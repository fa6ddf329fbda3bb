"""Shape-keyed launch-plan autotuner for the port's kernels (twin of
``repro.kernels.autotune``).

Each kernel wrapper has a ``launch_plan`` rule, fitted by hand at the B1
shapes.  :func:`plan_for` resolves the plan of one launch shape from a
persistent JSON cache first; on a miss at an eager launch on CUDA it times
every candidate plan (the plans the wrapper builds for that shape), keeps
the fastest and persists it.  The serving posture is to warm the cache
OFFLINE with ``repro_torch.launch.autotune_sweep``, so that no request pays
for tuning.

Cache keys are salted with the kernel's version and the backend:

    <kernel>@v<version>:<dims>:<backend>      e.g.
    m2q_matmul@v1:8x1024x151936xbfloat16:cuda_sm90

``<dims>`` are what decides a plan's speed (an (M, K, N) product and x's
dtype; dwconv_w4's B, H, W, C, k, stride and dtype; relu_attn's B, N, H, D
and dtype).  A cache from one backend never serves another, and a change
to a kernel's plan semantics (bump :data:`KERNEL_VERSIONS`) orphans every
stale entry.  The default file is per backend
(``~/.cache/repro_torch/autotune.<backend>.json``);
``REPRO_TORCH_AUTOTUNE_CACHE`` overrides the path (the JAX package reads
``REPRO_AUTOTUNE_CACHE``: one process holds both, and a cache meant for
one never steers the other).

Nothing is timed and nothing persisted on a miss in a CPU call, inside a
CUDA-graph capture, or inside an engine step (:func:`no_tuning`, which
both engines enter around every step, eager prefill included): those
return ``launch_plan``'s plan, the twin of JAX returning its heuristic
inside a trace.  Every candidate timed bumps :func:`tuning_probe_count`.
A candidate that fails to launch raises: a slower plan never hides a
kernel fault.

Writes are atomic and locked (merge-on-write under ``fcntl.flock``, then
tmp + rename).  A corrupt file never takes the process down: truncated
JSON, a non-dict top level, an entry that is not a valid plan, or a key
that does not parse is dropped with a ``RuntimeWarning`` and the cache
rebuilds.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import fcntl
import gc
import json
import os
import re
import threading
import time
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

Plan = Dict[str, int]

# bump a kernel's version when the meaning of its plan changes (its keys,
# what a value launches): stale entries then miss instead of mis-steering
# the kernel.  The port's own numbers, independent of the JAX package's.
KERNEL_VERSIONS: Dict[str, int] = {
    "m2q_matmul": 1,
    "int8_matmul": 1,
    "int4_matmul": 1,
    "apot_matmul": 1,
    "dwconv_w4": 1,
    "relu_attn": 1,
    "decode_attn_int8": 1,
}

# <kernel>@v<version>:<dims>:<backend>; the dims end with x's dtype, so
# the JAX package's ``kernel@vN:MxNxK:backend`` keys never parse here
_KEY_RE = re.compile(r"^[A-Za-z0-9_.-]+@v\d+:(?:\d+x)+[a-z][a-z0-9]*"
                     r":[A-Za-z0-9_]+$")

_LOCK = threading.Lock()
_CACHES: Dict[str, "AutotuneCache"] = {}
_BACKENDS: Dict[int, str] = {}
# device -> [measure()'s memory pool, the last graph measured in it],
# for the candidates of one tune()
_POOLS: Dict[int, list] = {}


def backend_of(device) -> str:
    """The cache's backend salt for a device: ``cuda_sm<major><minor>``
    (``cuda_sm90`` on an H100) or the device type (``cpu``)."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _BACKENDS:
        major, minor = torch.cuda.get_device_capability(idx)
        _BACKENDS[idx] = f"cuda_sm{major}{minor}"
    return _BACKENDS[idx]


def _dims_str(dims: Sequence) -> str:
    return "x".join(str(d).removeprefix("torch.") for d in dims)


def cache_key(kernel: str, dims: Sequence, backend: str) -> str:
    """The salted persistent-cache key of one kernel launch shape."""
    return (f"{kernel}@v{KERNEL_VERSIONS.get(kernel, 1)}:{_dims_str(dims)}"
            f":{backend}")


def default_cache_path(backend: str) -> str:
    env = os.environ.get("REPRO_TORCH_AUTOTUNE_CACHE")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        f"autotune.{backend}.json")


# ---------------------------------------------------------------------------
# valid plans: the launch parameters each wrapper's _launch reads
# ---------------------------------------------------------------------------

_SPLITS = (1, 2, 4, 8)


def _plan_space() -> Dict[str, Callable[[dict], bool]]:
    from . import dwconv_w4, int4_matmul, m2q_matmul, relu_attn
    wo_tiles = set(int4_matmul.TILES) | set(int4_matmul.NARROW_TILES) \
        | {int4_matmul.FMA_TILE}

    def matmul(tiles):
        return lambda p: (set(p) == {"bm", "bn", "splits"}
                          and (p["bm"], p["bn"]) in tiles
                          and p["splits"] in _SPLITS)

    def dwconv(p):
        return (set(p) == {"cv", "sw", "th", "r"} and p["r"] in dwconv_w4.RS
                and p["cv"] * p["sw"] * p["th"] <= dwconv_w4.MAX_THREADS)

    return {"m2q_matmul": matmul(set(m2q_matmul.TILES)),
            "int8_matmul": matmul(set(m2q_matmul.TILES)),
            "int4_matmul": matmul(wo_tiles), "apot_matmul": matmul(wo_tiles),
            "dwconv_w4": dwconv,
            "relu_attn": lambda p: (set(p) == {"splits"}
                                    and p["splits"] in relu_attn.SPLITS)}


def valid_plan(kernel: str, plan) -> bool:
    """A cache entry must be a JSON object of positive ints (no bools)
    that the kernel's wrapper launches; a kernel this module does not know
    takes any such object."""
    if not isinstance(plan, dict) or not plan or not all(
            isinstance(k, str) and isinstance(v, int)
            and not isinstance(v, bool) and v > 0 for k, v in plan.items()):
        return False
    check = _plan_space().get(kernel)
    return check is None or check(plan)


# ---------------------------------------------------------------------------
# shape-request recording (the offline sweep's discovery hook) + probes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeRequest:
    """One plan request seen by :func:`plan_for` (or a shape noted by a
    kernel that is not tuned, ``tunable=False``): ``dims`` rebuild a real
    launch of the same shape (the offline sweep tunes on synthetic
    operands)."""

    kernel: str
    dims: Tuple
    tunable: bool = True

    def key(self, backend: str) -> str:
        return cache_key(self.kernel, self.dims, backend)


_RECORDERS: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_autotune_recorders", default=())
_FROZEN: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_autotune_frozen", default=False)


@contextlib.contextmanager
def record_requests(dest: Optional[List[ShapeRequest]] = None):
    """Collect every ShapeRequest seen inside the scope (nestable;
    requests also reach enclosing recorders).  The port discovers a
    deployment's shapes by running its forward and engine steps eagerly
    in such a scope; JAX lowers them instead."""
    sink: List[ShapeRequest] = [] if dest is None else dest
    token = _RECORDERS.set(_RECORDERS.get() + (sink,))
    try:
        yield sink
    finally:
        _RECORDERS.reset(token)


@contextlib.contextmanager
def no_tuning():
    """Inside this scope a cache miss returns the fallback plan: nothing
    is timed or persisted (the engines' steps; shape discovery)."""
    token = _FROZEN.set(True)
    try:
        yield
    finally:
        _FROZEN.reset(token)


def _record(kernel: str, dims: Sequence, tunable: bool) -> None:
    sinks = _RECORDERS.get()
    if not sinks:
        return
    req = ShapeRequest(kernel, tuple(
        d if isinstance(d, int) else str(d).removeprefix("torch.")
        for d in dims), tunable)
    for sink in sinks:
        sink.append(req)


def note_shape(kernel: str, dims: Sequence) -> None:
    """Record a shape of a kernel that is not tuned (decode_attn_int8):
    the sweep lists it, but never caches a plan for it."""
    _record(kernel, dims, tunable=False)


_PROBES = 0
_TUNE_S = 0.0


def tuning_probe_count() -> int:
    """Candidate timings run in this process -- what the zero-probes
    assertions read."""
    return _PROBES


def tuning_seconds() -> float:
    """Host seconds spent in :func:`tune` in this process."""
    return _TUNE_S


def reset_probe_count() -> None:
    """Zero :func:`tuning_probe_count` and :func:`tuning_seconds`."""
    global _PROBES, _TUNE_S
    _PROBES, _TUNE_S = 0, 0.0


# ---------------------------------------------------------------------------
# persistent cache
# ---------------------------------------------------------------------------


def _read_cache_file(path: str) -> Dict[str, Plan]:
    """Read and sanitize one cache file.  Never raises on corruption:
    unreadable JSON, a non-dict top level, invalid plans or keys that do
    not parse as ``kernel@vN:dims:backend`` warn (``RuntimeWarning``) and
    leave the valid subset (usually empty: the cache rebuilds)."""
    try:
        with open(path) as f:
            raw = json.load(f)
    except OSError:
        return {}  # no cache yet: the normal first run, no warning
    except ValueError as e:
        warnings.warn(f"autotune cache {path!r} is not valid JSON ({e}); "
                      "ignoring it and rebuilding from scratch",
                      RuntimeWarning, stacklevel=3)
        return {}
    if not isinstance(raw, dict):
        warnings.warn(f"autotune cache {path!r} top level is "
                      f"{type(raw).__name__}, expected a JSON object; "
                      "ignoring it and rebuilding from scratch",
                      RuntimeWarning, stacklevel=3)
        return {}
    data = {k: dict(v) for k, v in raw.items()
            if isinstance(k, str) and _KEY_RE.match(k)
            and valid_plan(k.split("@", 1)[0], v)}
    if len(data) != len(raw):
        warnings.warn(f"autotune cache {path!r}: dropped "
                      f"{len(raw) - len(data)} corrupt entries (each key must "
                      "be kernel@vN:dims:backend and each value a plan the "
                      f"kernel launches); keeping the {len(data)} valid ones",
                      RuntimeWarning, stacklevel=3)
    return data


class AutotuneCache:
    """JSON-backed {key: plan} map with atomic, locked persistence;
    corruption-tolerant (see :func:`_read_cache_file`)."""

    def __init__(self, path: str):
        self.path = path
        self._data: Dict[str, Plan] = {}
        self._loaded = False

    def load(self) -> "AutotuneCache":
        self._loaded = True
        self._data = _read_cache_file(self.path)
        return self

    def get(self, key: str) -> Optional[Plan]:
        if not self._loaded:
            self.load()
        v = self._data.get(key)
        return dict(v) if v is not None else None

    def put(self, key: str, plan: Plan, save: bool = True) -> None:
        if not self._loaded:
            self.load()
        self._data[key] = {k: int(v) for k, v in plan.items()}
        if save:
            self.save()

    def keys(self) -> List[str]:
        if not self._loaded:
            self.load()
        return sorted(self._data)

    def save(self) -> None:
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        # merge-on-write under an exclusive lock: concurrent tuners (and
        # threads) each hold a partial view, so read-merge-replace must be
        # atomic as a unit or a slower writer drops a faster one's entries
        with _LOCK, open(f"{self.path}.lock", "w") as lf:
            fcntl.flock(lf, fcntl.LOCK_EX)
            merged = _read_cache_file(self.path)
            merged.update(self._data)
            self._data = merged
            tmp = f"{self.path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(self._data, f, indent=0, sort_keys=True)
            os.replace(tmp, self.path)

    def __len__(self) -> int:
        if not self._loaded:
            self.load()
        return len(self._data)


def shared_cache(path: str) -> AutotuneCache:
    """The process-wide cache object for ``path``, the one kernel launches
    consult: the offline sweep warms this instance, so a sweep and a serve
    in one process see one view."""
    with _LOCK:
        if path not in _CACHES:
            _CACHES[path] = AutotuneCache(path)
        return _CACHES[path]


# ---------------------------------------------------------------------------
# timing and resolution
# ---------------------------------------------------------------------------


def measure(fn: Callable[[], object], iters: int = 4, reps: int = 3) -> float:
    """Device ms of one ``fn()`` call: one eager warm-up, then ``iters``
    calls captured in a CUDA graph on a side stream and replayed ``reps``
    times between CUDA events, so the host's launch cost is out of the
    figure (as ``chip_smoke.graph_ms`` times a kernel).  The capture is
    begun by hand: ``torch.cuda.graph`` would run a full garbage
    collection and empty the allocator's cache for every candidate.  The
    graphs of one :func:`tune` share one memory pool per device, so its
    candidates hold the memory of one: the last graph is kept until the
    next capture has begun (a pool no graph holds is released, and
    cannot be captured into again) and is never replayed again; ``tune``
    lets the pool go when it ends, and the allocator takes its memory
    back when it next runs short."""
    fn()
    dev = torch.cuda.current_device()
    held = _POOLS.setdefault(dev, [torch.cuda.graph_pool_handle(), None])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    # no garbage collection inside the capture: freeing another graph is
    # a CUDA call that would invalidate it
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.stream(side):
            graph.capture_begin(pool=held[0])
            try:
                for _ in range(iters):
                    fn()
            finally:
                graph.capture_end()
    except BaseException:
        if held[1] is None:  # no graph holds the pool: start a new one
            del _POOLS[dev]
        raise
    finally:
        if collecting:
            gc.enable()
    torch.cuda.current_stream().wait_stream(side)
    held[1] = graph  # the previous graph goes; this one holds the pool
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def can_tune(device) -> bool:
    """A miss may be tuned here: an eager call on CUDA, outside a capture
    and outside :func:`no_tuning`."""
    return (torch.device(device).type == "cuda" and not _FROZEN.get()
            and not torch.cuda.is_current_stream_capturing())


def tune(candidates: Sequence[Plan],
         bench: Callable[[Plan], float]) -> List[Tuple[float, Plan]]:
    """(ms, plan) of every candidate, fastest first (ties: the earlier
    candidate).  ``bench(plan)`` launches and times the plan; whatever it
    raises propagates."""
    global _PROBES, _TUNE_S
    timed = []
    t0 = time.perf_counter()
    try:
        for i, plan in enumerate(candidates):
            _PROBES += 1
            timed.append((float(bench(plan)), i, plan))
    finally:
        _POOLS.clear()
        _TUNE_S += time.perf_counter() - t0
    timed.sort(key=lambda t: (t[0], t[1]))
    return [(ms, plan) for ms, _, plan in timed]


def cached_plan(kernel: str, dims: Sequence, device) -> Optional[Plan]:
    """The cache's plan for one launch shape on ``device``, or None."""
    backend = backend_of(device)
    return shared_cache(default_cache_path(backend)).get(
        cache_key(kernel, dims, backend))


def plan_for(kernel: str, dims: Sequence, device, *,
             fallback: Callable[[], Plan],
             candidates: Optional[Callable[[], Sequence[Plan]]] = None,
             bench: Optional[Callable[[Plan], float]] = None,
             force_tune: bool = False) -> Plan:
    """The launch plan of one kernel launch shape.

    Lookup order: the persistent cache (on every device) -> live tuning
    (a miss where :func:`can_tune` allows it, or ``force_tune``, and a
    ``bench``) -> ``fallback()``, the wrapper's ``launch_plan``.  A tuned
    winner is persisted.  Every call is visible to
    :func:`record_requests`."""
    _record(kernel, dims, tunable=True)
    if not force_tune:
        hit = cached_plan(kernel, dims, device)
        if hit is not None:
            return hit
    if not (force_tune or can_tune(device)) or bench is None:
        return fallback()
    cands = list(candidates()) if candidates is not None else [fallback()]
    best = cands[0] if len(cands) == 1 else tune(cands, bench)[0][1]
    backend = backend_of(device)
    shared_cache(default_cache_path(backend)).put(
        cache_key(kernel, dims, backend), best)
    return best

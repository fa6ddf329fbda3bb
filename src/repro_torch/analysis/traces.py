"""Trace builders (twin of ``repro.analysis.traces``): the qlint traces
-- registry config -> recorded op-graph traces --
and the hot-path walk behind the offline autotune sweep.

**qlint.**  JAX lowers each hot path of an abstract-quantized tree and
reads the optimized HLO.  The port records each one eagerly instead
(:func:`trace_fn`, ``analysis.opgraph``): the tree of
``recipe.abstract_quantize`` (JAX's, shape for shape) over the float
tree ``init`` draws from seed 0, its meta QTensor fields filled from a
seeded generator (:func:`materialize`: the op graph depends on shapes
and dtypes, not on values), run once on the trace's device with every
dispatch axis scoped on (or as ``dispatch=`` says), inside
``autotune.no_tuning()`` and ``torch.inference_mode()``.  The trace
names, inputs and metas are JAX's (:func:`qlint_trace_specs`); the
decode step runs as the loop body (``loop="decode"``).

**The autotune walk.**

JAX lowers each hot path with ``autotune.record_requests`` listening:
block choices resolve at trace time, so lowering alone walks every
``blocks_for`` call.  The port has no lowering, so it runs each hot path
eagerly on the deployment's device instead, with every dispatch axis on
and inside ``autotune.no_tuning()``: every ``*_op`` entry point asks the
autotuner for its plan before it launches (or, on a CPU tensor, before it
picks the plain version), so the walk records each launch shape, and
nothing is timed.

A deployment is a registry config quantized under a recipe.  Vision
configs run ``forward`` at each ``VisionEngine`` bucket (the powers of
two up to ``max_batch``).  Token configs (with the int8 KV cache where
the family's cache has one) are quantized at the decode shape (the
recipe's own tokens a step, from its calibration batch) and at
``LM_PREFILL_TOKENS`` tokens a step (the mixed LM on the prefill side;
``chip_smoke.py``'s ``token`` and ``token-m2q`` paths), and each tree
runs one prefill group of ``max_batch`` prompts of ``prefill_len`` tokens
and one decode step at ``(max_batch, max_len)``, the token Engine's
shapes.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import (Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from ..configs.registry import ARCHS, REDUCED
from ..core.qtensor import CHILDREN, is_qtensor
from ..core.tree import map_with_path
from ..kernels import autotune, ops
from ..launch.specs import decode_inputs, prefill_inputs
from ..models import get_model
from ..recipe import PRESETS, QuantizedModel, abstract_quantize, quantize
from ..serving.batching import pow2_bucket
from . import opgraph
from .rules import Trace

LM_PREFILL_TOKENS = 64

Spec = Tuple[str, Callable[[], object]]


def _int8_kv(cfg):
    """``cfg`` with the int8 KV cache where the family's cache honors it
    (JAX's ``_int8_kv_cfg``), else ``cfg``."""
    cfg8 = cfg.replace(kv_cache_dtype="int8")
    cache = get_model(cfg8).init_cache(cfg8, 2, 16, device="meta")
    return cfg8 if any(t.dtype == torch.int8 for t in cache.values()) \
        else cfg


def model_trace_specs(qm: QuantizedModel, label: str, *, max_batch: int = 8,
                      prefill_len: int = 128,
                      max_len: int = 256) -> List[Spec]:
    """``(name, fn)`` for the hot paths of one quantized model on its
    device: ``fn()`` runs one eagerly."""
    cfg, dev = qm.cfg, qm.device
    if cfg.family == "efficientvit":
        buckets = sorted({pow2_bucket(n, 1, max_batch)
                          for n in range(1, max_batch + 1)})

        def forward(b):
            return lambda: qm.forward(torch.zeros(
                (b, cfg.img_res, cfg.img_res, 3), device=dev))

        return [(f"{label}/forward_b{b}", forward(b)) for b in buckets]
    model = qm.model
    gen = torch.Generator(device="cpu").manual_seed(0)

    def prefill():
        toks = torch.randint(0, cfg.vocab_size, (max_batch, prefill_len),
                             generator=gen).to(dev)
        cache = model.init_cache(cfg, max_batch, max_len,
                                 dtype=torch.float32, device=dev)
        kw = ({"lengths": torch.full((max_batch,), prefill_len,
                                     dtype=torch.int32, device=dev)}
              if getattr(model, "RAGGED_PREFILL", False) else {})
        with torch.inference_mode():
            return model.prefill(cfg, qm.params, cache, toks, **kw)

    def decode():
        cache = model.init_cache(cfg, max_batch, max_len,
                                 dtype=torch.float32, device=dev)
        cache["lengths"].fill_(prefill_len)
        toks = torch.randint(0, cfg.vocab_size, (max_batch, 1),
                             generator=gen).to(dev)
        with torch.inference_mode():
            return model.decode_step(cfg, qm.params, cache, toks)

    return [(f"{label}/prefill", prefill), (f"{label}/decode", decode)]


def registry_deployments(arch: str, *, recipes: Sequence[str] = (
        "m2q-w8a8", "uniform8"), device="cuda",
        reduced: bool = False) -> Iterator[Tuple[str, QuantizedModel]]:
    """``(label, quantized model)`` for one registry config (published
    widths, or its REDUCED twin): the float tree built once on ``device``
    from seed 0, quantized per recipe and, for token configs, per
    deployment shape (labelled ``<arch>/<recipe>`` and
    ``<arch>/<recipe>@<tokens a step>``)."""
    cfg = (REDUCED if reduced else ARCHS)[arch]
    if cfg.family != "efficientvit":
        cfg = _int8_kv(cfg)
    params = get_model(cfg).init(cfg, seed=0, device=device)
    shapes = ((None,) if cfg.family == "efficientvit"
              else (None, LM_PREFILL_TOKENS))
    for name in recipes:
        for tps in shapes:
            rec = PRESETS[name] if tps is None \
                else PRESETS[name].replace(tokens_per_step=tps)
            label = f"{arch}/{name}" + ("" if tps is None else f"@{tps}")
            yield label, quantize(cfg, params, rec)


def registry_trace_specs(arch: str, *, recipes: Sequence[str] = (
        "m2q-w8a8", "uniform8"), device="cuda",
        reduced: bool = False) -> Iterator[Spec]:
    """The trace set of one registry config: :func:`model_trace_specs` of
    each of its :func:`registry_deployments`."""
    for label, qm in registry_deployments(arch, recipes=recipes,
                                          device=device, reduced=reduced):
        yield from model_trace_specs(qm, label)


def walk(specs) -> Tuple[List[autotune.ShapeRequest], Dict[str, int]]:
    """Run each spec with every dispatch axis on, recording and never
    timing: (the deduplicated requests in first-seen order, {trace name:
    requests recorded})."""
    reqs: List[autotune.ShapeRequest] = []
    per_trace: Dict[str, int] = {}
    for name, fn in specs:
        n0 = len(reqs)
        with autotune.record_requests(reqs), autotune.no_tuning(), \
                ops.dispatch(dense=True, conv=True, attn=True):
            fn()
        per_trace[name] = len(reqs) - n0
    return list(dict.fromkeys(reqs)), per_trace


def shape_requests(configs: Sequence[str], *,
                   recipes: Sequence[str] = ("m2q-w8a8", "uniform8"),
                   device="cuda", reduced: bool = False):
    """Every autotune shape a deployment's hot paths request:
    ``(requests, per_trace)`` as :func:`walk` returns them, over
    :func:`registry_trace_specs` of each config."""
    def specs():
        for arch in configs:
            yield from registry_trace_specs(arch, recipes=recipes,
                                            device=device, reduced=reduced)
    # quantizing calibrates through eager forwards: nothing tunes there
    # either
    with autotune.no_tuning():
        return walk(specs())


# ---------------------------------------------------------------------------
# qlint: recorded hot paths
# ---------------------------------------------------------------------------


def param_paths(args) -> List[str]:
    """Every tensor leaf's path in ``args``, each QTensor child as
    ``<path>/<i>`` (JAX's ``_path_str`` of ``tree_flatten_with_path``)."""
    return [path for path, _ in opgraph.param_leaves(args)]


def materialize(tree, device, seed: int = 0):
    """``tree`` with every ``meta`` tensor (an abstract QTensor field)
    drawn from a CPU generator seeded with ``seed`` onto ``device``:
    int8 / uint8 payloads over their whole range, zero points integral
    in [0, 16), every other float field (scales) in [0.005, 0.015).
    Other tensors are kept."""
    gen = torch.Generator(device="cpu").manual_seed(seed)

    def draw(name, t):
        if not isinstance(t, torch.Tensor) or t.device.type != "meta":
            return t
        shape = tuple(t.shape)
        if t.dtype in (torch.int8, torch.uint8):
            lo, hi = (-128, 128) if t.dtype == torch.int8 else (0, 256)
            x = torch.randint(lo, hi, shape, generator=gen, dtype=t.dtype)
        elif name in ("zero_point", "u_zp"):
            x = torch.randint(0, 16, shape, generator=gen).to(t.dtype)
        else:
            x = (0.005 + 0.01 * torch.rand(shape, generator=gen)).to(t.dtype)
        return x.to(device)

    def visit(_, leaf):
        if is_qtensor(leaf):
            return dataclasses.replace(leaf, **{
                name: draw(name, getattr(leaf, name))
                for name in CHILDREN[type(leaf)]})
        return draw("", leaf)

    return map_with_path(visit, tree)


def trace_fn(fn, args, *, name: str, meta: Optional[dict] = None,
             dispatch: Optional[bool] = True,
             loop: Optional[str] = None) -> Trace:
    """Run ``fn(*args)`` once under an op-graph recorder (``args``
    seeded by path) and wrap the graph in a :class:`Trace`.
    ``dispatch``: True/False scopes all three kernel-dispatch axes
    on/off; None inherits the ambient scope.  ``loop`` labels every op
    as in that loop body (the decode step)."""
    scope = (contextlib.nullcontext() if dispatch is None
             else ops.dispatch(dense=dispatch, conv=dispatch, attn=dispatch))
    with scope, autotune.no_tuning(), torch.inference_mode(), \
            opgraph.record(args, loop=loop) as rec:
        fn(*args)
    return Trace(name=name, graph=rec.graph(), meta=dict(meta or {}))


def _quantized(cfg, params, recipe: str, tokens_per_step: int, device):
    return materialize(abstract_quantize(
        cfg, params_abs=params, recipe=recipe,
        tokens_per_step=tokens_per_step), device)


# extra input resolutions traced for vision configs under the m2q recipe
# (batch 1, JAX's ``VISION_HIRES``)
VISION_HIRES: Tuple[int, ...] = (384, 512)


def qlint_trace_specs(arch: str, *, device="cuda", reduced: bool = True,
                      batch: int = 2, prefill_len: int = 32,
                      decode_len: int = 64,
                      recipes: Sequence[str] = ("m2q-w8a8", "uniform8"),
                      hires: Sequence[int] = VISION_HIRES):
    """Yield ``(fn, args, name, meta, loop)`` for one registry config
    (JAX's ``registry_trace_specs``: its names, shapes and metas).

    Vision configs trace ``forward`` at the config resolution (batch
    ``batch``) and, under m2q, at each ``hires`` resolution (batch 1);
    token configs trace prefill and decode, with the int8 KV cache where
    the family's cache has one.  ``uniform8`` traces promise
    ``expect_no_f32_dot`` (the decode only with the int8 KV cache); the
    m2q vision traces hold a conv budget of 1 (the unquantized stem)."""
    cfg = (REDUCED if reduced else ARCHS)[arch]
    model = get_model(cfg)
    params = model.init(cfg, seed=0, device=device)
    rng = np.random.default_rng(0)
    for recipe in recipes:
        rtag = {"m2q-w8a8": "m2q", "uniform8": "u8"}.get(recipe, recipe)
        no_f32 = recipe == "uniform8"
        if cfg.family == "efficientvit":
            variants = [(cfg.img_res, batch, f"{arch}/{rtag}/forward")]
            if recipe == "m2q-w8a8":
                variants += [(r, 1, f"{arch}/{rtag}/forward-r{r}")
                             for r in hires]
            for res, b, name in variants:
                cfg_v = cfg if res == cfg.img_res else cfg.replace(img_res=res)
                qp = _quantized(cfg_v, params, recipe, b, device)
                imgs = torch.from_numpy(rng.standard_normal(
                    (b, res, res, 3), dtype=np.float32)).to(device)

                def fwd(p, x, _cfg=cfg_v):
                    return model.forward(_cfg, p, x)

                yield (fwd, (qp, imgs), name,
                       {"quantized": True, "expect_no_f32_dot": no_f32,
                        "conv_budget": 1 if recipe == "m2q-w8a8" else None},
                       None)
            continue
        cfg_t = _int8_kv(cfg)
        int8_kv = cfg_t is not cfg
        model_t = get_model(cfg_t)
        qp = _quantized(cfg_t, params, recipe, batch * prefill_len, device)
        inp, cache = prefill_inputs(cfg_t, batch, prefill_len, concrete=True,
                                    device=device)

        def prefill(p, c, i, _cfg=cfg_t, _model=model_t):
            return _model.prefill(_cfg, p, c, **i)

        yield (prefill, (qp, cache, inp), f"{arch}/{rtag}/prefill",
               {"quantized": True}, None)

        qp_d = _quantized(cfg_t, params, recipe, batch, device)
        dcache, dtok = decode_inputs(cfg_t, batch, decode_len, concrete=True,
                                     device=device)

        def decode(p, c, t, _cfg=cfg_t, _model=model_t):
            return _model.decode_step(_cfg, p, c, t)

        yield (decode, (qp_d, dcache, dtok), f"{arch}/{rtag}/decode",
               {"quantized": True, "expect_no_f32_dot": no_f32 and int8_kv},
               "decode")


def registry_traces(arch: str, *, device="cuda", reduced: bool = True,
                    **kw) -> List[Trace]:
    """The qlint trace set for one registry config: every spec of
    :func:`qlint_trace_specs` recorded with every dispatch axis on."""
    return [trace_fn(fn, args, name=name, meta=meta, loop=loop)
            for fn, args, name, meta, loop in qlint_trace_specs(
                arch, device=device, reduced=reduced, **kw)]


def _spec_str(parts) -> str:
    """A spec as JAX's ``_norm_spec`` writes it: trailing Nones stripped."""
    parts = list(parts or ())
    while parts and parts[-1] is None:
        parts.pop()
    return repr(tuple(parts))


def placed_spec(x) -> str:
    """The spec a ``DTensor``'s placements say (mesh axis names at the
    dims they shard), as :func:`_spec_str` writes it."""
    names = x.device_mesh.mesh_dim_names
    spec: List = [None] * x.ndim
    for name, pl in zip(names, x.placements):
        if pl.is_shard():
            d = pl.dim
            spec[d] = name if spec[d] is None else (
                tuple(spec[d]) if isinstance(spec[d], tuple)
                else (spec[d],)) + (name,)
    return _spec_str(spec)


def sharding_records(placed, specs, prefix: str = "") -> List[Dict[str, str]]:
    """{path, expected, actual} per array of a placed tree: the spec of
    ``dist.sharding`` against the placements it holds (paths after
    ``prefix``)."""
    from ..dist import sharding as shd
    want = dict(shd.flat_arrays(specs))
    return [{"path": prefix + path, "expected": _spec_str(want.get(path)),
             "actual": placed_spec(x) if hasattr(x, "placements")
             else repr(type(x).__name__)}
            for path, x in shd.flat_arrays(placed)]


def _sharded_rank(rank: int, world: int, port: int, arch: str, batch: int,
                  decode_len: int, n_data: int, n_model: int, recipe: str,
                  device: str, out) -> None:
    """One rank of :func:`sharded_decode_trace` (a spawned process)."""
    import torch.distributed as dist
    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo",
                                init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=world)
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
            dev = torch.device("cuda", torch.cuda.current_device())
        from ..dist import sharding as shd
        from ..launch.mesh import make_debug_mesh
        from ..serving.engine import Engine
        mesh = make_debug_mesh(n_data, n_model, device_type=dev.type)
        cfg = _int8_kv(REDUCED[arch])
        params = get_model(cfg).init(cfg, seed=0, device=dev)
        qp = _quantized(cfg, params, recipe, batch, dev)
        eng = Engine(cfg, qp, max_batch=batch, max_len=decode_len,
                     graphs=False, mesh=mesh)
        rt = eng._rt
        records = sharding_records(eng.params, shd.param_specs(qp, mesh), "0/")
        records += [{"path": f"1/{name}",
                     "expected": _spec_str(eng._cache_specs[name]),
                     "actual": placed_spec(x)}
                    for name, x in eng.sharded_cache().items()]
        eng._model_cache["lengths"].fill_(decode_len - 1)
        toks = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, size=(batch, 1), dtype=np.int32))
        toks = toks[eng._rows].to(dev)

        def decode(p, c, t):
            return eng.model.decode_step(eng._exec_cfg, p, c, t)

        from .. import kernels
        kernels.reset_counts()
        tr = trace_fn(decode, (eng._exec, eng._model_cache, toks),
                      name=f"{arch}/m2q/decode-sharded",
                      meta={"quantized": True, "sharding": records,
                            "mesh": {"data": rt.n_data,
                                     "model": rt.n_model}},
                      loop="decode")
        launches = {k: c["launches"] for k, c in kernels.counts().items()
                    if c["launches"]}
        out.put((rank, "ok", (tr if rank == 0 else None, launches)))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 -- reported to the parent
        import traceback
        out.put((rank, "err", traceback.format_exc()))


def sharded_decode_trace(arch: str = "qwen1.5-0.5b", *, batch: int = 4,
                         decode_len: int = 32, n_data: int = 1,
                         n_model: int = 2, recipe: str = "m2q-w8a8",
                         device="cuda", timeout: float = 300.0) -> Trace:
    """One mesh-sharded decode trace with sharding-conformance metadata:
    ``n_data * n_model`` gloo ranks (spawned processes; on ``cuda`` all
    on the current card, as the sharded engines run there) each build
    the token ``Engine`` with ``mesh=``, whose placed parameters and
    cache are held against ``dist.sharding``'s specs, and record one
    decode step of the rank's compute tree; rank 0's trace is returned,
    each rank's kernel launches of that step in ``meta["rank_launches"]``.
    Raises ``RuntimeError`` when a rank fails or does not answer within
    ``timeout`` seconds (every rank is then killed)."""
    import socket

    import torch.multiprocessing as mp
    world = n_data * n_model
    if str(device).startswith("cuda"):
        device = f"cuda:{torch.cuda.current_device()}"
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_sharded_rank, daemon=True, args=(
        r, world, port, arch, batch, decode_len, n_data, n_model, recipe,
        str(device), out)) for r in range(world)]
    for p in procs:
        p.start()
    got, errors = {}, []
    try:
        import queue
        import time
        end = time.monotonic() + timeout
        while len(got) + len(errors) < world:
            try:
                rank, status, val = out.get(
                    timeout=max(0.1, end - time.monotonic()))
            except queue.Empty:
                raise RuntimeError(f"sharded trace: no answer from "
                                   f"{world - len(got)} rank(s) in "
                                   f"{timeout:.0f} s") from None
            if status == "ok":
                got[rank] = val
            else:
                errors.append(f"rank {rank}: {val}")
        if errors:
            raise RuntimeError("sharded trace failed:\n" + "\n".join(errors))
        for p in procs:
            p.join(timeout=30)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    tr = got[0][0]
    tr.meta["rank_launches"] = [got[r][1] for r in range(world)]
    return tr


DEFAULT_SWEEP: Tuple[str, ...] = (
    "efficientvit-b1-r224",
    "qwen1.5-0.5b",
    "granite-3-8b",
    "rwkv6-3b",
    "whisper-large-v3",
    "llama4-scout-17b-a16e",
)

#!/usr/bin/env python3
"""Prove the PyTorch/CUDA port (``src/repro_torch``) runs its main path on
one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; one GPU

Phases, each fatal on failure (nonzero exit, no result line):

1. card check -- CUDA must be available; prints ``name, power.limit``;
2. build -- compiles every CUDA kernel source in ``src/repro_torch/csrc``
   with nvcc for sm_90a (one nvcc per source, all started together; int4
   and APoT share ``weights_only_matmul.cu``, m2q and int8
   ``m2q_matmul.cu``, relu_attn and its scale kernel ``relu_attn.cu``)
   and prints the ``-Xptxas -v`` report;
3. kernel checks -- each of the eight kernels against its plain PyTorch
   version on the card, at every distinct shape of one EfficientViT-B1
   R224 forward at batch 8 under the recipe paths below and of one
   qwen1.5-0.5b decode step at batch 8 (``decode_attn_int8`` at
   B=8 T=256 Hkv=16 G=1 D=64 with ragged lengths, plus a G=4 D=128 shape,
   a windowed case and the decode shape at B=1, 2 and 4, each row with
   its launch plan; ``int4_matmul`` also at the lm_head's M=8 K=1024
   N=151936; ``m2q_matmul`` also at the mixed qwen's shapes: one decode
   step at batch 8 -- (8, 1024, 1024) x 96, (8, 2816, 1024) x 24 and
   the lm_head (8, 1024, 151936) -- and one prefill group of 8 prompts of
   128 tokens), with kernel / plain / library device times (CUDA graphs
   timed by CUDA events) and the card's least time for the same work
   (m2q_matmul, int8_matmul and int4_matmul also per path: their shapes
   of different paths never run in one forward; every row but
   decode_attn_int8's also records the launch shape).  int8, dwconv and
   relu_attn (bf16 out, timed, and f32 out), m2q (f32 out) and relu_attn_scales (against
   the plain scale chain it replaces, timed as its plain version) must
   equal their plain versions bit for bit; the f32-dot kernels (int4,
   APoT) must sit within the f32 summation bound; decode_attn_int8
   within two flipped p8 codes per (b, h, g) row (f32 store), its bf16
   store (the served one, timed) equal to the f32 store rounded once, and
   two replays of one CUDA graph bit-identical;
4. main path -- ``init`` at full B1 R224 width, ``recipe.quantize(...,
   "m2q-w8a8")`` with synthesized calibration, ``serve(max_batch=8)``
   once eager (``graphs=False``) and once with the engine's CUDA graphs,
   each engine serving 12 submitted images twice (polled to completion;
   the graphed engine's first pass captures its buckets, timed apart as
   ``graph_capture_s``) and classifying them once; checks the launch
   counters in every pass (42 m2q / 20 dwconv / 14 relu_attn / 14
   relu_attn_scales launches per forward, 0 plain calls), every pass's
   logits equal to the eager engine's first at zero tolerance (the same
   batches: relu_attn's scales span the batch), and the logits against a
   plain-version forward of the same batches on the card; reports served
   images/s both ways; times the batch-8 forward (eager, in a CUDA graph,
   plain) and traces it with torch.profiler; then the artifact:
   ``qm.save`` and ``QuantizedModel.load(..., device="cuda")`` (timed,
   with the artifact's bytes), every leaf bit-identical with equal class
   and static fields, equal cfg, recipe, reports, act_stats and
   provenance, and a new engine's graph-served logits of the 12 images
   and its launch counts equal to the original's at zero tolerance;
5. the other recipe paths, each the same way (counters, leaf types,
   logits vs the plain-version forward, the batch-8 forward in a CUDA
   graph, the artifact round trip; ``uniform8`` also eager, plain and
   traced, the others not):
   ``uniform8`` (42 int8_matmul + 14 + 14 attention per forward), the
   opt-in int8 stem (1 int8_matmul + the m2q path's 90),
   ``w4-weights-only`` (42 int4_matmul + 20 dwconv + 14 + 14 attention)
   and weights-only APoT (42 apot_matmul + 20 dwconv + 14 + 14
   attention);
6. the token path -- qwen1.5-0.5b at full width with the int8 KV cache,
   ``recipe.quantize(..., "m2q-w8a8")`` on the card (every dense leaf
   4-bit at the decode shape), ``serve(max_batch=8, max_len=256,
   seed=0)`` once eager and once with the engine's decode-step graphs,
   each engine running 16 requests (prompts of 8-96 tokens, 24-40 new
   tokens, two at temperature 0.8) to completion twice; checks leaf
   types, the launch counters in every pass (decode_attn_int8 = 24 per
   decode step, int4_matmul = one per step and per prefill group, 0
   plain calls), every handle's token count, every graph-served token
   list equal to the eager engine's pass for pass (sampled requests
   included), and teacher-forced kernel logits against
   ``reference_path()`` logits; where a served token is not the
   teacher-forced argmax, prints the logits' top-2 margin there and the
   served token's gap to the top, which must stay within the logits'
   bound; times the batch-8 decode step (eager, in a CUDA graph -- a
   step that cannot be captured fails the run -- and plain), traces one
   with torch.profiler, times the per-step dequantizes of the layer
   weights no kernel takes (``plain_dequant_ms_per_step``) and reports
   the served tokens/s both ways and, over one more graphed pass, its
   time in prefill and in decode steps;
   the artifact round trip as in phase 4 (~0.3 GB of 4-bit payload), a
   new engine's graph-served tokens of the 16 requests at seed 0 and its
   launch counts equal to the original's first graphed pass; then
   ``token-m2q``, the same run of the mixed LM: ``m2q-w8a8`` at 64 tokens
   a step, so wq, wk, wv, wo and w2 are QExpertM2Q leaves of 24 layers,
   w1/w3 perm-folded QM2Q leaves without an activation scale and the
   lm_head a calibrated QM2Q; 121 m2q_matmul (5 x 24 + 1) and 24
   decode_attn_int8 launches per decode step, 121 m2q_matmul per prefill
   group, no int4_matmul (~0.54 GB artifact);
7. the trained proxy -- the reduced B1 the JAX package trained on the
   synthetic vision task: its committed JAX-written ``m2q-w8a8`` artifact
   (``results/artifacts/proxy_efficientvit_m2q``) loaded on the card
   classifies ``expected.json``'s 256 images through the kernels (int8
   attention; the launch counts printed) and with f32 attention; both
   forwards' logits must equal the same forward's under
   ``reference_path()`` exactly, and the f32-attention ones the JAX
   package's recorded logits and predictions within ``proxy_vs_jax``'s
   bounds; reports top-1 beside JAX's, the float proxy's, and the port's
   own quantization of the float proxy on the card (its top-1, and the
   payload bytes that differ from the JAX artifact's).

8. the serving runtime -- (a) ``repro_torch.launch.serve.main`` in-process
   at full width (qwen1.5-0.5b, int8 KV, ``--max-batch 8 --max-len
   256``, 8 requests of 16 new tokens): its ``requests=`` / ``decoded=``
   / ``tok/s=`` lines, and its launches equal to what its leaves route
   (decode_attn_int8 24 per decode step, int4_matmul one per step and
   group, 0 plain calls); (b) phase 6's ``token`` artifact (kept on disk
   for this phase, as phase 4's ``m2q-w8a8`` one is) loaded on the card
   and driven through one scripted manual run, once from the engine's
   CUDA graphs and once eagerly, each at seed 0 with
   ``debug_numerics=True`` and ``raise@prefill:2,nan@decode:5``: 8
   preemptible batch-class requests (two streamed, one at temperature
   0.8), then 2 interactive ones; both runs must fail the same uids
   with the same classes (``InjectedFault`` for the prefill group,
   ``NumericalError`` for the one poisoned slot), deliver the same
   tokens at zero tolerance, preempt at least once with the evicted
   stream kept, stream what they return, reconcile, and launch
   decode_attn_int8 24 times a step; the decode step in a CUDA graph
   with the cache scan off and on; (c) a ``ServingDaemon`` over a new
   graphed engine of that artifact serving ``launch.daemon.
   serve_traffic``'s 16 requests from a foreign thread, the first
   interactive one streamed: streamed == result, reconciled, the daemon
   stopped, launches as routed; time to first token, token gaps,
   per-class p50/p99 and tokens/s printed; (d) a daemon over phase 4's
   ``m2q-w8a8`` artifact serving 12 images submitted from a foreign
   thread in the interactive and batch classes: every handle DONE,
   reconciled, 42 / 20 / 14 / 14 launches per forward (logits are not
   gated here: daemon batches form by timing, and relu_attn's scales
   span the batch);

9. supervised serving -- (a) ``python -m repro_torch.launch.daemon --arch
   qwen1.5-0.5b --recovery-smoke`` in-process at full width: its
   ``recovery smoke ok`` line (a restart, every request exact or within
   the teacher-forced bound, the journal exact) and its kernels launched,
   no plain call; (b) :func:`supervised_cases` over phase 6's ``token``
   artifact (int8 KV, ``max_batch`` 8, graphs), each engine build warmed
   and captured in the factory before it is armed: ``crash@decode`` (one
   restart), ``hang@decode`` after 2 s (a HungStepError restart whose new
   engine is built and captured after the released serve thread left), a
   streamed request across a restart (streamed == result), every build
   armed until the circuit opens (CircuitOpenError on every handle, a
   rejected submit, the torn-down engine freed before each rebuild, and
   allocated memory after restart 3 within half an engine of restart
   1's), and a second supervisor cold-starting from the journal of a
   first stopped like a dead process; goodput 100% where no circuit
   opens, the journals exact with 0 pending, replayed tokens equal to a
   fault-free run's or, only where the replay's prefill group had another
   size or padded length, within the teacher-forced
   5e-2-of-max-|logit| bound (counts printed), launches as the engines'
   steps and prefill groups route them; (c) :func:`process_kill_replay`: a child process
   serving the artifact on the card is SIGKILLed mid-flight and a fresh
   one replays its journal to exact reconciliation; (d)
   :func:`supervised_vision` over phase 4's artifact under
   ``crash@vision``: 12 images DONE after the restart, 42 / 20 / 14 / 14
   launches per forward; (e) the CLI's ``--health-file`` read while it
   serves: a ready snapshot, the JAX package's keys (``HEALTH_KEYS``), 0
   restarts, no torn file; (f) per restart, detection, teardown, backoff,
   factory and recovery seconds and allocated bytes, printed beside the
   card.  The artifacts are removed at the end.

It then prints the card's name and power limit again, one JSON line with
every kernel's numbers and, last, the ``{"ok": true, "device": ...}``
line.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12     # outside the tensor cores

BATCH = 8
N_IMAGES = 12

# The trained proxy's JAX-written m2q-w8a8 artifact served with f32
# attention, against the JAX package's dispatch-off logits (expected.json).
# Measured with the same forward on the CPU (plain versions,
# tests/test_torch_artifact.py) and on an H100 (kernels): 251 of the 256
# images' logits are bit-identical to JAX's on each, 5 differ (3 of them
# the same images on both) by up to 0.067 (CPU) and 0.146 (H100) of a max
# |logit| of 8.18 -- float summation order moves an activation across an
# int8 rounding step upstream -- and no prediction differs.  The gate: at
# most PROXY_IMAGES_OFF images differ by more than PROXY_FLOAT of JAX's
# max |logit| (a float slip; a wrong kernel or quantizer moves nearly
# every image), none by more than PROXY_LOGITS of it, and at most
# PROXY_MISMATCHES predictions differ (2 images have a JAX top-2 margin
# below five times the CPU's largest difference).
PROXY_FLOAT = 1e-3
PROXY_IMAGES_OFF = 10
PROXY_LOGITS = 5e-2
PROXY_MISMATCHES = 2


def proxy_vs_jax(got, want):
    """The proxy gate: (numbers, failures) of f32-attention logits ``got``
    against the JAX package's ``want``, both (images, classes)."""
    import numpy as np
    top = float(np.abs(want).max())
    per_image = np.abs(got - want).max(1)
    res = dict(logits_max_abs_diff=float(per_image.max()),
               jax_logits_max_abs=top,
               images_off=int((per_image > PROXY_FLOAT * top).sum()),
               predictions_differing=int((got.argmax(-1) != want.argmax(-1))
                                         .sum()))
    failures = []
    if res["images_off"] > PROXY_IMAGES_OFF:
        failures.append(f"{res['images_off']} images' logits differ from "
                        f"JAX's by more than {PROXY_FLOAT} of {top} (bound "
                        f"{PROXY_IMAGES_OFF} images)")
    if not res["logits_max_abs_diff"] <= PROXY_LOGITS * top:
        failures.append(f"logits differ from JAX's by "
                        f"{res['logits_max_abs_diff']} (bound {PROXY_LOGITS}"
                        f" of {top})")
    if res["predictions_differing"] > PROXY_MISMATCHES:
        failures.append(f"{res['predictions_differing']} predictions differ "
                        f"from JAX's (bound {PROXY_MISMATCHES})")
    return res, failures


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of ``fn`` in ms over ``iters`` back-to-back eager calls
    (CUDA events): device time plus whatever launch gaps the host leaves."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def capture(fn, iters: int = 1):
    """(graph, output of the last call): ``iters`` calls of ``fn``
    captured in a CUDA graph after three warm-up calls on a side stream."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            y = fn()
    return graph, y


def graph_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Device time of one ``fn`` call in ms: ``iters`` calls captured in a
    CUDA graph, replayed ``reps`` times between CUDA events, so host launch
    overhead is out of the measurement."""
    import torch
    graph, _ = capture(fn, iters)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def device_profile(fn, iters: int = 3, top: int = 8) -> dict:
    """Trace ``iters`` eager calls of ``fn`` with torch.profiler: device
    busy ms per call (kernels on one stream do not overlap), the busy share
    of the traced span (deflated: the profiler slows the host's launches),
    and the kernels that took the most device time.  Empty when the trace
    holds no device events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kern:
        return {}
    busy = sum(e.time_range.elapsed_us() for e in kern)
    span = (max(e.time_range.end for e in kern)
            - min(e.time_range.start for e in kern))
    by_name = Counter()  # keyed by the name's first 120 characters, so
    for e in kern:       # kernels that share them are summed, not dropped
        by_name[e.name[:120]] += e.time_range.elapsed_us()
    ranked = by_name.most_common(top)
    return {"busy_share_profiled": busy / span,
            "span_ms": span / 1e3 / iters,
            "busy_ms": busy / 1e3 / iters,
            "kernels_per_call": len(kern) // iters,
            "top_ms_per_call": {n: t / 1e3 / iters for n, t in ranked}}


def main_path_calls(cfg, batch: int):
    """Every kernel call of one forward, in order: m2q (path, M, K, N),
    dwconv (path, B, H, W, C, k, stride), attention (B, N, heads, D)."""
    r = -(-cfg.img_res // 2)  # after the stride-2 stem
    m2q, dw, attn = [], [], []
    cin = cfg.widths[0]
    for si, (w, d) in enumerate(zip(cfg.widths, cfg.depths)):
        for bi in range(d):
            stride = 2 if (bi == 0 and si > 0) else 1
            p = f"stages/{si}/{bi}"
            mid = cin * 4
            m2q.append((f"{p}/mb/w_pw1", batch * r * r, cin, mid))
            dw.append((f"{p}/mb/w_dw", batch, r, r, mid, 3, stride))
            r = -(-r // stride)
            m2q.append((f"{p}/mb/w_pw2", batch * r * r, mid, w))
            if si >= len(cfg.widths) - 2:
                m2q.append((f"{p}/msa/w_qkv", batch * r * r, w, 3 * w))
                dw.append((f"{p}/msa/w_agg", batch, r, r, 3 * w, 5, 1))
                heads = w // cfg.dim_per_head
                attn += [(batch, r * r, heads, cfg.dim_per_head)] * 2
                m2q.append((f"{p}/msa/w_proj", batch * r * r, 2 * w, w))
            cin = w
    m2q.append(("head/w_in", batch * r * r, cin, cin * 4))
    m2q.append(("head/w", batch, cin * 4, cfg.n_classes))
    return m2q, dw, attn


class Tally:
    """One kernel's checks and times, per distinct shape and summed over
    one forward (each shape weighted by its launches per forward)."""

    KEYS = ("ms", "eager_ms", "plain_ms", "library_ms", "bound_ms",
            "bytes_ms", "ops_ms")

    def __init__(self, name: str, source: str = None):
        self.name = name
        self.source = source or name
        self.rows = []
        self.total = dict.fromkeys(self.KEYS, 0.0)
        self.by_path = {}  # recipe path -> its own sums, where paths differ
        self.err = 0.0
        self.err_ratio = None  # largest err / bound of the f32-dot kernels

    def measure(self, shape: dict, count: int, kernel, plain, library,
                nbytes: float, ops_ms: float, err_bound=None,
                path: str = None, timed=None) -> None:
        """Hold ``kernel()`` against ``plain()`` and time kernel, plain and
        ``library`` (a PyTorch yardstick, or None).  ``path``: the recipe
        path this shape belongs to, where one kernel serves two paths that
        never run in one forward; each gets its own sums.  ``timed``: the
        launch to time in place of ``kernel`` (the served one, where the
        check holds another store of the same kernel).

        ``err_bound`` None: the kernel's integer sums are exact and its
        float steps repeat the plain version's operations in the same
        order with IEEE rounding, so equality is expected; 1e-6 of the
        output's magnitude leaves room only for a rounding-order slip.
        ``err_bound`` a number or a per-element tensor: the limit itself
        (0.0 demands bit equality; the f32-dot kernels pass the f32
        summation bound), and the row records the largest err / bound."""
        import torch
        y, y_ref = kernel(), plain()
        if isinstance(y, tuple):  # (sq, sk, sv)
            y, y_ref = torch.stack(y), torch.stack(y_ref)
        torch.cuda.synchronize()
        diff = (y - y_ref).abs()
        err = float(diff.max())
        scale = float(y_ref.abs().max())
        if err_bound is None:
            err_bound = 1e-6 * max(scale, 1.0)
        ratio = float((diff / err_bound).nan_to_num(0.0).max()) \
            if torch.is_tensor(err_bound) else None
        if not bool(torch.all(diff <= err_bound)):
            fail(f"{self.name} {shape}: max_abs_err {err} vs |y| {scale} "
                 f"(err / bound {ratio})")
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        timed = timed or kernel
        row = dict(shape, count=count, err=err, ms=graph_ms(timed),
                   eager_ms=cuda_ms(timed), plain_ms=graph_ms(plain, 5),
                   library_ms=graph_ms(library) if library else None,
                   bound_ms=max(b_ms, ops_ms), bytes_ms=b_ms, ops_ms=ops_ms)
        row["bound_by"] = "bytes" if b_ms >= ops_ms else "operations"
        if ratio is not None:
            row["err_over_bound"] = ratio
            self.err_ratio = max(self.err_ratio or 0.0, ratio)
        self.rows.append(row)
        sums = [self.total]
        if path is not None:
            row["path"] = path
            sums.append(self.by_path.setdefault(
                path, dict.fromkeys(self.KEYS, 0.0)))
        for total in sums:
            for key in self.KEYS:
                total[key] += count * (row[key] or 0.0)
        self.err = max(self.err, err)

    @staticmethod
    def _sums(t: dict, library: bool) -> dict:
        return {"ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"],
                "bound_by": ("bytes" if t["bytes_ms"] >= t["ops_ms"]
                             else "operations"),
                "library_ms": t["library_ms"] if library else None}

    def entry(self, replaces: str, launches: int, library: bool) -> dict:
        e = {"name": self.name, "route": "cuda",
             "source": f"src/repro_torch/csrc/{self.source}.cu",
             "replaces": replaces, "launches": launches,
             "max_abs_err": self.err, **self._sums(self.total, library),
             "err_over_bound": self.err_ratio}
        if self.by_path:
            e["per_path"] = {p: self._sums(t, library)
                             for p, t in self.by_path.items()}
        return e


def _randn(torch, rng, shape, std=1.0, dtype=None):
    t = torch.from_numpy(rng.normal(0, std, shape).astype("float32")).cuda()
    return t if dtype is None else t.to(dtype)


def check_m2q(torch, rng, calls_by_path) -> Tally:
    """m2q_matmul at every distinct (M, K, N) of each path in
    ``calls_by_path`` (the B1 forward's mixed layers; the mixed qwen's
    decode step and prefill group), summed per path, bf16 x, bit-exact;
    each row records the launch shape the wrapper chose (tile, K splits,
    blocks).  Yardstick: one bf16 torch.matmul on the dequantized
    weight.  The entry's top-level ``ms``, ``plain_ms``, ``bound_ms`` and
    ``library_ms`` sum every path given (one B1 forward, one decode step
    and one prefill group); the B1 forward's own sums, the figure the
    entry gave before the LM paths joined it, are
    ``per_path["m2q-w8a8"]``."""
    from repro_torch.core.qtensor import QM2Q
    from repro_torch.core.scheme_select import select_schemes
    from repro_torch.kernels import m2q_matmul as k
    tally = Tally("m2q_matmul")
    for path, calls in calls_by_path.items():
        for (M, K, N), n in Counter([c[1:] for c in calls]).items():
            x = _randn(torch, rng, (M, K), dtype=torch.bfloat16)
            w = _randn(torch, rng, (K, N), std=K ** -0.5)
            asn = select_schemes(w)
            qt = QM2Q.quantize(w, asn.apot_idx, asn.uniform_idx,
                               act_max_abs=float(x.abs().max()))
            del w
            args = (x, qt.act_scale, qt.payload, qt.u_scale.reshape(-1),
                    qt.u_zp.reshape(-1), qt.a_scale.reshape(-1))
            w_deq = qt.dequant(torch.bfloat16)
            # each column is computed by its own engine: int8 MACs on the
            # uniform half, bf16-exact MACs on the APoT half
            ops_ms = 2.0 * M * K * (qt.n_uniform / INT8_OPS_PER_S
                                    + qt.n_apot / BF16_FLOPS_PER_S) * 1e3
            tally.measure(dict(M=M, K=K, N=N), n,
                          lambda: k.m2q_matmul(*args),
                          lambda: k.m2q_matmul_plain(*args),
                          lambda: torch.matmul(x, w_deq),
                          M * K * 2 + K * N + 3 * N * 4 + 4 + M * N * 4,
                          ops_ms, err_bound=0.0, path=path)
            tally.rows[-1]["launch"] = k.launch_plan(M, K, N)
            del qt, args, w_deq
    return tally


def check_dwconv(torch, rng, calls) -> Tally:
    """dwconv_w4 at every distinct conv shape with bf16 x and bf16 y, the
    launch the served paths make, bit for bit against the plain version
    cast to bf16; the f32-out launch is held bit for bit too (untimed).
    Each row records the launch shape (``launch_plan``).  Bytes count y at
    its stored 2 B.  Yardstick: one cuDNN grouped conv2d (bf16,
    channels-last view, symmetric padding)."""
    import torch.nn.functional as F
    from repro_torch.core.qtensor import QUniform
    from repro_torch.kernels import dwconv_w4 as k
    tally = Tally("dwconv_w4")
    for (B, H, W, C, ks, s), n in Counter([c[1:] for c in calls]).items():
        x = _randn(torch, rng, (B, H, W, C), dtype=torch.bfloat16)
        qt = QUniform.quantize(_randn(torch, rng, (ks * ks, C), std=1 / ks),
                               bits=4)
        args = (x, qt.payload, qt.scale.reshape(-1),
                qt.zero_point.reshape(-1), ks, ks, s)
        y32, y32_ref = (k._launch(*args, torch.float32),
                        k.dwconv_w4_plain(*args, torch.float32))
        if not torch.equal(y32, y32_ref):
            fail(f"dwconv_w4 {(B, H, W, C, ks, s)} f32 out: max_abs_err "
                 f"{float((y32 - y32_ref).abs().max())}")
        del y32, y32_ref
        x_nchw = x.permute(0, 3, 1, 2)  # channels-last view, no copy
        w_oihw = qt.dequant(torch.bfloat16).reshape(ks, ks, C).permute(
            2, 0, 1).unsqueeze(1).contiguous()
        HO, WO = -(-H // s), -(-W // s)
        nbytes = (B * H * W * C * 2 + ks * ks * C // 2 + 2 * C * 4
                  + B * HO * WO * C * 2)
        ops_ms = 2.0 * B * HO * WO * C * ks * ks / F32_FLOPS_PER_S * 1e3
        tally.measure(dict(B=B, H=H, W=W, C=C, k=ks, stride=s), n,
                      lambda: k.dwconv_w4(*args, torch.bfloat16),
                      lambda: k.dwconv_w4_plain(*args, torch.bfloat16),
                      lambda: F.conv2d(x_nchw, w_oihw, stride=s,
                                       padding=ks // 2, groups=C),
                      nbytes, ops_ms, err_bound=0.0)
        tally.rows[-1]["launch"] = k.launch_plan(B, H, W, C, ks, s)
        tally.rows[-1]["f32_out_exact"] = True
    return tally


def _attn_qkv(torch, rng, B, N, Hh, D):
    """bf16 q, k, v as the MSA hands them over: column slices of one
    (B, N, 3C) tensor."""
    C = Hh * D
    qkv = _randn(torch, rng, (B, N, 3 * C), dtype=torch.bfloat16)
    return [t.reshape(B, N, Hh, D) for t in torch.split(qkv, C, dim=-1)]


def check_attn(torch, rng, calls) -> Tally:
    """relu_attn at both MSA token counts, on strided q/k/v slices of one
    qkv tensor, with bf16 q/k/v and bf16 y (the launch the served paths
    make), bit for bit against the plain version rounded once to bf16;
    the f32-out launch is held bit for bit too (untimed).  Each row
    records the launch plan (token slices a cluster, CTAs).  Bytes count
    y at its stored 2 B.  No single PyTorch call computes int8 linear
    attention; the f32 einsum path (the port's other token mixer) is
    timed as the yardstick but reported as no
    library."""
    from repro_torch.kernels import relu_attn as k
    from repro_torch.kernels import relu_attn_scales as ks
    from repro_torch.nn.attention import relu_linear_attention
    tally = Tally("relu_attn")
    for (B, N, Hh, D), n in Counter(calls).items():
        q, kk, v = _attn_qkv(torch, rng, B, N, Hh, D)
        sc = ks.relu_attn_scales_plain(q, kk, v)
        y32, y32_ref = (k._launch(q, kk, v, *sc, 1e-6),
                        k.relu_attn_plain(q, kk, v, *sc))
        if not torch.equal(y32, y32_ref):
            fail(f"relu_attn {(B, N, Hh, D)} f32 out: max_abs_err "
                 f"{float((y32 - y32_ref).abs().max())}")
        del y32, y32_ref
        C = Hh * D
        ops = B * Hh * (4.0 * N * D * D + 3.0 * N * D)
        tally.measure(dict(B=B, N=N, H=Hh, D=D), n,
                      lambda: k.relu_attn(q, kk, v, *sc,
                                          out_dtype=torch.bfloat16),
                      lambda: k.relu_attn_plain(q, kk, v, *sc,
                                                out_dtype=torch.bfloat16),
                      lambda: relu_linear_attention(q, kk, v, attn="f32"),
                      3 * B * N * C * 2 + 3 * 4 + B * N * C * 2,
                      ops / INT8_OPS_PER_S * 1e3, err_bound=0.0)
        tally.rows[-1]["launch"] = k.launch_plan(B, N, Hh, D)
        tally.rows[-1]["f32_out_exact"] = True
    return tally


def check_scales(torch, rng, calls) -> Tally:
    """relu_attn_scales at both MSA shapes, on the same strided bf16
    slices, bit for bit against the plain chain it replaces (q.max,
    k.max, |v|.max and the scalar steps after each: ~20 launches, timed
    as the plain version).  Each row records the launch plan (the one
    cluster's CTAs).  Bytes: q, k and v read once, three f32 scales
    written; operations: one comparison an element at the f32 rate.  No single PyTorch call computes the three scales (library:
    none)."""
    from repro_torch.kernels import relu_attn_scales as ks
    tally = Tally("relu_attn_scales", source="relu_attn")
    for (B, N, Hh, D), n in Counter(calls).items():
        q, kk, v = _attn_qkv(torch, rng, B, N, Hh, D)
        elems = 3 * B * N * Hh * D
        tally.measure(dict(B=B, N=N, H=Hh, D=D), n,
                      lambda: ks.relu_attn_scales(q, kk, v),
                      lambda: ks.relu_attn_scales_plain(q, kk, v), None,
                      elems * 2 + 3 * 4, elems / F32_FLOPS_PER_S * 1e3,
                      err_bound=0.0)
        tally.rows[-1]["launch"] = ks.launch_plan(B, N, Hh * D, True)
    return tally


def f32_dot_bound(torch, x, w_hat):
    """Per-element limit for two f32 dots of x (M, K) and W (K, N) summed
    in different orders: each is within K * 2^-24 * (|x| @ |W|) of the
    exact dot, so they differ by at most K * 2^-23 * (|x| @ |W|); one more
    2^-23 covers an epilogue scale multiply rounded on each side."""
    K = x.shape[1]
    return ((K + 1) * 2.0 ** -23) * (x.abs().double() @ w_hat.abs().double())


def _int_mm_fits(M, K, N) -> bool:
    """torch._int_mm's shape rules on CUDA: M > 16, K and N multiples of
    8."""
    return M > 16 and K % 8 == 0 and N % 8 == 0


def check_int8(torch, rng, calls_by_path) -> Tally:
    """int8_matmul at every distinct (M, K, N) of each path in
    ``calls_by_path`` (the uniform8 PWConvs; the int8 stem's im2col'd
    conv), summed per path, with bf16 x and bf16 y, the launch the served
    paths make, bit for bit against the plain version cast to bf16; the
    f32-y launch is held bit for bit too (untimed).  Each row records the
    launch shape (``launch_plan``).  Bytes count y at its stored 2 B.
    Yardstick: torch._int_mm on the quantized activations where its shape
    rules allow, else one bf16 torch.matmul on the dequantized weight."""
    from repro_torch.core.qtensor import QUniform
    from repro_torch.core.quant import quantize_act
    from repro_torch.kernels import int8_matmul as k
    tally = Tally("int8_matmul", source="m2q_matmul")
    for path, calls in calls_by_path.items():
        for (M, K, N), n in Counter([c[1:] for c in calls]).items():
            x = _randn(torch, rng, (M, K), dtype=torch.bfloat16)
            qt = QUniform.quantize(_randn(torch, rng, (K, N), std=K ** -0.5),
                                   bits=8, act_max_abs=float(x.abs().max()))
            args = (x, qt.payload, qt.act_scale, qt.scale.reshape(-1),
                    qt.zero_point.reshape(-1))
            y32, y32_ref = k._launch(*args), k.int8_matmul_plain(*args)
            if not torch.equal(y32, y32_ref):
                fail(f"int8_matmul {(M, K, N)} f32 out: max_abs_err "
                     f"{float((y32 - y32_ref).abs().max())}")
            del y32, y32_ref
            if _int_mm_fits(M, K, N):
                xq = quantize_act(x, qt.act_scale)
                library = lambda: torch._int_mm(xq, qt.payload)  # noqa: E731
            else:
                w_deq = qt.dequant(torch.bfloat16)
                library = lambda: torch.matmul(x, w_deq)  # noqa: E731
            tally.measure(dict(M=M, K=K, N=N), n,
                          lambda: k.int8_matmul(*args, torch.bfloat16),
                          lambda: k.int8_matmul_plain(*args, torch.bfloat16),
                          library,
                          M * K * 2 + K * N + 2 * N * 4 + 4 + M * N * 2,
                          2.0 * M * K * N / INT8_OPS_PER_S * 1e3,
                          err_bound=0.0, path=path)
            tally.rows[-1]["launch"] = k.launch_plan(M, K, N)
            tally.rows[-1]["f32_out_exact"] = True
    return tally


def check_weights_only(torch, rng, name, calls_by_path) -> Tally:
    """``int4_matmul`` (the w4-weights-only PWConvs; the qwen lm_head) or
    ``apot_matmul`` (the weights-only APoT PWConvs) at every distinct
    (M, K, N) of each path in ``calls_by_path``, summed per path; within
    the f32 summation bound (each row records its largest err / bound and
    the launch shape: kernel, tile, K splits, blocks).  Yardstick: one
    bf16 torch.matmul on the dequantized weight.  Operations count at the
    bf16 tensor-core rate: x is bf16 and each decoded weight is a
    bf16-exact value ((q - zp) an integer in [-15, 15]; an APoT value has
    at most 8 significant bits) times a per-filter scale the epilogue
    applies: the kernel's bf16 MMA with f32 sums, within the same
    summation bound."""
    from repro_torch.core.qtensor import QAPoT, QUniform
    from repro_torch.kernels import apot_matmul, int4_matmul
    k = int4_matmul if name == "int4_matmul" else apot_matmul
    kernel, plain = getattr(k, name), getattr(k, f"{name}_plain")
    tally = Tally(name, source="weights_only_matmul")
    for path, calls in calls_by_path.items():
        for (M, K, N), n in Counter([c[1:] for c in calls]).items():
            x = _randn(torch, rng, (M, K), dtype=torch.bfloat16)
            w = _randn(torch, rng, (K, N), std=K ** -0.5)
            if k is int4_matmul:
                qt = QUniform.quantize(w, bits=4)
                args = (x, qt.payload, qt.scale.reshape(-1),
                        qt.zero_point.reshape(-1))
                w_bytes = K * N // 2 + 2 * N * 4
            else:
                qt = QAPoT.quantize(w)
                args = (x, qt.codes, qt.scale.reshape(-1))
                w_bytes = K * N + N * 4
            del w
            w_hat = qt.dequant()
            w_deq = w_hat.to(torch.bfloat16)
            tally.measure(dict(M=M, K=K, N=N), n, lambda: kernel(*args),
                          lambda: plain(*args),
                          lambda: torch.matmul(x, w_deq),
                          M * K * 2 + w_bytes + M * N * 4,
                          2.0 * M * K * N / BF16_FLOPS_PER_S * 1e3,
                          err_bound=f32_dot_bound(torch, x.float(), w_hat),
                          path=path if len(calls_by_path) > 1 else None)
            tally.rows[-1]["launch"] = int4_matmul.launch_plan(M, K, N)
            del w_hat, w_deq, qt, args
    return tally


def decode_valid_rows(lengths, T: int, window=None):
    """Cache rows the decode attention must read per batch row: the valid
    ones, or all T where every position is masked (length 0)."""
    rows = []
    for n in lengths:
        lo = max(0, n - window) if window is not None else 0
        hi = min(n, T)
        rows.append(hi - lo if hi > lo else T)
    return rows


def graph_replays(torch, fn):
    """``fn()`` captured once in a CUDA graph and replayed twice: the two
    replays' outputs (cloned)."""
    graph, y = capture(fn)
    outs = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        outs.append(y.clone())
    return outs


def sdpa_reference_ms(torch, q, k8, v8, lengths, window):
    """Device ms of torch.nn.functional.scaled_dot_product_attention on
    bf16 q, k and v of the same shape (k and v repeated over the group)
    under the same mask: a float attention, not the same function, timed
    as a reference only."""
    import torch.nn.functional as F
    B, H, G, D = q.shape
    T = k8.shape[1]
    qs = q.reshape(B, H * G, 1, D)
    k, v = (t.to(torch.bfloat16).permute(0, 2, 1, 3)
            .repeat_interleave(G, dim=1).contiguous() for t in (k8, v8))
    pos = torch.arange(T, device=q.device)[None, :]
    lens = lengths.long()[:, None]
    valid = pos < lens
    if window is not None:
        valid &= pos >= lens - window
    mask = valid[:, None, None, :]
    return graph_ms(lambda: F.scaled_dot_product_attention(
        qs, k, v, attn_mask=mask))


def check_decode_attn(torch, rng, n_layers: int) -> Tally:
    """decode_attn_int8 at the token path's decode shape (B=8, T=256,
    Hkv=16, G=1, D=64, bf16 q, ragged lengths as the served run holds
    them; ``n_layers`` launches per decode step), plus a GQA shape (G=4,
    D=128), a windowed case and the decode shape at batch 1, 2 and 4,
    which the path does not run (0 launches).  Each row: the f32 store
    within two flipped p8 codes per (b, h, g) row of the plain version
    (the share of elements within 1e-6 of max |out| recorded); the bf16
    store (the served one, timed) equal to the f32 store rounded once,
    at zero tolerance; two replays of one CUDA graph of the bf16 launch
    bit-identical to each other and to the eager launch; the launch plan
    (``launch_plan``).  No single PyTorch call computes int8 decode
    attention (library: none); scaled_dot_product_attention on bf16 q, k
    and v of the same shape and mask is timed as a reference and marked
    not the same function.  Bytes: bf16 q, the valid cache rows (int8 k
    and v, f32 row scales), bf16 out."""
    from repro_torch.kernels import decode_attn_int8 as k
    from repro_torch.nn.attention import quantize_kv_rows
    tally = Tally("decode_attn_int8")
    cases = [  # (B, T, Hkv, G, D, lengths, window, launches per step)
        (8, 256, 16, 1, 64, [1, 256] + list(rng.integers(8, 137, 6)), None,
         n_layers),
        (8, 256, 4, 4, 128, list(rng.integers(1, 257, 8)), None, 0),
        (8, 256, 16, 1, 64, list(rng.integers(1, 257, 8)), 64, 0),
    ] + [(B, 256, 16, 1, 64, list(rng.integers(8, 137, B)), None, 0)
         for B in (1, 2, 4)]
    for B, T, H, G, D, lengths, window, n in cases:
        lengths = [int(x) for x in lengths]
        q = _randn(torch, rng, (B, H, G, D), dtype=torch.bfloat16)
        k8, ks = quantize_kv_rows(_randn(torch, rng, (B, T, H, D)))
        v8, vs = quantize_kv_rows(_randn(torch, rng, (B, T, H, D)))
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        args = (q, k8, v8, ks, vs, lens, D ** -0.5, window)
        shape = dict(B=B, T=T, Hkv=H, G=G, D=D, window=window,
                     lengths=lengths)

        def served():
            return k.decode_attn_int8(*args, out_dtype=torch.bfloat16)
        y32, y16 = k.decode_attn_int8(*args), served()
        if not torch.equal(y16, y32.to(torch.bfloat16)):
            fail(f"decode_attn_int8 {shape}: the bf16 store differs from "
                 "the f32 store rounded to bf16")
        replays = graph_replays(torch, served)
        if not (torch.equal(replays[0], replays[1])
                and torch.equal(replays[0], y16)):
            fail(f"decode_attn_int8 {shape}: two replays of one CUDA graph "
                 "(or the eager launch) differ")
        rows = sum(decode_valid_rows(lengths, T, window))
        nbytes = (B * H * G * D * 2 + rows * H * (2 * D + 8)
                  + B * H * G * D * 2 + B * 4)
        ops_ms = 4.0 * rows * H * G * D / INT8_OPS_PER_S * 1e3
        tally.measure(shape, n, lambda: k.decode_attn_int8(*args),
                      lambda: k.decode_attn_int8_plain(*args), None,
                      nbytes, ops_ms, err_bound=k.error_bound(*args),
                      timed=served)
        y_ref = k.decode_attn_int8_plain(*args)
        err = (y32 - y_ref).abs()
        row = tally.rows[-1]
        row["share_within_1e-6_of_max"] = float(
            (err <= 1e-6 * float(y_ref.abs().max())).float().mean())
        # the bound over every cache row, as if all T were valid
        row["bound_all_rows_ms"] = (B * H * G * D * 4 + B * T * H * (2 * D + 8)
                                    + B * 4) / HBM_BYTES_PER_S * 1e3
        row["launch"] = k.launch_plan(B, T, H, G, D)
        row["bf16_store_is_f32_cast"] = True
        row["graph_replays_identical"] = True
        row["sdpa_ms_not_same_function"] = sdpa_reference_ms(
            torch, q, k8, v8, lens, window)
    return tally


def _get(tree, path):
    for part in path.split("/"):
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return tree


# per recipe path: the leaf each (dense, depthwise, stem) weight becomes,
# as leaf_kind() names it, and the kernel launches of one forward as
# multiples of (dense, depthwise, attention) calls plus fixed extras
PATHS = {
    "m2q-w8a8": (("QM2Q+act", "QUniform4", "float"),
                 {"m2q_matmul": "dense", "dwconv_w4": "dw",
                  "relu_attn": "attn", "relu_attn_scales": "attn"}),
    "uniform8": (("QUniform8+act", "QUniform8", "float"),
                 {"int8_matmul": "dense", "relu_attn": "attn",
                  "relu_attn_scales": "attn"}),
    "int8-stem": (("QM2Q+act", "QUniform4", "QUniform8+act"),
                  {"int8_matmul": 1, "m2q_matmul": "dense",
                   "dwconv_w4": "dw", "relu_attn": "attn",
                   "relu_attn_scales": "attn"}),
    "w4-weights-only": (("QUniform4", "QUniform4", "float"),
                        {"int4_matmul": "dense", "dwconv_w4": "dw",
                         "relu_attn": "attn", "relu_attn_scales": "attn"}),
    "apot-weights-only": (("QAPoT", "QUniform4", "float"),
                          {"apot_matmul": "dense", "dwconv_w4": "dw",
                           "relu_attn": "attn",
                           "relu_attn_scales": "attn"}),
}


def path_recipe(name: str):
    """The recipe of one path, built through the port's public API (the
    int8 stem and weights-only APoT are recipes, not presets)."""
    from repro_torch import recipe
    from repro_torch.core.policy import M2QPolicy
    from repro_torch.models import efficientvit as ev
    if name == "int8-stem":
        return recipe.PRESETS["m2q-w8a8"].replace(
            rules=tuple(ev.QUANT_RULES) + (ev.STEM_RULE,),
            overrides=(ev.STEM_OVERRIDE,))
    if name == "apot-weights-only":
        return recipe.QuantRecipe(name=name, policy=M2QPolicy(
            compute_scheme="apot", quantize_activations=False))
    return recipe.PRESETS[name]


def leaf_kind(leaf) -> str:
    from repro_torch.core.qtensor import QAPoT, QM2Q, QUniform
    act = "+act" if getattr(leaf, "act_scale", None) is not None else ""
    if isinstance(leaf, QM2Q):
        return "QM2Q" + act
    if isinstance(leaf, QUniform):
        return f"QUniform{leaf.bits}" + act
    if isinstance(leaf, QAPoT):
        return "QAPoT" + act
    return "float"


ARTIFACTS = ROOT / "build" / "chip_smoke_artifacts"
# the artifacts phase 8 serves again; main() removes them at the end
KEPT_ARTIFACTS = ("m2q-w8a8", "token")


def _bits(torch, t):
    """``t``'s bits as an integer tensor (equal bits, not equal values)."""
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def check_same_model(torch, what, a, b) -> None:
    """Fail unless ``b`` (a loaded artifact) holds ``a``'s model: every
    leaf of the same class with equal static fields and bit-identical
    tensors on the card, and equal cfg, recipe, reports and act_stats."""
    import dataclasses
    from repro_torch.core.tree import leaves_with_path
    la, lb = dict(leaves_with_path(a.params)), dict(leaves_with_path(b.params))
    if sorted(la) != sorted(lb):
        fail(f"{what}: the loaded tree's leaves differ: "
             f"{sorted(set(la) ^ set(lb))[:5]}")
    for key, x in la.items():
        y = lb[key]
        if type(x) is not type(y):
            fail(f"{what}: {key} loaded as {type(y).__name__}, saved as "
                 f"{type(x).__name__}")
        pairs = ({"": (x, y)} if isinstance(x, torch.Tensor) else
                 {f.name: (getattr(x, f.name), getattr(y, f.name))
                  for f in dataclasses.fields(x)})
        for field, (u, v) in pairs.items():
            if isinstance(u, torch.Tensor):
                same = (isinstance(v, torch.Tensor) and u.dtype == v.dtype
                        and u.shape == v.shape and v.device.type == "cuda"
                        and torch.equal(_bits(torch, u), _bits(torch, v)))
            else:
                same = u == v
            if not same:
                fail(f"{what}: {key} {field} is not bit-identical after "
                     "save and load")
    for field in ("cfg", "recipe", "report", "act_stats", "provenance"):
        if getattr(a, field) != getattr(b, field):
            fail(f"{what}: the loaded {field} differs from the saved one")


def round_trip(torch, qm, what: str):
    """``qm.save`` and ``QuantizedModel.load(..., device="cuda")``, timed;
    fails unless the loaded model is ``qm``'s.  Returns (the loaded
    model, {artifact_bytes, save_s, load_s}).  The artifact is removed,
    but for the paths in ``KEPT_ARTIFACTS``."""
    import shutil
    from repro_torch import recipe
    path = ARTIFACTS / what
    if path.exists():
        shutil.rmtree(path)
    torch.cuda.synchronize()
    try:  # fail() exits through here too: no artifact stays behind
        t0 = time.perf_counter()
        step_dir = qm.save(path)
        t1 = time.perf_counter()
        loaded = recipe.QuantizedModel.load(path, device="cuda")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        size = sum(f.stat().st_size for f in step_dir.iterdir())
        check_same_model(torch, what, qm, loaded)
    finally:
        if what not in KEPT_ARTIFACTS:
            shutil.rmtree(path, ignore_errors=True)
    return loaded, {"artifact_bytes": size, "save_s": t1 - t0,
                    "load_s": t2 - t1}


def poll_until_done(engine, handles, what: str) -> None:
    """Poll a VisionEngine until every handle is done (300 s at most)."""
    t0 = time.perf_counter()
    while not all(h.done() for h in handles):
        if time.perf_counter() - t0 > 300:
            fail(f"{what}: requests still pending after 300 s of polling")
        engine.poll()
        time.sleep(0.001)


def run_path(torch, cfg, name, calls, out_dir, full: bool):
    """Quantize a full-width B1 under one recipe path, serve 12 images
    eagerly and from the engine's CUDA graphs, and check leaves, launch
    counters and logits.  ``full``: also time the eager and plain-version
    forwards and trace one with torch.profiler."""
    import numpy as np
    from repro_torch import kernels, recipe
    from repro_torch.kernels import ops
    from repro_torch.models import efficientvit

    m2q_calls, dw_calls, attn_calls = calls
    leaves_want, per_fwd = PATHS[name]
    n_calls = {"dense": len(m2q_calls), "dw": len(dw_calls),
               "attn": len(attn_calls)}
    want = {k: n_calls[v] if isinstance(v, str) else v
            for k, v in per_fwd.items()}

    t0 = time.perf_counter()
    params = efficientvit.init(cfg, seed=0, device="cuda")
    qm = recipe.quantize(cfg, params, path_recipe(name))
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    roles = ([(path, 0) for path, *_ in m2q_calls]
             + [(path, 1) for path, *_ in dw_calls] + [("stem/w", 2)])
    for path, role in roles:
        got = leaf_kind(_get(qm.params, path))
        if got != leaves_want[role]:
            fail(f"{name}: {path} is a {got} leaf, expected "
                 f"{leaves_want[role]}")
    for path, M, K, N in m2q_calls:
        leaf = _get(qm.params, path)
        rows = getattr(leaf, "payload", getattr(leaf, "codes", None))
        if rows.shape[0] != K:
            fail(f"{name}: {path} payload {tuple(rows.shape)}, K={K}")

    rng = np.random.default_rng(1)
    images = rng.normal(0, 1, (N_IMAGES, cfg.img_res, cfg.img_res, 3)
                        ).astype(np.float32)

    def check_launches(counts, forwards, what):
        for kname, c in counts.items():
            if c["launches"] != want.get(kname, 0) * forwards \
                    or c["plain_calls"] != 0:
                fail(f"{name} {what}: {kname} {c} over {forwards} forwards, "
                     f"expected {want.get(kname, 0) * forwards} launches "
                     "and 0 plain calls")

    # each mode serves the 12 images twice (the graph mode's first pass
    # captures its buckets) and classifies them once; every pass runs the
    # same batches (8, then 4), so every logit must equal the first pass's
    served, seconds, classify_s, pass_counts = {}, {}, {}, {}
    for graphs in (False, True):
        mode = "graph" if graphs else "eager"
        engine = qm.serve(max_batch=BATCH, max_delay_ms=50.0, graphs=graphs)
        for rep in ("warm", "timed"):
            b0 = engine.stats.batches
            kernels.reset_counts()
            t1 = time.perf_counter()
            handles = [engine.submit(img) for img in images]
            poll_until_done(engine, handles, name)
            torch.cuda.synchronize()
            seconds[mode, rep] = time.perf_counter() - t1
            counts = kernels.counts()
            # re-raises failures, a failed capture's included
            served[mode, rep] = np.stack([h.result() for h in handles])
            forwards = engine.stats.batches - b0
            if forwards != 2 or engine.stats.buckets_used != {8, 4}:
                fail(f"{name} {mode}: expected batches of 8 and 4, got "
                     f"{forwards} batches over buckets "
                     f"{sorted(engine.stats.buckets_used)}")
            check_launches(counts, forwards, f"{mode} {rep}")
            pass_counts[mode, rep] = counts
            if graphs and rep == "warm":
                capture_s = engine.step_graphs.capture_s
                if len(engine.step_graphs) != 2:
                    fail(f"{name}: {len(engine.step_graphs)} graphs "
                         "captured for buckets 8 and 4")
        kernels.reset_counts()
        t1 = time.perf_counter()
        served[mode, "classify"] = engine.classify(images)
        classify_s[mode] = time.perf_counter() - t1
        check_launches(kernels.counts(), 2, f"{mode} classify")
    logits = served["eager", "warm"]
    for key, got in served.items():
        if not np.array_equal(got, logits):
            fail(f"{name}: {key} logits differ from the eager engine's by "
                 f"{float(np.abs(got - logits).max())} on the same batches")
    if logits.shape != (N_IMAGES, cfg.n_classes) \
            or not np.all(np.isfinite(logits)):
        fail(f"{name}: logits shape {logits.shape} or non-finite values")

    # the artifact: save, load on the card, serve the same 12 images from
    # a new engine's CUDA graphs; logits and launches equal the original's
    loaded, artifact = round_trip(torch, qm, name)
    engine2 = loaded.serve(max_batch=BATCH, max_delay_ms=50.0, graphs=True)
    kernels.reset_counts()
    handles = [engine2.submit(img) for img in images]
    poll_until_done(engine2, handles, f"{name} loaded")
    if kernels.counts() != pass_counts["graph", "warm"]:
        fail(f"{name}: the loaded model's launches {kernels.counts()} "
             f"differ from the original's {pass_counts['graph', 'warm']}")
    got = np.stack([h.result() for h in handles])
    if not np.array_equal(got, served["graph", "warm"]):
        fail(f"{name}: the loaded model's graph-served logits differ from "
             f"the original's by "
             f"{float(np.abs(got - served['graph', 'warm']).max())}")
    del loaded, engine2

    with ops.reference_path():
        ref = np.concatenate([
            qm.forward(images[:BATCH]).float().cpu().numpy(),
            qm.forward(images[BATCH:]).float().cpu().numpy()])
    diff = float(np.abs(logits - ref).max())
    top = float(np.abs(ref).max())
    same_argmax = int((logits.argmax(-1) == ref.argmax(-1)).sum())
    # bf16 activations: one bf16 ulp is 2^-8 of a value, so allow a few
    # ulps of the largest logit for a rounding slip anywhere upstream
    if not diff <= 2e-2 * top:
        fail(f"{name}: served logits differ from the plain forward by "
             f"{diff} (max |logit| {top})")

    x8 = torch.from_numpy(images[:BATCH]).cuda()
    with torch.inference_mode():
        fwd_graph_ms = graph_ms(lambda: qm.forward(x8), iters=3)
    res = dict(path=name, quantize_s=t_quant,
               serve_12_images_s={m: seconds[m, "timed"]
                                  for m in ("eager", "graph")},
               images_per_s={m: N_IMAGES / seconds[m, "timed"]
                             for m in ("eager", "graph")},
               serve_12_images_first_pass_s={
                   m: seconds[m, "warm"] for m in ("eager", "graph")},
               graph_capture_s=capture_s,
               classify_12_images_s=classify_s,
               classify_images_per_s={m: N_IMAGES / t
                                      for m, t in classify_s.items()},
               forwards=forwards,
               launches_per_forward={k: c["launches"] // forwards
                                     for k, c in counts.items()
                                     if c["launches"]},
               logits_max_abs_diff=diff, logits_max_abs=top,
               logits_exact=bool(diff == 0.0), same_argmax=same_argmax,
               forward_b8_graph_ms=fwd_graph_ms, artifact=artifact,
               serve_stats=engine.stats.summary())
    if full:
        res["forward_b8_ms"] = cuda_ms(lambda: qm.forward(x8), iters=10)
        with ops.reference_path():
            res["plain_forward_b8_ms"] = cuda_ms(lambda: qm.forward(x8),
                                                 iters=3, warmup=1)
        trace = device_profile(lambda: qm.forward(x8))
        if trace:  # busy share of the unprofiled eager forward
            trace["busy_share"] = trace["busy_ms"] / res["forward_b8_ms"]
        res["forward_b8_trace"] = trace
    (out_dir / f"chip_smoke_path_{name}.json").write_text(
        json.dumps(res, indent=1))
    print(f"path {name}:", json.dumps(res), flush=True)
    del qm, params, engine
    torch.cuda.empty_cache()
    return counts


# the token paths: qwen1.5-0.5b at full width, int8 KV cache
TOKEN_BATCH = 8
TOKEN_MAX_LEN = 256
N_REQUESTS = 16
# one prefill group of the m2q_matmul checks: 8 prompts of 128 tokens
PREFILL_LEN = 128
# the stacked layer matmuls a calibrated mixed qwen runs per layer
LM_MIXED = ("attn/wq", "attn/wk", "attn/wv", "attn/wo", "mlp/w2")
LM_FOLDED = ("mlp/w1", "mlp/w3")


def token_recipe(name: str):
    """``token``: m2q-w8a8 at the decode deployment shape (2 tokens a step
    from the calibration batch: every leaf 4-bit); ``token-m2q``: at 64
    tokens a step, the prefill side of the same server (the mixed LM)."""
    from repro_torch import recipe
    rec = recipe.PRESETS["m2q-w8a8"]
    return rec.replace(tokens_per_step=64) if name == "token-m2q" else rec


def token_m2q_calls(cfg, batch: int, prefill_len: int):
    """m2q_matmul's calls (path, M, K, N) in one decode step and in one
    prefill group of ``prefill_len``-token prompts of the mixed qwen: the
    five stacked matmuls of every layer, then the lm_head (on the last
    position of each prompt)."""
    def layers(M):
        shapes = {"attn/wq": (cfg.d_model, cfg.q_dim),
                  "attn/wk": (cfg.d_model, cfg.kv_dim),
                  "attn/wv": (cfg.d_model, cfg.kv_dim),
                  "attn/wo": (cfg.q_dim, cfg.d_model),
                  "mlp/w2": (cfg.d_ff, cfg.d_model)}
        return [(f"layers/{p}@{i}", M, *shapes[p])
                for i in range(cfg.n_layers) for p in LM_MIXED]
    head = ("lm_head", batch, cfg.d_model, cfg.padded_vocab)
    return {"token-m2q decode step": layers(batch) + [head],
            "token-m2q prefill group": layers(batch * prefill_len) + [head]}


def token_requests(cfg):
    """16 seeded requests: prompts of 8-96 tokens, 24-40 new tokens, the
    last two at temperature 0.8."""
    import numpy as np
    rng = np.random.default_rng(2)
    reqs = []
    for i in range(N_REQUESTS):
        prompt = rng.integers(0, cfg.vocab_size, int(rng.integers(8, 97)),
                              dtype=np.int32)
        reqs.append((prompt, int(rng.integers(24, 41)),
                     0.8 if i >= N_REQUESTS - 2 else 0.0))
    return reqs


def token_margins(logits, served) -> dict:
    """Where a served token (``served`` (steps, B)) is not the argmax of
    the teacher-forced ``logits`` (steps, B, vocab): the logits' top-2
    margin there and the served token's gap below the top."""
    import numpy as np
    from repro_torch.launch.daemon import token_gaps
    top2 = np.sort(logits, axis=-1)[..., -2:]
    gap = token_gaps(logits, served)
    at = np.argwhere(served != logits.argmax(-1))
    rows = [{"step": int(t), "request": int(b),
             "top2_margin": float(top2[t, b, 1] - top2[t, b, 0]),
             "served_gap": float(gap[t, b])} for t, b in at]
    return {"positions": int(served.size), "mismatches": rows,
            "largest_top2_margin": max((r["top2_margin"] for r in rows),
                                       default=0.0),
            "largest_gap": max((r["served_gap"] for r in rows), default=0.0)}


def check_token_leaves(qm, name: str) -> None:
    """``token``: every quantized leaf a 4-bit QUniform (axis 0 embed, 1
    lm_head, 2 the stacked layers).  ``token-m2q``: wq, wk, wv, wo and w2
    QExpertM2Q leaves of L layers with (L, 1, 1) activation scales, w1
    and w3 perm-folded 3-D QM2Q leaves without one, a calibrated 2-D QM2Q
    lm_head and a 4-bit axis-0 QUniform embed."""
    from repro_torch.core.qtensor import QExpertM2Q, QM2Q, QUniform
    L = qm.cfg.n_layers
    if len(qm.report) != 9:
        fail(f"{name} path: {len(qm.report)} quantized leaves, expected 9")
    for r in qm.report:
        leaf = _get(qm.params, r.path)
        got = f"{type(leaf).__name__} payload " \
              f"{tuple(getattr(leaf, 'payload', leaf).shape)}"
        if name == "token" or r.path == "embed":
            want_axis = {"embed": 0, "lm_head": 1}.get(r.path, 2)
            ok = (isinstance(leaf, QUniform) and leaf.bits == 4
                  and leaf.axis == want_axis and leaf.act_scale is None
                  and (want_axis != 2 or leaf.payload.shape[0] == L))
            want = f"a 4-bit QUniform with axis {want_axis}"
        elif r.path == "lm_head":
            ok = (type(leaf) is QM2Q and leaf.payload.ndim == 2
                  and leaf.act_scale is not None)
            want = "a 2-D QM2Q with an activation scale"
        elif r.path.split("/", 1)[1] in LM_FOLDED:
            ok = (type(leaf) is QM2Q and leaf.payload.ndim == 3
                  and leaf.payload.shape[0] == L and leaf.act_scale is None
                  and r.decision == "mixed(perm-folded)")
            want = f"a perm-folded QM2Q of {L} layers, no activation scale"
        else:
            ok = (isinstance(leaf, QExpertM2Q) and leaf.payload.ndim == 3
                  and leaf.payload.shape[0] == L
                  and leaf.act_scale is not None
                  and tuple(leaf.act_scale.shape) == (L, 1, 1))
            want = f"a QExpertM2Q of {L} layers, (L, 1, 1) activation scale"
        if not ok:
            fail(f"{name} path: {r.path} is {got}, expected {want}")


def token_launches(cfg, name: str, steps: int, groups: int) -> dict:
    """The kernel launches of ``steps`` decode steps and ``groups``
    prefill groups: decode_attn_int8 once per layer and step; the lm_head
    on int4_matmul (``token``), or every stacked layer matmul and the
    lm_head on m2q_matmul (``token-m2q``), in each step and group."""
    want = {"decode_attn_int8": cfg.n_layers * steps}
    if name == "token":
        want["int4_matmul"] = steps + groups
    else:
        want["m2q_matmul"] = (len(LM_MIXED) * cfg.n_layers + 1) \
            * (steps + groups)
    return want


def plain_dequant_ms(torch, qm) -> dict:
    """Device ms one decode step spends dequantizing the stacked layer
    weights that no kernel takes (their ``x @ dequant(W)`` in bf16): per
    such leaf, its layer-0 slice's ``dequant(bfloat16)`` timed in a CUDA
    graph, times the layer count."""
    from repro_torch.core.qtensor import slice_layer
    from repro_torch.kernels import ops
    out = {}
    for r in qm.report:
        if not r.path.startswith("layers/"):
            continue
        layer = slice_layer(_get(qm.params, r.path), 0)
        if not ops.kernel_supported(layer):
            out[r.path] = qm.cfg.n_layers * graph_ms(
                lambda: layer.dequant(torch.bfloat16), iters=5)
    return out


def run_token_path(torch, out_dir, name: str):
    """Quantize qwen1.5-0.5b at full width (int8 KV cache) under the
    ``name`` recipe (:func:`token_recipe`) on the card, serve 16 requests
    through the token Engine eagerly and from its CUDA graphs, and check
    leaves, launch counters, token counts, graph-vs-eager tokens and
    teacher-forced logits against reference_path(); time the decode step
    and trace one."""
    import numpy as np
    from repro_torch import kernels, recipe
    from repro_torch.configs.registry import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.launch.daemon import (TEACHER_FORCED_BOUND,
                                           teacher_forced_logits)
    from repro_torch.models import dense_lm

    cfg = ARCHS["qwen1.5-0.5b"].replace(kv_cache_dtype="int8")
    t0 = time.perf_counter()
    params = dense_lm.init(cfg, seed=0, device="cuda")
    qm = recipe.quantize(cfg, params, token_recipe(name))
    del params
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    check_token_leaves(qm, name)

    # each mode serves the 16 requests twice from seed 0 (the graph
    # mode's first pass captures its two decode steps); the second pass
    # draws on from the first's generator state, so every pass's tokens
    # must equal the eager engine's pass for pass
    reqs = token_requests(cfg)
    served, seconds, passes, pass_counts = {}, {}, {}, {}
    for graphs in (False, True):
        mode = "graph" if graphs else "eager"
        engine = qm.serve(max_batch=TOKEN_BATCH, max_len=TOKEN_MAX_LEN,
                          seed=0, graphs=graphs)
        for rep in ("warm", "timed"):
            s0 = (engine.stats.steps, engine.stats.prefill_batches)
            kernels.reset_counts()
            t1 = time.perf_counter()
            handles = [engine.submit(p, max_new_tokens=n, temperature=t)
                       for p, n, t in reqs]
            engine.run()
            torch.cuda.synchronize()
            seconds[mode, rep] = time.perf_counter() - t1
            counts = kernels.counts()
            # re-raises failures, a failed capture's included
            outs = served[mode, rep] = [h.handle.result() for h in handles]
            steps = engine.stats.steps - s0[0]
            groups = engine.stats.prefill_batches - s0[1]
            passes[f"{mode} {rep}"] = {"decode_steps": steps,
                                       "prefill_groups": groups}
            pass_counts[f"{mode} {rep}"] = counts
            for (p, n, _), toks in zip(reqs, outs):
                if len(toks) != n \
                        or not all(0 <= t < cfg.vocab_size for t in toks):
                    fail(f"{name} path: a request asked for {n} tokens "
                         f"and got {len(toks)} (or ids outside the vocab)")
            want = token_launches(cfg, name, steps, groups)
            for kname, c in counts.items():
                if c["launches"] != want.get(kname, 0) \
                        or c["plain_calls"] != 0:
                    fail(f"{name} path {mode} {rep}: {kname} {c} over {steps}"
                         f" decode steps and {groups} prefill groups, "
                         f"expected {want.get(kname, 0)} launches and 0 "
                         "plain calls")
            if graphs and rep == "warm":
                capture_s = engine.step_graphs.capture_s
                if len(engine.step_graphs) != 2:
                    fail(f"{name} path: {len(engine.step_graphs)} decode "
                         "graphs captured, expected a greedy and a drawing "
                         "one")
    for rep in ("warm", "timed"):
        for i, (a, b) in enumerate(zip(served["eager", rep],
                                       served["graph", rep])):
            if a != b:
                fail(f"{name} path {rep}: request {i}'s graph-served tokens "
                     f"differ from the eager engine's: {b} vs {a}")
    outs = served["eager", "warm"]
    generated = sum(len(t) for t in outs)
    stats = engine.stats

    # where a graphed pass's time goes: one more pass with every prefill
    # group and decode step timed between synchronizes
    split = Counter()

    def timed(fn, key):
        def call(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                return fn(*args)
            finally:
                torch.cuda.synchronize()
                split[key] += time.perf_counter() - t
        return call

    engine._prefill_group = timed(engine._prefill_group, "prefill_s")
    engine._decode = timed(engine._decode, "decode_s")
    t1 = time.perf_counter()
    for p, n, t in reqs:
        engine.submit(p, max_new_tokens=n, temperature=t)
    engine.run()
    torch.cuda.synchronize()
    split["pass_s"] = time.perf_counter() - t1
    del engine._prefill_group, engine._decode

    # the artifact (~0.3 GB of 4-bit payload; ~0.54 GB mixed): save, load,
    # serve the 16 requests from a new engine's decode-step graphs at
    # seed 0; tokens and launches equal the original's first graph pass
    loaded, artifact = round_trip(torch, qm, name)
    engine2 = loaded.serve(max_batch=TOKEN_BATCH, max_len=TOKEN_MAX_LEN,
                           seed=0, graphs=True)
    kernels.reset_counts()
    handles = [engine2.submit(p, max_new_tokens=n, temperature=t)
               for p, n, t in reqs]
    engine2.run()
    if kernels.counts() != pass_counts["graph warm"]:
        fail(f"{name} path: the loaded model's launches {kernels.counts()} "
             f"differ from the original's {pass_counts['graph warm']}")
    for i, h in enumerate(handles):
        if h.handle.result() != served["graph", "warm"][i]:
            fail(f"{name} path: request {i}'s tokens from the loaded model "
                 "differ from the original's")
    del loaded, engine2

    # teacher-forced logits, kernels vs plain versions: two greedy
    # requests, their served tokens fed back
    pick = [0, 1]
    steps = min(reqs[i][1] for i in pick) - 1
    prompts = [reqs[i][0] for i in pick]
    forced = np.array([outs[i][:steps] for i in pick]).T
    got = teacher_forced_logits(cfg, qm.params, prompts, forced,
                                TOKEN_MAX_LEN)
    with ops.reference_path():
        ref = teacher_forced_logits(cfg, qm.params, prompts, forced,
                                    TOKEN_MAX_LEN)
    diff = float((got - ref).abs().max())
    top = float(ref.abs().max())
    same_argmax = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    served = np.array([outs[i][:steps + 1] for i in pick]).T  # (steps+1, B)
    served_match = float(np.mean(served == got.argmax(-1).cpu().numpy()))
    margins = token_margins(got.cpu().numpy(), served)
    # bf16 activations through 24 layers: a flipped p8 code in any
    # layer's attention, or the lm_head's f32 sums landing on the other
    # side of a bf16 rounding, moves every later value by a bf16 ulp;
    # 5e-2 of the largest logit is ~8 bf16 ulps of it (0.051-0.086 of a
    # 5.19 max |logit| measured on an H100 at 700 W); a served token may
    # sit below the teacher-forced argmax by no more than that bound
    bound = TEACHER_FORCED_BOUND * top
    if not diff <= bound:
        fail(f"{name} path: teacher-forced logits differ from the plain "
             f"versions' by {diff} (max |logit| {top})")
    within_bound = bool(margins["largest_gap"] <= bound)
    print(f"{name} path served-vs-teacher-forced mismatches:", json.dumps(dict(
        margins, bound=bound, within_bound=within_bound)), flush=True)
    if not within_bound:
        fail(f"{name} path: a served token sits {margins['largest_gap']} "
             f"below the teacher-forced argmax, over the bound {bound}")

    # the batch-8 decode step at the served run's cache lengths
    cache = {k: v.clone() for k, v in engine.cache.items()}
    cache["lengths"].copy_(torch.tensor(
        [min(len(p) + 30, TOKEN_MAX_LEN - 1) for p, _, _ in
         reqs[:TOKEN_BATCH]], dtype=torch.int32, device="cuda"))
    tok = torch.zeros((TOKEN_BATCH, 1), dtype=torch.int64, device="cuda")

    def step():
        return dense_lm.decode_step(cfg, qm.params, cache, tok)

    res = dict(path=f"qwen1.5-0.5b int8-kv m2q-w8a8, "
                    f"{qm.recipe.tokens_per_step} tokens/step",
               quantize_s=t_quant,
               serve_s={m: seconds[m, "timed"] for m in ("eager", "graph")},
               requests=len(reqs), tokens=generated,
               tokens_per_s={m: generated / seconds[m, "timed"]
                             for m in ("eager", "graph")},
               serve_first_pass_s={m: seconds[m, "warm"]
                                   for m in ("eager", "graph")},
               graph_capture_s=capture_s, graph_pass_split=split,
               passes=passes, artifact=artifact,
               decode_steps=passes["graph timed"]["decode_steps"],
               prefill_groups=passes["graph timed"]["prefill_groups"],
               launches={k: c["launches"] for k, c in counts.items()
                         if c["launches"]},
               teacher_forced_max_abs_diff=diff, logits_max_abs=top,
               teacher_forced_same_argmax=same_argmax,
               served_tokens_match_teacher_forced_argmax=served_match,
               mismatch_margins=margins,
               serve_stats=stats.summary(),
               decode_lengths=cache["lengths"].tolist())
    with torch.no_grad():
        res["decode_step_ms"] = cuda_ms(step, iters=10)
        with ops.reference_path():
            res["plain_decode_step_ms"] = cuda_ms(step, iters=3, warmup=1)
        try:
            res["decode_step_graph_ms"] = graph_ms(step, iters=3)
        except Exception as e:  # noqa: BLE001 -- a failed phase fails the run
            fail(f"{name} path: the decode step did not run in a CUDA graph: "
                 f"{e!r}"[:400])
        trace = device_profile(step, top=8)
        res["plain_dequant_ms_per_step"] = plain_dequant_ms(torch, qm)
    if trace:
        trace["busy_share"] = trace["busy_ms"] / res["decode_step_ms"]
    res["decode_step_trace"] = trace
    (out_dir / f"chip_smoke_path_{name}.json").write_text(
        json.dumps(res, indent=1))
    print(f"path {name}:", json.dumps(res), flush=True)
    del qm, engine, cache
    torch.cuda.empty_cache()
    return counts


def payload_diff(torch, a, b) -> dict:
    """Where two quantized trees of one model differ: payload / code
    bytes, Eq. 6 splits, and the largest relative difference of each
    kind of scale."""
    import dataclasses
    from repro_torch.core.qtensor import is_qtensor
    from repro_torch.core.tree import leaves_with_path
    lb = dict(leaves_with_path(b))
    out = {"payload_bytes": 0, "payload_bytes_differing": 0,
           "leaves_differing": [], "splits_differing": [],
           "max_rel_diff": {}}
    for key, x in leaves_with_path(a):
        y = lb[key]
        if not is_qtensor(x):
            continue
        if getattr(x, "n_apot", None) != getattr(y, "n_apot", None):
            out["splits_differing"].append(key)
        for f in dataclasses.fields(x):
            u, v = getattr(x, f.name), getattr(y, f.name)
            if not isinstance(u, torch.Tensor) or v is None:
                continue
            if f.name in ("payload", "codes"):
                n = int((u.view(torch.uint8) != v.view(torch.uint8)).sum())
                out["payload_bytes"] += u.numel()
                out["payload_bytes_differing"] += n
                if n:
                    out["leaves_differing"].append(key)
            else:
                rel = float(((u - v).abs() / u.abs().clamp(min=1e-30))
                            .max())
                out["max_rel_diff"][f.name] = max(
                    rel, out["max_rel_diff"].get(f.name, 0.0))
    return out


def run_proxy(torch, out_dir):
    """The trained proxy (the reduced B1 trained by the JAX package): load
    its committed JAX-written m2q-w8a8 artifact on the card and classify
    the 256 images of ``expected.json`` through the kernels with int8
    attention (counters zeroed before, read after) and with f32
    attention.  Both are held against the same forward under
    ``reference_path()`` (exactly), and the f32-attention logits against
    the JAX package's (:func:`proxy_vs_jax`).  Reports top-1 beside
    JAX's, the float proxy's top-1, and the port's own quantization of the
    float proxy on the card (same four calibration batches): its top-1 and
    how its payloads differ from JAX's."""
    import numpy as np
    from repro_torch import kernels, recipe
    from repro_torch.data import proxy
    from repro_torch.kernels import ops

    expected = json.loads((proxy.ARTIFACT / "expected.json").read_text())
    labels = np.array(expected["labels"])
    jax_preds = np.array(expected["quantized"]["predictions"])
    jax_logits = np.array(expected["quantized"]["logits"], np.float32)
    t0 = time.perf_counter()
    qm = recipe.QuantizedModel.load(proxy.ARTIFACT, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0

    def run(params, attn):
        out, y = proxy.logits(params, attn=attn)
        if not np.array_equal(y, labels):
            fail("proxy: the images' labels differ from expected.json's")
        if out.shape != (len(labels), proxy.CFG.n_classes) \
                or not np.all(np.isfinite(out)):
            fail(f"proxy {attn}: logits shape {out.shape} or non-finite "
                 "values")
        return out, out.argmax(-1), float(np.mean(out.argmax(-1) == labels))

    kernels.reset_counts()
    logits_int8, preds_int8, acc_int8 = run(qm.params, "int8")
    counts = kernels.counts()
    launched = {k: c["launches"] for k, c in counts.items() if c["launches"]}
    print("proxy forward launches (8 batches of 32, int8 attention):",
          json.dumps(launched), flush=True)
    want = ("m2q_matmul", "dwconv_w4", "relu_attn", "relu_attn_scales")
    if any(c["plain_calls"] for c in counts.values()) \
            or sorted(launched) != sorted(want):
        fail(f"proxy: launches {counts}, expected kernels {want} only and "
             "no plain calls")
    logits_f32, preds_f32, acc_f32 = run(qm.params, "f32")

    # the kernels at the reduced shapes against their plain versions: all
    # four are bit-exact with them and the activations are f32, so exact
    vs_plain = {}
    with ops.reference_path():
        for attn, got in (("int8", logits_int8), ("f32", logits_f32)):
            ref, _, _ = run(qm.params, attn)
            diff = float(np.abs(got - ref).max())
            vs_plain[attn] = dict(logits_max_abs_diff=diff,
                                  logits_max_abs=float(np.abs(ref).max()))
            if diff != 0.0:
                fail(f"proxy {attn}: kernel logits differ from the plain "
                     f"forward by {diff}")

    # the f32-attention forward against the JAX package's
    if not np.array_equal(jax_logits.argmax(-1), jax_preds):
        fail("proxy: expected.json's logits and predictions disagree")
    vs_jax, failures = proxy_vs_jax(logits_f32, jax_logits)
    if failures:
        fail("proxy: f32 attention: " + "; ".join(failures))

    float_params = proxy.load_proxy("cuda")
    float_logits, float_preds, acc_float = run(float_params, "f32")
    t0 = time.perf_counter()
    port = recipe.quantize(proxy.CFG, float_params, "m2q-w8a8",
                           calib_batches=proxy.calib_batches(), attn="f32")
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    _, _, port_acc_int8 = run(port.params, "int8")
    _, port_f32, port_acc_f32 = run(port.params, "f32")
    res = dict(
        cfg=proxy.CFG.name, images=len(labels), artifact_load_s=load_s,
        jax=dict(float_top1=expected["float"]["accuracy"],
                 m2q_top1=expected["quantized"]["accuracy"]),
        float_top1=acc_float,
        float_predictions_differing=int(
            (float_preds != np.array(expected["float"]["predictions"]))
            .sum()),
        float_logits_max_abs_diff_vs_jax=float(np.abs(
            float_logits - np.array(expected["float"]["logits"],
                                    np.float32)).max()),
        jax_artifact=dict(top1_int8_attn=acc_int8, top1_f32_attn=acc_f32,
                          vs_plain=vs_plain, f32_vs_jax=vs_jax,
                          bounds=dict(float=PROXY_FLOAT,
                                      images_off=PROXY_IMAGES_OFF,
                                      logits=PROXY_LOGITS,
                                      predictions=PROXY_MISMATCHES),
                          int8_predictions_differing=int(
                              (preds_int8 != jax_preds).sum())),
        port_quantized=dict(quantize_s=quant_s, top1_int8_attn=port_acc_int8,
                            top1_f32_attn=port_acc_f32,
                            f32_predictions_differing=int(
                                (port_f32 != jax_preds).sum()),
                            vs_jax_artifact=payload_diff(
                                torch, qm.params, port.params)),
        launches=launched)
    (out_dir / "chip_smoke_proxy.json").write_text(json.dumps(res, indent=1))
    print("proxy:", json.dumps(res), flush=True)
    del qm, port, float_params
    torch.cuda.empty_cache()
    return counts


# ---- phase 8: the serving runtime -----------------------------------------
# (b)'s fault spec: the second prefill group raises, and the fifth decode
# step NaN-poisons one live slot's cache rows
RUNTIME_SPEC = "raise@prefill:2,nan@decode:5"
RUNTIME_BATCH = 8


def runtime_requests(cfg):
    """(b)'s requests: 8 batch-class ones (preemptible, 16 new tokens; the
    first two streamed, the last at temperature 0.8), then 2 interactive
    ones (8 new tokens)."""
    import numpy as np
    from repro_torch.serving.slo import BATCH, INTERACTIVE
    rng = np.random.default_rng(4)

    def prompt(lo, hi):
        return rng.integers(0, cfg.vocab_size, int(rng.integers(lo, hi)),
                            dtype=np.int32)
    batch = [dict(prompt=prompt(8, 33), max_new_tokens=16,
                  temperature=0.8 if i == 7 else 0.0,
                  priority=BATCH.priority, preemptible=True, stream=i < 2)
             for i in range(8)]
    inter = [dict(prompt=prompt(4, 17), max_new_tokens=8,
                  priority=INTERACTIVE.priority, stream=False)
             for _ in range(2)]
    return batch, inter


def drive_runtime_script(engine) -> dict:
    """(b)'s manual drive of a token engine with ``max_batch`` 8 built with
    ``faults=RUNTIME_SPEC``: the batch requests fill the slots in one
    prefill group and decode 3 steps; both interactive requests arrive, so
    the next step evicts one batch slot (the first of equals: a streamer),
    the first interactive request's group raises (prefill 2), the second
    takes the slot, and decode step 5 poisons slot 0.  Returns what two
    runs must agree on, with the kernels' counts over the drive."""
    from repro_torch import kernels
    batch, inter = runtime_requests(engine.cfg)
    kernels.reset_counts()
    s0 = engine.stats.steps, engine.stats.prefill_batches
    reqs, streams = [], {}

    def submit(kw):
        kw = dict(kw)
        seen = [] if kw.pop("stream") else None
        r = engine.submit(**kw, on_token=None if seen is None
                          else seen.append)
        if seen is not None:
            streams[r.uid] = seen
        reqs.append(r)

    for kw in batch:
        submit(kw)
    for _ in range(3):
        engine.step()
    before = {uid: list(s) for uid, s in streams.items()}
    for kw in inter:
        submit(kw)
    engine.run()
    s = engine.stats
    return dict(
        outcomes=[(r.uid, r.handle.state,
                   type(r.handle.exception()).__name__
                   if r.handle.exception() is not None else None)
                  for r in reqs],
        tokens={r.uid: r.handle.result() for r in reqs
                if r.handle.state == "DONE"},
        streams=streams, before=before,
        preemptions={r.uid: r.preemptions for r in reqs},
        steps=s.steps - s0[0], groups=s.prefill_batches - s0[1],
        counts=kernels.counts(),
        stats=dict(s.summary(), preemptions=s.preemptions,
                   streamed_tokens=s.streamed_tokens, resolved=s.resolved))


def runtime_script_problems(cfg, runs: dict, device: str) -> list:
    """What is wrong with (b)'s runs (mode -> drive_runtime_script()):
    per run, exactly one NumericalError, a failed prefill group of
    InjectedFault, at least one preemption with its pre-eviction stream
    kept, every DONE stream equal to its result, every submit resolved,
    decode_attn_int8 once per layer and step and no call of the other
    route (``launches`` on CUDA, ``plain_calls`` on the CPU); across
    runs, equal outcomes, DONE tokens and preemptions."""
    out = []
    field, other = (("launches", "plain_calls") if device == "cuda"
                    else ("plain_calls", "launches"))
    for mode, r in runs.items():
        kinds = Counter(e for _, _, e in r["outcomes"])
        if kinds["NumericalError"] != 1 or not kinds["InjectedFault"]:
            out.append(f"{mode}: failures {dict(kinds)}, expected one "
                       "NumericalError and a group of InjectedFault")
        if sum(r["preemptions"].values()) < 1 \
                or r["stats"]["preemptions"] != sum(
                    r["preemptions"].values()):
            out.append(f"{mode}: preemptions {r['preemptions']}, stats "
                       f"{r['stats']['preemptions']}")
        for uid, n in r["preemptions"].items():
            toks = r["tokens"].get(uid)
            if n and uid in r["before"] and (
                    toks is None or toks[:len(r["before"][uid])]
                    != r["before"][uid]):
                out.append(f"{mode}: preempted request {uid} lost its "
                           "pre-eviction tokens")
        for uid, seen in r["streams"].items():
            if uid in r["tokens"] and seen != r["tokens"][uid]:
                out.append(f"{mode}: request {uid} streamed {seen}, "
                           f"result {r['tokens'][uid]}")
        if r["stats"]["submitted"] != r["stats"]["resolved"]:
            out.append(f"{mode}: submitted {r['stats']['submitted']} != "
                       f"resolved {r['stats']['resolved']}")
        c = r["counts"]
        if c["decode_attn_int8"][field] != cfg.n_layers * r["steps"] \
                or any(v[other] for v in c.values()):
            out.append(f"{mode}: counts {c} over {r['steps']} steps")
    first = next(iter(runs.values()))
    for mode, r in list(runs.items())[1:]:
        for key in ("outcomes", "tokens", "preemptions"):
            if r[key] != first[key]:
                out.append(f"{mode}: {key} differ from the first run's")
    return out


def _printed(fn, *args):
    """(fn's return value, or its SystemExit code; its standard output),
    the output echoed as well."""
    import contextlib
    import io
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            ret = fn(*args)
    except SystemExit as e:
        ret = e.code
    finally:
        print(buf.getvalue(), end="", flush=True)
    return ret, buf.getvalue()


def _line(pattern, text, what):
    import re
    m = re.search(pattern, text)
    if m is None:
        fail(f"no {what} line in {text[-400:]!r}")
    return m


def _check_counts(counts, want, what):
    for kname, c in counts.items():
        if c["launches"] != want.get(kname, 0) or c["plain_calls"]:
            fail(f"phase 8 {what}: {kname} {c}, expected "
                 f"{want.get(kname, 0)} launches and 0 plain calls")


def run_runtime(torch, out_dir, card):
    """Phase 8, the serving runtime: (a) ``launch.serve.main`` at full
    width, (b) a scripted fault / preemption / streaming drive of the
    token engine from phase 6's artifact, graphed and eager, (c) token
    traffic through a ``ServingDaemon`` by ``launch.daemon.serve_traffic``,
    (d) vision traffic through a daemon over phase 4's artifact.  Returns
    the kernels' counts of the four parts."""
    import argparse
    import gc
    import threading
    import numpy as np
    from repro_torch import kernels, recipe
    from repro_torch.configs.registry import ARCHS
    from repro_torch.launch import daemon as launch_daemon
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serving.daemon import ServingDaemon
    from repro_torch.serving.faults import FaultInjector

    total = Counter()

    def add(counts):
        total.update({k: c["launches"] for k, c in counts.items()})

    # (a) the serve CLI, in-process, at full width over the int8 cache
    kernels.reset_counts()
    t0 = time.perf_counter()
    _, text = _printed(launch_serve.main, [
        "--arch", "qwen1.5-0.5b", "--max-batch", str(RUNTIME_BATCH),
        "--max-len", str(TOKEN_MAX_LEN), "--requests", "8",
        "--max-new", "16", "--kv-cache-dtype", "int8"])
    serve_s = time.perf_counter() - t0
    counts = kernels.counts()
    add(counts)
    m = _line(r"requests=(\d+) decoded=(\d+) steps=(\d+) tok/s=([\d.]+)",
              text, "phase 8 requests=")
    flushes = _line(r"flushes=(\{.*\})", text, "phase 8 flushes=")
    groups = sum(json.loads(flushes[1].replace("'", '"')).values())
    steps = int(m[3])
    if (int(m[1]), int(m[2])) != (8, 8 * 15) or not float(m[4]) > 0:
        fail(f"phase 8 (a): the serve CLI printed {m[0]!r}, expected 8 "
             "requests and 120 decoded tokens")
    _check_counts(counts, token_launches(ARCHS["qwen1.5-0.5b"], "token",
                                         steps, groups),
                  f"(a) over {steps} steps and {groups} groups")
    res = dict(serve_cli=dict(line=m[0], steps=steps, prefill_groups=groups,
                              tokens_per_s=float(m[4]), wall_s=serve_s,
                              launches={k: c["launches"]
                                        for k, c in counts.items()
                                        if c["launches"]}))
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the scripted drive, graphed and eager, on phase 6's artifact
    tok = recipe.QuantizedModel.load(ARTIFACTS / "token", device="cuda")
    runs = {}
    for graphs in (True, False):
        mode = "graph" if graphs else "eager"
        eng = tok.serve(max_batch=RUNTIME_BATCH, max_len=TOKEN_MAX_LEN,
                        seed=0, graphs=graphs, debug_numerics=True,
                        faults=FaultInjector.parse(RUNTIME_SPEC))
        runs[mode] = drive_runtime_script(eng)
        add(runs[mode]["counts"])
        if graphs and len(eng.step_graphs) != 2:
            fail(f"phase 8 (b): {len(eng.step_graphs)} decode graphs, "
                 "expected a greedy and a drawing one")
        _check_counts(runs[mode]["counts"], token_launches(
            tok.cfg, "token", runs[mode]["steps"], runs[mode]["groups"]),
            f"(b) {mode}")
        del eng
    problems = runtime_script_problems(tok.cfg, runs, "cuda")
    if problems:
        fail("phase 8 (b): " + "; ".join(problems)[:1500])
    # the decode step with the cache scan off and on, in CUDA graphs
    step_ms = {"scan_off": [], "scan_on": []}
    for scan in (False, True, True, False):
        eng = tok.serve(max_batch=RUNTIME_BATCH, max_len=TOKEN_MAX_LEN,
                        graphs=False, debug_numerics=scan)
        eng.cache["lengths"].fill_(96)
        eng._live.fill_(True)
        with torch.no_grad():
            step_ms["scan_on" if scan else "scan_off"].append(
                graph_ms(lambda: eng._decode_step(False), iters=3))
        del eng
    res["script"] = dict(
        spec=RUNTIME_SPEC, outcomes=runs["graph"]["outcomes"],
        preemptions=runs["graph"]["preemptions"],
        steps=runs["graph"]["steps"], groups=runs["graph"]["groups"],
        stats={m: r["stats"] for m, r in runs.items()},
        decode_step_graph_ms=step_ms)
    print("phase 8 (b):", json.dumps(res["script"]), flush=True)

    # (c) token traffic through the daemon: submits from a foreign thread,
    # the first interactive request streamed; this thread leaves the card
    # alone until the daemon has stopped (its graphs are captured on the
    # daemon's thread)
    eng = tok.serve(max_batch=RUNTIME_BATCH, max_len=TOKEN_MAX_LEN, seed=0)
    gc.collect()
    torch.cuda.synchronize()
    kernels.reset_counts()
    args = argparse.Namespace(requests=16, max_new=16, timeout=300.0,
                              stream=False)
    daemon = ServingDaemon(eng).start()
    t0 = time.perf_counter()
    try:
        ok, text = _printed(launch_daemon.serve_traffic, daemon, args)
    finally:
        daemon.shutdown(drain=False, timeout=60.0)
    wall = time.perf_counter() - t0
    counts = kernels.counts()
    add(counts)
    if ok is not True or daemon.running or daemon._thread.is_alive() \
            or daemon.crashed is not None:
        fail(f"phase 8 (c): serve_traffic returned {ok}, daemon running "
             f"{daemon.running}, crashed {daemon.crashed!r}")
    s = eng.stats
    _check_counts(counts, token_launches(tok.cfg, "token", s.steps,
                                         s.prefill_batches),
                  f"(c) over {s.steps} steps")
    stream = _line(r"stream ttft=([\d.]+)ms tokens=(\d+) gap "
                   r"p50=([\d.]+)ms max=([\d.]+)ms gaps_ms=(\[.*\])",
                   text, "phase 8 stream")
    generated = s.decoded_tokens + s.prefills
    res["token_daemon"] = dict(
        requests=s.submitted, tokens=generated, wall_s=wall,
        tokens_per_s=generated / wall, ttft_ms=float(stream[1]),
        gap_p50_ms=float(stream[3]), gap_max_ms=float(stream[4]),
        gaps_ms=json.loads(stream[5]),
        steps=s.steps, prefill_groups=s.prefill_batches,
        preemptions=s.preemptions, graph_capture_s=eng.step_graphs.capture_s,
        classes=daemon.stats_summary()["classes"], card=card)
    print("phase 8 (c):", json.dumps(res["token_daemon"]), flush=True)
    del eng, daemon, tok
    gc.collect()
    torch.cuda.empty_cache()

    # (d) vision traffic through the daemon over phase 4's artifact
    vis = recipe.QuantizedModel.load(ARTIFACTS / "m2q-w8a8", device="cuda")
    eng = vis.serve(max_batch=BATCH)
    rng = np.random.default_rng(6)
    images = rng.normal(0, 1, (N_IMAGES, vis.cfg.img_res, vis.cfg.img_res,
                               3)).astype(np.float32)
    gc.collect()
    torch.cuda.synchronize()
    kernels.reset_counts()
    handles = []
    daemon = ServingDaemon(eng).start()
    t0 = time.perf_counter()
    try:
        th = threading.Thread(target=lambda: handles.extend(
            daemon.submit(img, slo="interactive" if i % 3 == 0 else "batch")
            for i, img in enumerate(images)))
        th.start()
        th.join(300.0)
        for h in handles:
            h.result(timeout=300.0)
        daemon.shutdown(drain=True, timeout=300.0)
    finally:
        daemon.shutdown(drain=False, timeout=60.0)
    wall = time.perf_counter() - t0
    counts = kernels.counts()
    add(counts)
    s = eng.stats
    if len(handles) != N_IMAGES or any(h.state != "DONE" for h in handles) \
            or s.submitted != s.resolved or daemon._thread.is_alive():
        fail(f"phase 8 (d): {len(handles)} handles, states "
             f"{Counter(h.state for h in handles)}, submitted {s.submitted}"
             f", resolved {s.resolved}")
    per_fwd = {"m2q_matmul": 42, "dwconv_w4": 20, "relu_attn": 14,
               "relu_attn_scales": 14}
    _check_counts(counts, {k: n * s.batches for k, n in per_fwd.items()},
                  f"(d) over {s.batches} forwards")
    res["vision_daemon"] = dict(
        images=N_IMAGES, wall_s=wall, images_per_s=N_IMAGES / wall,
        forwards=s.batches, buckets=sorted(s.buckets_used),
        graph_capture_s=eng.step_graphs.capture_s,
        classes=daemon.stats_summary()["classes"], card=card)
    print("phase 8 (d):", json.dumps(res["vision_daemon"]), flush=True)
    (out_dir / "chip_smoke_runtime.json").write_text(
        json.dumps(res, indent=1))
    del eng, daemon, vis
    torch.cuda.empty_cache()
    return total


# ---- phase 9: supervised serving -------------------------------------------
# the top-level keys of Supervisor.health() over a daemon without a
# journal: the JAX package's (tests/test_torch_supervisor.py holds this set
# against it); the port's trip_latches value is {"axes": None}
HEALTH_KEYS = frozenset({
    "state", "ready", "restarts", "last_recovery_s", "replayed",
    "supervised_outstanding", "unix_time", "trip_latches", "stats",
    "daemon_state", "queue_depth", "daemon_outstanding", "heartbeat_age_s",
    "step_in_flight_s", "crashed"})
SUP_MAX_NEW = 16
SUP_WAIT = 300.0  # seconds: every wait of phase 9 is bounded
# the circuit case's budget: restarts 1-3 rebuild, the 4th opens it
SUP_CIRCUIT_RESTARTS = 3


def supervised_requests(cfg, n: int = 8):
    """Phase 9's prompts: ``n`` of 8-40 tokens, seeded."""
    import numpy as np
    rng = np.random.default_rng(9)
    return [rng.integers(0, cfg.vocab_size, int(rng.integers(8, 41)),
                         dtype=np.int32) for _ in range(n)]


def timed_injector(spec: str):
    """A FaultInjector for ``spec`` that also records the wall-clock time
    of each call it fires on (``fired_unix``): where detection starts."""
    from repro_torch.serving.faults import FaultInjector
    inj = FaultInjector.parse(spec)
    inj.fired_unix = []
    on_call = inj.on_call

    def timed(site):
        act = on_call(site)
        if act is not None:
            inj.fired_unix.append(time.time())
        return act

    inj.on_call = timed
    return inj


class Builds:
    """A supervisor's engine factory over one quantized model: each build
    is ``qm.serve(**serve_kw)`` warmed by ``warm`` (fault-free; on the
    card this captures its graphs), and only then armed with ``arm`` --
    the first build, or every one with ``arm_every``.  Keeps per-build
    figures (``rows``): never the engines, each of which holds a KV cache
    and a graph pool on the card.  ``mem_in`` / ``mem_out``: allocated
    bytes on entry and after the build, each after a collection but for
    a rebuild's entry, read as the supervisor leaves the card: a restart
    must already have freed the torn-down engine.  ``groups``: a token
    engine's served prefill groups
    (:class:`~repro_torch.launch.daemon.PrefillGroups`), warm-ups
    excluded."""

    def __init__(self, qm, serve_kw, warm, arm=None, arm_every=False):
        from repro_torch.core.tree import device_of
        from repro_torch.launch.daemon import PrefillGroups
        self.qm, self.serve_kw, self.warm = qm, serve_kw, warm
        self.arm, self.arm_every = arm, arm_every
        self.cuda = device_of(qm.params).type == "cuda"
        self.rows = []
        self.groups = PrefillGroups()

    def _allocated(self, collect=True):
        import gc
        import torch
        if not self.cuda:
            return None
        if collect:
            gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    def __call__(self):
        row = {"entered_unix": time.time(),
               "mem_in": self._allocated(collect=not self.rows)}
        t0 = time.perf_counter()
        eng = self.qm.serve(**self.serve_kw)
        self.warm(eng)
        if hasattr(eng, "_prefill_group"):
            self.groups.watch(eng)
        row["mem_out"] = self._allocated()
        row["build_s"] = time.perf_counter() - t0
        graphs = eng.step_graphs
        row["graphs"] = 0 if graphs is None else len(graphs)
        row["capture_s"] = 0.0 if graphs is None else graphs.capture_s
        row["stats"] = eng.stats
        if self.arm is not None and (self.arm_every or not self.rows):
            eng.faults = row["injector"] = timed_injector(self.arm)
        self.rows.append(row)
        return eng


def _outcomes(handles, timeout=SUP_WAIT):
    """Per client handle: (state, tokens or None, error class name)."""
    out = []
    for h in handles:
        try:
            res = h.result(timeout=timeout)
            out.append((h.state, [int(t) for t in res], None))
        except BaseException as e:  # noqa: BLE001 -- recorded, judged later
            out.append((h.state, None, type(e).__name__))
    return out


def restart_figures(sup, builds) -> list:
    """Per restart: detection (fault -> watchdog), teardown (-> the old
    serve thread gone), backoff, factory (engine + warm-up + captures),
    recovery (detection -> new daemon serving) seconds, and the allocated
    bytes before and after the new build."""
    rows = []
    for k, e in enumerate(sup.restart_log):
        inj = builds.rows[min(k, len(builds.rows) - 1)].get("injector")
        new = builds.rows[k + 1] if k + 1 < len(builds.rows) else {}
        rows.append(dict(
            restart=e["restart"], reason=e["reason"],
            detection_s=(e["detected_unix"] - inj.fired_unix[0]
                         if inj is not None and inj.fired_unix else None),
            teardown_s=e["teardown_s"],
            serve_thread_exited=e["serve_thread_exited"],
            backoff_s=e.get("backoff_s"), factory_s=e.get("factory_s"),
            recovery_s=e.get("recovery_s"),
            capture_s=new.get("capture_s"), graphs=new.get("graphs"),
            mem_after_teardown=new.get("mem_in"),
            mem_after_restart=new.get("mem_out")))
    return rows


def expected_launches(cfg, stats) -> Counter:
    """The token engines' launches over ``stats`` (each engine's): the
    ``token`` path's routing (:func:`token_launches`)."""
    want = Counter()
    for s in stats:
        want.update(token_launches(cfg, "token", s.steps, s.prefill_batches))
    return want


def launch_problems(counts, want, what, field) -> list:
    """``counts`` against ``want`` in ``field`` (``launches`` on the card,
    ``plain_calls`` on the CPU), and nothing in the other field."""
    other = "plain_calls" if field == "launches" else "launches"
    return [f"{what}: {k} {c}, expected {want.get(k, 0)} {field}"
            for k, c in counts.items()
            if c[field] != want.get(k, 0) or c[other]]


def die_like_a_process(sup) -> bool:
    """Stop ``sup`` as a killed process stops: its watchdog and serve
    thread halt, nothing is cancelled, no terminal is journaled for what
    was in flight, and the journal file is closed.  Returns whether the
    serve thread exited."""
    sup._stop_evt.set()
    sup._watchdog.join(SUP_WAIT)
    daemon = sup._daemon
    daemon.abort()
    exited = daemon.join(SUP_WAIT)
    sup.journal.close()
    return exited


def supervised_cases(qm, serve_kw, workdir, hang_s: float = 2.0):
    """Phase 9 (b): supervisors over engines of the token model ``qm``
    (``serve_kw``: its ``serve`` arguments), each build warmed and
    captured in the factory before it is armed.  Five cases: crash@decode
    (one restart), hang@decode detected after ``hang_s`` (one
    HungStepError restart; the new engine built after the old thread
    left), a streamed request across a crash (streamed == result), every
    build armed until the circuit opens, and a second supervisor
    cold-starting from the journal of a first stopped like a dead
    process.  Replayed tokens are held against one fault-free reference
    run (exact, or within the teacher-forced bound where a replay's
    prefill group differed from the reference's).  Returns (results,
    problems); ``results["counts"]`` the kernel counts of every served
    run."""
    from repro_torch import kernels
    from repro_torch.core.tree import device_of
    from repro_torch.launch.daemon import PrefillGroups, replay_agreement
    from repro_torch.serving.journal import RequestJournal
    from repro_torch.serving.supervisor import RestartPolicy, Supervisor
    cfg = qm.cfg
    max_len = serve_kw["max_len"]
    prompts = supervised_requests(cfg)
    cuda = device_of(qm.params).type == "cuda"
    field = "launches" if cuda else "plain_calls"
    problems, cases, total = [], {}, Counter()

    def warm(eng):
        for p in prompts:
            eng.submit(p, max_new_tokens=SUP_MAX_NEW)
        eng.run()

    kernels.reset_counts()
    ref_groups = PrefillGroups()
    ref = ref_groups.watch(qm.serve(**serve_kw))
    ref_reqs = [ref.submit(p, max_new_tokens=SUP_MAX_NEW) for p in prompts]
    ref.run()
    expected = [[int(t) for t in r.handle.result()] for r in ref_reqs]
    problems += launch_problems(kernels.counts(), expected_launches(
        cfg, [ref.stats]), "reference", field)
    total.update({k: c[field] for k, c in kernels.counts().items()})
    del ref, ref_reqs

    def policy(**kw):
        return RestartPolicy(**dict(dict(hang_threshold_s=10.0,
                                         backoff_base_s=0.05,
                                         poll_interval_s=0.02), **kw))

    def finish(name, sup, builds, outs, want_idx, extra_stats=()):
        """Counts, goodput, replay agreement and restart figures of one
        case, after its supervisor stopped."""
        counts = kernels.counts()
        total.update({k: c[field] for k, c in counts.items()})
        problems.extend(launch_problems(counts, expected_launches(
            cfg, [r["stats"] for r in builds.rows] + list(extra_stats)),
            name, field))
        done = [o for o in outs if o[0] == "DONE"]
        agree = replay_agreement(
            cfg, qm.params, [prompts[i] for i in want_idx],
            [o[1] for o in outs], [expected[i] for i in want_idx], max_len,
            builds.groups, ref_groups) if len(done) == len(outs) else None
        if agree is not None and agree["off"]:
            problems.append(f"{name}: replayed tokens off the reference "
                            f"beyond the bound: {agree['rows']}")
        cases[name] = dict(
            restarts=sup.restarts, replayed=sup.replayed,
            goodput=len(done) / len(outs), agreement=agree,
            outcomes=[o[0] if o[2] is None else o[2] for o in outs],
            log=sup.restart_log, figures=restart_figures(sup, builds),
            builds=[{k: v for k, v in r.items()
                     if k not in ("stats", "injector")}
                    for r in builds.rows])
        return cases[name]

    def journal_exact(path, name):
        with RequestJournal(path) as j:
            rec = j.reconcile()
        if not rec["exact"] or rec["pending"]:
            problems.append(f"{name}: journal {rec}")
        return rec

    # (1) crash@decode -> one restart
    builds = Builds(qm, serve_kw, warm, arm="crash@decode:4")
    jpath = workdir / "crash.jsonl"
    kernels.reset_counts()
    sup = Supervisor(builds, journal=RequestJournal(jpath),
                     policy=policy()).start()
    hs = [sup.submit(p, request_id=f"crash-{i}", max_new_tokens=SUP_MAX_NEW)
          for i, p in enumerate(prompts)]
    outs = _outcomes(hs)
    sup.shutdown()
    c = finish("crash", sup, builds, outs, range(len(prompts)))
    c["journal"] = journal_exact(jpath, "crash")

    # (2) hang@decode -> a HungStepError restart; the factory's captures
    # come after the old serve thread left
    builds = Builds(qm, serve_kw, warm, arm="hang@decode:4")
    kernels.reset_counts()
    sup = Supervisor(builds, policy=policy(hang_threshold_s=hang_s,
                                           poll_interval_s=0.05)).start()
    hs = [sup.submit(p, max_new_tokens=SUP_MAX_NEW) for p in prompts]
    outs = _outcomes(hs)
    sup.shutdown()
    c = finish("hang", sup, builds, outs, range(len(prompts)))
    if c["log"] and len(builds.rows) > 1:
        e = c["log"][0]
        c["built_after_teardown"] = bool(
            builds.rows[1]["entered_unix"] >= e["detected_unix"]
            + e["teardown_s"])
        if not (e["serve_thread_exited"] and c["built_after_teardown"]
                and (builds.rows[1]["graphs"] or not cuda)):
            problems.append(f"hang: teardown {e}, rebuild "
                            f"{c['builds'][1]}")

    # (3) a streamed request across a restart
    builds = Builds(qm, serve_kw, warm, arm="crash@decode:6")
    kernels.reset_counts()
    sup = Supervisor(builds, policy=policy()).start()
    streamed = []
    hs = [sup.submit(prompts[0], max_new_tokens=SUP_MAX_NEW,
                     on_token=streamed.append)]
    hs += [sup.submit(p, max_new_tokens=SUP_MAX_NEW) for p in prompts[1:4]]
    outs = _outcomes(hs)
    sup.shutdown()
    c = finish("stream", sup, builds, outs, range(4))
    c["streamed"] = len(streamed)
    if streamed != outs[0][1]:
        problems.append(f"stream: streamed {streamed} != result "
                        f"{outs[0][1]}")

    # (4) every build armed: restarts until the circuit opens (the last
    # case's supervisor and engine go first: the first build's entry is
    # the memory baseline)
    sup = None
    builds = Builds(qm, serve_kw, warm, arm="crash@decode:1",
                    arm_every=True)
    kernels.reset_counts()
    sup = Supervisor(builds, policy=policy(
        backoff_base_s=0.01, max_restarts=SUP_CIRCUIT_RESTARTS,
        restart_window_s=300.0)).start()
    hs = [sup.submit(p, max_new_tokens=SUP_MAX_NEW) for p in prompts[:4]]
    outs = _outcomes(hs)
    ready = sup.ready()
    try:
        sup.submit(prompts[0], max_new_tokens=SUP_MAX_NEW)
        rejected = None
    except Exception as e:  # noqa: BLE001 -- judged below
        rejected = type(e).__name__
    health = sup.health()
    sup.shutdown()
    c = finish("circuit", sup, builds, outs, range(4))
    c.update(ready=ready, rejected=rejected,
             rejected_count=health["stats"]["rejected"])
    if (any(o[2] != "CircuitOpenError" for o in outs)
            or sup.restarts != SUP_CIRCUIT_RESTARTS + 1
            or ready != {"ready": False, "reason": "circuit_open"}
            or rejected != "CircuitOpenError"
            or health["stats"]["rejected"] != 1):
        problems.append(f"circuit: outcomes {c['outcomes']}, restarts "
                        f"{sup.restarts}, ready {ready}, rejected "
                        f"{rejected} / {health['stats']['rejected']}")
    if cuda:
        # allocated once restart 1's and restart 3's new engine is built
        # and captured: the card then holds the parameters, the new
        # engine, and whatever the restart's thread allocated on first
        # use; the slack, half of one engine (its KV cache, decode buffers
        # and the graph pool's live outputs), is below what one leaked
        # engine adds.  On entry to each rebuild the supervisor has freed
        # the torn-down engine: the card holds no more than before the
        # first build, within the same slack
        rows = builds.rows
        footprint = rows[0]["mem_out"] - rows[0]["mem_in"]
        c["memory"] = dict(engine_bytes=footprint, slack=footprint // 2,
                           before_first_build=rows[0]["mem_in"],
                           after_restart_1=rows[1]["mem_out"],
                           after_restart_3=rows[3]["mem_out"],
                           teardowns=[r["mem_in"] for r in rows[1:]])
        if rows[3]["mem_out"] > rows[1]["mem_out"] + footprint // 2:
            problems.append(f"circuit: memory grew with restarts: "
                            f"{c['memory']}")
        if any(r["mem_in"] > rows[0]["mem_in"] + footprint // 2
               for r in rows[1:]):
            problems.append(f"circuit: a torn-down engine was still on "
                            f"the card at a rebuild: {c['memory']}")

    # (5) cold start from the journal of a supervisor stopped like a dead
    # process (a short first request completes before the stop)
    jpath = workdir / "cold.jsonl"
    kernels.reset_counts()
    first = Builds(qm, serve_kw, warm)
    dead = Supervisor(first, journal=RequestJournal(jpath),
                      policy=policy()).start()
    hs = [dead.submit(p, request_id=f"cold-{i}",
                      max_new_tokens=4 if i == 0 else SUP_MAX_NEW)
          for i, p in enumerate(prompts)]
    hs[0].result(timeout=SUP_WAIT)
    if not die_like_a_process(dead):
        problems.append("cold start: the first supervisor's serve thread "
                        "did not exit")
    with RequestJournal(jpath) as j:
        left = [r["rid"] for r in j.pending()]
    builds = Builds(qm, serve_kw, warm)
    sup = Supervisor(builds, journal=RequestJournal(jpath),
                     policy=policy()).start()
    got = sup.handles()
    rids = sorted(got, key=lambda r: int(r.split("-")[1]))
    outs = _outcomes([got[r] for r in rids])
    sup.shutdown()
    c = finish("cold_start", sup, builds, outs,
               [int(r.split("-")[1]) for r in rids],
               extra_stats=[first.rows[0]["stats"]])
    c["journal"] = journal_exact(jpath, "cold start")
    c["left_pending"] = len(left)
    if not left or rids != left or sup.replayed != len(left):
        problems.append(f"cold start: {len(left)} left pending, replayed "
                        f"{sup.replayed} ({rids})")

    for name, c in cases.items():
        if name != "circuit" and (c["goodput"] != 1.0
                                  or c["restarts"] != (name != "cold_start")):
            problems.append(f"{name}: goodput {c['goodput']}, restarts "
                            f"{c['restarts']}, outcomes {c['outcomes']}")
    return dict(cases=cases, counts=total), problems


def supervised_vision(vis, n_images: int = N_IMAGES, max_batch: int = BATCH):
    """Phase 9 (d): a supervised VisionEngine over ``vis`` under
    ``crash@vision:1``, every bucket warmed and captured before the first
    build is armed; ``n_images`` submitted in both classes must all end
    DONE after the restart, with finite logits and every forward's
    launches as routed.  Returns (results, problems)."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.serving.supervisor import RestartPolicy, Supervisor
    cfg = vis.cfg
    rng = np.random.default_rng(6)
    images = rng.normal(0, 1, (max(n_images, max_batch), cfg.img_res,
                               cfg.img_res, 3)).astype(np.float32)

    def warm(eng):
        n = max_batch
        while n >= 1:
            eng.classify(images[:n])
            n //= 2

    builds = Builds(vis, dict(max_batch=max_batch), warm,
                    arm="crash@vision:1")
    field = "launches" if builds.cuda else "plain_calls"
    kernels.reset_counts()
    sup = Supervisor(builds, policy=RestartPolicy(
        hang_threshold_s=10.0, backoff_base_s=0.02,
        poll_interval_s=0.02)).start()
    hs = [sup.submit(img, slo="interactive" if i % 3 == 0 else "batch")
          for i, img in enumerate(images[:n_images])]
    outs = []
    for h in hs:
        try:
            outs.append(np.asarray(h.result(timeout=SUP_WAIT)))
        except BaseException as e:  # noqa: BLE001 -- judged below
            outs.append(type(e).__name__)
    sup.shutdown()
    counts = kernels.counts()
    m2q, dw, attn = main_path_calls(cfg, 1)
    # the MSA mixer runs int8 (relu_attn and its scales) on the card, f32
    # einsums on the CPU (ops.default_attn)
    n_attn = len(attn) if builds.cuda else 0
    per_fwd = {"m2q_matmul": len(m2q), "dwconv_w4": len(dw),
               "relu_attn": n_attn, "relu_attn_scales": n_attn}
    forwards = sum(r["stats"].batches for r in builds.rows)
    problems = launch_problems(
        counts, {k: n * forwards for k, n in per_fwd.items()},
        f"vision over {forwards} forwards", field)
    done = sum(1 for h in hs if h.state == "DONE")
    if done != n_images or sup.restarts != 1 or not all(
            isinstance(o, np.ndarray) and o.shape == (cfg.n_classes,)
            and np.isfinite(o).all() for o in outs):
        problems.append(f"vision: {done} of {n_images} DONE, restarts "
                        f"{sup.restarts}, outcomes "
                        f"{[o if isinstance(o, str) else 'logits' for o in outs]}")
    return dict(images=n_images, done=done, restarts=sup.restarts,
                forwards=forwards, log=sup.restart_log,
                figures=restart_figures(sup, builds),
                counts={k: c[field] for k, c in counts.items()}), problems


def kill_child() -> None:
    """One process of (c), run as ``python -c "import chip_smoke;
    chip_smoke.kill_child()" PHASE ARTIFACT JOURNAL SERVE_KW``: ``serve``
    submits phase 9's requests under a journal-backed supervisor (the
    first of 4 tokens, the rest of 16), waits until the first is
    journaled terminal, and SIGKILLs itself; ``replay`` cold-starts a
    supervisor from the journal and prints its results."""
    import os
    import signal
    from repro_torch.launch.daemon import PrefillGroups
    from repro_torch.recipe import QuantizedModel
    from repro_torch.serving.journal import RequestJournal
    from repro_torch.serving.supervisor import Supervisor
    phase, art, jpath, serve_kw = sys.argv[1:5]
    serve_kw = json.loads(serve_kw)
    device = serve_kw.pop("device")
    qm = QuantizedModel.load(art, device=device)
    groups = PrefillGroups()
    sup = Supervisor(lambda: groups.watch(qm.serve(**serve_kw)),
                     journal=RequestJournal(jpath)).start()
    if phase == "serve":
        hs = [sup.submit(p, request_id=f"req-{i}",
                         max_new_tokens=4 if i == 0 else SUP_MAX_NEW)
              for i, p in enumerate(supervised_requests(qm.cfg))]
        hs[0].result(timeout=SUP_WAIT)
        # its terminal is journaled by a done-callback on the serve
        # thread, which may run after this wait returns
        t0 = time.monotonic()
        while sup.journal.terminal_state("req-0") is None \
                and time.monotonic() - t0 < SUP_WAIT:
            time.sleep(0.01)
        print("KILL-READY", flush=True)
        os.kill(os.getpid(), signal.SIGKILL)  # no shutdown, no drain
    results = {rid: [int(t) for t in h.result(timeout=SUP_WAIT)]
               for rid, h in sup.handles().items()}
    rec = sup.journal.reconcile()
    sup.shutdown()
    print("REPLAY-RESULT " + json.dumps(
        {"results": results, "reconcile": rec, "replayed": sup.replayed,
         "groups": groups}), flush=True)


def process_kill_replay(qm, art, workdir, serve_kw, device):
    """Phase 9 (c): a child process serving ``art`` (``qm`` saved) under a
    journal-backed supervisor is SIGKILLed mid-flight; a fresh one
    replays its journal.  The replayed tokens are held against a
    fault-free run of ``qm`` in this process.  Returns (results,
    problems)."""
    import os
    import signal
    from repro_torch.launch.daemon import PrefillGroups, replay_agreement
    from repro_torch.serving.journal import RequestJournal
    jpath = str(workdir / "kill.jsonl")
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([str(SRC), str(ROOT)])}
    arg = json.dumps(dict(serve_kw, device=device))
    res, problems = {}, []

    def child(phase):
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "-c", "import chip_smoke; "
             "chip_smoke.kill_child()", phase, str(art), jpath, arg],
            env=env, cwd=ROOT, capture_output=True, text=True,
            timeout=SUP_WAIT)
        res[f"{phase}_s"] = time.perf_counter() - t0
        return p

    p1 = child("serve")
    if "KILL-READY" not in p1.stdout or p1.returncode != -signal.SIGKILL:
        return res, [f"kill: the serving child ended rc {p1.returncode}: "
                     f"{p1.stdout[-400:]} {p1.stderr[-1200:]}"]
    with RequestJournal(jpath) as j:
        res["after_kill"] = j.reconcile()
    p2 = child("replay")
    lines = [ln for ln in p2.stdout.splitlines()
             if ln.startswith("REPLAY-RESULT ")]
    if p2.returncode != 0 or not lines:
        return res, [f"kill: the replaying child ended rc {p2.returncode}: "
                     f"{p2.stderr[-1200:]}"]
    out = json.loads(lines[0].split(" ", 1)[1])
    prompts = supervised_requests(qm.cfg)
    idx = sorted(int(r.split("-")[1]) for r in out["results"])
    ref_groups = PrefillGroups()
    eng = ref_groups.watch(qm.serve(**serve_kw))
    refs = [eng.submit(prompts[i], max_new_tokens=4 if i == 0 else
                       SUP_MAX_NEW) for i in idx]
    eng.run()
    agree = replay_agreement(
        qm.cfg, qm.params, [prompts[i] for i in idx],
        [out["results"][f"req-{i}"] for i in idx],
        [r.handle.result() for r in refs], serve_kw["max_len"],
        out["groups"], ref_groups)
    with RequestJournal(jpath) as j:
        final = j.reconcile()
    res.update(replayed=out["replayed"], reconcile=out["reconcile"],
               final=final, agreement=agree)
    pending = res["after_kill"]["pending"]
    if (pending < 1 or res["after_kill"]["submitted"] != len(prompts)
            or out["replayed"] != len(idx) or len(idx) != pending
            or not final["exact"] or final["pending"] or agree["off"]):
        problems.append(f"kill: {json.dumps(res)[:1500]}")
    return res, problems


def run_supervised(torch, out_dir, card):
    """Phase 9, supervised serving on the card: (a) the daemon CLI's
    ``--recovery-smoke`` at full width, (b) :func:`supervised_cases` over
    phase 6's ``token`` artifact, (c) :func:`process_kill_replay` of it,
    (d) :func:`supervised_vision` over phase 4's ``m2q-w8a8`` artifact,
    (e) the CLI's ``--health-file`` read while it serves, (f) the restart
    figures printed beside the card.  Returns the kernels' counts of (a),
    (b), (d) and (e) (the process-kill children count their own)."""
    import gc
    import tempfile
    import threading
    from repro_torch import kernels, recipe
    from repro_torch.launch import daemon as launch_daemon

    total = Counter()
    res = {"card": card}

    def add(counts, what):
        plain = {k: c["plain_calls"] for k, c in counts.items()
                 if c["plain_calls"]}
        if plain:
            fail(f"phase 9 {what}: plain calls {plain}")
        total.update({k: c["launches"] for k, c in counts.items()})

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    # (a) the recovery smoke CLI, in-process, at full width (bf16 cache)
    kernels.reset_counts()
    t0 = time.perf_counter()
    rc, text = _printed(launch_daemon.main, [
        "--arch", "qwen1.5-0.5b", "--recovery-smoke", "--timeout",
        str(SUP_WAIT)])
    counts = kernels.counts()
    add(counts, "(a)")
    m = _line(r"recovery smoke ok: crash@decode -> (\d+) restart\(s\), "
              r"(\d+) replayed, goodput=100%, results match fault-free "
              r"reference \((\d+) exact, (\d+) within the teacher-forced "
              r"bound\), journal exact \((\d+) submits == (\d+) "
              r"terminals\), (\d+) engine builds", text,
              "phase 9 (a) recovery smoke ok")
    log = json.loads(_line(r"restart log: (\[.*\])", text,
                           "phase 9 (a) restart log")[1])
    if rc != 0 or int(m[1]) < 1 or m[5] != m[6] \
            or not counts["int4_matmul"]["launches"]:
        fail(f"phase 9 (a): rc {rc}, {m[0]!r}, counts {counts}")
    res["recovery_cli"] = dict(
        line=m[0], restarts=int(m[1]), replayed=int(m[2]), exact=int(m[3]),
        bounded=int(m[4]), log=log, wall_s=time.perf_counter() - t0,
        launches={k: c["launches"] for k, c in counts.items()
                  if c["launches"]})
    print("phase 9 (a):", json.dumps(res["recovery_cli"]), flush=True)
    release()

    # (b) the scripted supervisor cases, (c) the process kill
    tok = recipe.QuantizedModel.load(ARTIFACTS / "token", device="cuda")
    serve_kw = dict(max_batch=TOKEN_BATCH, max_len=TOKEN_MAX_LEN, seed=0)
    with tempfile.TemporaryDirectory(dir=ARTIFACTS) as wd:
        b, problems = supervised_cases(tok, serve_kw, Path(wd), hang_s=2.0)
        if problems:
            fail("phase 9 (b): " + "; ".join(problems)[:2000])
        total.update(b["counts"])
        res["cases"] = b["cases"]
        print("phase 9 (b):", json.dumps({
            name: {k: c[k] for k in ("restarts", "replayed", "goodput",
                                     "agreement", "outcomes")}
            for name, c in b["cases"].items()}), flush=True)
        print("phase 9 (b) circuit memory:",
              json.dumps(b["cases"]["circuit"]["memory"]), flush=True)
        release()
        k, problems = process_kill_replay(tok, ARTIFACTS / "token",
                                          Path(wd), serve_kw, "cuda")
        if problems:
            fail("phase 9 (c): " + "; ".join(problems)[:2000])
        res["process_kill"] = k
        print("phase 9 (c):", json.dumps(k), flush=True)
    del tok
    release()

    # (d) a supervised vision daemon under crash@vision
    vis = recipe.QuantizedModel.load(ARTIFACTS / "m2q-w8a8", device="cuda")
    v, problems = supervised_vision(vis)
    if problems:
        fail("phase 9 (d): " + "; ".join(problems)[:2000])
    total.update(v["counts"])
    res["vision"] = v
    print("phase 9 (d):", json.dumps(v), flush=True)
    del vis
    release()

    # (e) --health-file, its snapshots read while the CLI serves
    hpath = ARTIFACTS / "health.json"
    snaps, torn, stop = [], [], threading.Event()

    def poll():
        while not stop.is_set():
            try:
                snaps.append(json.loads(hpath.read_text()))
            except FileNotFoundError:
                pass
            except json.JSONDecodeError as e:
                torn.append(repr(e))
            stop.wait(0.02)

    th = threading.Thread(target=poll, daemon=True)
    th.start()
    kernels.reset_counts()
    try:
        rc, text = _printed(launch_daemon.main, [
            "--arch", "qwen1.5-0.5b", "--health-file", str(hpath),
            "--max-batch", str(TOKEN_BATCH), "--max-len", "128",
            "--requests", "8", "--max-new", str(SUP_MAX_NEW),
            "--timeout", str(SUP_WAIT)])
    finally:
        stop.set()
        th.join(SUP_WAIT)
    counts = kernels.counts()
    add(counts, "(e)")
    final = json.loads(hpath.read_text())
    serving = [s for s in snaps if s["state"] == "running"
               and s["ready"]["ready"]]
    res["health_file"] = dict(
        snapshots=len(snaps), ready_snapshots=len(serving), torn=torn,
        keys=sorted(final), final_state=final["state"],
        restarts=final["restarts"], stats=final["stats"],
        trip_latches=final["trip_latches"])
    if (rc != 0 or not serving or torn or set(final) != HEALTH_KEYS
            or any(s["restarts"] for s in snaps) or final["restarts"]
            or final["trip_latches"] != {"axes": None}
            or final["stats"]["completed"] != 8
            or not counts["int4_matmul"]["launches"]):
        fail(f"phase 9 (e): rc {rc}, {json.dumps(res['health_file'])}")
    print("phase 9 (e):", json.dumps(res["health_file"]), flush=True)
    release()

    # (f) per restart: detection, teardown, backoff, factory, recovery
    # seconds and allocated bytes, beside the card
    figures = {f"(b) {name}": c["figures"]
               for name, c in res["cases"].items() if c["figures"]}
    figures["(d) vision"] = v["figures"]
    figures["(a) cli"] = [{k: e.get(k) for k in (
        "reason", "teardown_s", "backoff_s", "factory_s", "recovery_s")}
        for e in log]
    print(card, flush=True)
    for what, rows in figures.items():
        for row in rows:
            print(f"phase 9 (f) {what}:", json.dumps(row), flush=True)
    res["figures"] = figures
    (out_dir / "chip_smoke_supervised.json").write_text(
        json.dumps(res, indent=1, default=str))
    return total


def main() -> None:
    import torch  # the card check needs torch before anything else

    # ---- 1. card --------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout")
    sys.path.insert(0, str(SRC))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_card.txt").write_text(card + "\n")

    # ---- 2. build -------------------------------------------------------
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    print(build.build_all(), flush=True)
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 3. kernel checks at the recipe paths' shapes ---------------------
    import numpy as np
    from repro_torch.configs.registry import ARCHS
    cfg = ARCHS["efficientvit-b1-r224"]
    calls = main_path_calls(cfg, BATCH)
    m2q_calls, dw_calls, attn_calls = calls
    r = -(-cfg.img_res // 2)
    stem_call = ("stem/w", BATCH * r * r, 27, cfg.widths[0])
    print(f"per forward: {len(m2q_calls)} dense, {len(dw_calls)} dwconv, "
          f"{len(attn_calls)} attention calls; stem {stem_call}", flush=True)
    qwen = ARCHS["qwen1.5-0.5b"]
    lm_head_call = ("lm_head", TOKEN_BATCH, qwen.d_model, qwen.padded_vocab)
    rng = np.random.default_rng(0)
    tallies = [check_m2q(torch, rng, {
                   "m2q-w8a8": m2q_calls,
                   **token_m2q_calls(qwen, TOKEN_BATCH, PREFILL_LEN)}),
               check_dwconv(torch, rng, dw_calls),
               check_attn(torch, rng, attn_calls),
               check_scales(torch, rng, attn_calls),
               check_int8(torch, rng, {"uniform8": m2q_calls,
                                       "int8-stem": [stem_call]}),
               check_weights_only(torch, rng, "int4_matmul",
                                  {"w4-weights-only": m2q_calls,
                                   "qwen-decode-step": [lm_head_call]}),
               check_weights_only(torch, rng, "apot_matmul",
                                  {"weights-only-apot": m2q_calls}),
               check_decode_attn(torch, rng, qwen.n_layers)]
    detail = {t.name: t.rows for t in tallies}
    (out_dir / "chip_smoke_kernels.json").write_text(
        json.dumps(detail, indent=1))
    for t in tallies:
        for row in t.rows:
            print(t.name, json.dumps(row), flush=True)
        print(f"{t.name} per forward: {json.dumps(t.total)}", flush=True)
        for path, total in t.by_path.items():
            print(f"{t.name} per {path} forward: {json.dumps(total)}",
                  flush=True)
    print("kernels:", ", ".join(t.name for t in tallies), flush=True)

    launches = Counter()
    try:  # fail() exits through here too: no artifact stays behind
        # ---- 4./5. the recipe paths, each read from zeroed counters -----
        for name in PATHS:
            counts = run_path(torch, cfg, name, calls, out_dir,
                              full=name in ("m2q-w8a8", "uniform8"))
            launches.update({k: c["launches"] for k, c in counts.items()})

        # ---- 6. the token paths, each read from zeroed counters ----------
        for name in ("token", "token-m2q"):
            counts = run_token_path(torch, out_dir, name)
            launches.update({k: c["launches"] for k, c in counts.items()})

        # ---- 7. the trained proxy's artifact, read from zeroed counters ---
        counts = run_proxy(torch, out_dir)
        launches.update({k: c["launches"] for k, c in counts.items()})

        # ---- 8. the serving runtime, each part from zeroed counters -------
        launches.update(run_runtime(torch, out_dir, card))

        # ---- 9. supervised serving, each part from zeroed counters --------
        launches.update(run_supervised(torch, out_dir, card))
    finally:
        import shutil
        shutil.rmtree(ARTIFACTS, ignore_errors=True)

    # ---- 10. results ----------------------------------------------------
    replaces = {"m2q_matmul": "src/repro/kernels/m2q_matmul.py:80",
                "dwconv_w4": "src/repro/kernels/dwconv_w4.py:107",
                "relu_attn": "src/repro/kernels/relu_attn.py:74",
                # the three reductions XLA fuses ahead of that pallas_call
                "relu_attn_scales": "src/repro/kernels/ops.py:649",
                "int8_matmul": "src/repro/kernels/int8_matmul.py:53",
                "int4_matmul": "src/repro/kernels/int4_matmul.py:47",
                "apot_matmul": "src/repro/kernels/apot_matmul.py:56",
                "decode_attn_int8":
                    "src/repro/kernels/decode_attn_int8.py:60"}
    entries = [t.entry(replaces[t.name], launches[t.name],
                       library=t.name not in ("relu_attn",
                                              "relu_attn_scales",
                                              "decode_attn_int8"))
               for t in tallies]
    print(card, flush=True)  # again, beside the results it qualifies
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

"""autotune_sweep: warm the port's launch-plan cache OFFLINE for a
deployment's shape set, so no request pays for tuning (twin of
``repro.launch.autotune_sweep``).

The CLI finds every kernel launch shape a deployment's hot paths request
(registry configs x recipes, through ``analysis.traces.shape_requests``,
which runs them eagerly with the autotuner recording), times every
candidate plan of each shape on the card, and writes the per-backend
cache that ``kernels.autotune`` consults first on every launch.

On the card each shape is tuned on seeded synthetic operands rebuilt from
the request's dims, and every candidate's output is checked against the
kernel's plain version before its time counts: bit for bit for
``m2q_matmul``, ``int8_matmul``, ``dwconv_w4`` and ``relu_attn``, within
the f32 summation bound ``(K+1) 2^-23 (|x|@|W|)`` for ``int4_matmul`` and
``apot_matmul``.  A candidate that disagrees or fails to launch raises.
On the CPU, where no kernel runs, ``launch_plan``'s plans are committed:
what a lazy lookup there returns.

``--smoke`` is the CI gate: walk the pinned CI set (``CI_CONFIGS`` x
``CI_RECIPES``, at the published widths) against the cache and FAIL on
any missing key or any tuning probe.

Usage (from the repo root; the card unless ``--device cpu``):
  PYTHONPATH=src python -m repro_torch.launch.autotune_sweep \\
      [--configs efficientvit-b1-r224,qwen1.5-0.5b] [--cache PATH]
  PYTHONPATH=src python -m repro_torch.launch.autotune_sweep --smoke
  PYTHONPATH=src python -m repro_torch.launch.autotune_sweep --smoke \\
      --device cpu --reduced --cache /tmp/cpu.json

``--reduced`` walks the configs' REDUCED twins (the CPU tests).  The JAX
CLI's ``--bench`` (rows into a kernel bench report) is not ported; it
waits for the port's kernel bench (ROADMAP A10b).

Exit codes: 0 ok; 1 smoke found missing shapes or tuning probes; 2 usage.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch

CI_CONFIGS: Tuple[str, ...] = ("efficientvit-b1-r224", "qwen1.5-0.5b")
CI_RECIPES: Tuple[str, ...] = ("m2q-w8a8", "uniform8")


def discover(configs: Sequence[str], recipes: Sequence[str], device="cuda",
             reduced: bool = False, progress=print):
    """The deployment's shape set (an eager, recording, non-tuning walk)."""
    from ..analysis.traces import shape_requests
    t0 = time.time()
    reqs, per_trace = shape_requests(configs, recipes=recipes, device=device,
                                     reduced=reduced)
    for name, n in per_trace.items():
        progress(f"  {name:<44} {n} request(s)")
    progress(f"  {len(reqs)} unique shape(s) across {len(per_trace)} "
             f"trace(s) ({time.time() - t0:.1f}s)")
    return reqs


def _plans(req) -> Tuple[dict, List[dict]]:
    """``(launch_plan's plan, every candidate, that plan first)`` of one
    tunable request, from its dims."""
    from ..kernels import dwconv_w4, int4_matmul, int8_matmul, m2q_matmul
    from ..kernels import relu_attn
    *shape, dt = req.dims
    mods = {"m2q_matmul": m2q_matmul, "int8_matmul": int8_matmul,
            "relu_attn": relu_attn}
    if req.kernel in ("int4_matmul", "apot_matmul"):
        cands = int4_matmul.candidate_plans(*shape, bf16=dt == "bfloat16")
    elif req.kernel == "dwconv_w4":
        cands = dwconv_w4.candidate_plans(
            *shape, itemsize=torch.empty((), dtype=getattr(torch, dt))
            .element_size())
    elif req.kernel in mods:
        cands = mods[req.kernel].candidate_plans(*shape)
    else:
        raise ValueError(f"no launch plans for {req.kernel}")
    return cands[0], cands


def _case(req, device) -> Tuple[Callable, Callable]:
    """``(launch, check)`` for one tunable request on seeded synthetic
    operands of its dims: ``launch(plan)`` runs the kernel uncounted under
    ``plan``; ``check(y)`` raises unless y agrees with the plain version
    (the served launch: y in x's dtype where the kernel stores it)."""
    from ..core.packing import apot_decode_values, unpack_int4
    from ..kernels import apot_matmul, dwconv_w4, int4_matmul, int8_matmul
    from ..kernels import m2q_matmul, relu_attn
    from ..kernels.relu_attn_scales import relu_attn_scales_plain
    *shape, dt = req.dims
    dtype = getattr(torch, dt)
    g = torch.Generator(device=device).manual_seed(0)

    def randn(*s):
        return torch.randn(s, generator=g, device=device).to(dtype)

    def rand(*s, lo=1e-3, hi=1e-2):
        return torch.rand(s, generator=g, device=device) * (hi - lo) + lo

    def ints(lo, hi, *s, dtype=torch.int32):
        return torch.randint(lo, hi, s, generator=g, device=device,
                             dtype=dtype)

    def exact(ref):
        def check(y):
            if not torch.equal(y, ref):
                raise AssertionError(
                    f"{req.kernel} {req.dims}: a candidate differs from the "
                    f"plain version by {float((y - ref).abs().max())}")
        return check

    def bounded(ref, x, w_hat):
        bound = int4_matmul.f32_dot_bound(x.float(), w_hat)

        def check(y):
            if not bool(((y.double() - ref.double()).abs() <= bound).all()):
                raise AssertionError(
                    f"{req.kernel} {req.dims}: a candidate is outside the "
                    "f32 summation bound of the plain version")
        return check

    k = req.kernel
    if k in ("m2q_matmul", "int8_matmul", "int4_matmul", "apot_matmul"):
        M, K, N = shape
        x = randn(M, K)
        sa = (x.abs().max().float() / 127.0).reshape(())
        if k == "m2q_matmul":
            # the merged layout: each column a uniform byte or an APoT
            # code, the other engine's scales zero
            uni = torch.rand(N, generator=g, device=device) < 0.5
            w = (ints(-128, 128, K, N, dtype=torch.int8),
                 torch.where(uni, rand(N), 0.0),
                 torch.where(uni, ints(-8, 8, N).float(), 0.0),
                 torch.where(uni, 0.0, rand(N)))
            return (lambda p: m2q_matmul._launch(x, sa, *w, plan=p),
                    exact(m2q_matmul.m2q_matmul_plain(x, sa, *w)))
        if k == "int8_matmul":
            w = (ints(-128, 128, K, N, dtype=torch.int8), sa, rand(N),
                 ints(-8, 8, N).float())
            return (lambda p: int8_matmul._launch(x, *w, dtype, plan=p),
                    exact(int8_matmul.int8_matmul_plain(x, *w, dtype)))
        if k == "int4_matmul":
            w = (ints(0, 256, K, N // 2, dtype=torch.uint8), rand(N),
                 ints(0, 16, N).float())
            w_hat = (unpack_int4(w[0]).float() - w[2]) * w[1]
            return (lambda p: int4_matmul._launch(x, *w, plan=p),
                    bounded(int4_matmul.int4_matmul_plain(x, *w), x, w_hat))
        w = (ints(0, 256, K, N, dtype=torch.uint8), rand(N))
        w_hat = apot_decode_values(w[0]) * w[1]
        return (lambda p: apot_matmul._launch(x, *w, plan=p),
                bounded(apot_matmul.apot_matmul_plain(x, *w), x, w_hat))
    if k == "dwconv_w4":
        B, H, W, C, ks, s = shape
        x = randn(B, H, W, C)
        w = (ints(0, 256, ks * ks, C // 2, dtype=torch.uint8),
             rand(C, lo=0.05, hi=0.2), ints(0, 16, C).float())
        return (lambda p: dwconv_w4._launch(x, *w, ks, ks, s, dtype, plan=p),
                exact(dwconv_w4.dwconv_w4_plain(x, *w, ks, ks, s, dtype)))
    if k == "relu_attn":
        B, N, H, D = shape
        # column slices of one qkv tensor, as the MSA hands them over
        q, kk, v = (t.reshape(B, N, H, D) for t in
                    torch.split(randn(B, N, 3 * H * D), H * D, dim=-1))
        sc = relu_attn_scales_plain(q, kk, v)
        return (lambda p: relu_attn._launch(q, kk, v, *sc, 1e-6, dtype,
                                            plan=p),
                exact(relu_attn.relu_attn_plain(q, kk, v, *sc, 1e-6, dtype)))
    raise ValueError(f"no synthetic launch for {req.kernel}")


def warm(requests, cache_path: str, device="cuda", *,
         force_tune: bool = False, rows: Optional[list] = None,
         progress=print) -> Tuple[int, int]:
    """Tune (on the card) or seed with ``launch_plan``'s plans (on the
    CPU) every tunable request into the shared cache at ``cache_path``.
    ``rows``: a list that gets one dict per tuned shape (``launch_plan``'s
    plan and ms, the winner and its ms).  Returns (written, skipped as
    already cached)."""
    from ..kernels import autotune

    backend = autotune.backend_of(device)
    cache = autotune.shared_cache(cache_path)
    live = torch.device(device).type == "cuda"
    wrote = skipped = 0
    for req in requests:
        if not req.tunable:
            continue
        key = req.key(backend)
        if not force_tune and cache.get(key) is not None:
            skipped += 1
            continue
        fallback, cands = _plans(req)
        plan = fallback
        if live:
            launch, check = _case(req, device)

            def bench(p):
                check(launch(p))
                return autotune.measure(lambda: launch(p))

            timed = autotune.tune(cands, bench)
            plan = timed[0][1]
            if rows is not None:
                rows.append({"kernel": req.kernel, "dims": list(req.dims),
                             "launch_plan": fallback,
                             "launch_plan_ms": next(
                                 ms for ms, p in timed if p == fallback),
                             "tuned": plan, "tuned_ms": timed[0][0],
                             "candidates": len(cands)})
        cache.put(key, plan, save=False)
        wrote += 1
        progress(f"  {key:<60} -> {plan}")
    cache.save()
    return wrote, skipped


def smoke(configs: Sequence[str], recipes: Sequence[str], cache_path: str,
          device="cuda", reduced: bool = False, progress=print) -> int:
    """CI gate: the cache must hold every tunable shape of the CI set,
    and walking it must run zero tuning probes."""
    from ..kernels import autotune

    autotune.reset_probe_count()
    reqs = discover(configs, recipes, device, reduced, progress=progress)
    backend = autotune.backend_of(device)
    cache = autotune.AutotuneCache(cache_path).load()
    tunable = [r for r in reqs if r.tunable]
    missing = [r for r in tunable if cache.get(r.key(backend)) is None]
    probes = autotune.tuning_probe_count()
    if missing:
        progress(f"autotune_sweep: FAIL -- {len(missing)} shape(s) missing "
                 f"from {cache_path} (run the sweep; a missing shape must "
                 "not be left to tune at serving time):")
        for r in missing:
            progress(f"  MISSING {r.key(backend)}")
        return 1
    if probes:
        progress(f"autotune_sweep: FAIL -- {probes} tuning probe(s) ran "
                 "during the walk; a warmed cache must make it pure cache "
                 "hits")
        return 1
    progress(f"autotune_sweep: smoke ok -- {len(tunable)} tunable shape(s) "
             f"all present in {cache_path} ({len(reqs) - len(tunable)} "
             "note-only), 0 tuning probes")
    return 0


def main(argv=None) -> int:
    from ..kernels import autotune

    ap = argparse.ArgumentParser(
        prog="autotune_sweep",
        description="offline kernel autotune: warm the per-backend "
                    "launch-plan cache for a deployment's shape set")
    ap.add_argument("--configs", default=",".join(CI_CONFIGS),
                    help="comma-joined registry config names")
    ap.add_argument("--recipes", default=",".join(CI_RECIPES),
                    help="comma-joined quantization recipes")
    ap.add_argument("--cache", default=None,
                    help="cache file to warm/check (default: the "
                         "autotuner's per-backend file)")
    ap.add_argument("--smoke", action="store_true",
                    help="CI gate: assert the cache covers the CI shape set "
                         "(no warming; missing shapes FAIL)")
    ap.add_argument("--force-tune", action="store_true",
                    help="re-tune shapes already cached")
    ap.add_argument("--device", default="cuda",
                    help="where the walk and the tuning run (the card by "
                         "default)")
    ap.add_argument("--reduced", action="store_true",
                    help="walk the configs' REDUCED twins")
    args = ap.parse_args(argv)

    configs = [c.strip() for c in args.configs.split(",") if c.strip()]
    recipes = [r.strip() for r in args.recipes.split(",") if r.strip()]
    if not configs or not recipes:
        ap.error("--configs / --recipes must be non-empty")
    cache_path = args.cache or autotune.default_cache_path(
        autotune.backend_of(args.device))
    # point the walk's own lookups at the file being warmed or checked
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = cache_path

    if args.smoke:
        return smoke(CI_CONFIGS, CI_RECIPES, cache_path, args.device,
                     args.reduced)
    print(f"autotune_sweep: discovering shapes for {len(configs)} "
          f"config(s) x {len(recipes)} recipe(s) on {args.device}...")
    reqs = discover(configs, recipes, args.device, args.reduced)
    wrote, skipped = warm(reqs, cache_path, args.device,
                          force_tune=args.force_tune)
    print(f"autotune_sweep: {wrote} shape(s) warmed, {skipped} already "
          f"cached -> {cache_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time a kernel of the port at every shape its served paths launch,
under the launch shape its ``launch_plan`` picks and, with ``--all``,
under every other launch shape the kernel builds.

    python3 tools/m2q_tune.py [--kernel K] [--all]  # from a checkout's root

``--kernel m2q_matmul`` (the default): the 17 shapes of one
EfficientViT-B1 R224 batch-8 forward, each launch checked bit for bit
against the plain version; ``--all`` adds every other plan the autotuner
times (``kernels/autotune.py``: each kernel module's
``candidate_plans``).  ``--kernel int4_matmul`` / ``apot_matmul``: the same
forward's shapes and, for int4, qwen1.5-0.5b's lm_head at decode batch 8;
each launch checked against the plain version within the f32 summation
bound ``(K + 1) * 2^-23 * (|x| @ |W|)``, and its largest err / bound
recorded.  ``--kernel int8_matmul``: the same forward's 17 shapes (the
uniform8 PWConvs) and the int8 stem's im2col'd conv (M = 100352, K = 27,
N = 16), bf16 x and bf16 y as the served paths launch them, each launch
checked bit for bit against the plain version; ``--all`` adds every tile
the kernel builds and every K split.  ``--kernel dwconv_w4``: the 11
depthwise shapes of the same forward, bf16 x and bf16 y as the served
paths launch them, each launch checked bit for bit against the plain
version; ``--all`` adds every channel slice, column strip, row count and
outputs per thread that fits the kernel's limits.  Inputs are ``chip_smoke.py``'s (bf16 x, layers
quantized from seeded normal weights); each launch is timed in a CUDA
graph as ``chip_smoke.py`` times it.  Prints one JSON line per shape and
the sum over one forward (each shape weighted by its launches), and
writes the rows to ``chiprun_out/<kernel>_tune.json``.  One GPU.

``--kernel relu_attn`` / ``relu_attn_scales`` always sweep every plan the
kernel takes (``--all`` is implied): the two MSA shapes of the same
forward (stage 3: N = 196, 8 heads; stage 4: N = 49, 16 heads; D = 16)
at batch 1, 2, 4 and 8 (VisionEngine's buckets), bf16 q/k/v sliced from
one qkv tensor as the model hands them over; relu_attn under every
token split with bf16 out, the scale kernel under every cluster size;
each plan checked bit for bit against the plain version
(the plain scale chain) before it is timed.  Prints, per shape and per
batch-B forward, the ``launch_plan`` choice against the best plan.

``--kernel decode_attn_int8`` always sweeps every plan (rows a ring slot
x ring slots, ``decode_attn_int8.ROWS`` x ``DEPTHS``): qwen1.5-0.5b's
decode shape (T 256, Hkv 16, G 1, D 64) and a GQA shape (T 256, Hkv 4,
G 4, D 128) at batch 1, 2, 4 and 8, bf16 q, the cache lengths of
``chip_smoke.py``'s timed decode step (its first B requests' prompts +
30) and the same with the first cache filled to T; each plan's f32 store
checked within the stated bound ``2 * p_s * max|v8|`` of the plain
version and its bf16 store against the f32 store rounded once before the
bf16 launch (the served one) is timed.  Each row also times the chosen plan with every length
halved, quartered and cut to one row: how the time follows the rows
one block reads, which bounds what splitting a (b, h) over several
blocks could gain.
"""
from __future__ import annotations

import argparse
import itertools
import json
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

def plans(mod, M: int, K: int, N: int, every: bool):
    """The chosen launch shape first, then (``every``) each other plan the
    autotuner times at this shape (the module's ``candidate_plans``: every
    tile of its kind and power-of-two split that leaves no more splits
    than K steps)."""
    cands = mod.candidate_plans(M, K, N)
    return cands if every else cands[:1]


def dwconv_plans(B: int, H: int, W: int, C: int, k: int, stride: int,
                 every: bool):
    """``launch_plan``'s choice first, then (``every``) each other plan of
    the kernel (``dwconv_w4.candidate_plans``, bf16 x)."""
    from repro_torch.kernels import dwconv_w4
    cands = dwconv_w4.candidate_plans(B, H, W, C, k, stride)
    return cands if every else cands[:1]


def dwconv_case(torch, cs, rng, B, H, W, C, ks, s):
    """(launch(plan), check(y) -> None) for dwconv_w4 with bf16 x and y,
    as ``chip_smoke.check_dwconv`` builds its inputs."""
    from repro_torch.core.qtensor import QUniform
    from repro_torch.kernels import dwconv_w4 as k
    x = cs._randn(torch, rng, (B, H, W, C), dtype=torch.bfloat16)
    qt = QUniform.quantize(cs._randn(torch, rng, (ks * ks, C), std=1 / ks),
                           bits=4)
    a = (x, qt.payload, qt.scale.reshape(-1), qt.zero_point.reshape(-1),
         ks, ks, s, torch.bfloat16)
    y_ref = k.dwconv_w4_plain(*a)

    def check(y):
        return None if torch.equal(y, y_ref) else float("inf")
    return (lambda p: k._launch(*a, plan=p)), check


def m2q_case(torch, cs, rng, M, K, N):
    """(launch(plan), check(y) -> err / bound or None) for m2q_matmul."""
    from repro_torch.core.qtensor import QM2Q
    from repro_torch.core.scheme_select import select_schemes
    from repro_torch.kernels import m2q_matmul as k
    x = cs._randn(torch, rng, (M, K), dtype=torch.bfloat16)
    w = cs._randn(torch, rng, (K, N), std=K ** -0.5)
    asn = select_schemes(w)
    qt = QM2Q.quantize(w, asn.apot_idx, asn.uniform_idx,
                       act_max_abs=float(x.abs().max()))
    a = (x, qt.act_scale, qt.payload, qt.u_scale.reshape(-1),
         qt.u_zp.reshape(-1), qt.a_scale.reshape(-1))
    y_ref = k.m2q_matmul_plain(*a)

    def check(y):
        return None if torch.equal(y, y_ref) else float("inf")
    return (lambda p: k._launch(*a, plan=p)), check


def int8_case(torch, cs, rng, M, K, N):
    """(launch(plan), check(y) -> None) for int8_matmul with bf16 x and
    y, as ``chip_smoke.check_int8`` builds its inputs."""
    from repro_torch.core.qtensor import QUniform
    from repro_torch.kernels import int8_matmul as k
    x = cs._randn(torch, rng, (M, K), dtype=torch.bfloat16)
    qt = QUniform.quantize(cs._randn(torch, rng, (K, N), std=K ** -0.5),
                           bits=8, act_max_abs=float(x.abs().max()))
    a = (x, qt.payload, qt.act_scale, qt.scale.reshape(-1),
         qt.zero_point.reshape(-1), torch.bfloat16)
    y_ref = k.int8_matmul_plain(*a)

    def check(y):
        return None if torch.equal(y, y_ref) else float("inf")
    return (lambda p: k._launch(*a, plan=p)), check


def weights_only_case(torch, cs, rng, name, M, K, N):
    """(launch(plan), check(y) -> err / bound) for int4 or APoT."""
    from repro_torch.core.qtensor import QAPoT, QUniform
    from repro_torch.kernels import apot_matmul, int4_matmul
    x = cs._randn(torch, rng, (M, K), dtype=torch.bfloat16)
    w = cs._randn(torch, rng, (K, N), std=K ** -0.5)
    if name == "int4_matmul":
        qt = QUniform.quantize(w, bits=4)
        k, a = int4_matmul, (x, qt.payload, qt.scale.reshape(-1),
                             qt.zero_point.reshape(-1))
    else:
        qt = QAPoT.quantize(w)
        k, a = apot_matmul, (x, qt.codes, qt.scale.reshape(-1))
    del w
    w_hat = qt.dequant()
    bound = int4_matmul.f32_dot_bound(x.float(), w_hat)
    y_ref = getattr(k, f"{name}_plain")(*a).double()
    del w_hat

    def check(y):
        return float(((y.double() - y_ref).abs() / bound).max())
    return (lambda p: k._launch(*a, plan=p)), check


def attn_plans(kernel: str, B: int, N: int, H: int, D: int):
    """``launch_plan``'s choice first, then every other plan the kernel
    takes at this shape."""
    from repro_torch.kernels import relu_attn, relu_attn_scales
    if kernel == "relu_attn":
        return relu_attn.candidate_plans(B, N, H, D)
    else:
        chosen = relu_attn_scales.launch_plan(B, N, H * D, True)
        every = [dict(ctas=c) for c in relu_attn_scales.CTAS]
    return [chosen] + [p for p in every if p != chosen]


def attn_main(torch, cs, kernel: str) -> None:
    """The relu_attn / relu_attn_scales sweep (see the module doc)."""
    from repro_torch.configs.registry import ARCHS
    from repro_torch.kernels import relu_attn, relu_attn_scales
    import numpy as np
    cfg = ARCHS["efficientvit-b1-r224"]
    rng = np.random.default_rng(0)
    rows, totals = [], {}
    for B in (1, 2, 4, 8):
        calls = Counter(cs.main_path_calls(cfg, B)[2])
        total = totals.setdefault(f"batch {B}",
                                  {"chosen_ms": 0.0, "best_ms": 0.0})
        for (b, N, H, D), count in sorted(calls.items()):
            q, k, v = cs._attn_qkv(torch, rng, b, N, H, D)
            sc = relu_attn_scales.relu_attn_scales_plain(q, k, v)
            if kernel == "relu_attn":
                want = relu_attn.relu_attn_plain(q, k, v, *sc,
                                                 out_dtype=torch.bfloat16)

                def launch(p):
                    return relu_attn._launch(q, k, v, *sc, 1e-6,
                                             torch.bfloat16, p)
            else:
                want = torch.stack(sc)

                def launch(p):
                    return relu_attn_scales._launch(q, k, v, p)
            timed = []
            for p in attn_plans(kernel, b, N, H, D):
                y = launch(p)
                torch.cuda.synchronize()
                if not torch.equal(y, want):
                    sys.exit(f"m2q_tune: {kernel} {(b, N, H, D)} {p} "
                             "differs from the plain version")
                timed.append(dict(p, ms=cs.graph_ms(lambda: launch(p))))
            row = dict(B=b, N=N, H=H, D=D, count=count, chosen=timed[0],
                       best=min(timed, key=lambda r: r["ms"]), all=timed)
            total["chosen_ms"] += count * row["chosen"]["ms"]
            total["best_ms"] += count * row["best"]["ms"]
            rows.append(row)
            print(json.dumps({key: val for key, val in row.items()
                              if key != "all"}), flush=True)
            del q, k, v, want
    for name, total in totals.items():
        print(f"per {name} forward:", json.dumps(total), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"{kernel}_tune.json").write_text(json.dumps(rows, indent=1))


def decode_plans(B: int, T: int, H: int, G: int, D: int):
    """``launch_plan``'s choice first, then every other plan the sweep
    tries that fits the card's shared memory unchanged."""
    from repro_torch.kernels import decode_attn_int8 as k
    chosen = {key: k.launch_plan(B, T, H, G, D)[key]
              for key in ("rows", "depth")}
    every = [{"rows": r, "depth": d} for r in k.ROWS for d in k.DEPTHS]
    return [chosen] + [p for p in every if p != chosen
                       and k.fit_plan(T, G, D, p) == p]


def decode_main(torch, cs) -> None:
    """The decode_attn_int8 sweep (see the module doc)."""
    import numpy as np
    from repro_torch.configs.registry import ARCHS
    from repro_torch.kernels import decode_attn_int8 as k
    from repro_torch.nn.attention import quantize_kv_rows
    qwen = ARCHS["qwen1.5-0.5b"]
    T = cs.TOKEN_MAX_LEN
    served = [min(len(p) + 30, T - 1) for p, _, _ in cs.token_requests(qwen)]
    rng = np.random.default_rng(0)
    rows = []
    for (H, G, D), B, full in itertools.product(((16, 1, 64), (4, 4, 128)),
                                                (1, 2, 4, 8), (False, True)):
        q = cs._randn(torch, rng, (B, H, G, D), dtype=torch.bfloat16)
        k8, ks = quantize_kv_rows(cs._randn(torch, rng, (B, T, H, D)))
        v8, vs = quantize_kv_rows(cs._randn(torch, rng, (B, T, H, D)))

        def case(lengths):
            lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            return (q, k8, v8, ks, vs, lens, D ** -0.5, None)
        # full: the first cache filled to T, as chip_smoke's decode row has
        lengths = [T] + served[:B - 1] if full else served[:B]
        args = case(lengths)
        y_ref = k.decode_attn_int8_plain(*args)
        bound = k.error_bound(*args)
        timed = []
        for p in decode_plans(B, T, H, G, D):
            y = k._launch(*args, plan=p)
            y16 = k._launch(*args, out_dtype=torch.bfloat16, plan=p)
            torch.cuda.synchronize()
            ratio = float(((y - y_ref).abs() / bound).max())
            if not ratio <= 1.0 or not torch.equal(y16,
                                                   y.to(torch.bfloat16)):
                sys.exit(f"m2q_tune: decode_attn_int8 {(B, H, G, D)} {p}: "
                         f"err / bound {ratio}, or the bf16 store is not "
                         "the f32 store rounded")
            timed.append(dict(p, err_over_bound=ratio, ms=cs.graph_ms(
                lambda: k._launch(*args, out_dtype=torch.bfloat16,
                                  plan=p))))
        scaling = {}
        for frac in (2, 4, 256):
            a = case([max(1, n // frac) for n in lengths])
            scaling[f"lengths/{frac}"] = cs.graph_ms(
                lambda: k._launch(*a, out_dtype=torch.bfloat16,
                                  plan=timed[0]))
        best = min(timed, key=lambda r: r["ms"])
        row = dict(B=B, T=T, Hkv=H, G=G, D=D, lengths=lengths,
                   chosen=timed[0], best=best,
                   chosen_over_best=timed[0]["ms"] / best["ms"],
                   rows_scaling=scaling, all=timed)
        rows.append(row)
        print(json.dumps({key: v for key, v in row.items() if key != "all"}),
              flush=True)
        del q, k8, v8, ks, vs
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "decode_attn_int8_tune.json").write_text(json.dumps(rows,
                                                               indent=1))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", default="m2q_matmul",
                    choices=("m2q_matmul", "int8_matmul", "int4_matmul",
                             "apot_matmul", "dwconv_w4", "relu_attn",
                             "relu_attn_scales", "decode_attn_int8"))
    ap.add_argument("--all", action="store_true",
                    help="also time every other launch shape")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("m2q_tune: needs a CUDA device")
    import numpy as np

    import chip_smoke as cs
    if args.kernel in ("relu_attn", "relu_attn_scales"):
        return attn_main(torch, cs, args.kernel)
    if args.kernel == "decode_attn_int8":
        return decode_main(torch, cs)
    from repro_torch.configs.registry import ARCHS
    from repro_torch.kernels import int4_matmul, int8_matmul, m2q_matmul

    cfg = ARCHS["efficientvit-b1-r224"]
    dense_calls, dw_calls, _ = cs.main_path_calls(cfg, cs.BATCH)
    if args.kernel == "dwconv_w4":
        names = ("B", "H", "W", "C", "k", "stride")
        calls = Counter(c[1:] for c in dw_calls)
    else:
        names = ("M", "K", "N")
        calls = Counter(c[1:] for c in dense_calls)
        mod = {"m2q_matmul": m2q_matmul, "int8_matmul": int8_matmul,
               "int4_matmul": int4_matmul,
               "apot_matmul": int4_matmul}[args.kernel]  # APoT: int4's plan
    shapes = [(sh, n, "forward") for sh, n in calls.items()]
    if args.kernel == "int8_matmul":
        r = -(-cfg.img_res // 2)  # the stem's im2col'd 3x3 stride-2 conv
        shapes.append(((cs.BATCH * r * r, 27, cfg.widths[0]), 1, "stem"))
    if args.kernel == "int4_matmul":
        qwen = ARCHS["qwen1.5-0.5b"]
        shapes.append(((cs.TOKEN_BATCH, qwen.d_model, qwen.padded_vocab), 1,
                       "lm_head"))
    rng = np.random.default_rng(0)
    rows = []
    total = {"chosen_ms": 0.0, "best_ms": 0.0}
    for shape, count, where in shapes:
        if args.kernel == "dwconv_w4":
            launch, check = dwconv_case(torch, cs, rng, *shape)
            candidates = dwconv_plans(*shape, args.all)
        elif args.kernel == "m2q_matmul":
            launch, check = m2q_case(torch, cs, rng, *shape)
            candidates = plans(mod, *shape, args.all)
        elif args.kernel == "int8_matmul":
            launch, check = int8_case(torch, cs, rng, *shape)
            candidates = plans(mod, *shape, args.all)
        else:
            launch, check = weights_only_case(torch, cs, rng, args.kernel,
                                              *shape)
            candidates = plans(mod, *shape, args.all)
        timed = []
        for p in candidates:
            y = launch(p)
            torch.cuda.synchronize()
            ratio = check(y)
            if ratio is not None and not ratio <= 1.0:
                sys.exit(f"m2q_tune: {args.kernel} {shape} {p} is "
                         f"outside its bound (err / bound {ratio})")
            del y
            row = dict(p, ms=cs.graph_ms(lambda: launch(p)))
            if ratio is not None:
                row["err_over_bound"] = ratio
            timed.append(row)
        row = dict(zip(names, shape), count=count, where=where,
                   chosen=timed[0], best=min(timed, key=lambda r: r["ms"]),
                   all=timed)
        if where == "forward":
            total["chosen_ms"] += count * row["chosen"]["ms"]
            total["best_ms"] += count * row["best"]["ms"]
        rows.append(row)
        print(json.dumps({key: v for key, v in row.items() if key != "all"}),
              flush=True)
        del launch, check
        torch.cuda.empty_cache()
    print("per forward:", json.dumps(total), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"{args.kernel}_tune.json").write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Time a matmul kernel of the port at every shape its served paths
launch, under the launch shape its ``launch_plan`` picks and, with
``--all``, under every other tile and K split the kernel builds.

    python3 tools/m2q_tune.py [--kernel K] [--all]  # from a checkout's root

``--kernel m2q_matmul`` (the default): the 17 shapes of one
EfficientViT-B1 R224 batch-8 forward, each launch checked bit for bit
against the plain version.  ``--kernel int4_matmul`` / ``apot_matmul``:
the same forward's shapes and, for int4, qwen1.5-0.5b's lm_head at decode
batch 8; each launch checked against the plain version within the f32
summation bound ``(K + 1) * 2^-23 * (|x| @ |W|)``, and its largest
err / bound recorded.  Inputs are ``chip_smoke.py``'s (bf16 x, layers
quantized from seeded normal weights); each launch is timed in a CUDA
graph as ``chip_smoke.py`` times it.  Prints one JSON line per shape and
the sum over one forward (each shape weighted by its launches), and
writes the rows to ``chiprun_out/<kernel>_tune.json``.  One GPU.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

KEYS = ("bm", "bn", "splits")


def plans(mod, M: int, K: int, N: int, every: bool):
    """The chosen launch shape first, then (``every``) each other tile of
    its kind (the chosen width for m2q_matmul; the narrow tiles that hold
    M tokens, or the M > 16 tiles, for the weights-only kernels) and
    power-of-two split that leaves no more splits than K steps."""
    chosen = mod.launch_plan(M, K, N)
    out = [{key: chosen[key] for key in KEYS}]
    if not every:
        return out
    if not hasattr(mod, "NARROW_TILES"):  # m2q_matmul
        tiles = [t for t in mod.TILES if t[1] == chosen["bn"]]
    elif chosen["bm"] <= 16:
        tiles = [t for t in mod.NARROW_TILES if t[0] >= M]
    else:
        tiles = list(mod.TILES)
    steps = -(-K // mod.BK)
    for bm, bn in tiles:
        for splits in (1, 2, 4, 8):
            p = {"bm": bm, "bn": bn, "splits": splits}
            if splits <= steps and p != out[0]:
                out.append(p)
    return out


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
    bound = cs.f32_dot_bound(torch, x.float(), w_hat)
    y_ref = getattr(k, f"{name}_plain")(*a).double()
    del w_hat

    def check(y):
        return float(((y.double() - y_ref).abs() / bound).max())
    return (lambda p: k._launch(*a, plan=p)), check


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", default="m2q_matmul",
                    choices=("m2q_matmul", "int4_matmul", "apot_matmul"))
    ap.add_argument("--all", action="store_true",
                    help="also time every other tile and K split")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("m2q_tune: needs a CUDA device")
    import numpy as np

    import chip_smoke as cs
    from repro_torch.configs.registry import ARCHS
    from repro_torch.kernels import apot_matmul, int4_matmul, m2q_matmul

    mod = {"m2q_matmul": m2q_matmul, "int4_matmul": int4_matmul,
           "apot_matmul": apot_matmul}[args.kernel]
    if mod is apot_matmul:  # the shared template's plan and tiles
        mod = int4_matmul
    cfg = ARCHS["efficientvit-b1-r224"]
    calls = Counter(c[1:] for c in cs.main_path_calls(cfg, cs.BATCH)[0])
    shapes = [(s, n, "forward") for s, n in calls.items()]
    if args.kernel == "int4_matmul":
        qwen = ARCHS["qwen1.5-0.5b"]
        shapes.append(((cs.TOKEN_BATCH, qwen.d_model, qwen.padded_vocab), 1,
                       "lm_head"))
    rng = np.random.default_rng(0)
    rows = []
    total = {"chosen_ms": 0.0, "best_ms": 0.0}
    for (M, K, N), count, where in shapes:
        if args.kernel == "m2q_matmul":
            launch, check = m2q_case(torch, cs, rng, M, K, N)
        else:
            launch, check = weights_only_case(torch, cs, rng, args.kernel,
                                              M, K, N)
        timed = []
        for p in plans(mod, M, K, N, args.all):
            y = launch(p)
            torch.cuda.synchronize()
            ratio = check(y)
            if ratio is not None and not ratio <= 1.0:
                sys.exit(f"m2q_tune: {args.kernel} {(M, K, N)} {p} is "
                         f"outside its bound (err / bound {ratio})")
            del y
            row = dict(p, ms=cs.graph_ms(lambda: launch(p)))
            if ratio is not None:
                row["err_over_bound"] = ratio
            timed.append(row)
        row = dict(M=M, K=K, N=N, count=count, where=where,
                   chosen=timed[0], best=min(timed, key=lambda r: r["ms"]),
                   all=timed)
        if where == "forward":
            total["chosen_ms"] += count * row["chosen"]["ms"]
            total["best_ms"] += count * row["best"]["ms"]
        rows.append(row)
        print(json.dumps({key: row[key] for key in ("M", "K", "N", "count",
                                                     "where", "chosen",
                                                     "best")}), flush=True)
        del launch, check
        torch.cuda.empty_cache()
    print("per forward:", json.dumps(total), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"{args.kernel}_tune.json").write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()

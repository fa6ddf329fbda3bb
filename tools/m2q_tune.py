#!/usr/bin/env python3
"""Time ``m2q_matmul`` at every shape of one EfficientViT-B1 R224 batch-8
forward, under the launch shape ``launch_plan`` picks and, with
``--all``, under every other tile of that width and K split the kernel
builds.

    python3 tools/m2q_tune.py [--all]    # from a checkout's root; one GPU

Each launch is checked bit for bit against the plain version, then timed
in a CUDA graph as ``chip_smoke.py`` times it (same inputs: bf16 x, a
QM2Q layer from ``select_schemes``).  Prints one JSON line per shape and
the sum over one forward (each shape weighted by its launches), and
writes the rows to ``chiprun_out/m2q_tune.json``.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def plans(M: int, K: int, N: int, chosen: dict, every: bool):
    """The chosen launch shape first, then (``every``) each other tile of
    the chosen width and power-of-two split of at least one K step per
    block."""
    from repro_torch.kernels import m2q_matmul as k
    keys = ("bm", "bn", "splits")
    out = [{key: chosen[key] for key in keys}]
    if every:
        steps = -(-K // k.BK)
        for bm, bn in k.TILES:
            for splits in (1, 2, 4, 8):
                p = {"bm": bm, "bn": bn, "splits": splits}
                if bn == chosen["bn"] and splits <= steps and p != out[0]:
                    out.append(p)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--all", action="store_true",
                    help="also time every other tile height and K split")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("m2q_tune: needs a CUDA device")
    import numpy as np

    import chip_smoke as cs
    from repro_torch.configs.registry import ARCHS
    from repro_torch.core.qtensor import QM2Q
    from repro_torch.core.scheme_select import select_schemes
    from repro_torch.kernels import m2q_matmul as k

    cfg = ARCHS["efficientvit-b1-r224"]
    calls = Counter(c[1:] for c in cs.main_path_calls(cfg, cs.BATCH)[0])
    rng = np.random.default_rng(0)
    rows, total = [], {"chosen_ms": 0.0, "best_ms": 0.0}
    for (M, K, N), count in calls.items():
        x = cs._randn(torch, rng, (M, K), dtype=torch.bfloat16)
        w = cs._randn(torch, rng, (K, N), std=K ** -0.5)
        asn = select_schemes(w)
        qt = QM2Q.quantize(w, asn.apot_idx, asn.uniform_idx,
                           act_max_abs=float(x.abs().max()))
        a = (x, qt.act_scale, qt.payload, qt.u_scale.reshape(-1),
             qt.u_zp.reshape(-1), qt.a_scale.reshape(-1))
        y_ref = k.m2q_matmul_plain(*a)
        timed = []
        for p in plans(M, K, N, k.launch_plan(M, K, N), args.all):
            y = k._launch(*a, plan=p)
            torch.cuda.synchronize()
            if not torch.equal(y, y_ref):
                sys.exit(f"m2q_tune: {(M, K, N)} {p} differs from the plain "
                         "version")
            timed.append(dict(p, ms=cs.graph_ms(
                lambda: k._launch(*a, plan=p))))
        row = dict(M=M, K=K, N=N, count=count, chosen=timed[0],
                   best=min(timed, key=lambda r: r["ms"]), all=timed)
        total["chosen_ms"] += count * row["chosen"]["ms"]
        total["best_ms"] += count * row["best"]["ms"]
        rows.append(row)
        print(json.dumps({key: row[key] for key in ("M", "K", "N", "count",
                                                     "chosen", "best")}),
              flush=True)
    print("per forward:", json.dumps(total), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "m2q_tune.json").write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Write the JAX package's rows of the paper's accuracy tables (I-IV) on
the trained proxy, for the port to be held against:
``results/proxy_tables_jax.json``.

The rows are ``benchmarks/tables.py``'s accuracy columns: the committed
proxy (``results/proxy_efficientvit.npz``, read by
``benchmarks.proxy_model.train_proxy``; nothing is trained here)
fake-quantized by ``repro.core.apply.fake_quant_model`` exactly as each
table function calls it, and classified by ``benchmarks.proxy_model.
accuracy()`` (8 x 32 images of ``SyntheticVision`` from seed 10000).
For every row the file holds its name (as ``repro_torch.launch.tables``
names it), top-1 and drop from the float top-1 (rounded to 4 places, as
the reference rounds them), the 256 top-1 predictions, the sha256 of
the f32 bytes of every leaf the row's calls replaced, and for the M2Q and
``pot_mix`` rows each mixed leaf's ``apot_idx`` (Eq. 6 at ratio 0.5; one
``select_schemes`` per leaf, which is what ``fake_quant_model`` computes
inside); the labels once.

    PYTHONPATH=src python3 tools/write_proxy_tables.py   # from the root

Imports JAX (the reference's side); runs on the CPU in several minutes
(the reference's ``select_schemes`` runs eagerly).  Kernel dispatch is
scoped off, as on any host without a TPU.
"""
from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from benchmarks.proxy_model import (CACHE, CFG, _data, accuracy,  # noqa: E402
                                    train_proxy)
from repro.core import policy as pol  # noqa: E402
from repro.core.apply import fake_quant_model  # noqa: E402
from repro.core.calibrate import path_str  # noqa: E402
from repro.core.scheme_select import select_schemes  # noqa: E402
from repro.kernels import ops  # noqa: E402
from repro.models import efficientvit  # noqa: E402

OUT = ROOT / "results" / "proxy_tables_jax.json"
N_BATCHES = 8      # accuracy(): 8 batches of 32 from seed 10000
SEED0 = 10_000
BATCH = 32

DENSE, DW = pol.KIND_DENSE, pol.KIND_DWCONV


def _ours(pattern=None):
    return (("m2q", 8, DENSE, pattern), ("uniform", 4, DW, pattern))


# benchmarks/tables.py's fake_quant_model calls, row by row
ROWS = (
    [("table1/float", ())]
    + [(f"table1/{s}", ((s, b, DENSE, None),))
       for s, b in (("uniform", 8), ("pot", 3), ("apot", 8), ("m2q", 8))]
    + [("table2/float", ())]
    + [(f"table2/{b}bit", (("uniform", b, DW, None),)) for b in range(2, 9)]
    + [("table3/trio", (("uniform", 8, DENSE, None),)),
       ("table3/autovit", (("pot_mix", 8, DENSE, None),)),
       ("table3/ours", _ours())]
    + [("table4/none(trio)", ())]
    + [(f"table4/{g}", _ours(p)) for g, p in (
        ("ffn_only", r"w_pw\d"), ("attention_only", r"(w_qkv|w_proj|w_agg)"),
        ("all", r"."))])


def digest(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(np.asarray(a), np.float32)
                          .tobytes()).hexdigest()


def flat(tree) -> dict:
    """path -> leaf, in the reference's path strings."""
    return {path_str(k): v
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def predictions(params):
    fwd = jax.jit(lambda p, x: efficientvit.forward(CFG, p, x))
    ds = _data()
    preds, labels = [], []
    for b in range(N_BATCHES):
        x, y = ds.batch(SEED0 + b, BATCH)
        preds.append(np.asarray(jnp.argmax(fwd(params, jnp.asarray(x)), -1)))
        labels.append(y)
    return np.concatenate(preds), np.concatenate(labels)


def main() -> None:
    with ops.dispatch(dense=False, conv=False, attn=False):
        params = train_proxy()
        memo = {(): (params, set(), set())}

        def apply(steps):
            """(tree, replaced leaves, mixed leaves) after ``steps``."""
            if steps not in memo:
                tree, replaced, mixed = apply(steps[:-1])
                scheme, bits, kind, pattern = steps[-1]
                out = fake_quant_model(tree, efficientvit.QUANT_RULES,
                                       scheme=scheme, bits=bits,
                                       kinds={kind}, path_filter=pattern)
                before = flat(tree)
                new = {k for k, v in flat(out).items() if v is not before[k]}
                memo[steps] = (out, replaced | new, mixed | (
                    new if scheme in ("m2q", "pot_mix") else set()))
                print(f"  {steps[-1]}: {len(new)} leaves", flush=True)
            return memo[steps]

        splits = {}   # path -> apot_idx, one Eq. 6 per float leaf

        def apot_idx(path):
            if path not in splits:
                w = flat(params)[path]
                w2 = jnp.asarray(w, jnp.float32).reshape(-1, w.shape[-1])
                splits[path] = select_schemes(w2, ratio=0.5).apot_idx.tolist()
            return splits[path]

        fp = accuracy(params)
        rows, labels_once = [], None
        for name, steps in ROWS:
            tree, replaced, mixed = apply(steps)
            preds, labels = predictions(tree)
            acc = accuracy(tree)
            if acc != float(np.mean(preds == labels)):
                raise SystemExit(f"{name}: accuracy() {acc} disagrees with "
                                 "the predictions")
            labels_once = labels
            leaves = flat(tree)
            rows.append({
                "name": name, "top1": round(acc, 4),
                "drop": round(fp - acc, 4), "predictions": preds.tolist(),
                "leaves": {p: digest(leaves[p]) for p in sorted(replaced)},
                "apot_idx": {p: apot_idx(p) for p in sorted(mixed)}})
            print(f"{name}: top1 {rows[-1]['top1']} drop {rows[-1]['drop']}",
                  flush=True)
    out = {"cfg": CFG.name, "proxy": str(CACHE.relative_to(ROOT)),
           "proxy_sha256": hashlib.sha256(CACHE.read_bytes()).hexdigest(),
           "n_images": N_BATCHES * BATCH, "seed0": SEED0,
           "labels": labels_once.tolist(), "rows": rows}
    OUT.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {OUT.relative_to(ROOT)} ({OUT.stat().st_size} bytes)")


if __name__ == "__main__":
    main()

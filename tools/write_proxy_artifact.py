#!/usr/bin/env python3
"""Write the committed JAX-side artifact of the trained proxy, for the
port to load: the reduced EfficientViT-B1 trained on the synthetic vision
task (``results/proxy_efficientvit.npz``, read by
``benchmarks.proxy_model.train_proxy``; nothing is trained here),
quantized by the JAX package under ``m2q-w8a8`` from four calibration
batches exactly as ``examples/quantize_efficientvit.py`` does, and saved
with ``repro.recipe.QuantizedModel.save`` to
``results/artifacts/proxy_efficientvit_m2q/``.

Beside the artifact it writes ``expected.json``: the JAX package's
``accuracy()`` of the float and of the quantized proxy (top-1 over 8 x 32
images of ``SyntheticVision`` from seed 10000), both models' logits and
top-1 predictions on those images, and the labels.  The logits are
float32 values written in their shortest decimal form, so
``np.float32(value)`` gives back the exact bits.

    PYTHONPATH=src python3 tools/write_proxy_artifact.py   # from the root

Imports JAX (the JAX package's side of the format); runs on the CPU in
about two minutes.  Kernel dispatch is scoped off: the forward and the
quantizers take their XLA paths, as on any host without a TPU.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from benchmarks.proxy_model import CFG, _data, accuracy, train_proxy  # noqa: E402
from repro.kernels import ops  # noqa: E402
from repro.models import efficientvit  # noqa: E402
from repro.recipe import QuantizedModel, quantize  # noqa: E402

OUT = ROOT / "results" / "artifacts" / "proxy_efficientvit_m2q"
N_BATCHES = 8      # accuracy(): 8 batches of 32 from seed 10000
SEED0 = 10_000
BATCH = 32
CALIB_SEED0 = 20_000
CALIB_BATCHES = 4


def forward_logits(params):
    """(float32 logits, labels) over accuracy()'s 256 images."""
    fwd = jax.jit(lambda p, x: efficientvit.forward(CFG, p, x))
    ds = _data()
    logits, labels = [], []
    for b in range(N_BATCHES):
        x, y = ds.batch(SEED0 + b, BATCH)
        logits.append(np.asarray(fwd(params, jnp.asarray(x)), np.float32))
        labels.append(y)
    return np.concatenate(logits), np.concatenate(labels)


def main() -> None:
    with ops.dispatch(dense=False, conv=False, attn=False):
        params = train_proxy()
        ds = _data()
        calib = [jnp.asarray(ds.batch(CALIB_SEED0 + i, BATCH)[0])
                 for i in range(CALIB_BATCHES)]
        qm = quantize(CFG, params, "m2q-w8a8", calib_batches=calib)
        qm.save(OUT)
        loaded = QuantizedModel.load(OUT)
        same = jax.tree.leaves(jax.tree.map(
            lambda a, b: bool(np.array_equal(np.asarray(a), np.asarray(b))),
            qm.params, loaded.params))
        if not all(same):
            raise SystemExit("the saved artifact does not reload bit for bit")
        expected = {"cfg": CFG.name, "recipe": "m2q-w8a8",
                    "n_images": N_BATCHES * BATCH, "seed0": SEED0,
                    "calib_batches": [CALIB_SEED0 + i
                                      for i in range(CALIB_BATCHES)]}
        for what, p in (("float", params), ("quantized", qm.params)):
            logits, labels = forward_logits(p)
            preds = logits.argmax(-1)
            acc = accuracy(p)
            if acc != float(np.mean(preds == labels)):
                raise SystemExit(f"{what}: accuracy() {acc} disagrees with "
                                 "the predictions")
            expected[what] = {
                "accuracy": acc, "predictions": preds.tolist(),
                "logits": [[float(str(v)) for v in row] for row in logits]}
        expected["labels"] = labels.tolist()
    (OUT / "expected.json").write_text(json.dumps(expected, indent=1) + "\n")
    size = sum(f.stat().st_size for f in OUT.rglob("*") if f.is_file())
    print(f"wrote {OUT.relative_to(ROOT)} ({size} bytes): float top-1 "
          f"{expected['float']['accuracy']}, m2q-w8a8 top-1 "
          f"{expected['quantized']['accuracy']}")


if __name__ == "__main__":
    main()

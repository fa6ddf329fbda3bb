"""The paper's pipeline end to end on the PyTorch/CUDA port (the twin of
``examples/quantize_efficientvit.py``): load the trained proxy
EfficientViT (the reduced B1 the JAX package trained on the synthetic
vision task, committed under ``results/``), run the one-call M2Q recipe
on the card -- PTQ calibration, Eq. 6 per-filter scheme selection, QTensor
weights -- save the artifact, reload it without re-quantizing, and serve
it through the batched ``VisionEngine``.  Top-1 is printed beside the JAX
package's figures for the same images (``expected.json`` of its artifact,
``tools/write_proxy_artifact.py``).  The accelerator-simulator step of the
JAX example is JAX-side analysis and stays there.

  PYTHONPATH=src python examples/quantize_efficientvit_torch.py [--device cpu]
"""
import argparse
import json
import tempfile

import numpy as np

from repro_torch.convert import params_to_numpy
from repro_torch.core.tree import leaves_with_path
from repro_torch.data import proxy
from repro_torch.recipe import QuantizedModel, quantize


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args()
    jax_ref = json.loads((proxy.ARTIFACT / "expected.json").read_text())

    print("[1/5] load the trained proxy EfficientViT")
    params = proxy.load_proxy(args.device)
    acc_fp = proxy.accuracy(params, attn="f32")
    print(f"      float top-1 {acc_fp:.4f} (JAX "
          f"{jax_ref['float']['accuracy']:.4f})")

    print("[2/5] one-call M2Q: calibrate + quantize, on the device")
    qm = quantize(proxy.CFG, params, "m2q-w8a8",
                  calib_batches=proxy.calib_batches(), attn="f32")
    n_mixed = sum(r.decision == "mixed" for r in qm.report)
    print(f"      {len(qm.report)} quantized layers: {n_mixed} mixed "
          f"(uniform8/APoT), {len(qm.report) - n_mixed} low-bit; avg stored "
          f"bits/weight {np.mean([r.bits for r in qm.report]):.2f}")
    acc_q = proxy.accuracy(qm.params, attn="f32")
    acc_q8 = proxy.accuracy(qm.params, attn="int8")
    print(f"      top-1 M2Q {acc_q:.4f} (f32 attention; JAX "
          f"{jax_ref['quantized']['accuracy']:.4f}), {acc_q8:.4f} with int8 "
          "attention")

    print("[3/5] save -> load the artifact (no re-quantization)")
    with tempfile.TemporaryDirectory() as d:
        qm.save(d)
        qm2 = QuantizedModel.load(d, device=args.device)
    a, b = (dict(leaves_with_path(params_to_numpy(m.params)))
            for m in (qm, qm2))
    same = a.keys() == b.keys() and all(
        np.array_equal(a[k], b[k]) if isinstance(a[k], np.ndarray)
        else a[k] == b[k] for k in a)
    print(f"      round-trip identical tree: {same}")

    print("[4/5] the JAX package's artifact of the same proxy, loaded here")
    jqm = QuantizedModel.load(proxy.ARTIFACT, device=args.device)
    print(f"      top-1 {proxy.accuracy(jqm.params, attn='f32'):.4f} "
          "(f32 attention)")

    print("[5/5] vision serving (deadline flush) on the loaded tree")
    eng = qm2.serve(max_batch=8, max_delay_ms=15.0)
    rng = np.random.default_rng(0)
    handles = [eng.submit(rng.normal(0, 1, (proxy.CFG.img_res,
                                            proxy.CFG.img_res, 3))
                          .astype(np.float32)) for _ in range(12)]
    while not all(h.done() for h in handles):
        eng.poll()  # the batch of 8 ran inline; the tail of 4 runs once
        #             its 15 ms deadline fires
    logits = np.stack([h.result() for h in handles])
    assert logits.shape == (12, proxy.CFG.n_classes)
    print(f"      {eng.stats.images} images in {eng.stats.batches} batches, "
          f"buckets {sorted(eng.stats.buckets_used)}, "
          f"flushes {eng.stats.flush_reasons}")


if __name__ == "__main__":
    main()

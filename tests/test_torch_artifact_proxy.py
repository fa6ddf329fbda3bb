"""The trained proxy (``repro_torch.data.proxy``) against the JAX
package's: its weights, the committed JAX-written artifact
(``results/artifacts/proxy_efficientvit_m2q/``) in both packages, and
the port's top-1 on the CPU against ``expected.json`` (JAX's
dispatch-off logits and predictions, which the card is gated against by
``chip_smoke.proxy_vs_jax``).  Split from ``test_torch_artifact.py``:
it shares none of that file's trees."""
import json
import sys
from pathlib import Path

import numpy as np

from repro import recipe as jr
from repro_torch import recipe as tr
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.data import proxy
from torch_parity import (artifact_payload, jax_forward, jax_to_numpy,
                          same_numpy)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (the card's proxy gate)


# ---------------------------------------------------------------------------
# the trained proxy
# ---------------------------------------------------------------------------


def test_load_proxy_equals_the_jax_packages_trained_proxy():
    from benchmarks.proxy_model import train_proxy
    want = params_from_numpy(jax_to_numpy(train_proxy()), "cpu")
    same_numpy(params_to_numpy(proxy.load_proxy("cpu")),
                params_to_numpy(want))


def test_the_committed_artifact_loads_in_both_packages():
    jqm = jr.QuantizedModel.load(str(proxy.ARTIFACT))
    qm = tr.QuantizedModel.load(proxy.ARTIFACT, device="cpu")
    same_numpy(params_to_numpy(qm.params), jax_to_numpy(jqm.params))
    assert artifact_payload(qm, "port") == artifact_payload(jqm, "jax")
    assert qm.cfg == proxy.CFG and qm.recipe.name == "m2q-w8a8"


def test_port_top1_on_the_committed_artifact_matches_jax():
    """The port's forward (plain versions, f32 attention) of the JAX
    artifact against ``expected.json``: JAX's dispatch-off logits and
    predictions, which the card is gated against by
    ``chip_smoke.proxy_vs_jax``.

    Measured here: the float proxy's 256 predictions equal JAX's; of the
    quantized proxy's, 251 images' logits are bit-identical to JAX's and
    5 differ, by up to 0.067 of a max |logit| of 8.18: float summation
    order moves an activation across an int8 rounding step upstream.  No
    prediction differs; two images have a JAX top-2 margin below five
    times that difference (0.076, 0.32), so ``PROXY_MISMATCHES`` is 2,
    and top-1 may move by at most 2/256."""
    from repro.configs.efficientvit_b1 import REDUCED as JCFG
    expected = json.loads((proxy.ARTIFACT / "expected.json").read_text())
    labels = np.array(expected["labels"])
    preds, y = proxy.predict(proxy.load_proxy("cpu"), attn="f32")
    assert np.array_equal(y, labels)
    assert np.array_equal(preds, expected["float"]["predictions"])
    qm = tr.QuantizedModel.load(proxy.ARTIFACT, device="cpu")
    got, _ = proxy.logits(qm.params, attn="f32")
    preds = got.argmax(-1)
    assert abs(float(np.mean(preds == labels))
               - expected["quantized"]["accuracy"]) <= \
        chip_smoke.PROXY_MISMATCHES / len(labels)

    # the recorded logits are JAX's dispatch-off forward of the artifact
    want = np.array(expected["quantized"]["logits"], np.float32)
    assert np.array_equal(want.argmax(-1),
                          expected["quantized"]["predictions"])
    ds = proxy._data()
    images = np.concatenate([ds.batch(expected["seed0"] + b, proxy.BATCH)[0]
                             for b in range(8)])
    jqm = jr.QuantizedModel.load(str(proxy.ARTIFACT))
    np.testing.assert_allclose(jax_forward(JCFG, jqm.params, images), want,
                               rtol=0, atol=1e-4 * np.abs(want).max())
    res, failures = chip_smoke.proxy_vs_jax(got, want)
    assert failures == []
    # the gate tells another function apart though every argmax may hold:
    # int8 attention moves every image's logits
    other, _ = proxy.logits(qm.params, attn="int8")
    assert chip_smoke.proxy_vs_jax(other, want)[0]["images_off"] == 256
    assert chip_smoke.proxy_vs_jax(other, want)[1]
    top2 = np.sort(want, -1)[:, -2:]
    near = int(((top2[:, 1] - top2[:, 0])
                < 5 * res["logits_max_abs_diff"]).sum())
    assert near <= chip_smoke.PROXY_MISMATCHES
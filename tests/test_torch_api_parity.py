"""Public names the port lacked against the JAX package, each held against
JAX's on the same inputs: ``ServeStats.reset()``, ``VisionEngine(
min_bucket=)`` (and ``QuantizedModel.serve(min_bucket=)``),
``QM2Q.scheme_mask``, ``qmatmul``, ``packing.store_uniform`` /
``load_uniform`` and ``calibrate.path_str``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import REDUCED as JREDUCED
from repro.core import calibrate as jcal
from repro.core import packing as jpacking
from repro.core import qtensor as jq
from repro.core import quant as jquant
from repro.kernels import ops as jops
from repro.models import efficientvit as jev
from repro.serving.batching import ServeStats as JServeStats
from repro.serving.vision import VisionEngine as JVisionEngine
from repro_torch import recipe as tr
from repro_torch.configs.registry import REDUCED as TREDUCED
from repro_torch.convert import params_from_numpy
from repro_torch.core import calibrate as tcal
from repro_torch.core import packing as tpacking
from repro_torch.core import quant as tquant
from repro_torch.core.qtensor import QAPoT, QM2Q, QUniform, qmatmul
from repro_torch.core.scheme_select import select_schemes
from repro_torch.core.tree import leaves_with_path
from repro_torch.serving import errors as terrors
from repro_torch.serving.batching import ServeStats as TServeStats
from repro_torch.serving.vision import VisionEngine as TVisionEngine
from torch_parity import jax_to_numpy

B1 = "efficientvit-b1-r224"


# ---------------------------------------------------------------------------
# ServeStats.reset
# ---------------------------------------------------------------------------


def _drive(s):
    """The same calls on either package's ServeStats (the JAX test's,
    tests/test_fault_tolerance.py, and every other recorder)."""
    s.submitted += 7
    for kind in ("completed", "failed", "cancelled", "timed_out", "shed"):
        s.record_outcome(kind)
    s.record_outcome("rejected")
    s.record_batch(items=3, padded=1, capacity=8, bucket=4)
    s.record_batch(items=8, capacity=8, bucket=8)
    s.record_flush("full")
    s.record_flush("deadline")
    for ms in (1.0, 4.0, 2.5):
        s.record_latency(ms)


def test_servestats_reset_zeroes_every_counter_as_jax_does():
    """After the same calls both summaries agree; after ``reset()`` both
    equal a fresh stats' summary, the object and its lock kept (the
    scheduler holds the reference), and recording goes on from zero."""
    ours, theirs = TServeStats(), JServeStats()
    _drive(ours)
    _drive(theirs)
    assert ours.summary() == theirs.summary()
    assert ours.resolved == theirs.resolved == 5
    lock = ours._lock
    ours.reset()
    theirs.reset()
    assert ours.summary() == theirs.summary() == TServeStats().summary()
    assert ours.resolved == 0 and ours.rejected == 0
    assert ours._lock is lock
    _drive(ours)
    _drive(theirs)
    assert ours.summary() == theirs.summary()


# ---------------------------------------------------------------------------
# VisionEngine(min_bucket=)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def b1_params():
    """The reduced B1's float weights from JAX's init, in both packages."""
    cfg = JREDUCED[B1]
    jparams = jax.jit(lambda k: jev.init(cfg, k))(jax.random.PRNGKey(0))
    return jparams, params_from_numpy(jax_to_numpy(jparams), "cpu")


def _engines(b1_params, min_bucket):
    jparams, tparams = b1_params
    off = jops.DispatchConfig(dense=False, conv=False, attn=False)
    jeng = JVisionEngine(JREDUCED[B1], jparams, max_batch=8,
                         min_bucket=min_bucket, dispatch=off)
    teng = TVisionEngine(TREDUCED[B1], tparams, max_batch=8,
                         min_bucket=min_bucket)
    return jeng, teng


@pytest.mark.parametrize("min_bucket", [1, 2, 8])
def test_vision_buckets_equal_jaxs(b1_params, min_bucket):
    """For n = 1..8 the executed bucket equals JAX's: the smallest power
    of two >= n, floored at ``min_bucket``, capped at ``max_batch``."""
    jeng, teng = _engines(b1_params, min_bucket)
    got = [teng.bucket(n) for n in range(1, 9)]
    assert got == [jeng.bucket(n) for n in range(1, 9)]
    assert min(got) == min_bucket and max(got) == 8


@pytest.mark.parametrize("min_bucket", [1, 2, 8])
def test_vision_logits_and_buckets_used_equal_jaxs(b1_params, min_bucket):
    """``classify`` of 1, 3 and 8 images through both engines: the logits
    within 1e-5 of max |logit| (f32 XLA vs torch on the same weights; the
    padded rows are zeros and are dropped) and the buckets used equal."""
    jeng, teng = _engines(b1_params, min_bucket)
    images = np.random.default_rng(3).normal(
        0, 1, (8, 32, 32, 3)).astype(np.float32)
    for n in (1, 3, 8):
        want = jeng.classify(images[:n])
        got = teng.classify(images[:n])
        assert got.shape == want.shape == (n, TREDUCED[B1].n_classes)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    assert teng.stats.summary()["buckets_used"] == \
        jeng.stats.summary()["buckets_used"]
    assert teng.stats.padded_images == jeng.stats.padded_images


def test_quantized_model_serve_passes_min_bucket():
    """``QuantizedModel.serve(min_bucket=)`` builds the engine with it
    (before, a TypeError)."""
    cfg = TREDUCED[B1]
    from repro_torch.models import efficientvit
    qm = tr.quantize(cfg, efficientvit.init(cfg, seed=0, device="cpu"),
                     "w4-weights-only")
    eng = qm.serve(max_batch=8, min_bucket=4)
    assert eng.min_bucket == 4 and eng.bucket(1) == 4 and eng.bucket(5) == 8
    out = eng.classify(np.zeros((2, 32, 32, 3), np.float32))
    assert out.shape == (2, cfg.n_classes)
    assert eng.stats.summary()["buckets_used"] == [4]


# ---------------------------------------------------------------------------
# the smaller names
# ---------------------------------------------------------------------------


def _w(seed, shape=(48, 40), std=0.1):
    return np.random.default_rng(seed).normal(0, std, shape).astype(
        np.float32)


def test_scheme_mask_equals_jaxs_bit_for_bit():
    """The (N,) uniform-column mask of the same mixed layer in both
    packages: equal, and True on exactly the n_uniform columns."""
    w = _w(1)
    asn = select_schemes(torch.from_numpy(w))
    ours = QM2Q.quantize(torch.from_numpy(w), asn.apot_idx, asn.uniform_idx)
    theirs = jq.QM2Q.quantize(jnp.asarray(w), asn.apot_idx, asn.uniform_idx)
    got = ours.scheme_mask().numpy()
    assert got.dtype == np.bool_ and got.shape == (40,)
    np.testing.assert_array_equal(got, np.asarray(theirs.scheme_mask()))
    assert int(got.sum()) == ours.n_uniform
    np.testing.assert_array_equal(np.flatnonzero(got),
                                  np.sort(asn.uniform_idx))


@pytest.mark.parametrize("kind", ["uniform4", "uniform8+act", "apot", "m2q"])
def test_qmatmul_equals_jaxs(kind):
    """``qmatmul(x, W)`` (the leaf's plain matmul) on the same leaf in
    both packages, within 1e-5 of max |y| (f32 dots summed in different
    orders; the W8A8 and mixed paths' integer sums are exact)."""
    w, x = _w(2), _w(3, (5, 48), std=1.0)
    ams = float(np.abs(x).max())
    tw, jw = torch.from_numpy(w), jnp.asarray(w)
    if kind == "uniform4":
        ours, theirs = QUniform.quantize(tw, bits=4), \
            jq.QUniform.quantize(jw, bits=4)
    elif kind == "uniform8+act":
        ours = QUniform.quantize(tw, bits=8, act_max_abs=ams)
        theirs = jq.QUniform.quantize(jw, bits=8, act_max_abs=ams)
    elif kind == "apot":
        ours, theirs = QAPoT.quantize(tw), jq.QAPoT.quantize(jw)
    else:
        asn = select_schemes(tw)
        ours = QM2Q.quantize(tw, asn.apot_idx, asn.uniform_idx,
                             act_max_abs=ams)
        theirs = jq.QM2Q.quantize(jw, asn.apot_idx, asn.uniform_idx,
                                  act_max_abs=ams)
    with jops.dispatch(dense=False, conv=False, attn=False):
        want = np.asarray(jq.qmatmul(jnp.asarray(x), theirs))
    got = qmatmul(torch.from_numpy(x), ours).numpy()
    assert got.shape == want.shape == (5, 40)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("bits", [3, 4, 8])
def test_store_and_load_uniform_equal_jaxs_bytes(bits):
    """``store_uniform`` of the same UniformQ in both packages: the stored
    payload's bytes (4-bit packed two a byte, other widths one byte a
    weight), dtype and shape equal; ``load_uniform`` gives back the int32
    codes in both."""
    w = _w(4, (16, 24))
    ours = tquant.uniform_quantize(torch.from_numpy(w), bits=bits)
    theirs = jquant.uniform_quantize(jnp.asarray(w), bits=bits)
    np.testing.assert_array_equal(ours.q.numpy(), np.asarray(theirs.q))
    got = tpacking.store_uniform(ours).numpy()
    want = np.asarray(jpacking.store_uniform(theirs))
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    back = tpacking.load_uniform(torch.from_numpy(got), bits)
    assert back.dtype == torch.int32
    np.testing.assert_array_equal(back.numpy(), ours.q.numpy())
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jpacking.load_uniform(jnp.asarray(want),
                                                       bits)))


def test_path_str_equals_jaxs_and_the_ports_paths():
    """``path_str`` of every JAX tree path of a nested dict/list tree
    equals JAX's and the port's own ``leaves_with_path`` keys."""
    tree = {"b": [{"w": 1.0}, {"w": 2.0, "a": [3.0, 4.0]}], "a": {"x": 0.0}}
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    got = [tcal.path_str(path) for path, _ in flat]
    assert got == [jcal.path_str(path) for path, _ in flat]
    assert got == [k for k, _ in leaves_with_path(tree)]
    assert tcal.path_str(("layers", 3, "w")) == "layers/3/w"


def test_errors_docstring_names_the_ported_supervisor():
    """The failure taxonomy's docstring no longer calls the supervision
    layer unported; the process-level errors it names are exported."""
    doc = terrors.__doc__
    assert "not ported" not in doc and ".supervisor" in doc
    for name in ("HungStepError", "EngineCrashError", "CircuitOpenError"):
        assert name in doc and name in terrors.__all__

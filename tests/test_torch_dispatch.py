"""The port's dispatch layer (``repro_torch.kernels.ops``: scopes, the
trip latch, the env vars, the backend default) against the JAX package's
``repro.kernels.ops``, and what each axis routes on a REDUCED
EfficientViT-B1 (widths (8,16,32), R32, f32) quantized under m2q-w8a8:
the port's all-off forward against JAX's dispatch-off forward, and the
shapes the port's autotuner is asked for against those JAX's asks for on
the same quantized tree.  Only the CPU: the device given to the port's
axes is a ``torch.device``, and ``cuda`` needs no card to resolve."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.efficientvit_b1 import REDUCED as JCFG
from repro.kernels import autotune as jautotune
from repro.kernels import ops as jops
from repro.models import efficientvit as jev
from repro_torch import kernels
from repro_torch.configs.efficientvit_b1 import REDUCED as TCFG
from repro_torch.convert import params_to_numpy
from repro_torch.kernels import autotune, ops
from repro_torch.models import efficientvit as tev
from repro_torch.recipe import quantize
from torch_parity import jax_forward, numpy_to_jax

AXES = ("dense", "conv", "attn")
JAX_ENV = {"dense": "REPRO_PALLAS_DISPATCH",
           "conv": "REPRO_PALLAS_CONV_DISPATCH",
           "attn": "REPRO_PALLAS_ATTN_DISPATCH"}
CPU, CUDA = torch.device("cpu"), torch.device("cuda")
# the port's backend default on a CPU tensor: the dense and conv wrappers
# run their plain versions there; the MSA keeps its f32 einsums
CPU_DEFAULT = {"dense": True, "conv": True, "attn": False}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its walks run many small
    ops, which torch's thread pool slows ~30x when other test workers
    hold the cores (a reduced discovery: 1.9 s vs 60 s under load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in list(JAX_ENV.values()) + list(ops._ENV.values()):
        monkeypatch.delenv(name, raising=False)
    jops.reset_trip_latch()
    ops.reset_trip_latch()
    yield
    jops.reset_trip_latch()
    ops.reset_trip_latch()


def _state(env=(), trips=(), scopes=()):
    return {"env": dict(env), "trips": tuple(trips), "scopes": tuple(scopes)}


# (name, env {axis: value}, tripped axes, nested scopes (outer first))
CASES = [
    ("backend default", _state()),
    ("env dense on", _state(env={"dense": "1"})),
    ("env dense off", _state(env={"dense": "0"})),
    ("env conv on", _state(env={"conv": "1"})),
    ("env conv off", _state(env={"conv": "0"})),
    ("env attn on", _state(env={"attn": "1"})),
    ("env attn off, dense on", _state(env={"attn": "0", "dense": "1"})),
    ("env attn empty string", _state(env={"attn": ""})),
    ("scope dense on", _state(scopes=[{"dense": True}])),
    ("scope dense off", _state(scopes=[{"dense": False}])),
    ("scope conv off in dense on",
     _state(scopes=[{"dense": True}, {"conv": False}])),
    ("scope attn off in dense on",
     _state(scopes=[{"dense": True}, {"attn": False}])),
    ("scope attn on alone", _state(scopes=[{"attn": True}])),
    ("scope dense on over env off",
     _state(env={"dense": "0", "conv": "0", "attn": "0"},
            scopes=[{"dense": True}])),
    ("scope config all off", _state(scopes=[
        ops.DispatchConfig(dense=False, conv=False, attn=False)])),
    ("scope config attn off over dense on", _state(scopes=[
        ops.DispatchConfig(attn=True).layered_over(
            ops.DispatchConfig(dense=False, conv=True))])),
    ("dense tripped", _state(trips=["dense"])),
    ("conv tripped", _state(trips=["conv"])),
    ("attn tripped", _state(trips=["attn"])),
    ("dense tripped over env on", _state(env={"dense": "1"},
                                         trips=["dense"])),
    ("conv tripped over env on", _state(env={"conv": "1"}, trips=["conv"])),
    ("dense tripped under scope on", _state(trips=["dense"],
                                            scopes=[{"dense": True}])),
    ("conv tripped under scope dense on",
     _state(trips=["conv"], scopes=[{"dense": True}])),
    ("conv tripped, scope attn on", _state(trips=["conv"],
                                           scopes=[{"attn": True}])),
    ("all tripped twice", _state(trips=["dense", "conv", "attn", "conv"])),
]


def _scope_kw(s):
    if isinstance(s, dict):
        return s
    return {ax: getattr(s, ax) for ax in AXES}


def _jax_answers(state, backend):
    with pytest.MonkeyPatch.context() as mp:
        for ax, v in state["env"].items():
            mp.setenv(JAX_ENV[ax], v)
        mp.setattr(jax, "default_backend", lambda: backend)
        for ax in state["trips"]:
            jops.trip_axis(ax)
        try:
            return _nested(jops.dispatch, state["scopes"], lambda: {
                "dense": jops.dispatch_enabled(),
                "conv": jops.conv_dispatch_enabled(),
                "attn": jops.attn_dispatch_enabled()})
        finally:
            jops.reset_trip_latch()


def _port_answers(state, device):
    with pytest.MonkeyPatch.context() as mp:
        for ax, v in state["env"].items():
            mp.setenv(ops._ENV[ax], v)
        for ax in state["trips"]:
            ops.trip_axis(ax)
        try:
            return _nested(ops.dispatch, state["scopes"], lambda: {
                "dense": ops.dispatch_enabled(device),
                "conv": ops.conv_dispatch_enabled(device),
                "attn": ops.attn_dispatch_enabled(device)})
        finally:
            ops.reset_trip_latch()


def _nested(dispatch, scopes, read):
    if not scopes:
        return read()
    with dispatch(**_scope_kw(scopes[0])):
        return _nested(dispatch, scopes[1:], read)


@pytest.mark.parametrize("name,state", CASES, ids=[c[0] for c in CASES])
def test_resolution_table_matches_jax(name, state):
    """Scope -> latch -> env var -> backend default, in both packages,
    each under its own env var names.  A CUDA tensor in the port answers
    as JAX on a TPU in every row.  A CPU tensor answers as JAX on its CPU
    except where the backend default decides (JAX's answer moves with the
    backend), where the port's CPU default holds: dense and conv on (the
    wrappers' plain versions), attn off."""
    j_cpu = _jax_answers(state, "cpu")
    j_tpu = _jax_answers(state, "tpu")
    t_cpu = _port_answers(state, CPU)
    t_cuda = _port_answers(state, CUDA)
    assert t_cuda == j_tpu, name
    for ax in AXES:
        want = j_cpu[ax] if j_cpu[ax] == j_tpu[ax] else CPU_DEFAULT[ax]
        assert t_cpu[ax] == want, (name, ax)


def test_trip_latch_layers_under_scope_and_over_env(monkeypatch):
    """JAX's test of the same name on the port: the latch beats the env
    var, an explicit scope beats the latch, counts count, an unknown axis
    raises, and ``reset_trip_latch`` re-arms."""
    monkeypatch.setenv("REPRO_TORCH_DISPATCH", "1")
    assert ops.dispatch_enabled(CPU)
    ops.trip_axis("dense")
    assert not ops.dispatch_enabled(CPU)       # latch beats the env var
    assert not ops.dispatch_enabled(CUDA)
    with ops.dispatch(dense=True):
        assert ops.dispatch_enabled(CPU)       # explicit scope beats latch
    assert ops.trip_counts() == {"dense": 1, "conv": 0, "attn": 0}
    assert ops.axis_tripped("dense") and not ops.axis_tripped("conv")
    with pytest.raises(ValueError, match="unknown dispatch axis"):
        ops.trip_axis("bogus")
    ops.reset_trip_latch()
    assert ops.trip_counts() == {"dense": 0, "conv": 0, "attn": 0}
    assert ops.dispatch_enabled(CPU)


def test_attn_dispatch_layering(monkeypatch):
    """JAX's test of the same name on the port, at a CUDA device (JAX's
    on a TPU would read the same) and at the CPU's default."""
    assert ops.attn_dispatch_enabled(CUDA)
    assert not ops.attn_dispatch_enabled(CPU)  # the CPU's f32 MSA
    with ops.dispatch(dense=True):             # attn follows dense if unset
        assert ops.attn_dispatch_enabled(CPU)
        with ops.dispatch(attn=False):         # nested: attn off, dense kept
            assert ops.dispatch_enabled(CPU)
            assert not ops.attn_dispatch_enabled(CPU)
        assert ops.attn_dispatch_enabled(CPU)
    monkeypatch.setenv("REPRO_TORCH_ATTN_DISPATCH", "1")
    assert ops.attn_dispatch_enabled(CPU)
    monkeypatch.setenv("REPRO_TORCH_DISPATCH", "0")
    assert not ops.dispatch_enabled(CUDA)      # attn env does not leak
    monkeypatch.setenv("REPRO_TORCH_ATTN_DISPATCH", "0")
    monkeypatch.setenv("REPRO_TORCH_DISPATCH", "1")
    assert not ops.attn_dispatch_enabled(CUDA)  # attn's own env wins
    with ops.dispatch(dense=True):              # ...and a scope over it
        assert ops.attn_dispatch_enabled(CUDA)
    cfg = ops.DispatchConfig(attn=True).layered_over(
        ops.DispatchConfig(dense=False, conv=True))
    assert (cfg.dense, cfg.conv, cfg.attn) == (False, True, True)
    assert ops.active_dispatch() == ops.DispatchConfig()
    with ops.dispatch(cfg, conv=False):
        assert ops.active_dispatch() == ops.DispatchConfig(False, False,
                                                           True)
        assert ops.resolve(CPU) == ops.DispatchConfig(False, False, True)


def test_each_package_reads_only_its_own_env_vars():
    """One process imports both packages: a switch meant for one never
    steers the other."""
    with pytest.MonkeyPatch.context() as mp:
        for name in JAX_ENV.values():
            mp.setenv(name, "0")
        assert ops.resolve(CPU) == ops.DispatchConfig(True, True, False)
        assert ops.resolve(CUDA) == ops.DispatchConfig(True, True, True)
    with pytest.MonkeyPatch.context() as mp:
        for name in ops._ENV.values():
            mp.setenv(name, "0")
        mp.setattr(jax, "default_backend", lambda: "tpu")
        assert jops.dispatch_enabled() and jops.attn_dispatch_enabled()
        assert ops.resolve(CUDA) == ops.DispatchConfig(False, False, False)


# ---------------------------------------------------------------------------
# the REDUCED B1 under each routing
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def b1():
    """The port's m2q-w8a8 tree of the REDUCED B1 (seed 0), the same tree
    in the JAX package, and seeded images."""
    qm = quantize(TCFG, tev.init(TCFG, seed=0, device="cpu"), "m2q-w8a8")
    images = np.random.default_rng(0).normal(
        0, 1, (4, TCFG.img_res, TCFG.img_res, 3)).astype(np.float32)
    return qm, numpy_to_jax(params_to_numpy(qm.params)), images


def test_all_off_forward_matches_jax_dispatch_off(b1):
    """``dispatch(dense=False, conv=False, attn=False)``: the plain
    QTensor paths (``qmatmul``, the dequantized depthwise conv, the f32
    MSA), the twin of JAX's XLA path, on the same quantized tree as JAX's
    dispatch-off forward.  Bound as ``test_torch_slice.py``'s carried
    quantized forward: 1e-4 of the largest logit (float summation order
    upstream of an int8 rounding), argmax equal.  No wrapper runs a
    depthwise conv, and the plain QTensor path of a calibrated QM2Q leaf
    is ``m2q_matmul``'s plain version."""
    qm, jtree, images = b1
    kernels.reset_counts()
    with ops.dispatch(dense=False, conv=False, attn=False):
        y = qm.forward(images).numpy()
    counts = kernels.counts()
    assert counts["dwconv_w4"]["plain_calls"] == 0
    assert counts["m2q_matmul"]["plain_calls"] == 16
    assert not any(c["launches"] for c in counts.values())
    want = jax_forward(JCFG, jtree, images)
    np.testing.assert_allclose(y, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    np.testing.assert_array_equal(y.argmax(-1), want.argmax(-1))
    # the default CPU routing (the wrappers' plain versions, f32 MSA)
    # computes the same function
    kernels.reset_counts()
    np.testing.assert_allclose(qm.forward(images).numpy(), y, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    assert kernels.counts()["dwconv_w4"]["plain_calls"] == 7


def test_a_tripped_conv_axis_routes_convs_to_the_plain_path(b1):
    """``trip_axis("conv")``: the PWConvs, MSA qkv/proj and depthwise
    convs leave the wrappers; ``nn.dense`` (the head's last matmul) stays
    on the dense axis."""
    qm, _, images = b1
    ops.trip_axis("conv")
    kernels.reset_counts()
    with ops.dispatch(attn=False):
        qm.forward(images)
    counts = kernels.counts()
    assert counts["dwconv_w4"]["plain_calls"] == 0
    # 15 conv leaves' plain QM2Q path + the head's dense through the wrapper
    assert counts["m2q_matmul"]["plain_calls"] == 16
    reqs = []
    with autotune.record_requests(reqs):
        qm.forward(images)
    assert [r.kernel for r in reqs] == ["m2q_matmul"]


def _jax_requests(jtree, images, monkeypatch):
    """The (kernel, M, N, K) shapes JAX's entry points ask its autotuner
    for while its forward lowers under kernel dispatch, on the same tree.
    The kernel bodies are stubbed with zeros of the output's shape: this
    JAX lacks ``jax.core.trace_state_clean`` and Pallas' ``unblocked``
    indexing, so neither the tuner's trace check nor the dwconv kernel
    would lower; the requests are recorded before either."""
    monkeypatch.setattr(jax.core, "trace_state_clean", lambda: False,
                        raising=False)

    def mm(n_of):
        return lambda x, *a, **k: jnp.zeros((x.shape[0], n_of(a)),
                                            jnp.float32)

    monkeypatch.setattr(jops, "_m2q_core", mm(lambda a: a[1].shape[1]))
    monkeypatch.setattr(jops, "_int8_core", mm(lambda a: a[0].shape[1]))
    monkeypatch.setattr(jops, "_int4_core", mm(lambda a: 2 * a[0].shape[1]))
    monkeypatch.setattr(jops, "_apot_core", mm(lambda a: a[0].shape[1]))
    monkeypatch.setattr(
        jops, "_dwconv_core",
        lambda x, packed, scale, zp, kh, kw, stride, *a: jnp.zeros(
            (x.shape[0], -(-x.shape[1] // stride), -(-x.shape[2] // stride),
             x.shape[3]), jnp.float32))
    monkeypatch.setattr(jops, "_relu_attn_core",
                        lambda q, *a: jnp.zeros(q.shape, jnp.float32))
    reqs = []
    with jautotune.record_requests(reqs), \
            jops.dispatch(dense=True, conv=True, attn=True):
        jax.jit(lambda p, x: jev.forward(JCFG, p, x)).lower(jtree, images)
    return reqs


def _as_jax(req):
    """A port ShapeRequest in the JAX package's (kernel, M, N, K) terms."""
    d = req.dims
    if req.kernel == "dwconv_w4":
        B, H, W, C, k, s, _ = d
        return (req.kernel, B * -(-H // s) * -(-W // s), C, k * k)
    if req.kernel == "relu_attn":
        B, N, H, D, _ = d
        return (req.kernel, N, D, B * H)
    M, K, N, _ = d
    return (req.kernel, M, N, K)


def test_recorded_requests_match_jax_shapes(b1, monkeypatch):
    """``record_requests`` over the forward with every axis on: one
    request per launch (each entry point asks before it picks the plain
    version), so one per distinct launch shape after deduplication; and
    those shapes are the ones JAX's entry points ask for on the same
    tree."""
    qm, jtree, images = b1
    kernels.reset_counts()
    with autotune.record_requests() as reqs, \
            ops.dispatch(dense=True, conv=True, attn=True):
        qm.forward(images)
    calls = {k: c["plain_calls"] for k, c in kernels.counts().items()}
    for kernel in ("m2q_matmul", "dwconv_w4", "relu_attn"):
        assert sum(r.kernel == kernel for r in reqs) == calls[kernel]
    assert all(r.tunable and r.dims[-1] == "float32" for r in reqs)
    ours = {_as_jax(r) for r in reqs}
    theirs = {(r.kernel, r.M, r.N, r.K)
              for r in _jax_requests(jtree, images, monkeypatch)}
    assert ours == theirs
    assert len(set(reqs)) == len(ours)

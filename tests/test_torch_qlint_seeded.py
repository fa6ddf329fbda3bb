"""The port's qlint rules on recorded seeds: guarded and unguarded
activation quantization, a permutation epilogue, the conv budget, and
parameter paths spelled as the JAX package's traces spell them."""
import numpy as np
import torch
import torch.nn.functional as F

from torch_qlint_cases import jax_leak_check, rule_paths, tiny_qtensor  # noqa: F401

from repro_torch.analysis import lint
from repro_torch.analysis.traces import param_paths, trace_fn
from repro_torch.core.quant import quantize_act


def test_unguarded_act_quant_distinguishes_guarded_conversions():
    x = torch.zeros(8, 16)
    s = torch.tensor(0.05)

    def unguarded(v):
        return quantize_act(v, s)

    def guarded(v):
        return quantize_act(torch.where(torch.isfinite(v), v, 0.0), s)

    def scrubbed(v):
        return quantize_act(torch.nan_to_num(v), s)

    tr = trace_fn(unguarded, (x,), name="seeded/unguarded", dispatch=False,
                  meta={"quantized": True})
    vs = lint(tr, "unguarded-act-quant")
    assert [(v.severity, v.path) for v in vs] == [
        ("warn", "core/quant.py:quantize_act")]
    # a finite guard upstream of the conversion silences the warning --
    # the rule is non-vacuous in BOTH directions
    for fn in (guarded, scrubbed):
        tr_ok = trace_fn(fn, (x,), name="seeded/guarded", dispatch=False,
                         meta={"quantized": True})
        assert lint(tr_ok, "unguarded-act-quant") == []


def test_no_gather_concat_fires_on_a_permutation_epilogue():
    qt = tiny_qtensor()
    perm = torch.from_numpy(np.random.default_rng(0).permutation(16))
    x = torch.zeros(4, 32)

    def epilogue(q, p, v):   # the deleted M2Q permutation, re-added
        w = torch.cat([q.payload[:, :8], q.payload[:, 8:]], dim=1)
        return v @ w.index_select(1, p).to(torch.float32)

    tr = trace_fn(epilogue, (qt, perm, x), name="seeded/epilogue",
                  dispatch=False, meta={"quantized": True})
    assert rule_paths(lint(tr, "no-gather-concat")) == {
        ("no-gather-concat", "0/0")}
    msgs = sorted(v.message.split(" reachable")[0]
                  for v in lint(tr, "no-gather-concat"))
    assert msgs == ["1 concatenate op(s)", "1 gather op(s)"]

    def after(q, v):         # a cat of the PRODUCT is not an epilogue
        y = v @ q.dequant()
        return torch.cat([y, y], dim=1)

    tr_ok = trace_fn(after, (qt, x), name="seeded/after", dispatch=False,
                     meta={"quantized": True})
    assert lint(tr_ok, "no-gather-concat") == []


def test_conv_budget_counts_convolutions():
    x = torch.zeros(1, 4, 8, 8)
    w = torch.zeros(4, 1, 3, 3)

    def two(v, k):
        return F.conv2d(F.conv2d(v, k, padding=1, groups=4), k, padding=1,
                        groups=4)

    tr = trace_fn(two, (x, w), name="seeded/convs", dispatch=False,
                  meta={"conv_budget": 1})
    (v,) = lint(tr, "conv-budget")
    assert v.message.startswith("2 convolution(s)")
    assert "fell back" in v.message
    tr.meta["conv_budget"] = 3
    (v,) = lint(tr, "conv-budget")
    assert "update the budget" in v.message
    tr.meta["conv_budget"] = 2
    assert lint(tr, "conv-budget") == []


def test_param_paths_spell_the_jax_packages_paths(jax_leak_check):
    import jax.numpy as jnp

    from repro.analysis.traces import param_paths as jax_param_paths
    from repro.core import QUniform as JQUniform
    w = np.random.default_rng(11).normal(0, 0.1, (16, 8)).astype(np.float32)
    qt = JQUniform.quantize(jnp.asarray(w), bits=8,
                            act_max_abs=jnp.float32(3.0))
    jpaths = jax_param_paths(({"w": qt, "b": jnp.zeros(8)},
                              jnp.zeros((2, 16))))
    pqt = tiny_qtensor(act=True)
    paths = param_paths(({"w": pqt, "b": torch.zeros(8)}, torch.zeros(2, 16)))
    assert paths == jpaths == ["0/b", "0/w/0", "0/w/1", "0/w/2", "0/w/3",
                               "1"]
    # the recorder names the same values: the payload is 0/w/0
    tr = trace_fn(lambda p, v: p["w"].matmul(v), (
        {"w": pqt, "b": torch.zeros(8)}, torch.zeros(2, 32)),
        name="align", dispatch=False)
    g = tr.graph
    assert list(g.params) == paths
    assert g.dtype_of(g.params["0/w/0"]) == "s8"
    assert tr.param_path(g.params["1"]) == "1"

"""convert.params_from_numpy / params_to_numpy: float and QTensor trees
round-trip exactly; unknown leaf kinds and dtype/shape mismatches raise."""
import copy

import numpy as np
import pytest
import torch

from repro_torch.configs.efficientvit_b1 import REDUCED
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.qtensor import QAPoT, QM2Q, QUniform
from repro_torch.core.tree import leaves_with_path
from repro_torch.models import efficientvit
from repro_torch.recipe import quantize


def _qtree():
    params = efficientvit.init(REDUCED, seed=3, device="cpu")
    batches = [np.random.default_rng(1).normal(0, 1, (2, 32, 32, 3))
               .astype(np.float32)]
    return params, quantize(REDUCED, params, calib_batches=batches).params


def _assert_same(a, b):
    la, lb = dict(leaves_with_path(a)), dict(leaves_with_path(b))
    assert sorted(la) == sorted(lb)
    for path, x in la.items():
        y = lb[path]
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, path
            np.testing.assert_array_equal(x, y, err_msg=path)
        else:
            assert x == y, path


def test_float_tree_round_trips():
    params, _ = _qtree()
    np_tree = params_to_numpy(params)
    back = params_from_numpy(np_tree, "cpu")
    _assert_same(np_tree, params_to_numpy(back))
    assert isinstance(back["stages"], list)
    assert back["stem"]["w"].dtype == torch.float32


def test_qtensor_tree_round_trips():
    _, qparams = _qtree()
    np_tree = params_to_numpy(qparams)
    back = params_from_numpy(np_tree, "cpu")
    _assert_same(np_tree, params_to_numpy(back))
    kinds = {type(leaf) for _, leaf in leaves_with_path(back)}
    assert {QM2Q, QUniform} <= kinds
    m2q = back["head"]["w"]
    assert m2q.payload.dtype == torch.int8 and m2q.act_scale.ndim == 0


def _leaf(np_tree, path):
    node = np_tree
    for part in path.split("/"):
        node = node[int(part)] if isinstance(node, list) else node[part]
    return node


@pytest.fixture(scope="module")
def np_qtree():
    return params_to_numpy(_qtree()[1])


@pytest.mark.parametrize("path,field,bad", [
    ("head/w", "payload", lambda a: a.astype(np.uint8)),
    ("head/w", "payload", lambda a: a[:-1]),
    ("head/w", "u_scale", lambda a: a.astype(np.float64)),
    ("head/w", "a_scale", lambda a: a.reshape(-1)),
    ("head/w", "act_scale", lambda a: np.float64(a)),
    ("head/w", "n_apot", lambda a: a + 1),
    ("stages/0/0/mb/w_dw", "payload", lambda a: a.astype(np.int8)),
    ("stages/0/0/mb/w_dw", "payload", lambda a: np.concatenate([a, a], 1)),
    ("stages/0/0/mb/w_dw", "scale", lambda a: a[:, :-1]),
    ("stages/0/0/mb/w_dw", "axis", lambda a: 0),
])
def test_mismatched_qtensor_fields_raise(np_qtree, path, field, bad):
    tree = copy.deepcopy(np_qtree)
    leaf = _leaf(tree, path)
    leaf[field] = bad(leaf[field])
    with pytest.raises((TypeError, ValueError)):
        params_from_numpy(tree, "cpu")


@pytest.mark.parametrize("leaf", [
    {"qtensor": "QPoT"},
    {"qtensor": "QAPoT"},
    "not-a-tensor",
    np.zeros((2, 2), np.int32),
    3.0,
])
def test_unknown_leaf_kinds_raise(leaf):
    with pytest.raises(TypeError):
        params_from_numpy({"head": {"w": leaf}}, "cpu")


def test_params_to_numpy_rejects_foreign_leaves():
    with pytest.raises(TypeError):
        params_to_numpy({"w": object()})


def _qapot_tree(act: bool):
    w = torch.from_numpy(np.random.default_rng(2).normal(
        0, 0.1, (3, 3, 4, 6)).astype(np.float32))
    qt = QAPoT.quantize(w.reshape(-1, 6), act_max_abs=2.5 if act else None)
    return {"stem": {"w": QAPoT(qt.codes, qt.scale, qt.act_scale,
                                tuple(w.shape))}}


@pytest.mark.parametrize("act", [False, True])
def test_qapot_leaf_round_trips(act):
    np_tree = params_to_numpy(_qapot_tree(act))
    leaf = np_tree["stem"]["w"]
    assert leaf["qtensor"] == "QAPoT" and leaf["codes"].dtype == np.uint8
    assert leaf["codes"].shape == (36, 6) and leaf["scale"].shape == (1, 6)
    back = params_from_numpy(np_tree, "cpu")
    assert isinstance(back["stem"]["w"], QAPoT)
    assert back["stem"]["w"].shape == (3, 3, 4, 6)
    _assert_same(np_tree, params_to_numpy(back))


@pytest.mark.parametrize("field,bad", [
    ("codes", lambda a: a.astype(np.int8)),
    ("codes", lambda a: a[:-1]),
    ("scale", lambda a: a.astype(np.float64)),
    ("scale", lambda a: a.reshape(-1)),
    ("act_scale", lambda a: np.float64(a)),
    ("shape", lambda a: a[:1]),
])
def test_mismatched_qapot_fields_raise(field, bad):
    tree = params_to_numpy(_qapot_tree(True))
    leaf = tree["stem"]["w"]
    leaf[field] = bad(leaf[field])
    with pytest.raises((TypeError, ValueError)):
        params_from_numpy(tree, "cpu")


# ---------------------------------------------------------------------------
# the mixed LM tree: stacked QExpertM2Q layers, perm-folded 3-D QM2Q FFN
# members, a 2-D QM2Q head
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def np_lm_tree():
    from repro_torch.configs.registry import REDUCED as LM
    from repro_torch.models import dense_lm
    cfg = LM["qwen1.5-0.5b"]
    qm = quantize(cfg, dense_lm.init(cfg, seed=0, device="cpu"), "m2q-w8a8")
    return params_to_numpy(qm.params)


def test_mixed_lm_tree_round_trips(np_lm_tree):
    from repro_torch.core.qtensor import QExpertM2Q
    back = params_from_numpy(np_lm_tree, "cpu")
    _assert_same(np_lm_tree, params_to_numpy(back))
    wq, w1 = back["layers"]["attn"]["wq"], back["layers"]["mlp"]["w1"]
    assert isinstance(wq, QExpertM2Q) and wq.payload.ndim == 3
    assert wq.u_scale.shape == (2, 1, 64) and wq.act_scale.shape == (2, 1, 1)
    assert type(w1) is QM2Q and w1.payload.ndim == 3 and w1.act_scale is None
    assert np_lm_tree["layers"]["attn"]["wq"]["qtensor"] == "QExpertM2Q"


@pytest.mark.parametrize("path,field,bad", [
    ("layers/attn/wq", "payload", lambda a: a.reshape(-1, a.shape[-1])),
    ("layers/attn/wq", "payload", lambda a: a.view(np.uint8)),
    ("layers/attn/wq", "u_scale", lambda a: a[0]),
    ("layers/attn/wq", "a_scale", lambda a: a.astype(np.float64)),
    ("layers/attn/wq", "act_scale", lambda a: a.reshape(-1)),
    ("layers/attn/wq", "n_uniform", lambda a: a - 1),
    ("layers/attn/wq", "shape", lambda a: [2] + list(a)),
    ("layers/mlp/w1", "u_zp", lambda a: a[:, :, :-1]),
    ("layers/mlp/w1", "act_scale", lambda a: np.float32(1.0)),
])
def test_mismatched_mixed_lm_fields_raise(np_lm_tree, path, field, bad):
    """A field of the wrong shape or dtype raises, a 4-D ``shape`` over
    a 3-D payload included (an (L, E, K, N) expert leaf needs an (L, E,
    K, N) payload)."""
    tree = copy.deepcopy(np_lm_tree)
    leaf = _leaf(tree, path)
    leaf[field] = bad(leaf[field])
    with pytest.raises((TypeError, ValueError)):
        params_from_numpy(tree, "cpu")

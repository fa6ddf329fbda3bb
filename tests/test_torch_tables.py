"""The paper's accuracy tables in the port (``repro_torch.launch.tables``)
and the proxy's trainer (``data.proxy.train_proxy``) against the JAX
package: every row of Tables I-IV on the CPU against
``results/proxy_tables_jax.json`` (the reference's rows, written by
``tools/write_proxy_tables.py``), that file against one reference row
recomputed here, the checker the card's phase 17 runs
(``tables.reference_check``) on rows made to disagree, and three
training steps against the reference's step.

Measured here: all 20 rows' replaced leaves are byte-identical to the
reference's, no prediction differs and every top-1 is equal."""
import functools
import hashlib
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import apply as japply
from repro.core import policy as jpol
from repro.models import efficientvit as jev
from repro_torch.convert import params_from_numpy
from repro_torch.core.scheme_select import select_schemes
from repro_torch.core.tree import leaves_with_path
from repro_torch.data import proxy
from repro_torch.launch import tables
from torch_parity import jax_forward, jax_to_numpy

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (PROXY_MISMATCHES, the card's bound)

EXPECTED = json.loads(tables.EXPECTED.read_text())
ROW_NAMES = [r["name"] for r in EXPECTED["rows"]]


@functools.lru_cache(maxsize=None)
def _port_rows():
    params = proxy.load_proxy("cpu")
    return params, {r.name: r for r in tables.run(params)}


def test_reference_file_is_of_the_committed_proxy():
    assert EXPECTED["proxy_sha256"] == hashlib.sha256(
        proxy.CACHE.read_bytes()).hexdigest()
    assert EXPECTED["cfg"] == proxy.CFG.name
    assert EXPECTED["n_images"] == len(EXPECTED["labels"]) == 256
    _, labels = proxy.predict(proxy.load_proxy("cpu"), attn="f32")
    np.testing.assert_array_equal(labels, EXPECTED["labels"])


def test_port_has_the_references_rows_in_order():
    params, rows = _port_rows()
    assert list(rows) == ROW_NAMES
    assert ROW_NAMES[:5] == ["table1/float", "table1/uniform", "table1/pot",
                             "table1/apot", "table1/m2q"]


@pytest.mark.parametrize("name", ROW_NAMES)
def test_row_matches_the_reference(name):
    """Leaf digests equal (no PoT tie needed on the CPU), Eq. 6 splits
    equal, predictions within the card's bound, top-1 within it too."""
    params, rows = _port_rows()
    row = rows[name]
    reports, failures = tables.reference_check(
        [row], EXPECTED, params, chip_smoke.PROXY_MISMATCHES)
    assert failures == []
    rep, = reports
    assert rep["ties"] == 0 and rep["flipped"] == {}
    want = EXPECTED["rows"][ROW_NAMES.index(name)]
    assert abs(row.top1 - want["top1"]) <= \
        chip_smoke.PROXY_MISMATCHES / len(EXPECTED["labels"])
    assert rep["predictions_differing"] == 0  # measured
    assert sorted(row.assignments) == sorted(want["apot_idx"])


def test_table1_ranks_the_schemes_as_the_paper():
    """Table I's ordering: PoT << APoT < M2Q <= uniform (paper, Table I)."""
    _, rows = _port_rows()
    top = {n.split("/")[1]: rows[n].top1 for n in ROW_NAMES
           if n.startswith("table1/")}
    assert top["pot"] < top["apot"] < top["m2q"] <= top["uniform"]
    assert rows["table3/autovit"].top1 < rows["table3/ours"].top1


def test_reference_file_against_a_recomputed_jax_row():
    """table1/uniform recomputed by the JAX package (eager
    ``fake_quant_model`` on the dense weights, its dispatch-off forward):
    the same leaf digests, predictions and top-1 as the file holds."""
    from benchmarks.proxy_model import accuracy, train_proxy
    jp = train_proxy()
    fq = japply.fake_quant_model(jp, jev.QUANT_RULES, scheme="uniform",
                                 bits=8, kinds={jpol.KIND_DENSE})
    want = EXPECTED["rows"][ROW_NAMES.index("table1/uniform")]
    flat_in = dict(leaves_with_path(jax_to_numpy(jp)))
    flat = dict(leaves_with_path(jax_to_numpy(fq)))
    replaced = {k for k, v in flat.items()
                if not np.array_equal(v, flat_in[k])}
    assert replaced == set(want["leaves"])
    for path in replaced:
        assert tables.digest(flat[path]) == want["leaves"][path], path
    ds = proxy._data()
    images = np.concatenate([ds.batch(EXPECTED["seed0"] + b, proxy.BATCH)[0]
                             for b in range(8)])
    preds = jax_forward(proxy.CFG, fq, images).argmax(-1)
    np.testing.assert_array_equal(preds, want["predictions"])
    assert round(accuracy(fq), 4) == want["top1"]


# ---------------------------------------------------------------------------
# the checker on rows made to disagree
# ---------------------------------------------------------------------------


def _one_leaf_case(w, scheme, asn=None):
    """(row, expected, params) of one leaf ``head/w`` under ``scheme``."""
    from repro_torch.core.apply import fake_quant_model
    params = {"head": {"w": torch.from_numpy(w)}}
    got = {}
    out = fake_quant_model(params, [(r"head/w", "dense")], scheme=scheme,
                           assignments=got)
    leaf = out["head"]["w"]
    row = tables.Row("t/x", 1.0, 0.0, np.zeros(4, np.int64),
                     {"head/w": leaf}, {"head/w": scheme}, got)
    expected = {"rows": [{
        "name": "t/x", "top1": 1.0, "drop": 0.0, "predictions": [0] * 4,
        "leaves": {"head/w": tables.digest(leaf)},
        "apot_idx": {k: a.apot_idx.tolist() for k, a in got.items()}}]}
    return row, expected, params


def _w(shape, seed):
    return np.random.default_rng(seed).normal(0, 0.05, shape).astype(
        np.float32)


def test_checker_accepts_equal_rows_and_refuses_a_changed_leaf():
    row, expected, params = _one_leaf_case(_w((32, 16), 0), "apot")
    assert tables.reference_check([row], expected, params, 0)[1] == []
    expected["rows"][0]["leaves"]["head/w"] = "0" * 64
    _, failures = tables.reference_check([row], expected, params, 0)
    assert len(failures) == 1 and "digest differs" in failures[0]


def test_checker_refuses_predictions_past_the_bound():
    row, expected, params = _one_leaf_case(_w((32, 16), 1), "uniform")
    expected["rows"][0]["predictions"] = [0, 0, 1, 1]
    assert tables.reference_check([row], expected, params, 2)[1] == []
    assert "predictions differ" in tables.reference_check(
        [row], expected, params, 1)[1][0]


def test_checker_counts_a_pot_element_at_a_rounding_tie():
    """One element whose log2 sits on a half-integer: a reference that
    rounded it the other way is accepted, and the element counted."""
    w = _w((16, 8), 2)
    w[:, 0] = np.abs(w[:, 0])
    w[0, 0] = 0.0                       # column 0 spans [0, 1]: S = 1
    w[1, 0] = 1.0
    w[2, 0] = np.float32(2.0 ** -3.5)   # |w| / S = 2^-3.5
    row, expected, params = _one_leaf_case(w, "pot")
    idx, vals = tables.pot_ties(torch.from_numpy(w), 3)
    assert list(idx) == [2 * 8]         # the one tie, flat index
    other = row.leaves["head/w"].numpy().copy()
    assert other.reshape(-1)[idx[0]] != vals[0]
    other.reshape(-1)[idx] = vals
    expected["rows"][0]["leaves"]["head/w"] = tables.digest(other)
    reports, failures = tables.reference_check([row], expected, params, 0)
    assert failures == [] and reports[0]["ties"] == 1
    # a difference anywhere else is not a tie
    other.reshape(-1)[5] += 1.0
    expected["rows"][0]["leaves"]["head/w"] = tables.digest(other)
    assert tables.reference_check([row], expected, params, 0)[1]


@pytest.mark.parametrize("scheme", ["m2q", "pot_mix"])
def test_checker_reports_filters_flipped_within_noise(scheme):
    """Two equal filters tie exactly in Eq. 6: a reference that put the
    other one on the APoT side is reported, gap 0, and its leaf (the
    port's under the reference's split) accepted."""
    w = _w((24, 8), 3)
    asn = select_schemes(torch.from_numpy(w))
    order = np.argsort(asn.mse_apot - asn.mse_uniform, kind="stable")
    i, j = sorted(order[3:5])   # the last APoT filter, the first uniform
    w[:, j] = w[:, i]           # now they tie, one on each side
    row, expected, params = _one_leaf_case(w, scheme)
    asn = row.assignments["head/w"]
    apot = set(asn.apot_idx.tolist())
    assert (i in apot) != (j in apot)
    swapped = sorted(apot ^ {i, j})
    from repro_torch.core.apply import mixed_fake_quant
    forced = mixed_fake_quant(
        torch.from_numpy(w), type(asn)(
            apot_idx=np.array(swapped, np.int32),
            uniform_idx=np.setdiff1d(np.arange(8), swapped).astype(np.int32),
            mse_uniform=asn.mse_uniform, mse_apot=asn.mse_apot), scheme)
    expected["rows"][0]["apot_idx"]["head/w"] = swapped
    expected["rows"][0]["leaves"]["head/w"] = tables.digest(forced)
    reports, failures = tables.reference_check([row], expected, params, 0)
    assert failures == []
    flip = reports[0]["flipped"]["head/w"]
    assert flip["filters"] == [i, j] and flip["penalty_gap"] == 0.0
    assert reports[0]["flipped_equal"] == ["head/w"]


def test_checker_refuses_a_split_that_is_not_noise():
    w = _w((24, 8), 4)
    w[:, 3] *= 40.0   # a filter far from every other's penalty
    row, expected, params = _one_leaf_case(w, "m2q")
    asn = select_schemes(torch.from_numpy(w))
    apot = list(asn.apot_idx)
    uni = list(asn.uniform_idx)
    wrong = sorted(apot[1:] + [uni[-1]])
    expected["rows"][0]["apot_idx"]["head/w"] = wrong
    _, failures = tables.reference_check([row], expected, params, 0)
    assert any("flipped with penalty gap" in f for f in failures)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_on_the_cpu_writes_markdown_only_under_out(tmp_path, capsys,
                                                       monkeypatch):
    monkeypatch.chdir(tmp_path)
    tables.main(["--device", "cpu"])
    assert list(tmp_path.iterdir()) == []
    printed = [json.loads(line) for line in capsys.readouterr().out
               .splitlines() if line.startswith("{")]
    assert [r["name"] for r in printed] == ROW_NAMES
    tables.main(["--device", "cpu", "--out", str(tmp_path / "md")])
    names = sorted(p.name for p in (tmp_path / "md").iterdir())
    assert names == ["table1_schemes.md", "table2_bits.md",
                     "table3_accuracy.md", "table4_accuracy.md"]
    text = (tmp_path / "md" / "table1_schemes.md").read_text()
    assert "| pot | 0.9336 | 0.0664 |" in text


def test_cli_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit):
        tables.main(["--device", "cuda"])


# ---------------------------------------------------------------------------
# the proxy's trainer
# ---------------------------------------------------------------------------


def test_train_step_matches_the_references_step(tmp_path):
    """Three steps at batch 8 from the same (JAX-drawn) initial tree: the
    reference's step (jitted ``value_and_grad`` of the mean
    cross-entropy, its AdamW under ``cosine_schedule(2e-3, 10, 300)``)
    against the port's ``train_step`` with ``proxy.optimizer()``.  The
    losses agree to f32 rounding (measured 5.8e-7 relative; bound 1e-5).
    The parameters agree to f32 rounding except where a gradient is near
    zero: AdamW's first steps move every weight by about the learning
    rate times the sign of its gradient, so float noise in a tiny
    gradient can move a weight by twice that.  Measured: the update of
    the whole tree differs by 7.9e-4 of its norm; bound 1e-2.  The
    trained tree then saves in the committed layout and loads back."""
    from repro.optim.adamw import AdamW, cosine_schedule
    cfg = proxy.CFG
    init = jax.jit(lambda k: jev.init(cfg, k))(jax.random.PRNGKey(0))
    opt = AdamW(lr=cosine_schedule(2e-3, 10, 300))
    state = opt.init(init)

    @jax.jit
    def step(params, state, x, y):
        def loss_fn(p):
            lg = jev.forward(cfg, p, x).astype(jnp.float32)
            return jnp.mean(-jax.nn.log_softmax(lg)[jnp.arange(x.shape[0]),
                                                   y])
        loss, grads = jax.value_and_grad(loss_fn)(params)
        params, state, _ = opt.update(grads, state, params)
        return params, state, loss

    ds = proxy._data()
    params, losses = init, []
    got = params_from_numpy(jax_to_numpy(init), "cpu")
    topt = proxy.optimizer()
    tstate, got_losses = topt.init(got), []
    for s in range(3):
        x, y = ds.batch(s, 8)
        params, state, loss = step(params, state, jnp.asarray(x),
                                   jnp.asarray(y))
        losses.append(float(loss))
        got, tstate, tloss = proxy.train_step(topt, got, tstate, x, y)
        got_losses.append(float(tloss))
    np.testing.assert_allclose(got_losses, losses, rtol=1e-5)
    want = dict(leaves_with_path(jax_to_numpy(params)))
    start = dict(leaves_with_path(jax_to_numpy(init)))
    diff = sum(float(np.sum((v.numpy() - want[k]) ** 2))
               for k, v in leaves_with_path(got))
    moved = sum(float(np.sum((want[k] - start[k]) ** 2)) for k in want)
    assert 0 < moved and np.sqrt(diff / moved) < 1e-2
    path = proxy.save_proxy(got, tmp_path / "trained.npz")
    for (k, a), (_, b) in zip(leaves_with_path(got),
                              leaves_with_path(proxy.load_proxy(
                                  "cpu", path=path))):
        assert torch.equal(a, b), k


def test_the_committed_proxy_is_never_written():
    before = proxy.CACHE.read_bytes()
    params = proxy.load_proxy("cpu")
    with pytest.raises(ValueError):
        proxy.save_proxy(params, proxy.CACHE)
    with pytest.raises(ValueError):
        proxy.train_proxy(proxy.CACHE, device="cpu")
    assert proxy.CACHE.read_bytes() == before


def test_load_proxy_refuses_a_missing_file(tmp_path):
    with pytest.raises(FileNotFoundError):
        proxy.load_proxy("cpu", path=tmp_path / "none.npz")

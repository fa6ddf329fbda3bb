"""The port's qlint baseline ledger against the JAX package's
``repro.analysis.baseline`` (which imports no JAX): the same ledgers,
diff lines and bytes on disk."""
import json
from pathlib import Path

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from torch_qlint_cases import jax_leak_check  # noqa: F401

from repro.analysis import Violation as JViolation
from repro.analysis import baseline as jbl
from repro_torch.analysis import Violation, baseline

ROOT = Path(__file__).resolve().parents[1]


def _viol(trace, rule, path, n=1):
    return [Violation(rule=rule, severity="error", trace=trace, path=path,
                      message="m")] * n


_keys = st.tuples(st.sampled_from(["t/a", "t/b", "t/c"]),
                  st.sampled_from(["no-f32-dot", "conv-budget",
                                   "no-dequant-matmul"]),
                  st.sampled_from(["", "w", "0/embed/0", "1/k"]))


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(cur=st.lists(_keys, max_size=12), old=st.lists(_keys, max_size=12))
def test_baseline_agrees_with_jax_on_drawn_ledgers(cur, old, jax_leak_check):
    def port(keys):
        return [Violation(r, "error", t, p, "m") for t, r, p in keys]

    def jax(keys):
        return [JViolation(r, "error", t, p, "m") for t, r, p in keys]

    pc, po = baseline.to_ledger(port(cur)), baseline.to_ledger(port(old))
    jc, jo = jbl.to_ledger(jax(cur)), jbl.to_ledger(jax(old))
    assert (pc, po) == (jc, jo)
    assert baseline.diff(pc, po) == jbl.diff(jc, jo)
    assert baseline.improvements(pc, po) == jbl.improvements(jc, jo)


def test_baseline_diff_flags_new_and_grown_only():
    old = _viol("t/a", "no-f32-dot", "", 1) + _viol("t/a", "conv-budget",
                                                    "w", 2)
    cur = (_viol("t/a", "no-f32-dot", "", 1)          # unchanged
           + _viol("t/a", "conv-budget", "w", 3)      # grew 2 -> 3
           + _viol("t/b", "no-d2h-in-loop", "decode"))  # new
    regress = baseline.diff(baseline.to_ledger(cur), baseline.to_ledger(old))
    assert any("GREW" in r and "conv-budget" in r for r in regress)
    assert any("NEW" in r and "t/b" in r for r in regress)
    assert not any("no-f32-dot" in r for r in regress)
    # shrinking / disappearing entries are improvements, not regressions
    assert baseline.improvements(baseline.to_ledger(cur),
                                 baseline.to_ledger(old)) == []
    gone = baseline.improvements(baseline.to_ledger([]),
                                 baseline.to_ledger(old))
    assert len(gone) == 2 and all("GONE" in g for g in gone)


def test_baseline_save_load_roundtrip_and_version_gate(tmp_path):
    led = baseline.to_ledger(_viol("t/a", "no-f32-dot", "", 2))
    p = tmp_path / "base.json"
    baseline.save(p, led)
    assert baseline.load(p) == led
    blob = json.loads(p.read_text())
    blob["version"] = 999
    p.write_text(json.dumps(blob))
    with pytest.raises(ValueError, match="version"):
        baseline.load(p)


def test_committed_baselines_load_and_save_canonically(tmp_path,
                                                       jax_leak_check):
    """The JAX package's ledger reads the same through both modules and
    re-saves to its own bytes from each; the port's ledger is canonical
    too (sorted keys, stable formatting), so diffs stay reviewable."""
    jax_file = ROOT / "results/qlint_baseline.json"
    led = baseline.load(jax_file)
    assert led == jbl.load(jax_file)
    baseline.save(tmp_path / "port.json", led)
    jbl.save(tmp_path / "jax.json", led)
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "jax.json").read_bytes() == jax_file.read_bytes()
    ours = ROOT / "results/qlint_baseline_torch.json"
    led = baseline.load(ours)
    assert led, "the port's baseline is empty: regenerate it with " \
                "--update-baseline"
    baseline.save(tmp_path / "ours.json", led)
    assert (tmp_path / "ours.json").read_bytes() == ours.read_bytes()

"""The port's qlint CLI (``python -m repro_torch.launch.qlint``): exit
codes, ``--fail-on-gone``, ``--list-rules``, the card it defaults to, and
a seeded violation failing a real sweep."""
from pathlib import Path

import pytest
import torch

import torch_qlint_cases  # noqa: F401 -- one intra-op thread

from repro_torch.analysis import Violation
from repro_torch.kernels import ops
from repro_torch.launch import qlint as Q

BASELINE = str(Path(__file__).resolve().parents[1]
               / "results/qlint_baseline_torch.json")


def _viol(trace, rule, path):
    return [Violation(rule=rule, severity="error", trace=trace, path=path,
                      message="m")]


def test_qlint_cli_fail_on_gone(tmp_path, monkeypatch, capsys):
    """``--fail-on-gone`` turns stale ledger rows into a failure, while a
    ledger the run still reproduces stays green with the flag on.
    Traces and rules are monkeypatched: this is the CLI contract."""
    class FakeTrace:
        name = "t/a"

    monkeypatch.setattr(Q, "build_traces",
                        lambda configs, sharded=True, **kw: [FakeTrace()])
    p = tmp_path / "base.json"
    monkeypatch.setattr(Q, "run_rules",
                        lambda tr: (_viol("t/a", "no-f32-dot", ""), []))
    base = ["--baseline", str(p), "--device", "cpu"]
    assert Q.main(base + ["--update-baseline"]) == 0
    assert Q.main(base) == 0
    assert Q.main(base + ["--fail-on-gone"]) == 0
    # the violation disappears: advisory by default, FAIL under the flag
    monkeypatch.setattr(Q, "run_rules", lambda tr: ([], []))
    assert Q.main(base) == 0
    assert Q.main(base + ["--fail-on-gone"]) == 1
    assert "re-tighten" in capsys.readouterr().err
    # a NEW violation still beats the gone-check (exit 1 either way)
    monkeypatch.setattr(Q, "run_rules",
                        lambda tr: (_viol("t/a", "conv-budget", "w"), []))
    assert Q.main(base + ["--fail-on-gone"]) == 1
    assert "NEW  t/a :: conv-budget :: w" in capsys.readouterr().out


def test_qlint_cli_list_rules_and_usage_errors(tmp_path, capsys):
    assert Q.main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for name in ("no-f32-dot", "no-gather-concat", "conv-budget",
                 "no-dequant-matmul", "no-d2h-in-loop",
                 "unguarded-act-quant", "sharding-conformance"):
        assert name in out
    assert "default suppressions: (^|/)embed" in out
    with pytest.raises(SystemExit) as e:
        Q.main(["--configs", " , ", "--device", "cpu"])
    assert e.value.code == 2
    missing = tmp_path / "none.json"
    assert Q.main(["--baseline", str(missing), "--configs",
                   "qwen1.5-0.5b", "--no-sharded", "--device", "cpu"]) == 2
    assert "not found" in capsys.readouterr().err


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
def test_qlint_cli_refuses_the_card_without_one():
    with pytest.raises(RuntimeError, match="--device cpu"):
        Q.main(["--configs", "qwen1.5-0.5b", "--no-sharded"])


def test_qlint_cli_seeded_violation_exits_1(monkeypatch, capsys):
    """A quantized layer quietly sent to ``x @ dequant(W)`` fails the
    sweep against the committed baseline; the real sweep passes."""
    argv = ["--baseline", BASELINE, "--configs",
            "qwen1.5-0.5b", "--no-sharded", "--device", "cpu"]
    assert Q.main(argv) == 0
    monkeypatch.setattr(ops, "qtensor_matmul",
                        lambda x, qt: x @ qt.dequant(x.dtype))
    assert Q.main(argv) == 1
    out = capsys.readouterr().out
    assert "NEW  qwen1.5-0.5b/u8/decode :: no-dequant-matmul" in out

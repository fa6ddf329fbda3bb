"""The port's qlint sweep on the CPU against the committed ledger
(``results/qlint_baseline_torch.json``, what ``chip_smoke.py``'s phase
18 holds the card to): the reduced EfficientViT-B1 and qwen1.5-0.5b
with every dispatch axis on, the sharded decode on two gloo ranks, and
phase 18's gate rehearsed."""
import sys
from pathlib import Path

import pytest

from torch_qlint_cases import cpu_traces

from repro_torch.analysis import baseline as bl
from repro_torch.analysis.traces import sharded_decode_trace

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (phase 18's gate)

BASE = bl.load(ROOT / "results/qlint_baseline_torch.json")
KERNELS = {
    "efficientvit-b1-r224/m2q/forward": {
        "m2q_matmul": 16, "dwconv_w4": 7, "relu_attn": 6,
        "relu_attn_scales": 6},
    "efficientvit-b1-r224/u8/forward": {
        "int8_matmul": 16, "relu_attn": 6, "relu_attn_scales": 6},
    "qwen1.5-0.5b/m2q/decode": {"m2q_matmul": 11, "decode_attn_int8": 2},
    "qwen1.5-0.5b/u8/decode": {"int8_matmul": 1, "decode_attn_int8": 2},
}


def _entries(prefix):
    return {t: v for t, v in BASE.items()
            if t.startswith(prefix) and not t.endswith("-sharded")}


@pytest.mark.parametrize("arch", ["efficientvit-b1-r224", "qwen1.5-0.5b"])
def test_cpu_ledger_equals_the_committed_baseline(arch):
    traces = cpu_traces(arch)
    # on the CPU every kernel node runs its plain version
    ledger, problems, rows = chip_smoke.qlint_problems(
        traces, _entries(arch + "/"), ran="plain")
    assert problems == []
    assert ledger == _entries(arch + "/")
    for name, want in KERNELS.items():
        if name in rows:
            assert rows[name]["kernel_nodes"] == want, name


def test_phase_18_gate_names_plain_nodes_and_ledger_drift():
    traces = cpu_traces("qwen1.5-0.5b", recipes=("uniform8",))
    base = _entries("qwen1.5-0.5b/u8/")
    _, problems, _ = chip_smoke.qlint_problems(traces, base)
    # on the card a plain version in a kernel node fails the phase
    assert "qwen1.5-0.5b/u8/decode: 2 node(s) decode_attn_int8 ran plain" \
        in problems
    assert not any(p.startswith(("NEW", "GREW", "GONE")) for p in problems)
    drop = {t: {r: dict(p) for r, p in v.items()} for t, v in base.items()}
    del drop["qwen1.5-0.5b/u8/decode"]["no-gather-concat"]["1/k"]
    drop["qwen1.5-0.5b/u8/prefill"]["no-f32-dot"] = {"": 1}
    _, problems, _ = chip_smoke.qlint_problems(traces, drop, ran="plain")
    assert problems == [
        "NEW  qwen1.5-0.5b/u8/decode :: no-gather-concat :: 1/k (x1)",
        "GONE qwen1.5-0.5b/u8/prefill :: no-f32-dot :: <module> (1 -> 0)"]


def test_sharded_decode_trace_conforms_on_two_gloo_ranks():
    tr = sharded_decode_trace("qwen1.5-0.5b", device="cpu", timeout=240)
    assert tr.name == "qwen1.5-0.5b/m2q/decode-sharded"
    assert tr.meta["mesh"] == {"data": 1, "model": 2}
    recs = tr.meta["sharding"]
    paths = {r["path"] for r in recs}
    assert {"0/lm_head/0", "0/layers/attn/wq/0", "1/k", "1/lengths"} <= paths
    assert sum("'model'" in r["actual"] for r in recs) >= 20
    assert all(r["expected"] == r["actual"] for r in recs)
    ledger, problems, rows = chip_smoke.qlint_problems(
        [tr], {tr.name: BASE[tr.name]}, ran="plain")
    assert problems == []
    # each rank launched nothing on the CPU; the kernel nodes say so
    assert tr.meta["rank_launches"] == [{}, {}]
    assert rows[tr.name]["kernel_nodes"] == {"m2q_matmul": 11,
                                             "decode_attn_int8": 2}

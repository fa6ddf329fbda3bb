"""The port's qlint rule engine on handcrafted op graphs: the vacuity
guard, sharding conformance, suppressions and strict rule names (the
port's twins of ``tests/test_qlint.py``'s text-only cases)."""
import pytest

from torch_qlint_cases import GraphBuilder

from repro_torch.analysis import RULES_BY_NAME, Trace, lint, run_rules
from repro_torch.analysis.opgraph import Graph


def test_no_f32_dot_vacuity_guard_fires_without_dots():
    b = GraphBuilder()
    b.op("add", b.param("x"))
    tr = b.trace("seeded/no-dots", expect_no_f32_dot=True)
    vs = lint(tr, "no-f32-dot")
    assert len(vs) == 1 and "vacuous" in vs[0].message
    # expect_dots=False waives the vacuity sub-check
    tr.meta["expect_dots"] = False
    assert lint(tr, "no-f32-dot") == []
    # a kernel node is a (quantized) contraction: not vacuous, no f32
    b = GraphBuilder()
    b.op("int8_matmul", b.param("x"), b.param("w/0", "s8"), kind="kernel",
         ran="plain")
    assert lint(b.trace(expect_no_f32_dot=True), "no-f32-dot") == []
    # an f32 mm fires with its FLOPs: 2 * 4 * 2 * 8
    b = GraphBuilder()
    b.op("mm", b.param("x", shape=(4, 8)), b.param("w", shape=(8, 2)),
         shape=(4, 2))
    (v,) = lint(b.trace(expect_no_f32_dot=True), "no-f32-dot")
    assert v.message.startswith("128 f32 dot FLOPs")


def test_sharding_conformance_fires_on_spec_drift():
    recs = [{"path": "0/embed/0", "expected": "(None, 'model')",
             "actual": "(None, 'model')"},
            {"path": "0/layers/wq/0", "expected": "(None, 'model')",
             "actual": "()"}]
    tr = Trace(name="seeded/shard", graph=Graph([], {}),
               meta={"sharding": recs})
    vs = lint(tr, "sharding-conformance")
    assert [v.path for v in vs] == ["0/layers/wq/0"]
    assert "dist.sharding" in vs[0].message
    # the rule only applies when sharding metadata was recorded
    assert not RULES_BY_NAME["sharding-conformance"].applies({})


def test_suppressions_are_reported_not_dropped():
    b = GraphBuilder()
    e = b.param("0/embed/0", "s8", (16, 4))
    ids = b.param("ids", "s64", (2,))
    g = b.op("embedding", e, ids, dtype="s8", shape=(2, 4))
    b.op("_to_copy", g, shape=(2, 4))
    tr = b.trace("seeded/embed-gather", quantized=True)
    # the default (^|/)embed suppression swallows the embedding gather --
    # run_rules returns it on the suppressed channel, lint drops it
    vs, supp = run_rules(tr, rules=[RULES_BY_NAME["no-gather-concat"]])
    assert vs == [] and [v.path for v in supp] == ["0/embed/0"]
    assert lint(tr, "no-gather-concat") == []
    # a custom suppression channels any rule the same way
    b = GraphBuilder()
    w = b.param("w/0", "s8", (16, 4))
    b.op("index_select", w, b.param("ids", "s64", (2,)), dtype="s8")
    tr = b.trace("seeded/gather")
    vs2, supp2 = run_rules(tr, rules=[RULES_BY_NAME["no-gather-concat"]])
    assert [v.path for v in vs2] == ["w/0"] and supp2 == []
    vs3, supp3 = run_rules(tr, rules=[RULES_BY_NAME["no-gather-concat"]],
                           suppressions={"no-gather-concat": [r"^w/"]})
    assert vs3 == [] and len(supp3) == 1


def test_lint_rejects_unknown_rule_names():
    tr = Trace(name="x", graph=Graph([], {}))
    with pytest.raises(KeyError):
        lint(tr, "no-such-rule")
    assert [r for r in RULES_BY_NAME] == [
        "no-f32-dot", "no-gather-concat", "conv-budget",
        "no-dequant-matmul", "no-d2h-in-loop", "unguarded-act-quant",
        "sharding-conformance"]

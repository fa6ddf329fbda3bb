"""The port's qlint op graph: the recorder (in-place writes, kernel
nodes) and the dequantize and host-read rules on seeded graphs (the
port's twins of ``tests/test_qlint.py``'s handcrafted-HLO cases)."""
import torch

from torch_qlint_cases import GraphBuilder, rule_paths, tiny_qtensor

from repro_torch.analysis import lint, opgraph
from repro_torch.analysis.traces import trace_fn
from repro_torch.kernels import m2q_matmul as m2q
from repro_torch.kernels import ops


def test_no_d2h_in_loop_fires_on_a_host_read_in_the_decode_step():
    b = GraphBuilder()
    x = b.param("1/tokens", "s32", (2, 1))
    s = b.op("sum", x, dtype="s64", shape=(), loop="decode")
    b.op("_local_scalar_dense", s, dtype="s64", shape=(), loop="decode")
    vs = lint(b.trace("seeded/item"), "no-d2h-in-loop")
    assert [v.rule for v in vs] == ["no-d2h-in-loop"]
    assert "_local_scalar_dense" in vs[0].message and vs[0].path == "decode"
    # a copy to the host from the card is one too; on-device ops are not
    b = GraphBuilder()
    x = b.param("1/tokens", "s32", (2, 1))
    y = b.op("add", x, dtype="s32", loop="decode", device="cuda")
    b.op("_to_copy", y, dtype="s32", loop="decode", device="cpu")
    assert [v.path for v in lint(b.trace(), "no-d2h-in-loop")] == ["decode"]
    b = GraphBuilder()
    x = b.param("1/tokens", "s32", (2, 1))
    b.op("add", x, dtype="s32", loop="decode")
    assert lint(b.trace(), "no-d2h-in-loop") == []
    # recorded: .item() inside the loop body fires, outside it does not
    t = torch.arange(4)
    tr = trace_fn(lambda v: v.sum().item(), (t,), name="seeded/rec",
                  dispatch=None, loop="decode")
    assert rule_paths(lint(tr, "no-d2h-in-loop")) == {
        ("no-d2h-in-loop", "decode")}
    tr = trace_fn(lambda v: v.sum().item(), (t,), name="seeded/rec",
                  dispatch=None)
    assert lint(tr, "no-d2h-in-loop") == []


def test_recorder_versions_in_place_writes_through_views():
    def write(cache, rows):
        cache[:, :2] = rows     # a view of the cache, written in place
        return cache.sum()

    cache = torch.zeros(3, 4)
    rows = torch.ones(3, 2)
    with torch.inference_mode(), opgraph.record((cache, rows)) as rec:
        write(cache, rows)
    g = rec.graph()
    assert g.params == {"0": 0, "1": 1}
    total = [n for n in g.nodes if n.op == "sum"][0]
    # the sum reads the cache's NEW version, which the write produced
    # from the rows
    (read,) = total.inputs
    writer = g.producer(read)
    assert writer is not None and writer.op == "copy_"
    assert g.params["1"] in writer.inputs
    assert total.idx in g.consumers[read]
    # the version the write replaced is not what the sum read
    assert read != g.params["0"]


def test_kernel_node_folds_its_plain_version_and_names_its_route(
        monkeypatch):
    rng = torch.Generator().manual_seed(0)
    x = torch.randn(4, 32, generator=rng)
    args = (x, torch.tensor(0.05), torch.randint(
        -128, 128, (32, 16), generator=rng, dtype=torch.int8),
        torch.rand(16, generator=rng), torch.rand(16, generator=rng),
        torch.rand(16, generator=rng))
    with torch.inference_mode(), opgraph.record(args) as rec:
        y = ops.m2q_matmul_op(*args)
    g = rec.graph()
    (node,) = g.nodes
    assert (node.op, node.kind, node.ran) == ("m2q_matmul", "kernel",
                                              "plain")
    assert node.folded > 0       # the plain version's aten ops
    assert set(node.inputs) == set(range(6))
    assert g.values[node.outputs[0]].shape == tuple(y.shape)

    def stub(*a, **kw):          # a "launch": what a CUDA tensor takes
        m2q.launches += 1
        return torch.zeros(4, 16)

    monkeypatch.setattr(m2q, "m2q_matmul", stub)
    monkeypatch.setattr(m2q, "launches", m2q.launches)
    with torch.inference_mode(), opgraph.record(args) as rec:
        ops.m2q_matmul_op(*args)
    (node,) = rec.graph().nodes
    assert (node.ran, node.folded) == ("kernel", 1)  # its output's zeros
    # without a recorder, nothing is recorded and the result is the same
    assert opgraph.active() is None
    torch.testing.assert_close(ops.m2q_matmul_op(*args), torch.zeros(4, 16))


def test_no_dequant_matmul_fires_on_a_seeded_dequant_contraction():
    # handcrafted: int8 payload -> float conversion -> mm
    b = GraphBuilder()
    w = b.param("w/payload", "s8", (8, 2))
    x = b.param("x", "f32", (4, 8))
    cv = b.op("_to_copy", w, shape=(8, 2))
    b.op("mm", x, cv, shape=(4, 2))
    vs = lint(b.trace(quantized=True), "no-dequant-matmul")
    assert [v.rule for v in vs] == ["no-dequant-matmul"]
    assert "w/payload" in vs[0].message and vs[0].path == "w/payload"
    # re-quantized before the contraction: clean
    b = GraphBuilder()
    w = b.param("w/payload", "s8", (8, 2))
    cv = b.op("mul", w, shape=(8, 2))           # torch's int8 * f32
    q = b.op("_to_copy", cv, dtype="s8", shape=(8, 2))
    b.op("mm", b.param("x", "s8", (4, 8)), q, dtype="s32", shape=(4, 2))
    assert lint(b.trace(), "no-dequant-matmul") == []
    # recorded: the payload decoded to f32 and contracted at f32
    qt = tiny_qtensor()
    x = torch.zeros(4, 32)
    tr = trace_fn(lambda q, v: v @ q.dequant(), (qt, x),
                  name="seeded/dequant-matmul", dispatch=False,
                  meta={"quantized": True})
    assert rule_paths(lint(tr, "no-dequant-matmul")) == {
        ("no-dequant-matmul", "0/0")}
    # the calibrated integer path is clean: int8 x int8 in an exact
    # integer contraction (int_einsum), rescaled to f32 after it
    qt_cal = tiny_qtensor(act=True)
    tr_ok = trace_fn(lambda q, v: q.matmul(v), (qt_cal, x),
                     name="seeded/int-matmul", dispatch=False,
                     meta={"quantized": True})
    assert "int_einsum" in tr_ok.graph.op_histogram()
    assert lint(tr_ok, "no-dequant-matmul") == []

"""The engines' CUDA-graph mode (``serving/graphs.py``) on the CPU, where
no graph can be captured: ``graphs=True`` on a CPU device runs eagerly
and never touches ``torch.cuda``; and, with a stub graph standing in for
``torch.cuda.CUDAGraph`` (its capture runs the host code once and changes
nothing, its replay re-runs the step with the kernel counters put back,
as a replay runs no host code), the graph-served engines give the eager
engines' logits, tokens and ``kernels.counts()``, capture once per key,
and use no graph inside ``ops.reference_path()``."""
import functools

import numpy as np
import pytest
import torch

from repro_torch import kernels, recipe
from repro_torch.configs.efficientvit_b1 import REDUCED as B1
from repro_torch.configs.registry import REDUCED
from repro_torch.kernels import ops
from repro_torch.models import dense_lm, efficientvit
from repro_torch.serving import graphs

LM = REDUCED["qwen1.5-0.5b"]


@functools.lru_cache(maxsize=None)
def _lm(kv_cache_dtype):
    cfg = LM.replace(kv_cache_dtype=kv_cache_dtype)
    return recipe.quantize(cfg, dense_lm.init(cfg, seed=0, device="cpu"),
                           "w4-weights-only")


@functools.lru_cache(maxsize=None)
def _vision():
    params = efficientvit.init(B1, seed=0, device="cpu")
    batches = [np.random.default_rng(9).normal(0, 1, (2, 32, 32, 3))
               .astype(np.float32)]
    return recipe.quantize(B1, params, calib_batches=batches)


def _images(n, seed):
    return np.random.default_rng(seed).normal(
        0, 1, (n, 32, 32, 3)).astype(np.float32)


def _requests(seed=3):
    """Five greedy and two sampled requests, more than four slots hold."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, LM.vocab_size, int(rng.integers(2, 14)),
                          dtype=np.int32), int(rng.integers(2, 9)),
             0.8 if i >= 5 else 0.0) for i in range(7)]


def _serve_tokens(eng, reqs):
    kernels.reset_counts()
    hs = [eng.submit(p, max_new_tokens=n, temperature=t) for p, n, t in reqs]
    eng.run()
    return [h.handle.result() for h in hs], kernels.counts()


class StubGraph:
    def __init__(self, fn, out):
        self.fn, self.out, self.replays = fn, out, 0

    def pool(self):
        return "pool"

    def replay(self):
        self.replays += 1
        before = kernels.counts()
        out = self.fn()
        if out is not None:
            self.out.copy_(out)
        kernels.set_counts(before)


class Stub:
    """Patches ``graphs._warm_up`` / ``graphs._record``.  ``protect``:
    what the test's steps write (tensors and generators); the stub
    capture puts it back after its one host pass."""

    def __init__(self, monkeypatch):
        self.protect, self.warm, self.recorded, self.pools = [], 0, [], []
        monkeypatch.setattr(graphs, "_warm_up", self._warm_up)
        monkeypatch.setattr(graphs, "_record", self._record)

    def _warm_up(self, fn):
        self.warm += 1
        for _ in range(graphs.WARMUP):
            fn()

    def _record(self, fn, pool, generators):
        self.pools.append(pool)
        saved = [t.clone() if isinstance(t, torch.Tensor) else t.get_state()
                 for t in self.protect]
        out = fn()
        for t, s in zip(self.protect, saved):
            t.copy_(s) if isinstance(t, torch.Tensor) else t.set_state(s)
        g = StubGraph(fn, out)
        self.recorded.append((g, tuple(generators)))
        return g, out


def _stubbed_engine(stub, eng):
    eng.step_graphs = graphs.StepGraphs()
    if hasattr(eng, "cache"):
        stub.protect += [*eng.cache.values(), eng._pending, eng._outbuf,
                         eng._counts, eng._nonfinite, eng._gen]
    return eng


def test_for_device_and_in_use():
    assert graphs.for_device(torch.device("cpu"), True) is None
    assert graphs.for_device(torch.device("cuda"), False) is None
    sg = graphs.for_device(torch.device("cuda"), True)
    assert isinstance(sg, graphs.StepGraphs) and len(sg) == 0
    assert graphs.in_use(sg) and not graphs.in_use(None)
    with ops.reference_path():
        assert not graphs.in_use(sg)
    assert graphs.in_use(sg)


def test_capture_restores_counts_state_and_generator(monkeypatch):
    """The warm-up and capture passes leave the counters, the written
    state and the generator as they were; each replay adds one capture
    pass's counts and takes the draws the eager call would."""
    stub = Stub(monkeypatch)
    qt = _lm("int8").params["lm_head"]  # 4-bit: int4_matmul's leaf
    x = torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, (5, LM.d_model)).astype(np.float32))

    def step(acc, gen):
        acc.add_(ops.qtensor_matmul(x, qt))
        acc.add_(torch.rand(acc.shape, generator=gen))

    want = torch.zeros(5, LM.padded_vocab)
    want_gen = torch.Generator().manual_seed(1)
    kernels.reset_counts()
    for _ in range(3):
        step(want, want_gen)
    eager = kernels.counts()
    acc = torch.zeros_like(want)
    gen = torch.Generator().manual_seed(1)
    stub.protect += [acc, gen]
    kernels.reset_counts()
    sg = graphs.StepGraphs()
    for _ in range(3):
        sg.run("step", lambda: step(acc, gen), state=(acc,),
               generators=(gen,))
    assert kernels.counts() == eager
    assert eager["int4_matmul"]["plain_calls"] == 3
    torch.testing.assert_close(acc, want, rtol=0, atol=0)
    assert torch.equal(gen.get_state(), want_gen.get_state())
    assert len(sg) == 1 and stub.warm == 1 and len(stub.recorded) == 1
    assert stub.recorded[0][0].replays == 3
    assert stub.recorded[0][1] == (gen,) and sg.capture_s > 0


def test_failed_capture_raises_and_restores_the_counters(monkeypatch):
    Stub(monkeypatch)

    def boom(fn, pool, generators):
        fn()
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    monkeypatch.setattr(graphs, "_record", boom)
    x = torch.ones(2, LM.d_model)
    qt = _lm("int8").params["lm_head"]
    kernels.reset_counts()
    sg = graphs.StepGraphs()
    with pytest.raises(RuntimeError, match="capturing"):
        sg.run("k", lambda: ops.qtensor_matmul(x, qt))
    assert all(c == {"launches": 0, "plain_calls": 0}
               for c in kernels.counts().values())
    assert len(sg) == 0


@pytest.mark.parametrize("raises", [False, True])
def test_no_garbage_collection_inside_a_capture(monkeypatch, raises):
    """``_record`` runs the captured step with the garbage collector off (a
    collection could free an earlier engine's graph, whose CUDA call would
    invalidate the capture) and turns it back on after, also when the
    step raises; a collector the caller had turned off stays off."""
    import contextlib
    import gc

    class FakeGraph:
        def register_generator_state(self, g):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda graph, pool=None: contextlib.nullcontext())
    seen = []

    def step():
        seen.append(gc.isenabled())
        if raises:
            raise RuntimeError("step failed")
        return "out"

    assert gc.isenabled()
    with (pytest.raises(RuntimeError) if raises
          else contextlib.nullcontext()):
        graph, out = graphs._record(step, None, ())
        assert isinstance(graph, FakeGraph) and out == "out"
    assert seen == [False] and gc.isenabled()
    gc.disable()
    try:
        graphs._record(lambda: None, None, ()) if not raises else None
        assert not gc.isenabled()
    finally:
        gc.enable()


def _refuse_cuda(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("torch.cuda touched on a CPU engine")

    for name in ("CUDAGraph", "graph", "Stream", "stream", "current_stream",
                 "graph_pool_handle", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, refuse)


@pytest.mark.parametrize("kv", ["int8", "bf16"])
def test_token_engine_graphs_on_cpu_run_eagerly(monkeypatch, kv):
    reqs = _requests()
    want, want_counts = _serve_tokens(_lm(kv).serve(max_batch=4, max_len=32,
                                                    graphs=False), reqs)
    _refuse_cuda(monkeypatch)
    eng = _lm(kv).serve(max_batch=4, max_len=32)  # graphs=True by default
    assert eng.step_graphs is None
    assert _serve_tokens(eng, reqs) == (want, want_counts)


def test_vision_engine_graphs_on_cpu_run_eagerly(monkeypatch):
    qm, imgs = _vision(), _images(6, seed=1)
    want = qm.serve(max_batch=4, graphs=False).classify(imgs)
    _refuse_cuda(monkeypatch)
    eng = qm.serve(max_batch=4)
    assert eng.step_graphs is None
    np.testing.assert_array_equal(eng.classify(imgs), want)


@pytest.mark.parametrize("kv", ["int8", "bf16"])
def test_token_engine_with_stub_graphs_equals_eager(monkeypatch, kv):
    """Greedy and sampled requests over more requests than slots: the
    graph-served engine's tokens and counts equal the eager engine's;
    one graph per draw branch, the draw graph given the engine's
    generator, every decode step a replay, prefill eager."""
    reqs = _requests()
    eager = _lm(kv).serve(max_batch=4, max_len=32, graphs=False)
    want, want_counts = _serve_tokens(eager, reqs)
    stub = Stub(monkeypatch)
    eng = _stubbed_engine(stub, _lm(kv).serve(max_batch=4, max_len=32))
    got, counts = _serve_tokens(eng, reqs)
    assert got == want and counts == want_counts
    assert counts["int4_matmul"]["plain_calls"] == (
        eng.stats.steps + eng.stats.prefill_batches)
    assert len(eng.step_graphs) == 2 and stub.warm == 2
    (g0, gens0), (g1, gens1) = stub.recorded
    assert {gens0, gens1} == {(), (eng._gen,)}
    assert g0.replays + g1.replays == eng.stats.steps == eager.stats.steps
    assert stub.pools == [None, "pool"]  # the second capture shares a pool
    for name in ("lengths", "k", "v"):
        assert torch.equal(eng.cache[name], eager.cache[name]), name
    # a second run replays the same two graphs and still repeats
    again, _ = _serve_tokens(eng, reqs)
    assert len(stub.recorded) == 2
    assert again == _serve_tokens(eager, reqs)[0]


def test_token_engine_uses_no_graph_under_the_reference_path(monkeypatch):
    reqs = _requests(seed=4)
    want = _serve_tokens(_lm("int8").serve(max_batch=4, max_len=32,
                                           graphs=False), reqs)
    stub = Stub(monkeypatch)
    eng = _stubbed_engine(stub, _lm("int8").serve(max_batch=4, max_len=32))
    with ops.reference_path():
        got = _serve_tokens(eng, reqs)
    assert got == want and stub.recorded == [] and len(eng.step_graphs) == 0


def test_vision_engine_with_stub_graphs_equals_eager(monkeypatch):
    """One graph per bucket (1, 2, 4, 8 at max_batch 8), captured at the
    bucket's first use over its static input, replayed for every later
    batch of that bucket: logits and counts equal the eager engine's;
    none is used inside reference_path()."""
    qm = _vision()
    sizes = [1, 2, 3, 8, 5, 1]
    batches = [_images(n, seed=10 + i) for i, n in enumerate(sizes)]
    eager = qm.serve(max_batch=8, attn="int8", graphs=False)
    kernels.reset_counts()
    want = [eager.classify(b) for b in batches]
    want_counts = kernels.counts()
    stub = Stub(monkeypatch)
    eng = _stubbed_engine(stub, qm.serve(max_batch=8, attn="int8"))
    kernels.reset_counts()
    got = [eng.classify(b) for b in batches]
    assert kernels.counts() == want_counts
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert sorted(eng._inputs) == [(1, "int8"), (2, "int8"), (4, "int8"),
                                   (8, "int8")]
    assert len(stub.recorded) == len(eng.step_graphs) == 4
    assert [g.replays for g, _ in stub.recorded] == [2, 1, 1, 2]
    with ops.reference_path():
        np.testing.assert_array_equal(eng.classify(batches[0]), want[0])
    assert len(stub.recorded) == 4

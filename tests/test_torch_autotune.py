"""The port's launch-plan autotuner (``repro_torch.kernels.autotune``) and
offline sweep (``repro_torch.launch.autotune_sweep``) on the CPU, against
the JAX package's cache contract (``repro.kernels.autotune``): salted
keys, foreign backends, the corrupt-file fixtures of JAX's
``test_autotune_cache_tolerates_corruption``, cache-first lookups with
zero probes, forced tuning with a fake bench, and the sweep's warm ->
``--smoke`` gate over the CI set at REDUCED width.  Timing needs the card
(``autotune.measure`` replays a CUDA graph), so every tuned case here
passes a fake bench."""
import contextlib
import json
import os
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kernels import autotune as jautotune
from repro_torch.configs.efficientvit_b1 import REDUCED as TCFG
from repro_torch.kernels import autotune, int4_matmul, m2q_matmul, ops
from repro_torch.launch import autotune_sweep as sw
from repro_torch.models import efficientvit as tev
from repro_torch.recipe import quantize

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (phase 15's case)

CPU = torch.device("cpu")
DIMS = (8, 1024, 151936, torch.bfloat16)
PLAN = {"bm": 32, "bn": 64, "splits": 2}


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
def _cache(tmp_path, monkeypatch):
    """Every test on its own cache file (the env var is the port's; JAX's
    ``REPRO_AUTOTUNE_CACHE`` is left alone)."""
    path = str(tmp_path / "cache.json")
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", path)
    autotune.reset_probe_count()
    return path


def test_keys_are_salted_with_version_and_backend(monkeypatch):
    key = autotune.cache_key("m2q_matmul", DIMS, "cuda_sm90")
    assert key == "m2q_matmul@v1:8x1024x151936xbfloat16:cuda_sm90"
    assert autotune._KEY_RE.match(key)
    assert autotune.backend_of(CPU) == "cpu"
    assert autotune.cache_key("m2q_matmul", DIMS, "cpu") != key
    monkeypatch.setitem(autotune.KERNEL_VERSIONS, "m2q_matmul", 2)
    assert autotune.cache_key("m2q_matmul", DIMS, "cuda_sm90") == \
        "m2q_matmul@v2:8x1024x151936xbfloat16:cuda_sm90"
    # the JAX package's own keys never parse as the port's
    jkey = jautotune.cache_key("m2q_matmul", 8, 151936, 1024, backend="cpu")
    assert not autotune._KEY_RE.match(jkey)


def test_default_path_is_per_backend_and_the_port_env_var_wins(
        monkeypatch, tmp_path):
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_CACHE")
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "jax.json"))
    path = autotune.default_cache_path("cuda_sm90")
    assert path.endswith("/.cache/repro_torch/autotune.cuda_sm90.json")
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "t.json"))
    assert autotune.default_cache_path("cpu") == str(tmp_path / "t.json")


def test_cache_first_on_every_device_with_zero_probes(_cache):
    """A committed entry serves its plan verbatim on the CPU, where
    nothing is ever tuned; the lookup is recorded; no probe runs."""
    key = autotune.cache_key("m2q_matmul", DIMS, "cpu")
    autotune.AutotuneCache(_cache).put(key, PLAN)
    autotune.shared_cache(_cache).load()
    with autotune.record_requests() as reqs:
        got = autotune.plan_for("m2q_matmul", DIMS, CPU,
                                fallback=lambda: {"bm": 1},
                                bench=lambda p: pytest.fail("timed"))
    assert got == PLAN
    assert reqs == [autotune.ShapeRequest(
        "m2q_matmul", (8, 1024, 151936, "bfloat16"))]
    assert autotune.tuning_probe_count() == 0


def test_a_miss_returns_launch_plan_where_nothing_may_tune(_cache):
    """On the CPU, and in a no_tuning scope, a miss is launch_plan's plan;
    nothing is timed or persisted."""
    want = {k: m2q_matmul.launch_plan(8, 1024, 151936)[k]
            for k in m2q_matmul.PLAN_KEYS}
    for scope in (contextlib.nullcontext, autotune.no_tuning):
        with scope():
            got = autotune.plan_for(
                "m2q_matmul", DIMS, CPU, fallback=lambda: want,
                candidates=lambda: m2q_matmul.candidate_plans(8, 1024,
                                                              151936),
                bench=lambda p: pytest.fail("timed"))
        assert got == want
    assert not autotune.can_tune(CPU)
    with autotune.no_tuning():
        assert not autotune.can_tune(torch.device("cuda"))
    assert len(autotune.AutotuneCache(_cache).load()) == 0
    assert autotune.tuning_probe_count() == 0


def test_dwconv_tile_plan_reads_the_cache_then_launch_plan(_cache):
    """The plan ``dwconv_w4`` launches at an engine step: a cached entry,
    else ``launch_plan``'s; never a probe."""
    from repro_torch.kernels import dwconv_w4
    dims = (8, 56, 56, 64, 3, 1)
    want = {k: dwconv_w4.launch_plan(*dims)[k] for k in dwconv_w4.PLAN_KEYS}
    assert ops.dwconv_tile_plan(*dims, device=CPU) == want
    tuned = {"cv": 4, "sw": 4, "th": 4, "r": 2}
    autotune.shared_cache(_cache).put(autotune.cache_key(
        "dwconv_w4", dims + (torch.bfloat16,), "cpu"), tuned)
    assert ops.dwconv_tile_plan(*dims, device=CPU) == tuned
    assert ops.dwconv_tile_plan(*dims, dtype=torch.float32,
                                device=CPU) == want
    assert autotune.tuning_probe_count() == 0


def test_a_version_bump_orphans_entries(_cache, monkeypatch):
    autotune.shared_cache(_cache).put(
        autotune.cache_key("m2q_matmul", DIMS, "cpu"), PLAN)
    fallback = {"bm": 64, "bn": 64, "splits": 1}
    assert autotune.plan_for("m2q_matmul", DIMS, CPU,
                             fallback=lambda: fallback) == PLAN
    monkeypatch.setitem(autotune.KERNEL_VERSIONS, "m2q_matmul", 2)
    assert autotune.plan_for("m2q_matmul", DIMS, CPU,
                             fallback=lambda: fallback) == fallback


def test_foreign_backend_entries_never_serve(_cache):
    """JAX's test of the same name: a cache committed for another backend
    misses here, though its entries are valid and survive a load."""
    foreign = autotune.cache_key("m2q_matmul", DIMS, "cuda_sm90")
    autotune.AutotuneCache(_cache).put(foreign, PLAN)
    autotune.shared_cache(_cache).load()
    fallback = {"bm": 64, "bn": 64, "splits": 1}
    assert autotune.plan_for("m2q_matmul", DIMS, CPU,
                             fallback=lambda: fallback) == fallback
    assert autotune.AutotuneCache(_cache).load().get(foreign) == PLAN


CORRUPT = [
    "{truncated",                                   # invalid JSON
    json.dumps([1, 2, 3]),                          # non-dict top level
    json.dumps({"k": "not-a-plan"}),                # foreign key, bad entry
    json.dumps({autotune.cache_key("m2q_matmul", DIMS, "cpu"):
                {"bm": 8, "bn": "x", "splits": 1}}),  # non-int member
    json.dumps({autotune.cache_key("m2q_matmul", DIMS, "cpu"):
                {"bm": 48, "bn": 64, "splits": 1}}),  # a tile it lacks
    json.dumps({autotune.cache_key("relu_attn", (2, 49, 16, 16, "float32"),
                                   "cpu"): {"splits": True}}),  # a bool
    json.dumps({jautotune.cache_key("kern", 8, 8, 8, backend="cpu"):
                {"bm": 8}}),                        # the JAX key format
]


@pytest.mark.parametrize("text", CORRUPT)
def test_a_corrupt_cache_warns_and_rebuilds(text, _cache):
    """JAX's corrupt-file fixtures, and the port's own kinds of invalid
    plan: each is dropped with a RuntimeWarning, the cache rebuilds, and
    ``save`` merges through the corrupt file into clean JSON."""
    with open(_cache, "w") as f:
        f.write(text)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        cache = autotune.AutotuneCache(_cache).load()
    assert len(cache) == 0
    assert any(issubclass(x.category, RuntimeWarning) for x in w)
    key = autotune.cache_key("m2q_matmul", DIMS, "cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cache.put(key, PLAN)
    assert autotune.AutotuneCache(_cache).load().get(key) == PLAN
    assert json.load(open(_cache)) == {key: PLAN}


def test_valid_entries_survive_beside_corrupt_ones(_cache):
    good = autotune.cache_key("dwconv_w4", (8, 56, 56, 64, 3, 1, "bfloat16"),
                              "cpu")
    with open(_cache, "w") as f:
        json.dump({good: {"cv": 8, "sw": 2, "th": 8, "r": 4},
                   "bad": [1, 2]}, f)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        cache = autotune.AutotuneCache(_cache).load()
    assert cache.get(good) == {"cv": 8, "sw": 2, "th": 8, "r": 4}
    assert cache.get("bad") is None
    assert any("corrupt entries" in str(x.message) for x in w)


def test_writes_are_atomic_merged_round_trips(_cache):
    """Two cache objects on one file each write their own key: the file
    holds both (merge-on-write under the lock), no temporary file stays,
    and a fresh load reads the plans back exactly."""
    a, b = autotune.AutotuneCache(_cache), autotune.AutotuneCache(_cache)
    ka = autotune.cache_key("int8_matmul", (8, 64, 64, "float32"), "cpu")
    kb = autotune.cache_key("relu_attn", (8, 196, 8, 16, "bfloat16"), "cpu")
    a.put(ka, {"bm": 32, "bn": 64, "splits": 1})
    b.put(kb, {"splits": 4})
    fresh = autotune.AutotuneCache(_cache).load()
    assert fresh.keys() == sorted([ka, kb])
    assert fresh.get(ka) == {"bm": 32, "bn": 64, "splits": 1}
    assert fresh.get(kb) == {"splits": 4}
    assert sorted(os.listdir(os.path.dirname(_cache))) == [
        "cache.json", "cache.json.lock"]


def test_force_tune_picks_the_fastest_and_counts_its_probes(_cache):
    """JAX's ``test_probe_counter_counts_live_tuning`` with a fake bench:
    every candidate timed once, the fastest persisted, and the warmed
    second lookup probes no more and returns the same plan."""
    cands = int4_matmul.candidate_plans(8, 1024, 151936)
    fake = {json.dumps(p, sort_keys=True): 1.0 + i
            for i, p in enumerate(cands)}
    fastest = cands[5]
    fake[json.dumps(fastest, sort_keys=True)] = 0.5
    dims = (8, 1024, 151936, "bfloat16")

    def bench(p):
        return fake[json.dumps(p, sort_keys=True)]

    first = autotune.plan_for("int4_matmul", dims, CPU, fallback=lambda:
                              cands[0], candidates=lambda: cands,
                              bench=bench, force_tune=True)
    assert first == fastest
    assert autotune.tuning_probe_count() == len(cands)
    second = autotune.plan_for("int4_matmul", dims, CPU,
                               fallback=lambda: cands[0], bench=bench)
    assert second == first
    assert autotune.tuning_probe_count() == len(cands)
    assert autotune.AutotuneCache(_cache).load().get(
        autotune.cache_key("int4_matmul", dims, "cpu")) == fastest


def test_a_raising_candidate_raises(_cache):
    """Unlike JAX, a candidate that fails is not scored as infinitely
    slow: the error reaches the caller and nothing is persisted."""
    cands = [{"splits": 1}, {"splits": 2}]

    def bench(p):
        if p["splits"] == 2:
            raise RuntimeError("CUDA kernel relu_attn failed to launch")
        return 1.0

    with pytest.raises(RuntimeError, match="failed to launch"):
        autotune.plan_for("relu_attn", (8, 49, 16, 16, "bfloat16"), CPU,
                          fallback=lambda: cands[0],
                          candidates=lambda: cands, bench=bench,
                          force_tune=True)
    assert len(autotune.AutotuneCache(_cache).load()) == 0


def test_every_candidate_is_a_plan_the_cache_keeps():
    """The plans each wrapper builds for a shape (what the tuner times)
    are valid cache entries, ``launch_plan``'s first and no duplicates."""
    shapes = {
        "m2q_matmul": [(8, 1024, 151936), (25088, 16, 64), (8, 2816, 1024)],
        "int8_matmul": [(100352, 27, 16), (392, 256, 1024)],
        "int4_matmul": [(8, 1024, 151936), (1568, 128, 512)],
        "relu_attn": [(8, 196, 8, 16), (1, 49, 16, 16)],
        "dwconv_w4": [(8, 112, 112, 64, 3, 1), (1, 7, 7, 1536, 5, 1)],
    }
    from repro_torch.kernels import dwconv_w4, int8_matmul, relu_attn
    mods = {"m2q_matmul": m2q_matmul, "int8_matmul": int8_matmul,
            "int4_matmul": int4_matmul, "relu_attn": relu_attn,
            "dwconv_w4": dwconv_w4}
    for kernel, dims in shapes.items():
        for d in dims:
            cands = mods[kernel].candidate_plans(*d)
            plan = mods[kernel].launch_plan(*d)
            assert cands[0] == {k: plan[k] for k in cands[0]}
            assert len({json.dumps(c, sort_keys=True) for c in cands}) \
                == len(cands) > 1
            assert all(autotune.valid_plan(kernel, c) for c in cands)
    assert int4_matmul.candidate_plans(8, 1024, 151936, bf16=False) == [
        {"bm": 64, "bn": 64, "splits": 1}]


def test_sweep_warms_then_smokes_and_fails_on_a_missing_key(_cache):
    """The CI gate end to end on the CPU at REDUCED width: the warm
    commits launch_plan's plan for every tunable shape the walk finds,
    ``--smoke`` exits 0 with zero probes; a deleted entry makes it exit
    1; a bad flag exits 2."""
    reqs = sw.discover(sw.CI_CONFIGS, sw.CI_RECIPES, "cpu", reduced=True,
                       progress=lambda *a: None)
    kernels = {r.kernel for r in reqs}
    assert kernels == {"m2q_matmul", "int8_matmul", "dwconv_w4",
                       "relu_attn", "decode_attn_int8"}
    assert [r for r in reqs if not r.tunable] and \
        all(r.kernel == "decode_attn_int8" for r in reqs if not r.tunable)
    wrote, skipped = sw.warm(reqs, _cache, "cpu", progress=lambda *a: None)
    assert wrote == sum(r.tunable for r in reqs) and skipped == 0
    cache = autotune.AutotuneCache(_cache).load()
    for r in reqs:
        if r.tunable:
            assert cache.get(r.key("cpu")) == sw._plans(r)[0]
    assert sw.warm(reqs, _cache, "cpu", progress=lambda *a: None) == \
        (0, wrote)
    argv = ["--smoke", "--device", "cpu", "--reduced", "--cache", _cache]
    assert sw.main(argv) == 0
    assert autotune.tuning_probe_count() == 0
    with open(_cache) as f:
        data = json.load(f)
    data.pop(next(r.key("cpu") for r in reqs
                  if r.kernel == "dwconv_w4"))
    with open(_cache, "w") as f:
        json.dump(data, f)
    assert sw.main(argv) == 1
    with pytest.raises(SystemExit) as e:
        sw.main(["--smoke", "--bogus"])
    assert e.value.code == 2


def test_the_engine_steps_resolve_plans_without_tuning(_cache):
    """A served batch runs inside the engine's dispatch scope and
    ``no_tuning``: the forward's requests are recorded, its axes follow
    ``dispatch=``, and nothing is probed."""
    qm = quantize(TCFG, tev.init(TCFG, seed=0, device="cpu"), "m2q-w8a8")
    img = np.zeros((TCFG.img_res, TCFG.img_res, 3), np.float32)
    for cfg, kernels in ((None, {"m2q_matmul", "dwconv_w4"}),
                         (ops.DispatchConfig(conv=False), {"m2q_matmul"}),
                         (ops.DispatchConfig(dense=True),
                          {"m2q_matmul", "dwconv_w4", "relu_attn"})):
        eng = qm.serve(max_batch=2, dispatch=cfg)
        with autotune.record_requests() as reqs:
            eng.classify(np.stack([img, img]))
        assert {r.kernel for r in reqs} == kernels
    assert autotune.tuning_probe_count() == 0


def test_chip_smoke_phase_15_at_reduced_width(_cache, monkeypatch):
    """``chip_smoke.autotune_case`` (phase 15) on the CPU at REDUCED
    width: the walk, the warm (launch_plan's plans here), the --smoke
    child process, the served engines (plain versions) against an empty
    cache, the dispatch-off forward and the tripped conv axis."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the --smoke child's
    res, problems, launches, rows = chip_smoke.autotune_case(
        torch, device="cpu", reduced=True)
    assert problems == []
    assert rows == [] and not any(launches.values())  # nothing timed here
    assert res["smoke"]["rc"] == 0
    assert res["tunable_shapes"] == res["shapes"] - 1  # decode: noted only
    assert res["matmuls_bit_equal"] == 16
    assert res["health_tripped"] == {"axes": {"dense": 0, "conv": 1,
                                              "attn": 0}}
    assert res["off counts"] == {"m2q_matmul": 16}
    assert ops.trip_counts() == {"dense": 0, "conv": 0, "attn": 0}

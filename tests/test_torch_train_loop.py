"""The port's training loop, CLI and elastic launcher on the CPU
(``repro_torch.train.loop``, ``launch.train``, ``launch.elastic``):

* the port's versions of ``tests/test_substrate.py``'s
  ``test_training_loss_decreases`` and ``test_training_resume_exact``
  (here the resumed parameters equal the straight run's bit for bit);
* a ``(params, AdamWState)`` checkpoint written by the JAX package's
  ``train`` that the port restores and trains on, and the reverse: the
  keys (``1/.count``, ``1/.m/...``), shapes, dtypes and SHA256s of both
  packages' manifests equal, the restored numbers equal, the first
  resumed step's loss within 1e-5 relative of the other package's;
* SIGTERM: a final save and a clean exit;
* ``run_supervised`` on the CPU with ``crash_at_step`` and
  ``stop_at_step``, as ``tests/test_elastic.py`` holds the JAX launcher
  (every subprocess wait bounded);
* the train CLI in-process and the example.
"""
import json
import shutil
import signal
import subprocess
import sys
import threading
from collections import defaultdict
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.configs.registry import REDUCED as JREDUCED
from repro.models import get_model as jget_model
from repro.optim.adamw import AdamW as JAdamW
from repro.train.loop import TrainConfig as JTrainConfig
from repro.train.loop import train as jtrain
from repro_torch.ckpt import checkpoint as tckpt
from repro_torch.configs.registry import REDUCED
from repro_torch.core.tree import leaves_with_path
from repro_torch.launch import elastic
from repro_torch.models import dense_lm
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.train import loop
from repro_torch.train.loop import TrainConfig, train

_REPO = Path(__file__).resolve().parent.parent
_ARCH, _STEPS, _EVERY = "qwen1.5-0.5b", 12, 3
WAIT_S = 240.0  # every subprocess wait of this file


def test_training_loss_decreases(tmp_path):
    cfg = REDUCED["qwen1.5-0.5b"].replace(vocab_size=64)
    tc = TrainConfig(steps=60, global_batch=8, seq_len=32, lr=1e-3, warmup=10,
                     ckpt_dir=None, metrics_path=str(tmp_path / "m.jsonl"))
    _, _, info = train(cfg, tc, device="cpu")
    first = np.mean(info["losses"][:10])
    last = np.mean(info["losses"][-10:])
    assert last < first - 0.1, (first, last)
    recs = [json.loads(x) for x in (tmp_path / "m.jsonl").read_text()
            .splitlines()]
    # every log_every-th step, and any other step only as a straggler
    assert [r["step"] for r in recs if r["step"] % 10 == 0] \
        == list(range(0, 60, 10))
    assert all(r["straggler"] for r in recs if r["step"] % 10)
    assert set(recs[0]) == {"step", "loss", "grad_norm", "step_time_s",
                            "straggler"}


def test_training_resume_exact(tmp_path):
    cfg = REDUCED["qwen1.5-0.5b"].replace(vocab_size=64)
    kw = dict(global_batch=4, seq_len=16, lr=1e-3, ckpt_every=100)
    p_full, s_full, full = train(cfg, TrainConfig(
        steps=20, ckpt_dir=str(tmp_path / "a"), **kw), device="cpu")
    train(cfg, TrainConfig(steps=10, ckpt_dir=str(tmp_path / "b"), **kw),
          device="cpu")
    p_res, s_res, info = train(cfg, TrainConfig(
        steps=20, ckpt_dir=str(tmp_path / "b"), **kw), device="cpu")
    # resumed training consumed the same data (step-indexed): the same
    # losses and the same parameters and state, bit for bit
    assert info["losses"] == full["losses"][10:]
    for (k, a), (_, b) in zip(leaves_with_path((p_full, s_full)),
                              leaves_with_path((p_res, s_res))):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
    assert isinstance(s_res, AdamWState) and int(s_res.count) == 20


# ---------------------------------------------------------------------------
# (params, AdamWState) checkpoints across the two packages
# ---------------------------------------------------------------------------

_CROSS = dict(global_batch=4, seq_len=16, lr=1e-3, warmup=2, ckpt_every=100)


def _manifest(d, step):
    return json.loads((Path(d) / f"step_{step:08d}" / "manifest.json")
                      .read_text())


def _first_loss(info):
    return info["losses"][0]


def _jax_leaves(tree) -> dict:
    """JAX's (key, numpy leaf) pairs, keyed as its checkpoint keys them."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): np.asarray(leaf) for path, leaf in flat}


def _same_numbers(jtree, ttree):
    a = _jax_leaves(jtree)
    b = {k: v.numpy() for k, v in leaves_with_path(ttree)}
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _templates():
    cfg = JREDUCED[_ARCH]
    jp = jget_model(cfg).init(cfg, jax.random.PRNGKey(1))
    tp = dense_lm.init(REDUCED[_ARCH], seed=1, device="cpu")
    return (jp, JAdamW().init(jp)), (tp, AdamW().init(tp))


def test_a_jax_checkpoint_restores_and_trains_in_the_port(tmp_path):
    a, b = tmp_path / "jax", tmp_path / "port"
    jtrain(JREDUCED[_ARCH], JTrainConfig(steps=3, ckpt_dir=str(a), **_CROSS))
    shutil.copytree(a, b)
    jtpl, ttpl = _templates()
    (jstate, _) = jckpt.restore(str(a), 2, jtpl)
    tstate, extra = tckpt.restore(b, 2, ttpl, device="cpu")
    assert extra == {"step": 2} and isinstance(tstate[1], AdamWState)
    _same_numbers(jstate, tstate)
    keys = [r["key"] for r in _manifest(a, 2)["leaves"]]
    assert keys == [k for k, _ in tckpt._leaf_paths(tstate)]
    assert {"1/.count", "1/.m/embed", "1/.v/lm_head"} <= set(keys)
    # both go on from step 2 to the end of a 5-step schedule
    _, _, jinfo = jtrain(JREDUCED[_ARCH], JTrainConfig(
        steps=5, ckpt_dir=str(a), **_CROSS))
    _, tst, tinfo = train(REDUCED[_ARCH], TrainConfig(
        steps=5, ckpt_dir=str(b), **_CROSS), device="cpu")
    assert len(tinfo["losses"]) == len(jinfo["losses"]) == 2
    assert abs(_first_loss(tinfo) - _first_loss(jinfo)) \
        <= 1e-5 * abs(_first_loss(jinfo))
    assert np.isfinite(tinfo["losses"]).all() and int(tst.count) == 5


def test_a_port_checkpoint_restores_and_trains_in_jax(tmp_path):
    a, b, c = tmp_path / "port", tmp_path / "jax", tmp_path / "jax_again"
    train(REDUCED[_ARCH], TrainConfig(steps=3, ckpt_dir=str(a), **_CROSS),
          device="cpu")
    shutil.copytree(a, b)
    jtpl, ttpl = _templates()
    jstate, extra = jckpt.restore(str(b), 2, jtpl)
    assert extra == {"step": 2} and int(jstate[1].count) == 3
    tstate, _ = tckpt.restore(a, 2, ttpl, device="cpu")
    _same_numbers(jstate, tstate)
    # the same numbers saved by JAX: the same manifest, leaf for leaf
    jckpt.save(str(c), 2, jstate, {"step": 2})
    assert _manifest(a, 2)["leaves"] == _manifest(c, 2)["leaves"]
    _, _, tinfo = train(REDUCED[_ARCH], TrainConfig(
        steps=5, ckpt_dir=str(a), **_CROSS), device="cpu")
    _, jst, jinfo = jtrain(JREDUCED[_ARCH], JTrainConfig(
        steps=5, ckpt_dir=str(b), **_CROSS))
    assert len(jinfo["losses"]) == 2 and int(jst.count) == 5
    assert abs(_first_loss(jinfo) - _first_loss(tinfo)) \
        <= 1e-5 * abs(_first_loss(tinfo))


# ---------------------------------------------------------------------------
# preemption
# ---------------------------------------------------------------------------


def test_sigterm_saves_and_exits_cleanly(tmp_path, monkeypatch, capsys):
    assert threading.current_thread() is threading.main_thread()
    before = signal.getsignal(signal.SIGTERM)
    real = loop.SyntheticLM.batch

    def batch(self, step, *a, **k):
        if step == 2:  # the preemption notice arrives during step 2
            signal.raise_signal(signal.SIGTERM)
        return real(self, step, *a, **k)

    monkeypatch.setattr(loop.SyntheticLM, "batch", batch)
    cfg = REDUCED["qwen1.5-0.5b"].replace(vocab_size=64)
    _, st, info = train(cfg, TrainConfig(
        steps=10, global_batch=2, seq_len=8, ckpt_dir=str(tmp_path),
        ckpt_every=100), device="cpu")
    assert info["preempted"] and info["last_step"] == 2
    assert len(info["losses"]) == 3 and int(st.count) == 3
    assert tckpt.latest_step(tmp_path) == 2
    assert "[train] preempted at step 2; saving" in capsys.readouterr().out
    assert signal.getsignal(signal.SIGTERM) is before


# ---------------------------------------------------------------------------
# the elastic launcher, on the CPU
# ---------------------------------------------------------------------------


class _BoundedPopen(subprocess.Popen):
    """A Popen whose every wait ends within WAIT_S: an expired wait kills
    the child, so a hung worker fails its test instead of hanging it."""

    def wait(self, timeout=None):
        try:
            return super().wait(WAIT_S if timeout is None else timeout)
        except subprocess.TimeoutExpired:
            self.kill()
            super().wait(30)
            raise


@pytest.fixture
def _subprocess_env(monkeypatch):
    monkeypatch.setenv("PYTHONPATH", str(_REPO / "src"))
    monkeypatch.chdir(_REPO)
    monkeypatch.setattr(elastic.subprocess, "Popen", _BoundedPopen)


def _losses_by_step(metrics):
    by_step = defaultdict(list)
    for line in Path(metrics).read_text().splitlines():
        rec = json.loads(line)
        by_step[rec["step"]].append(rec["loss"])
    return by_step


def test_crash_restart_resumes_exactly(tmp_path, _subprocess_env):
    ckpt_dir = str(tmp_path / "ckpt")
    metrics = str(tmp_path / "metrics.jsonl")
    restarts = elastic.run_supervised(
        _ARCH, _STEPS, ckpt_dir, metrics, batch=2, seq=16,
        ckpt_every=_EVERY, log_every=1, crash_at_step=7, max_restarts=2,
        device="cpu")
    assert restarts == 1
    assert tckpt.latest_step(ckpt_dir) == _STEPS - 1
    by_step = _losses_by_step(metrics)
    assert sorted(by_step) == list(range(_STEPS))
    # crash at 7, latest async checkpoint 6: step 7 ran in both processes
    assert len(by_step[7]) == 2 and len(by_step[8]) == 1
    for step, losses in by_step.items():
        assert len(set(losses)) == 1, (step, losses)


def test_clean_but_incomplete_exit_counts_as_restart(tmp_path, capfd,
                                                     _subprocess_env):
    ckpt_dir = str(tmp_path / "ckpt")
    metrics = str(tmp_path / "metrics.jsonl")
    restarts = elastic.run_supervised(
        _ARCH, _STEPS, ckpt_dir, metrics, batch=2, seq=16,
        ckpt_every=_EVERY, log_every=1, stop_at_step=4, max_restarts=2,
        device="cpu")
    out = capfd.readouterr().out
    assert restarts == 1
    assert tckpt.latest_step(ckpt_dir) == _STEPS - 1
    assert "[train] clean early exit at step 4" in out
    assert "exited cleanly (rc=0)" in out and "counted restart #1" in out
    assert "[train] resumed from step 4" in out
    by_step = _losses_by_step(metrics)
    assert sorted(by_step) == list(range(_STEPS))
    assert len(by_step[4]) == 1 and len(by_step[5]) == 1


# ---------------------------------------------------------------------------
# the CLI and the example, in-process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("extra", [[], ["--microbatches", "2",
                                        "--grad-compression"]])
def test_train_cli(tmp_path, monkeypatch, capsys, extra):
    from repro_torch.launch import train as cli
    metrics = tmp_path / "m.jsonl"
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", _ARCH, "--reduced", "--device", "cpu",
        "--steps", "4", "--warmup", "1", "--batch", "4", "--seq", "16",
        "--log-every", "1", "--metrics", str(metrics),
        "--ckpt-dir", str(tmp_path / "ckpt"), *extra])
    cli.main()
    out = capsys.readouterr().out
    assert "[train] arch=qwen1.5-0.5b-reduced steps=4 first_loss=" in out
    assert "peak_alloc_bytes" not in out
    assert len(metrics.read_text().splitlines()) == 4
    assert tckpt.latest_step(tmp_path / "ckpt") == 3


def test_example_trains(tmp_path, monkeypatch, capsys):
    sys.path.insert(0, str(_REPO / "examples"))
    try:
        import train_small_lm_torch as example
    finally:
        sys.path.remove(str(_REPO / "examples"))
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    example.main(["--steps", "40", "--batch", "4", "--seq", "32",
                  "--device", "cpu"])
    assert "steps=40 loss" in capsys.readouterr().out


def test_restore_reads_many_leaves_at_once(tmp_path):
    """A checkpoint of many large leaves restored by the thread pool (each
    worker its own zip reader): every leaf back bit for bit, and a
    flipped byte still named."""
    rng = np.random.default_rng(0)
    tree = {f"w{i:02d}": torch.from_numpy(rng.normal(
        size=(256, 257)).astype(np.float32)) for i in range(48)}
    state = AdamWState(torch.tensor(3, dtype=torch.int32), dict(tree),
                       {k: v * 2 for k, v in tree.items()})
    tckpt.save(tmp_path, 1, (tree, state), {"step": 1})
    for _ in range(3):
        (got, st), _ = tckpt.restore(tmp_path, 1, (tree, state), device="cpu")
        for (k, a), (_, b) in zip(leaves_with_path((tree, state)),
                                  leaves_with_path((got, st))):
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
    npz = tmp_path / "step_00000001" / "arrays.npz"
    data = dict(np.load(npz))
    data["leaf_00030"] = data["leaf_00030"] + 1
    np.savez(npz, **data)
    with pytest.raises(tckpt.ChecksumMismatchError, match="0/w30"):
        tckpt.restore(tmp_path, 1, (tree, state), device="cpu")


def test_chip_smoke_training_gates(tmp_path):
    """chip_smoke phase 14's gates on a metrics file: a falling, finite,
    once-logged run passes; a flat loss, a NaN, a twice-logged step and a
    straggler each fail by name."""
    sys.path.insert(0, str(_REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(_REPO))

    def problems(recs):
        path = tmp_path / "m.jsonl"
        path.write_text("".join(json.dumps(r) + "\n" for r in recs))
        return chip_smoke.training_problems(
            chip_smoke.metrics_by_step(path), 20)

    good = [{"step": s, "loss": 5.0 - 0.1 * s, "grad_norm": 1.0,
             "step_time_s": 0.1, "straggler": False} for s in range(20)]
    assert problems(good) == []
    flat = [dict(r, loss=5.0) for r in good]
    assert "not below" in problems(flat)[0]
    assert "non-finite" in problems(
        [dict(r, grad_norm=float("nan")) if r["step"] == 3 else r
         for r in good])[0]
    assert "more than once" in problems(good + [good[5]])[0]
    assert "straggler" in problems(
        [dict(r, straggler=r["step"] == 15) for r in good])[0]

"""The port's VisionEngine and scheduler on the REDUCED EfficientViT-B1
(CPU): served logits equal the port's forward on the same batch
composition, deadline/full/drain flushing, per-row numerics containment,
admission control -- and no fallback path."""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs.efficientvit_b1 import REDUCED
from repro_torch.models import efficientvit
from repro_torch.recipe import quantize
from repro_torch.serving.batching import pow2_bucket
from repro_torch.serving.errors import (NumericalError, QueueFullError,
                                        RequestTimedOut)
from repro_torch.serving.scheduler import (CANCELLED, DONE, FAILED,
                                           TIMED_OUT, FlushPolicy,
                                           OverloadPolicy, Scheduler)


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture(scope="module")
def qm():
    params = efficientvit.init(REDUCED, seed=0, device="cpu")
    batches = [np.random.default_rng(9).normal(0, 1, (2, 32, 32, 3))
               .astype(np.float32)]
    return quantize(REDUCED, params, calib_batches=batches)


def _images(n, seed=1):
    return np.random.default_rng(seed).normal(
        0, 1, (n, 32, 32, 3)).astype(np.float32)


@pytest.mark.parametrize("attn", ["int8", "f32"])
def test_engine_delivers_forward_of_the_same_batches(qm, attn):
    """12 submits at max_batch 8: a full batch of 8 runs at the 8th submit,
    the deadline flushes the other 4 (bucket 4).  The int8 attention scales
    are batch-wide, so equality holds batch by batch -- exactly, since the
    same CPU ops run on the same inputs."""
    clock = Clock()
    eng = qm.serve(max_batch=8, max_delay_ms=5.0, attn=attn, clock=clock)
    imgs = _images(12)
    handles = [eng.submit(im) for im in imgs]
    assert [h.state for h in handles] == [DONE] * 8 + ["PENDING"] * 4
    assert eng.poll() == 0
    clock.t += 0.01
    assert eng.poll() == 4
    got = np.stack([h.result() for h in handles])
    want = np.concatenate([qm.forward(imgs[:8], attn=attn).numpy(),
                           qm.forward(imgs[8:], attn=attn).numpy()])
    np.testing.assert_array_equal(got, want)
    s = eng.stats.summary()
    assert s["flush_reasons"] == {"full": 1, "deadline": 1}
    assert s["buckets_used"] == [4, 8] and s["completed"] == 12


def test_flush_pads_to_pow2_and_zero_rows_stay_out(qm):
    """5 images pad to a bucket of 8; zero rows stay zero through the
    network, so the 5 real rows equal a forward of the padded batch."""
    eng = qm.serve(max_batch=8, attn="int8")
    imgs = _images(5, seed=2)
    handles = [eng.submit(im) for im in imgs]
    out = eng.flush()
    assert out.shape == (5, REDUCED.n_classes)
    padded = np.concatenate([imgs, np.zeros((3, 32, 32, 3), np.float32)])
    want = qm.forward(padded, attn="int8").numpy()
    np.testing.assert_array_equal(out, want[:5])
    assert np.all(want[5:] == 0.0)
    assert eng.stats.padded_images == 3
    assert [h.state for h in handles] == [DONE] * 5


def test_classify_matches_forward_and_runs_plain_versions_on_cpu(qm):
    eng = qm.serve(max_batch=4, attn="int8")
    imgs = _images(4, seed=3)
    kernels.reset_counts()
    out = eng.classify(imgs)
    c = kernels.counts()
    assert all(v["launches"] == 0 for v in c.values())
    assert c["m2q_matmul"]["plain_calls"] == 16
    assert c["dwconv_w4"]["plain_calls"] == 7
    assert c["relu_attn"]["plain_calls"] == 6
    np.testing.assert_array_equal(out, qm.forward(imgs, attn="int8").numpy())


def test_non_finite_row_fails_alone(qm, monkeypatch):
    eng = qm.serve(max_batch=2)
    real = eng._run_batch

    def poisoned(images, bucket):
        out = real(images, bucket).copy()
        out[0] = np.nan
        return out

    monkeypatch.setattr(eng, "_run_batch", poisoned)
    h0, h1 = eng.submit(_images(1)[0]), eng.submit(_images(1, seed=4)[0])
    assert h0.state == FAILED and h1.state == DONE
    with pytest.raises(NumericalError):
        h0.result()


def test_kernel_raise_fails_its_batch_and_is_not_retried(qm, monkeypatch):
    """No hidden retry on another path: the exception reaches the caller."""
    eng = qm.serve(max_batch=1)
    calls = []

    def boom(*a, **k):
        calls.append(1)
        raise RuntimeError("CUDA kernel m2q_matmul failed to launch")

    monkeypatch.setattr(eng.model, "forward", boom)
    h = eng.submit(_images(1)[0])
    assert h.state == FAILED and calls == [1]
    with pytest.raises(RuntimeError, match="failed to launch"):
        h.result()


@pytest.mark.parametrize("bad", [np.zeros((31, 32, 3), np.float32),
                                 np.full((32, 32, 3), np.nan, np.float32),
                                 np.zeros((32, 32, 3), np.complex64)])
def test_submit_validates_payloads(qm, bad):
    with pytest.raises(ValueError):
        qm.serve().submit(bad)


def test_scheduler_deadlines_cancel_and_overload():
    clock = Clock()
    ran = []
    sched = Scheduler(FlushPolicy(max_batch=4, max_delay_ms=10.0),
                      executor=lambda hs, r: ([h.set_result(h.payload)
                                               for h in hs], ran.append(r)),
                      clock=clock, overload=OverloadPolicy(max_queue=3))
    a = sched.submit("a", deadline_ms=5.0)
    b = sched.submit("b")
    c = sched.submit("c")
    with pytest.raises(QueueFullError):
        sched.submit("d")
    assert c.cancel() and c.state == CANCELLED
    clock.t = 0.006
    assert sched.poll() == 0 and a.state == TIMED_OUT
    with pytest.raises(RequestTimedOut):
        a.result()
    clock.t = 0.02
    assert sched.poll() == 1 and b.result() == "b"
    assert ran == ["deadline"]
    st = sched.stats
    assert st.submitted == 3 and st.resolved == 3 and st.rejected == 1
    clock.t = 0.01  # a clock stepping back reads as the latest time seen
    assert sched.now() == 0.02


def test_scheduler_shed_oldest():
    sched = Scheduler(FlushPolicy(max_batch=8),
                      executor=lambda hs, r: [h.set_result(1) for h in hs],
                      overload=OverloadPolicy(max_queue=2, shed_oldest=True))
    h = [sched.submit(i) for i in range(3)]
    assert h[0].state == FAILED and sched.stats.shed == 1
    assert [x.result() for x in sched.drain()] == [1, 1]


@pytest.mark.parametrize("n,cap,want", [(0, None, 1), (5, 8, 8),
                                        (3, None, 4), (9, 8, 8)])
def test_pow2_bucket(n, cap, want):
    # JAX's signature: pow2_bucket(n, min_bucket=1, cap=None)
    assert pow2_bucket(n, cap=cap) == want


def test_forward_accepts_numpy_and_runs_on_params_device(qm):
    y = qm.forward(_images(2))
    assert isinstance(y, torch.Tensor) and y.device.type == "cpu"
    assert y.shape == (2, REDUCED.n_classes) and torch.isfinite(y).all()

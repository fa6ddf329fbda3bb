"""The port's sharded serving on four gloo ranks on the CPU
(``torch_mesh_pool``): the reduced EfficientViT-B1 data-parallel through
``VisionEngine(mesh=)`` and the reduced qwen tensor- and data-parallel
through ``Engine(mesh=)``, each against the unsharded port engine on the
same inputs (and the vision logits against JAX's dispatch-off forward
of the same artifact), requests submitted at different wall times on
different ranks, the token engine under a ``ServingDaemon``, and both
CLIs on the mesh."""
import numpy as np
import pytest

from repro_torch import recipe as trecipe
from repro_torch.configs.efficientvit_b1 import REDUCED as VCFG
from repro_torch.configs.registry import REDUCED
from repro_torch.launch.daemon import teacher_forced_logits, token_gaps
from torch_mesh_pool import MeshPool

# a served token that differs from the unsharded engine's must sit this
# close below the teacher-forced top, as a fraction of the largest
# |logit|: the reduced qwen runs in f32, and a row-parallel shard only
# reorders f32 additions (measured: no token differed)
F32_TOKEN_BOUND = 1e-5


@pytest.fixture(scope="module")
def pool():
    p = MeshPool()
    yield p
    p.close()


@pytest.fixture(scope="module")
def vision_art(tmp_path_factory):
    from repro_torch.models import efficientvit as ev
    qm = trecipe.quantize(VCFG, ev.init(VCFG, device="cpu"), "m2q-w8a8")
    path = tmp_path_factory.mktemp("vision_art")
    qm.save(path)
    images = np.random.default_rng(0).normal(
        size=(6, VCFG.img_res, VCFG.img_res, 3)).astype(np.float32)
    return str(path), qm, images


def _requests(cfg, n=7):
    rng = np.random.default_rng(3)
    return [(rng.integers(0, cfg.vocab_size, int(rng.integers(3, 12))
                          ).tolist(), int(rng.integers(3, 7)),
             0.8 if i % 3 == 0 else 0.0) for i in range(n)]


@pytest.fixture(scope="module")
def token_arts(tmp_path_factory):
    """The reduced qwen (int8 KV) under w4-weights-only and m2q-w8a8
    (the mixed LM path: QExpertM2Q / perm-folded QM2Q leaves)."""
    from repro_torch.models import dense_lm
    cfg = REDUCED["qwen1.5-0.5b"].replace(kv_cache_dtype="int8")
    out = {}
    for rec in ("w4-weights-only", "m2q-w8a8"):
        qm = trecipe.quantize(cfg, dense_lm.init(cfg, device="cpu"), rec)
        path = tmp_path_factory.mktemp(rec)
        qm.save(path)
        out[rec] = (str(path), qm)
    return out


def _unsharded_tokens(qm, requests, max_batch=4, max_len=64):
    eng = qm.serve(max_batch=max_batch, max_len=max_len, seed=0,
                   graphs=False)
    reqs = [eng.submit(np.asarray(p, np.int32), max_new_tokens=n,
                       temperature=t) for p, n, t in requests]
    eng.run()
    return [r.handle.result() for r in reqs]


def _check_tokens(qm, requests, got, want, max_len=64):
    """Equal, or every token of a differing greedy request within
    F32_TOKEN_BOUND of the teacher-forced top."""
    for (p, n, t), a, b in zip(requests, got, want):
        if a == b:
            continue
        assert t == 0.0 and len(a) == len(b), (a, b)
        lg = teacher_forced_logits(qm.cfg, qm.params, [p],
                                   np.asarray(a[:-1])[:, None],
                                   max_len).numpy()
        gaps = token_gaps(lg, np.asarray(a)[:, None])
        assert gaps.max() <= F32_TOKEN_BOUND * np.abs(lg).max(), (a, b)


# ---------------------------------------------------------------------------
# vision: data-parallel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)])
@pytest.mark.parametrize("attn", ["int8", "f32"])
def test_vision_data_parallel_equals_unsharded(pool, vision_art, shape, attn):
    """Each rank runs its data slice of every padded bucket; relu_attn's
    batch-wide scales are max-reduced over ``data``.  ``classify`` and a
    submitted-and-flushed batch equal the unsharded engine's logits on the
    same buckets (min_bucket raised to the data axis) at zero tolerance,
    on every rank; with ``model=2`` too (no B1 leaf shards over model:
    the bound is 0)."""
    art, qm, images = vision_art
    ref = qm.serve(max_batch=4, graphs=False, attn=attn,
                   min_bucket=shape[0]).classify(images)
    for out in pool.run("vision", art=art, images=images, shape=shape,
                        attn=attn):
        np.testing.assert_array_equal(out["classify"], ref)
        np.testing.assert_array_equal(out["flush"], ref)
        assert all(out["done"]) and out["min_bucket"] == shape[0]


def test_vision_matches_jax_dispatch_off(pool, vision_art):
    """The sharded engine's f32-attention logits against JAX's
    dispatch-off forward of the same artifact (JAX reads the port's
    save), within test_torch_slice's bound: 1e-4 of the largest logit,
    argmax equal."""
    from repro import recipe as jrecipe
    from repro.configs.efficientvit_b1 import REDUCED as JCFG
    from torch_parity import jax_forward
    art, _, images = vision_art
    jq = jrecipe.QuantizedModel.load(art)
    out = pool.run("vision", art=art, images=images[:4], shape=(4, 1),
                   attn="f32")[0]
    want = jax_forward(JCFG, jq.params, images[:4])
    np.testing.assert_allclose(out["classify"], want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    np.testing.assert_array_equal(out["classify"].argmax(-1),
                                  want.argmax(-1))


def test_vision_skewed_submit(pool, vision_art):
    """Rank 1 submits half a second after the others: rank 0 decides the
    batches, rank 1 waits for its own submits, nobody hangs, the logits
    are the same.  A request that times out in rank 0's queue times out
    on every rank -- rank 1's twin, submitted after rank 0's expiry
    reached it, at its submit."""
    art, qm, images = vision_art
    ref = qm.serve(max_batch=4, graphs=False, attn="int8",
                   min_bucket=2).classify(images)
    for out in pool.run("vision", art=art, images=images, shape=(2, 2),
                        skew_s=0.5):
        np.testing.assert_array_equal(out["flush"], ref)
        assert out["expired"] == ("TIMED_OUT", "RequestTimedOut")


# ---------------------------------------------------------------------------
# token: tensor- and data-parallel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("recipe", ["w4-weights-only", "m2q-w8a8"])
@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 1)])
def test_token_sharded_equals_unsharded(pool, token_arts, recipe, shape):
    """Heads, FFN columns and the lm_head's vocab on ``model``, slots on
    ``data``: greedy and seeded-sampled tokens (every rank draws the full
    (B, V) uniforms and keeps its rows) equal the unsharded engine's on
    every rank, but where a row-parallel sum's reordered f32 additions
    move a near-tie (F32_TOKEN_BOUND).  The cache is placed by
    ``cache_specs(shard_model=True)``: k / v heads on model, the int8 row
    scales replicated over model."""
    art, qm = token_arts[recipe]
    requests = _requests(qm.cfg)
    want = _unsharded_tokens(qm, requests)
    outs = pool.run("tokens", art=art, requests=requests, shape=shape)
    for out in outs:
        _check_tokens(qm, requests, out["tokens"], want)
        assert all(out["placed"].values()), out["placed"]
        L, B, T, H, D = out["full"]["k"]
        assert out["local"]["k"] == (L, B // shape[0], T, H // shape[1], D)
        assert out["local"]["k_scale"] == (L, B // shape[0], T, H)
    assert len({tuple(map(tuple, o["tokens"])) for o in outs}) == 1


def test_token_skewed_submit(pool, token_arts):
    """Rank 1 submits its requests half a second late: rank 0 admits by
    uid and rank 1 waits for its own submits; the same tokens, no
    hang."""
    art, qm = token_arts["w4-weights-only"]
    requests = _requests(qm.cfg)
    want = _unsharded_tokens(qm, requests)
    for out in pool.run("tokens", art=art, requests=requests, shape=(2, 2),
                        skew_s=0.5):
        _check_tokens(qm, requests, out["tokens"], want)


def test_token_sharded_under_serving_daemon(pool, token_arts):
    """Each rank's ``ServingDaemon`` drives its engine: rank 0's daemon
    decides every step, the others follow until rank 0 releases them at
    shutdown; tokens equal the unsharded engine's."""
    art, qm = token_arts["w4-weights-only"]
    requests = [(p, n, 0.0) for p, n, _ in _requests(qm.cfg)]
    want = _unsharded_tokens(qm, requests)
    for out in pool.run("tokens", art=art, requests=requests, shape=(2, 2),
                        daemon=True, timeout=120):
        _check_tokens(qm, requests, out["tokens"], want)


def test_token_daemon_survives_an_idle_gap(pool, token_arts):
    """The ranks other than 0 wait for rank 0's next decision inside a
    collective: with the group's timeout cut to 2 s, an idle gap of 5 s
    between requests is bridged by rank 0's daemon stepping every
    keep-alive (a quarter of the timeout), and the requests after the
    gap are served on every rank."""
    art, qm = token_arts["w4-weights-only"]
    requests = [(p, n, 0.0) for p, n, _ in _requests(qm.cfg, n=4)]
    want = _unsharded_tokens(qm, requests)
    for out in pool.run("idle_gap", art=art, requests=requests, gap_s=5.0,
                        timeout_s=2.0, timeout=90):
        assert out["keepalive_s"] == 0.5
        _check_tokens(qm, requests, out["tokens"], want)


def test_clis_serve_on_the_mesh(pool, tmp_path):
    """``launch.serve --mesh 2x2`` reports once (rank 0) with the backend
    printed; ``launch.daemon --coordinator ... --mesh 2x2`` checks every
    leaf's placement, passes the readiness barrier and serves its
    traffic on every rank."""
    outs = pool.run("clis", art_dir=str(tmp_path), timeout=120)
    assert "backend=gloo" in outs[0]["serve"]
    assert "requests=4" in outs[0]["serve"] and "mesh=" in outs[0]["serve"]
    assert all(o["serve"] == "" for o in outs[1:])
    for rank, out in enumerate(outs):
        rc, text = out["daemon"]
        assert rc == 0, text
        assert f"[daemon:{rank}] placement-ok" in text
        assert "peers-ready: 4/4" in text and "reconciled 4 requests" in text

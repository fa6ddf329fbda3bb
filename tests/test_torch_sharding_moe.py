"""Model-sharded serving of the MoE and recurrent families on gloo ranks
on the CPU (``torch_mesh_pool``: a pool of four ranks and one of two):

* the MoE routing on a data axis > 1 against the JAX package's
  ``nn.moe_ffn`` over the global batch, with the capacity factor cut so
  that experts overflow (the ranks must route the step's global rows:
  capacity and each choice's position depend on every row);
* one MoE layer expert-parallel (``dist.spmd.ExpertParallel``: each rank
  ``E / model`` experts, outputs gathered over ``model``) equal to the
  unsharded layer at zero tolerance: llama4-scout's 4-bit ``QUniform``
  experts and dbrx's ``QExpertM2Q`` experts;
* the reduced llama4-scout, dbrx, rwkv6-3b and recurrentgemma-9b served
  through ``Engine(mesh=)``: tokens and the sharded tree's teacher-forced
  logits against the unsharded port engine's, and the unsharded engine
  against the JAX package's forward of the same artifact;
* ``local_config``'s refusals (whisper, indivisible heads).

Trees are built once per module; the ranks, and this process
(``torch_parity``), run one intra-op thread."""
import numpy as np
import pytest
import torch

from repro_torch import nn
from repro_torch import recipe as trecipe
from repro_torch.configs.registry import REDUCED
from repro_torch.dist import spmd
from repro_torch.launch.daemon import teacher_forced_logits, token_gaps
from repro_torch.models import dense_lm, get_model
from torch_mesh_pool import MeshPool
from torch_parity import jax_lm_forward

MOE = ["llama4-scout-17b-a16e", "dbrx-132b"]
RECURRENT = ["rwkv6-3b", "recurrentgemma-9b"]
# the recipe of each reduced artifact: llama4-scout's experts 4-bit
# QUniform (axis 3), dbrx's mixed QExpertM2Q (the narrow LM's taxonomy
# overrides), the recurrent families weights-only (recurrentgemma cannot
# be calibrated, in either package)
RECIPES = {"llama4-scout-17b-a16e": "w4-weights-only",
           "dbrx-132b": "m2q-w8a8", "rwkv6-3b": "w4-weights-only",
           "recurrentgemma-9b": "w4-weights-only"}
SHAPES = {"llama4-scout-17b-a16e": [(1, 2), (1, 4), (2, 2)],
          "dbrx-132b": [(1, 2), (1, 4), (2, 2)],
          "rwkv6-3b": [(1, 2), (2, 2)],
          "recurrentgemma-9b": [(1, 2), (2, 2)]}
MAX_LEN = 64
PROMPT_LEN = 8
MAX_NEW = 5
# the port's f32 MoE layer against JAX's: summation order only
FLOAT_TOL = 1e-5
# sharded against unsharded, as a fraction of the largest |logit|: the
# reduced trees run in f32 and a row-parallel shard reorders f32
# additions (tests/test_torch_sharding_serve.py's bound; measured: at most
# 9.5e-7, dbrx's and rwkv's 0.0, every token equal)
SHARD_TOL = 1e-5
# the unsharded engine's teacher-forced logits against JAX's forward of
# the same artifact over prompt + forced tokens: the MoE LMs decode from
# an int8 KV cache where the forward attends in f32 (test_torch_moe.py's
# int8-KV decode bound, 5e-2; measured 1.5e-2 and 2.0e-2); the recurrent
# families' cache is f32 (test_torch_recurrent.py's f32 bound, 1e-5;
# measured 5.0e-7 and 2.0e-6)
JAX_TOL = {"llama4-scout-17b-a16e": 5e-2, "dbrx-132b": 5e-2,
           "rwkv6-3b": 1e-5, "recurrentgemma-9b": 1e-5}

@pytest.fixture(scope="module")
def pools():
    p = {4: MeshPool(4), 2: MeshPool(2)}
    yield p
    for pool in p.values():
        pool.close()


def _pool(pools, shape):
    return pools[shape[0] * shape[1]]


def _cfg(arch):
    cfg = REDUCED[arch]
    return cfg.replace(kv_cache_dtype="int8") if arch in MOE else cfg


@pytest.fixture(scope="module")
def arts(tmp_path_factory):
    """Each reduced model quantized under its recipe and saved."""
    out = {}
    for arch, rec in RECIPES.items():
        cfg = _cfg(arch)
        qm = trecipe.quantize(cfg, get_model(cfg).init(cfg, device="cpu"),
                              rec)
        path = tmp_path_factory.mktemp(arch)
        qm.save(path)
        out[arch] = (str(path), qm)
    return out


# ---------------------------------------------------------------------------
# the routing on a data axis
# ---------------------------------------------------------------------------


def _float_layer(cfg, seed=0):
    rng = np.random.default_rng(seed)
    D, E, F = cfg.d_model, cfg.moe_experts, cfg.moe_d_ff

    def w(*shape):
        return (rng.normal(size=shape) / np.sqrt(shape[-2])).astype(
            np.float32)
    return {"router": w(D, E),
            "experts": {"w1": w(E, D, F), "w3": w(E, D, F),
                        "w2": w(E, F, D)}}


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
@pytest.mark.parametrize("arch", MOE)
def test_data_parallel_moe_routes_the_global_batch(pools, arch, shape):
    """With the capacity factor cut to 0.5, some choice overflows its
    expert at the global batch's capacity.  Each data rank holds its
    block of the 64 rows; the layer's outputs, data ranks in order, equal
    the unsharded port layer's on the whole batch at zero tolerance and
    the JAX package's ``moe_ffn`` on it within FLOAT_TOL of max |y|
    (routing each rank's rows alone would drop other choices)."""
    import jax.numpy as jnp
    from repro import nn as jnn
    cfg = REDUCED[arch].replace(moe_capacity_factor=0.5)
    mcfg = dense_lm.moe_config(cfg)
    layer = _float_layer(cfg)
    x = np.random.default_rng(1).normal(size=(64, cfg.d_model)).astype(
        np.float32)
    host = {"router": torch.from_numpy(layer["router"]),
            "experts": {k: torch.from_numpy(v)
                        for k, v in layer["experts"].items()}}
    _, _, _, ok = nn.moe.route(torch.from_numpy(x), host["router"], mcfg)
    assert not bool(ok.all()), "no choice overflowed: the test shows nothing"
    want = nn.moe_ffn(torch.from_numpy(x), host, mcfg).numpy()
    jcfg = jnn.moe.MoEConfig(
        num_experts=mcfg.num_experts, top_k=mcfg.top_k,
        d_model=mcfg.d_model, d_ff=mcfg.d_ff,
        capacity_factor=mcfg.capacity_factor)
    jy = np.asarray(jnn.moe.moe_ffn(
        jnp.asarray(x), {"router": jnp.asarray(layer["router"]),
                         "experts": {k: jnp.asarray(v) for k, v in
                                     layer["experts"].items()}}, jcfg))
    outs = _pool(pools, shape).run("moe_layer", x=x, shape=shape,
                                   layer=layer, mcfg=mcfg)
    m = shape[1]
    got = np.concatenate([o["y"] for o in outs[::m]])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, jy, rtol=0,
                               atol=FLOAT_TOL * np.abs(jy).max())
    assert {o["experts"] for o in outs} == {cfg.moe_experts // m}


# ---------------------------------------------------------------------------
# one expert-parallel layer, exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 2)])
@pytest.mark.parametrize("arch", MOE)
def test_expert_parallel_layer_equals_unsharded(pools, arts, arch, shape):
    """Layer 0's MoE of the quantized reduced model: each rank runs its
    ``E / model`` experts of the (E, C, D) buffer every rank builds alike
    (the replicated router), the outputs gathered over ``model``; on a
    data axis the rows are gathered first.  Equal to the unsharded layer
    on the same 24 rows at zero tolerance (each expert's product is the
    same call on the same rows)."""
    art, qm = arts[arch]
    cfg = qm.cfg
    x = np.random.default_rng(2).normal(size=(24, cfg.d_model)).astype(
        np.float32)
    with torch.no_grad():
        want = nn.moe_ffn(torch.from_numpy(x), dense_lm.layer_params(
            qm.params["layers"], 0)["moe"], dense_lm.moe_config(cfg)).numpy()
    outs = _pool(pools, shape).run("moe_layer", x=x, shape=shape, art=art)
    got = np.concatenate([o["y"] for o in outs[::shape[1]]])
    np.testing.assert_array_equal(got, want)
    assert {o["experts"] for o in outs} == {cfg.moe_experts // shape[1]}


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------


def _requests(cfg, n=4):
    """``n`` greedy requests of PROMPT_LEN tokens (one prefill group,
    one exact-length bucket for the recurrent families) and one sampled
    request of another length."""
    rng = np.random.default_rng(7)
    reqs = [(rng.integers(0, cfg.vocab_size, PROMPT_LEN).tolist(), MAX_NEW,
             0.0) for _ in range(n)]
    reqs.append((rng.integers(0, cfg.vocab_size, 5).tolist(), MAX_NEW, 0.8))
    return reqs


def _served(qm, requests):
    eng = qm.serve(max_batch=4, max_len=MAX_LEN, seed=0, graphs=False)
    reqs = [eng.submit(np.asarray(p, np.int32), max_new_tokens=n,
                       temperature=t) for p, n, t in requests]
    eng.run()
    return [r.handle.result() for r in reqs]


def _forced(requests, tokens):
    """(prompts, forced (steps, B)) of the greedy requests."""
    greedy = [i for i, (_, _, t) in enumerate(requests) if t == 0.0]
    return ([requests[i][0] for i in greedy],
            np.array([tokens[i][:-1] for i in greedy]).T, greedy)


@pytest.fixture(scope="module")
def unsharded(arts):
    """Each artifact's unsharded engine tokens and teacher-forced logits
    over its greedy tokens."""
    out = {}
    for arch, (_, qm) in arts.items():
        reqs = _requests(qm.cfg)
        toks = _served(qm, reqs)
        prompts, forced, _ = _forced(reqs, toks)
        lg = teacher_forced_logits(qm.cfg, qm.params, prompts, forced,
                                   MAX_LEN).numpy()
        out[arch] = (reqs, toks, lg)
    return out


CASES = [(a, s) for a in MOE + RECURRENT for s in SHAPES[a]]


@pytest.mark.parametrize("arch,shape", CASES,
                         ids=[f"{a}-{s[0]}x{s[1]}" for a, s in CASES])
def test_sharded_engine_matches_unsharded(pools, arts, unsharded, arch,
                                          shape):
    """``Engine(mesh=)`` on ``shape`` (the MoE LMs: experts, heads and
    vocab on ``model``, the single KV head gathered; rwkv: the embedding
    and lm_head; recurrentgemma: query heads, FFN and vocab, the single
    KV head gathered and the recurrence replicated), every rank the same
    tokens; each greedy token equal to the unsharded engine's or within
    SHARD_TOL of the unsharded teacher-forced top; the sampled request
    the same length; the sharded tree's teacher-forced logits within
    SHARD_TOL of max |logit| of the unsharded ones; the cache placed as
    ``cache_specs`` says."""
    art, qm = arts[arch]
    reqs, want, ref = unsharded[arch]
    pool = _pool(pools, shape)
    outs = pool.run("tokens", art=art, requests=reqs, shape=shape,
                    max_len=MAX_LEN)
    tol = SHARD_TOL * np.abs(ref).max()
    got = outs[0]["tokens"]
    assert all(o["tokens"] == got for o in outs)
    for o in outs:
        assert all(o["placed"].values()), o["placed"]
    prompts, _, greedy = _forced(reqs, want)
    for j, i in enumerate(greedy):
        if got[i] != want[i]:
            gaps = token_gaps(ref[:, j:j + 1], np.asarray(got[i])[:, None])
            assert gaps.max() <= tol, (i, got[i], want[i])
    assert all(len(got[i]) == n for i, (_, n, _) in enumerate(reqs))
    # the sharded tree's teacher-forced logits over the unsharded tokens
    forced = _forced(reqs, want)[1]
    outs = pool.run("forced_logits", art=art, prompts=prompts,
                    forced=forced, shape=shape, max_len=MAX_LEN)
    for o in outs:
        assert np.abs(o["logits"] - ref).max() <= tol
    cfg = qm.cfg
    if arch != "rwkv6-3b":
        assert outs[0]["heads"] == (cfg.n_heads // shape[1], 1)


@pytest.mark.parametrize("arch", MOE + RECURRENT)
def test_unsharded_engine_matches_jax_forward(arts, unsharded, arch):
    """The unsharded port engine against the JAX package's forward
    (dispatch off, ``torch_parity.jax_lm_forward``) of the same artifact,
    read by JAX: its teacher-forced
    logits over the served greedy tokens within JAX_TOL of max |logit|
    of JAX's at the same positions, and each served greedy token within
    that bound of JAX's top."""
    from repro import recipe as jrecipe
    art, qm = arts[arch]
    reqs, toks, lg = unsharded[arch]
    prompts, forced, greedy = _forced(reqs, toks)
    seqs = np.concatenate([np.array(prompts), forced.T], axis=1)
    jqm = jrecipe.QuantizedModel.load(art)
    jl = jax_lm_forward(jqm.cfg, jqm.params, seqs)
    jl = jl[:, PROMPT_LEN - 1:, :qm.cfg.vocab_size].transpose(1, 0, 2)
    tol = JAX_TOL[arch] * np.abs(jl).max()
    assert np.abs(lg - jl).max() <= tol
    served = np.array([toks[i] for i in greedy]).T
    assert token_gaps(jl, served).max() <= tol


# ---------------------------------------------------------------------------
# what stays refused
# ---------------------------------------------------------------------------


class _Ranks:
    """What ``local_config`` reads of a runtime: the model axis."""

    def __init__(self, n_model):
        self.n_model = n_model


def test_local_config_refusals():
    """whisper stays refused on a model axis > 1 (naming ROADMAP's item);
    a dense LM's KV heads, and any family's query heads, experts or
    vocab, must divide over it; a single KV head is gathered for the MoE
    LMs and recurrentgemma, not for a dense LM."""
    rt2 = _Ranks(2)
    with pytest.raises(NotImplementedError, match="A10d"):
        spmd.local_config(REDUCED["whisper-large-v3"], rt2)
    with pytest.raises(ValueError, match="n_kv_heads=1"):
        spmd.local_config(REDUCED["qwen3-14b"].replace(
            n_heads=4, n_kv_heads=1), rt2)
    with pytest.raises(ValueError, match="n_heads=4"):
        spmd.local_config(REDUCED["recurrentgemma-9b"], _Ranks(8))
    with pytest.raises(ValueError, match="moe_experts=3"):
        spmd.local_config(REDUCED["dbrx-132b"].replace(moe_experts=3), rt2)
    with pytest.raises(ValueError, match="padded_vocab"):
        spmd.local_config(REDUCED["rwkv6-3b"], _Ranks(3))
    for arch in ("dbrx-132b", "recurrentgemma-9b"):
        cfg = spmd.local_config(REDUCED[arch], rt2)
        assert (cfg.n_heads, cfg.n_kv_heads) == (2, 1)
        assert spmd.kv_gathered(REDUCED[arch], rt2)
    assert spmd.local_config(REDUCED["rwkv6-3b"], rt2) == REDUCED["rwkv6-3b"]
    assert spmd.local_config(REDUCED["whisper-large-v3"], _Ranks(1)) \
        == REDUCED["whisper-large-v3"]

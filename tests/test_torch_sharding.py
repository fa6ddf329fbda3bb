"""The port's sharding rules (``repro_torch.dist.sharding``) against the
JAX package's, leaf for leaf, and its placement on a real mesh: four
gloo ranks on the CPU (``torch_mesh_pool``) placing a reduced qwen
artifact with ``put_global`` and ``restore(..., shardings=)``, and saving
a sharded tree whole.  The CLIs' ``--mesh`` / ``--coordinator`` errors,
and the engines' mesh errors on shape-only stand-in meshes."""
import jax
import numpy as np
import pytest
import torch

from repro import recipe as jrecipe
from repro.configs import registry as jreg
from repro.core.calibrate import path_str
from repro.dist import sharding as J
from repro.models import get_model as jget_model
from repro_torch import recipe as trecipe
from repro_torch.configs.registry import ARCHS, REDUCED
from repro_torch.dist import sharding as T
from repro_torch.models import get_model
from torch_mesh_pool import MeshPool


class StandIn:
    """Shape-only mesh (the rules read axis sizes only), as JAX's
    ``tests/test_sharding.py`` uses."""
    axis_names = mesh_dim_names = ("data", "model")

    def __init__(self, data: int, model: int):
        self.shape = {"data": data, "model": model}

    def size(self) -> int:
        return self.shape["data"] * self.shape["model"]


MESHES = [StandIn(2, 2), StandIn(1, 4), StandIn(4, 1), StandIn(16, 16)]


def _jax_specs(tree) -> dict:
    return {path_str(p): tuple(s) for p, s in
            jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))}


def _port_specs(tree) -> dict:
    return {p: tuple(s) for p, s in T.flat_arrays(tree)}


def _both_equal(ttree, jtree, fn_t, fn_j):
    """Every mesh x fsdp: the port's spec of each leaf == JAX's."""
    n = 0
    for mesh in MESHES:
        for fsdp in (False, True):
            ours = _port_specs(fn_t(ttree, mesh, fsdp))
            theirs = _jax_specs(fn_j(jtree, mesh, fsdp))
            assert ours.keys() == theirs.keys()
            for path, spec in ours.items():
                assert spec == theirs[path], (path, mesh.shape, fsdp)
                n += 1
    return n


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------

RULE_CASES = [
    ("layers/attn/wq", (24, 64, 128), "float32"),
    ("layers/attn/wq/0/0", (24, 64, 128), "int8"),
    ("layers/attn/wq", (24, 64, 126), "float32"),
    ("layers/attn/wq/2", (24, 128), "int32"),
    ("layers/attn/wq/2", (24, 128), "uint32"),
    ("layers/moe/experts/w1", (8, 16, 64, 128), "float32"),
    ("layers/moe/experts/w2/0", (16, 64, 128), "int8"),
    ("layers/attn/wo", (24, 128, 64), "bfloat16"),
    ("layers/mlp/w2/1", (24, 1, 64), "float32"),
    ("lm_head", (64, 1000), "float32"),
    ("lm_head/0", (64, 500), "uint8"),
    ("embed", (1000, 64), "float32"),
    ("stages/0/0/mb/w_pw1", (1, 1, 8, 32), "float32"),
    ("layers/attn/bq", (24, 128), "float32"),
    ("final_norm", (64,), "float32"),
    ("scalar", (), "float32"),
    ("layers/mlp/w1", (24, 2048, 4096), "float32"),
]


@pytest.mark.parametrize("path,shape,dtype", RULE_CASES)
@pytest.mark.parametrize("fsdp", [False, True])
def test_spec_for_param_matches_jax(path, shape, dtype, fsdp):
    """The rules leaf by leaf, numpy and torch dtypes alike (int leaves of
    4+ bytes replicate; experts on ndim-3, rows on ndim-2, columns on
    ndim-1; FSDP on the first free divisible dim of a big leaf)."""
    tdt = getattr(torch, dtype) if dtype != "uint32" else torch.uint32
    for mesh in MESHES:
        want = tuple(J.spec_for_param(path, shape, np.dtype(
            "float32" if dtype == "bfloat16" else dtype), mesh, fsdp=fsdp))
        assert tuple(T.spec_for_param(path, shape, tdt, mesh, fsdp)) == want
        if dtype != "bfloat16":
            assert tuple(T.spec_for_param(path, shape, np.dtype(dtype), mesh,
                                          fsdp)) == want
    assert repr(T.P(None, "model")) == "P(None, 'model')"


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_float_tree_match_jax(arch):
    """The float tree (``init`` on the meta device vs ``jax.eval_shape``
    of init) of every registered config, every mesh, fsdp on and off."""
    cfg = ARCHS[arch]
    jcfg = jreg.ARCHS[arch]
    ours = get_model(cfg).init(cfg, device="meta")
    theirs = jax.eval_shape(
        lambda: jget_model(jcfg).init(jcfg, jax.random.PRNGKey(0)))
    assert _both_equal(ours, theirs, T.param_specs, J.param_specs) > 0


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("recipe", ["m2q-w8a8", "w4-weights-only"])
def test_param_specs_quantized_tree_match_jax(arch, recipe):
    """Each package's shape-only quantized twin (``abstract_quantize``):
    QTensor children keyed ``<path>/<i>``, payloads and per-column scales
    co-sharded, index leaves replicated -- equal leaf for leaf."""
    ours = trecipe.abstract_quantize(arch, recipe=recipe)
    theirs = jrecipe.abstract_quantize(arch, recipe=recipe)
    assert _both_equal(ours, theirs, T.param_specs, J.param_specs) > 0


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(
    str(v) for v in m.shape.values()))
def test_batch_specs_match_jax(mesh):
    batch = {"tokens": np.zeros((8, 16), np.int32),
             "images": np.zeros((6, 4, 4, 3), np.float32),
             "lengths": np.zeros((16,), np.int32),
             "scalar": np.zeros((), np.float32)}
    ours = _port_specs(T.batch_specs(
        {k: torch.from_numpy(v) for k, v in batch.items()}, mesh))
    assert ours == _jax_specs(J.batch_specs(batch, mesh))


CACHE_FAMILIES = ["qwen1.5-0.5b", "qwen3-14b", "rwkv6-3b",
                  "recurrentgemma-9b", "llama4-scout-17b-a16e",
                  "whisper-large-v3"]


@pytest.mark.parametrize("arch", CACHE_FAMILIES)
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_cache_specs_match_jax(arch, kv):
    """``cache_specs`` over each cache family's ``init_cache`` (the int8
    cache's (L, B, T, Hkv) row scales keep their heads replicated under
    the ``nd >= 5`` rule), with and without ``shard_model``."""
    cfg = REDUCED[arch].replace(kv_cache_dtype=kv)
    jcfg = jreg.REDUCED[arch].replace(kv_cache_dtype=kv)
    ours = get_model(cfg).init_cache(cfg, 8, 16, dtype=torch.float32,
                                     device="meta")
    theirs = jax.eval_shape(lambda: jget_model(jcfg).init_cache(jcfg, 8, 16))
    for mesh in MESHES:
        for shard_model in (False, True):
            assert _port_specs(T.cache_specs(ours, mesh, shard_model)) == \
                _jax_specs(J.cache_specs(theirs, mesh, shard_model)), \
                (mesh.shape, shard_model)


# ---------------------------------------------------------------------------
# placement on four gloo ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pool():
    p = MeshPool()
    yield p
    p.close()


@pytest.fixture(scope="module")
def token_art(tmp_path_factory):
    """Reduced qwen (int8 KV) under w4-weights-only, saved."""
    from repro_torch.models import dense_lm
    cfg = REDUCED["qwen1.5-0.5b"].replace(kv_cache_dtype="int8")
    qm = trecipe.quantize(cfg, dense_lm.init(cfg, device="cpu"),
                          "w4-weights-only")
    path = tmp_path_factory.mktemp("token_art")
    qm.save(path)
    return str(path), qm


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 1)])
def test_placement_equals_specs(pool, token_art, shape):
    """Every leaf of ``put_global`` and of ``restore(shardings=)`` is
    placed as its spec says, each rank holds the shard its coordinate
    cuts (column shards of wq / w1 / lm_head, row shards of wo / w2,
    replicated scalars), and the shards reassemble to the host tree; the
    cache and a token batch place likewise."""
    art, qm = token_art
    outs = pool.run("placement", art=art, shape=shape)
    mesh = StandIn(*shape)
    specs = dict(T.flat_arrays(T.param_specs(qm.params, mesh)))
    host = dict(T.flat_arrays(qm.params))
    coords = set()
    for out in outs:
        coords.add(out["coordinate"])
        for what in ("put_global", "restore", "cache", "batch"):
            assert out[what]["problems"] == [], what
        assert out["restore"]["local"] == out["put_global"]["local"]
        for path, local in out["restore"]["local"].items():
            want = list(host[path].shape)
            for d, ax in enumerate(specs[path]):
                if ax is not None:
                    want[d] //= mesh.shape[ax]
            assert local == tuple(want), path
    assert len(coords) == 4
    n_model = shape[1]
    sharded = outs[0]["restore"]["sharded"]
    assert (sharded > 0) == (n_model > 1)


def test_save_gathers_sharded_leaves(pool, token_art, tmp_path):
    """A model restored with its shards and saved: the artifact equals
    the unsharded one leaf for leaf (saves stay whole, so either package
    reads them)."""
    art, qm = token_art
    pool.run("save_sharded", art=art, out_dir=str(tmp_path / "again"))
    back = trecipe.QuantizedModel.load(str(tmp_path / "again"),
                                       device="cpu")
    a, b = dict(T.flat_arrays(qm.params)), dict(T.flat_arrays(back.params))
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_sharded_engines_refuse_graphs_and_expert_parallel(pool, token_art):
    """``graphs=True`` on a mesh of more than one rank raises (gloo
    collectives cannot be captured; no quiet fallback to eager), and an
    MoE model on a model axis > 1 -- once refused -- builds and serves
    (its experts split over ``model``): every rank the same three
    tokens, each in the vocab."""
    art, _ = token_art
    outs = pool.run("refused", art=art)
    vocab = REDUCED["llama4-scout-17b-a16e"].vocab_size
    for out in outs:
        assert "graphs=True" in out["graphs"]
        assert out["moe"] == outs[0]["moe"]
        assert len(out["moe"]) == 3 and all(0 <= t < vocab
                                            for t in out["moe"])


# ---------------------------------------------------------------------------
# errors without ranks
# ---------------------------------------------------------------------------


def test_vision_engine_mesh_errors_match_jax():
    """The data axis must be a power of two dividing max_batch (the JAX
    engine's messages), checked before any rank is touched."""
    from repro_torch.configs.efficientvit_b1 import REDUCED as VCFG
    from repro_torch.serving.vision import VisionEngine
    with pytest.raises(ValueError, match="not a power of two"):
        VisionEngine(VCFG, {}, max_batch=6, mesh=StandIn(3, 1))
    with pytest.raises(ValueError, match="must be divisible by the data"):
        VisionEngine(VCFG, {}, max_batch=6, mesh=StandIn(4, 1))
    with pytest.raises(ValueError, match="graphs=True"):
        VisionEngine(VCFG, {}, max_batch=8, mesh=StandIn(2, 1))


def test_token_engine_refuses_graphs_on_a_mesh():
    from repro_torch.serving.engine import Engine
    cfg = REDUCED["qwen1.5-0.5b"]
    with pytest.raises(ValueError, match="graphs=True"):
        Engine(cfg, {}, mesh=StandIn(1, 2))


@pytest.mark.parametrize("cli,args,msg", [
    ("serve", ["--mesh", "2by2"], "DATAxMODEL"),
    ("daemon", ["--mesh", "1x2", "--smoke"],
     "--smoke and --recovery-smoke run on one rank"),
    ("daemon", ["--mesh", "1x2", "--recovery-smoke"],
     "--smoke and --recovery-smoke run on one rank"),
])
def test_cli_mesh_errors(cli, args, msg, monkeypatch):
    """The CLIs' ``--mesh`` errors beyond the ranks count
    (``test_torch_daemon.py`` holds that one): a malformed spec, and the
    one-rank modes refusing a mesh, before anything is built."""
    import importlib
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    main = importlib.import_module(f"repro_torch.launch.{cli}").main
    with pytest.raises(SystemExit) as e:
        main(["--arch", "qwen1.5-0.5b", "--reduced", "--device", "cpu",
              *args])
    assert msg in str(e.value)
    assert "A9" not in str(e.value)

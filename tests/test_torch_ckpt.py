"""The port's checkpoint module (``repro_torch.ckpt.checkpoint``) and the
JSON guard of its artifacts, against the JAX package's.

* save/restore round trips a tree of every leaf kind onto a ``meta``
  template; a crash injected at each step of ``save`` never publishes a
  torn step and the previous checkpoint still restores; a flipped byte,
  a wrong shape or dtype, a missing or extra leaf raise by name;
  ``AsyncCheckpointer`` snapshots, garbage-collects and re-raises.
* The same tree saved by both packages (JAX QTensors and the port's
  leaves from the same bytes) gives identical manifests.
* The config JSON: the port's payload equals JAX's ``asdict``, the JAX-only
  fields the port lacks are named and defaulted as JAX has them, and a
  function-changing one away from its default raises.
* The data pipeline's batches equal JAX's byte for byte."""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.configs.registry import ARCHS as JARCHS
from repro.data import pipeline as jpipe
from repro.models.config import ArchConfig as JArchConfig
from repro import recipe as jr
from repro_torch import recipe as tr
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs.registry import ARCHS
from repro_torch.convert import params_to_numpy
from repro_torch.core.qtensor import QAPoT, QM2Q, QUniform
from repro_torch.core.scheme_select import select_schemes
from repro_torch.core.tree import leaves_with_path
from repro_torch.data import pipeline
from repro_torch.data import proxy
from repro_torch.models.config import ArchConfig
from torch_parity import jax_to_numpy, numpy_to_jax


def _tree(seed=0):
    """Every leaf kind the port saves: QM2Q, 8-bit / 4-bit / stacked /
    embedding QUniform and QAPoT, each with and without an activation
    scale where it takes one, float leaves in dicts and lists, a 0-d."""
    g = torch.Generator().manual_seed(seed)
    w = torch.randn((16, 8), generator=g)
    w3 = torch.randn((2, 16, 8), generator=g)
    asn = select_schemes(w)
    m2q = QM2Q.quantize(w, asn.apot_idx, asn.uniform_idx, act_max_abs=3.0)
    return {
        "dense": {"m2q": m2q, "m2q_plain": dataclasses.replace(
            m2q, act_scale=None)},
        "u8": QUniform.quantize(w, 8, act_max_abs=2.0),
        "u4": QUniform.quantize(w, 4),
        "stacked": QUniform.quantize(
            w3, 8, axis=-1, reduce_axes=(1,),
            act_max_abs=np.array([1.0, 2.0], np.float32).reshape(2, 1, 1)),
        "embed": QUniform.quantize(w, 4, axis=0),
        "apot": QAPoT.quantize(w, act_max_abs=1.5),
        "apot_w": QAPoT.quantize(w),
        "blocks": [{"b": torch.zeros(8)},
                   {"b": torch.ones(8), "g": torch.randn(3, generator=g)}],
        "scalar": torch.tensor(2.5),
    }


def _meta(tree):
    """``tree`` with every tensor on the meta device (a restore
    template)."""
    return ckpt._map_arrays(lambda _, t: torch.empty_like(t, device="meta"),
                            tree)


def _same(a, b):
    """Equal trees: leaf classes, static fields, array dtypes and bits."""
    la = dict(leaves_with_path(params_to_numpy(a)))
    lb = dict(leaves_with_path(params_to_numpy(b)))
    assert sorted(la) == sorted(lb)
    for key, x in la.items():
        y = lb[key]
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, key
            np.testing.assert_array_equal(x, y, err_msg=key)
        else:
            assert x == y, key


def test_round_trip_onto_a_meta_template(tmp_path):
    tree = _tree()
    path = ckpt.save(tmp_path, 3, tree, extra={"note": [1, 2]})
    assert path.name == "step_00000003"
    assert ckpt.list_steps(tmp_path) == [3] and ckpt.latest_step(tmp_path) == 3
    assert ckpt.read_extra(tmp_path, 3) == {"note": [1, 2]}
    back, extra = ckpt.restore(tmp_path, 3, _meta(tree), device="cpu")
    assert extra == {"note": [1, 2]}
    _same(back, tree)
    assert back["dense"]["m2q_plain"].act_scale is None
    assert isinstance(back["blocks"], list)
    keys = [rec["key"] for rec in json.loads(
        (path / "manifest.json").read_text())["leaves"]]
    # positional children; a None act_scale writes no leaf and the other
    # indices do not shift
    assert [k for k in keys if k.startswith("dense/")] == [
        "dense/m2q/0", "dense/m2q/1", "dense/m2q/2", "dense/m2q/3",
        "dense/m2q/4", "dense/m2q_plain/0", "dense/m2q_plain/1",
        "dense/m2q_plain/2", "dense/m2q_plain/3"]
    assert "u4/3" not in keys and "apot/2" in keys and "apot_w/2" not in keys


def test_manifest_leaves_equal_the_jax_packages_on_the_same_tree(tmp_path):
    """Both packages save the same bytes (the port's leaves, and JAX
    QTensors built from their numpy form): the manifests' leaf lists --
    key, member name, shape, numpy dtype name, sha256 -- are identical,
    and each package restores the other's file."""
    tree = _tree()
    jtree = numpy_to_jax(params_to_numpy(tree))
    ckpt.save(tmp_path / "port", 0, tree)
    jckpt.save(tmp_path / "jax", 0, jtree)
    ours, theirs = (json.loads((tmp_path / d / "step_00000000" /
                                "manifest.json").read_text())["leaves"]
                    for d in ("port", "jax"))
    assert ours == theirs
    assert {rec["dtype"] for rec in ours} == {"float32", "int8", "uint8"}
    back, _ = ckpt.restore(tmp_path / "jax", 0, _meta(tree), device="cpu")
    _same(back, tree)
    jback, _ = jckpt.restore(tmp_path / "port", 0, jtree)
    for (ka, a), (kb, b) in zip(jckpt._leaf_paths(jback),
                                jckpt._leaf_paths(jtree)):
        assert ka == kb and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=ka)


class _Crash(RuntimeError):
    pass


def _inject(monkeypatch, point):
    """Make ``save`` die at ``point``: mid-way through the arrays file, at
    its fsync, mid-way through the manifest, at the manifest's publish
    (``os.replace``), at the swap of an existing step aside, or at the
    rename that publishes the step."""
    def partial_savez(file, **_):
        with open(file, "wb") as f:
            f.write(b"PK\x03\x04torn")
        raise _Crash(point)

    def partial_dump(obj, f):
        f.write(json.dumps(obj)[:40])
        raise _Crash(point)

    def crash(*_):
        raise _Crash(point)

    real_rename = ckpt.os.rename

    def rename(src, dst):
        src, dst = str(src), str(dst)
        if (point == "swap" and dst.endswith(".old-tmp")) or \
                (point == "publish" and src.endswith(".tmp")):
            raise _Crash(point)
        return real_rename(src, dst)

    if point == "arrays":
        monkeypatch.setattr(ckpt.np, "savez", partial_savez)
    elif point == "fsync":
        monkeypatch.setattr(ckpt, "_fsync_file", crash)
    elif point == "manifest":
        monkeypatch.setattr(ckpt.json, "dump", partial_dump)
    elif point == "marker":
        monkeypatch.setattr(ckpt.os, "replace", crash)
    else:
        monkeypatch.setattr(ckpt.os, "rename", rename)


@pytest.mark.parametrize("point,overwrite", [
    (point, overwrite) for point in ("arrays", "fsync", "manifest", "marker",
                                     "swap", "publish")
    for overwrite in (False, True)
    if overwrite or point != "swap"])  # only an overwrite swaps aside
def test_a_crash_mid_save_never_publishes_a_torn_step(tmp_path, monkeypatch,
                                                      point, overwrite):
    """Steps 1 and 2 are published; a save of step 3 (or an overwrite of
    step 2) dies at ``point``.  The readers see steps 1 and 2 complete
    and old, never a torn step; a retry then publishes the new tree."""
    old = {1: _tree(1), 2: _tree(2)}
    for s, t in old.items():
        ckpt.save(tmp_path, s, t)
    new, step = _tree(3), (2 if overwrite else 3)
    with monkeypatch.context() as m:
        _inject(m, point)
        with pytest.raises(_Crash):
            ckpt.save(tmp_path, step, new)
    assert ckpt.list_steps(tmp_path) == [1, 2]
    for s, t in old.items():
        back, _ = ckpt.restore(tmp_path, s, _meta(t), device="cpu")
        _same(back, t)
    ckpt.save(tmp_path, step, new)
    assert ckpt.list_steps(tmp_path) == sorted({1, 2, step})
    back, _ = ckpt.restore(tmp_path, step, _meta(new), device="cpu")
    _same(back, new)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        f"step_{s:08d}" for s in sorted({1, 2, step})]


def _flip_byte(step_dir, name, at=0):
    with np.load(step_dir / "arrays.npz") as data:
        arrays = {k: data[k].copy() for k in data.files}
    arrays[name].view(np.uint8).reshape(-1)[at] ^= 0x10
    np.savez(step_dir / "arrays.npz", **arrays)


def test_a_flipped_byte_raises_checksum_mismatch_naming_the_leaf(tmp_path):
    tree = _tree()
    path = ckpt.save(tmp_path, 0, tree)
    leaves = json.loads((path / "manifest.json").read_text())["leaves"]
    rec = next(r for r in leaves if r["key"] == "stacked/0")
    _flip_byte(path, rec["name"], at=5)
    with pytest.raises(ckpt.ChecksumMismatchError, match="stacked/0") as e:
        ckpt.restore(tmp_path, 0, _meta(tree), device="cpu")
    assert e.value.key == "stacked/0" and e.value.expected == rec["sha256"]
    assert e.value.actual != rec["sha256"]
    back, _ = ckpt.restore(tmp_path, 0, _meta(tree), device="cpu",
                           verify=False)
    assert not torch.equal(back["stacked"].payload, tree["stacked"].payload)


def test_shape_dtype_and_leaf_set_mismatches_raise(tmp_path):
    tree = _tree()
    path = ckpt.save(tmp_path, 0, tree)
    tpl = _meta(tree)

    def restore(t):
        return ckpt.restore(tmp_path, 0, t, device="cpu")

    with pytest.raises(ValueError, match="shape mismatch for 'blocks/1/g'"):
        restore({**tpl, "blocks": [tpl["blocks"][0], {
            "b": tpl["blocks"][1]["b"], "g": torch.empty(4, device="meta")}]})
    with pytest.raises(TypeError, match="dtype mismatch for 'scalar'"):
        restore({**tpl, "scalar": torch.empty((), dtype=torch.float64,
                                              device="meta")})
    with pytest.raises(TypeError, match="dtype mismatch for 'u8/0'"):
        restore({**tpl, "u8": dataclasses.replace(
            tpl["u8"], payload=torch.empty((16, 8), dtype=torch.uint8,
                                           device="meta"))})
    with pytest.raises(KeyError, match="missing leaf 'extra'"):
        restore({**tpl, "extra": torch.empty(2, device="meta")})
    with pytest.raises(KeyError, match="the template lacks"):
        restore({k: v for k, v in tpl.items() if k != "scalar"})
    with pytest.raises(KeyError, match="the template lacks.*'u8/3'"):
        restore({**tpl, "u8": dataclasses.replace(tpl["u8"],
                                                  act_scale=None)})
    # a manifest that claims another dtype than the file holds (a bf16
    # member comes back from numpy as raw '|V2' bytes)
    manifest = json.loads((path / "manifest.json").read_text())
    manifest["leaves"][0]["dtype"] = "bfloat16"
    (path / "manifest.json").write_text(json.dumps(manifest))
    key = manifest["leaves"][0]["key"]
    with pytest.raises(TypeError, match=f"dtype mismatch for '{key}'"):
        restore(tpl)
    # bf16 has no numpy dtype: saving it would not reload
    with pytest.raises(TypeError, match="has no numpy dtype"):
        ckpt.save(tmp_path, 1, {"w": torch.zeros(2, dtype=torch.bfloat16)})


def test_async_checkpointer_snapshots_keeps_and_reraises(tmp_path,
                                                         monkeypatch):
    saver = ckpt.AsyncCheckpointer(tmp_path, keep=2)
    trees = {s: _tree(s) for s in range(1, 5)}
    for s, t in trees.items():
        saver.save_async(s, t)
    saver.wait()
    assert saver.last_saved == 4 and ckpt.list_steps(tmp_path) == [3, 4]
    for s in (3, 4):
        back, _ = ckpt.restore(tmp_path, s, _meta(trees[s]), device="cpu")
        _same(back, trees[s])

    snap = _tree(5)
    saver.save_async(5, snap)
    snap["u8"].payload.zero_()  # the snapshot was taken on this thread
    saver.wait()
    back, _ = ckpt.restore(tmp_path, 5, _meta(snap), device="cpu")
    assert torch.equal(back["u8"].payload, _tree(5)["u8"].payload)

    def full_disk(*_, **__):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(ckpt.np, "savez", full_disk)
    saver.save_async(6, _tree(6))
    with pytest.raises(OSError, match="No space left"):
        saver.wait()
    saver.wait()  # re-raised once, then acknowledged
    monkeypatch.undo()
    saver.save_async(7, _tree(7))
    saver.wait()
    assert ckpt.list_steps(tmp_path) == [5, 7]


# ---------------------------------------------------------------------------
# the config payload
# ---------------------------------------------------------------------------


def test_cfg_fields_split_as_the_jax_package_has_them():
    """Every JAX ArchConfig field is the port's, or named in exactly one
    of the guard's two sets with JAX's default; the port's own fields
    default as JAX's do."""
    jax_fields = {f.name: f.default for f in dataclasses.fields(JArchConfig)}
    ours = {f.name: f.default for f in dataclasses.fields(ArchConfig)}
    lacks = {**tr.FUNCTION_FIELDS, **tr.EXECUTION_FIELDS}
    assert not set(tr.FUNCTION_FIELDS) & set(tr.EXECUTION_FIELDS)
    assert set(ours) | set(lacks) == set(jax_fields)
    assert not set(ours) & set(lacks)
    for k, v in {**ours, **lacks}.items():
        assert jax_fields[k] == v, k


@pytest.mark.parametrize("name", ["efficientvit-b1-r224", "qwen1.5-0.5b",
                                  "llama4-scout-17b-a16e", "dbrx-132b",
                                  "whisper-large-v3"])
def test_cfg_json_equals_the_jax_packages(name):
    jcfg, cfg = JARCHS[name], ARCHS[name]
    want = json.loads(json.dumps(jr._cfg_to_json(jcfg)))
    assert json.loads(json.dumps(tr._cfg_to_json(cfg))) == want
    assert tr._cfg_from_json(want) == cfg
    assert jr._cfg_from_json(tr._cfg_to_json(cfg)) == jcfg


@pytest.mark.parametrize("field,value", [
    ("attn_bf16_mm", True), ("block_pattern", ["rec", "attn"]),
    ("family", "hyena"), ("from_the_future", 1)])
def test_cfg_guard_raises_on_what_changes_the_function(field, value):
    d = json.loads(json.dumps(jr._cfg_to_json(
        JARCHS["qwen1.5-0.5b"])))
    d[field] = value
    with pytest.raises(tr.UnsupportedConfigError, match=field if field !=
                       "family" else "hyena"):
        tr._cfg_from_json(d)


@pytest.mark.parametrize("field,value", [
    ("norm", "layer"), ("n_enc_layers", 32), ("n_audio_ctx", 64)])
def test_cfg_whisper_fields_load_and_round_trip(field, value):
    """The whisper fields are the port's own: a qwen payload carrying any
    of them loads with the value, and writes JAX's JSON back."""
    jcfg = JARCHS["qwen1.5-0.5b"].replace(**{field: value})
    want = json.loads(json.dumps(jr._cfg_to_json(jcfg)))
    cfg = tr._cfg_from_json(want)
    assert getattr(cfg, field) == value
    assert cfg == ARCHS["qwen1.5-0.5b"].replace(**{field: value})
    assert json.loads(json.dumps(tr._cfg_to_json(cfg))) == want
    assert jr._cfg_from_json(tr._cfg_to_json(cfg)) == jcfg


def test_cfg_guard_drops_execution_only_knobs():
    jcfg = JARCHS["qwen1.5-0.5b"].replace(remat_policy="dots",
                                          causal_skip=True,
                                          act_sharding="data")
    assert tr._cfg_from_json(json.loads(json.dumps(
        jr._cfg_to_json(jcfg)))) == ARCHS["qwen1.5-0.5b"]


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def test_synthetic_batches_equal_the_jax_packages():
    ours = pipeline.SyntheticVision(10, 32, noise=0.7)
    theirs = jpipe.SyntheticVision(10, 32, noise=0.7)
    assert ours.templates.tobytes() == theirs.templates.tobytes()
    for step in (0, 10_000, 20_003):
        for a, b in zip(ours.batch(step, 32), theirs.batch(step, 32)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    dcfg = dict(vocab_size=97, seq_len=24, global_batch=8, seed=5)
    lm, jlm = (pipeline.SyntheticLM(pipeline.DataConfig(**dcfg)),
               jpipe.SyntheticLM(jpipe.DataConfig(**dcfg)))
    for step, rank, ranks in ((0, 0, 1), (7, 1, 2)):
        a, b = lm.batch(step, rank, ranks), jlm.batch(step, rank, ranks)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == \
                b[k].tobytes()
    # the proxy's images and calibration batches are these
    x, y = proxy._data().batch(10_000, proxy.BATCH)
    jx, jy = theirs.batch(10_000, 32)
    assert x.tobytes() == jx.tobytes() and y.tobytes() == jy.tobytes()


def test_jax_flatten_order_is_the_ports():
    """``_leaf_paths`` walks a tree in the order (and with the keys) the
    JAX package's ``tree_flatten_with_path`` does."""
    tree = _tree()
    jtree = numpy_to_jax(params_to_numpy(tree))
    assert [k for k, _ in ckpt._leaf_paths(tree)] == \
        [k for k, _ in jckpt._leaf_paths(jtree)]
    assert len(jax.tree_util.tree_leaves(jtree)) == len(
        ckpt._leaf_paths(tree))
    assert jax_to_numpy(jtree).keys() == params_to_numpy(tree).keys()

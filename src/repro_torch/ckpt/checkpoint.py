"""Fault-tolerant checkpointing (twin of ``repro.ckpt.checkpoint``), in the
JAX package's on-disk format byte for byte, so either package restores
the other's checkpoints.

* Layout: ``step_XXXXXXXX/arrays.npz`` with members ``leaf_00000``, ...,
  and ``manifest.json`` = ``{step, extra, leaves: [{key, name, shape,
  dtype, sha256}]}``, leaves in JAX flatten order: dict keys sorted, list
  items by index, a NamedTuple's fields as ``.<name>`` (an optimizer
  state's ``1/.count``, ``1/.m/...``), and a QTensor leaf's array fields
  as its positional children ``<path>/<i>`` (``core.qtensor.CHILDREN``;
  a None child writes nothing and the other indices do not shift).
  ``dtype`` is numpy's name of the array's type; the SHA256 is over its
  C-contiguous bytes.
* Atomic publish: arrays land in ``step_XXXXXXXX.tmp`` first and are
  fsync'd; the manifest is the publish marker (written inside the tmp dir
  via its own tmp file + ``os.replace``; a dir without one is invisible to
  :func:`list_steps`), and the dir publishes by rename.  A crash at any
  point never publishes a torn step.  An overwriting save swaps the old
  step aside (``step_XXXXXXXX.old-tmp``) before it publishes; a crash
  between the two renames leaves the old step complete there, and the
  readers and the next save take it as the step (the JAX package's
  readers do not see it, and its next save deletes it).
* Integrity: per-leaf SHA256 verified on restore
  (:class:`ChecksumMismatchError` names the leaf and both digests); each
  leaf's shape and dtype are checked against the manifest and the
  template.
* Async: :meth:`AsyncCheckpointer.save_async` snapshots to host memory on
  the caller's thread and writes in the background; a failed write
  re-raises from the next ``wait()`` / ``save_async()``.
* Structure comes from a template tree on restore (real or ``meta``
  tensors, QTensor leaves included); the arrays land on ``device``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..core.qtensor import CHILDREN, is_qtensor
from ..core.tree import leaves_with_path, map_with_path

_MANIFEST = "manifest.json"

# torch dtypes a checkpoint holds, by numpy's name (bf16 has none: numpy
# reads a bf16 member back as raw void bytes)
_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64,
             torch.float16: np.float16, torch.int8: np.int8,
             torch.uint8: np.uint8, torch.int16: np.int16,
             torch.int32: np.int32, torch.int64: np.int64,
             torch.bool: np.bool_}


class ChecksumMismatchError(IOError):
    """A restored leaf's bytes do not hash to the manifest's digest:
    on-disk corruption (or a manifest from a different save).  Carries
    the leaf key and both digests so the error names what rotted."""

    def __init__(self, key: str, expected: str, actual: str):
        super().__init__(
            f"checksum mismatch for leaf {key!r}: manifest sha256 "
            f"{expected[:16]}..., file hashes to {actual[:16]}... -- the "
            "checkpoint is corrupt on disk")
        self.key = key
        self.expected = expected
        self.actual = actual


def _fsync_file(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _leaf_paths(tree):
    """(key, array) pairs in JAX flatten order, QTensor leaves expanded
    into their non-None children ``<path>/<i>``."""
    out = []
    for key, leaf in leaves_with_path(tree):
        if is_qtensor(leaf):
            for i, name in enumerate(CHILDREN[type(leaf)]):
                child = getattr(leaf, name)
                if child is not None:
                    out.append((f"{key}/{i}", child))
        elif leaf is not None:
            out.append((key, leaf))
    return out


def _numpy_dtype(dtype) -> np.dtype:
    if isinstance(dtype, torch.dtype):
        if dtype not in _NP_DTYPE:
            raise TypeError(f"{dtype} has no numpy dtype; a checkpoint "
                            "holds float16/32/64, integer and bool arrays")
        return np.dtype(_NP_DTYPE[dtype])
    return np.dtype(dtype)


def _is_dtensor(leaf) -> bool:
    return isinstance(leaf, torch.Tensor) and hasattr(leaf, "full_tensor")


def _to_numpy(leaf) -> np.ndarray:
    if _is_dtensor(leaf):
        # a sharded leaf is saved whole (a collective over its mesh), so
        # either package reads the artifact
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        _numpy_dtype(leaf.dtype)  # names a dtype numpy lacks
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _sha256(arr: np.ndarray) -> str:
    """SHA256 of the array's C-contiguous bytes, hashed in place."""
    flat = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    return hashlib.sha256(flat).hexdigest()


# threads that hash leaves (and read them back) at once: hashlib and
# zlib's CRC release the GIL on large buffers
_IO_THREADS = 8


def _map_arrays(fn, tree):
    """``tree`` with every array -- a float leaf or a QTensor child --
    replaced by ``fn(key, array)``, keys as :func:`_leaf_paths` gives
    them."""
    def visit(key, leaf):
        if is_qtensor(leaf):
            return dataclasses.replace(leaf, **{
                name: fn(f"{key}/{i}", getattr(leaf, name))
                for i, name in enumerate(CHILDREN[type(leaf)])
                if getattr(leaf, name) is not None})
        return None if leaf is None else fn(key, leaf)
    return map_with_path(visit, tree)


def save(ckpt_dir, step: int, tree, extra: Optional[dict] = None) -> Path:
    """Synchronous atomic save of ``tree`` (tensors, numpy arrays and
    QTensor leaves); ``extra`` is any JSON-serialisable dict.  Returns
    the published directory.

    ``DTensor`` leaves (a tree placed on a mesh) are saved whole: every
    rank calls ``save``, each leaf is gathered (``full_tensor()``), rank
    0 alone writes, and every rank returns once it has published.

    Crash-safe at every point: arrays are written and fsync'd before the
    manifest exists, the manifest lands via tmp + ``os.replace``, and an
    existing published step is swapped aside -- never removed in place --
    so an overwriting save that dies midway leaves a complete checkpoint
    (old or new), not a torn one."""
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    paths = _leaf_paths(tree)
    if any(_is_dtensor(leaf) for _, leaf in paths):
        import torch.distributed as dist
        leaves = [(key, _to_numpy(leaf)) for key, leaf in paths]
        if dist.get_rank() == 0:
            _write(ckpt_dir, step, leaves, extra)
        dist.barrier()
        return final
    return _write(ckpt_dir, step,
                  [(key, _to_numpy(leaf)) for key, leaf in paths], extra)


def _write(ckpt_dir: Path, step: int, leaves, extra) -> Path:
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    aside = ckpt_dir / f"step_{step:08d}.old-tmp"
    if aside.exists() and not final.exists():
        os.rename(aside, final)  # a crash mid-swap left the old step aside
    for stale in (tmp, aside):  # debris from a previous crashed save
        if stale.exists():
            shutil.rmtree(stale)
    tmp.mkdir()
    manifest = {"step": step, "extra": extra or {}, "leaves": []}
    with ThreadPoolExecutor(_IO_THREADS) as pool:
        digests = list(pool.map(_sha256, [arr for _, arr in leaves]))
    arrays = {}
    for i, ((key, arr), digest) in enumerate(zip(leaves, digests)):
        name = f"leaf_{i:05d}"
        arrays[name] = arr
        manifest["leaves"].append({
            "key": key, "name": name, "shape": list(arr.shape),
            "dtype": str(arr.dtype), "sha256": digest})
    np.savez(tmp / "arrays.npz", **arrays)
    _fsync_file(tmp / "arrays.npz")
    # the manifest is the publish marker: atomic even within the tmp dir,
    # so a torn manifest write is never mistaken for a complete save
    mtmp = tmp / (_MANIFEST + ".tmp")
    with open(mtmp, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(mtmp, tmp / _MANIFEST)
    if final.exists():
        os.rename(final, aside)  # swap aside, publish, then drop: a
    os.rename(tmp, final)        # crash in between leaves old or new,
    if aside.exists():           # both complete (neither is ever torn)
        shutil.rmtree(aside)
    return final


class AsyncCheckpointer:
    """Snapshot on the caller's thread, write in the background; at most
    one save in flight (a newer request waits for the previous to land).
    ``keep``: the newest steps kept after each save."""

    def __init__(self, ckpt_dir, keep: int = 3):
        self.ckpt_dir = Path(ckpt_dir)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.last_saved: Optional[int] = None

    def wait(self):
        """Block until the in-flight save lands.  A background write that
        failed re-raises here, once: an async checkpointer must not turn
        a full disk into silently missing checkpoints."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save_async(self, step: int, tree, extra: Optional[dict] = None):
        self.wait()  # re-raises a previous failed background save
        host_tree = _map_arrays(   # copies: a CPU tensor's .cpu() is itself
            lambda _, a: a.detach().to("cpu", copy=True)
            if isinstance(a, torch.Tensor) else np.array(a), tree)

        def work():
            try:
                save(self.ckpt_dir, step, host_tree, extra)
                self.last_saved = step
                self._gc()
            except BaseException as e:  # noqa: BLE001 -- re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self):
        for s in list_steps(self.ckpt_dir)[: -self.keep]:
            shutil.rmtree(_step_dir(self.ckpt_dir, s), ignore_errors=True)


def _step_dir(ckpt_dir, step: int) -> Path:
    """The directory holding ``step``'s complete checkpoint: its own, or
    the one an overwriting save swapped aside before it crashed."""
    final = Path(ckpt_dir) / f"step_{step:08d}"
    aside = Path(ckpt_dir) / f"step_{step:08d}.old-tmp"
    if not (final / _MANIFEST).exists() and (aside / _MANIFEST).exists():
        return aside
    return final


def list_steps(ckpt_dir) -> list:
    """The published steps under ``ckpt_dir``, ascending."""
    p = Path(ckpt_dir)
    if not p.exists():
        return []
    out = set()
    for d in p.iterdir():
        m = re.fullmatch(r"step_(\d{8})(\.old-tmp)?", d.name)
        if m and (d / _MANIFEST).exists():
            out.add(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir) -> Optional[int]:
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def read_extra(ckpt_dir, step: int) -> dict:
    """The manifest's ``extra`` payload, without touching the arrays."""
    return json.loads((_step_dir(ckpt_dir, step) / _MANIFEST).read_text()
                      )["extra"]


def restore(ckpt_dir, step: int, template, device="cuda",
            verify: bool = True, shardings=None):
    """Restore into the structure of ``template`` (a tree of tensors --
    ``meta`` ones do -- numpy arrays and QTensor leaves, whose static
    fields are kept) on ``device``.  Each leaf's bytes are checked against
    the manifest's SHA256 (``verify``), and its shape and dtype against
    the manifest and the template; a leaf the template lacks, or the
    checkpoint lacks, raises.  ``shardings``: a matching tree of
    ``dist.sharding.NamedSharding`` (``shardings_from_specs``) -- each
    leaf is read whole and placed as a ``DTensor`` with its placement,
    this rank keeping only its shard, on the mesh's device (``device``
    is then unused).  Returns (tree, extra)."""
    d = _step_dir(ckpt_dir, step)
    manifest = json.loads((d / _MANIFEST).read_text())
    by_key = {rec["key"]: rec for rec in manifest["leaves"]}
    wanted = dict(_leaf_paths(template))
    extra_keys = sorted(set(by_key) - set(wanted))
    if extra_keys:
        raise KeyError(f"checkpoint holds leaves the template lacks: "
                       f"{extra_keys[:5]}")
    device = torch.device(device)
    placed = None
    if shardings is not None:
        from ..dist import sharding as shd
        placed = dict(shd.flat_arrays(shardings))
        missing = sorted(set(wanted) - set(placed))
        if missing:
            raise KeyError(f"shardings lack leaves of the template: "
                           f"{missing[:5]}")

    def load(key):
        tpl = wanted[key]
        if key not in by_key:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        rec = by_key[key]
        # a zip reader of its own: one ZipFile is not safe across threads
        with np.load(d / "arrays.npz") as data:
            arr = data[rec["name"]]
        if verify:
            actual = _sha256(arr)
            if actual != rec["sha256"]:
                raise ChecksumMismatchError(key, rec["sha256"], actual)
        want = _numpy_dtype(tpl.dtype)
        if str(arr.dtype) != rec["dtype"] or arr.dtype != want:
            raise TypeError(
                f"dtype mismatch for {key!r}: file {arr.dtype}, "
                f"manifest {rec['dtype']}, template {want}")
        if tuple(arr.shape) != tuple(rec["shape"]) \
                or tuple(arr.shape) != tuple(tpl.shape):
            raise ValueError(
                f"shape mismatch for {key!r}: ckpt {arr.shape} vs "
                f"template {tuple(tpl.shape)}")
        t = torch.from_numpy(np.require(arr, requirements="C"))
        if placed is not None:
            return shd.place(t, placed[key])
        return t.to(device)

    # leaves read, verified and moved a few at a time; the first failure
    # in flatten order raises
    with ThreadPoolExecutor(_IO_THREADS) as pool:
        loaded = dict(zip(wanted, pool.map(load, wanted)))
    return _map_arrays(lambda key, _: loaded[key], template), \
        manifest["extra"]

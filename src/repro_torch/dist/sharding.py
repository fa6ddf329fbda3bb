"""Sharding rules: canonical tree path + shape -> partition spec (twin of
``repro.dist.sharding``).

Policy (a data + model mesh):

* column-parallel on the ``model`` axis for qkv projections, FFN up/gate,
  lm_head and embeddings (output-channel = last dim);
* row-parallel for the projections that contract a model-sharded axis
  (attn/wo, FFN down) so the pair forms the classic Megatron sandwich;
* expert-parallel on the (stacked) expert axis for MoE expert weights;
* optional FSDP: big tensors additionally shard their first free divisible
  dim over ``data``.

QTensor leaves expand into their children, keyed as a checkpoint keys
them ("layers/attn/wq/0" = payload, "/1" = scale, ...); suffixes are
stripped before rule matching and each child's own shape decides
divisibility -- payloads and per-column scales co-shard on the filter
axis, while int32 index leaves always replicate.  Any indivisible dim
falls back to replication on that dim rather than erroring.

A spec is :class:`P`, a tuple of mesh axis names or ``None`` per tensor
dim (the twin of ``PartitionSpec``, and a leaf of the port's trees).  The
rules read only the mesh's axis sizes, so anything with a ``shape`` dict
(or a ``DeviceMesh`` with ``mesh_dim_names``) serves.  On a real
``torch.distributed.device_mesh.DeviceMesh`` a spec becomes ``DTensor``
placements (:func:`shardings_from_specs`), and :func:`put_global` places
a host tree as ``DTensor`` leaves, each rank keeping only its own shards.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional

import numpy as np
import torch

from ..core.qtensor import CHILDREN, is_qtensor
from ..core.tree import map_with_path

# role patterns matched against the stripped canonical path
_COL_RE = re.compile(
    r"(attn/w[qkv]|mlp/w[13]|shared/w[13]|lm_head|head|embed)$")
_ROW_RE = re.compile(r"(attn/wo|mlp/w2|shared/w2)$")
_EXPERT_RE = re.compile(r"experts/")

# FSDP only pays off above this many elements (small tensors replicate)
_FSDP_MIN_SIZE = 1 << 20


class P(tuple):
    """A partition spec: one mesh axis name (or None) per tensor dim;
    ``P()`` replicates.  A leaf of the port's trees (``TREE_LEAF``)."""

    TREE_LEAF = True

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _strip_child_suffix(path: str) -> str:
    """Drop trailing QTensor child indices: 'layers/attn/wq/0/0' -> '.../wq'."""
    parts = path.split("/")
    while parts and parts[-1].isdigit():
        parts.pop()
    return "/".join(parts)


def _mesh_axes(mesh) -> dict:
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    return dict(zip(mesh.mesh_dim_names, shape))


def _is_wide_int(dtype) -> bool:
    """int/uint of 4+ bytes (numpy's ``kind in "iu" and itemsize >= 4``)."""
    if isinstance(dtype, torch.dtype):
        return (not dtype.is_floating_point and not dtype.is_complex
                and dtype != torch.bool and dtype.itemsize >= 4)
    dt = np.dtype(dtype)
    return dt.kind in "iu" and dt.itemsize >= 4


def spec_for_param(path: str, shape, dtype, mesh,
                   fsdp: bool = False) -> P:
    """Spec for one (possibly QTensor-child) parameter leaf."""
    if _is_wide_int(dtype):
        return P()  # permutation / index leaves: always replicated
    axes = _mesh_axes(mesh)
    shape = tuple(shape)
    ndim = len(shape)
    if ndim == 0:
        return P()
    spec = [None] * ndim
    clean = _strip_child_suffix(path)

    def try_set(dim: int, axis: Optional[str]) -> None:
        if (axis in axes and 0 <= dim < ndim and spec[dim] is None
                and shape[dim] > 1 and shape[dim] % axes[axis] == 0):
            spec[dim] = axis

    if _EXPERT_RE.search(clean):
        try_set(ndim - 3, "model")  # (L, E, K, N) -> E; (E, K, N) -> E
    elif _ROW_RE.search(clean):
        try_set(ndim - 2, "model")
    elif _COL_RE.search(clean):
        try_set(ndim - 1, "model")
    if fsdp and int(np.prod(shape)) >= _FSDP_MIN_SIZE:
        for d in range(ndim):
            if spec[d] is None:
                before = spec[d]
                try_set(d, "data")
                if spec[d] is not before:
                    break
    return P(*spec)


def _map_arrays(fn, tree):
    """``tree`` with every array -- a tensor leaf or a QTensor's non-None
    child -- replaced by ``fn(path, array)``, QTensor children keyed
    ``<path>/<i>`` (their flatten order), other leaves by ``fn(path,
    leaf)`` too."""
    def visit(path, leaf):
        if is_qtensor(leaf):
            return dataclasses.replace(leaf, **{
                name: fn(f"{path}/{i}", getattr(leaf, name))
                for i, name in enumerate(CHILDREN[type(leaf)])
                if getattr(leaf, name) is not None})
        return fn(path, leaf)
    return map_with_path(visit, tree)


def param_specs(params, mesh, fsdp: bool = False):
    """Spec tree mirroring ``params`` (QTensor leaves keep their class,
    a spec in each array field)."""
    def visit(path, leaf):
        if not hasattr(leaf, "shape"):
            return P()
        return spec_for_param(path, leaf.shape,
                              getattr(leaf, "dtype", np.float32), mesh,
                              fsdp=fsdp)

    return _map_arrays(visit, params)


def batch_specs(batch, mesh):
    """Data-parallel batch: leading dim over 'data' when divisible."""
    axes = _mesh_axes(mesh)

    def visit(_, leaf):
        if not hasattr(leaf, "shape") or len(leaf.shape) == 0:
            return P()
        s = [None] * len(leaf.shape)
        if "data" in axes and leaf.shape[0] % axes["data"] == 0:
            s[0] = "data"
        return P(*s)

    return map_with_path(visit, batch)


def cache_specs(cache, mesh, shard_model: bool = False):
    """KV/state cache: batch axis over 'data' (axis 0 for per-slot vectors
    like lengths, axis 1 under the stacked layer dim), optionally heads
    over 'model' for attention caches."""
    axes = _mesh_axes(mesh)

    def visit(_, leaf):
        nd = len(leaf.shape)
        s = [None] * nd
        if nd == 0:
            return P()
        bdim = 0 if nd == 1 else 1
        if "data" in axes and leaf.shape[bdim] % axes["data"] == 0:
            s[bdim] = "data"
        if (shard_model and "model" in axes and nd >= 5
                and leaf.shape[3] % axes["model"] == 0):
            s[3] = "model"  # (L, B, T, H, Dh) heads axis
        return P(*s)

    return map_with_path(visit, cache)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec over a ``DeviceMesh`` (the twin of JAX's ``NamedSharding``):
    ``placements`` are the ``DTensor`` placements, one per mesh dim."""

    mesh: object
    spec: P

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for name in self.mesh.mesh_dim_names:
            dims = [d for d, ax in enumerate(self.spec) if ax == name]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)


def shardings_from_specs(specs, mesh):
    """Spec tree -> :class:`NamedSharding` tree (same structure)."""
    return _map_arrays(lambda _, s: NamedSharding(mesh, s), specs)


def mesh_device(mesh) -> torch.device:
    """This rank's device on ``mesh``: the current CUDA device of a
    ``"cuda"`` mesh, the CPU otherwise."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def local_slice(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's shard of the global ``x`` under ``spec``: each sharded
    dim cut into ``mesh``-axis-size equal pieces (the specs only shard
    divisible dims), the piece at this rank's coordinate kept (a view)."""
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    sizes = _mesh_axes(mesh)
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        n = x.shape[d] // sizes[ax]
        x = x.narrow(d, coord[ax] * n, n)
    return x


def place(x, sharding: NamedSharding):
    """One global host value as a ``DTensor`` on ``sharding``: this rank
    cuts its shard from ``x`` and moves only that to its device (the
    ``distribute_tensor(..., src_data_rank=None)`` contract, without
    moving the whole tensor first: every rank holds the same values)."""
    from torch.distributed.tensor import DTensor
    x = torch.as_tensor(x)
    mesh = sharding.mesh
    local = local_slice(x, sharding.spec, mesh).contiguous().to(
        mesh_device(mesh))
    return DTensor.from_local(local, mesh, sharding.placements,
                              run_check=False)


def put_global(tree, specs, mesh):
    """Place a host-local tree as GLOBAL sharded ``DTensor`` leaves (the
    twin of ``jax.make_array_from_callback`` over every leaf): every rank
    calls this with the same host values and keeps only its own shards.
    On a one-rank mesh every shard is the whole tensor."""
    shardings = dict(_flat(shardings_from_specs(specs, mesh)))
    return _map_arrays(lambda path, x: None if x is None
                       else place(x, shardings[path]), tree)


def _flat(tree):
    out = []
    _map_arrays(lambda path, x: out.append((path, x)), tree)
    return out


def flat_arrays(tree) -> list:
    """(path, array) pairs of ``tree``: its tensor leaves and QTensor
    children in flatten order, keyed as the specs key them."""
    return [(p, x) for p, x in _flat(tree) if x is not None]

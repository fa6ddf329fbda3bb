"""Multi-controller execution over a ``DeviceMesh``: what the port's
engines run where the JAX package relies on GSPMD (the port's own; JAX
has no twin).

The JAX package is single-controller: one program places global arrays
and XLA partitions every op.  The port runs one process per rank, so:

* :class:`MeshRuntime` holds the mesh's ``data`` / ``model`` groups and
  the few collectives the engines issue (sum / max all-reduce, an
  all-gather, an object broadcast from the leader, rank 0).  The backend
  is whatever the process group was initialised with; over ``gloo`` the
  tensors stay on their device (gloo reduces and gathers CUDA tensors).
* :func:`local_params` turns a ``DTensor`` tree placed by
  ``dist.sharding.param_specs`` into the tree a rank computes with: its
  own shards, and around each leaf sharded over ``model`` a
  :class:`Parallel` leaf, which ``nn.dense`` / ``nn.embed`` hand the
  product to (``local_dense`` / ``local_embed``).  The CUDA kernels have
  no ``DTensor`` sharding rule, so each runs on the local shard and the
  leaf adds what GSPMD would: a column-parallel product keeps its output
  columns (its bias sliced to match), a row-parallel one's partial
  products -- each already rounded to the compute dtype by the kernel
  or matmul -- are summed over ``model`` in f32 and cast back, and the
  lm_head's / embedding's columns are gathered over ``model`` (so are
  a single KV head's K / V columns: ``gather_kv``).
* Each MoE layer (a ``{"router", "experts"}`` subtree) becomes an
  :class:`ExpertParallel` leaf, which ``nn.moe_ffn`` hands the layer to
  (``local_moe``): the router replicated, this rank's ``E / model``
  experts of every expert leaf (each QTensor child narrowed along its
  expert axis), and the routing over the step's global rows -- a rank's
  ``data`` rows are gathered first, as the reference routes the whole
  batch -- then every rank runs its experts on the same (E, C, D)
  buffer and the outputs are gathered over ``model``.
* :class:`Lockstep` keeps every rank's host-side decisions equal: the
  leader decides (admission, flushes, evictions, expiries), broadcasts
  each decision before it runs, and the other ranks apply it to their
  own handles, matched by uid (every rank submits the same requests in
  the same order, at whatever wall time).  A collective the ranks do not
  all enter would hang, which is why nobody but the leader decides.
  The others wait for the leader's next decision inside a collective,
  so an idle leader still speaks every :attr:`Lockstep.keepalive_s`
  (a serving daemon's idle wait is capped at it), well inside the
  process group's timeout.
"""
from __future__ import annotations

import dataclasses
import re
import threading
import time
from typing import Optional

import torch

from ..core.qtensor import CHILDREN, is_qtensor, slice_layer
from ..core.tree import map_with_path
from ..nn.layers import dense, embed
from ..serving.scheduler import CANCELLED, TIMED_OUT, end_like
from . import sharding as shd

# a model-sharded leaf whose product must be gathered over ``model``
# (the rest of the column-parallel leaves feed a row-parallel one)
_GATHER_RE = re.compile(r"(lm_head|head|embed)$")
# ... and with ``gather_kv``, the K / V projections of a single KV head
_KV_GATHER_RE = re.compile(r"(lm_head|head|embed|attn/w[kv])$")


class MeshRuntime:
    """One rank's view of a ``("data", "model")`` mesh that spans the
    whole process group."""

    def __init__(self, mesh):
        import torch.distributed as dist
        self.mesh = mesh
        names = tuple(mesh.mesh_dim_names)
        if not set(names) <= {"data", "model"}:
            raise ValueError(f"mesh axes {names}: the engines take a "
                             "('data', 'model') mesh")
        if mesh.size() != dist.get_world_size():
            raise ValueError(f"mesh of {mesh.size()} ranks over a world of "
                             f"{dist.get_world_size()}: the engines' "
                             "mesh spans every process")
        sizes = shd._mesh_axes(mesh)
        coord = dict(zip(names, mesh.get_coordinate()))
        self.n_data = int(sizes.get("data", 1))
        self.n_model = int(sizes.get("model", 1))
        self.data_rank = int(coord.get("data", 0))
        self.model_rank = int(coord.get("model", 0))
        self.rank = dist.get_rank()
        self.size = mesh.size()
        self.leader = self.rank == 0
        self.backend = str(dist.get_backend())
        self.groups = {name: mesh.get_group(name) for name in names}
        self.device = shd.mesh_device(mesh)

    def _group(self, axis: str):
        return self.groups.get(axis)

    def _n(self, axis: str) -> int:
        return self.n_data if axis == "data" else self.n_model

    def all_reduce(self, t: torch.Tensor, axis: str, op: str = "sum"
                   ) -> torch.Tensor:
        """``t`` reduced over ``axis`` (in place; returned)."""
        import torch.distributed as dist
        if self._n(axis) > 1:
            dist.all_reduce(t, op=getattr(dist.ReduceOp, op.upper()),
                            group=self._group(axis))
        return t

    def all_gather(self, t: torch.Tensor, axis: str, dim: int
                   ) -> torch.Tensor:
        """The ``axis`` ranks' ``t`` concatenated along ``dim`` in rank
        order (equal shapes)."""
        import torch.distributed as dist
        if self._n(axis) == 1:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self._n(axis))]
        dist.all_gather(parts, t, group=self._group(axis))
        return torch.cat(parts, dim=dim)

    def broadcast(self, obj):
        """The leader's ``obj`` on every rank (pickled, over the world
        group)."""
        import torch.distributed as dist
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def rows(self, n: int) -> slice:
        """This rank's rows of ``n`` data-sharded rows."""
        per = n // self.n_data
        return slice(self.data_rank * per, (self.data_rank + 1) * per)


# ---------------------------------------------------------------------------
# local execution of a model-sharded tree
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Parallel:
    """A leaf sharded over ``model``: ``leaf`` is this rank's shard (a
    tensor or a QTensor whose static ``shape`` is the shard's), ``role``
    ``"col"`` (output columns) or ``"row"`` (input rows), ``gather``
    whether a column-parallel output is gathered over ``model``."""

    leaf: object
    role: str
    gather: bool
    rt: MeshRuntime

    def local_dense(self, x: torch.Tensor, b) -> torch.Tensor:
        """``nn.dense(x, self.leaf)`` completed as GSPMD would: the bias
        of a column shard sliced to its columns; a row shard's partial
        products (each in the compute dtype) summed over ``model`` in
        f32 and cast back, then the bias."""
        if self.role == "row":
            y = dense(x, self.leaf)
            y = self.rt.all_reduce(y.to(torch.float32), "model").to(y.dtype)
            return y if b is None else y + b.to(y.dtype)
        y = dense(x, self.leaf)
        if b is not None:
            n = y.shape[-1]
            y = y + b.narrow(-1, self.rt.model_rank * n, n).to(y.dtype)
        return self.rt.all_gather(y, "model", -1) if self.gather else y

    def local_embed(self, ids: torch.Tensor) -> torch.Tensor:
        """Column-sharded embedding rows, gathered over ``model``."""
        return self.rt.all_gather(embed(ids, self.leaf), "model", -1)

    def __getitem__(self, i: int) -> "Parallel":
        """Layer ``i`` of a stacked shard (``core.qtensor.slice_layer``)."""
        return dataclasses.replace(self, leaf=slice_layer(self.leaf, i))


@dataclasses.dataclass
class ExpertParallel:
    """One MoE layer on a rank (``nn.moe_ffn`` hands it the layer:
    :meth:`local_moe`): ``router`` replicated; ``experts`` this rank's
    ``E / model`` experts of each expert leaf (all of them on a model
    axis of 1); ``rows``: the layer's input holds this rank's ``data``
    rows of the step (row order: data rank ``r`` owns the ``r``-th
    block), which are gathered before routing, since capacity and each
    choice's position depend on every row of the batch.  False where
    every data rank runs the whole batch (:func:`whole_rows`)."""

    router: object
    experts: dict
    rt: MeshRuntime
    rows: bool

    def local_moe(self, x: torch.Tensor, cfg) -> torch.Tensor:
        """``nn.moe_ffn(x, layer, cfg)`` over the step's global rows:
        gathered over ``data`` (a no-op on one data rank), routed on
        every rank alike, each rank's experts run, this rank's rows
        kept."""
        from ..nn import moe
        gather = self.rows and self.rt.n_data > 1
        xg = self.rt.all_gather(x, "data", 0) if gather else x
        y = moe.dispatch_ffn(xg, self.router, cfg, self._run_experts)
        if not gather:
            return y
        n = x.shape[0]
        return y.narrow(0, self.rt.data_rank * n, n)

    def _run_experts(self, xe: torch.Tensor) -> torch.Tensor:
        """The (E, C, D) buffer -> (E, C, D): this rank's experts on
        their rows, gathered over ``model`` along the expert axis."""
        from ..nn import moe
        if self.rt.n_model == 1:
            return moe.expert_ffn(xe, self.experts)
        n = xe.shape[0] // self.rt.n_model
        ye = moe.expert_ffn(xe.narrow(0, self.rt.model_rank * n, n),
                            self.experts)
        return self.rt.all_gather(ye, "model", 0)

    def __getitem__(self, i: int) -> "ExpertParallel":
        """Layer ``i`` of a stacked layer (``core.qtensor.slice_layer``)."""
        return dataclasses.replace(
            self, router=slice_layer(self.router, i),
            experts={k: slice_layer(v, i) for k, v in self.experts.items()})


def _role(path: str, spec, rt: MeshRuntime) -> Optional[str]:
    clean = shd._strip_child_suffix(path)
    if "model" not in spec or rt.n_model == 1:
        return None
    if shd._EXPERT_RE.search(clean):
        return "expert"
    if shd._ROW_RE.search(clean):
        return "row"
    return "col"


def _local(x):
    return x.to_local() if hasattr(x, "to_local") else x


def local_params(params, specs, rt: MeshRuntime, gather_kv: bool = False):
    """This rank's compute tree of a ``DTensor`` tree placed by
    ``specs``: local shards, each model-sharded leaf wrapped in
    :class:`Parallel`, each MoE layer in :class:`ExpertParallel` (on a
    mesh of more than one rank).  ``gather_kv``: the K / V projections'
    columns are gathered over ``model`` (one KV head, cut by the
    column rule, that every rank's query heads read whole:
    :func:`kv_gathered`).  Raises ``ValueError`` where the children of
    one QTensor leaf are not sharded alike (a product of mismatched
    shards would be wrong)."""
    flat_specs = dict(shd.flat_arrays(specs))
    gathered = _KV_GATHER_RE if gather_kv else _GATHER_RE

    def visit(path, leaf):
        if is_qtensor(leaf):
            kids = [(f"{path}/{i}", name) for i, name in
                    enumerate(CHILDREN[type(leaf)])
                    if getattr(leaf, name) is not None]
            roles = {_role(k, flat_specs[k], rt) for k, _ in kids}
            if "expert" in roles:
                return _local_experts(path, leaf, kids, flat_specs, rt)
            loc = dataclasses.replace(leaf, **{
                name: _local(getattr(leaf, name)) for _, name in kids})
            role = _qtensor_role(path, leaf, kids, flat_specs, roles)
            if role is None:
                return loc
            shape = list(leaf.shape)
            dim = len(shape) - (1 if role == "col" else 2)
            shape[dim] //= rt.n_model
            loc = dataclasses.replace(loc, shape=tuple(shape))
        else:
            if not isinstance(leaf, torch.Tensor):
                return leaf
            role = _role(path, flat_specs.get(path, shd.P()), rt)
            loc = _local(leaf)
            if role in (None, "expert"):
                return loc
        return Parallel(loc, role, bool(gathered.search(path)), rt)

    tree = map_with_path(visit, params)
    return _wrap_moe(tree, rt) if rt.size > 1 else tree


def _wrap_moe(tree, rt: MeshRuntime):
    """Every ``{"router", "experts", ...}`` node of ``tree`` as an
    :class:`ExpertParallel` leaf (rows gathered over ``data``)."""
    if not isinstance(tree, dict):
        return tree
    if "router" in tree and "experts" in tree:
        return ExpertParallel(tree["router"], tree["experts"], rt,
                              rows=True)
    return {k: _wrap_moe(v, rt) for k, v in tree.items()}


def whole_rows(tree):
    """``tree`` (from :func:`local_params`) for a pass in which every
    data rank runs the whole batch (a prefill group): its MoE layers
    route the rows they are given, gathering nothing; None where the
    tree has no MoE layer on a data axis > 1 (no layer couples the
    rows)."""
    found = []

    def visit(node):
        if isinstance(node, ExpertParallel) and node.rt.n_data > 1:
            found.append(node)
            return dataclasses.replace(node, rows=False)
        if isinstance(node, dict):
            return {k: visit(v) for k, v in node.items()}
        return node
    out = visit(tree)
    return out if found else None


def _local_experts(path, leaf, kids, specs, rt: MeshRuntime):
    """This rank's experts ``[r E/m, (r+1) E/m)`` of an expert QTensor
    (``(L, E, K, N)`` or ``(E, K, N)``).  The rule places each child by
    its own rank, so each child's expert axis is found from the leaf's
    (``len(leaf.shape) - 3``, counted from the left: the children share
    the leading dims): a child sharded there is already this rank's; a
    replicated child with the E experts there is narrowed to them; one
    of size 1 there (the per-layer activation scale) stays whole.
    Raises ``ValueError`` for a child sharded over ``model`` on another
    axis."""
    axis = len(leaf.shape) - 3
    E = leaf.shape[axis]
    n = E // rt.n_model
    fields = {}
    for key, name in kids:
        spec, loc = specs[key], _local(getattr(leaf, name))
        placed = len(spec) > axis and spec[axis] == "model"
        if "model" in spec and not placed:
            raise ValueError(f"{key}: spec {spec} shards another axis than "
                             f"the experts' ({axis}) of {path}")
        if not placed and loc.ndim > axis and loc.shape[axis] == E:
            loc = loc.narrow(axis, rt.model_rank * n, n)
        fields[name] = loc
    shape = list(leaf.shape)
    shape[axis] = n
    return dataclasses.replace(leaf, shape=tuple(shape), **fields)


def _qtensor_role(path, leaf, kids, specs, roles) -> Optional[str]:
    """The one role a QTensor leaf's children agree on: every child with
    more than one entry along the sharded dim must be sharded there."""
    roles.discard(None)
    if not roles:
        return None
    role = roles.pop()
    for key, name in kids:
        child = getattr(leaf, name)
        spec = specs[key]
        dim = child.ndim - (1 if role == "col" else 2)
        if dim >= 0 and child.shape[dim] > 1 and (
                len(spec) <= dim or spec[dim] != "model"):
            raise ValueError(
                f"{key}: shape {tuple(child.shape)} spec {spec} is not "
                f"sharded like the rest of {path} ({role}-parallel)")
    return role


def kv_gathered(cfg, rt: MeshRuntime) -> bool:
    """Whether a rank computes the K / V projections' columns whole (a
    single KV head that the model axis does not divide, which
    :func:`local_config` admits for the MoE LMs and recurrentgemma):
    gathered over ``model``, the KV cache replicated over it, as the
    reference's ``cache_specs`` shards heads only where divisible."""
    return rt.n_model > 1 and cfg.n_kv_heads % rt.n_model != 0


def local_config(cfg, rt: MeshRuntime):
    """The config a rank computes with: its query heads on ``model`` (the
    weights' shards) and its KV heads (all of a single KV head:
    :func:`kv_gathered`), everything else as given.

    * ``dense_lm``: the model axis must divide the query and KV heads,
      the FFN, the model width and the vocab;
    * ``moe_lm``: the same, and the experts and the expert FFN, except
      that a single KV head is gathered;
    * ``recurrentgemma``: the heads (a single KV head gathered), the FFN,
      the width and the vocab (the recurrence blocks replicate);
    * ``rwkv``: the vocab (only the embedding and the lm_head shard).

    Raises ``ValueError`` where one of these does not divide, or
    ``NotImplementedError`` for whisper (ROADMAP A10d)."""
    m = rt.n_model
    if m == 1:
        return cfg
    fam = cfg.family
    if fam not in ("dense_lm", "moe_lm", "rwkv", "recurrentgemma"):
        raise NotImplementedError(
            f"{cfg.name}: model-sharded serving of the {fam} family is not "
            "ported (ROADMAP A10d: its sharded steps exist only in the "
            "reference's dry-run); use a mesh whose model axis is 1")
    checks = [("padded_vocab", cfg.padded_vocab)]
    if fam != "rwkv":
        checks += [("n_heads", cfg.n_heads), ("d_ff", cfg.d_ff),
                   ("d_model", cfg.d_model)]
        if fam == "dense_lm" or cfg.n_kv_heads != 1:
            checks.append(("n_kv_heads", cfg.n_kv_heads))
    if fam == "moe_lm":
        checks += [("moe_experts", cfg.moe_experts),
                   ("moe_d_ff", cfg.moe_d_ff or cfg.d_ff)]
    for what, n in checks:
        if n % m:
            raise ValueError(f"{cfg.name}: {what}={n} does not divide "
                             f"over a model axis of {m}")
    if fam == "rwkv":
        return cfg
    return cfg.replace(n_heads=cfg.n_heads // m,
                       n_kv_heads=cfg.n_kv_heads if kv_gathered(cfg, rt)
                       else cfg.n_kv_heads // m)


def place_tree(tree, specs, mesh):
    """``put_global`` of a host tree; a tree already of ``DTensor``
    leaves is checked against ``specs`` instead (its placements must be
    theirs) and kept."""
    arrays = shd.flat_arrays(tree)
    if arrays and all(hasattr(x, "placements") for _, x in arrays):
        want = dict(shd.flat_arrays(shd.shardings_from_specs(specs, mesh)))
        for path, x in arrays:
            if tuple(x.placements) != tuple(want[path].placements):
                raise ValueError(f"{path}: placed {x.placements}, its spec "
                                 f"wants {want[path].placements}")
        return tree
    return shd.put_global(tree, specs, mesh)


# ---------------------------------------------------------------------------
# the leader's decisions, followed
# ---------------------------------------------------------------------------


# how long a rank waits for its own submit of a request rank 0 decided
AWAIT_S = 600.0

# the longest an idle leader leaves the other ranks waiting in its
# broadcast (capped at a quarter of the process group's timeout)
KEEPALIVE_S = 60.0


def group_timeout_s(device) -> Optional[float]:
    """The world process group's collective timeout, in seconds, on
    ``device``'s backend (None where this torch does not say)."""
    import torch.distributed as dist
    try:
        backend = dist.group.WORLD._get_backend(torch.device(device))
        return backend.options._timeout.total_seconds()
    except (AttributeError, RuntimeError):
        return None


class Lockstep:
    """The leader broadcasts each decision before it acts on it; the
    others receive and apply them in order.  ``handles`` maps uid ->
    handle of every request this rank has submitted and not yet seen
    decided (what :meth:`await_handles` reads).  The other ranks keep
    no deadlines: every message of rank 0's carries the requests that
    ended there without a result since its last one (timed out or
    cancelled), and the others end theirs alike (:meth:`mirror`)."""

    def __init__(self, rt: MeshRuntime):
        self.rt = rt
        self.handles = {}
        self.stopped = False
        # uid -> (state, message) of rank 0's requests that ended before
        # their submit reached this rank; uids grow with every submit, so
        # one at or below the last noted was submitted here already
        self._ended = {}
        self._last_uid = -1
        # rank 0: (uid, state, message) of requests that ended without a
        # result since its last message
        self._log = []
        self._lock = threading.Lock()  # submit thread vs serve thread

    @property
    def leader(self) -> bool:
        return self.rt.leader

    @property
    def follows(self) -> bool:
        """A rank other than 0 that rank 0 has not released: it must keep
        stepping (waiting in rank 0's broadcast), or rank 0's next
        collective hangs."""
        return not self.leader and not self.stopped

    @property
    def keepalive_s(self) -> float:
        """How long rank 0 may idle before it speaks again (an empty
        step), so the others' wait stays inside the group's timeout."""
        t = group_timeout_s(self.rt.device)
        return KEEPALIVE_S if t is None else min(KEEPALIVE_S, t / 4.0)

    def release(self) -> None:
        """Rank 0: tell the other ranks that no step follows (their steps
        return at once from then on).  A no-op elsewhere."""
        if self.leader and not self.stopped:
            self.share(("stop",))
            self.stopped = True

    def note(self, handle, requeued: bool = False) -> None:
        """A new (or ``requeued``) handle.  Rank 0 logs how it ends if it
        ends without a result; elsewhere it waits for rank 0's decision,
        and one that rank 0 already ended ends at once, alike."""
        if self.leader:
            if not requeued:
                handle.add_done_callback(self._log_end)
            return
        with self._lock:
            self._last_uid = max(self._last_uid, handle.uid)
            ended = self._ended.pop(handle.uid, None)
            if ended is None:
                self.handles[handle.uid] = handle
        if ended is not None:
            end_like(handle, *ended)

    def _log_end(self, handle) -> None:
        if handle.state in (TIMED_OUT, CANCELLED):
            with self._lock:
                self._log.append((handle.uid, handle.state,
                                  str(handle.exception())))

    def mirror(self, ended) -> None:
        """Rank 0's requests that ended without a result -- ``(uid,
        state, message)`` -- end alike here, now or at their submit (one
        already admitted here ends with its slot, by rank 0's sweep)."""
        for uid, state, msg in ended:
            with self._lock:
                h = self.handles.pop(uid, None)
                if h is None and uid > self._last_uid:
                    self._ended[uid] = (state, msg)
            if h is not None:
                end_like(h, state, msg)

    def share(self, msg):
        """Leader: broadcast ``msg``; others: the leader's next one.  The
        requests rank 0 ended since its last message go with it."""
        if self.leader:
            with self._lock:
                ended, self._log = self._log, []
            self.rt.broadcast((msg, ended))
            return msg
        msg, ended = self.rt.broadcast(None)
        self.mirror(ended)
        return msg

    def await_handles(self, uids):
        """This rank's handles for the leader's ``uids``, waiting (up to
        ``AWAIT_S``) for submits that have not arrived yet."""
        deadline = time.monotonic() + AWAIT_S
        while True:
            with self._lock:
                missing = [u for u in uids if u not in self.handles]
                if not missing:
                    return [self.handles.pop(u) for u in uids]
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"rank {self.rt.rank}: requests {missing} were decided "
                    f"on rank 0 but never submitted here within "
                    f"{AWAIT_S:.0f} s (every rank submits the same "
                    "requests in the same order)")
            time.sleep(1e-3)


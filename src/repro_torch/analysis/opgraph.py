"""The port's op graph: one eager hot path recorded as a def-use graph
(the port's counterpart of ``repro.launch.hlo_analysis.Graph``, which
parses XLA's optimized HLO; the port has no HLO).

:func:`record` runs a function under a :class:`Recorder`, a
``TorchDispatchMode`` that logs each aten op as a :class:`Node`: the op,
the ids of its input and output tensors (:class:`Value`: dtype, shape,
device), the port's source site that issued it, and the loop label it
ran under (:meth:`Recorder.loop`; the decode step is the loop body that
JAX's while bodies stand for).  A tensor keeps its value id as an
attribute; an in-place op gives the tensor (and the base a view of it
shares storage with) a new id, produced by that op.

The CUDA kernels are ``ctypes`` calls the dispatcher never sees, so each
entry point in ``kernels/ops.py`` records one *kernel node* itself
(:func:`kernel_node`), saying whether the kernel or its plain version
ran; the aten ops of a plain version run inside that node and are folded
into it, so a CPU graph is the card's graph.  ``core.quant.int_einsum``
(an exact integer contraction: int32 on the CPU, float64 on CUDA) is
folded the same way into a *composite* node.

The trace's argument tree is seeded first (:meth:`Recorder.seed`): each
tensor leaf -- each non-None child of a QTensor leaf -- is a parameter
value named by its path, spelled as JAX's ``_path_str`` spells it
(``0/stages/1/0/msa/w_agg/0``: argument 0, the leaf's child 0).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
import os
import sys
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

_DT = {torch.float32: "f32", torch.float64: "f64", torch.float16: "f16",
       torch.bfloat16: "bf16", torch.int8: "s8", torch.int16: "s16",
       torch.int32: "s32", torch.int64: "s64", torch.uint8: "u8",
       torch.bool: "pred", torch.complex64: "c64",
       torch.complex128: "c128"}


def dtype_str(dt: torch.dtype) -> str:
    """HLO's spelling of a torch dtype (``f32``, ``bf16``, ``s8``, ...)."""
    return _DT.get(dt, str(dt).replace("torch.", ""))


def is_float_dtype(dt: str) -> bool:
    return dt.startswith(("f", "bf"))


def is_int_dtype(dt: str) -> bool:
    return dt.startswith(("s", "u"))


@dataclasses.dataclass
class Value:
    """One tensor value: a parameter leaf (``param`` its path), an op's
    output (``producer`` the node index), or a constant made outside the
    trace (neither)."""

    vid: int
    dtype: str
    shape: Tuple[int, ...]
    device: str
    producer: Optional[int] = None
    param: Optional[str] = None


@dataclasses.dataclass
class Node:
    """One op: an aten op (``kind`` ``"aten"``, ``op`` its name without
    the namespace or overload), a kernel entry point (``"kernel"``,
    ``ran`` ``"kernel"`` or ``"plain"``) or a composite contraction
    (``"composite"``); ``folded`` counts the aten ops run inside it."""

    idx: int
    op: str
    kind: str
    inputs: Tuple[int, ...]
    outputs: Tuple[int, ...]
    site: str = ""
    loop: Optional[str] = None
    ran: Optional[str] = None
    folded: int = 0


class Graph:
    """Def-use view over recorded nodes and values: ``consumers[vid]``
    (node indices reading a value) and ``params`` (path -> value id, in
    seeding order)."""

    def __init__(self, nodes: Sequence[Node], values: Dict[int, Value]):
        self.nodes = list(nodes)
        self.values = dict(values)
        self.consumers: Dict[int, List[int]] = {}
        for n in self.nodes:
            for v in dict.fromkeys(n.inputs):
                self.consumers.setdefault(v, []).append(n.idx)
        self.params = {v.param: v.vid for v in self.values.values()
                       if v.param is not None}

    def dtype_of(self, vid: int) -> str:
        return self.values[vid].dtype

    def producer(self, vid: int) -> Optional[Node]:
        p = self.values[vid].producer
        return None if p is None else self.nodes[p]

    def kernel_nodes(self) -> List[Node]:
        return [n for n in self.nodes if n.kind == "kernel"]

    def loop_nodes(self) -> List[Node]:
        return [n for n in self.nodes if n.loop is not None]

    def op_histogram(self) -> Dict[str, int]:
        """{op: count} over the nodes (kernel nodes by kernel name)."""
        out: Dict[str, int] = {}
        for n in self.nodes:
            out[n.op] = out.get(n.op, 0) + 1
        return out


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_opgraph_recorder", default=None)
_SERIAL = itertools.count(1)
_TAG = "_qlint_vid"
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__))) + os.sep
# frames that never name a site: the recorder and the kernel entry points
# (a kernel node's site is the code that called the entry point)
_SKIP = tuple(os.path.join(_PKG, p) for p in (
    os.path.join("analysis", "opgraph.py"), os.path.join("kernels", "ops.py")))
_SITES: Dict[object, Optional[str]] = {}

# ops whose output depends on an input's shape only, never its values
_SHAPE_ONLY = frozenset({
    "zeros_like", "ones_like", "empty_like", "full_like", "rand_like",
    "randn_like", "randint_like", "new_zeros", "new_ones", "new_empty",
    "new_full", "new_empty_strided"})


def _site() -> str:
    f = sys._getframe(1)
    while f is not None:
        code = f.f_code
        if code not in _SITES:
            fn = code.co_filename
            _SITES[code] = (f"{fn[len(_PKG):]}:{code.co_name}"
                            .replace(os.sep, "/")
                            if fn.startswith(_PKG) and not fn.startswith(_SKIP)
                            else None)
        if _SITES[code] is not None:
            return _SITES[code]
        f = f.f_back
    return ""


def param_leaves(args) -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every tensor leaf of ``args`` in flattening
    order: a QTensor leaf's non-None children as ``<path>/<i>`` (JAX's
    ``_path_str`` of ``tree_flatten_with_path``), a model-sharded
    ``Parallel`` leaf by its shard."""
    from ..core.qtensor import CHILDREN, is_qtensor
    from ..core.tree import leaves_with_path
    for path, leaf in leaves_with_path(args):
        if hasattr(leaf, "leaf") and hasattr(leaf, "role"):
            leaf = leaf.leaf
        if is_qtensor(leaf):
            for i, name in enumerate(CHILDREN[type(leaf)]):
                child = getattr(leaf, name)
                if child is not None:
                    yield f"{path}/{i}", child
        elif isinstance(leaf, torch.Tensor):
            yield path, leaf


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


class _Handle:
    """What :func:`kernel_node` yields: ``out(y)`` records ``y`` (a tensor
    or a tuple of them) as the node's output and returns it."""

    def __init__(self, module=None):
        self.launches = getattr(module, "launches", 0)
        self.outputs: tuple = ()

    def out(self, y):
        self.outputs = tuple(_tensors(y))
        return y


class _Noop:
    """The handle outside a recording: ``out`` only returns ``y``."""

    @staticmethod
    def out(y):
        return y


_NOOP = _Noop()


class Recorder(TorchDispatchMode):
    """Records every aten op dispatched while it is entered (see the
    module docstring); :meth:`graph` is the result."""

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # nothing records under torch.compile: leaving __torch_dispatch__
        # unwrapped keeps torch._dynamo (and what its import sets in the
        # environment) out of the process
        return False

    def __init__(self):
        super().__init__()
        self.serial = next(_SERIAL)
        self.nodes: List[Node] = []
        self.values: Dict[int, Value] = {}
        self._fold = 0
        self._folded = 0
        self._loop: Optional[str] = None

    # -- values --------------------------------------------------------------

    def _new(self, t: torch.Tensor, producer=None, param=None) -> int:
        vid = len(self.values)
        self.values[vid] = Value(vid, dtype_str(t.dtype), tuple(t.shape),
                                 t.device.type, producer, param)
        setattr(t, _TAG, (self.serial, vid))
        return vid

    def vid(self, t: torch.Tensor) -> int:
        """``t``'s value id (a constant value for a tensor made outside
        the trace)."""
        tag = getattr(t, _TAG, None)
        if tag is not None and tag[0] == self.serial:
            return tag[1]
        return self._new(t)

    def seed(self, args) -> None:
        """Name every tensor leaf of ``args`` by its path
        (:func:`param_leaves`)."""
        for path, t in param_leaves(args):
            tag = getattr(t, _TAG, None)
            if tag is None or tag[0] != self.serial:
                self._new(t, param=path)

    # -- nodes ---------------------------------------------------------------

    def _node(self, op, kind, inputs, outputs, producer_of, ran=None,
              folded=0, site=None) -> Node:
        """Append a node reading ``inputs`` (tensors); ``outputs`` are
        fresh tensors, ``producer_of`` tensors whose new version it
        writes."""
        node = Node(len(self.nodes), op, kind,
                    tuple(self.vid(t) for t in inputs), (),
                    site if site is not None else _site(), self._loop, ran,
                    folded)
        self.nodes.append(node)
        outs = []
        for t in producer_of:
            outs.append(self._new(t, producer=node.idx))
            base = t._base
            if base is not None:
                outs.append(self._new(base, producer=node.idx))
        seen = {id(t) for t in producer_of}
        for t in outputs:
            if id(t) not in seen:
                seen.add(id(t))
                outs.append(self._new(t, producer=node.idx))
        node.outputs = tuple(outs)
        return node

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._fold:
            self._folded += 1
            return out
        name = func.overloadpacket.__name__
        schema = func._schema
        written = []
        for i, a in enumerate(schema.arguments):
            if a.alias_info is not None and a.alias_info.is_write:
                v = args[i] if i < len(args) else kwargs.get(a.name)
                written += _tensors(v)
        inputs = [] if name in _SHAPE_ONLY else _tensors((args, kwargs))
        self._node(name, "aten", inputs, _tensors(out), written)
        return out

    @contextlib.contextmanager
    def loop(self, label: str):
        """Ops recorded inside run in the loop body ``label``."""
        prev, self._loop = self._loop, label
        try:
            yield
        finally:
            self._loop = prev

    @contextlib.contextmanager
    def fold(self, name: str, kind: str, module, inputs):
        """One node for everything run inside (see :func:`kernel_node`)."""
        if self._fold:
            self._fold += 1
            try:
                yield _NOOP
            finally:
                self._fold -= 1
            return
        site = _site()
        h = _Handle(module)
        self._fold, self._folded = 1, 0
        try:
            yield h
        finally:
            self._fold = 0
        ran = None
        if module is not None:
            ran = "kernel" if module.launches > h.launches else "plain"
        self._node(name, kind, _tensors(inputs), h.outputs, (), ran=ran,
                   folded=self._folded, site=site)

    def graph(self) -> Graph:
        return Graph(self.nodes, self.values)


def active() -> Optional[Recorder]:
    return _ACTIVE.get()


@contextlib.contextmanager
def record(args=None, loop: Optional[str] = None) -> Iterator[Recorder]:
    """Record the ops run inside; ``args`` (a tree) is seeded first, and
    ``loop`` labels every op as in that loop body."""
    rec = Recorder()
    if args is not None:
        rec.seed(args)
    token = _ACTIVE.set(rec)
    try:
        with rec, (rec.loop(loop) if loop else contextlib.nullcontext()):
            yield rec
    finally:
        _ACTIVE.reset(token)


@contextlib.contextmanager
def kernel_node(name: str, module, inputs: Sequence):
    """Around one kernel entry point: while a recorder is active, the
    call becomes one node named ``name`` reading ``inputs``, whose output
    is what the yielded handle's ``out`` is given; ``module``'s
    ``launches`` counter says whether the kernel ran (else its plain
    version, whose ops are folded in).  A no-op otherwise."""
    rec = _ACTIVE.get()
    if rec is None:
        yield _NOOP
        return
    with rec.fold(name, "kernel", module, inputs) as h:
        yield h


@contextlib.contextmanager
def composite_node(name: str, inputs: Sequence):
    """Like :func:`kernel_node` for a composite op of the port's own
    (``int_einsum``): one node, its aten ops folded in."""
    rec = _ACTIVE.get()
    if rec is None:
        yield _NOOP
        return
    with rec.fold(name, "composite", None, inputs) as h:
        yield h

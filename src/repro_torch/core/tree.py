"""Parameter trees: nested dicts/lists/tuples whose leaves are tensors or
QTensor leaves.  Paths are the JAX package's strings (dict keys and list
indices joined by '/', e.g. ``stages/3/0/msa/w_qkv``; a NamedTuple's
fields by ``.<name>``, as ``jax.tree_util`` names a ``GetAttrKey``, e.g.
``1/.m/embed`` in a ``(params, AdamWState)`` tree), visited in the order
JAX flattens them (dict keys sorted, NamedTuple fields in declaration
order), so ``QUANT_RULES``, calibration stores, layer reports and
checkpoint keys match across the two packages."""
from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, Tuple

import torch


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _is_node(tree) -> bool:
    """A list or tuple walked into; a tuple type that says ``TREE_LEAF``
    (``dist.sharding.P``, the twin of a ``PartitionSpec``) is a leaf."""
    return isinstance(tree, (list, tuple)) and not getattr(
        tree, "TREE_LEAF", False)


def _children(tree):
    """(key, child) pairs of a tuple or list: a NamedTuple's fields as
    ``.<name>``, any other sequence's items by index."""
    if _is_namedtuple(tree):
        return [(f".{name}", getattr(tree, name)) for name in tree._fields]
    return [(str(i), v) for i, v in enumerate(tree)]


def map_with_path(fn: Callable[[str, Any], Any], tree, _path: Tuple = ()):
    """Rebuild ``tree`` with every leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k], _path + (str(k),))
                for k in sorted(tree)}
    if _is_node(tree):
        children = [map_with_path(fn, v, _path + (k,))
                    for k, v in _children(tree)]
        if _is_namedtuple(tree):
            return type(tree)(*children)
        return type(tree)(children)
    return fn("/".join(_path), tree)


def leaves_with_path(tree, _path: Tuple = ()) -> Iterator[Tuple[str, Any]]:
    """(path, leaf) pairs in flattening order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], _path + (str(k),))
    elif _is_node(tree):
        for k, v in _children(tree):
            yield from leaves_with_path(v, _path + (k,))
    else:
        yield "/".join(_path), tree


def unflatten(template, leaves: Iterable):
    """The tree of ``template``'s structure whose leaves, in flattening
    order, are ``leaves`` (twin of ``jax.tree_util.tree_unflatten``); the
    count must match."""
    it = iter(leaves)
    sentinel = object()

    def take(path, _):
        leaf = next(it, sentinel)
        if leaf is sentinel:
            raise ValueError(f"too few leaves: none left for {path!r}")
        return leaf

    out = map_with_path(take, template)
    if next(it, sentinel) is not sentinel:
        raise ValueError("more leaves than the template holds")
    return out


def device_of(tree):
    """The device of the first tensor (or QTensor field) in ``tree``."""
    for _, leaf in leaves_with_path(tree):
        t = leaf if isinstance(leaf, torch.Tensor) else \
            getattr(leaf, "payload", getattr(leaf, "codes", None))
        if isinstance(t, torch.Tensor):
            return t.device
    raise ValueError("parameter tree holds no tensor")

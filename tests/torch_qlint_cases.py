"""Helpers the port's qlint tests share: a leak check around every test
that touches the JAX package, handcrafted op graphs, and the traces the
parity files compare (recorded once per process).

The port's qlint tests are spread over several files of at most four
tests each.  pytest-xdist's ``--dist loadfile`` hands files out largest
first, so files this small are handed out after every file of the JAX
package's suite and cannot change which of those share a worker."""
import os

import pytest
import torch

import torch_parity  # noqa: F401 -- one intra-op thread for the process

from repro_torch.analysis import opgraph as G
from repro_torch.analysis.rules import Trace


def _jax_state():
    import jax

    from repro.kernels import ops as jops
    env = {k: v for k, v in os.environ.items()
           if k != "PYTEST_CURRENT_TEST"}  # pytest's own, per phase
    return {"trip_counts()": jops.trip_counts(), "os.environ": env,
            "jax_enable_x64": bool(jax.config.jax_enable_x64)}


@pytest.fixture
def jax_leak_check():
    """Fails the test if it changed the JAX package's process state:
    the dispatch trip latch, the environment, or ``jax_enable_x64``."""
    before = _jax_state()
    yield
    after = _jax_state()
    for what, b in before.items():
        a = after[what]
        if isinstance(b, dict):
            changed = sorted(k for k in set(a) | set(b) if a.get(k) != b.get(k))
            assert not changed, f"the test changed {what}: {changed}"
        assert a == b, f"the test changed {what}: {b!r} -> {a!r}"


class GraphBuilder:
    """A handcrafted op graph: ``param`` and ``op`` return value ids."""

    def __init__(self):
        self.values = {}
        self.nodes = []

    def _value(self, dtype, shape, producer=None, param=None, device="cpu"):
        vid = len(self.values)
        self.values[vid] = G.Value(vid, dtype, tuple(shape), device,
                                   producer, param)
        return vid

    def param(self, path, dtype="f32", shape=(4, 8)):
        return self._value(dtype, shape, param=path)

    def op(self, op, *inputs, dtype="f32", shape=(4, 8), kind="aten",
           loop=None, ran=None, site="seeded.py:f", device="cpu"):
        idx = len(self.nodes)
        out = self._value(dtype, shape, producer=idx, device=device)
        self.nodes.append(G.Node(idx, op, kind, tuple(inputs), (out,),
                                 site, loop, ran))
        return out

    def trace(self, name="seeded", **meta):
        return Trace(name=name, graph=G.Graph(self.nodes, self.values),
                     meta=meta)


def rule_paths(violations, rules=None):
    """{(rule, path)} of ``violations`` (of ``rules`` only, if given)."""
    return {(v.rule, v.path) for v in violations
            if rules is None or v.rule in rules}


def cpu_traces(arch, **kw):
    """The port's qlint traces of a reduced config on the CPU."""
    from repro_torch.analysis import traces as T
    return T.registry_traces(arch, device="cpu", **kw)


def tiny_qtensor(seed=3, act=False):
    """A (32, 16) 8-bit QUniform from the port's quantizer (calibrated:
    with an activation scale)."""
    import numpy as np

    from repro_torch.core.qtensor import QUniform
    w = torch.from_numpy(np.random.default_rng(seed).normal(
        0, 0.1, (32, 16)).astype(np.float32))
    return QUniform.quantize(w, bits=8, act_max_abs=(
        torch.tensor(3.0) if act else None))

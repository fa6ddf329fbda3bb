"""The port's qlint verdicts with every kernel-dispatch axis off against
the JAX package's (``trace_fn(..., dispatch=False)`` + ``run_rules``, no
Pallas launch): the reduced EfficientViT-B1's m2q and uniform8 forwards
and the reduced qwen1.5-0.5b's uniform8 prefill and decode.  The
(rule, parameter path) sets are equal for the four path-keyed rules but
for the differences named below (``docs/qlint_torch.md``); the
``unguarded-act-quant`` rule, which JAX keys by fusion name and the port
by source site, fires on the same traces."""
import functools

import pytest

from torch_qlint_cases import jax_leak_check, rule_paths  # noqa: F401

from repro_torch.analysis import run_rules
from repro_torch.analysis import traces as T
from repro_torch.core.qtensor import QM2Q
from repro_torch.core.tree import leaves_with_path

PATH_RULES = ("no-dequant-matmul", "no-gather-concat", "conv-budget",
              "no-f32-dot")
CASES = {"efficientvit-b1-r224": ("m2q-w8a8", "uniform8"),
         "qwen1.5-0.5b": ("uniform8",)}
TRACES = ["efficientvit-b1-r224/m2q/forward",
          "efficientvit-b1-r224/u8/forward",
          "qwen1.5-0.5b/u8/prefill", "qwen1.5-0.5b/u8/decode"]


def _m2q_payloads(args):
    return {("no-dequant-matmul", f"{path}/0")
            for path, leaf in leaves_with_path(args)
            if isinstance(leaf, QM2Q)}


# (rule, path) only one side finds, per trace, and why
JAX_ONLY = {
    # JAX's plain M2Q matmul decodes the APoT codes to f32 and contracts
    # them in an f32 dot (the SAT engine); the port decodes them to
    # integer units of 2^-7 and contracts them exactly in int_einsum, an
    # integer contraction: every QM2Q payload
    "efficientvit-b1-r224/m2q/forward": _m2q_payloads,
    # JAX's HLO walk reaches the prefill attention's f32 score / value
    # dots from the embedding through the layer scan's carry tuple; the
    # port's q / k / v come out of integer contractions, where walks stop
    "qwen1.5-0.5b/u8/prefill":
        lambda args: {("no-dequant-matmul", "0/embed/0")},
}
PORT_ONLY = {
    # the decode step's masked row write (models/dense_lm.py _write_rows:
    # dst[b, i] = where(mask, rows, dst[b, i])) gathers the int8 rows it
    # overwrites; JAX writes with a dynamic-update-slice, no gather
    "qwen1.5-0.5b/u8/decode":
        lambda args: {("no-gather-concat", "1/k"),
                      ("no-gather-concat", "1/v")},
}


@functools.lru_cache(maxsize=None)
def _jax_verdicts(arch):
    from repro.analysis import run_rules as jrun
    from repro.analysis.traces import registry_trace_specs, trace_fn
    out = {}
    for fn, args, name, meta in registry_trace_specs(
            arch, recipes=CASES[arch], hires=()):
        vs, supp = jrun(trace_fn(fn, args, name=name, meta=meta,
                                 dispatch=False))
        out[name] = (rule_paths(vs), rule_paths(supp))
    return out


def _port(arch, name):
    for fn, args, tname, meta, loop in T.qlint_trace_specs(
            arch, device="cpu", recipes=CASES[arch], hires=()):
        if tname == name:
            tr = T.trace_fn(fn, args, name=name, meta=meta,
                            dispatch=False, loop=loop)
            assert not tr.graph.kernel_nodes()
            vs, supp = run_rules(tr)
            return args, rule_paths(vs), rule_paths(supp)
    raise KeyError(name)


@pytest.mark.parametrize("name", TRACES)
def test_dispatch_off_verdicts_match_jax(name, jax_leak_check):
    arch = name.split("/")[0]
    jvs, jsupp = _jax_verdicts(arch)[name]
    args, pvs, psupp = _port(arch, name)

    def keyed(s):
        return {k for k in s if k[0] in PATH_RULES}

    jax_only = JAX_ONLY.get(name, lambda a: set())(args)
    port_only = PORT_ONLY.get(name, lambda a: set())(args)
    assert keyed(jvs) - keyed(pvs) == jax_only
    assert keyed(pvs) - keyed(jvs) == port_only
    assert keyed(jsupp) == keyed(psupp)
    # unguarded-act-quant: the same traces fire
    assert any(r == "unguarded-act-quant" for r, _ in jvs)
    assert any(r == "unguarded-act-quant" for r, _ in pvs)

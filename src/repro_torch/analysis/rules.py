"""qlint rule engine over the port's op graph (twin of
``repro.analysis.rules``, which reads optimized HLO).

A :class:`Trace` is one recorded hot path (an ``opgraph.Graph`` plus the
metadata needed to judge it: which invariants apply, what the sharding
specs were).  A :class:`Rule` is one invariant -- it declares its
severity, whether it applies to a given trace (``applies(meta)``), and
produces :class:`Violation`\\ s.  Rules carry default per-path
suppressions (regexes over the violation path) and callers can add more;
suppressed violations are returned separately, never silently dropped.

====================  ========  ==================================================
rule                  severity  invariant
====================  ========  ==================================================
no-f32-dot            error     a quantized hot path runs zero f32/f64 dots
no-gather-concat      error     no gather/concat epilogue on quantized weights
conv-budget           error     exactly the declared unquantized convolutions
no-dequant-matmul     error     no float dot/conv fed by a dequantized weight
no-d2h-in-loop        error     no host reads inside the decode step
unguarded-act-quant   warn      float->int8 conversions guarded by a finite check
sharding-conformance  error     each rank's shards match dist.sharding's specs
====================  ========  ==================================================

Restated over the op graph (``docs/qlint_torch.md``): a dot is an aten
contraction (``mm``, ``bmm``, ``matmul``, ``linear``, ...); a kernel node
(and the integer ``int_einsum``) is an opaque contraction that every
walk stops at; a conversion is any op whose output dtype differs from an
input's (torch promotes ``int8 * f32`` without a ``convert``).
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from . import opgraph as G

_QUANT_DTYPES = ("s4", "u4", "s8", "u8")

DOTS = frozenset({"mm", "bmm", "addmm", "baddbmm", "addbmm", "matmul",
                  "linear", "dot", "vdot", "mv", "addmv", "einsum",
                  "tensordot", "_int_mm"})
CONVS = frozenset({"convolution", "_convolution", "conv1d", "conv2d",
                   "conv3d", "cudnn_convolution", "mkldnn_convolution"})
GATHERS = frozenset({"gather", "index", "index_select", "embedding",
                     "take", "take_along_dim"})
CONCATS = frozenset({"cat", "concat", "concatenate", "stack", "hstack",
                     "vstack"})
REDUCES = frozenset({"sum", "mean", "amax", "amin", "max", "min", "prod",
                     "argmax", "argmin", "var", "std", "var_mean",
                     "std_mean", "norm", "linalg_vector_norm", "logsumexp",
                     "all", "any"})
SCATTERS = frozenset({"scatter", "scatter_", "scatter_add", "scatter_add_",
                      "scatter_reduce", "scatter_reduce_", "index_put",
                      "index_put_", "index_add", "index_add_", "index_copy",
                      "index_copy_", "masked_scatter", "masked_scatter_"})
SORTS = frozenset({"sort", "argsort", "topk", "msort"})
# ops that read a device value on the host (nonzero: its output's size)
HOST_READS = frozenset({"item", "_local_scalar_dense", "tolist", "nonzero"})
# ops that copy a tensor, to the CPU where their output lies there
COPIES = frozenset({"to", "_to_copy", "copy_", "copy", "cpu"})
GUARDS = frozenset({"isfinite", "nan_to_num", "nan_to_num_"})
# the walks stop at a contraction or an opaque op, as JAX's stop at dot /
# convolution / reduce / custom-call / scatter / sort
_STOP_ATEN = DOTS | CONVS | REDUCES | SCATTERS | SORTS


def _stops(node: G.Node) -> bool:
    return node.kind != "aten" or node.op in _STOP_ATEN


@dataclasses.dataclass
class Trace:
    """One recorded hot path under analysis.

    ``meta`` keys the rules understand:

    * ``quantized`` (bool, default True) -- quantized-weights rules apply
    * ``expect_no_f32_dot`` (bool) -- the trace promises zero f32 dots
    * ``expect_dots`` (bool, default True) -- guard against vacuity: a
      trace with no dots at all fails ``no-f32-dot`` instead of passing
    * ``conv_budget`` (int or None) -- exact allowed convolution count
    * ``sharding`` (list[dict]) -- {path, expected, actual} spec strings
      recorded by the sharded trace builder
    """

    name: str
    graph: G.Graph
    meta: dict = dataclasses.field(default_factory=dict)

    def param_path(self, vid: int) -> str:
        """Path of the parameter value ``vid`` (``param<vid>`` for a value
        that is not one)."""
        return self.graph.values[vid].param or f"param{vid}"


@dataclasses.dataclass(frozen=True)
class Violation:
    rule: str
    severity: str  # "error" | "warn"
    trace: str
    path: str      # what the suppression regexes match against
    message: str


@dataclasses.dataclass(frozen=True)
class Rule:
    """One named invariant over a :class:`Trace`."""

    name: str
    severity: str
    doc: str
    applies: Callable[[dict], bool]
    check: Callable[["Rule", Trace], List[Violation]]
    suppress: Tuple[str, ...] = ()  # default path-regex suppressions

    def violation(self, trace: Trace, path: str, message: str) -> Violation:
        return Violation(rule=self.name, severity=self.severity,
                         trace=trace.name, path=path, message=message)


def run_rules(trace: Trace, rules: Optional[Sequence[Rule]] = None,
              suppressions: Optional[Dict[str, Sequence[str]]] = None,
              ) -> Tuple[List[Violation], List[Violation]]:
    """Run every applicable rule; returns (violations, suppressed)."""
    out: List[Violation] = []
    supp: List[Violation] = []
    for rule in DEFAULT_RULES if rules is None else rules:
        if not rule.applies(trace.meta):
            continue
        pats = tuple(rule.suppress) + tuple(
            (suppressions or {}).get(rule.name, ()))
        for v in rule.check(rule, trace):
            if any(re.search(p, v.path) for p in pats):
                supp.append(v)
            else:
                out.append(v)
    return out, supp


# ---------------------------------------------------------------------------
# graph walks shared by the dtype-flow rules
# ---------------------------------------------------------------------------


def _quantized_param_seeds(trace: Trace) -> List[Tuple[str, int]]:
    """(path, value id) of low-bit integer parameters -- quantized
    payloads (weights, int8 KV cache planes)."""
    g = trace.graph
    return [(path, vid) for path, vid in g.params.items()
            if g.dtype_of(vid) in _QUANT_DTYPES]


def _check_no_gather_concat(rule: Rule, trace: Trace) -> List[Violation]:
    g = trace.graph
    out = []
    for path, seed in _quantized_param_seeds(trace):
        seen_v, seen_n = {seed}, set()
        frontier = [seed]
        hits: Dict[str, int] = {}
        while frontier:
            v = frontier.pop()
            for ni in g.consumers.get(v, ()):
                if ni in seen_n:
                    continue
                seen_n.add(ni)
                node = g.nodes[ni]
                if node.kind == "aten" and node.op in GATHERS:
                    hits["gather"] = hits.get("gather", 0) + 1
                elif node.kind == "aten" and node.op in CONCATS:
                    hits["concatenate"] = hits.get("concatenate", 0) + 1
                if _stops(node):
                    continue
                for s in node.outputs:
                    if s not in seen_v:
                        seen_v.add(s)
                        frontier.append(s)
        for op, k in sorted(hits.items()):
            out.append(rule.violation(
                trace, path,
                f"{k} {op} op(s) reachable from quantized param {path!r} "
                f"before any contraction (the M2Q epilogue must be fused "
                f"away)"))
    return out


def _check_no_dequant_matmul(rule: Rule, trace: Trace) -> List[Violation]:
    g = trace.graph
    out = []
    for path, seed in _quantized_param_seeds(trace):
        # state = (value id, passed-through-a-dequantize?)
        seen = {(seed, False)}
        frontier: List[Tuple[int, bool]] = [(seed, False)]
        hits = set()
        while frontier:
            v, dq = frontier.pop()
            v_dt = g.dtype_of(v)
            for ni in g.consumers.get(v, ()):
                node = g.nodes[ni]
                if node.kind == "aten" and node.op in DOTS | CONVS:
                    if dq and G.is_float_dtype(v_dt):
                        hits.add((node.op, ni))
                    continue  # never walk past a contraction
                if _stops(node):
                    continue
                for s in node.outputs:
                    s_dt = g.dtype_of(s)
                    s_dq = dq
                    if G.is_float_dtype(s_dt) and G.is_int_dtype(v_dt):
                        # int -> float before any contraction is a
                        # dequantize (an explicit ``.to`` or torch's own
                        # promotion of ``int8 * f32``)
                        s_dq = True
                    elif G.is_int_dtype(s_dt):
                        s_dq = False  # re-quantized: no float weight now
                    if (s, s_dq) not in seen:
                        seen.add((s, s_dq))
                        frontier.append((s, s_dq))
        for op, ni in sorted(hits, key=lambda h: h[1]):
            out.append(rule.violation(
                trace, path,
                f"float {op} #{ni} ({g.nodes[ni].site}) consumes a "
                f"dequantized value of quantized param {path!r} (the "
                f"low-bit payload is decoded to float and contracted at "
                f"full precision)"))
    return out


def _dot_flops(g: G.Graph, node: G.Node) -> float:
    """2 * output elements * contraction length of one aten dot."""
    if not node.outputs or not node.inputs:
        return 0.0
    a = node.inputs[1] if node.op.startswith("add") and len(
        node.inputs) > 2 else node.inputs[0]
    k = g.values[a].shape[-1] if g.values[a].shape else 1
    return 2.0 * math.prod(g.values[node.outputs[0]].shape) * k


def dots_by_dtype(g: G.Graph) -> Dict[str, float]:
    """{operand dtype: FLOPs} over the aten dots, and ``"kernel"``: the
    count of kernel and composite nodes (opaque integer contractions)."""
    out: Dict[str, float] = {}
    for node in g.nodes:
        if node.kind != "aten":
            out["kernel"] = out.get("kernel", 0.0) + 1
        elif node.op in DOTS and node.inputs:
            dt = g.dtype_of(node.inputs[0])
            out[dt] = out.get(dt, 0.0) + _dot_flops(g, node)
    return out


def _check_no_f32_dot(rule: Rule, trace: Trace) -> List[Violation]:
    by_dtype = dots_by_dtype(trace.graph)
    out = []
    if trace.meta.get("expect_dots", True) and not by_dtype:
        out.append(rule.violation(
            trace, "", "vacuous: the trace contains no dot ops at all "
            "(expected a quantized contraction hot path)"))
    for dt in ("f32", "f64"):
        if by_dtype.get(dt, 0.0) > 0.0:
            out.append(rule.violation(
                trace, "",
                f"{by_dtype[dt]:.3g} {dt} dot FLOPs on a path declared "
                f"fully quantized (expect_no_f32_dot)"))
    return out


def _check_conv_budget(rule: Rule, trace: Trace) -> List[Violation]:
    budget = trace.meta["conv_budget"]
    n = sum(1 for node in trace.graph.nodes
            if node.kind == "aten" and node.op in CONVS)
    if n == budget:
        return []
    why = ("a quantized conv fell back to a dequantized f32 convolution"
           if n > budget else "fewer convs than declared: update the budget")
    return [rule.violation(
        trace, "",
        f"{n} convolution(s) in the module, budget is exactly {budget} "
        f"({why})")]


def _is_host_read(g: G.Graph, node: G.Node) -> bool:
    if node.kind != "aten":
        return False
    if node.op in HOST_READS:
        return True
    if node.op in COPIES and node.outputs:
        to_cpu = g.values[node.outputs[-1]].device == "cpu"
        return to_cpu and any(g.values[v].device != "cpu"
                              for v in node.inputs)
    return False


def _check_no_d2h_in_loop(rule: Rule, trace: Trace) -> List[Violation]:
    g = trace.graph
    return [rule.violation(
        trace, node.loop,
        f"host read {node.op} #{node.idx} ({node.site}) inside loop body "
        f"{node.loop!r}: decode must stay device-resident (one d2h per "
        f"completion)")
        for node in g.loop_nodes() if _is_host_read(g, node)]


def _check_unguarded_act_quant(rule: Rule, trace: Trace) -> List[Violation]:
    g = trace.graph
    buckets: Dict[str, int] = {}
    for node in g.nodes:
        if node.kind != "aten" or not node.outputs or not node.inputs:
            continue
        if g.dtype_of(node.outputs[0]) not in ("s8", "u8"):
            continue
        if not G.is_float_dtype(g.dtype_of(node.inputs[0])):
            continue
        # bounded backward walk: is the quantized value dominated by a
        # finiteness guard anywhere in its ancestry?
        guarded = False
        seen = set(node.inputs)
        frontier = list(node.inputs)
        depth = 0
        while frontier and not guarded and depth < 16:
            depth += 1
            nxt = []
            for v in frontier:
                p = g.producer(v)
                if p is None:
                    continue
                if p.kind == "aten" and p.op in GUARDS:
                    guarded = True
                    break
                for u in p.inputs:
                    if u not in seen:
                        seen.add(u)
                        nxt.append(u)
            frontier = nxt
        if not guarded:
            buckets[node.site] = buckets.get(node.site, 0) + 1
    return [rule.violation(
        trace, b,
        f"{k} float->int8 conversion(s) at {b!r} with no dominating "
        f"isfinite / nan_to_num: a NaN activation quantizes to finite "
        f"garbage the logits check cannot flag")
        for b, k in sorted(buckets.items())]


def _check_sharding_conformance(rule: Rule, trace: Trace) -> List[Violation]:
    out = []
    for rec in trace.meta.get("sharding", ()):
        if rec["expected"] != rec["actual"]:
            out.append(rule.violation(
                trace, rec["path"],
                f"input sharding for {rec['path']!r} is {rec['actual']} "
                f"but dist.sharding specs say {rec['expected']}"))
    return out


def lint(trace: Trace, *rule_names: str,
         suppressions: Optional[Dict[str, Sequence[str]]] = None,
         ) -> List[Violation]:
    """Violations from the named rules (all of ``DEFAULT_RULES`` when no
    names are given).  A rule name is looked up strictly (KeyError on
    typos: a misspelled rule must not pass vacuously).  Suppressed
    violations are dropped here -- tests assert on what a CI run would
    actually report."""
    rules = ([RULES_BY_NAME[n] for n in rule_names] if rule_names else None)
    return run_rules(trace, rules=rules, suppressions=suppressions)[0]


DEFAULT_RULES: Tuple[Rule, ...] = (
    Rule(name="no-f32-dot", severity="error",
         doc="A hot path declared fully quantized runs zero f32/f64 dot "
             "FLOPs (and is non-vacuous: it runs SOME dots; a kernel "
             "node counts as one).",
         applies=lambda m: bool(m.get("expect_no_f32_dot")),
         check=_check_no_f32_dot),
    Rule(name="no-gather-concat", severity="error",
         doc="No gather/index/cat/stack is reachable from a quantized "
             "parameter before its contraction (the deleted M2Q "
             "permutation epilogue must not creep back).",
         applies=lambda m: bool(m.get("quantized", True)),
         check=_check_no_gather_concat,
         # embedding tables are looked up BY gather -- that is the op's
         # definition, not an epilogue regression
         suppress=(r"(^|/)embed",)),
    Rule(name="conv-budget", severity="error",
         doc="The trace runs exactly the declared number of aten "
             "convolutions (the unquantized stem); any extra conv is a "
             "quantized conv that fell back to f32.",
         applies=lambda m: m.get("conv_budget") is not None,
         check=_check_conv_budget),
    Rule(name="no-dequant-matmul", severity="error",
         doc="No float dot/convolution consumes a value reached from a "
             "quantized parameter through an int->float conversion.",
         applies=lambda m: bool(m.get("quantized", True)),
         check=_check_no_dequant_matmul),
    Rule(name="no-d2h-in-loop", severity="error",
         doc="No host read (item, _local_scalar_dense, nonzero, a copy "
             "to the CPU) inside the decode step.",
         applies=lambda m: True,
         check=_check_no_d2h_in_loop),
    Rule(name="unguarded-act-quant", severity="warn",
         doc="Every float->int8 conversion should be dominated by an "
             "isfinite / nan_to_num guard; unguarded ones launder NaN "
             "into finite int8 garbage (see docs/serving.md).",
         applies=lambda m: bool(m.get("quantized", True)),
         check=_check_unguarded_act_quant),
    Rule(name="sharding-conformance", severity="error",
         doc="Each rank's placed shards match the dist.sharding specs "
             "the trace was built with.",
         applies=lambda m: bool(m.get("sharding")),
         check=_check_sharding_conformance),
)

RULES_BY_NAME: Dict[str, Rule] = {r.name: r for r in DEFAULT_RULES}

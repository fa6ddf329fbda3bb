"""The paper's accuracy tables on the trained proxy (twin of the accuracy
half of ``benchmarks.tables``): top-1 of the reduced EfficientViT-B1
trained on the synthetic vision task (``data.proxy``) with its weights
fake-quantized by :func:`~repro_torch.core.apply.fake_quant_model`.

* Table I (``table1/...``): the compute-intensive weights (``KIND_DENSE``)
  under uniform 8, PoT 3, APoT and M2Q;
* Table II (``table2/...``): the DWConv weights under uniform 2-8 bits;
* Table III (``table3/...``): Trio (uniform 8), Auto-ViT-Acc
  (``pot_mix``) and ours (M2Q, then DWConv uniform 4);
* Table IV (``table4/...``): ours on the FFN only (``w_pw\\d``), the
  attention only (``(w_qkv|w_proj|w_agg)``) or every layer (``.``), and
  none (the float top-1).

Each row is ``(name, top1, drop)`` as the reference rounds them, with
its 256 predictions, the leaves it replaced and each mixed leaf's Eq. 6
split (:class:`Row`).  Table III's rows drop the reference's model
dimension (``table3/<model>/<method>``): only its energy differs between
the four models, and the energy, latency and EDP columns of Tables
III-VI are absent because the reference computes them with a simulator
of the paper's accelerator calibrated from TPU kernel times
(``benchmarks/accel_sim.py``), which has no counterpart on the card.

    PYTHONPATH=src python -m repro_torch.launch.tables \\
        [--device cuda|cpu] [--proxy PATH] [--out DIR]

runs every row on the device (the card by default) over the committed
proxy or the file ``--proxy`` names (``data.proxy.train_proxy``'s
layout), prints the rows, and writes one markdown table per paper table
under ``--out`` (nothing without it).  The forward uses the f32
attention einsums, as the reference's forward does off a TPU.

:func:`reference_check` holds rows against the JAX package's, as
``tools/write_proxy_tables.py`` records them in
``results/proxy_tables_jax.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import itertools
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import policy as pol
from ..core.apply import fake_quant_model, mixed_fake_quant
from ..core.quant import _pot_magnitudes, flush, pot_log2
from ..core.scheme_select import SchemeAssignment
from ..core.tree import leaves_with_path
from ..data import proxy
from ..models import efficientvit

EXPECTED = proxy.ROOT / "results" / "proxy_tables_jax.json"

DENSE, DW = pol.KIND_DENSE, pol.KIND_DWCONV
# one fake_quant_model call: (scheme, bits, kind, path_filter)
Step = Tuple[str, int, str, Optional[str]]


def _ours(pattern: Optional[str] = None) -> Tuple[Step, ...]:
    """M2Q on the dense weights, then the DWConvs at 4 bits."""
    return (("m2q", 8, DENSE, pattern), ("uniform", 4, DW, pattern))


# per table, its rows in the reference's order: (row, steps)
TABLES: Dict[str, List[Tuple[str, Tuple[Step, ...]]]] = {
    "table1": [("float", ())] + [
        (scheme, ((scheme, bits, DENSE, None),))
        for scheme, bits in (("uniform", 8), ("pot", 3), ("apot", 8),
                             ("m2q", 8))],
    "table2": [("float", ())] + [
        (f"{b}bit", (("uniform", b, DW, None),)) for b in range(2, 9)],
    "table3": [("trio", (("uniform", 8, DENSE, None),)),
               ("autovit", (("pot_mix", 8, DENSE, None),)),
               ("ours", _ours())],
    "table4": [("none(trio)", ())] + [
        (group, _ours(pattern)) for group, pattern in (
            ("ffn_only", r"w_pw\d"),
            ("attention_only", r"(w_qkv|w_proj|w_agg)"),
            ("all", r"."))],
}
TITLES = {"table1": "table1_schemes", "table2": "table2_bits",
          "table3": "table3_accuracy", "table4": "table4_accuracy"}


@dataclasses.dataclass
class Row:
    name: str
    top1: float
    drop: float
    predictions: np.ndarray
    leaves: Dict[str, torch.Tensor]        # path -> fake-quantized leaf
    schemes: Dict[str, str]                # path -> the scheme it took
    assignments: Dict[str, SchemeAssignment]  # mixed leaves' splits


def digest(leaf) -> str:
    """sha256 of a leaf's f32 bytes in C order."""
    a = leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) \
        else np.asarray(leaf)
    return hashlib.sha256(np.ascontiguousarray(a, np.float32).tobytes()
                          ).hexdigest()


def _apply(params, steps: Tuple[Step, ...], memo: dict):
    """(tree, replaced leaves, schemes, splits) after ``steps``, each
    prefix computed once across rows."""
    if steps in memo:
        return memo[steps]
    tree, leaves, schemes, splits = _apply(params, steps[:-1], memo)
    scheme, bits, kind, pattern = steps[-1]
    asn = {}
    out = fake_quant_model(tree, efficientvit.QUANT_RULES, scheme=scheme,
                           bits=bits, kinds={kind}, path_filter=pattern,
                           assignments=asn)
    before = dict(leaves_with_path(tree))
    new = {k: v for k, v in leaves_with_path(out) if v is not before[k]}
    memo[steps] = (out, {**leaves, **new},
                   {**schemes, **dict.fromkeys(new, scheme)},
                   {**splits, **asn})
    return memo[steps]


def run(params, tables: Sequence[str] = tuple(TABLES)) -> List[Row]:
    """Every row of ``tables`` over ``params`` (the float proxy, on the
    device it runs on): top-1 over the 8 x 32 images the reference's
    ``accuracy()`` draws (``data.proxy.predict``)."""
    memo = {(): (params, {}, {}, {})}
    scored = {}  # steps -> (predictions, top-1)

    def score(steps):
        if steps not in scored:
            preds, labels = proxy.predict(_apply(params, steps, memo)[0],
                                          attn="f32")
            scored[steps] = (preds, float(np.mean(preds == labels)))
        return scored[steps]

    fp = score(())[1]
    rows = []
    for table in tables:
        for name, steps in TABLES[table]:
            preds, acc = score(steps)
            _, leaves, schemes, splits = _apply(params, steps, memo)
            rows.append(Row(f"{table}/{name}", round(acc, 4),
                            round(fp - acc, 4), preds, leaves, schemes,
                            splits))
    return rows


def write_markdown(rows: Sequence[Row], out: Path) -> List[Path]:
    """One ``<title>.md`` per table under ``out`` (columns row, top1,
    drop)."""
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    written = []
    for table, title in TITLES.items():
        mine = [r for r in rows if r.name.startswith(table + "/")]
        if not mine:
            continue
        lines = ["| row | top1 | drop |", "|---|---|---|"]
        lines += [f"| {r.name.split('/', 1)[1]} | {r.top1} | {r.drop} |"
                  for r in mine]
        path = out / f"{title}.md"
        path.write_text("\n".join(lines) + "\n")
        written.append(path)
    return written


# ---------------------------------------------------------------------------
# against the JAX package's rows
# ---------------------------------------------------------------------------

# an exponent's log2 within this many f32 ulps of a half-integer is at a
# rounding tie: two logs correct to an ulp or two may round it apart
TIE_ULPS = 8
# most tie elements a leaf's digest is searched over (2^n candidates)
MAX_TIES = 10
# flipped Eq. 6 filters: their penalties must agree within this share of
# their MSEs (float summation order; real disagreements are far larger)
PENALTY_NOISE = 1e-4


def pot_ties(w: torch.Tensor, bits: int = 3):
    """The elements of ``fake_quant_pot(w, bits)`` (filter-wise, axis -1)
    whose exponent sits at a rounding tie of log2, and the value each
    takes with the exponent rounded the other way: (flat indices, values)
    as numpy."""
    scale, pmin, is_zero, lg = pot_log2(w, bits, -1, 1e-8, None)
    low = torch.floor(lg)
    ulp = torch.abs(lg) * 2.0 ** -23 + 2.0 ** -149
    tie = (torch.abs(lg - low - 0.5) <= TIE_ULPS * ulp) & ~is_zero
    alt = torch.where(torch.round(lg) == low, low + 1, low)
    alt = torch.clamp(alt, pmin, 0).to(torch.int64)
    mag = torch.from_numpy(_pot_magnitudes()).to(w.device)[-alt]
    val = flush(torch.sign(flush(w)) * mag * scale)
    idx = torch.nonzero(tie.reshape(-1)).reshape(-1)
    return (idx.cpu().numpy(),
            val.reshape(-1)[idx].cpu().numpy().astype(np.float32))


def _tie_search(leaf: np.ndarray, idx: np.ndarray, vals: np.ndarray,
                want: str) -> Optional[int]:
    """The fewest tie elements of ``leaf`` that, rounded the other way,
    give the digest ``want``; None if no subset does."""
    flat = leaf.reshape(-1)
    for n in range(1, len(idx) + 1):
        for sub in itertools.combinations(range(len(idx)), n):
            cand = flat.copy()
            cand[idx[list(sub)]] = vals[list(sub)]
            if digest(cand) == want:
                return n
    return None


def _leaf_problems(path, leaf, float_leaf, scheme, asn, jax_idx,
                   want: str, rep: dict) -> List[str]:
    """Why ``leaf`` is not the reference's, or [] where it is up to
    counted ties (``rep`` gains ``ties`` and ``flipped_equal``)."""
    if digest(leaf) == want:
        return []
    shape = float_leaf.shape
    w = float_leaf.to(torch.float32).reshape(-1, shape[-1])
    if scheme in ("m2q", "pot_mix"):
        if jax_idx is not None and not np.array_equal(asn.apot_idx, jax_idx):
            # the leaf under the reference's split, computed here
            forced = SchemeAssignment(
                apot_idx=jax_idx.astype(np.int32),
                uniform_idx=np.setdiff1d(np.arange(shape[-1]),
                                         jax_idx).astype(np.int32),
                mse_uniform=asn.mse_uniform, mse_apot=asn.mse_apot)
            leaf = mixed_fake_quant(w, forced, scheme).reshape(shape)
            asn = forced
            if digest(leaf) == want:
                rep["flipped_equal"].append(path)
                return []
    if scheme in ("pot", "pot_mix"):
        if scheme == "pot":
            idx, vals = pot_ties(w, 3)
            idx_full = idx
        else:
            cols = torch.as_tensor(asn.apot_idx, dtype=torch.int64,
                                   device=w.device)
            idx, vals = pot_ties(w[:, cols], 3)
            n_a = len(asn.apot_idx)
            idx_full = (idx // n_a) * shape[-1] + asn.apot_idx[idx % n_a]
        if 0 < len(idx) <= MAX_TIES:
            n = _tie_search(leaf.detach().cpu().numpy(), idx_full, vals,
                            want)
            if n is not None:
                rep["ties"] += n
                return []
        return [f"{path}: digest differs ({len(idx)} PoT elements at a "
                "rounding tie could not account for it)"]
    return [f"{path}: digest differs"]


def reference_check(rows: Sequence[Row], expected: dict, params,
                    max_mismatches: int):
    """Hold ``rows`` (from :func:`run` over ``params``) against the JAX
    package's (``expected``, the JSON of ``tools/write_proxy_tables.py``):
    every replaced leaf's sha256 equal to the reference's, but for PoT
    elements at a rounding tie of log2 (counted); each mixed leaf's
    ``apot_idx`` equal, or every flipped filter reported with its penalty
    gap, which must be float noise (``PENALTY_NOISE``), and the leaf
    under the reference's split equal to the reference's; at most
    ``max_mismatches`` predictions differing.  Returns (one report a row,
    failures)."""
    ref = {r["name"]: r for r in expected["rows"]}
    floats = dict(leaves_with_path(params))
    reports, failures = [], []
    for row in rows:
        want = ref.get(row.name)
        if want is None:
            failures.append(f"{row.name}: not in the reference's rows")
            continue
        rep = {"name": row.name, "top1": row.top1, "jax_top1": want["top1"],
               "drop": row.drop, "jax_drop": want["drop"],
               "predictions_differing": int(np.sum(
                   row.predictions != np.array(want["predictions"]))),
               "leaves": len(row.leaves), "ties": 0, "flipped": {},
               "flipped_equal": []}
        if sorted(row.leaves) != sorted(want["leaves"]):
            failures.append(f"{row.name}: replaced leaves "
                            f"{sorted(set(row.leaves) ^ set(want['leaves']))}"
                            " differ from the reference's")
            continue
        for path, asn in row.assignments.items():
            jax_idx = np.array(want["apot_idx"][path])
            if np.array_equal(asn.apot_idx, jax_idx):
                continue
            flipped = np.setxor1d(asn.apot_idx, jax_idx)
            pen = asn.mse_apot - asn.mse_uniform
            gap = float(pen[flipped].max() - pen[flipped].min())
            bound = PENALTY_NOISE * float(np.max(
                np.abs(asn.mse_apot[flipped]) + np.abs(
                    asn.mse_uniform[flipped])))
            rep["flipped"][path] = {"filters": flipped.tolist(),
                                    "penalty_gap": gap, "bound": bound}
            if gap > bound:
                failures.append(f"{row.name}: {path} filters "
                                f"{flipped.tolist()} flipped with penalty "
                                f"gap {gap} (bound {bound})")
        for path, leaf in row.leaves.items():
            idx = want["apot_idx"].get(path)
            failures += [f"{row.name}: {p}" for p in _leaf_problems(
                path, leaf, floats[path], row.schemes[path],
                row.assignments.get(path),
                None if idx is None else np.array(idx),
                want["leaves"][path], rep)]
        if rep["predictions_differing"] > max_mismatches:
            failures.append(f"{row.name}: {rep['predictions_differing']} "
                            "predictions differ from the reference's "
                            f"(bound {max_mismatches})")
        reports.append(rep)
    return reports, failures


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--proxy", default=str(proxy.CACHE),
                    help="the float proxy (.npz, leaf_<i> members)")
    ap.add_argument("--out", default=None,
                    help="write the tables as markdown under this folder")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device here "
                         "(--device cpu runs the tables on the CPU)")
    params = proxy.load_proxy(args.device, path=args.proxy)
    rows = run(params)
    where = (torch.cuda.get_device_name(0) if args.device == "cuda"
             else "cpu")
    print(f"[tables] {args.proxy} on {where}")
    for r in rows:
        print(json.dumps({"name": r.name, "top1": r.top1, "drop": r.drop}))
    if args.out:
        for path in write_markdown(rows, Path(args.out)):
            print(f"[tables] wrote {path}")


if __name__ == "__main__":
    main()

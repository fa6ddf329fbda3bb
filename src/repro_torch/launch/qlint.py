"""qlint: sweep the config registry and verify quantization / transfer /
sharding invariants over the port's recorded op graphs (twin of
``repro.launch.qlint``).

For every config in the sweep this quantizes the reduced model's tree
abstractly (``recipe.abstract_quantize``, its fields drawn from a seed),
records the forward / prefill / decode hot paths eagerly with every
kernel-dispatch axis on (``analysis.traces``), and runs the
``repro_torch.analysis`` rule engine over each op graph.  Violations are
diffed against the committed baseline ledger -- by-design deviations
live THERE, once, reviewed (``docs/qlint_torch.md``); the exit code is
nonzero only for violations the baseline does not know about.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.qlint --device cpu \\
      --baseline results/qlint_baseline_torch.json
  PYTHONPATH=src python -m repro_torch.launch.qlint --device cpu \\
      --update-baseline
  PYTHONPATH=src python -m repro_torch.launch.qlint --configs qwen1.5-0.5b
  PYTHONPATH=src python -m repro_torch.launch.qlint --list-rules

``--device`` is ``cuda`` by default: the card, which must be there (no
fallback to the CPU).  Exit codes: 0 clean / baseline-known only; 1 new
violations (or stale ones under ``--fail-on-gone``); 2 usage or missing
baseline.
"""
import argparse
import sys
import time
from pathlib import Path

from ..analysis import DEFAULT_RULES, baseline as bl, run_rules

DEFAULT_BASELINE = "results/qlint_baseline_torch.json"


def build_traces(configs, sharded=True, sharded_arch="qwen1.5-0.5b",
                 device="cuda", progress=print):
    from ..analysis.traces import registry_traces, sharded_decode_trace
    traces = []
    for arch in configs:
        t0 = time.time()
        got = registry_traces(arch, device=device)
        traces += got
        progress(f"  {arch}: {len(got)} traces ({time.time() - t0:.1f}s)")
    if sharded:
        t0 = time.time()
        traces.append(sharded_decode_trace(sharded_arch, n_data=1,
                                           n_model=2, device=device))
        progress(f"  {sharded_arch} (sharded): 1 trace "
                 f"({time.time() - t0:.1f}s)")
    return traces


def _check_device(device: str) -> None:
    import torch
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {device}: no CUDA device (torch.cuda.is_available() "
            "is False); pass --device cpu to trace on the CPU")


def main(argv=None) -> int:
    from ..analysis.traces import DEFAULT_SWEEP
    ap = argparse.ArgumentParser(
        prog="qlint", description="op-graph invariant linter")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help=f"known-violation ledger (default "
                         f"{DEFAULT_BASELINE})")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the ledger from this run's violations")
    ap.add_argument("--configs", default=",".join(DEFAULT_SWEEP),
                    help="comma-joined registry config names (reduced "
                         "shapes are used)")
    ap.add_argument("--no-sharded", action="store_true",
                    help="skip the mesh-sharded conformance trace")
    ap.add_argument("--fail-on-gone", action="store_true",
                    help="exit nonzero when baseline entries are no "
                         "longer observed (CI keeps the ledger tight: "
                         "fixed violations must be ratcheted out with "
                         "--update-baseline, not left as dead rows)")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where the hot paths run (default cuda: the card, "
                         "never a fallback; cpu runs the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)

    if args.list_rules:
        for r in DEFAULT_RULES:
            print(f"{r.name:<22} [{r.severity}] {r.doc}")
            if r.suppress:
                print(f"{'':<22} default suppressions: "
                      f"{', '.join(r.suppress)}")
        return 0

    configs = [c.strip() for c in args.configs.split(",") if c.strip()]
    if not configs:
        ap.error("--configs is empty")
    _check_device(args.device)
    print(f"qlint: tracing {len(configs)} registry config(s) on "
          f"{args.device}...")
    traces = build_traces(configs, sharded=not args.no_sharded,
                          device=args.device)

    violations, suppressed = [], []
    for tr in traces:
        vs, supp = run_rules(tr)
        violations += vs
        suppressed += supp
        n_err = sum(v.severity == "error" for v in vs)
        n_warn = len(vs) - n_err
        print(f"  {tr.name:<44} {n_err} error(s), {n_warn} warn(s), "
              f"{len(supp)} suppressed")
    ledger = bl.to_ledger(violations)

    if args.update_baseline:
        bl.save(args.baseline, ledger)
        print(f"qlint: wrote {sum(len(p) for t in ledger.values() for p in t.values())} "
              f"ledger entries to {args.baseline}")
        return 0

    if not Path(args.baseline).exists():
        print(f"qlint: baseline {args.baseline} not found -- run with "
              f"--update-baseline to create it", file=sys.stderr)
        return 2
    base = bl.load(args.baseline)
    regressions = bl.diff(ledger, base)
    gone = bl.improvements(ledger, base)
    if gone:
        print(f"qlint: {len(gone)} baseline entr(ies) no longer observed "
              f"(ratchet with --update-baseline):")
        for line in gone:
            print(f"  {line}")
    if regressions:
        print(f"qlint: {len(regressions)} NEW violation(s) vs "
              f"{args.baseline}:")
        for line in regressions:
            print(f"  {line}")
        for v in violations:
            key = f"{v.trace} :: {v.rule}"
            if any(key in line for line in regressions):
                print(f"    detail: [{v.severity}] {key} :: "
                      f"{v.path or '<module>'}: {v.message}")
        return 1
    if gone and args.fail_on_gone:
        # only meaningful on the full sweep: a partial --configs run
        # trivially "loses" every untraced config's entries
        print(f"qlint: FAIL -- {len(gone)} stale baseline entr(ies) "
              f"(--fail-on-gone): re-tighten the ledger with "
              f"--update-baseline", file=sys.stderr)
        return 1
    print(f"qlint: clean -- {len(traces)} trace(s), "
          f"{len(DEFAULT_RULES)} rules, {len(violations)} baseline-known "
          f"violation(s), {len(suppressed)} suppressed")
    return 0


if __name__ == "__main__":
    sys.exit(main())

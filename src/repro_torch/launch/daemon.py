"""The serving-daemon CLI (the single-host paths of
``repro.launch.daemon``): wall-clock serving with SLO classes and
streaming.

Quantize (unless ``--no-quant``) and serve mixed interactive + batch
wall-clock traffic through the background
:class:`~repro_torch.serving.daemon.ServingDaemon`, streaming the first
interactive request token by token:

  PYTHONPATH=src python -m repro_torch.launch.daemon --arch qwen1.5-0.5b \
      --reduced --requests 8 --stream [--device cpu]

``--smoke`` is the fast path: one streamed request with a tight timeout,
clean drain, exact outcome reconciliation -- exits non-zero on any of
those failing.

Not ported yet, and refused with a message naming what brings them:
``--health-file`` and ``--recovery-smoke`` run under the supervisor and
its request journal (ROADMAP A6: ``serving/journal.py``,
``serving/supervisor.py``); ``--coordinator`` (multi-host launch) and
``--mesh`` wait for the port's sharding (ROADMAP A9).
"""
from __future__ import annotations

import argparse
import sys
import threading
import time

import numpy as np

SUPERVISOR_NOT_PORTED = (
    "{flag}: supervised serving is not ported; it waits for the port's "
    "serving/journal.py and serving/supervisor.py (ROADMAP A6)")
SHARDING_NOT_PORTED = (
    "{flag}: multi-host and sharded serving are not ported; they wait for "
    "the port's dist/sharding.py (ROADMAP A9)")


def build_engine(args):
    from ..configs.registry import ARCHS, REDUCED
    from ..models import get_model
    from ..serving.engine import Engine
    from .serve import quantize_for_serving
    cfg = (REDUCED if args.reduced else ARCHS)[args.arch]
    params = get_model(cfg).init(cfg, seed=0, device=args.device)
    engine_kw = dict(max_batch=args.max_batch, max_len=args.max_len)
    if args.no_quant:
        return Engine(cfg, params, **engine_kw)
    qm = quantize_for_serving(cfg, params)
    print(f"[daemon] quantized {len(qm.report)} layers")
    return qm.serve(**engine_kw)


def _prompts(cfg, n, rng):
    return [rng.integers(0, cfg.vocab_size, int(rng.integers(4, 13)),
                         dtype=np.int32) for _ in range(n)]


def serve_traffic(daemon, args) -> bool:
    """Submit mixed interactive/batch wall-clock traffic from a foreign
    thread, stream the first interactive request, report per-class
    latency and the stream's time to first token and token gaps.
    Returns True when every outcome reconciled."""
    eng = daemon.engine
    cfg = eng.cfg
    rng = np.random.default_rng(0)
    n_inter = max(1, args.requests // 2)
    n_batch = args.requests - n_inter
    results = []

    def submitter():
        for p in _prompts(cfg, n_batch, rng):
            results.append(daemon.submit(p, slo="batch",
                                         max_new_tokens=args.max_new))
        for p in _prompts(cfg, n_inter - 1, rng):
            results.append(daemon.submit(p, slo="interactive",
                                         max_new_tokens=args.max_new))

    th = threading.Thread(target=submitter)
    th.start()
    streamed, at = [], []
    t0 = time.monotonic()
    first = daemon.submit(_prompts(cfg, 1, rng)[0], slo="interactive",
                          max_new_tokens=args.max_new, stream=True)
    for tok in first.handle.tokens(timeout=args.timeout):
        at.append(time.monotonic())
        streamed.append(tok)
        if args.stream:
            print(f"[daemon] stream tok={tok}", flush=True)
    th.join(args.timeout)
    if th.is_alive():
        print("[daemon] FAIL: the submitting thread did not finish")
        return False
    results.append(first)
    for r in results:
        r.handle.result(timeout=args.timeout)
    daemon.shutdown(drain=True, timeout=args.timeout)
    if streamed != first.handle.result():
        print(f"[daemon] FAIL: streamed {streamed} != result "
              f"{first.handle.result()}")
        return False
    s = eng.stats
    if s.submitted != s.resolved:
        print(f"[daemon] FAIL: submitted={s.submitted} != "
              f"resolved={s.resolved}")
        return False
    cls = daemon.stats_summary()["classes"]
    for name, row in cls.items():
        print(f"[daemon] class={name} completed={row['completed']} "
              f"p50={row['p50_ms']:.1f}ms p99={row['p99_ms']:.1f}ms")
    gaps = np.diff(at) * 1000.0
    print(f"[daemon] stream ttft={(at[0] - t0) * 1000.0:.1f}ms "
          f"tokens={len(streamed)} "
          f"gap p50={np.percentile(gaps, 50) if len(gaps) else 0.0:.1f}ms "
          f"max={gaps.max() if len(gaps) else 0.0:.1f}ms "
          f"gaps_ms={[round(float(g), 1) for g in gaps]}")
    print(f"[daemon] reconciled {s.submitted} requests; "
          f"streamed_tokens={s.streamed_tokens} "
          f"preemptions={s.preemptions}")
    return True


def smoke(args) -> int:
    """Fast path: one streamed request end to end, wall-clock, with a
    tight timeout and a clean reconciled shutdown."""
    from ..serving.daemon import ServingDaemon
    t0 = time.monotonic()
    eng = build_engine(args)
    daemon = ServingDaemon(eng).start()
    streamed = []
    req = daemon.submit(np.arange(1, 9, dtype=np.int32),
                        slo="interactive", max_new_tokens=args.max_new,
                        stream=True)
    try:
        for tok in req.handle.tokens(timeout=args.timeout):
            streamed.append(tok)
    except TimeoutError as e:
        daemon.shutdown(drain=False, timeout=args.timeout)
        print(f"[daemon] SMOKE FAIL: {e}")
        return 1
    daemon.shutdown(drain=True, timeout=args.timeout)
    s = eng.stats
    ok = (streamed == req.handle.result()
          and len(streamed) == args.max_new
          and s.submitted == s.resolved == 1
          and not daemon.running)
    if not ok:
        print(f"[daemon] SMOKE FAIL: streamed={streamed} "
              f"result={req.handle.result()} submitted={s.submitted} "
              f"resolved={s.resolved} running={daemon.running}")
        return 1
    print(f"[daemon] smoke ok: {len(streamed)} tokens streamed "
          f"wall-clock in {time.monotonic() - t0:.1f}s, clean shutdown")
    return 0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--timeout", type=float, default=120.0,
                    help="per-wait timeout (seconds) for streaming/"
                         "results/drain")
    ap.add_argument("--no-quant", action="store_true")
    ap.add_argument("--stream", action="store_true",
                    help="print each streamed token of the first "
                         "interactive request")
    ap.add_argument("--smoke", action="store_true",
                    help="fast path: one streamed request, tight "
                         "timeout, reconciled shutdown")
    ap.add_argument("--recovery-smoke", action="store_true",
                    help="crash-recovery stage (not ported)")
    ap.add_argument("--health-file", default=None,
                    help="supervisor health snapshots (not ported)")
    ap.add_argument("--mesh", default=None,
                    help="DATAxMODEL over the global device world (not "
                         "ported)")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0, multi-host launch (not "
                         "ported)")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the model and engine live (cuda or cpu)")
    args = ap.parse_args(argv)

    if args.coordinator is not None:
        raise SystemExit(SHARDING_NOT_PORTED.format(flag="--coordinator"))
    if args.mesh:
        raise SystemExit(SHARDING_NOT_PORTED.format(flag="--mesh"))
    if args.recovery_smoke:
        raise SystemExit(SUPERVISOR_NOT_PORTED.format(
            flag="--recovery-smoke"))
    if args.health_file:
        raise SystemExit(SUPERVISOR_NOT_PORTED.format(flag="--health-file"))
    if args.smoke:
        sys.exit(smoke(args))
    from ..serving.daemon import ServingDaemon
    eng = build_engine(args)
    with ServingDaemon(eng) as daemon:
        ok = serve_traffic(daemon, args)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()

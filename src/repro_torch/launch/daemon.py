"""The serving-daemon CLI (the single-host paths of
``repro.launch.daemon``): wall-clock serving with SLO classes,
streaming, and supervision.

Quantize (unless ``--no-quant``) and serve mixed interactive + batch
wall-clock traffic through the background
:class:`~repro_torch.serving.daemon.ServingDaemon`, streaming the first
interactive request token by token:

  PYTHONPATH=src python -m repro_torch.launch.daemon --arch qwen1.5-0.5b \
      --reduced --requests 8 --stream [--device cpu]

``--smoke`` is the fast path: one streamed request with a tight timeout,
clean drain, exact outcome reconciliation -- exits non-zero on any of
those failing.

Supervision (:mod:`repro_torch.serving.supervisor`):

* ``--health-file PATH`` runs the same traffic under a
  :class:`~repro_torch.serving.supervisor.Supervisor` (restart-
  transparent submits) and writes its ``health()`` snapshot to PATH
  (atomic tmp + ``os.replace``) twice a second, and once more after the
  shutdown -- poll it from outside the process.
* ``--recovery-smoke`` is the crash-recovery stage: a journal-backed
  supervisor serving under an injected ``crash@decode`` fault -- exits
  non-zero unless the watchdog restarted the daemon, every request
  completed, the replayed results match a fault-free reference and the
  journal reconciles exactly.  Every engine is built from the first
  one's parameter tree (no second quantization, no copy).  "Match"
  means equal; where the replay's prefill group had another size or
  padded length than the reference's, a differing request may instead
  sit within ``TEACHER_FORCED_BOUND`` of the teacher-forced argmax
  (:func:`replay_agreement`; both counts are printed): on the card bf16
  matmuls of another shape can move a near-tie token.

Not ported yet, and refused with a message naming what brings them:
``--coordinator`` (multi-host launch, with its per-process readiness
markers under ``--health-file``) and ``--mesh`` wait for the port's
sharding (ROADMAP A9).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
import weakref

import numpy as np
import torch

# a served token that is not the teacher-forced argmax must sit this
# close below it, as a fraction of the largest teacher-forced |logit|:
# the token path's bound on the card, for served and replayed tokens
TEACHER_FORCED_BOUND = 5e-2

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


def _write_json_atomic(path, obj) -> None:
    tmp = f"{path}.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(obj, f, sort_keys=True)
    os.replace(tmp, path)


class _HealthWriter:
    """Background thread dumping ``snapshot()`` JSON to ``path`` (atomic
    replace, so readers never see a torn file)."""

    def __init__(self, path: str, snapshot, interval_s: float = 0.5):
        self.path = path
        self._snapshot = snapshot
        self._interval = interval_s
        self._stop = threading.Event()
        self._th = threading.Thread(target=self._run, daemon=True,
                                    name="repro-health-writer")

    def _run(self):
        while True:
            _write_json_atomic(self.path, self._snapshot())
            if self._stop.wait(self._interval):
                return

    def __enter__(self):
        self._th.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._th.join()
        _write_json_atomic(self.path, self._snapshot())  # final state


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


def serve_supervised(args) -> int:
    """The serve path under a Supervisor, health snapshots on disk
    (``--health-file``): :func:`serve_traffic`'s mix submitted through
    ``Supervisor.submit`` -- restart-transparent -- with supervisor-level
    outcome reconciliation.  A restart builds its engine from the first
    one's parameter tree and warms it up (one greedy request, which
    captures the decode graph on the card) before it serves."""
    from ..serving.engine import Engine
    from ..serving.supervisor import Supervisor
    first = [build_engine(args)]
    cfg, params = first[0].cfg, first[0].params

    def factory():
        if first:
            return first.pop()
        eng = Engine(cfg, params, max_batch=args.max_batch,
                     max_len=args.max_len)
        # capture the greedy decode graph here, on the watchdog thread,
        # before the new serve thread starts
        eng.submit(np.arange(1, 9, dtype=np.int32), max_new_tokens=2)
        eng.run()
        return eng

    sup = Supervisor(factory).start()
    rng = np.random.default_rng(0)
    n_inter = max(1, args.requests // 2)
    n_batch = args.requests - n_inter
    ok = True
    with _HealthWriter(args.health_file, sup.health):
        handles = [sup.submit(p, slo="batch", max_new_tokens=args.max_new)
                   for p in _prompts(cfg, n_batch, rng)]
        handles += [sup.submit(p, slo="interactive",
                               max_new_tokens=args.max_new)
                    for p in _prompts(cfg, n_inter - 1, rng)]
        streamed = []
        first_h = sup.submit(_prompts(cfg, 1, rng)[0], slo="interactive",
                             max_new_tokens=args.max_new, stream=True)
        for tok in first_h.tokens(timeout=args.timeout):
            streamed.append(tok)
            if args.stream:
                print(f"[daemon] stream tok={tok}", flush=True)
        handles.append(first_h)
        for h in handles:
            h.result(timeout=args.timeout)
        if streamed != first_h.result():
            print(f"[daemon] FAIL: streamed {streamed} != result "
                  f"{first_h.result()}")
            ok = False
        sup.shutdown(drain=True, timeout=args.timeout)
        s = sup.stats
        if s.submitted != s.resolved:
            print(f"[daemon] FAIL: submitted={s.submitted} != "
                  f"resolved={s.resolved}")
            ok = False
    health = sup.health()
    print(f"[daemon] supervised: {s.submitted} requests reconciled, "
          f"restarts={health['restarts']}, health -> {args.health_file}")
    return 0 if ok else 1


def teacher_forced_logits(cfg, params, prompts, forced, max_len: int):
    """(steps + 1, B, vocab) f32 logits: the B ``prompts`` prefilled into
    one batch-B f32 cache, then ``forced`` ((steps, B) token ids) fed
    back one decode step at a time, on the parameters' device."""
    from ..core.tree import device_of
    from ..models import get_model
    model = get_model(cfg)
    dev = device_of(params)
    lens = [len(p) for p in prompts]
    toks = np.zeros((len(prompts), max(lens)), np.int64)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    cache = model.init_cache(cfg, len(prompts), max_len,
                             dtype=torch.float32, device=dev)
    out = []
    with torch.no_grad():
        lg, cache = model.prefill(
            cfg, params, cache, torch.from_numpy(toks).to(dev),
            lengths=torch.tensor(lens, dtype=torch.int32, device=dev))
        out.append(lg[:, 0, :cfg.vocab_size].float())
        for t in np.asarray(forced, np.int64).reshape(-1, len(prompts)):
            lg, cache = model.decode_step(
                cfg, params, cache, torch.from_numpy(t[:, None]).to(dev))
            out.append(lg[:, 0, :cfg.vocab_size].float())
    return torch.stack(out)


def token_gaps(logits, served):
    """How far each ``served`` token ((steps, B) ids) sits below the
    argmax of ``logits`` ((steps, B, vocab), numpy): 0 at the argmax."""
    served = np.asarray(served, np.int64)
    return logits.max(-1) - np.take_along_axis(
        logits, served[..., None], -1)[..., 0]


def teacher_forced_gaps(cfg, params, prompt, tokens, max_len: int):
    """(gaps, bound): :func:`token_gaps` of ``tokens`` under the
    teacher-forced logits of ``prompt`` (:func:`teacher_forced_logits`
    at batch 1), and TEACHER_FORCED_BOUND of those logits' largest
    |logit|."""
    tokens = np.asarray(tokens, np.int64)
    logits = teacher_forced_logits(cfg, params, [prompt], tokens[:-1],
                                   max_len).cpu().numpy()
    gaps = token_gaps(logits, tokens[:, None])[:, 0]
    return gaps, TEACHER_FORCED_BOUND * float(np.abs(logits).max())


class PrefillGroups(dict):
    """Prompt (its token ids joined by commas) -> [group size, padded
    length] of the prefill group that last ran it, in every engine
    :meth:`watch` wraps: what :func:`replay_agreement` compares."""

    @staticmethod
    def key(prompt) -> str:
        return ",".join(str(int(t)) for t in prompt)

    def watch(self, engine):
        """Record ``engine``'s prefill groups from now on; returns it.
        The wrapper holds the engine weakly, so it adds no reference
        cycle that would keep a torn-down engine on the card."""
        from ..serving.batching import pow2_bucket
        run, ref = type(engine)._prefill_group, weakref.ref(engine)

        def recorded(gslots, handles):
            eng = ref()
            prompts = [h.payload.prompt for h in handles]
            shape = [len(prompts), pow2_bucket(
                max(len(p) for p in prompts), 8, eng.T)]
            for p in prompts:
                self[self.key(p)] = shape
            return run(eng, gslots, handles)

        engine._prefill_group = recorded
        return engine


def replay_agreement(cfg, params, prompts, got, expected, max_len: int,
                     got_groups, ref_groups) -> dict:
    """Replayed results (``got``) against a fault-free reference's
    (``expected``), request by request: ``exact`` when equal; ``bounded``
    when they differ, the replay's prefill group (``got_groups``, a
    :class:`PrefillGroups`) had another size or padded length than the
    reference's (``ref_groups``), and every token of ``got`` sits within
    the teacher-forced bound (:func:`teacher_forced_gaps`); else ``off``
    -- a difference under an equal grouping has no such cause.  ``rows``
    lists each request that differs, its largest gap, the bound and both
    groupings."""
    out = {"exact": 0, "bounded": 0, "off": 0, "rows": []}
    for i, (p, a, b) in enumerate(zip(prompts, got, expected)):
        a = [int(t) for t in a]
        if a == [int(t) for t in b]:
            out["exact"] += 1
            continue
        key = PrefillGroups.key(p)
        groups = [ref_groups.get(key), got_groups.get(key)]
        gaps, bound = teacher_forced_gaps(cfg, params, p, a, max_len)
        kind = "bounded" if (None not in groups and groups[0] != groups[1]
                             and len(a) == len(b)
                             and gaps.max() <= bound) else "off"
        out[kind] += 1
        out["rows"].append({"request": i, "largest_gap": float(gaps.max()),
                            "bound": bound, "groups": groups, "kind": kind})
    return out


def recovery_smoke(args) -> int:
    """Crash-recovery stage: journal-backed supervisor, the first engine
    build armed with ``crash@decode`` AFTER a fault-free warm-up (which
    also captures the engine's CUDA graphs on the card, so the served
    steps run as fast as they will) -- assert restart happened, goodput
    is total, replayed results match a fault-free reference
    (:func:`replay_agreement`) and the journal reconciles exactly.  The
    factory builds every engine from the first one's parameter tree and
    keeps a count of its builds, not the engines: each holds a KV cache
    and a graph pool on the card."""
    import tempfile
    from ..serving.engine import Engine
    from ..serving.faults import FaultInjector, FaultSpec
    from ..serving.journal import RequestJournal
    from ..serving.supervisor import RestartPolicy, Supervisor
    t0 = time.monotonic()
    eng0 = build_engine(args)
    cfg, params = eng0.cfg, eng0.params
    rng = np.random.default_rng(0)
    prompts = _prompts(cfg, max(2, args.requests), rng)
    ref_groups, got_groups = PrefillGroups(), PrefillGroups()

    ref_groups.watch(eng0)
    refs = [eng0.submit(p, max_new_tokens=args.max_new) for p in prompts]
    eng0.run()
    expected = [r.handle.result() for r in refs]
    del eng0, refs

    builds = 0

    def factory():
        nonlocal builds
        eng = Engine(cfg, params, max_batch=args.max_batch,
                     max_len=args.max_len)
        for p in prompts:  # warm every shape, fault-free, then arm
            eng.submit(p, max_new_tokens=args.max_new)
        eng.run()
        got_groups.watch(eng)
        if not builds:
            eng.faults = FaultInjector(
                [FaultSpec.parse(f"crash@decode:{args.max_new}")])
        builds += 1
        return eng

    jpath = os.path.join(tempfile.mkdtemp(prefix="repro-recovery-"),
                         "journal.jsonl")
    sup = Supervisor(
        factory, journal=RequestJournal(jpath),
        policy=RestartPolicy(hang_threshold_s=max(10.0, args.timeout / 4),
                             backoff_base_s=0.02, poll_interval_s=0.05))
    sup.start()
    handles = [sup.submit(p, request_id=f"smoke-{i}",
                          max_new_tokens=args.max_new)
               for i, p in enumerate(prompts)]
    outs = [h.result(timeout=args.timeout) for h in handles]
    rec = sup.journal.reconcile()
    health = sup.health()
    sup.shutdown(drain=True, timeout=args.timeout)
    completed = sum(1 for o in outs if o is not None)
    goodput = completed / len(prompts)
    agree = replay_agreement(cfg, params, prompts, outs, expected,
                             args.max_len, got_groups, ref_groups)
    match = agree["off"] == 0
    ok = (sup.restarts >= 1 and goodput == 1.0 and match
          and rec["exact"] and rec["pending"] == 0
          and health["ready"]["ready"])
    if not ok:
        print(f"[daemon] RECOVERY SMOKE FAIL: restarts={sup.restarts} "
              f"goodput={goodput} match={match} agreement={agree} "
              f"reconcile={rec} ready={health['ready']}")
        return 1
    print(f"[daemon] recovery smoke ok: crash@decode -> "
          f"{sup.restarts} restart(s), {sup.replayed} replayed, "
          f"goodput={goodput:.0%}, results match fault-free reference "
          f"({agree['exact']} exact, {agree['bounded']} within the "
          f"teacher-forced bound), journal exact ({rec['submitted']} "
          f"submits == {rec['terminal']} terminals), {builds} engine "
          f"builds, recovery_s={sup.last_recovery_s:.3f} in "
          f"{time.monotonic() - t0:.1f}s")
    print(f"[daemon] restart log: {json.dumps(sup.restart_log)}")
    return 0


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
                    help="crash-recovery stage: journal-backed "
                         "supervisor under an injected crash@decode "
                         "fault; asserts restart + replay + exact "
                         "journal reconciliation")
    ap.add_argument("--health-file", default=None,
                    help="write supervisor health() JSON snapshots here "
                         "while serving under a Supervisor")
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
        sys.exit(recovery_smoke(args))
    if args.smoke:
        sys.exit(smoke(args))
    if args.health_file:
        sys.exit(serve_supervised(args))
    from ..serving.daemon import ServingDaemon
    eng = build_engine(args)
    with ServingDaemon(eng) as daemon:
        ok = serve_traffic(daemon, args)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()

"""Elastic launcher (twin of ``repro.launch.elastic``): supervise training
across failures and preemptions.

It runs ``python -m repro_torch.launch.train`` as a subprocess, restarts
a worker that died or stopped short from the latest published checkpoint
(step-indexed data makes the resumed run exact), and counts the
restarts.  Failure injection fires on the first attempt only:

  PYTHONPATH=src python -m repro_torch.launch.elastic --arch qwen1.5-0.5b \
      --steps 60 --crash-at-step 7 [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import tempfile
import time
from typing import Optional


def _latest_ckpt_step(ckpt_dir) -> Optional[int]:
    from ..ckpt import checkpoint as ckpt
    return ckpt.latest_step(ckpt_dir)


def run_supervised(arch: str, steps: int, ckpt_dir: str, metrics: str,
                   kill_after_s: Optional[float] = None,
                   max_restarts: int = 3,
                   batch: int = 4, seq: int = 32,
                   ckpt_every: int = 5, log_every: int = 10,
                   stop_at_step: Optional[int] = None,
                   crash_at_step: Optional[int] = None,
                   device: str = "cuda") -> int:
    """Run ``launch.train`` (``--reduced``, on ``device``) under restart
    supervision until the final step's checkpoint is published; returns
    the restart count.

    Completion is judged by the checkpoint, not the exit code: the train
    loop's final sync save publishes ``steps - 1`` exactly when it ran to
    the end, so a worker that exits rc 0 without that checkpoint (a
    ``--stop-at-step`` early exit, a preemption save) is counted and
    logged as a restart like any crash.  ``kill_after_s`` SIGTERMs the
    first worker mid-run; ``stop_at_step`` / ``crash_at_step`` go to the
    first worker's ``launch.train``."""
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            arch, "--reduced", "--device", device, "--steps", str(steps),
            "--batch", str(batch), "--seq", str(seq), "--ckpt-dir",
            ckpt_dir, "--ckpt-every", str(ckpt_every),
            "--log-every", str(log_every), "--metrics", metrics]
    restarts = 0
    while True:
        cmd = list(base)
        if restarts == 0:  # injected faults fire once, on the first run
            if stop_at_step is not None:
                cmd += ["--stop-at-step", str(stop_at_step)]
            if crash_at_step is not None:
                cmd += ["--crash-at-step", str(crash_at_step)]
        proc = subprocess.Popen(cmd)
        if kill_after_s is not None and restarts == 0:
            time.sleep(kill_after_s)
            proc.send_signal(signal.SIGTERM)  # simulated preemption
        rc = proc.wait()
        latest = _latest_ckpt_step(ckpt_dir)
        if rc == 0 and latest is not None and latest >= steps - 1:
            return restarts
        restarts += 1
        if restarts > max_restarts:
            raise RuntimeError(
                f"too many restarts ({restarts} > {max_restarts}); "
                f"latest checkpoint step {latest}")
        if rc == 0:
            print(f"[elastic] worker exited cleanly (rc=0) without "
                  f"reaching step {steps - 1} (latest checkpoint: "
                  f"{latest}); counted restart #{restarts}", flush=True)
        else:
            print(f"[elastic] worker died (rc={rc}); restart #{restarts} "
                  "(resume from checkpoint)", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--steps", type=int, default=60)
    tmp = tempfile.gettempdir()
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tmp, "repro_torch_elastic_ckpt"))
    ap.add_argument("--metrics", default=os.path.join(
        tmp, "repro_torch_elastic_metrics.jsonl"))
    ap.add_argument("--kill-at", type=float, default=None,
                    help="seconds until simulated preemption")
    ap.add_argument("--stop-at-step", type=int, default=None,
                    help="first run exits cleanly after this step "
                         "(clean-but-incomplete worker)")
    ap.add_argument("--crash-at-step", type=int, default=None,
                    help="first run hard-crashes after this step")
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="the workers' torch device (default: the card)")
    args = ap.parse_args()
    restarts = run_supervised(args.arch, args.steps, args.ckpt_dir,
                              args.metrics, kill_after_s=args.kill_at,
                              max_restarts=args.max_restarts,
                              stop_at_step=args.stop_at_step,
                              crash_at_step=args.crash_at_step,
                              device=args.device)
    print(f"[elastic] finished with {restarts} restart(s)")


if __name__ == "__main__":
    main()

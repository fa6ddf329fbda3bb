"""Fault-tolerant training loop (twin of ``repro.train.loop``; the driver
behind ``launch/train.py``).

  * deterministic resumable data (step-indexed), exact-resume semantics
  * async checkpoints every N steps + atomic publish + auto-resume
  * preemption handling (SIGTERM/SIGINT -> final sync save -> clean exit)
  * straggler telemetry: per-step wall time vs the running median; slow
    steps are logged
  * metrics JSONL (step, loss, grad_norm, step_time_s, straggler)

On CUDA a step's time is taken after a device synchronize, so
``step_time_s`` is the step's work, not its launch.
"""
from __future__ import annotations

import dataclasses
import json
import os
import signal
import time
from typing import Optional

import numpy as np
import torch

from ..ckpt import checkpoint as ckpt
from ..data.pipeline import DataConfig, SyntheticLM
from ..models import get_model
from ..models.config import ArchConfig
from ..optim.adamw import AdamW, cosine_schedule
from .step import TrainStepConfig, make_train_step


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    global_batch: int = 8
    seq_len: int = 64
    lr: float = 3e-4
    warmup: int = 20
    ckpt_every: int = 50
    log_every: int = 10
    ckpt_dir: Optional[str] = None
    metrics_path: Optional[str] = None
    microbatches: int = 1
    grad_compression: bool = False
    seed: int = 0
    straggler_factor: float = 3.0
    # deterministic failure injection for the elastic launcher:
    # ``stop_at_step`` exits cleanly (rc 0) after that step without
    # reaching ``steps``; ``crash_at_step`` hard-kills the process
    # (``os._exit(3)``: no final save, the finally block never runs)
    # right after that step's async checkpoint lands
    stop_at_step: Optional[int] = None
    crash_at_step: Optional[int] = None


def train(cfg: ArchConfig, tc: TrainConfig, device="cuda"):
    """Train ``cfg`` from ``init(seed=tc.seed)`` on ``device`` (or from
    ``tc.ckpt_dir``'s latest checkpoint); returns (params, opt_state,
    {"losses", "last_step", "preempted"})."""
    device = torch.device(device)
    model = get_model(cfg)
    opt = AdamW(lr=cosine_schedule(tc.lr, tc.warmup, tc.steps))
    step_fn = make_train_step(
        cfg, model, opt, TrainStepConfig(microbatches=tc.microbatches,
                                         grad_compression=tc.grad_compression))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=tc.seq_len,
                                  global_batch=tc.global_batch,
                                  seed=tc.seed))

    params = model.init(cfg, seed=tc.seed, device=device)
    opt_state = opt.init(params)
    start_step = 0

    saver = ckpt.AsyncCheckpointer(tc.ckpt_dir) if tc.ckpt_dir else None
    if saver and (last := ckpt.latest_step(tc.ckpt_dir)) is not None:
        (params, opt_state), extra = ckpt.restore(
            tc.ckpt_dir, last, (params, opt_state), device=device)
        start_step = extra["step"] + 1
        print(f"[train] resumed from step {extra['step']}")

    stop = {"now": False}

    def on_signal(signum, frame):
        stop["now"] = True

    old_handlers = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            old_handlers[sig] = signal.signal(sig, on_signal)
        except ValueError:  # not the main thread (tests)
            pass

    metrics_f = open(tc.metrics_path, "a") if tc.metrics_path else None
    step_times = []
    losses = []
    final_step = start_step
    try:
        for step in range(start_step, tc.steps):
            t0 = time.time()
            batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                     for k, v in data.batch(step).items()}
            params, opt_state, m = step_fn(params, opt_state, batch)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            loss = float(m["loss"])
            dt = time.time() - t0
            step_times.append(dt)
            losses.append(loss)
            final_step = step
            med = float(np.median(step_times[-50:]))
            straggler = dt > tc.straggler_factor * med and len(step_times) > 10
            if metrics_f and (step % tc.log_every == 0 or straggler):
                metrics_f.write(json.dumps({
                    "step": step, "loss": loss,
                    "grad_norm": float(m["grad_norm"]),
                    "step_time_s": round(dt, 4),
                    "straggler": bool(straggler)}) + "\n")
                metrics_f.flush()
            if saver and step and step % tc.ckpt_every == 0:
                saver.save_async(step, (params, opt_state), {"step": step})
            if tc.crash_at_step is not None and step == tc.crash_at_step:
                if saver:
                    saver.wait()  # the published ckpt survives the crash
                print(f"[train] simulated hard crash at step {step} "
                      "(no final save)", flush=True)
                os._exit(3)
            if tc.stop_at_step is not None and step == tc.stop_at_step:
                print(f"[train] clean early exit at step {step} "
                      f"(before step {tc.steps - 1})", flush=True)
                break
            if stop["now"]:
                print(f"[train] preempted at step {step}; saving")
                break
    finally:
        if saver:
            saver.wait()
            ckpt.save(tc.ckpt_dir, final_step, (params, opt_state),
                      {"step": final_step})
        if metrics_f:
            metrics_f.close()
        for sig, h in old_handlers.items():
            signal.signal(sig, h)
    return params, opt_state, {"losses": losses, "last_step": final_step,
                               "preempted": stop["now"]}

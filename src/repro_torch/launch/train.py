"""Training driver CLI (twin of ``repro.launch.train``), on the card
unless ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
      [--reduced] [--device cpu] --steps 200 --batch 8 --seq 64 \
      --ckpt-dir /path/to/ckpt --metrics /path/to/metrics.jsonl
"""
from __future__ import annotations

import argparse

import torch

from ..configs.registry import ARCHS, REDUCED
from ..train.loop import TrainConfig, train


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-runnable)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=TrainConfig.warmup,
                    help="linear warmup steps of the cosine schedule")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics", default=None)
    ap.add_argument("--stop-at-step", type=int, default=None,
                    help="exit cleanly (rc 0) after this step without "
                         "completing (elastic-launcher fault injection)")
    ap.add_argument("--crash-at-step", type=int, default=None,
                    help="hard-kill (os._exit) after this step's async "
                         "checkpoint lands (elastic-launcher fault "
                         "injection)")
    args = ap.parse_args()

    cfg = (REDUCED if args.reduced else ARCHS)[args.arch]
    tc = TrainConfig(steps=args.steps, global_batch=args.batch,
                     seq_len=args.seq, lr=args.lr, warmup=args.warmup,
                     microbatches=args.microbatches,
                     grad_compression=args.grad_compression,
                     ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                     log_every=args.log_every,
                     metrics_path=args.metrics,
                     stop_at_step=args.stop_at_step,
                     crash_at_step=args.crash_at_step)
    _, _, info = train(cfg, tc, device=args.device)
    if info["losses"]:
        peak = ""
        if torch.device(args.device).type == "cuda":
            peak = f" peak_alloc_bytes={torch.cuda.max_memory_allocated()}"
        print(f"[train] arch={cfg.name} steps={info['last_step'] + 1} "
              f"first_loss={info['losses'][0]:.4f} "
              f"last_loss={info['losses'][-1]:.4f}{peak}")


if __name__ == "__main__":
    main()

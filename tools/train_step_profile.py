#!/usr/bin/env python3
"""Where a full-width train step's time goes, on one GPU.

    python3 tools/train_step_profile.py [--arch qwen1.5-0.5b] [--batch 8]
        [--seq 256]

In one process on the card: ``init`` (seed 0), 8 train steps of
SyntheticLM batches (host clock to a synchronize; the first pays the
``torch._dynamo`` import of ``torch.utils.checkpoint`` and the
allocator's growth), then, on the last step's state, the parts of a step
timed alone (3 repeats after a warm-up): the gradients with remat and
without, the AdamW update, a no-grad forward; a step's peak allocated
bytes; two steps under ``torch.profiler`` (``chip_smoke.device_profile``:
device busy ms, the busy share, the costliest kernels); and a ``(params,
AdamWState)`` checkpoint saved and restored (with and without SHA256
checks) under ``build/``, then removed.  Prints one JSON object per
part and writes them all to ``chiprun_out/train_step_profile.json``.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.configs.registry import ARCHS
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import get_model
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.step import (make_grad_fn, make_train_step,
                                        softmax_xent, value_and_grad)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    res = {"card": card, "arch": args.arch, "batch": args.batch,
           "seq": args.seq}

    def report(part, **figures):
        res[part] = figures
        print(part, json.dumps(figures), flush=True)

    cfg = ARCHS[args.arch]
    model = get_model(cfg)
    t0 = time.perf_counter()
    params = model.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(leaf.numel() for _, leaf in ckpt._leaf_paths(params))
    report("init", seconds=time.perf_counter() - t0, parameters=n_params)
    opt = AdamW(lr=cosine_schedule(1e-3, 10, 100))
    state = opt.init(params)
    step = make_train_step(cfg, model, opt)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=args.seq,
                                  global_batch=args.batch, seed=0))

    def batch_at(i):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
                for k, v in data.batch(i).items()}

    times = []
    for i in range(8):
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch_at(i))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    report("steps", seconds=times, loss=float(m["loss"]))

    batch = batch_at(8)

    def timed(fn, n=3):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n

    def loss_without_remat(p, b):
        logits = model.forward(cfg, p, b["tokens"], remat=False)
        return softmax_xent(logits[:, :-1], b["labels"][:, 1:],
                            cfg.vocab_size)

    grad_fn = make_grad_fn(cfg, model)
    _, grads = grad_fn(params, batch)
    with torch.no_grad():
        fwd = timed(lambda: model.forward(cfg, params, batch["tokens"]))
    report("parts_s", grads_remat=timed(lambda: grad_fn(params, batch)),
           grads_no_remat=timed(lambda: value_and_grad(
               loss_without_remat, params, batch)),
           update=timed(lambda: opt.update(grads, state, params)),
           forward_no_grad=fwd)
    del grads
    torch.cuda.reset_peak_memory_stats()
    params, state, _ = step(params, state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    report("profile", step_peak_bytes=peak, **chip_smoke.device_profile(
        lambda: step(params, state, batch), iters=2, top=8))

    d = ROOT / "build" / "train_step_profile_ckpt"
    shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    ckpt.save(d, 1, (params, state), {"step": 1})
    saved = time.perf_counter() - t0
    meta = model.init(cfg, device="meta")
    template = (meta, AdamW().init(meta))
    figures = {"save_s": saved, "bytes": sum(
        f.stat().st_size for f in (d / "step_00000001").iterdir())}
    for verify in (True, False):
        t0 = time.perf_counter()
        ckpt.restore(d, 1, template, device="cuda", verify=verify)
        torch.cuda.synchronize()
        figures[f"restore_s_verify_{verify}"] = time.perf_counter() - t0
    shutil.rmtree(d, ignore_errors=True)
    report("checkpoint", **figures)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "train_step_profile.json").write_text(json.dumps(res, indent=1))
    print(card, flush=True)


if __name__ == "__main__":
    main()

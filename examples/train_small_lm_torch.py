"""Train a small LM end-to-end with the PyTorch port's fault-tolerant loop
(twin of ``examples/train_small_lm.py``): deterministic data, async
checkpoints, preemption-safe resume.  The full-size run is the same code
path through ``python -m repro_torch.launch.train --arch <id>``.

  PYTHONPATH=src python examples/train_small_lm_torch.py [--steps 200] \
      [--device cpu]
"""
import argparse
import json
import tempfile
from pathlib import Path

from repro_torch.configs.registry import REDUCED
from repro_torch.train.loop import TrainConfig, train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = REDUCED[args.arch].replace(vocab_size=256)
    workdir = Path(tempfile.mkdtemp(prefix="repro_torch_train_"))
    tc = TrainConfig(steps=args.steps, global_batch=args.batch,
                     seq_len=args.seq, lr=1e-3, warmup=20,
                     ckpt_dir=str(workdir / "ckpt"),
                     ckpt_every=50,
                     metrics_path=str(workdir / "metrics.jsonl"))
    _, _, info = train(cfg, tc, device=args.device)
    losses = info["losses"]
    print(f"steps={len(losses)} loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"(ckpts in {workdir}/ckpt)")
    assert losses[-1] < losses[0], "loss should decrease"
    for line in Path(tc.metrics_path).read_text().splitlines()[-3:]:
        print(" ", json.loads(line))


if __name__ == "__main__":
    main()

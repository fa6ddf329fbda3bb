#!/usr/bin/env python3
"""Time ``decode_attn_int8`` of several checkouts of the port on the same
inputs, in turns, on one GPU.

    python3 tools/decode_attn_ab.py PARENT_DIR . . PARENT_DIR

Each argument is the root of a checkout; each is timed in its own child
process (its ``src/repro_torch`` imported, its kernel built there), in
the order given.  The inputs are ``chip_smoke.py``'s (this checkout's):
qwen1.5-0.5b's decode shape (T 256, Hkv 16, G 1, D 64, bf16 q) at batch
1, 2, 4 and 8 with the cache lengths of the timed decode step (the first
B requests' prompts + 30), and the same with the first cache filled to
T.  Each launch goes through the public wrapper with its default f32
store, so every checkout makes the same call; where the wrapper takes
``out_dtype``, the bf16 store (the served one) is timed too.  Device ms
per launch from a CUDA graph (``chip_smoke.graph_ms``).  Prints one JSON
line per checkout and run.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def child(checkout: Path) -> dict:
    sys.path[:0] = [str(checkout / "src"), str(ROOT)]
    import inspect

    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.configs.registry import ARCHS
    from repro_torch.kernels import decode_attn_int8 as k
    from repro_torch.nn.attention import quantize_kv_rows
    T, H, G, D = cs.TOKEN_MAX_LEN, 16, 1, 64
    served = [min(len(p) + 30, T - 1)
              for p, _, _ in cs.token_requests(ARCHS["qwen1.5-0.5b"])]
    bf16_store = "out_dtype" in inspect.signature(k.decode_attn_int8).parameters
    rng = np.random.default_rng(0)
    rows = []
    for B in (1, 2, 4, 8):
        q = cs._randn(torch, rng, (B, H, G, D), dtype=torch.bfloat16)
        k8, ks = quantize_kv_rows(cs._randn(torch, rng, (B, T, H, D)))
        v8, vs = quantize_kv_rows(cs._randn(torch, rng, (B, T, H, D)))
        for full in (False, True):
            lengths = [T] + served[:B - 1] if full else served[:B]
            lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            args = (q, k8, v8, ks, vs, lens, D ** -0.5, None)
            row = dict(B=B, lengths=lengths,
                       f32_ms=cs.graph_ms(lambda: k.decode_attn_int8(*args)))
            if bf16_store:
                row["bf16_ms"] = cs.graph_ms(lambda: k.decode_attn_int8(
                    *args, out_dtype=torch.bfloat16))
            rows.append(row)
    return {"checkout": str(checkout), "card": torch.cuda.get_device_name(0),
            "rows": rows}


def main() -> None:
    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        print(json.dumps(child(Path(sys.argv[2]).resolve())), flush=True)
        return
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    for run, checkout in enumerate(sys.argv[1:]):
        out = subprocess.run(
            [sys.executable, __file__, "--child", checkout],
            capture_output=True, text=True, check=True, timeout=600)
        line = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(dict(run=run, **line)), flush=True)


if __name__ == "__main__":
    main()

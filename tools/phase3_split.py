#!/usr/bin/env python3
"""Where ``chip_smoke.py`` phase 3's seconds go, on one GPU.

    python3 tools/phase3_split.py

Builds the kernels, then runs each of phase 3's checks (``check_m2q``
... ``check_decode_attn``, at the shapes ``main()`` gives them) with a
host clock, after a synchronize, around the check and around its parts:
the CUDA-graph timings (``graph_ms``), the eager timings (``cuda_ms``),
the graph replays and the SDPA reference of the decode rows, the
scheme selection and the quantizers that build the synthetic weights.
What no part claims is the rest of the check: its inputs' draws, the
correctness calls and their comparisons.  Prints one JSON line per
check and writes them to ``chiprun_out/phase3_split.json``.
"""
from __future__ import annotations

import functools
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main() -> None:
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.configs.registry import ARCHS
    from repro_torch.core import qtensor, scheme_select
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        sys.exit("phase3_split: needs a GPU")
    seconds = defaultdict(float)
    depth = [0]  # a part timed inside another counts to the outer one

    def clocked(fn, key):
        @functools.wraps(fn)
        def wrapper(*args, **kw):
            depth[0] += 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.synchronize()
                depth[0] -= 1
                if depth[0] == 0:
                    seconds[key] += time.perf_counter() - t0
        return wrapper

    for name in ("graph_ms", "cuda_ms", "graph_replays",
                 "sdpa_reference_ms"):
        setattr(cs, name, clocked(getattr(cs, name), name))
    scheme_select.select_schemes = clocked(scheme_select.select_schemes,
                                           "select_schemes")
    for cls in (qtensor.QM2Q, qtensor.QUniform, qtensor.QAPoT):
        cls.quantize = classmethod(clocked(cls.quantize.__func__,
                                           f"{cls.__name__}.quantize"))

    print(build.build_all()[-300:], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ARCHS["efficientvit-b1-r224"]
    m2q_calls, dw_calls, attn_calls = cs.main_path_calls(cfg, cs.BATCH)
    r = -(-cfg.img_res // 2)
    stem_call = ("stem/w", cs.BATCH * r * r, 27, cfg.widths[0])
    qwen = ARCHS["qwen1.5-0.5b"]
    lm_head_call = ("lm_head", cs.TOKEN_BATCH, qwen.d_model,
                    qwen.padded_vocab)
    pool = [(name, ARCHS[name]) for name in cs.LM_POOL]
    moe_lms = [(name, ARCHS[name].replace(n_layers=layers))
               for name, layers, _ in cs.MOE_CASES]
    recurrent = [(name, ARCHS[name]) for name in ("rwkv6-3b",
                                                  "recurrentgemma-9b")]
    heads = {f"{name} lm_head": [("lm_head", cs.TOKEN_BATCH, c.d_model,
                                  c.padded_vocab)]
             for name, c in pool + moe_lms[:1] + recurrent}
    rng = np.random.default_rng(0)
    checks = [
        ("m2q_matmul", lambda: cs.check_m2q(torch, rng, {
            "m2q-w8a8": m2q_calls,
            **cs.token_m2q_calls(qwen, cs.TOKEN_BATCH, cs.PREFILL_LEN),
            **cs.token_m2q_calls(ARCHS["minitron-4b"], cs.TOKEN_BATCH,
                                 cs.POOL_PREFILL_LEN, "minitron-4b mixed"),
            **cs.moe_m2q_calls(moe_lms[1][1], cs.TOKEN_BATCH,
                               cs.POOL_PREFILL_LEN, "dbrx-132b"),
            **cs.rwkv_m2q_calls(recurrent[0][1], cs.TOKEN_BATCH,
                                (2, cs.RECURRENT_LENGTHS[-1]),
                                "rwkv6-3b mixed")})),
        ("dwconv_w4", lambda: cs.check_dwconv(torch, rng, dw_calls)),
        ("relu_attn", lambda: cs.check_attn(torch, rng, attn_calls)),
        ("relu_attn_scales", lambda: cs.check_scales(torch, rng,
                                                     attn_calls)),
        ("int8_matmul", lambda: cs.check_int8(
            torch, rng, {"uniform8": m2q_calls, "int8-stem": [stem_call]})),
        ("int4_matmul", lambda: cs.check_weights_only(
            torch, rng, "int4_matmul", {"w4-weights-only": m2q_calls,
                                        "qwen-decode-step": [lm_head_call],
                                        **heads})),
        ("apot_matmul", lambda: cs.check_weights_only(
            torch, rng, "apot_matmul", {"weights-only-apot": m2q_calls})),
        ("decode_attn_int8", lambda: cs.check_decode_attn(
            torch, rng, qwen.n_layers, pool + moe_lms)),
    ]
    out = {}
    for name, check in checks:
        before = dict(seconds)
        t0 = time.perf_counter()
        tally = check()
        row = {"s": time.perf_counter() - t0, "rows": len(tally.rows)}
        row.update({k: v - before.get(k, 0.0) for k, v in seconds.items()
                    if v - before.get(k, 0.0) > 0.0})
        row["rest_s"] = row["s"] - sum(v for k, v in row.items()
                                       if k not in ("s", "rows"))
        out[name] = row
        print(name, json.dumps(row), flush=True)
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "phase3_split.json").write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()

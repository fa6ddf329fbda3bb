"""The serving CLI (twin of ``repro.launch.serve``): PTQ-quantize a
model with M2Q and serve batched requests through the continuous-batching
token engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
      --reduced --requests 8 --max-new 16 [--device cpu]

``--arch`` takes the port's LMs: the dense qwen1.5-0.5b, qwen3-14b,
granite-3-8b, minitron-4b and internvl2-2b (served as text: the token
engine takes no patch prefix, as in the JAX package), the MoE
llama4-scout-17b-a16e and dbrx-132b, and the recurrent rwkv6-3b and
recurrentgemma-9b (served through exact-length prefill buckets;
recurrentgemma-9b only with ``--no-quant``: the CLI's m2q-w8a8 recipe
calibrates, which that family cannot do in the reference either).

The engine runs on ``--device`` (the card by default).  ``--mesh
DATAxMODEL`` serves sharded (``dist.sharding``, the engines' ``mesh=``):
one process per rank, launched by ``torchrun``, whose environment
(``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``) joins them;
the mesh must cover every rank.  The process group's backend is printed:
NCCL where every rank has a card of its own, gloo on the CPU and for
several ranks on one card (``launch.mesh.pick_backend``).  Every rank
builds the same tree from seed 0 and submits the same requests; rank 0
prints the report.  Every family above takes a model axis that divides
it (``dist.spmd.local_config``): the dense and MoE LMs' heads, FFN and
vocab, the MoE experts (expert-parallel), recurrentgemma's heads and
FFN (its recurrence replicated), rwkv's embedding and lm_head.  The
sharded steps run eagerly:

  python -m torch.distributed.run --nproc-per-node 4 \
      -m repro_torch.launch.serve --arch qwen1.5-0.5b --reduced \
      --device cpu --mesh 2x2

One flag is the port's own, not in the JAX CLI: ``--kv-cache-dtype``.
The registry's qwen1.5-0.5b keeps a bf16 cache, so without it the CLI
could not serve the int8-KV deployment whose decode attention runs the
``decode_attn_int8`` kernel on the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np

from ..configs.registry import ARCHS, REDUCED
from ..models import get_model
from ..recipe import QuantizedModel, as_recipe, quantize
from ..serving.engine import Engine

def quantize_for_serving(cfg, params, batch: int = 2, calib_len: int = 32,
                         recipe="m2q-w8a8") -> QuantizedModel:
    """Offline PTQ via the recipe API: calibrate on random prompts, apply
    M2Q, return the persistable artifact.  Only the prompt shape is
    overridden; the recipe's other CalibSpec fields (batches, seed) are
    kept.  ``params`` is handed over: each float leaf is dropped from it
    once quantized (``recipe.quantize(..., release=True)``), so a float
    tree that fills most of the card (qwen3-14b's) quantizes there."""
    rec = as_recipe(recipe)
    rec = rec.replace(calib=dataclasses.replace(
        rec.calib, batch_size=batch, seq_len=calib_len))
    return quantize(cfg, params, rec, release=True)


def parse_mesh(spec: str, device: str = "cuda", world: int = None,
               rank: int = None, init_method: str = "env://"):
    """'DATAxMODEL' (e.g. '2x2') -> a ``DeviceMesh`` over (data, model)
    spanning the process group, joined here if it is not yet (``torchrun``'s
    environment by default).  The mesh must cover exactly the world's
    ranks (one process each)."""
    try:
        n_data, n_model = (int(p) for p in spec.lower().split("x"))
    except ValueError:
        raise SystemExit(f"--mesh wants DATAxMODEL (e.g. 4x4), got {spec!r}")
    import torch.distributed as dist
    if world is None:
        world = (dist.get_world_size() if dist.is_initialized()
                 else int(os.environ.get("WORLD_SIZE", "1")))
    n = n_data * n_model
    if n > world:
        raise SystemExit(
            f"--mesh {spec} needs {n} ranks but only {world} exist (launch "
            f"one process per rank: python -m torch.distributed.run "
            f"--nproc-per-node {n} -m repro_torch.launch.serve ...)")
    if n < world:
        raise SystemExit(
            f"--mesh {spec} covers {n} of {world} ranks; the port's "
            "sharded engines span every rank")
    from .mesh import init_ranks, make_mesh
    if rank is None:
        rank = (dist.get_rank() if dist.is_initialized()
                else int(os.environ.get("RANK", "0")))
    backend, why = init_ranks(device, world, rank, init_method)
    if rank == 0:
        print(f"[serve] mesh={n_data}x{n_model} backend={backend} ({why})",
              flush=True)
    return make_mesh((n_data, n_model), ("data", "model"),
                     "cuda" if device.startswith("cuda") else "cpu")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-delay-ms", type=float, default=0.0,
                    help="admission deadline: >0 coalesces prefills until "
                         "the batch fills or the oldest request ages out")
    ap.add_argument("--mesh", default=None,
                    help="DATAxMODEL (e.g. 2x2): sharded execution via "
                         "repro_torch.dist.sharding, one torchrun rank "
                         "each")
    ap.add_argument("--no-quant", action="store_true")
    ap.add_argument("--kv-cache-dtype", choices=("bf16", "int8"),
                    default=None,
                    help="the KV cache (default: the config's); port-only")
    ap.add_argument("--device", default="cuda",
                    help="where the model and engine live (cuda or cpu)")
    args = ap.parse_args(argv)
    mesh = parse_mesh(args.mesh, args.device) if args.mesh else None
    lead = mesh is None or mesh.get_rank() == 0

    cfg = (REDUCED if args.reduced else ARCHS)[args.arch]
    if args.kv_cache_dtype:
        cfg = cfg.replace(kv_cache_dtype=args.kv_cache_dtype)
    params = get_model(cfg).init(cfg, seed=0, device=args.device)
    engine_kw = dict(max_batch=args.max_batch, max_len=args.max_len,
                     max_delay_ms=args.max_delay_ms)
    if mesh is not None:  # eager: gloo collectives cannot be captured
        engine_kw.update(mesh=mesh, graphs=False)
    if not args.no_quant:
        qm = quantize_for_serving(cfg, params)
        del params
        bits = {r.path: r.bits for r in qm.report}
        if lead:
            print(f"[serve] quantized {len(qm.report)} layers; "
                  f"avg bits={np.mean(list(bits.values())):.2f}")
        eng = qm.serve(**engine_kw)
    else:
        eng = Engine(cfg, params, **engine_kw)
    rng = np.random.default_rng(1)
    for _ in range(args.requests):
        plen = int(rng.integers(4, 17))
        eng.submit(rng.integers(0, cfg.vocab_size, plen, dtype=np.int32),
                   max_new_tokens=args.max_new)
    t0 = time.time()
    stats = eng.run()  # ends on a completion's read: the card is done
    dt = time.time() - t0
    if not lead:
        return
    print(f"[serve] arch={cfg.name} requests={stats.finished} "
          f"decoded={stats.decoded_tokens} steps={stats.steps} "
          f"tok/s={stats.decoded_tokens / max(dt, 1e-9):.1f}"
          + (f" mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))}"
             if mesh is not None else ""))
    print(f"[serve] queue p50={stats.p50_ms:.2f}ms p99={stats.p99_ms:.2f}ms "
          f"prefill-occupancy={stats.batch_occupancy:.2f} "
          f"padded-fraction={stats.padded_fraction:.2f} "
          f"flushes={stats.flush_reasons}")


if __name__ == "__main__":
    main()

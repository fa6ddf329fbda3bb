"""A pool of gloo ranks on the CPU for the port's sharding tests: four
processes joined into one process group, spawned once per test module,
each running the named function of this module on command (torch and
``repro_torch`` only: no JAX in the ranks).  A command that does not
answer within its timeout kills the pool (a rank stuck in a collective
cannot be recovered), failing that test; the next command starts a new
pool."""
from __future__ import annotations

import os
import queue
import socket
import sys
import time
import traceback

import numpy as np

WORLD = 4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(rank: int, world: int, port: int, inbox, outbox) -> None:
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    meshes = {}

    def mesh(shape):
        if shape not in meshes:
            from repro_torch.launch.mesh import make_debug_mesh
            meshes[shape] = make_debug_mesh(*shape, device_type="cpu")
        return meshes[shape]

    while True:
        cmd = inbox.get()
        if cmd is None:
            break
        name, kw = cmd
        try:
            out = ("ok", globals()[name](mesh, rank, **kw))
        except BaseException:  # noqa: BLE001 -- reported to the test
            out = ("err", traceback.format_exc())
        outbox.put((rank, out))
    dist.destroy_process_group()


class MeshPool:
    def __init__(self, world: int = WORLD):
        self.world = world
        self.procs = []

    def _start(self):
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        port = _free_port()
        self.outbox = ctx.Queue()
        self.inboxes = [ctx.Queue() for _ in range(self.world)]
        self.procs = [ctx.Process(target=_worker, daemon=True,
                                  args=(r, self.world, port, self.inboxes[r],
                                        self.outbox))
                      for r in range(self.world)]
        for p in self.procs:
            p.start()

    def run(self, name: str, timeout: float = 60.0, **kw) -> list:
        """``name(mesh, rank, **kw)`` on every rank; their results in rank
        order.  A rank's exception fails the call with its traceback."""
        if not self.procs:
            self._start()
        for box in self.inboxes:
            box.put((name, kw))
        got = {}
        deadline = time.monotonic() + timeout
        while len(got) < self.world:
            try:
                rank, out = self.outbox.get(
                    timeout=max(0.1, deadline - time.monotonic()))
            except queue.Empty:
                self.close(kill=True)
                raise TimeoutError(
                    f"{name}: ranks {sorted(set(range(self.world)) - set(got))}"
                    f" did not answer within {timeout:.0f} s")
            got[rank] = out
        errs = [f"rank {r}:\n{o[1]}" for r, o in sorted(got.items())
                if o[0] == "err"]
        if errs:
            self.close(kill=True)
            raise RuntimeError("\n".join(errs))
        return [got[r][1] for r in range(self.world)]

    def close(self, kill: bool = False) -> None:
        for p, box in zip(self.procs, getattr(self, "inboxes", [])):
            if kill:
                p.kill()
            else:
                box.put(None)
        for p in self.procs:
            p.join(10)
            if p.is_alive():
                p.kill()
        self.procs = []


# ---------------------------------------------------------------------------
# what the ranks run: fn(mesh, rank, **kw)
# ---------------------------------------------------------------------------


def _sharded(mesh_of, shape):
    from repro_torch.dist import sharding as shd
    mesh = mesh_of(shape)
    return mesh, (lambda tree: shd.shardings_from_specs(
        shd.param_specs(tree, mesh), mesh))


def placement(mesh_of, rank, art, shape=(2, 2)):
    """An artifact placed two ways -- ``put_global`` of the host tree and
    ``QuantizedModel.load(..., shardings=)`` -- each checked leaf by leaf
    against its spec (``launch.daemon.placement_problems``), the shards
    reassembled equal to the host tree, and the decode cache and a token
    batch placed likewise."""
    import torch
    from repro_torch.core.tree import leaves_with_path
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.daemon import placement_problems
    from repro_torch.recipe import QuantizedModel
    mesh, shardings = _sharded(mesh_of, shape)
    host = QuantizedModel.load(art, device="cpu")
    specs = shd.param_specs(host.params, mesh)
    out = {}
    glob = shd.put_global(host.params, specs, mesh)
    loaded = QuantizedModel.load(art, device="cpu", shardings=shardings)
    for what, tree in (("put_global", glob), ("restore", loaded.params)):
        problems, n, sharded = placement_problems(tree, specs, mesh)
        want = dict(shd.flat_arrays(host.params))
        for path, leaf in shd.flat_arrays(tree):
            if not torch.equal(leaf.full_tensor(), want[path]):
                problems.append(f"{path}: shards do not reassemble")
        out[what] = {"problems": problems, "leaves": n, "sharded": sharded,
                     "local": {p: tuple(x.to_local().shape)
                               for p, x in shd.flat_arrays(tree)}}
    from repro_torch.models import get_model
    cfg = host.cfg
    cache = get_model(cfg).init_cache(cfg, 8, 16, dtype=torch.float32,
                                      device="cpu")
    batch = {"tokens": torch.zeros((8, 4), dtype=torch.int64)}
    for what, tree, specs in (
            ("cache", cache, shd.cache_specs(cache, mesh, shard_model=True)),
            ("batch", batch, shd.batch_specs(batch, mesh))):
        problems, n, sharded = placement_problems(
            shd.put_global(tree, specs, mesh), specs, mesh)
        out[what] = {"problems": problems, "leaves": n, "sharded": sharded}
    out["coordinate"] = tuple(mesh.get_coordinate())
    out["paths"] = [p for p, _ in leaves_with_path(host.params)]
    return out


def save_sharded(mesh_of, rank, art, out_dir, shape=(2, 2)):
    """A sharded model saved (every rank calls, rank 0 writes)."""
    from repro_torch.recipe import QuantizedModel
    mesh, shardings = _sharded(mesh_of, shape)
    qm = QuantizedModel.load(art, device="cpu", shardings=shardings)
    qm.save(out_dir)
    return True


def vision(mesh_of, rank, art, images, shape, max_batch=4, attn="int8",
           skew_s=0.0):
    """Reduced B1 served on ``shape``: ``classify`` of ``images``, then
    the same images submitted (rank 1 late by ``skew_s``) and flushed,
    and polled once more; the engine's bucket floor and image counts.
    Then one image with a 50 ms deadline that rank 0 lets expire in its
    queue: rank 1 submits it only after the poll that brought rank 0's
    expiry, the others before; each rank's handle state and error."""
    from repro_torch.recipe import QuantizedModel
    mesh, shardings = _sharded(mesh_of, shape)
    qm = QuantizedModel.load(art, device="cpu", shardings=shardings)
    eng = qm.serve(max_batch=max_batch, graphs=False, mesh=mesh, attn=attn)
    a = eng.classify(images)
    if rank == 1:
        time.sleep(skew_s)
    hs = [eng.submit(im) for im in images]
    b = eng.flush()
    eng.poll()
    if rank != 1:
        late = eng.submit(images[0], deadline_ms=50.0)
    if rank == 0:
        time.sleep(0.2)
    eng.poll()
    if rank == 1:
        late = eng.submit(images[0], deadline_ms=50.0)
    return {"classify": a, "flush": b, "done": [h.done() for h in hs],
            "min_bucket": eng.min_bucket,
            "stats": (eng.stats.images, eng.stats.padded_images),
            "expired": (late.state, type(late.exception()).__name__)}


def tokens(mesh_of, rank, art, requests, shape, max_batch=4, max_len=64,
           skew_s=0.0, seed=0, daemon=False):
    """A token artifact served on ``shape``: every request submitted
    (rank 1 late by ``skew_s``), run to the end -- or served through a
    ``ServingDaemon`` -- and each handle's tokens; the cache's placements
    against ``cache_specs``."""
    from repro_torch.dist import sharding as shd
    from repro_torch.recipe import QuantizedModel
    mesh, shardings = _sharded(mesh_of, shape)
    qm = QuantizedModel.load(art, device="cpu", shardings=shardings)
    eng = qm.serve(max_batch=max_batch, max_len=max_len, seed=seed,
                   graphs=False, mesh=mesh)
    if rank == 1:
        time.sleep(skew_s)
    if daemon:
        from repro_torch.serving.daemon import ServingDaemon
        with ServingDaemon(eng) as d:
            reqs = [d.submit(np.asarray(p, np.int32), slo="batch",
                             max_new_tokens=n, temperature=t)
                    for p, n, t in requests]
            out = [r.handle.result(timeout=60) for r in reqs]
    else:
        reqs = [eng.submit(np.asarray(p, np.int32), max_new_tokens=n,
                           temperature=t) for p, n, t in requests]
        eng.run()
        out = [r.handle.result() for r in reqs]
    cache = eng.sharded_cache()
    full = {k: tuple(v.shape) for k, v in cache.items()}
    import torch
    specs = shd.cache_specs({k: torch.empty(s, device="meta")
                             for k, s in full.items()}, mesh,
                            shard_model=True)
    placed = {k: tuple(v.placements) == tuple(
        shd.NamedSharding(mesh, specs[k]).placements)
        for k, v in cache.items()}
    return {"tokens": out, "placed": placed, "full": full,
            "local": {k: tuple(v.to_local().shape) for k, v in cache.items()},
            "steps": eng.stats.steps}


def idle_gap(mesh_of, rank, art, requests, gap_s, timeout_s, shape=(2, 2)):
    """A token artifact served on ``shape`` by a ``ServingDaemon`` on every
    rank with the world group's collective timeout cut to ``timeout_s``:
    the first half of ``requests``, then ``gap_s`` with nothing to serve
    (the other ranks wait in rank 0's broadcast), then the rest.  Each
    request's tokens and rank 0's keep-alive; the timeout is restored
    afterwards."""
    import datetime
    from torch.distributed.distributed_c10d import _set_pg_timeout
    from repro_torch.recipe import QuantizedModel
    from repro_torch.serving.daemon import ServingDaemon
    mesh, shardings = _sharded(mesh_of, shape)
    qm = QuantizedModel.load(art, device="cpu", shardings=shardings)
    eng = qm.serve(max_batch=4, max_len=64, seed=0, graphs=False, mesh=mesh)
    half = len(requests) // 2
    _set_pg_timeout(datetime.timedelta(seconds=timeout_s))
    try:
        with ServingDaemon(eng) as d:
            def serve(reqs):
                rs = [d.submit(np.asarray(p, np.int32), slo="batch",
                               max_new_tokens=n, temperature=t)
                      for p, n, t in reqs]
                return [r.handle.result(timeout=60) for r in rs]
            out = serve(requests[:half])
            time.sleep(gap_s)
            out += serve(requests[half:])
            keepalive = eng.lockstep.keepalive_s
    finally:
        _set_pg_timeout(datetime.timedelta(minutes=30))
    return {"tokens": out, "keepalive_s": keepalive}


def refused(mesh_of, rank, art, shape=(2, 2)):
    """What a sharded engine refuses -- ``graphs=True`` on more than one
    rank (both engines) -- and what it now takes: an MoE model on a
    model axis > 1 (llama4-scout's float tree, experts split over
    ``model``), built and serving one greedy request."""
    from repro_torch.configs.registry import REDUCED
    from repro_torch.models import dense_lm
    from repro_torch.recipe import QuantizedModel
    from repro_torch.serving.engine import Engine
    mesh, shardings = _sharded(mesh_of, shape)
    qm = QuantizedModel.load(art, device="cpu", shardings=shardings)
    out = {}
    try:
        qm.serve(mesh=mesh)
        out["graphs"] = None
    except ValueError as e:
        out["graphs"] = str(e)
    cfg = REDUCED["llama4-scout-17b-a16e"]
    eng = Engine(cfg, dense_lm.init(cfg, device="cpu"), mesh=mesh,
                 graphs=False)
    req = eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=3)
    eng.run()
    out["moe"] = req.handle.result()
    return out


def _exec(mesh, cfg, params):
    """A rank's (config, compute tree, runtime) of a tree placed on
    ``mesh`` (what ``Engine(mesh=)`` computes with)."""
    from repro_torch.dist import sharding as shd
    from repro_torch.dist import spmd
    rt = spmd.MeshRuntime(mesh)
    specs = shd.param_specs(params, mesh)
    tree = spmd.local_params(params, specs, rt,
                             gather_kv=spmd.kv_gathered(cfg, rt))
    return spmd.local_config(cfg, rt), tree, rt


def moe_layer(mesh_of, rank, x, shape, art=None, layer=None, mcfg=None):
    """One MoE layer on ``shape`` over ``x`` (T, D): ``layer`` (one
    layer's float ``{"router", "experts"}`` numpy tree, ``mcfg`` its
    ``nn.MoEConfig``) placed on the mesh, or layer 0 of the artifact
    ``art``; this data rank's rows of ``x`` through ``nn.moe_ffn``.
    Returns this rank's rows of the output and its local expert count."""
    import torch
    from repro_torch import nn
    from repro_torch.dist import sharding as shd
    from repro_torch.dist import spmd
    from repro_torch.models import dense_lm
    from repro_torch.recipe import QuantizedModel
    mesh, shardings = _sharded(mesh_of, shape)
    if art is not None:
        qm = QuantizedModel.load(art, device="cpu", shardings=shardings)
        mcfg = dense_lm.moe_config(qm.cfg)
        _, tree, rt = _exec(mesh, qm.cfg, qm.params)
        moe = dense_lm.layer_params(tree["layers"], 0)["moe"]
    else:
        host = {"router": torch.from_numpy(layer["router"]),
                "experts": {k: torch.from_numpy(v)
                            for k, v in layer["experts"].items()}}
        rt = spmd.MeshRuntime(mesh)
        specs = shd.param_specs(host, mesh)
        moe = spmd.local_params(shd.put_global(host, specs, mesh), specs,
                                rt)
    rows = rt.rows(x.shape[0])
    with torch.no_grad():
        y = nn.moe_ffn(torch.from_numpy(x[rows]), moe, mcfg)
    experts = moe.experts if hasattr(moe, "experts") else moe["experts"]
    return {"y": y.numpy(), "experts": int(experts["w1"].shape[-3])}


def forced_logits(mesh_of, rank, art, prompts, forced, shape, max_len=64):
    """The teacher-forced logits (``launch.daemon.teacher_forced_logits``)
    of a sharded artifact's compute tree on ``shape``: every rank runs
    every prompt (its MoE layers route the rows they are given:
    ``spmd.whole_rows``), on its model shards.  Also the engine's
    local config's heads."""
    from repro_torch.dist import spmd
    from repro_torch.launch.daemon import teacher_forced_logits
    from repro_torch.recipe import QuantizedModel
    mesh, shardings = _sharded(mesh_of, shape)
    qm = QuantizedModel.load(art, device="cpu", shardings=shardings)
    cfg, tree, _ = _exec(mesh, qm.cfg, qm.params)
    tree = spmd.whole_rows(tree) or tree
    lg = teacher_forced_logits(cfg, tree, prompts, np.asarray(forced),
                               max_len)
    return {"logits": lg.numpy(), "heads": (cfg.n_heads, cfg.n_kv_heads)}


def vision_refused(mesh_of, rank, art, shape=(2, 2)):
    """``graphs=True`` on a multi-rank vision engine."""
    from repro_torch.recipe import QuantizedModel
    mesh, shardings = _sharded(mesh_of, shape)
    qm = QuantizedModel.load(art, device="cpu", shardings=shardings)
    try:
        qm.serve(mesh=mesh, max_batch=4)
    except ValueError as e:
        return str(e)
    return None


def clis(mesh_of, rank, art_dir):
    """Both CLIs on this pool's process group: ``launch.serve --mesh
    2x2`` and ``launch.daemon --coordinator ... --mesh 2x2`` (its
    placement check, the serve loop over the daemon), at REDUCED width
    on the CPU; their exit codes and printed lines."""
    import contextlib
    import io
    from repro_torch.launch import daemon, serve
    common = ["--arch", "qwen1.5-0.5b", "--reduced", "--device", "cpu",
              "--requests", "4", "--max-new", "4"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(common + ["--mesh", "2x2"])
    out = {"serve": buf.getvalue()}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = daemon.multihost_dryrun(daemon.parse_args(
            common + ["--mesh", "2x2", "--coordinator", "127.0.0.1:1",
                      "--num-processes", "4", "--process-id", str(rank),
                      "--health-file", f"{art_dir}/health"]))
    out["daemon"] = (rc, buf.getvalue())
    return out


if __name__ == "__main__":  # pragma: no cover
    sys.exit("imported by the tests, not run")

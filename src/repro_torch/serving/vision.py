"""Batched vision inference (images in, logits out); twin of
``repro.serving.vision`` without ``FallbackGuard``.

``submit()`` queues one image and returns a handle at once; a batch runs
when it fills to ``max_batch``, when its oldest request is older than
``max_delay_ms`` (checked by :meth:`VisionEngine.poll`), or on
:meth:`VisionEngine.flush`.  Each executed batch is zero-padded up to a
power-of-two bucket (at least ``min_bucket``) and runs one forward on the
engine's device.  Logits are finite-checked per row: a non-finite row
fails its own request with :class:`~.errors.NumericalError` while its
batchmates are delivered.

On CUDA (``graphs=True``, the default) each bucket's forward is a CUDA
graph (:mod:`.graphs`), captured at the bucket's first use over a static
input buffer and replayed for every later batch of that bucket: the twin
of the JAX engine's jitted forward.  ``graphs=False`` runs every forward
eagerly (the twin of ``jax.disable_jit()``), as the CPU always does.

``dispatch=`` (a ``kernels.ops.DispatchConfig``) pins kernel dispatch for
this engine: every batch and every capture runs inside that scope (on
whichever thread runs it) and inside ``autotune.no_tuning()``, so launch
plans come from the autotune cache or ``launch_plan`` and a step never
times candidates.  Each bucket's graph is keyed by the axes as they
resolve at its first use, so a graph replays the routing it was captured
under, and a tripped axis captures anew.

There is no silent retry: a kernel that raises fails its batch's requests
(the scheduler contains the exception) and the engine keeps serving.

``mesh=`` (a ``("data", "model")`` ``DeviceMesh`` over every process,
one rank each) serves data-parallel: the parameters are placed by
``dist.sharding.param_specs`` (``self.params`` holds ``DTensor`` leaves),
the data axis must be a power of two dividing ``max_batch`` (the JAX
engine's errors), ``min_bucket`` is raised to it, and each rank runs its
``data`` slice of every padded bucket, the logits gathered over ``data``.
``relu_attn``'s three scales are tensor-wide over the batch, so they are
max-reduced over ``data`` before the kernel (``ops.batch_scales``), and
each image's logits do not depend on the rank its row lands on.  On more
than one rank the forward runs eagerly (``graphs=True`` raises: gloo
collectives cannot be captured), batches run only in :meth:`poll` /
:meth:`flush` / :meth:`classify`, never inline at submit, and rank 0
decides every batch (``dist.spmd.Lockstep``): it broadcasts the batch's
uids before it runs, and the other ranks' :meth:`poll` / :meth:`flush`
run the same batches of their own handles (every rank submits the same
images in the same order).  The other ranks keep no deadlines: a request
that times out or is cancelled in rank 0's queue ends alike on the
others with rank 0's next message.  ``lockstep`` (None on one rank) is
what a serving daemon reads: a follower keeps polling until rank 0's
``lockstep.release()`` at shutdown, and an idle rank 0 polls every
``lockstep.keepalive_s``.

Fault injection (:mod:`.faults`; ``faults=`` or ``REPRO_FAULT_SPEC``)
fires at the ``vision`` site (each executed batch: a ``nan`` poisons the
first row's logits, and that request alone fails) and at the scheduler's
``executor`` site.  The JAX package's ``vision.kernel`` site fires inside
its ``FallbackGuard``; the port has none (ROADMAP A5), so an injector
that names it is refused when the engine is built rather than accepted
and never fired.  ``heartbeat`` is the wall-clock time ``poll()`` was
last entered.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from ..core.tree import device_of
from ..kernels import ops
from ..models import get_model
from ..models.config import ArchConfig
from . import faults as _faults
from .batching import ServeStats, pow2_bucket
from .errors import NumericalError
from .graphs import for_device, in_use
from .scheduler import DONE, FlushPolicy, Handle, OverloadPolicy, Scheduler


@dataclasses.dataclass
class VisionStats(ServeStats):
    """ServeStats with the vision field names."""

    @property
    def images(self) -> int:
        return self.items

    @property
    def padded_images(self) -> int:
        return self.padded_items


class VisionEngine:
    """Deadline-batched classifier over a (quantized) parameter tree."""

    def __init__(self, cfg: ArchConfig, params, max_batch: int = 64,
                 min_bucket: int = 1,
                 max_delay_ms: Optional[float] = None,
                 attn: Optional[str] = None,
                 clock: Callable[[], float] = time.monotonic,
                 overload: Optional[OverloadPolicy] = None,
                 faults: Optional[_faults.FaultInjector] = None,
                 graphs: bool = True,
                 dispatch: Optional[ops.DispatchConfig] = None,
                 mesh=None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        faults = faults if faults is not None else _faults.from_env()
        if faults is not None and any(
                spec.site == "vision.kernel" for spec in faults.specs):
            raise ValueError(
                "fault site 'vision.kernel' fires inside the JAX "
                "package's FallbackGuard, which the port does not have "
                "(ROADMAP A5: no silent retry on the card); inject at "
                "'vision' or 'executor' instead")
        self.cfg = cfg
        self.model = get_model(cfg)
        self.attn = attn
        self.dispatch = dispatch
        self.B = max_batch
        # the smallest bucket executed: a batch below it is padded up, so
        # only the buckets from min_bucket to max_batch are ever captured
        self.min_bucket = max(1, min_bucket)
        self.mesh = mesh
        self._rt = self.lockstep = None
        self._exec = params  # the tree the forward reads (a rank's shards)
        if mesh is not None:
            params = self._shard(params, mesh, graphs)
        self.params = params
        self.device = device_of(self._exec)
        self.stats = VisionStats()
        self.faults = faults
        # wall-clock time poll() was last entered (supervision liveness)
        self.heartbeat: Optional[float] = None
        self.step_graphs = for_device(self.device, graphs)
        self._inputs = {}  # (bucket, attn) -> its static (bucket, res, res, 3)
        self.scheduler = Scheduler(
            policy=FlushPolicy(max_batch=max_batch, max_delay_ms=max_delay_ms),
            executor=self._execute, stats=self.stats, clock=clock,
            overload=overload, faults=self.faults)
        if self.lockstep is not None:
            self.scheduler.execute_on_submit = False

    def _shard(self, params, mesh, graphs: bool):
        """Place params per dist.sharding and raise the bucket floor to the
        data-axis size so every pow2 batch shards evenly."""
        from ..dist import sharding as shd
        from ..dist import spmd
        data = int(shd._mesh_axes(mesh).get("data", 1))
        if data > 1:
            if data & (data - 1):
                raise ValueError(
                    f"data axis size {data} is not a power of two; pow2 "
                    "batch buckets cannot shard evenly over it")
            if self.B % data:
                raise ValueError(
                    f"max_batch ({self.B}) must be divisible by the data "
                    f"axis size ({data}) for sharded execution")
            self.min_bucket = max(self.min_bucket, data)
        if graphs and mesh.size() > 1:
            raise ValueError(
                "graphs=True on a mesh of more than one rank: the sharded "
                "forward's collectives (gloo) cannot be captured in a CUDA "
                "graph; serve it with graphs=False")
        rt = spmd.MeshRuntime(mesh)
        specs = shd.param_specs(params, mesh)
        placed = spmd.place_tree(params, specs, mesh)
        self._rt = rt
        if rt.size > 1:
            self.lockstep = spmd.Lockstep(rt)
        self._exec = spmd.local_params(placed, specs, rt)
        return placed

    def bucket(self, n: int) -> int:
        """Smallest power of two >= n, floored at min_bucket and capped at
        max_batch: the batch shape actually executed."""
        return pow2_bucket(n, self.min_bucket, self.B)

    def _run_batch(self, images: np.ndarray, bucket: int) -> np.ndarray:
        n = images.shape[0]
        pad = bucket - n
        if pad:
            images = np.concatenate(
                [images, np.zeros((pad,) + images.shape[1:], np.float32)])
        with torch.inference_mode(), ops.engine_step(self.dispatch):
            if in_use(self.step_graphs):
                logits = self._replay(images)
            else:
                logits = self._forward(images)
        self.stats.record_batch(items=n, padded=pad, capacity=self.B,
                                bucket=bucket)
        return logits.to(torch.float32).cpu().numpy()[:n]

    def _forward(self, images: np.ndarray) -> torch.Tensor:
        """The padded bucket's logits, eagerly; on a mesh this rank runs
        its ``data`` slice, its relu_attn scales max-reduced over
        ``data``, and the bucket's logits are gathered."""
        rt = self._rt
        if rt is None:
            return self.model.forward(
                self.cfg, self._exec, torch.from_numpy(images).to(
                    self.device), attn=self.attn)
        x = torch.from_numpy(images[rt.rows(images.shape[0])]).to(
            self.device)
        with ops.batch_scales(lambda s: rt.all_reduce(s, "data", "max")):
            logits = self.model.forward(self.cfg, self._exec, x,
                                        attn=self.attn)
        return rt.all_gather(logits.to(torch.float32), "data", 0)

    def _replay(self, images: np.ndarray) -> torch.Tensor:
        """The bucket's forward replayed from its graph (captured here at
        the bucket's first use); the launch plans depend on the batch, so
        each bucket has its own, and so does each resolution of the
        dispatch axes."""
        static = (images.shape[0], self.attn)
        x = self._inputs.get(static)
        if x is None:
            x = self._inputs[static] = torch.zeros(
                images.shape, dtype=torch.float32, device=self.device)
        x.copy_(torch.from_numpy(images))
        key = (*static, ops.resolve(self.device))
        return self.step_graphs.run(key, lambda: self.model.forward(
            self.cfg, self._exec, x, attn=self.attn))

    def _execute(self, handles: List[Handle], reason: str) -> None:
        """One flushed batch -> per-handle logits, finite-checked per row
        (an exception out of here fails this batch's handles)."""
        if self.lockstep is not None and self.lockstep.leader:
            self.lockstep.share(("batch", [h.uid for h in handles], reason))
        act = (self.faults.on_call("vision")
               if self.faults is not None else None)
        if act is not None:
            act.fire()  # raises and delays before any work runs
        imgs = np.stack([h.payload for h in handles]).astype(np.float32)
        out = self._run_batch(imgs, self.bucket(len(handles)))
        if act is not None and act.poison:
            out = out.copy()
            out[0] = np.nan  # that request fails alone
        for i, (h, row) in enumerate(zip(handles, out)):
            if not np.all(np.isfinite(row)):
                h.set_exception(NumericalError(
                    f"request {h.uid}: non-finite logits (row {i} of the "
                    "executed batch); its result was not delivered"))
            else:
                h.set_result(row)

    def submit(self, image: np.ndarray,
               deadline_ms: Optional[float] = None) -> Handle:
        """Queue one (res, res, 3) image; the handle's ``result()`` is its
        (n_classes,) logits.  A batch it fills runs inline unless a
        serving daemon drives the engine (then submit is host-only).
        Raises ``ValueError`` up front on a wrong
        shape, a non-numeric dtype or NaN/Inf pixels."""
        img = np.asarray(image)
        if img.shape != (self.cfg.img_res, self.cfg.img_res, 3):
            raise ValueError(f"expected ({self.cfg.img_res}, "
                             f"{self.cfg.img_res}, 3), got {img.shape}")
        if not np.issubdtype(img.dtype, np.number) \
                or np.issubdtype(img.dtype, np.complexfloating):
            raise ValueError(
                f"image dtype must be real-numeric pixels, got {img.dtype}")
        if np.issubdtype(img.dtype, np.floating) \
                and not np.all(np.isfinite(img)):
            raise ValueError("image holds NaN/Inf pixels; refusing to "
                             "enqueue a payload that would poison its batch")
        if self.lockstep is not None and not self.lockstep.leader:
            deadline_ms = None  # rank 0 decides expiries
        h = self.scheduler.submit(img, deadline_ms=deadline_ms)
        if self.lockstep is not None:
            self.lockstep.note(h)
        return h

    def _follow(self) -> List[Handle]:
        """A follower's poll / flush: rank 0's batches, run on this rank's
        handles of the same uids, until rank 0's poll / flush ends."""
        ls = self.lockstep
        done: List[Handle] = []
        while not ls.stopped:
            msg = ls.share(None)
            if msg[0] == "batch":
                _, uids, reason = msg
                handles = ls.await_handles(uids)
                self.scheduler.pop(handles, reason)
                self.scheduler._run_executor(handles, reason)
                done.extend(handles)
            elif msg[0] == "stop":
                ls.stopped = True
            else:  # "end"
                break
        return done

    def poll(self) -> int:
        """Execute whatever is due; returns the requests resolved."""
        self.heartbeat = time.monotonic()
        if self.lockstep is None:
            return self.scheduler.poll()
        if self.lockstep.stopped:
            return 0  # rank 0 released the ranks: nothing runs together
        if not self.lockstep.leader:
            return len(self._follow())
        n = self.scheduler.poll()
        self.lockstep.share(("end",))
        return n

    def flush(self) -> Optional[np.ndarray]:
        """Drain every pending image; returns the delivered logits in
        submit order (None if nothing was delivered)."""
        if self.lockstep is None:
            flushed = self.scheduler.drain()
        elif self.lockstep.stopped:
            flushed = []
        elif self.lockstep.leader:
            flushed = self.scheduler.drain()
            self.lockstep.share(("end",))
        else:
            flushed = self._follow()
        ok = [h.result() for h in flushed if h.state == DONE]
        if not ok:
            return None
        return np.stack(ok)

    def classify(self, images) -> np.ndarray:
        """(N, res, res, 3) -> (N, n_classes), bypassing the queue."""
        images = np.asarray(images, np.float32)
        n = images.shape[0]
        if n == 0:
            return np.zeros((0, self.cfg.n_classes), np.float32)
        outs = []
        for start in range(0, n, self.B):
            chunk = images[start:start + self.B]
            outs.append(self._run_batch(chunk, self.bucket(chunk.shape[0])))
            self.stats.record_flush("direct")
        return np.concatenate(outs)

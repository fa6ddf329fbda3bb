"""Continuous-batching token engine over a (quantized) LM parameter tree
(twin of ``repro.serving.engine.Engine`` without ``FallbackGuard``).

Slot-based: a fixed decode batch of ``max_batch`` slots, each holding one
request's KV cache rows (or recurrent state).  Waiting requests are
admitted into free slots by one ragged prefill per group (prompts
right-padded to a power-of-two length, at least 8, at most ``max_len``)
where the model takes per-row lengths (``RAGGED_PREFILL``); a recurrent
family's state must not see padding, so its candidates are bucketed by
exact prompt length, one bucket a pass, the rest admitted on the next
pass, each prefilled unpadded and without ``lengths``.  Every
:meth:`Engine.step` decodes one token for all live slots, and a
finished request frees its slot at once.  Admission runs on the shared
scheduler core in admission mode: with the default ``max_delay_ms=0.0``
waiting requests are admitted whenever a slot is free; a positive delay
coalesces prefills.

Device-resident decode: the pending-token vector, per-slot temperatures,
the output buffer, the emitted counts and a sticky per-slot non-finite
flag live on the engine's device, and sampling (greedy, or Gumbel-max at
a temperature from a ``torch.Generator`` seeded with ``seed`` on that
device) runs there.  Completion is decided by host-side step counting, so
the host reads the device once per completed request: the flag and the
token row, in one transfer.  A request whose logits went non-finite at
any step fails alone with :class:`~.errors.NumericalError`.

On CUDA (``graphs=True``, the default) the decode step is a CUDA graph
(:mod:`.graphs`) at ``(max_batch, max_len)``, one for greedy-only steps
and one that draws (so a greedy step consumes no random numbers, as
eagerly), each captured at its first use; the twin of the JAX engine's
jitted decode step.  The step writes the engine's buffers in place, the
live mask is copied into a static buffer before each replay, and the
draw graph takes its uniforms from the engine's generator as the eager
step would.  Prefill stays eager: its shapes vary with the group and the
padded prompt length.  ``graphs=False`` runs every step eagerly (the
twin of ``jax.disable_jit()``), as the CPU always does.

``dispatch=`` (a ``kernels.ops.DispatchConfig``) pins kernel dispatch for
this engine: every :meth:`Engine.step` -- admission, eager prefill,
decode and any capture -- runs inside that scope (on whichever thread
steps the engine) and inside ``autotune.no_tuning()``, so launch plans
come from the autotune cache or ``launch_plan`` and a step never times
candidates.  A decode graph is keyed by the axes as they resolve at its
first use, so it replays the routing it was captured under.

There is no silent retry: a raising prefill fails its group's handles, a
raising decode step fails the slots live in it, and the engine serves on.
With ``kv_cache_dtype == "int8"`` every decode step runs the
``decode_attn_int8`` kernel once per layer on CUDA.

Priorities, preemption and streaming: ``submit(..., priority=)`` admits
higher classes first; a ``preemptible`` request's slot may be evicted
for a strictly-higher-priority request that is due while every slot is
busy -- it restarts from prefill over its prompt plus the tokens it has
decoded, keeping them (``Request.out_prefix``).  ``stream=True`` (or
``on_token=``) pushes each token through the handle as it is decoded, at
one device-to-host read of the pending tokens per step, shared by every
streaming slot, plus one per prefill group for the first tokens.

Fault injection (:mod:`.faults`; ``faults=`` or ``REPRO_FAULT_SPEC``)
fires at the ``prefill`` and ``decode`` sites: a ``raise`` fails the
group or the live slots, a ``nan@decode`` NaN-poisons one live slot's
cache rows in place (so a replayed decode graph sees them) and that
request alone fails with :class:`~.errors.NumericalError`.  With an int8
cache the quantizers send NaN to code 0, so the logits check alone can
miss a poisoned slot (the logits check is always on: JAX's
``check_numerics=`` switch is not ported); ``debug_numerics=True`` (or
``REPRO_DEBUG_NUMERICS=1``) also scans the cache's float leaves inside
every decode step.  ``heartbeat`` is the wall-clock time ``step()`` was
last entered.

``mesh=`` (a ``("data", "model")`` ``DeviceMesh`` over every process,
one rank each) serves sharded, as the JAX engine's ``mesh=`` does: the
parameters are placed by ``dist.sharding.param_specs`` (``self.params``
holds ``DTensor`` leaves) and the cache by ``cache_specs(...,
shard_model=True)`` (:meth:`sharded_cache`): slots over ``data``, heads
over ``model``; the int8 cache's ``(L, B, T, Hkv)`` row scales are
replicated over ``model``, so each rank writes its heads' slice and the
new rows are gathered over ``model`` after every write.  Each rank runs
its ``data`` slice of the slots on its ``model`` shards
(``dist.spmd.local_params``: column-parallel products keep their
columns, row-parallel ones are summed over ``model``, the lm_head's
logits gathered before sampling; an MoE layer's experts split over
``model`` and its routing over the step's global rows, so a prefill
group of an MoE model runs whole on every data rank; the recurrent
families' recurrence blocks replicated); sampled tokens are drawn from
the full ``(B, V)`` uniforms of the engine's seeded generator on every
rank, each keeping its rows, so seeded draws equal the unsharded
engine's.  On more
than one rank the steps run eagerly (``graphs=True`` raises: gloo
collectives cannot be captured) and rank 0 decides every step
(``dist.spmd.Lockstep``): each slot retirement, queue expiry, eviction,
admitted group and decode is broadcast before it runs, the other ranks
apply it to their own handles of the same uids (every rank submits the
same requests in the same order, at any wall time), and :meth:`run` ends
on every rank when rank 0's does.  The other ranks keep no deadlines:
rank 0's expiries and cancellations reach them with its decisions.
``lockstep`` (None on one rank) is what a serving daemon reads: a
follower keeps stepping until rank 0's ``lockstep.release()`` at
shutdown, and an idle rank 0 steps every ``lockstep.keepalive_s``.
"""
from __future__ import annotations

import dataclasses
import os
import time
import zlib
from typing import Callable, List, Optional

import numpy as np
import torch

from ..core.tree import device_of
from ..kernels import ops
from ..models import get_model
from ..models.config import ArchConfig
from . import faults as _faults
from .batching import ServeStats, pow2_bucket
from .errors import NumericalError, RequestTimedOut
from .graphs import for_device, in_use
from .scheduler import TIMED_OUT, FlushPolicy, Handle, OverloadPolicy, \
    Scheduler, end_like


def write_slots(cache: dict, slots: List[int], group_cache: dict) -> None:
    """Copy an (n, ...) prefill cache into ``cache``'s slots, in place (the
    batch axis is 1 for the stacked (L, B, ...) rows and states)."""
    idx = torch.as_tensor(slots, dtype=torch.int64,
                          device=cache["lengths"].device)
    for name, dst in cache.items():
        src = group_cache[name]
        if dst.ndim == 1:  # lengths (B,)
            dst[idx] = src
        else:
            dst[:, idx] = src


def _digest(req: "Request") -> tuple:
    """What ranks compare before prefilling a request together."""
    return (zlib.crc32(np.ascontiguousarray(req.prompt).tobytes()),
            req.max_new_tokens, req.temperature)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (P,) int32
    max_new_tokens: int = 16
    temperature: float = 0.0  # 0 = greedy
    out_tokens: Optional[List[int]] = None
    handle: Optional[Handle] = None  # resolves at completion
    stream: bool = False             # push tokens through the handle
    preemptible: bool = False        # slot may be evicted for higher prio
    # restart-from-prefix state: tokens decoded by earlier incarnations;
    # the result is out_prefix + the current incarnation's tokens
    out_prefix: List[int] = dataclasses.field(default_factory=list)
    preemptions: int = 0


@dataclasses.dataclass
class EngineStats(ServeStats):
    """ServeStats + the token engine's decode-loop counters."""

    steps: int = 0
    decoded_tokens: int = 0
    prefills: int = 0
    prefill_batches: int = 0
    finished: int = 0
    preemptions: int = 0       # slot evictions (restart-from-prefix)
    streamed_tokens: int = 0   # tokens pushed through streaming handles


class Engine:
    def __init__(self, cfg: ArchConfig, params, max_batch: int = 4,
                 max_len: int = 256, seed: int = 0,
                 max_delay_ms: float = 0.0,
                 clock: Callable[[], float] = time.monotonic,
                 overload: Optional[OverloadPolicy] = None,
                 faults: Optional[_faults.FaultInjector] = None,
                 debug_numerics: Optional[bool] = None,
                 graphs: bool = True,
                 dispatch: Optional[ops.DispatchConfig] = None,
                 mesh=None):
        if max_delay_ms is None:
            raise ValueError(
                "token engine admission needs a deadline: use "
                "max_delay_ms=0.0 (admit whenever slots free) or > 0 "
                "(coalesce prefills), not None")
        self.cfg = cfg
        self.model = get_model(cfg)
        self._ragged = bool(getattr(self.model, "RAGGED_PREFILL", False))
        self.B = max_batch
        self.T = max_len
        self.mesh = mesh
        self._rt = self.lockstep = self._group_exec = None
        # what the model computes with: a rank's config and shards
        self._exec_cfg, self._exec = cfg, params
        if mesh is not None:
            params = self._shard(params, mesh, graphs)
        self.params = params
        self.device = device_of(self._exec)
        self.dispatch = dispatch
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.stats = EngineStats()
        self.faults = faults if faults is not None else _faults.from_env()
        if debug_numerics is None:
            debug_numerics = os.environ.get(
                "REPRO_DEBUG_NUMERICS", "").strip().lower() in (
                    "1", "true", "on", "yes")
        # fixed per engine, so the decode graphs stay keyed by draw only
        self.debug_numerics = bool(debug_numerics)
        # wall-clock time step() was last entered, whatever the
        # scheduler's clock (the supervision layer's liveness signal)
        self.heartbeat: Optional[float] = None
        self.scheduler = Scheduler(
            policy=FlushPolicy(max_batch=max_batch,
                               max_delay_ms=max_delay_ms),
            stats=self.stats, clock=clock, overload=overload)
        dev = self.device
        self._rows = slice(0, max_batch)  # this rank's slots
        self._gathered = ()  # cache leaves replicated over model
        if self._rt is None:
            self.cache = self.model.init_cache(cfg, max_batch, max_len,
                                               dtype=torch.float32,
                                               device=dev)
            self._model_cache = self.cache
        else:
            self._init_sharded_cache()
        # device-resident decode state
        self._gen = torch.Generator(device=dev).manual_seed(seed)
        self._pending = torch.zeros((max_batch,), dtype=torch.int64,
                                    device=dev)
        self._temps = torch.zeros((max_batch,), device=dev)
        self._outbuf = torch.zeros((max_batch, max_len), dtype=torch.int32,
                                   device=dev)
        self._counts = torch.zeros((max_batch,), dtype=torch.int32,
                                   device=dev)
        # sticky per-slot non-finite-logits flag, read only at completion
        self._nonfinite = torch.zeros((max_batch,), dtype=torch.bool,
                                      device=dev)
        # the host's live-slot mask, copied in before every decode step
        self._live = torch.zeros((max_batch,), dtype=torch.bool, device=dev)
        self.step_graphs = for_device(dev, graphs)
        # host mirror of per-slot emitted-token counts (drives completion
        # without reading token values back)
        self._emitted = [0] * max_batch

    # -- sharding --------------------------------------------------------------
    def _shard(self, params, mesh, graphs: bool):
        """Place params per dist.sharding; this rank's compute tree and
        config (``dist.spmd``)."""
        from ..dist import sharding as shd
        from ..dist import spmd
        if graphs and mesh.size() > 1:
            raise ValueError(
                "graphs=True on a mesh of more than one rank: the sharded "
                "decode step's collectives (gloo) cannot be captured in a "
                "CUDA graph; serve it with graphs=False")
        rt = spmd.MeshRuntime(mesh)
        if self.B % rt.n_data:
            raise ValueError(
                f"max_batch ({self.B}) must be divisible by the data "
                f"axis size ({rt.n_data}) for sharded execution")
        self._exec_cfg = spmd.local_config(self.cfg, rt)
        specs = shd.param_specs(params, mesh)
        placed = spmd.place_tree(params, specs, mesh)
        self._exec = spmd.local_params(
            placed, specs, rt, gather_kv=spmd.kv_gathered(self.cfg, rt))
        # an MoE layer couples the rows of a pass: a prefill group runs
        # whole on every data rank, each keeping its members
        self._group_exec = spmd.whole_rows(self._exec)
        self._rt = rt
        if rt.size > 1:
            self.lockstep = spmd.Lockstep(rt)
        return placed

    def _init_sharded_cache(self) -> None:
        """This rank's cache buffers: its slots, and its heads of a
        model-sharded leaf; a leaf ``cache_specs`` replicates over
        ``model`` although the model writes it per head (the int8 row
        scales) keeps every head, and the model is handed its heads'
        slice (a view)."""
        from ..dist import sharding as shd
        rt, cfg, T = self._rt, self.cfg, self.T
        n = self.B // rt.n_data
        self._rows = rt.rows(self.B)
        self._cache_specs = shd.cache_specs(
            self.model.init_cache(cfg, self.B, T, dtype=torch.float32,
                                  device="meta"), rt.mesh, shard_model=True)
        full = self.model.init_cache(cfg, n, T, dtype=torch.float32,
                                     device=self.device)
        mine = self.model.init_cache(self._exec_cfg, n, T,
                                     dtype=torch.float32, device=self.device)
        self.cache, self._model_cache, gathered = {}, {}, []
        self._whole = {}  # leaves placed over model but computed whole
        for name, buf in mine.items():
            spec = self._cache_specs[name]
            if buf.shape == full[name].shape and "model" in spec:
                self._whole[name] = spec.index("model")
            if "model" in spec or buf.shape == full[name].shape:
                self.cache[name] = self._model_cache[name] = buf
                continue
            h = buf.shape[-1]
            self.cache[name] = full[name]
            self._model_cache[name] = full[name].narrow(
                -1, rt.model_rank * h, h)
            gathered.append(name)
        self._gathered = tuple(gathered)

    def sharded_cache(self) -> dict:
        """The cache as ``DTensor`` leaves over this engine's mesh (views
        of the buffers the steps write), placed as ``cache_specs(...,
        shard_model=True)`` says (a leaf the spec shards over ``model``
        that the model computes whole -- rwkv's state -- as this rank's
        slice of its buffer)."""
        from torch.distributed.tensor import DTensor

        from ..dist import sharding as shd
        if self._rt is None:
            raise ValueError("sharded_cache() needs an engine built with "
                             "mesh=")
        rt = self._rt
        out = {}
        for name, buf in self.cache.items():
            if name in self._whole:
                d = self._whole[name]
                n = buf.shape[d] // rt.n_model
                buf = buf.narrow(d, rt.model_rank * n, n)
            out[name] = DTensor.from_local(
                buf, rt.mesh, shd.NamedSharding(
                    rt.mesh, self._cache_specs[name]).placements,
                run_check=False)
        return out

    def _gather_rows(self, lengths: torch.Tensor) -> None:
        """After a decode step: the row each slot wrote (``lengths - 1``,
        dropped past ``max_len``) of every per-head leaf replicated over
        ``model``, gathered from every ``model`` rank into all heads."""
        if not self._gathered:
            return
        at = (lengths - 1).to(torch.int64)
        ok = at < self.T
        safe = torch.where(ok, at, torch.zeros_like(at))
        b = torch.arange(at.shape[0], device=at.device)
        for name in self._gathered:
            buf, mine = self.cache[name], self._model_cache[name]
            rows = self._rt.all_gather(mine[:, b, safe], "model", -1)
            keep = ok.reshape(1, -1, 1)
            buf[:, b, safe] = torch.where(keep, rows, buf[:, b, safe])

    def _write_group(self, slots: List[int], group_cache: dict) -> None:
        """A prefill group's cache into this rank's slots (``slots``
        local), its per-head replicated leaves gathered over ``model``."""
        group_cache = dict(group_cache)
        for name in self._gathered:
            group_cache[name] = self._rt.all_gather(group_cache[name],
                                                    "model", -1)
        write_slots(self.cache, slots, group_cache)

    # -- lockstep (more than one rank) -------------------------------------------
    def _announce(self, msg) -> None:
        """Rank 0: broadcast a decision before it runs."""
        if self.lockstep is not None and self.lockstep.leader:
            self.lockstep.share(msg)

    # -- request API ---------------------------------------------------------
    @property
    def queue(self) -> List[Request]:
        """Requests waiting for admission (FIFO)."""
        return self.scheduler.pending_payloads()

    def submit(self, prompt, max_new_tokens: int = 16,
               temperature: float = 0.0,
               deadline_ms: Optional[float] = None,
               priority: int = 0,
               stream: bool = False,
               on_token: Optional[Callable[[int], None]] = None,
               preemptible: bool = False) -> Request:
        """Enqueue one request; its ``.handle`` resolves (or fails) at
        completion with the list of generated token ids.  Host-only
        (numpy and the scheduler): any thread may submit while another
        drives the engine.

        ``deadline_ms``: the request times out (``TIMED_OUT``, slot freed)
        unless it completes within that many ms of submission, queued or
        mid-decode.  ``priority``: higher admits first (FIFO within a
        class).  ``preemptible``: the decode slot may be evicted for a
        strictly-higher-priority request; the request restarts from
        prefill over its prompt and the tokens so far, keeping them.
        ``stream=True`` (implied by ``on_token``) pushes each decoded
        token through the handle (``handle.tokens()`` / the callback)
        before the completion-time numerics check: the handle's terminal
        state says whether the stream is trustworthy.

        Raises ``ValueError`` up front for a prompt that is
        not a 1-D vector of integer token ids in ``[0, vocab_size)``, an
        empty prompt, ``max_new_tokens < 1``, or a prompt plus budget
        longer than ``max_len``; ``QueueFullError`` when a bounded queue
        rejects the submit."""
        arr = np.asarray(prompt)
        if arr.ndim != 1:
            raise ValueError(f"prompt must be a 1-D vector of token ids, "
                             f"got shape {arr.shape}")
        if arr.size and not np.issubdtype(arr.dtype, np.integer):
            raise ValueError(f"prompt dtype must be integer token ids, got "
                             f"{arr.dtype}")
        if arr.size and (int(arr.min()) < 0
                         or int(arr.max()) >= self.cfg.vocab_size):
            raise ValueError(
                f"prompt token ids must be in [0, {self.cfg.vocab_size}), "
                f"got range [{int(arr.min())}, {int(arr.max())}]")
        prompt = arr.astype(np.int32)
        if len(prompt) == 0:
            raise ValueError("empty prompt: prefill needs at least one token")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens} (every "
                "admitted request decodes at least its prefill-sampled "
                "first token)")
        if len(prompt) + max_new_tokens > self.T:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens})"
                f" exceeds max_len ({self.T})")
        req = Request(uid=0, prompt=prompt, max_new_tokens=max_new_tokens,
                      temperature=float(temperature), out_tokens=[],
                      stream=bool(stream) or on_token is not None,
                      preemptible=bool(preemptible))
        if self.lockstep is not None and not self.lockstep.leader:
            deadline_ms = None  # rank 0 decides expiries
        req.handle = self.scheduler.submit(req, deadline_ms=deadline_ms,
                                           priority=priority,
                                           on_token=on_token)
        req.uid = req.handle.uid
        if self.lockstep is not None:
            self.lockstep.note(req.handle)
        return req

    # -- device-side pieces --------------------------------------------------
    def _sample(self, logits: torch.Tensor, temps: torch.Tensor,
                draw: bool, rows=None, total: int = 0) -> torch.Tensor:
        """(n, padded_vocab) logits -> (n,) int64 tokens on the device:
        argmax, or Gumbel-max of ``logits / t`` where ``t > 0`` (``draw``:
        whether any row samples; greedy-only calls consume no random
        numbers).  ``rows`` / ``total``: the logits are those rows of a
        batch of ``total`` (a rank's slots): the whole batch's uniforms
        are drawn and these rows kept, as the unsharded engine draws."""
        lg = logits[:, : self.cfg.vocab_size].to(torch.float32)
        greedy = torch.argmax(lg, dim=-1)
        if not draw:
            return greedy
        if rows is None:
            u = torch.rand(lg.shape, generator=self._gen, device=lg.device)
        else:
            u = torch.rand((total, lg.shape[1]), generator=self._gen,
                           device=lg.device)[rows]
        gumbel = -torch.log(-torch.log(u))
        drawn = torch.argmax(lg / temps.clamp(min=1e-6)[:, None] + gumbel,
                             dim=-1)
        return torch.where(temps > 0, drawn, greedy)

    def _row_nonfinite(self, logits: torch.Tensor) -> torch.Tensor:
        lg = logits[:, : self.cfg.vocab_size]
        return ~torch.isfinite(lg).all(dim=-1)

    def _cache_nonfinite(self) -> torch.Tensor:
        """(B,) bool: any NaN/Inf in a slot's float cache rows (batch axis
        1).  Integer payloads are finite by construction; the float leaves
        (a float cache, the int8 cache's row scales) carry a NaN the
        quantizers would send to code 0."""
        n = self.cache["lengths"].shape[0]  # this rank's slots
        bad = torch.zeros((n,), dtype=torch.bool, device=self.device)
        for leaf in self.cache.values():
            if leaf.ndim < 2 or not leaf.is_floating_point():
                continue
            rows = torch.isfinite(leaf).movedim(1, 0).reshape(n, -1)
            bad |= ~rows.all(dim=1)
        return bad

    # -- admission -----------------------------------------------------------
    def _admit(self) -> None:
        # free slots and the due-check are recomputed on every pass: a
        # max_new_tokens == 1 group completes inside _prefill_group and
        # frees its slots for the queue within the same call
        while True:
            free = [i for i, r in enumerate(self.slots) if r is None]
            if not free:
                if not self._maybe_preempt():
                    return
                continue  # the evicted slot is free for the due head
            reason = self.scheduler.due()
            if reason is None:
                return
            cands = self.scheduler.peek(len(free))
            if not self._ragged:
                # exact-length bucket: recurrent states must not see
                # padding; one bucket a pass, the rest re-enter next pass
                by_len = {}
                for h in cands:
                    by_len.setdefault(len(h.payload.prompt), []).append(h)
                cands = next(iter(by_len.values()), [])
            group = self.scheduler.pop(cands, reason)
            if not group:
                continue  # whole group cancelled/expired while queued
            self._announce(("prefill", free[: len(group)],
                            [h.uid for h in group], reason,
                            [_digest(h.payload) for h in group]))
            self._run_group(free[: len(group)], group)

    def _run_group(self, gslots: List[int], group: List[Handle]) -> None:
        try:
            self._prefill_group(gslots, group)
        except Exception as e:  # noqa: BLE001 -- per-batch containment
            for h in group:
                h.set_exception(e)

    def _maybe_preempt(self) -> bool:
        """With every slot busy: evict ONE preemptible decode of lower
        priority than a due request at the head of the queue.  Victim:
        lowest priority, then most tokens emitted (the continuation with
        the least decoding left).  Returns True if a slot was freed."""
        if self.scheduler.due() is None:
            return False
        head = self.scheduler.peek(1)
        if not head:
            return False
        want = head[0].priority
        victims = []
        for slot, req in enumerate(self.slots):
            if (req is None or not req.preemptible or req.handle is None
                    or req.handle.done()
                    or req.handle.priority >= want):
                continue
            victims.append((req.handle.priority, -self._emitted[slot], slot))
        if not victims:
            return False
        self._announce(("preempt", min(victims)[2]))
        self._preempt_slot(min(victims)[2])
        return True

    def _preempt_slot(self, slot: int) -> None:
        """Evict one decode, restart-from-prefix: the tokens decoded so
        far join the prompt (``max_new_tokens`` shrinks by as many, so
        the ``max_len`` check still holds) and the same handle goes back
        to the end of its priority class.  One device-to-host read (the
        sticky flag and the token row).  A victim whose flag has tripped
        fails instead: restarting would launder its poisoned tokens into
        the continuation's prompt."""
        req = self.slots[slot]
        h = req.handle
        emitted = self._emitted[slot]
        row = torch.cat([self._nonfinite[slot:slot + 1].to(torch.int32),
                         self._outbuf[slot, :emitted]]).cpu().numpy()
        if row[0]:
            h.set_exception(NumericalError(
                f"request {h.uid} produced non-finite logits during "
                "decode (caught at preemption); its tokens are not "
                "trustworthy and were not delivered"))
            self._release_slot(slot)
            return
        toks = row[1:]
        req.out_prefix.extend(int(t) for t in toks)
        req.prompt = np.concatenate([req.prompt, toks.astype(np.int32)])
        # a slot at its budget retired in _finish_done: the rest is >= 1
        req.max_new_tokens -= emitted
        req.preemptions += 1
        self.stats.preemptions += 1
        self._release_slot(slot)
        self.scheduler.requeue(h)
        if self.lockstep is not None:
            self.lockstep.note(h, requeued=True)  # admitted again by uid

    @torch.no_grad()
    def _prefill_group(self, gslots: List[int], handles: List[Handle]):
        greqs = [h.payload for h in handles]
        lens = np.asarray([len(r.prompt) for r in greqs], np.int32)
        pmax = int(lens.max())
        if self._ragged:
            # a power-of-two padded length (8..max_len) bounds the
            # distinct prefill shapes; lengths mask the pad columns
            pmax = pow2_bucket(pmax, 8, self.T)
        toks = np.zeros((len(greqs), pmax), np.int64)
        for i, r in enumerate(greqs):
            toks[i, : len(r.prompt)] = r.prompt
        dev = self.device
        temps_h = [r.temperature for r in greqs]
        temps = torch.tensor(temps_h, dtype=torch.float32, device=dev)
        act = (self.faults.on_call("prefill")
               if self.faults is not None else None)
        if act is not None:
            act.fire()  # raises and delays land before any state changes
        first, bad = self._prefill_rows(gslots, toks, lens, temps,
                                        any(t > 0 for t in temps_h))
        if act is not None and act.poison:
            bad[0] = True  # the group's first request fails alone
        idx = torch.as_tensor(gslots, dtype=torch.int64, device=dev)
        self._pending[idx] = first
        self._temps[idx] = temps
        self._outbuf[idx, 0] = first.to(torch.int32)
        self._counts[idx] = 1
        self._nonfinite[idx] = bad
        for s, r in zip(gslots, greqs):
            self.slots[s] = r
            self._emitted[s] = 1
        self.stats.prefills += len(greqs)
        self.stats.prefill_batches += 1
        if any(r.stream for r in greqs):
            # streamers pay one read per group for their first tokens
            fv = first.cpu().numpy()
            for i, (r, h) in enumerate(zip(greqs, handles)):
                if r.stream and h.push_token(int(fv[i])):
                    self.stats.streamed_tokens += 1
        # real prompt tokens vs the padded (n, pmax) prefill executed
        self.stats.record_batch(items=int(lens.sum()),
                                padded=int(len(greqs) * pmax - lens.sum()),
                                capacity=self.B * pmax)
        self._finish_done()  # max_new_tokens == 1 finishes at prefill

    def _prefill_rows(self, gslots, toks, lens, temps, draw):
        """This rank prefills the group's members whose slots are its own
        (all of them without a mesh; on a mesh, on its model shards; an
        MoE model, whose routing couples the rows, prefills the whole
        group on every data rank and keeps its members' rows), samples
        them from the whole group's uniforms, and on a mesh the group's
        first tokens and flags are summed over ``data`` (each member's
        row comes from one data rank).  Returns the group's (n,) first
        tokens and flags."""
        rt, dev, n = self._rt, self.device, len(gslots)
        lo = self._rows.start
        mine = [i for i, s in enumerate(gslots) if self._rows.start <= s
                < self._rows.stop]
        first = torch.zeros((n,), dtype=torch.int64, device=dev)
        bad = torch.zeros((n,), dtype=torch.int32, device=dev)
        if mine:
            idx = torch.as_tensor(mine, dtype=torch.int64, device=dev)
            whole = self._group_exec
            run = list(range(n)) if whole is not None else mine
            sc = self.model.init_cache(self._exec_cfg, len(run), self.T,
                                       dtype=torch.float32, device=dev)
            kw = ({"lengths": torch.from_numpy(lens[run]).to(dev)}
                  if self._ragged else {})
            logits, sc = self.model.prefill(
                self._exec_cfg, self._exec if whole is None else whole, sc,
                torch.from_numpy(toks[run]).to(dev), **kw)
            if whole is not None:  # this rank's members of the group
                logits = logits[idx]
                sc = {k: v[idx] if v.ndim == 1 else v[:, idx]
                      for k, v in sc.items()}
            first[idx] = self._sample(logits[:, -1], temps[idx], draw,
                                      rows=idx, total=n)
            bad[idx] = self._row_nonfinite(logits[:, -1]).to(torch.int32)
            self._write_group([gslots[i] - lo for i in mine], sc)
        elif draw:
            # the group's uniforms are drawn on every rank all the same
            torch.rand((n, self.cfg.vocab_size), generator=self._gen,
                       device=dev)
        if rt is not None:
            rt.all_reduce(first, "data")
            rt.all_reduce(bad, "data")
        return first, bad.to(torch.bool)

    # -- slots ---------------------------------------------------------------
    def _release_slot(self, slot: int) -> None:
        """Free a slot and clear its sticky flag for the next occupant
        (its cache rows are overwritten at the next prefill)."""
        self.slots[slot] = None
        self._emitted[slot] = 0
        self._nonfinite[slot] = False

    def _sweep_slots(self) -> None:
        """Retire in-flight requests that went terminal without a result:
        cancellation, and deadline expiry mid-decode (rank 0 broadcasts
        the slots it retired)."""
        leader = self.lockstep is not None and self.lockstep.leader
        self.scheduler.expire()
        now = self.scheduler.now()
        if leader:
            slots = {s: r.handle for s, r in enumerate(self.slots)
                     if r is not None and r.handle is not None
                     and not r.handle.done()}
        self._retire_done(now)
        if leader:
            gone = [(s, h.state, str(h.exception()))
                    for s, h in slots.items() if h.done()]
            if gone:
                self._announce(("sweep", gone))

    def _mirror_sweep(self, gone) -> None:
        """A follower: rank 0's retired slots, applied to this rank's
        handles."""
        for slot, state, msg in gone:
            req = self.slots[slot]
            if req is not None and req.handle is not None:
                end_like(req.handle, state, msg)
            self._release_slot(slot)

    def _retire_done(self, now: float) -> None:
        for slot, req in enumerate(self.slots):
            if req is None or req.handle is None:
                continue
            h = req.handle
            if not h.done() and h.deadline is not None and now >= h.deadline:
                h.set_exception(
                    RequestTimedOut(
                        f"request {h.uid} timed out mid-decode after "
                        f"{self._emitted[slot]} token(s); freeing its slot"),
                    state=TIMED_OUT)
            if h.done():
                self._release_slot(slot)

    def _finish_done(self) -> None:
        """Retire completed slots.  The only per-request device-to-host
        read: the slot's sticky flag and its token row, in one copy."""
        for slot, req in enumerate(self.slots):
            if req is None or self._emitted[slot] < req.max_new_tokens:
                continue
            h = req.handle
            n = req.max_new_tokens
            row = torch.cat([self._nonfinite[slot:slot + 1].to(torch.int32),
                             self._outbuf[slot, :n]]).cpu().numpy()
            if row[0]:
                if h is not None:
                    h.set_exception(NumericalError(
                        f"request {h.uid} produced non-finite logits "
                        "during decode (NaN/Inf); its tokens are not "
                        "trustworthy and were not delivered"))
                self._release_slot(slot)
                continue
            # out_prefix: the tokens of incarnations before a preemption
            req.out_tokens = req.out_prefix + [int(t) for t in row[1:]]
            # a late result into a handle already cancelled or timed out
            # is dropped by the handle's state machine
            if h is None or h.set_result(req.out_tokens):
                self.stats.finished += 1
            self._release_slot(slot)

    # -- the loop ------------------------------------------------------------
    @torch.no_grad()
    def _decode(self, live_mask: np.ndarray) -> None:
        self._live.copy_(torch.from_numpy(live_mask))
        draw = any(r is not None and r.temperature > 0 for r in self.slots)
        if in_use(self.step_graphs):
            self.step_graphs.run(
                (draw, ops.resolve(self.device)),
                lambda: self._decode_step(draw),
                state=(*self.cache.values(), self._pending, self._outbuf,
                       self._counts, self._nonfinite),
                generators=(self._gen,) if draw else ())
        else:
            self._decode_step(draw)

    def _decode_step(self, draw: bool) -> None:
        """One decode step for every slot, in place over the engine's
        buffers (what a graph captures; ``draw`` as in :meth:`_sample`)."""
        live, rows = self._live, self._rows
        logits, cache = self.model.decode_step(
            self._exec_cfg, self._exec, self._model_cache,
            self._pending[rows, None])
        self.cache["lengths"].copy_(cache["lengths"])
        self._gather_rows(cache["lengths"])
        lg = logits[:, 0]
        bad = self._row_nonfinite(lg)
        if self.debug_numerics:
            # a cache NaN the int8 quantizers would launder into finite
            # logits still trips the flag
            bad |= self._cache_nonfinite()
        sampled = self._sample(lg, self._temps[rows], draw, rows=rows,
                               total=self.B)
        if self._rt is not None:  # every rank's slots, on every rank
            sampled = self._rt.all_gather(sampled, "data", 0)
            bad = self._rt.all_gather(bad.to(torch.int32), "data",
                                      0).to(torch.bool)
        # sticky: once a live slot's logits go non-finite the bit stays
        # set until the slot retires
        self._nonfinite |= bad & live
        tok = torch.where(live, sampled, self._pending)
        b = torch.arange(self.B, device=self.device)
        at = torch.clamp(self._counts, max=self.T - 1).to(torch.int64)
        self._outbuf[b, at] = torch.where(live, tok.to(torch.int32),
                                          self._outbuf[b, at])
        self._counts += live.to(torch.int32)
        self._pending.copy_(tok)

    def step(self) -> int:
        """Admit, then one decode step for all live slots; returns the
        number of live slots.  A raising decode step fails only the slots
        live in it; the step itself never raises (an injected ``crash``,
        a ``BaseException``, goes through on purpose)."""
        with ops.engine_step(self.dispatch):
            return self._step()

    def _step(self) -> int:
        self.heartbeat = time.monotonic()
        ls = self.lockstep
        if ls is not None and ls.stopped:
            return 0
        if ls is not None and not ls.leader:
            return self._follow()
        self._sweep_slots()
        self._admit()
        live_mask = np.asarray([r is not None for r in self.slots], bool)
        if not live_mask.any():
            self._announce(("end",))
            return 0
        self._announce(("decode",))
        return self._decode_live(live_mask)

    def _follow(self) -> int:
        """A follower's step: rank 0's decisions, in its order, until its
        decode (or the end of its step)."""
        ls = self.lockstep
        while True:
            msg = ls.share(None)
            kind = msg[0]
            if kind == "sweep":
                self._mirror_sweep(msg[1])
            elif kind == "preempt":
                self._preempt_slot(msg[1])
            elif kind == "prefill":
                _, gslots, uids, reason, digests = msg
                group = ls.await_handles(uids)
                mine = [_digest(h.payload) for h in group]
                if mine != digests:
                    raise RuntimeError(
                        f"rank {ls.rt.rank}: requests {uids} differ from "
                        "rank 0's (prompt, budget or temperature): every "
                        "rank must submit the same requests in the same "
                        "order")
                self.scheduler.pop(group, reason)
                self._run_group(gslots, group)
            elif kind == "decode":
                return self._decode_live(np.asarray(
                    [r is not None for r in self.slots], bool))
            elif kind == "idle":
                self._peer_idle = True
                return 0
            elif kind == "stop":
                ls.stopped = True
                return 0
            else:  # "end"
                return 0

    def _decode_live(self, live_mask: np.ndarray) -> int:
        live = [i for i in range(self.B) if live_mask[i]]
        act = (self.faults.on_call("decode")
               if self.faults is not None else None)
        try:
            if act is not None:
                act.fire()
                if act.poison:
                    self._poison_slot(live[0])
            self._decode(live_mask)
        except Exception as e:  # noqa: BLE001 -- per-batch containment
            for slot in live:
                req = self.slots[slot]
                if req is not None and req.handle is not None:
                    req.handle.set_exception(e)
                self._release_slot(slot)
            return 0
        self.stats.steps += 1
        self.stats.decoded_tokens += len(live)
        for slot in live:
            self._emitted[slot] += 1
        self._stream_live(live)
        self._finish_done()
        return len(live)

    def _stream_live(self, live: List[int]) -> None:
        """Push this step's token into every live streaming slot's
        handle: one read of the pending tokens, shared by all of them,
        and none when no live slot streams."""
        streamers = [s for s in live if self.slots[s] is not None
                     and self.slots[s].stream
                     and self.slots[s].handle is not None]
        if not streamers:
            return
        pend = self._pending.cpu().numpy()
        for s in streamers:
            if self.slots[s].handle.push_token(int(pend[s])):
                self.stats.streamed_tokens += 1

    @torch.no_grad()
    def _poison_slot(self, slot: int) -> None:
        """NaN-poison ONE slot's cache rows (``nan@decode``) in place --
        the decode graph replays these very buffers -- so that request
        alone fails with ``NumericalError`` (on a mesh, by the data rank
        whose slot it is)."""
        if not self._rows.start <= slot < self._rows.stop:
            return
        for leaf in self.cache.values():
            if leaf.is_floating_point() and leaf.ndim >= 2:
                leaf[:, slot - self._rows.start] = float("nan")

    def run(self, max_steps: int = 10_000) -> EngineStats:
        """Step until the queue and every slot are empty (or
        ``max_steps``); on a mesh of more than one rank the other ranks
        step until rank 0's run ends."""
        ls = self.lockstep
        if ls is not None and not ls.leader:
            self._peer_idle = False
            for _ in range(max_steps):
                self.step()
                if self._peer_idle or ls.stopped:
                    break
            return self.stats
        try:
            return self._run(max_steps)
        finally:
            if ls is not None and not ls.stopped:
                ls.share(("idle",))

    def _run(self, max_steps: int) -> EngineStats:
        for _ in range(max_steps):
            if self.scheduler.pending == 0 and all(
                    s is None for s in self.slots):
                break
            if self.step() == 0 and self.scheduler.pending \
                    and self.scheduler.clock is time.monotonic:
                # nothing live and admission held by max_delay_ms: sleep
                # toward the deadline (only on the real clock)
                nd = self.scheduler.next_deadline()
                if nd is not None:
                    delay = nd - self.scheduler.clock()
                    if delay > 0:
                        time.sleep(min(delay, 1e-3))
        return self.stats

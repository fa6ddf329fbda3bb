"""Production mesh factory (twin of ``repro.launch.mesh``).

FUNCTIONS, not module-level constants, so importing this module never
touches device or process-group state.  Each builds a
``torch.distributed.device_mesh.DeviceMesh`` over the process group the
caller has already initialised (``torch.distributed.init_process_group``
-- ``torchrun``'s environment, or ``launch.daemon --coordinator``), one
rank per process.

Mesh geometry (the JAX package's TPU v5e posture, the same axis names):
  single pod:  (data, model) = (16, 16)        -- 256 ranks
  multi pod:   (pod, data, model) = (2, 16, 16) -- 512 ranks
``model`` is the tensor/expert-parallel axis; ``data`` carries data
parallelism / FSDP; ``pod`` cross-pod data parallelism.
"""
from __future__ import annotations


def _device_type() -> str:
    import torch
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_mesh(shape, axes, device_type=None):
    """``init_device_mesh`` over the initialised process group, on the
    card where there is one unless ``device_type`` says otherwise."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type or _device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_debug_mesh(n_data: int = 2, n_model: int = 2, device_type=None):
    """Small mesh for multi-process tests (the world size set by the
    caller's process group)."""
    return make_mesh((n_data, n_model), ("data", "model"), device_type)


def pick_backend(device: str, world: int) -> tuple:
    """(backend, why) for ``world`` ranks on ``device``: ``gloo`` on the
    CPU; on CUDA ``nccl`` where every rank has a card of its own, else
    ``gloo`` over CUDA tensors (NCCL refuses two ranks on one card).
    The rule is stated, not probed: callers print ``why``."""
    import torch
    if torch.device(device).type != "cuda":
        return "gloo", "CPU ranks"
    cards = torch.cuda.device_count()
    if world <= cards:
        return "nccl", f"{world} ranks on {cards} cards, one card each"
    return "gloo", (f"{world} ranks on {cards} card(s): NCCL needs a card "
                    "per rank, so gloo moves the CUDA tensors")


# the ranks other than 0 wait for rank 0's next decision inside a
# collective; an idle rank 0 speaks at least every quarter of this
# (``dist.spmd.Lockstep.keepalive_s``, at most 60 s)
GROUP_TIMEOUT_S = 1800.0


def init_ranks(device: str, world: int, rank: int,
               init_method: str) -> tuple:
    """Join the process group (once per process) with
    :func:`pick_backend`'s backend; on CUDA select this rank's card
    (``rank % cards``).  Returns (backend, why)."""
    import datetime

    import torch
    import torch.distributed as dist
    backend, why = pick_backend(device, world)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init_method, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    return backend, why

"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with ``ctypes``.  Nothing builds
at import: the first launch of a kernel builds its library, and
:func:`build_all` builds every source at once (one ``nvcc`` per source, all
started together).  Libraries land in ``build/repro_torch/`` at the root of
the checkout, named by a hash of the source, so an edited source rebuilds.

``--use_fast_math`` is never passed: the kernels rely on IEEE division and
round-half-to-even to stay bit-identical to their plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# each source and the extern "C" entry points it defines
SOURCES = {"m2q_matmul": ("m2q_matmul", "int8_matmul"),
           "dwconv_w4": ("dwconv_w4",),
           "relu_attn": ("relu_attn", "relu_attn_scales"),
           "weights_only_matmul": ("int4_matmul", "apot_matmul"),
           "decode_attn_int8": ("decode_attn_int8",)}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin); the CUDA kernels cannot build")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    out = _lib_path(name)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, (proc, tmp)


def _finish(name: str, out: Path, job) -> str:
    if job is None:
        return f"{name}: cached {out.name}"
    proc, tmp = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return f"{name}: built {out.name}\n{log}"


def build_all() -> str:
    """Compile every kernel source in parallel; returns the compiler
    reports (``-Xptxas -v``: registers, shared memory, spills)."""
    with _lock:
        jobs = {name: _start(name) for name in SOURCES}
        return "\n".join(_finish(name, *jobs[name]) for name in SOURCES)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            out, job = _start(name)
            _finish(name, out, job)
            lib = ctypes.CDLL(str(out))
            _libs[name] = lib
        return lib


def check(err: int, name: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def check_operands(name: str, x: torch.Tensor, *operands) -> None:
    """The launch contract of the matmul kernels: ``x`` a contiguous 2-D
    float32/bfloat16 tensor; each ``(field, tensor, dtype)`` contiguous, of
    that dtype, on ``x``'s device.  Raises ValueError otherwise."""
    if x.dtype not in (torch.float32, torch.bfloat16) \
            or not x.is_contiguous() or x.ndim != 2:
        raise ValueError(f"{name}: x must be a contiguous 2-D float32 or "
                         "bfloat16 tensor")
    for field, t, dtype in operands:
        if t.device != x.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: {field} must be a contiguous {dtype} "
                             f"tensor on {x.device}")


def launch_matmul(source: str, name: str, x: torch.Tensor, n: int,
                  *operands, ints: tuple = (),
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Launch the matmul kernel ``extern "C" int <name>(x, operands...,
    y, M, N, K, x_is_bf16, [y_is_bf16,] ints..., stream)`` of
    ``csrc/<source>.cu`` on x's current stream after
    :func:`check_operands`; returns y (M, n).  ``ints``: the kernel's own
    launch parameters, if it takes any.  ``out_dtype``: None for a kernel
    that stores f32 only; float32 or bfloat16 for one that takes the
    ``y_is_bf16`` flag."""
    check_operands(name, x, *operands)
    flags = (int(x.dtype == torch.bfloat16),)
    if out_dtype is not None:
        if out_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"{name}: out_dtype must be float32 or "
                             f"bfloat16, got {out_dtype}")
        flags += (int(out_dtype == torch.bfloat16),)
    m, k = x.shape
    y = torch.empty((m, n), dtype=out_dtype or torch.float32,
                    device=x.device)
    fn = getattr(load(source), name)
    fn.argtypes = [ctypes.c_void_p] * (len(operands) + 2) \
        + [ctypes.c_int] * (3 + len(flags) + len(ints)) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), *(t.data_ptr() for _, t, _ in operands),
             y.data_ptr(), m, n, k, *flags, *ints,
             torch.cuda.current_stream(x.device).cuda_stream)
    check(err, name)
    return y

"""Adversarial inputs for the fused m2q matmul, built with numpy from a
seed: the edge cases of the APoT decode and of activation clipping that
the CUDA kernel's int8 tensor-core planes (payload, hi, lo) must get
right.

An APoT byte is ``zero(0x80) | sign(0x40) | e1 << 3 | e2`` and decodes to
``s * (2^(7-e1) + 2^(7-e2))`` units of 2^-7; the quantizer's codebook uses
the 36 pairs ``e1 <= e2`` in [0, 7].  ``e1 = e2 = 0`` is +-256 units, the
only magnitude that needs the hi plane twice."""
import numpy as np

APOT_PAIRS = [(a, b) for a in range(8) for b in range(a, 8)]  # 36 codes
ZERO_CODE = 0x80


def apot_codes() -> np.ndarray:
    """Every codebook code in both signs, and the zero code (uint8)."""
    mags = [(a << 3) | b for a, b in APOT_PAIRS]
    return np.array(mags + [m | 0x40 for m in mags] + [ZERO_CODE],
                    dtype=np.uint8)


def adversarial_m2q(M: int, K: int, N: int, kind: str, seed: int = 0):
    """(x, act_scale, payload, u_scale, u_zp, a_scale) as numpy arrays.

    ``kind``: "mixed" (columns split at random between the engines),
    "uniform" (every column uniform) or "apot" (every column APoT).  Each
    APoT column cycles through all :func:`apot_codes` (shuffled), so every
    code appears wherever K >= 73; uniform columns hold any int8 byte.
    The scales are zero-masked per column as QM2Q stores them.  x is drawn
    so that most entries clip at +-127 after quantization."""
    rng = np.random.default_rng(seed)
    is_apot = {"mixed": rng.random(N) < 0.5, "uniform": np.zeros(N, bool),
               "apot": np.ones(N, bool)}[kind]
    codes = apot_codes()
    payload = rng.integers(-128, 128, (K, N)).astype(np.int8)
    for n in np.flatnonzero(is_apot):
        col = np.resize(codes, K)
        rng.shuffle(col)
        payload[:, n] = col.view(np.int8)
    u_scale = np.where(is_apot, 0.0, rng.uniform(1e-3, 2e-2, N))
    u_zp = np.where(is_apot, 0.0, rng.integers(-128, 128, N))
    a_scale = np.where(is_apot, rng.uniform(1e-3, 2e-2, N), 0.0)
    act_scale = np.float32(0.01)
    # |x / sa| mostly far above 127; a few small values near rounding ties
    x = rng.normal(0, 5.0, (M, K)).astype(np.float32)
    x[:, ::7] = (rng.integers(-300, 300, (M, len(range(0, K, 7)))) + 0.5) \
        * act_scale
    return (x, act_scale, payload, u_scale.astype(np.float32),
            u_zp.astype(np.float32), a_scale.astype(np.float32))

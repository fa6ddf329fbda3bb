"""Adversarial inputs for the quantized W8A8 matmuls (the fused m2q
matmul and the uniform int8 matmul), built with numpy from a seed: the
edge cases of the APoT decode, of activation rounding near ties and of
clipping that the CUDA kernels' int8 tensor-core planes (payload, hi, lo)
and reciprocal quantizer must get right.

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


def near_ties(sa, n: int, rng) -> np.ndarray:
    """``n`` f32 values at and one ulp either side of ``(k + 0.5) * sa``
    for integers k in [-140, 140): the quotients whose rounding a
    reciprocal multiply can get wrong, and the clip at +-127."""
    sa = np.float32(sa)
    ties = ((rng.integers(-140, 140, n) + np.float32(0.5)) * sa).astype(
        np.float32)
    step = rng.integers(-1, 2, n)  # -1, 0 or +1 ulp
    toward = np.where(step > 0, np.float32(np.inf), np.float32(-np.inf))
    return np.where(step == 0, ties,
                    np.nextafter(ties, toward)).astype(np.float32)


def adversarial_int8(M: int, K: int, N: int, seed: int = 0, sa=0.01,
                     nonfinite: bool = False):
    """(x, act_scale, wq, scale, zero_point) as numpy arrays for the
    uniform W8A8 matmul: a quarter of x near rounding ties of x / sa, a
    quarter beyond the +-127 clip, the rest ordinary; any int8 payload
    byte; integral zero points across the int8 range.  ``nonfinite``:
    NaN, +inf and -inf at ~2% of x each."""
    rng = np.random.default_rng(seed)
    sa = np.float32(sa)
    x = (rng.normal(0, 40.0, (M, K)) * sa).astype(np.float32)
    pick = rng.random((M, K))
    x[pick < 0.25] = near_ties(sa, int((pick < 0.25).sum()), rng)
    far = (pick >= 0.25) & (pick < 0.5)
    x[far] = (rng.choice([-1, 1], int(far.sum()))
              * rng.uniform(127.5, 400, int(far.sum())) * sa)
    if nonfinite:
        for i, v in enumerate((np.nan, np.inf, -np.inf)):
            x[(pick >= 0.5 + 0.02 * i) & (pick < 0.52 + 0.02 * i)] = v
    wq = rng.integers(-128, 128, (K, N)).astype(np.int8)
    scale = rng.uniform(1e-3, 2e-2, N).astype(np.float32)
    zp = rng.integers(-128, 128, N).astype(np.float32)
    return x, sa, wq, scale, zp

// Quantized W8A8 matmuls for Hopper (sm_90a): one kernel template, two
// functions.
//
// m2q_matmul replaces the TPU kernel repro/kernels/m2q_matmul.py::m2q_matmul
// (body _kernel): the fused two-level mixed-quantization matmul
//   y = [((xq@P)_i32 - rowsum(xq)*u_zp)*u_scale
//        + (xq@apot(P))*2^-7*a_scale] * sa,
// P the merged (K, N) int8 payload, stored as f32.
// int8_matmul replaces repro/kernels/int8_matmul.py::int8_matmul (body
// _kernel): the uniform W8A8 matmul
//   y = ((xq@Wq)_i32 - rowsum(xq)*zp) * (sa*scale),
// Wq the offset-folded (K, N) int8 payload, stored as f32 or bf16.
// Both quantize xq = clip(rne(x/sa), +-127) inside the kernel.
//
// What bounds them on the H100: bytes.  At every shape of the main paths
// (K 16..1024, N 16..1024, M = batch*pixels from 8 to ~10^5; the int8 stem
// at M = 100352, K = 27, N = 16) the int8 operations take well under a
// microsecond at the tensor-core rate, while reading x (bf16) and writing
// y take 1-9 us.
//
// What the first design lost, and why: one 256-thread block per 64x64
// tile gave 16-112 blocks on 132 SMs at the late-stage shapes and the
// head; each walked all of K with scalar 32-bit IMADs from shared memory,
// loaded through registers with no copy in flight, divided once per x
// element and N-tile, and (m2q) re-decoded APoT per element.  Its time
// followed K alone (~6 us per 32-deep step).
//
// This design:
// * Int8 tensor cores (mma.sync m16n8k32 s8.s8.s32).  The uniform engine
//   multiplies the payload bytes as they are.  An APoT byte (m2q only)
//   decodes to s*(2^(7-e1) + 2^(7-e2)) units of 2^-7, up to +-256, which
//   int8 cannot hold, so the decode writes two int8 planes,
//   hi = s*(units >> 7) and lo = s*(units & 127), and the kernel forms
//   (xq@hi << 7) + xq@lo in int32.  Every product and sum is an exact
//   integer, so the order of summation does not matter.  (A bf16 MMA with
//   f32 sums would round once a partial sum passes 2^24 units, i.e. at
//   K >= 517.)
// * The .col B fragment wants K contiguous per column and ldmatrix cannot
//   transpose bytes, so the convert pass transposes 4 x 4 byte blocks with
//   byte permutes and writes the planes n-major into shared memory: the
//   payload alone for int8_matmul; payload, hi and lo for m2q_matmul, each
//   byte's (hi, lo) from a 256-entry table the block builds once.
// * x and payload tiles stream through a ring of STAGES buffers with
//   cp.async (16 B a thread where rows are 16-byte aligned; 8 or 4 B, or
//   plain loads, otherwise).  The converted tiles are double-buffered, so
//   each K step has one barrier: the tensor cores work on step i while
//   the same warps quantize and convert step i + 1 and the copies of the
//   steps after it are in flight.
// * Enough blocks at every shape: the wrapper picks the tile (64 x 64,
//   64 x 32 or 128 x 16, so N = 16 and N = 32 waste no columns; 32 rows
//   at M <= 32) and, where the tiles alone leave SMs idle, splits K over
//   a thread block cluster of up to 8 blocks.  The cluster's blocks add
//   their int32 partial sums and rowsums through distributed shared
//   memory and each writes a slice of the tile: one launch, no workspace,
//   still exact.  Warp tiles are small (32 or 16 x 16), so a block has
//   128-512 threads for the quantize and convert passes and few registers
//   each.
// * x is quantized in the prologue of each step, once per element and
//   N-tile, bit for bit as the plain versions round (IEEE quotient, round
//   half to even).  The IEEE division is a call with a slow-path branch,
//   so a thread's divisions run one after another, and in a first
//   version of this design they set the time of the long-K launches.  A
//   reciprocal multiply decides every element whose rounding it cannot
//   get wrong and __fdiv_rn decides the rest (see Quantizer).  Where a
//   shape has more than one N-tile, x is at most 1568 x 512, so
//   repeating the quantization costs less than a separate launch would.
// * Each function's epilogue (M2Q, Int8 below) repeats its plain
//   version's operations in its order with explicitly rounded
//   __fmul_rn/__fsub_rn/__fadd_rn, so nvcc cannot contract them into FMAs
//   the plain version does not do.  A bf16 y is the f32 result rounded to
//   nearest even, as torch's cast of the plain version's f32 output.
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError().
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BK = 32;           // K per step: one m16n8k32 deep
constexpr int STAGES = 3;        // cp.async ring depth
constexpr int KROW = BK + 16;    // bytes per row of xq and of each plane:
                                 // 48 keeps fragment loads conflict-free
constexpr int MAX_SPLIT = 8;     // portable cluster size

// rne(v) clipped to +-127, as an int.  The conversion rounds half to
// even, saturates and sends NaN to 0 (cvt.rni.s32.f32), as the plain
// version's (and XLA's) float -> int8 cast does; an fminf/fmaxf clip in
// float would send NaN to -127.
__device__ __forceinline__ int clip127(float v) {
  return max(-127, min(127, __float2int_rn(v)));
}

// clip(rint(v / sa), +-127), bit for bit as the plain version rounds it
// (IEEE quotient, round half to even), for E elements at once.
//
// An IEEE division is a call with a slow-path branch, so E of them in a
// row run one after another; per element that cost more than the whole
// K step.  But only the rounded integer is needed.  With r = RN(1/sa) and
// t = RN(v*r), t differs from Q = RN(v/sa) by at most 3*2^-24*|v/sa|,
// under 2^-15 where |v/sa| < 129, so rint(t) = rint(Q) unless t lies
// within 2^-12 of a half-integer (|t - rint(t)| > 0.5 - 2^-12); at or
// beyond 128 both clip to +-127.
// Only a chunk holding such a near-tie (or a scale outside the normal
// range, where r or t could overflow) takes __fdiv_rn, element by
// element; NaN and infinities take the same clip either way.
struct Quantizer {
  float sa, r;  // the scale and RN(1 / scale)
  bool fast;    // the scale is in the range the argument above needs
};

__device__ __forceinline__ Quantizer make_quantizer(float sa) {
  const float a = fabsf(sa);
  return {sa, __frcp_rn(sa), a >= 0x1p-125f && a <= 0x1p125f};
}

// ROLLED keeps the divisions in a loop with one call site, which puts v
// and q in local memory (a stack frame of 8*E bytes) on every path;
// unrolled they stay in registers, and the Int8 instance runs faster on
// the H100 (PERF.md).  M2Q keeps the rolled loop its tiles were tuned with.
template <int E, bool ROLLED>
__device__ __forceinline__ void quantize(const Quantizer& qz,
                                         const float (&v)[E], int (&q)[E]) {
  bool near = !qz.fast;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const float t = __fmul_rn(v[e], qz.r);
    const float n = rintf(t);
    near |= fabsf(t) < 128.f && fabsf(__fsub_rn(t, n)) > 0.5f - 0x1p-12f;
    q[e] = clip127(n);
  }
  if (near) {
#pragma unroll (ROLLED ? 1 : E)
    for (int e = 0; e < E; ++e) q[e] = clip127(rintf(__fdiv_rn(v[e], qz.sa)));
  }
}

// 16 bytes of x as f32 values, unpacked in registers.
__device__ __forceinline__ void unpack(const uint4& raw, float (&v)[4]) {
  v[0] = __uint_as_float(raw.x);
  v[1] = __uint_as_float(raw.y);
  v[2] = __uint_as_float(raw.z);
  v[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack(const uint4& raw, float (&v)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 -> f32 is exact: the high half
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// One payload byte -> its APoT (hi, lo) int8 pair: the code's units of
// 2^-7, s*(2^(7-e1) + 2^(7-e2)), are (hi << 7) + lo; 0 where bit 7 is set.
__device__ __forceinline__ void decode(uint32_t c, int& hi, int& lo) {
  int mag = (1 << (7 - ((c >> 3) & 7))) + (1 << (7 - (c & 7)));
  if (c & 0x80) mag = 0;
  hi = mag >> 7;
  lo = mag & 127;
  if (c & 0x40) {
    hi = -hi;
    lo = -lo;
  }
}

// y stores: f32, or bf16 rounded to nearest even (as torch's cast)
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
// two adjacent columns; p is 2-element aligned
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The two functions of the template, chosen at compile time.  Each names
// its column scales, how a column loads them, and its epilogue, which
// repeats its plain version's operations in order, each rounded once.

// m2q_matmul: the uniform and APoT engines, f32 y.
struct M2Q {
  static constexpr bool APOT = true;
  using Out = float;
  struct Params {
    const float *u_scale, *u_zp, *a_scale;
  };
  struct Col {
    float us, uz, as;
  };
  static __device__ __forceinline__ Col column(int n, int N, const Params& p,
                                               float) {
    if (n >= N) return {0.f, 0.f, 0.f};
    return {p.u_scale[n], p.u_zp[n], p.a_scale[n]};
  }
  // ((acc_u - rowsum*u_zp)*u_scale + (acc_a*2^-7)*a_scale)*sa
  static __device__ __forceinline__ float epilogue(int acc_u, int acc_a,
                                                   int xsum, const Col& c,
                                                   float sa) {
    const float corr = __fmul_rn((float)xsum, c.uz);
    const float yu = __fmul_rn(__fsub_rn((float)acc_u, corr), c.us);
    const float ya = __fmul_rn(__fmul_rn((float)acc_a, 0.0078125f), c.as);
    return __fmul_rn(__fadd_rn(yu, ya), sa);
  }
};

// int8_matmul: the uniform engine alone, y in Out (f32 or bf16).
template <typename O>
struct Int8 {
  static constexpr bool APOT = false;
  using Out = O;
  struct Params {
    const float *scale, *zp;
  };
  struct Col {
    float s, zp;  // RN(sa * scale), zp
  };
  static __device__ __forceinline__ Col column(int n, int N, const Params& p,
                                               float sa) {
    if (n >= N) return {0.f, 0.f};
    return {__fmul_rn(sa, p.scale[n]), p.zp[n]};
  }
  // (acc - rowsum*zp) * (sa*scale)
  static __device__ __forceinline__ float epilogue(int acc, int, int xsum,
                                                   const Col& c, float) {
    const float corr = __fmul_rn((float)xsum, c.zp);
    return __fmul_rn(__fsub_rn((float)acc, corr), c.s);
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Copy `bytes` (16, 8 or 4) from src to shared dst; fill zeros if !valid.
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes, bool valid) {
  const uint32_t d = smem_addr(dst);
  const int n = valid ? bytes : 0;
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
  } else if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d = a (16x32 s8, row) * b (32x8 s8, col) + c, all int32 sums.
__device__ __forceinline__ void mma(int (&d)[4], const int (&a)[4],
                                    const int (&b)[2], const int (&c)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "r"(c[0]), "r"(c[1]), "r"(c[2]), "r"(c[3]));
}

// Tile geometry of one (BM, BN) configuration with x elements of type T;
// APOT: the converted payload carries the hi/lo planes and the table.
template <typename T, int BM_, int BN_, bool APOT_>
struct Tile {
  using X = T;
  static constexpr int BM = BM_;
  static constexpr int BN = BN_;
  static constexpr bool APOT = APOT_;
  // warp tile WM x 16: small, so a block has many threads for the
  // quantize and convert passes and few registers each
  static constexpr int WM = BN >= 32 ? 32 : 16;
  static constexpr int WN = 16;
  static constexpr int WARPS_M = BM / WM;
  static constexpr int WARPS_N = BN / WN;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int MI = WM / 16;  // m16 fragments per warp
  static constexpr int NI = WN / 8;   // n8 fragments per warp
  static constexpr int TPR = THREADS / BM;  // threads quantizing one row
  static constexpr int EPT = BK / TPR;      // x elements each converts
  // raw x rows padded by 16 B: conflict-free 16-byte reads in the
  // quantize pass, 16-byte aligned cp.async destinations
  static constexpr int XROW = BK * (int)sizeof(T) + 16;
  static constexpr int XRAW = BM * XROW;     // bytes per stage
  static constexpr int PROW = BN + 16;       // payload row, padded
  static constexpr int PRAW = BK * PROW;     // payload bytes per stage
  static constexpr int PLANES = APOT ? 3 : 1;  // payload (hi, lo)
  // shared memory layout (bytes)
  static constexpr int OFF_PRAW = STAGES * XRAW;
  static constexpr int OFF_XQ = OFF_PRAW + STAGES * PRAW;
  static constexpr int XQ = BM * KROW;           // converted tiles: two
  static constexpr int PL = PLANES * BN * KROW;  // buffers each
  static constexpr int OFF_PL = OFF_XQ + 2 * XQ;
  // split K parks each engine's int32 sums and a slice's rowsums over
  // the pipeline's buffers once the main loop is done
  static constexpr int ES = BN + 8;  // row stride: conflict-free int2
  static constexpr int EPI = ((APOT ? 2 : 1) * BM * ES + BM / 2) * 4;
  static constexpr int OFF_RSUM =
      OFF_PL + 2 * PL > EPI ? OFF_PL + 2 * PL : EPI;
  static constexpr int OFF_LUT = OFF_RSUM + BM * 4;
  static constexpr int SMEM = OFF_LUT + (APOT ? 256 * 4 : 0);
};

// Issue the copies of one K step (x rows m0.., payload columns n0..) into
// ring slot `slot`.  vx / vp: copy width in bytes for x / payload rows
// (0: rows not 4-byte aligned, plain loads instead).
template <typename G>
__device__ __forceinline__ void load_step(
    unsigned char* smem, int slot, const typename G::X* __restrict__ x,
    const int8_t* __restrict__ P, int M, int N, int K, int m0, int n0,
    int k0, int vx, int vp) {
  using T = typename G::X;
  constexpr int BM = G::BM, BN = G::BN;
  const int tid = threadIdx.x;
  unsigned char* xs = smem + slot * G::XRAW;
  unsigned char* ps = smem + G::OFF_PRAW + slot * G::PRAW;
  constexpr int XB = BK * (int)sizeof(T);  // bytes of one row's step
  if (vx == 16) {
    constexpr int PR = XB / 16, EX = 16 / (int)sizeof(T), NC = BM * PR;
#pragma unroll
    for (int it = 0; it < (NC + G::THREADS - 1) / G::THREADS; ++it) {
      const int i = tid + it * G::THREADS;
      if (NC % G::THREADS != 0 && i >= NC) break;
      const int r = i / PR, c = i % PR;
      const int gm = m0 + r, gk = k0 + c * EX;
      const bool ok = gm < M && gk < K;  // K % EX == 0: all or nothing
      cp_async(xs + r * G::XROW + c * 16,
               ok ? (const void*)(x + (int64_t)gm * K + gk) : (const void*)x,
               16, ok);
    }
  } else if (vx) {
    const int per_row = XB / vx, ex = vx / (int)sizeof(T);
    for (int i = tid; i < BM * per_row; i += G::THREADS) {
      const int r = i / per_row, c = i % per_row;
      const int gm = m0 + r, gk = k0 + c * ex;
      const bool ok = gm < M && gk < K;  // K % ex == 0: all or nothing
      cp_async(xs + r * G::XROW + c * vx,
               ok ? (const void*)(x + (int64_t)gm * K + gk) : (const void*)x,
               vx, ok);
    }
  } else {
    for (int i = tid; i < BM * BK; i += G::THREADS) {
      const int r = i / BK, c = i % BK;
      const int gm = m0 + r, gk = k0 + c;
      T v = T(0.f);
      if (gm < M && gk < K) v = x[(int64_t)gm * K + gk];
      reinterpret_cast<T*>(xs + r * G::XROW)[c] = v;
    }
  }
  if (vp == 16) {
    constexpr int PR = BN / 16, NC = BK * PR;
#pragma unroll
    for (int it = 0; it < (NC + G::THREADS - 1) / G::THREADS; ++it) {
      const int i = tid + it * G::THREADS;
      if (NC % G::THREADS != 0 && i >= NC) break;
      const int r = i / PR, c = i % PR;
      const int gk = k0 + r, gn = n0 + c * 16;
      const bool ok = gk < K && gn < N;  // N % 16 == 0: all or nothing
      cp_async(ps + r * G::PROW + c * 16,
               ok ? (const void*)(P + (int64_t)gk * N + gn) : (const void*)P,
               16, ok);
    }
  } else if (vp) {
    const int per_row = BN / vp;
    for (int i = tid; i < BK * per_row; i += G::THREADS) {
      const int r = i / per_row, c = i % per_row;
      const int gk = k0 + r, gn = n0 + c * vp;
      const bool ok = gk < K && gn < N;  // N % vp == 0: all or nothing
      cp_async(ps + r * G::PROW + c * vp,
               ok ? (const void*)(P + (int64_t)gk * N + gn) : (const void*)P,
               vp, ok);
    }
  } else {
    for (int i = tid; i < BK * BN; i += G::THREADS) {
      const int r = i / BN, c = i % BN;
      const int gk = k0 + r, gn = n0 + c;
      ps[r * G::PROW + c] =
          (gk < K && gn < N) ? (unsigned char)P[(int64_t)gk * N + gn] : 0;
    }
  }
}

// Quantize one landed K step (ring slot `slot`) into xq and convert its
// payload into the planes `pl`; adds the thread's share of rowsum.
template <typename G>
__device__ __forceinline__ void convert_step(
    const unsigned char* smem, int slot, int8_t* xq, int8_t* pl,
    const uint32_t* lut, const Quantizer& qz, int k0, int K,
    int& row_sum) {
  using T = typename G::X;
  constexpr int BN = G::BN;
  const int tid = threadIdx.x;
  // quantize: TPR threads per row, EPT contiguous elements each, read
  // 16 bytes at a time (conflict-free with the padded rows)
  {
    constexpr int PER16 = 16 / (int)sizeof(T);
    const int qrow = tid / G::TPR, qpart = tid % G::TPR;
    const unsigned char* src =
        smem + slot * G::XRAW + qrow * G::XROW + qpart * G::EPT * sizeof(T);
    int8_t* dst = xq + qrow * KROW + qpart * G::EPT;
    const int kc = k0 + qpart * G::EPT;
#pragma unroll
    for (int e = 0; e < G::EPT; e += PER16) {
      if (kc + e >= K) {  // past K (K = 16 and 32 leave most of the step)
#pragma unroll
        for (int w = 0; w < PER16 / 4; ++w)
          *reinterpret_cast<uint32_t*>(dst + e + 4 * w) = 0;
        continue;
      }
      float v[PER16];
      int q[PER16];
      unpack(*reinterpret_cast<const uint4*>(src + e * sizeof(T)), v);
      quantize<PER16, G::APOT>(qz, v, q);
#pragma unroll
      for (int w = 0; w < PER16 / 4; ++w) {
        uint32_t word = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qq = kc + e + 4 * w + j < K ? q[4 * w + j] : 0;
          row_sum += qq;
          word |= (uint32_t)(qq & 0xff) << (8 * j);
        }
        *reinterpret_cast<uint32_t*>(dst + e + 4 * w) = word;
      }
    }
  }
  // convert: the payload tile (k-major) -> n-major int8 planes.  Each
  // thread takes a 4 x 4 byte block: four row words, transposed with byte
  // permutes into four column words (the uniform plane), and (APoT) each
  // byte's (hi, lo) pair looked up in the block's 256-entry table.
  {
    const unsigned char* ps = smem + G::OFF_PRAW + slot * G::PRAW;
    constexpr int BLOCKS = (BK / 4) * (BN / 4);
#pragma unroll
    for (int it = 0; it < (BLOCKS + G::THREADS - 1) / G::THREADS; ++it) {
      const int b = tid + it * G::THREADS;
      if (BLOCKS % G::THREADS != 0 && b >= BLOCKS) break;
      const int kq = b % (BK / 4), n4 = b / (BK / 4);  // 2-way stores
      uint32_t r[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        r[j] = *reinterpret_cast<const uint32_t*>(
            ps + (4 * kq + j) * G::PROW + 4 * n4);
      const uint32_t lo01 = __byte_perm(r[0], r[1], 0x5140);
      const uint32_t hi01 = __byte_perm(r[0], r[1], 0x7362);
      const uint32_t lo23 = __byte_perm(r[2], r[3], 0x5140);
      const uint32_t hi23 = __byte_perm(r[2], r[3], 0x7362);
      const uint32_t col[4] = {__byte_perm(lo01, lo23, 0x5410),
                               __byte_perm(lo01, lo23, 0x7632),
                               __byte_perm(hi01, hi23, 0x5410),
                               __byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t u = col[i];
        const int off = (4 * n4 + i) * KROW + 4 * kq;
        *reinterpret_cast<uint32_t*>(pl + off) = u;
        if constexpr (G::APOT) {
          const uint32_t v0 = lut[u & 0xff], v1 = lut[(u >> 8) & 0xff];
          const uint32_t v2 = lut[(u >> 16) & 0xff], v3 = lut[u >> 24];
          const uint32_t h = __byte_perm(__byte_perm(v0, v1, 0x0040),
                                         __byte_perm(v2, v3, 0x0040), 0x5410);
          const uint32_t l = __byte_perm(__byte_perm(v0, v1, 0x0051),
                                         __byte_perm(v2, v3, 0x0051), 0x5410);
          *reinterpret_cast<uint32_t*>(pl + BN * KROW + off) = h;
          *reinterpret_cast<uint32_t*>(pl + 2 * BN * KROW + off) = l;
        }
      }
    }
  }
}

// One K step of the warp's tile on the tensor cores (m16n8k32): the
// uniform plane into acc_u; (APoT) the hi/lo planes into acc_a as
// (hi << 7) + lo.
template <typename G>
__device__ __forceinline__ void mma_step(const int8_t* xq, const int8_t* pl,
                                         int wm0, int wn0, int g, int t4,
                                         int (&acc_u)[G::MI][G::NI][4],
                                         int (&acc_a)[G::MI][G::NI][4]) {
  static_assert(BK == 32, "one m16n8k32 per step");
  constexpr int BN = G::BN;
  const int zero[4] = {0, 0, 0, 0};
  int a[G::MI][4];
#pragma unroll
  for (int mi = 0; mi < G::MI; ++mi) {
    const int8_t* r0 = xq + (wm0 + mi * 16 + g) * KROW + 4 * t4;
    a[mi][0] = *reinterpret_cast<const int*>(r0);
    a[mi][1] = *reinterpret_cast<const int*>(r0 + 8 * KROW);
    a[mi][2] = *reinterpret_cast<const int*>(r0 + 16);
    a[mi][3] = *reinterpret_cast<const int*>(r0 + 8 * KROW + 16);
  }
#pragma unroll
  for (int ni = 0; ni < G::NI; ++ni) {
    const int8_t* c0 = pl + (wn0 + ni * 8 + g) * KROW + 4 * t4;
    int bu[2];
    bu[0] = *reinterpret_cast<const int*>(c0);
    bu[1] = *reinterpret_cast<const int*>(c0 + 16);
    if constexpr (G::APOT) {
      int bh[2], bl[2];
      bh[0] = *reinterpret_cast<const int*>(c0 + BN * KROW);
      bh[1] = *reinterpret_cast<const int*>(c0 + BN * KROW + 16);
      bl[0] = *reinterpret_cast<const int*>(c0 + 2 * BN * KROW);
      bl[1] = *reinterpret_cast<const int*>(c0 + 2 * BN * KROW + 16);
#pragma unroll
      for (int mi = 0; mi < G::MI; ++mi) {
        mma(acc_u[mi][ni], a[mi], bu, acc_u[mi][ni]);
        int th[4];
        mma(th, a[mi], bh, zero);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc_a[mi][ni][j] += th[j] * 128;
        mma(acc_a[mi][ni], a[mi], bl, acc_a[mi][ni]);
      }
    } else {
#pragma unroll
      for (int mi = 0; mi < G::MI; ++mi)
        mma(acc_u[mi][ni], a[mi], bu, acc_u[mi][ni]);
    }
  }
}

template <typename Fn, typename T, int BM, int BN>
__global__ void __launch_bounds__(Tile<T, BM, BN, Fn::APOT>::THREADS)
matmul_kernel(const T* __restrict__ x, const float* __restrict__ sa_ptr,
              const int8_t* __restrict__ P, const typename Fn::Params prm,
              typename Fn::Out* __restrict__ y, int M, int N, int K, int vx,
              int vp) {
  using G = Tile<T, BM, BN, Fn::APOT>;
  using Col = typename Fn::Col;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* xq = reinterpret_cast<int8_t*>(smem + G::OFF_XQ);
  int8_t* pl = reinterpret_cast<int8_t*>(smem + G::OFF_PL);  // u (hi, lo)
  int* rsum = reinterpret_cast<int*>(smem + G::OFF_RSUM);
  uint32_t* lut = reinterpret_cast<uint32_t*>(smem + G::OFF_LUT);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wm0 = (warp / G::WARPS_N) * G::WM;
  const int wn0 = (warp % G::WARPS_N) * G::WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int splits = gridDim.z, split = blockIdx.z;

  // this split's K steps
  const int steps = (K + BK - 1) / BK;
  const int per = (steps + splits - 1) / splits;
  const int s0 = min(split * per, steps);
  const int ns = min(s0 + per, steps) - s0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ns)
      load_step<G>(smem, s, x, P, M, N, K, m0, n0, (s0 + s) * BK, vx, vp);
    cp_async_commit();
  }
  if constexpr (G::APOT) {
    // payload byte -> its APoT (hi, lo) int8 pair in bytes 0 and 1
    for (int c = tid; c < 256; c += G::THREADS) {
      int hi, lo;
      decode((uint32_t)c, hi, lo);
      lut[c] = (uint32_t)(hi & 0xff) | (uint32_t)(lo & 0xff) << 8;
    }
  }
  const Quantizer qz = make_quantizer(*sa_ptr);
  // the epilogue's column scales, loaded now so their latency hides
  // behind the main loop: per MMA fragment column, and (split K) the one
  // column a thread writes
  Col col[G::NI][2];
#pragma unroll
  for (int ni = 0; ni < G::NI; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      col[ni][j] = Fn::column(n0 + wn0 + ni * 8 + 2 * t4 + j, N, prm, qz.sa);
  static_assert(G::THREADS % BN == 0, "a thread keeps one column");
  const int c = tid % BN, gn = n0 + c;
  const Col cc = Fn::column(gn, N, prm, qz.sa);

  int acc_u[G::MI][G::NI][4] = {};
  int acc_a[G::MI][G::NI][4] = {};  // APoT units of 2^-7 (M2Q only)
  int row_sum = 0;  // this thread's share of rowsum(xq) for its row

  // Software pipeline, one barrier per step: while the tensor cores work
  // on step i (converted buffer i % 2), the threads convert step i + 1
  // into the other buffer and the copies of later steps are in flight.
  if (ns > 0) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    convert_step<G>(smem, 0, xq, pl, lut, qz, s0 * BK, K, row_sum);
  }
  for (int i = 0; i < ns; ++i) {
    const int nxt = i + STAGES - 1;  // into the slot step i - 1 used
    if (nxt < ns)
      load_step<G>(smem, nxt % STAGES, x, P, M, N, K, m0, n0,
                   (s0 + nxt) * BK, vx, vp);
    cp_async_commit();
    cp_async_wait<STAGES - 2>();  // step i + 1 landed
    __syncthreads();  // step i converted; step i - 1's MMAs are done
    const int cur = i & 1;
    if (i + 1 < ns)
      convert_step<G>(smem, (i + 1) % STAGES, xq + (cur ^ 1) * G::XQ,
                      pl + (cur ^ 1) * G::PL, lut, qz, (s0 + i + 1) * BK, K,
                      row_sum);
    mma_step<G>(xq + cur * G::XQ, pl + cur * G::PL, wm0, wn0, g, t4, acc_u,
                acc_a);
  }
  cp_async_wait<0>();

  // rowsum: the TPR threads of a row are adjacent lanes
#pragma unroll
  for (int o = 1; o < G::TPR; o <<= 1)
    row_sum += __shfl_xor_sync(0xffffffffu, row_sum, o);
  if (tid % G::TPR == 0) rsum[tid / G::TPR] = row_sum;

  if (splits == 1) {
    const float sa = qz.sa;
    __syncthreads();
#pragma unroll
    for (int mi = 0; mi < G::MI; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm0 + mi * 16 + g + 8 * h, gm = m0 + r;
        if (gm >= M) continue;
        const int xs = rsum[r];
#pragma unroll
        for (int ni = 0; ni < G::NI; ++ni) {
          const int gn = n0 + wn0 + ni * 8 + 2 * t4;  // even
          float out[2];
#pragma unroll
          for (int j = 0; j < 2; ++j)
            out[j] = Fn::epilogue(acc_u[mi][ni][2 * h + j],
                                  acc_a[mi][ni][2 * h + j], xs, col[ni][j],
                                  sa);
          typename Fn::Out* dst = y + (int64_t)gm * N + gn;
          if (gn + 1 < N && N % 2 == 0) {
            store2(dst, out[0], out[1]);
          } else if (gn < N) {
            store1(dst, out[0]);
            if (gn + 1 < N) store1(dst + 1, out[1]);
          }
        }
      }
    }
    return;
  }

  // split K: park the partial sums in shared memory (over the pipeline's
  // buffers, which the main loop no longer needs), then each block of the
  // cluster adds every block's sums for its slice of BM / splits rows
  // and writes that slice of y
  constexpr int ES = G::ES;
  constexpr int ENGINES = G::APOT ? 2 : 1;
  int* eu = reinterpret_cast<int*>(smem);  // [BM][ES] uniform sums
  int* ea = eu + BM * ES;                  // [BM][ES] APoT sums (M2Q)
  int* rtot = eu + ENGINES * BM * ES;      // [BM / 2] the slice's rowsums
  __syncthreads();  // this block's MMAs are done with the buffers
#pragma unroll
  for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < G::NI; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int off = (wm0 + mi * 16 + g + 8 * h) * ES + wn0 + ni * 8 +
                        2 * t4;
        *reinterpret_cast<int2*>(eu + off) =
            make_int2(acc_u[mi][ni][2 * h], acc_u[mi][ni][2 * h + 1]);
        if constexpr (G::APOT)
          *reinterpret_cast<int2*>(ea + off) =
              make_int2(acc_a[mi][ni][2 * h], acc_a[mi][ni][2 * h + 1]);
      }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rows = BM / splits;  // splits divides BM (a power of 2 <= 8)
  const int r0 = (int)cluster.block_rank() * rows;
  // every block's sums at once: unrolled over the largest cluster, so the
  // distributed shared memory reads are all in flight together
  for (int r = tid; r < rows; r += G::THREADS) {
    int sx = 0;
#pragma unroll
    for (int q = 0; q < MAX_SPLIT; ++q)
      if (q < splits) sx += cluster.map_shared_rank(rsum, q)[r0 + r];
    rtot[r] = sx;
  }
  __syncthreads();
#pragma unroll 4
  for (int r = tid / BN; r < rows; r += G::THREADS / BN) {
    const int off = (r0 + r) * ES + c;
    int su = 0, sa_ = 0;
#pragma unroll
    for (int q = 0; q < MAX_SPLIT; ++q) {
      if (q < splits) {
        su += cluster.map_shared_rank(eu, q)[off];
        if constexpr (G::APOT) sa_ += cluster.map_shared_rank(ea, q)[off];
      }
    }
    const int gm = m0 + r0 + r;
    if (gm < M && gn < N)
      store1(y + (int64_t)gm * N + gn,
             Fn::epilogue(su, sa_, rtot[r], cc, qz.sa));
  }
  cluster.sync();  // no block leaves while another reads its sums
}

// Copy width for rows of `row_bytes` starting at `p`: 16, 8 or 4 bytes,
// or 0 (plain loads) when rows are not 4-byte aligned.
int vec_bytes(const void* p, int64_t row_bytes) {
  for (int v = 16; v >= 4; v /= 2)
    if (row_bytes % v == 0 && (uintptr_t)p % v == 0) return v;
  return 0;
}

template <typename Fn, typename T, int BM, int BN>
int launch(const void* x, const float* sa, const int8_t* P,
           const typename Fn::Params& prm, void* y, int M, int N, int K,
           int splits, cudaStream_t s) {
  using G = Tile<T, BM, BN, Fn::APOT>;
  auto kernel = matmul_kernel<Fn, T, BM, BN>;
  const int smem = G::SMEM;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  cfg.blockDim = dim3(G::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute la[1];
  la[0].id = cudaLaunchAttributeClusterDimension;
  la[0].val.clusterDim.x = 1;
  la[0].val.clusterDim.y = 1;
  la[0].val.clusterDim.z = splits;
  cfg.attrs = la;
  cfg.numAttrs = splits > 1 ? 1 : 0;  // a plain launch needs no cluster
  const int vx = vec_bytes(x, (int64_t)K * sizeof(T));
  const int vp = vec_bytes(P, N);
  cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, (const T*)x, sa, P, prm,
                         (typename Fn::Out*)y, M, N, K, vx, vp);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename Fn, typename T>
int dispatch(const void* x, const float* sa, const int8_t* P,
             const typename Fn::Params& prm, void* y, int M, int N, int K,
             int bm, int bn, int splits, cudaStream_t s) {
  if (splits < 1 || splits > MAX_SPLIT || (splits & (splits - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return (int)cudaGetLastError();
#define MATMUL_TILE(BM_, BN_)                                              \
  if (bm == BM_ && bn == BN_)                                              \
    return launch<Fn, T, BM_, BN_>(x, sa, P, prm, y, M, N, K, splits, s);
  MATMUL_TILE(128, 16) MATMUL_TILE(64, 64) MATMUL_TILE(64, 32)
  MATMUL_TILE(32, 64) MATMUL_TILE(32, 32)
#undef MATMUL_TILE
  return (int)cudaErrorInvalidValue;
}

template <typename Fn>
int dispatch_x(const void* x, int x_is_bf16, const float* sa,
               const int8_t* P, const typename Fn::Params& prm, void* y,
               int M, int N, int K, int bm, int bn, int splits,
               cudaStream_t s) {
  if (x_is_bf16)
    return dispatch<Fn, __nv_bfloat16>(x, sa, P, prm, y, M, N, K, bm, bn,
                                       splits, s);
  return dispatch<Fn, float>(x, sa, P, prm, y, M, N, K, bm, bn, splits, s);
}

}  // namespace

// bm x bn: the output tile, one of those dispatch() instantiates (the
// wrappers' m2q_matmul.TILES);
// splits: blocks of one cluster that share the tile's K (1, 2, 4 or 8).
extern "C" int m2q_matmul(const void* x, const void* act_scale,
                          const void* payload, const void* u_scale,
                          const void* u_zp, const void* a_scale, void* y,
                          int M, int N, int K, int x_is_bf16, int bm, int bn,
                          int splits, void* stream) {
  const M2Q::Params prm = {(const float*)u_scale, (const float*)u_zp,
                           (const float*)a_scale};
  return dispatch_x<M2Q>(x, x_is_bf16, (const float*)act_scale,
                         (const int8_t*)payload, prm, y, M, N, K, bm, bn,
                         splits, (cudaStream_t)stream);
}

// y_is_bf16: store y as bf16 (rounded to nearest even), else f32.
extern "C" int int8_matmul(const void* x, const void* wq,
                           const void* act_scale, const void* scale,
                           const void* zero_point, void* y, int M, int N,
                           int K, int x_is_bf16, int y_is_bf16, int bm,
                           int bn, int splits, void* stream) {
  const float* sa = (const float*)act_scale;
  const int8_t* W = (const int8_t*)wq;
  const float *sc = (const float*)scale, *zp = (const float*)zero_point;
  cudaStream_t s = (cudaStream_t)stream;
  if (y_is_bf16)
    return dispatch_x<Int8<__nv_bfloat16>>(x, x_is_bf16, sa, W, {sc, zp}, y,
                                           M, N, K, bm, bn, splits, s);
  return dispatch_x<Int8<float>>(x, x_is_bf16, sa, W, {sc, zp}, y, M, N, K,
                                 bm, bn, splits, s);
}

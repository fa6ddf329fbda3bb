// Weights-only matmuls for Hopper (sm_90a): one template, two weight
// decodes.
//
// Replaces two TPU kernels, each an entry point below:
// - repro/kernels/int4_matmul.py::int4_matmul (body _kernel):
//   y = x @ ((unpack(P) - zp) * scale), P the (K, N/2) nibble-packed
//   payload (low nibble = even column);
// - repro/kernels/apot_matmul.py::apot_matmul (body _kernel):
//   y = (x @ decode(codes)) * scale, a code byte decoding to
//   s*(2^-e1 + 2^-e2) (bit6 = sign, bits5..3 = e1, bits2..0 = e2) and to 0
//   when bit7 is set (decode_apot_tile).
// Both are f32 dots on float activations; y is f32.
//
// What bounds them on the H100: bytes.  At the weights-only recipes'
// PWConvs (K 16..1024, N 16..1000, M = batch*pixels up to ~10^5) x (bf16,
// read once) and y (f32, written once) set the floor; at qwen's lm_head
// (M = 8, K = 1024, N = 151936) the 78 MB int4 payload does.  The
// operations are few next to either at the bf16 tensor-core rate.
//
// Design, bf16 x (every launch of the served paths):
// * Both decoded weights are exact in bf16: (q - zp) is an integer in
//   [-15, 15] (uniform_quantize rounds zp), an APoT value has at most 8
//   significant bits.  So the products run on bf16 tensor cores
//   (mma.sync m16n8k16, f32 accumulation) and the per-column scale
//   multiplies once in the epilogue, for both decodes.
// * The payload is never decoded into shared memory.  x and payload tiles
//   stream through a ring of cp.async stages (16 B copies where rows are
//   aligned); each warp reads its payload words from the landed tile and
//   decodes them in registers straight into MMA fragments.  The k order
//   inside each 16-deep MMA step is permuted (logical k 2t, 2t+1, 2t+8,
//   2t+9 of lane t%4 -> physical k 4t..4t+3), the same for both operands,
//   so a lane's fragments come from four consecutive payload rows and one
//   8-byte x load; a lane's columns are adjacent in a payload row, so a
//   4-bit word or an APoT byte group decodes into several fragments.
//   int4 decodes by bit tricks: bf16(128 + q) is 0x4300 | q, and one bf16
//   subtraction of bf16(128 + zp) gives q - zp exactly.
// * Two plans.  M > 16: block tiles of 32-128 rows by 16/32/64 columns,
//   x the MMA's A operand; a warp takes 16 columns by up to 64 rows, so a
//   lane's two decoded columns feed 4-8 MMAs.  M <= 16 (the lm_head, B1's
//   head): operands swapped, y^T = W^T x^T, so 16 output columns take the
//   MMA's 16-row side and the tokens its 8-wide side; each warp owns 64
//   columns and every payload byte is read and decoded once.
// * Where the tiles leave SMs idle, K splits over a thread block cluster
//   of up to 8 blocks; the blocks add their f32 partial sums through
//   distributed shared memory and each writes a slice of the tile.
// * Ragged edges (K = 16, 27, 72; N = 130, 1000) are masked in the copies
//   (zero fill) and the stores, never padded in memory: an APoT pad byte
//   0x00 would decode to 2, but it only meets zero-filled x.
// The tensor cores' f32 sums run in another order than the plain
// version's matmul; the result stays within the f32 summation bound
// (K + 1) * 2^-23 * (|x| @ |W|).
//
// f32 x keeps the first design, f32 FMAs on 64x64 tiles (a bf16 product
// of an f32 x would not be exact): chosen by dtype, never on a failure.
//
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError().
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// ===========================================================================
// f32 x: the f32 FMA kernel
// ===========================================================================

constexpr int F_BM = 64;
constexpr int F_BN = 64;
constexpr int F_BK = 32;
constexpr int F_THREADS = 256;

// 4-bit uniform: the decoded weight carries the scale; no epilogue scale.
struct Int4Weights {
  static constexpr bool kScaleOut = false;
  const uint8_t* P;
  const float* scale;
  const float* zp;
  int N;
  __device__ float weight(int k, int n) const {
    const uint8_t b = P[(int64_t)k * (N / 2) + n / 2];
    const int q = (n & 1) ? (b >> 4) : (b & 0x0F);
    return __fmul_rn(__fsub_rn((float)q, zp[n]), scale[n]);
  }
  __device__ float out_scale(int) const { return 1.f; }
};

// APoT codes: the decoded value is exact; the scale is applied per filter
// in the epilogue.
struct ApotWeights {
  static constexpr bool kScaleOut = true;
  const uint8_t* codes;
  const float* scale;
  int N;
  __device__ float weight(int k, int n) const {
    const uint8_t c = codes[(int64_t)k * N + n];
    if (c & 0x80) return 0.f;
    const int mag = (1 << (7 - ((c >> 3) & 7))) + (1 << (7 - (c & 7)));
    return (float)((c & 0x40) ? -mag : mag) * 0.0078125f;
  }
  __device__ float out_scale(int n) const { return scale[n]; }
};

// One 256-thread block per 64x64 output tile, a loop over K in steps of
// 32; each thread accumulates 4x4 outputs with f32 FMAs in ascending k.
template <typename Weights>
__global__ void __launch_bounds__(F_THREADS)
fma_kernel(const float* __restrict__ x, const Weights w, float* __restrict__ y,
           int M, int N, int K) {
  __shared__ float xs[F_BM][F_BK + 1];
  __shared__ float ws[F_BK][F_BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output columns tx + 16*j
  const int ty = tid / 16;  // output rows    ty + 16*i
  const int m0 = blockIdx.y * F_BM;
  const int n0 = blockIdx.x * F_BN;

  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += F_BK) {
    for (int i = tid; i < F_BM * F_BK; i += F_THREADS) {
      const int r = i / F_BK, c = i % F_BK;
      const int gm = m0 + r, gk = k0 + c;
      xs[r][c] = (gm < M && gk < K) ? x[(int64_t)gm * K + gk] : 0.f;
    }
    for (int i = tid; i < F_BK * F_BN; i += F_THREADS) {
      const int r = i / F_BN, c = i % F_BN;
      const int gk = k0 + r, gn = n0 + c;
      ws[r][c] = (gk < K && gn < N) ? w.weight(gk, gn) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < F_BK; ++kk) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[ty + 16 * i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float b = ws[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i], b, acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int gn = n0 + tx + 16 * j;
    if (gn >= N) continue;
    const float s = w.out_scale(gn);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gm = m0 + ty + 16 * i;
      if (gm < M)
        y[(int64_t)gm * N + gn] =
            Weights::kScaleOut ? __fmul_rn(acc[i][j], s) : acc[i][j];
    }
  }
}

template <typename Weights>
int launch_fma(const void* x, const Weights& w, void* y, int M, int N, int K,
               cudaStream_t s) {
  dim3 grid((N + F_BN - 1) / F_BN, (M + F_BM - 1) / F_BM);
  fma_kernel<Weights><<<grid, F_THREADS, 0, s>>>((const float*)x, w,
                                                 (float*)y, M, N, K);
  return (int)cudaGetLastError();
}

// ===========================================================================
// bf16 x: the tensor-core template
// ===========================================================================

constexpr int BK = 64;         // K per ring stage: four m16n8k16 steps
constexpr int XROW = BK * 2 + 32;  // bytes per x row of a stage: 160 keeps
                                   // the 8-byte fragment loads conflict-free
constexpr int MAX_SPLIT = 8;   // portable cluster size

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

// d = a (16x16 bf16, row) * b (16x8 bf16, col) + d, f32 sums.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The two decodes, each turning the payload bits of two k rows of one
// column into a bf16 pair (the lower k in the low half).
struct Int4Dec {
  static constexpr int BITS = 4;
  // bf16(128 + q) - bf16(128 + zp): both exact (integers below 256), the
  // difference too; zpp holds bf16(128 + zp) in both halves
  __device__ __forceinline__ static uint32_t pair(uint32_t w0, uint32_t w1,
                                                  int j, uint32_t zpp) {
    const uint32_t lo = (w0 >> (4 * j)) & 0xFu;
    const uint32_t hi = (w1 >> (4 * j)) & 0xFu;
    const uint32_t raw = lo | (hi << 16) | 0x43004300u;
    const __nv_bfloat162 d = __hsub2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw),
        *reinterpret_cast<const __nv_bfloat162*>(&zpp));
    return *reinterpret_cast<const uint32_t*>(&d);
  }
};

struct ApotDec {
  static constexpr int BITS = 8;
  // s*(2^-e1 + 2^-e2) as bf16 bits: the f32 sum is exact and has at most
  // 8 significant bits, so its top half is the bf16 value; 0 for bit 7
  __device__ __forceinline__ static uint32_t value(uint32_t c) {
    const float f = __uint_as_float((127u - ((c >> 3) & 7u)) << 23) +
                    __uint_as_float((127u - (c & 7u)) << 23);
    const uint32_t b = (__float_as_uint(f) >> 16) | ((c & 0x40u) << 9);
    return (c & 0x80u) ? 0u : b;
  }
  __device__ __forceinline__ static uint32_t pair(uint32_t w0, uint32_t w1,
                                                  int j, uint32_t) {
    return value((w0 >> (8 * j)) & 0xFFu) |
           (value((w1 >> (8 * j)) & 0xFFu) << 16);
  }
};

// Tile geometry.  NARROW: the swapped plan, BM tokens (8 or 16) by BN
// columns, one warp per 64 columns.  Otherwise BM rows by BN columns, a
// warp per 16 columns and up to 64 rows: the fewer columns a warp decodes
// and the more rows it multiplies them with, the fewer decode operations
// each MMA costs.
template <int BM, int BN, bool NARROW, int BITS>
struct Tile {
  static constexpr int ROWS = BM;  // x rows (tokens) a stage holds
  static constexpr int WN = NARROW ? 64 : 16;              // warp columns
  static constexpr int WM = NARROW ? BM : BM < 64 ? BM : 64;  // warp rows
  static constexpr int WARPS_N = BN / WN;
  static constexpr int WARPS = WARPS_N * (BM / WM);
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int J = WN / 8;  // columns a lane decodes
  static constexpr int MI = NARROW ? J / 2 : WM / 16;  // m16 fragments
  static constexpr int NI = NARROW ? BM / 8 : J;       // n8 fragments
  static constexpr int STAGES = NARROW ? 4 : 3;
  static constexpr int PB = J * BITS / 8;  // payload bytes a lane reads a row
  static constexpr int BNB = BN * BITS / 8;  // payload bytes a tile row
  static constexpr int PROW = (BNB > 16 ? BNB : 16) + 16;
  static constexpr int XRAW = BM * XROW;
  static constexpr int STAGE = XRAW + BK * PROW;
  static constexpr int RING = STAGES * STAGE;
  // split K parks the f32 partial tile (output orientation) over the ring
  static constexpr int PC = BN + 4;
  static constexpr int PARK = BM * PC * 4;
  static constexpr int SMEM = RING > PARK ? RING : PARK;
  static_assert(BN % WN == 0 && BM % WM == 0, "whole warps");
};

// Issue the copies of one K step (x rows m0.., payload bytes n0b..) into
// ring slot `slot`.  vx / vp: copy width in bytes for x / payload rows
// (0: rows not 4-byte aligned, plain loads instead).
template <typename G>
__device__ __forceinline__ void load_step(
    unsigned char* smem, int slot, const __nv_bfloat16* __restrict__ x,
    const uint8_t* __restrict__ P, int M, int NB, int K, int m0, int n0b,
    int k0, int vx, int vp) {
  const int tid = threadIdx.x;
  unsigned char* xs = smem + slot * G::STAGE;
  unsigned char* ps = xs + G::XRAW;
  constexpr int XB = BK * 2;  // bytes of one x row's step
  if (vx) {
    const int per_row = XB / vx, ex = vx / 2;
    for (int i = tid; i < G::ROWS * per_row; i += G::THREADS) {
      const int r = i / per_row, c = i % per_row;
      const int gm = m0 + r, gk = k0 + c * ex;
      const bool ok = gm < M && gk < K;  // K % ex == 0: all or nothing
      cp_async(xs + r * XROW + c * vx,
               ok ? (const void*)(x + (int64_t)gm * K + gk) : (const void*)x,
               vx, ok);
    }
  } else {
    for (int i = tid; i < G::ROWS * BK; i += G::THREADS) {
      const int r = i / BK, c = i % BK;
      const int gm = m0 + r, gk = k0 + c;
      __nv_bfloat16 v = __float2bfloat16(0.f);
      if (gm < M && gk < K) v = x[(int64_t)gm * K + gk];
      reinterpret_cast<__nv_bfloat16*>(xs + r * XROW)[c] = v;
    }
  }
  if (vp) {
    const int w = vp < G::BNB ? vp : G::BNB;
    const int per_row = G::BNB / w;
    for (int i = tid; i < BK * per_row; i += G::THREADS) {
      const int r = i / per_row, c = i % per_row;
      const int gk = k0 + r, gb = n0b + c * w;
      const bool ok = gk < K && gb < NB;  // NB % w == 0: all or nothing
      cp_async(ps + r * G::PROW + c * w,
               ok ? (const void*)(P + (int64_t)gk * NB + gb) : (const void*)P,
               w, ok);
    }
  } else {
    for (int i = tid; i < BK * G::BNB; i += G::THREADS) {
      const int r = i / G::BNB, c = i % G::BNB;
      const int gk = k0 + r, gb = n0b + c;
      ps[r * G::PROW + c] =
          (gk < K && gb < NB) ? P[(int64_t)gk * NB + gb] : 0;
    }
  }
}

// A lane's PB payload bytes of one row, in one or two 32-bit words.
template <int PB>
__device__ __forceinline__ uint2 load_bytes(const unsigned char* p) {
  if constexpr (PB == 8) return *reinterpret_cast<const uint2*>(p);
  if constexpr (PB == 4)
    return make_uint2(*reinterpret_cast<const uint32_t*>(p), 0u);
  if constexpr (PB == 2)
    return make_uint2(*reinterpret_cast<const uint16_t*>(p), 0u);
  return make_uint2(*p, 0u);
}

// Column j's pair of rows (w0, w1), from the word holding it.
template <typename Dec>
__device__ __forceinline__ uint32_t col_pair(const uint2& w0, const uint2& w1,
                                             int j, uint32_t zpp) {
  constexpr int PER = 32 / Dec::BITS;  // columns per 32-bit word
  return j < PER ? Dec::pair(w0.x, w1.x, j, zpp)
                 : Dec::pair(w0.y, w1.y, j - PER, zpp);
}

// One landed ring stage on the tensor cores: four 16-deep steps.  pcol:
// byte offset of the lane's columns in a payload row; wm0: the warp's
// first row (!NARROW).
template <typename G, bool NARROW, typename Dec>
__device__ __forceinline__ void mma_stage(
    const unsigned char* xs, const unsigned char* ps, int pcol, int wm0,
    int g, int t4, const uint32_t (&zpp)[G::J],
    float (&acc)[G::MI][G::NI][4]) {
#pragma unroll
  for (int s = 0; s < BK / 16; ++s) {
    uint2 w[4];  // payload rows 16s + 4*t4 + 0..3
#pragma unroll
    for (int r = 0; r < 4; ++r)
      w[r] = load_bytes<G::PB>(ps + (16 * s + 4 * t4 + r) * G::PROW + pcol);
    uint32_t lo[G::J], hi[G::J];  // each column's (k, k+1) pairs
#pragma unroll
    for (int j = 0; j < G::J; ++j) {
      lo[j] = col_pair<Dec>(w[0], w[1], j, zpp[j]);
      hi[j] = col_pair<Dec>(w[2], w[3], j, zpp[j]);
    }
    const int xo = 32 * s + 8 * t4;  // byte of physical k 16s + 4*t4
    if constexpr (NARROW) {
      // A = W^T (rows: the lane's columns 2mi, 2mi+1), B = x^T (tokens)
#pragma unroll
      for (int ni = 0; ni < G::NI; ++ni) {
        const uint2 b =
            *reinterpret_cast<const uint2*>(xs + (8 * ni + g) * XROW + xo);
#pragma unroll
        for (int mi = 0; mi < G::MI; ++mi) {
          const uint32_t a[4] = {lo[2 * mi], lo[2 * mi + 1], hi[2 * mi],
                                 hi[2 * mi + 1]};
          mma(acc[mi][ni], a, b.x, b.y);
        }
      }
    } else {
      // A = x (rows wm0 + 16mi + g, + 8), B = W (column j of fragment j)
#pragma unroll
      for (int mi = 0; mi < G::MI; ++mi) {
        const unsigned char* r0 = xs + (wm0 + 16 * mi + g) * XROW + xo;
        const uint2 a01 = *reinterpret_cast<const uint2*>(r0);
        const uint2 a23 = *reinterpret_cast<const uint2*>(r0 + 8 * XROW);
        const uint32_t a[4] = {a01.x, a23.x, a01.y, a23.y};
#pragma unroll
        for (int ni = 0; ni < G::NI; ++ni) mma(acc[mi][ni], a, lo[ni], hi[ni]);
      }
    }
  }
}

// Store `cnt` consecutive outputs of one row from column gn: float4 where
// N allows it, else masked scalars.
template <int CNT>
__device__ __forceinline__ void store_row(float* __restrict__ y, int64_t row,
                                          int gn, int N,
                                          const float (&v)[CNT]) {
  float* dst = y + row * N + gn;
  if (N % 4 == 0 && gn + CNT <= N) {
#pragma unroll
    for (int i = 0; i < CNT; i += 4)
      *reinterpret_cast<float4*>(dst + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < CNT; ++i)
      if (gn + i < N) dst[i] = v[i];
  }
}

template <int BM, int BN, bool NARROW, typename Dec>
__global__ void __launch_bounds__(Tile<BM, BN, NARROW, Dec::BITS>::THREADS)
mma_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ P,
           const float* __restrict__ scale, const float* __restrict__ zp,
           float* __restrict__ y, int M, int N, int K, int vx, int vp) {
  using G = Tile<BM, BN, NARROW, Dec::BITS>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int n0 = blockIdx.x * BN;
  const int m0 = NARROW ? 0 : blockIdx.y * BM;
  const int splits = gridDim.z, split = blockIdx.z;
  const int NB = N * Dec::BITS / 8;  // payload bytes a row
  const int n0b = n0 * Dec::BITS / 8;

  // this split's K steps
  const int steps = (K + BK - 1) / BK;
  const int per = (steps + splits - 1) / splits;
  const int s0 = min(split * per, steps);
  const int ns = min(s0 + per, steps) - s0;

#pragma unroll
  for (int s = 0; s < G::STAGES - 1; ++s) {
    if (s < ns)
      load_step<G>(smem, s, x, P, M, NB, K, m0, n0b, (s0 + s) * BK, vx, vp);
    cp_async_commit();
  }

  // the lane's decode columns: a run of J in its warp's columns
  const int wn0 = (warp % G::WARPS_N) * G::WN;
  const int wm0 = (warp / G::WARPS_N) * G::WM;
  const int dcol = wn0 + G::J * g;
  const int pcol = dcol * Dec::BITS / 8;
  uint32_t zpp[G::J];
#pragma unroll
  for (int j = 0; j < G::J; ++j) {
    zpp[j] = 0u;
    if constexpr (Dec::BITS == 4) {
      const int gn = n0 + dcol + j;
      const __nv_bfloat16 z =
          __float2bfloat16_rn(128.f + (gn < N ? zp[gn] : 0.f));
      const uint32_t zb = *reinterpret_cast<const uint16_t*>(&z);
      zpp[j] = zb | (zb << 16);
    }
  }
  // the lane's output columns: 2J from its warp's 2J*t4 (general), 8 from
  // dcol (narrow); their scales are loaded now, so the latency hides
  constexpr int OC = NARROW ? 8 : 2 * G::J;
  const int ocol = n0 + (NARROW ? dcol : wn0 + OC * t4);
  float sc[OC];
#pragma unroll
  for (int c = 0; c < OC; ++c) sc[c] = ocol + c < N ? scale[ocol + c] : 0.f;

  float acc[G::MI][G::NI][4] = {};
  for (int i = 0; i < ns; ++i) {
    cp_async_wait<G::STAGES - 2>();  // step i landed
    __syncthreads();                 // and step i - 1's slot is free
    const int nxt = i + G::STAGES - 1;
    if (nxt < ns)
      load_step<G>(smem, nxt % G::STAGES, x, P, M, NB, K, m0, n0b,
                   (s0 + nxt) * BK, vx, vp);
    cp_async_commit();
    const unsigned char* xs = smem + (i % G::STAGES) * G::STAGE;
    mma_stage<G, NARROW, Dec>(xs, xs + G::XRAW, pcol, wm0, g, t4, zpp, acc);
  }
  cp_async_wait<0>();

  if (splits == 1) {
    if constexpr (NARROW) {
      // fragment mi: rows g / g+8 <-> columns dcol + 2mi / + 2mi + 1;
      // c0, c1 <-> tokens 8ni + 2t4, + 1
#pragma unroll
      for (int ni = 0; ni < G::NI; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int tok = 8 * ni + 2 * t4 + h;
          if (tok >= M) continue;
          float out[8];
#pragma unroll
          for (int mi = 0; mi < G::MI; ++mi) {
            out[2 * mi] = __fmul_rn(acc[mi][ni][h], sc[2 * mi]);
            out[2 * mi + 1] = __fmul_rn(acc[mi][ni][2 + h], sc[2 * mi + 1]);
          }
          store_row(y, tok, ocol, N, out);
        }
    } else {
      // fragment (mi, ni): c0 / c1 <-> columns 2J*t4 + ni / + J + ni
#pragma unroll
      for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gm = m0 + wm0 + 16 * mi + g + 8 * h;
          if (gm >= M) continue;
          float out[OC];
#pragma unroll
          for (int j = 0; j < G::J; ++j) {
            out[j] = __fmul_rn(acc[mi][j][2 * h], sc[j]);
            out[G::J + j] = __fmul_rn(acc[mi][j][2 * h + 1], sc[G::J + j]);
          }
          store_row(y, gm, ocol, N, out);
        }
    }
    return;
  }

  // split K: park the partial tile in shared memory (over the ring, which
  // the main loop no longer needs), then each block of the cluster adds
  // every block's partial sums for its slice of the tile and writes it
  float* park = reinterpret_cast<float*>(smem);
  __syncthreads();  // this block's MMAs are done with the ring
  if constexpr (NARROW) {
#pragma unroll
    for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < G::NI; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* row = park + (8 * ni + 2 * t4 + h) * G::PC + dcol + 2 * mi;
          row[0] = acc[mi][ni][h];
          row[1] = acc[mi][ni][2 + h];
        }
  } else {
#pragma unroll
    for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* row = park + (wm0 + 16 * mi + g + 8 * h) * G::PC + wn0 +
                     OC * t4;
#pragma unroll
        for (int j = 0; j < G::J; ++j) {
          row[j] = acc[mi][j][2 * h];
          row[G::J + j] = acc[mi][j][2 * h + 1];
        }
      }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  constexpr int E = BM * BN;
  const int chunk = E / splits;  // splits divides E (a power of 2 <= 8)
  const int e0 = (int)cluster.block_rank() * chunk;
  for (int e = e0 + tid; e < e0 + chunk; e += G::THREADS) {
    const int r = e / BN, c = e % BN;
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < MAX_SPLIT; ++q)
      if (q < splits) sum += cluster.map_shared_rank(park, q)[r * G::PC + c];
    const int gm = m0 + r, gn = n0 + c;
    if (gm < M && gn < N) y[(int64_t)gm * N + gn] = __fmul_rn(sum, scale[gn]);
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

template <int BM, int BN, bool NARROW, typename Dec>
int launch_mma(const void* x, const void* P, const float* scale,
               const float* zp, float* y, int M, int N, int K, int splits,
               cudaStream_t s) {
  using G = Tile<BM, BN, NARROW, Dec::BITS>;
  auto kernel = mma_kernel<BM, BN, NARROW, Dec>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + BN - 1) / BN, NARROW ? 1 : (M + BM - 1) / BM,
                     splits);
  cfg.blockDim = dim3(G::THREADS);
  cfg.dynamicSmemBytes = G::SMEM;
  cfg.stream = s;
  cudaLaunchAttribute la[1];
  la[0].id = cudaLaunchAttributeClusterDimension;
  la[0].val.clusterDim.x = 1;
  la[0].val.clusterDim.y = 1;
  la[0].val.clusterDim.z = splits;
  cfg.attrs = la;
  cfg.numAttrs = splits > 1 ? 1 : 0;  // a plain launch needs no cluster
  const int vx = vec_bytes(x, (int64_t)K * 2);
  const int vp = vec_bytes(P, (int64_t)N * Dec::BITS / 8);
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, (const __nv_bfloat16*)x, (const uint8_t*)P, scale, zp, y,
      M, N, K, vx, vp);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// bm x bn: one of the tiles below (the wrapper's int4_matmul.TILES and
// NARROW_TILES); bm <= 16 is the narrow plan (M <= bm tokens).
template <typename Dec>
int dispatch(const void* x, const void* P, const float* scale,
             const float* zp, float* y, int M, int N, int K, int bm, int bn,
             int splits, cudaStream_t s) {
  if (splits < 1 || splits > MAX_SPLIT || (splits & (splits - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  if (bm <= 16 && M > bm) return (int)cudaErrorInvalidValue;
#define WO_TILE(BM_, BN_, NARROW_)                                          \
  if (bm == BM_ && bn == BN_)                                               \
    return launch_mma<BM_, BN_, NARROW_, Dec>(x, P, scale, zp, y, M, N, K,  \
                                              splits, s);
  WO_TILE(128, 16, false) WO_TILE(64, 16, false) WO_TILE(32, 16, false)
  WO_TILE(128, 32, false) WO_TILE(64, 32, false) WO_TILE(32, 32, false)
  WO_TILE(128, 64, false) WO_TILE(64, 64, false) WO_TILE(32, 64, false)
  WO_TILE(8, 64, true) WO_TILE(8, 128, true) WO_TILE(8, 256, true)
  WO_TILE(16, 64, true) WO_TILE(16, 128, true) WO_TILE(16, 256, true)
#undef WO_TILE
  return (int)cudaErrorInvalidValue;
}

// The f32 plan is the one fixed FMA launch shape.
bool fma_plan(int bm, int bn, int splits) {
  return bm == F_BM && bn == F_BN && splits == 1;
}

}  // namespace

// bm x bn, splits: the launch plan (kernels/int4_matmul.launch_plan).
extern "C" int int4_matmul(const void* x, const void* packed,
                           const void* scale, const void* zero_point, void* y,
                           int M, int N, int K, int x_is_bf16, int bm, int bn,
                           int splits, void* stream) {
  if (M == 0 || N == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (!x_is_bf16) {
    if (!fma_plan(bm, bn, splits)) return (int)cudaErrorInvalidValue;
    const Int4Weights w{(const uint8_t*)packed, (const float*)scale,
                        (const float*)zero_point, N};
    return launch_fma(x, w, y, M, N, K, s);
  }
  return dispatch<Int4Dec>(x, packed, (const float*)scale,
                           (const float*)zero_point, (float*)y, M, N, K, bm,
                           bn, splits, s);
}

extern "C" int apot_matmul(const void* x, const void* codes,
                           const void* scale, void* y, int M, int N, int K,
                           int x_is_bf16, int bm, int bn, int splits,
                           void* stream) {
  if (M == 0 || N == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (!x_is_bf16) {
    if (!fma_plan(bm, bn, splits)) return (int)cudaErrorInvalidValue;
    const ApotWeights w{(const uint8_t*)codes, (const float*)scale, N};
    return launch_fma(x, w, y, M, N, K, s);
  }
  return dispatch<ApotDec>(x, codes, (const float*)scale, nullptr, (float*)y,
                           M, N, K, bm, bn, splits, s);
}

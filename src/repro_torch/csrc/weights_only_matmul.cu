// Weights-only matmuls for Hopper (sm_90a): one f32-dot kernel, two weight
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
// Both are f32 dots on float activations.
//
// What bounds them on the H100: the main path's shapes are the weights-only
// recipes' PWConvs (K 16..1024, N 16..1000, M = batch*pixels up to ~10^5).
// Weights (half a byte or one byte each) are small next to x (read once)
// and y (f32, written once); those bytes set the floor.  The operations do
// not: x is bf16 and each decoded weight is a bf16-exact value times a
// per-filter scale ((q - zp) an integer in [-15, 15]; an APoT value has at
// most 7 significant bits), so bf16 tensor cores with f32 accumulation could
// do the work.
//
// Design (simple first, speed later): one 256-thread block per 64x64
// output tile, a loop over K in steps of 32 (the TPU's sequential k grid
// axis).  Each step widens the x tile to f32 in shared memory (exact for
// bf16) and decodes each weight once into its f32 value, equal to the plain
// version's decode: (q - zp) * scale rounded as the plain version rounds
// it, an APoT value as an integer in units of 2^-7 times 2^-7.  Each thread
// accumulates 4x4 outputs with f32 FMAs in ascending k; the APoT
// per-filter scale multiplies once in the epilogue, as in the TPU kernel.
// The plain version's f32 matmul sums in another order, so the two agree
// to the f32 summation bound K * 2^-23 * (|x| @ |W|), not bit for bit.
// Ragged edges (K = 16 at stage 0, N = 1000 = 500 int4 payload bytes a row
// at the head) are masked in the loads and the store, never padded, so no
// APoT code is padded either (a 0x00 pad byte would decode to 2).  Launches
// on the caller's stream, allocates nothing, and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

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

template <typename T, typename Weights>
__global__ void __launch_bounds__(THREADS)
wo_kernel(const T* __restrict__ x, const Weights w, float* __restrict__ y,
          int M, int N, int K) {
  __shared__ float xs[BM][BK + 1];
  __shared__ float ws[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output columns tx + 16*j
  const int ty = tid / 16;  // output rows    ty + 16*i
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      const int gm = m0 + r, gk = k0 + c;
      xs[r][c] = (gm < M && gk < K) ? to_f32(x[(int64_t)gm * K + gk]) : 0.f;
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      const int gk = k0 + r, gn = n0 + c;
      ws[r][c] = (gk < K && gn < N) ? w.weight(gk, gn) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
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
int launch(const void* x, const Weights& w, void* y, int M, int N, int K,
           int x_is_bf16, void* stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = (cudaStream_t)stream;
  if (x_is_bf16) {
    wo_kernel<__nv_bfloat16, Weights><<<grid, THREADS, 0, s>>>(
        (const __nv_bfloat16*)x, w, (float*)y, M, N, K);
  } else {
    wo_kernel<float, Weights><<<grid, THREADS, 0, s>>>(
        (const float*)x, w, (float*)y, M, N, K);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int int4_matmul(const void* x, const void* packed,
                           const void* scale, const void* zero_point, void* y,
                           int M, int N, int K, int x_is_bf16, void* stream) {
  const Int4Weights w{(const uint8_t*)packed, (const float*)scale,
                      (const float*)zero_point, N};
  return launch(x, w, y, M, N, K, x_is_bf16, stream);
}

extern "C" int apot_matmul(const void* x, const void* codes,
                           const void* scale, void* y, int M, int N, int K,
                           int x_is_bf16, void* stream) {
  const ApotWeights w{(const uint8_t*)codes, (const float*)scale, N};
  return launch(x, w, y, M, N, K, x_is_bf16, stream);
}

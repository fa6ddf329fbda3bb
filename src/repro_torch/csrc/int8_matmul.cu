// W8A8 uniform integer matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/int8_matmul.py::int8_matmul (body
// _kernel): y = ((xq@Wq)_i32 - rowsum(xq)*zp) * (sa*scale),
// xq = clip(rne(x/sa), +-127), Wq the offset-folded int8 payload.
//
// What bounds it on the H100: the main path's shapes are the uniform8
// recipe's PWConvs (K 16..1024, N 16..1000, M = batch*pixels up to ~10^5)
// and the im2col'd stem (M = 100352, K = 27, N = 16).  Their operational
// intensity is low (a few int8 ops per byte of x read and f32 y written),
// so the bytes of x and y set the floor, not the int8 tensor-core rate.
//
// Design (simple first, speed later): one 256-thread block per 64x64
// output tile; a loop over K in steps of 32 replaces the TPU's sequential
// k grid axis and its VMEM accumulators.  Each step quantizes the x tile
// in the prologue (IEEE division, round half to even -- the rounding of
// the plain version) into shared memory and loads the payload tile once.
// Each thread accumulates 4x4 outputs in int32 plus its rows' int32 sums:
// every product and sum is exact and order-free, so the result is
// bit-identical to the plain version.  Ragged edges (K = 27 at the stem,
// K = 16 at stage 0, N = 1000 at the head) are masked in the loads and the
// store instead of padded.  The epilogue uses explicitly rounded
// operations so nvcc cannot contract acc - xsum*zp into an FMA that the
// plain version does not do.  Launches on the caller's stream, allocates
// nothing, and returns cudaGetLastError().
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
int8_kernel(const T* __restrict__ x, const float* __restrict__ sa_ptr,
            const int8_t* __restrict__ W, const float* __restrict__ scale,
            const float* __restrict__ zp, float* __restrict__ y, int M, int N,
            int K) {
  __shared__ int xs[BM][BK + 1];
  __shared__ int ws[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output columns tx + 16*j
  const int ty = tid / 16;  // output rows    ty + 16*i
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const float sa = *sa_ptr;

  int acc[4][4] = {};
  int xsum[4] = {};

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      const int gm = m0 + r, gk = k0 + c;
      int q = 0;
      if (gm < M && gk < K) {
        // rne and clip in one: the conversion rounds half to even,
        // saturates and sends NaN to 0 (cvt.rni.s32.f32), as the plain
        // version's (and XLA's) float -> int8 cast does
        const float v = __fdiv_rn(to_f32(x[(int64_t)gm * K + gk]), sa);
        q = max(-127, min(127, __float2int_rn(v)));
      }
      xs[r][c] = q;
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      const int gk = k0 + r, gn = n0 + c;
      ws[r][c] = (gk < K && gn < N) ? (int)W[(int64_t)gk * N + gn] : 0;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      int a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = xs[ty + 16 * i][kk];
        xsum[i] += a[i];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int b = ws[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += a[i] * b;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int gn = n0 + tx + 16 * j;
    if (gn >= N) continue;
    const float s = __fmul_rn(sa, scale[gn]), z = zp[gn];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gm = m0 + ty + 16 * i;
      if (gm >= M) continue;
      const float corr = __fmul_rn((float)xsum[i], z);
      y[(int64_t)gm * N + gn] = __fmul_rn(__fsub_rn((float)acc[i][j], corr), s);
    }
  }
}

}  // namespace

extern "C" int int8_matmul(const void* x, const void* wq,
                           const void* act_scale, const void* scale,
                           const void* zero_point, void* y, int M, int N,
                           int K, int x_is_bf16, void* stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = (cudaStream_t)stream;
  const float* sa = (const float*)act_scale;
  const int8_t* W = (const int8_t*)wq;
  if (x_is_bf16) {
    int8_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        (const __nv_bfloat16*)x, sa, W, (const float*)scale,
        (const float*)zero_point, (float*)y, M, N, K);
  } else {
    int8_kernel<float><<<grid, THREADS, 0, s>>>(
        (const float*)x, sa, W, (const float*)scale, (const float*)zero_point,
        (float*)y, M, N, K);
  }
  return (int)cudaGetLastError();
}

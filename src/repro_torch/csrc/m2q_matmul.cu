// Fused two-level mixed-quantization matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/m2q_matmul.py::m2q_matmul (body
// _kernel): y = [((xq@P)_i32 - rowsum(xq)*u_zp)*u_scale
//                + (xq@apot(P))*a_scale] * sa,  xq = clip(rne(x/sa), +-127).
//
// What bounds it on the H100: at the main path's shapes (K 16..1024, N
// 16..1024, M = batch*pixels up to ~10^5) most layers are narrow, so the
// bytes of x (read once) and y (f32, written once) set the floor; only the
// wide late-stage layers approach the tensor-core ridge.
//
// Design (simple first, speed later): one 256-thread block per 64x64
// output tile; a loop over K in steps of 32 replaces the TPU's sequential
// k grid axis and its VMEM accumulators.  Each step quantizes the x tile
// in the prologue (IEEE division, round half to even -- the same rounding
// as the plain version) into shared memory, loads the payload tile once,
// and decodes the APoT view of each byte once into shared memory as an
// integer in units of 2^-7 (s*(2^(7-e1)+2^(7-e2)), 0 if bit7 is set).
// Each thread accumulates 4x4 outputs in int32 for both engines plus its
// rows' int32 sums: every product and sum is exact and order-free, so the
// result is bit-identical to the plain version.  Ragged edges (K = 16 at
// stage 0, N = 1000 at the head) are masked in the loads and the store
// instead of padded.  The epilogue uses explicitly rounded operations so
// nvcc cannot contract it into FMAs that the plain version does not do.
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError().
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

__device__ __forceinline__ int apot_units(uint8_t c) {
  if (c & 0x80) return 0;
  int mag = (1 << (7 - ((c >> 3) & 7))) + (1 << (7 - (c & 7)));
  return (c & 0x40) ? -mag : mag;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
m2q_kernel(const T* __restrict__ x, const float* __restrict__ sa_ptr,
           const int8_t* __restrict__ P, const float* __restrict__ u_scale,
           const float* __restrict__ u_zp, const float* __restrict__ a_scale,
           float* __restrict__ y, int M, int N, int K) {
  __shared__ int xs[BM][BK + 1];
  __shared__ int pu[BK][BN];
  __shared__ int pa[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output columns tx + 16*j
  const int ty = tid / 16;  // output rows    ty + 16*i
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const float sa = *sa_ptr;

  int uacc[4][4] = {};
  int aacc[4][4] = {};
  int xsum[4] = {};

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      const int gm = m0 + r, gk = k0 + c;
      int q = 0;
      if (gm < M && gk < K) {
        float v = rintf(__fdiv_rn(to_f32(x[(int64_t)gm * K + gk]), sa));
        v = fminf(fmaxf(v, -127.f), 127.f);
        q = (int)v;
      }
      xs[r][c] = q;
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      const int gk = k0 + r, gn = n0 + c;
      int8_t b = 0;
      if (gk < K && gn < N) b = P[(int64_t)gk * N + gn];
      pu[r][c] = (int)b;
      pa[r][c] = apot_units((uint8_t)b);
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
        const int bu = pu[kk][tx + 16 * j];
        const int ba = pa[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          uacc[i][j] += a[i] * bu;
          aacc[i][j] += a[i] * ba;
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int gn = n0 + tx + 16 * j;
    if (gn >= N) continue;
    const float us = u_scale[gn], uz = u_zp[gn], as = a_scale[gn];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gm = m0 + ty + 16 * i;
      if (gm >= M) continue;
      const float corr = __fmul_rn((float)xsum[i], uz);
      const float yu = __fmul_rn(__fsub_rn((float)uacc[i][j], corr), us);
      const float ya = __fmul_rn(__fmul_rn((float)aacc[i][j], 0.0078125f), as);
      y[(int64_t)gm * N + gn] = __fmul_rn(__fadd_rn(yu, ya), sa);
    }
  }
}

}  // namespace

extern "C" int m2q_matmul(const void* x, const void* act_scale,
                          const void* payload, const void* u_scale,
                          const void* u_zp, const void* a_scale, void* y,
                          int M, int N, int K, int x_is_bf16, void* stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = (cudaStream_t)stream;
  const float* sa = (const float*)act_scale;
  const int8_t* P = (const int8_t*)payload;
  if (x_is_bf16) {
    m2q_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        (const __nv_bfloat16*)x, sa, P, (const float*)u_scale,
        (const float*)u_zp, (const float*)a_scale, (float*)y, M, N, K);
  } else {
    m2q_kernel<float><<<grid, THREADS, 0, s>>>(
        (const float*)x, sa, P, (const float*)u_scale, (const float*)u_zp,
        (const float*)a_scale, (float*)y, M, N, K);
  }
  return (int)cudaGetLastError();
}

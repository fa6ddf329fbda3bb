// Int8 ReLU linear attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/relu_attn.py::relu_attn (body
// _kernel): per (batch, head), q8/k8 = quant(relu(.)), v8 = quant(v);
// int32 kv = k8^T v8 (D x D) and ksum; kv requantized to int8 with
// skv = max(max|kv*sk*sv| / 127, 1e-8); num = q8 @ kv8, den = q8 . ksum;
// out = num*sq*skv / (den*sq*sk + eps).
//
// What bounds it on the H100: memory.  The work is ~4*N*D*D integer MACs
// per (b, h) against 3*N*D inputs and N*D f32 outputs -- with D = 16 that
// is well under the card's ops-per-byte ridge, so reading q/k/v once and
// writing out once is the floor.
//
// Design (simple first): one 256-thread block per (b, h); q/k/v are read
// in place through their batch/token strides (the MSA hands strided slices
// of one qkv tensor, so no copy is made).  Pass 1 streams k and v in
// chunks of 64 tokens, quantizing them into shared memory; each thread
// owns fixed (d, e) entries of kv (and, for threads < D, one ksum entry)
// and loops over the tokens, so no atomics are needed.  A block reduction
// gives skv; kv_f = float(kv32) * (sk*sv) and kv8 = clamp(rint(kv_f/skv))
// are formed in that operation order.  Pass 2 streams q in chunks and
// forms the integer num/den dot products per (token, e), then the epilogue
// of the TPU kernel.  All integer sums are exact; the float steps use
// explicitly rounded operations (IEEE division, no FMA contraction), so
// the result is bit-identical to the plain version.  D <= 64 (the wrapper
// raises above that).  NaN behaves as in the reference: ReLU and the kv
// max propagate it, the int8 quantizer sends it to 0.  Launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAXD = 64;
constexpr int CH = 64;                            // tokens per chunk
constexpr int SLOTS = MAXD * MAXD / THREADS;      // kv entries per thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// rne(v) clipped to +-127, as an int.  The conversion rounds half to
// even, saturates and sends NaN to 0 (cvt.rni.s32.f32), as the plain
// version's (and XLA's) float -> int8 cast does; an fminf/fmaxf clip in
// float would send NaN to -127.
__device__ __forceinline__ int clip127(float v) {
  return max(-127, min(127, __float2int_rn(v)));
}

__device__ __forceinline__ int8_t quant(float x, float s) {
  return (int8_t)clip127(__fdiv_rn(x, s));
}

// ReLU that keeps NaN, as jnp.maximum and torch.relu do
__device__ __forceinline__ float relu(float x) { return x < 0.f ? 0.f : x; }

// max that propagates NaN, as jnp.max and torch.amax do
__device__ __forceinline__ float nanmax(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmaxf(a, b);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
relu_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, int64_t qsb, int64_t qsn,
                 int64_t ksb, int64_t ksn, int64_t vsb, int64_t vsn,
                 const float* __restrict__ sq_p, const float* __restrict__ sk_p,
                 const float* __restrict__ sv_p, float* __restrict__ out,
                 int N, int H, int D, float eps) {
  __shared__ int8_t a8[CH][MAXD];  // k chunk in pass 1, q chunk in pass 2
  __shared__ int8_t b8[CH][MAXD];  // v chunk
  __shared__ int kv8[MAXD * MAXD];
  __shared__ int ksum[MAXD];
  __shared__ float red[THREADS];

  const int tid = threadIdx.x;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const float sq = *sq_p, sk = *sk_p, sv = *sv_p;
  const T* qb = q + b * qsb + (int64_t)h * D;
  const T* kb = k + b * ksb + (int64_t)h * D;
  const T* vb = v + b * vsb + (int64_t)h * D;
  const int DD = D * D;

  // ---- pass 1: int32 kv = k8^T v8 and ksum --------------------------------
  int acc[SLOTS];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) acc[s] = 0;
  int ks = 0;
  for (int n0 = 0; n0 < N; n0 += CH) {
    const int rows = min(CH, N - n0);
    for (int i = tid; i < rows * D; i += THREADS) {
      const int r = i / D, d = i % D;
      const int64_t n = n0 + r;
      a8[r][d] = quant(relu(to_f32(kb[n * ksn + d])), sk);
      b8[r][d] = quant(to_f32(vb[n * vsn + d]), sv);
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const int e_idx = tid + s * THREADS;
      if (e_idx < DD) {
        const int d = e_idx / D, e = e_idx % D;
        int a = acc[s];
        for (int r = 0; r < rows; ++r) a += (int)a8[r][d] * (int)b8[r][e];
        acc[s] = a;
      }
    }
    if (tid < D)
      for (int r = 0; r < rows; ++r) ks += (int)a8[r][tid];
    __syncthreads();
  }

  // ---- requantize kv to int8 with a block-wide max ------------------------
  const float sksv = __fmul_rn(sk, sv);
  float m = 0.f;
#pragma unroll
  for (int s = 0; s < SLOTS; ++s)
    if (tid + s * THREADS < DD)
      m = nanmax(m, fabsf(__fmul_rn((float)acc[s], sksv)));
  red[tid] = m;
  __syncthreads();
  for (int w = THREADS / 2; w > 0; w >>= 1) {
    if (tid < w) red[tid] = nanmax(red[tid], red[tid + w]);
    __syncthreads();
  }
  const float skv = nanmax(__fdiv_rn(red[0], 127.f), 1e-8f);
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int e_idx = tid + s * THREADS;
    if (e_idx < DD) {
      kv8[e_idx] = clip127(__fdiv_rn(__fmul_rn((float)acc[s], sksv), skv));
    }
  }
  if (tid < D) ksum[tid] = ks;
  __syncthreads();

  // ---- pass 2: integer num/den per token, then the epilogue ---------------
  const float num_scale = __fmul_rn(sq, skv);
  const float den_scale = __fmul_rn(sq, sk);
  for (int n0 = 0; n0 < N; n0 += CH) {
    const int rows = min(CH, N - n0);
    for (int i = tid; i < rows * D; i += THREADS) {
      const int r = i / D, d = i % D;
      a8[r][d] = quant(relu(to_f32(qb[(int64_t)(n0 + r) * qsn + d])), sq);
    }
    __syncthreads();
    for (int i = tid; i < rows * D; i += THREADS) {
      const int r = i / D, e = i % D;
      int num = 0, den = 0;
      for (int d = 0; d < D; ++d) {
        const int qv = (int)a8[r][d];
        num += qv * kv8[d * D + e];
        den += qv * ksum[d];
      }
      const float nf = __fmul_rn((float)num, num_scale);
      const float df = __fadd_rn(__fmul_rn((float)den, den_scale), eps);
      out[(((int64_t)b * N + n0 + r) * H + h) * D + e] = __fdiv_rn(nf, df);
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int relu_attn(const void* q, const void* k, const void* v,
                         int64_t qsb, int64_t qsn, int64_t ksb, int64_t ksn,
                         int64_t vsb, int64_t vsn, const void* sq,
                         const void* sk, const void* sv, void* out, int B,
                         int N, int H, int D, float eps, int x_is_bf16,
                         void* stream) {
  if (D > MAXD) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned blocks = (unsigned)(B * H);
  if (x_is_bf16) {
    relu_attn_kernel<__nv_bfloat16><<<blocks, THREADS, 0, s>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, qsb, qsn, ksb, ksn, vsb, vsn,
        (const float*)sq, (const float*)sk, (const float*)sv, (float*)out, N,
        H, D, eps);
  } else {
    relu_attn_kernel<float><<<blocks, THREADS, 0, s>>>(
        (const float*)q, (const float*)k, (const float*)v, qsb, qsn, ksb, ksn,
        vsb, vsn, (const float*)sq, (const float*)sk, (const float*)sv,
        (float*)out, N, H, D, eps);
  }
  return (int)cudaGetLastError();
}

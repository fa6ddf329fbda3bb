// GQA decode attention over the int8 KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/decode_attn_int8.py::decode_attn_int8
// (body _kernel): per (batch, kv-head) and query g of the group,
//   q_s = max|q|/127 + 1e-9,  q8 = clip(rint(q/q_s), +-127);
//   s_t = ((float(q8 . k8_t) * q_s) * scale) * k_scale_t on valid rows
//         (t < length, and t >= length - window when windowed), -1e30 else;
//   p = softmax(s) in f32;  pv_t = p_t * v_scale_t;
//   p_s = max|pv|/127 + 1e-12,  p8 = clip(rint(pv/p_s), +-127);
//   out = float(sum_t p8_t * v8_t) * p_s.
//
// What bounds it on the H100: memory.  One decode token does ~4*G*T*D
// integer MACs against T*D bytes of k and of v plus 8*T bytes of row scales
// per (b, h), far below the card's ops-per-byte ridge: reading the cache
// rows once is the floor.
//
// Design (simple first): one 256-thread block per (b, kv-head).  Each warp
// quantizes q rows into shared memory.  One thread per cache row forms the
// int32 dot with __dp4a from a 16-byte-vector load of the row; the G x T f32
// scores live in dynamic shared memory (the host side raises when G*T does
// not fit).  Block reductions give the row max, the exp sum and max|pv|;
// p8 lands in shared memory as int8, and the int32 PV sums are split over
// the threads by (g, d) and, when G*D < 256, by slices of rows, then added
// in shared memory -- integer sums, so their order changes nothing.  Rows
// outside [lo, hi) carry p = 0 exactly whenever one row is valid, so the
// score and PV loops skip them; a length-0 row (every position masked)
// gets the uniform softmax over all T rows that the plain version gives.
// Float steps use explicitly rounded operations (IEEE division, no FMA
// contraction) in the plain version's order; maxima propagate NaN as
// torch.amax does.  The exp and the sum order can still move p by an ulp
// and flip one p8 code, so the result agrees with the plain version to
// 2 * p_s * max|v8| per output row, not bit for bit.  Launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAXD = 128;
constexpr float NEG_INF = -1.0e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// max that propagates NaN, as torch.amax and jnp.max do
__device__ __forceinline__ float nanmax(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmaxf(a, b);
}

// clip(rne(x / s), +-127) as int8.  The conversion rounds half to even,
// saturates and sends NaN to 0 (cvt.rni.s32.f32), as the plain version's
// (and XLA's) float -> int8 cast does; an fminf/fmaxf clip in float would
// send NaN to -127.
__device__ __forceinline__ int8_t quant8(float x, float s) {
  return (int8_t)max(-127, min(127, __float2int_rn(__fdiv_rn(x, s))));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = nanmax(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

// block-wide max (is_max) or sum of v; every thread gets the result
__device__ float block_reduce(float v, bool is_max, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = is_max ? warp_max(v) : warp_sum(v);
  __syncthreads();  // red may still be read by a previous reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < WARPS; ++w)
    r = is_max ? nanmax(r, red[w]) : __fadd_rn(r, red[w]);
  return r;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_attn_int8_kernel(const T* __restrict__ q, const int8_t* __restrict__ k,
                        const int8_t* __restrict__ v,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const int* __restrict__ lengths,
                        float* __restrict__ out, int Tn, int H, int G, int D,
                        float scale, int window) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[WARPS];
  const int GD = G * D;
  const int PART = GD > THREADS ? GD : THREADS;
  float* s = reinterpret_cast<float*>(smem);         // [G][T] scores -> e
  float* qs = s + (size_t)G * Tn;                    // [G] q scales
  float* ps = qs + G;                                // [G] p scales
  int* part = reinterpret_cast<int*>(ps + G);        // [PART] PV partials
  int8_t* q8 = reinterpret_cast<int8_t*>(part + PART);  // [G][D]
  int8_t* p8 = q8 + GD;                              // [G][T]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int length = lengths[b];
  // rows that can be valid; an empty range means every row is masked
  int lo = window >= 0 ? max(0, length - window) : 0;
  int hi = min(length, Tn);
  const bool all_masked = lo >= hi;
  if (all_masked) { lo = 0; hi = Tn; }
  const int64_t row_stride = (int64_t)H * D;  // bytes between cache rows
  const int8_t* kb = k + (int64_t)b * Tn * row_stride + (int64_t)h * D;
  const int8_t* vb = v + (int64_t)b * Tn * row_stride + (int64_t)h * D;
  const float* ksb = k_scale + (int64_t)b * Tn * H + h;
  const float* vsb = v_scale + (int64_t)b * Tn * H + h;

  // ---- q rows -> q8 and q_s, one warp per row of the group ---------------
  for (int g = warp; g < G; g += WARPS) {
    const T* qg = q + ((int64_t)(b * H + h) * G + g) * D;
    float m = 0.f;
    for (int d = lane; d < D; d += 32) m = nanmax(m, fabsf(to_f32(qg[d])));
    m = warp_max(m);
    const float sc = __fadd_rn(__fdiv_rn(m, 127.f), 1e-9f);
    if (lane == 0) qs[g] = sc;
    for (int d = lane; d < D; d += 32) q8[g * D + d] = quant8(to_f32(qg[d]), sc);
  }
  __syncthreads();

  // ---- scores: one thread per cache row, int32 dot by __dp4a -------------
  const int nw = D / 4;  // 32-bit words per row
  for (int t = tid; t < Tn; t += THREADS) {
    if (all_masked || t < lo || t >= hi) {
      for (int g = 0; g < G; ++g) s[g * Tn + t] = NEG_INF;
      continue;
    }
    int kw[MAXD / 4];
    const int4* krow = reinterpret_cast<const int4*>(kb + t * row_stride);
#pragma unroll
    for (int i = 0; i < MAXD / 16; ++i) {
      if (i < D / 16) {
        const int4 w4 = krow[i];
        kw[4 * i] = w4.x; kw[4 * i + 1] = w4.y;
        kw[4 * i + 2] = w4.z; kw[4 * i + 3] = w4.w;
      }
    }
    const float ks = ksb[(int64_t)t * H];
    for (int g = 0; g < G; ++g) {
      const int* qw = reinterpret_cast<const int*>(q8 + g * D);
      int acc = 0;
#pragma unroll
      for (int i = 0; i < MAXD / 4; ++i)
        if (i < nw) acc = __dp4a(kw[i], qw[i], acc);
      const float sc = __fmul_rn(__fmul_rn((float)acc, qs[g]), scale);
      s[g * Tn + t] = __fmul_rn(sc, ks);
    }
  }
  __syncthreads();

  // ---- softmax, p * v_scale, requantization to p8 (one row g at a time) --
  for (int g = 0; g < G; ++g) {
    float* sg = s + g * Tn;
    float m = NEG_INF;
    for (int t = tid; t < Tn; t += THREADS) m = nanmax(m, sg[t]);
    m = block_reduce(m, true, red);
    float sum = 0.f;
    for (int t = tid; t < Tn; t += THREADS) {
      const float e = expf(__fsub_rn(sg[t], m));
      sg[t] = e;
      sum = __fadd_rn(sum, e);
    }
    sum = block_reduce(sum, false, red);
    float pmax = 0.f;
    for (int t = tid; t < Tn; t += THREADS) {
      const float pv = __fmul_rn(__fdiv_rn(sg[t], sum), vsb[(int64_t)t * H]);
      sg[t] = pv;
      pmax = nanmax(pmax, fabsf(pv));
    }
    pmax = block_reduce(pmax, true, red);
    const float psc = __fadd_rn(__fdiv_rn(pmax, 127.f), 1e-12f);
    if (tid == 0) ps[g] = psc;
    for (int t = tid; t < Tn; t += THREADS) p8[g * Tn + t] = quant8(sg[t], psc);
  }
  __syncthreads();

  // ---- int32 PV: threads split over (g, d) and, if idle, over rows -------
  const int nsplit = GD < THREADS ? THREADS / GD : 1;
  for (int j = tid; j < GD * nsplit; j += THREADS) {
    const int pair = j % GD, split = j / GD;
    const int g = pair / D, d = pair % D;
    const int8_t* pg = p8 + g * Tn;
    int acc = 0;
    for (int t = lo + split; t < hi; t += nsplit)
      acc += (int)pg[t] * (int)vb[t * row_stride + d];
    part[split * GD + pair] = acc;
  }
  __syncthreads();
  for (int pair = tid; pair < GD; pair += THREADS) {
    int acc = 0;
    for (int split = 0; split < nsplit; ++split) acc += part[split * GD + pair];
    const int g = pair / D;
    out[(int64_t)(b * H + h) * GD + pair] = __fmul_rn((float)acc, ps[g]);
  }
}

// Dynamic shared memory one block needs (the wrapper checks it against the
// card's limit before launching).
size_t smem_bytes(int Tn, int G, int D) {
  const size_t GD = (size_t)G * D;
  const size_t part = GD > (size_t)THREADS ? GD : (size_t)THREADS;
  return (size_t)G * Tn * 4 + 2 * (size_t)G * 4 + part * 4 + GD
         + (size_t)G * Tn;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* k_scale,
           const void* v_scale, const void* lengths, void* out, int B, int Tn,
           int H, int G, int D, float scale, int window, cudaStream_t stream) {
  const size_t smem = smem_bytes(Tn, G, D);
  cudaError_t err = cudaFuncSetAttribute(
      decode_attn_int8_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_attn_int8_kernel<T><<<(unsigned)(B * H), THREADS, smem, stream>>>(
      (const T*)q, (const int8_t*)k, (const int8_t*)v, (const float*)k_scale,
      (const float*)v_scale, (const int*)lengths, (float*)out, Tn, H, G, D,
      scale, window);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int decode_attn_int8(const void* q, const void* k, const void* v,
                                const void* k_scale, const void* v_scale,
                                const void* lengths, void* out, int B, int Tn,
                                int H, int G, int D, float scale, int window,
                                int q_is_bf16, void* stream) {
  if (D % 16 != 0 || D > MAXD || G < 1 || Tn < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (q_is_bf16)
    return launch<__nv_bfloat16>(q, k, v, k_scale, v_scale, lengths, out, B,
                                 Tn, H, G, D, scale, window, s);
  return launch<float>(q, k, v, k_scale, v_scale, lengths, out, B, Tn, H, G,
                       D, scale, window, s);
}

// Int8 ReLU linear attention for Hopper (sm_90a), and the three
// tensor-wide activation scales it reads.
//
// relu_attn replaces the TPU kernel repro/kernels/relu_attn.py::relu_attn
// (body _kernel): per (batch, head), q8/k8 = quant(relu(.)), v8 = quant(v);
// int32 kv = k8^T v8 (D x D) and ksum; kv requantized to int8 with
// skv = max(max|kv*sk*sv| / 127, 1e-8); num = q8 @ kv8, den = q8 . ksum;
// out = num*sq*skv / (den*sq*sk + eps).
//
// relu_attn_scales is the counterpart of the three scalar reductions the
// JAX graph computes ahead of that kernel (repro/kernels/ops.py::
// _relu_attn_core, fused there by XLA): sq = max(max(max q, 0)/127, 1e-8),
// sk likewise over k, sv = max(max|v|/127, 1e-8), over the whole batch.
//
// What bounds both on the H100: memory, in principle -- ~4*N*D*D integer
// MACs per (b, h) against 3*N*D inputs and N*D outputs is far below the
// card's ops-per-byte ridge.  In practice, at the model's shapes (a few
// hundred KB a call), latency: the first loads' round trip, then a chain
// of short phases, each a few dependent instructions per thread and a
// barrier.  So the design gives every thread about one item per phase
// and keeps the phases few.
//
// relu_attn: a cluster of `splits` CTAs per (batch, head), 512 threads a
// CTA; each CTA takes one slice of the tokens (up to CH_MAX at once; a
// longer slice is walked in chunks, q then requantized chunk by chunk).
// Loads are 16 bytes where rows allow (a head's D elements of a token are
// contiguous), one load of one tensor an item.  k and v are quantized
// into shared memory transposed (tokens contiguous, zero-padded to a
// multiple of 16), q as rows; the quantizer is m2q_matmul.cu's reciprocal
// one with the rounding done by a magic-number add instead of the
// conversion unit.  The partial int32 kv = k8^T v8 and ksum come from
// dp4a over 16-byte shared loads.  With splits > 1 each CTA pushes its
// partials into a slot of every peer's shared memory (remote stores do
// not stall) and one cluster barrier makes them visible; int32 sums are
// exact, so every CTA holds the same kv.  Each warp takes the maximum of
// its 32 entries and the head's maximum is that of the warps' maxima,
// compared as the bits of |x|: |x| and NaN order as unsigned ints, so
// NaN propagates.  kv8 repeats the plain version's rounded steps in its
// order (RN(kv * RN(sk*sv)), RN(max / 127) floored at 1e-8,
// clip(rne(RN(kv_f / skv)))); pass 2 forms num = q8 . kv8 with dp4a and
// den = q8 . ksum with dp4a on ksum's three bytes (ksum <= 127 N <
// 2^24), then the epilogue RN(RN(num * RN(sq*skv)) / RN(RN(den *
// RN(sq*sk)) + eps)), stored in the caller's dtype (bf16 rounded half to
// even, as torch's cast).  The output is bit-identical to the plain
// version.  D <= 64, N < 2^24 / 127.
//
// relu_attn_scales: one cluster of `ctas` CTAs (up to 16) of 512 threads
// reads q, k and v once with 16-byte loads, keeps the three maxima per thread (max.NaN:
// NaN propagates, as torch.max does), reduces them per warp and per CTA,
// and CTA 0 reduces the cluster's through distributed shared memory and
// writes (sq, sk, sv).  One launch: no second "finish" kernel, no ticket
// to reset, no workspace; the maxima are combined in one fixed order, so
// every run gives the same result, and it is capturable in a CUDA graph.
//
// Both launch on the caller's stream, allocate nothing, and return
// cudaGetLastError().
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAXD = 64;
constexpr int MAX_SPLIT = 8;        // CTAs of one relu_attn cluster
constexpr int NT = 512;             // threads of a relu_attn CTA
constexpr int MAX_N = (1 << 24) / 127;  // ksum < 2^24: three bytes
constexpr int CH_MAX = 256;         // tokens a CTA holds at once, at most
constexpr int E2 = 4;               // outputs one pass-2 item stores
constexpr int SMEM_MAX = 232448;    // the H100's shared memory a block
constexpr int SCALE_NT = 512;       // threads of a relu_attn_scales CTA
constexpr int SCALE_WARPS = SCALE_NT / 32;
constexpr int MAX_SCALE_CTAS = 16;  // a non-portable cluster size

template <typename T>
constexpr int VEC = 16 / (int)sizeof(T);  // elements of a 16-byte load

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void unpack(const uint4& u, float (&x)[4]) {
  x[0] = __uint_as_float(u.x);
  x[1] = __uint_as_float(u.y);
  x[2] = __uint_as_float(u.z);
  x[3] = __uint_as_float(u.w);
}

// eight bf16 (lower address in the lower half of each word) -> f32, exact
__device__ __forceinline__ void unpack(const uint4& u, float (&x)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T, int V>
__device__ __forceinline__ void load(const T* __restrict__ p, float (&x)[V]) {
  if constexpr (V == 1) {
    x[0] = to_f32(*p);
  } else {
    unpack(*reinterpret_cast<const uint4*>(p), x);
  }
}

// rne(v) clipped to +-127, as an int.  The conversion rounds half to
// even, saturates and sends NaN to 0 (cvt.rni.s32.f32), as the plain
// version's (and XLA's) float -> int8 cast does.
__device__ __forceinline__ int clip127(float v) {
  return max(-127, min(127, __float2int_rn(v)));
}

// clip(rint(v / s), +-127) for V values, bit for bit as the plain
// version rounds it (IEEE quotient, round half to even) -- m2q_matmul.cu's
// reciprocal quantizer.  With r = RN(1/s) and t = RN(v*r), t differs from
// RN(v/s) by at most 3*2^-24*|v/s|, under 2^-15 where |v/s| < 129, so
// rint(t) is the answer unless t lies within 2^-12 of a half-integer; at
// or beyond 128 both clip to +-127.  Only such a near-tie, or a scale
// outside the normal range (NaN included), takes __fdiv_rn, a call with
// a slow-path branch; NaN and infinities take the same clip either way.
struct Quantizer {
  float s, r;  // the scale and RN(1 / scale)
  bool fast;   // the scale is in the range the argument above needs
};

__device__ __forceinline__ Quantizer make_quantizer(float s) {
  const float a = fabsf(s);
  return {s, __frcp_rn(s), a >= 0x1p-125f && a <= 0x1p125f};
}

// rint and the int conversion without the conversion unit (a quarter of
// the FP32 rate): t clamped to +-128, plus 1.5 * 2^23, rounds to the
// nearest even integer in the FADD, whose bits are 0x4B400000 + rint(t);
// NaN goes to 0, as the conversion sends it.
template <int V>
__device__ __forceinline__ void quantize(const Quantizer& qz,
                                         const float (&v)[V], int (&q)[V]) {
  bool near = !qz.fast;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const float t = __fmul_rn(v[e], qz.r);
    const float m = __fadd_rn(fminf(fmaxf(t, -128.f), 128.f), 0x1.8p23f);
    const float n = __fsub_rn(m, 0x1.8p23f);
    near |= fabsf(t) < 128.f && fabsf(__fsub_rn(t, n)) > 0.5f - 0x1p-12f;
    const int i = __float_as_int(m) - 0x4B400000;
    q[e] = t != t ? 0 : max(-127, min(127, i));
  }
  if (near) {
#pragma unroll
    for (int e = 0; e < V; ++e) q[e] = clip127(__fdiv_rn(v[e], qz.s));
  }
}

// ReLU that keeps NaN, as jnp.maximum and torch.relu do
__device__ __forceinline__ float relu(float x) { return x < 0.f ? 0.f : x; }

// max that propagates NaN, as jnp.max, torch.max and torch.clamp do
__device__ __forceinline__ float nanmax(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// c + the dot product of a's four signed bytes with b's four unsigned
__device__ __forceinline__ int dp4a_su(int a, uint32_t b, int c) {
  int d;
  asm("dp4a.s32.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// |x| as bits: clears the sign, so NaN stays NaN and orders above +inf
__device__ __forceinline__ unsigned abs_bits(float x) {
  return __float_as_uint(x) & 0x7fffffffu;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// relu_attn
// ---------------------------------------------------------------------------

// Tokens one CTA holds at once (ch) for slices of `per` tokens: the slice
// rounded up to 32, at most CH_MAX; a transposed row takes ch / 4 + 4
// words, 16-byte aligned and an odd multiple of 4 (conflict-free LDS.128
// over 8 rows).
__host__ __device__ constexpr int chunk_tokens(int per) {
  return per + 31 < CH_MAX ? (per + 31) & ~31 : CH_MAX;
}

// Shared memory of one relu_attn CTA, in 32-bit words (DW = DP / 4); at
// most 189 KB (splits 8, DP 64, ch 256), so every plan fits.
__host__ __device__ constexpr int attn_smem_words(int DP, int S, int ch) {
  return 2 * DP * (ch / 4 + 4)  // kT, vT: [DP][token] over tokens
         + S * DP * DP          // recv: [S][DP*DP] each CTA's partial kv
         + S * DP               // recvk: [S][DP] each CTA's partial ksum
         + DP * DP / 32         // wmax: a warp's max |kv_f| bits
         + 1                    // skv
         + 3 * (DP / 4)         // ks8: [byte][d] ksum's bytes packed over d
         + DP * (DP / 4)        // kv8: [e][d] packed over d
         + ch * (DP / 4);       // q8: [token][d] packed over d
}

// Load and quantize tokens [c0, c0 + rows) of one head: (with_kv) k and
// v transposed into kTb / vTb (byte r of row d), zero past `rows` up to
// rows16; (with_q) q as rows into q8b.  V: elements a load.  One item is
// one load of one tensor, so the items spread over all the threads (the
// quantizer's chain per element sets this phase's time).
template <int DP, int V, typename T>
__device__ __forceinline__ void load_chunk(
    const T* __restrict__ qb, const T* __restrict__ kb,
    const T* __restrict__ vb, int64_t qsn, int64_t ksn, int64_t vsn, int c0,
    int rows, int rows16, int D, int rw, float sq, float sk, float sv,
    bool with_kv, bool with_q, int8_t* kTb, int8_t* vTb, int8_t* q8b) {
  const int vpr = D / V;           // loads per token and tensor
  const int per = rows16 * vpr;    // items per tensor
  const int first = with_kv ? 0 : 2;  // tensors: 0 k, 1 v, 2 q
  const int last = with_q ? 2 : 1;
  for (int i = threadIdx.x; i < (last - first + 1) * per; i += NT) {
    const int t = first + i / per;
    const int ii = i % per, r = ii / vpr;
    const int d = (ii - r * vpr) * V;  // the load's first element
    const bool live = r < rows;
    int c[V];
    if (live) {
      const T* base = t == 0 ? kb : t == 1 ? vb : qb;
      const int64_t sn = t == 0 ? ksn : t == 1 ? vsn : qsn;
      float x[V];
      load<T, V>(base + (int64_t)(c0 + r) * sn + d, x);
      const float s = t == 0 ? sk : t == 1 ? sv : sq;
      if (t != 1) {
#pragma unroll
        for (int e = 0; e < V; ++e) x[e] = relu(x[e]);
      }
      quantize<V>(make_quantizer(s), x, c);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) c[e] = 0;
    }
    if (t == 2) {
      if (live) {
#pragma unroll
        for (int e = 0; e < V; ++e) q8b[r * DP + d + e] = (int8_t)c[e];
      }
    } else {
      int8_t* dst = t == 0 ? kTb : vTb;
#pragma unroll
      for (int e = 0; e < V; ++e) dst[(d + e) * (rw * 4) + r] = (int8_t)c[e];
    }
  }
}

template <typename T, typename OUT, int DP>
__global__ void __launch_bounds__(NT) relu_attn_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, int64_t qsb, int64_t qsn, int64_t ksb,
    int64_t ksn, int64_t vsb, int64_t vsn, const float* __restrict__ sq_p,
    const float* __restrict__ sk_p, const float* __restrict__ sv_p,
    OUT* __restrict__ out, int N, int H, int D, float eps, int splits,
    int vec) {
  extern __shared__ __align__(16) int smem[];
  constexpr int DD = DP * DP;
  constexpr int DW = DP / 4;
  const int tid = threadIdx.x, lane = tid & 31;
  const int rank = (int)(blockIdx.x % (unsigned)splits);  // token slice
  const int pair = (int)(blockIdx.x / (unsigned)splits);  // (b, h)
  const int per = (N + splits - 1) / splits;  // tokens of a slice
  const int ch = chunk_tokens(per), rw = ch / 4 + 4;
  int* kT = smem;                       // [DP][rw]
  int* vT = kT + DP * rw;               // [DP][rw]
  int* recv = vT + DP * rw;             // [splits][DD]: CTA r's kv, slot r
  int* recvk = recv + splits * DD;      // [splits][DP]: its ksum
  unsigned* wmax = reinterpret_cast<unsigned*>(recvk + splits * DP);
  float* skv_s = reinterpret_cast<float*>(wmax + DD / 32);
  uint32_t* ks8 = reinterpret_cast<uint32_t*>(skv_s + 1);
  int* kv8 = reinterpret_cast<int*>(ks8 + 3 * DW);  // [DP e][DW]
  int* q8 = kv8 + DP * DW;              // [ch][DW]
  int* kvp = recv + rank * DD;      // this CTA's partial kv
  int* ksp = recvk + rank * DP;     // and ksum
  int8_t* kTb = reinterpret_cast<int8_t*>(kT);
  int8_t* vTb = reinterpret_cast<int8_t*>(vT);
  int8_t* q8b = reinterpret_cast<int8_t*>(q8);
  cg::cluster_group cluster = cg::this_cluster();
  // this CTA runs: peers may write into its shared memory once every
  // CTA of the cluster has arrived here (waited on before the first push)
  if (splits > 1) cluster_arrive();

  const int b = pair / H, h = pair - b * H;
  const int n_lo = min(N, rank * per), n_hi = min(N, n_lo + per);
  const bool q_once = n_hi - n_lo <= ch;  // q quantized with k and v
  const T* qb = q + b * qsb + (int64_t)h * D;
  const T* kb = k + b * ksb + (int64_t)h * D;
  const T* vb = v + b * vsb + (int64_t)h * D;
  const float sq = *sq_p, sk = *sk_p, sv = *sv_p;

  for (int i = tid; i < DD; i += NT) kvp[i] = 0;
  for (int i = tid; i < DP; i += NT) ksp[i] = 0;
  if (D < DP) {  // padded head dims stay zero in every int8 operand
    for (int i = tid; i < 2 * DP * rw; i += NT) kT[i] = 0;
    for (int i = tid; i < ch * DW; i += NT) q8[i] = 0;
    __syncthreads();
  }

  // ---- pass 1: this slice's partial kv = k8^T v8 and ksum ---------------
  for (int c0 = n_lo; c0 < n_hi; c0 += ch) {
    const int rows = min(ch, n_hi - c0), rows16 = (rows + 15) & ~15;
    if (vec)
      load_chunk<DP, VEC<T>>(qb, kb, vb, qsn, ksn, vsn, c0, rows, rows16, D,
                             rw, sq, sk, sv, true, q_once, kTb, vTb, q8b);
    else
      load_chunk<DP, 1>(qb, kb, vb, qsn, ksn, vsn, c0, rows, rows16, D, rw,
                        sq, sk, sv, true, q_once, kTb, vTb, q8b);
    __syncthreads();
    const int n16 = rows16 / 16;  // 16 tokens (four words) a load
    // items [0, DD): kv entries; [DD, DD + DP): ksum entries (k8 . 1); the
    // same owner in every chunk
    for (int i = tid; i < DD + DP; i += NT) {
      int acc = 0;
      if (i < DD) {
        const int4* a = reinterpret_cast<const int4*>(kT + (i / DP) * rw);
        const int4* c = reinterpret_cast<const int4*>(vT + (i % DP) * rw);
        for (int w = 0; w < n16; ++w) {
          const int4 x = a[w], y = c[w];
          acc = __dp4a(x.x, y.x, acc);
          acc = __dp4a(x.y, y.y, acc);
          acc = __dp4a(x.z, y.z, acc);
          acc = __dp4a(x.w, y.w, acc);
        }
        kvp[i] += acc;
      } else {
        const int4* a = reinterpret_cast<const int4*>(kT + (i - DD) * rw);
        for (int w = 0; w < n16; ++w) {
          const int4 x = a[w];
          acc = __dp4a(x.x, 0x01010101, acc);
          acc = __dp4a(x.y, 0x01010101, acc);
          acc = __dp4a(x.z, 0x01010101, acc);
          acc = __dp4a(x.w, 0x01010101, acc);
        }
        ksp[i - DD] += acc;
      }
    }
    __syncthreads();  // before the next chunk overwrites kT / vT
  }

  // ---- the cluster's kv: every CTA's partial, summed exactly -------------
  // Each thread pushes the partial sums it owns into slot `rank` of every
  // peer (remote stores do not stall), and one cluster barrier makes them
  // visible; no CTA reads another's memory, so none waits at the end.
  if (splits > 1) {
    cluster_wait();  // every CTA of the cluster runs
    for (int i = tid; i < DD; i += NT) {
      const int a = kvp[i];
#pragma unroll
      for (int r = 1; r < MAX_SPLIT; ++r)
        if (r < splits)
          cluster.map_shared_rank(recv, (rank + r) % splits)[rank * DD + i] =
              a;
    }
    for (int i = tid; i < DP; i += NT) {
      const int a = ksp[i];
#pragma unroll
      for (int r = 1; r < MAX_SPLIT; ++r)
        if (r < splits)
          cluster.map_shared_rank(recvk, (rank + r) % splits)[rank * DP + i] =
              a;
    }
    cluster.sync();
  } else {
    __syncthreads();
  }
  // ---- the totals (slot 0, each entry by its owner), per-warp maxima,
  // and ksum's bytes packed over d -------------------------------------
  const float sksv = __fmul_rn(sk, sv);
  for (int i = tid; i < DD; i += NT) {  // DD and NT: multiples of 32
    int a = 0;
#pragma unroll
    for (int r = 0; r < MAX_SPLIT; ++r)
      if (r < splits) a += recv[r * DD + i];
    recv[i] = a;
    const unsigned m = __reduce_max_sync(
        0xffffffffu, abs_bits(__fmul_rn((float)a, sksv)));
    if (lane == 0) wmax[i >> 5] = m;
  }
  // ksum (0 <= ksum <= 127 N < 2^24) as three unsigned bytes, so pass 2
  // forms den = q8 . ksum with dp4a: den = d0 + 2^8 d1 + 2^16 d2
  for (int w = tid; w < DW; w += NT) {
    uint32_t b3[3] = {0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int a = 0;
#pragma unroll
      for (int r = 0; r < MAX_SPLIT; ++r)
        if (r < splits) a += recvk[r * DP + 4 * w + j];
#pragma unroll
      for (int t = 0; t < 3; ++t)
        b3[t] |= (((uint32_t)a >> (8 * t)) & 0xffu) << (8 * j);
    }
#pragma unroll
    for (int t = 0; t < 3; ++t) ks8[t * DW + w] = b3[t];
  }
  __syncthreads();

  // ---- kv requantized to int8, packed over d for pass 2 ----------------
  for (int i = tid; i < DP * DW; i += NT) {
    const int e = i / DW, w = i % DW;
    unsigned m = 0u;  // the head's max |kv_f| as bits: |x| and NaN order so
    for (int x = 0; x < DD / 32; ++x) m = max(m, wmax[x]);
    const float skv = nanmax(__fdiv_rn(__uint_as_float(m), 127.f), 1e-8f);
    if (i == 0) *skv_s = skv;
    float f[4];
    int c[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[j] = __fmul_rn((float)recv[(4 * w + j) * DP + e], sksv);
    quantize<4>(make_quantizer(skv), f, c);
    uint32_t packed = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) packed |= (uint32_t)(c[j] & 0xff) << (8 * j);
    kv8[i] = (int)packed;
  }
  __syncthreads();

  // ---- pass 2: num / den for this slice's tokens, then the epilogue ------
  const float den_scale = __fmul_rn(sq, sk);
  const float num_scale = __fmul_rn(sq, *skv_s);
  const int NE = (D + E2 - 1) / E2;  // E2-wide output chunks of a head
  for (int c0 = n_lo; c0 < n_hi; c0 += ch) {
    const int rows = min(ch, n_hi - c0);
    if (!q_once) {  // a long slice: q chunk by chunk
      __syncthreads();  // the previous chunk's q8 is read
      if (vec)
        load_chunk<DP, VEC<T>>(qb, kb, vb, qsn, ksn, vsn, c0, rows, rows, D,
                               rw, sq, sk, sv, false, true, kTb, vTb, q8b);
      else
        load_chunk<DP, 1>(qb, kb, vb, qsn, ksn, vsn, c0, rows, rows, D, rw,
                          sq, sk, sv, false, true, kTb, vTb, q8b);
      __syncthreads();
    }
    for (int it = tid; it < rows * NE; it += NT) {
      const int c = it % NE, r = it / NE;
      int qw[DW];
      const int* qr = q8 + r * DW;
#pragma unroll
      for (int w = 0; w < DW; ++w) qw[w] = qr[w];
      int d0 = 0, d1 = 0, d2 = 0;
#pragma unroll
      for (int w = 0; w < DW; ++w) {
        d0 = dp4a_su(qw[w], ks8[w], d0);
        d1 = dp4a_su(qw[w], ks8[DW + w], d1);
        d2 = dp4a_su(qw[w], ks8[2 * DW + w], d2);
      }
      // the int32 sum q8 . ksum, modulo 2^32 as the plain version's
      const int den = (int)((uint32_t)d0 + ((uint32_t)d1 << 8) +
                            ((uint32_t)d2 << 16));
      const float df = __fadd_rn(__fmul_rn((float)den, den_scale), eps);
      float y[E2];
#pragma unroll
      for (int j = 0; j < E2; ++j) {
        const int* kr = kv8 + (c * E2 + j) * DW;
        int num = 0;
#pragma unroll
        for (int w = 0; w < DW; ++w) num = __dp4a(qw[w], kr[w], num);
        y[j] = __fdiv_rn(__fmul_rn((float)num, num_scale), df);
      }
      OUT* o = out + (((int64_t)b * N + c0 + r) * H + h) * D + c * E2;
      if (D % E2 == 0) {
        if constexpr (sizeof(OUT) == 2) {
          uint32_t w[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const __nv_bfloat162 p = __floats2bfloat162_rn(y[2 * j],
                                                           y[2 * j + 1]);
            w[j] = *reinterpret_cast<const uint32_t*>(&p);
          }
          *reinterpret_cast<uint2*>(o) = make_uint2(w[0], w[1]);
        } else {
          *reinterpret_cast<float4*>(o) = make_float4(y[0], y[1], y[2], y[3]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < E2; ++j) {
          if (c * E2 + j < D) {
            if constexpr (sizeof(OUT) == 2)
              o[j] = __float2bfloat16_rn(y[j]);
            else
              o[j] = y[j];
          }
        }
      }
    }
  }
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

template <typename T, typename OUT, int DP>
int launch_attn(const void* q, const void* k, const void* v, int64_t qsb,
                int64_t qsn, int64_t ksb, int64_t ksn, int64_t vsb,
                int64_t vsn, const float* sq, const float* sk,
                const float* sv, void* out, int B, int N, int H, int D,
                float eps, int splits, cudaStream_t s) {
  auto kernel = relu_attn_kernel<T, OUT, DP>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (attr != cudaSuccess) return (int)attr;
  constexpr int V = VEC<T>;
  const int vec = D % V == 0 && qsb % V == 0 && qsn % V == 0 &&
                  ksb % V == 0 && ksn % V == 0 && vsb % V == 0 &&
                  vsn % V == 0 && aligned16(q) && aligned16(k) &&
                  aligned16(v);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(splits * B * H));
  cfg.blockDim = dim3((unsigned)NT);
  cfg.dynamicSmemBytes =
      (size_t)attn_smem_words(DP, splits,
                              chunk_tokens((N + splits - 1) / splits)) * 4;
  cfg.stream = s;
  cudaLaunchAttribute la[1];
  la[0].id = cudaLaunchAttributeClusterDimension;
  la[0].val.clusterDim.x = (unsigned)splits;
  la[0].val.clusterDim.y = 1;
  la[0].val.clusterDim.z = 1;
  cfg.attrs = la;
  cfg.numAttrs = splits > 1 ? 1 : 0;  // a plain launch needs no cluster
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, (const T*)q, (const T*)k, (const T*)v, qsb, qsn, ksb,
      ksn, vsb, vsn, sq, sk, sv, (OUT*)out, N, H, D, eps, splits, vec);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, typename OUT>
int dispatch_attn(const void* q, const void* k, const void* v, int64_t qsb,
                  int64_t qsn, int64_t ksb, int64_t ksn, int64_t vsb,
                  int64_t vsn, const float* sq, const float* sk,
                  const float* sv, void* out, int B, int N, int H, int D,
                  float eps, int splits, cudaStream_t s) {
#define RELU_ATTN_DP(DP_)                                                  \
  if (D <= DP_)                                                            \
    return launch_attn<T, OUT, DP_>(q, k, v, qsb, qsn, ksb, ksn, vsb, vsn,  \
                                    sq, sk, sv, out, B, N, H, D, eps,       \
                                    splits, s);
  RELU_ATTN_DP(8) RELU_ATTN_DP(16) RELU_ATTN_DP(32) RELU_ATTN_DP(64)
#undef RELU_ATTN_DP
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// relu_attn_scales
// ---------------------------------------------------------------------------

// This thread's share of q, k and v (rows of C elements, row b*N + n at
// b*sb + n*sn): the maxima of q, of k and of |v|.  V: elements a load.
template <typename T, int V>
__device__ __forceinline__ void scan(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, int64_t qsb, int64_t qsn, int64_t ksb,
    int64_t ksn, int64_t vsb, int64_t vsn, unsigned N, unsigned total,
    unsigned vpr, unsigned first, unsigned stride, float& mq, float& mk,
    float& mv) {
  constexpr int U = 2;  // loads of each tensor in flight per thread
  for (unsigned i0 = first; i0 < total; i0 += U * stride) {
    float xq[U][V], xk[U][V], xv[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const unsigned i = i0 + u * stride;
      if (i < total) {
        const unsigned row = i / vpr, j = (i - row * vpr) * V;
        const unsigned b = row / N, n = row - b * N;
        load<T, V>(q + b * qsb + n * qsn + j, xq[u]);
        load<T, V>(k + b * ksb + n * ksn + j, xk[u]);
        load<T, V>(v + b * vsb + n * vsn + j, xv[u]);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) xq[u][e] = xk[u][e] = xv[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int e = 0; e < V; ++e) {
        if (i0 + u * stride < total) {
          mq = nanmax(mq, xq[u][e]);
          mk = nanmax(mk, xk[u][e]);
          mv = nanmax(mv, __uint_as_float(abs_bits(xv[u][e])));
        }
      }
  }
}

__device__ __forceinline__ void warp_max3(float& a, float& b, float& c) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a = nanmax(a, __shfl_xor_sync(0xffffffffu, a, o));
    b = nanmax(b, __shfl_xor_sync(0xffffffffu, b, o));
    c = nanmax(c, __shfl_xor_sync(0xffffffffu, c, o));
  }
}

template <typename T>
__global__ void __launch_bounds__(SCALE_NT) relu_attn_scales_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, int64_t qsb, int64_t qsn, int64_t ksb,
    int64_t ksn, int64_t vsb, int64_t vsn, float* __restrict__ out,
    unsigned N, unsigned rows, unsigned C, int vec) {
  __shared__ float red[3][SCALE_WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned first = blockIdx.x * SCALE_NT + tid;
  const unsigned stride = gridDim.x * SCALE_NT;
  float mq = -INFINITY, mk = -INFINITY, mv = 0.f;
  if (vec) {
    constexpr int V = VEC<T>;
    scan<T, V>(q, k, v, qsb, qsn, ksb, ksn, vsb, vsn, N, rows * (C / V),
               C / V, first, stride, mq, mk, mv);
  } else {
    scan<T, 1>(q, k, v, qsb, qsn, ksb, ksn, vsb, vsn, N, rows * C, C,
               first, stride, mq, mk, mv);
  }
  warp_max3(mq, mk, mv);
  if (lane == 0) {
    red[0][warp] = mq;
    red[1][warp] = mk;
    red[2][warp] = mv;
  }
  __syncthreads();
  if (warp == 0) {
    mq = lane < SCALE_WARPS ? red[0][lane] : -INFINITY;
    mk = lane < SCALE_WARPS ? red[1][lane] : -INFINITY;
    mv = lane < SCALE_WARPS ? red[2][lane] : 0.f;
    warp_max3(mq, mk, mv);
    if (lane == 0) {
      red[0][0] = mq;
      red[1][0] = mk;
      red[2][0] = mv;
    }
  }
  const int ctas = (int)gridDim.x;
  cg::cluster_group cluster = cg::this_cluster();
  if (ctas > 1)
    cluster.sync();
  else
    __syncthreads();
  if (blockIdx.x == 0 && tid < 3) {
    float m = tid == 2 ? 0.f : -INFINITY;
#pragma unroll
    for (int r = 0; r < MAX_SCALE_CTAS; ++r)
      if (r < ctas)
        m = nanmax(m, (ctas > 1 ? cluster.map_shared_rank(&red[0][0], r)
                                : &red[0][0])[tid * SCALE_WARPS]);
    // q and k: the post-ReLU maximum, clamp(max, min=0)
    if (tid < 2) m = nanmax(m, 0.f);
    out[tid] = nanmax(__fdiv_rn(m, 127.f), 1e-8f);
  }
  if (ctas > 1) cluster.sync();  // no CTA leaves while CTA 0 reads it
}

template <typename T>
int launch_scales(const void* q, const void* k, const void* v, int64_t qsb,
                  int64_t qsn, int64_t ksb, int64_t ksn, int64_t vsb,
                  int64_t vsn, float* out, int B, int N, int C, int ctas,
                  cudaStream_t s) {
  auto kernel = relu_attn_scales_kernel<T>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (attr != cudaSuccess) return (int)attr;
  constexpr int V = VEC<T>;
  const int vec = C % V == 0 && qsb % V == 0 && qsn % V == 0 &&
                  ksb % V == 0 && ksn % V == 0 && vsb % V == 0 &&
                  vsn % V == 0 && aligned16(q) && aligned16(k) &&
                  aligned16(v);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)ctas);
  cfg.blockDim = dim3((unsigned)SCALE_NT);
  cfg.stream = s;
  cudaLaunchAttribute la[1];
  la[0].id = cudaLaunchAttributeClusterDimension;
  la[0].val.clusterDim.x = (unsigned)ctas;
  la[0].val.clusterDim.y = 1;
  la[0].val.clusterDim.z = 1;
  cfg.attrs = la;
  cfg.numAttrs = ctas > 1 ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, (const T*)q, (const T*)k, (const T*)v, qsb, qsn, ksb,
      ksn, vsb, vsn, out, (unsigned)N, (unsigned)(B * N), (unsigned)C, vec);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// q/k/v (B, N, H, D) with unit stride over D and stride D over heads;
// batch / token strides qsb, qsn, ...; sq/sk/sv 0-d f32 on the device.
// out: (B, N, H, D) contiguous, f32 or (y_is_bf16) bf16.
// splits: CTAs of one cluster, each a slice of the tokens (1, 2, 4, 8).
extern "C" int relu_attn(const void* q, const void* k, const void* v,
                         int64_t qsb, int64_t qsn, int64_t ksb, int64_t ksn,
                         int64_t vsb, int64_t vsn, const void* sq,
                         const void* sk, const void* sv, void* out, int B,
                         int N, int H, int D, float eps, int x_is_bf16,
                         int y_is_bf16, int splits, void* stream) {
  if (D < 1 || D > MAXD || splits < 1 || splits > MAX_SPLIT ||
      (splits & (splits - 1)) != 0 || N > MAX_N)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || N == 0 || H == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const float *fq = (const float*)sq, *fk = (const float*)sk,
              *fv = (const float*)sv;
#define RELU_ATTN_ARGS                                                    \
  q, k, v, qsb, qsn, ksb, ksn, vsb, vsn, fq, fk, fv, out, B, N, H, D, eps, \
      splits, s
  if (x_is_bf16) {
    if (y_is_bf16)
      return dispatch_attn<__nv_bfloat16, __nv_bfloat16>(RELU_ATTN_ARGS);
    return dispatch_attn<__nv_bfloat16, float>(RELU_ATTN_ARGS);
  }
  if (y_is_bf16) return dispatch_attn<float, __nv_bfloat16>(RELU_ATTN_ARGS);
  return dispatch_attn<float, float>(RELU_ATTN_ARGS);
#undef RELU_ATTN_ARGS
}

// q/k/v as relu_attn takes them, C = H * D elements a token; out: 3 f32
// on the device, written (sq, sk, sv).  ctas: CTAs of the one cluster
// (1, 2, 4, 8 or 16).  B * N * C must stay below 2^31.
extern "C" int relu_attn_scales(const void* q, const void* k, const void* v,
                                int64_t qsb, int64_t qsn, int64_t ksb,
                                int64_t ksn, int64_t vsb, int64_t vsn,
                                void* out, int B, int N, int C,
                                int x_is_bf16, int ctas, void* stream) {
  if (B < 1 || N < 1 || C < 1 || ctas < 1 || ctas > MAX_SCALE_CTAS ||
      (ctas & (ctas - 1)) != 0 || (int64_t)B * N * C >= (int64_t)1 << 31)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_is_bf16)
    return launch_scales<__nv_bfloat16>(q, k, v, qsb, qsn, ksb, ksn, vsb,
                                        vsn, (float*)out, B, N, C, ctas, s);
  return launch_scales<float>(q, k, v, qsb, qsn, ksb, ksn, vsb, vsn,
                              (float*)out, B, N, C, ctas, s);
}

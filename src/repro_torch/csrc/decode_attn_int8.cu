// GQA decode attention over the int8 KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/decode_attn_int8.py::decode_attn_int8
// (body _kernel): per (batch, kv-head) and query g of the group,
//   q_s = max|q|/127 + 1e-9,  q8 = clip(rint(q/q_s), +-127);
//   s_t = ((float(q8 . k8_t) * q_s) * scale) * k_scale_t on valid rows
//         (t < length, and t >= length - window when windowed), -1e30 else;
//   p = softmax(s) in f32;  pv_t = p_t * v_scale_t;
//   p_s = max|pv|/127 + 1e-12,  p8 = clip(rint(pv/p_s), +-127);
//   out = float(sum_t p8_t * v8_t) * p_s, stored as f32 or bf16.
//
// What bounds it on the H100: memory, and at the served sizes latency.  One
// decode token does ~4*G*T*D integer MACs against T*D bytes of k and of v
// plus 8*T bytes of row scales per (b, h), far below the card's ops-per-byte
// ridge: reading the valid cache rows once is the floor.  At the served
// shape (B 8, T 256, Hkv 16, G 1, D 64, 44-118 valid rows) a block moves
// ~15 KB, so the time is the chain of dependent steps: the length load, the
// row copies, three softmax reductions, the PV sums.
//
// Design: one block of THREADS (256) threads per (b, kv-head).
//  * Valid rows only: the block works on [lo, hi), the rows that can be
//    valid; all T rows only when every row is masked (length 0: the uniform
//    softmax the plain version gives).  Whenever one row is valid, a masked
//    row has p = 0 exactly (exp(-1e30 - m)), so its exp and division change
//    nothing; its v_scale is still read, because 0 * NaN or 0 * inf makes
//    the plain version's max|pv| NaN.
//  * Rows stream through a ring of `depth` slots of `rows` cache rows each:
//    the k tiles, then the v tiles, one cp.async group per tile (16-byte
//    copies for the rows, XOR-swizzled so that threads reading one chunk of
//    consecutive rows hit distinct banks; 4 bytes for k_scale).  The first
//    slots go in flight as soon as the length is read, ahead of the q
//    quantization; a slot freed by the score pass takes the next tile at
//    once, so the v tiles fly during the softmax.  Shared memory grows with
//    T only by the G x T f32 scores and the G x T int8 codes.
//  * One thread per row from the scores to the codes: thread tid owns the
//    rows t = tid (mod THREADS), keeps the v_scale of its first rows in
//    registers (loaded at entry, with the length) and is the only reader of
//    their scores, so the passes meet only at the three reductions (max,
//    sum, max|pv|), each a warp shuffle and one shared-memory exchange.
//    The scores are int32 dots by __dp4a over the row's 16-byte chunks.
//    Float steps use explicitly rounded operations (IEEE division, no FMA
//    contraction) in the plain version's order; maxima propagate NaN as
//    torch.amax does.  Nothing on the path divides by a runtime integer:
//    slots and tiles are powers of two (what a plan may choose).
//  * PV on __dp4a: a thread owns four columns; for each quad of rows it
//    packs the four rows' p8 codes into one word and turns the four v8 words
//    into four column words with __byte_perm.  Int32 partials sit per
//    thread in shared memory and are summed at the end: integer sums, so
//    their order changes nothing.
// The exp and the softmax sum order can still move p by an ulp and flip a
// p8 code, so the result agrees with the plain version to 2 * p_s * max|v8|
// per output row, not bit for bit; the bf16 store is the f32 result rounded
// once (__float2bfloat16_rn), as a cast of the f32 store is.  One corner is
// not followed: if every valid score is below -1e30 + 104 (an infinite
// k_scale), the plain softmax puts its weight on the masked rows, which
// this kernel skips.  Launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // every plan of the sweep chose 256
constexpr int W = THREADS / 32;
constexpr int VPT = 2;        // rows a thread keeps the v_scale of in registers
constexpr int MAXD = 128;
constexpr int MAX_DEPTH = 16;
constexpr int GC = 4;  // query rows of a group the PV pass does together
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory of one block
constexpr float NEG_INF = -1.0e30f;
constexpr unsigned MINUS_INF_BITS = 0xff800000u;
constexpr unsigned NAN_BITS = 0x7fffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// max that propagates NaN, as torch.amax and jnp.max do (one instruction)
__device__ __forceinline__ float nanmax(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// clip(rne(x / s), +-127).  The conversion rounds half to even, saturates
// and sends NaN to 0 (cvt.rni.s32.f32), as the plain version's float ->
// int8 cast does.
__device__ __forceinline__ int quant8(float x, float s) {
  return max(-127, min(127, __float2int_rn(__fdiv_rn(x, s))));
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

// the W per-warp values of one exchange, reduced as a tree (every thread
// gets the same result: the order is fixed)
template <int W>
__device__ __forceinline__ float exchange_max(const float* red) {
  float v[W];
#pragma unroll
  for (int w = 0; w < W; ++w) v[w] = red[w];
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1)
#pragma unroll
    for (int w = 0; w < o; ++w) v[w] = nanmax(v[w], v[w + o]);
  return v[0];
}

template <int W>
__device__ __forceinline__ float exchange_sum(const float* red) {
  float v[W];
#pragma unroll
  for (int w = 0; w < W; ++w) v[w] = red[w];
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1)
#pragma unroll
    for (int w = 0; w < o; ++w) v[w] = __fadd_rn(v[w], v[w + o]);
  return v[0];
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most n (< MAX_DEPTH) of this thread's groups are pending
__device__ __forceinline__ void cp_async_wait(int n) {
#define WAIT_CASE(k) \
  case k:            \
    asm volatile("cp.async.wait_group " #k ";\n" ::: "memory"); break;
  switch (n) {
    WAIT_CASE(0) WAIT_CASE(1) WAIT_CASE(2) WAIT_CASE(3) WAIT_CASE(4)
    WAIT_CASE(5) WAIT_CASE(6) WAIT_CASE(7) WAIT_CASE(8) WAIT_CASE(9)
    WAIT_CASE(10) WAIT_CASE(11) WAIT_CASE(12) WAIT_CASE(13) WAIT_CASE(14)
    default: asm volatile("cp.async.wait_group 15;\n" ::: "memory");
  }
#undef WAIT_CASE
}

__host__ __device__ __forceinline__ int pow2_ceil(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

__host__ __device__ __forceinline__ int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

__host__ __device__ __forceinline__ int log2_pow2(int x) {
  int l = 0;
  while ((1 << l) < x) ++l;
  return l;
}

// Where the 16-byte chunks of a ring slot's rows sit: a row holds ch = D/16
// chunks, chunk c of row r at physical chunk c ^ ((r >> sh) & mk).  For a
// power-of-two ch the XOR makes the eight threads of one shared-memory
// phase, reading chunk c of eight consecutive rows, hit eight bank groups;
// other ch are not swizzled.  A copy loop gives a row 1 << lg lanes (ch
// rounded up to a power of two).
struct Chunks {
  int ch, sh, mk, lg;
  __device__ __forceinline__ explicit Chunks(int D) : ch(D / 16) {
    const bool p2 = (ch & (ch - 1)) == 0;
    lg = log2_pow2(ch);
    mk = p2 ? ch - 1 : 0;
    sh = p2 ? 3 - lg : 0;
  }
  __device__ __forceinline__ int at(int r, int c) const {
    return c ^ ((r >> sh) & mk);
  }
};

// Dynamic shared memory of one block, in the order the kernel lays it out:
// the ring; the G x T f32 scores (later the PV partials, when larger); the
// G x T int8 codes; q8; q_s (later p_s); two rows of per-warp reduction
// values (the max and max|pv| exchanges share one).  Byte offsets.
struct Layout {
  size_t s, p8, q8, qs, red, total;
};

__host__ __device__ __forceinline__ Layout smem_layout(int Tn, int G, int D,
                                                       int rows, int depth) {
  const size_t splits = THREADS / pow2_ceil(D / 4);
  size_t s = (size_t)G * Tn;
  if (s < splits * G * D) s = splits * G * D;
  Layout l;
  l.s = (size_t)depth * rows * (D + 4);
  l.p8 = l.s + s * 4;
  l.q8 = (l.p8 + (size_t)G * round_up(Tn, 4) + 15) / 16 * 16;
  l.qs = l.q8 + (size_t)G * D;
  l.red = l.qs + (size_t)G * 4;
  l.total = l.red + (size_t)2 * G * W * 4;
  return l;
}

// Issue the copies of tile i of the block's stream (nk k tiles, then the v
// tiles) into ring slot i & (depth - 1), then commit one group -- an empty one
// past the end, so that before tile i is consumed exactly i + depth groups
// are committed.
__device__ __forceinline__ void issue_tile(
    int i, int nk, int ntiles, int n, int lo, int rows, int depth, int D,
    int slot_bytes, int64_t row_stride, int H, const Chunks& ck,
    unsigned char* ring, const int8_t* kb, const int8_t* vb,
    const float* ksb) {
  if (i < ntiles) {
    const bool is_k = i < nk;
    const int base = (is_k ? i : i - nk) * rows;
    const int cnt = min(rows, n - base);
    unsigned char* slot = ring + (size_t)(i & (depth - 1)) * slot_bytes;
    const int8_t* src = (is_k ? kb : vb) + (int64_t)(lo + base) * row_stride;
    // (1 << lg) lanes a row, chunk c = lane's low bits
    const int c = threadIdx.x & ((1 << ck.lg) - 1);
    if (c < ck.ch)
      for (int r = threadIdx.x >> ck.lg; r < cnt; r += THREADS >> ck.lg)
        cp_async16(slot + r * D + 16 * ck.at(r, c),
                   src + r * row_stride + 16 * c);
    if (is_k)
      for (int r = threadIdx.x; r < cnt; r += THREADS)
        cp_async4(slot + rows * D + 4 * r, ksb + (int64_t)(lo + base + r) * H);
  }
  cp_async_commit();
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_attn_int8_kernel(const T* __restrict__ q, const int8_t* __restrict__ k,
                        const int8_t* __restrict__ v,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const int* __restrict__ lengths, void* __restrict__ out,
                        int Tn, int H, int G, int D, float scale, int window,
                        int out_bf16, int rows, int depth) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = smem_layout(Tn, G, D, rows, depth);
  unsigned char* ring = smem;
  float* s = reinterpret_cast<float*>(smem + lay.s);      // [G][T]
  int* part = reinterpret_cast<int*>(smem + lay.s);       // [splits][G][D]
  int8_t* p8 = reinterpret_cast<int8_t*>(smem + lay.p8);  // [G][P8N]
  int8_t* q8 = reinterpret_cast<int8_t*>(smem + lay.q8);  // [G][D]
  float* qs = reinterpret_cast<float*>(smem + lay.qs);    // [G]
  // [G][W] each; every thread has read the maxima before the barrier
  // that precedes the first max|pv| write
  float* red_max = reinterpret_cast<float*>(smem + lay.red);
  float* red_sum = red_max + G * W;
  float* red_pmax = red_max;
  const int P8N = round_up(Tn, 4);
  const int slot_bytes = rows * (D + 4);
  const Chunks ck(D);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int64_t row_stride = (int64_t)H * D;  // bytes between cache rows
  const int8_t* kb = k + (int64_t)b * Tn * row_stride + (int64_t)h * D;
  const int8_t* vb = v + (int64_t)b * Tn * row_stride + (int64_t)h * D;
  const float* ksb = k_scale + (int64_t)b * Tn * H + h;
  const float* vsb = v_scale + (int64_t)b * Tn * H + h;

  // ---- entry: the length, and what does not wait for it: q and the
  // v_scale of rows tid + i * THREADS (the thread's rows) ------------------
  const int length = lengths[b];
  float qv[MAXD / 32];
  const T* q0 = q + ((int64_t)(b * H + h) * G + warp) * D;
  if (warp < G) {
#pragma unroll
    for (int i = 0; i < MAXD / 32; ++i) {
      const int d = lane + 32 * i;
      qv[i] = d < D ? to_f32(q0[d]) : 0.f;
    }
  }
  float vsr[VPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int t = tid + i * THREADS;
    vsr[i] = t < Tn ? vsb[(int64_t)t * H] : 0.f;
  }

  // rows that can be valid; an empty range means every row is masked
  int lo = window >= 0 ? max(0, length - window) : 0;
  int hi = min(length, Tn);
  const bool all_masked = lo >= hi;
  if (all_masked) { lo = 0; hi = Tn; }
  const bool has_masked = all_masked || lo > 0 || hi < Tn;
  const int n = hi - lo;
  const int nt = (n + rows - 1) >> log2_pow2(rows);  // tiles of k, of v
  const int nk = all_masked ? 0 : nt;    // no scores to form: no k tiles
  const int ntiles = nk + nt;
#define STAGE(i)                                                          \
  issue_tile((i), nk, ntiles, n, lo, rows, depth, D, slot_bytes, row_stride, \
             H, ck, ring, kb, vb, ksb)
  for (int i = 0; i < depth; ++i) STAGE(i);

  // ---- q rows -> q8 and q_s, one warp per row of the group ---------------
  for (int g = warp; g < G; g += W) {
    const T* qg = q + ((int64_t)(b * H + h) * G + g) * D;
    if (g != warp) {
#pragma unroll
      for (int i = 0; i < MAXD / 32; ++i) {
        const int d = lane + 32 * i;
        qv[i] = d < D ? to_f32(qg[d]) : 0.f;
      }
    }
    float m = 0.f;
#pragma unroll
    for (int i = 0; i < MAXD / 32; ++i) m = nanmax(m, fabsf(qv[i]));
    m = warp_max(m);
    const float sc = __fadd_rn(__fdiv_rn(m, 127.f), 1e-9f);
    if (lane == 0) qs[g] = sc;
#pragma unroll
    for (int i = 0; i < MAXD / 32; ++i) {
      const int d = lane + 32 * i;
      if (d < D) q8[g * D + d] = (int8_t)quant8(qv[i], sc);
    }
  }

  // ---- scores: the thread owns rows t = tid (mod THREADS) in [lo, hi); int32
  // dots by __dp4a over the row's chunks in the k tiles ----------------------
  for (int i = 0; i < nk; ++i) {
    cp_async_wait(depth - 1);
    __syncthreads();  // tile i (and, the first time, q8 / q_s) visible
    const unsigned char* slot = ring + (size_t)(i & (depth - 1)) * slot_bytes;
    const float* kss = reinterpret_cast<const float*>(slot + rows * D);
    const int t0 = lo + i * rows, t1 = min(t0 + rows, hi);
    for (int t = t0 + ((tid - t0) % THREADS + THREADS) % THREADS; t < t1;
         t += THREADS) {
      const int rl = t - t0;
      int4 kw[MAXD / 16];
#pragma unroll
      for (int c = 0; c < MAXD / 16; ++c)
        if (c < ck.ch)
          kw[c] = *reinterpret_cast<const int4*>(slot + rl * D +
                                                 16 * ck.at(rl, c));
      const float ks = kss[rl];
      for (int g = 0; g < G; ++g) {
        const int4* qw = reinterpret_cast<const int4*>(q8 + g * D);
        int a0 = 0, a1 = 0;
#pragma unroll
        for (int c = 0; c < MAXD / 16; ++c) {
          if (c < ck.ch) {
            const int4 qq = qw[c];
            a0 = __dp4a(kw[c].x, qq.x, a0);
            a1 = __dp4a(kw[c].y, qq.y, a1);
            a0 = __dp4a(kw[c].z, qq.z, a0);
            a1 = __dp4a(kw[c].w, qq.w, a1);
          }
        }
        s[g * Tn + t] = __fmul_rn(
            __fmul_rn(__fmul_rn((float)(a0 + a1), qs[g]), scale), ks);
      }
    }
    if (i + depth < ntiles) __syncthreads();  // slot read by every warp
    STAGE(i + depth);
  }

  // ---- softmax over the thread's rows: the first VPT in registers (t =
  // tid + i * THREADS), the rest (long caches) read v_scale again ----------
  const int t_tail = max(tid + VPT * THREADS,
                         lo + ((tid - lo) % THREADS + THREADS) % THREADS);
#define FOR_ROWS(BODY)                                                \
  _Pragma("unroll") for (int i = 0; i < VPT; ++i) {                   \
    const int t = tid + i * THREADS;                                  \
    if (t >= lo && t < hi) { const float vsc = vsr[i]; BODY }         \
  }                                                                   \
  for (int t = t_tail; t < hi; t += THREADS) {                        \
    const float vsc = vsb[(int64_t)t * H]; BODY                       \
  }
  for (int g = 0; g < G; ++g) {
    // the max over all T rows takes -1e30 in when a row is masked
    float m = has_masked ? NEG_INF : __uint_as_float(MINUS_INF_BITS);
    if (!all_masked) {
      const float* sg = s + g * Tn;
      FOR_ROWS((void)vsc; m = nanmax(m, sg[t]);)
    }
    m = warp_max(m);
    if (lane == 0) red_max[g * W + warp] = m;
  }
  __syncthreads();
  for (int g = 0; g < G; ++g) {
    const float m = exchange_max<W>(red_max + g * W);
    float* sg = s + g * Tn;
    float sum = 0.f;
    FOR_ROWS((void)vsc;
             const float e = expf(__fsub_rn(all_masked ? NEG_INF : sg[t], m));
             sg[t] = e; sum = __fadd_rn(sum, e);)
    sum = warp_sum(sum);
    if (lane == 0) red_sum[g * W + warp] = sum;
  }
  // a masked row's p is 0: only whether its v_scale is finite matters
  bool vs_bad = false;
  if (!all_masked) {
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int t = tid + i * THREADS;
      if (t < Tn && (t < lo || t >= hi)) vs_bad |= !isfinite(vsr[i]);
    }
    for (int t = tid + VPT * THREADS; t < Tn; t += THREADS)
      if (t < lo || t >= hi) vs_bad |= !isfinite(vsb[(int64_t)t * H]);
  }
  __syncthreads();
  for (int g = 0; g < G; ++g) {
    const float sum = exchange_sum<W>(red_sum + g * W);
    float* sg = s + g * Tn;
    float pmax = vs_bad ? __uint_as_float(NAN_BITS) : 0.f;
    FOR_ROWS(const float pv = __fmul_rn(__fdiv_rn(sg[t], sum), vsc);
             sg[t] = pv; pmax = nanmax(pmax, fabsf(pv));)
    pmax = warp_max(pmax);
    if (lane == 0) red_pmax[g * W + warp] = pmax;
  }
  __syncthreads();
  for (int g = 0; g < G; ++g) {
    const float ps =
        __fadd_rn(__fdiv_rn(exchange_max<W>(red_pmax + g * W), 127.f), 1e-12f);
    if (tid == 0) qs[g] = ps;  // q_s is spent: the slot now holds p_s
    const float* sg = s + g * Tn;
    int8_t* pg = p8 + g * P8N - lo;  // codes indexed from lo
    FOR_ROWS((void)vsc; pg[t] = (int8_t)quant8(sg[t], ps);)
    if (tid < round_up(n, 4) - n) pg[hi + tid] = 0;  // the last quad's pad
  }
#undef FOR_ROWS

  // ---- PV: a thread owns 4 columns of one stream of row quads -------------
  const int cpr = pow2_ceil(D / 4), lcpr = log2_pow2(cpr);
  const int spw = 32 >> lcpr, splits = W * spw;
  const int cc = lane & (cpr - 1);
  const int sp = warp * spw + (lane >> lcpr);
  // rows of a quad are read in the order j ^ x, so that the streams of one
  // warp hit other banks; the p8 word is permuted the same way
  const int x = (lane >> lcpr) & 3;
  const unsigned psel = (unsigned)((0 ^ x) | (1 ^ x) << 4 | (2 ^ x) << 8 |
                                   (3 ^ x) << 12);
  const bool owner = 4 * cc < D;
  const int cchunk = cc >> 2, cword = 4 * (cc & 3);
  for (int i = nk; i < ntiles; ++i) {
    cp_async_wait(depth - 1);
    __syncthreads();  // tile visible (the first time: p8 and p_s too)
    const unsigned char* slot = ring + (size_t)(i & (depth - 1)) * slot_bytes;
    const int base = (i - nk) * rows;
    const int nq = (min(rows, n - base) + 3) / 4;
    for (int g0 = 0; g0 < G; g0 += GC) {
      int acc[GC][4] = {};
      if (owner) {
        for (int qd = sp; qd < nq; qd += splits) {
          unsigned a[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int rl = 4 * qd + (j ^ x);
            a[j] = *reinterpret_cast<const unsigned*>(
                slot + rl * D + 16 * ck.at(rl, cchunk) + cword);
          }
          // 4 x 4 byte transpose: column k's word holds byte k of each row
          const unsigned t0 = __byte_perm(a[0], a[1], 0x5140);
          const unsigned t1 = __byte_perm(a[2], a[3], 0x5140);
          const unsigned t2 = __byte_perm(a[0], a[1], 0x7362);
          const unsigned t3 = __byte_perm(a[2], a[3], 0x7362);
          const int col0 = (int)__byte_perm(t0, t1, 0x5410);
          const int col1 = (int)__byte_perm(t0, t1, 0x7632);
          const int col2 = (int)__byte_perm(t2, t3, 0x5410);
          const int col3 = (int)__byte_perm(t2, t3, 0x7632);
#pragma unroll
          for (int gg = 0; gg < GC; ++gg) {
            if (g0 + gg < G) {
              const unsigned pw = *reinterpret_cast<const unsigned*>(
                  p8 + (g0 + gg) * P8N + base + 4 * qd);
              const int pp = (int)__byte_perm(pw, 0, psel);
              acc[gg][0] = __dp4a(col0, pp, acc[gg][0]);
              acc[gg][1] = __dp4a(col1, pp, acc[gg][1]);
              acc[gg][2] = __dp4a(col2, pp, acc[gg][2]);
              acc[gg][3] = __dp4a(col3, pp, acc[gg][3]);
            }
          }
        }
#pragma unroll
        for (int gg = 0; gg < GC; ++gg) {
          if (g0 + gg < G) {
            int4* pt = reinterpret_cast<int4*>(
                part + ((size_t)sp * G + g0 + gg) * D + 4 * cc);
            int4 cur = i == nk ? make_int4(0, 0, 0, 0) : *pt;
            cur.x += acc[gg][0]; cur.y += acc[gg][1];
            cur.z += acc[gg][2]; cur.w += acc[gg][3];
            *pt = cur;
          }
        }
      }
    }
    if (i + depth < ntiles) __syncthreads();
    STAGE(i + depth);
  }
  __syncthreads();

  // ---- the int32 sums of the streams, times p_s ---------------------------
  const int GD = G * D;
  for (int g = 0; g < G; ++g) {
    for (int d = tid; d < D; d += THREADS) {
      const int j = g * D + d;
      int acc = 0;
      for (int p = 0; p < splits; ++p) acc += part[(size_t)p * GD + j];
      const float y = __fmul_rn((float)acc, qs[g]);
      const int64_t o = (int64_t)(b * H + h) * GD + j;
      if (out_bf16)
        reinterpret_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(y);
      else
        reinterpret_cast<float*>(out)[o] = y;
    }
  }
#undef STAGE
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* k_scale,
           const void* v_scale, const void* lengths, void* out, int B, int Tn,
           int H, int G, int D, float scale, int window, int out_bf16,
           int rows, int depth, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      decode_attn_int8_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_attn_int8_kernel<T><<<(unsigned)(B * H), THREADS, smem, stream>>>(
      (const T*)q, (const int8_t*)k, (const int8_t*)v, (const float*)k_scale,
      (const float*)v_scale, (const int*)lengths, out, Tn, H, G, D, scale,
      window, out_bf16, rows, depth);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one block under a plan (the wrapper mirrors it).
extern "C" long long decode_attn_int8_smem(int Tn, int G, int D, int rows,
                                           int depth) {
  return (long long)smem_layout(Tn, G, D, rows, depth).total;
}

// rows: cache rows a ring slot holds (a power of two, at least 4); depth:
// ring slots (a power of two up to 16).  Anything else, or a plan whose
// shared memory passes the card's limit, returns cudaErrorInvalidValue.
extern "C" int decode_attn_int8(const void* q, const void* k, const void* v,
                                const void* k_scale, const void* v_scale,
                                const void* lengths, void* out, int B, int Tn,
                                int H, int G, int D, float scale, int window,
                                int q_is_bf16, int out_bf16, int rows,
                                int depth, void* stream) {
  if (D % 16 != 0 || D > MAXD || G < 1 || Tn < 1 || rows < 4 ||
      (rows & (rows - 1)) || depth < 1 || depth > MAX_DEPTH ||
      (depth & (depth - 1)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_layout(Tn, G, D, rows, depth).total;
  if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (q_is_bf16)
    return launch<__nv_bfloat16>(q, k, v, k_scale, v_scale, lengths, out, B,
                                 Tn, H, G, D, scale, window, out_bf16, rows,
                                 depth, smem, s);
  return launch<float>(q, k, v, k_scale, v_scale, lengths, out, B, Tn, H, G,
                       D, scale, window, out_bf16, rows, depth, smem, s);
}

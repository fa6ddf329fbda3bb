// 4-bit depthwise convolution for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/dwconv_w4.py::dwconv_w4 (bodies
// _kernel and _kernel_fused_pad): a depthwise kh x kw conv with XLA SAME
// padding (lo = total // 2), weights decoded from packed nibbles (low
// nibble = even channel) as (q - zp) * scale per channel, taps summed
// i-major, j-minor.  The output is f32, or bf16 rounded to nearest even
// when the caller asks for it (the served paths' bf16 activations).
//
// What bounds it on the H100: bytes.  Each output reads kh*kw inputs of
// its own channel, with no reuse across channels, so x (read once) and y
// (written once) set the floor; the packed weights are kh*kw*C/2 bytes.
// Close behind come the f32 operations: the sum may not contract into
// FMAs (bit-exactness), so each tap is a rounded multiply and a rounded
// add, ~4 us of issue at the largest shape (B 8, 112 x 112 x 64, 3x3).
//
// Design:
// * Block = one image, a tile of TH output rows x TW = SW*R output columns
//   and a slice of CS = 8*CV channels; blockDim (CV, SW, TH) names the
//   thread's channel vector, column strip and row, the grid (channel
//   tiles, row tiles * column tiles, images).  All index arithmetic is
//   32-bit within one image, worked out once per block (one division).
// * The input halo, (TH-1)*s + kh rows by (TW-1)*s + kw columns by CS
//   channels, lands in shared memory through 16-byte cp.async copies
//   (zero-filled for the SAME padding, asymmetric lo/hi as given) where
//   C and x are 16-byte aligned; else masked scalar loads (a channel tail
//   of any even C).  The block decodes its kh*kw x CS weights to f32 once,
//   as __fmul_rn(__fsub_rn(q, zp), scale), while the copies fly.
// * Each thread owns 8 channels and R adjacent output columns of one row.
//   For tap row i it reads kw weight vectors and slides over the
//   (R-1)*s + kw input vectors of its halo row once, adding each to the
//   outputs it reaches: every output still sums its taps in i-major,
//   j-minor order, each as __fadd_rn(acc, __fmul_rn(x, w)), and a padded
//   tap adds 0 * w, so the result is bit-identical to the plain version.
// * Shared memory keeps a thread's 8 channels where a quarter warp reads
//   16 contiguous bytes a thread: bf16 x as one vector; f32 x and the
//   weights as two planes of 4 channels, so no read conflicts on banks.
// * Stores go straight from registers: 16-byte bf16 or 2 x 16-byte f32
//   vectors where C % 8 == 0, masked scalars for a channel tail.
// The kernel is instantiated for (k, s) in {3, 5} x {1, 2} and R in
// {1, 2, 4, 8}; CV, SW and TH are runtime (the wrapper's launch_plan).
//
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() (cudaErrorInvalidValue for a plan it does not build).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CPT = 8;              // channels a thread owns
constexpr int MAX_THREADS = 256;    // CV * SW * TH, at most
constexpr int MAX_SMEM = 232448;    // 227 KB, a block's shared-memory cap

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Copy 16 bytes from src to shared dst; zeros when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// A thread's 8 channels of one pixel (or one tap's weights) from shared
// memory.  p: the pixel's CS channels; cv: the thread's channel vector.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, int cv, int,
                                      float (&v)[CPT]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p + cv * CPT);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // bf16 -> f32 is exact: the high half
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ void load8(const float* p, int cv, int cs,
                                      float (&v)[CPT]) {
  const float4 a = *reinterpret_cast<const float4*>(p + cv * 4);
  const float4 b = *reinterpret_cast<const float4*>(p + cs / 2 + cv * 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// Where channel c of a slice sits in the two-plane layout (4 channels of
// each thread in plane 0, the next 4 in plane 1 at cs / 2).
__device__ __forceinline__ int plane_pos(int c, int cs) {
  return (c >> 3) * 4 + (c & 3) + ((c >> 2) & 1) * (cs / 2);
}

template <typename T, int K, int S, int R>
__global__ void __launch_bounds__(MAX_THREADS)
dwconv_kernel(const T* __restrict__ x, const uint8_t* __restrict__ packed,
              const float* __restrict__ scale, const float* __restrict__ zp,
              void* __restrict__ y, int H, int W, int C, int HO, int WO,
              int ph, int pw, int n_wt, int vec, int y_bf16) {
  // 16-byte chunks of 8 channels: bf16 one, f32 two (planes)
  constexpr int E = 16 / sizeof(T);
  constexpr int NV = CPT / E;
  const int CV = blockDim.x, SW = blockDim.y, TH = blockDim.z;
  const int CS = CV * CPT;
  const int TW = SW * R;
  const int WIN = (TW - 1) * S + K;
  const int HIN = (TH - 1) * S + K;

  extern __shared__ __align__(16) unsigned char smem[];
  float* ws = reinterpret_cast<float*>(smem);            // [K*K][CS]
  T* xs = reinterpret_cast<T*>(smem + K * K * CS * 4);   // [HIN][WIN][CS]

  const int ht = blockIdx.y / n_wt;
  const int wt = blockIdx.y - ht * n_wt;
  const int c0 = blockIdx.x * CS;
  const int h0 = ht * TH * S - ph;  // image row of halo row 0
  const int w0 = wt * TW * S - pw;  // image column of halo column 0
  const T* xb = x + (size_t)blockIdx.z * H * W * C;
  const int cv = threadIdx.x, sw = threadIdx.y, th = threadIdx.z;

  // ---- the halo, zero-filled outside the image and past C ---------------
  for (int r = th; r < HIN; r += TH) {
    const int h = h0 + r;
    const bool h_ok = (unsigned)h < (unsigned)H;
    for (int col = sw; col < WIN; col += SW) {
      const int w = w0 + col;
      const bool ok = h_ok && (unsigned)w < (unsigned)W;
      const int src = ok ? (h * W + w) * C + c0 : 0;
      T* dst = xs + (r * WIN + col) * CS;
      for (int q = cv; q < CV * NV; q += CV) {
        T* d = dst + (q % NV) * (CS / NV) + (q / NV) * E;
        const int c = c0 + q * E;
        if (vec) {
          const bool valid = ok && c < C;
          cp_async16(d, valid ? xb + src + q * E : xb, valid);
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e)
            d[e] = ok && c + e < C ? xb[src + q * E + e] : T(0.f);
        }
      }
    }
  }

  // ---- the weights, decoded once per block while the copies fly --------
  const int tid = cv + CV * (sw + SW * th);
  const int half = C / 2;
  for (int c = tid; c < CS; c += CV * SW * TH) {
    const int gc = c0 + c;
    const int pos = plane_pos(c, CS);
    if (gc < C) {
      const float s = scale[gc], z = zp[gc];
      const int shift = (gc & 1) * 4;
#pragma unroll
      for (int t = 0; t < K * K; ++t) {
        const int q = (packed[t * half + (gc >> 1)] >> shift) & 0x0F;
        ws[t * CS + pos] = __fmul_rn(__fsub_rn((float)q, z), s);
      }
    } else {
#pragma unroll
      for (int t = 0; t < K * K; ++t) ws[t * CS + pos] = 0.f;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  const int ho = ht * TH + th;
  const int wo0 = wt * TW + sw * R;
  const int cb = c0 + cv * CPT;
  if (ho >= HO || wo0 >= WO || cb >= C) return;

  // ---- R outputs x 8 channels, taps i-major, j-minor --------------------
  float acc[R][CPT];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int k = 0; k < CPT; ++k) acc[r][k] = 0.f;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    float wv[K][CPT];
#pragma unroll
    for (int j = 0; j < K; ++j) load8(ws + (i * K + j) * CS, cv, CS, wv[j]);
    const T* row = xs + ((th * S + i) * WIN + sw * R * S) * CS;
#pragma unroll
    for (int c = 0; c < (R - 1) * S + K; ++c) {
      float xv[CPT];
      load8(row + c * CS, cv, CS, xv);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int j = c - r * S;  // output r's tap j, in ascending order
        if (j >= 0 && j < K) {
#pragma unroll
          for (int k = 0; k < CPT; ++k)
            acc[r][k] = __fadd_rn(acc[r][k], __fmul_rn(xv[k], wv[j][k]));
        }
      }
    }
  }

  // ---- store in the caller's dtype ---------------------------------------
  const size_t img = (size_t)blockIdx.z * HO * WO * C;
  const int nc = min(CPT, C - cb);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (wo0 + r >= WO) break;
    const int o = (ho * WO + wo0 + r) * C + cb;
    if (y_bf16) {
      __nv_bfloat16* yo = reinterpret_cast<__nv_bfloat16*>(y) + img + o;
      if (nc == CPT && (C & 7) == 0) {
        uint32_t p[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const __nv_bfloat162 v = __floats2bfloat162_rn(acc[r][2 * k],
                                                         acc[r][2 * k + 1]);
          p[k] = *reinterpret_cast<const uint32_t*>(&v);
        }
        *reinterpret_cast<uint4*>(yo) = make_uint4(p[0], p[1], p[2], p[3]);
      } else {
        for (int k = 0; k < nc; ++k) yo[k] = __float2bfloat16_rn(acc[r][k]);
      }
    } else {
      float* yo = reinterpret_cast<float*>(y) + img + o;
      if (nc == CPT && (C & 7) == 0) {
        reinterpret_cast<float4*>(yo)[0] =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        reinterpret_cast<float4*>(yo)[1] =
            make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
      } else {
        for (int k = 0; k < nc; ++k) yo[k] = acc[r][k];
      }
    }
  }
}

template <typename T, int K, int S, int R>
int launch(const void* x, const void* packed, const void* scale,
           const void* zp, void* y, int B, int H, int W, int C, int HO,
           int WO, int ph, int pw, int y_bf16, int cv, int sw, int th,
           cudaStream_t stream) {
  auto kernel = dwconv_kernel<T, K, S, R>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const int cs = cv * CPT, tw = sw * R;
  const long smem = (long)K * K * cs * 4
      + (long)((th - 1) * S + K) * ((tw - 1) * S + K) * cs * sizeof(T);
  const int n_ct = (C + cs - 1) / cs, n_ht = (HO + th - 1) / th;
  const int n_wt = (WO + tw - 1) / tw;
  if (smem > MAX_SMEM || (long)n_ht * n_wt > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  // 16-byte copies need C and x aligned to a 16-byte chunk of channels
  const int vec = (C * (int)sizeof(T)) % 16 == 0 && (uintptr_t)x % 16 == 0;
  kernel<<<dim3(n_ct, n_ht * n_wt, B), dim3(cv, sw, th), (size_t)smem,
           stream>>>((const T*)x, (const uint8_t*)packed,
                     (const float*)scale, (const float*)zp, y, H, W, C, HO,
                     WO, ph, pw, n_wt, vec, y_bf16);
  return (int)cudaGetLastError();
}

template <typename T, int K, int S>
int dispatch_r(const void* x, const void* packed, const void* scale,
               const void* zp, void* y, int B, int H, int W, int C, int HO,
               int WO, int ph, int pw, int y_bf16, int cv, int sw, int th,
               int r, cudaStream_t s) {
#define DW_R(R_)                                                         \
  if (r == R_)                                                           \
    return launch<T, K, S, R_>(x, packed, scale, zp, y, B, H, W, C, HO, \
                               WO, ph, pw, y_bf16, cv, sw, th, s);
  DW_R(1) DW_R(2) DW_R(4) DW_R(8)
#undef DW_R
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch(const void* x, const void* packed, const void* scale,
             const void* zp, void* y, int B, int H, int W, int C, int HO,
             int WO, int k, int stride, int ph, int pw, int y_bf16, int cv,
             int sw, int th, int r, cudaStream_t s) {
#define DW_KS(K_, S_)                                                     \
  if (k == K_ && stride == S_)                                            \
    return dispatch_r<T, K_, S_>(x, packed, scale, zp, y, B, H, W, C, HO, \
                                 WO, ph, pw, y_bf16, cv, sw, th, r, s);
  DW_KS(3, 1) DW_KS(3, 2) DW_KS(5, 1) DW_KS(5, 2)
#undef DW_KS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// kh == kw in {3, 5}, stride in {1, 2}; ph, pw: the SAME padding's lo;
// cv, sw, th: the block's channel vectors (8 channels each), column
// strips and output rows (cv * sw * th <= 256 threads); r: output columns
// a thread computes, one of 1, 2, 4, 8.
extern "C" int dwconv_w4(const void* x, const void* packed, const void* scale,
                         const void* zero_point, void* y, int B, int H, int W,
                         int C, int HO, int WO, int kh, int kw, int stride,
                         int ph, int pw, int x_is_bf16, int y_is_bf16, int cv,
                         int sw, int th, int r, void* stream) {
  if (kh != kw || cv < 1 || sw < 1 || th < 1 || th > 64
      || cv * sw * th > MAX_THREADS || C % 2 != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || HO == 0 || WO == 0 || C == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (x_is_bf16)
    return dispatch<__nv_bfloat16>(x, packed, scale, zero_point, y, B, H, W,
                                   C, HO, WO, kh, stride, ph, pw, y_is_bf16,
                                   cv, sw, th, r, s);
  return dispatch<float>(x, packed, scale, zero_point, y, B, H, W, C, HO, WO,
                         kh, stride, ph, pw, y_is_bf16, cv, sw, th, r, s);
}

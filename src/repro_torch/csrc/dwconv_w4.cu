// 4-bit depthwise convolution for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/dwconv_w4.py::dwconv_w4 (bodies
// _kernel and _kernel_fused_pad): a depthwise kh x kw conv with XLA SAME
// padding (lo = total // 2), weights decoded from packed nibbles as
// (q - zp) * scale per channel, output f32.
//
// What bounds it on the H100: memory.  Each output does kh*kw
// multiply-adds against one input element per tap, with no reuse across
// channels, so the bytes of x and y (2-4 B each) dominate by far; the
// packed weights are tiny (kh*kw*C/2 bytes).
//
// Design (simple first): one thread per output element with the channel
// innermost, so neighbouring threads read neighbouring channels of the
// same pixel (coalesced NHWC loads) and taps reuse through L1/L2.  SAME
// padding is applied inside the kernel by bounds checks, so neither stride
// materializes a padded copy of the map (the TPU kernel's fuse_pad mode,
// asymmetric lo/hi at stride 2 on even maps included).  One kernel serves
// 3x3 and 5x5 at strides 1 and 2.  The weight nibble is decoded per tap in
// the kernel.  Taps accumulate in i-major, j-minor order with explicitly
// rounded adds and multiplies (no FMA contraction), and out-of-bounds taps
// add 0*w exactly as the zero-padded plain version does, so the result is
// bit-identical to the plain version.  Launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
dwconv_kernel(const T* __restrict__ x, const uint8_t* __restrict__ packed,
              const float* __restrict__ scale, const float* __restrict__ zp,
              float* __restrict__ y, int B, int H, int W, int C, int HO,
              int WO, int kh, int kw, int stride, int ph, int pw) {
  const int64_t total = (int64_t)B * HO * WO * C;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int c = (int)(idx % C);
  int64_t t = idx / C;
  const int wo = (int)(t % WO);
  t /= WO;
  const int ho = (int)(t % HO);
  const int b = (int)(t / HO);

  const float s = scale[c], z = zp[c];
  const int half = C / 2;
  const int shift = (c & 1) ? 4 : 0;
  float acc = 0.f;
  for (int i = 0; i < kh; ++i) {
    const int hi = ho * stride + i - ph;
    const bool row_ok = hi >= 0 && hi < H;
    for (int j = 0; j < kw; ++j) {
      const int wi = wo * stride + j - pw;
      const int q = (packed[(i * kw + j) * half + (c >> 1)] >> shift) & 0x0F;
      const float w = __fmul_rn(__fsub_rn((float)q, z), s);
      float xv = 0.f;
      if (row_ok && wi >= 0 && wi < W)
        xv = to_f32(x[(((int64_t)b * H + hi) * W + wi) * C + c]);
      acc = __fadd_rn(acc, __fmul_rn(xv, w));
    }
  }
  y[idx] = acc;
}

}  // namespace

extern "C" int dwconv_w4(const void* x, const void* packed, const void* scale,
                         const void* zero_point, void* y, int B, int H, int W,
                         int C, int HO, int WO, int kh, int kw, int stride,
                         int ph, int pw, int x_is_bf16, void* stream) {
  const int64_t total = (int64_t)B * HO * WO * C;
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  if (x_is_bf16) {
    dwconv_kernel<__nv_bfloat16><<<blocks, THREADS, 0, s>>>(
        (const __nv_bfloat16*)x, (const uint8_t*)packed, (const float*)scale,
        (const float*)zero_point, (float*)y, B, H, W, C, HO, WO, kh, kw,
        stride, ph, pw);
  } else {
    dwconv_kernel<float><<<blocks, THREADS, 0, s>>>(
        (const float*)x, (const uint8_t*)packed, (const float*)scale,
        (const float*)zero_point, (float*)y, B, H, W, C, HO, WO, kh, kw,
        stride, ph, pw);
  }
  return (int)cudaGetLastError();
}

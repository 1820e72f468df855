// Bilinear glimpse gather for the separable spatial transformer, sm_90a.
//
// Replaces attend_infer_repeat_tpu/ops/pallas_st.py:_gather_kernel (with
// its hat weights from _axis_weights_in_kernel).  That kernel builds the
// dense per-example weight matrices W_y (h x H) and W_x (w x W) and runs
// out = W_y . img . W_x^T as two small matmuls.  Each row of W_y and W_x
// holds at most two nonzero hat weights max(1 - |p - q|, 0), at
// q0 = floor(p) and q0 + 1, so the same function is a 2x2-tap bilinear
// sample with zero padding.  This kernel computes it in that tap form.
//
// What bounds it on the card: memory.  A 50x50 -> 20x20 gather over 8192
// examples moves at most ~95 MB (each input read once, each output written
// once); it reads only the input pixels its nonzero taps touch, so a small
// window moves less.  It needs ~0.1 GFLOP in tap form; the dense form
// would need ~140 kFLOP per example (~1.1 GFLOP), which on CUDA cores is
// close to the memory time.  The tap form keeps the arithmetic far below that.
//
// Design: one block per example.  The block first computes the two taps
// of every output row and every output column (h + w coordinates, not
// h * w) into shared memory; then its threads sweep the output pixels in
// order, each reading its row and column taps, four pixels through the
// read-only cache, and writing one float.  Neighbouring threads own
// neighbouring output pixels, so stores coalesce.  Index arithmetic is
// 32-bit within an example.
//
// Numerics follow the Pallas kernel: coordinates and hat weights in f32
// with the same operation order (no FMA contraction), accumulation in f32
// rows first, then columns, each output's two products summed in tap
// order.  A dense f32 product that sums in index order (its other
// weights add exact zeros) then gives the same bits.  In bf16 mode the pixels and weights are rounded to bf16
// before the products, and so is the row-pass intermediate, as the
// Pallas kernel rounds its first dot's result before the second.
//
// Coordinates are range-checked in float before floor(p) becomes an int
// (st_taps.cuh).  A row or column whose p lies outside (-1, in) has no
// nonzero weight and yields exactly 0; a NaN coordinate yields NaN, as
// the dense form does.

#include <cstdint>

#include "st_taps.cuh"

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float pixel(const float* __restrict__ img, int y,
                                       int x, int in_w, float w, bool bf16) {
  if (w == 0.0f) return 0.0f;                // also skips taps out of range
  const float v = __ldg(img + y * in_w + x);
  return bf16 ? round_bf16(v) : v;
}

__global__ void __launch_bounds__(kThreads)
st_gather_kernel(const float* __restrict__ img, const float* __restrict__ zw,
                 float* __restrict__ out, int in_h, int in_w, int out_h,
                 int out_w, bool bf16) {
  extern __shared__ Taps taps[];             // out_h rows, then out_w columns
  const int64_t b = blockIdx.x;
  const float* __restrict__ z = zw + 4 * b;  // sx, sy, tx, ty
  for (int r = threadIdx.x; r < out_h + out_w; r += kThreads) {
    const bool row = r < out_h;
    const float p = row ? source_coord(__ldg(z + 1), __ldg(z + 3),
                                       axis_u(r, out_h), in_h)
                        : source_coord(__ldg(z + 0), __ldg(z + 2),
                                       axis_u(r - out_h, out_w), in_w);
    taps[r] = axis_taps(p, row ? in_h : in_w, bf16);
  }
  __syncthreads();

  const float* __restrict__ src = img + b * in_h * in_w;
  float* __restrict__ dst = out + b * out_h * out_w;
  for (int pix = threadIdx.x; pix < out_h * out_w; pix += kThreads) {
    const int i = pix / out_w;
    const Taps ty = taps[i];
    const Taps tx = taps[out_h + pix - i * out_w];
    if (ty.q0 == kNaN || tx.q0 == kNaN) {
      dst[pix] = __int_as_float(0x7fc00000);
      continue;
    }
    // Row pass for the two columns the pixel needs, then the column pass.
    float col[2];
    for (int c = 0; c < 2; ++c) {
      const int x = tx.q0 + c;
      float acc = 0.0f;
      if ((c ? tx.w1 : tx.w0) != 0.0f) {
        acc = __fmaf_rn(ty.w0, pixel(src, ty.q0, x, in_w, ty.w0, bf16), acc);
        acc = __fmaf_rn(ty.w1, pixel(src, ty.q0 + 1, x, in_w, ty.w1, bf16),
                        acc);
      }
      col[c] = bf16 ? round_bf16(acc) : acc;
    }
    dst[pix] = __fmaf_rn(tx.w1, col[1], __fmul_rn(tx.w0, col[0]));
  }
}

}  // namespace

// img (n, in_h, in_w), zw (n, 4) and out (n, out_h, out_w): contiguous
// float32 device pointers, n < 2^31.  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() after the launch.
extern "C" int st_gather(const void* img, const void* zw, void* out,
                         long long n, int in_h, int in_w, int out_h,
                         int out_w, int bf16, void* stream) {
  if (n <= 0 || out_h <= 0 || out_w <= 0) return 0;
  const size_t smem = sizeof(Taps) * static_cast<size_t>(out_h + out_w);
  st_gather_kernel<<<static_cast<unsigned>(n), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const float*>(zw),
      static_cast<float*>(out), in_h, in_w, out_h, out_w, bf16 != 0);
  return static_cast<int>(cudaGetLastError());
}

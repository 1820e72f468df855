// Row and column taps of the separable bilinear spatial transformer,
// shared by the gather (st_gather.cu) and its backward (st_gather_bwd.cu),
// and the scan both make for non-finite inputs.
//
// An output row (or column) k samples the input axis at
// p = ((scale * u + shift) + 1) * (in - 1) / 2, u = 2k / (out - 1) - 1.
// Its dense weight row max(1 - |p - q|, 0) has at most two nonzero
// entries, at q0 = floor(p) and q0 + 1; they are formed here as the dense
// form forms them, in the same f32 operation order, so that the tap form
// and a dense product agree bit for bit where the dense product sums in
// index order.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kNaN = INT_MIN;                // tap index marking a NaN coord

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// x rounded to bf16 in bf16 mode, x itself in f32 mode.
template <bool kBf16>
__device__ __forceinline__ float rnd(float x) {
  return kBf16 ? round_bf16(x) : x;
}

// Whether x, rounded as the mode rounds it, is NaN or infinite.
template <bool kBf16>
__device__ __forceinline__ bool nonfinite(float x) {
  return !isfinite(rnd<kBf16>(x));
}

// Whether any of the n floats at p is non-finite in the mode.  Each of
// the block's kThreads threads reads a strided share, 16 bytes a load
// where vec says p is 16-byte aligned and n a multiple of 4.
template <bool kBf16, int kThreads>
__device__ __forceinline__ bool any_nonfinite(const float* __restrict__ p,
                                              int n, bool vec) {
  bool bad = false;
  if (vec) {
    const float4* __restrict__ p4 = reinterpret_cast<const float4*>(p);
#pragma unroll 4
    for (int q = threadIdx.x; q < n / 4; q += kThreads) {
      const float4 v = __ldg(p4 + q);
      bad |= nonfinite<kBf16>(v.x) | nonfinite<kBf16>(v.y) |
             nonfinite<kBf16>(v.z) | nonfinite<kBf16>(v.w);
    }
  } else {
#pragma unroll 4
    for (int q = threadIdx.x; q < n; q += kThreads) {
      bad |= nonfinite<kBf16>(__ldg(p + q));
    }
  }
  return bad;
}

// Normalized coordinate u = 2k / (out - 1) - 1 of output index k.
__device__ __forceinline__ float axis_u(int k, int out_size) {
  const float denom = static_cast<float>(out_size > 1 ? out_size - 1 : 1);
  return __fsub_rn(__fdiv_rn(__fmul_rn(2.0f, static_cast<float>(k)), denom),
                   1.0f);
}

// Source coordinate, in input pixels, of normalized coordinate u.  The
// dense form divides by 2; x * 0.5 is the same correctly rounded value.
__device__ __forceinline__ float source_coord(float scale, float shift,
                                              float u, int in_size) {
  const float src = __fadd_rn(__fmul_rn(scale, u), shift);
  return __fmul_rn(__fmul_rn(__fadd_rn(src, 1.0f),
                             static_cast<float>(in_size - 1)), 0.5f);
}

// The two taps of one output row or column: index q0 of the first, and
// the hat weights of q0 and q0 + 1, zeroed where a tap falls outside
// [0, in).
struct Taps {
  int q0;
  float w0, w1;
};

// Coordinates are range-checked in float before floor(p) becomes an int:
// after invert_where's eps guard a near-zero scale gives |p| ~ 1e7, which
// would saturate the conversion.  A p outside (-1, in) has no nonzero
// weight; a NaN p is marked with q0 = kNaN.
__device__ __forceinline__ Taps axis_taps(float p, int in_size, bool bf16) {
  Taps t{0, 0.0f, 0.0f};
  if (p != p) {
    t.q0 = kNaN;
    return t;
  }
  if (!(p > -1.0f && p < static_cast<float>(in_size))) return t;
  const float fl = floorf(p);
  t.q0 = static_cast<int>(fl);               // in [-1, in - 1]
  // 1 - |p - q| for q = q0 and q0 + 1, rounded as the dense form rounds
  // it (1 - (1 - frac) is not always frac in f32)
  const float w0 = __fsub_rn(1.0f, fabsf(__fsub_rn(p, fl)));
  const float w1 = __fsub_rn(1.0f, fabsf(__fsub_rn(p, __fadd_rn(fl, 1.0f))));
  t.w0 = (t.q0 >= 0) ? w0 : 0.0f;
  t.w1 = (t.q0 + 1 < in_size) ? w1 : 0.0f;
  if (bf16) {
    t.w0 = round_bf16(t.w0);
    t.w1 = round_bf16(t.w1);
  }
  return t;
}

}  // namespace

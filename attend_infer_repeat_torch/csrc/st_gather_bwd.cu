// Backward of the bilinear glimpse gather (the spatial transformer's VJP),
// sm_90a.
//
// Replaces attend_infer_repeat_tpu/ops/pallas_st.py:_gather_bwd_kernel
// (line 155; the custom_vjp backward of st_gather_pallas, with its weights
// and their derivatives from _axis_weights_and_dp).  That kernel rebuilds
// the dense per-example weights W_y (h x H), W_x (w x W) and dW/dp, and
// runs five small matmuls:
//   g_img = W_y^T . g . W_x
//   d_sy = cy sum_i u_i gy_i,  d_ty = cy sum_i gy_i,
//   gy_i = sum_j dW_y[i,j] sum_k g[i,k] (img . W_x^T)[j,k]
// and likewise in x with tmp = W_y . img, cy = (in_h - 1) / 2.
// Each row of W and dW/dp has at most two nonzero entries (taps q0 and
// q0 + 1, st_taps.cuh), so this kernel computes the same function in tap
// form: each output pixel (i, k) touches four input pixels.
//
// What bounds it on the card: memory.  Its sums need the input pixels its
// taps touch, the cotangent g at the output pixels that have a tap, and
// zw, and it writes g_img and g_zw once; the check for non-finite inputs
// (below) reads all of img and g once.  The arithmetic is a few
// multiply-adds per tap pair, far under the CUDA-core rate.  In practice
// a block's latency
// bounds it: at N = 1024 the grid is one wave, and at N = 8192 a few
// waves of the same chain (zw, taps, a round trip for g and img, the sums,
// the writes).  So the designs below shorten that chain and do no work on
// pixels that need none.
//
// Two designs, chosen by shape; both one block per example, every sum in
// a fixed order, no atomics on floats (the kernel is deterministic):
//
// The live rectangle (st_gather_bwd_kernel), for pastes (more output
// pixels than input pixels).  On the train step's windows (scale <= 0.45)
// a paste's backward needs 2-4 % of its g; the dense design read all of it
// twice.
//   1. The h + w row and column taps, with dw/dp and u, into shared
//      memory.  Each axis's live interval (first and last output row or
//      column with a nonzero weight or dw/dp), the input rows and columns
//      their taps touch, and for each input row (column) the interval of
//      output rows (columns) whose nonzero weights reach it: integer
//      min/max, by warp reductions then shared atomics.  p and q0 are
//      monotone in the output index, so each of these is an interval,
//      negative scales included.
//   2. g on live rows x live columns and img on the touched rectangle,
//      copied once into shared memory; nothing else is read.
//   3. One warp per live output row forms, per pixel,
//      A = sum_a dwy_a sum_b wx_b img[qa, qb] and
//      B = sum_b dwx_b sum_a wy_a img[qa, qb]; gy_i = sum_k g A by a
//      shuffle tree, and each lane keeps its columns' taps and sums of
//      g B over the warp's rows in registers (per-warp gx partials).  With
//      g_img: t2[j, k] = sum_i wy[i, j] g[i, k], one thread per (touched
//      input row, live column), over the rows that reach j, in order.
//   4. The last warp sums the gx partials in warp order and forms the four
//      zw gradients; all threads form g_img[j, l] = sum_k t2[j, k] wx[k, l]
//      over the columns that reach l, in order, and write all of g_img
//      with 16-byte stores, zeros where no tap reaches.
//   Shared memory at the step's shape (20x20 -> 50x50): 19 KB.
//
// The dense design (st_gather_bwd_dense_kernel), for gathers (at most as
// many output pixels as input pixels), where most of g is live: one pass
// over every output pixel (g A and g B per pixel in shared memory; g read
// only where the pixel is live), gy per row and gx per column by one
// thread each, in order, and the zw sums by one warp; g_img by two
// scatter passes through shared memory, one thread per output column,
// then one per input row (5 KB of shared memory for the step's
// 50x50 -> 20x20 with g_zw only).  On an H100 the live-rectangle design
// was slower than this one on gather shapes and 2.5-4.5x faster on
// pastes (PERF.md, section 6).
//
// When the caller passes no g_img pointer (the gather of the data image,
// whose gradient nobody needs), g_img's passes and write are skipped and
// only g_zw is computed.
//
// Numerics: f32 accumulation throughout.  In bf16 mode the operands of
// each of the Pallas kernel's five products are rounded to bf16 as its
// dot() rounds them: pixels, hat weights and g; the intermediates
// img . W_x^T and W_y . img (before the products with dW/dp) and t2.
// dW/dp is -1, 0 or 1, exact in bf16.  A coordinate outside (-1, in)
// gives exactly 0 in both outputs.  A NaN coordinate gives NaN where the
// dense form gives it: all of g_img; the x gradients for a NaN row
// coordinate, the y gradients for a NaN column coordinate.
//
// Non-finite inputs: the dense form multiplies every entry of img and g
// by weights, zero ones included, so one NaN or infinity spreads through
// 0 * inf and 0 * NaN into outputs the taps never reach.  Both designs
// use img and g only where a tap is live.  So each block first reads its
// whole img and g (16-byte loads) only to OR a flag: an entry that is NaN
// or infinite as the mode rounds it.  A finite example takes the designs
// above, whose bits do not change.  A flagged one takes
// gather_bwd_nonfinite, which computes the dense form's five products
// literally on its dense weights (rounded as in bf16 mode), so every
// output is NaN, +-inf or finite where the dense form's is: slow, and
// only ever run on a non-finite example.

#include <climits>
#include <cstdint>

#include "st_taps.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// One output row or column: its taps, dw/dp of each tap, and u.
struct TapsDp {
  Taps t;
  float d0, d1;
  float u;
};

// d(max(1 - |d|, 0))/dp = -sign(d) where |d| < 1, else 0, for d = p - q.
__device__ __forceinline__ float hat_dp(float d) {
  if (!(fabsf(d) < 1.0f)) return 0.0f;
  return d > 0.0f ? -1.0f : (d < 0.0f ? 1.0f : 0.0f);
}

template <bool kBf16>
__device__ __forceinline__ TapsDp axis_taps_dp(float scale, float shift,
                                               int k, int out_size,
                                               int in_size) {
  TapsDp r;
  r.u = axis_u(k, out_size);
  const float p = source_coord(scale, shift, r.u, in_size);
  r.t = axis_taps(p, in_size, kBf16);
  r.d0 = 0.0f;
  r.d1 = 0.0f;
  if (r.t.q0 != kNaN && p > -1.0f && p < static_cast<float>(in_size)) {
    const float fl = floorf(p);
    if (r.t.q0 >= 0) r.d0 = hat_dp(__fsub_rn(p, fl));
    if (r.t.q0 + 1 < in_size) r.d1 = hat_dp(__fsub_rn(p, __fadd_rn(fl, 1.0f)));
  }
  return r;
}

// A tap with a zero weight and a zero derivative adds nothing; taps
// outside [0, in) are always such, so a dead tap's pixel is never read.
__device__ __forceinline__ bool live(float w, float d) {
  return w != 0.0f || d != 0.0f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The weight of tap index j in taps t (0 unless j is q0 or q0 + 1).
__device__ __forceinline__ float weight_at(const Taps& t, int j) {
  return t.q0 == j ? t.w0 : (t.q0 + 1 == j ? t.w1 : 0.0f);
}

// Copies rows x cols of a row-major array with row stride ld into shared
// memory with row stride cols: a warp takes rows, a lane columns, and each
// thread issues up to kB loads before it stores any.
__device__ __forceinline__ void copy_block(float* dst, const float* src,
                                           int ld, int rows, int cols,
                                           int warp, int lane) {
  constexpr int kB = 8;
  for (int c = lane; c < cols; c += 32) {
    for (int r0 = warp; r0 < rows; r0 += kB * kWarps) {
      float v[kB];
#pragma unroll
      for (int u = 0; u < kB; ++u) {
        const int r = r0 + u * kWarps;
        if (r < rows) v[u] = __ldg(src + r * ld + c);
      }
#pragma unroll
      for (int u = 0; u < kB; ++u) {
        const int r = r0 + u * kWarps;
        if (r < rows) dst[r * cols + c] = v[u];
      }
    }
  }
}

// The taps' share of shared memory, in 16-byte units.
__host__ __device__ __forceinline__ int taps_float4s(int n_taps) {
  return (n_taps * static_cast<int>(sizeof(TapsDp)) + 15) / 16;
}

// Indices into the block's table `lim`: [lo, hi] pairs, then flags.
enum {
  kRows = 0, kCols = 2, kInRows = 4, kInCols = 6, kNanRow = 8, kNanCol = 9,
  kLim = 10
};

// The weight and dW/dp of the dense form at tap index j of taps t (NaN
// weights and zero dW/dp on a NaN coordinate, as the dense form has).
__device__ __forceinline__ float dense_w(const TapsDp& t, int j) {
  return t.t.q0 == kNaN ? __int_as_float(0x7fc00000) : weight_at(t.t, j);
}

__device__ __forceinline__ float dense_dw(const TapsDp& t, int j) {
  return t.t.q0 == j ? t.d0 : (t.t.q0 + 1 == j ? t.d1 : 0.0f);
}

// Floats of shared memory gather_bwd_nonfinite needs after the taps: one
// (out_h x in_w) or (in_h x out_w) product at a time, then each output row
// and column's two tap terms and a flag.
__host__ __device__ __forceinline__ int nonfinite_floats(int in_h, int in_w,
                                                         int out_h,
                                                         int out_w) {
  const int a = out_h * in_w, b = in_h * out_w;
  return (a > b ? a : b) + 3 * (out_h + out_w);
}

// The backward of an example whose img or g holds a NaN or an infinity:
// the dense form's five products, literally (see the header), in the
// block's shared memory buf (nonfinite_floats).  src, g, gimg (null when
// not asked for) and gzw point at the example's own rows.
template <bool kBf16>
__device__ __noinline__ void gather_bwd_nonfinite(
    const float* __restrict__ src, const float* __restrict__ g,
    float* __restrict__ gimg, float* __restrict__ gzw,
    const TapsDp* __restrict__ taps, float* __restrict__ buf, int in_h,
    int in_w, int out_h, int out_w) {
  const int tid = threadIdx.x;
  const TapsDp* __restrict__ ty = taps;
  const TapsDp* __restrict__ tx = taps + out_h;
  const int n_buf = nonfinite_floats(in_h, in_w, out_h, out_w)
      - 3 * (out_h + out_w);
  float* __restrict__ term_x = buf + n_buf;          // 2 per output column
  float* __restrict__ term_y = term_x + 2 * out_w;   // 2 per output row
  int* __restrict__ flag_x = reinterpret_cast<int*>(term_y + 2 * out_h);
  int* __restrict__ flag_y = flag_x + out_w;
  const float nan = __int_as_float(0x7fc00000);

  // tmp = W_y . img (out_h x in_w)
  for (int idx = tid; idx < out_h * in_w; idx += kThreads) {
    const int i = idx / in_w, l = idx - i * in_w;
    float acc = 0.0f;
    for (int j = 0; j < in_h; ++j) {
      acc = __fmaf_rn(rnd<kBf16>(dense_w(ty[i], j)),
                      rnd<kBf16>(src[j * in_w + l]), acc);
    }
    buf[idx] = acc;
  }
  for (int idx = tid; idx < 3 * (out_h + out_w); idx += kThreads) {
    term_x[idx] = 0.0f;                      // the terms, then the flags
  }
  __syncthreads();
  // gxw[k] = sum_l dwx[k, l] (g^T . tmp)[k, l]: the terms of the two taps,
  // and a flag where a non-finite product meets dW/dp = 0 elsewhere
  for (int idx = tid; idx < out_w * in_w; idx += kThreads) {
    const int k = idx / in_w, l = idx - k * in_w;
    float acc = 0.0f;
    for (int i = 0; i < out_h; ++i) {
      acc = __fmaf_rn(rnd<kBf16>(g[i * out_w + k]),
                      rnd<kBf16>(buf[i * in_w + l]), acc);
    }
    const int q0 = tx[k].t.q0;
    if (l == q0 || l == q0 + 1) {
      term_x[2 * k + (l - q0)] = dense_dw(tx[k], l) * acc;
    } else if (!isfinite(acc)) {
      flag_x[k] = 1;
    }
  }
  __syncthreads();
  // gx = img . W_x^T (in_h x out_w)
  for (int idx = tid; idx < in_h * out_w; idx += kThreads) {
    const int j = idx / out_w, k = idx - j * out_w;
    float acc = 0.0f;
    for (int l = 0; l < in_w; ++l) {
      acc = __fmaf_rn(rnd<kBf16>(src[j * in_w + l]),
                      rnd<kBf16>(dense_w(tx[k], l)), acc);
    }
    buf[idx] = acc;
  }
  __syncthreads();
  // gy[i] = sum_j dwy[i, j] (g . gx^T)[i, j], as gxw
  for (int idx = tid; idx < out_h * in_h; idx += kThreads) {
    const int i = idx / in_h, j = idx - i * in_h;
    float acc = 0.0f;
    for (int k = 0; k < out_w; ++k) {
      acc = __fmaf_rn(rnd<kBf16>(g[i * out_w + k]),
                      rnd<kBf16>(buf[j * out_w + k]), acc);
    }
    const int q0 = ty[i].t.q0;
    if (j == q0 || j == q0 + 1) {
      term_y[2 * i + (j - q0)] = dense_dw(ty[i], j) * acc;
    } else if (!isfinite(acc)) {
      flag_y[i] = 1;
    }
  }
  __syncthreads();
  if (tid < 32) {
    float sx_u = 0.0f, sx = 0.0f, sy_u = 0.0f, sy = 0.0f;
    for (int k = tid; k < out_w; k += 32) {
      const float gxw = flag_x[k] ? nan : term_x[2 * k] + term_x[2 * k + 1];
      sx_u = __fmaf_rn(gxw, tx[k].u, sx_u);
      sx += gxw;
    }
    for (int i = tid; i < out_h; i += 32) {
      const float gy = flag_y[i] ? nan : term_y[2 * i] + term_y[2 * i + 1];
      sy_u = __fmaf_rn(gy, ty[i].u, sy_u);
      sy += gy;
    }
    sx_u = warp_sum(sx_u);
    sx = warp_sum(sx);
    sy_u = warp_sum(sy_u);
    sy = warp_sum(sy);
    if (tid == 0) {
      const float cy = 0.5f * static_cast<float>(in_h - 1);
      const float cx = 0.5f * static_cast<float>(in_w - 1);
      gzw[0] = sx_u * cx;
      gzw[1] = sy_u * cy;
      gzw[2] = sx * cx;
      gzw[3] = sy * cy;
    }
  }
  if (gimg == nullptr) return;
  // g_img = (W_y^T . g) . W_x: t2 (in_h x out_w), then g_img
  for (int idx = tid; idx < in_h * out_w; idx += kThreads) {
    const int j = idx / out_w, k = idx - j * out_w;
    float acc = 0.0f;
    for (int i = 0; i < out_h; ++i) {
      acc = __fmaf_rn(rnd<kBf16>(dense_w(ty[i], j)),
                      rnd<kBf16>(g[i * out_w + k]), acc);
    }
    buf[idx] = acc;
  }
  __syncthreads();
  for (int idx = tid; idx < in_h * in_w; idx += kThreads) {
    const int j = idx / in_w, l = idx - j * in_w;
    float acc = 0.0f;
    for (int k = 0; k < out_w; ++k) {
      acc = __fmaf_rn(rnd<kBf16>(buf[j * out_w + k]),
                      rnd<kBf16>(dense_w(tx[k], l)), acc);
    }
    gimg[idx] = acc;
  }
}

// Dynamic shared memory of one block, in floats after the taps.
struct Layout {
  int gs, ims, gy, gxp, t2, reach, floats;
  __host__ __device__ Layout(int in_h, int in_w, int out_h, int out_w,
                             bool with_gimg) {
    gs = 0;                                  // g, live rectangle
    ims = gs + out_h * out_w;                // img, touched rectangle
    gy = ims + in_h * in_w;                  // gy per live row
    gxp = gy + out_h;                        // gx partials, per warp
    t2 = gxp + kWarps * out_w;               // (touched rows, live cols)
    reach = t2 + (with_gimg ? in_h * out_w : 0);
    floats = reach + (with_gimg ? 2 * (in_h + in_w) : 0);   // int pairs
  }
};

// One live column's terms, kept in a lane's registers for all rows.
struct Col {
  bool l0, l1;                               // tap live (weight or dw/dp)
  float w0, w1, d0, d1;
  int off;                                   // q0 - first touched column
};

// kIndexed (with no gimg): example b's image is src_index[b] of img, as
// in the indexed gather.  Without it the kernel reads no index.
template <bool kBf16, bool kIndexed>
__global__ void __launch_bounds__(kThreads)
st_gather_bwd_kernel(const float* __restrict__ img,
                     const float* __restrict__ zw,
                     const float* __restrict__ g, float* __restrict__ gimg,
                     float* __restrict__ gzw, int in_h, int in_w, int out_h,
                     int out_w, int vec, const int* __restrict__ src_index) {
  extern __shared__ float4 smem4[];
  const bool with_img = gimg != nullptr;
  const Layout lay(in_h, in_w, out_h, out_w, with_img);
  TapsDp* taps = reinterpret_cast<TapsDp*>(smem4);   // rows, then columns
  float* fl = reinterpret_cast<float*>(smem4 + taps_float4s(out_h + out_w));
  float* gs = fl + lay.gs;
  float* ims = fl + lay.ims;
  float* gy = fl + lay.gy;
  float* gxp = fl + lay.gxp;
  float* t2 = fl + lay.t2;
  // per input row, then per input column: [lo, hi] of the output rows
  // (columns) whose nonzero weights reach it
  int* reach = reinterpret_cast<int*>(fl + lay.reach);
  __shared__ int lim[kLim];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t b = blockIdx.x;
  const float* __restrict__ z = zw + 4 * b;          // sx, sy, tx, ty
  const float scale_x = __ldg(z + 0), scale_y = __ldg(z + 1);
  const float shift_x = __ldg(z + 2), shift_y = __ldg(z + 3);
  if (tid < kLim) lim[tid] = tid >= kNanRow ? 0 : (tid & 1) ? -1 : INT_MAX;
  if (with_img) {
    for (int idx = tid; idx < 2 * (in_h + in_w); idx += kThreads) {
      reach[idx] = (idx & 1) ? -1 : INT_MAX;
    }
  }
  __syncthreads();
  int64_t image = b;
  if constexpr (kIndexed) image = __ldg(src_index + b);
  const float* __restrict__ src = img + image * in_h * in_w;
  const float* __restrict__ gg = g + b * out_h * out_w;
  const bool bad =
      any_nonfinite<kBf16, kThreads>(src, in_h * in_w, vec & 1) ||
      any_nonfinite<kBf16, kThreads>(gg, out_h * out_w, vec & 2);

  // 1. taps, live intervals, touched input, reach
  bool nan_row = false, nan_col = false;
  // this thread's part of lim: live rows, live columns, touched input rows
  // and columns, each [lo, hi]
  int row_lo = INT_MAX, row_hi = -1, col_lo = INT_MAX, col_hi = -1;
  int in_row_lo = INT_MAX, in_row_hi = -1, in_col_lo = INT_MAX, in_col_hi = -1;
  for (int r = tid; r < out_h + out_w; r += kThreads) {
    const bool row = r < out_h;
    const int k = row ? r : r - out_h;
    const TapsDp t = row
        ? axis_taps_dp<kBf16>(scale_y, shift_y, k, out_h, in_h)
        : axis_taps_dp<kBf16>(scale_x, shift_x, k, out_w, in_w);
    taps[r] = t;
    if (t.t.q0 == kNaN) {                   // its weights and dw/dp are 0
      nan_row |= row;
      nan_col |= !row;
      continue;
    }
    const bool l0 = live(t.t.w0, t.d0), l1 = live(t.t.w1, t.d1);
    const int q_lo = l0 ? t.t.q0 : t.t.q0 + 1, q_hi = l1 ? t.t.q0 + 1 : t.t.q0;
    if (row && (l0 || l1)) {
      row_lo = min(row_lo, k);
      row_hi = max(row_hi, k);
      in_row_lo = min(in_row_lo, q_lo);
      in_row_hi = max(in_row_hi, q_hi);
    } else if (l0 || l1) {
      col_lo = min(col_lo, k);
      col_hi = max(col_hi, k);
      in_col_lo = min(in_col_lo, q_lo);
      in_col_hi = max(in_col_hi, q_hi);
    }
    if (with_img) {
      int* rc = reach + (row ? 0 : 2 * in_h);
      if (t.t.w0 != 0.0f) {
        atomicMin(rc + 2 * t.t.q0, k);
        atomicMax(rc + 2 * t.t.q0 + 1, k);
      }
      if (t.t.w1 != 0.0f) {
        atomicMin(rc + 2 * (t.t.q0 + 1), k);
        atomicMax(rc + 2 * (t.t.q0 + 1) + 1, k);
      }
    }
  }
  const int mine[8] = {row_lo, row_hi, col_lo, col_hi,
                       in_row_lo, in_row_hi, in_col_lo, in_col_hi};
#pragma unroll
  for (int e = 0; e < 8; e += 2) {           // the warp's, then the block's
    const int lo = __reduce_min_sync(0xffffffffu, mine[e]);
    const int hi = __reduce_max_sync(0xffffffffu, mine[e + 1]);
    if (lane == 0) {
      atomicMin(lim + e, lo);
      atomicMax(lim + e + 1, hi);
    }
  }
  const bool warp_nan_row = __any_sync(0xffffffffu, nan_row);
  const bool warp_nan_col = __any_sync(0xffffffffu, nan_col);
  if (lane == 0 && warp_nan_row) lim[kNanRow] = 1;
  if (lane == 0 && warp_nan_col) lim[kNanCol] = 1;
  if (__syncthreads_or(bad)) {
    gather_bwd_nonfinite<kBf16>(src, gg, with_img ? gimg + b * in_h * in_w
                                                  : nullptr,
                                gzw + 4 * b, taps, fl, in_h, in_w, out_h,
                                out_w);
    return;
  }

  // the live rectangle of g and the touched rectangle of img
  int nr = lim[kRows + 1] - lim[kRows] + 1;
  int nc = lim[kCols + 1] - lim[kCols] + 1;
  if (nr <= 0 || nc <= 0) nr = nc = 0;
  const int r_lo = lim[kRows], c_lo = lim[kCols];
  const int j_lo = lim[kInRows], l_lo = lim[kInCols];
  const int nj = nr ? lim[kInRows + 1] - j_lo + 1 : 0;
  const int nl = nr ? lim[kInCols + 1] - l_lo + 1 : 0;
  const bool any_nan_row = lim[kNanRow], any_nan_col = lim[kNanCol];

  // 2. read g and img there, once (rounded to bf16 where they are used)
  if (nr) {
    copy_block(gs, gg + r_lo * out_w + c_lo, out_w, nr, nc, warp, lane);
    copy_block(ims, src + j_lo * in_w + l_lo, in_w, nj, nl, warp, lane);
  }
  __syncthreads();

  // 3a. gy per live row (a warp a row), gx partials per warp; a lane
  //     keeps its two columns' taps and gx sums in registers.
  for (int k0 = 0; k0 < nc; k0 += 64) {
    Col col[2];
    float gx[2] = {0.0f, 0.0f};
    bool on[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int kk = k0 + lane + 32 * s;
      on[s] = kk < nc;
      const TapsDp tx = taps[out_h + c_lo + (on[s] ? kk : 0)];
      col[s] = {live(tx.t.w0, tx.d0), live(tx.t.w1, tx.d1), tx.t.w0,
                tx.t.w1, tx.d0, tx.d1, tx.t.q0 - l_lo};
    }
    for (int ii = warp; ii < nr; ii += kWarps) {
      const TapsDp ty = taps[r_lo + ii];
      const bool ly[2] = {live(ty.t.w0, ty.d0), live(ty.t.w1, ty.d1)};
      const float wy[2] = {ty.t.w0, ty.t.w1}, dy[2] = {ty.d0, ty.d1};
      const float* im0 = ims + (ty.t.q0 - j_lo) * nl;   // used where live
      float row_sum = 0.0f;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        if (!on[s]) continue;
        const Col& c = col[s];
        const bool lx[2] = {c.l0, c.l1};
        const float wx[2] = {c.w0, c.w1}, dx[2] = {c.d0, c.d1};
        float v[2][2];
#pragma unroll
        for (int a = 0; a < 2; ++a) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            v[a][e] = (ly[a] && lx[e])
                ? rnd<kBf16>(im0[a * nl + c.off + e]) : 0.0f;
          }
        }
        float a_sum = 0.0f, b_sum = 0.0f;
#pragma unroll
        for (int a = 0; a < 2; ++a) {         // (img . W_x^T)[qa, k]
          const float cp = rnd<kBf16>(
              __fmaf_rn(wx[1], v[a][1], __fmul_rn(wx[0], v[a][0])));
          a_sum = __fmaf_rn(dy[a], cp, a_sum);
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {         // (W_y . img)[i, qe]
          const float rp = rnd<kBf16>(
              __fmaf_rn(wy[1], v[1][e], __fmul_rn(wy[0], v[0][e])));
          b_sum = __fmaf_rn(dx[e], rp, b_sum);
        }
        const float gv = rnd<kBf16>(gs[ii * nc + k0 + lane + 32 * s]);
        row_sum += gv * a_sum;
        gx[s] += gv * b_sum;
      }
      row_sum = warp_sum(row_sum);
      if (lane == 0) gy[ii] = k0 ? gy[ii] + row_sum : row_sum;
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (on[s]) gxp[warp * out_w + k0 + lane + 32 * s] = gx[s];
    }
  }

  // 3b. t2[j, k] = sum_i wy[i, j] g[i, k] over the rows that reach j
  if (with_img) {
    for (int idx = tid; idx < nj * nc; idx += kThreads) {
      const int jj = idx / nc, kk = idx - jj * nc, j = j_lo + jj;
      float acc = 0.0f;
      for (int i = reach[2 * j]; i <= reach[2 * j + 1]; ++i) {
        const float w = weight_at(taps[i].t, j);
        if (w != 0.0f) {
          acc = __fmaf_rn(w, rnd<kBf16>(gs[(i - r_lo) * nc + kk]), acc);
        }
      }
      t2[idx] = rnd<kBf16>(acc);
    }
  }
  __syncthreads();
  const bool nan_img = any_nan_row || any_nan_col;

  // 4a. the zw gradients through dp/dscale = u (in - 1) / 2 and
  //     dp/dshift = (in - 1) / 2, by the last warp
  if (warp == kWarps - 1) {
    float sx_u = 0.0f, sx = 0.0f, sy_u = 0.0f, sy = 0.0f;
    for (int kk = lane; kk < nc; kk += 32) {
      float gx = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) gx += gxp[w * out_w + kk];
      sx_u = __fmaf_rn(gx, taps[out_h + c_lo + kk].u, sx_u);
      sx += gx;
    }
    for (int ii = lane; ii < nr; ii += 32) {
      sy_u = __fmaf_rn(gy[ii], taps[r_lo + ii].u, sy_u);
      sy += gy[ii];
    }
    sx_u = warp_sum(sx_u);
    sx = warp_sum(sx);
    sy_u = warp_sum(sy_u);
    sy = warp_sum(sy);
    if (lane == 0) {
      const float cy = 0.5f * static_cast<float>(in_h - 1);
      const float cx = 0.5f * static_cast<float>(in_w - 1);
      const float nan = __int_as_float(0x7fc00000);
      gzw[4 * b + 0] = any_nan_row ? nan : sx_u * cx;    // d_sx
      gzw[4 * b + 1] = any_nan_col ? nan : sy_u * cy;    // d_sy
      gzw[4 * b + 2] = any_nan_row ? nan : sx * cx;      // d_tx
      gzw[4 * b + 3] = any_nan_col ? nan : sy * cy;      // d_ty
    }
  }

  // 4b. g_img[j, l] = sum_k t2[j, k] wx[k, l] over the columns that reach l
  if (!with_img) return;
  const int* reach_x = reach + 2 * in_h;
  auto value = [&](int j, int l) -> float {
    if (nan_img) return __int_as_float(0x7fc00000);
    const int jj = j - j_lo;
    if (jj < 0 || jj >= nj) return 0.0f;
    float acc = 0.0f;
    for (int k = reach_x[2 * l]; k <= reach_x[2 * l + 1]; ++k) {
      const float w = weight_at(taps[out_h + k].t, l);
      if (w != 0.0f) acc = __fmaf_rn(w, t2[jj * nc + k - c_lo], acc);
    }
    return acc;
  };
  float* __restrict__ dst = gimg + b * in_h * in_w;
  const int n_in = in_h * in_w;
  if (n_in % 4 == 0) {                       // 16-byte aligned per example
    // (j0, l0): the first of this thread's 4 pixels, stepped without a
    // division
    const int step = 4 * kThreads, dj = step / in_w, dl = step - dj * in_w;
    int j0 = 4 * tid / in_w, l0 = 4 * tid - j0 * in_w;
    for (int q = tid; q < n_in / 4; q += kThreads) {
      int j = j0, l = l0;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = value(j, l);
        if (++l == in_w) {
          l = 0;
          ++j;
        }
      }
      reinterpret_cast<float4*>(dst)[q] = make_float4(v[0], v[1], v[2], v[3]);
      j0 += dj;
      l0 += dl;
      if (l0 >= in_w) {
        l0 -= in_w;
        ++j0;
      }
    }
  } else {
    for (int idx = tid; idx < n_in; idx += kThreads) {
      const int j = idx / in_w;
      dst[idx] = value(j, idx - j * in_w);
    }
  }
}

// The dense design (one pass over every output pixel, then scatter
// passes), for gathers: see the header.
template <bool kBf16, bool kIndexed>
__global__ void __launch_bounds__(kThreads)
st_gather_bwd_dense_kernel(const float* __restrict__ img,
                           const float* __restrict__ zw,
                           const float* __restrict__ g,
                           float* __restrict__ gimg,
                           float* __restrict__ gzw, int in_h, int in_w,
                           int out_h, int out_w, int vec,
                           const int* __restrict__ src_index) {
  extern __shared__ float smem[];
  const int n_taps = out_h + out_w;
  const int n_out = out_h * out_w;
  TapsDp* taps = reinterpret_cast<TapsDp*>(smem);   // rows, then columns
  float* ga = reinterpret_cast<float*>(taps + n_taps);   // g A per pixel
  float* gb = ga + n_out;                                 // g B per pixel
  float* red = gb + n_out;           // gy (out_h), then gx (out_w)
  float* t2 = red + n_taps;          // (in_h, out_w), with g_img only
  float* gi = t2 + in_h * out_w;     // (in_h, in_w), with g_img only
  __shared__ int nan_row, nan_col;

  const int tid = threadIdx.x;
  const int64_t b = blockIdx.x;
  const float* __restrict__ z = zw + 4 * b;          // sx, sy, tx, ty
  int64_t image = b;
  if constexpr (kIndexed) image = __ldg(src_index + b);
  const float* __restrict__ src = img + image * in_h * in_w;
  const float* __restrict__ gg = g + b * n_out;
  if (tid == 0) {
    nan_row = 0;
    nan_col = 0;
  }
  if (gimg != nullptr) {
    for (int idx = tid; idx < in_h * (out_w + in_w); idx += kThreads) {
      t2[idx] = 0.0f;                                 // t2 and gi
    }
  }
  __syncthreads();

  // 1. taps, and the check for non-finite inputs
  const bool bad =
      any_nonfinite<kBf16, kThreads>(src, in_h * in_w, vec & 1) ||
      any_nonfinite<kBf16, kThreads>(gg, n_out, vec & 2);
  for (int r = tid; r < n_taps; r += kThreads) {
    const bool row = r < out_h;
    taps[r] = row ? axis_taps_dp<kBf16>(__ldg(z + 1), __ldg(z + 3), r,
                                        out_h, in_h)
                  : axis_taps_dp<kBf16>(__ldg(z + 0), __ldg(z + 2), r - out_h,
                                        out_w, in_w);
    if (taps[r].t.q0 == kNaN) atomicExch(row ? &nan_row : &nan_col, 1);
  }
  if (__syncthreads_or(bad)) {
    gather_bwd_nonfinite<kBf16>(src, gg, gimg == nullptr ? nullptr
                                         : gimg + b * in_h * in_w,
                                gzw + 4 * b, taps, ga, in_h, in_w, out_h,
                                out_w);
    return;
  }

  // 2. per output pixel: g A and g B; g is read only where the pixel's
  //    row and column are live (a NaN tap is never live)
  for (int pix = tid; pix < n_out; pix += kThreads) {
    const int i = pix / out_w;
    const TapsDp ty = taps[i];
    const TapsDp tx = taps[out_h + pix - i * out_w];
    const bool ly[2] = {live(ty.t.w0, ty.d0), live(ty.t.w1, ty.d1)};
    const bool lx[2] = {live(tx.t.w0, tx.d0), live(tx.t.w1, tx.d1)};
    float gv = 0.0f, a_sum = 0.0f, b_sum = 0.0f;
    if ((ly[0] || ly[1]) && (lx[0] || lx[1])) {
      gv = rnd<kBf16>(__ldg(gg + pix));
      float v[2][2];
      for (int a = 0; a < 2; ++a) {
        for (int c = 0; c < 2; ++c) {
          v[a][c] = 0.0f;
          if (ly[a] && lx[c]) {
            v[a][c] = rnd<kBf16>(
                __ldg(src + (ty.t.q0 + a) * in_w + tx.t.q0 + c));
          }
        }
      }
      const float wy[2] = {ty.t.w0, ty.t.w1}, dy[2] = {ty.d0, ty.d1};
      const float wx[2] = {tx.t.w0, tx.t.w1}, dx[2] = {tx.d0, tx.d1};
      for (int a = 0; a < 2; ++a) {           // (img . W_x^T)[qa, k]
        const float cp = rnd<kBf16>(
            __fmaf_rn(wx[1], v[a][1], __fmul_rn(wx[0], v[a][0])));
        a_sum = __fmaf_rn(dy[a], cp, a_sum);
      }
      for (int c = 0; c < 2; ++c) {           // (W_y . img)[i, qc]
        const float rp = rnd<kBf16>(
            __fmaf_rn(wy[1], v[1][c], __fmul_rn(wy[0], v[0][c])));
        b_sum = __fmaf_rn(dx[c], rp, b_sum);
      }
    }
    ga[pix] = gv * a_sum;
    gb[pix] = gv * b_sum;
  }
  __syncthreads();

  // 3. gy per output row, gx per output column, each summed in order
  for (int r = tid; r < n_taps; r += kThreads) {
    float s = 0.0f;
    if (r < out_h) {
      for (int k = 0; k < out_w; ++k) s += ga[r * out_w + k];
    } else {
      for (int i = 0; i < out_h; ++i) s += gb[i * out_w + r - out_h];
    }
    red[r] = s;
  }

  // 4. g_img = W_y^T . g . W_x, two scatter passes
  if (gimg != nullptr) {
    for (int k = tid; k < out_w; k += kThreads) {
      for (int i = 0; i < out_h; ++i) {
        const Taps ty = taps[i].t;
        if (ty.q0 == kNaN) continue;          // g_img is all NaN then
        const float gv = rnd<kBf16>(__ldg(gg + i * out_w + k));
        if (ty.w0 != 0.0f) {
          t2[ty.q0 * out_w + k] = __fmaf_rn(ty.w0, gv, t2[ty.q0 * out_w + k]);
        }
        if (ty.w1 != 0.0f) {
          t2[(ty.q0 + 1) * out_w + k] =
              __fmaf_rn(ty.w1, gv, t2[(ty.q0 + 1) * out_w + k]);
        }
      }
    }
    __syncthreads();
    for (int j = tid; j < in_h; j += kThreads) {
      float* __restrict__ grow = gi + j * in_w;
      for (int k = 0; k < out_w; ++k) {
        const Taps tx = taps[out_h + k].t;
        if (tx.q0 == kNaN) continue;
        const float v = rnd<kBf16>(t2[j * out_w + k]);
        if (tx.w0 != 0.0f) grow[tx.q0] = __fmaf_rn(tx.w0, v, grow[tx.q0]);
        if (tx.w1 != 0.0f) {
          grow[tx.q0 + 1] = __fmaf_rn(tx.w1, v, grow[tx.q0 + 1]);
        }
      }
    }
    __syncthreads();
    const bool nan = nan_row || nan_col;
    float* __restrict__ dst = gimg + b * in_h * in_w;
    for (int idx = tid; idx < in_h * in_w; idx += kThreads) {
      dst[idx] = nan ? __int_as_float(0x7fc00000) : gi[idx];
    }
  } else {
    __syncthreads();
  }

  // 5. the zw gradients through dp/dscale = u (in - 1) / 2 and
  //    dp/dshift = (in - 1) / 2
  if (tid < 32) {
    float sy_u = 0.0f, sy = 0.0f, sx_u = 0.0f, sx = 0.0f;
    for (int i = tid; i < out_h; i += 32) {
      sy_u = __fmaf_rn(red[i], taps[i].u, sy_u);
      sy += red[i];
    }
    for (int k = out_h + tid; k < n_taps; k += 32) {
      sx_u = __fmaf_rn(red[k], taps[k].u, sx_u);
      sx += red[k];
    }
    sy_u = warp_sum(sy_u);
    sy = warp_sum(sy);
    sx_u = warp_sum(sx_u);
    sx = warp_sum(sx);
    if (tid == 0) {
      const float cy = 0.5f * static_cast<float>(in_h - 1);
      const float cx = 0.5f * static_cast<float>(in_w - 1);
      const float nan = __int_as_float(0x7fc00000);
      gzw[4 * b + 0] = nan_row ? nan : sx_u * cx;        // d_sx
      gzw[4 * b + 1] = nan_col ? nan : sy_u * cy;        // d_sy
      gzw[4 * b + 2] = nan_row ? nan : sx * cx;          // d_tx
      gzw[4 * b + 3] = nan_col ? nan : sy * cy;          // d_ty
    }
  }
}

// Dynamic shared memory the dense kernel needs for one example.
long long dense_smem_bytes(int in_h, int in_w, int out_h, int out_w,
                           bool with_gimg) {
  long long bytes = static_cast<long long>(sizeof(TapsDp)) * (out_h + out_w)
      + static_cast<long long>(sizeof(float))
            * (2LL * out_h * out_w + out_h + out_w);
  if (with_gimg) {
    bytes += static_cast<long long>(sizeof(float))
        * (static_cast<long long>(in_h) * out_w
           + static_cast<long long>(in_h) * in_w);
  }
  return bytes;
}

template <bool kBf16, bool kIndexed = false>
int launch(const float* img, const float* zw, const float* g, float* gimg,
           float* gzw, long long n, int in_h, int in_w, int out_h, int out_w,
           cudaStream_t stream, const int* src_index = nullptr) {
  const bool dense = out_h * out_w <= in_h * in_w;
  const long long taps_bytes = dense
      ? static_cast<long long>(sizeof(TapsDp)) * (out_h + out_w)
      : 16LL * taps_float4s(out_h + out_w);
  long long smem = dense
      ? dense_smem_bytes(in_h, in_w, out_h, out_w, gimg != nullptr)
      : taps_bytes + static_cast<long long>(sizeof(float))
                  * Layout(in_h, in_w, out_h, out_w, gimg != nullptr).floats;
  // room for gather_bwd_nonfinite, which a block takes for a non-finite
  // example
  const long long nonfinite_smem = taps_bytes
      + static_cast<long long>(sizeof(float))
            * nonfinite_floats(in_h, in_w, out_h, out_w);
  if (nonfinite_smem > smem) smem = nonfinite_smem;
  // bit 0: img, bit 1: g can be scanned 16 bytes a load
  const bool vec_img =
      reinterpret_cast<uintptr_t>(img) % 16 == 0 && (in_h * in_w) % 4 == 0;
  const bool vec_g =
      reinterpret_cast<uintptr_t>(g) % 16 == 0 && (out_h * out_w) % 4 == 0;
  const int vec = (vec_img ? 1 : 0) | (vec_g ? 2 : 0);
  const auto kernel = dense ? st_gather_bwd_dense_kernel<kBf16, kIndexed>
                            : st_gather_bwd_kernel<kBf16, kIndexed>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();    // returned here, not left for the next launch
      return static_cast<int>(err);
    }
  }
  kernel<<<static_cast<unsigned>(n), kThreads, static_cast<size_t>(smem),
           stream>>>(img, zw, g, gimg, gzw, in_h, in_w, out_h, out_w, vec,
                     src_index);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// img (n, in_h, in_w), zw (n, 4), g (n, out_h, out_w) in; gimg
// (n, in_h, in_w) or null, gzw (n, 4) out: contiguous float32 device
// pointers, n < 2^31, gimg 16-byte aligned (a fresh allocation).
// Launches on `stream`, does not synchronise, and returns the first CUDA
// error of the attribute call or the launch (a shape whose block needs
// more shared memory than the card has fails the attribute call).
extern "C" int st_gather_bwd(const void* img, const void* zw, const void* g,
                             void* gimg, void* gzw, long long n, int in_h,
                             int in_w, int out_h, int out_w, int bf16,
                             void* stream) {
  if (n <= 0 || out_h <= 0 || out_w <= 0) return 0;
  const auto* i = static_cast<const float*>(img);
  const auto* z = static_cast<const float*>(zw);
  const auto* gg = static_cast<const float*>(g);
  auto* gi = static_cast<float*>(gimg);
  auto* gz = static_cast<float*>(gzw);
  auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<true>(i, z, gg, gi, gz, n, in_h, in_w, out_h, out_w, s)
              : launch<false>(i, z, gg, gi, gz, n, in_h, in_w, out_h, out_w,
                              s);
}

// The indexed gather's backward, f32 mode, g_zw alone (the images are
// data): img (m, in_h, in_w), src_index (n) int32 image indices in
// [0, m), zw (n, 4), g (n, out_h, out_w) in; gzw (n, 4) out: contiguous
// float32 device pointers, n < 2^31.  Bit for bit what st_gather_bwd
// gives on a copy of each window's image.  Launches on `stream`, does not
// synchronise, and returns the first CUDA error.
extern "C" int st_gather_bwd_indexed(const void* img, const void* src_index,
                                     const void* zw, const void* g,
                                     void* gzw, long long n, int in_h,
                                     int in_w, int out_h, int out_w,
                                     void* stream) {
  if (n <= 0 || out_h <= 0 || out_w <= 0) return 0;
  return launch<false, true>(
      static_cast<const float*>(img), static_cast<const float*>(zw),
      static_cast<const float*>(g), nullptr, static_cast<float*>(gzw), n,
      in_h, in_w, out_h, out_w, static_cast<cudaStream_t>(stream),
      static_cast<const int*>(src_index));
}

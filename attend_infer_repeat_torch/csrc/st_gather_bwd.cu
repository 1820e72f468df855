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
// What bounds it on the card: memory.  At the train step's shapes it reads
// the input pixels its taps touch, the output cotangent g and zw, and
// writes g_img and g_zw once; the arithmetic is a few multiply-adds per
// tap pair, far under the CUDA-core rate.
//
// Design: one block per example, everything between the reads and the
// writes in shared memory, no global atomics, every sum in a fixed order
// (the kernel is deterministic):
//   1. the h + w row and column taps, with dw/dp and u, into shared memory;
//   2. one pass over the output pixels: for pixel (i, k) with cotangent
//      g, A = sum_a dwy_a sum_b wx_b img[qa, qb] and
//      B = sum_b dwx_b sum_a wy_a img[qa, qb]; g A and g B are kept per
//      pixel;
//   3. gy_i = sum_k g A (one thread per output row), gx_k = sum_i g B
//      (one thread per output column);
//   4. g_img in two separable scatter passes through shared memory:
//      t2[j, k] = sum_i wy[i, j] g[i, k] (one thread owns output column k),
//      then g_img[j, l] = sum_k t2[j, k] wx[k, l] (one thread owns input
//      row j), then written out coalesced;
//   5. one thread forms the four zw gradients from gy, gx and u.
// At the train step's shapes the block needs 18 KB of shared memory for
// the gather's backward (50x50 -> 20x20) and 28 KB for the paste's
// (20x20 -> 50x50).
//
// When the caller passes no g_img pointer (the gather of the data image,
// whose gradient nobody needs), steps 4's passes and the g_img write are
// skipped and only g_zw is computed.
//
// Numerics: f32 accumulation throughout.  In bf16 mode the operands of
// each of the Pallas kernel's five products are rounded to bf16 as its
// dot() rounds them: pixels, hat weights and g; the intermediates
// img . W_x^T and W_y . img (before the products with dW/dp) and t2.
// dW/dp is -1, 0 or 1, exact in bf16.  A coordinate outside (-1, in)
// gives exactly 0 in both outputs.  A NaN coordinate gives NaN where the
// dense form gives it: all of g_img; the x gradients for a NaN row
// coordinate, the y gradients for a NaN column coordinate.

#include <cstdint>

#include "st_taps.cuh"

namespace {

constexpr int kThreads = 128;

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

__device__ __forceinline__ TapsDp axis_taps_dp(float scale, float shift,
                                               int k, int out_size,
                                               int in_size, bool bf16) {
  TapsDp r;
  r.u = axis_u(k, out_size);
  const float p = source_coord(scale, shift, r.u, in_size);
  r.t = axis_taps(p, in_size, bf16);
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

__global__ void __launch_bounds__(kThreads)
st_gather_bwd_kernel(const float* __restrict__ img,
                     const float* __restrict__ zw,
                     const float* __restrict__ g, float* __restrict__ gimg,
                     float* __restrict__ gzw, int in_h, int in_w, int out_h,
                     int out_w, bool bf16) {
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
  const float* __restrict__ src = img + b * in_h * in_w;
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

  // 1. taps
  for (int r = tid; r < n_taps; r += kThreads) {
    const bool row = r < out_h;
    taps[r] = row ? axis_taps_dp(__ldg(z + 1), __ldg(z + 3), r, out_h, in_h,
                                 bf16)
                  : axis_taps_dp(__ldg(z + 0), __ldg(z + 2), r - out_h,
                                 out_w, in_w, bf16);
    if (taps[r].t.q0 == kNaN) atomicExch(row ? &nan_row : &nan_col, 1);
  }
  __syncthreads();

  // 2. per output pixel: g A and g B
  for (int pix = tid; pix < n_out; pix += kThreads) {
    const int i = pix / out_w;
    const TapsDp ty = taps[i];
    const TapsDp tx = taps[out_h + pix - i * out_w];
    float gv = __ldg(gg + pix);
    if (bf16) gv = round_bf16(gv);
    float a_sum = 0.0f, b_sum = 0.0f;
    if (ty.t.q0 != kNaN && tx.t.q0 != kNaN) {
      const bool ly[2] = {live(ty.t.w0, ty.d0), live(ty.t.w1, ty.d1)};
      const bool lx[2] = {live(tx.t.w0, tx.d0), live(tx.t.w1, tx.d1)};
      float v[2][2];
      for (int a = 0; a < 2; ++a) {
        for (int c = 0; c < 2; ++c) {
          v[a][c] = 0.0f;
          if (ly[a] && lx[c]) {
            v[a][c] = __ldg(src + (ty.t.q0 + a) * in_w + tx.t.q0 + c);
            if (bf16) v[a][c] = round_bf16(v[a][c]);
          }
        }
      }
      const float wy[2] = {ty.t.w0, ty.t.w1}, dy[2] = {ty.d0, ty.d1};
      const float wx[2] = {tx.t.w0, tx.t.w1}, dx[2] = {tx.d0, tx.d1};
      for (int a = 0; a < 2; ++a) {           // (img . W_x^T)[qa, k]
        float cp = __fmaf_rn(wx[1], v[a][1], __fmul_rn(wx[0], v[a][0]));
        if (bf16) cp = round_bf16(cp);
        a_sum = __fmaf_rn(dy[a], cp, a_sum);
      }
      for (int c = 0; c < 2; ++c) {           // (W_y . img)[i, qc]
        float rp = __fmaf_rn(wy[1], v[1][c], __fmul_rn(wy[0], v[0][c]));
        if (bf16) rp = round_bf16(rp);
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
        float gv = __ldg(gg + i * out_w + k);
        if (bf16) gv = round_bf16(gv);
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
        float v = t2[j * out_w + k];
        if (bf16) v = round_bf16(v);
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
  if (tid == 0) {
    float sy_u = 0.0f, sy = 0.0f, sx_u = 0.0f, sx = 0.0f;
    for (int i = 0; i < out_h; ++i) {
      sy_u = __fmaf_rn(red[i], taps[i].u, sy_u);
      sy += red[i];
    }
    for (int k = out_h; k < n_taps; ++k) {
      sx_u = __fmaf_rn(red[k], taps[k].u, sx_u);
      sx += red[k];
    }
    const float cy = 0.5f * static_cast<float>(in_h - 1);
    const float cx = 0.5f * static_cast<float>(in_w - 1);
    const float nan = __int_as_float(0x7fc00000);
    gzw[4 * b + 0] = nan_row ? nan : sx_u * cx;        // d_sx
    gzw[4 * b + 1] = nan_col ? nan : sy_u * cy;        // d_sy
    gzw[4 * b + 2] = nan_row ? nan : sx * cx;          // d_tx
    gzw[4 * b + 3] = nan_col ? nan : sy * cy;          // d_ty
  }
}

// Dynamic shared memory the kernel needs for one example.
long long smem_bytes(int in_h, int in_w, int out_h, int out_w,
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

}  // namespace

// img (n, in_h, in_w), zw (n, 4), g (n, out_h, out_w) in; gimg
// (n, in_h, in_w) or null, gzw (n, 4) out: contiguous float32 device
// pointers, n < 2^31.  Launches on `stream`, does not synchronise, and
// returns the first CUDA error of the attribute call or the launch (a
// shape whose block needs more shared memory than the card has fails the
// attribute call).
extern "C" int st_gather_bwd(const void* img, const void* zw, const void* g,
                             void* gimg, void* gzw, long long n, int in_h,
                             int in_w, int out_h, int out_w, int bf16,
                             void* stream) {
  if (n <= 0 || out_h <= 0 || out_w <= 0) return 0;
  const long long smem =
      smem_bytes(in_h, in_w, out_h, out_w, gimg != nullptr);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        st_gather_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();    // returned here, not left for the next launch
      return static_cast<int>(err);
    }
  }
  st_gather_bwd_kernel<<<static_cast<unsigned>(n), kThreads,
                         static_cast<size_t>(smem),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const float*>(zw),
      static_cast<const float*>(g), static_cast<float*>(gimg),
      static_cast<float*>(gzw), in_h, in_w, out_h, out_w, bf16 != 0);
  return static_cast<int>(cudaGetLastError());
}

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
// examples moves ~95 MB (each input read once, each output written once):
// the taps need only the input pixels they touch, but the check for
// non-finite pixels (below) reads every one.  It needs ~0.1 GFLOP in tap
// form; the dense form would need ~140 kFLOP per example (~1.1 GFLOP),
// which on CUDA cores is close to the memory time.  The tap form keeps
// the arithmetic far below that.
// At N = 1024 the grid is one wave of blocks, so there a launch takes a
// fixed cost plus its slowest block's latency: a chain of dependent loads,
// not bytes, sets it.  At N = 8192 the same chain repeats over several
// waves, so the number of examples in flight on an SM matters too.
//
// Design: one block per example.
//   1. The block loads its zw, then computes the two taps of every output
//      row and every output column (h + w coordinates, not h * w) into
//      shared memory, and checks its example for non-finite pixels.
//   2. Each thread owns runs of V consecutive pixels of one output row
//      (V = 4, 2 or 1, the largest that divides the row), stored with one
//      V-wide vector store.  A thread finds its first run with one
//      division and steps to the next without one.  Per run it reads the
//      row's taps once, issues all of the run's loads before using any,
//      then forms the V outputs.  An output row with no nonzero tap (most
//      of a paste's canvas) stores zeros with no taps of its columns read
//      and no loads; a column with no nonzero tap loads nothing.
//   3. The mode (f32 or bf16) is a template parameter: no runtime branch
//      on it.
//   4. A small output (the 20x20 glimpse) gets a 64-thread block, so that
//      an SM holds twice as many examples; a paste's 2,500 outputs run
//      faster with 128 threads.
// Index arithmetic is 32-bit within an example.
//
// Numerics follow the Pallas kernel: coordinates and hat weights in f32
// with the same operation order (no FMA contraction), accumulation in f32
// rows first, then columns, each output's two products summed in tap
// order.  A dense f32 product that sums in index order (its other
// weights add exact zeros) then gives the same bits.  In bf16 mode the
// pixels and weights are rounded to bf16 before the products, and so is
// the row-pass intermediate, as the Pallas kernel rounds its first dot's
// result before the second.
//
// Coordinates are range-checked in float before floor(p) becomes an int
// (st_taps.cuh).  A row or column whose p lies outside (-1, in) has no
// nonzero weight and yields exactly 0; a NaN coordinate yields NaN, as
// the dense form does.
//
// Non-finite pixels: the dense form multiplies every pixel by a weight,
// zero ones included, so one NaN or infinity reaches outputs that do not
// tap it (0 * inf and 0 * NaN are NaN).  The tap form never reads those
// products.  So each block first reads its whole example (16-byte loads)
// only to OR a flag: a pixel that is NaN or infinite as the mode rounds
// it.  A finite example takes the tap path above, whose bits do not
// change.  A flagged one takes gather_nonfinite, which gives the dense
// form's pattern of NaN and +-inf: with tmp = W_y . img, tmp[i, l] is NaN
// where column l holds a NaN, or an infinity in a row to which output row
// i gives weight 0, and otherwise the sum of its taps' products (+-inf
// where a tap meets an infinity); an output (i, k) is NaN where tmp[i, .]
// holds a NaN, or an infinity in a column to which output column k gives
// weight 0, and otherwise the sum of its taps' products.

#include <cstdint>

#include "st_taps.cuh"

namespace {

// Outputs (pixels per example) up to which a block has 64 threads.
constexpr int kSmallOutput = 512;
// A column count that marks a column holding a NaN.
constexpr int kNanColumn = 0x7fffffff;

// tmp[i, l] = (W_y . img)[i, l] of the dense form for row taps ty, given
// cnt, column l's count of infinities (kNanColumn if it holds a NaN).
template <bool kBf16>
__device__ __forceinline__ float dense_row_value(const float* __restrict__ src,
                                                 const Taps& ty, int cnt,
                                                 int l, int in_w) {
  const float nan = __int_as_float(0x7fc00000);
  if (cnt == kNanColumn) return nan;
  float acc = 0.0f;
  int inf_taps = 0;
  if (ty.w0 != 0.0f) {
    const float v = rnd<kBf16>(src[ty.q0 * in_w + l]);
    inf_taps += isinf(v);
    acc = __fmaf_rn(ty.w0, v, acc);
  }
  if (ty.w1 != 0.0f) {
    const float v = rnd<kBf16>(src[(ty.q0 + 1) * in_w + l]);
    inf_taps += isinf(v);
    acc = __fmaf_rn(ty.w1, v, acc);
  }
  // an infinity that this row gives weight 0 makes a NaN
  return cnt > inf_taps ? nan : rnd<kBf16>(acc);
}

// The gather of an example that holds a NaN or an infinity: the dense
// form's result (see the header), handed to store(idx, value) once for
// each output pixel.  Shared memory after the taps: cnt
// (in_w column counts), then per output row a NaN flag and a count of
// infinite tmp values.
template <bool kBf16, class Store>
__device__ __noinline__ void gather_nonfinite(const float* __restrict__ src,
                                              Store store,
                                              const Taps* __restrict__ taps,
                                              int* __restrict__ cnt, int in_h,
                                              int in_w, int out_h, int out_w) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  int* __restrict__ row_nan = cnt + in_w;
  int* __restrict__ row_inf = row_nan + out_h;
  const float nan = __int_as_float(0x7fc00000);
  for (int l = tid; l < in_w; l += nthreads) {
    int c = 0;
    for (int j = 0; j < in_h; ++j) {
      const float v = rnd<kBf16>(src[j * in_w + l]);
      if (v != v) c = kNanColumn;
      else if (isinf(v) && c != kNanColumn) ++c;
    }
    cnt[l] = c;
  }
  for (int i = tid; i < out_h; i += nthreads) {
    row_nan[i] = 0;
    row_inf[i] = 0;
  }
  __syncthreads();
  for (int idx = tid; idx < out_h * in_w; idx += nthreads) {
    const int i = idx / in_w, l = idx - i * in_w;
    if (taps[i].q0 == kNaN) continue;         // its outputs are all NaN
    const float t = dense_row_value<kBf16>(src, taps[i], cnt[l], l, in_w);
    if (t != t) {
      row_nan[i] = 1;
    } else if (isinf(t)) {
      atomicAdd(row_inf + i, 1);
    }
  }
  __syncthreads();
  for (int idx = tid; idx < out_h * out_w; idx += nthreads) {
    const int i = idx / out_w, k = idx - i * out_w;
    const Taps ty = taps[i], tx = taps[out_h + k];
    float res = nan;
    if (ty.q0 != kNaN && tx.q0 != kNaN && !row_nan[i]) {
      float col[2] = {0.0f, 0.0f};
      int inf_taps = 0;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if ((c ? tx.w1 : tx.w0) != 0.0f) {
          col[c] = dense_row_value<kBf16>(src, ty, cnt[tx.q0 + c],
                                          tx.q0 + c, in_w);
          inf_taps += isinf(col[c]);
        }
      }
      // an infinite tmp that this column gives weight 0 makes a NaN
      if (row_inf[i] == inf_taps) {
        res = __fmaf_rn(tx.w1, col[1], __fmul_rn(tx.w0, col[0]));
      }
    }
    store(idx, res);
  }
}

// Where gather_nonfinite puts an output: the gather's f32 output pixel.
struct StoreOutput {
  float* __restrict__ dst;
  __device__ void operator()(int idx, float v) const { dst[idx] = v; }
};

// The tap form of one output pixel, shared by the gather and the fused
// paste.  An output row that reads nothing: its row coordinate is NaN, or
// it has no nonzero tap.
__device__ __forceinline__ bool reads_nothing(const Taps& ty) {
  return ty.q0 == kNaN || (ty.w0 == 0.0f && ty.w1 == 0.0f);
}

// The value of such a row at the column with taps *tx: NaN in a NaN row
// or column, else 0 (the column's taps read only where a column is NaN).
__device__ __forceinline__ float untapped_value(const Taps& ty,
                                                const Taps* tx,
                                                bool any_nan_col) {
  const bool nan = ty.q0 == kNaN || (any_nan_col && tx->q0 == kNaN);
  return nan ? __int_as_float(0x7fc00000) : 0.0f;
}

// The four pixels that an output pixel with taps ty, tx reads, v[c][r]
// for column tap c and row tap r, each load(offset in the example); 0
// where a weight is 0, with no load.
template <class Load>
__device__ __forceinline__ void tap_loads(const Taps& ty, const Taps& tx,
                                          int in_w, Load load,
                                          float (&v)[2][2]) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const bool wc = (c ? tx.w1 : tx.w0) != 0.0f;
    const int x = tx.q0 + c;
    v[c][0] = (wc && ty.w0 != 0.0f) ? load(ty.q0 * in_w + x) : 0.0f;
    v[c][1] = (wc && ty.w1 != 0.0f) ? load((ty.q0 + 1) * in_w + x) : 0.0f;
  }
}

// The pixel from those four: the row pass for its two columns, then the
// column pass (see the header for the rounding); NaN in a NaN column.
template <bool kBf16>
__device__ __forceinline__ float tap_value(const Taps& ty, const Taps& tx,
                                           const float (&v)[2][2]) {
  float col[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    float acc = 0.0f;
    if ((c ? tx.w1 : tx.w0) != 0.0f) {
      acc = __fmaf_rn(ty.w0, rnd<kBf16>(v[c][0]), acc);
      acc = __fmaf_rn(ty.w1, rnd<kBf16>(v[c][1]), acc);
    }
    col[c] = rnd<kBf16>(acc);
  }
  return tx.q0 == kNaN ? __int_as_float(0x7fc00000)
                       : __fmaf_rn(tx.w1, col[1], __fmul_rn(tx.w0, col[0]));
}

template <int V>
struct Vec;
template <>
struct Vec<4> {
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Vec<2> {
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
};
template <>
struct Vec<1> {
  __device__ static void store(float* p, const float* v) { *p = v[0]; }
};

template <bool kBf16, int V, int kThreads>
__global__ void __launch_bounds__(kThreads)
st_gather_kernel(const float* __restrict__ img, const float* __restrict__ zw,
                 float* __restrict__ out, int in_h, int in_w, int out_h,
                 int out_w, bool vec) {
  extern __shared__ Taps taps[];             // out_h rows, then out_w columns
  const int tid = threadIdx.x;
  const int64_t b = blockIdx.x;
  const float* __restrict__ z = zw + 4 * b;  // sx, sy, tx, ty
  const float scale_x = __ldg(z + 0), scale_y = __ldg(z + 1);
  const float shift_x = __ldg(z + 2), shift_y = __ldg(z + 3);

  bool nan_col = false;
  for (int r = tid; r < out_h + out_w; r += kThreads) {
    const bool row = r < out_h;
    const int k = row ? r : r - out_h;
    const float u = axis_u(k, row ? out_h : out_w);
    const float p = row ? source_coord(scale_y, shift_y, u, in_h)
                        : source_coord(scale_x, shift_x, u, in_w);
    taps[r] = axis_taps(p, row ? in_h : in_w, kBf16);
    nan_col |= !row && p != p;
  }
  const float* __restrict__ src = img + b * in_h * in_w;
  float* __restrict__ dst = out + b * out_h * out_w;
  const bool bad = any_nonfinite<kBf16, kThreads>(src, in_h * in_w, vec);
  const bool any_nan_col = __syncthreads_or(nan_col);
  if (__syncthreads_or(bad)) {
    gather_nonfinite<kBf16>(src, StoreOutput{dst}, taps,
                            reinterpret_cast<int*>(taps + out_h + out_w),
                            in_h, in_w, out_h, out_w);
    return;
  }
  const auto load = [src](int offset) { return __ldg(src + offset); };
  const int nvec = out_w / V;                // runs per output row
  const int step_i = kThreads / nvec, step_k = kThreads - step_i * nvec;
  int i = tid / nvec, kv = tid - i * nvec;
  while (i < out_h) {
    const Taps ty = taps[i];
    const Taps* __restrict__ txs = taps + out_h + kv * V;
    float res[V];
    if (reads_nothing(ty)) {
#pragma unroll
      for (int p = 0; p < V; ++p) {
        res[p] = untapped_value(ty, txs + p, any_nan_col);
      }
    } else {
      Taps tx[V];
      float v[V][2][2];                      // [pixel][column tap][row tap]
#pragma unroll
      for (int p = 0; p < V; ++p) tx[p] = txs[p];
      // all of the run's loads before any of its arithmetic
#pragma unroll
      for (int p = 0; p < V; ++p) tap_loads(ty, tx[p], in_w, load, v[p]);
#pragma unroll
      for (int p = 0; p < V; ++p) res[p] = tap_value<kBf16>(ty, tx[p], v[p]);
    }
    Vec<V>::store(dst + i * out_w + kv * V, res);
    kv += step_k;
    i += step_i;
    if (kv >= nvec) {
      kv -= nvec;
      ++i;
    }
  }
}

template <bool kBf16, int V>
int launch(const float* img, const float* zw, float* out, long long n,
           int in_h, int in_w, int out_h, int out_w, cudaStream_t stream) {
  // the taps, then gather_nonfinite's counts
  const size_t smem = sizeof(Taps) * static_cast<size_t>(out_h + out_w)
      + sizeof(int) * static_cast<size_t>(in_w + 2 * out_h);
  const unsigned blocks = static_cast<unsigned>(n);
  const bool vec = reinterpret_cast<uintptr_t>(img) % 16 == 0
      && (in_h * in_w) % 4 == 0;
  if (out_h * out_w <= kSmallOutput) {
    st_gather_kernel<kBf16, V, 64><<<blocks, 64, smem, stream>>>(
        img, zw, out, in_h, in_w, out_h, out_w, vec);
  } else {
    st_gather_kernel<kBf16, V, 128><<<blocks, 128, smem, stream>>>(
        img, zw, out, in_h, in_w, out_h, out_w, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kBf16>
int launch_mode(const float* img, const float* zw, float* out, long long n,
                int in_h, int in_w, int out_h, int out_w,
                cudaStream_t stream) {
  if (out_w % 4 == 0) {
    return launch<kBf16, 4>(img, zw, out, n, in_h, in_w, out_h, out_w, stream);
  }
  if (out_w % 2 == 0) {
    return launch<kBf16, 2>(img, zw, out, n, in_h, in_w, out_h, out_w, stream);
  }
  return launch<kBf16, 1>(img, zw, out, n, in_h, in_w, out_h, out_w, stream);
}

// ---------------------------------------------------------------------------
// The paste fused with the canvas update that follows it in the model's
// cell (models/cell.py):
//   canvas_out[n, p] = carry(f32(canvas_in[n, p]) + z_pres[n] * paste[n, p])
// where paste is the gather above (f32 mode) of the glimpse under the
// inverted window, and carry is the canvas's own type, f32 or bf16.
// Unfused, PyTorch makes four passes over the canvas after the paste
// kernel: the mask z_pres * paste, bf16 -> f32, the add, f32 -> bf16.
// Each is one correctly rounded f32 operation (the add's a + 1 * b is
// a + b), and PyTorch's bf16 casts on sm_90 are __bfloat162float and
// __float2bfloat16; this kernel does the same operations in the same
// order, so it gives the same bits, NaN and infinity patterns included.
//
// What bounds it: memory.  The canvas is read once and written once at
// the carry's width and the glimpse read once: 11.6 KB an example at
// 50x50 <- 20x20 in bf16, about what the paste's f32 output alone was.
//
// Design: one block per example.
//   1. Each thread first loads its first kU runs of the flat canvas
//      (V = 4 consecutive pixels, one 8- or 16-byte load; V = 1 where the
//      canvas is not so aligned), so their latency overlaps step 2.
//   2. The block forms the row and column taps in shared memory, as the
//      gather does, and copies the glimpse into shared memory while
//      checking it for non-finite pixels.
//   3. A flagged example takes gather_nonfinite, the dense form's NaN and
//      inf pattern, with the update as its store (the canvas read again).
//      Otherwise each pixel's paste is formed from the taps and the
//      shared glimpse, with the gather's arithmetic: a row with no nonzero
//      tap pastes 0 (NaN in a NaN column) without reading the column taps
//      or the glimpse, and a column with none reads no glimpse.  The
//      update is done there too: f32(c) + z * 0 is not always c (-0 + 0 is
//      +0, and a non-finite z makes NaN).
//   4. Runs go kU at a time: a thread starts a batch's kU loads together,
//      then forms and stores the batch.

// The canvas's element: its storage type, four of them in one load, and
// the conversions to f32 and back that PyTorch's casts use.
struct CarryF32 {
  using T = float;
  using T4 = float4;
  __device__ static float load(float v) { return v; }
  __device__ static float store(float v) { return v; }
};
struct CarryBf16 {
  using T = unsigned short;                  // a bf16's bits
  using T4 = ushort4;
  __device__ static float load(unsigned short v) {
    return __bfloat162float(__ushort_as_bfloat16(v));
  }
  __device__ static unsigned short store(float v) {
    return __bfloat16_as_ushort(__float2bfloat16(v));
  }
};

// f32(c) + z * paste, rounded to the carry.
template <class C>
__device__ __forceinline__ typename C::T update(float c, float z,
                                                float paste) {
  return C::store(__fadd_rn(c, __fmul_rn(z, paste)));
}

template <class C, int V>
__device__ __forceinline__ void load_run(const typename C::T* __restrict__ p,
                                         float* f) {
  if constexpr (V == 4) {
    const typename C::T4 v = *reinterpret_cast<const typename C::T4*>(p);
    f[0] = C::load(v.x);
    f[1] = C::load(v.y);
    f[2] = C::load(v.z);
    f[3] = C::load(v.w);
  } else {
#pragma unroll
    for (int q = 0; q < V; ++q) f[q] = C::load(p[q]);
  }
}

template <class C, int V>
__device__ __forceinline__ void store_run(typename C::T* __restrict__ p,
                                          const typename C::T* v) {
  if constexpr (V == 4) {
    typename C::T4 w;
    w.x = v[0];
    w.y = v[1];
    w.z = v[2];
    w.w = v[3];
    *reinterpret_cast<typename C::T4*>(p) = w;
  } else {
#pragma unroll
    for (int q = 0; q < V; ++q) p[q] = v[q];
  }
}

// The dense path's store: the update of one canvas pixel.
template <class C>
struct StoreUpdate {
  const typename C::T* __restrict__ cin;
  typename C::T* __restrict__ cout;
  float pres;
  __device__ void operator()(int idx, float v) const {
    cout[idx] = update<C>(C::load(cin[idx]), pres, v);
  }
};

// The paste at output pixel (i, k) of a finite example: the gather's f32
// tap form, the glimpse g in shared memory.
__device__ __forceinline__ float paste_pixel(const Taps* __restrict__ taps,
                                             const float* __restrict__ g,
                                             int i, int k, int out_h,
                                             int in_w, bool any_nan_col) {
  const Taps ty = taps[i];
  if (reads_nothing(ty)) {
    return untapped_value(ty, taps + out_h + k, any_nan_col);
  }
  const Taps tx = taps[out_h + k];
  float v[2][2];
  tap_loads(ty, tx, in_w, [g](int offset) { return g[offset]; }, v);
  return tap_value<false>(ty, tx, v);
}

template <class C, int V, int kThreads>
__global__ void __launch_bounds__(kThreads)
st_gather_accumulate_kernel(const typename C::T* __restrict__ canvas_in,
                            const float* __restrict__ glimpse,
                            const float* __restrict__ zw,
                            const float* __restrict__ z_pres,
                            typename C::T* __restrict__ canvas_out, int in_h,
                            int in_w, int out_h, int out_w, bool vec) {
  constexpr int kU = 4;                      // runs in flight per thread
  // out_h row taps, out_w column taps, then the glimpse (or, for a
  // flagged example, gather_nonfinite's counts)
  extern __shared__ Taps taps[];
  const int tid = threadIdx.x;
  const int64_t b = blockIdx.x;
  const int n_in = in_h * in_w, n_out = out_h * out_w, runs = n_out / V;
  const typename C::T* __restrict__ cin = canvas_in + b * n_out;
  typename C::T* __restrict__ cout = canvas_out + b * n_out;

  float c[kU][V];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int r = tid + u * kThreads;
    if (r < runs) load_run<C, V>(cin + r * V, c[u]);
  }

  const float* __restrict__ z = zw + 4 * b;  // sx, sy, tx, ty
  const float scale_x = __ldg(z + 0), scale_y = __ldg(z + 1);
  const float shift_x = __ldg(z + 2), shift_y = __ldg(z + 3);
  const float pres = __ldg(z_pres + b);
  bool nan_col = false;
  for (int r = tid; r < out_h + out_w; r += kThreads) {
    const bool row = r < out_h;
    const int k = row ? r : r - out_h;
    const float u = axis_u(k, row ? out_h : out_w);
    const float p = row ? source_coord(scale_y, shift_y, u, in_h)
                        : source_coord(scale_x, shift_x, u, in_w);
    taps[r] = axis_taps(p, row ? in_h : in_w, false);
    nan_col |= !row && p != p;
  }
  float* __restrict__ g = reinterpret_cast<float*>(taps + out_h + out_w);
  const float* __restrict__ src = glimpse + b * n_in;
  bool bad = false;
  if (vec) {
    const float4* __restrict__ src4 = reinterpret_cast<const float4*>(src);
    for (int q = tid; q < n_in / 4; q += kThreads) {
      const float4 v = __ldg(src4 + q);
      g[4 * q] = v.x;
      g[4 * q + 1] = v.y;
      g[4 * q + 2] = v.z;
      g[4 * q + 3] = v.w;
      bad |= !isfinite(v.x) | !isfinite(v.y) | !isfinite(v.z) |
             !isfinite(v.w);
    }
  } else {
    for (int q = tid; q < n_in; q += kThreads) {
      const float v = __ldg(src + q);
      g[q] = v;
      bad |= !isfinite(v);
    }
  }
  const bool any_nan_col = __syncthreads_or(nan_col);
  if (__syncthreads_or(bad)) {
    gather_nonfinite<false>(src, StoreUpdate<C>{cin, cout, pres}, taps,
                            reinterpret_cast<int*>(g), in_h, in_w, out_h,
                            out_w);
    return;
  }
  for (int base = tid; base < runs; base += kU * kThreads) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int r = base + u * kThreads;
      if (r < runs) {
        int i = r * V / out_w, k = r * V - i * out_w;
        typename C::T o[V];
#pragma unroll
        for (int q = 0; q < V; ++q) {
          o[q] = update<C>(c[u][q], pres,
                           paste_pixel(taps, g, i, k, out_h, in_w,
                                       any_nan_col));
          if (++k == out_w) {
            k = 0;
            ++i;
          }
        }
        store_run<C, V>(cout + r * V, o);
      }
    }
    const int next = base + kU * kThreads;
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int r = next + u * kThreads;
      if (r < runs) load_run<C, V>(cin + r * V, c[u]);
    }
  }
}

// Canvas pixels per example above which a fused block has 256 threads.
constexpr int kLargeCanvas = 4096;

template <class C, int V>
int launch_accumulate(const void* canvas_in, const float* glimpse,
                      const float* zw, const float* z_pres, void* canvas_out,
                      long long n, int in_h, int in_w, int out_h, int out_w,
                      cudaStream_t stream) {
  const auto* cin = static_cast<const typename C::T*>(canvas_in);
  auto* cout = static_cast<typename C::T*>(canvas_out);
  const size_t n_in = static_cast<size_t>(in_h) * in_w;
  const size_t counts = static_cast<size_t>(in_w) + 2 * out_h;
  const size_t smem = sizeof(Taps) * static_cast<size_t>(out_h + out_w)
      + sizeof(float) * (n_in > counts ? n_in : counts);
  const unsigned blocks = static_cast<unsigned>(n);
  const bool vec = reinterpret_cast<uintptr_t>(glimpse) % 16 == 0
      && n_in % 4 == 0;
  auto run = [&](auto kernel, int threads) {
    if (smem > 48 * 1024) {
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
    }
    kernel<<<blocks, threads, smem, stream>>>(cin, glimpse, zw, z_pres, cout,
                                              in_h, in_w, out_h, out_w, vec);
  };
  if (out_h * out_w <= kLargeCanvas) {
    run(st_gather_accumulate_kernel<C, V, 128>, 128);
  } else {
    run(st_gather_accumulate_kernel<C, V, 256>, 256);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class C>
int launch_carry(const void* canvas_in, const float* glimpse,
                 const float* zw, const float* z_pres, void* canvas_out,
                 long long n, int in_h, int in_w, int out_h, int out_w,
                 cudaStream_t stream) {
  constexpr uintptr_t kAlign = 4 * sizeof(typename C::T);
  if ((out_h * out_w) % 4 == 0
      && reinterpret_cast<uintptr_t>(canvas_in) % kAlign == 0
      && reinterpret_cast<uintptr_t>(canvas_out) % kAlign == 0) {
    return launch_accumulate<C, 4>(canvas_in, glimpse, zw, z_pres,
                                   canvas_out, n, in_h, in_w, out_h, out_w,
                                   stream);
  }
  return launch_accumulate<C, 1>(canvas_in, glimpse, zw, z_pres, canvas_out,
                                 n, in_h, in_w, out_h, out_w, stream);
}

}  // namespace

// img (n, in_h, in_w), zw (n, 4) and out (n, out_h, out_w): contiguous
// float32 device pointers, n < 2^31, out 16-byte aligned (a fresh
// allocation).  Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launch.
extern "C" int st_gather(const void* img, const void* zw, void* out,
                         long long n, int in_h, int in_w, int out_h,
                         int out_w, int bf16, void* stream) {
  if (n <= 0 || out_h <= 0 || out_w <= 0) return 0;
  const auto* i = static_cast<const float*>(img);
  const auto* z = static_cast<const float*>(zw);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_mode<true>(i, z, o, n, in_h, in_w, out_h, out_w, s)
              : launch_mode<false>(i, z, o, n, in_h, in_w, out_h, out_w, s);
}

// canvas_in and canvas_out (n, out_h, out_w), f32 or (carry_bf16) bf16;
// glimpse (n, in_h, in_w), zw (n, 4) and z_pres (n): contiguous device
// pointers, the last three float32, n < 2^31.  Writes
// carry(f32(canvas_in) + z_pres * st_gather(glimpse, zw)) to canvas_out.
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launch.
extern "C" int st_gather_accumulate(const void* canvas_in, const void* glimpse,
                                    const void* zw, const void* z_pres,
                                    void* canvas_out, long long n, int in_h,
                                    int in_w, int out_h, int out_w,
                                    int carry_bf16, void* stream) {
  if (n <= 0 || out_h <= 0 || out_w <= 0) return 0;
  const auto* g = static_cast<const float*>(glimpse);
  const auto* z = static_cast<const float*>(zw);
  const auto* zp = static_cast<const float*>(z_pres);
  auto s = static_cast<cudaStream_t>(stream);
  return carry_bf16
      ? launch_carry<CarryBf16>(canvas_in, g, z, zp, canvas_out, n, in_h,
                                in_w, out_h, out_w, s)
      : launch_carry<CarryF32>(canvas_in, g, z, zp, canvas_out, n, in_h, in_w,
                               out_h, out_w, s);
}

// The LSTM cell's pointwise chain (models/modules.py LSTMCell), sm_90a:
// forward and backward, one kernel each.
//
// Replaces no TPU kernel: XLA fuses these elementwise ops on its own, and
// PyTorch runs them as ~10 kernels forward and ~13 backward (the gate add,
// three sigmoids, two tanhs, their backwards, the products, the split's
// concatenation and the sum of c's two gradients).  The cell runs at
// every object step (four LSTMs a frame and slot in SQAIR), so these are
// many small launches of the step graph.
//
// The two GEMMs stay outside: a = ih(x) and b = hh(h), each (rows, 4H)
// float32, gates i, f, g, o at column offsets 0, H, 2H, 3H.
//   forward   (a, b, c_prev) -> (c, h)
//             z = a + b; c = sigmoid(f) * c_prev + sigmoid(i) * tanh(g);
//             h = sigmoid(o) * tanh(c)
//   backward  (a, b, c_prev, dh, dc) -> (d_gates (rows, 4H), dc_prev)
//             the gradient of z, which is that of a and of b; the
//             activations are recomputed from a, b and c_prev, so the
//             forward writes nothing beyond c and h.
//
// What bounds it on the card: memory.  At 5,120 rows and H = 256 the
// forward moves 57.7 MB (a, b, c_prev read, c and h written: 17.2 us at
// 3.35 TB/s) and the backward 83.9 MB (a, b, c_prev, dh, dc read, d_gates
// and dc_prev written: 25.0 us), with ~30 flops and 5 transcendentals a
// unit.  Design: one thread per row and V = 4 consecutive hidden units
// (V = 1 where H % 4 or an address or row stride does not allow 16-byte
// loads), so a warp reads 512 contiguous bytes of each gate block; the
// grid covers rows x H / V; no shared memory.  c_prev, dh and dc may be
// row-strided views (inner stride 1): SQAIR's slot states are columns of
// a (B, N, H) tensor, and a gradient of a concatenation's part is one.
//
// Bits: each op rounds where the unfused PyTorch ops round, in their
// order (__fadd_rn / __fmul_rn: no FMA contraction), so both kernels are
// bit-equal to the unfused ops and their autograd:
//   sigmoid(x)            1 / (1 + expf(-x))        (PyTorch's CUDA sigmoid)
//   tanh(x)               tanhf(x)
//   sigmoid_backward(g,y) (g * (1 - y)) * y
//   tanh_backward(g, y)   g * fma(-y, y, 1)         (PyTorch's binary
//                         contracts 1 - y * y; tests/test_torch_lstm_cuda.py
//                         holds both forms against it on the card)
//   the products' backwards single products, and c's two gradients (from
//   dc and through h) summed once.  An absent dh or dc skips its term
//   (a null pointer), as autograd skips it: no 0 + x, which would turn
//   -0 into +0.  Without dh the o gate's gradient is +0, as the split's
//   backward fills it.  NaN and infinities propagate as in the unfused
//   ops, since the ops are the same.
// Index arithmetic is 64-bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

__device__ __forceinline__ float sigmoid_bwd(float g, float y) {
  return __fmul_rn(__fmul_rn(g, __fsub_rn(1.0f, y)), y);
}

__device__ __forceinline__ float tanh_bwd(float g, float y) {
  return __fmul_rn(g, __fmaf_rn(-y, y, 1.0f));
}

template <int V>
__device__ __forceinline__ void load(const float* __restrict__ p, float* f) {
  if constexpr (V == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  } else {
    f[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store(float* __restrict__ p, const float* f) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  } else {
    *p = f[0];
  }
}

// The four gates' pre-activations z = a + b of V units, and their
// activations: s[0] sigmoid(i), s[1] sigmoid(f), s[2] tanh(g), s[3]
// sigmoid(o).
template <int V>
__device__ __forceinline__ void gates(const float* __restrict__ a,
                                      const float* __restrict__ b, int hidden,
                                      float (*s)[V]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float x[V], y[V];
    load<V>(a + q * hidden, x);
    load<V>(b + q * hidden, y);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float z = __fadd_rn(x[k], y[k]);
      s[q][k] = q == 2 ? tanhf(z) : sigmoid(z);
    }
  }
}

// This thread's row and first unit, or false past the grid's end.
template <int V>
__device__ __forceinline__ bool place(long long rows, int hidden,
                                      long long* r, int* j) {
  const long long per_row = hidden / V;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads
      + threadIdx.x;
  if (t >= rows * per_row) return false;
  *r = t / per_row;
  *j = static_cast<int>(t - *r * per_row) * V;
  return true;
}

template <int V>
__global__ void __launch_bounds__(kThreads) lstm_cell_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ c_prev, long long cp_stride,
    float* __restrict__ c, float* __restrict__ h, long long rows,
    int hidden) {
  long long r;
  int j;
  if (!place<V>(rows, hidden, &r, &j)) return;
  const long long in = r * 4 * hidden + j, out = r * hidden + j;
  float s[4][V], cp[V], cn[V], hn[V];
  gates<V>(a + in, b + in, hidden, s);
  load<V>(c_prev + r * cp_stride + j, cp);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    cn[k] = __fadd_rn(__fmul_rn(s[1][k], cp[k]), __fmul_rn(s[0][k], s[2][k]));
    hn[k] = __fmul_rn(s[3][k], tanhf(cn[k]));
  }
  store<V>(c + out, cn);
  store<V>(h + out, hn);
}

template <int V>
__global__ void __launch_bounds__(kThreads) lstm_cell_bwd_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ c_prev, long long cp_stride,
    const float* __restrict__ dh, long long dh_stride,
    const float* __restrict__ dc, long long dc_stride,
    float* __restrict__ d_gates, float* __restrict__ dc_prev, long long rows,
    int hidden) {
  long long r;
  int j;
  if (!place<V>(rows, hidden, &r, &j)) return;
  const long long in = r * 4 * hidden + j;
  float s[4][V], cp[V], gh[V], gc[V], d[4][V], dcp[V];
  gates<V>(a + in, b + in, hidden, s);
  load<V>(c_prev + r * cp_stride + j, cp);
  if (dh) load<V>(dh + r * dh_stride + j, gh);
  if (dc) load<V>(dc + r * dc_stride + j, gc);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    float dct;
    if (dh) {
      const float tc = tanhf(__fadd_rn(__fmul_rn(s[1][k], cp[k]),
                                       __fmul_rn(s[0][k], s[2][k])));
      d[3][k] = sigmoid_bwd(__fmul_rn(gh[k], tc), s[3][k]);
      const float through_h = tanh_bwd(__fmul_rn(gh[k], s[3][k]), tc);
      dct = dc ? __fadd_rn(gc[k], through_h) : through_h;
    } else {
      d[3][k] = 0.0f;
      dct = gc[k];
    }
    d[0][k] = sigmoid_bwd(__fmul_rn(dct, s[2][k]), s[0][k]);
    d[1][k] = sigmoid_bwd(__fmul_rn(dct, cp[k]), s[1][k]);
    d[2][k] = tanh_bwd(__fmul_rn(dct, s[0][k]), s[2][k]);
    dcp[k] = __fmul_rn(dct, s[1][k]);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) store<V>(d_gates + in + q * hidden, d[q]);
  if (dc_prev) store<V>(dc_prev + r * hidden + j, dcp);
}

bool aligned(const void* p, long long stride) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && stride % 4 == 0;
}

unsigned grid(long long rows, int hidden, int v) {
  const long long threads = rows * (hidden / v);
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

}  // namespace

// a, b (rows, 4 * hidden) contiguous; c_prev (rows, hidden) with row
// stride cp_stride and inner stride 1; c, h (rows, hidden) contiguous: all
// float32 device pointers.  Launches on `stream`, does not synchronise,
// and returns cudaGetLastError() after the launch.
extern "C" int lstm_cell(const void* a, const void* b, const void* c_prev,
                         long long cp_stride, void* c, void* h,
                         long long rows, int hidden, void* stream) {
  if (rows <= 0 || hidden <= 0) return 0;
  const auto* pa = static_cast<const float*>(a);
  const auto* pb = static_cast<const float*>(b);
  const auto* pc = static_cast<const float*>(c_prev);
  auto* oc = static_cast<float*>(c);
  auto* oh = static_cast<float*>(h);
  auto s = static_cast<cudaStream_t>(stream);
  if (hidden % 4 == 0 && aligned(a, 0) && aligned(b, 0)
      && aligned(c_prev, cp_stride) && aligned(c, 0) && aligned(h, 0)) {
    lstm_cell_kernel<4><<<grid(rows, hidden, 4), kThreads, 0, s>>>(
        pa, pb, pc, cp_stride, oc, oh, rows, hidden);
  } else {
    lstm_cell_kernel<1><<<grid(rows, hidden, 1), kThreads, 0, s>>>(
        pa, pb, pc, cp_stride, oc, oh, rows, hidden);
  }
  return static_cast<int>(cudaGetLastError());
}

// As lstm_cell, and dh, dc (rows, hidden) with row strides dh_stride,
// dc_stride and inner stride 1, either null where absent (not both);
// d_gates (rows, 4 * hidden) and dc_prev (rows, hidden) contiguous,
// dc_prev null where not wanted.
extern "C" int lstm_cell_bwd(const void* a, const void* b, const void* c_prev,
                             long long cp_stride, const void* dh,
                             long long dh_stride, const void* dc,
                             long long dc_stride, void* d_gates,
                             void* dc_prev, long long rows, int hidden,
                             void* stream) {
  if (rows <= 0 || hidden <= 0) return 0;
  const auto* pa = static_cast<const float*>(a);
  const auto* pb = static_cast<const float*>(b);
  const auto* pc = static_cast<const float*>(c_prev);
  const auto* gh = static_cast<const float*>(dh);
  const auto* gc = static_cast<const float*>(dc);
  auto* og = static_cast<float*>(d_gates);
  auto* ocp = static_cast<float*>(dc_prev);
  auto s = static_cast<cudaStream_t>(stream);
  if (hidden % 4 == 0 && aligned(a, 0) && aligned(b, 0)
      && aligned(c_prev, cp_stride) && aligned(dh, dh_stride)
      && aligned(dc, dc_stride) && aligned(d_gates, 0)
      && aligned(dc_prev, 0)) {
    lstm_cell_bwd_kernel<4><<<grid(rows, hidden, 4), kThreads, 0, s>>>(
        pa, pb, pc, cp_stride, gh, dh_stride, gc, dc_stride, og, ocp, rows,
        hidden);
  } else {
    lstm_cell_bwd_kernel<1><<<grid(rows, hidden, 1), kThreads, 0, s>>>(
        pa, pb, pc, cp_stride, gh, dh_stride, gc, dc_stride, og, ocp, rows,
        hidden);
  }
  return static_cast<int>(cudaGetLastError());
}

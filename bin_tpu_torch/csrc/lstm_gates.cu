// Fused ConvLSTM gate update for Hopper (sm_90a): K1 (forward) and K1b
// (backward).
//
// Replaces the Pallas TPU kernel bin_tpu/ops/pallas/lstm_gates.py:51
// (`_forward`, body `_gate_kernel` at :30, reached by `fused_lstm_gates`):
//     c' = sigmoid(f + bias) * c + sigmoid(i) * tanh(g)
//     h' = sigmoid(o) * tanh(c')
// with the state math in fp32.
//
// Layout: the gate conv runs in channels_last, so the gate tensor is
// (rows, 4F) with rows = N*H*W and the four blocks i, f, g, o are strided
// slices [0,F), [F,2F), [2F,3F), [3F,4F) of each row.  c, h' and c' are
// (rows, F) fp32.  The Python wrapper checks that layout and refuses any
// other (an NCHW gate tensor is not contiguous once viewed as NHWC).
//
// Bound on the card: bytes.  Each output element reads 4 gate values and c
// and writes h' and c': at the main path's (1, 90, 160, 1024) bf16 gates
// that is 29.5 MB + 14.7 MB read and 29.5 MB written, about 22 us at
// 3.35 TB/s, against some 30 flops per element.  The design reads every
// input once and writes every output once, nothing else: one thread per
// output element, neighbouring threads on neighbouring features, so each of
// the five loads and two stores of a warp is one contiguous run.
// expf/tanhf (not the fast intrinsics) keep it within ~1e-6 of the plain
// PyTorch version.
//
// K1b replaces the same module's VJP (bin_tpu/ops/pallas/lstm_gates.py:81,
// `_bwd`, plain jnp inside the Pallas module's custom_vjp): from the saved
// inputs (gates, c) and the cotangents (dh, dc_out) of (h', c') it
// recomputes the four nonlinearities and c' in fp32 and writes
//     dc'     = dc_out + dh * sigmoid(o) * (1 - tanh(c')^2)
//     dgates  = [dc' tanh(g) si(1-si), dc' c sf(1-sf),
//                dc' si (1-tanh(g)^2), dh tanh(c') so(1-so)]
//     dc      = dc' * sf
// with dgates in the gates' dtype, rounded once.  Bound: bytes again (4F
// gate values, c, dh and dc_out read; 4F dgates and dc written, ~40 flops
// per element): at the training shape, (4, 16, 16, 1024) fp32 gates, that
// is 12.6 MB, about 3.8 us at 3.35 TB/s, short enough that the launch
// itself counts.  Same design as K1: one thread per cell element, the four
// gate blocks read and written as four coalesced runs per warp, every
// tensor touched once.  The products are evaluated in the plain version's
// order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <typename T>
__global__ void lstm_gates_kernel(const T* __restrict__ gates,
                                  const float* __restrict__ c,
                                  float* __restrict__ h_out,
                                  float* __restrict__ c_out, int64_t rows,
                                  int feat, float forget_bias) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= feat) return;
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    const T* g = gates + r * 4 * feat + j;
    const int64_t k = r * feat + j;
    const float gi = to_f32(g[0]);
    const float gf = to_f32(g[feat]);
    const float gg = to_f32(g[2 * feat]);
    const float go = to_f32(g[3 * feat]);
    const float nc = sigmoid(gf + forget_bias) * c[k] + sigmoid(gi) * tanhf(gg);
    h_out[k] = sigmoid(go) * tanhf(nc);
    c_out[k] = nc;
  }
}

template <typename T>
__global__ void lstm_gates_bwd_kernel(const T* __restrict__ gates,
                                      const float* __restrict__ c,
                                      const float* __restrict__ dh,
                                      const float* __restrict__ dc_out,
                                      T* __restrict__ dgates,
                                      float* __restrict__ dc, int64_t rows,
                                      int feat, float forget_bias) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= feat) return;
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    const T* g = gates + r * 4 * feat + j;
    T* dg = dgates + r * 4 * feat + j;
    const int64_t k = r * feat + j;
    const float si = sigmoid(to_f32(g[0]));
    const float sf = sigmoid(to_f32(g[feat]) + forget_bias);
    const float tg = tanhf(to_f32(g[2 * feat]));
    const float so = sigmoid(to_f32(g[3 * feat]));
    const float ck = c[k];
    const float tc = tanhf(sf * ck + si * tg);
    const float dhk = dh[k];
    const float dnc = dc_out[k] + dhk * so * (1.0f - tc * tc);
    dg[0] = from_f32<T>(dnc * tg * si * (1.0f - si));
    dg[feat] = from_f32<T>(dnc * ck * sf * (1.0f - sf));
    dg[2 * feat] = from_f32<T>(dnc * si * (1.0f - tg * tg));
    dg[3 * feat] = from_f32<T>(dhk * tc * so * (1.0f - so));
    dc[k] = dnc * sf;
  }
}

// one thread per feature of a row, rows over the grid's y (wrapping)
inline void grid_for(int64_t rows, int feat, dim3* grid, int* threads) {
  *threads = feat < 256 ? ((feat + 31) / 32) * 32 : 256;
  const int64_t max_y = 65535;
  *grid = dim3((feat + *threads - 1) / *threads,
               (unsigned)(rows < max_y ? rows : max_y));
}

template <typename T>
int launch_bwd(const void* gates, const void* c, const void* dh,
               const void* dc_out, void* dgates, void* dc, int64_t rows,
               int feat, float forget_bias, cudaStream_t stream) {
  dim3 grid;
  int threads;
  grid_for(rows, feat, &grid, &threads);
  lstm_gates_bwd_kernel<T><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(gates), static_cast<const float*>(c),
      static_cast<const float*>(dh), static_cast<const float*>(dc_out),
      static_cast<T*>(dgates), static_cast<float*>(dc), rows, feat,
      forget_bias);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* gates, const void* c, void* h_out, void* c_out,
           int64_t rows, int feat, float forget_bias, cudaStream_t stream) {
  dim3 grid;
  int threads;
  grid_for(rows, feat, &grid, &threads);
  lstm_gates_kernel<T><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(gates), static_cast<const float*>(c),
      static_cast<float*>(h_out), static_cast<float*>(c_out), rows, feat,
      forget_bias);
  return (int)cudaGetLastError();
}

}  // namespace

// gates_bf16: 1 for bf16 gates, 0 for fp32.  Returns a cudaError_t.
extern "C" int btt_lstm_gates(const void* gates, int gates_bf16,
                              const void* c, void* h_out, void* c_out,
                              int64_t rows, int feat, float forget_bias,
                              void* stream) {
  if (rows <= 0 || feat <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gates_bf16)
    return launch<__nv_bfloat16>(gates, c, h_out, c_out, rows, feat,
                                 forget_bias, s);
  return launch<float>(gates, c, h_out, c_out, rows, feat, forget_bias, s);
}

// K1b.  gates_bf16 as above; dgates takes the gates' dtype, dc is fp32.
// Returns a cudaError_t.
extern "C" int btt_lstm_gates_bwd(const void* gates, int gates_bf16,
                                  const void* c, const void* dh,
                                  const void* dc_out, void* dgates, void* dc,
                                  int64_t rows, int feat, float forget_bias,
                                  void* stream) {
  if (rows <= 0 || feat <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gates_bf16)
    return launch_bwd<__nv_bfloat16>(gates, c, dh, dc_out, dgates, dc, rows,
                                     feat, forget_bias, s);
  return launch_bwd<float>(gates, c, dh, dc_out, dgates, dc, rows, feat,
                           forget_bias, s);
}

// Fused ConvLSTM gate update for Hopper (sm_90a).
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
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
int launch(const void* gates, const void* c, void* h_out, void* c_out,
           int64_t rows, int feat, float forget_bias, cudaStream_t stream) {
  const int threads = feat < 256 ? ((feat + 31) / 32) * 32 : 256;
  const int64_t max_y = 65535;
  dim3 grid((feat + threads - 1) / threads,
            (unsigned)(rows < max_y ? rows : max_y));
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

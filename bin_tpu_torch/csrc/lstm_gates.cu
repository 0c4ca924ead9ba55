// Fused ConvLSTM gate update for Hopper (sm_90a): K1 (forward) and K1b
// (backward).
//
// Replaces the Pallas TPU kernel bin_tpu/ops/pallas/lstm_gates.py:51
// (`_forward`, body `_gate_kernel` at :30, reached by `fused_lstm_gates`):
//     c' = sigmoid(f + bias) * c + sigmoid(i) * tanh(g)
//     h' = sigmoid(o) * tanh(c')
// with the state math in fp32.  K1b replaces the same module's VJP
// (:81, `_bwd`, plain jnp inside the Pallas module's custom_vjp): from the
// saved inputs (gates, c) and the cotangents (dh, dc_out) of (h', c') it
// recomputes the four nonlinearities and c' in fp32 and writes
//     dc'     = dc_out + dh * sigmoid(o) * (1 - tanh(c')^2)
//     dgates  = [dc' tanh(g) si(1-si), dc' c sf(1-sf),
//                dc' si (1-tanh(g)^2), dh tanh(c') so(1-so)]
//     dc      = dc' * sf
// with dgates in the gates' dtype, rounded once.
//
// Layout: the gate conv runs in channels_last, so the gate tensor is
// (rows, 4F) with rows = N*H*W and the four blocks i, f, g, o are strided
// slices [0,F), [F,2F), [2F,3F), [3F,4F) of each row.  c, h', c', dh,
// dc_out and dc are (rows, F) fp32.  The Python wrapper checks that layout
// and refuses any other (an NCHW gate tensor is not contiguous once viewed
// as NHWC).
//
// Bound on the card: bytes.  Every input is read once and every output
// written once.  K1 moves 4F gate values, c, h' and c' a row: at the 720p
// clip's (1, 90, 160, 1024) bf16 gates 29.5 + 14.7 MB read and 29.5 MB
// written, 22.0 us at 3.35 TB/s; at the train step's (4, 16, 16, 1024)
// fp32 gates 7.3 MB, 2.2 us; at config5's step (8, 8, 8, 1024) bf16 2.6 MB,
// 0.8 us.  K1b reads 4F gate values, c, dh, dc_out and writes 4F dgates and
// dc: 118 MB, 35.2 us at the 720p shape (bf16), 12.6 MB, 3.8 us at the
// train step's (fp32).  Each does 15-40 flops an element, ~100 instructions
// with expf and tanhf at full precision.
//
// What the first kernels (commit 17563ba) lost, and the design that
// replaces them:
// - They ran one thread per output element on a (F/256, rows) grid of
//   256-thread blocks: 14,400 blocks of a few hundred bytes each at the
//   720p shape, the row wrapping at 65,535.  Now a thread owns a run of V
//   consecutive features of one row (an "item"), and the grid is one
//   dimension over rows x F/V items, at most K1_GRID_WAVES (4) times what
//   the card holds at once (SMs x resident blocks, from
//   cudaOccupancyMaxActiveBlocksPerMultiprocessor, asked once per kernel,
//   device and block size), each thread walking the items with a grid
//   stride.  One wave ran the blocks in step (all loading, then all
//   computing) and was 3-7 % slower at the 720p shape; 4 waves let the
//   block scheduler stagger them.
// - They loaded bf16 gates 2 bytes and c 4 bytes a thread, so a warp's
//   load moved 64 or 128 bytes.  Now, at V = 4, c, dh, dc_out, h', c' and
//   dc move as one 16-byte access a thread (a warp's 512 contiguous bytes),
//   fp32 gate blocks too, and bf16 gate blocks as 8 bytes; K1b's dgates
//   are one store a block.  V = 8 (16 bytes of bf16 gates) was measured
//   and dropped: its fp32 runs take two 16-byte accesses, each of which
//   covers every other 16 bytes of the warp's span, and 64 registers (K1b
//   78) instead of 40 (48): it was slower at all seven bf16 shapes timed.
// - A thread issues every load of its item before the math, so the bytes a
//   warp needs are in flight at once.
// - The plan (ops/lstm_gates.py `k1_plan`) narrows V to 2 or 1 where fewer
//   than 2^17 items would leave the card short of threads (the train steps'
//   shapes), where F is no multiple of V, or where a pointer is not aligned
//   to its access: the same kernel template, narrower accesses, never the
//   plain version.  A thread's first item costs a multiply, not a
//   division, so its loads start at once.
//
// Transcendentals: expf (three sigmoids, the division correctly rounded)
// and tanhf (two), as the first kernels had them and in the same order of
// operations, so each value is what the first kernels computed; the fast
// intrinsics (tanh.approx.f32's ~5e-4) would not hold the 1e-5 the kernels
// are held to.  With the arithmetic cut (tools/k1_ab.py --ablate math) K1
// takes about 1.2 us less at the 720p shape (of ~30.7): the data movement,
// not the math, sets its time there.
//
// The launch floor: an empty launch timed between CUDA events as the
// kernels are (chip_smoke.py's `floor_ms`) takes about 5 us on the H100,
// above every train and config5 step shape's bound; there the launch is
// most of the time.

#include <atomic>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The grid is at most K1_GRID_WAVES times what the card holds at once
// (tools/k1_ab.py varies it with -D)
#ifndef K1_GRID_WAVES
#define K1_GRID_WAVES 4
#endif

namespace {

constexpr int kMaxThreads = 256;  // the largest block the plan gives
constexpr int kMaxDevices = 16;   // devices whose grid limits are kept

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

// the word type of one access of B bytes
template <int B> struct Word;
template <> struct Word<16> { using type = uint4; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<4> { using type = unsigned int; };
template <> struct Word<2> { using type = unsigned short; };

// One store of a word.  The 8- and 16-byte ones are written in PTX: left to
// the compiler, K1b's stores of words whose parts were set one by one came
// out as 4-byte stores.
__device__ __forceinline__ void store_word(uint4* p, uint4 w) {
  asm volatile("st.global.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(p),
               "r"(w.x), "r"(w.y), "r"(w.z), "r"(w.w)
               : "memory");
}
__device__ __forceinline__ void store_word(uint2* p, uint2 w) {
  asm volatile("st.global.v2.u32 [%0], {%1, %2};" ::"l"(p), "r"(w.x),
               "r"(w.y)
               : "memory");
}
__device__ __forceinline__ void store_word(unsigned int* p, unsigned int w) {
  *p = w;
}
__device__ __forceinline__ void store_word(unsigned short* p,
                                           unsigned short w) {
  *p = w;
}

// V consecutive values of T (V <= 4: at most 16 bytes), loaded and stored
// as one word (the pointer aligned to its width), read and written as
// floats.
template <typename T, int V>
struct Run {
  using W = typename Word<V * sizeof(T)>::type;
  union {
    W word;
    T v[V];
  };

  __device__ __forceinline__ void load(const T* __restrict__ p) {
    word = __ldg(reinterpret_cast<const W*>(p));
  }
  __device__ __forceinline__ void store(T* __restrict__ p) const {
    store_word(reinterpret_cast<W*>(p), word);
  }
  __device__ __forceinline__ float get(int e) const { return to_f32(v[e]); }
  __device__ __forceinline__ void set(int e, float x) { v[e] = from_f32<T>(x); }
};

// A thread's walk over the items (row, run of V features): it starts at
// its global index (under 2^31: the grid is capped) and strides by the
// grid's thread count.  The host works out the stride's rows and runs
// (drow, drun) and a multiply that divides by the runs a row (magic,
// shift), so no item waits on a division for its addresses.
struct Extent {
  int64_t rows;
  int64_t drow;
  int drun;
  int runs;
  unsigned magic;
  int shift;
};

struct Walk {
  int64_t row;
  int run;

  __device__ __forceinline__ explicit Walk(const Extent& x) {
    const unsigned item = blockIdx.x * blockDim.x + threadIdx.x;
    const unsigned q = (__umulhi(item, x.magic) + item) >> x.shift;
    row = q;
    run = (int)(item - q * (unsigned)x.runs);
  }
  __device__ __forceinline__ void next(const Extent& x) {
    row += x.drow;
    run += x.drun;
    if (run >= x.runs) {
      run -= x.runs;
      ++row;
    }
  }
};

// Each thread's items, each loaded whole before its math
template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
    lstm_gates_kernel(const T* __restrict__ gates,
                      const float* __restrict__ c, float* __restrict__ h_out,
                      float* __restrict__ c_out, int feat, float forget_bias,
                      const Extent x) {
  for (Walk w(x); w.row < x.rows; w.next(x)) {
    const int64_t k = w.row * feat + (int64_t)w.run * V;
    const T* g = gates + w.row * 4 * feat + (int64_t)w.run * V;
    Run<T, V> gi, gf, gg, go;
    Run<float, V> ck, h, nc;
    gi.load(g);
    gf.load(g + feat);
    gg.load(g + 2 * feat);
    go.load(g + 3 * feat);
    ck.load(c + k);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float n = sigmoid(gf.get(e) + forget_bias) * ck.get(e) +
                      sigmoid(gi.get(e)) * tanhf(gg.get(e));
      h.set(e, sigmoid(go.get(e)) * tanhf(n));
      nc.set(e, n);
    }
    h.store(h_out + k);
    nc.store(c_out + k);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
    lstm_gates_bwd_kernel(const T* __restrict__ gates,
                          const float* __restrict__ c,
                          const float* __restrict__ dh,
                          const float* __restrict__ dc_out,
                          T* __restrict__ dgates, float* __restrict__ dc,
                          int feat, float forget_bias, const Extent x) {
  for (Walk w(x); w.row < x.rows; w.next(x)) {
    const int64_t k = w.row * feat + (int64_t)w.run * V;
    const int64_t r = w.row * 4 * feat + (int64_t)w.run * V;
    Run<T, V> gi, gf, gg, go;
    Run<float, V> ck, dhk, dck, dcn;
    gi.load(gates + r);
    gf.load(gates + r + feat);
    gg.load(gates + r + 2 * feat);
    go.load(gates + r + 3 * feat);
    ck.load(c + k);
    dhk.load(dh + k);
    dck.load(dc_out + k);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float si = sigmoid(gi.get(e));
      const float sf = sigmoid(gf.get(e) + forget_bias);
      const float tg = tanhf(gg.get(e));
      const float so = sigmoid(go.get(e));
      const float cv = ck.get(e);
      const float tc = tanhf(sf * cv + si * tg);
      const float dhv = dhk.get(e);
      const float dnc = dck.get(e) + dhv * so * (1.0f - tc * tc);
      // the gate cotangents overwrite the gates' registers, each block
      // after its last read
      gi.set(e, dnc * tg * si * (1.0f - si));
      gf.set(e, dnc * cv * sf * (1.0f - sf));
      gg.set(e, dnc * si * (1.0f - tg * tg));
      go.set(e, dhv * tc * so * (1.0f - so));
      dcn.set(e, dnc * sf);
    }
    gi.store(dgates + r);
    gf.store(dgates + r + feat);
    gg.store(dgates + r + 2 * feat);
    go.store(dgates + r + 3 * feat);
    dcn.store(dc + k);
  }
}

// Blocks of `threads` the grid takes for `items`: a thread an item, up to
// K1_GRID_WAVES times what the card holds at once (SMs x resident blocks of
// `kernel`), asked of the runtime once per device and block size and kept
// in `cache` as (threads << 32) | blocks.
int64_t grid_blocks(std::atomic<int64_t>* cache, const void* kernel,
                    int64_t items, int threads) {
  int dev = 0;
  cudaGetDevice(&dev);
  int64_t cap = 0;
  if (dev < kMaxDevices) {
    const int64_t kept = cache[dev].load(std::memory_order_relaxed);
    if ((kept >> 32) == threads) cap = kept & 0xffffffff;
  }
  if (cap == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                  0);
    cap = (int64_t)(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1) *
          K1_GRID_WAVES;
    if (dev < kMaxDevices)
      cache[dev].store(((int64_t)threads << 32) | cap,
                       std::memory_order_relaxed);
  }
  const int64_t need = (items + threads - 1) / threads;
  return need < cap ? need : cap;
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The grid of `threads`-thread blocks for rows x feat / V items, and its
// extent
template <int V>
int64_t grid_for(std::atomic<int64_t>* cache, const void* kernel,
                 int64_t rows, int feat, int threads, Extent* x) {
  const int runs = feat / V;
  const int64_t blocks = grid_blocks(cache, kernel, rows * runs, threads);
  const int64_t stride = blocks * threads;
  // n / runs == (umulhi(n, magic) + n) >> shift for n < 2^31
  int shift = 0;
  while ((1ll << shift) < runs) ++shift;
  const uint64_t magic =
      ((1ull << 32) * ((1ull << shift) - runs)) / runs + 1;
  *x = {rows, stride / runs, (int)(stride % runs), runs, (unsigned)magic,
        shift};
  return blocks;
}

template <typename T, int V>
int launch(const void* gates, const void* c, void* h_out, void* c_out,
           int64_t rows, int feat, float forget_bias, int threads,
           cudaStream_t stream) {
  static std::atomic<int64_t> cache[kMaxDevices];
  if (!aligned(gates, V * sizeof(T)) || !aligned(c, V * 4) ||
      !aligned(h_out, V * 4) || !aligned(c_out, V * 4))
    return (int)cudaErrorMisalignedAddress;
  Extent x;
  const int64_t blocks = grid_for<V>(
      cache, reinterpret_cast<const void*>(lstm_gates_kernel<T, V>), rows,
      feat, threads, &x);
  lstm_gates_kernel<T, V><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(gates), static_cast<const float*>(c),
      static_cast<float*>(h_out), static_cast<float*>(c_out), feat,
      forget_bias, x);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_bwd(const void* gates, const void* c, const void* dh,
               const void* dc_out, void* dgates, void* dc, int64_t rows,
               int feat, float forget_bias, int threads,
               cudaStream_t stream) {
  static std::atomic<int64_t> cache[kMaxDevices];
  if (!aligned(gates, V * sizeof(T)) || !aligned(dgates, V * sizeof(T)) ||
      !aligned(c, V * 4) || !aligned(dh, V * 4) || !aligned(dc_out, V * 4) ||
      !aligned(dc, V * 4))
    return (int)cudaErrorMisalignedAddress;
  Extent x;
  const int64_t blocks = grid_for<V>(
      cache, reinterpret_cast<const void*>(lstm_gates_bwd_kernel<T, V>), rows,
      feat, threads, &x);
  lstm_gates_bwd_kernel<T, V><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(gates), static_cast<const float*>(c),
      static_cast<const float*>(dh), static_cast<const float*>(dc_out),
      static_cast<T*>(dgates), static_cast<float*>(dc), feat, forget_bias,
      x);
  return (int)cudaGetLastError();
}

// vec and threads as the plan gives them: V of 1, 2 or 4 that divides feat,
// threads a multiple of 32 up to kMaxThreads
bool valid(int64_t rows, int feat, int vec, int threads) {
  return rows > 0 && feat > 0 && (vec == 1 || vec == 2 || vec == 4) &&
         feat % vec == 0 && threads >= 32 && threads <= kMaxThreads &&
         threads % 32 == 0;
}

// K1 and K1b of gates T at the plan's vec
template <typename T>
int launch_vec(int vec, const void* gates, const void* c, void* h_out,
               void* c_out, int64_t rows, int feat, float forget_bias,
               int threads, cudaStream_t s) {
  switch (vec) {
    case 4: return launch<T, 4>(gates, c, h_out, c_out, rows, feat,
                                forget_bias, threads, s);
    case 2: return launch<T, 2>(gates, c, h_out, c_out, rows, feat,
                                forget_bias, threads, s);
    default: return launch<T, 1>(gates, c, h_out, c_out, rows, feat,
                                 forget_bias, threads, s);
  }
}

template <typename T>
int launch_bwd_vec(int vec, const void* gates, const void* c, const void* dh,
                   const void* dc_out, void* dgates, void* dc, int64_t rows,
                   int feat, float forget_bias, int threads,
                   cudaStream_t s) {
  switch (vec) {
    case 4: return launch_bwd<T, 4>(gates, c, dh, dc_out, dgates, dc, rows,
                                    feat, forget_bias, threads, s);
    case 2: return launch_bwd<T, 2>(gates, c, dh, dc_out, dgates, dc, rows,
                                    feat, forget_bias, threads, s);
    default: return launch_bwd<T, 1>(gates, c, dh, dc_out, dgates, dc, rows,
                                     feat, forget_bias, threads, s);
  }
}

}  // namespace

// gates_bf16: 1 for bf16 gates, 0 for fp32.  vec: the features a thread
// takes at once (1, 2 or 4); threads: the block size (ops/lstm_gates.py
// `k1_plan`).  Returns a cudaError_t.
extern "C" int btt_lstm_gates(const void* gates, int gates_bf16,
                              const void* c, void* h_out, void* c_out,
                              int64_t rows, int feat, float forget_bias,
                              int vec, int threads, void* stream) {
  if (!valid(rows, feat, vec, threads)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gates_bf16)
    return launch_vec<__nv_bfloat16>(vec, gates, c, h_out, c_out, rows, feat,
                                     forget_bias, threads, s);
  return launch_vec<float>(vec, gates, c, h_out, c_out, rows, feat,
                           forget_bias, threads, s);
}

// K1b.  gates_bf16, vec and threads as above; dgates takes the gates'
// dtype, dc is fp32.  Returns a cudaError_t.
extern "C" int btt_lstm_gates_bwd(const void* gates, int gates_bf16,
                                  const void* c, const void* dh,
                                  const void* dc_out, void* dgates, void* dc,
                                  int64_t rows, int feat, float forget_bias,
                                  int vec, int threads, void* stream) {
  if (!valid(rows, feat, vec, threads)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gates_bf16)
    return launch_bwd_vec<__nv_bfloat16>(vec, gates, c, dh, dc_out, dgates,
                                         dc, rows, feat, forget_bias,
                                         threads, s);
  return launch_bwd_vec<float>(vec, gates, c, dh, dc_out, dgates, dc, rows,
                               feat, forget_bias, threads, s);
}

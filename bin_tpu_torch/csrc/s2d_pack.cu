// Input pack (space-to-depth) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel bin_tpu/ops/pallas/s2d_pack.py:69
// (`_forward`, body `_pack_kernel` at :41, reached by
// `space_to_depth_pallas`):
//     (N, H, W, C) -> (N, H/f, W/f, f*f*C),
//     out[n, yo, xo, (dy*f + dx)*C + c] = in[n, yo*f + dy, xo*f + dx, c].
// A pure permutation: the kernel moves bits, so it is exact at every dtype
// (u8, bf16, fp32).  The caller casts first and packs after, as bin_tpu does.
//
// Bound on the card: bytes.  The main path packs a (1, 8, 720, 1280, 3)
// bf16 clip once: 44.2 MB read and 44.2 MB written, about 26 us at
// 3.35 TB/s, with no arithmetic.  On the TPU the pack was a VMEM relayout
// because XLA's transpose of a 3-wide minor axis crawled.  Here the design
// rests on one fact: the f*C values (dx, c) of one input row and one output
// cell are contiguous on both sides,
//     out[n, yo, xo, dy, :] = in[n, yo*f + dy, xo, :]   (runs of R = f*C),
// so the pack is a copy of runs.  The caller picks the widest word (up to
// 16 bytes) that divides a run's bytes and both base addresses; for the
// main path's bf16 runs of 6 values that is 4 bytes, 3 words a run.  One
// block row per output image row; neighbouring threads write neighbouring
// words (coalesced stores) and read the f input rows in runs of R words.
// Index math stays in 32 bits inside a row; only row offsets are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename W>
__global__ void s2d_pack_kernel(const W* __restrict__ x, W* __restrict__ out,
                                int64_t out_rows, int ho, int wo, int f,
                                int run) {
  const int row_len = wo * f * run;  // words in one output row
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= row_len) return;
  const int t = p / run, r = p - t * run;
  const int xo = t / f, dy = t - xo * f;
  for (int64_t orow = blockIdx.y; orow < out_rows; orow += gridDim.y) {
    const int64_t n = orow / ho;
    const int yo = (int)(orow - n * ho);
    const int64_t irow = n * ho * f + (int64_t)yo * f + dy;  // n*H + y
    out[orow * row_len + p] = x[(irow * wo + xo) * run + r];
  }
}

template <typename W>
int launch(const void* x, void* out, int64_t out_rows, int ho, int wo, int f,
           int run, cudaStream_t stream) {
  const int threads = 256;
  const int64_t max_y = 65535;
  const int row_len = wo * f * run;
  dim3 grid((row_len + threads - 1) / threads,
            (unsigned)(out_rows < max_y ? out_rows : max_y));
  s2d_pack_kernel<W><<<grid, threads, 0, stream>>>(
      static_cast<const W*>(x), static_cast<W*>(out), out_rows, ho, wo, f,
      run);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (n, h, w, c) contiguous; out: (n, h/f, w/f, f*f*c) contiguous; a run of
// f*c elements is run_bytes bytes, copied as words of word_bytes (1, 2, 4,
// 8 or 16; it must divide run_bytes and both addresses).  Returns a
// cudaError_t.
extern "C" int btt_s2d_pack(const void* x, void* out, int64_t n, int h, int w,
                            int f, int run_bytes, int word_bytes,
                            void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || f <= 0 || h % f || w % f ||
      word_bytes <= 0 || run_bytes % word_bytes ||
      reinterpret_cast<uintptr_t>(x) % word_bytes ||
      reinterpret_cast<uintptr_t>(out) % word_bytes)
    return (int)cudaErrorInvalidValue;
  const int ho = h / f, wo = w / f, run = run_bytes / word_bytes;
  const int64_t out_rows = n * ho;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (word_bytes) {
    case 1: return launch<uint8_t>(x, out, out_rows, ho, wo, f, run, s);
    case 2: return launch<uint16_t>(x, out, out_rows, ho, wo, f, run, s);
    case 4: return launch<uint32_t>(x, out, out_rows, ho, wo, f, run, s);
    case 8: return launch<uint2>(x, out, out_rows, ho, wo, f, run, s);
    case 16: return launch<uint4>(x, out, out_rows, ho, wo, f, run, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

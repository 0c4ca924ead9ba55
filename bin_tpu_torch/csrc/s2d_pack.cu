// Input pack (space-to-depth) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel bin_tpu/ops/pallas/s2d_pack.py:69
// (`_forward`, body `_pack_kernel` at :41, reached by
// `space_to_depth_pallas`):
//     (N, H, W, C) -> (N, H/f, W/f, f*f*C),
//     out[n, yo, xo, (dy*f + dx)*C + c] = in[n, yo*f + dy, xo*f + dx, c].
// A pure permutation: the kernel moves bytes, so it is exact at every dtype
// (u8, bf16, fp32).  The caller casts first and packs after, as bin_tpu does.
//
// Bound on the card: bytes.  The main path packs a (1, 8, 720, 1280, 3)
// bf16 clip once: 44.2 MB read and 44.2 MB written, 26.4 us at 3.35 TB/s,
// with no arithmetic.  Reaching it takes 16-byte accesses and some 2 MB in
// flight across the card; the runs that the pack moves are f*C values (12
// bytes on the main path), too short for either when copied directly.
//
// The design rests on bands.  Output row (n, yo) is built from input rows
// yo*f .. yo*f + f-1 of image n, which are one contiguous span of f*W*C
// values, and the output row is one contiguous span of the same length:
//     out[n, yo, xo, dy, :] = in[n, yo*f + dy, xo, :]   (runs of f*C).
// So the pack permutes runs inside independent bands (15,360 bytes each on
// the main path, 2,880 of them).  A tile is a band, or a chunk of `cells`
// output cells of it when a band is larger than a stage: it reads f input
// segments (one per dy) and writes one output segment.  Where even the
// fewest cells overflow a stage (very wide C), a tile is one cell and a
// `slice` of each of its f runs instead, and writes f output pieces.
//
// One persistent grid, two blocks per SM, each walking over tiles.  A block
// keeps a ring of kStages stages in shared memory: the loads of the next
// two tiles (cp.async, 16 bytes a thread where the addresses allow) are in
// flight while it permutes this tile in shared memory and stores it with
// 16-byte stores, neighbouring threads on neighbouring words.  On the main
// path that is up to 60 KB of loads in flight per SM.
//
// The global word (16, 8, 4, 2 or 1 bytes) is the widest that divides both
// base addresses, the input row's bytes and, for sliced runs, the run's
// bytes; the caller (bin_tpu_torch/ops/pixel_shuffle.py `pack_plan`) picks
// it and the tile, so that every segment is a whole number of words.  Words
// of 4 bytes or more load with cp.async; narrower words (a view at an odd
// address) load with plain loads through the same ring.  Inside shared
// memory a word is assembled from pieces of the widest size that divides
// both the word and the run, so a piece never straddles two runs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kStages = 3;
constexpr int kBlocksPerSm = 2;
constexpr int kMaxStageBytes = 64 * 1024;  // kStages of them fit an SM

template <int B> struct Word;
template <> struct Word<1> { using T = uint8_t; };
template <> struct Word<2> { using T = uint16_t; };
template <> struct Word<4> { using T = uint32_t; };
template <> struct Word<8> { using T = uint2; };
template <> struct Word<16> { using T = uint4; };

struct Plan {
  int64_t row_bytes;     // one input row, W*C*elem
  int64_t tiles;         // out_rows * chunks * slices
  int f, run_bytes;      // a run is f*C*elem bytes
  int cells, slice;      // output cells and run bytes per tile
  int chunks, slices;    // tiles of one band: ceil(Wo/cells) * ceil(run/slice)
  int wo;                // output cells per row
};

struct Tile {
  const char* in;  // segment of dy = 0; dy's segment is row_bytes further
  char* out;       // output byte of (cell 0, dy 0, r 0)
  int seg;         // bytes of one input segment: cells * slice of this tile
  int slice;       // run bytes of this tile
};

__device__ __forceinline__ Tile tile_at(const Plan& p, const char* x,
                                        char* out, int64_t t) {
  const int per_row = p.chunks * p.slices;
  const int64_t orow = t / per_row;
  const int k = (int)(t - orow * per_row);
  const int chunk = k / p.slices, sl = k - chunk * p.slices;
  const int x0 = chunk * p.cells, r0 = sl * p.slice;
  const int cells = min(p.cells, p.wo - x0);
  const int slice = min(p.slice, p.run_bytes - r0);
  Tile tl;
  // input row of (orow, dy) is orow*f + dy; an output row is f input rows
  tl.in = x + orow * p.f * p.row_bytes + (int64_t)x0 * p.run_bytes + r0;
  tl.out = out + orow * p.f * p.row_bytes + (int64_t)x0 * p.f * p.run_bytes +
           r0;
  tl.seg = cells * slice;
  tl.slice = slice;
  return tl;
}

template <int L>
__device__ __forceinline__ void load_word(char* dst, const char* src) {
  if constexpr (L >= 4) {
    const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
    if constexpr (L == 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                   "l"(src));
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                   "l"(src), "n"(L));
  } else {
    using W = typename Word<L>::T;
    *reinterpret_cast<W*>(dst) = *reinterpret_cast<const W*>(src);
  }
}

// The f input segments of tile `tl` into stage `s`, as words of L bytes;
// segment dy lands at s + dy*seg.
template <int L>
__device__ __forceinline__ void load_tile(const Tile& tl, char* s, int f,
                                          int64_t row_bytes) {
  const int words = tl.seg / L;
  for (int dy = 0; dy < f; ++dy) {
    const char* src = tl.in + dy * row_bytes;
    char* dst = s + dy * tl.seg;
    for (int j = threadIdx.x; j < words; j += kThreads)
      load_word<L>(dst + j * L, src + j * L);
  }
}

// Output word k of a tile is bytes [k*L, k*L + L) of (cell, dy, r) in that
// order, r over the tile's slice; in the stage that byte sits at
// dy*seg + cell*slice + r.  Each word is gathered in pieces of G bytes.
template <int L, int G>
__device__ __forceinline__ void store_tile(const Tile& tl, const char* s,
                                           int f, int run_bytes) {
  using W = typename Word<L>::T;
  using P = typename Word<G>::T;
  union {
    W w;
    P p[L / G];
  } v;
  const int words = f * tl.seg / L;
  for (int k = threadIdx.x; k < words; k += kThreads) {
    const int o = k * L;
    const int q = o / tl.slice;
    int r = o - q * tl.slice;
    int cell = q / f;
    int dy = q - cell * f;
    char* dst = tl.out + (int64_t)(cell * f + dy) * run_bytes + r;
#pragma unroll
    for (int j = 0; j < L / G; ++j) {
      v.p[j] = *reinterpret_cast<const P*>(s + dy * tl.seg +
                                           cell * tl.slice + r);
      r += G;
      if (r == tl.slice) {
        r = 0;
        if (++dy == f) {
          dy = 0;
          ++cell;
        }
      }
    }
    *reinterpret_cast<W*>(dst) = v.w;
  }
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int L, int G>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    s2d_pack_kernel(const char* __restrict__ x, char* __restrict__ out,
                    Plan p) {
  extern __shared__ __align__(16) char ring[];
  const int stage_bytes = p.f * p.cells * p.slice;
  const int64_t step = gridDim.x;
  int64_t t = blockIdx.x;
  // prologue: the first kStages - 1 tiles, one commit group each (a group
  // may be empty: the counting below needs one group per tile slot)
  for (int i = 0; i < kStages - 1; ++i) {
    const int64_t ti = t + i * step;
    if (ti < p.tiles)
      load_tile<L>(tile_at(p, x, out, ti), ring + i * stage_bytes, p.f,
                   p.row_bytes);
    commit();
  }
  for (int i = 0; t < p.tiles; ++i, t += step) {
    wait_pending<kStages - 2>();  // this thread's copies of tile i landed
    __syncthreads();  // everyone's did, and everyone left tile i-1's stage
    const int64_t tn = t + (kStages - 1) * step;
    if (tn < p.tiles)
      load_tile<L>(tile_at(p, x, out, tn),
                   ring + ((i + kStages - 1) % kStages) * stage_bytes, p.f,
                   p.row_bytes);
    commit();
    store_tile<L, G>(tile_at(p, x, out, t), ring + (i % kStages) * stage_bytes,
                     p.f, p.run_bytes);
  }
  wait_pending<0>();
}

template <int L, int G>
int launch(const void* x, void* out, const Plan& p, cudaStream_t stream) {
  auto kernel = s2d_pack_kernel<L, G>;
  const int smem = kStages * p.f * p.cells * p.slice;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  const int64_t most = (int64_t)kBlocksPerSm * sms;
  const int blocks = (int)(p.tiles < most ? p.tiles : most);
  kernel<<<blocks, kThreads, smem, stream>>>(static_cast<const char*>(x),
                                             static_cast<char*>(out), p);
  return (int)cudaGetLastError();
}

template <int L>
int launch_word(const void* x, void* out, const Plan& p, int piece,
                cudaStream_t s) {
  switch (piece) {
    case 1: return launch<L, 1>(x, out, p, s);
    case 2: if constexpr (L >= 2) return launch<L, 2>(x, out, p, s); break;
    case 4: if constexpr (L >= 4) return launch<L, 4>(x, out, p, s); break;
    case 8: if constexpr (L >= 8) return launch<L, 8>(x, out, p, s); break;
    case 16: if constexpr (L >= 16) return launch<L, 16>(x, out, p, s); break;
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x: (n, h, w, c) contiguous; out: (n, h/f, w/f, f*f*c) contiguous, with
// out_rows = n*h/f output rows.  row_bytes = w*c*elem, run_bytes = f*c*elem.
// The plan (pixel_shuffle.pack_plan): global words of `word` bytes (1, 2, 4,
// 8 or 16; it divides both addresses and row_bytes), tiles of `cells`
// output cells and `slice` bytes of each run (slice = run_bytes, or cells =
// 1 and word divides slice and run_bytes), cells*slice a whole number of
// words.  Returns a cudaError_t.
extern "C" int btt_s2d_pack(const void* x, void* out, int64_t out_rows,
                            int f, int64_t row_bytes, int run_bytes,
                            int word, int cells, int slice, void* stream) {
  const bool word_ok = word == 1 || word == 2 || word == 4 || word == 8 ||
                       word == 16;
  if (!word_ok || out_rows <= 0 || f <= 1 || run_bytes <= 0 ||
      row_bytes <= 0 || row_bytes % run_bytes || row_bytes % word ||
      cells <= 0 || slice <= 0 || slice > run_bytes ||
      (slice < run_bytes && (cells != 1 || slice % word || run_bytes % word)) ||
      ((int64_t)cells * slice) % word ||
      (int64_t)f * cells * slice > kMaxStageBytes ||
      reinterpret_cast<uintptr_t>(x) % word ||
      reinterpret_cast<uintptr_t>(out) % word)
    return (int)cudaErrorInvalidValue;
  Plan p;
  p.row_bytes = row_bytes;
  p.f = f;
  p.run_bytes = run_bytes;
  p.wo = (int)(row_bytes / run_bytes);
  p.cells = cells < p.wo ? cells : p.wo;
  p.slice = slice;
  p.chunks = (p.wo + p.cells - 1) / p.cells;
  p.slices = (run_bytes + slice - 1) / slice;
  p.tiles = out_rows * p.chunks * p.slices;
  // pieces: the widest size that divides the word and the slice
  int piece = word;
  while (slice % piece) piece /= 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (word) {
    case 1: return launch_word<1>(x, out, p, piece, s);
    case 2: return launch_word<2>(x, out, p, piece, s);
    case 4: return launch_word<4>(x, out, p, piece, s);
    case 8: return launch_word<8>(x, out, p, piece, s);
    default: return launch_word<16>(x, out, p, piece, s);
  }
}

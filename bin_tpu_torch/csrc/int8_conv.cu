// Int8 serving convs for Hopper (sm_90a): K3q, the activation quantize, and
// K3, an int8 implicit-GEMM 3x3 conv with its fp32 epilogue.
//
// Neither replaces a Pallas kernel: bin_tpu runs its PTQ conv
// (bin_tpu/ops/quant.py `int8_conv`) as one XLA conv with int8 operands and
// int32 accumulation, and PyTorch has no int8 conv on CUDA.  Both must be
// bit-exact with that function, so every float step is an IEEE operation
// rounded on its own (the _rn intrinsics: nvcc would contract a*b+c into an
// FMA, which bin_tpu does not do).
//
// K3q:  q = clamp(rint(x / s), -127, 127), x bf16 or fp32, s one fp32 value
//       read from device memory.  A division, never a multiply by 1/s.
//       Bound: bytes (one read of x, one int8 write); 16 values a thread,
//       16-byte loads and stores.
//
// K3:   out[m, co] = epilogue(sum_k A[m, k] * B[co, k]) over the GEMM view
//       M = N*Ho*Wo output pixels, N = Cout, K = 9*Cin ordered (kh, kw, cin):
//       A is the im2col of the NHWC int8 input, never materialised; B is the
//       weight packed (Cout, 3, 3, Cin).  SAME output size, top/left
//       padding (pt, pl) (flax SAME is asymmetric, (0, 1), for stride 2 on
//       even sizes); taps outside the input read zero.
//       epilogue: v = fp32(acc) * (ascale * kscale[co]); v += bias[co];
//       v = addend[m, co] + v; the round-to-nearest cast to bf16 (or fp32
//       as is); then, optionally, the LeakyReLU v > 0 ? v : v * slope and
//       the residual add residual[m, co] + v, each rounded to the output
//       dtype: the pass that follows each int8 conv of the backbone, in the
//       order the eager model runs it.
//       Bound: operations.  At the main path's widest conv, (3, 180, 320,
//       256) -> 256, the 2.0e11 int8 ops take 0.10 ms at 1979 TOP/s against
//       0.04 ms for its bytes.  Only wgmma reaches the s8 tensor cores' full
//       rate, so the design is Hopper's GEMM shape applied to implicit GEMM:
//       - an M tile is a BH x BW block of output pixels of one image; its A
//         for one (tap, chunk of CK input channels) is ONE 4-D TMA box over
//         the NHWC input, (CK, BW, BH, 1) from (c0, ox0*s + kw - pl,
//         oy0*s + kh - pt, n), with traversal strides (1, s, s, 1) for
//         stride s.  TMA zero-fills what lies outside the input, negative
//         coordinates included: that is the SAME padding and the ragged
//         edge, with no masking in the kernel;
//       - B is a 2-D TMA box (CK bytes of K, BN = 128 rows of Cout) of the
//         weight, which is K-major as wgmma's 8-bit operands must be;
//       - CK is 128 bytes where Cin allows (64 or 32 otherwise), with the
//         TMA swizzle of the same width, which the wgmma descriptors name;
//       - one producer thread issues the loads into a ring of stages with
//         a full and an empty mbarrier each;
//       - two consumer warpgroups, each on a 128 x 128 tile of its own:
//         per 32-byte k-step two wgmma m64n128k32 s8, int32 sums in
//         registers, one group in flight, a stage freed only once the
//         group that read it has completed;
//       - a persistent grid of one block per SM walks the tiles; the ring
//         hands them to the consumers in turn, so one consumer's epilogue
//         (staged through shared memory so that it reads and writes
//         global memory coalesced) runs beside the other's wgmma.
//       Why each choice was kept (PERF.md; tools/k3_ab.py, in turns on the
//       card, its --ablate cuts): with the loads alone the kernel takes
//       19.0 ms per clip, with the wgmma alone 18.0, with both 23.9, and
//       the epilogue brings it to 28.5.  An epilogue written straight from
//       the fragment (4-byte stores over rows, and the reads the compiler
//       kept behind them) cost several times this one, which stages through
//       shared memory.  Both consumers on one 128 x 256 tile came out even
//       with this ping-pong: the first moves fewer bytes through shared
//       memory per operation, the second hides part of its epilogue.
//       Clusters of two CTAs sharing B by TMA multicast were slower: the
//       two CTAs' rings wait on each other.  4 stages beat 3 and 5; the
//       producer's 24 registers and the epilogue's reads issued 4 rows at
//       a time leave the consumers room (4 bytes spill).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {


// ---------------------------------------------------------------- K3q

__device__ __forceinline__ int8_t quant1(float v, float s) {
  float r = rintf(__fdiv_rn(v, s));  // half to even, as jnp/torch round
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return static_cast<int8_t>(static_cast<int>(r));
}

__device__ __forceinline__ void load16(const float* p, float (&v)[16]) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 f = p4[j];
    v[4 * j] = f.x;
    v[4 * j + 1] = f.y;
    v[4 * j + 2] = f.z;
    v[4 * j + 3] = f.w;
  }
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&v)[16]) {
  const uint4* p4 = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const uint4 u = p4[j];
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      // bf16 -> fp32 is exact: the bits move to the top half
      v[8 * j + 2 * t] = __uint_as_float(w[t] << 16);
      v[8 * j + 2 * t + 1] = __uint_as_float(w[t] & 0xffff0000u);
    }
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void quantize_act_kernel(const T* __restrict__ x,
                                    const float* __restrict__ scale,
                                    int8_t* __restrict__ q, int64_t n) {
  const float s = *scale;
  const int64_t n16 = n / 16;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int64_t i = first; i < n16; i += step) {
    float v[16];
    load16(x + i * 16, v);
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t packed = 0;
#pragma unroll
      for (int t = 0; t < 4; ++t)
        packed |= (uint32_t)(uint8_t)quant1(v[4 * j + t], s) << (8 * t);
      w[j] = packed;
    }
    reinterpret_cast<uint4*>(q)[i] = make_uint4(w[0], w[1], w[2], w[3]);
  }
  for (int64_t i = n16 * 16 + first; i < n; i += step)  // the ragged tail
    q[i] = quant1(to_f32(x[i]), s);
}

// ---------------------------------------------------------------- K3

// The tiling.  The shipped build takes these defaults; tools/k3_ab.py
// builds the same source with other values (-DK3_MAX_STAGES=4 ...) to
// compare them.
#ifndef K3_BH
#define K3_BH 4  // output rows of an M tile
#endif
#ifndef K3_BW
#define K3_BW 32  // output columns of an M tile
#endif
#ifndef K3_MAX_STAGES
#define K3_MAX_STAGES 4
#endif
#ifndef K3_PRODUCER_REGS
#define K3_PRODUCER_REGS 24  // the producer warpgroup's registers a thread
#endif
#ifndef K3_EPI_BATCH
#define K3_EPI_BATCH 4  // rows whose global reads the epilogue issues at once
#endif

constexpr int BH = K3_BH, BW = K3_BW, BM = BH * BW, BN = 128;
constexpr int SLABS = BM / 64;  // m64 wgmmas a k-step, 64 tile rows each
static_assert(BM % 64 == 0 && SLABS <= 2, "M tile");
// two consumer warpgroups, each on a tile of its own, and the producer's;
// setmaxnreg moves the producer's unused registers to the consumers
constexpr int THREADS = 3 * 128;
constexpr int PRODUCER_REGS = K3_PRODUCER_REGS;
constexpr int CONSUMER_REGS = (65536 / THREADS / 8 * 8 * THREADS -
                               128 * PRODUCER_REGS) / 256 / 8 * 8;
constexpr int SMEM_LIMIT = 232448;  // the most a block may take on sm_90
// The epilogue stages a slab's sums through shared memory 64 columns at a
// time, per consumer; a row pitch of 72 int32 puts the four rows of a
// half-warp's 8-byte writes on distinct banks.
constexpr int EPI_COLS = 64, EPI_PITCH = 72;
constexpr int STAGING = 2 * 64 * EPI_PITCH * 4;

// One stage holds A (BM rows of CK bytes) and B (BN rows of CK bytes), each
// a whole number of the swizzle's 8-row repeat, so every tile starts on
// that repeat and the wgmma descriptors need no base offset.  Shared
// memory: 1024 bytes of slack to align the ring, the ring, a full and an
// empty mbarrier per stage, a turn mbarrier per consumer, the epilogue's
// staging; as many stages as fit.
template <int CK>
struct Tiling {
  static constexpr int A_BYTES = BM * CK, B_BYTES = BN * CK;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int FIT =
      (SMEM_LIMIT - 1024 - 16 - STAGING - 16 * K3_MAX_STAGES) / STAGE;
  static constexpr int STAGES = FIT < K3_MAX_STAGES ? FIT : K3_MAX_STAGES;
  static constexpr int SMEM = 1024 + STAGES * (STAGE + 16) + 16 + STAGING;
  static_assert(CK == 128 || CK == 64 || CK == 32, "chunk");
  static_assert(BN % EPI_COLS == 0, "epilogue passes");
  static_assert(STAGES >= 2 && SMEM <= SMEM_LIMIT, "ring");
};

struct ConvArgs {
  const float* ascale;   // one value
  const float* kscale;   // (cout,)
  const float* bias;     // (cout,) or null
  const float* addend;   // (n, ho, wo, cout) fp32, or null
  const void* residual;  // (n, ho, wo, cout) in the output dtype, or null
  void* out;             // (n, ho, wo, cout), bf16 or fp32
  int ho, wo, cin, cout, stride, pt, pl, out_bf16, leaky;
  float slope;
  int tiles_x, tiles_y, n_tiles, tiles;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_test(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the phase of parity `parity` to complete.  A wait that lasts
// seconds means a fault in the pipeline (a transaction count that never
// arrives): trap, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_test(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_test(bar, parity))
    if (clock64() - t0 > (1ll << 33)) __trap();
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// A K-major operand in shared memory under the swizzle of CK bytes: row r
// of the tile at (r / 8) * SBO + (r % 8) * CK from its start, SBO = 8 CK
// (rows are dense); the leading offset is unused when a k-step (32 bytes)
// lies inside one swizzled row.  A k-step of 32 bytes adds 32 to the start.
template <int CK>
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)((8 * CK) >> 4) << 32 |
         (CK == 128 ? (uint64_t)1 : CK == 64 ? (uint64_t)2 : (uint64_t)3)
             << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from reading or moving an accumulator across the
// asynchronous wgmma that owns it.
template <int R>
__device__ __forceinline__ void fence_operands(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void setmaxnreg_producer() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS)
               : "memory");
}

__device__ __forceinline__ void setmaxnreg_consumer() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS)
               : "memory");
}

struct Tile {
  int n, oy0, ox0, n0;
};

// Tile t of the walk: N tiles fastest, so the blocks that run at once
// share their A (the input) in L2; then the M tiles in raster order.
__device__ __forceinline__ Tile tile_at(const ConvArgs& p, int t) {
  const int nt = t % p.n_tiles;
  int mt = t / p.n_tiles;
  const int tx = mt % p.tiles_x;
  mt /= p.tiles_x;
  const int ty = mt % p.tiles_y;
  return {mt / p.tiles_y, ty * BH, tx * BW, nt * BN};
}

__device__ __forceinline__ float leaky(float v, float slope) {
  return v > 0.0f ? v : __fmul_rn(v, slope);
}

__device__ __forceinline__ void bar_sync_wg(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// The residual's bits at out[off..off+3]: four bf16 in .x, .y, or four fp32.
__device__ __forceinline__ uint4 load_residual(const ConvArgs& p, int off) {
  if (p.out_bf16) {
    const uint2 r = __ldg(reinterpret_cast<const uint2*>(
        static_cast<const __nv_bfloat16*>(p.residual) + off));
    return make_uint4(r.x, r.y, 0, 0);
  }
  return __ldg(reinterpret_cast<const uint4*>(
      static_cast<const float*>(p.residual) + off));
}

// ascale * kscale and the bias of the four columns 4 (ct % 16) + e of each
// pass that thread ct's epilogue takes, loaded at the start of the tile so
// that the mainloop hides their latency.
struct Columns {
  float s[BN / EPI_COLS][4], b[BN / EPI_COLS][4];
};

__device__ __forceinline__ Columns columns(const ConvArgs& p, const Tile& t,
                                           int ct, float as) {
  Columns c;
#pragma unroll
  for (int pass = 0; pass < BN / EPI_COLS; ++pass) {
    const int co = t.n0 + pass * EPI_COLS + 4 * (ct & 15);
    const int cs = co < p.cout ? co : 0;
    const float4 k = ldg4(p.kscale + cs);
    const float4 b = p.bias ? ldg4(p.bias + cs) : make_float4(0, 0, 0, 0);
    c.s[pass][0] = __fmul_rn(as, k.x);
    c.s[pass][1] = __fmul_rn(as, k.y);
    c.s[pass][2] = __fmul_rn(as, k.z);
    c.s[pass][3] = __fmul_rn(as, k.w);
    c.b[pass][0] = b.x;
    c.b[pass][1] = b.y;
    c.b[pass][2] = b.z;
    c.b[pass][3] = b.w;
  }
  return c;
}

// The epilogue of one 64-row slab of a consumer's tile (rows row0 ..
// row0 + 63, BN columns), EPI_COLS columns a pass.  wgmma's s32 fragment
// (the thread's register 4j + 2h + e holds row 16 warp + lane/4 + 8h of the
// slab and column 8j + 2 (lane % 4) + e) goes to the consumer's staging
// rows; then each thread takes four consecutive columns of rows r8 + 8 it,
// so that the addend, the residual and the output move in 16- or 8-byte
// pieces, coalesced.  A pass issues its global reads (read-only, __ldg)
// K3_EPI_BATCH rows at a time before it computes and stores them, rows
// outside the output reading row 0 instead: the addend where there is one,
// else the residual.
__device__ __forceinline__ void epilogue(const ConvArgs& p, const Tile& t,
                                         const Columns& cols, int row0,
                                         int cw, int ct, int* staging,
                                         const int (&acc)[BN / 2]) {
  constexpr int ROWS = 64 / 8;  // rows a thread takes in a pass
  const int warp = ct >> 5, lane = ct & 31;
  int* const mine = staging + cw * 64 * EPI_PITCH;
  const int c4 = ct & 15, r8 = ct >> 4;
  int pix[ROWS];  // the output offset of each row's pixel, channel 0
  bool ok[ROWS];
#pragma unroll
  for (int it = 0; it < ROWS; ++it) {
    const int tr = row0 + r8 + 8 * it;
    const int oy = t.oy0 + tr / BW, ox = t.ox0 + tr % BW;
    ok[it] = oy < p.ho && ox < p.wo;
    pix[it] = ok[it] ? ((t.n * p.ho + oy) * p.wo + ox) * p.cout : 0;
  }
#pragma unroll
  for (int pass = 0; pass < BN / EPI_COLS; ++pass) {
    if (pass) bar_sync_wg(1 + cw);  // the last pass has read the staging
#pragma unroll
    for (int jj = 0; jj < EPI_COLS / 8; ++jj) {
      const int j = pass * EPI_COLS / 8 + jj;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + (lane >> 2) + 8 * h;
        *reinterpret_cast<int2*>(mine + r * EPI_PITCH + 8 * jj +
                                 2 * (lane & 3)) =
            make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
    bar_sync_wg(1 + cw);
    const int co = t.n0 + pass * EPI_COLS + 4 * c4;
    const bool col_ok = co < p.cout;  // cout % 8 == 0: whole groups of four
    const int cs = col_ok ? co : 0;
#pragma unroll
    for (int it0 = 0; it0 < ROWS; it0 += K3_EPI_BATCH) {
    uint4 ld[K3_EPI_BATCH];
#pragma unroll
    for (int it = it0; it < it0 + K3_EPI_BATCH; ++it) {
      if (p.addend)
        ld[it - it0] = __ldg(
            reinterpret_cast<const uint4*>(p.addend + pix[it] + cs));
      else if (p.residual)
        ld[it - it0] = load_residual(p, pix[it] + cs);
    }
#pragma unroll
    for (int it = it0; it < it0 + K3_EPI_BATCH; ++it) {
      const int4 a4 = *reinterpret_cast<const int4*>(
          mine + (r8 + 8 * it) * EPI_PITCH + 4 * c4);
      const int a[4] = {a4.x, a4.y, a4.z, a4.w};
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = __fmul_rn(__int2float_rn(a[e]), cols.s[pass][e]);
        if (p.bias) v[e] = __fadd_rn(v[e], cols.b[pass][e]);
      }
      const int o = pix[it] + co;
      if (p.addend) {
        v[0] = __fadd_rn(__uint_as_float(ld[it - it0].x), v[0]);
        v[1] = __fadd_rn(__uint_as_float(ld[it - it0].y), v[1]);
        v[2] = __fadd_rn(__uint_as_float(ld[it - it0].z), v[2]);
        v[3] = __fadd_rn(__uint_as_float(ld[it - it0].w), v[3]);
      }
      uint4 res = make_uint4(0, 0, 0, 0);
      if (p.residual)
        res = p.addend ? load_residual(p, pix[it] + cs) : ld[it - it0];
      if (p.out_bf16) {
        __nv_bfloat162 y[2] = {__floats2bfloat162_rn(v[0], v[1]),
                               __floats2bfloat162_rn(v[2], v[3])};
        if (p.leaky) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float2 f = __bfloat1622float2(y[e]);
            y[e] = __floats2bfloat162_rn(leaky(f.x, p.slope),
                                         leaky(f.y, p.slope));
          }
        }
        if (p.residual) {
          const uint32_t rw[2] = {res.x, res.y};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float2 f = __bfloat1622float2(y[e]);
            const float2 g = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&rw[e]));
            y[e] = __floats2bfloat162_rn(__fadd_rn(g.x, f.x),
                                         __fadd_rn(g.y, f.y));
          }
        }
        if (ok[it] && col_ok)
          *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(p.out) + o) =
              make_uint2(*reinterpret_cast<const uint32_t*>(&y[0]),
                         *reinterpret_cast<const uint32_t*>(&y[1]));
      } else {
        if (p.leaky) {
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] = leaky(v[e], p.slope);
        }
        if (p.residual) {
          v[0] = __fadd_rn(__uint_as_float(res.x), v[0]);
          v[1] = __fadd_rn(__uint_as_float(res.y), v[1]);
          v[2] = __fadd_rn(__uint_as_float(res.z), v[2]);
          v[3] = __fadd_rn(__uint_as_float(res.w), v[3]);
        }
        if (ok[it] && col_ok)
          *reinterpret_cast<float4*>(static_cast<float*>(p.out) + o) =
              make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    }
  }
  bar_sync_wg(1 + cw);  // the staging is free for the next slab
}

// The block walks tiles blockIdx.x + k gridDim.x, k = 0, 1, ...; the
// producer loads them in that order, and consumer warpgroup k % 2 takes
// tile k, so that one consumer's epilogue runs beside the other's wgmma (a
// ping-pong).  A consumer starts waiting on its tile's loads only once the
// other has waited on all of its own (the turn mbarriers): a parity wait
// tells phases apart only modulo 2, so the loads it waits on must be the
// next fill of each stage, never one further ahead.
template <int CK>
__global__ void __launch_bounds__(THREADS, 1)
    int8_conv_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap,
                     const ConvArgs p) {
  using T = Tiling<CK>;
  extern __shared__ uint8_t smem_raw[];
  // the ring, aligned to the 128-byte swizzle's 1024-byte repeat
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = ring + T::STAGES * T::STAGE;
  int* const staging = reinterpret_cast<int*>(
      smem_raw + (bars + 16 * T::STAGES + 16 - smem_u32(smem_raw)));
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (T::STAGES + s); };
  auto turn = [&](int c) { return bars + 8u * (2 * T::STAGES + c); };
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 1);
    }
    mbar_init(turn(0), 1);
    mbar_init(turn(1), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int chunks = p.cin / CK, kblocks = 9 * chunks;

  if (tid >= 256) {
    // the producer warpgroup: one thread issues every load
    setmaxnreg_producer();
    if (tid == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int i = blockIdx.x; i < p.tiles; i += gridDim.x) {
        const Tile t = tile_at(p, i);
        const int y0 = t.oy0 * p.stride - p.pt, x0 = t.ox0 * p.stride - p.pl;
        for (int kb = 0; kb < kblocks; ++kb) {
          const int tap = kb / chunks, c0 = (kb - tap * chunks) * CK;
          const int kh = tap / 3, kw = tap - 3 * kh;
          mbar_wait(empty(stage), phase ^ 1);
          const uint32_t a = ring + stage * T::STAGE;
          mbar_expect_tx(full(stage), T::STAGE);
          tma_load_4d(a, &xmap, full(stage), c0, x0 + kw, y0 + kh, t.n);
          tma_load_2d(a + T::A_BYTES, &wmap, full(stage), tap * p.cin + c0,
                      t.n0);
          if (++stage == T::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
      // leave only once the consumers have read every stage
      for (int s = 0; s < T::STAGES; ++s) {
        mbar_wait(empty(stage), phase ^ 1);
        if (++stage == T::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    setmaxnreg_consumer();
    const int cw = tid >> 7, ct = tid & 127;
    const float as = *p.ascale;
    int acc[SLABS][BN / 2];
#pragma unroll
    for (int sl = 0; sl < SLABS; ++sl)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[sl][i] = 0;
    uint32_t turn_phase = 0;
    for (int k = cw;; k += 2) {
      const int i = blockIdx.x + k * gridDim.x;
      if (i >= p.tiles) break;
      if (k > 0) {
        mbar_wait(turn(cw), turn_phase);
        turn_phase ^= 1;
      }
      const Tile t = tile_at(p, i);
      const Columns cols = columns(p, t, ct, as);
      // this tile's loads are the block's (k kblocks)-th onwards
      int stage = k * kblocks % T::STAGES;
      uint32_t phase = (k * kblocks / T::STAGES) & 1;
      int prev = 0;
      for (int kb = 0; kb < kblocks; ++kb) {
        mbar_wait(full(stage), phase);
        const uint32_t a = ring + stage * T::STAGE;
        const uint32_t b = a + T::A_BYTES;
#pragma unroll
        for (int sl = 0; sl < SLABS; ++sl) fence_operands(acc[sl]);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < CK / 32; ++ks)
#pragma unroll
          for (int sl = 0; sl < SLABS; ++sl)
            wgmma_n128(acc[sl], wgmma_desc<CK>(a + sl * 64 * CK + 32 * ks),
                       wgmma_desc<CK>(b + 32 * ks), (kb | ks) != 0);
        wgmma_commit();
#pragma unroll
        for (int sl = 0; sl < SLABS; ++sl) fence_operands(acc[sl]);
        if (kb > 0) {
          // the group of the previous stage has completed: free that stage
          wgmma_wait<1>();
          if (ct == 0) mbar_arrive(empty(prev));
        }
        prev = stage;
        if (++stage == T::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      if (ct == 0) mbar_arrive(turn(cw ^ 1));  // the other consumer's turn
      wgmma_wait<0>();
      if (ct == 0) mbar_arrive(empty(prev));
#pragma unroll
      for (int sl = 0; sl < SLABS; ++sl) fence_operands(acc[sl]);
#pragma unroll
      for (int sl = 0; sl < SLABS; ++sl)
        epilogue(p, t, cols, sl * 64, cw, ct, staging, acc[sl]);
    }
  }
}

}  // namespace

// x_bf16: 1 for bf16 x, 0 for fp32; x and q 16-byte aligned.  Returns a
// cudaError_t.
extern "C" int btt_quantize_act(const void* x, int x_bf16, const void* scale,
                                void* q, int64_t n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  int64_t blocks = (n / 16 + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (x_bf16)
    quantize_act_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const float*>(scale), static_cast<int8_t*>(q), n);
  else
    quantize_act_kernel<float><<<(unsigned)blocks, threads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(scale),
        static_cast<int8_t*>(q), n);
  return (int)cudaGetLastError();
}

namespace {

// cuTensorMapEncodeTiled through the runtime's driver entry point, so that
// the library needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

CUtensorMapSwizzle swizzle_of(int ck) {
  return ck == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
         : ck == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                    : CU_TENSOR_MAP_SWIZZLE_32B;
}

template <int CK>
int launch_conv(const int8_t* x, const int8_t* wt, ConvArgs p, int n, int h,
                int w, cudaStream_t stream) {
  using T = Tiling<CK>;
  EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorNotSupported;
  const int s = p.stride;
  // A: the NHWC input as (C, W, H, N), a box of CK channels x BW x BH
  // output pixels; a traversal stride of s takes every s-th pixel, and the
  // box spans s times the pixels it loads (cuda.h, elementStrides).
  CUtensorMap xmap, wmap;
  const cuuint64_t xdim[4] = {(cuuint64_t)p.cin, (cuuint64_t)w,
                              (cuuint64_t)h, (cuuint64_t)n};
  const cuuint64_t xstride[3] = {(cuuint64_t)p.cin, (cuuint64_t)w * p.cin,
                                 (cuuint64_t)h * w * p.cin};
  const cuuint32_t xbox[4] = {CK, (cuuint32_t)(BW * s), (cuuint32_t)(BH * s),
                              1};
  const cuuint32_t xel[4] = {1, (cuuint32_t)s, (cuuint32_t)s, 1};
  CUresult r = encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4,
                      const_cast<int8_t*>(x), xdim, xstride, xbox, xel,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(CK),
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  // B: the weight as (9 Cin, Cout), a box of CK bytes of K x BN rows
  const cuuint64_t wdim[2] = {(cuuint64_t)9 * p.cin, (cuuint64_t)p.cout};
  const cuuint64_t wstride[1] = {(cuuint64_t)9 * p.cin};
  const cuuint32_t wbox[2] = {CK, BN};
  const cuuint32_t wel[2] = {1, 1};
  r = encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(wt),
             wdim, wstride, wbox, wel, CU_TENSOR_MAP_INTERLEAVE_NONE,
             swizzle_of(CK), CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;

  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        int8_conv_kernel<CK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        T::SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  p.tiles_x = (p.wo + BW - 1) / BW;
  p.tiles_y = (p.ho + BH - 1) / BH;
  p.n_tiles = (p.cout + BN - 1) / BN;
  p.tiles = n * p.tiles_y * p.tiles_x * p.n_tiles;
  const int grid = p.tiles < sms ? p.tiles : sms;
  int8_conv_kernel<CK><<<grid, THREADS, T::SMEM, stream>>>(xmap, wmap, p);
  return (int)cudaGetLastError();
}

}  // namespace

// SAME 3x3 conv, stride 1 or 2, top/left padding (pt, pl), ho output rows
// (SAME's, or fewer: a band with its halo rows, pt 0).  cin a multiple
// of 32, cout of 8, fewer than 2^31 outputs; x, wt, kscale, bias, addend and residual 16-byte
// aligned.  bias, addend and residual may be null; leaky != 0 applies the LeakyReLU of `slope` after the cast,
// then the residual (the output's dtype and shape) is added.  Returns a
// cudaError_t.
extern "C" int btt_int8_conv(const void* x, const void* wt,
                             const void* ascale, const void* kscale,
                             const void* bias, const void* addend,
                             const void* residual, void* out, int out_bf16,
                             int n, int h, int w, int ho, int cin, int cout,
                             int stride, int pt, int pl, int leaky,
                             float slope, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || cin <= 0 || cout <= 0 || cin % 32 ||
      cout % 8 || (stride != 1 && stride != 2) || pt < 0 || pt > 2 ||
      pl < 0 || pl > 2 || ho <= 0 || ho > (h + stride - 1) / stride ||
      (int64_t)n * ho * ((w + stride - 1) / stride) * cout >= (int64_t)1 << 31)
    return (int)cudaErrorInvalidValue;
  const void* const aligned[] = {x, wt, kscale, bias, addend, residual};
  for (const void* ptr : aligned)
    if (reinterpret_cast<uintptr_t>(ptr) % 16)
      return (int)cudaErrorInvalidValue;
  ConvArgs p = {};
  p.ascale = static_cast<const float*>(ascale);
  p.kscale = static_cast<const float*>(kscale);
  p.bias = static_cast<const float*>(bias);
  p.addend = static_cast<const float*>(addend);
  p.residual = residual;
  p.out = out;
  p.ho = ho;
  p.wo = (w + stride - 1) / stride;
  p.cin = cin;
  p.cout = cout;
  p.stride = stride;
  p.pt = pt;
  p.pl = pl;
  p.out_bf16 = out_bf16;
  p.leaky = leaky;
  p.slope = slope;
  const int8_t* xq = static_cast<const int8_t*>(x);
  const int8_t* wq = static_cast<const int8_t*>(wt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the chunk: the widest of 128, 64 and 32 bytes that divides Cin, with
  // the swizzle of its width
  if (cin % 128 == 0) return launch_conv<128>(xq, wq, p, n, h, w, s);
  if (cin % 64 == 0) return launch_conv<64>(xq, wq, p, n, h, w, s);
  return launch_conv<32>(xq, wq, p, n, h, w, s);
}

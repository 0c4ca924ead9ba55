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
//       v = addend[m, co] + v; then a round-to-nearest cast to bf16 or an
//       fp32 store.
//       Bound: operations.  At the main path's widest conv, (3, 180, 320,
//       256) -> 256, the 2.0e11 int8 ops take 0.10 ms at 1979 TOP/s against
//       0.04 ms for its bytes.  Design, simple first: 128x128 output tiles,
//       256 threads as 2x4 warps of 64x32, mma.sync m16n8k32 s8 with int32
//       accumulators, K in chunks of 128 bytes double-buffered in shared
//       memory by 16-byte cp.async (zero-filled where a tap is out of range
//       or past M, Cout or K), rows padded by 16 bytes so that ldmatrix
//       reads without bank conflicts; two blocks per SM (128 registers a
//       thread).  Each 16-byte piece lies inside one tap because Cin is a
//       multiple of 32.  A sweep of tilings (tools/k3_ab.py, PERF.md) found
//       occupancy the lever: warp tiles of 64x64 or one block per SM were
//       slower.  wgmma/TMA is later work.

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
// builds the same source with other values (-DK3_BM=... ) to compare them.
#ifndef K3_BM
#define K3_BM 128
#endif
#ifndef K3_BN
#define K3_BN 128
#endif
#ifndef K3_BK
#define K3_BK 128
#endif
#ifndef K3_WARPS_M
#define K3_WARPS_M 2
#endif
#ifndef K3_WARPS_N
#define K3_WARPS_N 4
#endif
#ifndef K3_STAGES
#define K3_STAGES 2
#endif
#ifndef K3_MIN_BLOCKS
#define K3_MIN_BLOCKS 2
#endif

constexpr int BM = K3_BM, BN = K3_BN, BK = K3_BK, STAGES = K3_STAGES;
constexpr int WARPS_M = K3_WARPS_M, WARPS_N = K3_WARPS_N;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int MI = BM / WARPS_M / 16, NJ = BN / WARPS_N / 8;  // mma tiles
constexpr int PIECES = BK / 16;               // 16-byte pieces of a row
constexpr int ROWS_PER_PASS = THREADS / PIECES;
constexpr int A_PER = BM / ROWS_PER_PASS, B_PER = BN / ROWS_PER_PASS;
constexpr int PITCH = BK + 16;  // shared row pitch in bytes
constexpr int A_STAGE = BM * PITCH, B_STAGE = BN * PITCH;
constexpr int SMEM_BYTES = STAGES * (A_STAGE + B_STAGE);
static_assert(BK % 32 == 0 && THREADS % PIECES == 0, "loader layout");
static_assert(BM % ROWS_PER_PASS == 0 && BN % ROWS_PER_PASS == 0,
              "loader layout");
static_assert(BM % (16 * WARPS_M) == 0 && NJ % 2 == 0, "warp layout");

struct ConvArgs {
  const int8_t* x;       // (n, h, w, cin)
  const int8_t* wt;      // (cout, 3, 3, cin)
  const float* ascale;   // one value
  const float* kscale;   // (cout,)
  const float* bias;     // (cout,) or null
  const float* addend;   // (n, ho, wo, cout) or null
  void* out;             // (n, ho, wo, cout), bf16 or fp32
  int n, h, w, cin, ho, wo, cout, stride, pt, pl, out_bf16;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  // src-size 0 fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(THREADS, K3_MIN_BLOCKS)
    int8_conv_kernel(const ConvArgs p) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int64_t M = (int64_t)p.n * p.ho * p.wo;
  const int K = 9 * p.cin;
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // Loader: a tile's A and B are BM and BN rows of PIECES pieces of 16
  // bytes; thread t moves the pieces (row t/PIECES + i ROWS_PER_PASS,
  // column t%PIECES), so its column, and the (tap, channel) of its k, are
  // the same for all its pieces.
  const int lrow = tid / PIECES;
  const int lcol = (tid % PIECES) * 16;
  const int8_t* a_img[A_PER];
  int a_iy[A_PER], a_ix[A_PER];
  bool a_ok[A_PER];
  const int8_t* b_row[B_PER];
  bool b_ok[B_PER];
#pragma unroll
  for (int i = 0; i < A_PER; ++i) {
    const int64_t m = m0 + lrow + ROWS_PER_PASS * i;
    a_ok[i] = m < M;
    const int64_t mm = a_ok[i] ? m : 0;
    const int64_t img = mm / ((int64_t)p.ho * p.wo);
    const int rem = (int)(mm - img * p.ho * p.wo);
    const int oy = rem / p.wo, ox = rem - (rem / p.wo) * p.wo;
    a_iy[i] = oy * p.stride - p.pt;
    a_ix[i] = ox * p.stride - p.pl;
    a_img[i] = p.x + img * p.h * p.w * (int64_t)p.cin;
  }
#pragma unroll
  for (int i = 0; i < B_PER; ++i) {
    const int co = n0 + lrow + ROWS_PER_PASS * i;
    b_ok[i] = co < p.cout;
    b_row[i] = p.wt + (int64_t)(b_ok[i] ? co : 0) * K;
  }
  // this thread's k in the next tile to load, as (tap, channel)
  int kload = lcol;
  int tap = lcol / p.cin, chan = lcol - tap * p.cin;

  auto load_tile = [&](int stage) {
    uint8_t* sa = smem + stage * (A_STAGE + B_STAGE);
    uint8_t* sb = sa + A_STAGE;
    const bool kin = kload < K;
    const int kh = tap / 3, kw = tap - 3 * (tap / 3);
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int iy = a_iy[i] + kh, ix = a_ix[i] + kw;
      const bool ok = a_ok[i] && kin && iy >= 0 && iy < p.h && ix >= 0 &&
                      ix < p.w;
      const int8_t* src =
          ok ? a_img[i] + ((int64_t)iy * p.w + ix) * p.cin + chan : p.x;
      cp_async16(smem_u32(sa + (lrow + ROWS_PER_PASS * i) * PITCH + lcol),
                 src, ok);
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const bool ok = b_ok[i] && kin;
      cp_async16(smem_u32(sb + (lrow + ROWS_PER_PASS * i) * PITCH + lcol),
                 ok ? b_row[i] + kload : p.wt, ok);
    }
    kload += BK;
    chan += BK;
    while (chan >= p.cin) {
      chan -= p.cin;
      ++tap;
    }
  };

  int acc[MI][NJ][4];
#pragma unroll
  for (int a = 0; a < MI; ++a)
#pragma unroll
    for (int b = 0; b < NJ; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0;

  const int KT = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_tile(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile kt landed; stage (kt-1) % STAGES is free
    if (kt + STAGES - 1 < KT) load_tile((kt + STAGES - 1) % STAGES);
    cp_async_commit();
    const uint8_t* sa = smem + (kt % STAGES) * (A_STAGE + B_STAGE);
    const uint8_t* sb = sa + A_STAGE;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t af[MI][4], bf[NJ][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        ldmatrix_x4(af[mi], smem_u32(sa +
                                     (wm * MI * 16 + mi * 16 + (lane & 15)) *
                                         PITCH +
                                     ks + (lane >> 4) * 16));
#pragma unroll
      for (int nj = 0; nj < NJ; nj += 2) {
        uint32_t r[4];
        ldmatrix_x4(r, smem_u32(sb +
                                (wn * NJ * 8 + (nj + (lane >> 4)) * 8 +
                                 (lane & 7)) * PITCH +
                                ks + ((lane >> 3) & 1) * 16));
        bf[nj][0] = r[0];
        bf[nj][1] = r[1];
        bf[nj + 1][0] = r[2];
        bf[nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int nj = 0; nj < NJ; ++nj)
          mma_s8(acc[mi][nj], af[mi], bf[nj][0], bf[nj][1]);
    }
  }
  cp_async_wait<0>();

  // Epilogue: the thread holds rows g, g+8 of each m16 tile and the column
  // pair 2*(lane%4) of each n8 tile.
  const float as = *p.ascale;
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int nj = 0; nj < NJ; ++nj) {
    const int col = n0 + wn * NJ * 8 + nj * 8 + tg * 2;
    if (col >= p.cout) continue;  // cout is even: col + 1 is in range too
    const float s0 = __fmul_rn(as, p.kscale[col]);
    const float s1 = __fmul_rn(as, p.kscale[col + 1]);
    const float b0 = p.bias ? p.bias[col] : 0.0f;
    const float b1 = p.bias ? p.bias[col + 1] : 0.0f;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int64_t m = m0 + wm * MI * 16 + mi * 16 + g + half * 8;
        if (m >= M) continue;
        float v0 = __fmul_rn(__int2float_rn(acc[mi][nj][2 * half]), s0);
        float v1 = __fmul_rn(__int2float_rn(acc[mi][nj][2 * half + 1]), s1);
        if (p.bias) {
          v0 = __fadd_rn(v0, b0);
          v1 = __fadd_rn(v1, b1);
        }
        const int64_t o = m * p.cout + col;
        if (p.addend) {
          const float2 a = *reinterpret_cast<const float2*>(p.addend + o);
          v0 = __fadd_rn(a.x, v0);
          v1 = __fadd_rn(a.y, v1);
        }
        if (p.out_bf16)
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(p.out) + o) =
              __floats2bfloat162_rn(v0, v1);
        else
          *reinterpret_cast<float2*>(static_cast<float*>(p.out) + o) =
              make_float2(v0, v1);
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

// SAME 3x3 conv, stride 1 or 2, top/left padding (pt, pl).  cin a multiple
// of 32, cout of 8.  bias and addend may be null.  Returns a cudaError_t.
extern "C" int btt_int8_conv(const void* x, const void* wt,
                             const void* ascale, const void* kscale,
                             const void* bias, const void* addend, void* out,
                             int out_bf16, int n, int h, int w, int cin,
                             int cout, int stride, int pt, int pl,
                             void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || cin <= 0 || cout <= 0 || cin % 32 ||
      cout % 8 || (stride != 1 && stride != 2) || pt < 0 || pt > 2 ||
      pl < 0 || pl > 2)
    return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        int8_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  ConvArgs p;
  p.x = static_cast<const int8_t*>(x);
  p.wt = static_cast<const int8_t*>(wt);
  p.ascale = static_cast<const float*>(ascale);
  p.kscale = static_cast<const float*>(kscale);
  p.bias = static_cast<const float*>(bias);
  p.addend = static_cast<const float*>(addend);
  p.out = out;
  p.n = n;
  p.h = h;
  p.w = w;
  p.cin = cin;
  p.ho = (h + stride - 1) / stride;
  p.wo = (w + stride - 1) / stride;
  p.cout = cout;
  p.stride = stride;
  p.pt = pt;
  p.pl = pl;
  p.out_bf16 = out_bf16;
  const int64_t M = (int64_t)n * p.ho * p.wo;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((cout + BN - 1) / BN));
  int8_conv_kernel<<<grid, THREADS, SMEM_BYTES,
                     static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// PSS matched filter + power for the grid engine's pass A (Hopper, sm_90a).
//
// Replaces the TPU kernel pss_correlate_power_pallas
// (ltetrigger_tpu/ops/pallas/matched_filter.py) and the XLA matmul of pass A
// (ltetrigger_tpu/models/trigger.py _group_power).  For each batch lane b and
// operand row j in [0, M):
//
//   x[j] = [re[lo+128j : +128] | im[..] | re[lo+128(j+1) : +128] | im[..]]
//   c[j] = x[j] @ W                      W = [512, 768], comp-major columns
//   out[b, j, n] = c[j, n]^2 + c[j, 384 + n]      n in [0, 384)
//
// Row j+1's first half is row j's second half, so the operand is read
// straight from the stream (no im2col copy); samples outside [0, N) read as
// zero.  The complex correlation lives only in registers: each thread holds
// the re and im accumulators of the same output columns, and the square-sum
// is the epilogue.
//
// Bound: at 128 channels x 100 half-frame steps pass A is 960,000 rows x
// 512 x 768 x 2 = 755 GFLOP and moves ~2.5 GB (1.0 GB of stream read,
// 1.47 GB of power written).  On the H100 data sheet (989 TFLOP/s bf16 on
// the tensor cores, 3.35 TB/s) both limits are near 0.75 ms, so the kernel
// is balanced between compute and memory (a data-sheet reckoning, not a
// measurement; PERF.md has the card's times).
//
// Two bodies, chosen by the input precision:
//  * bf16 (the shipped default): x and W rounded to bfloat16 (nearest even),
//    multiplied on the tensor cores with mma.sync m16n8k16 and accumulated
//    in float32 — the JAX package's bf16-input / f32-accumulate contract.
//    W arrives pre-transposed and pre-rounded ([768, 512] bf16) so both
//    operands are K-contiguous in shared memory.
//  * f32: plain float32 FMA on the SM cores (67 TFLOP/s data-sheet peak),
//    so compute-bound, no faster than ~11 ms at the shape above.
// Both are simple tiled kernels (shared-memory tiles, no pipelining);
// wgmma, TMA and persistence are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;         // operand rows per block
constexpr int BN = 64;         // power columns per block (128 W columns)
constexpr int BK = 32;         // contraction slice per stage
constexpr int NPOW = 384;      // power columns: 3 roots x 128 lanes
constexpr int NW = 768;        // W columns: [re | im] x 3 roots x 128
constexpr int KDIM = 512;
constexpr int THREADS = 256;   // 8 warps

// float32 body: a block computes BM rows x BN power columns; a thread owns
// 4 rows x 4 power columns (strided by 16, conflict-free smem reads).
__global__ void __launch_bounds__(THREADS)
group_power_kernel(const float* __restrict__ re, const float* __restrict__ im,
                   const float* __restrict__ W, float* __restrict__ out,
                   int N, long long lo, int M) {
  __shared__ float As[BK][BM + 1];       // x slice, transposed, padded
  __shared__ float Ws[BK][2 * BN];       // [re cols | im cols]

  const int b = blockIdx.z;
  const int row0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const float* bre = re + (size_t)b * N;
  const float* bim = im + (size_t)b * N;

  float acc_re[4][4] = {};
  float acc_im[4][4] = {};

  for (int k0 = 0; k0 < KDIM; k0 += BK) {
    // a BK slice lies inside one 128-wide quarter of the K axis
    const int quarter = k0 / 128;
    const float* comp = (quarter & 1) ? bim : bre;
    const long long qoff = lo + 128LL * (quarter >> 1) + (k0 % 128);
    {
      const int kk = tid % BK;
      for (int r = tid / BK; r < BM; r += THREADS / BK) {
        const int j = row0 + r;
        const long long pos = qoff + 128LL * j + kk;
        float v = 0.f;
        if (j < M && pos >= 0 && pos < N) v = comp[pos];
        As[kk][r] = v;
      }
    }
    {
      const int c = tid % (2 * BN);
      const int wcol = (c < BN) ? (n0 + c) : (NPOW + n0 + c - BN);
      for (int kk = tid / (2 * BN); kk < BK; kk += THREADS / (2 * BN))
        Ws[kk][c] = W[(size_t)(k0 + kk) * NW + wcol];
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], wr[4], wi[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wr[i] = Ws[kk][tx + 16 * i];
        wi[i] = Ws[kk][BN + tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc_re[i][q] = fmaf(a[i], wr[q], acc_re[i][q]);
          acc_im[i][q] = fmaf(a[i], wi[q], acc_im[i][q]);
        }
    }
    __syncthreads();
  }

  float* bout = out + (size_t)b * M * NPOW;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = row0 + ty + 16 * i;
    if (j >= M) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = n0 + tx + 16 * q;
      bout[(size_t)j * NPOW + n] =
          acc_re[i][q] * acc_re[i][q] + acc_im[i][q] * acc_im[i][q];
    }
  }
}

constexpr int TC_BK = 32;                // contraction slice per stage
constexpr int TC_LD = TC_BK + 8;         // padded smem row (bf16): no bank
                                         // conflicts on fragment loads

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Tensor-core body: a block computes BM rows x BN power columns with 8 warps
// laid out 2 (rows) x 4 (columns); a warp owns 32 rows x 16 power columns,
// i.e. 2 m16 tiles x {re, im} x 2 n8 tiles of accumulators, and squares its
// re/im fragments in place (they share one register layout).
__global__ void __launch_bounds__(THREADS)
group_power_tc_kernel(const float* __restrict__ re,
                      const float* __restrict__ im,
                      const __nv_bfloat16* __restrict__ Wt,
                      float* __restrict__ out, int N, long long lo, int M) {
  __shared__ __align__(16) __nv_bfloat16 As[BM][TC_LD];
  __shared__ __align__(16) __nv_bfloat16 Bs[2 * BN][TC_LD];   // [n][k]

  const int b = blockIdx.z;
  const int row0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int g = lane >> 2, t = lane & 3;
  const float* bre = re + (size_t)b * N;
  const float* bim = im + (size_t)b * N;

  float acc[2][2][2][4] = {};     // [m16 tile][re, im][n8 tile][fragment]

  for (int k0 = 0; k0 < KDIM; k0 += TC_BK) {
    const int quarter = k0 / 128;
    const float* comp = (quarter & 1) ? bim : bre;
    const long long qoff = lo + 128LL * (quarter >> 1) + (k0 % 128);
    const int kk = tid % TC_BK;
    for (int r = tid / TC_BK; r < BM; r += THREADS / TC_BK) {
      const int j = row0 + r;
      const long long pos = qoff + 128LL * j + kk;
      float v = 0.f;
      if (j < M && pos >= 0 && pos < N) v = comp[pos];
      As[r][kk] = __float2bfloat16_rn(v);
    }
    for (int c = tid / TC_BK; c < 2 * BN; c += THREADS / TC_BK) {
      const int wcol = (c < BN) ? (n0 + c) : (NPOW + n0 + c - BN);
      Bs[c][kk] = Wt[(size_t)wcol * KDIM + k0 + kk];
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < TC_BK; ks += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm * 32 + mi * 16 + g;
        a[mi][0] = ld32(&As[r][ks + 2 * t]);
        a[mi][1] = ld32(&As[r + 8][ks + 2 * t]);
        a[mi][2] = ld32(&As[r][ks + 2 * t + 8]);
        a[mi][3] = ld32(&As[r + 8][ks + 2 * t + 8]);
      }
#pragma unroll
      for (int ci = 0; ci < 2; ++ci)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) {
          const int n = ci * BN + wn * 16 + ni * 8 + g;
          const uint32_t b0 = ld32(&Bs[n][ks + 2 * t]);
          const uint32_t b1 = ld32(&Bs[n][ks + 2 * t + 8]);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            mma_bf16(acc[mi][ci][ni], a[mi], b0, b1);
        }
    }
    __syncthreads();
  }

  float* bout = out + (size_t)b * M * NPOW;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {        // fragment rows g and g + 8
        const int j = row0 + wm * 32 + mi * 16 + g + 8 * h;
        if (j >= M) continue;
        const float* cr = &acc[mi][0][ni][2 * h];
        const float* ci = &acc[mi][1][ni][2 * h];
        const int n = n0 + wn * 16 + ni * 8 + 2 * t;
        *reinterpret_cast<float2*>(&bout[(size_t)j * NPOW + n]) =
            make_float2(cr[0] * cr[0] + ci[0] * ci[0],
                        cr[1] * cr[1] + ci[1] * ci[1]);
      }
}

}  // namespace

// C interface (bound with ctypes).  re, im: [B, N] float32; W: [512, 768]
// float32 (f32 body); Wt: [768, 512] bfloat16, W transposed and rounded
// (bf16 body); out: [B, M, 384] float32.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int mf_group_power(const float* re, const float* im,
                              const float* W, const void* Wt, float* out,
                              int B, int N, long long lo, int M, int bf16,
                              void* stream) {
  if (B <= 0 || M <= 0) return 0;
  dim3 grid((M + BM - 1) / BM, NPOW / BN, B);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    group_power_tc_kernel<<<grid, THREADS, 0, s>>>(
        re, im, (const __nv_bfloat16*)Wt, out, N, lo, M);
  else
    group_power_kernel<<<grid, THREADS, 0, s>>>(re, im, W, out, N, lo, M);
  return (int)cudaGetLastError();
}

// PSS matched filter + power for the grid engine's pass A (Hopper, sm_90a).
//
// Replaces the TPU kernel pss_correlate_power_pallas
// (ltetrigger_tpu/ops/pallas/matched_filter.py) and the XLA matmul of pass A
// (ltetrigger_tpu/models/trigger.py _group_power).  For each batch lane b and
// operand row j in [0, M):
//
//   x[j] = [re[lo+128j : +128] | im[..] | re[lo+128(j+1) : +128] | im[..]]
//   c[j] = x[j] @ W                      W = [512, 768], comp-major columns
//   out[b, j, n] = c[j, n]^2 + c[j, 384 + n]^2     n in [0, 384)
//
// Samples outside [0, N) read as zero.  Only power reaches device memory.
//
// Bound (per launch of the 128-channel x 25-step group, 4 launches per
// 128 x 100 dispatch): 240,000 rows x 512 x 768 x 2 = 188.7 GFLOP, 0.19 ms
// at 989 TFLOP/s bf16; 246 MB of stream read + 369 MB of power written,
// 0.18 ms at 3.35 TB/s.  Compute and memory meet near 0.19 ms (H100 data
// sheet).  For float32 inputs the product is bound by the 67 TFLOP/s of the
// SM cores, 2.8 ms, unless it is split onto the tensor cores as below.
//
// Design.  Two kernels per launch:
//
//  1. mf_stage_kernel: a staging pass that reads the float32 stream once,
//     with guarded loads (any N, any lo, zeros past N), and writes the
//     128-sample blocks [lo + 128 j, +128), j in [0, M], of re and of im as
//     planes [2B, M + 1, 128] in the matmul's operand type.  TMA copies
//     bytes and cannot round, so the rounding happens here: bf16 by
//     __float2bfloat16_rn (nearest even, the contract the decisions are
//     tested against); for float32 inputs a hi/lo pair, see below.  Of the
//     three ways to feed a float32 stream to wgmma (round in registers with
//     A from registers; round in producer warps; stage) this is the one
//     whose main kernel sees only aligned, TMA-legal operands, so one path
//     serves every shape the wrapper accepts.  It costs one extra write and
//     read of the operand (123 MB at C=128 in bf16).
//
//  2. mf_wgmma_kernel: persistent blocks, one per SM, walk units of
//     (lane, row tile, PSS root), root fastest so that the three blocks that
//     share an operand tile run together and L2 serves two of them.  A unit
//     is a [BM rows] x [256 columns] accumulator tile over K = 512: W is
//     reordered on the host so that one root's 128 re and 128 im columns are
//     adjacent, each consumer warpgroup owns 64 rows and issues wgmma
//     m64n256 with float32 accumulators, and a thread holds c[j, n] and
//     c[j, n + 128] (re and im of one power column) in the same fragment
//     position, so re^2 + im^2 stays in registers.  One producer warp feeds
//     a ring of shared-memory stages with TMA (128-byte swizzle), full and
//     empty mbarriers per stage; consumers keep one wgmma group in flight
//     and release a stage when the group that read it has retired.  Row j's
//     second half is row j+1's first half: the K quarters 2 and 3 are the
//     same planes one row later, loaded as their own TMA box (box
//     coordinates are element-granular, so no swizzled tile is ever
//     addressed at an odd row).  The producer runs ahead into the next
//     unit while the consumers square and store.  Rows j >= M are masked at
//     the store; TMA zero-fills rows past M + 1.
//     BM is 128 (two consumer warpgroups) when that fills the card and 64
//     (one) for small launches; mf_group_power picks from the shape.
//
// float32 inputs: three TF32 products instead of one float32 product,
// x W ~= x_hi W_hi + x_hi W_lo + x_lo W_hi, with hi = the value with its low
// 13 mantissa bits cleared (exactly a TF32 number) and lo = value - hi
// (exact in float32; the tensor core reads its leading 11 bits).  The
// dropped terms are below 2^-21 of |x||W| per product, inside the rtol 1e-4
// the port states, where one-pass TF32 (2^-11) is not.  Chosen over a
// register-tiled FMA body because it reuses this pipeline unchanged (a
// stage carries A_hi, A_lo, W_hi, W_lo and issues three wgmma per K step)
// and its bound, 566 GFLOP at 495 TFLOP/s = 1.1 ms, is under the FMA peak's
// 2.8 ms.
//
// Predicted before the first run on the card (H100, 700 W), C=128, g=25:
// bf16 0.5-0.8 ms (staging ~0.12 ms, main kernel 0.4-0.65 ms: each unit
// streams 384 KB from L2 for 33.5 MFLOP, 2.2 GB per launch, so L2 rather
// than the tensor cores sets the pace), against 2.76 ms for the mma.sync
// body it replaces; float32 2.3-3.5 ms against 6.43 ms.
// Measured (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py): bf16 0.41 ms, of
// which staging 0.12 ms (its 369 MB at 3.0 TB/s: memory-bound, as fast as
// it can be) and the main kernel 0.28 ms (660 TFLOP/s; one torch.matmul on
// the pre-built operand takes 0.29 ms), so L2 did not pace it as predicted;
// float32 1.90 ms (staging 0.25, main 1.65 ms), against 3.74 ms for the
// float32 library matmul.  What separates bf16 from its 0.19 ms bound is
// the staging pass and the tensor cores' sustained rate; the 8-byte stores
// of the epilogue were left as they are because the main kernel already
// runs at the library's rate.  PERF.md has every row.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

constexpr int NPOW = 384;      // power columns: 3 roots x 128 lanes
constexpr int NW = 768;        // W columns: 3 roots x [128 re | 128 im]
constexpr int KDIM = 512;
constexpr int BLK = 128;       // samples per stream block = plane row
constexpr int UNIT_N = 256;    // accumulator columns of one unit

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Shared-memory matrix descriptor of a K-major tile whose rows are 128 bytes
// (one swizzle row), written by TMA with the 128-byte swizzle: groups of 8
// rows are 1024 bytes apart (SBO); LBO is unused for this layout.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  uint64_t d = static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>(1) << 16;
  d |= static_cast<uint64_t>(1024 >> 4) << 32;
  d |= static_cast<uint64_t>(1) << 62;             // SWIZZLE_128B
  return d;
}

#define MF_ACC8(d, b)                                                        \
  "+f"(d[b]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]),                \
  "+f"(d[b + 4]), "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])
#define MF_ACC32(d, b)                                                       \
  MF_ACC8(d, b), MF_ACC8(d, b + 8), MF_ACC8(d, b + 16), MF_ACC8(d, b + 24)
#define MF_ACC128(d)                                                         \
  MF_ACC32(d, 0), MF_ACC32(d, 32), MF_ACC32(d, 64), MF_ACC32(d, 96)
#define MF_ACC_LIST                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"   \
  " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"   \
  " %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"   \
  " %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"   \
  " %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"   \
  " %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85,"   \
  " %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99,"   \
  " %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111," \
  " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123," \
  " %124, %125, %126, %127}, "

// d[64 x 256] (+)= A[64 x 16] B[256 x 16]^T, bf16 operands from shared
// memory, both K-major; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_bf16(float (&d)[128], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      MF_ACC_LIST
      "%128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : MF_ACC128(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// The same tile with TF32 operands (K = 8 per instruction, 32 bytes).
__device__ __forceinline__ void wgmma_tf32(float (&d)[128], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
      MF_ACC_LIST
      "%128, %129, p, 1, 1;\n"
      "}\n"
      : MF_ACC128(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// ------------------------------------------------------------- staging --
// One thread converts 4 consecutive samples of one plane.  Planes:
// [2B, M + 1, 128], plane 2b is lane b's re, 2b + 1 its im.  bf16: one
// array of bfloat16.  TF32: float32 hi planes, then (2B planes later) the
// float32 lo planes.
template <bool TF32>
__global__ void __launch_bounds__(256)
mf_stage_kernel(const float* __restrict__ re, const float* __restrict__ im,
                void* __restrict__ scratch, int B, int N, long long lo,
                int M) {
  const long long quads = static_cast<long long>(M + 1) * (BLK / 4);
  const long long gid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (gid >= quads * 2 * B) return;
  const int plane = static_cast<int>(gid / quads);
  const long long e = (gid % quads) * 4;
  const float* src =
      ((plane & 1) ? im : re) + static_cast<size_t>(plane >> 1) * N;
  const long long pos = lo + e;
  float v[4];
  if (pos >= 0 && pos + 3 < N &&
      (reinterpret_cast<uintptr_t>(src + pos) & 15) == 0) {
    const float4 t = *reinterpret_cast<const float4*>(src + pos);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long p = pos + i;
      v[i] = (p >= 0 && p < N) ? src[p] : 0.f;
    }
  }
  const size_t at = static_cast<size_t>(plane) * quads * 4 + e;
  if (!TF32) {
    __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 w;
    w.x = *reinterpret_cast<uint32_t*>(&a);
    w.y = *reinterpret_cast<uint32_t*>(&b);
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(scratch) + at) = w;
  } else {
    float hi[4], lw[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      hi[i] = __uint_as_float(__float_as_uint(v[i]) & 0xFFFFE000u);
      lw[i] = v[i] - hi[i];
    }
    float* s = static_cast<float*>(scratch);
    const size_t lo_planes = static_cast<size_t>(2 * B) * quads * 4;
    *reinterpret_cast<float4*>(s + at) =
        make_float4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<float4*>(s + lo_planes + at) =
        make_float4(lw[0], lw[1], lw[2], lw[3]);
  }
}

// ---------------------------------------------------------- main kernel --
template <int NWG, bool TF32>
struct Cfg {
  static constexpr int BM = 64 * NWG;              // rows per unit
  static constexpr int PARTS = TF32 ? 2 : 1;       // hi, lo
  static constexpr int KS = TF32 ? 32 : 64;        // elements per 128 bytes
  static constexpr int KSTEPS = KDIM / KS;         // stages per unit
  static constexpr int A_BYTES = BM * 128;         // one operand sub-tile
  static constexpr int W_BYTES = UNIT_N * 128;     // one weight sub-tile
  static constexpr int STAGE_BYTES = PARTS * (A_BYTES + W_BYTES);
  static constexpr int STAGES = TF32 ? 2 : 4;
  static constexpr int THREADS = NWG * 128 + 32;   // consumers + producer
  // stages (1024-aligned by hand) + full and empty barriers
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;
};

template <int NWG, bool TF32>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
mf_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,
                const __grid_constant__ CUtensorMap tm_w,
                float* __restrict__ out, int B, int M, int tiles_per_lane,
                int units) {
  using C = Cfg<NWG, TF32>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full0 = base + C::STAGES * C::STAGE_BYTES;
  const uint32_t empty0 = full0 + C::STAGES * 8;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);                 // the producer's expect_tx
      mbar_init(empty0 + 8 * s, NWG * 4);          // lane 0 of each warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  int stage = 0;
  uint32_t phase = 0;

  if (warp == NWG * 4) {
    // ---- producer: one thread keeps the ring full ----
    if (lane != 0) return;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int root = u % 3;
      const int tile = u / 3;
      const int b = tile / tiles_per_lane;
      const int j0 = (tile % tiles_per_lane) * C::BM;
      for (int ks = 0; ks < C::KSTEPS; ++ks) {
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        const uint32_t bar = full0 + 8 * stage;
        mbar_expect_tx(bar, C::STAGE_BYTES);
        const int quarter = ks / (C::KSTEPS / 4);  // re_j im_j re_j+1 im_j+1
        const int col = (ks % (C::KSTEPS / 4)) * C::KS;
        const int row = j0 + (quarter >> 1);
        const int plane = 2 * b + (quarter & 1);
        const uint32_t dst = base + stage * C::STAGE_BYTES;
#pragma unroll
        for (int p = 0; p < C::PARTS; ++p) {
          tma_load_3d(dst + p * C::A_BYTES, &tm_a, bar, col, row,
                      plane + p * 2 * B);
          tma_load_2d(dst + C::PARTS * C::A_BYTES + p * C::W_BYTES, &tm_w,
                      bar, ks * C::KS, root * UNIT_N + p * NW);
        }
        if (++stage == C::STAGES) { stage = 0; phase ^= 1; }
      }
    }
  } else {
    // ---- consumers: one warpgroup per 64 rows ----
    const int wg = warp / 4;
    float d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.f;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int root = u % 3;
      const int tile = u / 3;
      const int b = tile / tiles_per_lane;
      const int j0 = (tile % tiles_per_lane) * C::BM;
      int prev = 0;
#pragma unroll 1
      for (int ks = 0; ks < C::KSTEPS; ++ks) {
        mbar_wait(full0 + 8 * stage, phase);
        const uint32_t sa = base + stage * C::STAGE_BYTES + wg * 64 * 128;
        const uint32_t sw = base + stage * C::STAGE_BYTES
                            + C::PARTS * C::A_BYTES;
        const uint64_t da = smem_desc(sa);
        const uint64_t dw = smem_desc(sw);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {           // 4 x 32 bytes of K
          const int keep = (ks | kk) == 0 ? 0 : 1;  // 0: start a new sum
          if (TF32) {                              // small terms first
            const uint64_t da_lo = smem_desc(sa + C::A_BYTES);
            const uint64_t dw_lo = smem_desc(sw + C::W_BYTES);
            wgmma_tf32(d, da_lo + 2 * kk, dw + 2 * kk, keep);
            wgmma_tf32(d, da + 2 * kk, dw_lo + 2 * kk, 1);
            wgmma_tf32(d, da + 2 * kk, dw + 2 * kk, 1);
          } else {
            wgmma_bf16(d, da + 2 * kk, dw + 2 * kk, keep);
          }
        }
        wgmma_commit();
        if (ks > 0) {                              // the stage before retired
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(empty0 + 8 * prev);
        }
        prev = stage;
        if (++stage == C::STAGES) { stage = 0; phase ^= 1; }
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(empty0 + 8 * prev);

      // power = re^2 + im^2: accumulator columns n and n + 128 of a row sit
      // at d[4 i + 2 h + e] and d[4 (i + 16) + 2 h + e].
      const int r0 = j0 + wg * 64 + (warp % 4) * 16 + (lane >> 2);
      float* obase = out + static_cast<size_t>(b) * M * NPOW + root * BLK
                     + 2 * (lane & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = r0 + 8 * h;
        if (j < M) {
          float* orow = obase + static_cast<size_t>(j) * NPOW;
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const float r0v = d[4 * i + 2 * h], r1v = d[4 * i + 2 * h + 1];
            const float i0v = d[4 * (i + 16) + 2 * h];
            const float i1v = d[4 * (i + 16) + 2 * h + 1];
            *reinterpret_cast<float2*>(orow + 8 * i) =
                make_float2(r0v * r0v + i0v * i0v, r1v * r1v + i1v * i1v);
          }
        }
      }
    }
  }
}

// -------------------------------------------------------- tensor maps ----
struct MapKey {
  const void* ptr;
  int es, d0, d1, d2, b0, b1;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && es == o.es && d0 == o.d0 && d1 == o.d1 &&
           d2 == o.d2 && b0 == o.b0 && b1 == o.b1;
  }
};

// A tensor map over a dense [d2, d1, d0] array of 2- or 4-byte elements
// (d2 = 0: two-dimensional), box [1, b1, b0] with b0 * es = 128 bytes,
// 128-byte swizzle, zeros out of bounds.  Cached by pointer and shape (per
// host thread: ctypes calls run without the interpreter lock).
int tensor_map(CUtensorMap* out, const void* ptr, int es, int d0, int d1,
               int d2, int b0, int b1) {
  constexpr int SLOTS = 8;
  thread_local MapKey keys[SLOTS] = {};
  thread_local CUtensorMap maps[SLOTS];
  thread_local int next = 0;
  const MapKey key{ptr, es, d0, d1, d2, b0, b1};
  for (int i = 0; i < SLOTS; ++i)
    if (keys[i].ptr != nullptr && keys[i] == key) {
      *out = maps[i];
      return 0;
    }
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return 20000;
  const int rank = d2 > 0 ? 3 : 2;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1,
                              (cuuint64_t)(d2 > 0 ? d2 : 1)};
  const cuuint64_t strides[2] = {(cuuint64_t)d0 * es,
                                 (cuuint64_t)d0 * es * d1};
  const cuuint32_t box[3] = {(cuuint32_t)b0, (cuuint32_t)b1, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = enc(
      out, es == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                   : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      rank, const_cast<void*>(ptr), dims, strides, box, estr,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return 20000 + static_cast<int>(r);
  keys[next] = key;
  maps[next] = *out;
  next = (next + 1) % SLOTS;
  return 0;
}

// SMs of the current device (0 on error).
int sm_count() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  return v;
}

template <int NWG, bool TF32>
int launch_main(const void* Wt, void* scratch, float* out, int B, int M,
                int sms, cudaStream_t s) {
  using C = Cfg<NWG, TF32>;
  const int es = TF32 ? 4 : 2;
  CUtensorMap tm_a, tm_w;
  int rc = tensor_map(&tm_a, scratch, es, BLK, M + 1, 2 * B * C::PARTS,
                      C::KS, C::BM);
  if (rc != 0) return rc;
  rc = tensor_map(&tm_w, Wt, es, KDIM, NW * C::PARTS, 0, C::KS, UNIT_N);
  if (rc != 0) return rc;
  auto kernel = mf_wgmma_kernel<NWG, TF32>;
  // per device, so set on every launch: more than 48 KB of dynamic shared
  // memory needs the opt-in
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles_per_lane = (M + C::BM - 1) / C::BM;
  const long long units = 3LL * B * tiles_per_lane;
  if (units >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(units < sms ? units : sms);
  kernel<<<grid, C::THREADS, C::SMEM, s>>>(tm_a, tm_w, out, B, M,
                                           tiles_per_lane,
                                           static_cast<int>(units));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface (bound with ctypes).

// re, im: [B, N] float32.  Wt: W transposed (K contiguous) with one root's
// re and im columns adjacent, row 256 r + 128 c + m = column 384 c + 128 r
// + m of W; [768, 512] bfloat16 for bf16, [2, 768, 512] float32 (hi, lo)
// otherwise.  scratch: room for the staged planes [2B, M + 1, 128], in
// bfloat16 or in float32 twice (hi and lo), 16-byte aligned; scratch_bytes
// is what the caller allocated.  out: [B, M, 384] float32.  Launches on
// `stream`; returns 0 when both kernels were launched, else a cudaError, or
// 20000 + a CUresult from the tensor-map encoder.
extern "C" int mf_group_power(const float* re, const float* im,
                              const void* Wt, void* scratch,
                              long long scratch_bytes, float* out, int B,
                              int N, long long lo, int M, int bf16,
                              void* stream) {
  if (B <= 0 || M <= 0) return 0;
  if (scratch_bytes < 2LL * B * (M + 1) * BLK * (bf16 ? 2 : 8))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);

  const long long threads = 2LL * B * (M + 1) * (BLK / 4);
  const long long blocks = (threads + 255) / 256;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  if (bf16)
    mf_stage_kernel<false><<<static_cast<unsigned>(blocks), 256, 0, s>>>(
        re, im, scratch, B, N, lo, M);
  else
    mf_stage_kernel<true><<<static_cast<unsigned>(blocks), 256, 0, s>>>(
        re, im, scratch, B, N, lo, M);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  // 128-row units when they fill the card, 64-row units for small launches
  const bool big = 3LL * B * ((M + 127) / 128) >= sms;
  if (bf16)
    return big ? launch_main<2, false>(Wt, scratch, out, B, M, sms, s)
               : launch_main<1, false>(Wt, scratch, out, B, M, sms, s);
  return big ? launch_main<2, true>(Wt, scratch, out, B, M, sms, s)
             : launch_main<1, true>(Wt, scratch, out, B, M, sms, s);
}

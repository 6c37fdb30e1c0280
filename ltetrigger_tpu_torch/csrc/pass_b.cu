// Pass B of the grid engine: the PSS tracking recurrence over one group of
// half-frame steps, in one launch (Hopper, sm_90a).
//
// Replaces the device loop of the JAX package's pass B: the lax.scan of
// _step_core (ltetrigger_tpu/models/trigger.py:292, scans :422-424) with
// correlate.peak_and_psr_blocked (ltetrigger_tpu/ops/correlate.py:291).
// Its plain PyTorch version is scan_group_plain in
// ltetrigger_tpu_torch/ops/kernels/pass_b.py (about 45 small ops a step);
// this kernel computes what that code computes, step for step:
//
//   search = !tracking || timer == 0;   timer = search ? every : timer - 1
//   if search:
//     ema = 0.2f * power + 0.8f * ema   (two rounded products, one rounded
//                                        add: what eager PyTorch computes;
//                                        __fmul_rn / __fadd_rn keep nvcc
//                                        from contracting it into an FMA)
//     peak = first-occurrence argmax over the flat bin 128 * block + m
//     lobe edges: the least d in [1, 64] right (left) of the peak whose
//       next bin outward is larger; the bin past an end of the stream is
//       the bin itself, so it never rises; no rise: 64
//     side = max(0, max over the bins outside the lobe)
//     psr  = pk / max(side, 1e-30f)     (IEEE division)
//     psr ring push
//   the hysteresis (score, tracking, crossing, loss resets), exactly as
//   _step_core, and the seven rows (peak, psr, score, tracking, emit,
//   lost, consumed) of the step.
//
// Steps at and after n_active (the host's count; active steps are a prefix
// of the group) repeat the state with emit, lost and consumed zero.  At the
// end the block writes its EMA and carry to the output state: nothing is
// updated in place.  Power is a squared magnitude, so >= 0: the argmax and
// the maxima compare floats through an order-preserving 32-bit key, under
// which -0.0 sorts below +0.0; -0.0 and NaN inputs are outside the contract.
//
// Bound (C=128, g=25, one launch of the four of a 128 x 100 dispatch): the
// searched steps' power is read once, up to 128 x 25 x 28800 x 4 B = 369
// MB, and the EMA read and written once, 29.5 MB: 0.12 ms at 3.35 TB/s
// (H100 data sheet).  The arithmetic, ~10 operations a bin and step, is
// far under the FP32 rate.  The steps of a lane are serial, so the kernel
// is bound by bytes only if every step's loads are in flight while the
// steps run.  The design, one block of 320 threads per (channel, root):
//
// * One wave at C=128.  The lane's 9600-bin EMA lives in registers (30 a
//   thread, bin i = tid + 320 k, fully unrolled), so shared memory holds
//   only a staging copy of one step's power (37.5 KB) and ~1.5 KB more.
//   __launch_bounds__(320, 3) caps registers at 64, so 3 blocks fit on a
//   SM: 396 resident on 132 SMs, and a 128-channel group's 384 blocks run
//   in one wave.
// * The next searched step's power in flight while this step reduces.
//   Thread 0 copies a step with three tensor copies (TMA; one tensor map of
//   the power, [B g 75][3][128] floats, encoded on the host at each
//   launch), 25 rows of 512 B each, each completed on its own mbarrier, so
//   the pass starts on the first third while the rest lands.  As soon as a
//   step's pass over the staging buffer is done (block barrier 1) it
//   issues the copy of the next step predicted to search: t + 1 when not
//   tracking, t + 1 + every when tracking.  A crossing or a loss makes the
//   prediction wrong; the next searched step then waits for the stray copy
//   and loads its own power: a prefetch may fetch a step that is not
//   searched but never changes a result.  Unsearched steps read no power
//   and cross no barrier.  Three tensor copies, not one bulk copy a row:
//   with 75 one-dimensional copies a step the launch took 0.138 ms at B=1
//   and 0.184 at C=128 on an H100, with three tensor copies 0.070 and
//   0.142 (chip_smoke.py phase 3a).
// * One pass over the bins a step.  The pass updates the EMA in registers
//   and keeps each thread's largest bin (first occurrence) and its
//   second-largest value.  Block barrier 1 gives the peak (warp maxima by
//   __reduce_max_sync on the keys, then the least index among them).  The
//   lobe lies in the 131-bin window [pk - 65, pk + 65], and a thread owns
//   at most one bin of it (320 > 131): the owners write the window to
//   shared memory, and every thread's max outside the window is its
//   largest value, or its second largest where its largest bin is the one
//   in the window (the blocked form of peak_and_psr_blocked with the
//   thread's bins as the blocks).  Block barrier 2; then every warp walks
//   the lobe on the window (four ballots), takes the side lobe from the
//   window outside the lobe and the ten warps' outside maxima, and
//   computes the same psr: two block barriers a searched step, no
//   second pass over the 9600 bins.
// * Small batches (B = 1-16: 3-48 blocks, one a SM).  A searched step's
//   serial chain is then the pass over the staged bins on one SM, the two
//   barriers, the reductions and the lobe walk; the copy is off it.
//   Measured on an H100 (examples/pass_b_stamps_torch.py, B=1, medians):
//   0.54 us for the wait and the pass, 0.11 reduction and barrier 1, 0.42
//   window and barrier 2, 0.58 lobe walk and psr, 0.19 hysteresis, 0.22 to
//   the next step: 2.06 us a searched step, 0.35 an unsearched one.  A
//   launch lasts as long as its slowest lane: at B=1, g=32 a root that
//   searches all 32 steps loops for 66.6 us of the kernel's 70.3-us span
//   (prologue 1.2 us, carry-out 2.0).  A cluster of SMs per lane would
//   shorten only the pass and add two cluster barriers a step: not done.
//
// Resident on the card (NVIDIA H100 80GB HBM3; -Xptxas -v and
// cudaOccupancyMaxActiveBlocksPerMultiprocessor, printed by chip_smoke.py
// phase 3a through pb_kernel_info): 64 registers a thread with 208 B of
// spill a thread, all of it in the prologue and the carry-out (the step
// loop has none: cuobjdump -sass), 39872 B of static shared memory a
// block, 3 blocks a SM;
// one wave for every batch up to 132 channels, two at 256.  Times are in
// PERF.md (section 6).

#include <cuda.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "tma.cuh"

namespace {

constexpr int NBLK = 75;             // 128-bin blocks a half-frame
constexpr int M = 128;
constexpr int R = 3;                 // PSS roots
constexpr int NBIN = NBLK * M;       // 9600
constexpr int RING = 200;            // PSR telemetry ring (MOVING_AVG_SZ)
constexpr int LOBE = 64;
constexpr int HOOD = LOBE + 1;       // the window: [pk - 65, pk + 65]
constexpr int WIN = 2 * HOOD + 1;    // 131
constexpr int HALF_FRAME = 9600;
constexpr int THREADS = 320;
constexpr int MIN_BLOCKS = 3;        // a SM: a 128-channel group in one wave
constexpr int PER_THREAD = NBIN / THREADS;   // 30
constexpr int WARPS = THREADS / 32;
constexpr int CHUNKS = 3;            // tensor copies a step, 25 rows each
constexpr int CHUNK_ROWS = NBLK / CHUNKS;
constexpr int CHUNK_K = PER_THREAD / CHUNKS;  // a thread's bins a chunk
constexpr uint32_t CHUNK_BYTES = CHUNK_ROWS * M * 4;
constexpr unsigned FULL = 0xffffffffu;
static_assert(NBIN % THREADS == 0, "bins split evenly over the threads");
static_assert(THREADS > WIN, "a thread owns at most one bin of the window");
static_assert(WARPS <= 32, "warp maxima fit one warp");
static_assert(PER_THREAD % 6 == 0, "the window read selects in groups of 6");
static_assert(NBLK % CHUNKS == 0 && CHUNK_ROWS * M == CHUNK_K * THREADS,
              "a chunk is a whole range of k for every thread");

}  // namespace

// Field for field the ctypes.Structure in ops/kernels/pass_b.py.  State
// fields are [B, 3] (EMA [B, 75, 3, 128], ring [B, 3, 200]); power is
// [B, g, 75, 3, 128]; rows are [g, B, 3].  Bools are one byte, 0 or 1.
struct PassBArgs {
  const float* ema;
  const int32_t* score;
  const int32_t* timer;
  const uint8_t* tracking;
  const float* psr;
  const int32_t* peak;
  const float* psr_max;
  const float* psr_ring;
  const int32_t* psr_count;
  float* ema_out;
  int32_t* score_out;
  int32_t* timer_out;
  uint8_t* tracking_out;
  float* psr_out;
  int32_t* peak_out;
  float* psr_max_out;
  float* psr_ring_out;
  int32_t* psr_count_out;
  const float* power;
  int32_t* row_peak;
  float* row_psr;
  int32_t* row_score;
  uint8_t* row_tracking;
  uint8_t* row_emit;
  uint8_t* row_lost;
  int32_t* row_consumed;
  int32_t B;
  int32_t g;
  int32_t n_active;
  int32_t track_after;
  int32_t track_every;
  float thresh;
  float alpha;       // PSR_EMA_ALPHA as float32
  float beta;        // 1 - PSR_EMA_ALPHA, rounded to float32 as PyTorch does
};

namespace {

// ------------------------------------------------------------ helpers --
// an order-preserving key: a < b as floats iff key(a) < key(b) as
// unsigned, for all but NaN (and -0.0 below +0.0)
__device__ __forceinline__ uint32_t fkey(float v) {
  const uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float fkey_inv(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// v[kw] for a register array and a run-time index: selects in groups of 6
__device__ __forceinline__ float pick(const float (&v)[PER_THREAD], int kw) {
  const int hi = kw / 6, lo = kw % 6;
  float grp[PER_THREAD / 6];
#pragma unroll
  for (int a = 0; a < PER_THREAD / 6; ++a) {
    grp[a] = v[6 * a];
#pragma unroll
    for (int b = 1; b < 6; ++b) grp[a] = lo == b ? v[6 * a + b] : grp[a];
  }
  float out = grp[0];
#pragma unroll
  for (int a = 1; a < PER_THREAD / 6; ++a) out = hi == a ? grp[a] : out;
  return out;
}

// Built with -DPB_STAMPS (examples/pass_b_stamps_torch.py does), thread 0
// of block 0 records %globaltimer at six points of every step: its start,
// after the pass, after barrier 1, after barrier 2, after the psr, after
// the hysteresis; and thread 0 of every block (up to 4096) at four points
// of the launch: its entry, the end of the prologue (EMA, ring and scalars
// loaded, the first copy issued), the end of the step loop, the end of the
// carry-out.  pb_read_stamps copies them out.  Otherwise no code.
#ifdef PB_STAMPS
constexpr int STAMP_STEPS = 4096;
constexpr int STAMP_BLOCKS = 4096;
__device__ unsigned long long pb_stamps[STAMP_STEPS][6];
__device__ unsigned long long pb_block_stamps[STAMP_BLOCKS][4];
#define STAMP(t, i)                                                  \
  do {                                                               \
    if (blockIdx.x == 0 && threadIdx.x == 0 && (t) < STAMP_STEPS) {  \
      pb_stamps[t][i] = global_ns();                                 \
      if ((i) == 0)                                                  \
        for (int j = 1; j < 5; ++j) pb_stamps[t][j] = 0;             \
    }                                                                \
  } while (0)
#define BLOCK_STAMP(i)                                       \
  do {                                                       \
    if (threadIdx.x == 0 && blockIdx.x < STAMP_BLOCKS)       \
      pb_block_stamps[blockIdx.x][i] = global_ns();          \
  } while (0)
#else
#define STAMP(t, i) \
  do {              \
  } while (0)
#define BLOCK_STAMP(i) \
  do {                 \
  } while (0)
#endif

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    pb_scan_kernel(const __grid_constant__ CUtensorMap tm, const PassBArgs a) {
  __shared__ __align__(128) float stage[NBIN];   // one step's power
  __shared__ float win[WIN + 1];
  __shared__ float ring[RING];
  __shared__ uint32_t red_key[WARPS];
  __shared__ int red_idx[WARPS];
  __shared__ uint32_t red_side[WARPS];
  __shared__ __align__(8) uint64_t bar[CHUNKS];
  BLOCK_STAMP(0);

  const int lr = blockIdx.x;              // b * 3 + r
  const int b = lr / R, r = lr % R;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t bar_a = smem_u32(bar), stage_a = smem_u32(stage);

  if (tid == 0) {
    for (int c = 0; c < CHUNKS; ++c) mbar_init(bar_a + 8 * c, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the root's EMA, bin 128 * blk + m at [b, blk, r, m], into registers
  float ema[PER_THREAD];
  const float* ema_in = a.ema + static_cast<size_t>(b) * NBLK * R * M + r * M;
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int i = tid + THREADS * k;
    ema[k] = ema_in[(i >> 7) * (R * M) + (i & (M - 1))];
  }
  for (int j = tid; j < RING; j += THREADS)
    ring[j] = a.psr_ring[static_cast<size_t>(lr) * RING + j];
  int score = a.score[lr], timer = a.timer[lr], count = a.psr_count[lr];
  int peak = a.peak[lr];
  bool tracking = a.tracking[lr] != 0;
  float psr = a.psr[lr], psr_max = a.psr_max[lr];
  __syncthreads();

  // thread 0 copies step t's power into the staging buffer: three tensor
  // copies of 25 rows, each completed on its own barrier
  const int row0 = b * a.g * NBLK;
  auto issue = [&](int t) {
    if (tid != 0) return;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    for (int c = 0; c < CHUNKS; ++c) {
      mbar_expect_tx(bar_a + 8 * c, CHUNK_BYTES);
      // rows [row, row + 25) of root r, 128 floats each
      tma_load_3d(stage_a + c * CHUNK_BYTES, &tm, bar_a + 8 * c, 0, r,
                  row0 + t * NBLK + c * CHUNK_ROWS);
    }
  };
  auto wait_all = [&](uint32_t parity) {
    for (int c = 0; c < CHUNKS; ++c) mbar_wait(bar_a + 8 * c, parity);
  };
  int pending = -1;          // the step whose copy is in flight
  uint32_t phase = 0;
  {
    const int first = tracking ? timer : 0;     // the first searched step
    if (first < a.n_active) {
      issue(first);
      pending = first;
    }
  }
  BLOCK_STAMP(1);

  for (int t = 0; t < a.g; ++t) {
    const size_t row = (static_cast<size_t>(t) * a.B + b) * R + r;
    if (t >= a.n_active) {              // inactive: the state repeats
      if (tid == 0) {
        a.row_peak[row] = peak;
        a.row_psr[row] = psr;
        a.row_score[row] = score;
        a.row_tracking[row] = tracking;
        a.row_emit[row] = 0;
        a.row_lost[row] = 0;
        a.row_consumed[row] = 0;
      }
      continue;
    }
    const bool search = !tracking || timer == 0;
    timer = search ? a.track_every : timer - 1;
    STAMP(t, 0);

    if (search) {
      if (pending != t) {               // the prediction missed
        if (pending >= 0) {
          wait_all(phase);
          phase ^= 1;
          // every thread has seen that phase end before the next can
          __syncthreads();
        }
        issue(t);
      }

      // --- the one pass: EMA update, largest bin, second-largest value;
      // each chunk as soon as it has landed ---
      float top = __int_as_float(0xff800000), second = top;   // -inf
      int top_k = 0;
#pragma unroll
      for (int k = 0; k < PER_THREAD; ++k) {
        if (k % CHUNK_K == 0) mbar_wait(bar_a + 8 * (k / CHUNK_K), phase);
        const float e = __fadd_rn(__fmul_rn(a.alpha, stage[tid + THREADS * k]),
                                  __fmul_rn(a.beta, ema[k]));
        ema[k] = e;
        const bool up = e > top;
        second = up ? top : fmaxf(second, e);
        top = up ? e : top;
        top_k = up ? k : top_k;
      }
      phase ^= 1;
      pending = -1;
      STAMP(t, 1);
      const int top_i = tid + THREADS * top_k;
      {
        const uint32_t key = fkey(top);
        const uint32_t wk = __reduce_max_sync(FULL, key);
        const int wi = __reduce_min_sync(FULL, key == wk ? top_i : INT_MAX);
        if (lane == 0) {
          red_key[warp] = wk;
          red_idx[warp] = wi;
        }
      }
      __syncthreads();                  // 1: warp maxima; staging read
      STAMP(t, 2);

      // the next searched step, as far as this step can tell
      {
        const int nt = !tracking ? t + 1
                       : a.track_every >= a.g ? a.g
                                              : t + 1 + a.track_every;
        if (nt < a.n_active) {
          issue(nt);
          pending = nt;
        }
      }
      const uint32_t rk = lane < WARPS ? red_key[lane] : 0u;
      const uint32_t bk = __reduce_max_sync(FULL, rk);
      const int pk = __reduce_min_sync(
          FULL, lane < WARPS && rk == bk ? red_idx[lane] : INT_MAX);
      const float pk_val = fkey_inv(bk);

      // --- the window [pk - 65, pk + 65], and each thread's max outside ---
      const int base = pk - HOOD;
      int d = (tid - base) % THREADS;
      if (d < 0) d += THREADS;
      const int own = base + d;         // this thread's bin at window pos d
      float outside = top;
      if (d < WIN && own >= 0 && own < NBIN) {
        const int kw = (own - tid) / THREADS;
        win[d] = pick(ema, kw);
        if (kw == top_k) outside = second;
      }
      {
        const uint32_t sk = __reduce_max_sync(FULL, fkey(outside));
        if (lane == 0) red_side[warp] = sk;
      }
      __syncthreads();                  // 2: the window, the side maxima
      STAMP(t, 3);

      // --- every warp: the lobe walk, d = 1..64 right and left ---
      bool rise[4];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int dd = lane + 1 + 32 * s;
        const int ir = pk + dd, il = pk - dd;
        rise[s] = ir < NBIN - 1 && win[HOOD + dd + 1] > win[HOOD + dd];
        rise[2 + s] = il > 0 && win[HOOD - dd - 1] > win[HOOD - dd];
      }
      const unsigned r0 = __ballot_sync(FULL, rise[0]);
      const unsigned r1 = __ballot_sync(FULL, rise[1]);
      const unsigned l0 = __ballot_sync(FULL, rise[2]);
      const unsigned l1 = __ballot_sync(FULL, rise[3]);
      const int right = r0 ? __ffs(r0) : r1 ? 32 + __ffs(r1) : LOBE;
      const int left = l0 ? __ffs(l0) : l1 ? 32 + __ffs(l1) : LOBE;

      // --- the side lobe: the window outside the lobe, and the rest ---
      float sv = 0.0f;
#pragma unroll
      for (int u = 0; u < (WIN + 31) / 32; ++u) {
        const int w = lane + 32 * u;
        const int i = base + w, rel = w - HOOD;
        if (w < WIN && i >= 0 && i < NBIN && (rel < -left || rel > right))
          sv = fmaxf(sv, win[w]);
      }
      const uint32_t side_in = __reduce_max_sync(FULL, fkey(sv));
      const uint32_t side_out =
          __reduce_max_sync(FULL, lane < WARPS ? red_side[lane] : 0u);
      const float side =
          fmaxf(fkey_inv(side_in > side_out ? side_in : side_out), 0.0f);

      psr = __fdiv_rn(pk_val, fmaxf(side, 1e-30f));
      STAMP(t, 4);
      peak = pk;
      if (tid == 0) ring[count % RING] = psr;
      count += 1;
    }

    // --- hysteresis scoring (reference incr_score / reset_score) ---
    const bool over = psr > a.thresh;
    const int score_inc = min(score + 1, a.track_after);
    const bool crossing = over && !tracking && score_inc == a.track_after;
    const bool lost = !over && score > 0;
    score = over ? score_inc : 0;
    tracking = over && (tracking || crossing);
    if (crossing || lost) {
#pragma unroll
      for (int k = 0; k < PER_THREAD; ++k) ema[k] = 0.0f;
    }
    if (lost) {
      timer = 0;
      count = 0;
      if (tid == 0)
        for (int j = 0; j < RING; ++j) ring[j] = 0.0f;
    }
    STAMP(t, 5);
    // torch.maximum: a NaN in either operand is the result
    if (psr > psr_max || psr != psr) psr_max = psr;

    if (tid == 0) {
      a.row_peak[row] = peak;
      a.row_psr[row] = psr;
      a.row_score[row] = score;
      a.row_tracking[row] = tracking;
      a.row_emit[row] = over || lost;
      a.row_lost[row] = lost;
      a.row_consumed[row] = HALF_FRAME;
    }
  }

  BLOCK_STAMP(2);

  // --- the carry out; no copy may still be landing ---
  if (pending >= 0) wait_all(phase);
  __syncthreads();
  float* ema_out = a.ema_out + static_cast<size_t>(b) * NBLK * R * M + r * M;
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int i = tid + THREADS * k;
    ema_out[(i >> 7) * (R * M) + (i & (M - 1))] = ema[k];
  }
  for (int j = tid; j < RING; j += THREADS)
    a.psr_ring_out[static_cast<size_t>(lr) * RING + j] = ring[j];
  if (tid == 0) {
    a.score_out[lr] = score;
    a.timer_out[lr] = timer;
    a.tracking_out[lr] = tracking;
    a.psr_out[lr] = psr;
    a.peak_out[lr] = peak;
    a.psr_max_out[lr] = psr_max;
    a.psr_count_out[lr] = count;
  }
  BLOCK_STAMP(3);
}

// The power [B, g, 75, 3, 128] as a 3-D tensor [B g 75][3][128] of float32
// rows; box [25][1][128]: 25 rows of one root, 12800 B.  Returns 0 or
// 20000 + a CUresult.
int power_map(CUtensorMap* out, const float* power, int B, int g) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return 20000;
  const cuuint64_t dims[3] = {M, R, static_cast<cuuint64_t>(B) * g * NBLK};
  const cuuint64_t strides[2] = {M * 4, R * M * 4};
  const cuuint32_t box[3] = {M, 1, CHUNK_ROWS};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult res = enc(
      out, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(power),
      dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : 20000 + static_cast<int>(res);
}

// ask for the largest shared-memory carveout once per device, so that
// MIN_BLOCKS blocks fit beside L1
cudaError_t prefer_shared() {
  static int done_for = -1;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || done_for == dev) return e;
  e = cudaFuncSetAttribute(pb_scan_kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           static_cast<int>(cudaSharedmemCarveoutMaxShared));
  if (e == cudaSuccess) done_for = dev;
  return e;
}

}  // namespace

// One group of pass B on `stream`: one block per (channel, root).  The
// power must be 16-byte aligned (the tensor map's rule; the wrapper sees
// to it).  Returns 0, a cudaError, or 20000 + a CUresult from the
// tensor-map encoder.
extern "C" int pb_scan_group(const PassBArgs* args, void* stream) {
  if (args->B <= 0 || args->g <= 0) return 0;
  const long long blocks = static_cast<long long>(args->B) * R;
  if (blocks >= (1LL << 31) ||
      static_cast<long long>(args->B) * args->g * NBLK >= (1LL << 31) ||
      reinterpret_cast<uintptr_t>(args->power) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm;
  const int rc = power_map(&tm, args->power, args->B, args->g);
  if (rc != 0) return rc;
  const cudaError_t e = prefer_shared();
  if (e != cudaSuccess) return static_cast<int>(e);
  pb_scan_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(tm, *args);
  return static_cast<int>(cudaGetLastError());
}

#ifdef PB_STAMPS
// The stamps of the last launch, nanoseconds (0: not reached): block 0's
// steps [4096][6] into `steps`, every block's launch [4096][4] into
// `blocks`.
extern "C" int pb_read_stamps(unsigned long long* steps,
                              unsigned long long* blocks) {
  cudaError_t e = cudaMemcpyFromSymbol(steps, pb_stamps, sizeof(pb_stamps));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(blocks, pb_block_stamps,
                             sizeof(pb_block_stamps));
  return static_cast<int>(e);
}
#endif

// out[0..3]: registers a thread, local (spill) bytes a thread, static
// shared memory a block, blocks resident a SM.  Returns 0 or a cudaError.
extern "C" int pb_kernel_info(int* out) {
  cudaError_t e = prefer_shared();
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, pb_scan_kernel);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, pb_scan_kernel,
                                                      THREADS, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(fa.sharedSizeBytes);
  out[3] = n;
  return 0;
}

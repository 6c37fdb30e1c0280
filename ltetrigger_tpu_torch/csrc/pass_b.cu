// Pass B of the grid engine: the PSS tracking recurrence over one group of
// half-frame steps, in one launch (Hopper, sm_90a).
//
// Replaces the device loop of the JAX package's pass B: the lax.scan of
// _step_core (ltetrigger_tpu/models/trigger.py:292, scans :422-424) with
// correlate.peak_and_psr_blocked (ltetrigger_tpu/ops/correlate.py:291).
// Its plain PyTorch version is scan_group_plain in
// ltetrigger_tpu_torch/ops/kernels/pass_b.py (about 45 small ops a step);
// this kernel computes what that code computes, step for step.
//
// One block per (channel, PSS root): roots are independent in the step,
// and the grid position, which all share, stays a host integer.  The
// block keeps the root's 9600-bin EMA (37.5 KB) in shared memory for the
// whole group and, for each of the group's g steps:
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
// updated in place.  Inputs that hold NaN are outside the contract.
//
// Bound (C=128, g=25, one launch of the four of a 128 x 100 dispatch): the
// power is read once, 128 x 25 x 28800 x 4 B = 369 MB, and the EMA read and
// written once, 29.5 MB: 398 MB, 0.12 ms at 3.35 TB/s (H100 data sheet).
// The arithmetic, ~10 operations a bin and step, is 100x under the FP32
// rate.  The steps of a block are serial; 384 blocks of 320 threads all fit
// on the card at once (2 a SM, set by registers), so each step's power
// read is ~1.5 MB in flight across the card.  Each thread owns 30 bins
// (i = tid + 320 k, so a warp reads 128 contiguous bytes of one 128-bin
// block row) and issues its 30 loads together.  Per step: one pass over
// the bins (load, EMA, local argmax), a block argmax, the lobe walk (four
// warps, one ballot each), one pass for the side lobe, a block max:
// three barriers.  Tensor cores, TMA and fusing the EMA into the matched
// filter's epilogue are not used: a first kernel that is right.
//
// Predicted and measured times are in PERF.md (section 6).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NBLK = 75;             // 128-bin blocks a half-frame
constexpr int M = 128;
constexpr int R = 3;                 // PSS roots
constexpr int NBIN = NBLK * M;       // 9600
constexpr int RING = 200;            // PSR telemetry ring (MOVING_AVG_SZ)
constexpr int LOBE = 64;
constexpr int HALF_FRAME = 9600;
constexpr int THREADS = 320;
constexpr int PER_THREAD = NBIN / THREADS;   // 30
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
static_assert(NBIN % THREADS == 0, "bins split evenly over the threads");

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

// (value, index) pairs: the larger value wins, the smaller index on a tie
__device__ __forceinline__ void argmax_merge(float& v, int& i, float ov,
                                             int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// two blocks a SM (<= 102 registers a thread): the 384 blocks of a
// 128-channel group are all resident at once
__global__ void __launch_bounds__(THREADS, 2)
    pb_scan_kernel(const PassBArgs a) {
  __shared__ float ema[NBIN];
  __shared__ float ring[RING];
  __shared__ float red_v[WARPS];
  __shared__ int red_i[WARPS];
  __shared__ float red_s[WARPS];
  __shared__ unsigned edge_bits[4];

  const int lr = blockIdx.x;              // b * 3 + r
  const int b = lr / R, r = lr % R;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // the root's EMA: bin 128 * blk + m sits at [b, blk, r, m]
  const float* ema_in = a.ema + static_cast<size_t>(b) * NBLK * R * M + r * M;
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int i = tid + THREADS * k;
    ema[i] = ema_in[(i >> 7) * (R * M) + (i & (M - 1))];
  }
  if (tid == 0)
    for (int j = 0; j < RING; ++j)
      ring[j] = a.psr_ring[static_cast<size_t>(lr) * RING + j];
  int score = a.score[lr], timer = a.timer[lr], count = a.psr_count[lr];
  int peak = a.peak[lr];
  bool tracking = a.tracking[lr] != 0;
  float psr = a.psr[lr], psr_max = a.psr_max[lr];
  __syncthreads();

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

    if (search) {
      // --- EMA update with this step's power, and the local argmax ---
      const float* p = a.power +
                       (static_cast<size_t>(b) * a.g + t) * (NBLK * R * M) +
                       r * M;
      float pw[PER_THREAD];
#pragma unroll
      for (int k = 0; k < PER_THREAD; ++k) {
        const int i = tid + THREADS * k;
        pw[k] = __ldg(p + (i >> 7) * (R * M) + (i & (M - 1)));
      }
      float bv = __int_as_float(0xff800000);   // -inf
      int bi = 0x7fffffff;
#pragma unroll
      for (int k = 0; k < PER_THREAD; ++k) {
        const int i = tid + THREADS * k;
        const float e =
            __fadd_rn(__fmul_rn(a.alpha, pw[k]), __fmul_rn(a.beta, ema[i]));
        ema[i] = e;
        argmax_merge(bv, bi, e, i);
      }
#pragma unroll
      for (int off = 16; off; off >>= 1)
        argmax_merge(bv, bi, __shfl_down_sync(FULL, bv, off),
                     __shfl_down_sync(FULL, bi, off));
      if (lane == 0) {
        red_v[warp] = bv;
        red_i[warp] = bi;
      }
      __syncthreads();
      float pk_val = red_v[0];
      int pk = red_i[0];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) argmax_merge(pk_val, pk, red_v[w], red_i[w]);

      // --- the lobe walk: warps 0-1 right (d = 1..64), 2-3 left ---
      if (warp < 4) {
        const int d = (warp & 1) * 32 + lane + 1;
        bool rise = false;
        if (warp < 2) {
          const int i = pk + d;
          if (i < NBIN) rise = ema[min(i + 1, NBIN - 1)] > ema[i];
        } else {
          const int i = pk - d;
          if (i >= 0) rise = ema[max(i - 1, 0)] > ema[i];
        }
        const unsigned bal = __ballot_sync(FULL, rise);
        if (lane == 0) edge_bits[warp] = bal;
      }
      __syncthreads();
      const int right = edge_bits[0]   ? __ffs(edge_bits[0])
                        : edge_bits[1] ? 32 + __ffs(edge_bits[1])
                                       : LOBE;
      const int left = edge_bits[2]   ? __ffs(edge_bits[2])
                       : edge_bits[3] ? 32 + __ffs(edge_bits[3])
                                      : LOBE;

      // --- the side lobe: the max outside [pk - left, pk + right] ---
      float sv = 0.0f;
#pragma unroll
      for (int k = 0; k < PER_THREAD; ++k) {
        const int i = tid + THREADS * k;
        const int rel = i - pk;
        if (rel < -left || rel > right) sv = fmaxf(sv, ema[i]);
      }
#pragma unroll
      for (int off = 16; off; off >>= 1)
        sv = fmaxf(sv, __shfl_down_sync(FULL, sv, off));
      if (lane == 0) red_s[warp] = sv;
      __syncthreads();
      float side = red_s[0];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) side = fmaxf(side, red_s[w]);

      psr = __fdiv_rn(pk_val, fmaxf(side, 1e-30f));
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
      // each thread clears the bins it alone reads and writes until the
      // next barrier
#pragma unroll
      for (int k = 0; k < PER_THREAD; ++k) ema[tid + THREADS * k] = 0.0f;
    }
    if (lost) {
      timer = 0;
      count = 0;
      if (tid == 0)
        for (int j = 0; j < RING; ++j) ring[j] = 0.0f;
    }
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

  // --- the carry out ---
  __syncthreads();
  float* ema_out = a.ema_out + static_cast<size_t>(b) * NBLK * R * M + r * M;
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int i = tid + THREADS * k;
    ema_out[(i >> 7) * (R * M) + (i & (M - 1))] = ema[i];
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
}

}  // namespace

// One group of pass B on `stream`: one block per (channel, root).  Returns 0
// or the cudaError of the launch.
extern "C" int pb_scan_group(const PassBArgs* args, void* stream) {
  if (args->B <= 0 || args->g <= 0) return 0;
  const long long blocks = static_cast<long long>(args->B) * R;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  pb_scan_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

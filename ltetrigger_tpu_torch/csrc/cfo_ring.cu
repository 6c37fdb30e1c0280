// The 200-slot CFO telemetry ring of pass C over a dispatch longer than the
// ring, in one launch (Hopper, sm_90a).
//
// Replaces the device loop of the JAX package's _mib_postpass for s > 200
// steps: the lax.scan of `ring_step` (ltetrigger_tpu/models/trigger.py:962,
// scanned at :972).  Its plain PyTorch version is ring_scan_plain in
// ltetrigger_tpu_torch/ops/kernels/cfo_ring.py (about 15 small ops a step);
// this kernel computes what that code computes, step for step:
//
//   if lost[t]: ring = 0, count = 0
//   if push[t]: ring[count mod 200] = est[t], count += 1
//   mean[t] = count > 0 ? sum(ring) / min(count, 200) : 0
//
// Ring and count are exact; the sum is a warp-shuffle tree, so only its
// order differs from the plain version's ring.sum(-1).
//
// Bound (48 lanes, S = 400: the 2-s band scan of 16 channels): the ring
// read and written once, est / push / lost read and the means written
// once, ~0.27 MB, 0.1 us at 3.35 TB/s (H100 data sheet); the 200-value sum
// a step, 3.8 M adds, about as little.  Neither is the floor: the S steps
// of a lane are a serial chain (a push into the ring, then a sum over it),
// so the launch lasts at least S dependent sums.  The design, one warp a
// lane and 4 lanes a block:
//
// * The ring in registers: slot i + 32 j in register j of thread i (7 a
//   thread, 224 slots, the 24 past 200 stay 0), the count in a register of
//   every thread.  A push is a compare and a select in each register, with
//   no index into local memory.
// * The lane's inputs staged once: est, push and lost of up to 256 steps
//   at a time (6 bytes a step) into the warp's shared memory with one load
//   a thread and step, one __syncwarp, so the chain reads no device memory.
// * The mean: each thread sums its 7 registers, then five xor shuffles;
//   lane 0 divides (IEEE) and writes.
//
// The kernel allocates nothing and does not synchronise.  Times are in
// PERF.md (section 6).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int RING = 200;
constexpr int PER = 7;                 // ring slots a thread (224 >= 200)
constexpr int WARPS = 4;               // lanes a block
constexpr int MIN_BLOCKS = 8;          // a SM (registers capped at 64)
constexpr int STAGE = 256;             // steps staged at once
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS)
    ring_scan_kernel(const float* __restrict__ ring0,
                     const int32_t* __restrict__ count0,
                     const float* __restrict__ est,
                     const bool* __restrict__ push,
                     const bool* __restrict__ lost, long long L, int S,
                     float* __restrict__ ring_f, int32_t* __restrict__ count_f,
                     float* __restrict__ mean) {
  __shared__ float s_est[WARPS][STAGE];
  __shared__ unsigned char s_flag[WARPS][STAGE];   // bit 0 push, bit 1 lost

  const int w = threadIdx.x >> 5, ln = threadIdx.x & 31;
  const long long lane = static_cast<long long>(blockIdx.x) * WARPS + w;
  if (lane >= L) return;               // the whole warp; no block barrier

  float r[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int slot = ln + 32 * j;
    r[j] = slot < RING ? ring0[lane * RING + slot] : 0.f;
  }
  int count = count0[lane];

  for (int t0 = 0; t0 < S; t0 += STAGE) {
    const int n = min(STAGE, S - t0);
    for (int j = ln; j < n; j += 32) {
      const long long i = static_cast<long long>(t0 + j) * L + lane;
      s_est[w][j] = est[i];
      s_flag[w][j] = static_cast<unsigned char>(push[i] | (lost[i] << 1));
    }
    __syncwarp();
    for (int j = 0; j < n; ++j) {
      const int f = s_flag[w][j];
      if (f & 2) {
#pragma unroll
        for (int k = 0; k < PER; ++k) r[k] = 0.f;
        count = 0;
      }
      if (f & 1) {
        const float e = s_est[w][j];
        const int slot = ((count % RING) + RING) % RING;
#pragma unroll
        for (int k = 0; k < PER; ++k)
          if (ln + 32 * k == slot) r[k] = e;
        count += 1;
      }
      float s = r[0];
#pragma unroll
      for (int k = 1; k < PER; ++k) s = __fadd_rn(s, r[k]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        s = __fadd_rn(s, __shfl_xor_sync(FULL, s, o));
      if (ln == 0) {
        const int live = min(count, RING);
        mean[static_cast<long long>(t0 + j) * L + lane] =
            live > 0 ? __fdiv_rn(s, static_cast<float>(live)) : 0.f;
      }
    }
    __syncwarp();                      // before the next stage overwrites
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int slot = ln + 32 * j;
    if (slot < RING) ring_f[lane * RING + slot] = r[j];
  }
  if (ln == 0) count_f[lane] = count;
}

}  // namespace

// Run S steps for each of L lanes: ring0 [L, 200] float32, count0 [L]
// int32, est [S, L] float32, push / lost [S, L] bool; out ring_f [L, 200],
// count_f [L], mean [S, L].  Returns 0 or the cudaError of the launch.
extern "C" int ring_scan(const float* ring0, const int32_t* count0,
                         const float* est, const bool* push, const bool* lost,
                         long long L, int S, float* ring_f, int32_t* count_f,
                         float* mean, void* stream) {
  if (L <= 0) return 0;
  const long long blocks = (L + WARPS - 1) / WARPS;
  if (S < 0 || blocks >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  ring_scan_kernel<<<static_cast<unsigned>(blocks), WARPS * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      ring0, count0, est, push, lost, L, S, ring_f, count_f, mean);
  return static_cast<int>(cudaGetLastError());
}

// out[0..3]: registers a thread, local (spill) bytes a thread, static
// shared memory a block, blocks resident a SM.  Returns 0 or a cudaError.
extern "C" int ring_kernel_info(int* out) {
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, ring_scan_kernel);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ring_scan_kernel,
                                                      WARPS * 32, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(fa.sharedSizeBytes);
  out[3] = n;
  return 0;
}

// The 200-slot CFO telemetry ring of pass C over a dispatch of any length,
// in one launch (Hopper, sm_90a).
//
// Replaces the device loop of the JAX package's _mib_postpass for s > 200
// steps, the lax.scan of `ring_step` (ltetrigger_tpu/models/trigger.py:962,
// scanned at :972), and its closed form (:679) for s <= 200 steps.  Its plain PyTorch version is ring_scan_plain in
// ltetrigger_tpu_torch/ops/kernels/cfo_ring.py (about 15 small ops a step);
// this kernel computes what that code computes, step for step:
//
//   if lost[t]: ring = 0, count = 0
//   if push[t]: ring[count mod 200] = est[t], count += 1
//   mean[t] = count > 0 ? sum(ring) / min(count, 200) : 0
//
// Ring and count are exact for any input ring and count; each step's sum
// is taken in another order than the plain version's ring.sum(-1).
//
// Bound (48 lanes, S = 400: the 2-s band scan of 16 channels): the ring
// read and written once, est / push / lost read and the means written
// once, ~0.27 MB, 0.1 us at 3.35 TB/s (H100 data sheet); the 200-value sum
// a step, 3.8 M adds, about as little.  A step's mean depends on the
// ring's contents at that step, not on the step before's sum, and the
// contents depend on the push and loss flags alone: nothing forces the S
// steps into one dependent chain.  The design, one block of 256 threads a
// lane, S steps in tiles of 32, two block barriers a tile:
//
// * The count by ballots, in a warp of its own.  Warp 7, lane i for step
//   t0 + i: the pushes since the tile's last reset at or before step i (a
//   ballot of lost, a ballot of push, a popc), or the carry plus every
//   push up to i; the slot a push writes (count before it, mod 200) and
//   min(count, 200) follow, the carry is one shuffle.  It does this for
//   the next tile (inputs loaded a tile ahead, a second buffer of slots,
//   estimates and the reset mask) while warps 0-6 walk this one.
// * The ring off the sum's chain.  Thread j < 200 holds slot j and walks
//   the tile's 32 steps: zero on a reset, est on a push into slot j (a
//   compare and a select a step, a third test only in a tile with a
//   reset; nothing from another thread; the slots read 4 steps at a time,
//   broadcast), and writes its value of each step into a [32, 204] shared
//   tile.
// * The sums across the tile.  Warp w < 7, lane l sums slots 32w..32w+31
//   of step l's row (float4 reads, rows 204 floats apart: no bank
//   conflict; 4 partial sums).  Warp 7 adds the 7 partials in order and
//   divides (IEEE) while warps 0-6 walk the next tile.
//
// The kernel allocates nothing and does not synchronise.  Times are in
// PERF.md (section 6).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int RING = 200;
constexpr int SUM_WARPS = 7;           // thread j < 200 walks slot j
constexpr int SCALAR_WARP = SUM_WARPS; // the counts and the means
constexpr int THREADS = 32 * (SUM_WARPS + 1);
constexpr int TILE = 32;               // steps a tile (a warp's lanes)
constexpr int PITCH = RING + 4;        // float4 rows, 12 banks apart
constexpr int MIN_BLOCKS = 6;          // a SM (registers capped at 40)
constexpr int NONE = -1;               // slot: no push
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int highest(unsigned m) { return 31 - __clz(m); }

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

struct Inputs {                        // one step's, in a lane of warp 7
  float e = 0.f;
  bool push = false, lost = false;
};

__device__ __forceinline__ Inputs load_step(const float* est,
                                            const bool* push,
                                            const bool* lost, long long L,
                                            int S, long long lane, int t) {
  Inputs in;
  if (t < S) {
    const long long i = static_cast<long long>(t) * L + lane;
    in.e = est[i];
    in.push = push[i];
    in.lost = lost[i];
  }
  return in;
}

// Warp 7, lane i for step i of a tile of n: the slot each step pushes
// into (or NONE), its estimate and the tile's reset mask into slot / e /
// *reset; the carry advanced past the tile.  Returns min(count after step
// i, 200).
__device__ __forceinline__ int tile_scalars(const Inputs& in, int ln, int n,
                                            unsigned& count, int* slot,
                                            float* e, unsigned* reset) {
  const unsigned P = __ballot_sync(FULL, in.push);
  const unsigned R = __ballot_sync(FULL, in.lost);
  const unsigned upto = (2u << ln) - 1u;         // steps 0..i
  const unsigned rb = R & upto;
  const unsigned after =
      rb ? static_cast<unsigned>(
               __popc(P & upto & ~((1u << highest(rb)) - 1u)))
         : count + static_cast<unsigned>(__popc(P & upto));
  const int before = static_cast<int>(after - (in.push ? 1u : 0u));
  slot[ln] = in.push ? ((before % RING) + RING) % RING : NONE;
  e[ln] = in.e;
  if (ln == 0) *reset = R;
  count = __shfl_sync(FULL, after, n - 1);
  return min(static_cast<int>(after), RING);
}

// Slot t through a tile: a reset (bit u of `reset`, only if RESETS)
// zeroes it, a push into slot t writes its estimate; its value after each
// step into row u of the tile.
template <bool RESETS>
__device__ __forceinline__ void walk(float& v, int t, const int* slot,
                                     const float* est, unsigned reset,
                                     float (*tile)[PITCH]) {
#pragma unroll
  for (int q = 0; q < TILE / 4; ++q) {
    const int4 o = reinterpret_cast<const int4*>(slot)[q];
    const float4 e = reinterpret_cast<const float4*>(est)[q];
    const int slots[4] = {o.x, o.y, o.z, o.w};
    const float es[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (RESETS && ((reset >> (4 * q + r)) & 1u)) v = 0.f;
      if (slots[r] == t) v = es[r];
      tile[4 * q + r][t] = v;
    }
  }
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    ring_scan_kernel(const float* __restrict__ ring0,
                     const int32_t* __restrict__ count0,
                     const float* __restrict__ est,
                     const bool* __restrict__ push,
                     const bool* __restrict__ lost, long long L, int S,
                     float* __restrict__ ring_f, int32_t* __restrict__ count_f,
                     float* __restrict__ mean) {
  __shared__ __align__(16) float s_tile[TILE][PITCH];
  __shared__ float s_part[SUM_WARPS][TILE];
  __shared__ __align__(16) int s_slot[2][TILE];
  __shared__ __align__(16) float s_est[2][TILE];
  __shared__ unsigned s_reset[2];

  const long long lane = blockIdx.x;
  const int t = threadIdx.x, w = t >> 5, ln = t & 31;
  float v = t < RING ? ring0[lane * RING + t] : 0.f;
  // warp 7: the carry, the next tile's inputs, the live counts of the
  // tile being walked and of the one being summed
  unsigned count = static_cast<unsigned>(count0[lane]);
  Inputs next;
  int live = 0, live_summed = 0;
  if (w == SCALAR_WARP) {
    const Inputs in = load_step(est, push, lost, L, S, lane, ln);
    next = load_step(est, push, lost, L, S, lane, TILE + ln);
    if (S > 0)
      live = tile_scalars(in, ln, min(TILE, S), count, s_slot[0], s_est[0],
                          &s_reset[0]);
  }
  __syncthreads();

  for (int t0 = 0, b = 0; t0 < S; t0 += TILE, b ^= 1) {
    if (t < RING) {                    // the ring: slot t through the tile
      const unsigned reset = s_reset[b];
      if (reset)
        walk<true>(v, t, s_slot[b], s_est[b], reset, s_tile);
      else
        walk<false>(v, t, s_slot[b], s_est[b], 0u, s_tile);
    } else if (w == SCALAR_WARP) {
      if (t0 > 0) {                    // the means of the tile before
        float s = s_part[0][ln];
#pragma unroll
        for (int k = 1; k < SUM_WARPS; ++k) s = __fadd_rn(s, s_part[k][ln]);
        mean[static_cast<long long>(t0 - TILE + ln) * L + lane] =
            live_summed > 0
                ? __fdiv_rn(s, static_cast<float>(live_summed)) : 0.f;
      }
      live_summed = live;
      if (t0 + TILE < S) {             // the next tile's scalars
        const Inputs in = next;
        next = load_step(est, push, lost, L, S, lane, t0 + 2 * TILE + ln);
        live = tile_scalars(in, ln, min(TILE, S - t0 - TILE), count,
                            s_slot[b ^ 1], s_est[b ^ 1], &s_reset[b ^ 1]);
      }
    }
    __syncthreads();
    if (w < SUM_WARPS) {               // step ln's slots 32w..32w+31
      const float4* row =
          reinterpret_cast<const float4*>(&s_tile[ln][32 * w]);
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      if (w < SUM_WARPS - 1) {
#pragma unroll
        for (int j = 0; j < 8; ++j) a = add4(a, row[j]);
      } else {
#pragma unroll
        for (int j = 0; j < (RING - 32 * (SUM_WARPS - 1)) / 4; ++j)
          a = add4(a, row[j]);
      }
      s_part[w][ln] = __fadd_rn(__fadd_rn(a.x, a.y), __fadd_rn(a.z, a.w));
    }
    __syncthreads();
  }
  if (w == SCALAR_WARP && S > 0) {     // the last tile's means
    const int t0 = (S - 1) / TILE * TILE;
    float s = s_part[0][ln];
#pragma unroll
    for (int k = 1; k < SUM_WARPS; ++k) s = __fadd_rn(s, s_part[k][ln]);
    if (t0 + ln < S)
      mean[static_cast<long long>(t0 + ln) * L + lane] =
          live_summed > 0 ? __fdiv_rn(s, static_cast<float>(live_summed))
                          : 0.f;
  }
  if (t < RING) ring_f[lane * RING + t] = v;
  if (t == 32 * SCALAR_WARP) count_f[lane] = static_cast<int32_t>(count);
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
  if (S < 0 || L >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  ring_scan_kernel<<<static_cast<unsigned>(L), THREADS, 0,
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
                                                      THREADS, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(fa.sharedSizeBytes);
  out[3] = n;
  return 0;
}

// The TTI soft-combining chain of pass C's MIB decode, over the K captured
// candidates of each lane (channel x root), in one launch (Hopper, sm_90a).
//
// Replaces the device loop of the JAX package's _decode_candidates: the
// lax.scan of `chain` (ltetrigger_tpu/models/trigger.py:848, scanned at
// :879).  Its plain PyTorch version is tti_chain_plain in
// ltetrigger_tpu_torch/ops/kernels/tti_chain.py (about 15 small ops a
// slot); this kernel computes what that code computes, slot for slot:
//
//   restart = (!combine || fresh[k]) || cell[k] != cell
//   n_k     = restart ? 0 : n
//   q[h]    = (n_k + h) mod 4                      (h = 0..3, the phase)
//   sel[p, h, :] = contrib[k, p, q[h], :]          (p = 0..2, the port)
//   new[p, h, :] = q[h] == 0 ? sel : (restart ? 0 : acc) + sel
//   if valid[k]: acc = new, n = n_k + 1, cell = cell[k]
//   accs[k] = acc, qs[k] = q
//
// The one add an element is __fadd_rn (nothing to contract: no product),
// so the kernel is bit for bit the plain version, -0.0 and all (a
// restarting phase adds its LLRs to +0.0, turning -0.0 into +0.0).
//
// Bound (chip_smoke.tti_bound, the one count used everywhere): the LLRs of
// each slot in use read once, the accumulator after every slot written
// once, the carry read and written once, flags, cell ids and quarters once;
// for the seeded C=128 x 3 lanes x K=16 inputs (about half the slots in
// use) ~57.6 MB, 0.0172 ms at 3.35 TB/s (H100 data sheet).  The adds are
// nothing beside it.  Each element's slots are a serial chain, so the
// launch is bound by bytes only if many slots' loads are in flight while
// one is folded in.  The design:
//
// * A lane split across warps.  Every element's chain is independent; only
//   the scalars (restart, n_k, q) are shared, and they do not depend on
//   the LLRs.  A lane's 360 float4s go to 12 warps, one a (port, group of
//   8 float4 columns): thread (column c, phase h) of a warp holds
//   acc[port, h, 4c:4c+4] (the last group has 6 columns: 8 idle threads).
//   Warps are independent (no block barrier), so a block is only a packing
//   of warps: 1 warp a block for few lanes (3 lanes fill 36 SMs), 4 for
//   many (384 lanes, 1152 blocks, in one wave at 9 blocks a SM).
// * The scalar chain by ballots, in every warp, 32 slots at a time: lane i
//   loads slot i's flags and cell id; the cell before slot i is that of
//   the last valid slot before it (a ballot of valid, a shuffle), which
//   gives restart; n before slot i counts the valid slots since the last
//   valid restart (a second ballot, a popc), or adds them to the carry.
//   No step waits on the one before.  The warp of column group 0 and port
//   0 writes qs, n_f and cell_f: one writer.
// * Slots in flight, DEPTH slots ahead in a register ring (a warp reads 4
//   whole rows of its port a slot: 128-byte runs).  In the four-warp
//   blocks (many lanes: bytes matter) DEPTH is 4 (36 warps a SM keep ~70
//   KB in flight, more than the memory needs), and with q known before the
//   LLRs arrive each thread loads its q-selected float4 of the valid slots
//   only.  In the one-warp blocks (few lanes: latency matters) DEPTH is 32,
//   a chunk's slots all in flight at once, and each thread loads its own
//   row h of every slot as the kernel starts, beside the flags, so no load
//   waits on another; four shuffles within the column's 4 threads then
//   hand thread h row q[h].
//
// The kernel allocates nothing and does not synchronise; contrib, acc0 and
// the outputs are float32, contiguous and 16-byte aligned (the wrapper
// checks).  Times are in PERF.md (section 6).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int ROW = 120;               // LLRs of one (port, phase) row
constexpr int ACC = 3 * 4 * ROW;       // 1440 floats a lane
constexpr int COLS = ROW / 4;          // 30 float4 columns a row
constexpr int WARP_COLS = 8;           // columns a warp: 8 x 4 phases
constexpr int PARTS = 3 * 4;           // warps a lane: 3 ports x 4 groups
constexpr int CHUNK = 32;              // slots whose scalars a warp holds
constexpr unsigned FULL = 0xffffffffu;

// the two launch shapes (ops/kernels/tti_chain.py: launch_plan)
constexpr int NARROW_WARPS = 1, NARROW_DEPTH = 32, NARROW_BLOCKS = 8;
constexpr int WIDE_WARPS = 4, WIDE_DEPTH = 4, WIDE_BLOCKS = 9;
#define NARROW NARROW_WARPS, NARROW_DEPTH, NARROW_BLOCKS, true
#define WIDE WIDE_WARPS, WIDE_DEPTH, WIDE_BLOCKS, false

__device__ __forceinline__ float4 add_rn(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// the highest set bit of a nonzero mask
__device__ __forceinline__ int highest(unsigned m) { return 31 - __clz(m); }

// (nk + h) mod 4 as torch.remainder takes it of an int32 sum that wraps:
// the low two bits of the two's-complement sum
__device__ __forceinline__ int q_of(unsigned nk, int h) {
  return static_cast<int>((nk + static_cast<unsigned>(h)) & 3u);
}

// float4 x of lane src (all 32 lanes take part)
__device__ __forceinline__ float4 shfl4(float4 x, int src) {
  return make_float4(__shfl_sync(FULL, x.x, src), __shfl_sync(FULL, x.y, src),
                     __shfl_sync(FULL, x.z, src), __shfl_sync(FULL, x.w, src));
}

// OWN_ROW: each thread loads row h of every slot and takes row q[h] from
// its column's thread q[h]; else it loads row q[h] of the valid slots.
template <int WARPS, int DEPTH, int MIN_BLOCKS, bool OWN_ROW>
__global__ void __launch_bounds__(32 * WARPS, MIN_BLOCKS)
    tti_chain_kernel(const float* __restrict__ acc0,
                     const int32_t* __restrict__ n0,
                     const int32_t* __restrict__ cell0,
                     const float* __restrict__ contrib,
                     const bool* __restrict__ fresh,
                     const int32_t* __restrict__ cell,
                     const bool* __restrict__ valid, int combine,
                     long long lanes, int K, float* __restrict__ accs,
                     int32_t* __restrict__ qs, float* __restrict__ acc_f,
                     int32_t* __restrict__ n_f,
                     int32_t* __restrict__ cell_f) {
  static_assert(CHUNK % DEPTH == 0, "the ring's slots index it statically");
  const long long warp =
      static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (warp >= lanes * PARTS) return;   // the whole warp
  const int ln = threadIdx.x & 31;
  const long long lane = warp / PARTS;
  const int part = static_cast<int>(warp % PARTS);
  const int col = (part % 4) * WARP_COLS + (ln >> 2), h = ln & 3;
  const bool holds = col < COLS;
  const bool writer = part == 0;       // writes qs, n_f, cell_f
  // this thread's float4 of row (port, r) is at base + r * ROW
  const int base = (part / 4) * 4 * ROW + 4 * col;
  const long long slot0 = lane * K;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 acc = zero;
  if (holds)
    acc = *reinterpret_cast<const float4*>(acc0 + lane * ACC + base
                                           + h * ROW);
  unsigned n = static_cast<unsigned>(n0[lane]);   // the carry, every lane
  int cur = cell0[lane];

  for (int k0 = 0; k0 < K; k0 += CHUNK) {
    const int kn = min(CHUNK, K - k0);
    const float* src = contrib + (slot0 + k0) * ACC + base;
    float4 ring[DEPTH];
    if (OWN_ROW) {                     // in flight beside the flags
#pragma unroll
      for (int i = 0; i < DEPTH; ++i) {
        ring[i] = zero;
        if (i < kn && holds)
          ring[i] = __ldg(reinterpret_cast<const float4*>(
              src + static_cast<long long>(i) * ACC + h * ROW));
      }
    }
    // ---- the chunk's scalars: lane i for slot k0 + i ----
    const long long si = slot0 + k0 + ln;
    int c = 0;
    bool v = false, f = false;
    if (ln < kn) {
      c = cell[si];
      v = valid[si];
      f = fresh[si];
    }
    const unsigned V = __ballot_sync(FULL, v);
    const unsigned before = V & ((1u << ln) - 1u);   // valid slots < i
    const int prev = __shfl_sync(FULL, c, before ? highest(before) : 0);
    const bool restart = !combine || f || c != (before ? prev : cur);
    const unsigned R = __ballot_sync(FULL, v && restart);
    const unsigned rb = R & ((1u << ln) - 1u);
    // n before slot i: the valid slots since the last valid restart (it
    // included), or the carry plus every valid slot before i
    const unsigned n_before =
        rb ? static_cast<unsigned>(
                 __popc(before & ~((1u << highest(rb)) - 1u)))
           : n + static_cast<unsigned>(__popc(before));
    const unsigned nk = restart ? 0u : n_before;
    if (writer && ln < kn)
      reinterpret_cast<int4*>(qs)[si] =
          make_int4(q_of(nk, 0), q_of(nk, 1), q_of(nk, 2), q_of(nk, 3));
    if (V) {                           // the carry out of the chunk
      const int last = highest(V);
      n = __shfl_sync(FULL, nk, last) + 1u;
      cur = __shfl_sync(FULL, c, last);
    }

    // ---- the LLRs: DEPTH slots in flight ----
    float* dst = accs + (slot0 + k0) * ACC + base + h * ROW;
    if (!OWN_ROW) {                    // row q[h] of the valid slots
#pragma unroll
      for (int i = 0; i < DEPTH; ++i) {
        ring[i] = zero;
        const unsigned nki = __shfl_sync(FULL, nk, i);
        if (i < kn && ((V >> i) & 1u) && holds)
          ring[i] = __ldg(reinterpret_cast<const float4*>(
              src + static_cast<long long>(i) * ACC + q_of(nki, h) * ROW));
      }
    }
    for (int g = 0; g < kn; g += DEPTH) {
#pragma unroll
      for (int i = 0; i < DEPTH; ++i) {
        const int j = g + i;
        if (j < kn) {                  // warp-uniform
          const unsigned nkj = __shfl_sync(FULL, nk, j);
          const float4 x =
              OWN_ROW ? shfl4(ring[i], (ln & ~3) | q_of(nkj, h)) : ring[i];
          const int jn = j + DEPTH;
          if (jn < kn) {
            const unsigned nkn = __shfl_sync(FULL, nk, jn);
            if ((OWN_ROW || ((V >> jn) & 1u)) && holds)
              ring[i] = __ldg(reinterpret_cast<const float4*>(
                  src + static_cast<long long>(jn) * ACC
                  + (OWN_ROW ? h : q_of(nkn, h)) * ROW));
          }
          if ((V >> j) & 1u) {
            if (q_of(nkj, h) == 0)
              acc = x;
            else
              acc = add_rn(((R >> j) & 1u) ? zero : acc, x);
          }
          if (holds)
            *reinterpret_cast<float4*>(dst + static_cast<long long>(j)
                                       * ACC) = acc;
        }
      }
    }
  }
  if (holds)
    *reinterpret_cast<float4*>(acc_f + lane * ACC + base + h * ROW) = acc;
  if (writer && ln == 0) {
    n_f[lane] = static_cast<int32_t>(n);
    cell_f[lane] = cur;
  }
}

template <int WARPS, int DEPTH, int MIN_BLOCKS, bool OWN_ROW>
int launch(const float* acc0, const int32_t* n0, const int32_t* cell0,
           const float* contrib, const bool* fresh, const int32_t* cell,
           const bool* valid, int combine, long long lanes, int K,
           float* accs, int32_t* qs, float* acc_f, int32_t* n_f,
           int32_t* cell_f, cudaStream_t stream) {
  const long long blocks = (lanes * PARTS + WARPS - 1) / WARPS;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  tti_chain_kernel<WARPS, DEPTH, MIN_BLOCKS, OWN_ROW>
      <<<static_cast<unsigned>(blocks), 32 * WARPS, 0, stream>>>(
          acc0, n0, cell0, contrib, fresh, cell, valid, combine, lanes, K,
          accs, qs, acc_f, n_f, cell_f);
  return static_cast<int>(cudaGetLastError());
}

template <int WARPS, int DEPTH, int MIN_BLOCKS, bool OWN_ROW>
int info(int* out) {
  const auto kernel = tti_chain_kernel<WARPS, DEPTH, MIN_BLOCKS, OWN_ROW>;
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel,
                                                      32 * WARPS, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(fa.sharedSizeBytes);
  out[3] = n;
  return 0;
}

}  // namespace

// Fold K slots for each of `lanes` lanes: acc0 [lanes, 1440] float32, n0 /
// cell0 [lanes] int32, contrib [lanes, K, 1440] float32, fresh / valid
// [lanes, K] bool, cell [lanes, K] int32; out accs [lanes, K, 1440], qs
// [lanes, K, 4] int32, acc_f [lanes, 1440], n_f / cell_f [lanes].  `wide`
// 0 launches one-warp blocks with 32 slots in flight, 1 four-warp blocks
// with 4.  Returns 0 or the cudaError of the launch.
extern "C" int tti_chain(const float* acc0, const int32_t* n0,
                         const int32_t* cell0, const float* contrib,
                         const bool* fresh, const int32_t* cell,
                         const bool* valid, int combine, long long lanes,
                         int K, int wide, float* accs, int32_t* qs,
                         float* acc_f, int32_t* n_f, int32_t* cell_f,
                         void* stream) {
  if (lanes <= 0) return 0;
  if (K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t ptrs =
      reinterpret_cast<uintptr_t>(acc0) | reinterpret_cast<uintptr_t>(contrib)
      | reinterpret_cast<uintptr_t>(accs) | reinterpret_cast<uintptr_t>(qs)
      | reinterpret_cast<uintptr_t>(acc_f);
  if (ptrs % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return wide ? launch<WIDE>(
                    acc0, n0, cell0, contrib, fresh, cell, valid, combine,
                    lanes, K, accs, qs, acc_f, n_f, cell_f, s)
              : launch<NARROW>(
                    acc0, n0, cell0, contrib, fresh, cell, valid, combine,
                    lanes, K, accs, qs, acc_f, n_f, cell_f, s);
}

// out[0..3] for the launch shape `wide` (0 or 1): registers a thread, local
// (spill) bytes a thread, static shared memory a block, blocks resident a
// SM.  Returns 0 or a cudaError.
extern "C" int tti_kernel_info(int* out, int wide) {
  return wide ? info<WIDE>(out) : info<NARROW>(out);
}

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
// so the kernel is bit for bit the plain version, -0.0 and all.
//
// Bound (C=128, K=16, the C=128 x 100 dispatch's decode; 384 lanes): each
// slot's 1440 LLRs are read once and the lane's 1440-float accumulator
// written once, 2 x 384 x 16 x 1440 x 4 B = 70.8 MB, 0.021 ms at 3.35 TB/s
// (H100 data sheet); 8.8 M adds are nothing beside it.  The slots of a lane
// are serial, so the kernel is bound by bytes only if the next slot's read
// is in flight while this one is folded in.  The design, one block of 384
// threads a lane:
//
// * The accumulator in registers.  The lane's [3, 4, 120] = 1440 floats
//   are 360 float4s, one a thread (threads 360-383 hold none); a float4 is
//   four elements of one (port, phase) row, so it reads one 16-byte run of
//   the q-selected quarter of `contrib` in place, in contrib's own layout
//   [.., K, 3, 4, 120], and writes one 16-byte run of accs[k].
// * One wave: __launch_bounds__(384, 3) caps registers at 56, so 3
//   blocks fit a SM and the C=128 dispatch's 384 lanes run at once.
// * The scalar chain off the data path.  restart, n_k and valid depend on
//   the carry (n, cell) alone, not on the LLRs: warp 0 loads up to 32
//   slots' flags and cell ids at once, thread 0 walks the chain over them
//   in shared memory (and writes n_f, cell_f), warp 0 writes their qs;
//   one block barrier, then every thread folds those slots with no further
//   barrier, the next slot's float4 loaded before this one's is used.
//
// The kernel allocates nothing and does not synchronise; contrib, acc0 and
// the outputs are float32, contiguous and 16-byte aligned (the wrapper
// checks).  Times are in PERF.md (section 6).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int ROW = 120;               // LLRs of one (port, phase) row
constexpr int ACC = 3 * 4 * ROW;       // 1440 floats a lane
constexpr int VEC = ACC / 4;           // 360 float4s
constexpr int THREADS = 384;           // 12 warps; 360 hold a float4
constexpr int MIN_BLOCKS = 3;          // a SM: 396 lanes in one wave
constexpr int CHUNK = 32;              // slots whose scalars thread 0 walks

__device__ __forceinline__ float4 add_rn(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// (nk + h) mod 4 as torch.remainder takes it of an int32 sum that wraps:
// the low two bits of the two's-complement sum
__device__ __forceinline__ int q_of(int nk, int h) {
  return static_cast<int>((static_cast<unsigned>(nk) + h) & 3u);
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    tti_chain_kernel(const float* __restrict__ acc0,
                     const int32_t* __restrict__ n0,
                     const int32_t* __restrict__ cell0,
                     const float* __restrict__ contrib,
                     const bool* __restrict__ fresh,
                     const int32_t* __restrict__ cell,
                     const bool* __restrict__ valid, int combine, int K,
                     float* __restrict__ accs, int32_t* __restrict__ qs,
                     float* __restrict__ acc_f, int32_t* __restrict__ n_f,
                     int32_t* __restrict__ cell_f) {
  __shared__ int s_nk[CHUNK], s_cell[CHUNK];
  __shared__ unsigned char s_flag[CHUNK];    // bit 0 valid, 1 fresh, 2 restart

  const long long lane = blockIdx.x;
  const int t = threadIdx.x;
  const bool holds = t < VEC;
  // the (port, phase) row and offset of this thread's float4
  const int ph = (4 * t) / ROW, off = (4 * t) % ROW;
  const int port = ph / 4, phase = ph % 4;
  const long long lane_slots = lane * K;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (holds) acc = reinterpret_cast<const float4*>(acc0 + lane * ACC)[t];
  int n = 0, cur = 0;                  // the carry, in thread 0
  if (t == 0) {
    n = n0[lane];
    cur = cell0[lane];
  }

  for (int k0 = 0; k0 < K; k0 += CHUNK) {
    const int kn = min(CHUNK, K - k0);
    if (t < 32) {                      // warp 0: the chunk's scalar chain
      const long long i = lane_slots + k0 + t;
      if (t < kn) {
        s_cell[t] = cell[i];
        s_flag[t] = static_cast<unsigned char>(valid[i] | (fresh[i] << 1));
      }
      __syncwarp();
      if (t == 0) {
        for (int j = 0; j < kn; ++j) {
          const int f = s_flag[j];
          const bool restart = !combine || (f & 2) || s_cell[j] != cur;
          const int nk = restart ? 0 : n;
          s_nk[j] = nk;
          s_flag[j] = static_cast<unsigned char>(f | (restart << 2));
          if (f & 1) {
            n = nk + 1;
            cur = s_cell[j];
          }
        }
        if (k0 + kn == K) {
          n_f[lane] = n;
          cell_f[lane] = cur;
        }
      }
      __syncwarp();
      if (t < kn) {
        const int nk = s_nk[t];
        reinterpret_cast<int4*>(qs)[i] = make_int4(
            q_of(nk, 0), q_of(nk, 1), q_of(nk, 2), q_of(nk, 3));
      }
    }
    __syncthreads();
    if (holds) {
      const float* base = contrib + (lane_slots + k0) * ACC + port * 4 * ROW
                          + off;
      float4 nxt = *reinterpret_cast<const float4*>(
          base + q_of(s_nk[0], phase) * ROW);
      for (int j = 0; j < kn; ++j) {
        const float4 sel = nxt;
        const int nk = s_nk[j];
        if (j + 1 < kn)
          nxt = *reinterpret_cast<const float4*>(
              base + static_cast<long long>(j + 1) * ACC
              + q_of(s_nk[j + 1], phase) * ROW);
        const int f = s_flag[j];
        if (f & 1) {
          if (q_of(nk, phase) == 0) {
            acc = sel;
          } else {
            const float4 from = (f & 4)
                                    ? make_float4(0.f, 0.f, 0.f, 0.f)
                                    : acc;
            acc = add_rn(from, sel);
          }
        }
        reinterpret_cast<float4*>(accs + (lane_slots + k0 + j) * ACC)[t] =
            acc;
      }
    }
    __syncthreads();                   // before warp 0 rewrites s_*
  }
  if (holds) reinterpret_cast<float4*>(acc_f + lane * ACC)[t] = acc;
}

}  // namespace

// Fold K slots for each of `lanes` lanes: acc0 [lanes, 1440] float32, n0 /
// cell0 [lanes] int32, contrib [lanes, K, 1440] float32, fresh / valid
// [lanes, K] bool, cell [lanes, K] int32; out accs [lanes, K, 1440], qs
// [lanes, K, 4] int32, acc_f [lanes, 1440], n_f / cell_f [lanes].  Returns
// 0 or the cudaError of the launch.
extern "C" int tti_chain(const float* acc0, const int32_t* n0,
                         const int32_t* cell0, const float* contrib,
                         const bool* fresh, const int32_t* cell,
                         const bool* valid, int combine, long long lanes,
                         int K, float* accs, int32_t* qs, float* acc_f,
                         int32_t* n_f, int32_t* cell_f, void* stream) {
  if (lanes <= 0) return 0;
  if (K <= 0 || lanes >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t ptrs =
      reinterpret_cast<uintptr_t>(acc0) | reinterpret_cast<uintptr_t>(contrib)
      | reinterpret_cast<uintptr_t>(accs) | reinterpret_cast<uintptr_t>(qs)
      | reinterpret_cast<uintptr_t>(acc_f);
  if (ptrs % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  tti_chain_kernel<<<static_cast<unsigned>(lanes), THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      acc0, n0, cell0, contrib, fresh, cell, valid, combine, K, accs, qs,
      acc_f, n_f, cell_f);
  return static_cast<int>(cudaGetLastError());
}

// out[0..3]: registers a thread, local (spill) bytes a thread, static
// shared memory a block, blocks resident a SM.  Returns 0 or a cudaError.
extern "C" int tti_kernel_info(int* out) {
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, tti_chain_kernel);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, tti_chain_kernel,
                                                      THREADS, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(fa.sharedSizeBytes);
  out[3] = n;
  return 0;
}

// Wrap-around tail-biting Viterbi decoder, K=7 rate 1/3, radix-4, for the
// 40-bit PBCH block (Hopper, sm_90a).
//
// Replaces the device loop of the JAX package's viterbi_decode_wa
// (ltetrigger_tpu/ops/viterbi.py:120, its three lax.scans at :168, :184 and
// :191).  Its plain PyTorch version is viterbi_decode_wa in
// ltetrigger_tpu_torch/ops/viterbi.py (60 serial steps of ~6 ops each);
// ops/kernels/viterbi.schedule_model is this kernel's schedule in PyTorch.
//
//   the 40 x 3 LLRs repeated 3x, two trellis stages a step (60 steps);
//   ACS: cand[ns, j] = m[4 (ns & 15) + j] + sum_c OB2[ns, j, c] r[c],
//     decision = first-occurrence argmax over j;
//   the best of the 64 final metrics (first occurrence), metric = max / 3;
//   the 40 bits are the input bits of steps 20-39 on the best path.
//
// Bound (73728 codewords, the C=128 x 100 dispatch's decode): a radix-4
// step needs 44 adds for its distinct branch metrics, 256 candidate adds
// and 3 compares a state, 492 float32 operations; 60 steps and the final
// argmax make 2.95e4 a codeword, 2.2e9 in all, 0.065 ms at 33.5 T
// operations/s (the data sheet's 67 TFLOP/s float32 counts an FMA as two;
// these are adds and compares).  The LLRs, bits and metric, 47 MB, take
// 0.014 ms at 3.35 TB/s.  The kernel is bound by the instructions it
// issues on the 60-step ACS chain; the design cuts them:
//
// * Branch metrics off the chain.  The 120 repeated LLRs make only 20
//   distinct steps.  Before the ACS loop the codeword's 16 lanes compute,
//   for each of those 20 steps, the 32 distinct sums up to sign into shared
//   memory (key 8 a + 2 b + sigma, see ops/kernels/viterbi.distinct_sums):
//   r0 + t1 r1 + t2 r2 + t3 r3 + t4 r4 + t5 r5 in symbol order, one
//   rounding an add (an FMA with a factor of +-1), the order the plain
//   version's product takes on the card, so the branch metrics are the same
//   floats as its.  In the loop a lane reads the 8 sums its butterfly uses
//   (two of each of four key pairs) and forms each candidate as one FMA
//   m + S0 (+-u), u one of the 8 and the sign fixed for the lane: 16 FMAs,
//   then 3 compares a state.  The lane's key pairs, pair orientation and
//   sign come in one 32-bit word per lane (VitLanes, built on the host by
//   ops/kernels/viterbi.lane_words), in the launch's parameter block, which
//   the card serves from its constant bank: no __constant__ symbol, no copy
//   that waits.
// * The radix-4 butterfly as the unit of work.  New states {q, q+16, q+32,
//   q+48} share the predecessors 4q..4q+3: lane q of a codeword owns that
//   group, so a codeword is 16 lanes and a warp decodes two.  A step reads
//   the 4 predecessor metrics as one 16-byte load from a double-buffered
//   [64] row, writes the 4 new ones, and ends on one __syncwarp.
// * Decisions, not survivor registers.  Steps 20-59 record each state's
//   2-bit decision by __ballot_sync: 8 ballot words a warp and step (4 a
//   codeword: states q + 16 k, the low and the high bit), stored by lane 0
//   as two 16-byte writes, 640 B a codeword.  After step 59 one lane a
//   codeword traces back once from the best final state: bits 2 (t - 20)
//   and 2 (t - 20) + 1 are bits 4 and 5 of the state after step t (the two
//   input bits it shifted in), and the predecessor is 4 (s & 15) + d.
//   Given the same decisions this returns the bits register exchange
//   returns; it replaces two 8-byte shared-memory moves a state and step.
//
// Resident on the card (NVIDIA H100 80GB HBM3; -Xptxas -v and
// cudaOccupancyMaxActiveBlocksPerMultiprocessor, printed by chip_smoke.py
// phase 3b through vit_kernel_info): 4 warps a block, 29696 B of static
// shared memory (a warp: sums 2 x 20 x 32 floats, metrics 2 x 2 x 64
// floats, decisions 40 x 8 words, which first hold the LLRs), 55 registers
// a thread and no spill under __launch_bounds__(128, 7): 7 blocks (28
// warps, 56 codewords) a SM; 73728 codewords are 9216 blocks, 10 waves
// over 132 SMs.  Times are in PERF.md (section 6).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int N_STATES = 64;
constexpr int N_LLR = 120;           // 40 symbols x 3
constexpr int DISTINCT = 20;         // distinct radix-4 steps
constexpr int KEYS = 32;             // distinct sums a step, up to sign
constexpr int REC = 40;              // steps 20-59 record decisions
constexpr int LANES = 16;            // a codeword's lanes
constexpr int WARPS = 4;
constexpr int MIN_BLOCKS = 7;
constexpr unsigned FULL = 0xffffffffu;

}  // namespace

// bits 4p..4p+3: key pair P[p] of slot p = 2 (k & 1) + (j >> 1); bit
// 16 + p: the element of that pair used where (j & 1) ^ (k >> 1) is 0;
// bit 20: the lane's sign S0 is -1
struct VitLanes {
  uint32_t lane[LANES];
};

namespace {

// one warp's shared memory: two codewords
struct WarpSmem {
  float tab[2][DISTINCT][KEYS];      // distinct sums
  float m[2][2][N_STATES];           // [codeword][buffer][state]
  uint32_t dec[REC][8];              // ballots; first the 240 LLRs
};

// One radix-4 step of lane q: predecessor metrics 4q..4q+3 from `mcur`,
// the new metrics of states q + 16 k into `mnxt` and `fin`; with RECORD
// the 8 ballot words of the warp's decisions into `dec_row`.
template <bool RECORD>
__device__ __forceinline__ void acs_step(const float* row,
                                         const int (&off_e)[4],
                                         const int (&off_n)[4], float s0,
                                         const float* mcur, float* mnxt,
                                         int q, int lane, uint32_t* dec_row,
                                         float (&fin)[4]) {
  const float4 m4 = *reinterpret_cast<const float4*>(mcur + 4 * q);
  const float mv[4] = {m4.x, m4.y, m4.z, m4.w};
  float ve[4], vn[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    ve[p] = row[off_e[p]];
    vn[p] = row[off_n[p]];
  }
  uint32_t lo[4], hi[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float c[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = 2 * (k & 1) + (j >> 1);
      const float u = ((j & 1) ^ (k >> 1)) ? vn[p] : ve[p];
      // the branch's sign: S0, times -1 for odd k, times (+, -, -, +)[j]
      const bool neg = ((k & 1) != 0) != (j == 1 || j == 2);
      c[j] = __fmaf_rn(s0, neg ? -u : u, mv[j]);
    }
    float best;
    if (RECORD) {          // first-occurrence argmax as a tournament
      const bool p01 = c[1] > c[0];
      const float v01 = p01 ? c[1] : c[0];
      const bool p23 = c[3] > c[2];
      const float v23 = p23 ? c[3] : c[2];
      const bool up = v23 > v01;
      best = up ? v23 : v01;
      hi[k] = __ballot_sync(FULL, up);
      lo[k] = __ballot_sync(FULL, up ? p23 : p01);
    } else {
      best = fmaxf(fmaxf(c[0], c[1]), fmaxf(c[2], c[3]));
    }
    mnxt[q + 16 * k] = best;
    fin[k] = best;
  }
  if (RECORD && lane == 0) {
    uint4* d = reinterpret_cast<uint4*>(dec_row);
    d[0] = make_uint4(lo[0], hi[0], lo[1], hi[1]);
    d[1] = make_uint4(lo[2], hi[2], lo[3], hi[3]);
  }
  __syncwarp();
}

__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS)
    vit_wa_kernel(const float* __restrict__ llr, long long B,
                  const VitLanes lanes, int32_t* __restrict__ bits,
                  float* __restrict__ metric) {
  __shared__ __align__(16) WarpSmem sm[WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = lane >> 4, q = lane & (LANES - 1);
  const long long cw0 = (static_cast<long long>(blockIdx.x) * WARPS + warp) * 2;
  if (cw0 >= B) return;             // whole warps only: no block barrier
  const long long cw = cw0 + h;
  WarpSmem& s = sm[warp];

  // the two codewords' LLRs (zeros for a missing second one)
  float* x = reinterpret_cast<float*>(&s.dec[0][0]);
  const long long n = (B - cw0 >= 2 ? 2 : 1) * static_cast<long long>(N_LLR);
  const float* src = llr + cw0 * N_LLR;
  for (int i = lane; i < 2 * N_LLR; i += 32) x[i] = i < n ? src[i] : 0.0f;
  __syncwarp();

  // the distinct sums: lane q computes keys q and q + 16 of every step
  const float* xr = x + h * N_LLR;
  for (int tau = 0; tau < DISTINCT; ++tau) {
    float r[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) r[c] = xr[6 * tau + c];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int key = q + 16 * u;
      const float t3 = (key & 1) ? -1.0f : 1.0f;
      float acc = __fmaf_rn((key & 16) ? -1.0f : 1.0f, r[1], r[0]);
      acc = __fmaf_rn((key & 8) ? -1.0f : 1.0f, r[2], acc);
      acc = __fmaf_rn(t3, r[3], acc);
      acc = __fmaf_rn((key & 4) ? -t3 : t3, r[4], acc);
      acc = __fmaf_rn((key & 2) ? -t3 : t3, r[5], acc);
      s.tab[h][tau][key] = acc;
    }
  }

  // the lane's butterfly: states q + 16 k, predecessors 4 q + j
  const uint32_t w = lanes.lane[q];
  const float s0 = ((w >> 20) & 1) ? -1.0f : 1.0f;
  int off_e[4], off_n[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int pair = (w >> (4 * p)) & 15, e = (w >> (16 + p)) & 1;
    off_e[p] = 2 * pair + e;
    off_n[p] = 2 * pair + (e ^ 1);
  }
  float* m0 = s.m[h][0];
  float* m1 = s.m[h][1];
#pragma unroll
  for (int k = 0; k < 4; ++k) m0[q + 16 * k] = 0.0f;
  __syncwarp();

  float fin[4];
  const float* tab = &s.tab[h][0][0];
  for (int t = 0; t < DISTINCT; t += 2) {          // steps 0-19
    acs_step<false>(tab + t * KEYS, off_e, off_n, s0, m0, m1, q, lane,
                    nullptr, fin);
    acs_step<false>(tab + (t + 1) * KEYS, off_e, off_n, s0, m1, m0, q, lane,
                    nullptr, fin);
  }
  for (int t = 0; t < REC; t += 2) {               // steps 20-59
    const int tau = t % DISTINCT;
    acs_step<true>(tab + tau * KEYS, off_e, off_n, s0, m0, m1, q, lane,
                   s.dec[t], fin);
    acs_step<true>(tab + (tau + 1) * KEYS, off_e, off_n, s0, m1, m0, q, lane,
                   s.dec[t + 1], fin);
  }

  // the best final state, first occurrence over the state index
  float v = fin[0];
  int st = q;
#pragma unroll
  for (int k = 1; k < 4; ++k)
    if (fin[k] > v) {
      v = fin[k];
      st = q + 16 * k;
    }
#pragma unroll
  for (int off = LANES / 2; off; off >>= 1) {
    const float ov = __shfl_xor_sync(FULL, v, off);
    const int os = __shfl_xor_sync(FULL, st, off);
    if (ov > v || (ov == v && os < st)) {
      v = ov;
      st = os;
    }
  }

  // traceback from step 59 to step 20; bits of steps 20-39
  uint32_t lo = 0, hi = 0;
  if (q == 0) {
    int sx = st;
    const int shift = LANES * h;
    for (int t = REC - 1; t >= 0; --t) {           // step 20 + t
      if (t < DISTINCT) {
        const uint32_t two = ((sx >> 4) & 1) | (((sx >> 5) & 1) << 1);
        if (t < 16) lo |= two << (2 * t);
        else hi |= two << (2 * t - 32);
      }
      if (t == 0) break;
      const int k = sx >> 4, qq = sx & (LANES - 1);
      const uint32_t dlo = s.dec[t][2 * k], dhi = s.dec[t][2 * k + 1];
      const int d = static_cast<int>((((dhi >> (qq + shift)) & 1u) << 1) |
                                     ((dlo >> (qq + shift)) & 1u));
      sx = 4 * qq + d;
    }
  }
  lo = __shfl_sync(FULL, lo, LANES * h);
  hi = __shfl_sync(FULL, hi, LANES * h);
  if (cw < B) {
    int32_t* out = bits + cw * 40;
    out[q] = static_cast<int32_t>((lo >> q) & 1u);
    out[q + 16] = static_cast<int32_t>((lo >> (q + 16)) & 1u);
    if (q < 8) out[q + 32] = static_cast<int32_t>((hi >> q) & 1u);
    if (q == 0) metric[cw] = __fdiv_rn(v, 3.0f);
  }
}

// ask for the largest shared-memory carveout once per device, so that
// MIN_BLOCKS blocks fit beside L1
cudaError_t prefer_shared() {
  static int done_for = -1;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || done_for == dev) return e;
  e = cudaFuncSetAttribute(vit_wa_kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           static_cast<int>(cudaSharedmemCarveoutMaxShared));
  if (e == cudaSuccess) done_for = dev;
  return e;
}

}  // namespace

// Decode B codewords (llr [B, 40, 3] float32, contiguous) into bits
// [B, 40] int32 and metric [B] float32 on `stream`.  Returns 0 or the
// cudaError of the launch.
extern "C" int vit_decode_wa(const float* llr, long long B,
                             const VitLanes* lanes, int32_t* bits,
                             float* metric, void* stream) {
  if (B <= 0) return 0;
  const long long per_block = 2LL * WARPS;
  const long long blocks = (B + per_block - 1) / per_block;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = prefer_shared();
  if (e != cudaSuccess) return static_cast<int>(e);
  vit_wa_kernel<<<static_cast<unsigned>(blocks), WARPS * 32, 0,
                  static_cast<cudaStream_t>(stream)>>>(llr, B, *lanes, bits,
                                                       metric);
  return static_cast<int>(cudaGetLastError());
}

// out[0..3]: registers a thread, local (spill) bytes a thread, static
// shared memory a block, blocks resident a SM.  Returns 0 or a cudaError.
extern "C" int vit_kernel_info(int* out) {
  cudaError_t e = prefer_shared();
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, vit_wa_kernel);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, vit_wa_kernel,
                                                      WARPS * 32, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(fa.sharedSizeBytes);
  out[3] = n;
  return 0;
}

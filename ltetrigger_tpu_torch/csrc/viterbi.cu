// Wrap-around tail-biting Viterbi decoder, K=7 rate 1/3, radix-4, for the
// 40-bit PBCH block (Hopper, sm_90a).
//
// Replaces the device loop of the JAX package's viterbi_decode_wa
// (ltetrigger_tpu/ops/viterbi.py:120, its three lax.scans at :168, :184 and
// :191).  Its plain PyTorch version is viterbi_decode_wa in
// ltetrigger_tpu_torch/ops/viterbi.py (60 serial steps of ~6 ops each);
// this kernel computes what that code computes, step for step:
//
//   the 40 x 3 LLRs repeated 3x, two trellis stages a step (60 steps);
//   ACS: cand[ns, j] = m[4 (ns & 15) + j] + sum_c OB2[ns, j, c] r[c], the
//     sum taken in c order 0..5, decision = first-occurrence argmax over j;
//   steps 0-19 ACS only, 20-39 also record 2 survivor bits a step into an
//     int64 register per state, 40-59 register exchange only;
//   the best of the 64 final metrics (first occurrence), metric = max / 3,
//   bit i = bit 39 - i of the best state's register.
//
// One warp per codeword; lane l owns states l and l + 32, which share the
// predecessors 4 (l & 15) + j.  The warp keeps its codeword's 120 LLRs, the
// 64 path metrics and the 64 survivor registers in shared memory (double-
// buffered, one __syncwarp a step: 2 KB a warp).  The radix-4 tables ride
// in the launch's parameter block, which the card serves from its constant
// bank: one 32-bit word per state, OB2's 24 signs (OB2 is +-1, so each
// product is exact and the sum depends only on its order) and BITS2's four
// 2-bit symbols, built on the host from ops/viterbi._radix4_tables; each
// lane moves its two words to registers once.
//
// Bound (73728 codewords, the C=128 x 100 dispatch's decode): a radix-4
// step needs 44 adds for its distinct branch metrics (6 for each stage's
// four sums up to sign, one for each of the 32 two-stage sums up to sign),
// 256 candidate adds and 3 compares a state, 492 float32 operations; 60
// steps and the final argmax make 2.95e4 a codeword, 2.2e9 in all, 0.065 ms
// at 33.5 T operations/s (the data sheet's 67 TFLOP/s float32 counts an FMA
// as two; these are adds and compares).  The LLRs, bits and metric, 47 MB,
// take 0.014 ms at 3.35 TB/s.  This kernel spends 48 adds and 6 compares a
// lane and step, 1728 a codeword and step, 3.5x what the decode needs,
// besides the sign selects, shifts and survivor traffic: it does not aim
// at the bound, it is the first kernel that is right.
//
// Predicted and measured times are in PERF.md (section 6).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int N_STATES = 64;
constexpr int N_LLR = 120;           // 40 symbols x 3
constexpr int STEPS = 60;
constexpr int WARPS = 8;
constexpr unsigned FULL = 0xffffffffu;

}  // namespace

// bits 0..23: sign of OB2[ns, j, c] at bit 6 j + c (1 = -1);
// bits 24..31: BITS2[ns, j] at bits 24 + 2 j
struct VitTables {
  uint32_t state[N_STATES];
};

namespace {

__device__ __forceinline__ float branch(uint32_t word, int j,
                                        const float (&r)[6]) {
  float acc = 0.0f;
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    const float x = (word >> (6 * j + c)) & 1u ? -r[c] : r[c];
    acc = c == 0 ? x : __fadd_rn(acc, x);
  }
  return acc;
}

// first-occurrence argmax of the four candidates of state `word`
__device__ __forceinline__ void acs(uint32_t word, const float (&mv)[4],
                                    const float (&r)[6], float& best,
                                    int& dec) {
  best = __fadd_rn(mv[0], branch(word, 0, r));
  dec = 0;
#pragma unroll
  for (int j = 1; j < 4; ++j) {
    const float cand = __fadd_rn(mv[j], branch(word, j, r));
    if (cand > best) {
      best = cand;
      dec = j;
    }
  }
}

__global__ void __launch_bounds__(WARPS * 32)
    vit_wa_kernel(const float* __restrict__ llr, long long B,
                  const VitTables tab, int32_t* __restrict__ bits,
                  float* __restrict__ metric) {
  __shared__ float s_llr[WARPS][N_LLR];
  __shared__ float s_m[WARPS][2][N_STATES];
  __shared__ long long s_reg[WARPS][2][N_STATES];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long cw = static_cast<long long>(blockIdx.x) * WARPS + warp;
  if (cw >= B) return;              // whole warps only: no block barrier

  const float* x = llr + cw * N_LLR;
  for (int i = lane; i < N_LLR; i += 32) s_llr[warp][i] = x[i];
  const uint32_t w0 = tab.state[lane], w1 = tab.state[lane + 32];
  const int k4 = 4 * (lane & 15);
  for (int i = lane; i < N_STATES; i += 32) {
    s_m[warp][0][i] = 0.0f;
    s_reg[warp][0][i] = 0;
    s_reg[warp][1][i] = 0;
  }
  __syncwarp();

  float m0 = 0.0f, m1 = 0.0f;
  int cur = 0;
  for (int t = 0; t < STEPS; ++t) {
    float r[6], mv[4];
    const float* rt = &s_llr[warp][(6 * t) % N_LLR];
#pragma unroll
    for (int c = 0; c < 6; ++c) r[c] = rt[c];
#pragma unroll
    for (int j = 0; j < 4; ++j) mv[j] = s_m[warp][cur][k4 + j];
    int d0, d1;
    acs(w0, mv, r, m0, d0);
    acs(w1, mv, r, m1, d1);
    const int nxt = cur ^ 1;
    if (t >= 20) {                  // phases 2 and 3: register exchange
      long long r0 = s_reg[warp][cur][k4 + d0];
      long long r1 = s_reg[warp][cur][k4 + d1];
      if (t < 40) {                 // phase 2: record two bits
        r0 = (r0 << 2) | ((w0 >> (24 + 2 * d0)) & 3u);
        r1 = (r1 << 2) | ((w1 >> (24 + 2 * d1)) & 3u);
      }
      s_reg[warp][nxt][lane] = r0;
      s_reg[warp][nxt][lane + 32] = r1;
    }
    s_m[warp][nxt][lane] = m0;
    s_m[warp][nxt][lane + 32] = m1;
    __syncwarp();
    cur = nxt;
  }

  // the best final state, first occurrence over the state index
  float v = m0;
  int s = lane;
  if (m1 > m0) {
    v = m1;
    s = lane + 32;
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    const float ov = __shfl_xor_sync(FULL, v, off);
    const int os = __shfl_xor_sync(FULL, s, off);
    if (ov > v || (ov == v && os < s)) {
      v = ov;
      s = os;
    }
  }
  const long long word = s_reg[warp][cur][s];
  bits[cw * 40 + lane] = static_cast<int32_t>((word >> (39 - lane)) & 1);
  if (lane < 8)
    bits[cw * 40 + 32 + lane] = static_cast<int32_t>((word >> (7 - lane)) & 1);
  if (lane == 0) metric[cw] = __fdiv_rn(v, 3.0f);
}

}  // namespace

// Decode B codewords (llr [B, 40, 3] float32, contiguous) into bits
// [B, 40] int32 and metric [B] float32 on `stream`.  Returns 0 or the
// cudaError of the launch.
extern "C" int vit_decode_wa(const float* llr, long long B,
                             const VitTables* tables, int32_t* bits,
                             float* metric, void* stream) {
  if (B <= 0) return 0;
  const long long blocks = (B + WARPS - 1) / WARPS;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  vit_wa_kernel<<<static_cast<unsigned>(blocks), WARPS * 32, 0,
                  static_cast<cudaStream_t>(stream)>>>(llr, B, *tables, bits,
                                                       metric);
  return static_cast<int>(cudaGetLastError());
}

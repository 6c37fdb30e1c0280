// Pass C's front end in two launches around the CFO-ring kernel (Hopper,
// sm_90a): each lane-step's slot-0 read, CFO estimate, rotation, CP and
// SSS decision, the lanes' MIB capture selection and the PSS channel
// estimate, in place of a chain of ~400 small PyTorch ops a dispatch.
//
// Replaces no Pallas kernel: the JAX package's `_mib_postpass` is jnp
// (ltetrigger_tpu/models/trigger.py).  Its plain PyTorch version is
// front_plain in ltetrigger_tpu_torch/ops/kernels/pass_c_front.py, the
// chain pass C ran before these kernels.  For lane l = (channel b, root r)
// and step t, with st0 = grid[t] + peak[t, l] - 832 the slot-0 start and
// x the buffer zero outside [0, N):
//
//   front_estimate:  est[t, l] = angle(conj(y0) y1) / pi, y0 / y1 the
//       correlations of x[st0 + 832 + n], n < 64 / n >= 64, with root r's
//       time replica; push[t, l] = emit & tracking.
//   (the CFO-ring kernel, csrc/cfo_ring.cu: the ring means mean[t, l])
//   front_decide:  freq = tracking ? -mean / 128 : 0; the slot-0 tail
//       x[st0 + 448 + n], n < 512, rotated by exp(j 2 pi freq (448 + n));
//       normal CP when the normalised CP correlation over the two symbols
//       before the PSS scores at least as high at 9 samples as at 32; the
//       SSS symbol at that CP through the 62 sync rows of the DFT,
//       descrambled, m0 and m1 by the 3-section non-coherent correlation
//       against the 31 cyclic shifts (first maximum), N_id_1 and subframe
//       5 from the (m0, m1) table; then, lane by lane over the steps, the
//       capture chain (published gate, eligibility, slots under K,
//       overflow, fresh, pending_fresh) and the candidates in their
//       slots; the LS channel estimate of the last pushed step's rotated
//       PSS, or the carried one.
//
// Integers and flags are the plain version's wherever its decisions (the
// two CP scores, an SSS argmax) do not lie within float32 rounding of a
// tie: the sums run in another order here.
//
// Bound (scan512: 512 channels x 3 roots x 200 steps, 307 200 lane-steps):
// each lane-step reads its 512-sample slot-0 tail once (4 KB, 1.26 GB in
// all, 0.38 ms at 3.35 TB/s), and its arithmetic is the 62 x 128 complex
// DFT (31 744 FMA), the rotation (512 sincos) and ~6 000 FMA of CP and
// SSS: ~1.2e10 FMA, 0.36 ms at 33.5 T FFMA/s (H100 data sheet).  The
// design:
//
// * front_estimate: a warp a lane-step, 8 a block; lane j reads samples
//   j, j + 32, j + 64, j + 96 of the PSS symbol (coalesced) against the
//   replica, five shuffles a sum.  Its push flags feed the ring kernel
//   without another op.
// * front_decide: a block of 8 warps a lane, steps in tiles of 32, each
//   warp 4 steps of a tile.  A warp's step: the 512-sample tail read
//   coalesced, rotated (sincosf) into a 4-KB buffer of its own in shared
//   memory; the CP scores by shuffles; the DFT with lane j on bins j and
//   j + 32, the samples broadcast and the table read as [128][64] pairs,
//   conflict free; the 31 shifts on lanes 0-30, the argmax by shuffles.
//   The block stages the DFT and SSS tables (75 KB) once.  Warp 0 then
//   takes the tile's capture chain in 32 lanes at once, by ballots (the
//   losses, the eligible steps, the captures: a prefix count, the last
//   capture and loss before each step), while the other warps work on the
//   next tile (two buffers of the tile's decisions, one barrier a tile),
//   and writes each captured step into its slot.  Slots past the count are
//   zeroed by the whole block.
//
// The kernels allocate nothing and do not synchronise.  Times are in
// PERF.md (section 6).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int R = 3;            // N_id_2 hypotheses (lanes are [.., 3])
constexpr int SYM = 128;        // OFDM symbol
constexpr int SEG = 512;        // slot-0 tail a step
constexpr int SEG_OFF = 448;    // its offset in the slot
constexpr int LOOKBACK = 832;   // PSS start in the slot
constexpr int SLOT = 960;
constexpr int NB = 62;          // sync subcarriers
constexpr int PITCH = 64;       // bins a row of the DFT table
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int TILE = 32;        // steps a tile
constexpr int EST_WARPS = 8;    // front_estimate: lane-steps a block
constexpr int CP_NORM = 9, CP_EXT = 32;
constexpr unsigned FULL = 0xffffffffu;

// tables() of pass_c_front.py, in floats: the part staged in shared memory
// first, then the replicas read from device memory
constexpr int T_DFT = 0;                     // [128][64] (re, im)
constexpr int T_CSCR = SYM * PITCH * 2;      // [3][2][31]
constexpr int T_Z = T_CSCR + R * 2 * 31;     // [8][31]
constexpr int T_BANK = T_Z + 8 * 31;         // [31][31] shift bank S[m][k]
constexpr int T_NID1 = T_BANK + 31 * 31;     // [31][31] N_id_1 or -1
constexpr int T_SHARED = T_NID1 + 31 * 31;
constexpr int T_FRE = T_SHARED;              // [3][62] freq replicas, re
constexpr int T_FIM = T_FRE + R * NB;        // im
constexpr int T_TRE = T_FIM + R * NB;        // [3][128] time replicas, re
constexpr int T_TIM = T_TRE + R * SYM;       // im
static_assert(T_SHARED % 4 == 0, "float4 staging");

// front_decide's dynamic shared memory, in bytes
constexpr int S_TAB = 0;
constexpr int S_SEG = S_TAB + 4 * T_SHARED;          // [WARPS][512] float2
constexpr int S_CELL = S_SEG + WARPS * SEG * 8;      // [2][TILE] int
constexpr int S_FREQ = S_CELL + 2 * TILE * 4;        // [2][TILE] float
constexpr int S_FLAG = S_FREQ + 2 * TILE * 4;        // [2][TILE] int
constexpr int S_SCAL = S_FLAG + 2 * TILE * 4;        // cnt, last push
constexpr int SMEM = S_SCAL + 16;
static_assert(S_SEG % 16 == 0, "aligned buffers");

constexpr float TWO_PI = 6.28318530717958647692f;
constexpr float PI = 3.14159265358979323846f;

// flags of a step's decision in the tile buffer
constexpr int F_SSS = 1, F_SUB5 = 2, F_NCP = 4;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ int highest(unsigned m) { return 31 - __clz(m); }

__device__ __forceinline__ float2 rd(const float* re, const float* im,
                                     long long n, long long p) {
  return (p >= 0 && p < n) ? make_float2(re[p], im[p])
                           : make_float2(0.f, 0.f);
}

// x * exp(j theta), theta = w * m, as the plain version's separate ops
__device__ __forceinline__ float2 rotate(float2 x, float w, int m) {
  float s, c;
  sincosf(__fmul_rn(w, static_cast<float>(m)), &s, &c);
  return make_float2(__fsub_rn(__fmul_rn(x.x, c), __fmul_rn(x.y, s)),
                     __fadd_rn(__fmul_rn(x.x, s), __fmul_rn(x.y, c)));
}

__global__ void __launch_bounds__(32 * EST_WARPS)
    front_estimate_kernel(const float* __restrict__ re,
                          const float* __restrict__ im,
                          const int32_t* __restrict__ grid,
                          const int32_t* __restrict__ peak,
                          const bool* __restrict__ emit,
                          const bool* __restrict__ tracking,
                          const float* __restrict__ tab, long long N,
                          long long L, int S, float* __restrict__ est,
                          bool* __restrict__ push) {
  const long long item =
      static_cast<long long>(blockIdx.x) * EST_WARPS + (threadIdx.x >> 5);
  const int ln = threadIdx.x & 31;
  if (item >= static_cast<long long>(S) * L) return;   // a whole warp
  const int t = static_cast<int>(item / L);
  const long long l = item - static_cast<long long>(t) * L;
  const int r = static_cast<int>(l % R);
  const float* xr = re + (l / R) * N;
  const float* xi = im + (l / R) * N;
  const long long pos =
      static_cast<long long>(grid[t]) + peak[item] - LOOKBACK + SEG_OFF +
      SEG - SYM;
  // y_h = sum x[n] conj(rep[n]) over half h of the symbol
  float a[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int n = ln + 32 * q, h = q >> 1;
    const float2 x = rd(xr, xi, N, pos + n);
    const float br = tab[T_TRE + r * SYM + n], bi = tab[T_TIM + r * SYM + n];
    a[h][0] += __fadd_rn(__fmul_rn(x.x, br), __fmul_rn(x.y, bi));
    a[h][1] += __fsub_rn(__fmul_rn(x.y, br), __fmul_rn(x.x, bi));
  }
  const float y0r = warp_sum(a[0][0]), y0i = warp_sum(a[0][1]);
  const float y1r = warp_sum(a[1][0]), y1i = warp_sum(a[1][1]);
  if (ln == 0) {
    // conj(y0) * y1
    const float pr = __fadd_rn(__fmul_rn(y0r, y1r), __fmul_rn(y0i, y1i));
    const float pi = __fsub_rn(__fmul_rn(y0r, y1i), __fmul_rn(y0i, y1r));
    est[item] = __fdiv_rn(atan2f(pi, pr), PI);
    push[item] = emit[item] && tracking[item];
  }
}

struct DecideArgs {
  const float *re, *im;
  const int32_t *grid, *peak;
  const bool *emit, *tracking, *lost;
  const float* mean;
  const bool* published;
  const int32_t* mib_cell;
  const bool* pf0;
  const float *chest0, *tab;
  long long N, L, data_valid;
  int S, K;
  float *freq, *chest;
  bool* normal_cp;
  int32_t* cell_id;
  bool* want_cap;
  long long *at, *cnt;
  bool* pf_f;
  int32_t *overflow, *cand_cell;
  bool *cand_cp, *cand_fresh;
  long long* cand_start;
  float* cand_freq;
  bool* valid;
};

// One CP hypothesis' score over the two symbols before the PSS (the
// rotated tail `sf`, its index 512 the slot's end): |sum c conj(t)| over
// 0.5 (|c|^2 + |t|^2) summed, c the cyclic prefix, t the symbol's end.
template <int CP>
__device__ __forceinline__ float cp_score(const float2* sf, int ln) {
  float nr = 0.f, ni = 0.f, den = 1e-30f;
  int pos = SEG - SYM;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    pos -= SYM + CP;
    float dr = 0.f, di = 0.f, ec = 0.f, et = 0.f;
    if (ln < CP) {
      const float2 c = sf[pos - CP + ln], u = sf[pos + SYM - CP + ln];
      dr = __fadd_rn(__fmul_rn(c.x, u.x), __fmul_rn(c.y, u.y));
      di = __fsub_rn(__fmul_rn(c.y, u.x), __fmul_rn(c.x, u.y));
      ec = __fadd_rn(__fmul_rn(c.x, c.x), __fmul_rn(c.y, c.y));
      et = __fadd_rn(__fmul_rn(u.x, u.x), __fmul_rn(u.y, u.y));
    }
    nr += warp_sum(dr);
    ni += warp_sum(di);
    den = __fadd_rn(den, __fmul_rn(0.5f, __fadd_rn(warp_sum(ec),
                                                   warp_sum(et))));
  }
  return __fdiv_rn(sqrtf(__fadd_rn(__fmul_rn(nr, nr), __fmul_rn(ni, ni))),
                   den);
}

// Bins j and j + 32 of the 62 sync rows of the DFT of x[0, 128) (lane j;
// x broadcast from shared memory, the table [128][64] pairs)
__device__ __forceinline__ void dft62(const float2* x, const float2* w,
                                      int ln, float2& y0, float2& y1) {
  float rr0 = 0.f, ii0 = 0.f, ri0 = 0.f, ir0 = 0.f;
  float rr1 = 0.f, ii1 = 0.f, ri1 = 0.f, ir1 = 0.f;
#pragma unroll 8
  for (int n = 0; n < SYM; ++n) {
    const float2 v = x[n], w0 = w[n * PITCH + ln], w1 = w[n * PITCH + ln + 32];
    rr0 = fmaf(w0.x, v.x, rr0);
    ii0 = fmaf(w0.y, v.y, ii0);
    ri0 = fmaf(w0.x, v.y, ri0);
    ir0 = fmaf(w0.y, v.x, ir0);
    rr1 = fmaf(w1.x, v.x, rr1);
    ii1 = fmaf(w1.y, v.y, ii1);
    ri1 = fmaf(w1.x, v.y, ri1);
    ir1 = fmaf(w1.y, v.x, ir1);
  }
  y0 = make_float2(__fsub_rn(rr0, ii0), __fadd_rn(ri0, ir0));
  y1 = make_float2(__fsub_rn(rr1, ii1), __fadd_rn(ri1, ir1));
}

// The shift m (lane m < 31) whose 3-section non-coherent correlation with
// y[0, 31) is largest; the first on a tie.  The same in every lane.
__device__ __forceinline__ int sss_argmax(const float2* y, const float* bank,
                                          int ln) {
  float v = -1.f;
  if (ln < 31) {
    float p[3];
#pragma unroll
    for (int s = 0; s < 3; ++s) {    // sections [0, 10), [10, 20), [20, 31)
      float cr = 0.f, ci = 0.f;
      for (int k = 10 * s; k < (s == 2 ? 31 : 10 * s + 10); ++k) {
        const float b = bank[ln * 31 + k];
        cr = fmaf(y[k].x, b, cr);
        ci = fmaf(y[k].y, b, ci);
      }
      p[s] = __fadd_rn(__fmul_rn(cr, cr), __fmul_rn(ci, ci));
    }
    v = __fadd_rn(__fadd_rn(p[0], p[1]), p[2]);
  }
  int idx = ln;
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const float ov = __shfl_xor_sync(FULL, v, o);
    const int oi = __shfl_xor_sync(FULL, idx, o);
    if (ov > v || (ov == v && oi < idx)) {
      v = ov;
      idx = oi;
    }
  }
  return idx;
}

// One lane-step (a whole warp): its rotation, CP, SSS and cell id, written
// to the step outputs and to slot u of the tile buffers.
__device__ __forceinline__ void decide_step(const DecideArgs& a,
                                            const float* tab, float2* sf,
                                            long long l, int r, int t, int ln,
                                            int* tcell, float* tfreq,
                                            int* tflag, int u) {
  const long long i = static_cast<long long>(t) * a.L + l;
  const float f = a.tracking[i] ? __fdiv_rn(-a.mean[i], 128.f) : 0.f;
  const float w = __fmul_rn(TWO_PI, f);
  const float* xr = a.re + (l / R) * a.N;
  const float* xi = a.im + (l / R) * a.N;
  const long long base =
      static_cast<long long>(a.grid[t]) + a.peak[i] - LOOKBACK + SEG_OFF;
  __syncwarp();                        // the warp's last step read sf
#pragma unroll 4
  for (int q = 0; q < SEG / 32; ++q) {
    const int n = ln + 32 * q;
    sf[n] = rotate(rd(xr, xi, a.N, base + n), w, SEG_OFF + n);
  }
  __syncwarp();
  const bool ncp = cp_score<CP_NORM>(sf, ln) >= cp_score<CP_EXT>(sf, ln);
  const int sss = SEG - 2 * SYM - (ncp ? CP_NORM : CP_EXT);
  float2 y0, y1;
  dft62(sf + sss, reinterpret_cast<const float2*>(tab + T_DFT), ln, y0, y1);
  __syncwarp();
  float2* y = sf;                      // the 62 bins over sf[0, 62)
  float2* e = sf + 64;                 // descrambled even / odd bins
  y[ln] = y0;
  if (ln + 32 < NB) y[ln + 32] = y1;
  __syncwarp();
  const float* c = tab + T_CSCR + r * 62;      // c0 [31], then c1 [31]
  if (ln < 31) {
    const float2 v = y[2 * ln];
    e[ln] = make_float2(__fmul_rn(v.x, c[ln]), __fmul_rn(v.y, c[ln]));
  }
  __syncwarp();
  const int m0 = sss_argmax(e, tab + T_BANK, ln);
  __syncwarp();
  if (ln < 31) {
    const float g = __fmul_rn(c[31 + ln], tab[T_Z + (m0 % 8) * 31 + ln]);
    const float2 v = y[2 * ln + 1];
    e[ln] = make_float2(__fmul_rn(v.x, g), __fmul_rn(v.y, g));
  }
  __syncwarp();
  const int m1 = sss_argmax(e, tab + T_BANK, ln);
  const int direct = static_cast<int>(tab[T_NID1 + m0 * 31 + m1]);
  const int swapped = static_cast<int>(tab[T_NID1 + m1 * 31 + m0]);
  const int nid1 = direct >= 0 ? direct : swapped;
  const bool sub5 = direct < 0 && swapped >= 0;
  const int cell = 3 * max(nid1, 0) + r;
  if (ln == 0) {
    a.freq[i] = f;
    a.cell_id[i] = cell;
    a.normal_cp[i] = ncp;
    tcell[u] = cell;
    tfreq[u] = f;
    tflag[u] = (nid1 >= 0 ? F_SSS : 0) | (sub5 ? F_SUB5 : 0) |
               (ncp ? F_NCP : 0);
  }
}

// The capture chain's carry from one tile to the next (warp 0, every lane
// the same)
struct Chain {
  bool pub_live, pf;
  int cum, overflow, cell, last_push;
};

// Warp 0, lane j for step t0 + j of a tile of n: the step's capture
// decision as the plain version's closed form gives it, by ballots; each
// captured step written into its slot; the carry advanced past the tile.
__device__ __forceinline__ void chain_tile(const DecideArgs& a, long long l,
                                           int t0, int n, int ln,
                                           const int* tcell,
                                           const float* tfreq,
                                           const int* tflag, Chain& ch) {
  const int t = t0 + ln;
  const bool act = ln < n;
  const long long i = static_cast<long long>(t) * a.L + l;
  bool em = false, lo = false, tr = false, ga = false;
  int cell = 0, fl = 0;
  float fq = 0.f;
  long long st0 = 0;
  if (act) {
    em = a.emit[i];
    lo = a.lost[i];
    tr = a.tracking[i];
    st0 = static_cast<long long>(a.grid[t]) + a.peak[i] - LOOKBACK;
    ga = st0 + 2 * SLOT <= a.data_valid;
    cell = tcell[ln];
    fq = tfreq[ln];
    fl = tflag[ln];
  }
  const unsigned below = (1u << ln) - 1u, upto = below | (1u << ln);
  const unsigned lm = __ballot_sync(FULL, lo);
  // published_live: cleared by a loss at or before the step
  const bool gate = ch.pub_live && !(lm & upto);
  const bool want_any = em && !lo && (fl & F_SSS) && !gate && !(fl & F_SUB5);
  const bool elig = want_any && ga;
  const unsigned em_ = __ballot_sync(FULL, elig);
  const int slot = ch.cum + __popc(em_ & below);
  const bool cap = elig && slot < a.K;
  const unsigned cm = __ballot_sync(FULL, cap);
  const unsigned om = __ballot_sync(FULL, want_any && !cap);
  // the last capture and loss before the step, in the tile or carried
  const unsigned cb = cm & below, lb = lm & below;
  const int lc = cb ? highest(cb) : -1, ll = lb ? highest(lb) : -1;
  const int cell_prev = __shfl_sync(FULL, cell, lc >= 0 ? lc : ln);
  const int cell_before = lc >= 0 ? cell_prev : ch.cell;
  const bool pf_before = (lc < 0 && ll < 0) ? ch.pf : ll > lc;
  const bool fresh = pf_before || cell != cell_before;
  if (act) {
    a.want_cap[i] = cap;
    a.at[l * a.S + t] = cap ? slot : a.K;
    if (cap) {
      const long long o = l * a.K + slot;
      a.cand_cell[o] = cell;
      a.cand_cp[o] = (fl & F_NCP) != 0;
      a.cand_fresh[o] = fresh;
      a.cand_start[o] = st0 + SLOT;
      a.cand_freq[o] = fq;
    }
  }
  const int last_cell = __shfl_sync(FULL, cell, cm ? highest(cm) : 0);
  if (cm) ch.cell = last_cell;
  if (cm | lm) ch.pf = (lm ? highest(lm) : -1) > (cm ? highest(cm) : -1);
  ch.pub_live = ch.pub_live && !lm;
  ch.cum += __popc(em_);
  ch.overflow += __popc(om);
  const unsigned pm = __ballot_sync(FULL, act && em && tr);
  if (pm) ch.last_push = t0 + highest(pm);
}

__global__ void __launch_bounds__(THREADS, 2)
    front_decide_kernel(const DecideArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* tab = reinterpret_cast<float*>(smem + S_TAB);
  float2* seg = reinterpret_cast<float2*>(smem + S_SEG);
  int* tcell = reinterpret_cast<int*>(smem + S_CELL);
  float* tfreq = reinterpret_cast<float*>(smem + S_FREQ);
  int* tflag = reinterpret_cast<int*>(smem + S_FLAG);
  int* scal = reinterpret_cast<int*>(smem + S_SCAL);

  const long long l = blockIdx.x;
  const int r = static_cast<int>(l % R);
  const int tid = threadIdx.x, w = tid >> 5, ln = tid & 31;
  for (int j = tid; j < T_SHARED / 4; j += THREADS)
    reinterpret_cast<float4*>(tab)[j] =
        reinterpret_cast<const float4*>(a.tab)[j];
  Chain ch{a.published[l], a.pf0[l], 0, 0, a.mib_cell[l], -1};
  __syncthreads();

  const int tiles = (a.S + TILE - 1) / TILE;
  for (int it = 0; it <= tiles; ++it) {
    const int b = it & 1;
    if (it < tiles) {
      for (int u = w; u < TILE; u += WARPS) {
        const int t = it * TILE + u;
        if (t < a.S)
          decide_step(a, tab, seg + w * SEG, l, r, t, ln, tcell + b * TILE,
                      tfreq + b * TILE, tflag + b * TILE, u);
      }
    }
    if (it > 0 && w == 0) {
      const int t0 = (it - 1) * TILE;
      chain_tile(a, l, t0, min(TILE, a.S - t0), ln, tcell + (b ^ 1) * TILE,
                 tfreq + (b ^ 1) * TILE, tflag + (b ^ 1) * TILE, ch);
    }
    __syncthreads();
  }
  if (tid == 0) {
    const int cnt = min(ch.cum, a.K);
    a.cnt[l] = cnt;
    a.pf_f[l] = ch.pf;
    a.overflow[l] = ch.overflow;
    scal[0] = cnt;
    scal[1] = ch.last_push;
  }
  __syncthreads();
  const int cnt = scal[0], lp = scal[1];
  for (int j = tid; j < a.K; j += THREADS) {
    const long long o = l * a.K + j;
    a.valid[o] = j < cnt;
    if (j >= cnt) {
      a.cand_cell[o] = 0;
      a.cand_cp[o] = false;
      a.cand_fresh[o] = false;
      a.cand_start[o] = 0;
      a.cand_freq[o] = 0.f;
    }
  }
  float* chest = a.chest + l * NB * 2;
  if (lp < 0) {                        // no push: the carried estimate
    for (int j = tid; j < NB * 2; j += THREADS)
      chest[j] = a.chest0[l * NB * 2 + j];
  } else if (w == WARPS - 1) {         // the last pushed step's PSS
    const long long i = static_cast<long long>(lp) * a.L + l;
    const float f = a.tracking[i] ? __fdiv_rn(-a.mean[i], 128.f) : 0.f;
    const float wf = __fmul_rn(TWO_PI, f);
    const long long base =
        static_cast<long long>(a.grid[lp]) + a.peak[i] - LOOKBACK + SEG_OFF +
        SEG - SYM;
    float2* sf = seg + w * SEG;
    const float* xr = a.re + (l / R) * a.N;
    const float* xi = a.im + (l / R) * a.N;
#pragma unroll
    for (int q = 0; q < SYM / 32; ++q) {
      const int n = ln + 32 * q;
      sf[n] = rotate(rd(xr, xi, a.N, base + n), wf, SEG_OFF + SEG - SYM + n);
    }
    __syncwarp();
    float2 y[2];
    dft62(sf, reinterpret_cast<const float2*>(tab + T_DFT), ln, y[0], y[1]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = ln + 32 * h;
      if (k < NB) {                    // y * conj(replica)
        const float fr = a.tab[T_FRE + r * NB + k];
        const float fi = a.tab[T_FIM + r * NB + k];
        chest[2 * k] =
            __fadd_rn(__fmul_rn(y[h].x, fr), __fmul_rn(y[h].y, fi));
        chest[2 * k + 1] =
            __fsub_rn(__fmul_rn(y[h].y, fr), __fmul_rn(y[h].x, fi));
      }
    }
  }
}

// front_decide's dynamic shared memory past 48 KB, allowed once a device
// (outside any stream capture: the first call of a process is)
cudaError_t allow_smem() {
  static unsigned long long done = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 64 && ((done >> dev) & 1ull))) return e;
  e = cudaFuncSetAttribute(front_decide_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e == cudaSuccess && dev < 64) done |= 1ull << dev;
  return e;
}

}  // namespace

// front_estimate for S steps of L lanes: buffer re / im [L / 3, N] float32,
// grid [S] int32, peak [S, L] int32, emit / tracking [S, L] bool, tab the
// kernels' tables; out est [S, L] float32, push [S, L] bool.  Returns 0 or
// the cudaError of the launch.
extern "C" int front_estimate(const float* re, const float* im,
                              const int32_t* grid, const int32_t* peak,
                              const bool* emit, const bool* tracking,
                              const float* tab, long long N, long long L,
                              int S, float* est, bool* push, void* stream) {
  const long long items = static_cast<long long>(S) * L;
  if (items <= 0) return 0;
  const long long blocks = (items + EST_WARPS - 1) / EST_WARPS;
  if (blocks >= (1LL << 31) || L % R)
    return static_cast<int>(cudaErrorInvalidValue);
  front_estimate_kernel<<<static_cast<unsigned>(blocks), 32 * EST_WARPS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      re, im, grid, peak, emit, tracking, tab, N, L, S, est, push);
  return static_cast<int>(cudaGetLastError());
}

// front_decide for S steps of L lanes: the inputs of front_estimate, lost
// [S, L] bool, the ring's means [S, L], the carry (published, mib_cell,
// pending_fresh [L], chest [L, 62, 2]), K slots, data_valid; out (in the
// order of pass_c_front.Front's fields from freq on) freq, chest,
// normal_cp, cell_id, want_cap [S, L] / [L, 62, 2], at [L, S] int64, cnt
// [L] int64, pf_f, overflow [L], cand_cell, cand_cp, cand_fresh,
// cand_start (int64), cand_freq, valid [L, K].  Returns 0 or the
// cudaError of the launch.
extern "C" int front_decide(
    const float* re, const float* im, const int32_t* grid,
    const int32_t* peak, const bool* emit, const bool* tracking,
    const bool* lost, const float* mean, const bool* published,
    const int32_t* mib_cell, const bool* pf0, const float* chest0,
    const float* tab, long long N, long long L, int S, int K,
    long long data_valid, float* freq, float* chest, bool* normal_cp,
    int32_t* cell_id, bool* want_cap, long long* at, long long* cnt,
    bool* pf_f, int32_t* overflow, int32_t* cand_cell, bool* cand_cp,
    bool* cand_fresh, long long* cand_start, float* cand_freq, bool* valid,
    void* stream) {
  if (L <= 0) return 0;
  if (S < 0 || K < 1 || L >= (1LL << 31) || L % R)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = allow_smem();
  if (e != cudaSuccess) return static_cast<int>(e);
  const DecideArgs a{re, im, grid, peak, emit, tracking, lost, mean,
                     published, mib_cell, pf0, chest0, tab, N, L, data_valid,
                     S, K, freq, chest, normal_cp, cell_id, want_cap, at,
                     cnt, pf_f, overflow, cand_cell, cand_cp, cand_fresh,
                     cand_start, cand_freq, valid};
  front_decide_kernel<<<static_cast<unsigned>(L), THREADS, SMEM,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// out[0..3] of front_decide: registers a thread, local (spill) bytes a
// thread, shared memory a block (static and dynamic), blocks resident a
// SM.  Returns 0 or a cudaError.
extern "C" int front_kernel_info(int* out) {
  cudaFuncAttributes fa;
  cudaError_t e = allow_smem();
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, front_decide_kernel);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, front_decide_kernel, THREADS, SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(fa.sharedSizeBytes) + SMEM;
  out[3] = n;
  return 0;
}

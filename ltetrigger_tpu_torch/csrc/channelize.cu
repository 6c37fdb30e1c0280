// The channelizer's mixer and decimator in one launch (Hopper, sm_90a):
// every centre of a band mixed down and low-pass decimated from one wide
// stream, nothing but the lanes written to device memory.
//
// Replaces no Pallas kernel: the JAX package's channelizer is jnp
// (ltetrigger_tpu/ops/channelize.py:59 _channelize_scan: a lax.scan over
// chunks of the phase, the rotation, the mixed [C, chunk] stream and a
// strided convolution).  Its plain PyTorch version is channelize_plain in
// ltetrigger_tpu_torch/ops/kernels/channelize.py, the same chunk loop
// (about ten elementwise ops over [C, chunk] tensors in device memory,
// then a depthwise conv1d of L = 16 R taps at stride R).  This kernel
// computes the same outputs in another order.  With i0 = BLOCK + n R the
// wide index of output n of centre c:
//
//   y_c[n]   = rot_c(i0) * sum_k g_c[k] * x[i0 + k - 8R]
//   g_c[k]   = h[k] * exp(j 2 pi ramp_c(k - 8R))
//   rot_c(i) = exp(j 2 pi (origins[c, i / BLOCK] + ramps[c, i % BLOCK]))
//
// with ramp_c(d) = ramps[c, d] and ramp_c(-d) = -ramps[c, d]: the mixer's
// phase is linear in i, so the rotation of each tap's input is the
// output's rotation times a fixed one a tap, folded into the taps.  Every
// phase is an f32 value of the plain version's mod-1 tables; the rotation
// is needed at the narrow rate only.  R = 1 is the mix alone (the
// decimator returns its input at ratio 1), in a kernel of its own.
//
// Bound (the band: C = 170 centres, 61.44 M wide samples, R = 16): the
// wide pair read once (0.49 GB) and the lanes written once (5.2 GB), 1.7 ms
// at 3.35 TB/s; the filter's 170 x 3.84 M x 256 complex taps, 6.7e11
// FFMA, 20 ms at 33.5 T FFMA/s (H100 data sheet), or ~8 ms as three TF32
// products at 495 TF/s.  The kernel is bound by its float32 arithmetic,
// which stays float32 FFMA (a single TF32 product would be a lower
// precision than the channelizer's float32).  The design:
//
// * A block of 256 threads: a tile of T = 512 outputs of a group of 16
//   centres.  Thread (r, t), r < 4, t < 64: centres 4r..4r+3, outputs
//   8t..8t+7 of the tile, 32 complex accumulators in registers; a row of
//   centres past C skips the sum.  The grid, ceil(C / 16) x ceil(n_out /
//   512) blocks, follows the shape; its centre groups vary fastest, so a
//   tile's wide input comes from device memory once and from L2 for the
//   other groups.
// * Polyphase: tap k = R q + p reads X_p[n + q], X_p[m] = x[base + m R +
//   p].  A piece of P phases (the largest divisor of R up to 16) of the
//   tile's input, (T + 16) x P complex, is staged in shared memory phase
//   by phase, index m at m + m / 8: the 32 threads of a warp, 8 outputs
//   apart, then read 32 banks.  The piece's taps g_c, made by the block
//   from h and the ramp table, sit beside it as [p][q][4 centres] float4s
//   that a warp reads as one broadcast.
// * The sum: for 4 taps a thread reads 11 input values (a sliding window)
//   and a float4 pair a tap, then issues 128 FFMA a tap: shared memory
//   serves ~17 FFMA a load, so the FFMA pipe, not the loads, is the limit.
// * The epilogue: the accumulators staged in shared memory (same skew),
//   then each output rotated (sincospif of origins[c, b] + ramps[c, R m]
//   summed in f32, as the plain version sums them) and written once,
//   coalesced, into the [C, n_out] re and im planes.
//
// The kernel allocates nothing and does not synchronise.  Times are in
// PERF.md (section 6).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BLOCK = 9600;  // the phase tables' block (ops/channelize.py)
constexpr int K = 16;        // taps a phase: L = 16 R
constexpr int CPT = 4;       // centres a thread
constexpr int OPT = 8;       // outputs a thread
constexpr int QB = 4;        // taps a sliding window
constexpr int PMAX = 16;     // phases a piece
constexpr int MIX_THREADS = 256;

__host__ __device__ constexpr int skew(int m) { return m + (m >> 3); }

// the least row pitch >= n that is 18 mod 32: the x piece's P rows, stored
// by consecutive threads, then fall in distinct banks
__host__ __device__ constexpr int pitch18(int n) {
  return n + ((18 - n) % 32 + 32) % 32;
}

__host__ __device__ constexpr int up4(int n) { return (n + 3) & ~3; }

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

constexpr int ROWS = 4;      // rows of 4 centres a block
constexpr int COLS = 64;     // threads a row, 8 outputs each
constexpr int THREADS = ROWS * COLS;
constexpr int CG = CPT * ROWS;                 // centres a block
constexpr int T = OPT * COLS;                  // outputs a block
constexpr int SPAN = T + K;                    // X_p[m], m < SPAN
constexpr int XPITCH = pitch18(skew(SPAN - 1) + 1);
constexpr int OPITCH = skew(T);

// floats of shared memory: the x piece or the staged outputs, then taps
__host__ __device__ constexpr int front(int P) {
  return up4(imax(2 * P * XPITCH, 2 * CG * OPITCH));
}
__host__ __device__ constexpr int smem_floats(int P) {
  return front(P) + 2 * P * K * CG;
}

struct Args {
  const float* xr;           // the wide pair, [xlen] each
  const float* xi;
  long long xlen;
  const float* origins;      // [C, nb]
  int nb;
  const float* ramps;        // [C, BLOCK]
  const float* rampn;        // ramps[:, ::R], [C, BLOCK / R]
  const float* h;            // the decimator's taps, [16 R]
  int C, R, P;               // P: phases a piece
  long long n_out;
  int groups;                // centre groups of the grid
  float* yr;                 // the lanes, [C, n_out] each
  float* yi;
};

// 128 registers a thread at 2 blocks a SM
__global__ void __launch_bounds__(THREADS, 2)
    chan_decimate_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const float* __restrict__ ramps = a.ramps;
  const int C = a.C, R = a.R, P = a.P;
  const int tid = threadIdx.x;
  const int r = tid / COLS, t = tid % COLS;
  const int c0 = static_cast<int>(blockIdx.x % a.groups) * CG;
  const long long n0 = static_cast<long long>(blockIdx.x / a.groups) * T;
  const long long base = BLOCK - 8LL * R + n0 * R;   // X_p[0] = x[base + p]
  float* const Xr = smem;
  float* const Xi = smem + P * XPITCH;
  float* const Tr = smem + front(P);
  float* const Ti = Tr + P * K * CG;
  const bool live = c0 + CPT * r < C;                // warp-uniform

  float ar[CPT][OPT], ai[CPT][OPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c)
#pragma unroll
    for (int j = 0; j < OPT; ++j) ar[c][j] = ai[c][j] = 0.f;

  for (int p0 = 0; p0 < R; p0 += P) {
    __syncthreads();                 // the last piece's sums are done
    // the piece's taps: float (pl K + q) CG + cl is tap R q + p0 + pl of
    // centre c0 + cl
    for (int i = tid; i < P * K * CG; i += THREADS) {
      const int cl = i % CG, q = (i / CG) % K;
      const int pl = i / (CG * K);
      const int c = c0 + cl, k = R * q + p0 + pl;
      float gr = 0.f, gi = 0.f;
      if (c < C) {
        const int d = k - 8 * R;
        const float* row = ramps + static_cast<long long>(c) * BLOCK;
        const float th = d >= 0 ? row[d] : -row[-d];
        float s, co;
        sincospif(2.f * th, &s, &co);
        gr = a.h[k] * co;
        gi = a.h[k] * s;
      }
      Tr[i] = gr;
      Ti[i] = gi;
    }
    // the piece's input, phase-major and skewed; zeros past the stream
    for (int i = tid; i < SPAN * P; i += THREADS) {
      const int m = i / P, pl = i - m * P;
      const long long g = base + static_cast<long long>(m) * R + p0 + pl;
      float vr = 0.f, vi = 0.f;
      if (g < a.xlen) {
        vr = a.xr[g];
        vi = a.xi[g];
      }
      Xr[pl * XPITCH + skew(m)] = vr;
      Xi[pl * XPITCH + skew(m)] = vi;
    }
    __syncthreads();
    if (!live) continue;
    for (int pl = 0; pl < P; ++pl) {
      // skew(8t + m) = 9t + skew(m) for m < 24
      const float* wr = Xr + pl * XPITCH + 9 * t;
      const float* wi = Xi + pl * XPITCH + 9 * t;
      const float4* gr4 =
          reinterpret_cast<const float4*>(Tr) + pl * K * ROWS + r;
      const float4* gi4 =
          reinterpret_cast<const float4*>(Ti) + pl * K * ROWS + r;
#pragma unroll
      for (int q0 = 0; q0 < K; q0 += QB) {
        float vr[OPT + QB - 1], vi[OPT + QB - 1];
#pragma unroll
        for (int s = 0; s < OPT + QB - 1; ++s) {
          vr[s] = wr[skew(q0 + s)];
          vi[s] = wi[skew(q0 + s)];
        }
#pragma unroll
        for (int qq = 0; qq < QB; ++qq) {
          const float4 ga = gr4[(q0 + qq) * ROWS];
          const float4 gb = gi4[(q0 + qq) * ROWS];
          const float gre[CPT] = {ga.x, ga.y, ga.z, ga.w};
          const float gim[CPT] = {gb.x, gb.y, gb.z, gb.w};
#pragma unroll
          for (int c = 0; c < CPT; ++c)
#pragma unroll
            for (int j = 0; j < OPT; ++j) {
              ar[c][j] = fmaf(gre[c], vr[j + qq], ar[c][j]);
              ar[c][j] = fmaf(-gim[c], vi[j + qq], ar[c][j]);
              ai[c][j] = fmaf(gre[c], vi[j + qq], ai[c][j]);
              ai[c][j] = fmaf(gim[c], vr[j + qq], ai[c][j]);
            }
        }
      }
    }
  }

  // the epilogue: sums staged (the x piece's space), rotated, written once
  __syncthreads();
  float* const Or = smem;
  float* const Oi = smem + CG * OPITCH;
  if (live) {
#pragma unroll
    for (int c = 0; c < CPT; ++c)
#pragma unroll
      for (int j = 0; j < OPT; ++j) {
        Or[(CPT * r + c) * OPITCH + 9 * t + j] = ar[c][j];
        Oi[(CPT * r + c) * OPITCH + 9 * t + j] = ai[c][j];
      }
  }
  __syncthreads();
  const int M = BLOCK / R;                           // narrow samples a block
  for (int i = tid; i < CG * T; i += THREADS) {
    const int cl = i / T, n = i % T;
    const int c = c0 + cl;
    const long long ng = n0 + n;
    if (c >= C || ng >= a.n_out) continue;
    const long long b = 1 + ng / M;                  // i0 / BLOCK
    const int m = static_cast<int>(ng % M);          // (i0 % BLOCK) / R
    const float th = a.origins[static_cast<long long>(c) * a.nb + b] +
                     a.rampn[static_cast<long long>(c) * M + m];
    float s, co;
    sincospif(2.f * th, &s, &co);
    const float vr = Or[cl * OPITCH + skew(n)];
    const float vi = Oi[cl * OPITCH + skew(n)];
    const long long o = static_cast<long long>(c) * a.n_out + ng;
    a.yr[o] = vr * co - vi * s;
    a.yi[o] = vr * s + vi * co;
  }
}

// R = 1: output n of centre c is x[BLOCK + n] rotated by its phase
__global__ void __launch_bounds__(MIX_THREADS) chan_mix_kernel(const Args a) {
  const long long total = static_cast<long long>(a.C) * a.n_out;
  for (long long o = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       o < total; o += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long c = o / a.n_out, n = o % a.n_out, i = BLOCK + n;
    const float th = a.origins[c * a.nb + 1 + n / BLOCK] +
                     a.ramps[c * BLOCK + n % BLOCK];
    float s, co;
    sincospif(2.f * th, &s, &co);
    const float vr = i < a.xlen ? a.xr[i] : 0.f;
    const float vi = i < a.xlen ? a.xi[i] : 0.f;
    a.yr[o] = vr * co - vi * s;
    a.yi[o] = vr * s + vi * co;
  }
}

int phases_per_piece(int R) {
  int P = R < PMAX ? R : PMAX;
  while (R % P) --P;
  return P;
}

int launch(Args a, cudaStream_t stream) {
  a.P = phases_per_piece(a.R);
  a.groups = (a.C + CG - 1) / CG;
  const long long blocks = ((a.n_out + T - 1) / T) * a.groups;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * smem_floats(a.P);
  // the attribute is per device, so set on every launch
  cudaError_t e = cudaFuncSetAttribute(
      chan_decimate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  chan_decimate_kernel<<<static_cast<unsigned>(blocks), THREADS, smem,
                         stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Mix the wide pair (xr, xi) [xlen] to C centres and decimate by R into
// (yr, yi) [C, n_out] (see the header); origins [C, nb], ramps [C, BLOCK]
// and rampn = ramps[:, ::R] [C, BLOCK / R] float32, h [16 R] the
// decimator's taps.  Returns 0 or a cudaError.
extern "C" int chan_scan(const float* xr, const float* xi, long long xlen,
                         const float* origins, int nb, const float* ramps,
                         const float* rampn, const float* h, int C, int R,
                         long long n_out, float* yr, float* yi,
                         void* stream) {
  if (R < 1 || BLOCK % R || 8 * R >= BLOCK || C < 0 || n_out < 0 || xlen < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0 || n_out == 0) return 0;
  const Args a{xr, xi, xlen, origins, nb, ramps, rampn, h, C, R, 0, n_out, 0,
               yr, yi};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R > 1) return launch(a, s);
  const long long total = static_cast<long long>(C) * n_out;
  long long blocks = (total + MIX_THREADS - 1) / MIX_THREADS;
  if (blocks > 132 * 64) blocks = 132 * 64;
  chan_mix_kernel<<<static_cast<unsigned>(blocks), MIX_THREADS, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// out[0..3] of the decimating kernel: registers a thread, local (spill)
// bytes a thread, dynamic shared memory a block at 16 phases a piece,
// blocks resident a SM.  Returns 0 or a cudaError.
extern "C" int chan_kernel_info(int* out) {
  const size_t smem = sizeof(float) * smem_floats(PMAX);
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncSetAttribute(
      chan_decimate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, chan_decimate_kernel);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, chan_decimate_kernel, THREADS, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(smem);
  out[3] = n;
  return 0;
}

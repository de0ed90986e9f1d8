// Mamba2 / SSD chunked scan for Hopper (sm_90a), f32 in and out.
//
// Replaces the Pallas TPU kernel src/repro/kernels/mamba_scan.py
// (mamba_scan_kernel, body _kernel).  Per (batch b, head h), over time t:
//
//   S_t = e^{a_t} * S_{t-1} + dtx_t (x) B_t        (P x N state, S_0 = 0)
//   y_t = S_t . C_t
//
// with dtx (b, S, H, P), a (b, S, H), B and C (b, S, N): one group, so B
// and C are indexed by (b, t) and shared by every head.
//
// Chunkwise, as the Pallas body: for a chunk of Q steps with in-chunk
// cumulative log decay cum_t,
//   y_t   = sum_{s<=t} (C_t . B_s) e^{cum_t - cum_s} dtx_s     (intra)
//         + e^{cum_t} (S . C_t)                                (inter)
//   S'    = e^{cum_last} S + sum_s e^{cum_last - cum_s} dtx_s (x) B_s
// The exp is taken only where s <= t: a future entry has cum_t - cum_s > 0
// and would overflow.  a = -30 (a full reset) makes e^{cum} underflow to 0,
// which is the right answer.
//
// What bounds it on an H100 SXM: per chunk of one (b, h) it does about
// Q^2 (N + P) operations on the masked scores and the intra term and 4 Q N P
// on the inter term and the carry, and moves 8 Q P bytes of f32 dtx in and
// y out (a, B and C add little: B and C are shared by the H heads).  At
// zamba2's P = N = 64 and Q = 64 that is some 48 operations per byte, above
// the balance of the f32 CUDA cores (67 TFLOP/s over 3.35 TB/s: 20), so
// operations bound it.
//
// This first design is simple and right, not fast:
//   * one block of 256 threads per (b, h) walks the chunks in order (the
//     Pallas grid's sequential chunk axis becomes this loop), with the
//     P x N state in shared memory, transposed (St[n][p]);
//   * per chunk of Q = 64 steps it stages dtx, B and C (zero past the
//     ragged end of S and past P and N, so padding adds nothing) and the
//     cumulative sum of a (one warp, shuffles), then runs four 64 x 64
//     tiles, each thread a 4 x 4 patch: the masked decay-weighted scores
//     (patches wholly above the diagonal skipped), y = intra + inter, and
//     the carry;
//   * P and N up to 64; smaller ones are padded with zeros in shared memory.
// Shared memory is 4 * (6 * 64 * 68 + 64) = 104,704 bytes.  What it leaves
// on the table: C.B^T is recomputed by each of the H heads that share it;
// at batch 1 zamba2 gives 80 blocks for 132 SMs (under one wave; a split of
// P across blocks would fill the card); the products run in f32 on the CUDA
// cores, not on the tensor cores, and the tiles are loaded by the threads,
// not by TMA.

#include <cuda_runtime.h>

namespace {

constexpr int Q = 64;            // time steps per chunk
constexpr int PMAX = 64;         // state rows (head dim P) a block holds
constexpr int NMAX = 64;         // state columns (state dim N)
constexpr int THREADS = 256;     // 16 x 16 threads, a 4 x 4 patch each
constexpr int LD = 64 + 4;       // row stride of every tile: float4-aligned

static_assert(Q == 64 && PMAX == 64 && NMAX == 64,
              "the 16 x 16 threads of 4 x 4 patches cover 64 x 64 tiles");

struct ScanArgs {
  const float* dtx;
  const float* a_log;
  const float* B;
  const float* C;
  float* y;
  int S, H, P, N;
};

constexpr int smem_floats() { return 6 * 64 * LD + Q; }

__global__ void __launch_bounds__(THREADS)
mamba_scan_kernel(const ScanArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* X = smem;              // [Q][LD]     dtx_s[p] of this chunk
  float* St = X + Q * LD;       // [NMAX][LD]  the state, St[n][p] = S[p][n]
  float* Ct = St + NMAX * LD;   // [NMAX][LD]  Ct[n][t] = C_t[n]
  float* Bt = Ct + NMAX * LD;   // [NMAX][LD]  Bt[n][s] = B_s[n]
  float* Bw = Bt + NMAX * LD;   // [Q][LD]     Bw[s][n] = e^{cum_last-cum_s} B_s[n]
  float* Gt = Bw + Q * LD;      // [Q][LD]     Gt[s][t] = masked scores
  float* cum = Gt + Q * LD;     // [Q]         in-chunk cumulative log decay

  const int tid = threadIdx.x;
  const int tx = tid % 16;      // columns: s (scores) or p (y, carry)
  const int ty = tid / 16;      // rows: t (scores, y) or n (carry)
  const int r0 = ty * 4, c0 = tx * 4;
  const int bi = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int S = a.S, H = a.H, P = a.P, N = a.N;

  for (int i = tid; i < NMAX * LD; i += THREADS) St[i] = 0.f;

  for (int t0 = 0; t0 < S; t0 += Q) {
    const int L = min(Q, S - t0);             // steps in this chunk
    const size_t row0 = (size_t)bi * S + t0;  // (b, t0) in a (b, S) grid

    for (int i = tid; i < Q * PMAX; i += THREADS) {
      const int s = i / PMAX, p = i % PMAX;
      X[s * LD + p] = s < L && p < P
                          ? a.dtx[((row0 + s) * H + h) * P + p] : 0.f;
    }
    for (int i = tid; i < Q * NMAX; i += THREADS) {
      const int s = i / NMAX, n = i % NMAX;
      const bool in = s < L && n < N;
      Bt[n * LD + s] = in ? a.B[(row0 + s) * N + n] : 0.f;
      Ct[n * LD + s] = in ? a.C[(row0 + s) * N + n] : 0.f;
    }
    if (tid < 32) {   // inclusive scan of a over the chunk: 2 steps a lane
      const int s = 2 * tid;
      const float v0 = s < L ? a.a_log[(row0 + s) * H + h] : 0.f;
      const float v1 = s + 1 < L ? a.a_log[(row0 + s + 1) * H + h] : 0.f;
      float run = v0 + v1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, run, off);
        if (tid >= off) run += up;
      }
      cum[s + 1] = run;
      cum[s] = run - v1;
    }
    __syncthreads();
    const float clast = cum[Q - 1];   // = cum[L - 1]: a is 0 past L

    // Masked decay-weighted scores G[t][s] = (C_t . B_s) e^{cum_t - cum_s}
    // for s <= t, stored transposed; a patch wholly above the diagonal
    // (tx > ty) is 0.
    float g[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) g[i][j] = 0.f;
    if (tx <= ty) {
      for (int n = 0; n < N; ++n) {
        const float4 cv = *reinterpret_cast<const float4*>(&Ct[n * LD + r0]);
        const float4 bv = *reinterpret_cast<const float4*>(&Bt[n * LD + c0]);
        const float ca[4] = {cv.x, cv.y, cv.z, cv.w};
        const float ba[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) g[i][j] = fmaf(ca[i], ba[j], g[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          g[i][j] = c0 + j <= r0 + i
                        ? g[i][j] * expf(cum[r0 + i] - cum[c0 + j]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Gt[(c0 + j) * LD + r0]) =
          make_float4(g[0][j], g[1][j], g[2][j], g[3][j]);
    for (int i = tid; i < Q * NMAX; i += THREADS) {
      const int s = i / NMAX, n = i % NMAX;
      Bw[s * LD + n] = expf(clast - cum[s]) * Bt[n * LD + s];
    }
    __syncthreads();

    // y[t][p] = sum_{s<=t} G[t][s] X[s][p] + e^{cum_t} sum_n C_t[n] S[p][n]
    float intra[4][4], inter[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) intra[i][j] = inter[i][j] = 0.f;
    const int s_end = min(L, r0 + 4);   // G[t][s] = 0 for s > t
    for (int s = 0; s < s_end; ++s) {
      const float4 gv = *reinterpret_cast<const float4*>(&Gt[s * LD + r0]);
      const float4 xv = *reinterpret_cast<const float4*>(&X[s * LD + c0]);
      const float ga[4] = {gv.x, gv.y, gv.z, gv.w};
      const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          intra[i][j] = fmaf(ga[i], xa[j], intra[i][j]);
    }
    for (int n = 0; n < N; ++n) {
      const float4 cv = *reinterpret_cast<const float4*>(&Ct[n * LD + r0]);
      const float4 sv = *reinterpret_cast<const float4*>(&St[n * LD + c0]);
      const float ca[4] = {cv.x, cv.y, cv.z, cv.w};
      const float sa[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          inter[i][j] = fmaf(ca[i], sa[j], inter[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = r0 + i;
      if (t >= L) continue;
      const float et = expf(cum[t]);
      float* yrow = a.y + ((row0 + t) * H + h) * P;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c0 + j < P) yrow[c0 + j] = fmaf(et, inter[i][j], intra[i][j]);
    }
    __syncthreads();   // every thread has read St before the carry writes it

    // S'[p][n] = e^{cum_last} S[p][n] + sum_s Bw[s][n] X[s][p], as St[n][p]
    if (r0 < N && c0 < P) {
      const float el = expf(clast);
      float st[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 sv = *reinterpret_cast<const float4*>(
            &St[(r0 + i) * LD + c0]);
        st[i][0] = el * sv.x;
        st[i][1] = el * sv.y;
        st[i][2] = el * sv.z;
        st[i][3] = el * sv.w;
      }
      for (int s = 0; s < L; ++s) {
        const float4 bv = *reinterpret_cast<const float4*>(&Bw[s * LD + r0]);
        const float4 xv = *reinterpret_cast<const float4*>(&X[s * LD + c0]);
        const float ba[4] = {bv.x, bv.y, bv.z, bv.w};
        const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) st[i][j] = fmaf(ba[i], xa[j], st[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(&St[(r0 + i) * LD + c0]) =
            make_float4(st[i][0], st[i][1], st[i][2], st[i][3]);
    }
    __syncthreads();   // before the next chunk overwrites X, Bt, Ct and cum
  }
}

}  // namespace

// Launches on `stream` and returns the CUDA error (0 on success).  dtx is
// (b, S, H, P), a (b, S, H), B and C (b, S, N), y (b, S, H, P), all
// contiguous float32; the caller checks shapes, 1 <= P, N <= 64, S >= 1,
// and every index below 2**31.
extern "C" int mamba_scan_f32(const void* dtx, const void* a, const void* B,
                              const void* C, void* y, int b, int S, int H,
                              int P, int N, void* stream) {
  constexpr int smem = smem_floats() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      mamba_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ScanArgs args;
  args.dtx = static_cast<const float*>(dtx);
  args.a_log = static_cast<const float*>(a);
  args.B = static_cast<const float*>(B);
  args.C = static_cast<const float*>(C);
  args.y = static_cast<float*>(y);
  args.S = S;
  args.H = H;
  args.P = P;
  args.N = N;
  mamba_scan_kernel<<<b * H, THREADS, smem,
                      static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mamba_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

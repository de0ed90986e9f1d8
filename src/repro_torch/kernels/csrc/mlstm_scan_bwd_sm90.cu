// Backward of the stabilised mLSTM scan for Hopper (sm_90a): f32 in and
// out; the scores of the denominator in f64 on the FP64 tensor cores, the
// products on the TF32 tensor cores as three TF32 products each.
//
// The vector-Jacobian product of the recurrence csrc/mlstm_scan_sm90.cu
// computes (the forward of src/repro/kernels/mlstm_scan.py:62, whose Pallas
// kernel has no backward: JAX differentiates its jnp scan), in the plain
// version's exponents: per (batch b, head h), with lf'_t = (log f_t +
// m_{t-1}) - m_t and i'_t = i_t - m_t as the m chain rounds them
// (m_t = max(log f_t + m_{t-1}, i_t), m_0 = -1e30),
//
//   D_ts = e^{i'_s + sum_{s<u<=t} lf'_u}   (s <= t),   S_ts = q_t.k_s
//   d_t = sum_s D_ts S_ts,   h_t = sum_s D_ts S_ts v_s / max(|d_t|, 1).
//
// Given dh, with dnum_t = dh_t / den_t and dd_t = -(dh_t.h_t) / den_t
// sign(d_t) where |d_t| >= 1 (0 where the clamp holds), every pair (t, s)
// has dA_ts = dnum_t.v_s + dd_t and dl_ts = dA_ts D_ts S_ts, and
//
//   dq_t = sum_s dA_ts D_ts k_s,   dk_s = sum_t dA_ts D_ts q_t,
//   dv_s = sum_t D_ts S_ts dnum_t,
//   d i'_s = sum_t dl_ts (the column sums),
//   d lf'_u = sum_{s<u<=t} dl_ts = sum_{t>=u} (rowsum_t - colsum_t).
//
// The stabiliser is not gradient-free: lf' and i' depend on m, and m on the
// gates through the max.  The adjoint the exponents put on m_u telescopes
// to -rowsum_u, which is 0 but for rounding where the clamp does not hold
// (h does not depend on m there) and -(dh.h) where it does; then the m
// chain runs backwards, G_t = -rowsum_t + w_{t+1} G_{t+1}, with w_t = 1, 1/2
// or 0 as log f_t + m_{t-1} is above, equal to or below i_t (the max's
// gradient, a tie split evenly as torch and JAX split it), and
//   d log f_t = d lf'_t + w_t G_t,   d i_t = d i'_t + (1 - w_t) G_t,
//   d f_pre_t = d log f_t sigma(-f_pre_t).
// The row and column sums are taken over the very same f64 terms (products
// of two f32 numbers, exact in f64), so their difference, summed over t,
// cancels to f64 rounding and not to f32's.  m_0 = -1e30 where JAX has
// -inf changes nothing: lf'_0 enters no pair (u > s >= 0), so it is left
// out of the sums of lf'.
//
// The form.  The pairs are taken in the quadratic form over the whole
// sequence, with no state: the P x P state is 1 MiB per (b, h) at P = 512,
// and a chunkwise backward would carry its adjoint from chunk to chunk, so
// at xlstm-1.3b's training length (S = 512 = P) the quadratic form does
// less work.  Each pair's score, weight, dnum.v and M = dA D are formed
// once, in six launches:
//   1. gates: per (b, h) the m chain in the forward's order and rounding,
//      lf', i', w, and the f64 prefix sums of lf' as a block scan; in the
//      same grid, a warp per row t sums dh_t.h_t in f64;
//   2. scores: per 64 x 64 tile of the causal pairs, q_t.k_s in f64 on the
//      FP64 tensor cores (mma m16n8k8: exact products, f64 sums), D_ts in
//      f64, the tile's row sums of D (q.k) in f64; D and the scores
//      rounded to f32 into an SP x SP scratch (SP: S rounded up to 128);
//   3. rows: per step d_t, the tiles' row sums added lowest tile first;
//      den_t and dd_t;
//   4. pairs: per 128 x 128 block of pairs, X = dnum.V^T as three TF32
//      products (wgmma), M = (X + dd_t) D and W o S = D S in place of D and
//      S, dl = M S in f64 with its row and column sums over the block;
//   5. products: per 128 rows and 128 columns of P, dq = M.K over s <= t,
//      dk = M^T.Q and dv = (W o S)^T.dnum over t >= s, as three TF32
//      products, the longest blocks first;
//   6. gate gradients: per (b, h) rowsum_t and colsum_s, the blocks' sums
//      added lowest block first; d lf' and the m chain's adjoint backwards
//      over t as block scans (the adjoint's steps are affine maps).
// The exp is taken only for s <= t, where its exponent is <= 0.  No
// atomics: every sum has one order, and two launches give the same bits.
//
// What bounds it on an H100 SXM, at xlstm-1.3b's training shape (b 4, S
// 512, H 4, P 512): 134 MB of inputs and outputs (0.040 ms at 3.35 TB/s)
// against 2.1 GFLOP of f64 scores at 67 TFLOP/s and four pair products as
// TF32x3, ~26 GFLOP on the tensor cores at 495: operations bound it
// (0.084 ms).  The first version formed every score three times on the f32
// CUDA cores (5.24 ms a call).  Here the TF32 products run from swizzled
// K-major hi and lo planes filled per k-tile by cp.async and a split
// (transposed where the input's rows run along k), through the forward's
// pipeline (csrc/mlstm_tf32x3_sm90.cuh), two blocks to an SM; the scores
// take Hopper's m16n8k8 f64 shape, on an H100 faster than the forward's
// m8n8k4 at that shape (PERF.md); the scratch of D, S, M and W o S (2 SP^2
// floats per (b, h), 34 MB at that shape) stays mostly in the 50 MB L2.

#include <cuda_runtime.h>

#include <cstdint>

#include "mlstm_tf32x3_sm90.cuh"

namespace {

constexpr float M0 = -1e30f;        // the stabiliser before the first step
constexpr int PMAX = 512;
constexpr int ST = 64;              // score tile
constexpr int S_THREADS = 128;      // score blocks: four warps of 32 x 32
constexpr int KT = 32;              // P per staged k-tile of the scores
constexpr int LDS64 = KT + 4;       // f64 stride of the score operand tiles,
                                    // so the fragment loads meet 32 banks
constexpr int SEG = 1024;           // gate steps per shared segment
constexpr int GATE_THREADS = 128;
constexpr int ROW_THREADS = 256;

struct Args {
  const float* dh;
  const float* q;
  const float* k;
  const float* v;
  const float* i_pre;
  const float* f_pre;
  const float* h;
  float* dq;
  float* dk;
  float* dv;
  float* di;
  float* df;
  double* G;       // (b, H, S): sum_{1<=u<=t} lf'_u
  float* iota;     // (b, H, S): i'
  float* wsel;     // (b, H, S): w
  double* hd;      // (b, H, S): dh_t . h_t
  double* dpart;   // (b, H, SP, SP / ST): a score tile's row sums of D S
  float* den;      // (b, H, SP): max(|d_t|, 1), 1 on padded steps
  float* dd;       // (b, H, SP): the gradient of d_t, 0 on padded steps
  double* rpart;   // (b, H, SP, nb): a pair block's row sums of dl
  double* cpart;   // (b, H, SP, nb): its column sums
  float* sc;       // (b, H, SP, SP): the scores in f32, then W o S
  float* wm;       // (b, H, SP, SP): D in f32, then M
  int S, H, P;
  int SP, nb;      // S rounded up to TILE; SP / TILE
  bool vec;        // the (b, S, H, P) rows 16-byte aligned, P % 4 == 0
};

__device__ __forceinline__ size_t at(const Args& a, int bi, int hh) {
  return (static_cast<size_t>(bi) * a.S * a.H + hh) * a.P;
}

__device__ __forceinline__ size_t plane(const Args& a, int cell) {
  return static_cast<size_t>(cell) * a.SP * a.SP;
}

// Decodes the triangle's index `idx` (0 .. n(n+1)/2) into ti >= si.
__device__ __forceinline__ void tri(int idx, int& ti, int& si) {
  ti = 0;
  while (idx > ti) idx -= ++ti;
  si = idx;
}

// ---------------------------------------------------------------------------
// The gate launches' scans over a segment of SEG steps: thread i takes the
// PER steps from PER i; the threads' parts are combined in one fixed tree,
// a warp's shuffles, then the warps in order.
constexpr int PER = SEG / GATE_THREADS;
constexpr int GATE_WARPS = GATE_THREADS / 32;

// The sum of x over the threads below this one; `total` over all.
__device__ double earlier_sum(double x, double* ws, double& total) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  double incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) ws[warp] = incl;
  __syncthreads();
  double before = 0.0;
  total = 0.0;
#pragma unroll
  for (int w = 0; w < GATE_WARPS; ++w) {
    if (w < warp) before += ws[w];
    total += ws[w];
  }
  const double excl = __shfl_up_sync(0xffffffffu, incl, 1);
  __syncthreads();   // ws is free again
  return lane ? before + excl : before;
}

// The sum of x over the threads above this one.
__device__ double later_sum(double x, double* ws) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  double incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double y = __shfl_down_sync(0xffffffffu, incl, o);
    if (lane + o < 32) incl += y;
  }
  if (lane == 0) ws[warp] = incl;
  __syncthreads();
  double after = 0.0;
#pragma unroll
  for (int w = GATE_WARPS - 1; w > 0; --w)
    if (w > warp) after += ws[w];
  const double excl = __shfl_down_sync(0xffffffffu, incl, 1);
  __syncthreads();
  return lane < 31 ? excl + after : after;
}

// x -> A x + B; f.after(g) is f o g.
struct Affine {
  double A, B;
  __device__ Affine after(Affine g) const { return {A * g.A, A * g.B + B}; }
};

// The composition of the maps of the threads above this one, the lowest
// outermost.
__device__ Affine later_map(Affine f, double* wa, double* wb) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const Affine y{__shfl_down_sync(0xffffffffu, f.A, o),
                   __shfl_down_sync(0xffffffffu, f.B, o)};
    if (lane + o < 32) f = f.after(y);
  }
  if (lane == 0) {
    wa[warp] = f.A;
    wb[warp] = f.B;
  }
  __syncthreads();
  Affine e{__shfl_down_sync(0xffffffffu, f.A, 1),
           __shfl_down_sync(0xffffffffu, f.B, 1)};
  if (lane == 31) e = {1.0, 0.0};
  for (int w = warp + 1; w < GATE_WARPS; ++w) e = e.after({wa[w], wb[w]});
  __syncthreads();
  return e;
}

// Launch 1: per (b, h) the m chain (thread 0, in order, the next eight
// steps loaded ahead), lf', i', w and the prefix sums of lf' (a scan);
// blocks `chains` .. take four rows (b, t, h) each, a warp summing dh.h in
// f64 over P.
__global__ void __launch_bounds__(GATE_THREADS)
mlstm_bwd_gates_kernel(const Args a, int chains, int rows) {
  const int tid = threadIdx.x;
  if (static_cast<int>(blockIdx.x) >= chains) {
    const int warp = tid / 32, lane = tid % 32;
    const int row = (blockIdx.x - chains) * GATE_WARPS + warp;
    if (row >= rows) return;
    const float* x = a.dh + static_cast<size_t>(row) * a.P;
    const float* y = a.h + static_cast<size_t>(row) * a.P;
    double s = 0.0;
    for (int p = lane; p < a.P; p += 32)
      s = fma(static_cast<double>(__ldg(x + p)),
              static_cast<double>(__ldg(y + p)), s);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) {
      const int hh = row % a.H, t = (row / a.H) % a.S;
      const int bi = row / (a.H * a.S);
      a.hd[(static_cast<size_t>(bi) * a.H + hh) * a.S + t] = s;
    }
    return;
  }
  __shared__ float lf[SEG], ii[SEG], m[SEG + 1];
  __shared__ double ws[GATE_WARPS];
  const int bi = blockIdx.x / a.H, hh = blockIdx.x % a.H;
  const size_t o = static_cast<size_t>(blockIdx.x) * a.S;
  float run = M0;    // thread 0's stabiliser
  double G = 0.0;    // the prefix sum before the segment
  for (int t0 = 0; t0 < a.S; t0 += SEG) {
    const int n = min(SEG, a.S - t0), n8 = (n + 7) / 8 * 8;
    for (int j = tid; j < n8; j += GATE_THREADS) {
      const size_t gi = (static_cast<size_t>(bi) * a.S + t0 + j) * a.H + hh;
      const float fr = j < n ? a.f_pre[gi] : 0.f;
      lf[j] = j < n ? fminf(fr, 0.f) - log1pf(expf(-fabsf(fr))) : 0.f;
      ii[j] = j < n ? a.i_pre[gi] : M0;   // padding leaves m as it is
    }
    __syncthreads();
    if (tid == 0) {
      m[0] = run;
      float l8[8], i8[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        l8[u] = lf[u];
        i8[u] = ii[u];
      }
      for (int j0 = 0; j0 < n8; j0 += 8) {
        float ln[8], in[8];   // the next eight, loaded ahead of the chain
        const int jn = j0 + 8 < n8 ? j0 + 8 : j0;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          ln[u] = lf[jn + u];
          in[u] = ii[jn + u];
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          run = fmaxf(l8[u] + run, i8[u]);
          m[j0 + u + 1] = run;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          l8[u] = ln[u];
          i8[u] = in[u];
        }
      }
    }
    __syncthreads();
    for (int j = tid; j < n; j += GATE_THREADS) {
      const float e = lf[j] + m[j], mn = m[j + 1];
      a.iota[o + t0 + j] = ii[j] - mn;
      a.wsel[o + t0 + j] = e > ii[j] ? 1.f : e == ii[j] ? 0.5f : 0.f;
      lf[j] = e - mn;
    }
    __syncthreads();
    const int lo = PER * tid, hi = min(lo + PER, n);
    double part = 0.0;
    for (int j = lo; j < hi; ++j)
      if (t0 + j > 0) part += lf[j];
    double total;
    double run_g = G + earlier_sum(part, ws, total);
    for (int j = lo; j < hi; ++j) {
      if (t0 + j > 0) run_g += lf[j];
      a.G[o + t0 + j] = run_g;
    }
    G += total;
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Launch 2: the scores of one 64 x 64 tile (rows t0 .., columns s0 ..) of
// a pair block: four warps of 32 x 32, each 2 x 4 m16n8k8 f64 products
// per k-step of 8 (a fragment loaded feeds two or four products), over P
// in k-tiles of KT: copied as f32 by cp.async into a ring of two while the
// tile before is staged as f64 and multiplied.  The tile above the
// diagonal of a diagonal block is zero.
struct ScoreSmem {
  float raw[2][2][ST * KT];   // the ring: q's and k's k-tiles as they lie
  double q[ST][LDS64];
  double k[ST][LDS64];
  double part[2][ST];
  double Gt[ST], Gs[ST];
  float io[ST];
};

__global__ void __launch_bounds__(S_THREADS, 3)
mlstm_bwd_scores_kernel(const Args a, int per_cell) {
  extern __shared__ __align__(16) unsigned char smem[];
  ScoreSmem& s = *reinterpret_cast<ScoreSmem*>(smem);
  const int cell = blockIdx.x / per_cell, idx = blockIdx.x % per_cell;
  int bt, bs;
  tri(idx / 4, bt, bs);
  const int t0 = bt * TILE + ST * ((idx % 4) / 2);
  const int s0 = bs * TILE + ST * (idx % 2);
  const int bi = cell / a.H, hh = cell % a.H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int wr = 32 * (warp / 2), wc = 32 * (warp % 2);
  float* wmb = a.wm + plane(a, cell) + static_cast<size_t>(t0) * a.SP + s0;
  float* scb = a.sc + plane(a, cell) + static_cast<size_t>(t0) * a.SP + s0;
  if (s0 > t0) {   // above the diagonal: D and S zero
    for (int i = tid; i < ST * ST / 4; i += S_THREADS) {
      const size_t off = static_cast<size_t>(i / (ST / 4)) * a.SP +
                         4 * (i % (ST / 4));
      *reinterpret_cast<float4*>(wmb + off) = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(scb + off) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  const size_t o = static_cast<size_t>(cell) * a.S;
  if (tid < ST) {
    s.Gt[tid] = t0 + tid < a.S ? a.G[o + t0 + tid] : 0.0;
    s.Gs[tid] = s0 + tid < a.S ? a.G[o + s0 + tid] : 0.0;
    s.io[tid] = s0 + tid < a.S ? a.iota[o + s0 + tid] : M0;
  }
  const size_t rstride = static_cast<size_t>(a.H) * a.P;
  const float* qb = a.q + at(a, bi, hh) + t0 * rstride;
  const float* kb = a.k + at(a, bi, hh) + s0 * rstride;
  auto copy = [&](int j0, int ring) {
    copy_tile<S_THREADS>(s.raw[ring][0], qb + j0, rstride, ST, KT, a.S - t0,
                         a.P - j0, a.vec, a.q);
    copy_tile<S_THREADS>(s.raw[ring][1], kb + j0, rstride, ST, KT, a.S - s0,
                         a.P - j0, a.vec, a.k);
  };
  // Thread i = tid + 128 u stages row i / 8, floats 4 (i % 8) .. as f64,
  // its two pairs in the order that puts a quarter warp's 16-byte stores
  // on 32 distinct banks.
  auto stage = [&](double (*dst)[LDS64], const float* raw) {
#pragma unroll
    for (int u = 0; u < ST * KT / 4 / S_THREADS; ++u) {
      const int i = tid + S_THREADS * u, r = i / 8, c4 = i % 8;
      const float4 x = *reinterpret_cast<const float4*>(raw + r * KT + 4 * c4);
      const double2 lo = make_double2(x.x, x.y), hi = make_double2(x.z, x.w);
      double2* p = reinterpret_cast<double2*>(&dst[r][4 * c4]);
      const int first = (c4 >> 2) & 1;   // the pair stored first
      p[first] = first ? hi : lo;
      p[1 - first] = first ? lo : hi;
    }
  };
  // acc[i][j][e]: row wr + 8 i + g, column wc + 8 j + 2 tig + e.
  double acc[4][4][2] = {};
  const int nk = (a.P + KT - 1) / KT;
  copy(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) copy((kt + 1) * KT, (kt + 1) % 2);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();   // k-tile kt landed; the products before are done
    stage(s.q, s.raw[kt % 2][0]);
    stage(s.k, s.raw[kt % 2][1]);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KT; kk += 8) {
      double fa[2][4], fb[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wr + 16 * i + g;
        fa[i][0] = s.q[r][kk + tig];
        fa[i][1] = s.q[r + 8][kk + tig];
        fa[i][2] = s.q[r][kk + tig + 4];
        fa[i][3] = s.q[r + 8][kk + tig + 4];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        fb[j][0] = s.k[wc + 8 * j + g][kk + tig];
        fb[j][1] = s.k[wc + 8 * j + g][kk + tig + 4];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          asm volatile(
              "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
              "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
              : "+d"(acc[2 * i][j][0]), "+d"(acc[2 * i][j][1]),
                "+d"(acc[2 * i + 1][j][0]), "+d"(acc[2 * i + 1][j][1])
              : "d"(fa[i][0]), "d"(fa[i][1]), "d"(fa[i][2]), "d"(fa[i][3]),
                "d"(fb[j][0]), "d"(fb[j][1]));
    }
  }
  // D_ts = e^{i'_s + (G_t - G_s)} where s <= t < S, else 0; D S summed over
  // the thread's columns, then its row's four lanes, then the two warps.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = wr + 8 * i + g, t = t0 + r;
    const double gt = s.Gt[r];
    double rs = 0.0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = wc + 8 * j + 2 * tig;
      float dw[2], sv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool vis = s0 + c + e <= t && t < a.S;
        const double x = static_cast<double>(s.io[c + e]) + (gt - s.Gs[c + e]);
        const double D = exp(vis ? x : -1e300);
        rs += D * acc[i][j][e];
        dw[e] = static_cast<float>(D);
        sv[e] = static_cast<float>(acc[i][j][e]);
      }
      const size_t off = static_cast<size_t>(r) * a.SP + c;
      *reinterpret_cast<float2*>(wmb + off) = make_float2(dw[0], dw[1]);
      *reinterpret_cast<float2*>(scb + off) = make_float2(sv[0], sv[1]);
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    if (tig == 0) s.part[warp % 2][r] = rs;
  }
  __syncthreads();
  if (tid < ST)
    a.dpart[(static_cast<size_t>(cell) * a.SP + t0 + tid) * (a.SP / ST) +
            s0 / ST] = s.part[0][tid] + s.part[1][tid];
}

// ---------------------------------------------------------------------------
// Launch 3: per step t of each (b, h), padded steps included, d_t (the
// tiles' row sums, lowest tile first), den_t and dd_t.
__global__ void __launch_bounds__(ROW_THREADS)
mlstm_bwd_rows_kernel(const Args a, int count) {
  const int i = blockIdx.x * ROW_THREADS + threadIdx.x;
  if (i >= count) return;
  const int cell = i / a.SP, t = i % a.SP;
  float den = 1.f, dd = 0.f;
  if (t < a.S) {
    const double* part = a.dpart + static_cast<size_t>(i) * (a.SP / ST);
    double d = 0.0;
    for (int j = 0; j <= t / ST; ++j) d += part[j];
    const double hd = a.hd[static_cast<size_t>(cell) * a.S + t];
    const double ad = fabs(d);
    const bool clamp = ad < 1.0;
    den = clamp ? 1.f : static_cast<float>(ad);
    dd = clamp ? 0.f
               : static_cast<float>(-(hd / den) * (d > 0.0 ? 1.0 : -1.0));
  }
  a.den[i] = den;
  a.dd[i] = dd;
}

// ---------------------------------------------------------------------------
// Launch 4: per 128 x 128 block of pairs (rows t0 .., columns s0 ..) X =
// dnum.V^T over P, staged in shared memory; then warp w takes rows w, w +
// 8, .., lane l columns 4 l .. 4 l + 3: per pair M = (X + dd_t) D, W o S =
// D S and dl = M S in f64; a row's sum of dl over the thread's four
// columns, then the warp's lanes; a column's over the thread's rows, then
// the eight warps in order.
struct PairExtra {
  float den[TILE];
  float dd[TILE];
  double colp[THREADS / 32][TILE];
};

constexpr int PAIR_BYTES = 1024 + PIPE + sizeof(PairExtra);
constexpr int LDX = TILE + 8;   // row stride of the staged X: a half warp's
                               // 8-byte stores meet 32 banks

__global__ void __launch_bounds__(THREADS, 2)
mlstm_bwd_pairs_kernel(const Args a, int per_cell) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* pipe = pipe_of(smem);
  PairExtra& x = *reinterpret_cast<PairExtra*>(pipe + PIPE);
  const int cell = blockIdx.x / per_cell;
  int bt, bs;
  tri(blockIdx.x % per_cell, bt, bs);
  const int t0 = bt * TILE, s0 = bs * TILE;
  const int bi = cell / a.H, hh = cell % a.H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid < TILE) {
    x.den[tid] = a.den[static_cast<size_t>(cell) * a.SP + t0 + tid];
    x.dd[tid] = a.dd[static_cast<size_t>(cell) * a.SP + t0 + tid];
  }
  const size_t rstride = static_cast<size_t>(a.H) * a.P;
  const float* dhb = a.dh + at(a, bi, hh) + t0 * rstride;
  const float* vb = a.v + at(a, bi, hh) + s0 * rstride;
  auto copy = [&](int t, float* stage) {
    const int j0 = t * KW;
    copy_rows(stage, dhb + j0, rstride, a.S - t0, a.P - j0, a.vec, a.dh);
    copy_rows(stage + TILE * KW, vb + j0, rstride, a.S - s0, a.P - j0, a.vec,
              a.v);
  };
  auto split = [&](int, const float* stage, uint8_t* buf) {
    put_rows(buf, stage, [&](int r, float v) { return v / x.den[r]; });
    put_rows(buf + 2 * PLANE, stage + TILE * KW, Same{});
  };
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  int it = 0;
  gemm(acc, pipe, (a.P + KW - 1) / KW, it, copy, split);
  __syncthreads();   // every warpgroup's products are done: the pipe is free
  float* X = reinterpret_cast<float*>(pipe);
  {
    const int r0 = 64 * (warp / 4) + 16 * (warp % 4) + lane / 4;
    const int c0 = 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(X + (r0 + 8 * h) * LDX + 8 * j + c0) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
  __syncthreads();

  float* wmb = a.wm + plane(a, cell) + static_cast<size_t>(t0) * a.SP + s0;
  float* scb = a.sc + plane(a, cell) + static_cast<size_t>(t0) * a.SP + s0;
  const int c = 4 * lane;
  double cs[4] = {0.0, 0.0, 0.0, 0.0};
  for (int r = warp; r < TILE; r += THREADS / 32) {
    const size_t off = static_cast<size_t>(r) * a.SP + c;
    const float4 xv = *reinterpret_cast<const float4*>(X + r * LDX + c);
    const float4 w = *reinterpret_cast<const float4*>(wmb + off);
    const float4 sv = *reinterpret_cast<const float4*>(scb + off);
    const float dd = x.dd[r];
    const float4 m = make_float4((xv.x + dd) * w.x, (xv.y + dd) * w.y,
                                 (xv.z + dd) * w.z, (xv.w + dd) * w.w);
    *reinterpret_cast<float4*>(wmb + off) = m;
    *reinterpret_cast<float4*>(scb + off) =
        make_float4(w.x * sv.x, w.y * sv.y, w.z * sv.z, w.w * sv.w);
    const double l[4] = {
        static_cast<double>(m.x) * static_cast<double>(sv.x),
        static_cast<double>(m.y) * static_cast<double>(sv.y),
        static_cast<double>(m.z) * static_cast<double>(sv.z),
        static_cast<double>(m.w) * static_cast<double>(sv.w)};
    double rs = 0.0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      rs += l[e];
      cs[e] += l[e];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o);
    if (lane == 0)
      a.rpart[(static_cast<size_t>(cell) * a.SP + t0 + r) * a.nb + bs] = rs;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) x.colp[warp][c + e] = cs[e];
  __syncthreads();
  if (tid < TILE) {
    double col = 0.0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) col += x.colp[w][tid];
    a.cpart[(static_cast<size_t>(cell) * a.SP + s0 + tid) * a.nb + bt] = col;
  }
}

// ---------------------------------------------------------------------------
// Launch 5: one 128 x 128 tile (rows .., columns p0 .. of P) of dq, dk or
// dv; warpgroup wg takes rows 64 wg ...  Blocks run longest first: index
// i's level i / (3 cells tiles) has nb - level blocks of 128 along k; at
// each level the three products, then the cells, then the tiles of P.
//   dq, rows t of block nb - level - 1: M rows (K-major as they lie)
//       against K, transposed, over s below the block's end;
//   dk, rows s of block `level`: M^T against Q, both transposed, over t
//       from the block on; dv the same with W o S and dnum = dh / den.
constexpr int PRODUCT_BYTES = 1024 + PIPE;

__global__ void __launch_bounds__(THREADS, 2)
mlstm_bwd_products_kernel(const Args a, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* pipe = pipe_of(smem);
  const int cells = gridDim.x / (3 * tiles * a.nb);
  const int per_level = 3 * cells * tiles;
  const int level = blockIdx.x / per_level;
  const int rem = blockIdx.x % per_level;
  const int kind = rem / (cells * tiles);
  const int cell = (rem / tiles) % cells, pt = rem % tiles;
  const int blocks = a.nb - level;        // k extent in blocks of 128
  const int bi = cell / a.H, hh = cell % a.H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int p0 = pt * TILE;
  const size_t rstride = static_cast<size_t>(a.H) * a.P;
  const float* mb = a.wm + plane(a, cell);
  const float* wsb = a.sc + plane(a, cell);
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  int it = 0;
  int row0;      // first output row
  float* out;
  if (kind == 0) {   // dq = M.K
    row0 = (blocks - 1) * TILE;
    out = a.dq;
    const float* kb = a.k + at(a, bi, hh) + p0;
    auto copy = [&](int t, float* stage) {
      const int s = t * KW;
      copy_rows(stage, mb + static_cast<size_t>(row0) * a.SP + s, a.SP, TILE,
                KW, true, mb);
      copy_cols(stage + TILE * KW, kb + s * rstride, rstride, a.S - s,
                a.P - p0, a.vec, a.k);
    };
    auto split = [&](int, const float* stage, uint8_t* buf) {
      float x8[8];
      put_rows(buf, stage, Same{});
      put_transposed(buf + 2 * PLANE, stage + TILE * KW, Same{}, x8);
    };
    gemm(acc, pipe, blocks * TILE / KW, it, copy, split);
  } else {           // dk = M^T.Q, dv = (W o S)^T.dnum
    row0 = level * TILE;
    out = kind == 1 ? a.dk : a.dv;
    const float* ab = kind == 1 ? mb : wsb;
    const float* bsrc = kind == 1 ? a.q : a.dh;
    const float* bb = bsrc + at(a, bi, hh) + p0;
    const float* den = kind == 1 ? nullptr
                                 : a.den + static_cast<size_t>(cell) * a.SP;
    auto copy = [&](int t, float* stage) {
      const int tt = row0 + t * KW;
      copy_cols(stage, ab + static_cast<size_t>(tt) * a.SP + row0, a.SP, KW,
                TILE, true, ab);
      copy_cols(stage + TILE * KW, bb + tt * rstride, rstride, a.S - tt,
                a.P - p0, a.vec, bsrc);
    };
    auto split = [&](int t, const float* stage, uint8_t* buf) {
      const float* dt = den ? den + row0 + t * KW : nullptr;
      float x8[8];
      put_transposed(buf, stage, Same{}, x8);
      put_transposed(buf + 2 * PLANE, stage + TILE * KW,
                     [&](int k, float v) { return dt ? v / __ldg(dt + k) : v; },
                     x8);
    };
    gemm(acc, pipe, blocks * TILE / KW, it, copy, split);
  }
  const int r0 = 64 * (warp / 4) + 16 * (warp % 4) + lane / 4;
  const int c0 = 2 * (lane % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + r0 + 8 * h;
    if (r >= a.S) continue;
    float* orow = out + at(a, bi, hh) + r * rstride;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int p = p0 + 8 * j + c0;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (a.vec) {
        if (p < a.P) *reinterpret_cast<float2*>(orow + p) = make_float2(v0, v1);
      } else {
        if (p < a.P) orow[p] = v0;
        if (p + 1 < a.P) orow[p + 1] = v1;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launch 6: per (b, h), the blocks' row and column sums of dl added lowest
// block first, then backwards over t, segment by segment: the m chain's
// adjoint c_t = w_t G_t, G_t = c_{t+1} - rowsum_t (a scan of the maps c ->
// w_t (c - rowsum_t)), d lf' the sum over t >= u of rowsum - colsum (a
// scan), d i_pre and d f_pre.
__global__ void __launch_bounds__(GATE_THREADS)
mlstm_bwd_gate_grads_kernel(const Args a) {
  __shared__ double rsum[SEG], csum[SEG];
  __shared__ float w[SEG];
  __shared__ double wa[GATE_WARPS], wb[GATE_WARPS], carry[2];
  const int tid = threadIdx.x, bi = blockIdx.x / a.H, hh = blockIdx.x % a.H;
  const size_t o = static_cast<size_t>(blockIdx.x) * a.S;
  const size_t po = static_cast<size_t>(blockIdx.x) * a.SP;
  double c_in = 0.0, q_in = 0.0;   // c and d lf' after the segment
  for (int end = a.S; end > 0; end -= SEG) {
    const int t0 = max(0, end - SEG), n = end - t0;
    for (int j = tid; j < n; j += GATE_THREADS) {
      const int t = t0 + j;
      const double* rp = a.rpart + (po + t) * a.nb;
      const double* cp = a.cpart + (po + t) * a.nb;
      double r = 0.0, c = 0.0;
      for (int blk = 0; blk <= t / TILE; ++blk) r += rp[blk];
      for (int blk = t / TILE; blk < a.nb; ++blk) c += cp[blk];
      rsum[j] = r;
      csum[j] = c;
      w[j] = a.wsel[o + t];
    }
    __syncthreads();
    const int lo = PER * tid, hi = min(lo + PER, n);
    Affine f{1.0, 0.0};
    double part = 0.0;
    for (int j = hi - 1; j >= lo; --j) {
      f = {w[j] * f.A, w[j] * (f.B - rsum[j])};
      part += rsum[j] - csum[j];
    }
    const Affine later = later_map(f, wa, wb);
    double c = later.A * c_in + later.B;
    double quad = q_in + later_sum(part, wa);
    for (int j = hi - 1; j >= lo; --j) {
      const double gm = c - rsum[j];
      quad += rsum[j] - csum[j];
      const size_t gi = (static_cast<size_t>(bi) * a.S + t0 + j) * a.H + hh;
      const float fr = a.f_pre[gi], z = expf(-fabsf(fr));
      const float sig = fr < 0.f ? 1.f / (1.f + z) : z / (1.f + z);
      a.df[gi] = static_cast<float>(quad + w[j] * gm) * sig;
      a.di[gi] = static_cast<float>(csum[j] + (1.0 - w[j]) * gm);
      c = w[j] * gm;
    }
    if (tid == 0) {
      carry[0] = c;
      carry[1] = quad;
    }
    __syncthreads();
    c_in = carry[0];
    q_in = carry[1];
    __syncthreads();
  }
}

// The scratch's regions, each rounded up to 256 bytes.
struct Layout {
  size_t G, hd, rpart, cpart, dpart, iota, wsel, den, dd, sc, wm, bytes;
};

size_t up256(size_t n) { return (n + 255) / 256 * 256; }

Layout layout(int b, int S, int H) {
  const size_t n = static_cast<size_t>(b) * S * H;
  const size_t SP = (static_cast<size_t>(S) + TILE - 1) / TILE * TILE;
  const size_t np = static_cast<size_t>(b) * H * SP;   // padded steps
  Layout l;
  l.G = 0;
  l.hd = l.G + up256(n * 8);
  l.rpart = l.hd + up256(n * 8);
  l.cpart = l.rpart + up256(np * (SP / TILE) * 8);
  l.dpart = l.cpart + up256(np * (SP / TILE) * 8);
  l.iota = l.dpart + up256(np * (SP / ST) * 8);
  l.wsel = l.iota + up256(n * 4);
  l.den = l.wsel + up256(n * 4);
  l.dd = l.den + up256(np * 4);
  l.sc = l.dd + up256(np * 4);
  l.wm = l.sc + up256(np * SP * 4);
  l.bytes = l.wm + up256(np * SP * 4);
  return l;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// Bytes of scratch a call needs: O(S) per (b, h) for the gates and the
// partial sums, and 2 SP^2 floats (SP: S rounded up to 128) for D, the
// scores, M and W o S.
extern "C" long long mlstm_scan_bwd_sm90_scratch_bytes(int b, int S, int H) {
  return static_cast<long long>(layout(b, S, H).bytes);
}

// Launches the six phases on `stream` of the current device, checking each
// launch, and returns the first CUDA error (0 on success).  dh, q, k, v, h
// (the forward's output), dq, dk and dv are (b, S, H, P), i_pre, f_pre, di
// and df (b, S, H), all contiguous float32; `scratch` holds
// mlstm_scan_bwd_sm90_scratch_bytes(b, S, H) bytes, 256-byte aligned.  The
// caller checks shapes, 1 <= P <= 512, b, S, H >= 1 and every size below
// 2**31.
extern "C" int mlstm_scan_bwd_sm90_f32(
    const void* dh, const void* q, const void* k, const void* v,
    const void* i_pre, const void* f_pre, const void* h, void* dq, void* dk,
    void* dv, void* di, void* df, void* scratch, int b, int S, int H, int P,
    void* stream) {
  if (P < 1 || P > PMAX) return static_cast<int>(cudaErrorInvalidValue);
  const Layout l = layout(b, S, H);
  uint8_t* base = static_cast<uint8_t*>(scratch);
  Args a;
  a.dh = static_cast<const float*>(dh);
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.i_pre = static_cast<const float*>(i_pre);
  a.f_pre = static_cast<const float*>(f_pre);
  a.h = static_cast<const float*>(h);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.di = static_cast<float*>(di);
  a.df = static_cast<float*>(df);
  a.G = reinterpret_cast<double*>(base + l.G);
  a.hd = reinterpret_cast<double*>(base + l.hd);
  a.rpart = reinterpret_cast<double*>(base + l.rpart);
  a.cpart = reinterpret_cast<double*>(base + l.cpart);
  a.dpart = reinterpret_cast<double*>(base + l.dpart);
  a.iota = reinterpret_cast<float*>(base + l.iota);
  a.wsel = reinterpret_cast<float*>(base + l.wsel);
  a.den = reinterpret_cast<float*>(base + l.den);
  a.dd = reinterpret_cast<float*>(base + l.dd);
  a.sc = reinterpret_cast<float*>(base + l.sc);
  a.wm = reinterpret_cast<float*>(base + l.wm);
  a.S = S;
  a.H = H;
  a.P = P;
  a.SP = (S + TILE - 1) / TILE * TILE;
  a.nb = a.SP / TILE;
  a.vec = P % 4 == 0 &&
          ((reinterpret_cast<uintptr_t>(dh) | reinterpret_cast<uintptr_t>(q) |
            reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v) |
            reinterpret_cast<uintptr_t>(dq) | reinterpret_cast<uintptr_t>(dk) |
            reinterpret_cast<uintptr_t>(dv)) &
           15) == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if ((err = allow_smem(mlstm_bwd_scores_kernel, sizeof(ScoreSmem))) !=
          cudaSuccess ||
      (err = allow_smem(mlstm_bwd_pairs_kernel, PAIR_BYTES)) != cudaSuccess ||
      (err = allow_smem(mlstm_bwd_products_kernel, PRODUCT_BYTES)) !=
          cudaSuccess)
    return static_cast<int>(err);
  const int cells = b * H, blocks = a.nb * (a.nb + 1) / 2;
  const int rows = b * S * H, per = GATE_THREADS / 32;
  const int tiles = (P + TILE - 1) / TILE;
  mlstm_bwd_gates_kernel<<<cells + (rows + per - 1) / per, GATE_THREADS, 0,
                           st>>>(a, cells, rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  mlstm_bwd_scores_kernel<<<cells * blocks * 4, S_THREADS, sizeof(ScoreSmem),
                            st>>>(a, blocks * 4);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int padded = cells * a.SP;
  mlstm_bwd_rows_kernel<<<(padded + ROW_THREADS - 1) / ROW_THREADS,
                          ROW_THREADS, 0, st>>>(a, padded);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  mlstm_bwd_pairs_kernel<<<cells * blocks, THREADS, PAIR_BYTES, st>>>(a,
                                                                      blocks);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  mlstm_bwd_products_kernel<<<3 * cells * tiles * a.nb, THREADS,
                              PRODUCT_BYTES, st>>>(a, tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  mlstm_bwd_gate_grads_kernel<<<cells, GATE_THREADS, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of launch `phase` (2: scores, 4: pairs, 5:
// products); 0 otherwise.
extern "C" int mlstm_scan_bwd_sm90_smem_bytes(int phase) {
  switch (phase) {
    case 2:
      return static_cast<int>(sizeof(ScoreSmem));
    case 4:
      return PAIR_BYTES;
    case 5:
      return PRODUCT_BYTES;
    default:
      return 0;
  }
}

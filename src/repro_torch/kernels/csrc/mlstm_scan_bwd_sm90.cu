// Backward of the stabilised mLSTM scan for Hopper (sm_90a): f32 in and
// out, the scores' row sums and every exponent in f64, the products in f32
// on the CUDA cores.
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
// and a chunkwise backward would carry its adjoint from chunk to chunk
// (S P^2 operations a product against S^2 P / 2 for the pairs), so at
// xlstm-1.3b's training length (S = 512 = P) the quadratic form does less
// work and keeps nothing but per-step scalars.  It grows as S^2: past S = 2
// P a chunked form with a tiled state carry would do less.  Four launches:
//   1. gates: per (b, h) the m chain in the forward's order and rounding,
//      lf', i', w and the f64 prefix sums of lf';
//   2. rows: per (b, h, 16 steps t) the f64 sum d_t over s <= t (scores in
//      f64, as the forward takes them), den_t, dd_t; then per pair dnum.v,
//      q.k, dA D, dq_t and rowsum_t;
//   3. columns: per (b, h, 16 steps s) the same pair terms over t >= s, dk_s,
//      dv_s and colsum_s;
//   4. gate gradients: per (b, h) the sums and the m chain backwards.
// The exp is taken only for s <= t, where its exponent is <= 0.  No
// atomics: every sum has one order, and two launches give the same bits.
//
// At xlstm-1.3b's training shape (b 4, S 512, H 4, P 512) the pairs take
// seven products of S^2 P / 2 multiply-adds per (b, h) in f32 and one in f64
// (the scores of d), 15 GFLOP and 2.1 GFLOP on the CUDA cores, against 134
// MB of inputs and outputs: operations bound it.  A first version: the tensor cores (TF32x3 or f64 mma, as the
// forward's) are what would make it fast.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr float M0 = -1e30f;        // the stabiliser before the first step
constexpr int PMAX = 512;
constexpr int PC = 64;              // P per staged chunk
constexpr int NPC = PMAX / PC;
constexpr int LDC = PC + 1;         // row stride of a staged chunk
constexpr int LDR = PMAX + 1;       // row stride of the whole-P rows
constexpr int RT = 16;              // steps t of a row-pass block
constexpr int CT = 16;              // steps s of a column-pass block
constexpr int TS = 32;              // steps of a staged tile
constexpr int LANES = THREADS / 16; // 16 lanes per row or column
constexpr int SEG = 1024;           // gate steps per shared segment
constexpr int GATE_THREADS = 128;

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
  float* den;      // (b, H, S): max(|d_t|, 1)
  float* dd;       // (b, H, S): the gradient of d_t
  double* rowsum;  // (b, H, S)
  double* colsum;  // (b, H, S)
  int S, H, P, PT;
};

using Chunk = float[LDC];
using Row = float[LDR];

struct RowSmem {
  Row q[RT], n[RT];     // the block's rows of q and of dnum
  Chunk kt[TS], vt[TS]; // staged chunks of k and v
  float M[RT][TS + 1];  // dA D of a tile
  double Gt[RT], Gs[TS];
  float ios[TS], dd[RT], den[RT];
};

struct ColSmem {
  Row k[CT], v[CT];     // the block's rows of k and v
  Chunk qt[TS], nt[TS]; // staged chunks of q and dnum
  float E1[CT][TS + 1], E2[CT][TS + 1];
  double Gs[CT], Gt[TS];
  float ios[CT], dd[TS], den[TS];
};

__device__ __forceinline__ size_t seq(const Args& a, int bi, int hh) {
  return (static_cast<size_t>(bi) * a.H + hh) * a.S;
}

__device__ __forceinline__ size_t at(const Args& a, int bi, int hh) {
  return (static_cast<size_t>(bi) * a.S * a.H + hh) * a.P;
}

// A TS x PC chunk of steps [r0, r0 + TS) and columns [pc, pc + PC) of a
// (b, S, H, P) operand at (bi, 0, hh, 0), zero-padded, each element divided
// by scale[row] where scale is given.
__device__ void stage(Chunk* dst, const float* base, size_t stride, int r0,
                      int S, int pc, int P, const float* scale) {
  for (int i = threadIdx.x; i < TS * PC; i += THREADS) {
    const int r = i / PC, c = i % PC, t = r0 + r, p = pc + c;
    float x = 0.f;
    if (t < S && p < P) {
      x = base[t * stride + p];
      if (scale) x = x / scale[r];
    }
    dst[r][c] = x;
  }
}

// Whole rows [r0, r0 + rows) of a (b, S, H, P) operand, zero-padded to PT.
__device__ void whole(Row* dst, const float* base, size_t stride, int r0,
                      int rows, int S, int P, int PT) {
  for (int i = threadIdx.x; i < rows * PT; i += THREADS) {
    const int r = i / PT, p = i % PT, t = r0 + r;
    dst[r][p] = t < S && p < P ? base[t * stride + p] : 0.f;
  }
}

__device__ __forceinline__ double sum16(double x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float weight(double io, double gt, double gs) {
  return static_cast<float>(exp(io + (gt - gs)));
}

// Launch 1: the m chain, lf', i', w and the prefix sums of lf'.
__global__ void __launch_bounds__(GATE_THREADS)
mlstm_bwd_gates_kernel(const Args a) {
  __shared__ float lf[SEG], ii[SEG], m[SEG + 1];
  const int tid = threadIdx.x, bi = blockIdx.x / a.H, hh = blockIdx.x % a.H;
  const size_t o = seq(a, bi, hh);
  float run = M0;    // thread 0's stabiliser
  double G = 0.0;    // thread 0's prefix sum
  for (int t0 = 0; t0 < a.S; t0 += SEG) {
    const int n = min(SEG, a.S - t0);
    for (int j = tid; j < n; j += GATE_THREADS) {
      const size_t gi = (static_cast<size_t>(bi) * a.S + t0 + j) * a.H + hh;
      const float fr = a.f_pre[gi];
      lf[j] = fminf(fr, 0.f) - log1pf(expf(-fabsf(fr)));
      ii[j] = a.i_pre[gi];
    }
    __syncthreads();
    if (tid == 0) {
      m[0] = run;
      for (int j = 0; j < n; ++j) {
        run = fmaxf(lf[j] + run, ii[j]);
        m[j + 1] = run;
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
    if (tid == 0)
      for (int j = 0; j < n; ++j) {
        if (t0 + j > 0) G += lf[j];
        a.G[o + t0 + j] = G;
      }
    __syncthreads();
  }
}

// Launch 2: per (b, h, RT steps t): d_t, den_t, dd_t, dq_t and rowsum_t.
__global__ void __launch_bounds__(THREADS, 2)
mlstm_bwd_rows_kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t raw[];
  RowSmem& s = *reinterpret_cast<RowSmem*>(raw);
  const int tid = threadIdx.x, r = tid / LANES, j = tid % LANES;
  const int t0 = blockIdx.x * RT, hh = blockIdx.y, bi = blockIdx.z;
  const int t = t0 + r, s_end = min(t0 + RT, a.S);
  const size_t o = seq(a, bi, hh), x0 = at(a, bi, hh);
  const size_t hp = static_cast<size_t>(a.H) * a.P;
  whole(s.q, a.q + x0, hp, t0, RT, a.S, a.P, a.PT);
  if (tid < RT) s.Gt[tid] = t0 + tid < a.S ? a.G[o + t0 + tid] : 0.0;

  // d_t = sum_{s<=t} D_ts (q_t.k_s), the scores and the sum in f64.
  double d = 0.0;
  for (int s0 = 0; s0 < s_end; s0 += TS) {
    __syncthreads();
    if (tid < TS) {
      const int ss = s0 + tid;
      s.Gs[tid] = ss < a.S ? a.G[o + ss] : 0.0;
      s.ios[tid] = ss < a.S ? a.iota[o + ss] : M0;
    }
    double acc[2] = {0.0, 0.0};
    for (int pc = 0; pc < a.PT; pc += PC) {
      __syncthreads();
      stage(s.kt, a.k + x0, hp, s0, a.S, pc, a.P, nullptr);
      __syncthreads();
      for (int pp = 0; pp < PC; ++pp) {
        const double qv = s.q[r][pc + pp];
#pragma unroll
        for (int c = 0; c < 2; ++c)
          acc[c] = fma(qv, static_cast<double>(s.kt[j + 16 * c][pp]), acc[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int ss = s0 + j + 16 * c;
      if (ss <= t && t < a.S)
        d += exp(static_cast<double>(s.ios[j + 16 * c]) +
                 (s.Gt[r] - s.Gs[j + 16 * c])) * acc[c];
    }
  }
  d = sum16(d);
  double hd = 0.0;
  if (t < a.S)
    for (int p = j; p < a.P; p += LANES)
      hd += static_cast<double>(a.dh[x0 + t * hp + p]) *
            static_cast<double>(a.h[x0 + t * hp + p]);
  hd = sum16(hd);
  if (j == 0) {
    const double ad = fabs(d);
    const bool clamp = ad < 1.0;
    const float den = clamp ? 1.f : static_cast<float>(ad);
    const float dd = clamp ? 0.f
                           : static_cast<float>(-(hd / den) *
                                                (d > 0.0 ? 1.0 : -1.0));
    s.den[r] = den;
    s.dd[r] = dd;
    if (t < a.S) {
      a.den[o + t] = den;
      a.dd[o + t] = dd;
    }
  }
  __syncthreads();
  for (int i = tid; i < RT * a.PT; i += THREADS) {
    const int rr = i / a.PT, p = i % a.PT, tt = t0 + rr;
    s.n[rr][p] = tt < a.S && p < a.P ? a.dh[x0 + tt * hp + p] / s.den[rr]
                                     : 0.f;
  }

  // Per pair dA D, its row sums with q.k, and dq_t = sum_s dA D k_s.
  float dq[NPC * 4];
#pragma unroll
  for (int i = 0; i < NPC * 4; ++i) dq[i] = 0.f;
  double rs = 0.0;
  for (int s0 = 0; s0 < s_end; s0 += TS) {
    __syncthreads();
    if (tid < TS) {
      const int ss = s0 + tid;
      s.Gs[tid] = ss < a.S ? a.G[o + ss] : 0.0;
      s.ios[tid] = ss < a.S ? a.iota[o + ss] : M0;
    }
    float sc[2] = {0.f, 0.f}, x[2] = {0.f, 0.f};
    for (int pc = 0; pc < a.PT; pc += PC) {
      __syncthreads();
      stage(s.kt, a.k + x0, hp, s0, a.S, pc, a.P, nullptr);
      stage(s.vt, a.v + x0, hp, s0, a.S, pc, a.P, nullptr);
      __syncthreads();
      for (int pp = 0; pp < PC; ++pp) {
        const float qv = s.q[r][pc + pp], nv = s.n[r][pc + pp];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          sc[c] = fmaf(qv, s.kt[j + 16 * c][pp], sc[c]);
          x[c] = fmaf(nv, s.vt[j + 16 * c][pp], x[c]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int ss = s0 + j + 16 * c;
      const float w = ss <= t && t < a.S
                          ? weight(s.ios[j + 16 * c], s.Gt[r],
                                   s.Gs[j + 16 * c])
                          : 0.f;
      const float mv = (x[c] + s.dd[r]) * w;
      s.M[r][j + 16 * c] = mv;
      rs += static_cast<double>(mv) * static_cast<double>(sc[c]);
    }
#pragma unroll
    for (int pc = 0; pc < NPC; ++pc)
      if (pc * PC < a.PT) {
        __syncthreads();
        stage(s.kt, a.k + x0, hp, s0, a.S, pc * PC, a.P, nullptr);
        __syncthreads();
        for (int sl = 0; sl < TS; ++sl) {
          const float mv = s.M[r][sl];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            dq[pc * 4 + i] = fmaf(mv, s.kt[sl][j + 16 * i], dq[pc * 4 + i]);
        }
      }
  }
  rs = sum16(rs);
  if (t < a.S) {
    if (j == 0) a.rowsum[o + t] = rs;
#pragma unroll
    for (int pc = 0; pc < NPC; ++pc)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = pc * PC + j + 16 * i;
        if (p < a.P) a.dq[x0 + t * hp + p] = dq[pc * 4 + i];
      }
  }
}

// Launch 3: per (b, h, CT steps s): dk_s, dv_s and colsum_s.  Its two
// accumulators take 64 registers a thread: one block per SM, so that none
// spills.
__global__ void __launch_bounds__(THREADS, 1)
mlstm_bwd_cols_kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t raw[];
  ColSmem& s = *reinterpret_cast<ColSmem*>(raw);
  const int tid = threadIdx.x, c = tid / LANES, j = tid % LANES;
  const int s0 = blockIdx.x * CT, hh = blockIdx.y, bi = blockIdx.z;
  const int col = s0 + c;
  const size_t o = seq(a, bi, hh), x0 = at(a, bi, hh);
  const size_t hp = static_cast<size_t>(a.H) * a.P;
  whole(s.k, a.k + x0, hp, s0, CT, a.S, a.P, a.PT);
  whole(s.v, a.v + x0, hp, s0, CT, a.S, a.P, a.PT);
  if (tid < CT) {
    const int ss = s0 + tid;
    s.Gs[tid] = ss < a.S ? a.G[o + ss] : 0.0;
    s.ios[tid] = ss < a.S ? a.iota[o + ss] : M0;
  }
  float dk[NPC * 4], dv[NPC * 4];
#pragma unroll
  for (int i = 0; i < NPC * 4; ++i) dk[i] = dv[i] = 0.f;
  double cs = 0.0;
  for (int t0 = s0 / TS * TS; t0 < a.S; t0 += TS) {
    __syncthreads();
    if (tid < TS) {
      const int tt = t0 + tid;
      s.Gt[tid] = tt < a.S ? a.G[o + tt] : 0.0;
      s.dd[tid] = tt < a.S ? a.dd[o + tt] : 0.f;
      s.den[tid] = tt < a.S ? a.den[o + tt] : 1.f;
    }
    float sc[2] = {0.f, 0.f}, x[2] = {0.f, 0.f};
    for (int pc = 0; pc < a.PT; pc += PC) {
      __syncthreads();
      stage(s.qt, a.q + x0, hp, t0, a.S, pc, a.P, nullptr);
      stage(s.nt, a.dh + x0, hp, t0, a.S, pc, a.P, s.den);
      __syncthreads();
      for (int pp = 0; pp < PC; ++pp) {
        const float kv = s.k[c][pc + pp], vv = s.v[c][pc + pp];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          sc[i] = fmaf(s.qt[j + 16 * i][pp], kv, sc[i]);
          x[i] = fmaf(s.nt[j + 16 * i][pp], vv, x[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int tl = j + 16 * i, tt = t0 + tl;
      const float w = tt >= col && tt < a.S && col < a.S
                          ? weight(s.ios[c], s.Gt[tl], s.Gs[c])
                          : 0.f;
      const float e1 = (x[i] + s.dd[tl]) * w;
      s.E1[c][tl] = e1;
      s.E2[c][tl] = w * sc[i];
      cs += static_cast<double>(e1) * static_cast<double>(sc[i]);
    }
#pragma unroll
    for (int pc = 0; pc < NPC; ++pc)
      if (pc * PC < a.PT) {
        __syncthreads();
        stage(s.qt, a.q + x0, hp, t0, a.S, pc * PC, a.P, nullptr);
        stage(s.nt, a.dh + x0, hp, t0, a.S, pc * PC, a.P, s.den);
        __syncthreads();
        for (int tl = 0; tl < TS; ++tl) {
          const float e1 = s.E1[c][tl], e2 = s.E2[c][tl];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dk[pc * 4 + i] = fmaf(e1, s.qt[tl][j + 16 * i], dk[pc * 4 + i]);
            dv[pc * 4 + i] = fmaf(e2, s.nt[tl][j + 16 * i], dv[pc * 4 + i]);
          }
        }
      }
  }
  cs = sum16(cs);
  if (col < a.S) {
    if (j == 0) a.colsum[o + col] = cs;
#pragma unroll
    for (int pc = 0; pc < NPC; ++pc)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = pc * PC + j + 16 * i;
        if (p < a.P) {
          a.dk[x0 + col * hp + p] = dk[pc * 4 + i];
          a.dv[x0 + col * hp + p] = dv[pc * 4 + i];
        }
      }
  }
}

// Launch 4: per (b, h), backwards over t: d lf' as the sum over t >= u of
// rowsum - colsum, the m chain's adjoint, d i_pre and d f_pre.
__global__ void __launch_bounds__(GATE_THREADS)
mlstm_bwd_gate_grads_kernel(const Args a) {
  __shared__ double rsum[SEG], csum[SEG];
  __shared__ float w[SEG], dlf[SEG], dii[SEG];
  const int tid = threadIdx.x, bi = blockIdx.x / a.H, hh = blockIdx.x % a.H;
  const size_t o = seq(a, bi, hh);
  double carry = 0.0, quad = 0.0;   // thread 0's: w_{t+1} G_{t+1}, d lf'
  for (int end = a.S; end > 0; end -= SEG) {
    const int t0 = max(0, end - SEG), n = end - t0;
    for (int j = tid; j < n; j += GATE_THREADS) {
      rsum[j] = a.rowsum[o + t0 + j];
      csum[j] = a.colsum[o + t0 + j];
      w[j] = a.wsel[o + t0 + j];
    }
    __syncthreads();
    if (tid == 0)
      for (int j = n - 1; j >= 0; --j) {
        const double gm = carry - rsum[j];
        quad += rsum[j] - csum[j];
        dlf[j] = static_cast<float>(quad + w[j] * gm);
        dii[j] = static_cast<float>(csum[j] + (1.0 - w[j]) * gm);
        carry = w[j] * gm;
      }
    __syncthreads();
    for (int j = tid; j < n; j += GATE_THREADS) {
      const size_t gi = (static_cast<size_t>(bi) * a.S + t0 + j) * a.H + hh;
      const float fr = a.f_pre[gi], z = expf(-fabsf(fr));
      const float sig = fr < 0.f ? 1.f / (1.f + z) : z / (1.f + z);
      a.df[gi] = dlf[j] * sig;
      a.di[gi] = dii[j];
    }
    __syncthreads();
  }
}

struct Layout {
  size_t G, rowsum, colsum, iota, wsel, den, dd, bytes;
};

size_t up256(size_t n) { return (n + 255) / 256 * 256; }

Layout layout(int b, int S, int H) {
  const size_t n = static_cast<size_t>(b) * S * H;
  Layout l;
  l.G = 0;
  l.rowsum = l.G + up256(n * 8);
  l.colsum = l.rowsum + up256(n * 8);
  l.iota = l.colsum + up256(n * 8);
  l.wsel = l.iota + up256(n * 4);
  l.den = l.wsel + up256(n * 4);
  l.dd = l.den + up256(n * 4);
  l.bytes = l.dd + up256(n * 4);
  return l;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// Bytes of scratch a call needs.
extern "C" long long mlstm_scan_bwd_sm90_scratch_bytes(int b, int S, int H) {
  return static_cast<long long>(layout(b, S, H).bytes);
}

// Launches the four phases on `stream` of the current device, checking each
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
  a.rowsum = reinterpret_cast<double*>(base + l.rowsum);
  a.colsum = reinterpret_cast<double*>(base + l.colsum);
  a.iota = reinterpret_cast<float*>(base + l.iota);
  a.wsel = reinterpret_cast<float*>(base + l.wsel);
  a.den = reinterpret_cast<float*>(base + l.den);
  a.dd = reinterpret_cast<float*>(base + l.dd);
  a.S = S;
  a.H = H;
  a.P = P;
  a.PT = (P + PC - 1) / PC * PC;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if ((err = allow_smem(mlstm_bwd_rows_kernel, sizeof(RowSmem))) !=
          cudaSuccess ||
      (err = allow_smem(mlstm_bwd_cols_kernel, sizeof(ColSmem))) !=
          cudaSuccess)
    return static_cast<int>(err);
  mlstm_bwd_gates_kernel<<<b * H, GATE_THREADS, 0, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  mlstm_bwd_rows_kernel<<<dim3((S + RT - 1) / RT, H, b), THREADS,
                          sizeof(RowSmem), st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  mlstm_bwd_cols_kernel<<<dim3((S + CT - 1) / CT, H, b), THREADS,
                          sizeof(ColSmem), st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  mlstm_bwd_gate_grads_kernel<<<b * H, GATE_THREADS, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of launch `phase` (2: rows, 3: columns); 0
// otherwise.
extern "C" int mlstm_scan_bwd_sm90_smem_bytes(int phase) {
  return phase == 2 ? static_cast<int>(sizeof(RowSmem))
                    : phase == 3 ? static_cast<int>(sizeof(ColSmem)) : 0;
}

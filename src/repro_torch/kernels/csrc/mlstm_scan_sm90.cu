// Stabilised mLSTM scan for Hopper (sm_90a): f32 in and out, chunkwise, the
// large products on the tensor cores as three TF32 products each.
//
// Replaces the Pallas TPU kernel src/repro/kernels/mlstm_scan.py:62
// (mlstm_scan_kernel, body _kernel).  Per (batch b, head h), over time t,
// with log f_t = logsigmoid(f_pre_t) and m_0 = -1e30:
//
//   m_t = max(log f_t + m_{t-1}, i_t)
//   C_t = e^{lf'_t} C_{t-1} + e^{i'_t} v_t k_t^T     (P x P, C_0 = 0)
//   n_t = e^{lf'_t} n_{t-1} + e^{i'_t} k_t
//   h_t = C_t q_t / max(|n_t . q_t|, 1)
//
// where lf'_t = (log f_t + m_{t-1}) - m_t and i'_t = i_t - m_t are the
// exponents the plain recurrence takes, rounded as it rounds them: both
// are <= 0.  Unrolled over a chunk of L steps starting at c0, with the
// segment sums Lam(s, t] = sum_{s<u<=t} lf'_u and G_t = sum_{c0<=u<=t} lf'_u:
//
//   h_t = [sum_{s<=t} D_ts (q_t.k_s) v_s + g_t C_c0 q_t]
//         / max(|sum_{s<=t} D_ts (q_t.k_s) + g_t n_c0.q_t|, 1)       (1)
//   D_ts = e^{i'_s + Lam(s, t]},  g_t = e^{G_t}
//   C_{c0+L} = e^{G_end} C_c0 + (w o V)^T K,  w_s = e^{i'_s + Lam(s, end]}  (2)
//
// Every exponent is <= 0, and D is masked (s <= t) before the exp.  Four
// launches per call:
//   A. gates and scores, in one grid: per (b, h) one block runs the m
//      chain serially, in the plain version's order and rounding, and
//      writes lf' and i'; per (b, chunk, h) and 32 x 32 tile of the causal
//      scores q_t.k_s, blocks form them in f64 on the FP64 tensor cores
//      (mma m8n8k4): exact products, f64 sums;
//   B. chunk carries: per (b, chunk, h) and 128 x 128 tile of C, blocks
//      form (w o V)^T K as three TF32 products, the tiles of the first row
//      of tiles also w.K in f32, and the first tile e^{G_end}; the last
//      chunk's carry enters no chunk and is not formed;
//   C. weights and state passing, in one grid: per (b, chunk, h) one block
//      forms D, the weighted scores D (q.k) (rounded to f32, zero above the
//      diagonal), their row sums in f64 and g_t; and elementwise over each
//      (b, h)'s state, walking the chunks in order, the scratch's chunk
//      carry becomes the state C_c0, n_c0 entering the chunk (in place);
//   D. chunk outputs: per (b, chunk, h, 128 rows of t, 128 columns of h):
//      acc = Q.C_c0^T, acc *= g_t, acc += (D o QK^T).V, both as three TF32
//      products in one accumulator; n_c0.q_t in f64; the denominator (1) in
//      f64; the division.  The first chunk's C_c0 and n_c0 are zero, so its
//      blocks skip the first product.
//
// Numerics.  A TF32x3 product takes hi = tf32(x) and lo = tf32(x - hi) of
// each f32 operand (cvt.rna) and sums lo.hi + hi.lo + hi.hi in f32 on the
// tensor cores.  The denominator is the sensitive part: n.q cancels, and
// |h| reaches ~20 at P = 512, so an f32 error of the scores' row sums shows
// at full size in h.  Hence the scores in f64 (the card's FP64 tensor
// cores; the f32 scores fed to the numerator are those, rounded) and the
// row sums and n_c0.q_t in f64.  The exponents mirror the plain version's:
// the m chain runs in its order, and the weights are exps of segment sums
// of its per-step exponents, so where the plain version's own rounding of
// m drifts from exact (large i_t, long runs without a reset), the kernel
// drifts with it.  A CPU emulation of these phases
// (tests/test_torch_mlstm_scan.py, S = 2048, P = 512) holds h within 1e-4
// of the f32 plain recurrence on the usual, stabiliser and long-memory
// draws, where bf16x3 products, exponents summed from log f or a dropped
// carry miss it, and f32 or TF32x3 scores leave the denominator 4-7x
// further from exact.
//
// What bounds it on an H100 SXM, at xlstm-1.3b's prefill (b 1, S 2048, H
// 4, P 512): q, k, v read once and h written once are 67 MB, 0.020 ms at
// 3.35 TB/s; the chunked form needs ~9 GFLOP, 8.9 of them in the products
// (w o V)^T K, Q.C^T and (D o QK^T).V, which as TF32x3 at 495 TFLOP/s take
// ~0.054 ms.  Operations bound it.  The phases add traffic of their own:
// the chunk carries, 1 MiB of f32 per (b, chunk, h), are written by B,
// read and written by C and read by D: 4 x 64 MiB at L = 128, some served
// by the 50 MB L2.  L = 128 is built: on an H100 it was faster than 64 and
// 256 at every shape timed (PERF.md).
//
// What the design does about the limits of the first kernel (a block per
// 16 rows of C walking all S steps one by one, every product on the f32
// CUDA cores, q and k re-read per block): the steps run in parallel chunks,
// only the m chain (A), elementwise and cheap, and phase C walk time in
// order; the products of B and D run as m64n128k8 TF32 wgmmas from K-major
// hi and lo planes in shared memory (64-byte swizzle), filled per k-tile of
// 16 (cp.async of the raw tile, then the split, transposed where the
// input's rows run along k) while the products of the tile before run; two
// blocks share each SM.  No atomics: every sum has one order, and two
// launches give the same bits.  Padding (P below 128, a ragged last chunk)
// is zero-filled in shared memory, and the padded steps carry i' = -1e30,
// so they add nothing.

#include <cuda_runtime.h>

#include <cstdint>

#include "mlstm_tf32x3_sm90.cuh"

namespace {

constexpr float M0 = -1e30f;     // the stabiliser before the first step
constexpr int PMAX = 512;
constexpr int CHUNK = 128;       // steps per chunk (the kernels take any
                                 // multiple of 128; this one was the fastest)
constexpr int TS = 32;           // score tile
constexpr int A_THREADS = 128;   // phase A's blocks
constexpr int KT = 32;           // depth of a staged k-tile of the scores
constexpr int LDS64 = KT + 4;    // f64 stride of the score operand tiles,
                                 // so the fragment loads meet 32 banks
constexpr int SEG = 1024;        // gate steps per shared-memory segment
constexpr int RT = 32;           // rows per pass of the weights' row sums

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* i_pre;
  const float* f_pre;
  float* h;
  int S, H, P, PT, nc;  // PT: P rounded up to 64
  size_t state_floats;  // PT * PT + PT per (b, chunk, h)
  bool vec;             // q, k, v and h rows 16-byte aligned, P % 4 == 0
  float* state;         // (b, nc, H, state_floats): carry, then state
  double* s64;          // (b, nc, H, L, L): q_t.k_s
  double* rowsum;       // (b, nc, H, L)
  float* sc;            // (b, nc, H, L, L): D o QK^T, zero above diagonal
  float* g;             // (b, nc, H, L): e^{G_t}
  float* decay;         // (b, nc, H): e^{G_end}
  float* lfs;           // (b, H, nc * L): lf'
  float* iota;          // (b, H, nc * L): i'
};

__device__ __forceinline__ void mma_f64(double (&d)[2], double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
      "{%0,%1}, {%2}, {%3}, {%0,%1};"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

// ---------------------------------------------------------------------------
// Phase A, gate blocks: the m chain of (b, h) in the plain version's order,
// then lf' = (lf_t + m_{t-1}) - m_t and i' = i_t - m_t; padded steps get
// lf' = 0 and i' = -1e30.
struct GateSmem {
  float lf[SEG];
  float ii[SEG];
  float m[SEG + 1];   // m[0]: m before the segment; m[j + 1]: after step j
};

__device__ void gate_chain(const Args& a, int L, int bh, unsigned char* raw) {
  GateSmem& s = *reinterpret_cast<GateSmem*>(raw);
  const int tid = threadIdx.x;
  const int bi = bh / a.H, hh = bh % a.H;
  const int T = a.nc * L;
  float* lfs = a.lfs + static_cast<size_t>(bh) * T;
  float* iota = a.iota + static_cast<size_t>(bh) * T;
  float m = M0;   // thread 0's running stabiliser
  for (int t0 = 0; t0 < T; t0 += SEG) {
    const int n = min(SEG, T - t0);   // a multiple of 64
    for (int j = tid; j < n; j += A_THREADS) {
      const int t = t0 + j;
      if (t < a.S) {
        const size_t gi = (static_cast<size_t>(bi) * a.S + t) * a.H + hh;
        const float fr = __ldg(a.f_pre + gi);
        s.lf[j] = fminf(fr, 0.f) - log1pf(expf(-fabsf(fr)));
        s.ii[j] = __ldg(a.i_pre + gi);
      } else {
        s.lf[j] = 0.f;
        s.ii[j] = M0;
      }
    }
    __syncthreads();
    if (tid == 0) {
      s.m[0] = m;
      float l8[8], i8[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        l8[u] = s.lf[u];
        i8[u] = s.ii[u];
      }
      for (int j0 = 0; j0 < n; j0 += 8) {
        float ln[8], in[8];   // the next eight, loaded ahead of the chain
        const int jn = j0 + 8 < n ? j0 + 8 : j0;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          ln[u] = s.lf[jn + u];
          in[u] = s.ii[jn + u];
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          m = fmaxf(l8[u] + m, i8[u]);
          s.m[j0 + u + 1] = m;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          l8[u] = ln[u];
          i8[u] = in[u];
        }
      }
    }
    __syncthreads();
    for (int j = tid; j < n; j += A_THREADS) {
      const bool real = t0 + j < a.S;
      const float mn = s.m[j + 1];
      lfs[t0 + j] = real ? (s.lf[j] + s.m[j]) - mn : 0.f;
      iota[t0 + j] = real ? s.ii[j] - mn : M0;
    }
    __syncthreads();   // the segment's buffers are free again
  }
}

// Phase A, score blocks: q_t.k_s in f64 for one 32 x 32 tile (ti, si), si
// <= ti, of a (b, chunk, h): 4 warps of 8 x 32, m8n8k4 f64 products of
// the f32 inputs (exact), over P in k-tiles of 32 staged as f64.  Small
// tiles, so that many blocks share each SM: the products' latency, not
// their rate, bounds a block.
struct ScoreSmem {
  double q[TS][LDS64];
  double k[TS][LDS64];
};

template <int L>
__device__ void score_tile(const Args& a, int idx, unsigned char* raw) {
  ScoreSmem& s = *reinterpret_cast<ScoreSmem*>(raw);
  constexpr int NT = L / TS;
  constexpr int TILES = NT * (NT + 1) / 2;
  const size_t cell = idx / TILES;
  int tile = idx % TILES, ti = 0;
  while (tile > ti) tile -= ++ti;
  const int si = tile;
  const int hh = cell % a.H, c = (cell / a.H) % a.nc;
  const int bi = cell / (static_cast<size_t>(a.H) * a.nc);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int m0 = 8 * warp;
  const int tq = c * L + ti * TS, tk = c * L + si * TS;   // first steps
  const size_t rstride = static_cast<size_t>(a.H) * a.P;
  const float* qb = a.q + (static_cast<size_t>(bi) * a.S * a.H + hh) * a.P;
  const float* kb = a.k + (static_cast<size_t>(bi) * a.S * a.H + hh) * a.P;
  double acc[4][2] = {};
  // Each thread stages 8 consecutive floats of one row of q and of k; the
  // loads of the next k-tile are in flight while this one's products run.
  const int r = tid / 4, c8 = 8 * (tid % 4);
  float xq[8], xk[8];
  auto load = [&](int j0) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int col = j0 + c8 + u;
      const bool okq = tq + r < a.S && col < a.P;
      const bool okk = tk + r < a.S && col < a.P;
      xq[u] = okq ? __ldg(qb + (tq + r) * rstride + col) : 0.f;
      xk[u] = okk ? __ldg(kb + (tk + r) * rstride + col) : 0.f;
    }
  };
  load(0);
  for (int j0 = 0; j0 < a.P; j0 += KT) {
    __syncthreads();   // the previous k-tile is consumed
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      s.q[r][c8 + u] = xq[u];
      s.k[r][c8 + u] = xk[u];
    }
    __syncthreads();
    if (j0 + KT < a.P) load(j0 + KT);
#pragma unroll
    for (int kk = 0; kk < KT; kk += 4) {
      const double av = s.q[m0 + g][kk + tig];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        mma_f64(acc[ni], av, s.k[8 * ni + g][kk + tig]);
    }
  }
  double* out = a.s64 + cell * L * L;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int t = ti * TS + m0 + g, u = si * TS + 8 * ni + 2 * tig;
    *reinterpret_cast<double2*>(out + static_cast<size_t>(t) * L + u) =
        make_double2(acc[ni][0], acc[ni][1]);
  }
}

template <int L>
__global__ void __launch_bounds__(A_THREADS)
mlstm_gates_scores_kernel(const Args a, int chains) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (static_cast<int>(blockIdx.x) < chains)
    gate_chain(a, L, blockIdx.x, smem);
  else
    score_tile<L>(a, blockIdx.x - chains, smem);
}

// ---------------------------------------------------------------------------
// Phases B and C.  The chunk's lf' and i' in shared memory, and per step s the
// weight of its carry, w_s = e^{i'_s + Lam(s, L-1]} (Lam summed upward).
template <int L>
__device__ __forceinline__ void load_gates(const Args& a, size_t cell,
                                           float* lfs, float* io) {
  const int hh = cell % a.H, c = (cell / a.H) % a.nc;
  const int bi = cell / (static_cast<size_t>(a.H) * a.nc);
  const size_t base = (static_cast<size_t>(bi) * a.H + hh) * a.nc * L + c * L;
  for (int t = threadIdx.x; t < L; t += THREADS) {
    lfs[t] = a.lfs[base + t];
    io[t] = a.iota[base + t];
  }
}

template <int L>
struct WeightSmem {
  float lfs[L];
  float io[L];
  double rows[RT][L];   // RT rows of q.k, then of D (q.k), in f64
};

// Phase C, weight blocks: per (b, chunk, h), for each RT rows of the scores
// (copied in by cp.async), thread s walks its column t = s .. with Lam(s,
// t]: D_ts = e^{i'_s + Lam}, D (q.k) into sc (f32) and in place (f64),
// whose rows each warp sums in a fixed order; and g_t = e^{G_t}.
template <int L>
__device__ void weights(const Args& a, size_t cell, unsigned char* raw) {
  WeightSmem<L>& s = *reinterpret_cast<WeightSmem<L>*>(raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  load_gates<L>(a, cell, s.lfs, s.io);
  __syncthreads();
  if (tid < L) {   // G_t, summed upward from the chunk's first step
    float G = 0.f;
    for (int u = 0; u <= tid; ++u) G += s.lfs[u];
    a.g[cell * L + tid] = expf(G);
  }
  const double* S64 = a.s64 + cell * L * L;
  float* sc = a.sc + cell * L * L;
  const bool col = tid < L;
  const float io = col ? s.io[tid] : 0.f;
  float lam = 0.f;
  for (int t0 = 0; t0 < L; t0 += RT) {
    // Rows t0 .. of the scores; entries above the diagonal are not read.
    for (int i = tid; i < RT * L / 2; i += THREADS) {
      const int r = i / (L / 2), c = 2 * (i % (L / 2));
      cp_async16(&s.rows[r][c], S64 + static_cast<size_t>(t0 + r) * L + c,
                 16);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (col) {
#pragma unroll 4
      for (int r = 0; r < RT; ++r) {
        const int t = t0 + r;
        double ds = 0.0;
        if (t > tid) lam += s.lfs[t];
        if (t >= tid) ds = static_cast<double>(expf(io + lam)) * s.rows[r][tid];
        sc[static_cast<size_t>(t) * L + tid] = static_cast<float>(ds);
        s.rows[r][tid] = ds;
      }
    }
    __syncthreads();
    for (int r = warp; r < RT; r += THREADS / 32) {
      double sum = 0.0;
      for (int u = lane; u < L; u += 32) sum += s.rows[r][u];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) a.rowsum[cell * L + t0 + r] = sum;
    }
    __syncthreads();
  }
}

template <int L>
struct CarryExtra {
  float lfs[L];
  float io[L];
  float w[L];
  float dn[TILE];
};

// Phase B, carry blocks: dC[p][j] = sum_s w_s V[s][p] K[s][j] for one 128 x
// 128 tile (pt, jt) of a (b, chunk, h); warpgroup wg takes rows 64 wg ..
// of p.  The tiles with pt = 0 also sum dn[j] = sum_s w_s K[s][j] in f32:
// per thread over its steps, then the two threads of a column in order.
template <int L>
__device__ void carry_tile(const Args& a, int idx, int tiles,
                           unsigned char* raw) {
  uint8_t* pipe = pipe_of(raw);
  CarryExtra<L>& x = *reinterpret_cast<CarryExtra<L>*>(pipe + PIPE);
  const int per_cell = tiles * tiles;
  const size_t cell = idx / per_cell;
  const int pt = (idx % per_cell) / tiles, jt = idx % tiles;
  const int hh = cell % a.H, c = (cell / a.H) % a.nc;
  const int bi = cell / (static_cast<size_t>(a.H) * a.nc);
  if (c == a.nc - 1) return;   // the last chunk's carry enters no chunk
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int p0 = pt * TILE, j0 = jt * TILE;
  const int t0 = c * L, valid = min(L, a.S - t0);
  const size_t rstride = static_cast<size_t>(a.H) * a.P;
  const size_t row0 = (static_cast<size_t>(bi) * a.S + t0) * a.H + hh;
  const float* vb = a.v + row0 * a.P + p0;
  const float* kb = a.k + row0 * a.P + j0;
  load_gates<L>(a, cell, x.lfs, x.io);
  __syncthreads();
  if (tid < L) {
    float lam = 0.f;
    for (int u = tid + 1; u < L; ++u) lam += x.lfs[u];
    x.w[tid] = expf(x.io[tid] + lam);
  }
  if (idx % per_cell == 0 && tid == 0) {   // e^{G_end}, as g's last step
    float G = 0.f;
    for (int u = 0; u < L; ++u) G += x.lfs[u];
    a.decay[cell] = expf(G);
  }

  float dn = 0.f;
  auto copy = [&](int t, float* stage) {
    const size_t off = static_cast<size_t>(t) * KW * rstride;
    copy_cols(stage, vb + off, rstride, valid - t * KW, a.P - p0, a.vec, a.v);
    copy_cols(stage + TILE * KW, kb + off, rstride, valid - t * KW, a.P - j0,
              a.vec, a.k);
  };
  auto split = [&](int t, const float* stage, uint8_t* buf) {
    const float* w = x.w + t * KW;
    float xv[8], xk[8];
    put_transposed(buf, stage, [&](int k, float v) { return v * w[k]; }, xv);
    put_transposed(buf + 2 * PLANE, stage + TILE * KW, Same{}, xk);
    if (pt == 0) {
      const int k0 = 8 * (tid / TILE);
#pragma unroll
      for (int i = 0; i < 8; ++i) dn = fmaf(w[k0 + i], xk[i], dn);
    }
  };
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  int it = 0;
  gemm(acc, pipe, L / KW, it, copy, split);

  float* out = a.state + cell * a.state_floats;
  const int r0 = 64 * (warp / 4) + 16 * (warp % 4) + lane / 4;
  const int c0 = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + r0 + 8 * h, col = j0 + 8 * j + c0;
      if (p < a.PT && col < a.PT)
        *reinterpret_cast<float2*>(out + static_cast<size_t>(p) * a.PT +
                                   col) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  if (pt == 0) {
    if (tid >= TILE) x.dn[tid - TILE] = dn;
    __syncthreads();
    if (tid < TILE && j0 + tid < a.PT)
      out[static_cast<size_t>(a.PT) * a.PT + j0 + tid] = dn + x.dn[tid];
  }
}

template <int L>
constexpr int phase_b_bytes() {
  return 1024 + PIPE + sizeof(CarryExtra<L>);
}

template <int L>
__global__ void __launch_bounds__(THREADS, 2)
mlstm_chunk_carry_kernel(const Args a, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  carry_tile<L>(a, blockIdx.x, tiles, smem);
}

// ---------------------------------------------------------------------------
// Phase C: the weight blocks (above), and per (b, h) and four state
// elements a thread that walks the chunks: state[c] <- the state entering
// c; state <- e^{G_end(c)} state + carry(c).  The loads of UNROLL chunks go
// out before the chain uses them.
constexpr int UNROLL = 16;

template <int L>
__global__ void __launch_bounds__(THREADS)
mlstm_state_pass_kernel(const Args a, int cells, int count) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (static_cast<int>(blockIdx.x) < cells) {
    weights<L>(a, blockIdx.x, smem);
    return;
  }
  const int e = (blockIdx.x - cells) * THREADS + threadIdx.x;   // float4
  if (e >= count) return;
  const size_t per = a.state_floats / 4;
  const int bh = e / per;
  const size_t i4 = e % per;
  const int bi = bh / a.H, hh = bh % a.H;
  const size_t stride = a.H * per;
  float4* st = reinterpret_cast<float4*>(a.state) +
               (static_cast<size_t>(bi) * a.nc * a.H + hh) * per + i4;
  const float* dec = a.decay + static_cast<size_t>(bi) * a.nc * a.H + hh;
  float4 run = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < a.nc; c0 += UNROLL) {
    float4 d[UNROLL];
    float f[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (c0 + u < a.nc) {
        d[u] = st[(c0 + u) * stride];
        f[u] = dec[static_cast<size_t>(c0 + u) * a.H];
      }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (c0 + u < a.nc) {
        st[(c0 + u) * stride] = run;
        run = make_float4(fmaf(f[u], run.x, d[u].x), fmaf(f[u], run.y, d[u].y),
                          fmaf(f[u], run.z, d[u].z), fmaf(f[u], run.w, d[u].w));
      }
  }
}

// ---------------------------------------------------------------------------
// Phase D: h for 128 rows (chunk-local t0l ..) and 128 columns (p0 ..) of a
// (b, chunk, h); warpgroup wg takes rows 64 wg ...  Part 1 runs Q rows
// against C_c0 rows (both K-major as they lie) and sums n_c0.q_t in f64 as
// it splits Q (thread i = tid + 256 u: row i / 4, floats 4 (i % 4) .. of
// the k-tile, then the row's four threads in a fixed tree); part 2 runs
// rows of D o QK^T against V, transposed.
struct OutExtra {
  float n[PMAX];
  float g[TILE];
  double rowsum[TILE];
  double nq[TILE];
};

constexpr int OUT_BYTES = 1024 + PIPE + sizeof(OutExtra);

template <int L>
__global__ void __launch_bounds__(THREADS, 2)
mlstm_chunk_output_kernel(const Args a, int tiles) {
  constexpr int TT = L / TILE;   // row tiles per chunk
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* pipe = pipe_of(smem);
  OutExtra& x = *reinterpret_cast<OutExtra*>(pipe + PIPE);
  const int per_cell = TT * tiles;
  const size_t cell = blockIdx.x / per_cell;
  const int tt = (blockIdx.x % per_cell) / tiles, pt = blockIdx.x % tiles;
  const int hh = cell % a.H, c = (cell / a.H) % a.nc;
  const int bi = cell / (static_cast<size_t>(a.H) * a.nc);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int t0l = tt * TILE, p0 = pt * TILE;
  const int t0 = c * L + t0l, valid = min(TILE, a.S - t0);
  const size_t rstride = static_cast<size_t>(a.H) * a.P;
  const size_t row0 = (static_cast<size_t>(bi) * a.S + t0) * a.H + hh;
  const float* qb = a.q + row0 * a.P;
  const float* state = a.state + cell * a.state_floats;
  for (int j = tid; j < PMAX; j += THREADS)
    x.n[j] = c > 0 && j < a.PT
                 ? state[static_cast<size_t>(a.PT) * a.PT + j] : 0.f;
  for (int r = tid; r < TILE; r += THREADS) {
    x.g[r] = a.g[cell * L + t0l + r];
    x.rowsum[r] = a.rowsum[cell * L + t0l + r];
  }
  __syncthreads();   // x is read below, also where part 1 is skipped
  const int ch = tid % 4;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  int it = 0;

  // Part 1: acc = Q.C_c0^T over j < P; the first chunk's C_c0 and n_c0 are
  // zero, and so are its acc and n_c0.q.
  double nq[2] = {0.0, 0.0};
  auto copy1 = [&](int t, float* stage) {
    const int j0 = t * KW;
    copy_rows(stage, qb + j0, rstride, valid, a.P - j0, a.vec, a.q);
    copy_rows(stage + TILE * KW,
              state + static_cast<size_t>(p0) * a.PT + j0, a.PT, a.PT - p0,
              KW, true, state);
  };
  auto split1 = [&](int t, const float* stage, uint8_t* buf) {
    const float* n = x.n + t * KW + 4 * ch;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int row = tid / 4 + 64 * u;
      const float4 q = *reinterpret_cast<const float4*>(stage + row * KW +
                                                        4 * ch);
      put(buf, row, ch, q);
      put(buf + 2 * PLANE, row, ch,
          *reinterpret_cast<const float4*>(stage + TILE * KW + row * KW +
                                           4 * ch));
      nq[u] = fma(static_cast<double>(q.x), static_cast<double>(n[0]), nq[u]);
      nq[u] = fma(static_cast<double>(q.y), static_cast<double>(n[1]), nq[u]);
      nq[u] = fma(static_cast<double>(q.z), static_cast<double>(n[2]), nq[u]);
      nq[u] = fma(static_cast<double>(q.w), static_cast<double>(n[3]), nq[u]);
    }
  };
  if (c > 0) gemm(acc, pipe, (a.P + KW - 1) / KW, it, copy1, split1);
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    double v = nq[u];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    if (ch == 0) x.nq[tid / 4 + 64 * u] = v;
  }
  const int r0 = 64 * (warp / 4) + 16 * (warp % 4) + lane / 4;
  const float g_lo = x.g[r0], g_hi = x.g[r0 + 8];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    acc[4 * j] *= g_lo;
    acc[4 * j + 1] *= g_lo;
    acc[4 * j + 2] *= g_hi;
    acc[4 * j + 3] *= g_hi;
  }

  // Part 2: acc += (D o QK^T).V over s below the tile's last row.
  const float* scb = a.sc + cell * L * L + static_cast<size_t>(t0l) * L;
  const float* vb = a.v + (static_cast<size_t>(bi) * a.S * a.H + hh) * a.P +
                    static_cast<size_t>(c) * L * rstride + p0;
  const int cvalid = min(L, a.S - c * L);
  auto copy2 = [&](int t, float* stage) {
    const int s0 = t * KW;
    copy_rows(stage, scb + s0, L, TILE, KW, true, scb);
    copy_cols(stage + TILE * KW, vb + s0 * rstride, rstride, cvalid - s0,
              a.P - p0, a.vec, a.v);
  };
  auto split2 = [&](int, const float* stage, uint8_t* buf) {
    put_rows(buf, stage, Same{});
    float xv[8];
    put_transposed(buf + 2 * PLANE, stage + TILE * KW, Same{}, xv);
  };
  gemm(acc, pipe, (t0l + TILE) / KW, it, copy2, split2);
  __syncthreads();   // x.nq is written

  // h = acc / max(|rowsum + g n_c0.q|, 1), rows below S, columns below P.
  const int c0 = 2 * (lane % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= valid) continue;
    const float den = static_cast<float>(fmax(
        fabs(x.rowsum[r] + static_cast<double>(x.g[r]) * x.nq[r]), 1.0));
    float* hrow = a.h + (row0 + static_cast<size_t>(r) * a.H) * a.P;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int p = p0 + 8 * j + c0;
      const float v0 = acc[4 * j + 2 * h] / den;
      const float v1 = acc[4 * j + 2 * h + 1] / den;
      if (a.vec) {
        if (p < a.P) *reinterpret_cast<float2*>(hrow + p) = make_float2(v0, v1);
      } else {
        if (p < a.P) hrow[p] = v0;
        if (p + 1 < a.P) hrow[p + 1] = v1;
      }
    }
  }
}

// ---------------------------------------------------------------------------
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

constexpr int PHASE_A_BYTES =
    sizeof(GateSmem) > sizeof(ScoreSmem) ? sizeof(GateSmem)
                                         : sizeof(ScoreSmem);

template <int L>
int launch(const Args& a, int b, cudaStream_t stream) {
  constexpr int NT = L / TS;
  cudaError_t err;
  if ((err = allow_smem(mlstm_gates_scores_kernel<L>, PHASE_A_BYTES)) !=
          cudaSuccess ||
      (err = allow_smem(mlstm_chunk_carry_kernel<L>, phase_b_bytes<L>())) !=
          cudaSuccess ||
      (err = allow_smem(mlstm_state_pass_kernel<L>,
                        sizeof(WeightSmem<L>))) != cudaSuccess ||
      (err = allow_smem(mlstm_chunk_output_kernel<L>, OUT_BYTES)) !=
          cudaSuccess)
    return static_cast<int>(err);
  const int chains = b * a.H;
  const int cells = b * a.nc * a.H;
  const int tiles = (a.PT + TILE - 1) / TILE;
  mlstm_gates_scores_kernel<L><<<chains + cells * NT * (NT + 1) / 2,
                                 A_THREADS, PHASE_A_BYTES, stream>>>(a,
                                                                     chains);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  mlstm_chunk_carry_kernel<L><<<cells * tiles * tiles, THREADS,
                                phase_b_bytes<L>(), stream>>>(a, tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  // The state entering the first chunk is zero, and phase D reads none.
  const int count =
      a.nc > 1 ? static_cast<int>(chains * (a.state_floats / 4)) : 0;
  mlstm_state_pass_kernel<L><<<cells + (count + THREADS - 1) / THREADS,
                               THREADS, sizeof(WeightSmem<L>), stream>>>(
      a, cells, count);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  mlstm_chunk_output_kernel<L><<<cells * (L / TILE) * tiles, THREADS,
                                 OUT_BYTES, stream>>>(a, tiles);
  return static_cast<int>(cudaGetLastError());
}

// The scratch's regions, each rounded up to 256 bytes: f64 scores and row
// sums, then the f32 states, weighted scores, g, decays, lf' and i'.
struct Layout {
  size_t s64, rowsum, state, sc, g, decay, lfs, iota, bytes;
};

size_t up256(size_t n) { return (n + 255) / 256 * 256; }

Layout layout(int b, int S, int H, int P, int L) {
  const size_t nc = (S + L - 1) / L, cells = b * nc * H;
  const size_t PT = (P + 63) / 64 * 64;
  Layout l;
  l.s64 = 0;
  l.rowsum = l.s64 + up256(cells * L * L * 8);
  l.state = l.rowsum + up256(cells * L * 8);
  l.sc = l.state + up256(cells * (PT * PT + PT) * 4);
  l.g = l.sc + up256(cells * L * L * 4);
  l.decay = l.g + up256(cells * L * 4);
  l.lfs = l.decay + up256(cells * 4);
  l.iota = l.lfs + up256(b * H * nc * L * 4);
  l.bytes = l.iota + up256(b * H * nc * L * 4);
  return l;
}

bool built(int chunk) { return chunk == CHUNK; }

}  // namespace

// Bytes of scratch a call at chunk `chunk` needs (0 for an unbuilt chunk).
extern "C" long long mlstm_scan_sm90_scratch_bytes(int b, int S, int H, int P,
                                                   int chunk) {
  return built(chunk) ? static_cast<long long>(layout(b, S, H, P, chunk).bytes)
                      : 0;
}

// Launches the four phases on `stream`, checking each launch, and returns
// the first CUDA error (0 on success).  q, k, v and h are (b, S, H, P),
// i_pre and f_pre (b, S, H), all contiguous float32; `scratch` holds
// mlstm_scan_sm90_scratch_bytes(b, S, H, P, chunk) bytes, 256-byte aligned.
// The caller checks shapes, 1 <= P <= 512, b, S, H >= 1, every input's size
// and b * H * (PT * PT + PT) below 2**31 (PT: P rounded up to 64).
extern "C" int mlstm_scan_sm90_f32(const void* q, const void* k, const void* v,
                                   const void* i_pre, const void* f_pre,
                                   void* h, void* scratch, int b, int S, int H,
                                   int P, int chunk, void* stream) {
  if (!built(chunk) || P < 1 || P > PMAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout l = layout(b, S, H, P, chunk);
  unsigned char* base = static_cast<unsigned char*>(scratch);
  Args a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.i_pre = static_cast<const float*>(i_pre);
  a.f_pre = static_cast<const float*>(f_pre);
  a.h = static_cast<float*>(h);
  a.S = S;
  a.H = H;
  a.P = P;
  a.PT = (P + 63) / 64 * 64;
  a.nc = (S + chunk - 1) / chunk;
  a.state_floats = static_cast<size_t>(a.PT) * a.PT + a.PT;
  a.vec = P % 4 == 0 &&
          ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
            reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(h)) &
           15) == 0;
  a.s64 = reinterpret_cast<double*>(base + l.s64);
  a.rowsum = reinterpret_cast<double*>(base + l.rowsum);
  a.state = reinterpret_cast<float*>(base + l.state);
  a.sc = reinterpret_cast<float*>(base + l.sc);
  a.g = reinterpret_cast<float*>(base + l.g);
  a.decay = reinterpret_cast<float*>(base + l.decay);
  a.lfs = reinterpret_cast<float*>(base + l.lfs);
  a.iota = reinterpret_cast<float*>(base + l.iota);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return launch<CHUNK>(a, b, s);
}

// Dynamic shared memory of phase `phase` (1: gates and scores, 2: chunk
// carry, 3: weights and state passing, 4: chunk outputs) at chunk `chunk`;
// 0 otherwise.
extern "C" int mlstm_scan_sm90_smem_bytes(int phase, int chunk) {
  if (!built(chunk)) return 0;
  switch (phase) {
    case 1:
      return PHASE_A_BYTES;
    case 2:
      return phase_b_bytes<CHUNK>();
    case 3:
      return sizeof(WeightSmem<CHUNK>);
    case 4:
      return OUT_BYTES;
    default:
      return 0;
  }
}

extern "C" const char* mlstm_scan_sm90_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Flash attention backward in bf16 at head dim 256 on the tensor cores
// through mma.sync (sm_90a): dq, dk and dv of the forward in
// flash_attention_sm90.cu, for the output gradient dO.  GQA, causal
// (top-left), optional sliding window and logit softcap; bf16 in and out,
// f32 statistics and accumulation.  Every other head dim goes to the wgmma
// kernel in flash_attention_bwd_sm90.cu, f32 inputs to the CUDA-core
// backward in flash_attention_bwd.cu; the wrapper chooses by head dim
// (kernels/flash_attention.py) and counts this route as ``bwd_mma_bf16``.
// D = 256 is gemma2-2b's, which no training path runs; the wgmma kernel
// would need D split over two consumer warpgroups to hold dK and dV (256
// f32 a thread at D = 256), which is left for later (ROADMAP).
//
// The Pallas TPU kernel src/repro/kernels/flash_attention.py:84
// (flash_attention_kernel) has no backward: the JAX package trains through
// the einsum attention_scores (src/repro/models/layers.py:114) under
// jax.grad.  This kernel gives the port's forward kernel that gradient:
//
//   x_ij = mask(i, j) ? c*tanh(q_i.k_j / (c*sqrt(D))) : -1e30  (no c: /sqrt(D))
//   P_ij = exp(x_ij - lse_i),           lse_i saved by the forward
//   dV_j = sum_i P_ij dO_i,             dP_ij = dO_i.v_j
//   dX_ij = P_ij (dP_ij - D_i),         D_i = dO_i.O_i
//   dS_ij = dX_ij (1 - tanh^2) / sqrt(D)  (no c: dX_ij / sqrt(D))
//   dQ_i = sum_j dS_ij k_j,             dK_j = sum_i dS_ij q_i
//
// with k, v of KV head bh / group, dK and dV summed over the group's query
// heads.  q and dO are (BH, S, D), k and v (BKV, T, D), BH = BKV * group.
//
// Three launches, deterministic (no atomics: every output element has one
// writer, each sum a fixed order; two launches give the same bits):
//   (a) D_i = rowsum(dO * O), one f32 per query row, O taken as the bf16
//       output plus the forward's lo = bf16(o - bf16(o)): the f32 O to
//       2^-17;
//   (b) one block per (64-key tile, KV head): it walks the group's query
//       heads and, per head, the query tiles that some key of the tile is
//       visible to; per step it recomputes S^T = K.Q^T and dP^T = V.dO^T,
//       forms P^T and dS^T in registers, and accumulates dV += P^T.dO and
//       dK += dS^T.Q in registers; two warps share a key row group, each
//       accumulating half of D (both compute the row group's S^T, dP^T);
//   (c) one block per (64-query tile, query head): it walks the visible key
//       tiles, recomputes S = Q.K^T and dP = dO.V^T, and accumulates
//       dQ += dS.K in registers.
//
// What bounds it on an H100 SXM: the 10*D operations per visible (query,
// key) pair of the five products at 989 TFLOP/s (bf16 tensor cores).  As
// built it does 24*D a pair: S and dP in (b) twice (the two D halves) and
// again in (c), and P and dS each enter their products as hi + lo bf16
// (hi = bf16(p), lo = bf16(p - hi)), as the forward carries P: a single
// bf16 P or dS carries 2^-9 relative error per term, about the whole
// half-ulp limit of dq, dk, dv, where the split leaves some 2^-17.
//
// Every product is mma.sync m16n8k16 (bf16 in, f32 accumulate), its
// operands read from shared memory by ldmatrix (.trans where the
// contraction runs along the rows: Q and dO in (b), K in (c)); each warp
// owns 16 rows of the block and the C fragment of S (or dP) is, pair by
// pair, the A fragment of the next product.  Q, dO (and lse, D_i) in (b)
// and K, V in (c) go through a two-stage cp.async ring; rows past S or T
// come in as zeros.  Shared rows are padded to D + 8 bf16.  Tiles that no
// row can see are skipped; masks apply only on tiles that cross the
// diagonal, a window's edge, S or T.
// Numerics.  Products of bf16 values are exact in f32, so S and dP differ
// from the f32 arithmetic only in the order of their sums; the softcap uses
// the accurate tanhf, as the forward does; P = exp2(x*log2(e) - lse*log2(e))
// against the forward's saved lse.  Every gradient is rounded once, to
// bf16, from its f32 accumulator.
//
// Shared memory at D = 256: (b) 135,680 B, (c) 135,168 B.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int ROWS = 64;              // rows a block owns: keys (b), queries (c)
constexpr float LOG2E = 1.4426950408889634f;

// Tiles at D = 256, the one head dim built here: the accumulators' D f32
// a thread (dK and dV in (b), dQ in (c)) leave room for 32 queries a step
// of (b) and 32 keys a step of (c), and in (b) two warps share a key row
// group, each with half of D.
template <int D>
struct BwdTiles {
  static_assert(D == 256, "built at head dim 256");
  static constexpr int LD = D + 8;                  // shared row stride, bf16
  static constexpr int BQ = 32;                     // queries a step of (b)
  static constexpr int BKC = 32;                    // keys a step of (c)
  static constexpr int SPLIT = 2;                   // D slices in (b)
  static constexpr int DW = D / SPLIT;              // columns a warp owns
  static constexpr int THREADS_B = 128 * SPLIT;
  static constexpr int THREADS_C = 128;
  static constexpr int SMEM_B =
      2 * ROWS * LD * 2 + 2 * 2 * BQ * LD * 2 + 2 * 2 * BQ * 4;
  static constexpr int SMEM_C = 2 * ROWS * LD * 2 + 2 * 2 * BKC * LD * 2;
  static_assert(D % 16 == 0 && DW % 16 == 0, "head dim");
  static_assert(SMEM_B <= 232448 && SMEM_C <= 232448, "shared memory");
};

struct BwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;
  const float* di;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int S, T, group, causal, window;
  float scale, softcap;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, zeros when `valid` is false (src-size 0:
// nothing is read, `src` need only be a valid address).
__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp4(uint32_t dst, const void* src,
                                    bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8.  Without .trans lane l receives, of each
// matrix, row l / 4, columns 2(l % 4) and 2(l % 4) + 1; with .trans the
// same elements of the transposed matrix.
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr)
      : "memory");
}

// c += a.b: a 16x16 (row-major fragment), b 16x8 (column fragment), f32.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment addresses in a [rows][LD] bf16 tile at `base` (shared address).
// A operand, rows r0.. r0 + 15, columns c0.. c0 + 15 (the contraction along
// the row); with ldsm_t the same address gives the B operands of two
// 8-column tiles (columns c0.., c0 + 8..) of a product that contracts along
// the rows r0.. r0 + 15.
__device__ __forceinline__ uint32_t a_addr(uint32_t base, int r0, int c0,
                                           int ld, int lane) {
  return base + 2 * ((r0 + lane % 16) * ld + c0 + 8 * (lane / 16));
}
// B operands of two 8-column tiles of a product whose second factor is
// stored transposed, [n][k]: n rows n0.. n0 + 15, k columns k0.. k0 + 15.
__device__ __forceinline__ uint32_t b_addr(uint32_t base, int n0, int k0,
                                           int ld, int lane) {
  return base +
         2 * ((n0 + lane % 8 + 8 * (lane / 16)) * ld + k0 + 8 * ((lane / 8) % 2));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<const uint32_t*>(&h);
}

// x and y as hi + lo bf16 pairs: hi = bf16(x), lo = bf16(x - hi).
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// The A fragments, hi and lo, of a 16x16 block of an f32 C tile whose two
// 8-column fragments are c0 (columns 0-7) and c1 (8-15): the C fragment's
// pairs are the A fragment's, in the order (row g, cols 0-7), (g + 8,
// 0-7), (g, 8-15), (g + 8, 8-15).
__device__ __forceinline__ void split_a(const float (&c0)[4],
                                        const float (&c1)[4],
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split2(c0[0], c0[1], hi[0], lo[0]);
  split2(c0[2], c0[3], hi[1], lo[1]);
  split2(c1[0], c1[1], hi[2], lo[2]);
  split2(c1[2], c1[3], hi[3], lo[3]);
}

// The masked, softcapped, scaled logit x of the raw score s, P and dS:
// returns P and sets ds = P (dp - di) x'(s).
struct Grad {
  float scale, softcap, cap_in;
  __device__ __forceinline__ float apply(float s, float dp, float lse_l2,
                                         float di, bool visible,
                                         float& ds) const {
    float x, dx;
    if (softcap > 0.f) {
      const float t = tanhf(s * cap_in);
      x = softcap * t;
      dx = (1.f - t * t) * scale;
    } else {
      x = s * scale;
      dx = scale;
    }
    const float p = visible ? exp2f(x * LOG2E - lse_l2) : 0.f;
    ds = p * (dp - di) * dx;
    return p;
  }
};

__device__ __forceinline__ bool visible(int i, int j, int S, int T,
                                        int causal, int window) {
  bool ok = i < S && j < T;
  if (causal) ok = ok && j <= i;
  if (window > 0) ok = ok && j > i - window;
  return ok;
}

// (a): D_i = sum_d dO_id (O_id + Olo_id), one warp a row.
__global__ void __launch_bounds__(256)
flash_bwd_dot_do_o_kernel(const bf16* __restrict__ dout,
                          const bf16* __restrict__ o,
                          const bf16* __restrict__ o_lo,
                          float* __restrict__ di, int rows, int D) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const size_t base = static_cast<size_t>(row) * D;
  float sum = 0.f;
  for (int c = 2 * lane; c < D; c += 64) {
    const float2 g = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(dout + base + c));
    const float2 hi = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(o + base + c));
    const float2 lo = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(o_lo + base + c));
    sum = fmaf(g.x, hi.x + lo.x, sum);
    sum = fmaf(g.y, hi.y + lo.y, sum);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) di[row] = sum;
}

// Rows [r0, r0 + n) of a (rows, D) bf16 matrix into a [n][LD] shared tile,
// rows at or past `rows` as zeros.
template <int D>
__device__ __forceinline__ void load_rows(uint32_t dst, const bf16* src,
                                          int r0, int n, int rows,
                                          int threads) {
  constexpr int CH = D / 8;   // 16-byte chunks a row
  for (int i = threadIdx.x; i < n * CH; i += threads) {
    const int r = i / CH, c = i % CH;
    const bool ok = r0 + r < rows;
    const bf16* g = src + static_cast<size_t>(ok ? r0 + r : 0) * D + 8 * c;
    cp16(dst + 2 * (r * (D + 8) + 8 * c), g, ok);
  }
}

// (b): dK and dV of one 64-key tile of one KV head.
template <int D>
__global__ void __launch_bounds__(BwdTiles<D>::THREADS_B)
flash_bwd_dkdv_kernel(const BwdArgs a) {
  using C = BwdTiles<D>;
  constexpr int LD = C::LD, BQ = C::BQ, NT = BQ / 8, DW = C::DW;
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t sK = smem_addr(smem);
  const uint32_t sV = sK + ROWS * LD * 2;
  const uint32_t sQ = sV + ROWS * LD * 2;            // 2 stages [BQ][LD]
  const uint32_t sO = sQ + 2 * BQ * LD * 2;          // dO, 2 stages
  float* lse_s = reinterpret_cast<float*>(smem + 2 * ROWS * LD * 2 +
                                          4 * BQ * LD * 2);   // [2][BQ]
  float* di_s = lse_s + 2 * BQ;                                // [2][BQ]

  const int kvh = blockIdx.x;
  const int k0 = blockIdx.y * ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kg = warp % 4, slice = warp / 4;
  const int g = lane / 4, t = lane % 4;

  // The query tiles some key of this tile is visible to.
  int q_lo = a.causal ? k0 : 0;
  int q_hi = a.S;
  if (a.window > 0) q_hi = min(q_hi, k0 + ROWS - 1 + a.window);
  q_lo = q_lo / BQ * BQ;
  const int nq = q_hi > q_lo ? (q_hi - q_lo + BQ - 1) / BQ : 0;
  const int steps = a.group * nq;

  const size_t kv_off = static_cast<size_t>(kvh) * a.T * D;
  auto load_step = [&](int i) {
    const int bh = kvh * a.group + i / nq;
    const int q0 = q_lo + (i % nq) * BQ;
    const int st = i % 2;
    const size_t off = static_cast<size_t>(bh) * a.S * D;
    load_rows<D>(sQ + st * BQ * LD * 2, a.q + off, q0, BQ, a.S,
                 C::THREADS_B);
    load_rows<D>(sO + st * BQ * LD * 2, a.dout + off, q0, BQ, a.S,
                 C::THREADS_B);
    for (int r = threadIdx.x; r < BQ; r += C::THREADS_B) {
      const bool ok = q0 + r < a.S;
      const size_t row = static_cast<size_t>(bh) * a.S + (ok ? q0 + r : 0);
      cp4(smem_addr(lse_s + st * BQ + r), a.lse + row, ok);
      cp4(smem_addr(di_s + st * BQ + r), a.di + row, ok);
    }
  };

  load_rows<D>(sK, a.k + kv_off, k0, ROWS, a.T, C::THREADS_B);
  load_rows<D>(sV, a.v + kv_off, k0, ROWS, a.T, C::THREADS_B);
  if (steps > 0) load_step(0);
  cp_commit();

  float dk[DW / 8][4], dv[DW / 8][4];
#pragma unroll
  for (int n = 0; n < DW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  const Grad grad{a.scale, a.softcap,
                  a.softcap > 0.f ? a.scale / a.softcap : 0.f};
  const int key_r = k0 + 16 * kg + g;   // this thread's keys: key_r, +8

  for (int i = 0; i < steps; ++i) {
    if (i + 1 < steps) load_step(i + 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const int st = i % 2;
    const int q0 = q_lo + (i % nq) * BQ;
    const uint32_t q_s = sQ + st * BQ * LD * 2, o_s = sO + st * BQ * LD * 2;
    const float* lse_t = lse_s + st * BQ;
    const float* di_t = di_s + st * BQ;

    // S^T = K.Q^T and dP^T = V.dO^T for the warp's 16 keys.
    float sc[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ak[4], av[4];
      ldsm(ak, a_addr(sK, 16 * kg, 16 * kk, LD, lane));
      ldsm(av, a_addr(sV, 16 * kg, 16 * kk, LD, lane));
#pragma unroll
      for (int np = 0; np < BQ / 16; ++np) {
        uint32_t b[4];
        ldsm(b, b_addr(q_s, 16 * np, 16 * kk, LD, lane));
        mma(sc[2 * np], ak, b[0], b[1]);
        mma(sc[2 * np + 1], ak, b[2], b[3]);
        ldsm(b, b_addr(o_s, 16 * np, 16 * kk, LD, lane));
        mma(dp[2 * np], av, b[0], b[1]);
        mma(dp[2 * np + 1], av, b[2], b[3]);
      }
    }

    // P^T and dS^T in place; masks only on edge tiles.
    const bool edge = (a.causal && k0 + ROWS - 1 > q0) ||
                      (a.window > 0 && q0 + BQ - 1 - k0 >= a.window) ||
                      k0 + ROWS > a.T || q0 + BQ > a.S;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1);
        const int key = key_r + 8 * (e / 2);
        const bool vis =
            !edge || visible(q0 + col, key, a.S, a.T, a.causal, a.window);
        float ds;
        sc[j][e] = grad.apply(sc[j][e], dp[j][e], lse_t[col] * LOG2E,
                              di_t[col], vis, ds);
        dp[j][e] = ds;
      }

    // dV += P^T.dO and dK += dS^T.Q over the warp's slice of D.
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t ph[4], pl[4], dh[4], dl[4];
      split_a(sc[2 * kk], sc[2 * kk + 1], ph, pl);
      split_a(dp[2 * kk], dp[2 * kk + 1], dh, dl);
#pragma unroll
      for (int n = 0; n < DW / 16; ++n) {
        const int c0 = slice * DW + 16 * n;
        uint32_t b[4];
        ldsm_t(b, a_addr(o_s, 16 * kk, c0, LD, lane));
        mma(dv[2 * n], ph, b[0], b[1]);
        mma(dv[2 * n], pl, b[0], b[1]);
        mma(dv[2 * n + 1], ph, b[2], b[3]);
        mma(dv[2 * n + 1], pl, b[2], b[3]);
        ldsm_t(b, a_addr(q_s, 16 * kk, c0, LD, lane));
        mma(dk[2 * n], dh, b[0], b[1]);
        mma(dk[2 * n], dl, b[0], b[1]);
        mma(dk[2 * n + 1], dh, b[2], b[3]);
        mma(dk[2 * n + 1], dl, b[2], b[3]);
      }
    }
    __syncthreads();   // before the next load overwrites this stage
  }
  cp_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key_r + 8 * h;
    if (key >= a.T) continue;
    const size_t row = kv_off + static_cast<size_t>(key) * D;
#pragma unroll
    for (int n = 0; n < DW / 8; ++n) {
      const int c = slice * DW + 8 * n + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(a.dk + row + c) =
          __floats2bfloat162_rn(dk[n][2 * h], dk[n][2 * h + 1]);
      *reinterpret_cast<__nv_bfloat162*>(a.dv + row + c) =
          __floats2bfloat162_rn(dv[n][2 * h], dv[n][2 * h + 1]);
    }
  }
}

// (c): dQ of one 64-query tile of one query head.
template <int D>
__global__ void __launch_bounds__(BwdTiles<D>::THREADS_C)
flash_bwd_dq_kernel(const BwdArgs a, int q_tiles) {
  using C = BwdTiles<D>;
  constexpr int LD = C::LD, BKC = C::BKC, NT = BKC / 8;
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t sQ = smem_addr(smem);
  const uint32_t sO = sQ + ROWS * LD * 2;
  const uint32_t sK = sO + ROWS * LD * 2;      // 2 stages [BKC][LD]
  const uint32_t sV = sK + 2 * BKC * LD * 2;   // 2 stages

  const int bh = blockIdx.x;
  const int q0 = (q_tiles - 1 - static_cast<int>(blockIdx.y)) * ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  int k_lo = 0, k_hi = a.T;
  if (a.window > 0) k_lo = max(0, q0 - a.window + 1) / BKC * BKC;
  if (a.causal) k_hi = min(a.T, q0 + ROWS);
  const int steps = k_hi > k_lo ? (k_hi - k_lo + BKC - 1) / BKC : 0;

  const size_t q_off = static_cast<size_t>(bh) * a.S * D;
  const size_t kv_off = static_cast<size_t>(bh / a.group) * a.T * D;
  load_rows<D>(sQ, a.q + q_off, q0, ROWS, a.S, C::THREADS_C);
  load_rows<D>(sO, a.dout + q_off, q0, ROWS, a.S, C::THREADS_C);
  auto load_step = [&](int i) {
    const int st = i % 2;
    load_rows<D>(sK + st * BKC * LD * 2, a.k + kv_off, k_lo + i * BKC, BKC,
                 a.T, C::THREADS_C);
    load_rows<D>(sV + st * BKC * LD * 2, a.v + kv_off, k_lo + i * BKC, BKC,
                 a.T, C::THREADS_C);
  };
  if (steps > 0) load_step(0);
  cp_commit();

  // This thread's rows, q_r and q_r + 8: their lse (in log2 units) and D_i.
  const int q_r = q0 + 16 * warp + g;
  float lse_l2[2], di[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q_r + 8 * h;
    const size_t at = static_cast<size_t>(bh) * a.S + (row < a.S ? row : 0);
    lse_l2[h] = a.lse[at] * LOG2E;
    di[h] = a.di[at];
  }

  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
  const Grad grad{a.scale, a.softcap,
                  a.softcap > 0.f ? a.scale / a.softcap : 0.f};

  for (int i = 0; i < steps; ++i) {
    if (i + 1 < steps) load_step(i + 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const int st = i % 2;
    const int kb = k_lo + i * BKC;
    const uint32_t k_s = sK + st * BKC * LD * 2, v_s = sV + st * BKC * LD * 2;

    // S = Q.K^T and dP = dO.V^T for the warp's 16 queries.
    float sc[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ao[4];
      ldsm(aq, a_addr(sQ, 16 * warp, 16 * kk, LD, lane));
      ldsm(ao, a_addr(sO, 16 * warp, 16 * kk, LD, lane));
#pragma unroll
      for (int np = 0; np < BKC / 16; ++np) {
        uint32_t b[4];
        ldsm(b, b_addr(k_s, 16 * np, 16 * kk, LD, lane));
        mma(sc[2 * np], aq, b[0], b[1]);
        mma(sc[2 * np + 1], aq, b[2], b[3]);
        ldsm(b, b_addr(v_s, 16 * np, 16 * kk, LD, lane));
        mma(dp[2 * np], ao, b[0], b[1]);
        mma(dp[2 * np + 1], ao, b[2], b[3]);
      }
    }

    const bool edge = (a.causal && kb + BKC - 1 > q0) ||
                      (a.window > 0 && q0 + ROWS - 1 - kb >= a.window) ||
                      kb + BKC > a.T || q0 + ROWS > a.S;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const int key = kb + 8 * j + 2 * t + (e & 1);
        const bool vis = !edge || visible(q_r + 8 * h, key, a.S, a.T,
                                          a.causal, a.window);
        float ds;
        grad.apply(sc[j][e], dp[j][e], lse_l2[h], di[h], vis, ds);
        dp[j][e] = ds;
      }

    // dQ += dS.K
#pragma unroll
    for (int kk = 0; kk < BKC / 16; ++kk) {
      uint32_t dh[4], dl[4];
      split_a(dp[2 * kk], dp[2 * kk + 1], dh, dl);
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        uint32_t b[4];
        ldsm_t(b, a_addr(k_s, 16 * kk, 16 * n, LD, lane));
        mma(dq[2 * n], dh, b[0], b[1]);
        mma(dq[2 * n], dl, b[0], b[1]);
        mma(dq[2 * n + 1], dh, b[2], b[3]);
        mma(dq[2 * n + 1], dl, b[2], b[3]);
      }
    }
    __syncthreads();
  }
  cp_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q_r + 8 * h;
    if (row >= a.S) continue;
    bf16* out = a.dq + q_off + static_cast<size_t>(row) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * n + 2 * t) =
          __floats2bfloat162_rn(dq[n][2 * h], dq[n][2 * h + 1]);
  }
}

template <int D>
int launch(const BwdArgs& a, const bf16* o, const bf16* o_lo, float* di,
           int BH, int BKV, cudaStream_t stream) {
  using C = BwdTiles<D>;
  const int rows = BH * a.S;
  flash_bwd_dot_do_o_kernel<<<(rows + 7) / 8, 256, 0, stream>>>(
      a.dout, o, o_lo, di, rows, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM_B);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_kernel<D><<<dim3(BKV, (a.T + ROWS - 1) / ROWS),
                             C::THREADS_B, C::SMEM_B, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM_C);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int q_tiles = (a.S + ROWS - 1) / ROWS;
  flash_bwd_dq_kernel<D><<<dim3(BH, q_tiles), C::THREADS_C, C::SMEM_C,
                           stream>>>(a, q_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the three kernels on `stream` and returns the CUDA error (0 on
// success).  q, dout, o, o_lo, dq: (BH, S, 256); k, v, dk, dv: (BKV, T,
// 256); all contiguous bf16, 16-byte aligned; lse and di (scratch, written
// by the first launch): (BH, S) f32.  The caller checks shapes, BH % BKV ==
// 0, BH and S / 64 within the grid's 65535, and every index below 2**31.
extern "C" int flash_attention_bwd_mma_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* o_lo, const float* lse, const void* dout, void* dq, void* dk,
    void* dv, float* di, int BH, int BKV, int S, int T, int D, int causal,
    int window, float softcap, void* stream) {
  if (D != 256) return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = lse;
  a.di = di;
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.S = S;
  a.T = T;
  a.group = BH / BKV;
  a.causal = causal;
  a.window = window;
  a.scale = 1.0f / sqrtf(static_cast<float>(D));
  a.softcap = softcap;
  return launch<256>(a, static_cast<const bf16*>(o),
                     static_cast<const bf16*>(o_lo), di, BH, BKV,
                     static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of launch (b) (`which` 2) or (c) (3), 0 if not
// built for D.
extern "C" int flash_attention_bwd_mma_smem_bytes(int which, int D) {
  if (D != 256) return 0;
  return which == 2 ? BwdTiles<256>::SMEM_B : BwdTiles<256>::SMEM_C;
}

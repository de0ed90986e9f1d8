// Mamba2 / SSD chunked scan for Hopper (sm_90a): f32 in and out, chunk
// parallel, the products on the tensor cores as three bf16 products each.
//
// Replaces the Pallas TPU kernel src/repro/kernels/mamba_scan.py:62
// (mamba_scan_kernel, body _kernel).  Per (batch b, head h), over time t:
//
//   S_t = e^{a_t} * S_{t-1} + dtx_t (x) B_t        (P x N state, S_0 = 0)
//   y_t = S_t . C_t
//
// with dtx (b, S, H, P), a (b, S, H), B and C (b, S, N): one group, so B
// and C are indexed by (b, t) and shared by every head.
//
// Chunkwise: for chunk c of Q steps with in-chunk cumulative log decay
// cum_t and A_c = cum_last,
//   dS_c  = sum_s e^{cum_last - cum_s} dtx_s (x) B_s                 (1)
//   S_c   = e^{A_{c-1}} S_{c-1} + dS_{c-1},  S_0 = 0  (entering c)   (2)
//   y_t   = sum_{s<=t} (C_t . B_s) e^{cum_t - cum_s} dtx_s
//         + e^{cum_t} (S_c . C_t)                                    (3)
// and so three launches, each parallel over (batch, chunk, group of
// heads) or (batch, head, state element):
//   1. chunk states: per block the cumulative decays of its heads, then per
//      head dS_c = (w (.) X)^T B as a P x N product over the chunk (w_s =
//      e^{cum_last - cum_s}); dS_c and e^{A_c} go to an f32 scratch;
//   2. state passing: the only sequential part, elementwise: each thread
//      walks the chunks of four state elements and overwrites dS_c in the
//      scratch with the state entering chunk c;
//   3. chunk outputs: per block C.B^T once, kept in shared memory as f32
//      tiles of its lower triangle, then per head y = [G | e^{cum} C] .
//      [X ; S_c^T] in one accumulator, with G = C.B^T (.) decay applied
//      per element and masked before the exp, as (3) says.
// The exp is taken only where s <= t: a future entry has cum_t - cum_s > 0
// and would overflow (never e^{cum_t} e^{-cum_s}: cum reaches -100 in a
// chunk and e^{-cum_s} overflows past 88.7).  a = -30 (a full reset) makes
// e^{cum} underflow to 0, which is the right answer.
//
// Numerics.  Each f32 operand is split into hi = bf16(v) and lo = bf16(v -
// hi), and a.b is taken as a_hi.b_hi + a_hi.b_lo + a_lo.b_hi on mma.sync
// m16n8k16 into f32, as csrc/fused_conv_sm90.cu does.  hi + lo carries v to
// 2^-16, so each product is within a few 2^-16 of exact.  A CPU emulation
// of these phases (tests/test_torch_mamba_scan.py, S = 4096, P = N = 64)
// holds y within 2.7e-5 (fast decays) and 4.1e-5 (long memory) of the JAX
// oracle, inside the 1e-4 limit, where one bf16 pass (1.2e-2) or one TF32
// pass (2.2e-3) misses it; at zamba2's 80 heads the card measures about
// 5e-5 (PERF.md).  The largest terms, the diagonal (C_t.B_t) dtx_t, set
// the error.  TF32x3 would be ~5x more accurate at twice the tensor-core
// time.
//
// What bounds it on an H100 SXM, at zamba2's prefill (b 1, S 4096, H 80,
// P = N = 64): each input read once and y written once is 171 MB, 0.051 ms
// at 3.35 TB/s; the 6.71 GFLOP the function needs are 0.02 ms as three
// bf16 products at 989 TFLOP/s.  Bytes bound it.  The three phases add
// traffic of their own: dtx is read twice (phases 1 and 3, 84 MB each) and
// the states, b.(S/Q).H.P.N.4 bytes (42 MB at Q = 128), are written by
// phase 1, read and written by phase 2 and read by phase 3: 420 MB in all,
// 0.125 ms at 3.35 TB/s, some of it served by the 50 MB L2.  Q = 128
// halves the state traffic against Q = 64 (84 MB a pass) and was the
// faster of the two builds on the card at S = 1000 and 4096, Q = 64 at S
// up to 256, where it gives more blocks and less causal padding: the
// wrapper's chunk_for picks by S (PERF.md).
//
// What the design does about the limits of the first kernel (one block per
// (b, h) walking 64 chunks in series, 80 blocks at batch 1, C.B^T per head,
// every product in f32 on the CUDA cores):
//   * the grid: phases 1 and 3 run a block per (b, chunk, group of heads),
//     the group sized by the wrapper from the card's resident blocks so the
//     grid comes out in whole waves (hundreds of blocks at batch 1); phase
//     2 runs a thread per four state elements (81,920 at the prefill);
//   * the chunks: only phase 2, elementwise and bound by its bytes, walks
//     them in order; its loads are issued ahead of the chain;
//   * C.B^T: formed once per block, for the whole group of heads; each head
//     applies its decay to it element by element;
//   * the tensor cores: every product (C.B^T, G.X, e^{cum} C.S^T, (w (.)
//     X)^T B) runs as m16n8k16 bf16 mma.sync, operands split once into hi
//     and lo bf16 tiles in shared memory (ldmatrix) or in registers; C.B^T
//     is kept in the accumulators' layout, which is the A fragments', so G
//     is formed in registers; phase 3 runs 16 warps, two per 16-row tile
//     of t, each half of P, one block per SM;
//   * the loads of the next head's dtx and state go out before the current
//     head's products and land in registers while they run; the staging
//     loads of B and C are all issued before their stores.
// What holds it back: phase 3, some half of the time, runs well below its
// bytes: every 16-row tile loads its own B fragments of the X and S tiles
// (~270 KB of ldmatrix traffic a head against 48 KB of tiles), and the
// splits, gates and barriers take issue slots; wgmma's 64-row tiles would
// cut the first.  Phase 1 and phase 2 run at about 2 and 3 TB/s.
// Padding: a ragged last chunk, and P or N below 64, are zero-filled in
// shared memory, so padding adds nothing.  No atomics: every sum has one
// order, and two launches give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "ssd_bf16x3_sm90.cuh"

namespace {

constexpr int TILE = 64;            // P and N as the blocks hold them
constexpr int LDH = TILE + 8;       // bf16 row stride of the split tiles:
                                    // 144 bytes, so ldmatrix meets 32 banks
constexpr int LDF = TILE + 8;       // f32 row stride of the staged C, B:
                                    // the float2 fragment loads meet 32 banks
constexpr int STATE = TILE * TILE;  // floats of one head's state in scratch
constexpr int GMAX = 32;            // heads a block of phase 1 or 3 takes
constexpr int PHASE1_THREADS = 256;
#define NEG_INF __int_as_float(0xff800000)

struct ScanArgs {
  const float* dtx;
  const float* a_log;
  const float* B;
  const float* C;
  float* y;
  float* states;     // (b, nc, H, 64, 64): dS_c, then the state entering c
  float* decay;      // (b, nc, H): e^{A_c}
  int S, H, P, N, nc, group;
  bool vec_x, vec_bc;  // 16-byte loads along P (dtx) and N (B, C)
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[i] += a.b_i for NT n8 tiles as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi (the
// small terms first), issued product by product so that consecutive mmas
// write different accumulators.
template <int NT>
__device__ __forceinline__ void mma3(float (*d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[NT][2],
                                     const uint32_t (&bl)[NT][2]) {
#pragma unroll
  for (int i = 0; i < NT; ++i) mma(d[i], al, bh[i]);
#pragma unroll
  for (int i = 0; i < NT; ++i) mma(d[i], ah, bl[i]);
#pragma unroll
  for (int i = 0; i < NT; ++i) mma(d[i], ah, bh[i]);
}

// The B fragments of two n8 tiles from one ldmatrix x4 (optionally
// transposed): registers 0-1 are the first tile's, 2-3 the second's.
template <bool TRANS>
__device__ __forceinline__ void ldsm_b2(uint32_t (&b)[2][2], uint32_t addr) {
  uint32_t r[4];
  if (TRANS)
    ldsm_x4_t(r, addr);
  else
    ldsm_x4(r, addr);
  b[0][0] = r[0];
  b[0][1] = r[1];
  b[1][0] = r[2];
  b[1][1] = r[3];
}

// ---------------------------------------------------------------------------
// Phase 1: dS_c[p][n] = sum_s w_s X[s][p] B[s][n] per head, w_s = e^{cum_last
// - cum_s}.  8 warps, warp w the rows p in [16 (w % 4), +16) and columns n
// in [32 (w / 4), +32): four n8 tiles, Q/16 k-steps over s.
template <int Q>
struct StateSmem {
  static constexpr int PLANE = Q * LDH;                 // bf16 elements
  static constexpr int B_HI = 0, B_LO = B_HI + PLANE * 2;
  static constexpr int X_HI = B_LO + PLANE * 2, X_LO = X_HI + PLANE * 2;
  static constexpr int CUM = X_LO + PLANE * 2;          // bytes
  static constexpr int BYTES = CUM + GMAX * Q * 4;
};

template <int Q>
struct StateLoads {   // float4s of dtx per thread for one head's chunk
  static constexpr int X4 = Q * TILE / 4 / PHASE1_THREADS;
};

template <int Q>
__device__ __forceinline__ void load_x(const ScanArgs& a, float4 (&xr)[StateLoads<Q>::X4],
                                       size_t row0, int h, int L, int nthreads) {
#pragma unroll
  for (int k = 0; k < StateLoads<Q>::X4; ++k) {
    const int i = threadIdx.x + k * nthreads, s = i / 16, p = 4 * (i % 16);
    xr[k] = s < L ? load4(a.dtx + ((row0 + s) * a.H + h) * a.P, p, a.P,
                          a.vec_x)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <int Q>
__global__ void __launch_bounds__(PHASE1_THREADS, 2)
mamba_scan_chunk_state_kernel(const ScanArgs a) {
  using L_ = StateSmem<Q>;
  constexpr int X4 = StateLoads<Q>::X4;
  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* bh = reinterpret_cast<__nv_bfloat16*>(smem + L_::B_HI);
  __nv_bfloat16* bl = reinterpret_cast<__nv_bfloat16*>(smem + L_::B_LO);
  __nv_bfloat16* xh = reinterpret_cast<__nv_bfloat16*>(smem + L_::X_HI);
  __nv_bfloat16* xl = reinterpret_cast<__nv_bfloat16*>(smem + L_::X_LO);
  float* cum = reinterpret_cast<float*>(smem + L_::CUM);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, tig = lane % 4;
  const int c = blockIdx.x, bi = blockIdx.z;
  const int h0 = blockIdx.y * a.group, G = min(a.group, a.H - h0);
  const int t0 = c * Q, L = min(Q, a.S - t0);
  const size_t row0 = static_cast<size_t>(bi) * a.S + t0;

  float4 xr[X4];
  load_x<Q>(a, xr, row0, h0, L, PHASE1_THREADS);
  // B once per block, split into hi and lo tiles [s][n].
  {
    constexpr int K = Q * 16 / PHASE1_THREADS;
    float4 v[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = tid + k * PHASE1_THREADS, s = i / 16, n = 4 * (i % 16);
      v[k] = s < L ? load4(a.B + (row0 + s) * a.N, n, a.N, a.vec_bc)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = tid + k * PHASE1_THREADS, s = i / 16, n = 4 * (i % 16);
      uint2 hi, lo;
      split4(v[k], hi, lo);
      *reinterpret_cast<uint2*>(bh + s * LDH + n) = hi;
      *reinterpret_cast<uint2*>(bl + s * LDH + n) = lo;
    }
  }
  chunk_cumsum<Q>(a.a_log, a.H, cum, row0, h0, G, L, PHASE1_THREADS);
  if (tid < G)
    a.decay[(static_cast<size_t>(bi) * a.nc + c) * a.H + h0 + tid] =
        expf(cum[tid * Q + Q - 1]);

  const int p0 = 16 * (warp % 4), n0 = 32 * (warp / 4);
  // ldmatrix lane addresses: A = (w X)^T from the [s][p] tiles, transposed;
  // B from the [s][n] tiles, transposed.
  const int mat = lane / 8, r = lane % 8;
  const uint32_t a_off =
      ((8 * (mat / 2) + r) * LDH + p0 + 8 * (mat % 2)) * 2;
  const uint32_t b_off = ((8 * (mat % 2) + r) * LDH + n0 + 8 * (mat / 2)) * 2;
  const uint32_t sxh = smem_addr(xh), sxl = smem_addr(xl);
  const uint32_t sbh = smem_addr(bh), sbl = smem_addr(bl);

  for (int j = 0; j < G; ++j) {
    const float* cj = cum + j * Q;
    const float clast = cj[Q - 1];
    __syncthreads();   // every warp is done with the previous head's tiles
#pragma unroll
    for (int k = 0; k < X4; ++k) {
      const int i = tid + k * PHASE1_THREADS, s = i / 16, p = 4 * (i % 16);
      const float w = expf(clast - cj[s]);
      uint2 hi, lo;
      split4(make_float4(w * xr[k].x, w * xr[k].y, w * xr[k].z, w * xr[k].w),
             hi, lo);
      *reinterpret_cast<uint2*>(xh + s * LDH + p) = hi;
      *reinterpret_cast<uint2*>(xl + s * LDH + p) = lo;
    }
    __syncthreads();
    if (j + 1 < G) load_x<Q>(a, xr, row0, h0 + j + 1, L, PHASE1_THREADS);

    float acc[4][4] = {};
#pragma unroll 2   // full unrolling spills at 128 registers
    for (int ks = 0; ks < Q / 16; ++ks) {
      const uint32_t row = ks * 16 * LDH * 2;
      uint32_t ah[4], al[4];
      ldsm_x4_t(ah, sxh + row + a_off);
      ldsm_x4_t(al, sxl + row + a_off);
      uint32_t bhi[4][2], blo[4][2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        ldsm_b2<true>(*reinterpret_cast<uint32_t(*)[2][2]>(bhi[2 * q]),
                      sbh + row + b_off + q * 32);
        ldsm_b2<true>(*reinterpret_cast<uint32_t(*)[2][2]>(blo[2 * q]),
                      sbl + row + b_off + q * 32);
      }
      mma3<4>(acc, ah, al, bhi, blo);
    }
    float* out = a.states +
                 ((static_cast<size_t>(bi) * a.nc + c) * a.H + h0 + j) * STATE;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = n0 + 8 * nt + 2 * tig;
      *reinterpret_cast<float2*>(out + (p0 + g) * TILE + n) =
          make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(out + (p0 + g + 8) * TILE + n) =
          make_float2(acc[nt][2], acc[nt][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// Phase 2: per (b, h) and four state elements, walk the chunks:
// states[c] <- S entering c; S <- e^{A_c} S + dS_c.  The loads of UNROLL
// chunks go out before the chain uses them.
constexpr int PASS_THREADS = 256;
constexpr int UNROLL = 16;

__global__ void __launch_bounds__(PASS_THREADS)
mamba_scan_state_pass_kernel(const ScanArgs a, int count) {
  const int e = blockIdx.x * PASS_THREADS + threadIdx.x;   // float4 index
  if (e >= count) return;
  const int bh = e / (STATE / 4), i4 = e % (STATE / 4);
  const int bi = bh / a.H, h = bh % a.H;
  const size_t stride = static_cast<size_t>(a.H) * STATE / 4;
  float4* st = reinterpret_cast<float4*>(a.states) +
               (static_cast<size_t>(bi) * a.nc * a.H + h) * (STATE / 4) + i4;
  const float* dec = a.decay + static_cast<size_t>(bi) * a.nc * a.H + h;
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
// Phase 3: y = [G | e^{cum} C] . [X ; S_c^T] per head.  Q/8 warps (16 at
// Q = 128), one per 16-row tile of t and half of P; warp w takes row tile
// rt(w), chosen so that the warps sharing an SM sub-partition (w, w + 4,
// ...) share its causal work evenly.
template <int Q>
struct OutSmem {
  static constexpr int W = Q / 16;                    // row tiles
  static constexpr int THREADS = 64 * W;              // two warps a tile
  static constexpr int TILES = W * (W + 1) / 2;       // lower-triangle C.B^T
  static constexpr int CF = 0;                        // f32 C [Q][LDF]
  static constexpr int BF = CF + Q * LDF * 4;         // f32 B [Q][LDF], then
  static constexpr int X_HI = BF;                     // the split X tiles
  static constexpr int X_LO = X_HI + Q * LDH * 2;
  static constexpr int CB = BF + Q * LDF * 4;         // f32 fragments
  static constexpr int S_HI = CB + TILES * 256 * 4;   // split S [p][n]
  static constexpr int S_LO = S_HI + TILE * LDH * 2;
  static constexpr int CUM = S_LO + TILE * LDH * 2;
  static constexpr int BYTES = CUM + GMAX * Q * 4;
  static constexpr int X4 = Q * TILE / 4 / THREADS;   // prefetched float4s
  static constexpr int S4 = STATE / 4 / THREADS;
  static_assert(2 * Q * LDH * 2 <= Q * LDF * 4, "X tiles fit B's staging");
};

__device__ __forceinline__ int row_tile(int warp, int W) {
  return W == 8 && (warp / 4) % 2 ? 7 - warp % 4 : warp % W;
}

template <int Q>
__device__ __forceinline__ void load_head(const ScanArgs& a, float4* xr,
                                          float4* sr, size_t row0, size_t sidx,
                                          int h, int L) {
  using L_ = OutSmem<Q>;
#pragma unroll
  for (int k = 0; k < L_::X4; ++k) {
    const int i = threadIdx.x + k * L_::THREADS, s = i / 16, p = 4 * (i % 16);
    xr[k] = s < L ? load4(a.dtx + ((row0 + s) * a.H + h) * a.P, p, a.P,
                          a.vec_x)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float4* st = reinterpret_cast<const float4*>(a.states + sidx * STATE);
#pragma unroll
  for (int k = 0; k < L_::S4; ++k) sr[k] = st[threadIdx.x + k * L_::THREADS];
}

template <int Q>
__global__ void __launch_bounds__(OutSmem<Q>::THREADS, 1)
mamba_scan_chunk_output_kernel(const ScanArgs a) {
  using L_ = OutSmem<Q>;
  constexpr int W = L_::W, THREADS = L_::THREADS;
  extern __shared__ __align__(16) uint8_t smem[];
  float* cf = reinterpret_cast<float*>(smem + L_::CF);
  float* bf = reinterpret_cast<float*>(smem + L_::BF);
  __nv_bfloat16* xh = reinterpret_cast<__nv_bfloat16*>(smem + L_::X_HI);
  __nv_bfloat16* xl = reinterpret_cast<__nv_bfloat16*>(smem + L_::X_LO);
  float* cbs = reinterpret_cast<float*>(smem + L_::CB);
  __nv_bfloat16* sh = reinterpret_cast<__nv_bfloat16*>(smem + L_::S_HI);
  __nv_bfloat16* sl = reinterpret_cast<__nv_bfloat16*>(smem + L_::S_LO);
  float* cum = reinterpret_cast<float*>(smem + L_::CUM);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, tig = lane % 4;
  const int c = blockIdx.x, bi = blockIdx.z;
  const int h0 = blockIdx.y * a.group, G = min(a.group, a.H - h0);
  const int t0 = c * Q, L = min(Q, a.S - t0);
  const size_t row0 = static_cast<size_t>(bi) * a.S + t0;
  const size_t sidx0 = (static_cast<size_t>(bi) * a.nc + c) * a.H + h0;

  float4 xr[L_::X4], sr[L_::S4];
  load_head<Q>(a, xr, sr, row0, sidx0, h0, L);
  {   // C and B, f32 [t][n], every load issued before the stores
    constexpr int K = Q * 16 / THREADS;
    float4 cv[K], bv[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = tid + k * THREADS, s = i / 16, n = 4 * (i % 16);
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      cv[k] = s < L ? load4(a.C + (row0 + s) * a.N, n, a.N, a.vec_bc) : zero;
      bv[k] = s < L ? load4(a.B + (row0 + s) * a.N, n, a.N, a.vec_bc) : zero;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = tid + k * THREADS, s = i / 16, n = 4 * (i % 16);
      *reinterpret_cast<float4*>(cf + s * LDF + n) = cv[k];
      *reinterpret_cast<float4*>(bf + s * LDF + n) = bv[k];
    }
  }
  // (syncs C and B too)
  chunk_cumsum<Q>(a.a_log, a.H, cum, row0, h0, G, L, THREADS);

  const int rt = row_tile(warp, W), t_lo = 16 * rt + g, t_hi = t_lo + 8;
  const int ch = warp / W;   // this warp's half of P
  // C.B^T, the tiles (rt, kk <= rt) of this warp's rows, every other one
  // (the other warp of the row tile takes the rest): A = C rows, B = B^T,
  // both from f32 and split in registers; kept as f32 fragments.
  for (int kk = ch; kk <= rt; kk += 2) {
    float acc[2][4] = {};
#pragma unroll
    for (int ks = 0; ks < TILE / 16; ++ks) {
      const int n = 16 * ks + 2 * tig;
      uint32_t ah[4], al[4];
      const float2 c0 = *reinterpret_cast<const float2*>(cf + t_lo * LDF + n);
      const float2 c1 = *reinterpret_cast<const float2*>(cf + t_hi * LDF + n);
      const float2 c2 = *reinterpret_cast<const float2*>(cf + t_lo * LDF + n + 8);
      const float2 c3 = *reinterpret_cast<const float2*>(cf + t_hi * LDF + n + 8);
      split2(c0.x, c0.y, ah[0], al[0]);
      split2(c1.x, c1.y, ah[1], al[1]);
      split2(c2.x, c2.y, ah[2], al[2]);
      split2(c3.x, c3.y, ah[3], al[3]);
      uint32_t bhi[2][2], blo[2][2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const float* brow = bf + (16 * kk + 8 * jj + g) * LDF + n;
        const float2 b0 = *reinterpret_cast<const float2*>(brow);
        const float2 b1 = *reinterpret_cast<const float2*>(brow + 8);
        split2(b0.x, b0.y, bhi[jj][0], blo[jj][0]);
        split2(b1.x, b1.y, bhi[jj][1], blo[jj][1]);
      }
      mma3<2>(acc, ah, al, bhi, blo);
    }
    float4* tile = reinterpret_cast<float4*>(
        cbs + (rt * (rt + 1) / 2 + kk) * 256);
    tile[lane] = make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]);
    tile[32 + lane] = make_float4(acc[1][0], acc[1][1], acc[1][2], acc[1][3]);
  }

  const int mat = lane / 8, r = lane % 8;
  // ldmatrix lane addresses: X [s][p] transposed (B = X), S [p][n] as is
  // (B = S^T), each x4 covering two n8 tiles of p.
  const uint32_t x_off = ((8 * (mat % 2) + r) * LDH + 8 * (mat / 2)) * 2;
  const uint32_t s_off = ((8 * (mat / 2) + r) * LDH + 8 * (mat % 2)) * 2;
  const uint32_t sxh = smem_addr(xh), sxl = smem_addr(xl);
  const uint32_t ssh = smem_addr(sh), ssl = smem_addr(sl);

  for (int j = 0; j < G; ++j) {
    const int h = h0 + j;
    const float* cj = cum + j * Q;
    __syncthreads();   // C.B^T is written; the previous head's tiles are read
#pragma unroll
    for (int k = 0; k < L_::X4; ++k) {
      const int i = tid + k * THREADS, s = i / 16, p = 4 * (i % 16);
      uint2 hi, lo;
      split4(xr[k], hi, lo);
      *reinterpret_cast<uint2*>(xh + s * LDH + p) = hi;
      *reinterpret_cast<uint2*>(xl + s * LDH + p) = lo;
    }
#pragma unroll
    for (int k = 0; k < L_::S4; ++k) {
      const int i = tid + k * THREADS, p = i / 16, n = 4 * (i % 16);
      uint2 hi, lo;
      split4(sr[k], hi, lo);
      *reinterpret_cast<uint2*>(sh + p * LDH + n) = hi;
      *reinterpret_cast<uint2*>(sl + p * LDH + n) = lo;
    }
    __syncthreads();
    if (j + 1 < G) load_head<Q>(a, xr, sr, row0, sidx0 + j + 1, h + 1, L);

    float acc[4][4] = {};
    const float ct_lo = cj[t_lo], ct_hi = cj[t_hi];
    // The inter term: A = e^{cum_t} C_t (f32, scaled, then split), B = S^T.
    {
      const float e_lo = expf(ct_lo), e_hi = expf(ct_hi);
#pragma unroll
      for (int ks = 0; ks < TILE / 16; ++ks) {
        const int n = 16 * ks + 2 * tig;
        uint32_t ah[4], al[4];
        const float2 c0 = *reinterpret_cast<const float2*>(cf + t_lo * LDF + n);
        const float2 c1 = *reinterpret_cast<const float2*>(cf + t_hi * LDF + n);
        const float2 c2 =
            *reinterpret_cast<const float2*>(cf + t_lo * LDF + n + 8);
        const float2 c3 =
            *reinterpret_cast<const float2*>(cf + t_hi * LDF + n + 8);
        split2(e_lo * c0.x, e_lo * c0.y, ah[0], al[0]);
        split2(e_hi * c1.x, e_hi * c1.y, ah[1], al[1]);
        split2(e_lo * c2.x, e_lo * c2.y, ah[2], al[2]);
        split2(e_hi * c3.x, e_hi * c3.y, ah[3], al[3]);
        uint32_t bhi[4][2], blo[4][2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const uint32_t off = s_off + (16 * (2 * ch + q) * LDH + 16 * ks) * 2;
          ldsm_b2<false>(*reinterpret_cast<uint32_t(*)[2][2]>(bhi[2 * q]),
                         ssh + off);
          ldsm_b2<false>(*reinterpret_cast<uint32_t(*)[2][2]>(blo[2 * q]),
                         ssl + off);
        }
        mma3<4>(acc, ah, al, bhi, blo);
      }
    }
    // The intra term: G = C.B^T (.) e^{cum_t - cum_s}, masked (s <= t)
    // before the exp, from the f32 fragments to the A fragments.
    for (int kk = 0; kk <= rt; ++kk) {
      const float4* tile = reinterpret_cast<const float4*>(
          cbs + (rt * (rt + 1) / 2 + kk) * 256);
      const float4 v0 = tile[lane], v1 = tile[32 + lane];
      const int s0 = 16 * kk + 2 * tig;
      const float2 cs0 = *reinterpret_cast<const float2*>(cj + s0);
      const float2 cs1 = *reinterpret_cast<const float2*>(cj + s0 + 8);
      const bool diag = kk == rt;
      auto gate = [&](float cb, float ct, int t, float cs, int s) {
        return cb * expf(!diag || s <= t ? ct - cs : NEG_INF);
      };
      uint32_t ah[4], al[4];
      split2(gate(v0.x, ct_lo, t_lo, cs0.x, s0),
             gate(v0.y, ct_lo, t_lo, cs0.y, s0 + 1), ah[0], al[0]);
      split2(gate(v0.z, ct_hi, t_hi, cs0.x, s0),
             gate(v0.w, ct_hi, t_hi, cs0.y, s0 + 1), ah[1], al[1]);
      split2(gate(v1.x, ct_lo, t_lo, cs1.x, s0 + 8),
             gate(v1.y, ct_lo, t_lo, cs1.y, s0 + 9), ah[2], al[2]);
      split2(gate(v1.z, ct_hi, t_hi, cs1.x, s0 + 8),
             gate(v1.w, ct_hi, t_hi, cs1.y, s0 + 9), ah[3], al[3]);
      uint32_t bhi[4][2], blo[4][2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const uint32_t off = x_off + (16 * kk * LDH + 16 * (2 * ch + q)) * 2;
        ldsm_b2<true>(*reinterpret_cast<uint32_t(*)[2][2]>(bhi[2 * q]),
                      sxh + off);
        ldsm_b2<true>(*reinterpret_cast<uint32_t(*)[2][2]>(blo[2 * q]),
                      sxl + off);
      }
      mma3<4>(acc, ah, al, bhi, blo);
    }
    // y rows t < L, columns p < P.
#pragma unroll
    for (int pt = 0; pt < 4; ++pt) {
      const int p = 32 * ch + 8 * pt + 2 * tig;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = half ? t_hi : t_lo;
        if (t >= L || p >= a.P) continue;
        float* yrow = a.y + ((row0 + t) * a.H + h) * a.P;
        const float v0 = acc[pt][2 * half], v1 = acc[pt][2 * half + 1];
        if (a.vec_x)
          *reinterpret_cast<float2*>(yrow + p) = make_float2(v0, v1);
        else {
          yrow[p] = v0;
          if (p + 1 < a.P) yrow[p + 1] = v1;
        }
      }
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int Q>
int launch(ScanArgs a, int b, int group1, int group3, cudaStream_t stream) {
  cudaError_t err;
  const int hg1 = (a.H + group1 - 1) / group1;
  const int hg3 = (a.H + group3 - 1) / group3;
  if ((err = allow_smem(mamba_scan_chunk_state_kernel<Q>,
                        StateSmem<Q>::BYTES)) != cudaSuccess ||
      (err = allow_smem(mamba_scan_chunk_output_kernel<Q>,
                        OutSmem<Q>::BYTES)) != cudaSuccess)
    return static_cast<int>(err);
  a.group = group1;
  mamba_scan_chunk_state_kernel<Q>
      <<<dim3(a.nc, hg1, b), PHASE1_THREADS, StateSmem<Q>::BYTES, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int count = b * a.H * (STATE / 4);
  mamba_scan_state_pass_kernel<<<(count + PASS_THREADS - 1) / PASS_THREADS,
                                 PASS_THREADS, 0, stream>>>(a, count);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  a.group = group3;
  mamba_scan_chunk_output_kernel<Q>
      <<<dim3(a.nc, hg3, b), OutSmem<Q>::THREADS, OutSmem<Q>::BYTES,
         stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename Kernel>
int resident_of(Kernel kernel, int threads, int bytes) {
  int device = 0, sms = 0, blocks = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess ||
      allow_smem(kernel, bytes) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                    bytes) != cudaSuccess)
    return 0;
  return blocks * sms;
}

template <int Q>
int resident(int phase) {
  return phase == 1 ? resident_of(mamba_scan_chunk_state_kernel<Q>,
                                  PHASE1_THREADS, StateSmem<Q>::BYTES)
                    : resident_of(mamba_scan_chunk_output_kernel<Q>,
                                  OutSmem<Q>::THREADS, OutSmem<Q>::BYTES);
}

}  // namespace

// Launches the three phases on `stream` of CUDA device `device`, checking
// each launch, and returns the first CUDA error (0 on success).  dtx is (b,
// S, H, P), a (b, S, H), B and C (b, S, N), y (b, S, H, P), all contiguous
// float32; `states` is scratch of b * nc * H * (64 * 64 + 1) floats, nc =
// ceil(S / chunk); group1 and group3 are the heads per block of phases 1
// and 3 (1 to 32).  The caller checks shapes, 1 <= P, N <= 64, S >= 1 and
// every input's size below 2**31.
extern "C" int mamba_scan_sm90_f32(const void* dtx, const void* a_log,
                                   const void* B, const void* C, void* y,
                                   void* states, int b, int S, int H, int P,
                                   int N, int chunk, int group1, int group3,
                                   int device, void* stream) {
  if (group1 < 1 || group1 > GMAX || group3 < 1 || group3 > GMAX ||
      (chunk != 64 && chunk != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  ScanArgs a;
  a.dtx = static_cast<const float*>(dtx);
  a.a_log = static_cast<const float*>(a_log);
  a.B = static_cast<const float*>(B);
  a.C = static_cast<const float*>(C);
  a.y = static_cast<float*>(y);
  a.nc = (S + chunk - 1) / chunk;
  a.states = static_cast<float*>(states);
  a.decay = a.states + static_cast<size_t>(b) * a.nc * H * STATE;
  a.S = S; a.H = H; a.P = P; a.N = N;
  a.vec_x = P % 4 == 0 && reinterpret_cast<uintptr_t>(dtx) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(y) % 16 == 0;
  a.vec_bc = N % 4 == 0 && reinterpret_cast<uintptr_t>(B) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(C) % 16 == 0;
  int current = device;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int result = chunk == 64 ? launch<64>(a, b, group1, group3, s)
                                 : launch<128>(a, b, group1, group3, s);
  if (current != device) cudaSetDevice(current);
  return result;
}

// How many blocks of phase `phase` (1: chunk states, 3: chunk outputs) at
// chunk `chunk` the current device holds at once (0 on error).
extern "C" int mamba_scan_sm90_resident_blocks(int phase, int chunk) {
  return chunk == 64 ? resident<64>(phase) : chunk == 128 ? resident<128>(phase)
                                                          : 0;
}

// Dynamic shared memory of phase `phase` (1 or 3) at chunk `chunk`.
extern "C" int mamba_scan_sm90_smem_bytes(int phase, int chunk) {
  if (chunk == 64) return phase == 1 ? StateSmem<64>::BYTES
                                     : OutSmem<64>::BYTES;
  if (chunk == 128) return phase == 1 ? StateSmem<128>::BYTES
                                      : OutSmem<128>::BYTES;
  return 0;
}

extern "C" const char* mamba_scan_sm90_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

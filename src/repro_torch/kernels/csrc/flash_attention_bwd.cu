// Flash attention backward in f32 for Hopper (sm_90a), on the CUDA cores:
// dq, dk and dv of the forward in flash_attention.cu, for the output
// gradient dO.  GQA, causal (top-left), optional sliding window and logit
// softcap; f32 in and out.  bf16 inputs go to the tensor-core backward in
// flash_attention_bwd_sm90.cu, whose header gives the formulas; this file
// computes the same ones, exact to reordered f32 sums.
//
// The Pallas TPU kernel src/repro/kernels/flash_attention.py:84 has no
// backward (JAX trains through the einsum attention_scores,
// src/repro/models/layers.py:114); this gives the port's f32 forward kernel
// its gradient.  What bounds it on an H100 SXM: the five products, 10*D
// operations per visible (query, key) pair (S, dP, dV, dK, dQ), at
// 67 TFLOP/s, f32 on the CUDA cores; the bytes (q, k, v, O, dO, lse read
// once, dq, dk, dv written once) are some 10^2 times fewer at a training
// shape.  It stays off the tensor cores because f32 inputs are held exact
// to reordered f32 sums, which TF32 cannot give.
//
// Two launches:
//   (a) flash_bwd_f32_prep_kernel, eight lanes a query row: D_i =
//       rowsum(dO * O) from the forward's exact f32 O, and the lse, both
//       per row padded to whole 64-row tiles (0 past S), and the dQ
//       tiles' counters set to 0;
//   (b) flash_bwd_f32_kernel, one CTA per (BK-key tile, KV head): K and V
//       stay in shared memory; the CTA walks the group's query heads and,
//       per head, the BQ-query tiles that some key of the tile sees, from
//       the last down.  Per step, S^T = K.Q^T and dP^T = V.dO^T are
//       computed once, P^T and dS^T from them, dV += P^T.dO and dK +=
//       dS^T.Q accumulate in registers, and the step's dQ part dS.K is
//       added into the f32 dq itself: 10*D operations a pair.
//
// What sets the pace.  An SM's shared memory hands a warp one float a lane
// a cycle while its four schedulers issue four warp FMAs, so a product fed
// from shared memory keeps the FMA pipe busy only if each thread does four
// FMAs or more for every float it loads: a patch of 8 x 8 outputs a thread
// (4 x 4 gives two).  Roles in a CTA of three warpgroups: the producer
// (registers lowered to 40 with setmaxnreg; its first warp loads and
// writes), group A (S^T, P^T, dV) and group B (dP^T, dS^T, dK), each
// raised to 232 registers, so that a thread holds one key accumulator (dV
// or dK, 8 keys x 8 columns at D = 64) and one 8 x 8 score patch (TM keys
// x TN queries of two-float dot products over D, rows interleaved and
// padded to D + 4 floats, so that a warp's loads fall in distinct banks or
// are one address broadcast).  dV, dK and the dQ part are outer products
// of a run of rows and two to five column chunks a thread.  The dQ part is
// split by keys: each group takes its half of the tile's keys over the
// whole BQ x D part.
//
// The groups meet only where the data flows: B waits for A's P^T x'
// (P_READY), A for B's dS^T (DS_READY), and A overwrites dS^T with the next
// step's P^T x' only after B's last read of it (DS_READ); otherwise each
// group runs on (A's next S^T beside B's dK and dQ part).  The elementwise
// passes are branch-free (one softcap and one mask branch a step, the
// statistics read into registers first): with a branch an element the
// patch's elements did not overlap and the passes took a third of a step.
//
// The producer's lanes load K and V once and Q, dO, lse and D_i of the
// next steps into a two-stage ring, one bulk copy a row into rows padded
// to D + 4 floats (rows past S or T repeat the last row: their pairs are
// masked, so they add nothing), the copies' bytes counted on the stage's
// mbarrier.  Each group writes its dQ part into the stage's rows that it
// alone read last (A into dO's, B into Q's); the producer's lane 0 adds
// both into dq with bulk reductions (cp.reduce.async.bulk .add.f32) and
// then reloads the stage, so no consumer waits on global memory.
//
// Determinism.  The key tiles of a query tile add their parts in one fixed
// order, the lowest key tile first: each (query head, query tile) has a
// counter; the writer of the tile of rank r waits until the counter reads
// r (acquire), stores (rank 0) or adds A's part and then adds B's, waits
// for the bulk operations to complete, and raises the counter (release).
// Every element of dq gets its parts in that order, so two launches give
// the same bits.  The grid launches key tile 0 of every KV head, then tile
// 1, and so on (blockIdx.y = tile): a CTA waits only on CTAs launched
// before it; the lower tile, launched earlier and walking down from the
// same last query tile, reaches a shared query tile first, so the writer
// rarely waits; and on causal shapes the longest walks start first and the
// last wave is of short ones.
//
// Tiles (BK keys a CTA, BQ queries a step): 128 x 64 up to D = 64, 64 x 64
// at D = 80 and 96, 32 x 64 at D = 128 (more CTAs for GQA's few KV heads),
// 32 x 32 at D = 256.  P = expf(x - lse) with the accurate expf, the
// softcap through the accurate tanhf, as in the forward; masks only on
// tiles that cross the diagonal, a window's edge, S or T.  Key tiles that
// no query sees write zero dK and dV.
//
// Shared memory: K, V (2*BK*(D+4) floats), two stages of Q, dO
// (2*BQ*(D+4)) and their statistics, P^T and dS^T as [BQ][BK+4]: 207,936 B
// at D = 64, 189,504 at D = 96, 209,472 at D = 256.  What it leaves on the
// table (instrumented copies at minicpm-2b's 4x1024 layer, 36 heads of 64,
// on an NVIDIA H100 80GB HBM3 at 700.00 W): the 8 x 8 products reach about
// 0.6-0.7 of the FMA rate (their operands loaded a step ahead, or 8 x 8
// patches for the dQ part, gain 1 % or less); the ~130 row copies a step
// and ~260 a CTA keep the consumers waiting for tiles about 0.09 of their
// time (TMA boxes of D + 4 columns cut that to 0.04, but need tiles
// aligned to 128 bytes, and with them so aligned the kernel took 14 % more
// time); causal diagonal tiles compute their masked part (an eighth of the
// work at 128 x 64).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int GROUP = 128;               // threads of a consumer group
constexpr int CONSUMERS = 2 * GROUP;
constexpr int THREADS = GROUP + CONSUMERS;   // the producer warpgroup first
constexpr int STAGES = 2;
constexpr int TILE_ROWS = 64;            // the statistics' padding
constexpr int COUNTER_ROWS = 32;         // rows a counter slot stands for
// Named barriers (0 is __syncthreads), each of one group's arrivals and
// the other's waits (256 threads) or of one group alone (128): P_READY, A has
// written P^T x' and B may form dS^T from it; DS_READY, B has written dS^T
// and A may take its dQ part; DS_READ, B has read dS^T for the last time
// and A may overwrite it with the next step's P^T x'; GROUP_A_BAR and
// GROUP_B_BAR, within a group.
constexpr int P_READY = 1;
constexpr int GROUP_B_BAR = 2;
constexpr int DS_READ = 3;
constexpr int DS_READY = 4;
constexpr int GROUP_A_BAR = 5;

// A thread's share of an M x N product over a group's 128 threads: RM rows
// and NC chunks of W columns, chunk c at W * (col(t) + NN * c).  The rows
// are RM contiguous ones from row(t) (CONTIGUOUS) or row(t) + NM * r.  A
// warp is WM x WN threads (WN along N), so that its loads of a row chunk
// are WN adjacent chunks and its loads along M fall in distinct banks.
template <int M, int N, int RM, int NC, int W, bool CONTIGUOUS>
struct Split {
  static constexpr int NM = M / RM, NN = N / (W * NC);
  static constexpr int WN = NN < 8 ? NN : 8, WM = 32 / WN;
  static_assert(M % RM == 0 && N % (W * NC) == 0 && NM * NN == GROUP &&
                    NM % WM == 0 && NN % WN == 0,
                "product split");
  __device__ static int row(int t) {
    const int m = t / 32 / (NN / WN) * WM + t % 32 / WN;
    return CONTIGUOUS ? m * RM : m;
  }
  __device__ static int col(int t) {
    return t / 32 % (NN / WN) * WN + t % 32 % WN;
  }
};

template <int D>
struct Tiles {
  static constexpr int BK = D <= 64 ? 128 : D <= 96 ? 64 : 32;  // keys a CTA
  static constexpr int BQ = D == 256 ? 32 : 64;   // queries a step
  static constexpr int LDF = D + 4;               // K, V, Q, dO rows
  static constexpr int LDP = BK + 4;              // P^T, dS^T as [BQ][LDP]
  // S^T and dP^T: TM keys (kg + NKG * i) x TN queries (qg + NQG * j) a
  // thread of a group; a warp is 4 key groups x 8 query groups.
  static constexpr int TM = BK * BQ >= 4096 ? 8 : BK * BQ == 2048 ? 4 : 2;
  static constexpr int TN = BK * BQ / (GROUP * TM);
  static constexpr int NKG = BK / TM, NQG = BQ / TN;
  // dK and dV (a group each): KM contiguous keys x KC chunks of KW.
  static constexpr int KM = D == 16 || D == 128 || D == 256 ? 4 : 8;
  static constexpr int KW = D == 80 ? 1 : D == 96 ? 2 : 4;
  static constexpr int KC = BK * D / (GROUP * KM * KW);
  // The dQ part of a group's half of the keys: QM queries (interleaved) x
  // QC chunks of QW.
  static constexpr int QM = D == 16 ? 2 : D == 80 || D == 128 ? 8 : 4;
  static constexpr int QW = D == 80 ? 1 : 4;
  static constexpr int QC = BQ * D / (GROUP * QM * QW);
  using KSplit = Split<BK, D, KM, KC, KW, true>;
  using QSplit = Split<BQ, D, QM, QC, QW, false>;
  // Shared memory in floats after BAR_BYTES of mbarriers: K, V; the
  // stages (Q, dO, lse, D_i); P^T and dS^T as [BQ][LDP].  The dQ parts go
  // into the stage's dO (group A's) and Q (group B's) rows.
  static constexpr int BAR_BYTES = 64;
  static constexpr int K_OFF = 0, V_OFF = BK * LDF;
  static constexpr int STAGE_OFF = 2 * BK * LDF;
  static constexpr int STAGE_FLOATS = 2 * BQ * LDF + 2 * BQ;
  static constexpr int P_OFF = STAGE_OFF + STAGES * STAGE_FLOATS;
  static constexpr int DS_OFF = P_OFF + BQ * LDP;
  static constexpr int FLOATS = DS_OFF + BQ * LDP;
  static constexpr int SMEM = BAR_BYTES + 4 * FLOATS;
  static constexpr uint32_t KV_TX = 2u * BK * D * 4;
  static constexpr uint32_t STAGE_TX = 2u * BQ * D * 4 + 2u * BQ * 4;
  static_assert(D % 16 == 0 && TM * NKG == BK && TN * NQG == BQ &&
                    NKG % 4 == 0 && NQG % 8 == 0 && NKG * NQG == GROUP,
                "score split");
  static_assert(TILE_ROWS % BQ == 0 && BQ % COUNTER_ROWS == 0 && BK % 2 == 0,
                "tiles");
  static_assert(SMEM <= 232448, "shared memory");
};

// ---- PTX wrappers: mbarriers, bulk copies, the dQ order's counters ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar)) : "memory");
}

// Waits until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned)
// into shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
      "r"(smem_addr(bar)) : "memory");
}

// `bytes` contiguous bytes of shared memory stored to (or, with `add`,
// added in f32 to) global memory, as one bulk group; waits until done.
__device__ __forceinline__ void bulk_store_f32(float* dst, const float* src,
                                               uint32_t bytes, bool add) {
  if (add) {
    asm volatile(
        "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 "
        "[%0], [%1], %2;" ::"l"(reinterpret_cast<uint64_t>(dst)),
        "r"(smem_addr(src)), "r"(bytes) : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
            reinterpret_cast<uint64_t>(dst)),
        "r"(smem_addr(src)), "r"(bytes) : "memory");
  }
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Shared memory written by this thread is seen by later bulk copies.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Global memory: between the generic and the bulk copies' accesses.
__device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void red_release(int* p) {
  asm volatile("red.release.gpu.global.add.s32 [%0], 1;" ::"l"(p)
               : "memory");
}

// The warpgroup's registers a thread, lowered or raised.
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(N) : "memory");
}

// ---- the kernels ----

struct Args {
  const float* q;      // (BH, S, D)
  const float* k;      // (BKV, T, D)
  const float* v;
  const float* dout;   // (BH, S, D)
  const float* lse;    // (BH, S_pad): the forward's lse, 0 past S
  const float* di;     // (BH, S_pad): D_i, 0 past S
  float* dq;           // (BH, S, D)
  float* dk;           // (BKV, T, D)
  float* dv;
  int* counters;       // (BH, S_pad / 32): adds made to each dQ tile
  int S, T, S_pad, n_kt, group, causal, window;
  float scale, softcap, scale_cap;   // scale_cap = scale / softcap
};

__device__ __forceinline__ bool visible(int i, int j, int S, int T,
                                        int causal, int window) {
  return (i < S) & (j < T) & (!causal | (j <= i)) &
         ((window <= 0) | (j > i - window));
}

__device__ __forceinline__ float dot4(float4 x, float4 y, float acc) {
  acc = fmaf(x.x, y.x, acc);
  acc = fmaf(x.y, y.y, acc);
  acc = fmaf(x.z, y.z, acc);
  return fmaf(x.w, y.w, acc);
}

// N contiguous floats from shared memory (p aligned to min(N, 4) floats).
template <int N>
__device__ __forceinline__ void load_run(float* x, const float* p) {
  if constexpr (N == 1) {
    x[0] = p[0];
  } else if constexpr (N == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    x[0] = a.x;
    x[1] = a.y;
  } else {
#pragma unroll
    for (int h = 0; h < N / 4; ++h) {
      const float4 a = *reinterpret_cast<const float4*>(p + 4 * h);
      x[4 * h] = a.x;
      x[4 * h + 1] = a.y;
      x[4 * h + 2] = a.z;
      x[4 * h + 3] = a.w;
    }
  }
}

// N contiguous floats to shared memory.
template <int N>
__device__ __forceinline__ void store_run(float* p, const float* x) {
  if constexpr (N == 1) {
    p[0] = x[0];
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  }
}

// acc[r][W * c + e] += sum_{l < L} a(l, r) * B[l * ldb + W * (n0 + NN * c) +
// e]: a thread's patch of an outer-product sum over L, both operands in
// shared memory; a(l, r) = A[l * lda + r] for contiguous rows (A at the
// thread's first row), else A[l + r * lda] (rows of A of stride lda, A at
// the thread's first row).
template <int L, int RM, int NC, int W, int NN, bool CONTIGUOUS>
__device__ __forceinline__ void outer(float (&acc)[RM][W * NC],
                                      const float* A, int lda,
                                      const float* B, int ldb, int n0) {
#pragma unroll 4
  for (int l = 0; l < L; ++l) {
    float a[RM];
    if constexpr (CONTIGUOUS) {
      load_run<RM>(a, A + l * lda);
    } else {
#pragma unroll
      for (int r = 0; r < RM; ++r) a[r] = A[l + r * lda];
    }
    float b[NC][W];
#pragma unroll
    for (int c = 0; c < NC; ++c)
      load_run<W>(b[c], B + l * ldb + W * (n0 + NN * c));
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < W; ++e)
          acc[r][W * c + e] = fmaf(a[r], b[c][e], acc[r][W * c + e]);
  }
}

// s[i][j] = X[kg + NKG * i] . Y[qg + NQG * j] over D: a thread's patch of
// S^T (X = K, Y = Q) or dP^T (X = V, Y = dO), rows of stride D + 4, two
// floats a load.
template <int D>
__device__ __forceinline__ void scores(
    float (&s)[Tiles<D>::TM][Tiles<D>::TN], const float* X, const float* Y,
    int kg, int qg) {
  using C = Tiles<D>;
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int j = 0; j < C::TN; ++j) s[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 2) {
    float2 x[C::TM], y[C::TN];
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
      x[i] = *reinterpret_cast<const float2*>(X + (kg + C::NKG * i) * C::LDF +
                                              d);
#pragma unroll
    for (int j = 0; j < C::TN; ++j)
      y[j] = *reinterpret_cast<const float2*>(Y + (qg + C::NQG * j) * C::LDF +
                                              d);
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
#pragma unroll
      for (int j = 0; j < C::TN; ++j)
        s[i][j] = fmaf(x[i].y, y[j].y, fmaf(x[i].x, y[j].x, s[i][j]));
  }
}

// (a): D_i = sum_d dO_id O_id and the lse, eight lanes a row of the padded
// (BH, S_pad) layout (0 past S), 16 bytes a load; and the counters set to
// 0.
__global__ void __launch_bounds__(256)
flash_bwd_f32_prep_kernel(const float* __restrict__ dout,
                          const float* __restrict__ o,
                          const float* __restrict__ lse,
                          float* __restrict__ di, float* __restrict__ lse_pad,
                          int* __restrict__ counters, int S, int S_pad,
                          int rows, int D) {
  const int row = blockIdx.x * 32 + threadIdx.x / 8;
  const int part = threadIdx.x % 8;
  if (row >= rows) return;   // whole groups of eight lanes leave together
  const int bh = row / S_pad, s = row % S_pad;
  float sum = 0.f, l = 0.f;
  if (s < S) {
    const size_t base = (static_cast<size_t>(bh) * S + s) * D;
    for (int c = 4 * part; c < D; c += 32) {
      const float4 g = *reinterpret_cast<const float4*>(dout + base + c);
      const float4 x = *reinterpret_cast<const float4*>(o + base + c);
      sum = dot4(g, x, sum);
    }
    l = lse[static_cast<size_t>(bh) * S + s];
  }
  const unsigned lanes = 0xffu << (threadIdx.x % 32 / 8 * 8);
#pragma unroll
  for (int off = 4; off > 0; off >>= 1)
    sum += __shfl_xor_sync(lanes, sum, off);
  if (part == 0) {
    di[row] = sum;
    lse_pad[row] = l;
    if (s % COUNTER_ROWS == 0)
      counters[static_cast<size_t>(bh) * (S_pad / COUNTER_ROWS) +
               s / COUNTER_ROWS] = 0;
  }
}

// The query tiles that some key of the BK keys from k0 sees: nq of them from
// q_lo, walked for each of the group's query heads from the last down.
struct Walk {
  int q_lo, nq, steps;
  __device__ int tile(int n) const { return q_lo + nq - 1 - n % nq; }
};
template <int BK, int BQ>
__device__ __forceinline__ Walk walk(const Args& a, int k0) {
  const int n_q = (a.S + BQ - 1) / BQ;
  int q_lo = 0, q_hi = n_q;
  if (a.causal) q_lo = k0 <= a.S - 1 ? k0 / BQ : n_q;
  if (a.window > 0) {
    const int k_max = min(k0 + BK - 1, a.T - 1);
    q_hi = min(q_hi, (k_max + a.window - 1) / BQ + 1);
  }
  const int nq = max(0, q_hi - q_lo);
  return {q_lo, nq, a.group * nq};
}

// Group A's P^T and P^T x' of its patch of raw scores s into shared
// memory (x' = dx/ds through the softcap and the 1/sqrt(D) scale),
// invisible pairs 0 where EDGE: branch-free, so that the patch's elements
// overlap.
template <int D, bool SOFTCAP, bool EDGE>
__device__ __forceinline__ void probabilities(
    const Args& a, const float (&s)[Tiles<D>::TM][Tiles<D>::TN],
    const float (&lse)[Tiles<D>::TN], float* sp, float* spx, int kg, int qg,
    int k0, int q0) {
  using C = Tiles<D>;
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int j = 0; j < C::TN; ++j) {
      const int kk = kg + C::NKG * i, qq = qg + C::NQG * j;
      float x, dx;
      if constexpr (SOFTCAP) {
        const float t = tanhf(s[i][j] * a.scale_cap);
        x = a.softcap * t;
        dx = (1.f - t * t) * a.scale;
      } else {
        x = s[i][j] * a.scale;
        dx = a.scale;
      }
      float p = expf(x - lse[j]);
      if constexpr (EDGE)
        p = visible(q0 + qq, k0 + kk, a.S, a.T, a.causal, a.window) ? p : 0.f;
      sp[qq * C::LDP + kk] = p;
      spx[qq * C::LDP + kk] = p * dx;
    }
}

// A group's dQ part dS.K over its half of the keys (``half`` 0: group A,
// 1: group B) into `out` as a dense [BQ][D] block for the writer.
template <int D>
__device__ __forceinline__ void dq_part(const float* ds, const float* k,
                                        float* out, int half, int g) {
  using C = Tiles<D>;
  using Q = typename C::QSplit;
  constexpr int HK = C::BK / 2;
  const int m0 = Q::row(g), n0 = Q::col(g);
  float acc[C::QM][C::QW * C::QC];
#pragma unroll
  for (int r = 0; r < C::QM; ++r)
#pragma unroll
    for (int c = 0; c < C::QW * C::QC; ++c) acc[r][c] = 0.f;
  outer<HK, C::QM, C::QC, C::QW, Q::NN, false>(
      acc, ds + m0 * C::LDP + half * HK, Q::NM * C::LDP,
      k + half * HK * C::LDF, C::LDF, n0);
#pragma unroll
  for (int r = 0; r < C::QM; ++r)
#pragma unroll
    for (int c = 0; c < C::QC; ++c)
      store_run<C::QW>(out + (m0 + Q::NM * r) * D + C::QW * (n0 + Q::NN * c),
                       &acc[r][C::QW * c]);
  fence_async_shared();
}

// A consumer group's key accumulator (dV for A, dK for B) to global
// memory, rows past T dropped.
template <int D>
__device__ __forceinline__ void store_keys(
    float* dst, const float (&acc)[Tiles<D>::KM][Tiles<D>::KW * Tiles<D>::KC],
    int k0, int T, int m0, int n0) {
  using C = Tiles<D>;
#pragma unroll
  for (int r = 0; r < C::KM; ++r) {
    if (k0 + m0 + r >= T) continue;
#pragma unroll
    for (int c = 0; c < C::KC; ++c)
      store_run<C::KW>(dst + static_cast<size_t>(k0 + m0 + r) * D +
                           C::KW * (n0 + C::KSplit::NN * c),
                       &acc[r][C::KW * c]);
  }
}

// (b): dK and dV of one BK-key tile of one KV head, and its dQ parts.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_f32_kernel(const __grid_constant__ Args a) {
  using C = Tiles<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* const kv_full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* const full = kv_full + 1;             // [STAGES]
  uint64_t* const dq_full = full + STAGES;        // [STAGES]
  float* const sm = reinterpret_cast<float*>(smem_raw + C::BAR_BYTES);
  float* const sk = sm + C::K_OFF;
  float* const sv = sm + C::V_OFF;
  float* const sp = sm + C::P_OFF;     // P^T as [BQ][LDP]
  float* const sds = sm + C::DS_OFF;   // P^T x' (A), then dS^T (B)

  const int kvh = blockIdx.x;
  const int kt = blockIdx.y;
  const int k0 = kt * C::BK;
  const Walk w = walk<C::BK, C::BQ>(a, k0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(dq_full + s, CONSUMERS / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp < GROUP / 32) {
    // The producer warpgroup gives its registers to the consumers; its
    // first warp loads (every lane copies rows, lane 0 counts the bytes)
    // and writes the dQ parts (lane 0).
    regs_dec<40>();
    if (warp != 0 || w.steps == 0) return;
    const size_t kv_off = static_cast<size_t>(kvh) * a.T * D;
    if (lane == 0) mbar_expect_tx(kv_full, C::KV_TX);
    __syncwarp();
    for (int r = lane; r < C::BK; r += 32) {
      const size_t row = kv_off + static_cast<size_t>(min(k0 + r, a.T - 1)) * D;
      bulk_load(sk + r * C::LDF, a.k + row, D * 4, kv_full);
      bulk_load(sv + r * C::LDF, a.v + row, D * 4, kv_full);
    }
    auto load_stage = [&](int n) {
      const int s = n % STAGES;
      const int bh = kvh * a.group + n / w.nq;
      const int q0 = w.tile(n) * C::BQ;
      float* const sq = sm + C::STAGE_OFF + s * C::STAGE_FLOATS;
      float* const sdo = sq + C::BQ * C::LDF;
      float* const st = sdo + C::BQ * C::LDF;
      if (lane == 0) {
        mbar_expect_tx(full + s, C::STAGE_TX);
        const size_t row = static_cast<size_t>(bh) * a.S_pad + q0;
        bulk_load(st, a.lse + row, C::BQ * 4, full + s);
        bulk_load(st + C::BQ, a.di + row, C::BQ * 4, full + s);
      }
      __syncwarp();
      for (int r = lane; r < C::BQ; r += 32) {
        const size_t row =
            (static_cast<size_t>(bh) * a.S + min(q0 + r, a.S - 1)) * D;
        bulk_load(sq + r * C::LDF, a.q + row, D * 4, full + s);
        bulk_load(sdo + r * C::LDF, a.dout + row, D * 4, full + s);
      }
    };
    for (int n = 0; n < STAGES && n < w.steps; ++n) load_stage(n);
    for (int n = 0; n < w.steps; ++n) {
      const int s = n % STAGES;
      if (lane == 0) {
        // The two groups' parts, in the query tile's turn: A's (the first
        // half of the keys, in the dO rows) stored (rank 0) or added, then
        // B's (in the Q rows) added.
        const int bh = kvh * a.group + n / w.nq;
        const int qi = w.tile(n);
        const int q0 = qi * C::BQ;
        const int kt_lo = a.window > 0 ? max(0, q0 - a.window + 1) / C::BK : 0;
        const int rank = kt - kt_lo;   // lowest key tile first
        int* const cnt =
            a.counters + static_cast<size_t>(bh) * (a.S_pad / COUNTER_ROWS) +
            qi;
        const float* const part_b = sm + C::STAGE_OFF + s * C::STAGE_FLOATS;
        float* const dst = a.dq + (static_cast<size_t>(bh) * a.S + q0) * D;
        const uint32_t bytes = min(C::BQ, a.S - q0) * D * 4;
        mbar_wait(dq_full + s, (n / STAGES) & 1);
        if (rank > 0) {
          while (ld_acquire(cnt) != rank) {
          }
          fence_async_global();
        }
        bulk_store_f32(dst, part_b + C::BQ * C::LDF, bytes, rank > 0);
        bulk_store_f32(dst, part_b, bytes, true);
        fence_async_global();
        red_release(cnt);
      }
      __syncwarp();
      if (n + STAGES < w.steps) load_stage(n + STAGES);
    }
    return;
  }

  // Consumers: group A (warpgroup 1) S^T, P^T, dV; group B (warpgroup 2)
  // dP^T, dS^T, dK; each the dQ part of its half of the keys.
  regs_inc<232>();
  const bool group_a = warp < 2 * GROUP / 32;
  const int g = threadIdx.x % GROUP;
  const int gw = g / 32, gl = g % 32;
  const int kg = gw % (C::NKG / 4) * 4 + gl % 4;   // S^T, dP^T patch
  const int qg = gw / (C::NKG / 4) * 8 + gl / 4;
  const int km0 = C::KSplit::row(g), kn0 = C::KSplit::col(g);
  float acc[C::KM][C::KW * C::KC];   // dV (A) or dK (B)
#pragma unroll
  for (int r = 0; r < C::KM; ++r)
#pragma unroll
    for (int c = 0; c < C::KW * C::KC; ++c) acc[r][c] = 0.f;
  if (w.steps > 0) mbar_wait(kv_full, 0);

  for (int n = 0; n < w.steps; ++n) {
    const int s = n % STAGES;
    const int q0 = w.tile(n) * C::BQ;
    float* const sq = sm + C::STAGE_OFF + s * C::STAGE_FLOATS;
    float* const sdo = sq + C::BQ * C::LDF;
    const float* const sl = sdo + C::BQ * C::LDF;   // lse
    const float* const sd = sl + C::BQ;             // D_i
    const bool edge = (a.causal && k0 + C::BK - 1 > q0) ||
                      (a.window > 0 && q0 + C::BQ - 1 - k0 >= a.window) ||
                      k0 + C::BK > a.T || q0 + C::BQ > a.S;
    mbar_wait(full + s, (n / STAGES) & 1);
    float sc[C::TM][C::TN];
    float st[C::TN];   // lse (A) or D_i (B) of the patch's queries
#pragma unroll
    for (int j = 0; j < C::TN; ++j)
      st[j] = (group_a ? sl : sd)[qg + C::NQG * j];
    if (group_a) {
      // S^T; once B has read the last dS^T, P^T and P^T x'.
      scores<D>(sc, sk, sq, kg, qg);
      if (n > 0) named_sync<CONSUMERS>(DS_READ);
      if (a.softcap > 0.f) {
        if (edge)
          probabilities<D, true, true>(a, sc, st, sp, sds, kg, qg, k0, q0);
        else
          probabilities<D, true, false>(a, sc, st, sp, sds, kg, qg, k0, q0);
      } else {
        if (edge)
          probabilities<D, false, true>(a, sc, st, sp, sds, kg, qg, k0, q0);
        else
          probabilities<D, false, false>(a, sc, st, sp, sds, kg, qg, k0, q0);
      }
      named_arrive<CONSUMERS>(P_READY);
      named_sync<GROUP>(GROUP_A_BAR);
      // dV += P^T.dO; then, with dS^T complete, the dQ part of the first
      // half of the keys into the dO rows, which only this group read
      // last.
      outer<C::BQ, C::KM, C::KC, C::KW, C::KSplit::NN, true>(
          acc, sp + km0, C::LDP, sdo, C::LDF, kn0);
      named_sync<CONSUMERS>(DS_READY);
      dq_part<D>(sds, sk, sdo, 0, g);
    } else {
      // dP^T; dS^T = P^T x' (dP^T - D_i) in place, a row's loads before its
      // stores; dK += dS^T.Q; the dQ part of the second half of the keys
      // into the Q rows once every thread of B has read them.
      scores<D>(sc, sv, sdo, kg, qg);
      named_sync<CONSUMERS>(P_READY);
#pragma unroll
      for (int i = 0; i < C::TM; ++i) {
        float px[C::TN];
#pragma unroll
        for (int j = 0; j < C::TN; ++j)
          px[j] = sds[(qg + C::NQG * j) * C::LDP + kg + C::NKG * i];
#pragma unroll
        for (int j = 0; j < C::TN; ++j)
          sds[(qg + C::NQG * j) * C::LDP + kg + C::NKG * i] =
              px[j] * (sc[i][j] - st[j]);
      }
      named_sync<GROUP>(GROUP_B_BAR);
      named_arrive<CONSUMERS>(DS_READY);
      outer<C::BQ, C::KM, C::KC, C::KW, C::KSplit::NN, true>(
          acc, sds + km0, C::LDP, sq, C::LDF, kn0);
      named_sync<GROUP>(GROUP_B_BAR);
      dq_part<D>(sds, sk, sq, 1, g);
      if (n + 1 < w.steps) named_arrive<CONSUMERS>(DS_READ);
    }
    __syncwarp();
    if (gl == 0) mbar_arrive(dq_full + s);
  }

  const size_t kv_off = static_cast<size_t>(kvh) * a.T * D;
  store_keys<D>((group_a ? a.dv : a.dk) + kv_off, acc, k0, a.T, km0, kn0);
}

// ---- the host side ----

template <int D>
int launch(Args a, const float* o, const float* lse, float* di,
           float* lse_pad, int BH, int BKV, cudaStream_t stream) {
  using C = Tiles<D>;
  a.n_kt = (a.T + C::BK - 1) / C::BK;
  const int rows = BH * a.S_pad;
  flash_bwd_f32_prep_kernel<<<(rows + 31) / 32, 256, 0, stream>>>(
      a.dout, o, lse, di, lse_pad, a.counters, a.S, a.S_pad, rows, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_f32_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Key tile 0 of every KV head first, then tile 1, and so on: within a
  // head the lowest key tile goes first, so a CTA waits only on CTAs
  // launched before it, and on causal shapes the longest walks start
  // first and the last wave is of short ones.
  flash_bwd_f32_kernel<D><<<dim3(BKV, a.n_kt), THREADS, C::SMEM, stream>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the two kernels on `stream` and returns the CUDA error (0 on
// success).  q, dout, o, dq: (BH, S, D); k, v, dk, dv: (BKV, T, D); all
// contiguous f32, 16-byte aligned; lse: (BH, S) f32 from the forward.
// Scratch, written here: di and lse_pad (BH, S_pad) f32 and counters (BH,
// S_pad / 32) int32, S_pad = S rounded up to 64, 16-byte aligned.  The
// caller checks shapes, BH % BKV == 0, D in {16, 32, 64, 80, 96, 128, 256},
// BKV within the grid's 65535 and every index below 2**31.
extern "C" int flash_attention_bwd_f32(
    const float* q, const float* k, const float* v, const float* o,
    const float* lse, const float* dout, float* dq, float* dk, float* dv,
    float* di, float* lse_pad, int* counters, int BH, int BKV, int S, int T,
    int D, int causal, int window, float softcap, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = lse_pad;
  a.di = di;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.counters = counters;
  a.S = S;
  a.T = T;
  a.S_pad = (S + TILE_ROWS - 1) / TILE_ROWS * TILE_ROWS;
  a.group = BH / BKV;
  a.causal = causal;
  a.window = window;
  a.scale = 1.0f / sqrtf(static_cast<float>(D));
  a.softcap = softcap;
  a.scale_cap = softcap > 0.f ? a.scale / softcap : 0.f;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(a, o, lse, di, lse_pad, BH, BKV, s);
    case 32: return launch<32>(a, o, lse, di, lse_pad, BH, BKV, s);
    case 64: return launch<64>(a, o, lse, di, lse_pad, BH, BKV, s);
    case 80: return launch<80>(a, o, lse, di, lse_pad, BH, BKV, s);
    case 96: return launch<96>(a, o, lse, di, lse_pad, BH, BKV, s);
    case 128: return launch<128>(a, o, lse, di, lse_pad, BH, BKV, s);
    case 256: return launch<256>(a, o, lse, di, lse_pad, BH, BKV, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The main kernel's dynamic shared memory at head dim D (0 if not built
// for D).
extern "C" int flash_attention_bwd_f32_smem_bytes(int D) {
  switch (D) {
    case 16: return Tiles<16>::SMEM;
    case 32: return Tiles<32>::SMEM;
    case 64: return Tiles<64>::SMEM;
    case 80: return Tiles<80>::SMEM;
    case 96: return Tiles<96>::SMEM;
    case 128: return Tiles<128>::SMEM;
    case 256: return Tiles<256>::SMEM;
    default: return 0;
  }
}

// Flash attention forward in f32 for Hopper (sm_90a), on the CUDA cores:
// online softmax, GQA, causal (top-left), optional sliding window and
// logit softcap; f32 in and out, statistics and accumulation.  bf16 inputs
// go to the tensor-core kernel in flash_attention_sm90.cu instead.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:84
// (flash_attention_kernel, body _kernel) for f32 inputs:
//
//   o[bh, i] = sum_j softmax_j( mask(i, j) ? c*tanh(q_i.k_j / (c*sqrt(D)))
//                                          : -1e30 ) * v_j
//
// with k, v of KV head bh / group, mask(i, j) = [j <= i if causal]
// and [j > i - window if window > 0], and c the softcap (none when 0).
// q is (BH, S, D), k and v are (BKV, T, D), BH = BKV * group.
//
// What bounds it on an H100 SXM: per (query, visible key) pair it does
// 4*D operations (q.k and p*v) on 4 bytes of q, k, v and o per element of
// each, read once: thousands of operations per byte at a prefill, far above
// the balance of 20 for f32 on the CUDA cores (67 TFLOP/s over 3.35 TB/s),
// so the bound is operations at 67 TFLOP/s.  It stays on the CUDA cores
// because f32 inputs are held exact to reordered f32 sums, which the
// tensor cores (TF32 at best for f32) cannot give.
//
// What sets the pace.  An SM's shared memory hands a warp one float a lane
// a cycle while its four schedulers issue four warp FMAs, so a product fed
// from shared memory keeps the FMA pipe busy only if each thread does four
// FMAs or more for every float it loads: register patches of 8 x 8 (4 x 4
// gives two).  The design:
//   * the unit of work, an item, is BQ = 2 * BQG query rows of one query
//     head; the grid is persistent, one CTA an SM (its shared memory allows
//     no second), and deals the items out in rounds, forward in even rounds
//     and backward in odd ones, every head's last query tile first: on
//     causal shapes the longest items run first and the CTAs' totals even
//     out;
//   * a CTA is three warpgroups: a producer, registers lowered to 40 with
//     setmaxnreg, whose 128 threads copy 16 bytes each with cp.async, and
//     two consumer groups raised to 232, each owning BQG rows of the item;
//     the KV head bh / group is read in place;
//   * K and V tiles of BK keys go through a ring of NBUF tile buffers (K of
//     step n, V of step n, K of step n + 1, ...) across items, one
//     mbarrier pair a buffer: full (each producer thread's arrival lands
//     with its copies, cp.async.mbarrier.arrive.noinc) and empty (the eight
//     consumer warps' releases); rows padded to D + 4 floats, so that a
//     warp's loads fall in distinct banks or are one address broadcast;
//     rows past T repeat the last row (their keys are -inf, so they add
//     nothing).  The next item's Q is copied once the consumers' last
//     product of the item before has read Q (q_empty), and the producer
//     scales it in place by log2(e) / sqrt(D) (1 / sqrt(D) with a softcap)
//     once its copies have landed, so Q and the first tiles are ready
//     while the consumers finish the item before;
//   * S = Q.K^T: a thread owns TM queries (qg + 8i) x TN keys (kg + 16j),
//     8 x 8 up to D = 64, sixteen-byte loads; a warp is 16 key groups x 2
//     query groups, so a row's statistics are reduced with shuffles within
//     half a warp;
//   * the elementwise pass is branch-free (one softcap and one mask branch
//     a step, the mask only on tiles that cross the diagonal, a window's
//     edge or T) and in base 2, one ex2.approx.ftz a logit (within two
//     ulps; results below 2^-126 flush to 0, beside a row sum of at least
//     1): masked logits are -1e30 as in JAX, keys past T -inf; a row whose
//     first visited tile is wholly masked takes 2^0 garbage that the first
//     visible key's alpha = 2^(-1e30 - m) = 0 wipes, and a row that sees no
//     key at all (S >= T + window) would get 0 where JAX gives the mean of
//     v, so the wrapper refuses such windows.  Each lane keeps its share of
//     a row's sum l, reduced once an item;
//   * group 1 starts an item's first product once group 0 has done its
//     own, so that the groups run about a product apart and one's softmax
//     overlaps the other's products;
//   * P goes through shared memory (as P^T, [BK][BQG + 4]) between the two
//     products, with one group barrier before it is written (the last
//     P.V is done) and one after;
//   * O += P.V: a thread owns 8 contiguous rows x (OW * OC) columns (8 x 8
//     at D = 16 to 64, 128 and 256; 8 x 5 at D = 80, 8 x 6 at D = 96),
//     over a KS-th of the tile's keys; the KS partial sums are added in a
//     fixed order at the end of the item, through the group's P^T rows, so
//     two launches give the same bits;
//   * an item walks only the key tiles that some pair of its rows sees.
// Tiles (BQG query rows a group, BK keys a step; shared memory):
//   D = 16, 32:  64 x 128, four buffers      121,984 and 162,944 B
//   D = 64:      64 x 128, three buffers     210,048 B
//   D = 80, 96:  64 x 64, four buffers       164,992 and 189,568 B
//   D = 128:     64 x 64, three buffers      204,928 B
//   D = 256:     32 x 32, four buffers       209,536 B
// Where the caller passes a pointer, the epilogue also writes each row's
// log-sum-exp of its logits in natural-log units (m ln 2 + ln l) for the
// backward in flash_attention_bwd.cu; o is computed the same way either
// way.  What it leaves on the table (python3 flash_f32_phases.py: phase
// clocks of an instrumented copy at minicpm-2b's 4x1024 layer, 36 heads of
// 64, on an NVIDIA H100 80GB HBM3 at 700.00 W): the two products take 0.71
// of the consumer warps' cycles at about 0.7 of the FMA rate, the shared-
// memory pipe as loaded as the FMA pipe (larger patches need more than 232
// registers beside the O accumulator, or more than 227 KB of shared
// memory); the softmax 0.14 and the P^T stores (2-way bank conflicts)
// 0.04; the epilogue 0.05; S patches of 8 x 4 at D = 80 to 128 and 4 x 2
// at D = 256; the masked part of causal diagonal tiles (skipping the
// second half of a diagonal tile for the lower group gained nothing: the
// other group walks the whole tile); tanhf a logit with a softcap; and
// grids of fewer items than SMs (whisper's 448-by-1500 cross clip: 80
// items, 52 SMs idle), which smaller items or a split of the keys would
// fill.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int GROUP = 128;                   // threads of a consumer group
constexpr int CONSUMERS = 2 * GROUP;
constexpr int THREADS = GROUP + CONSUMERS;   // the producer warpgroup first
constexpr int CONSUMER_WARPS = CONSUMERS / 32;
constexpr int GROUP_BAR = 1;                 // + group: named barriers
constexpr int SKEW_BAR = 3;
constexpr int PRODUCER_BAR = 4;
constexpr float MASKED = -1e30f;             // the JAX kernel's NEG_INF
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
#define NO_KEY __int_as_float(0xff800000)    // -inf

template <int D>
struct Tiles {
  static constexpr int BQG = D == 256 ? 32 : 64;   // query rows a group
  static constexpr int BQ = 2 * BQG;               // a CTA
  static constexpr int BK = D <= 64 ? 128 : D <= 128 ? 64 : 32;
  static constexpr int LDF = D + 4;                // Q, K, V rows
  static constexpr int LDP = BQG + 4;              // P^T as [BK][LDP]
  // S: TM queries (qg + 8i) x TN keys (kg + 16j) a thread.
  static constexpr int TM = BQG / 8, TN = BK / 16;
  // O: RM contiguous rows x OC chunks of OW columns, chunk c at OW * (n +
  // NN * c), over KPART keys; NM x NN threads a part, KS parts.
  static constexpr int RM = 8;
  static constexpr int OW = D == 80 ? 1 : D == 96 ? 2 : 4;
  static constexpr int OC = D == 16 ? 1 : D == 80 ? 5 : D == 96 ? 3 : 2;
  static constexpr int NM = BQG / RM, NN = D / (OW * OC);
  static constexpr int KS = GROUP / (NM * NN), KPART = BK / KS;
  static constexpr int WN = NN < 8 ? NN : 8, WM = 32 / WN;   // a warp
  static constexpr int NBUF = D == 64 || D == 128 ? 3 : 4;
  // Shared memory in floats after BAR_BYTES of mbarriers: the NBUF tile
  // buffers, then per group Q [BQG][LDF], P^T [BK][LDP] and its rows'
  // alpha and l.  At the end of a query tile the parts ks >= 1 of O go
  // where the group's P^T was.
  static constexpr int BAR_BYTES = 128;
  static constexpr int TILE_FLOATS = BK * LDF;
  static constexpr int Q_OFF = 0, P_OFF = BQG * LDF;
  static constexpr int STAT_OFF = P_OFF + BK * LDP;
  static constexpr int GROUP_FLOATS = STAT_OFF + 2 * BQG;
  static constexpr int GROUPS_OFF = NBUF * TILE_FLOATS;
  static constexpr int SMEM = BAR_BYTES + 4 * (GROUPS_OFF + 2 * GROUP_FLOATS);
  static_assert(D % 16 == 0 && TM * 8 == BQG && TN * 16 == BK, "S split");
  static_assert(BQG % RM == 0 && D % (OW * OC) == 0 &&
                    NM * NN * KS == GROUP && BK % KS == 0 && NM % WM == 0 &&
                    NN % WN == 0 && (NM * NN) % 32 == 0,
                "O split");
  static_assert((KS - 1) * BQG * D <= BK * LDP, "O parts");
  static_assert((2 * NBUF + 2) * 8 <= BAR_BYTES && SMEM <= 232448,
                "shared memory");
};

// ---- PTX wrappers: mbarriers, async copies, registers, named barriers ----

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

// 16 bytes (both ends 16-byte aligned) into shared memory, through L2.
__device__ __forceinline__ void copy16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_addr(dst)),
               "l"(reinterpret_cast<uint64_t>(src)) : "memory");
}

// One of `bar`'s expected arrivals, made when this thread's copies so far
// have landed.
__device__ __forceinline__ void copies_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_addr(bar)) : "memory");
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

// 2^x, flushing results below 2^-126 to 0 (one instruction; within two
// ulps).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Group 1 waits at SKEW_BAR for group 0's arrival.
__device__ __forceinline__ void skew_wait() {
  asm volatile("bar.sync %0, %1;" ::"n"(SKEW_BAR), "n"(CONSUMERS) : "memory");
}
__device__ __forceinline__ void skew_arrive() {
  asm volatile("bar.arrive %0, %1;" ::"n"(SKEW_BAR), "n"(CONSUMERS)
               : "memory");
}

// A consumer group's 128 threads.
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;" ::"r"(GROUP_BAR + group), "n"(GROUP)
               : "memory");
}

// ---- the kernel ----

struct Args {
  const float* q;    // (BH, S, D)
  const float* k;    // (BKV, T, D)
  const float* v;
  float* o;          // (BH, S, D)
  float* lse;        // null, or the rows' log-sum-exp (BH, S)
  int BH, S, T, n_qt, n_items, group, causal, window;
  // Q is scaled by q_scale in shared memory: log2(e) / sqrt(D), or
  // 1 / sqrt(D) with a softcap, whose logit is then cap_log2e * tanh(s *
  // inv_cap), cap_log2e = softcap * log2(e): logits in base 2 either way.
  float q_scale, softcap, inv_cap, cap_log2e;
};

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

// N contiguous floats to memory (p aligned to N floats).
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

// s[i][j] = Q[qg + 8i] . K[kg + 16j] over D, four floats a load: a warp
// loads 16 key rows (two wavefronts) and 2 query rows (one) at once.
template <int D>
__device__ __forceinline__ void scores(float (&s)[Tiles<D>::TM][Tiles<D>::TN],
                                       const float* sq, const float* sk,
                                       int qg, int kg) {
  using C = Tiles<D>;
  const float* const qp = sq + qg * C::LDF;
  const float* const kp = sk + kg * C::LDF;
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int j = 0; j < C::TN; ++j) s[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 x[C::TM];
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
      x[i] = *reinterpret_cast<const float4*>(qp + 8 * i * C::LDF + d);
#pragma unroll
    for (int j = 0; j < C::TN; ++j) {
      const float4 y =
          *reinterpret_cast<const float4*>(kp + 16 * j * C::LDF + d);
#pragma unroll
      for (int i = 0; i < C::TM; ++i)
        s[i][j] = fmaf(x[i].w, y.w,
                       fmaf(x[i].z, y.z,
                            fmaf(x[i].y, y.y, fmaf(x[i].x, y.x, s[i][j]))));
    }
  }
}

// The base-2 logits of the patch's scores (softcap, mask where EDGE;
// branch-free, so that the patch's elements overlap), the rows' new maxima
// m over the 16 lanes that share them, P = 2^(x - m) in s, alpha =
// 2^(m_old - m), and each lane's share of the rows' sums l rescaled and
// added to.
template <int D, bool SOFTCAP, bool EDGE>
__device__ __forceinline__ void softmax_step(
    const Args& a, float (&s)[Tiles<D>::TM][Tiles<D>::TN],
    float (&m)[Tiles<D>::TM], float (&l)[Tiles<D>::TM],
    float (&alpha)[Tiles<D>::TM], int row0, int kb) {
  using C = Tiles<D>;
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int qi = row0 + 8 * i;
    float mx = m[i];
#pragma unroll
    for (int j = 0; j < C::TN; ++j) {
      float x = s[i][j];
      if constexpr (SOFTCAP) x = a.cap_log2e * tanhf(x * a.inv_cap);
      if constexpr (EDGE) {
        const int kj = kb + 16 * j;
        const bool vis = (!a.causal | (kj <= qi)) &
                         ((a.window <= 0) | (kj > qi - a.window));
        x = vis ? x : MASKED;
        x = kj < a.T ? x : NO_KEY;   // past the ragged edge
      }
      s[i][j] = x;
      mx = fmaxf(mx, x);
    }
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    alpha[i] = exp2_ftz(m[i] - mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < C::TN; ++j) {
      s[i][j] = exp2_ftz(s[i][j] - mx);
      sum += s[i][j];
    }
    l[i] = l[i] * alpha[i] + sum;
    m[i] = mx;
  }
}

// acc[r][OW * c + e] += sum_{l < KPART} Pt[l][r] * V[l][OW * (n0 + NN * c) +
// e]: a thread's patch of O over its part of the tile's keys (Pt at the
// part's first key and the thread's first row, V at the part's first key).
template <int D>
__device__ __forceinline__ void pv(
    float (&acc)[Tiles<D>::RM][Tiles<D>::OW * Tiles<D>::OC], const float* pt,
    const float* sv, int n0) {
  using C = Tiles<D>;
#pragma unroll 4
  for (int l = 0; l < C::KPART; ++l) {
    float p[C::RM];
    load_run<C::RM>(p, pt + l * C::LDP);
    float b[C::OC][C::OW];
#pragma unroll
    for (int c = 0; c < C::OC; ++c)
      load_run<C::OW>(b[c], sv + l * C::LDF + C::OW * (n0 + C::NN * c));
#pragma unroll
    for (int r = 0; r < C::RM; ++r)
#pragma unroll
      for (int c = 0; c < C::OC; ++c)
#pragma unroll
        for (int e = 0; e < C::OW; ++e)
          acc[r][C::OW * c + e] = fmaf(p[r], b[c][e], acc[r][C::OW * c + e]);
  }
}

// One query tile of one head: the kernel's unit of work.
struct Item {
  int bh, q0, k_begin, steps;
};

// Item idx (every head's last query tile first, then the one before, and
// so on) and the keys any of its rows can see: none past its last row
// (below S) when causal, none at or before q0 - window when windowed.
template <int D>
__device__ __forceinline__ Item item_of(const Args& a, int idx) {
  using C = Tiles<D>;
  Item w;
  w.bh = idx % a.BH;
  w.q0 = (a.n_qt - 1 - idx / a.BH) * C::BQ;
  w.k_begin = a.window > 0 ? max(0, w.q0 - a.window + 1) : 0;
  const int k_end = a.causal ? min(a.T, min(a.S, w.q0 + C::BQ)) : a.T;
  w.steps = k_end > w.k_begin ? (k_end - w.k_begin + C::BK - 1) / C::BK : 0;
  return w;
}

// The index of this CTA's k-th item, or -1: rounds of gridDim.x items,
// dealt forward in even rounds and backward in odd ones, so that the
// CTAs' totals even out when the items shorten (causal shapes).
__device__ __forceinline__ int item_index(int k, int n_items) {
  const int c = k & 1 ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int idx = k * gridDim.x + c;
  return idx < n_items ? idx : -1;
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_fwd_kernel(const __grid_constant__ Args a) {
  using C = Tiles<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem_raw);   // [NBUF]
  uint64_t* const empty = full + C::NBUF;                         // [NBUF]
  uint64_t* const q_full = empty + C::NBUF;
  uint64_t* const q_empty = q_full + 1;
  float* const tiles = reinterpret_cast<float*>(smem_raw + C::BAR_BYTES);
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int b = 0; b < C::NBUF; ++b) {
      mbar_init(full + b, GROUP);
      mbar_init(empty + b, CONSUMER_WARPS);
    }
    mbar_init(q_full, GROUP);
    mbar_init(q_empty, CONSUMER_WARPS);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp < GROUP / 32) {
    // The producer warpgroup gives its registers to the consumers and
    // copies 16 bytes a thread, item after item: both groups' Q rows (rows
    // past S repeat the last) once the consumers' last product of the
    // item before has read Q, scaled in place once all have landed; then K
    // and V of each step in turn through the ring (rows past T repeat the
    // last), each thread's arrival on a buffer's barrier landing with its
    // copies.
    regs_dec<40>();
    constexpr int CH = D / 4;   // 16-byte chunks a row
    const int t = threadIdx.x;
    int it = 0;                 // tiles copied so far
    for (int k = 0;; ++k) {
      const int idx = item_index(k, a.n_items);
      if (idx < 0) break;
      const Item w = item_of<D>(a, idx);
      if (k > 0) mbar_wait(q_empty, (k - 1) & 1);
      const float* const q = a.q + static_cast<size_t>(w.bh) * a.S * D;
      for (int c = t; c < C::BQ * CH; c += GROUP) {
        const int r = c / CH, col = 4 * (c % CH);
        copy16(tiles + C::GROUPS_OFF + r / C::BQG * C::GROUP_FLOATS +
                   r % C::BQG * C::LDF + col,
               q + static_cast<size_t>(min(w.q0 + r, a.S - 1)) * D + col);
      }
      // Scaled here, once every producer thread's copies have landed.
      asm volatile("cp.async.wait_all;" ::: "memory");
      asm volatile("bar.sync %0, %1;" ::"n"(PRODUCER_BAR), "n"(GROUP)
                   : "memory");
      for (int c = t; c < C::BQ * CH; c += GROUP) {
        const int r = c / CH, col = 4 * (c % CH);
        float4* const x = reinterpret_cast<float4*>(
            tiles + C::GROUPS_OFF + r / C::BQG * C::GROUP_FLOATS +
            r % C::BQG * C::LDF + col);
        const float4 y = *x;
        *x = make_float4(y.x * a.q_scale, y.y * a.q_scale, y.z * a.q_scale,
                         y.w * a.q_scale);
      }
      mbar_arrive(q_full);
      const size_t kv_off = static_cast<size_t>(w.bh / a.group) * a.T * D;
      for (int i = 0; i < 2 * w.steps; ++i, ++it) {
        const int b = it % C::NBUF;
        if (it >= C::NBUF) mbar_wait(empty + b, (it / C::NBUF - 1) & 1);
        const float* const src = (i % 2 ? a.v : a.k) + kv_off;
        const int kb = w.k_begin + i / 2 * C::BK;
        float* const dst = tiles + b * C::TILE_FLOATS;
        for (int c = t; c < C::BK * CH; c += GROUP) {
          const int r = c / CH, col = 4 * (c % CH);
          copy16(dst + r * C::LDF + col,
                 src + static_cast<size_t>(min(kb + r, a.T - 1)) * D + col);
        }
        copies_arrive(full + b);
      }
    }
    return;
  }

  regs_inc<232>();
  const int group = warp / 4 - 1;
  const int g = threadIdx.x % GROUP;
  const int gw = g / 32, gl = g % 32;
  float* const sm = tiles + C::GROUPS_OFF + group * C::GROUP_FLOATS;
  float* const sq = sm + C::Q_OFF;
  float* const sp = sm + C::P_OFF;
  float* const s_alpha = sm + C::STAT_OFF;
  float* const s_l = s_alpha + C::BQG;
  // S: key group kg (16 a warp), query group qg (two a warp).
  const int kg = gl % 16, qg = 2 * gw + gl / 16;
  // O: part ks of the keys, rows m0.., chunks n0 + NN * c.
  const int part = g / (C::NM * C::NN), t = g % (C::NM * C::NN);
  const int m0 = (t / 32 / (C::NN / C::WN) * C::WM + t % 32 / C::WN) * C::RM;
  const int n0 = t / 32 % (C::NN / C::WN) * C::WN + t % 32 % C::WN;
  constexpr int OCOLS = C::OW * C::OC;
  int it = 0;                   // tiles used so far

  for (int k = 0;; ++k) {
    const int idx = item_index(k, a.n_items);
    if (idx < 0) break;
    const Item w = item_of<D>(a, idx);
    const int qrow0 = w.q0 + group * C::BQG;   // the group's first row
    const int q_last = min(qrow0 + C::BQG, a.S) - 1;
    float m[C::TM], l[C::TM];
#pragma unroll
    for (int i = 0; i < C::TM; ++i) {
      m[i] = MASKED;
      l[i] = 0.f;
    }
    float acc[C::RM][OCOLS];
#pragma unroll
    for (int r = 0; r < C::RM; ++r)
#pragma unroll
      for (int c = 0; c < OCOLS; ++c) acc[r][c] = 0.f;
    mbar_wait(q_full, k & 1);
    group_sync(group);   // the item before's parts of O read
    if (w.steps == 0) {
      __syncwarp();
      if (gl == 0) mbar_arrive(q_empty);
    }

    for (int n = 0; n < w.steps; ++n, it += 2) {
      const int kb = w.k_begin + n * C::BK;
      const int bk = it % C::NBUF, bv = (it + 1) % C::NBUF;
      const float* const sk = tiles + bk * C::TILE_FLOATS;
      const float* const sv = tiles + bv * C::TILE_FLOATS;
      // Whether some pair of the group's rows and the tile's keys is hidden
      // (rows past S do not count) or some key lies past T.
      const bool edge = kb + C::BK > a.T ||
                        (a.causal && kb + C::BK - 1 > qrow0) ||
                        (a.window > 0 && kb <= q_last - a.window);
      mbar_wait(full + bk, (it / C::NBUF) & 1);
      float s[C::TM][C::TN];
      // Group 1 starts an item's first product once group 0 has done its
      // own, so that the groups run about a product apart and one's
      // softmax overlaps the other's products.
      if (n == 0 && group == 1) skew_wait();
      scores<D>(s, sq, sk, qg, kg);
      if (n == 0 && group == 0) skew_arrive();
      __syncwarp();
      if (gl == 0) {
        mbar_arrive(empty + bk);
        if (n == w.steps - 1) mbar_arrive(q_empty);   // Q's last read
      }
      float alpha[C::TM];
      const int row0 = qrow0 + qg, key0 = kb + kg;
      if (a.softcap > 0.f) {
        if (edge)
          softmax_step<D, true, true>(a, s, m, l, alpha, row0, key0);
        else
          softmax_step<D, true, false>(a, s, m, l, alpha, row0, key0);
      } else {
        if (edge)
          softmax_step<D, false, true>(a, s, m, l, alpha, row0, key0);
        else
          softmax_step<D, false, false>(a, s, m, l, alpha, row0, key0);
      }
      group_sync(group);   // the last step's P.V has read P^T and alpha
#pragma unroll
      for (int i = 0; i < C::TM; ++i) {
#pragma unroll
        for (int j = 0; j < C::TN; ++j)
          sp[(kg + 16 * j) * C::LDP + qg + 8 * i] = s[i][j];
        if (kg == 0) s_alpha[qg + 8 * i] = alpha[i];
      }
      group_sync(group);   // P^T and alpha written
      {
        float al[C::RM];
        load_run<C::RM>(al, s_alpha + m0);
#pragma unroll
        for (int r = 0; r < C::RM; ++r)
#pragma unroll
          for (int c = 0; c < OCOLS; ++c) acc[r][c] *= al[r];
      }
      mbar_wait(full + bv, ((it + 1) / C::NBUF) & 1);
      pv<D>(acc, sp + part * C::KPART * C::LDP + m0,
            sv + part * C::KPART * C::LDF, n0);
      __syncwarp();
      if (gl == 0) mbar_arrive(empty + bv);
    }

    // The rows' sums over the 16 lanes; their statistics for the O threads
    // and, where asked, the log-sum-exp.
#pragma unroll
    for (int i = 0; i < C::TM; ++i) {
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
      if (kg == 0) {
        const int r = qg + 8 * i;
        s_l[r] = l[i];
        if (a.lse != nullptr && qrow0 + r < a.S)
          a.lse[static_cast<size_t>(w.bh) * a.S + qrow0 + r] =
              m[i] * LN2 + logf(fmaxf(l[i], 1e-30f));
      }
    }
    group_sync(group);   // every P.V done; the sums written
    if (part > 0) {
      float* const dst = sp + (part - 1) * C::BQG * D;
#pragma unroll
      for (int r = 0; r < C::RM; ++r)
#pragma unroll
        for (int c = 0; c < C::OC; ++c)
          store_run<C::OW>(dst + (m0 + r) * D + C::OW * (n0 + C::NN * c),
                           &acc[r][C::OW * c]);
    }
    group_sync(group);   // the parts written
    if (part > 0) continue;
#pragma unroll
    for (int ks = 1; ks < C::KS; ++ks) {
      const float* const src = sp + (ks - 1) * C::BQG * D;
#pragma unroll
      for (int r = 0; r < C::RM; ++r)
#pragma unroll
        for (int c = 0; c < C::OC; ++c) {
          float x[C::OW];
          load_run<C::OW>(x, src + (m0 + r) * D + C::OW * (n0 + C::NN * c));
#pragma unroll
          for (int e = 0; e < C::OW; ++e) acc[r][C::OW * c + e] += x[e];
        }
    }
    float* const o = a.o + static_cast<size_t>(w.bh) * a.S * D;
#pragma unroll
    for (int r = 0; r < C::RM; ++r) {
      const int qi = qrow0 + m0 + r;
      if (qi >= a.S) continue;
      const float inv = __frcp_rn(fmaxf(s_l[m0 + r], 1e-30f));
      float y[OCOLS];
#pragma unroll
      for (int c = 0; c < OCOLS; ++c) y[c] = acc[r][c] * inv;
#pragma unroll
      for (int c = 0; c < C::OC; ++c)
        store_run<C::OW>(o + static_cast<size_t>(qi) * D +
                             C::OW * (n0 + C::NN * c),
                         &y[C::OW * c]);
    }
  }
}

template <int D>
int launch(Args a, cudaStream_t stream) {
  using C = Tiles<D>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_fwd_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  a.n_qt = (a.S + C::BQ - 1) / C::BQ;
  a.n_items = a.n_qt * a.BH;
  // One CTA an SM (its shared memory allows no second), each walking its
  // items.
  flash_attention_fwd_kernel<D>
      <<<a.n_items < sms ? a.n_items : sms, THREADS, C::SMEM, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns the CUDA error (0 on success).  q, k, v
// and o are contiguous float32, 16-byte aligned; the caller checks shapes,
// BH % BKV == 0, D in {16, 32, 64, 80, 96, 128, 256}, BH <= 65535 and every
// index below 2**31.  lse, where not null, gets each row's log-sum-exp of
// its logits ((BH, S), for the backward in flash_attention_bwd.cu); o is
// the same either way.
extern "C" int flash_attention_f32(const float* q, const float* k,
                                   const float* v, float* o, float* lse,
                                   int BH, int BKV, int S, int T, int D,
                                   int causal, int window, float softcap,
                                   void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lse = lse;
  a.BH = BH;
  a.S = S;
  a.T = T;
  a.group = BH / BKV;
  a.causal = causal;
  a.window = window;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  a.q_scale = softcap > 0.f ? scale : scale * LOG2E;
  a.softcap = softcap;
  a.inv_cap = softcap > 0.f ? 1.0f / softcap : 0.f;
  a.cap_log2e = softcap * LOG2E;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(a, s);
    case 32: return launch<32>(a, s);
    case 64: return launch<64>(a, s);
    case 80: return launch<80>(a, s);
    case 96: return launch<96>(a, s);
    case 128: return launch<128>(a, s);
    case 256: return launch<256>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The kernel's dynamic shared memory at head dim D (0 if not built for D).
extern "C" int flash_attention_f32_smem_bytes(int D) {
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

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Flash attention backward in bf16 for Hopper (sm_90a): tensor cores
// through wgmma, TMA-fed tiles, one producer and two consumer warpgroups.
// dq, dk and dv of the forward in flash_attention_sm90.cu for the output
// gradient dO, at every head dim the forward takes (16 to 256).  GQA,
// causal (top-left), optional sliding window and logit softcap; bf16 in
// and out, f32 statistics and accumulation.  f32 inputs go to the
// CUDA-core backward in flash_attention_bwd.cu.
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
// What bounds it on an H100 SXM: the 10*D operations per visible (query,
// key) pair of the five products at 989 TFLOP/s (bf16 tensor cores); the
// bytes (q, k, v, O, dO, lse read once, dq, dk, dv written once) are some
// 10^3 times fewer at a training shape.  As built it does 16*D a pair: S
// and dP once, and P and dS each enter their products as hi + lo bf16, two
// products into one f32 accumulator (hi = bf16(p), lo = bf16(p - hi)), as
// the forward carries P: one bf16 P or dS carries 2^-9 relative error per
// term, about the whole half-ulp limit of dq, dk, dv, where the split
// leaves some 2^-17.
//
// Three launches:
//   (a) flash_bwd_prep_kernel, eight lanes a query row: D_i = rowsum(dO *
//       O), O taken as the bf16 output plus the forward's lo = bf16(o -
//       bf16(o)), the f32 O to 2^-17 (from the bf16 O alone D_i would move
//       every dS by up to 2^-9 of sum|dO||O|, the gradient's whole
//       half-ulp limit); lse*log2(e); both per row padded to whole 64-row
//       tiles; and the dQ tiles' counters set to 0;
//   (b) flash_bwd_sm90_kernel, one CTA per (key tile, KV head): K and V
//       stay in shared memory; it walks the group's query heads and, per
//       head, the 64-query tiles that some key of the tile sees, in
//       ascending order.  Per step each consumer warpgroup, for its 64
//       keys: S^T = K.Q^T and dP^T = V.dO^T (wgmma, both operands in shared
//       memory, K-major); P^T and dS^T in registers; dV += P^T.dO and dK +=
//       dS^T.Q with P^T, dS^T (hi and lo) as register A operands and dO, Q
//       MN-major (the forward's P.V); dS^T, hi and lo, into shared memory
//       and its dQ part = dS.K (A = dS^T through the descriptor's
//       transpose, B = K MN-major).  The parts go into a shared dQ buffer
//       for one of the producer warpgroup's writer warps, which adds them
//       into the query tile's f32 sum in global memory with TMA bulk
//       reductions, part 0 and then part 1 (the first tile stores part
//       0): no consumer waits on global memory or on the other.  A
//       key tile is 128 keys, 64 a consumer, up to D = 96; at D = 128 and
//       256, where dK and dV of 64 keys would take D of a thread's
//       registers, 64 keys that both consumers share, each owning D / 2
//       columns of D (S^T and dP^T computed by both: 20*D a pair there),
//       their dQ parts the two column halves of one tile;
//   (c) flash_bwd_dq_convert_kernel: dq = bf16 of the f32 sums, one
//       rounding, a 64-row tile a block (a 64-row tile's sum is finished
//       only when its last key tile has added, so the rounding waits for
//       the launch's end).
//
// Determinism.  The key tiles of a query tile add their parts in one fixed
// order, the highest key tile first: each (query head, query tile) has a
// counter; the writer of the tile of rank r waits until the counter reads
// r (acquire), adds, waits for the bulk reduction to complete, and raises
// the counter (release).  Every element of a sum gets its parts in that
// order, so two launches give the same bits.  Key tiles run highest first
// within a head (blockIdx.x = n_kt - 1 - tile), so a CTA waits only on
// CTAs launched before it; and as every tile walks the query tiles in
// ascending order from its own first one, the higher tile, which starts
// later in the sequence, reaches a query tile first: on causal and
// windowed shapes the writers rarely wait.  Non-causal shapes, where every
// key tile sees every query tile, wait about a step per key tile
// (ROADMAP).  At D = 256 the order is the other way round (Tiles::
// LOWEST_FIRST): the lowest key tile adds first, the grid launches the
// lowest tiles first within a head, and each tile walks its query tiles
// downward with the group's heads inner, so every tile reaches a query
// tile at the same step as the tiles below it: a CTA waits only on CTAs
// launched before it, and the longest CTAs of a causal shape start first
// rather than last.  The f32 sums are stored per tile in the consumers'
// fragment order, so that the buffers are written without bank conflicts
// and copied whole; steps of one CTA are distinct query tiles, so the
// writers (one a buffer) need no order among themselves.
//
// The design, on Hopper:
//   * the producer's loader thread loads K and V once (TMA, 3-d maps over
//     (head, row, D), rows past T zero-filled) and keeps Q, dO, lse*log2e
//     and D_i of the next steps in flight in a ring of two or three stages
//     guarded by full and empty mbarriers; the producer warpgroup gives
//     registers away with setmaxnreg, the consumers take them (232 a
//     thread);
//   * the consumers take turns to start their products (named barriers, as
//     in the forward), so that one's P and dS run under the other's
//     products; P and dS are branch-free, with masks in a second pass on
//     tiles that cross the diagonal, a window's edge, S or T;
//   * D is cut into 64-wide column chunks, 128-byte swizzled, and one 16-
//     or 32-wide tail chunk, 32- or 64-byte swizzled, as in the forward;
//     dS^T is written in the 128-byte swizzle that wgmma reads;
//   * key tiles that no query sees write zero dK and dV.
// Numerics.  Products of bf16 values are exact in f32, so S and dP differ
// from the f32 arithmetic only in the order of their sums; the softcap uses
// the accurate tanhf, as the forward does; P = exp2(x*log2(e) - lse*log2(e))
// against the forward's saved lse (both from the same f32 x), through the
// SFU's ex2 (exp2f without its fix-up of results below 2^-126, which flush
// to 0).  dK and dV are rounded once from their registers, dQ once from
// its ordered f32 sum.
//
// Shared memory: K and V (2*BK*D*2 bytes), two or three stages of Q, dO
// (2*64*D*2) and their stats, dS^T hi and lo of both consumers (32 KB),
// two or three dQ buffers: 215,656 B at D = 64, 231,496 at D = 96.
//
// D = 256 (gemma2-2b, paligemma-3b).  Each consumer holds dK and dV of the
// 64 keys for its 128 columns: 128 f32 a thread, beside the hi and lo
// fragments of P^T and dS^T (64) in the key products and the dQ part (64)
// in its own batch, within the 232 registers setmaxnreg gives it.  K and V
// take 64 KB, one stage of Q and dO 64 KB, the dS^T tiles 32 KB and the
// one dQ buffer 64 KB: 230,952 B, so one stage and one buffer.  The
// loader refills the stage while the consumers run the dQ product, and
// the writer frees the buffer as soon as its bulk reduction has read it
// (wait_group.read), before waiting for the reduction to complete.  dK's
// products read dS^T from its shared tiles (the dQ part's A) rather than
// from fragments, dK and dV leave their registers for an f32 sum every 32
// steps (Tiles::FLUSH), and the dQ order runs lowest key tile first
// (Tiles::LOWEST_FIRST).  It does 20*D a pair against the bound's 10*D.
//
// What it leaves on the table: P and dS's split costs 1.6x the products of
// one bf16 P and dS; S^T, dP^T and the dQ part read both operands from
// shared memory at N = 64, near its rate; D = 128 and 256 compute S^T and
// dP^T twice; D = 256 has one stage of Q and dO; GQA shapes with few KV
// heads and short T give few CTAs (the group's heads are walked in one
// CTA); below D = 256 causal shapes launch their longest CTAs (the lowest
// key tiles) last, as the dQ order needs.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;                // queries a step
constexpr int THREADS = 384;          // producer + two consumer warpgroups
constexpr int CONSUMER_WARPS = 8;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int ERR_NO_ENCODER = 10001;     // as flash_attention_sm90.cu's
constexpr int ERR_TENSOR_MAP = 10002;
// Named barriers (0 is __syncthreads): WG_BAR + c, consumer c's own 128
// threads; SCHED_BAR + c, consumer c's turn to start products (the
// consumers take turns, as the forward's do, so that one's P and dS run
// under the other's products).
constexpr int WG_BAR = 1;
constexpr int SCHED_BAR = 3;

// Tiles and shared memory at head dim D, offsets from a 1024-aligned base.
// Chunk c of a [rows][D] tile holds columns [64c, 64c + width) as a dense
// [rows][width] block at byte offset rows * 128 * c.
template <int D>
struct Tiles {
  // Below D = 128 each consumer owns 64 of the CTA's 128 keys and all of
  // D; at D = 128 and 256, where dK and dV of 64 keys would take D of a
  // thread's registers, the two share the CTA's 64 keys and each owns D /
  // 2 columns of D (both compute S^T and dP^T: 20*D a pair there).
  static constexpr bool SPLIT = D >= 128;
  static constexpr int BK = SPLIT ? 64 : 128;     // keys a CTA owns
  static constexpr int DW = SPLIT ? D / 2 : D;    // columns a consumer owns
  static constexpr int N64 = D / 64;
  static constexpr int TAIL = D % 64;
  static constexpr int CHUNKS = N64 + (TAIL ? 1 : 0);
  static constexpr int KV_BYTES = BK * D * 2;     // K or V
  static constexpr int QT_BYTES = BQ * D * 2;     // Q or dO of one stage
  static constexpr int DS_BYTES = 64 * BQ * 2;    // dS^T, hi or lo
  static constexpr int DQ_BYTES = BQ * D * 4;     // a step's dQ part
  // A dQ buffer: both consumers' parts (summed by the writer), or at D =
  // 128 and 256 their column halves of one part.  As many buffers, one
  // writer warp each (the producer's warps 1 to 3), as shared memory
  // holds: at D = 256 one buffer and one stage.
  static constexpr int BUF_BYTES = SPLIT ? DQ_BYTES : 2 * DQ_BYTES;
  static constexpr int NBUF = D == 256 ? 1 : (D == 80 || D == 96) ? 2 : 3;
  static constexpr int STAGES = D == 256 ? 1 : D <= 80 ? 3 : 2;  // Q, dO
  static constexpr int STATS_BYTES = 2 * BQ * 4;  // lse*log2e, D_i
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = KV_BYTES;
  static constexpr int Q_OFF = 2 * KV_BYTES;      // stage s: Q, then dO
  static constexpr int DS_OFF = Q_OFF + STAGES * 2 * QT_BYTES;
  static constexpr int DQ_OFF = DS_OFF + 4 * DS_BYTES;
  static constexpr int ST_OFF = DQ_OFF + NBUF * BUF_BYTES;
  static constexpr int BAR_OFF = ST_OFF + STAGES * STATS_BYTES;
  // + 1024 to align the base for the 128-byte swizzle, + the mbarriers:
  // K and V in; per stage full, empty; per dQ buffer full, empty
  static constexpr int SMEM =
      BAR_OFF + 8 * (1 + 2 * STAGES + 2 * NBUF) + 1024;
  static constexpr int STAGE_TX = 2 * QT_BYTES + STATS_BYTES;
  // dV, dK and the dQ part in one batch of products where the registers
  // hold them all (dK, dV, the fragments of P and dS, the dQ part).
  static constexpr bool ONE_BATCH = DW <= 80;
  // At D = 256 dK's products read dS^T from its shared tiles, which the
  // dQ part reads too, rather than from fragments: dK and dV (128 f32 a
  // thread) leave no room for both P's and dS's.
  static constexpr bool DK_FROM_SMEM = D == 256;
  // At D = 256 dK and dV leave their registers for an f32 sum in global
  // memory every FLUSH steps (kv_acc, one thread's floats each, added in
  // round-to-nearest).  A register that takes a whole walk (256 steps,
  // 2048 products at gemma2's 8192 keys) drifted past the half-ulp
  // limit's 2e-5 slack on the card, where P and dS's split, summed
  // exactly, stays within it (flash_bwd_precision.py); 32 steps' runs
  // keep the kernel's error at the split's.
  static constexpr int FLUSH = D == 256 ? 32 : 0;
  // The dQ order.  Below D = 256 the highest key tile adds first: the grid
  // launches the highest tiles, the shortest CTAs on causal shapes, first
  // and each CTA walks its query tiles upward, so the higher tile reaches
  // a query tile first.  At D = 256, where the steps are twice as long,
  // the lowest key tile adds first: the grid launches the longest CTAs
  // first (a causal 8192's lowest tile walks 128 query tiles, its highest
  // one), which would otherwise run last, alone, and each CTA walks its
  // tiles downward, the group's heads in turn on each, so that every CTA
  // reaches a query tile at the same step as the tiles below it, which
  // were launched before it.
  static constexpr bool LOWEST_FIRST = D == 256;
  static_assert(D % 16 == 0 && (D <= 128 || D == 256) &&
                (TAIL == 0 || TAIL == 16 || TAIL == 32), "head dim");
  static_assert(SMEM <= 232448, "shared memory");
};

__host__ __device__ constexpr int chunk_width(int D, int c) {
  return c < D / 64 ? 64 : D % 64;
}

// The helpers below are those of flash_attention_sm90.cu (descriptors and
// swizzle, mbarriers, TMA, the wgmma wrappers), copied: each source builds
// alone.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets, and the swizzle that the chunk's layout uses (128 B for
// width 64, 64 B for 32, 32 B for 16).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int width) {
  const uint64_t swizzle = width == 64 ? 1 : width == 32 ? 2 : 3;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (swizzle << 62);
}

// K-major chunk (the product's K dim contiguous): 8-row groups lie 8 *
// width * 2 bytes apart; the leading offset is unused.
__device__ __forceinline__ uint64_t k_major(uint32_t addr, int width) {
  return smem_desc(addr, 16, 16 * width, width);
}

// MN-major chunk (the M or N dim contiguous, K down the rows): 8-row groups
// lie 8 * width * 2 bytes apart; M or N never exceeds one swizzle atom
// here, so both fields carry the group stride.
__device__ __forceinline__ uint64_t mn_major(uint32_t addr, int width) {
  return smem_desc(addr, 16 * width, 16 * width, width);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// One arrival per warp, once the whole warp is done with the stage.
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// Waits until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar), "r"(parity) : "memory");
}

// One box of a 3-d tensor map, coordinates innermost first (column, row,
// head), into shared memory; completion is counted on `bar` in bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(head),
      "r"(bar) : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned)
// into shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// `bytes` contiguous bytes of shared memory stored to (or, with `add`,
// added in f32 to) global memory, as one bulk group; waits until done, or
// with `read_only` only until the shared memory has been read (then
// bulk_wait_done waits for the rest).
__device__ __forceinline__ void bulk_store_f32(void* dst, uint32_t src,
                                               uint32_t bytes, bool add,
                                               bool read_only = false) {
  if (add) {
    asm volatile(
        "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 "
        "[%0], [%1], %2;" ::"l"(reinterpret_cast<uint64_t>(dst)),
        "r"(src), "r"(bytes) : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
            reinterpret_cast<uint64_t>(dst)),
        "r"(src), "r"(bytes) : "memory");
  }
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  if (read_only) {
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  } else {
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
}
__device__ __forceinline__ void bulk_wait_done() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Waits until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

template <int COUNT>
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(COUNT) : "memory");
}
template <int COUNT>
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(COUNT) : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma's registers
// across the asynchronous product.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// d[0..32) (+)= A·B for A, B in shared memory (K-major, descriptors).
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t a_desc,
                                             uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;"
      "\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a_desc), "l"(b_desc), "r"(accumulate));
}

// d[0..32) (+)= A·B for A and B in shared memory, both MN-major (A's M and
// B's N contiguous: the descriptors' transpose bits set).
__device__ __forceinline__ void wgmma_ss_tt_n64(float* d, uint64_t a_desc,
                                                uint64_t b_desc,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 1, 1;"
      "\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a_desc), "l"(b_desc), "r"(accumulate));
}

// d[0..32) += A·B for A in shared memory K-major and B in shared memory
// MN-major (B's N contiguous: its descriptor's transpose bit set).
__device__ __forceinline__ void wgmma_ss_kn_n64(float* d, uint64_t a_desc,
                                                uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 1;"
      "\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a_desc), "l"(b_desc), "r"(1));
}

// d[0..16) (+)= A·B, both MN-major in shared memory.
__device__ __forceinline__ void wgmma_ss_tt_n32(float* d, uint64_t a_desc,
                                                uint64_t b_desc,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15}, %16, %17, p, 1, 1, 1, 1;"
      "\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a_desc), "l"(b_desc), "r"(accumulate));
}

// d[0..8) (+)= A·B, both MN-major in shared memory.
__device__ __forceinline__ void wgmma_ss_tt_n16(float* d, uint64_t a_desc,
                                                uint64_t b_desc,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 1, 1;"
      "\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a_desc), "l"(b_desc), "r"(accumulate));
}

// d[0..8) += A·B, A from registers (a[0..4)), B in shared memory MN-major.
__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t* a,
                                             uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, "
      "p, 1, 1, 1;"
      "\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1));
}

// d[0..16) += A·B, A from registers (a[0..4)), B in shared memory MN-major.
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                             uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;"
      "\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1));
}

// d[0..32) += A·B, A from registers (a[0..4)), B in shared memory MN-major.
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, "
      "1, 1, 1;"
      "\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1));
}

// An f32 C tile of 64 columns as hi + lo bf16 A fragments, 16 columns each
// (the forward's split_p): registers 8t..8t+7 of the tile are columns
// 16t..16t+15.
__device__ __forceinline__ void split(const float (&p)[32],
                                      uint32_t (&hi)[4][4],
                                      uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x = p[8 * t + 2 * r], y = p[8 * t + 2 * r + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
      const float2 hf = __bfloat1622float2(h);
      hi[t][r] = bits(h);
      lo[t][r] = bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
    }
  }
}

// S^T (or dP^T) = K.Q^T (or V.dO^T) for the 64 keys from row `row0` of
// the [BK][D] tile at `rows` against the [BQ][D] tile at `cols`, 16
// columns of D a step, both K-major.  Started, not waited for.
template <int D>
__device__ __forceinline__ void start_scores(float* acc, uint32_t rows,
                                             int row0, uint32_t cols) {
  using C = Tiles<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk / 4, w = chunk_width(D, c);
    const uint64_t a =
        k_major(rows + C::BK * 128 * c + row0 * w * 2 + 32 * (kk % 4), w);
    const uint64_t b = k_major(cols + BQ * 128 * c + 32 * (kk % 4), w);
    wgmma_ss_n64(acc, a, b, kk > 0);
  }
}

// acc += X^T.Y for X^T (64 keys by BQ queries) as hi + lo A fragments and
// the consumer's columns of the [BQ][D] tile Y at `tile` (dO for dV, Q for
// dK), MN-major: per 16 queries, hi then lo against each chunk.  Started,
// not waited for.
template <int D>
__device__ __forceinline__ void start_key_grad(float* acc,
                                               const uint32_t (&hi)[4][4],
                                               const uint32_t (&lo)[4][4],
                                               uint32_t tile, int wg) {
  using C = Tiles<D>;
#pragma unroll
  for (int t = 0; t < BQ / 16; ++t) {
    if constexpr (C::SPLIT) {
#pragma unroll
      for (int c = 0; c < (C::DW / 64); ++c) {
        const uint64_t b = mn_major(
            tile + BQ * 128 * ((C::DW / 64) * wg + c) + t * 2048, 64);
        wgmma_rs_n64(acc + 32 * c, hi[t], b);
        wgmma_rs_n64(acc + 32 * c, lo[t], b);
      }
    } else {
#pragma unroll
      for (int c = 0; c < C::N64; ++c) {
        const uint64_t b = mn_major(tile + BQ * 128 * c + t * 2048, 64);
        wgmma_rs_n64(acc + 32 * c, hi[t], b);
        wgmma_rs_n64(acc + 32 * c, lo[t], b);
      }
      if constexpr (C::TAIL > 0) {
        constexpr int w = C::TAIL;
        const uint64_t b =
            mn_major(tile + BQ * 128 * C::N64 + t * 32 * w, w);
        if constexpr (w == 32) {
          wgmma_rs_n32(acc + 32 * C::N64, hi[t], b);
          wgmma_rs_n32(acc + 32 * C::N64, lo[t], b);
        } else {
          wgmma_rs_n16(acc + 32 * C::N64, hi[t], b);
          wgmma_rs_n16(acc + 32 * C::N64, lo[t], b);
        }
      }
    }
  }
}

// acc += dS^T.Q for dS^T (64 keys by BQ queries) as hi + lo from the
// consumer's [64 keys][BQ] shared tiles, K-major (the 16 queries of step t
// 32 bytes into each 128-byte row), and the consumer's columns of the
// [BQ][D] Q tile at `tile`, MN-major: per 16 queries and chunk, hi then
// lo, as start_key_grad sums them.  Started, not waited for.
template <int D>
__device__ __forceinline__ void start_key_grad_smem(float* acc,
                                                    uint32_t ds_hi,
                                                    uint32_t ds_lo,
                                                    uint32_t tile, int wg) {
  using C = Tiles<D>;
  static_assert(C::SPLIT, "the consumers split D");
#pragma unroll
  for (int t = 0; t < BQ / 16; ++t) {
#pragma unroll
    for (int c = 0; c < C::DW / 64; ++c) {
      const uint64_t b = mn_major(
          tile + BQ * 128 * (C::DW / 64 * wg + c) + t * 2048, 64);
      wgmma_ss_kn_n64(acc + 32 * c, k_major(ds_hi + 32 * t, 64), b);
      wgmma_ss_kn_n64(acc + 32 * c, k_major(ds_lo + 32 * t, 64), b);
    }
  }
}

// acc = dS.K over the 64 keys from row `row0` of the [BK][D] K tile at
// `sk`, the consumer's columns: A = dS^T (hi, then lo) from the
// consumer's [64 keys][BQ] tiles, MN-major; B = K, MN-major.  16 keys a
// step.  Started, not waited for.
template <int D>
__device__ __forceinline__ void start_dq(float* acc, uint32_t ds_hi,
                                         uint32_t ds_lo, uint32_t sk,
                                         int row0, int wg) {
  using C = Tiles<D>;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const uint64_t ah = mn_major(ds_hi + t * 2048, 64);
    const uint64_t al = mn_major(ds_lo + t * 2048, 64);
    const int row = row0 + 16 * t;
    if constexpr (C::SPLIT) {
#pragma unroll
      for (int c = 0; c < (C::DW / 64); ++c) {
        const uint64_t b = mn_major(
            sk + C::BK * 128 * ((C::DW / 64) * wg + c) + row * 128, 64);
        wgmma_ss_tt_n64(acc + 32 * c, ah, b, t > 0);
        wgmma_ss_tt_n64(acc + 32 * c, al, b, 1);
      }
    } else {
#pragma unroll
      for (int c = 0; c < C::N64; ++c) {
        const uint64_t b = mn_major(sk + C::BK * 128 * c + row * 128, 64);
        wgmma_ss_tt_n64(acc + 32 * c, ah, b, t > 0);
        wgmma_ss_tt_n64(acc + 32 * c, al, b, 1);
      }
      if constexpr (C::TAIL > 0) {
        constexpr int w = C::TAIL;
        const uint64_t b =
            mn_major(sk + C::BK * 128 * C::N64 + row * 2 * w, w);
        if constexpr (w == 32) {
          wgmma_ss_tt_n32(acc + 32 * C::N64, ah, b, t > 0);
          wgmma_ss_tt_n32(acc + 32 * C::N64, al, b, 1);
        } else {
          wgmma_ss_tt_n16(acc + 32 * C::N64, ah, b, t > 0);
          wgmma_ss_tt_n16(acc + 32 * C::N64, al, b, 1);
        }
      }
    }
  }
}

// Four 8x8 bf16 matrices into shared memory: lane l gives the address of
// row l % 8 of matrix l / 8; register i holds, of matrix i, row lane / 4,
// columns 2(lane % 4) and + 1 (the C fragment's layout).
__device__ __forceinline__ void stmatrix4(uint32_t addr,
                                          const uint32_t (&r)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};" ::
          "r"(addr),
      "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3]) : "memory");
}

// Two floats of shared memory, read where the code reads them (the
// compiler would hoist plain loads ahead of the loop, and spill).
__device__ __forceinline__ float2 ld_shared_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];" : "=f"(v.x), "=f"(v.y)
               : "r"(addr) : "memory");
  return v;
}

// 2^x as the SFU gives it: exp2f without its fix-up of results below
// 2^-126, which flush to 0 (a term of P or dS below 2^-126 of the sum).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// P^T and dS^T in place of the raw scores sc and dp^T of one consumer's
// 64 keys by BQ queries (register 4j + 2h + e: key row r0 + 8h, query
// column 8j + col0 + e), against the stage's lse*log2(e) and D_i at
// `stats` (BQ floats each): x the scaled (and softcapped) logit, P =
// exp2(x*log2(e) - lse*log2(e)), dS = P (dP - D_i) x'(s).  Branch-free;
// the caller masks.
template <bool CAP>
__device__ __forceinline__ void grads(float (&sc)[32], float (&dp)[32],
                                      uint32_t stats, int col0, float scale,
                                      float softcap) {
  const float cap_in = CAP ? scale / softcap : 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 l2 = ld_shared_f2(stats + 4 * (8 * j + col0));
    const float2 dd = ld_shared_f2(stats + 4 * (BQ + 8 * j + col0));
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * h + e;
        float x, dx;
        if constexpr (CAP) {
          const float t = tanhf(sc[i] * cap_in);
          x = softcap * t;
          dx = (1.f - t * t) * scale;
        } else {
          x = sc[i] * scale;
          dx = scale;
        }
        const float p = ex2(x * LOG2E - (e ? l2.y : l2.x));
        dp[i] = p * (dp[i] - (e ? dd.y : dd.x)) * dx;
        sc[i] = p;
      }
  }
}

// dK's and dV's registers into their f32 sums at `acc` (this thread's
// float4 j of dK at acc[128 j], of dV at acc[128 (DW / 8 + j)]): stored by
// the first flush, added in round-to-nearest by the later ones; the
// registers start again from zero.
template <int D>
__device__ __forceinline__ void flush_key_grads(float* dk, float* dv,
                                                float4* acc, bool add) {
  using C = Tiles<D>;
#pragma unroll
  for (int j = 0; j < C::DW / 8; ++j) {
    float4 k4 = make_float4(dk[4 * j], dk[4 * j + 1], dk[4 * j + 2],
                            dk[4 * j + 3]);
    float4 v4 = make_float4(dv[4 * j], dv[4 * j + 1], dv[4 * j + 2],
                            dv[4 * j + 3]);
    if (add) {
      const float4 k0 = acc[j * 128], v0 = acc[(C::DW / 8 + j) * 128];
      k4 = make_float4(k0.x + k4.x, k0.y + k4.y, k0.z + k4.z, k0.w + k4.w);
      v4 = make_float4(v0.x + v4.x, v0.y + v4.y, v0.z + v4.z, v0.w + v4.w);
    }
    acc[j * 128] = k4;
    acc[(C::DW / 8 + j) * 128] = v4;
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[4 * j + i] = dv[4 * j + i] = 0.f;
  }
}

__device__ __forceinline__ bool visible(int i, int j, int S, int T,
                                        int causal, int window) {
  return (i < S) & (j < T) & (!causal | (j <= i)) &
         ((window <= 0) | (j > i - window));
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

struct Maps {   // 3-d tensor maps over (head, row, D), one per chunk width
  CUtensorMap q64, q_tail, do64, do_tail, k64, k_tail, v64, v_tail;
};

struct Args {
  Maps maps;
  const float* lse2;   // (BH, S_pad): lse*log2(e), 0 past S
  const float* di;     // (BH, S_pad): D_i, 0 past S
  float* dq_acc;       // (BH, n_q, 64 * D): the ordered dQ sums, per
                       // tile in the consumers' fragment order
  int* counters;       // (BH, n_q): adds made to each dQ tile
  float4* kv_acc;      // at D = 256, per CTA the consumers' dK and dV sums
                       // of their first FLUSH-step runs, in fragment order
  bf16* dk;
  bf16* dv;
  int S, T, S_pad, n_q, n_kt, group, causal, window;
  float scale, softcap;
};

// (a): D_i = sum_d dO_id (O_id + Olo_id) and lse*log2(e), eight lanes a
// row of the padded (BH, S_pad) layout (0 past S), 16 bytes a load; and
// the counters set to 0.
__global__ void __launch_bounds__(256)
flash_bwd_prep_kernel(const bf16* __restrict__ dout,
                      const bf16* __restrict__ o,
                      const bf16* __restrict__ o_lo,
                      const float* __restrict__ lse, float* __restrict__ di,
                      float* __restrict__ lse2, int* __restrict__ counters,
                      int S, int S_pad, int n_q, int rows, int D) {
  const int row = blockIdx.x * 32 + threadIdx.x / 8;
  const int part = threadIdx.x % 8;
  if (row >= rows) return;   // whole groups of eight lanes leave together
  const int bh = row / S_pad, s = row % S_pad;
  float sum = 0.f, l2 = 0.f;
  if (s < S) {
    const size_t base = (static_cast<size_t>(bh) * S + s) * D;
    for (int c = 8 * part; c < D; c += 64) {
      const uint4 g = *reinterpret_cast<const uint4*>(dout + base + c);
      const uint4 hi = *reinterpret_cast<const uint4*>(o + base + c);
      const uint4 lo = *reinterpret_cast<const uint4*>(o_lo + base + c);
      const uint32_t gw[4] = {g.x, g.y, g.z, g.w};
      const uint32_t hw[4] = {hi.x, hi.y, hi.z, hi.w};
      const uint32_t lw[4] = {lo.x, lo.y, lo.z, lo.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 gf = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&gw[k]));
        const float2 hf = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&hw[k]));
        const float2 lf = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&lw[k]));
        sum = fmaf(gf.x, hf.x + lf.x, sum);
        sum = fmaf(gf.y, hf.y + lf.y, sum);
      }
    }
    l2 = lse[static_cast<size_t>(bh) * S + s] * LOG2E;
  }
  const unsigned group = 0xffu << (threadIdx.x % 32 / 8 * 8);
#pragma unroll
  for (int off = 4; off > 0; off >>= 1)
    sum += __shfl_xor_sync(group, sum, off);
  if (part == 0) {
    di[row] = sum;
    lse2[row] = l2;
    if (s % BQ == 0) counters[static_cast<size_t>(bh) * n_q + s / BQ] = 0;
  }
}

// The query tiles that some key of the BK keys from k0 sees: nq of them from
// q_lo, walked for each of the group's query heads.  Each role computes it
// after setmaxnreg, so that nothing lives across the change of registers.
struct Walk {
  int q_lo, nq, steps;
  // Step n's query head (of the group) and query tile: below D = 256 the
  // heads in turn, each walking its tiles upward; at D = 256 (LOWEST_FIRST)
  // the tiles downward, the group's heads in turn on each.
  template <bool LOWEST_FIRST>
  __device__ __forceinline__ int head(int n, int group) const {
    return LOWEST_FIRST ? n % group : n / nq;
  }
  template <bool LOWEST_FIRST>
  __device__ __forceinline__ int tile(int n, int group) const {
    return LOWEST_FIRST ? q_lo + nq - 1 - n / group : q_lo + n % nq;
  }
};
template <int BK>
__device__ __forceinline__ Walk walk(const Args& a, int k0) {
  int q_lo = 0, q_hi = a.n_q;
  if (a.causal) q_lo = k0 <= a.S - 1 ? k0 / BQ : a.n_q;
  if (a.window > 0) {
    const int k_max = min(k0 + BK - 1, a.T - 1);
    q_hi = min(q_hi, (k_max + a.window - 1) / BQ + 1);
  }
  const int nq = max(0, q_hi - q_lo);
  return {q_lo, nq, a.group * nq};
}

// (b): dK and dV of one key tile (128 keys, 64 at D = 128) of one KV head,
// and its dQ parts.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_sm90_kernel(const __grid_constant__ Args a) {
  using C = Tiles<D>;
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t raw = smem_addr(smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t kv_full = base + C::BAR_OFF;
  const uint32_t full = kv_full + 8, empty = full + 8 * C::STAGES;
  const uint32_t dq_full = empty + 8 * C::STAGES;
  const uint32_t dq_empty = dq_full + 8 * C::NBUF;

  const int kt = C::LOWEST_FIRST ? static_cast<int>(blockIdx.x)
                                 : a.n_kt - 1 - static_cast<int>(blockIdx.x);
  const int kvh = blockIdx.y;
  const int k0 = kt * C::BK;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMER_WARPS);
    }
    for (int b = 0; b < C::NBUF; ++b) {
      mbar_init(dq_full + 8 * b, CONSUMER_WARPS);
      mbar_init(dq_empty + 8 * b, 1);   // the buffer's writer
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp < 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const Walk w = walk<C::BK>(a, k0);
    const int steps = w.steps;
    if (threadIdx.x == 0 && steps > 0) {
      // The loader: one thread starts every load.
      const Maps& m = a.maps;
      const uint32_t sk = base + C::K_OFF, sv = base + C::V_OFF;
      mbar_expect_tx(kv_full, 2 * C::KV_BYTES);
#pragma unroll
      for (int c = 0; c < C::CHUNKS; ++c) {
        tma_load(sk + C::BK * 128 * c, c < C::N64 ? &m.k64 : &m.k_tail,
                 kv_full, 64 * c, k0, kvh);
        tma_load(sv + C::BK * 128 * c, c < C::N64 ? &m.v64 : &m.v_tail,
                 kv_full, 64 * c, k0, kvh);
      }
      for (int n = 0; n < steps; ++n) {
        const int s = n % C::STAGES;
        const int bh = kvh * a.group + w.head<C::LOWEST_FIRST>(n, a.group);
        const int q0 = w.tile<C::LOWEST_FIRST>(n, a.group) * BQ;
        const uint32_t sq = base + C::Q_OFF + 2 * s * C::QT_BYTES;
        const uint32_t sdo = sq + C::QT_BYTES;
        const uint32_t st = base + C::ST_OFF + s * C::STATS_BYTES;
        mbar_wait(empty + 8 * s, ((n / C::STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, C::STAGE_TX);
#pragma unroll
        for (int c = 0; c < C::CHUNKS; ++c) {
          tma_load(sq + BQ * 128 * c, c < C::N64 ? &m.q64 : &m.q_tail,
                   full + 8 * s, 64 * c, q0, bh);
          tma_load(sdo + BQ * 128 * c, c < C::N64 ? &m.do64 : &m.do_tail,
                   full + 8 * s, 64 * c, q0, bh);
        }
        const size_t row = static_cast<size_t>(bh) * a.S_pad + q0;
        bulk_load(st, a.lse2 + row, BQ * 4, full + 8 * s);
        bulk_load(st + BQ * 4, a.di + row, BQ * 4, full + 8 * s);
      }
    } else if (lane == 0 && warp >= 1 && warp <= C::NBUF) {
      // Writer warp w: the dQ parts of the steps that use buffer w - 1,
      // added into the query tile's f32 sum in the tile's turn: part 0
      // (stored by the first tile), then, once that has completed, part 1
      // (at D = 128 and 256 the buffer is one part).  Each step is its own
      // (query head, query tile), so the writers need no order among
      // themselves.
      const int b = warp - 1;
      const uint32_t buf = base + C::DQ_OFF + b * C::BUF_BYTES;
      for (int n = b; n < steps; n += C::NBUF) {
        const int bh = kvh * a.group + w.head<C::LOWEST_FIRST>(n, a.group);
        const int qi = w.tile<C::LOWEST_FIRST>(n, a.group);
        int rank;
        if constexpr (C::LOWEST_FIRST) {   // the lowest key tile first
          rank = kt - (a.window > 0 ? max(0, qi * BQ - a.window + 1) / C::BK
                                    : 0);
        } else {                           // the highest key tile first
          const int q_max = min(qi * BQ + BQ - 1, a.S - 1);
          const int kt_hi =
              a.causal ? min(a.n_kt, q_max / C::BK + 1) : a.n_kt;
          rank = kt_hi - 1 - kt;
        }
        int* const cnt = a.counters + static_cast<size_t>(bh) * a.n_q + qi;
        float* const dst =
            a.dq_acc + (static_cast<size_t>(bh) * a.n_q + qi) * (BQ * D);
        mbar_wait(dq_full + 8 * b, (n / C::NBUF) & 1);
        if (rank > 0) {
          while (ld_acquire(cnt) != rank) {
          }
          asm volatile("fence.proxy.async.global;" ::: "memory");
        }
        if constexpr (C::NBUF == 1) {
          // The one buffer goes back to the consumers once read; the
          // counter moves once the sum is complete.
          bulk_store_f32(dst, buf, C::DQ_BYTES, rank > 0, true);
          mbar_arrive(dq_empty + 8 * b);
          bulk_wait_done();
          asm volatile("fence.proxy.async.global;" ::: "memory");
          red_release(cnt);
        } else {
          bulk_store_f32(dst, buf, C::DQ_BYTES, rank > 0);
          if constexpr (!C::SPLIT)
            bulk_store_f32(dst, buf + C::DQ_BYTES, C::DQ_BYTES, true);
          asm volatile("fence.proxy.async.global;" ::: "memory");
          red_release(cnt);
          mbar_arrive(dq_empty + 8 * b);
        }
      }
    }
  } else {
    // Consumer wg: keys [kc0, kc0 + 64) of the tile, columns [cw0, cw0 +
    // DW) of D.  Thread (warp wq, lane) holds rows r0 and r0 + 8 of every
    // 64-row accumulator, and in every 8 columns the two at col0: register
    // 4j + 2h + e is row r0 + 8h, column 8j + col0 + e.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const Walk w = walk<C::BK>(a, k0);
    const int steps = w.steps;
    const int wg = warp / 4 - 1;
    const int wq = warp % 4;
    const int tid = threadIdx.x % 128;
    const int r0 = 16 * wq + lane / 4, col0 = 2 * (lane % 4);
    const int row0 = C::SPLIT ? 0 : 64 * wg;   // the keys' rows in K, V
    const int kc0 = k0 + row0;
    const int cw0 = C::SPLIT ? C::DW * wg : 0;
    // this thread's float4s of dK's and then dV's flushed sums
    float4* const kv_acc =
        C::FLUSH > 0
            ? a.kv_acc +
                  ((static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) *
                       2 + wg) * (C::DW / 4) * 128 + tid
            : nullptr;

    float dk[C::DW / 2], dv[C::DW / 2];
#pragma unroll
    for (int i = 0; i < C::DW / 2; ++i) dk[i] = dv[i] = 0.f;
    if (steps > 0) mbar_wait(kv_full, 0);
    if (wg == 1) named_arrive<256>(SCHED_BAR);   // consumer 0 goes first

    for (int n = 0; n < steps; ++n) {
      // At D = 256 the tiles' addresses are made anew each step: with one
      // stage every wgmma descriptor is loop-invariant, and held across
      // the loop they would take the registers that dK and dV need.
      uint32_t at = base;
      if constexpr (D == 256) asm volatile("" : "+r"(at));
      const uint32_t sk = at + C::K_OFF, sv = at + C::V_OFF;
      const uint32_t ds_hi = at + C::DS_OFF + 2 * wg * C::DS_BYTES;
      const uint32_t ds_lo = ds_hi + C::DS_BYTES;
      const int s = n % C::STAGES;
      const int q0 = w.tile<C::LOWEST_FIRST>(n, a.group) * BQ;
      const uint32_t sq = at + C::Q_OFF + 2 * s * C::QT_BYTES;
      const uint32_t sdo = sq + C::QT_BYTES;
      const uint32_t lse_t = at + C::ST_OFF + s * C::STATS_BYTES;
      mbar_wait(full + 8 * s, (n / C::STAGES) & 1);

      // S^T and dP^T for the consumer's 64 keys, in its turn.
      float sc[32], dp[32];
      named_sync<256>(SCHED_BAR + wg);
      wgmma_fence();
      start_scores<D>(sc, sk, row0, sq);
      start_scores<D>(dp, sv, row0, sdo);
      wgmma_commit();
      named_arrive<256>(SCHED_BAR + 1 - wg);
      wgmma_wait<0>();
      pin(sc);
      pin(dp);

      // P^T and dS^T in place; masks only on edge tiles, where invisible
      // pairs get P = dS = 0.
      if (a.softcap > 0.f) {
        grads<true>(sc, dp, lse_t, col0, a.scale, a.softcap);
      } else {
        grads<false>(sc, dp, lse_t, col0, a.scale, a.softcap);
      }
      if ((a.causal && kc0 + 63 > q0) ||
          (a.window > 0 && q0 + BQ - 1 - kc0 >= a.window) ||
          kc0 + 64 > a.T || q0 + BQ > a.S) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const bool vis = visible(q0 + 8 * (i / 4) + col0 + i % 2,
                                   kc0 + r0 + 8 * ((i / 2) % 2), a.S, a.T,
                                   a.causal, a.window);
          sc[i] = vis ? sc[i] : 0.f;
          dp[i] = vis ? dp[i] : 0.f;
        }
      }
      uint32_t ph[4][4], pl[4][4], dh[4][4], dl[4][4];
      split(sc, ph, pl);
      split(dp, dh, dl);

      // dS^T, hi and lo, into the consumer's [64 keys][BQ] tiles in the
      // 128-byte swizzle (16-byte chunk j of row r at chunk j ^ (r % 8)),
      // four 8x8 matrices a stmatrix: fragment (t, m) is the matrix of key
      // rows 16 wq + 8(m % 2) on, query columns 16t + 8(m / 2) on, whose
      // row lane % 8 lane gives the address of, for m = lane / 8.
      {
        const int m = lane / 8;
        const int row = 16 * wq + 8 * (m % 2) + lane % 8;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const uint32_t off =
              row * 128 + (((2 * t + m / 2) ^ (lane % 8)) << 4);
          stmatrix4(ds_hi + off, dh[t]);
          stmatrix4(ds_lo + off, dl[t]);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      named_sync<128>(WG_BAR + wg);   // every thread's dS^T is in place

      // dV += P^T.dO and dK += dS^T.Q, and the dQ part = dS.K over the
      // consumer's 64 keys: in one turn, or in two where the registers
      // cannot hold the dQ part beside the fragments.
      float dq[C::DW / 2];
      named_sync<256>(SCHED_BAR + wg);
      pin(dv);
      pin(dk);
      wgmma_fence();
      start_key_grad<D>(dv, ph, pl, sdo, wg);
      if constexpr (C::DK_FROM_SMEM) {
        start_key_grad_smem<D>(dk, ds_hi, ds_lo, sq, wg);
      } else {
        start_key_grad<D>(dk, dh, dl, sq, wg);
      }
      if constexpr (C::ONE_BATCH)
        start_dq<D>(dq, ds_hi, ds_lo, sk, row0, wg);
      wgmma_commit();
      named_arrive<256>(SCHED_BAR + 1 - wg);
      wgmma_wait<0>();
      pin(dv);
      pin(dk);
      pin(ph);
      pin(pl);   // the fragments stay theirs until the products are done
      if constexpr (!C::DK_FROM_SMEM) {
        pin(dh);
        pin(dl);
      }
      if constexpr (C::FLUSH > 0) {
        if (n % C::FLUSH == C::FLUSH - 1 && n != steps - 1)
          flush_key_grads<D>(dk, dv, kv_acc, n >= C::FLUSH);
      }
      release(empty + 8 * s, lane);
      if constexpr (!C::ONE_BATCH) {
        named_sync<256>(SCHED_BAR + wg);
        wgmma_fence();
        start_dq<D>(dq, ds_hi, ds_lo, sk, row0, wg);
        wgmma_commit();
        named_arrive<256>(SCHED_BAR + 1 - wg);
        wgmma_wait<0>();
      }
      pin(dq);

      // The part into dQ buffer n % NBUF in the tile's fragment order
      // (float4 j of thread tid at (j * 128 + tid) * 16 bytes): consumer
      // wg's whole part at part wg of the buffer, or at D = 128 and 256 its
      // column half (float4s DW / 8 wg to DW / 8 (wg + 1) - 1).  The
      // buffer's writer takes it.
      const int b = n % C::NBUF;
      const uint32_t buf =
          at + C::DQ_OFF + b * C::BUF_BYTES +
          (C::SPLIT ? C::DW / 8 * wg * 2048 : wg * C::DQ_BYTES) + tid * 16;
      mbar_wait(dq_empty + 8 * b, ((n / C::NBUF) & 1) ^ 1);
#pragma unroll
      for (int j = 0; j < C::DW / 8; ++j)
        asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(
                         buf + j * 2048),
                     "f"(dq[4 * j]), "f"(dq[4 * j + 1]), "f"(dq[4 * j + 2]),
                     "f"(dq[4 * j + 3]) : "memory");
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      release(dq_full + 8 * b, lane);
    }

    if (wg == 0) named_sync<256>(SCHED_BAR);   // consumer 1's last turn

    // dK and dV, rounded once (after their flushed runs' sum).
    if constexpr (C::FLUSH > 0) {
      if (steps > C::FLUSH) {
#pragma unroll
        for (int j = 0; j < C::DW / 8; ++j) {
          const float4 k4 = kv_acc[j * 128];
          const float4 v4 = kv_acc[(C::DW / 8 + j) * 128];
          dk[4 * j] = k4.x + dk[4 * j];
          dk[4 * j + 1] = k4.y + dk[4 * j + 1];
          dk[4 * j + 2] = k4.z + dk[4 * j + 2];
          dk[4 * j + 3] = k4.w + dk[4 * j + 3];
          dv[4 * j] = v4.x + dv[4 * j];
          dv[4 * j + 1] = v4.y + dv[4 * j + 1];
          dv[4 * j + 2] = v4.z + dv[4 * j + 2];
          dv[4 * j + 3] = v4.w + dv[4 * j + 3];
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = kc0 + r0 + 8 * h;
      if (key >= a.T) continue;
      const size_t row =
          (static_cast<size_t>(kvh) * a.T + key) * D + cw0 + col0;
#pragma unroll
      for (int j = 0; j < C::DW / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(a.dk + row + 8 * j) =
            __floats2bfloat162_rn(dk[4 * j + 2 * h], dk[4 * j + 2 * h + 1]);
        *reinterpret_cast<__nv_bfloat162*>(a.dv + row + 8 * j) =
            __floats2bfloat162_rn(dv[4 * j + 2 * h], dv[4 * j + 2 * h + 1]);
      }
    }
  }
}

// (c): dq = bf16 of the f32 sums, one block a 64-row tile: the tile's
// fragment order (float4 j of thread t: row 16(t / 32) + (t % 32) / 4 and
// + 8, columns 8j + 2(t % 4) and + 1) through shared memory into rows, 16
// bytes a store; built for D up to W.
template <int W>
__global__ void __launch_bounds__(128)
flash_bwd_dq_convert_kernel(const float4* __restrict__ acc,
                            bf16* __restrict__ dq, int S, int n_q, int D) {
  constexpr int LD = W + 8;   // bf16 a shared row
  __shared__ __align__(16) bf16 tile[BQ * LD];
  const int t = threadIdx.x;
  const size_t bh = blockIdx.x / n_q;
  const int q0 = static_cast<int>(blockIdx.x % n_q) * BQ;
  const int r = 16 * (t / 32) + (t % 32) / 4, c = 2 * (t % 4);
  const float4* src = acc + static_cast<size_t>(blockIdx.x) * (D / 8) * 128;
  for (int j = 0; j < D / 8; ++j) {
    const float4 v = src[j * 128 + t];
    *reinterpret_cast<__nv_bfloat162*>(tile + r * LD + 8 * j + c) =
        __floats2bfloat162_rn(v.x, v.y);
    *reinterpret_cast<__nv_bfloat162*>(tile + (r + 8) * LD + 8 * j + c) =
        __floats2bfloat162_rn(v.z, v.w);
  }
  __syncthreads();
  const int rows = min(BQ, S - q0), chunks = D / 8;
  for (int i = t; i < rows * chunks; i += 128) {
    const int row = i / chunks, ch = i % chunks;
    *reinterpret_cast<uint4*>(dq + (bh * S + q0 + row) * D + 8 * ch) =
        *reinterpret_cast<const uint4*>(tile + row * LD + 8 * ch);
  }
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime, so that the
// library links without -lcuda.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 3-d map over (heads, rows, D) of bf16: boxes of `width` columns by
// `box_rows` rows of one head, swizzled to the width.  Rows past `rows` come
// in as zeros.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* base, int heads,
            int rows, int D, int width, int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(rows) * D * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(width),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      width == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
      : width == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                    : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Call {   // one launch's operands, as the wrapper passes them
  const void *q, *k, *v, *o, *o_lo, *dout;
  const float* lse;
  void *dq, *dk, *dv;
  float *di, *lse2, *dq_acc;
  int* counters;
  float* kv_acc;
  int BH, BKV, S, T, causal, window;
  float softcap;
  cudaStream_t stream;
};

template <int D>
int launch(const Call& c) {
  using C = Tiles<D>;
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return ERR_NO_ENCODER;
  Args a{};
  Maps& m = a.maps;
  bool ok = true;
  if (C::N64 > 0)
    ok = encode(fn, &m.q64, c.q, c.BH, c.S, D, 64, BQ) &&
         encode(fn, &m.do64, c.dout, c.BH, c.S, D, 64, BQ) &&
         encode(fn, &m.k64, c.k, c.BKV, c.T, D, 64, C::BK) &&
         encode(fn, &m.v64, c.v, c.BKV, c.T, D, 64, C::BK);
  if (C::TAIL > 0)
    ok = ok && encode(fn, &m.q_tail, c.q, c.BH, c.S, D, C::TAIL, BQ) &&
         encode(fn, &m.do_tail, c.dout, c.BH, c.S, D, C::TAIL, BQ) &&
         encode(fn, &m.k_tail, c.k, c.BKV, c.T, D, C::TAIL, C::BK) &&
         encode(fn, &m.v_tail, c.v, c.BKV, c.T, D, C::TAIL, C::BK);
  if (!ok) return ERR_TENSOR_MAP;
  a.n_q = (c.S + BQ - 1) / BQ;
  a.S_pad = a.n_q * BQ;
  a.n_kt = (c.T + C::BK - 1) / C::BK;
  a.lse2 = c.lse2;
  a.di = c.di;
  a.dq_acc = c.dq_acc;
  a.counters = c.counters;
  a.kv_acc = reinterpret_cast<float4*>(c.kv_acc);
  a.dk = static_cast<bf16*>(c.dk);
  a.dv = static_cast<bf16*>(c.dv);
  a.S = c.S;
  a.T = c.T;
  a.group = c.BH / c.BKV;
  a.causal = c.causal;
  a.window = c.window;
  a.scale = 1.0f / sqrtf(static_cast<float>(D));
  a.softcap = c.softcap;
  const int rows = c.BH * a.S_pad;
  flash_bwd_prep_kernel<<<(rows + 31) / 32, 256, 0, c.stream>>>(
      static_cast<const bf16*>(c.dout), static_cast<const bf16*>(c.o),
      static_cast<const bf16*>(c.o_lo), c.lse, c.di, c.lse2, c.counters, c.S,
      a.S_pad, a.n_q, rows, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_sm90_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Within a KV head the key tiles go highest first: a CTA waits only on
  // CTAs launched before it.
  flash_bwd_sm90_kernel<D><<<dim3(a.n_kt, c.BKV), THREADS, C::SMEM,
                             c.stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_convert_kernel<(D > 128 ? 256 : 128)>
      <<<c.BH * a.n_q, 128, 0, c.stream>>>(
          reinterpret_cast<const float4*>(c.dq_acc),
          static_cast<bf16*>(c.dq), c.S, a.n_q, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the three kernels on `stream` and returns 0 or an error code
// for flash_attention_sm90_error_string.  q, dout, o, o_lo, dq: (BH, S,
// D); k, v, dk, dv: (BKV, T, D); all contiguous bf16, 16-byte aligned;
// lse: (BH, S) f32 from the forward.  Scratch, written here: di and lse2
// (BH, S_pad) f32, dq_acc (BH, S_pad, D) f32 and counters (BH, S_pad / 64)
// int32, S_pad = S rounded up to 64, 16-byte aligned; at D = 256 kv_acc,
// BKV * ceil(T / 64) * 32768 f32 (null at other head dims).  The caller
// checks shapes, BH % BKV == 0, D in {16, 32, 64, 80, 96, 128, 256}, BKV
// within the grid's 65535 and every index below 2**31.
extern "C" int flash_attention_bwd_sm90_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* o_lo, const float* lse, const void* dout, void* dq, void* dk,
    void* dv, float* di, float* lse2, float* dq_acc, int* counters,
    float* kv_acc, int BH,
    int BKV, int S, int T, int D, int causal, int window, float softcap,
    void* stream) {
  const Call c{q,      k,      v,  o,      o_lo,     dout,   lse,
               dq,     dk,     dv, di,     lse2,     dq_acc, counters,
               kv_acc,
               BH,     BKV,    S,  T,      causal,   window, softcap,
               static_cast<cudaStream_t>(stream)};
  switch (D) {
    case 16: return launch<16>(c);
    case 32: return launch<32>(c);
    case 64: return launch<64>(c);
    case 80: return launch<80>(c);
    case 96: return launch<96>(c);
    case 128: return launch<128>(c);
    case 256: return launch<256>(c);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The main kernel's dynamic shared memory at head dim D (0 if not built
// for D).
extern "C" int flash_attention_bwd_sm90_smem_bytes(int D) {
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

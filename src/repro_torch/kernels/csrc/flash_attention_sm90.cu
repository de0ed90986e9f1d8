// Flash attention forward in bf16 for Hopper (sm_90a): tensor cores through
// wgmma, a TMA-fed ring of K/V tiles, one producer warpgroup and two
// consumer warpgroups.  GQA, causal (top-left), optional sliding window and
// logit softcap; bf16 in and out, f32 statistics and accumulation.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:84
// (flash_attention_kernel, body _kernel) for bf16 inputs:
//
//   o[bh, i] = sum_j softmax_j( mask(i, j) ? c*tanh(q_i.k_j / (c*sqrt(D)))
//                                          : -1e30 ) * v_j
//
// with k, v of KV head bh / group, mask(i, j) = [j <= i if causal] and
// [j > i - window if window > 0], and c the softcap (none when 0).  q is
// (BH, S, D), k and v are (BKV, T, D), BH = BKV * group, all contiguous.
// f32 inputs go to the CUDA-core kernel in flash_attention.cu, which keeps
// them exact to reordered sums; tensor cores cannot.
//
// What bounds it on an H100 SXM: per (query, visible key) pair it does
// 4*D operations (q.k and p*v) on 2 bytes of q, k, v and o per element of
// each, read once.  At gemma2-2b's prefill (S = T = 8192, D = 256) that is
// some 10^4 operations per byte, far above the card's balance of 295 for
// bf16 tensor cores (989 TFLOP/s over 3.35 TB/s), so the bound is the
// operations at 989 TFLOP/s.  What the design does about it:
//   * both products run on the tensor cores: S = Q.K^T as wgmma with Q and
//     K in shared memory (both K-major: D contiguous, no transpose), and
//     O += P.V with P from registers (the f32 fragment of S is already the
//     bf16 A fragment of the next wgmma, 16 keys at a time) and V in shared
//     memory, MN-major (D contiguous), read through the descriptor's
//     transpose;
//   * one CTA per (128-query tile, query head), the tiles launched
//     longest-first so that the causal tail of the grid is short; three
//     warpgroups: a producer whose one thread starts every TMA load (it
//     gives registers away with setmaxnreg), and two consumers of 64 query
//     rows each (which take them);
//   * Q is loaded once; K and V each go through a ring of STAGES tiles in
//     shared memory, handed over by full and empty mbarriers, so that the
//     next tiles' loads run under this tile's math.  K's stage is given
//     back after the first product and V's after the second, so that two
//     stages suffice at D = 256.  The tensor maps are 3-d over (head, row,
//     D), so TMA zero-fills rows past S or T inside each head and never
//     reads the next head's rows;
//   * the consumers overlap softmax with the tensor cores: each starts
//     Q.K^T of tile n and P.V of tile n - 1 together, in turn with the
//     other consumer (two named barriers), then runs tile n's softmax
//     under its own P.V and the other's products.  O is rescaled only when
//     some row's max moved;
//   * D is cut into 64-wide column chunks, 128-byte swizzled, and one
//     16- or 32-wide tail chunk, 32- or 64-byte swizzled (D = 80 = 64 + 16
//     and D = 96 = 64 + 32: a 160- or 192-byte row does not fit one
//     128-byte swizzle atom); every wgmma descriptor names the swizzle of
//     its chunk's tensor map;
//   * masking runs only on tiles that cross the diagonal, a window's left
//     edge or T; tiles that no row of the CTA can see are skipped.  Both
//     consumers walk the same tiles, so that their turns pair up; a tile
//     that one consumer's rows cannot see is masked there like any other.
// Numerics.  Products of bf16 values are exact in f32, so S differs from
// the CUDA-core kernel only in the order of its sums; 1/sqrt(D) is applied
// to the f32 scores, never rounded into Q.  P is carried as hi + lo bf16
// (hi = bf16(p), lo = bf16(p - hi)), two wgmmas into the same accumulator:
// one bf16 P would carry 2^-9 relative error per weight, about the whole
// 2e-5 per-element limit at S = 8192 (|o| ~ 0.018 there), while the split
// leaves some 2^-17, for 1.5x the tensor-core work.  The softcap uses the
// accurate tanhf (tanh.approx's 2^-11, times c = 50, would move a logit by
// 0.024), exp2f runs on (s - m)*log2(e), unfused, so that s = m gives
// exactly 1.  Masked logits are -1e30 as in JAX and keys past T -inf: a
// row whose first visited tile is wholly masked takes exp(0) garbage that
// the first visible key's alpha = 0 wipes.  The output is divided by
// max(l, 1e-30), rounded once to bf16 and stored from registers; rows past
// S are never written.  A row that sees no key at all would get 0 where
// JAX gives the mean of v, so the wrapper refuses such windows.
// For the backward (flash_attention_bwd_sm90.cu) the epilogue also writes,
// where the caller passes the pointers, each row's log-sum-exp of its
// logits x (lse = max x + ln l, f32) and O's lo part, lo = bf16(o -
// bf16(o)): D_i = rowsum(dO * O) then takes O to 2^-17, not the bf16 O's
// 2^-9, which would move every dS by up to 2^-9 of sum|dO||O|, about the
// gradient's whole half-ulp limit.  lo costs 2 bytes an element where an
// f32 copy of O would cost 4.  O itself is computed and rounded as without
// them, so the inference path's output keeps its bits.
//
// Shared memory: Q 128*D*2 bytes, STAGES * 2 * BK*D*2 of K and V: 192 KB
// at D = 256 (BK = 64, 2 stages), 141 KB at D = 80 and 169 KB at D = 96
// (BK = 128, 3 stages).
// Registers: consumers 240 (O is 128 of them at D = 256, S 32, P 32),
// the producer 24.  What it leaves on the table: P's split costs 1.5x the
// tensor-core work of one bf16 P; at D = 256 the registers allow only
// 64-key tiles, so Q.K^T reads both operands from shared memory at N = 64,
// near the shared-memory rate; a single-query decode step has no split-KV
// form; the op's (B, S, H, D) <-> (BH, S, D) copies around the kernel.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BQ = 128;               // query rows per CTA, 64 per consumer
constexpr int THREADS = 384;          // producer + two consumer warpgroups
constexpr int CONSUMER_WARPS = 8;
constexpr float MASKED = -1e30f;      // the JAX kernel's NEG_INF
constexpr float LOG2E = 1.4426950408889634f;
#define NO_KEY __int_as_float(0xff800000)   // -inf, keys past T
constexpr int ERR_NO_ENCODER = 10001;
constexpr int ERR_TENSOR_MAP = 10002;

// Tiles per head dim.  Chunk c of a [rows][D] tile in shared memory holds
// columns [64c, 64c + width) as a dense [rows][width] block at byte offset
// rows * 128 * c: width 64 for c < N64, else TAIL.
template <int D>
struct Tiles {
  static constexpr int BK = (D == 256 || D == 128) ? 64 : 128;  // keys
  static constexpr int STAGES = D == 256 ? 2 : 3;               // K/V ring
  static constexpr int N64 = D / 64;
  static constexpr int TAIL = D % 64;
  static constexpr int CHUNKS = N64 + (TAIL ? 1 : 0);
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;    // K or V of one stage
  // + 1024 to align the base for the 128-byte swizzle, + the mbarriers
  static constexpr int SMEM = Q_BYTES + STAGES * 2 * KV_BYTES + 1024 + 128;
  static_assert(D % 16 == 0 && (TAIL == 0 || TAIL == 16 || TAIL == 32),
                "head dim");
  static_assert(SMEM <= 232448, "shared memory");
};

__host__ __device__ constexpr int chunk_width(int D, int c) {
  return c < D / 64 ? 64 : D % 64;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets, and the swizzle that the chunk's tensor map wrote (128 B
// for width 64, 64 B for 32, 32 B for 16).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int width) {
  const uint64_t swizzle = width == 64 ? 1 : width == 32 ? 2 : 3;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (swizzle << 62);
}

// K-major chunk (Q or K: the product's K dim, D, contiguous): 8-row groups
// lie 8 * width * 2 bytes apart; the leading offset is unused.
__device__ __forceinline__ uint64_t k_major(uint32_t addr, int width) {
  return smem_desc(addr, 16, 16 * width, width);
}

// MN-major chunk (V: its N dim, D, contiguous; K = keys down the rows):
// 8-key groups lie 8 * width * 2 bytes apart.  N never exceeds one swizzle
// atom here, so the offset to the next atom along N is never taken; both
// fields carry the group stride.
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

// Named barriers 1 and 2 (0 is __syncthreads) make the two consumers take
// turns on the tensor cores: each waits on its own barrier before starting
// its products, then arrives on the other's.
constexpr int SCHED_BAR = 1;
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;" ::"r"(id) : "memory");
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

// d[0..64) (+)= A·B for A, B in shared memory (K-major, descriptors).
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t a_desc,
                                              uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, %64, %65, p, 1, 1, 0, 0;"
      "\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
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

struct Maps {   // 3-d tensor maps over (head, row, D), one per chunk width
  CUtensorMap q64, q_tail, k64, k_tail, v64, v_tail;
};

struct Args {
  Maps maps;
  __nv_bfloat16* o;
  __nv_bfloat16* o_lo;   // null, or o's lo part for the backward
  float* lse;            // null, or the rows' log-sum-exp for the backward
  int S, T, group, causal, window, q_tiles;
  float scale, softcap;
};

// S = Q.K^T for one key tile: 16 columns of D a step, the consumer's 64
// rows of Q against the BK keys of the stage at `sk`.  Started, not waited for.
template <int D>
__device__ __forceinline__ void start_qk(float* sc, uint32_t sq, int wg,
                                         uint32_t sk) {
  constexpr int BK = Tiles<D>::BK;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk / 4, w = chunk_width(D, c);
    const uint64_t qd =
        k_major(sq + BQ * 128 * c + 64 * wg * w * 2 + 32 * (kk % 4), w);
    const uint64_t kd = k_major(sk + BK * 128 * c + 32 * (kk % 4), w);
    if constexpr (BK == 64) {
      wgmma_ss_n64(sc, qd, kd, kk > 0);
    } else {
      wgmma_ss_n128(sc, qd, kd, kk > 0);
    }
  }
}

// O += P.V for one key tile: per 16 keys, P's hi then lo against each
// chunk of the V tile at `sv`.  Started, not waited for.
template <int D>
__device__ __forceinline__ void start_pv(float* o, const uint32_t (*ph)[4],
                                         const uint32_t (*pl)[4],
                                         uint32_t sv) {
  using C = Tiles<D>;
#pragma unroll
  for (int t = 0; t < C::BK / 16; ++t) {
#pragma unroll
    for (int c = 0; c < C::N64; ++c) {
      const uint64_t vd = mn_major(sv + C::BK * 128 * c + t * 2048, 64);
      wgmma_rs_n64(o + 32 * c, ph[t], vd);
      wgmma_rs_n64(o + 32 * c, pl[t], vd);
    }
    if constexpr (C::TAIL > 0) {
      constexpr int w = C::TAIL;
      const uint64_t vd = mn_major(sv + C::BK * 128 * C::N64 + t * 32 * w, w);
      if constexpr (w == 32) {
        wgmma_rs_n32(o + 32 * C::N64, ph[t], vd);
        wgmma_rs_n32(o + 32 * C::N64, pl[t], vd);
      } else {
        wgmma_rs_n16(o + 32 * C::N64, ph[t], vd);
        wgmma_rs_n16(o + 32 * C::N64, pl[t], vd);
      }
    }
  }
}

// P as hi + lo bf16, in the A-fragment order of the P.V wgmma: registers
// 8t..8t+7 of S are keys 16t..16t+15.
template <int BK>
__device__ __forceinline__ void split_p(const float (&p)[BK / 2],
                                        uint32_t (&ph)[BK / 16][4],
                                        uint32_t (&pl)[BK / 16][4]) {
#pragma unroll
  for (int t = 0; t < BK / 16; ++t) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x = p[8 * t + 2 * r], y = p[8 * t + 2 * r + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(x, y);
      const float2 hf = __bfloat1622float2(hi);
      ph[t][r] = bits(hi);
      pl[t][r] = bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
    }
  }
}

// The online softmax of one consumer thread's two rows over a key tile.
struct Softmax {
  int causal, window, T;
  float scale, softcap;
  int row0, col0, r_lo;   // rows row0, row0 + 8; the consumer's first row

  // Raw scores in, p = exp2((s - m)*sl2) out, in place: softcap, masks on
  // edge tiles only, the row max over the 4 lanes that share a row, and l
  // and m brought up to date; alpha rescales what was summed before.
  template <int N>
  __device__ __forceinline__ void apply(float (&sc)[N], int kb, float (&m)[2],
                                        float (&l)[2],
                                        float (&alpha)[2]) const {
    constexpr int BK = 2 * N;
    const bool capped = softcap > 0.f;
    const float sl2 = (capped ? 1.f : scale) * LOG2E;
    if (capped) {
      const float cap_in = scale / softcap;
#pragma unroll
      for (int i = 0; i < N; ++i) sc[i] = softcap * tanhf(sc[i] * cap_in);
    }
    const bool edge = (causal && kb + BK - 1 > r_lo) ||
                      (window > 0 && kb <= r_lo + 63 - window) ||
                      kb + BK > T;
    if (edge) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int row = row0 + 8 * ((i / 2) % 2);
        const int key = kb + 8 * (i / 4) + col0 + i % 2;
        bool visible = !causal || key <= row;
        if (window > 0) visible = visible && key > row - window;
        sc[i] = key >= T ? NO_KEY : visible ? sc[i] : MASKED;
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < N; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = exp2f((m[h] - mx[h]) * sl2);
      m[h] = mx[h];
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      sc[i] = exp2f((sc[i] - m[(i / 2) % 2]) * sl2);
      sum[(i / 2) % 2] += sc[i];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + sum[h];
  }
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_sm90_kernel(const __grid_constant__ Args a) {
  using C = Tiles<D>;
  constexpr int BK = C::BK, STAGES = C::STAGES;
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t sq = (smem_addr(smem) + 1023) & ~1023u;   // Q, [BQ][D]
  const uint32_t skv = sq + C::Q_BYTES;   // stage s: K, then V, [BK][D]
  // mbarriers: Q in; per stage s (+ 8s), K in, K read, V in, V read.  K and
  // V have rings of their own: K is read by the first product, V by the
  // second, half a tile later.
  const uint32_t q_full = skv + STAGES * 2 * C::KV_BYTES;
  const uint32_t k_full = q_full + 8, k_empty = k_full + 8 * STAGES;
  const uint32_t v_full = k_empty + 8 * STAGES;
  const uint32_t v_empty = v_full + 8 * STAGES;

  const int bh = blockIdx.x;
  const int q0 = (a.q_tiles - 1 - static_cast<int>(blockIdx.y)) * BQ;
  // The key tiles that some row of this CTA can see.
  int k_lo = 0, k_hi = a.T;
  if (a.window > 0) k_lo = max(0, q0 - a.window + 1) / BK * BK;
  if (a.causal) k_hi = min(a.T, q0 + BQ);
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, CONSUMER_WARPS);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(v_empty + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp < 4) {
    // Producer: one thread starts every load.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      const Maps& m = a.maps;
      const int kv_head = bh / a.group;
      mbar_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < C::CHUNKS; ++c)
        tma_load(sq + BQ * 128 * c, c < C::N64 ? &m.q64 : &m.q_tail, q_full,
                 64 * c, q0, bh);
      // K of tile n, then V of tile n - 1: the consumers take them in
      // that order.
      for (int n = 0; n <= n_tiles; ++n) {
        if (n < n_tiles) {
          const int s = n % STAGES;
          mbar_wait(k_empty + 8 * s, ((n / STAGES) & 1) ^ 1);
          mbar_expect_tx(k_full + 8 * s, C::KV_BYTES);
#pragma unroll
          for (int c = 0; c < C::CHUNKS; ++c)
            tma_load(skv + 2 * s * C::KV_BYTES + BK * 128 * c,
                     c < C::N64 ? &m.k64 : &m.k_tail, k_full + 8 * s, 64 * c,
                     k_lo + n * BK, kv_head);
        }
        if (n > 0) {
          const int j = n - 1, s = j % STAGES;
          mbar_wait(v_empty + 8 * s, ((j / STAGES) & 1) ^ 1);
          mbar_expect_tx(v_full + 8 * s, C::KV_BYTES);
#pragma unroll
          for (int c = 0; c < C::CHUNKS; ++c)
            tma_load(skv + (2 * s + 1) * C::KV_BYTES + BK * 128 * c,
                     c < C::N64 ? &m.v64 : &m.v_tail, v_full + 8 * s, 64 * c,
                     k_lo + j * BK, kv_head);
        }
      }
    }
  } else {
    // Consumer wg: query rows [r_lo, r_lo + 64) of the tile.  Thread
    // (warp wq, lane) holds rows row0 and row0 + 8, and in every 8 columns
    // of an accumulator the two at col0: register 4j + 2h + e is row
    // row0 + 8h, column 8j + col0 + e.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = warp / 4 - 1;
    const int lane = threadIdx.x % 32;
    const int r_lo = q0 + 64 * wg;
    const Softmax sm{a.causal, a.window, a.T, a.scale, a.softcap,
                     r_lo + 16 * (warp % 4) + lane / 4, 2 * (lane % 4),
                     r_lo};

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {MASKED, MASKED}, l[2] = {0.f, 0.f};
    float sc[BK / 2];
    uint32_t ph[BK / 16][4], pl[BK / 16][4];

    mbar_wait(q_full, 0);
    if (wg == 1) named_arrive(SCHED_BAR);   // consumer 0 goes first
    if (n_tiles > 0) {   // the first tile: S, its softmax, its P
      mbar_wait(k_full, 0);
      named_sync(SCHED_BAR + wg);
      wgmma_fence();
      start_qk<D>(sc, sq, wg, skv);
      wgmma_commit();
      named_arrive(SCHED_BAR + 1 - wg);
      wgmma_wait<0>();
      pin(sc);
      release(k_empty, lane);
      float alpha[2];   // o is 0 still
      sm.apply(sc, k_lo, m, l, alpha);
      split_p<BK>(sc, ph, pl);
    }
    for (int n = 1; n < n_tiles; ++n) {
      const int s = n % STAGES, prev = (n - 1) % STAGES;
      mbar_wait(k_full + 8 * s, (n / STAGES) & 1);
      mbar_wait(v_full + 8 * prev, ((n - 1) / STAGES) & 1);
      // In turn with the other consumer: S of this tile, then O += P.V of
      // the previous one, which runs under this tile's softmax.
      named_sync(SCHED_BAR + wg);
      pin(o);
      wgmma_fence();
      start_qk<D>(sc, sq, wg, skv + 2 * s * C::KV_BYTES);
      wgmma_commit();
      start_pv<D>(o, ph, pl, skv + (2 * prev + 1) * C::KV_BYTES);
      wgmma_commit();
      named_arrive(SCHED_BAR + 1 - wg);
      wgmma_wait<1>();
      pin(sc);
      release(k_empty + 8 * s, lane);
      float alpha[2];
      sm.apply(sc, k_lo + n * BK, m, l, alpha);
      wgmma_wait<0>();
      pin(o);
      pin(ph);
      pin(pl);   // P's registers stay P's until its product is done
      release(v_empty + 8 * prev, lane);
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i / 2) % 2];
      }
      split_p<BK>(sc, ph, pl);
    }
    if (n_tiles > 0) {   // the last tile's O += P.V
      const int j = n_tiles - 1, s = j % STAGES;
      mbar_wait(v_full + 8 * s, (j / STAGES) & 1);
      pin(o);
      wgmma_fence();
      start_pv<D>(o, ph, pl, skv + (2 * s + 1) * C::KV_BYTES);
      wgmma_commit();
      wgmma_wait<0>();
      pin(o);
      release(v_empty + 8 * s, lane);
    }
    if (wg == 0) named_sync(SCHED_BAR);   // the other's last arrive

    // l is this thread's share of its rows' sums; the quad holds the rest.
    const size_t head = static_cast<size_t>(bh) * a.S;
    // The log-sum-exp of the rows' logits x: m is in units of x / unit.
    const float unit = a.softcap > 0.f ? 1.f : a.scale;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      const float denom = fmaxf(l[h], 1e-30f);
      const int row = sm.row0 + 8 * h;
      if (row < a.S) {
        const size_t at = (head + row) * D + sm.col0;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const __nv_bfloat162 hi = __floats2bfloat162_rn(
              o[4 * j + 2 * h] / denom, o[4 * j + 2 * h + 1] / denom);
          *reinterpret_cast<__nv_bfloat162*>(a.o + at + 8 * j) = hi;
          if (a.o_lo != nullptr) {
            const float2 hf = __bfloat1622float2(hi);
            *reinterpret_cast<__nv_bfloat162*>(a.o_lo + at + 8 * j) =
                __floats2bfloat162_rn(o[4 * j + 2 * h] / denom - hf.x,
                                      o[4 * j + 2 * h + 1] / denom - hf.y);
          }
        }
        if (a.lse != nullptr && sm.col0 == 0)
          a.lse[head + row] = m[h] * unit + logf(denom);
      }
    }
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
  const void* q;
  const void* k;
  const void* v;
  void* o;
  void* o_lo;
  float* lse;
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
         encode(fn, &m.k64, c.k, c.BKV, c.T, D, 64, C::BK) &&
         encode(fn, &m.v64, c.v, c.BKV, c.T, D, 64, C::BK);
  if (C::TAIL > 0)
    ok = ok && encode(fn, &m.q_tail, c.q, c.BH, c.S, D, C::TAIL, BQ) &&
         encode(fn, &m.k_tail, c.k, c.BKV, c.T, D, C::TAIL, C::BK) &&
         encode(fn, &m.v_tail, c.v, c.BKV, c.T, D, C::TAIL, C::BK);
  if (!ok) return ERR_TENSOR_MAP;
  a.o = static_cast<__nv_bfloat16*>(c.o);
  a.o_lo = static_cast<__nv_bfloat16*>(c.o_lo);
  a.lse = c.lse;
  a.S = c.S;
  a.T = c.T;
  a.group = c.BH / c.BKV;
  a.causal = c.causal;
  a.window = c.window;
  a.q_tiles = (c.S + BQ - 1) / BQ;
  a.scale = 1.0f / sqrtf(static_cast<float>(D));
  a.softcap = c.softcap;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_sm90_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(c.BH, a.q_tiles);   // every head of the longest tiles first
  flash_attention_sm90_kernel<D><<<grid, THREADS, C::SMEM, c.stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns 0 or an error code for
// flash_attention_sm90_error_string.  q, k, v and o are contiguous bf16,
// 16-byte aligned; the caller checks shapes, BH % BKV == 0, D in {16, 32,
// 64, 80, 96, 128, 256}, S <= 65535 * 128 and every index below 2**31.
// For the backward, o_lo (bf16, o's shape) and lse (f32, (BH, S)) are
// written where not null; o is the same either way.
extern "C" int flash_attention_sm90_bf16(const void* q, const void* k,
                                         const void* v, void* o, void* o_lo,
                                         float* lse, int BH, int BKV, int S,
                                         int T, int D, int causal, int window,
                                         float softcap, void* stream) {
  const Call c{q, k, v, o, o_lo, lse, BH, BKV, S, T, causal, window, softcap,
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

// The kernel's dynamic shared memory at head dim D (0 if not built for D).
extern "C" int flash_attention_sm90_smem_bytes(int D) {
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

extern "C" const char* flash_attention_sm90_error_string(int err) {
  if (err == ERR_NO_ENCODER)
    return "cuTensorMapEncodeTiled not found (needs CUDA 12.0 or later)";
  if (err == ERR_TENSOR_MAP)
    return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

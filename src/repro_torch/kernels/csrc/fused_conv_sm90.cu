// Fused CONV + BN(folded) [+ residual ADD] [+ ReLU] for Hopper (sm_90a),
// the products on the tensor cores through wgmma, in two routes:
//   * f32 in and out (fused_conv_sm90_f32): each f32 product carried as
//     three bf16 products with f32 accumulation;
//   * bf16 in and out (fused_conv_sm90_bf16): one bf16 product per k-step,
//     exact in the f32 accumulator; see "The bf16 route" below.
// Both read scale and shift as f32, add in f32 and round once to the
// output's type, as the Pallas kernel does (it reads every operand as f32
// and writes x.dtype).
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_conv.py:82
// (fused_conv_kernel, body _kernel): the PIMcore fused op of the paper's
// Table I (CONV_BN / CONV_BN_RELU / ADD_RELU).
//
//   y[b,oh,ow,n] = [relu]( sum_k patch(b,oh,ow)[k] * w[k,n] * scale[n]
//                          + shift[n] [+ residual[b,oh,ow,n]] )
//
// x is NHWC, w is HWIO, so w is already the (K = kh*kw*Cin) x Cout matrix of
// an implicit GEMM whose rows are the M = B*OH*OW output pixels; k runs over
// (r, c, ci) with ci fastest, the order of a patch row in NHWC memory.
//
// Numerics.  Each operand is split on the card into hi = bf16(v) and lo =
// bf16(v - hi), and a·b is taken as a_hi·b_hi + a_hi·b_lo + a_lo·b_hi, all
// three on the tensor cores into one f32 accumulator (products of bf16 are
// exact in f32).  What is dropped, a_lo·b_lo and the rounding of lo, is
// some 2^-16 of each product: a CPU emulation at ResNet18's shapes puts the
// conv within 5e-6·max|conv| of f64 (tests/test_torch_fused_conv.py), 20x
// inside the 1e-4 limit, where one bf16 pass (2e-3) or one TF32 pass
// (3e-4) misses it.  Three TF32 products would be ~100x more accurate, at
// half the rate, and TF32 wgmma takes K-major operands only; the bf16
// split holds the limit with room to spare, so it was chosen.  An inf
// input makes lo = inf - inf = NaN, so ±inf gives NaN where the plain conv
// gives ±inf; NaN stays NaN.
//
// What bounds it on an H100 SXM: the three products are 3·2·M·N·K
// operations at 989 TFLOP/s, some 0.09 ms per batch-8 ResNet18 forward,
// against 0.43 ms for the same f32 work on the CUDA cores; the stem (K =
// 147, Cin = 3) is bound by its bytes.  What the design does about it:
//   * a block computes a 128-pixel x BN-channel tile (BN = 64 or 128) in
//     32-deep k-blocks, with four warpgroups in two roles, handing work
//     over through mbarriers, never a block-wide barrier in the loop:
//   * two producer warpgroups stage each k-block asynchronously: cp.async
//     copies the f32 patches (a gather: 16 bytes along Cin where Cin % 4 ==
//     0, else 4 bytes, zero-filled for padding and the ragged M and K
//     edges) and the f32 weight rows into a ring of STAGES k-blocks, and
//     signals each stage's mbarrier as its copies land; they then split the
//     weights into hi and lo bf16 tiles, transposed to K-major and 64-byte
//     swizzled as a TMA box would lay them, in one of two buffers;
//   * two consumer warpgroups of 64 rows each read their patch fragments
//     from the ring, split them into hi and lo in registers, and issue
//     m64n64k16 wgmmas with A from registers and B from the weight tiles:
//     per k-block 2 k-steps x 3 products x BN/64 column halves, while the
//     producers stage and split the next k-blocks;
//   * K is padded to the k-block with zeros in shared memory only;
//   * grids under one wave (stages 3 and 4 of ResNet18 give 16-26 tiles
//     for 132 SMs) split K over a thread block cluster of up to 8 blocks;
//     the wrapper picks BN and the split per shape, counting how many
//     clusters of that size the card holds at once.  Each block leaves its
//     partial tile in shared memory; block r of the cluster sums the
//     partials of every block, in rank order, for its share of the tile's
//     rows, through distributed shared memory, and runs the epilogue: one
//     launch, no workspace, no atomics, the same bits on every run;
//   * the epilogue (scale, shift, residual, ReLU) runs on the sums and
//     stores each output once: the fused layer makes one device-memory
//     round trip, as on the PIM bank and the TPU.
// What holds it back: the producers.  A k-block's copies pull 32 KB from
// L2 (every m-tile re-reads the weights, every tap of a 3x3 window the
// patches), and the weight split is a second pass over them.  f32 in and
// out doubles bf16's bytes; TMA's im2col mode and a persistent grid are
// later work.
//
// The bf16 route (x, w and any residual in bf16; fused_conv_bf16_sm90_kernel).
// Products of bf16 values are exact in f32, so one product per 16-deep
// k-step carries what the f32 route needs three for, and nothing is split:
//   * the same block (128 pixels x BN channels, four warpgroups, two that
//     stage and two that multiply, mbarriers between them), the same split
//     of K over a cluster summed in rank order, the same one epilogue;
//   * 64-deep k-blocks, so that a staged bf16 row is 128 bytes, one
//     128-byte swizzle atom, in a ring of STAGES16 k-blocks: cp.async
//     copies 8 channels (16 bytes) of a patch row, so Cin % 8 == 0 and x
//     16-byte aligned.  The stem's Cin = 3 (a 6-byte pixel, no cp.async
//     size) comes in padded with zero channels to 8 by the wrapper: exact,
//     2.7x the stem's products and a copy of x, and still 1.5x faster on
//     an H100 than gathering its elements one by one through registers
//     (0.0455 ms + 0.0071 for the copy, against 0.0814, at batch 8);
//   * A (the patches) and B (the weights) are both read by wgmma from
//     shared memory: the patch rows K-major, the HWIO weight rows as they
//     lie in memory, N-major, through the descriptor's transpose bit for
//     16-bit B.  No weight pass, no second buffer: a producer waits for its
//     own copies, fences them for the async proxy and hands the stage over;
//   * the epilogue reads the tile's f32 sums from shared memory, 8 channels
//     a thread: scale and shift as f32, the residual as bf16, one rounding,
//     16-byte stores.
// Its bound at batch 8: one product, 2·M·N·K operations at 989 TFLOP/s,
// about 0.031 ms of tensor-core work a ResNet18 forward, and half the f32
// route's bytes; the stem and the downsamples are bound by their bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 128;             // output pixels per block
constexpr int BK = 32;              // reduction depth per k-block
constexpr int THREADS = 512;        // four warpgroups:
constexpr int CONSUMERS = 256;      // two run the products, 64 rows each,
constexpr int PRODUCERS = 256;      // two stage and split the operands
constexpr int WARPS = 8;            // of each role
constexpr int STAGES = 3;           // f32 k-blocks in flight
constexpr int MAX_SPLITS = 8;       // the portable cluster size
constexpr int A_STRIDE = BK + 8;    // floats per staged patch row: the
                                    // fragment loads of 4 rows x 4 lanes
                                    // meet 32 banks
constexpr int OUT_OF_IMAGE = -(1 << 28);
constexpr int ROW_BYTES = BK * 2;   // one bf16 row of a k-block: 64 bytes

template <int BN>
struct Layout {
  static constexpr int B_STRIDE = BN;                // floats per weight row
  static constexpr int A_STAGE = BM * A_STRIDE * 4;  // bytes
  static constexpr int B_STAGE = BK * B_STRIDE * 4;
  static constexpr int STAGE = A_STAGE + B_STAGE;
  static constexpr int B_TILE = BN * ROW_BYTES;      // one of hi, lo
  static constexpr int BUF = 2 * B_TILE;
  static constexpr int PART_STRIDE = BN + 4;         // floats, split partials
  // bf16 buffers first (1024-aligned for the swizzle), then the f32 ring,
  // which the split partials reuse, the rows' gather offsets and the
  // mbarriers.
  static constexpr int RING = 2 * BUF;
  static constexpr int TABLE = RING + STAGES * STAGE;
  static constexpr int BARS = TABLE + 3 * BM * 4;
  static constexpr int SMEM = BARS + 8 * (2 * STAGES + 4) + 1024;
  static_assert(BM * PART_STRIDE * 4 <= STAGES * STAGE, "partials");
  static_assert(SMEM <= 232448, "shared memory");
};

struct ConvArgs {
  const float* x;
  const float* w;
  const float* scale;
  const float* shift;
  const float* residual;            // nullptr when there is no ADD
  float* y;
  int B, H, W, Cin, kh, kw, Cout, OH, OW, stride, pad, relu;
  int ci_step, c_step;              // BK = c_step * Cin + ci_step
  int vec_w;                        // 16-byte copies along Cout
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 or 4 bytes; `bytes` = 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(bytes) : "memory");
}

// mbarriers: the producers' copies and splits and the consumers' reads hand
// the ring's stages and the weight buffers over without a block barrier.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}
// One arrival per warp, once the whole warp is done.
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0)
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
                 : "memory");
}
// Arrives on `bar` once this thread's cp.async copies so far have landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   bar) : "memory");
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

// Offset of byte b of row `row` in a K-major tile of 64-byte rows with the
// 64-byte swizzle (16-byte chunk j of the row lands at j ^ ((row / 2) % 4)),
// the layout a TMA box with CU_TENSOR_MAP_SWIZZLE_64B writes.
__device__ __forceinline__ int swizzled(int row, int b) {
  return row * ROW_BYTES + ((((b >> 4) ^ (row >> 1)) & 3) << 4) + (b & 15);
}

// wgmma descriptor of a K-major tile of 64-byte rows, 64-byte swizzle:
// 8-row groups 512 bytes apart, the leading offset unused.
__device__ __forceinline__ uint64_t k_major(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) | (2ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// d[0..32) += A·B, A from registers (a[0..4): the m64k16 fragment as
// bf16 pairs), B in shared memory (K-major, descriptor).
__device__ __forceinline__ void wgmma_n64(float* d, const uint32_t* a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, "
      "1, 1, 0;"
      "\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// Keeps the compiler from moving reads or writes of wgmma's registers
// across the asynchronous product.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// A k-block's A fragments: per 16-deep step, hi then lo.
using Frags = uint32_t[BK / 16][2][4];

__device__ __forceinline__ void pin(Frags& f) {
#pragma unroll
  for (int s = 0; s < BK / 16; ++s)
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        asm volatile("" : "+r"(f[s][p][i])::"memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
// The f32 at shared address `addr` of cluster block `rank`.
__device__ __forceinline__ float ld_cluster(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(remote));
  return v;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two f32 as hi and lo bf16 pairs.
__device__ __forceinline__ void split2(float2 v, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  const float2 f = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(v.x - f.x, v.y - f.y));
}

// Four f32 as hi and lo bf16, four of each packed in 8 bytes.
__device__ __forceinline__ void split4(float4 v, uint2& hi, uint2& lo) {
  const __nv_bfloat162 h01 = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 h23 = __floats2bfloat162_rn(v.z, v.w);
  const float2 f01 = __bfloat1622float2(h01), f23 = __bfloat1622float2(h23);
  const __nv_bfloat162 l01 = __floats2bfloat162_rn(v.x - f01.x, v.y - f01.y);
  const __nv_bfloat162 l23 = __floats2bfloat162_rn(v.z - f23.x, v.w - f23.y);
  hi = make_uint2(bits(h01), bits(h23));
  lo = make_uint2(bits(l01), bits(l23));
}

// 0 <= i < n, for the window's row or column i in an image of extent n.
__device__ __forceinline__ bool inside(int i, int n) {
  return static_cast<unsigned>(i) < static_cast<unsigned>(n);
}

__device__ __forceinline__ float epilogue(const ConvArgs& a, float acc, int m,
                                          int n) {
  float v = acc * __ldg(a.scale + n) + __ldg(a.shift + n);
  if (a.residual != nullptr) v += __ldg(a.residual + m * a.Cout + n);
  if (a.relu && v < 0.f) v = 0.f;   // keeps NaN, as torch.relu does
  return v;
}

// The patch rows one thread copies, and where its column of the next
// k-block to load lies in the window.  A copy moves 4 channels (VEC, Cin %
// 4 == 0) or one: the stem's Cin = 3.  Rows past M read zeros.
template <bool VEC>
struct Gather {
  static constexpr int COLS = VEC ? BK / 4 : BK;     // copies per patch row
  static constexpr int ROWS = BM * COLS / PRODUCERS;   // rows per thread
  static constexpr int STEP = PRODUCERS / COLS;        // between its rows
  int off[ROWS], ih0[ROWS], iw0[ROWS];   // image offset of the window corner
  int col, k, ci, c, r;                  // k = (r, c, ci) of its column

  // Producer thread `tid` reads its rows from `table`, which row_table
  // wrote.
  __device__ __forceinline__ Gather(const ConvArgs& a, int tid, int kb,
                                    const int* table) {
    col = tid % COLS;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int row = tid / COLS + STEP * i;
      off[i] = table[row];
      ih0[i] = table[BM + row];
      iw0[i] = table[2 * BM + row];
    }
    k = kb * BK + (VEC ? 4 : 1) * col;
    ci = k % a.Cin;
    c = k / a.Cin % a.kw;
    r = k / a.Cin / a.kw;
  }

  // Starts the copies of this k-block's patches into ring stage `sa`, then
  // steps to the next k-block.
  __device__ __forceinline__ void load(const ConvArgs& a, int K, uint32_t sa,
                                       int tid) {
    const bool k_ok = k < K;
    const int k_off = (r * a.W + c) * a.Cin + ci;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const bool ok = k_ok && inside(ih0[i] + r, a.H) &&
                      inside(iw0[i] + c, a.W);
      const float* src = ok ? a.x + off[i] + k_off : a.x;
      const uint32_t dst = sa + ((tid / COLS + STEP * i) * A_STRIDE +
                                 (VEC ? 4 : 1) * col) * 4;
      if constexpr (VEC) {
        cp_async16(dst, src, ok ? 16 : 0);
      } else {
        cp_async4(dst, src, ok ? 4 : 0);
      }
    }
    k += BK;
    ci += a.ci_step;
    c += a.c_step;
    if (ci >= a.Cin) {
      ci -= a.Cin;
      ++c;
    }
    if (c >= a.kw) {
      r += c / a.kw;
      c %= a.kw;
    }
  }
};

// Decodes row `row` of the tile into `table` (3 * BM ints): its image
// offset at the window's corner and the corner's row and column (either
// route's arguments).
template <class Args>
__device__ __forceinline__ void row_table(const Args& a, int m0, int M,
                                          int row, int* table) {
  const int m = m0 + row;
  int o = 0, h = OUT_OF_IMAGE, w = OUT_OF_IMAGE;
  if (m < M) {
    const int t = m / a.OW;
    h = (t % a.OH) * a.stride - a.pad;
    w = (m % a.OW) * a.stride - a.pad;
    o = (((t / a.OH) * a.H + h) * a.W + w) * a.Cin;
  }
  table[row] = o;
  table[BM + row] = h;
  table[2 * BM + row] = w;
}

// Starts the copies of k-block kb's weight rows into ring stage `sb`.
template <int BN>
__device__ __forceinline__ void load_weights(const ConvArgs& a, int K, int kb,
                                             int n0, uint32_t sb, int tid) {
  using L = Layout<BN>;
  if (a.vec_w) {   // chunks of 4 channels
    constexpr int CPR = BN / 4;
#pragma unroll
    for (int i = 0; i < BK * CPR / PRODUCERS; ++i) {
      const int idx = tid + PRODUCERS * i;
      const int kr = idx / CPR, n = n0 + 4 * (idx % CPR);
      const int k = kb * BK + kr;
      const bool ok = k < K && n < a.Cout;
      cp_async16(sb + (kr * L::B_STRIDE + 4 * (idx % CPR)) * 4,
                 ok ? a.w + k * a.Cout + n : a.w, ok ? 16 : 0);
    }
  } else {   // one value a copy, addresses made as needed: the unrolled
             // loop would hold one pointer per copy
#pragma unroll 1
    for (int i = 0; i < BK * BN / PRODUCERS; ++i) {
      const int idx = tid + PRODUCERS * i;
      const int kr = idx / BN, n = n0 + idx % BN;
      const int k = kb * BK + kr;
      const bool ok = k < K && n < a.Cout;
      cp_async4(sb + (kr * L::B_STRIDE + idx % BN) * 4,
                ok ? a.w + k * a.Cout + n : a.w, ok ? 4 : 0);
    }
  }
}

// Splits the weights of ring stage `fb` into the hi and lo bf16 tiles of
// buffer `buf`, transposed to [BN][BK]: K-major.
template <int BN>
__device__ __forceinline__ void split_weights(const float* fb, uint8_t* buf,
                                              int tid) {
  using L = Layout<BN>;
  uint8_t* b_hi = buf;
  uint8_t* b_lo = buf + L::B_TILE;
#pragma unroll
  for (int i = 0; i < BN * BK / 4 / PRODUCERS; ++i) {
    const int idx = tid + PRODUCERS * i;
    const int n = idx % BN, q = idx / BN;   // 4 k rows of column n
    const float* col = fb + 4 * q * L::B_STRIDE + n;
    const float4 v = make_float4(col[0], col[L::B_STRIDE],
                                 col[2 * L::B_STRIDE], col[3 * L::B_STRIDE]);
    uint2 hi, lo;
    split4(v, hi, lo);
    const int o = swizzled(n, 8 * q);
    *reinterpret_cast<uint2*>(b_hi + o) = hi;
    *reinterpret_cast<uint2*>(b_lo + o) = lo;
  }
}

// This thread's A fragments of the patches of ring stage `fa`, split into
// hi and lo: register 2j + h of a 16-deep step s holds row r0 + 8h at
// k = 16s + 8j + k0 and k0 + 1.
__device__ __forceinline__ void patch_frags(const float* fa, int r0, int k0,
                                            Frags& f) {
#pragma unroll
  for (int s = 0; s < BK / 16; ++s)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        split2(*reinterpret_cast<const float2*>(
                   fa + (r0 + 8 * h) * A_STRIDE + 16 * s + 8 * j + k0),
               f[s][0][2 * j + h], f[s][1][2 * j + h]);
}

// acc += the three products of one k-block for this warpgroup's 64 rows:
// their fragments f against the weight tiles in buffer `buf`.
template <int BN>
__device__ __forceinline__ void mma_kblock(float* acc, const Frags& f,
                                           uint32_t buf) {
  using L = Layout<BN>;
  const uint32_t b_hi = buf, b_lo = buf + L::B_TILE;
  // 64 columns a product: registers 32c.. hold columns 64c.. in the
  // accumulator layout of one m64nBNk16 product.
#pragma unroll
  for (int s = 0; s < BK / 16; ++s)
#pragma unroll
    for (int c = 0; c < BN / 64; ++c) {
      const int off = 32 * s + 64 * ROW_BYTES * c;   // k step, column half
      const uint64_t bh = k_major(b_hi + off), bl = k_major(b_lo + off);
      wgmma_n64(acc + 32 * c, f[s][0], bh);
      wgmma_n64(acc + 32 * c, f[s][0], bl);
      wgmma_n64(acc + 32 * c, f[s][1], bh);
    }
}

template <int BN, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
fused_conv_sm90_kernel(const ConvArgs a) {
  using L = Layout<BN>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  float* ring = reinterpret_cast<float*>(smem + L::RING);
  int* table = reinterpret_cast<int*>(smem + L::TABLE);
  // Per ring stage s (+ 8s): full (the producers' copies landed), empty
  // (consumers and producers done reading); per weight buffer b (+ 8b):
  // full (split written), empty (its products done).
  const uint32_t full = smem_addr(smem + L::BARS);
  const uint32_t empty = full + 8 * STAGES;
  const uint32_t b_full = empty + 8 * STAGES, b_empty = b_full + 16;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int M = a.B * a.OH * a.OW;
  const int K = a.kh * a.kw * a.Cin;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int splits = gridDim.z;
  const int part = splits > 1 ? static_cast<int>(cluster_rank()) : 0;
  const int nk_all = (K + BK - 1) / BK;
  const int kb0 = part * nk_all / splits;
  const int nk = (part + 1) * nk_all / splits - kb0;

  if (tid < BM) row_table(a, m0, M, tid, table);
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, PRODUCERS);
      mbar_init(empty + 8 * s, 2 * WARPS);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(b_full + 8 * b, WARPS);
      mbar_init(b_empty + 8 * b, WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const uint32_t ring_addr = smem_addr(ring);
  auto stage = [&](int t) { return ring_addr + (t % STAGES) * L::STAGE; };
  const int wg = tid / 128;
  float acc[BN / 2];
  if (wg >= 2) {
    // Producers: the copies of k-block t + STAGES - 1, then the split of
    // k-block t's weights.
    const int ptid = tid - CONSUMERS;
    Gather<VEC> patches(a, ptid, kb0, table);
    auto load = [&](int t) {
      patches.load(a, K, stage(t), ptid);
      load_weights<BN>(a, K, kb0 + t, n0, stage(t) + L::A_STAGE, ptid);
      cp_async_arrive(full + 8 * (t % STAGES));
    };
    for (int t = 0; t < STAGES - 1 && t < nk; ++t) load(t);
    for (int t = 0; t < nk; ++t) {
      const int ahead = t + STAGES - 1;
      if (ahead < nk) {   // into the stage k-block t - 1 leaves
        if (ahead >= STAGES)
          mbar_wait(empty + 8 * (ahead % STAGES),
                    ((ahead / STAGES) & 1) ^ 1);
        load(ahead);
      }
      mbar_wait(full + 8 * (t % STAGES), (t / STAGES) & 1);
      if (t >= 2) mbar_wait(b_empty + 8 * (t % 2), ((t / 2) & 1) ^ 1);
      const float* fb = ring + (t % STAGES) * (L::STAGE / 4) + L::A_STAGE / 4;
      split_weights<BN>(fb, smem + (t % 2) * L::BUF, ptid);
      // The tiles were written by the threads; wgmma reads them through
      // the async proxy.
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      release(b_full + 8 * (t % 2), lane);
      release(empty + 8 * (t % STAGES), lane);
    }
  } else {
    // Consumers: warpgroup wg's rows [64 wg, 64 wg + 64) of the tile.
    const int r0 = 64 * wg + 16 * ((tid / 32) % 4) + lane / 4;
    const int c0 = 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    // Two sets of A fragments: k-block t's are written while t - 1's
    // products may still read the other set.
    Frags even, odd;
    auto step = [&](int t, Frags& f, Frags& other) {
      mbar_wait(full + 8 * (t % STAGES), (t / STAGES) & 1);
      patch_frags(ring + (t % STAGES) * (L::STAGE / 4), r0, c0, f);
      release(empty + 8 * (t % STAGES), lane);
      mbar_wait(b_full + 8 * (t % 2), (t / 2) & 1);
      pin(acc);
      wgmma_fence();
      mma_kblock<BN>(acc, f, smem_addr(smem) + (t % 2) * L::BUF);
      wgmma_commit();
      wgmma_wait<1>();   // k-block t - 1's products are done
      pin(acc);
      pin(other);        // ... and with its fragments and weight buffer
      if (t > 0) release(b_empty + 8 * ((t - 1) % 2), lane);
    };
    for (int t = 0; t < nk; ++t) {
      if (t % 2 == 0) {
        step(t, even, odd);
      } else {
        step(t, odd, even);
      }
    }
    wgmma_wait<0>();
    pin(acc);
    pin(even);
    pin(odd);
  }
  __syncthreads();   // every copy has landed and been read

  // Consumer thread (warp w of warpgroup wg, lane) holds rows r0 and r0 + 8
  // of the tile, and in every 8 columns the two at c0: register 4j + 2h + e
  // is row r0 + 8h, column c0 + 8j + e.
  const int r0 = 64 * (wg % 2) + 16 * ((tid / 32) % 4) + lane / 4;
  const int n1 = n0 + 2 * (lane % 4);
  if (splits == 1) {   // every load first, then every store
    if (wg >= 2) return;
    float v[BN / 2];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n1 + 8 * j + e;
        const bool n_ok = n < a.Cout;
        const float sc = n_ok ? __ldg(a.scale + n) : 0.f;
        const float sh = n_ok ? __ldg(a.shift + n) : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + r0 + 8 * h;
          float& o = v[4 * j + 2 * h + e];
          o = acc[4 * j + 2 * h + e] * sc + sh;
          if (a.residual != nullptr && n_ok && m < M)
            o += __ldg(a.residual + m * a.Cout + n);
        }
      }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = m0 + r0 + 8 * h, n = n1 + 8 * j + e;
          const float o = v[4 * j + 2 * h + e];
          if (m < M && n < a.Cout)   // relu keeps NaN, as torch.relu does
            a.y[m * a.Cout + n] = a.relu && o < 0.f ? 0.f : o;
        }
    return;
  }

  // Split K: every block's partial tile into its ring, then block `part`
  // sums rows [part*rows, (part+1)*rows) over the cluster in rank order.
  if (wg < 2) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          ring[(r0 + 8 * h) * L::PART_STRIDE + n1 - n0 + 8 * j + e] =
              acc[4 * j + 2 * h + e];
  }
  cluster_sync();
  const int rows = (BM + splits - 1) / splits;
  const int row_lo = part * rows;
  const int row_hi = min(BM, row_lo + rows);
  for (int idx = tid; idx < (row_hi - row_lo) * BN; idx += THREADS) {
    const int row = row_lo + idx / BN, col = idx % BN;
    const int m = m0 + row, n = n0 + col;
    if (m >= M || n >= a.Cout) continue;
    const uint32_t at = ring_addr + (row * L::PART_STRIDE + col) * 4;
    float p[MAX_SPLITS];   // all loads in flight, then the sum in order
#pragma unroll
    for (int q = 0; q < MAX_SPLITS; ++q)
      if (q < splits) p[q] = ld_cluster(at, q);
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < MAX_SPLITS; ++q)
      if (q < splits) sum += p[q];
    a.y[m * a.Cout + n] = epilogue(a, sum, m, n);
  }
  cluster_sync();   // no block leaves while another reads its partials
}

// --- the bf16 route ---------------------------------------------------------

constexpr int BK16 = 64;                // reduction depth per bf16 k-block
constexpr int ROW16 = BK16 * 2;         // bytes per staged row: one 128-byte
                                        // swizzle atom
constexpr int CHUNK16 = BK16 * ROW16;   // a k-block of 64 weight channels
constexpr int STAGES16 = 4;             // bf16 k-blocks in flight

template <int BN>
struct Layout16 {
  static constexpr int A_STAGE = BM * ROW16;            // patch rows, K-major
  static constexpr int B_STAGE = BN / 64 * CHUNK16;     // weight rows, N-major
  static constexpr int STAGE = A_STAGE + B_STAGE;
  static constexpr int PART_STRIDE = BN + 8;            // floats, the sums
  // The ring first (1024-aligned for the swizzle; the tile's f32 sums reuse
  // it), then the rows' gather offsets and the mbarriers.
  static constexpr int TABLE = STAGES16 * STAGE;
  static constexpr int BARS = TABLE + 3 * BM * 4;
  static constexpr int SMEM = BARS + 8 * 2 * STAGES16 + 1024;
  static_assert(BM * PART_STRIDE * 4 <= STAGES16 * STAGE, "partials");
  static_assert(SMEM <= 232448, "shared memory");
};

struct ConvArgs16 {
  const __nv_bfloat16* x;
  const __nv_bfloat16* w;
  const float* scale;
  const float* shift;
  const __nv_bfloat16* residual;    // nullptr when there is no ADD
  __nv_bfloat16* y;
  int B, H, W, Cin, kh, kw, Cout, OH, OW, stride, pad, relu;
  int ci_step, c_step;              // BK16 = c_step * Cin + ci_step
  int vec_w;                        // 16-byte weight copies
  int vec_y;                        // 16-byte output and residual accesses
};

// Offset of 16-byte chunk j of row `row` in a tile of 128-byte rows with the
// 128-byte swizzle (chunk j lands at j ^ (row % 8)), as a TMA box with
// CU_TENSOR_MAP_SWIZZLE_128B would lay it.
__device__ __forceinline__ uint32_t sw128(int row, int j) {
  return row * ROW16 + (((j ^ row) & 7) << 4);
}

__device__ __forceinline__ void st_shared_u16(uint32_t addr, uint16_t v) {
  asm volatile("st.shared.u16 [%0], %1;" ::"r"(addr), "h"(v) : "memory");
}

__device__ __forceinline__ uint16_t ldg_u16(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned short*>(p));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// wgmma descriptor of a tile of 128-byte rows, 128-byte swizzle, 8-row
// groups 1024 bytes apart: K-major (the patches; the leading offset
// unused) or N-major (64 weight channels, K down the rows: N within one
// swizzle atom, so the leading offset is never taken and carries the group
// stride).
__device__ __forceinline__ uint64_t desc128(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d[0..32) += A·B, A in shared memory K-major, B in shared memory N-major
// (its descriptor's transpose bit set).
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t a,
                                             uint64_t b) {
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
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ float4 ld_shared4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr));
  return v;
}
// The four f32 at shared address `addr` of cluster block `rank`.
__device__ __forceinline__ float4 ld_cluster4(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  float4 v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(remote));
  return v;
}

// The patch rows one producer thread stages, and where its column of the
// next k-block lies in the window: a copy is cp.async of 8 channels
// (Cin % 8 == 0), zero-filled for padding, rows past M and the ragged K
// edge.
struct Gather16 {
  static constexpr int COLS = BK16 / 8;                 // copies per row
  static constexpr int ROWS = BM * COLS / PRODUCERS;    // rows per thread
  static constexpr int STEP = PRODUCERS / COLS;         // between its rows
  int off[ROWS], ih0[ROWS], iw0[ROWS];   // image offset of the window corner
  int col, k, ci, c, r;                  // k = (r, c, ci) of its column

  // Producer thread `tid` reads its rows from `table`, which row_table
  // wrote.
  __device__ __forceinline__ Gather16(const ConvArgs16& a, int tid, int kb,
                                      const int* table) {
    col = tid % COLS;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int row = tid / COLS + STEP * i;
      off[i] = table[row];
      ih0[i] = table[BM + row];
      iw0[i] = table[2 * BM + row];
    }
    k = kb * BK16 + 8 * col;
    ci = k % a.Cin;
    c = k / a.Cin % a.kw;
    r = k / a.Cin / a.kw;
  }

  // Starts the copies of this k-block's patches into the ring stage at
  // `sa`, then steps to the next k-block.
  __device__ __forceinline__ void load(const ConvArgs16& a, int K,
                                       uint32_t sa, int tid) {
    const bool k_ok = k < K;
    const int k_off = (r * a.W + c) * a.Cin + ci;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const bool ok = k_ok && inside(ih0[i] + r, a.H) &&
                      inside(iw0[i] + c, a.W);
      cp_async16(sa + sw128(tid / COLS + STEP * i, col),
                 ok ? a.x + off[i] + k_off : a.x, ok ? 16 : 0);
    }
    k += BK16;
    ci += a.ci_step;
    c += a.c_step;
    if (ci >= a.Cin) {
      ci -= a.Cin;
      ++c;
    }
    if (c >= a.kw) {
      r += c / a.kw;
      c %= a.kw;
    }
  }
};

// Stages k-block kb's weight rows in the ring stage at `sb`: row kr of
// 64-channel chunk q lands at sb + q * CHUNK16 + kr * 128, swizzled.
template <int BN>
__device__ __forceinline__ void load_weights16(const ConvArgs16& a, int K,
                                               int kb, int n0, uint32_t sb,
                                               int tid) {
  if (a.vec_w) {   // 8 channels a copy
    constexpr int CPR = BN / 8;
#pragma unroll
    for (int i = 0; i < BK16 * CPR / PRODUCERS; ++i) {
      const int idx = tid + PRODUCERS * i;
      const int kr = idx / CPR, q = idx % CPR;
      const int k = kb * BK16 + kr, n = n0 + 8 * q;
      const bool ok = k < K && n < a.Cout;
      cp_async16(sb + q / 8 * CHUNK16 + sw128(kr, q % 8),
                 ok ? a.w + k * a.Cout + n : a.w, ok ? 16 : 0);
    }
  } else {         // one element a load, through a register
#pragma unroll 4
    for (int i = 0; i < BK16 * BN / PRODUCERS; ++i) {
      const int idx = tid + PRODUCERS * i;
      const int kr = idx / BN, nn = idx % BN;
      const int k = kb * BK16 + kr, n = n0 + nn;
      const bool ok = k < K && n < a.Cout;
      st_shared_u16(sb + nn / 64 * CHUNK16 + sw128(kr, nn % 64 / 8) +
                        2 * (nn % 8),
                    ok ? ldg_u16(a.w + k * a.Cout + n) : 0);
    }
  }
}

// The epilogue of 8 channels from n of output pixel m: s holds their sums
// over K.  Scale and shift in f32, the residual read as bf16, one rounding
// to bf16.
__device__ __forceinline__ void store16(const ConvArgs16& a, const float* s,
                                        int m, int n) {
  float v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    v[e] = n + e < a.Cout ? s[e] * __ldg(a.scale + n + e) +
                                __ldg(a.shift + n + e)
                          : 0.f;
  const size_t at = static_cast<size_t>(m) * a.Cout + n;
  if (a.residual != nullptr) {
    if (a.vec_y) {
      const uint4 rv = __ldg(reinterpret_cast<const uint4*>(a.residual + at));
      const uint32_t words[4] = {rv.x, rv.y, rv.z, rv.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&words[q]));
        v[2 * q] += f.x;
        v[2 * q + 1] += f.y;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (n + e < a.Cout) v[e] += __bfloat162float(a.residual[at + e]);
    }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e)   // keeps NaN, as torch.relu does
    v[e] = a.relu && v[e] < 0.f ? 0.f : v[e];
  if (a.vec_y) {
    uint4 out;
    out.x = bits(__floats2bfloat162_rn(v[0], v[1]));
    out.y = bits(__floats2bfloat162_rn(v[2], v[3]));
    out.z = bits(__floats2bfloat162_rn(v[4], v[5]));
    out.w = bits(__floats2bfloat162_rn(v[6], v[7]));
    *reinterpret_cast<uint4*>(a.y + at) = out;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (n + e < a.Cout) a.y[at + e] = __float2bfloat16_rn(v[e]);
  }
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
fused_conv_bf16_sm90_kernel(const ConvArgs16 a) {
  using L = Layout16<BN>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  int* table = reinterpret_cast<int*>(smem + L::TABLE);
  // Per ring stage s (+ 8s): full (the producers' copies landed and were
  // fenced), empty (its products done).
  const uint32_t ring = smem_addr(smem);
  const uint32_t full = smem_addr(smem + L::BARS);
  const uint32_t empty = full + 8 * STAGES16;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int M = a.B * a.OH * a.OW;
  const int K = a.kh * a.kw * a.Cin;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int splits = gridDim.z;
  const int part = splits > 1 ? static_cast<int>(cluster_rank()) : 0;
  const int nk_all = (K + BK16 - 1) / BK16;
  const int kb0 = part * nk_all / splits;
  const int nk = (part + 1) * nk_all / splits - kb0;

  if (tid < BM) row_table(a, m0, M, tid, table);
  if (tid == 0) {
    for (int s = 0; s < STAGES16; ++s) {
      mbar_init(full + 8 * s, WARPS);
      mbar_init(empty + 8 * s, WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  auto stage = [&](int t) { return ring + (t % STAGES16) * L::STAGE; };
  const int wg = tid / 128;
  float acc[BN / 2];
  if (wg >= 2) {
    // Producers: at k-block t, hand over k-block t once its copies have
    // landed, then stage k-block t + STAGES16 - 1 into the stage k-block
    // t - 1 leaves.  One cp.async group per k-block (empty past nk).
    const int ptid = tid - CONSUMERS;
    Gather16 patches(a, ptid, kb0, table);
    auto load = [&](int t) {
      patches.load(a, K, stage(t), ptid);
      load_weights16<BN>(a, K, kb0 + t, n0, stage(t) + L::A_STAGE, ptid);
    };
    for (int t = 0; t < STAGES16 - 1; ++t) {
      if (t < nk) load(t);
      cp_async_commit();
    }
    for (int t = 0; t < nk; ++t) {
      cp_async_wait<STAGES16 - 2>();   // k-block t's copies have landed
      // The stage was written through the generic proxy (cp.async, and the
      // stores of an unaligned weight tile); wgmma reads it through the
      // async proxy.
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      release(full + 8 * (t % STAGES16), lane);
      const int ahead = t + STAGES16 - 1;
      if (ahead < nk) {
        if (ahead >= STAGES16)
          mbar_wait(empty + 8 * (ahead % STAGES16),
                    ((ahead / STAGES16) & 1) ^ 1);
        load(ahead);
      }
      cp_async_commit();
    }
  } else {
    // Consumers: warpgroup wg's rows [64 wg, 64 wg + 64) of the tile, one
    // product per 16-deep k-step and 64 channels.
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int t = 0; t < nk; ++t) {
      mbar_wait(full + 8 * (t % STAGES16), (t / STAGES16) & 1);
      const uint32_t sa = stage(t) + 64 * wg * ROW16;
      const uint32_t sb = stage(t) + L::A_STAGE;
      pin(acc);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < BK16 / 16; ++s)
#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
          wgmma_ss_n64(acc + 32 * c, desc128(sa + 32 * s, 16),
                       desc128(sb + c * CHUNK16 + 16 * ROW16 * s, 1024));
      wgmma_commit();
      wgmma_wait<1>();   // k-block t - 1's products are done
      pin(acc);
      if (t > 0) release(empty + 8 * ((t - 1) % STAGES16), lane);
    }
    wgmma_wait<0>();
    pin(acc);
    // The ring, read by wgmma, is written next by the threads.
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();   // every copy has landed and every product is done

  // The tile's sums into the ring: consumer thread (warp w of warpgroup wg,
  // lane) holds rows r0 and r0 + 8, and in every 8 columns the two at c0:
  // register 4j + 2h + e is row r0 + 8h, column c0 + 8j + e.
  if (wg < 2) {
    float* sums = reinterpret_cast<float*>(smem);
    const int r0 = 64 * wg + 16 * ((tid / 32) % 4) + lane / 4;
    const int c0 = 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(sums + (r0 + 8 * h) * L::PART_STRIDE +
                                   8 * j + c0) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
  if (splits == 1) {
    __syncthreads();
  } else {
    cluster_sync();
  }
  // Block `part` sums rows [part*rows, (part+1)*rows) over the cluster in
  // rank order (its own tile alone without a split) and runs the epilogue,
  // 8 channels a thread.
  const int rows = (BM + splits - 1) / splits;
  const int row_lo = part * rows;
  const int row_hi = min(BM, row_lo + rows);
  constexpr int GROUPS = BN / 8;
  for (int idx = tid; idx < (row_hi - row_lo) * GROUPS; idx += THREADS) {
    const int row = row_lo + idx / GROUPS, g = idx % GROUPS;
    const int m = m0 + row, n = n0 + 8 * g;
    if (m >= M || n >= a.Cout) continue;
    const uint32_t at = ring + (row * L::PART_STRIDE + 8 * g) * 4;
    float s[8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float4 p[MAX_SPLITS];   // all loads in flight, then the sum in order
      if (splits == 1) {
        p[0] = ld_shared4(at + 16 * h);
      } else {
#pragma unroll
        for (int q = 0; q < MAX_SPLITS; ++q)
          if (q < splits) p[q] = ld_cluster4(at + 16 * h, q);
      }
      float4 sum = p[0];
#pragma unroll
      for (int q = 1; q < MAX_SPLITS; ++q)
        if (q < splits) {
          sum.x += p[q].x;
          sum.y += p[q].y;
          sum.z += p[q].z;
          sum.w += p[q].w;
        }
      s[4 * h] = sum.x;
      s[4 * h + 1] = sum.y;
      s[4 * h + 2] = sum.z;
      s[4 * h + 3] = sum.w;
    }
    store16(a, s, m, n);
  }
  if (splits > 1) cluster_sync();   // no block leaves while another reads
}

// --- launches ------------------------------------------------------------

// Each route's kernel at tile width BN: its arguments, dynamic shared
// memory and k-block depth.
template <int BN, bool VEC>
struct F32 {
  using Args = ConvArgs;
  static constexpr int WIDTH = BN, SMEM = Layout<BN>::SMEM, K_BLOCK = BK;
  static auto kernel() { return fused_conv_sm90_kernel<BN, VEC>; }
};
template <int BN>
struct Bf16 {
  using Args = ConvArgs16;
  static constexpr int WIDTH = BN, SMEM = Layout16<BN>::SMEM;
  static constexpr int K_BLOCK = BK16;
  static auto kernel() { return fused_conv_bf16_sm90_kernel<BN>; }
};

// Lets the route's kernel take its dynamic shared memory on `device`, once
// per device (the attribute is the device's; setting it at every launch
// costs host time).
template <class Route>
cudaError_t allow_smem(int device) {
  constexpr int DEVICES = 64;
  static bool done[DEVICES] = {};
  if (device >= 0 && device < DEVICES && done[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      Route::kernel(), cudaFuncAttributeMaxDynamicSharedMemorySize,
      Route::SMEM);
  if (err == cudaSuccess && device >= 0 && device < DEVICES)
    done[device] = true;
  return err;
}

// A launch of `grid` in clusters of `splits` blocks along z, the route's
// dynamic shared memory each; `attr` holds the cluster's shape.
template <class Route>
cudaLaunchConfig_t cluster_launch(dim3 grid, int splits, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = Route::SMEM;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <class Route>
int launch(const typename Route::Args& a, int splits, int device,
           cudaStream_t stream) {
  const int M = a.B * a.OH * a.OW;
  const int K = a.kh * a.kw * a.Cin;
  if (splits < 1 || splits > MAX_SPLITS ||
      splits > (K + Route::K_BLOCK - 1) / Route::K_BLOCK)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem<Route>(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_launch<Route>(
      dim3((M + BM - 1) / BM, (a.Cout + Route::WIDTH - 1) / Route::WIDTH,
           splits),
      splits, stream, attr);
  err = cudaLaunchKernelEx(&cfg, Route::kernel(), a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many blocks of the route's kernel the current device holds at once
// when they come in clusters of `splits`: whole clusters must fit within
// one GPC of SMs (0 on error).
template <class Route>
int resident_blocks(int splits) {
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      allow_smem<Route>(device) != cudaSuccess)
    return 0;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_launch<Route>(dim3(1, 1, splits), splits, nullptr, attr);
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, Route::kernel(), &cfg) !=
      cudaSuccess)
    return 0;
  return clusters * splits;
}

// Runs `launch()` with `device` current, and puts the caller's device back.
template <class Launch>
int on_device(int device, Launch launch) {
  int current = device;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int result = launch();
  if (current != device) cudaSetDevice(current);
  return result;
}

}  // namespace

// Launches on `stream` of CUDA device `device` and returns
// cudaGetLastError() (0 on success).  bn is the tile's channel width (64 or
// 128), splits the cluster's split of K (1 to 8, at most one per 32-deep
// k-block).  The caller checks shapes and keeps every index below 2**31.
extern "C" int fused_conv_sm90_f32(const void* x, const void* w,
                                   const void* scale, const void* shift,
                                   const void* residual, void* y, int B, int H,
                                   int W, int Cin, int kh, int kw, int Cout,
                                   int OH, int OW, int stride, int pad,
                                   int relu, int bn, int splits, int device,
                                   void* stream) {
  ConvArgs a;
  a.x = static_cast<const float*>(x);
  a.w = static_cast<const float*>(w);
  a.scale = static_cast<const float*>(scale);
  a.shift = static_cast<const float*>(shift);
  a.residual = static_cast<const float*>(residual);
  a.y = static_cast<float*>(y);
  a.B = B; a.H = H; a.W = W; a.Cin = Cin; a.kh = kh; a.kw = kw;
  a.Cout = Cout; a.OH = OH; a.OW = OW; a.stride = stride; a.pad = pad;
  a.relu = relu;
  a.ci_step = BK % Cin;
  a.c_step = BK / Cin;
  a.vec_w = Cout % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const bool vec_x = Cin % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&] {
    if (bn == 64)
      return vec_x ? launch<F32<64, true>>(a, splits, device, s)
                   : launch<F32<64, false>>(a, splits, device, s);
    if (bn == 128)
      return vec_x ? launch<F32<128, true>>(a, splits, device, s)
                   : launch<F32<128, false>>(a, splits, device, s);
    return static_cast<int>(cudaErrorInvalidValue);
  });
}

// The bf16 route, with the arguments of fused_conv_sm90_f32: x, w, residual
// and y bf16, scale and shift f32; splits at most one per 64-deep k-block;
// Cin a multiple of 8 and x 16-byte aligned (cudaErrorInvalidValue
// otherwise: the wrapper pads the channels).
extern "C" int fused_conv_sm90_bf16(const void* x, const void* w,
                                    const void* scale, const void* shift,
                                    const void* residual, void* y, int B,
                                    int H, int W, int Cin, int kh, int kw,
                                    int Cout, int OH, int OW, int stride,
                                    int pad, int relu, int bn, int splits,
                                    int device, void* stream) {
  ConvArgs16 a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.scale = static_cast<const float*>(scale);
  a.shift = static_cast<const float*>(shift);
  a.residual = static_cast<const __nv_bfloat16*>(residual);
  a.y = static_cast<__nv_bfloat16*>(y);
  a.B = B; a.H = H; a.W = W; a.Cin = Cin; a.kh = kh; a.kw = kw;
  a.Cout = Cout; a.OH = OH; a.OW = OW; a.stride = stride; a.pad = pad;
  a.relu = relu;
  a.ci_step = BK16 % Cin;
  a.c_step = BK16 / Cin;
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  a.vec_w = Cout % 8 == 0 && aligned(w);
  a.vec_y = Cout % 8 == 0 && aligned(y) &&
            (residual == nullptr || aligned(residual));
  if (Cin % 8 != 0 || !aligned(x))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&] {
    if (bn == 64) return launch<Bf16<64>>(a, splits, device, s);
    if (bn == 128) return launch<Bf16<128>>(a, splits, device, s);
    return static_cast<int>(cudaErrorInvalidValue);
  });
}

// How many blocks of the route's kernel (bf16 != 0: the bf16 route) the
// current device holds at once when they come in clusters of `splits`.
extern "C" int fused_conv_sm90_resident_blocks(int splits, int bf16) {
  return bf16 ? resident_blocks<Bf16<128>>(splits)
              : resident_blocks<F32<128, true>>(splits);
}

// The route's dynamic shared memory at tile width bn (0 if not built).
extern "C" int fused_conv_sm90_smem_bytes(int bn, int bf16) {
  if (bf16) return bn == 64 ? Bf16<64>::SMEM : bn == 128 ? Bf16<128>::SMEM : 0;
  return bn == 64 ? Layout<64>::SMEM : bn == 128 ? Layout<128>::SMEM : 0;
}

extern "C" const char* fused_conv_sm90_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

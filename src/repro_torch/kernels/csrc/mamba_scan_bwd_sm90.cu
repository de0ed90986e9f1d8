// Backward of the Mamba2 / SSD scan for Hopper (sm_90a): f32 in and out,
// chunk parallel, every matrix product on the tensor cores as three bf16
// products.
//
// The vector-Jacobian product of the recurrence csrc/mamba_scan_sm90.cu
// computes (the forward of src/repro/kernels/mamba_scan.py:62, whose Pallas
// kernel has no backward: JAX differentiates its jnp scan).  Per (batch b,
// head h), over time t, with a_t = e^{a_log_t}:
//
//   S_t = a_t S_{t-1} + x_t (x) B_t,   y_t = S_t C_t       (S_0 = 0, P x N)
//
// with x = dtx (b, S, H, P), a_log (b, S, H), B and C (b, S, N) shared by
// every head.  Given dy, the state's adjoint runs backwards,
//
//   G_t = dy_t (x) C_t + a_{t+1} G_{t+1},
//
// and dx_t = G_t B_t, dB_t = sum_h G_t^T x_t, dC_t = sum_h S_t^T dy_t and
// d a_log_t = <G_t, a_t S_{t-1}>.  Chunkwise, for chunk c of Q steps with
// in-chunk cumulative log decay cum_t (cum_L at its last step), the state
// S0 entering it and the adjoint Gh of its last state from the later
// chunks:
//
//   dx_t  = sum_{s>=t} e^{cum_s - cum_t} (C_s.B_t) dy_s + e^{cum_L - cum_t} Gh B_t
//   dB_t  = sum_{s>=t} e^{cum_s - cum_t} (dy_s.x_t) C_s + e^{cum_L - cum_t} Gh^T x_t
//   dC_t  = sum_{s<=t} e^{cum_t - cum_s} (dy_t.x_s) B_s + e^{cum_t} S0^T dy_t
//   da_u  = sum_{t>=u} e^{cum_t} dy_t.(S0 C_t) + e^{cum_L} <Gh, S0>
//         + sum_{s<u} e^{cum_L - cum_s} x_s.(Gh B_s)
//         + sum_{s<u<=t} e^{cum_t - cum_s} (C_t.B_s)(dy_t.x_s)          (1)
//
// (1) is <G_u, a_u S_{u-1}> with both factors expanded: every term is a
// product the gradient is made of, none a difference.  The usual form, a
// reverse cumulative sum of cum's adjoint (row sums minus column sums of
// the pair terms), agrees with it where d a_log is of the order of the
// other gradients; where d a_log vanishes (a full reset, ~1e-12) its
// differences lose all of it, and the quadrant sums keep it (the CPU
// emulation in tests/test_torch_mamba_scan.py: to 1e-6 of itself with
// exact products, 6.3e-6 with this kernel's split ones).  Four launches:
//   1. chunk sums, per (b, chunk, group of heads): B and C split once, then
//      per head the chunk's own state dS_c = (gr o X)^T B and its own
//      adjoint L_c = (gl o dY)^T C, both P x N (gl = e^{cum_t}, gr =
//      e^{cum_L - cum_t}), and e^{cum_L};
//   2. passes, per four state elements: forwards over the chunks the state
//      entering each chunk (S0_{c+1} = e^{A_c} S0_c + dS_c), backwards the
//      adjoint leaving it (Gh_c = L_{c+1} + e^{A_{c+1}} Gh_{c+1}), in place;
//   3. chunk gradients, per (b, chunk, group of heads): B, C and C.B^T once,
//      then per head dY.X^T, the masked E1 = D o (C B^T), E2 = D o (dY X^T)
//      with D[r][k] = [r >= k] e^{cum_r - cum_k} and the pair terms W =
//      [r > k] E1 o (dY X^T) formed in registers; dx = gr o (B Gh^T) + E1^T
//      dY, dB_h = gr o (X Gh) + E2^T C and dC_h = gl o (dY S0) + E2 B, the
//      heads' dB_h and dC_h added in head order in registers; d a_log by
//      (1), its quadrant, prefix and suffix sums as warp scans;
//   4. group sums: dB and dC, each group's part added in group order.
// The exp is taken only where its exponent is <= 0 (masked before the
// exp), so a = -30 (a full reset) gives exact zeros, not NaN.  There are
// no atomics and every sum has one order: two launches give the same bits.
//
// Numerics: each product is a_lo.b_hi + a_hi.b_lo + a_hi.b_hi into f32
// (the split of csrc/ssd_bf16x3_sm90.cuh, shared with the forward), each
// operand split once into hi and lo bf16 planes in shared memory.  The
// CPU emulation puts every gradient within 0.042-0.096 of the 1e-4 max|g|
// limit this way, where one bf16 pass misses it 30-45-fold and one TF32
// pass 3.8-6.1-fold.  The row dots of (1) read x_t and C_t back as hi + lo.
//
// What bounds it on an H100 SXM, at zamba2's training shape (b 4, S 1024,
// H 80, P = N = 64): the inputs read and the gradients written once are
// 0.26 GB, 0.077 ms at 3.35 TB/s; the ten 64^3 products a (b, chunk, head)
// are ~72 GFLOP as three bf16 products, 0.07 ms at 989 TFLOP/s.  The chunk
// form adds traffic of its own: x and dy read twice (84 MB each more), the
// states and adjoints (84 MB each at chunk 64) written by launch 1, read
// and written by launch 2, read by launch 3: ~1.1 GB in all, ~0.34 ms.
// Bytes bind.  The chunk is 64: the E1 and E2 tiles of a chunk of 128 (four
// planes of 128 x 136 bf16, 139 KB) do not fit beside the other tiles.
//
// The design (every product on the tensor cores, in as few launches and
// barriers as the dependences allow):
//   * wgmma: each product is a 64 x 64 output, m64n32k16 per warpgroup (two
//     a block, 32 columns each), both operands read from shared memory as
//     split bf16 planes of 64 rows x 128 bytes in the 128-byte swizzle, K-
//     or MN-major as the product needs (E1^T, E2^T and the [k][n] operands
//     through the descriptors' transpose bits); a thread's accumulators are
//     mma.sync's m16n8 fragments, so the gates, masks, row dots and stores
//     work in registers;
//   * C.B^T is formed once a block and kept in shared memory in the
//     accumulators' layout; each head applies its decay element by element;
//   * a head's first products (dY X^T, then B Gh^T, X Gh and dY S0) are
//     issued together; E1, E2 and W are formed from the first, the
//     quadrant sums of W run on the CUDA cores, the second products take
//     the gates and the E products follow: three barriers a head, the
//     d a_log tail of warp 0 overlapping the next head's stores;
//   * the next head's x, dy, S0 and Gh load into registers (one block of 8
//     warps an SM, up to 255 registers a thread) while this head's
//     products run; the chunk sums take at most 5 heads a block
//     (mamba_scan.py's plan_bwd), the chunk gradients as many as fill the
//     card in whole waves;
//   * the state pass loads 8 chunks of states or adjoints and their decays
//     before its chain, 4 elements a thread.
// What holds it back (PERF.md): launch 3 runs at about twice its bytes'
// time, its shared memory shared by the products' operand reads, the
// plane stores and the elementwise passes.  Padding (a ragged last chunk,
// P or N below 64) is zero-filled, so it adds nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "ssd_bf16x3_sm90.cuh"

namespace {

constexpr int Q = 64;               // steps per chunk
constexpr int TILE = 64;            // P and N as the blocks hold them
constexpr int ROW = TILE * 2;       // bytes of a plane's row of 64 bf16
constexpr int PLANE = Q * ROW;      // bytes of one plane (hi or lo)
constexpr int LDW = Q + 8;          // f32 row stride of the pair terms W:
                                    // the float2 stores meet 32 banks
constexpr int STATE = TILE * TILE;  // floats of one state in the scratch
constexpr int THREADS = 256;        // two warpgroups, 32 columns each
constexpr int WARPS = THREADS / 32;
constexpr int F4 = Q * TILE / 4 / THREADS;   // float4s of a Q x 64 operand
constexpr int GMAX = 32;            // heads a block of launch 1 or 3 takes
constexpr int PASS_THREADS = 256;
constexpr int UNROLL = 8;           // chunks the state pass loads ahead
static_assert(Q == TILE, "the planes serve Q x Q and Q x 64 operands alike");

// The split planes: hi at an even index, its lo right after it.
enum Plane { B_P = 0, C_P = 2, X_P = 4, Y_P = 6, S_P = 8, G_P = 10,
             E1_P = 12, E2_P = 14 };

struct Args {
  const float* dy;
  const float* x;
  const float* a_log;
  const float* B;
  const float* C;
  float* dx;
  float* da;
  float* dB;
  float* dC;
  float* states;  // (b, nc, H, STATE): dS_c, then the state entering c
  float* adj;     // (b, nc, H, STATE): L_c, then the adjoint leaving c
  float* decay;   // (b, nc, H): e^{cum_L}
  float* dBg;     // (b, S, groups, TILE): each group's part of dB
  float* dCg;     // (b, S, groups, TILE): each group's part of dC
  int S, H, P, N, nc, group, groups;
  bool vec_x, vec_bc;  // 16-byte loads along P (x, dy, dx) and N (B, C)
};

__device__ __forceinline__ size_t cell(const Args& a, int bi, int c, int h) {
  return (static_cast<size_t>(bi) * a.nc + c) * a.H + h;
}

// Byte offset of entry (r, c) of a plane: rows of 128 bytes, the 16-byte
// chunk j of row r at chunk j ^ (r % 8) (the 128-byte swizzle wgmma reads).
__device__ __forceinline__ int swz(int r, int c) {
  return r * ROW + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2;
}

// F4 float4s a thread of the Q x 64 rows of an operand whose row s starts
// at base + s * stride: row i / 16, columns 4 (i % 16) for i = tid + k
// THREADS; zeros past L rows and `cols` columns.
__device__ __forceinline__ void load_rows(float4 (&v)[F4], const float* base,
                                          size_t stride, int L, int cols,
                                          bool vec) {
#pragma unroll
  for (int k = 0; k < F4; ++k) {
    const int i = threadIdx.x + k * THREADS, s = i / 16, c = 4 * (i % 16);
    v[k] = s < L ? load4(base + s * stride, c, cols, vec)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// A 64 x 64 state of the scratch, in load_rows' positions.
__device__ __forceinline__ void load_state(float4 (&v)[F4], const float* st) {
#pragma unroll
  for (int k = 0; k < F4; ++k)
    v[k] = reinterpret_cast<const float4*>(st)[threadIdx.x + k * THREADS];
}

// load_rows' float4s, each row s times scale(s), split into the plane pair
// at `hi` (lo PLANE bytes on).
template <typename Scale>
__device__ __forceinline__ void put_rows(uint8_t* hi, const float4 (&v)[F4],
                                         Scale scale) {
#pragma unroll
  for (int k = 0; k < F4; ++k) {
    const int i = threadIdx.x + k * THREADS, s = i / 16, c = 4 * (i % 16);
    const float w = scale(s);
    uint2 h, l;
    split4(make_float4(w * v[k].x, w * v[k].y, w * v[k].z, w * v[k].w), h, l);
    *reinterpret_cast<uint2*>(hi + swz(s, c)) = h;
    *reinterpret_cast<uint2*>(hi + PLANE + swz(s, c)) = l;
  }
}

__device__ __forceinline__ void put_rows(uint8_t* hi, const float4 (&v)[F4]) {
  put_rows(hi, v, [](int) { return 1.f; });
}

// Two neighbouring entries (r, c), (r, c + 1) of the plane pair at `hi`,
// read back as hi + lo.
__device__ __forceinline__ float2 unsplit2(const uint8_t* hi, int r, int c) {
  const float2 h = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(hi + swz(r, c)));
  const float2 l = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(hi + PLANE + swz(r, c)));
  return make_float2(h.x + l.x, h.y + l.y);
}

// Two neighbouring values split into the plane pair at `hi`, entry (r, c).
__device__ __forceinline__ void put2(uint8_t* hi, int r, int c, float x,
                                     float y) {
  uint32_t h, l;
  split2(x, y, h, l);
  *reinterpret_cast<uint32_t*>(hi + swz(r, c)) = h;
  *reinterpret_cast<uint32_t*>(hi + PLANE + swz(r, c)) = l;
}

// Generic-proxy stores to shared memory made visible to wgmma's reads
// (after the barrier that follows).
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// wgmma descriptor of a 128-byte-swizzled plane at shared address `addr`:
// K-major (the product's K along the rows' 64 entries; 8-row groups 1024
// bytes apart, the leading offset unused) or MN-major (K down the rows; M
// or N never exceeds the 64 entries of one swizzle atom, so both fields
// carry the group stride).
template <bool MN>
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  constexpr uint64_t lbo = MN ? 1024 : 16, sbo = 1024;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | ((lbo >> 4) << 16) |
         ((sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Waits until at most N committed groups of this warpgroup are in flight.
template <int N = 0>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous products.
__device__ __forceinline__ void pin(float (&d)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(d[j][i])::"memory");
}

// d (+)= A.B for the 64 x 16 A and 16 x 32 B at descriptors a and b, the
// warpgroup's m64n32 accumulator as mma.sync's four m16n8 tiles of each
// warp (rows 16 (warp % 4) + g and + 8, columns 8 j + 2 tig and + 1): TA
// (TB) when A's M (B's N) runs along the plane's rows.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n32(float (&d)[4][4], uint64_t a,
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
}

// d (+)= A.B over K = 64 for A (64 x 64) and B (64 x 64, this warpgroup's
// 32 columns from n0) split into the plane pairs at shared addresses a and
// b: each 16-wide k-step as lo.hi + hi.lo + hi.hi (the small terms first).
// A_MN: A kept as [k][m], else [m][k]; B_MN: B kept as [k][n], else [n][k].
// Issued, not waited for; `accumulate` 0 starts d at zero.
template <bool A_MN, bool B_MN>
__device__ __forceinline__ void mm3(float (&d)[4][4], uint32_t a, uint32_t b,
                                    int n0, int accumulate) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t ao = A_MN ? kk * 16 * ROW : kk * 32;
    const uint32_t bo = B_MN ? kk * 16 * ROW + n0 * 2 : n0 * ROW + kk * 32;
    const uint64_t ah = desc<A_MN>(a + ao), al = desc<A_MN>(a + PLANE + ao);
    const uint64_t bh = desc<B_MN>(b + bo), bl = desc<B_MN>(b + PLANE + bo);
    wgmma_n32<A_MN, B_MN>(d, al, bh, accumulate || kk > 0);
    wgmma_n32<A_MN, B_MN>(d, ah, bl, 1);
    wgmma_n32<A_MN, B_MN>(d, ah, bh, 1);
  }
}

// Rows r_lo and r_hi of d dotted with the same entries of the plane pair
// at `hi` over this warpgroup's 32 columns from n0: the four lanes of a
// row summed in one order, written to out[r] by the row's first lane.
__device__ __forceinline__ void row_dots(const float (&d)[4][4],
                                         const uint8_t* hi, float* out,
                                         int r_lo, int r_hi, int n0) {
  const int tig = threadIdx.x % 4;
  float dl = 0.f, dh = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + 8 * j + 2 * tig;
    const float2 vl = unsplit2(hi, r_lo, col), vh = unsplit2(hi, r_hi, col);
    dl = fmaf(vl.x, d[j][0], dl);
    dl = fmaf(vl.y, d[j][1], dl);
    dh = fmaf(vh.x, d[j][2], dh);
    dh = fmaf(vh.y, d[j][3], dh);
  }
  dl += __shfl_xor_sync(0xffffffffu, dl, 1);
  dh += __shfl_xor_sync(0xffffffffu, dh, 1);
  dl += __shfl_xor_sync(0xffffffffu, dl, 2);
  dh += __shfl_xor_sync(0xffffffffu, dh, 2);
  if (tig == 0) {
    out[r_lo] = dl;
    out[r_hi] = dh;
  }
}

__device__ __forceinline__ void scale_rows(float (&d)[4][4], float lo,
                                           float hi) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    d[j][0] *= lo;
    d[j][1] *= lo;
    d[j][2] *= hi;
    d[j][3] *= hi;
  }
}

// Inclusive scan of v over the warp's lanes, lowest lane first.
__device__ __forceinline__ float scan_up(float v) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += o;
  }
  return v;
}

// Inclusive scan of v over the warp's lanes, highest lane first.
__device__ __forceinline__ float scan_down(float v) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_down_sync(0xffffffffu, v, off);
    if (lane + off < 32) v += o;
  }
  return v;
}

// The 1024-byte-aligned start of dynamic shared memory (the swizzle's
// atoms are 1024 bytes).
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  const uint32_t at = smem_addr(raw);
  return raw + (((at + 1023) & ~1023u) - at);
}

// ---------------------------------------------------------------------------
// Launch 1: dS_c = (gr o X)^T B and L_c = (gl o dY)^T C per head of the
// block's group: warpgroup wg the 32 columns n from 32 wg of both.
struct ChunkSmem {
  static constexpr int CUM = 8 * PLANE;   // planes B, C, X, dY; then cum
  static constexpr int BYTES = CUM + GMAX * Q * 4 + 1024;
};

__global__ void __launch_bounds__(THREADS, 2)
mamba_bwd_chunk_kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t raw[];
  uint8_t* smem = aligned_smem(raw);
  float* cum = reinterpret_cast<float*>(smem + ChunkSmem::CUM);
  const uint32_t sp = smem_addr(smem);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int c = blockIdx.x, bi = blockIdx.z;
  const int h0 = blockIdx.y * a.group, G = min(a.group, a.H - h0);
  const int t0 = c * Q, L = min(Q, a.S - t0);
  const size_t row0 = static_cast<size_t>(bi) * a.S + t0;
  const size_t hp = static_cast<size_t>(a.H) * a.P;

  float4 xr[F4], yr[F4];
  load_rows(xr, a.x + (row0 * a.H + h0) * a.P, hp, L, a.P, a.vec_x);
  load_rows(yr, a.dy + (row0 * a.H + h0) * a.P, hp, L, a.P, a.vec_x);
  {
    float4 bv[F4], cv[F4];
    load_rows(bv, a.B + row0 * a.N, a.N, L, a.N, a.vec_bc);
    load_rows(cv, a.C + row0 * a.N, a.N, L, a.N, a.vec_bc);
    put_rows(smem + B_P * PLANE, bv);
    put_rows(smem + C_P * PLANE, cv);
  }
  chunk_cumsum<Q>(a.a_log, a.H, cum, row0, h0, G, L, THREADS);
  if (tid < G) a.decay[cell(a, bi, c, h0 + tid)] = expf(cum[tid * Q + Q - 1]);

  const int m0 = 16 * (warp % 4), n0 = 32 * (warp / 4);
  for (int j = 0; j < G; ++j) {
    const float* cj = cum + j * Q;
    const float cl = cj[Q - 1];
    __syncthreads();   // the previous head's products are done
    put_rows(smem + X_P * PLANE, xr, [&](int s) { return expf(cl - cj[s]); });
    put_rows(smem + Y_P * PLANE, yr, [&](int s) { return expf(cj[s]); });
    fence_async();
    __syncthreads();
    if (j + 1 < G) {
      const size_t off = (row0 * a.H + h0 + j + 1) * a.P;
      load_rows(xr, a.x + off, hp, L, a.P, a.vec_x);
      load_rows(yr, a.dy + off, hp, L, a.P, a.vec_x);
    }
    float ds[4][4], lc[4][4];
    wgmma_fence();
    mm3<true, true>(ds, sp + X_P * PLANE, sp + B_P * PLANE, n0, 0);
    mm3<true, true>(lc, sp + Y_P * PLANE, sp + C_P * PLANE, n0, 0);
    wgmma_commit();
    wgmma_wait();
    pin(ds);
    pin(lc);
    const size_t at = cell(a, bi, c, h0 + j) * STATE;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = n0 + 8 * nt + 2 * tig;
      const int lo = (m0 + g) * TILE + n, hi = lo + 8 * TILE;
      *reinterpret_cast<float2*>(a.states + at + lo) =
          make_float2(ds[nt][0], ds[nt][1]);
      *reinterpret_cast<float2*>(a.states + at + hi) =
          make_float2(ds[nt][2], ds[nt][3]);
      *reinterpret_cast<float2*>(a.adj + at + lo) =
          make_float2(lc[nt][0], lc[nt][1]);
      *reinterpret_cast<float2*>(a.adj + at + hi) =
          make_float2(lc[nt][2], lc[nt][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launch 2: per (b, h) and four state elements, the states entering the
// chunks (forwards over dS_c) or the adjoints leaving them (backwards over
// L_c), in place: X[c] <- run; run <- e^{A_c} run + own_c.  The first
// `count` threads walk the states, the next `count` the adjoints.
__global__ void __launch_bounds__(PASS_THREADS)
mamba_bwd_pass_kernel(const Args a, int count) {
  int e = blockIdx.x * PASS_THREADS + threadIdx.x;   // float4 index
  if (e >= 2 * count) return;
  const bool back = e >= count;
  if (back) e -= count;
  const int bh = e / (STATE / 4), i4 = e % (STATE / 4);
  const int bi = bh / a.H, h = bh % a.H;
  const size_t stride = static_cast<size_t>(a.H) * STATE / 4;
  float4* st = reinterpret_cast<float4*>(back ? a.adj : a.states) +
               (static_cast<size_t>(bi) * a.nc * a.H + h) * (STATE / 4) + i4;
  const float* dec = a.decay + static_cast<size_t>(bi) * a.nc * a.H + h;
  float4 run = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < a.nc; c0 += UNROLL) {
    float4 d[UNROLL];
    float f[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (c0 + u < a.nc) {
        const int c = back ? a.nc - 1 - c0 - u : c0 + u;
        d[u] = st[c * stride];
        f[u] = dec[static_cast<size_t>(c) * a.H];
      }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (c0 + u < a.nc) {
        const int c = back ? a.nc - 1 - c0 - u : c0 + u;
        st[c * stride] = run;
        run = make_float4(fmaf(f[u], run.x, d[u].x), fmaf(f[u], run.y, d[u].y),
                          fmaf(f[u], run.z, d[u].z), fmaf(f[u], run.w, d[u].w));
      }
  }
}

// ---------------------------------------------------------------------------
// Launch 3: per (b, chunk, group of heads) dx, d a_log and the group's part
// of dB and dC.  Each product is a 64 x 64 output, warpgroup wg its 32
// columns from n0 = 32 wg; a thread holds rows 16 (warp % 4) + g and + 8
// of them, columns n0 + 8 j + 2 tig and + 1.
struct GradSmem {
  static constexpr int W = 16 * PLANE;               // f32 [Q][LDW]
  static constexpr int CUM = W + Q * LDW * 4;        // f32 [GMAX][Q]
  static constexpr int FDOT = CUM + GMAX * Q * 4;    // f32 [2][Q]
  static constexpr int EDOT = FDOT + 2 * Q * 4;      // f32 [2][Q]
  static constexpr int QUAD = EDOT + 2 * Q * 4;      // f32 [WARPS][Q]
  static constexpr int RED = QUAD + WARPS * Q * 4;   // f32 [2][WARPS]
  static constexpr int CB = RED + 2 * WARPS * 4;     // float4 [WARPS][4][32]
  static constexpr int BYTES = CB + WARPS * 4 * 32 * 16 + 1024;
};

__global__ void __launch_bounds__(THREADS, 1)
mamba_bwd_grad_kernel(const Args a) {
  using L_ = GradSmem;
  extern __shared__ __align__(16) uint8_t raw[];
  uint8_t* smem = aligned_smem(raw);
  float* wt = reinterpret_cast<float*>(smem + L_::W);
  float* cum = reinterpret_cast<float*>(smem + L_::CUM);
  float* fdot = reinterpret_cast<float*>(smem + L_::FDOT);
  float* edot = reinterpret_cast<float*>(smem + L_::EDOT);
  float* quad = reinterpret_cast<float*>(smem + L_::QUAD);
  float* red = reinterpret_cast<float*>(smem + L_::RED);
  const uint32_t sp = smem_addr(smem);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int c = blockIdx.x, bi = blockIdx.z;
  const int grp = blockIdx.y, h0 = grp * a.group, G = min(a.group, a.H - h0);
  const int t0 = c * Q, L = min(Q, a.S - t0);
  const size_t row0 = static_cast<size_t>(bi) * a.S + t0;
  const size_t at0 = cell(a, bi, c, h0);
  const auto plane = [&](int p) { return smem + p * PLANE; };
  // C.B^T as this thread's accumulators leave it, a float4 an n8 tile.
  float4* cbs =
      reinterpret_cast<float4*>(smem + L_::CB) + warp * 4 * 32 + lane;
  const int m0 = 16 * (warp % 4), n0 = 32 * (warp / 4);
  const int r_lo = m0 + g, r_hi = r_lo + 8;   // this thread's rows
  const size_t hp = static_cast<size_t>(a.H) * a.P;
  // Head h's x and dy (Q x P rows), and the state entering and adjoint
  // leaving the chunk of its cell `at`.
  const auto load_xy = [&](float4(&xr)[F4], float4(&yr)[F4], int h) {
    const size_t off = (row0 * a.H + h) * a.P;
    load_rows(xr, a.x + off, hp, L, a.P, a.vec_x);
    load_rows(yr, a.dy + off, hp, L, a.P, a.vec_x);
  };
  const auto load_sg = [&](float4(&sr)[F4], float4(&gr)[F4], size_t at) {
    load_state(sr, a.states + at * STATE);
    load_state(gr, a.adj + at * STATE);
  };

  float4 xr[F4], yr[F4], sr[F4], gr[F4];
  load_xy(xr, yr, h0);
  load_sg(sr, gr, at0);
  {
    float4 bv[F4], cv[F4];
    load_rows(bv, a.B + row0 * a.N, a.N, L, a.N, a.vec_bc);
    load_rows(cv, a.C + row0 * a.N, a.N, L, a.N, a.vec_bc);
    put_rows(plane(B_P), bv);
    put_rows(plane(C_P), cv);
    fence_async();
  }
  chunk_cumsum<Q>(a.a_log, a.H, cum, row0, h0, G, L, THREADS);  // syncs B, C
  {
    float cb[4][4];
    wgmma_fence();
    mm3<false, false>(cb, sp + C_P * PLANE, sp + B_P * PLANE, n0, 0);
    wgmma_commit();
    wgmma_wait();
    pin(cb);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      cbs[nt * 32] = make_float4(cb[nt][0], cb[nt][1], cb[nt][2], cb[nt][3]);
  }
  float dBa[4][4] = {}, dCa[4][4] = {};

  for (int j = 0; j < G; ++j) {
    const int h = h0 + j;
    const float* cj = cum + j * Q;
    const float cl = cj[Q - 1];
    // The planes' address, made anew each head so that the compiler forms
    // the descriptors here and does not keep them all in registers.
    uint32_t spj;
    asm volatile("mov.b32 %0, %1;" : "=r"(spj) : "r"(sp));
    const auto addr = [&](int p) { return spj + p * PLANE; };
    // No barrier before these stores: the previous head's products and
    // reads of the planes ended before its last barrier; warp 0 may still
    // read its red[], so the heads alternate two.
    put_rows(plane(X_P), xr);
    put_rows(plane(Y_P), yr);
    put_rows(plane(S_P), sr);
    put_rows(plane(G_P), gr);
    fence_async();
    float* redj = red + (j % 2) * WARPS;
    {   // <Gh, S0>: this thread's part, then the warp's
      float d = 0.f;
#pragma unroll
      for (int k = 0; k < F4; ++k) {
        d = fmaf(gr[k].x, sr[k].x, d);
        d = fmaf(gr[k].y, sr[k].y, d);
        d = fmaf(gr[k].z, sr[k].z, d);
        d = fmaf(gr[k].w, sr[k].w, d);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
      if (lane == 0) redj[warp] = d;
    }
    __syncthreads();
    // The next head's loads, x and dy here, S0 and Gh behind the products'
    // issue, land in registers while this head's products run.
    if (j + 1 < G) load_xy(xr, yr, h + 1);

    // YX = dY X^T, then B Gh^T, X Gh and dY S0 behind it while E1 = D o CB,
    // E2 = D o YX and W = [r > k] E1 o YX are formed (D masked before the
    // exp; E1 and E2 split into their planes, W f32).
    float yx[4][4], dx[4][4], db[4][4], dc[4][4];
    wgmma_fence();
    mm3<false, false>(yx, addr(Y_P), addr(X_P), n0, 0);
    wgmma_commit();
    mm3<false, false>(dx, addr(B_P), addr(G_P), n0, 0);
    mm3<false, true>(db, addr(X_P), addr(G_P), n0, 0);
    mm3<false, true>(dc, addr(Y_P), addr(S_P), n0, 0);
    wgmma_commit();
    if (j + 1 < G) load_sg(sr, gr, at0 + j + 1);
    wgmma_wait<1>();
    pin(yx);
    const float c_lo = cj[r_lo], c_hi = cj[r_hi];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int k = n0 + 8 * nt + 2 * tig;
      const float2 ck = *reinterpret_cast<const float2*>(cj + k);
      const float4 cb4 = cbs[nt * 32];
      const float cb[4] = {cb4.x, cb4.y, cb4.z, cb4.w};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = half ? r_hi : r_lo;
        const float cr = half ? c_hi : c_lo;
        const float neg_inf = __int_as_float(0xff800000);
        const float d0 = expf(r >= k ? cr - ck.x : neg_inf);
        const float d1 = expf(r >= k + 1 ? cr - ck.y : neg_inf);
        const float y0 = yx[nt][2 * half], y1 = yx[nt][2 * half + 1];
        const float e10 = d0 * cb[2 * half], e11 = d1 * cb[2 * half + 1];
        put2(plane(E1_P), r, k, e10, e11);
        put2(plane(E2_P), r, k, d0 * y0, d1 * y1);
        *reinterpret_cast<float2*>(wt + r * LDW + k) =
            make_float2(r > k ? e10 * y0 : 0.f, r > k + 1 ? e11 * y1 : 0.f);
      }
    }
    fence_async();
    __syncthreads();

    // The quadrant sums of (1), sum_{t >= u} sum_{k < u} W[t][k], while the
    // products run: warp w the rows t in [8 w, 8 w + 8), lane the columns u
    // = 2 lane and + 1; each row's exclusive prefix sum over k a warp scan,
    // the eight rows' scans stepped together.
    {
      constexpr int ROWS = Q / WARPS;
      const int u0 = 2 * lane, t0w = ROWS * warp;
      float w0[ROWS], run[ROWS];
#pragma unroll
      for (int tt = 0; tt < ROWS; ++tt) {
        const int t = t0w + tt;
        const float2 w = *reinterpret_cast<const float2*>(wt + t * LDW + u0);
        w0[tt] = u0 < t ? w.x : 0.f;
        run[tt] = w0[tt] + (u0 + 1 < t ? w.y : 0.f);
      }
#pragma unroll
      for (int off = 1; off < 32; off <<= 1)
#pragma unroll
        for (int tt = 0; tt < ROWS; ++tt) {
          const float o = __shfl_up_sync(0xffffffffu, run[tt], off);
          if (lane >= off) run[tt] += o;
        }
      float q0 = 0.f, q1 = 0.f;
#pragma unroll
      for (int tt = 0; tt < ROWS; ++tt) {
        const int t = t0w + tt;
        float before = __shfl_up_sync(0xffffffffu, run[tt], 1);
        if (lane == 0) before = 0.f;
        if (u0 <= t) q0 += before;
        if (u0 + 1 <= t) q1 += before + w0[tt];
      }
      quad[warp * Q + u0] = q0;
      quad[warp * Q + u0 + 1] = q1;
    }

    // Their row dots (f, e) and gates; then dx += E1^T dY, dB_h += E2^T C
    // and dC_h += E2 B.
    wgmma_wait<0>();
    pin(dx);
    pin(db);
    pin(dc);
    row_dots(dx, plane(X_P), fdot + (warp / 4) * Q, r_lo, r_hi, n0);
    row_dots(dc, plane(C_P), edot + (warp / 4) * Q, r_lo, r_hi, n0);
    const float gr_lo = expf(cl - c_lo), gr_hi = expf(cl - c_hi);
    scale_rows(dx, gr_lo, gr_hi);
    scale_rows(db, gr_lo, gr_hi);
    scale_rows(dc, expf(c_lo), expf(c_hi));
    wgmma_fence();
    mm3<true, true>(dx, addr(E1_P), addr(Y_P), n0, 1);
    mm3<true, true>(db, addr(E2_P), addr(C_P), n0, 1);
    mm3<false, true>(dc, addr(E2_P), addr(B_P), n0, 1);
    wgmma_commit();
    wgmma_wait<0>();
    pin(dx);
    pin(db);
    pin(dc);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int p = n0 + 8 * nt + 2 * tig;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = half ? r_hi : r_lo;
        if (t < L && p < a.P) {
          float* row = a.dx + ((row0 + t) * a.H + h) * a.P;
          const float v0 = dx[nt][2 * half], v1 = dx[nt][2 * half + 1];
          if (a.vec_x) {
            *reinterpret_cast<float2*>(row + p) = make_float2(v0, v1);
          } else {
            row[p] = v0;
            if (p + 1 < a.P) row[p + 1] = v1;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dBa[nt][i] += db[nt][i];
        dCa[nt][i] += dc[nt][i];
      }
    }
    __syncthreads();   // the products, row dots and quadrant sums are done
    if (warp == 0) {   // d a_log of rows u0 and u0 + 1
      const int u0 = 2 * lane;
      const float e0 = expf(cj[u0]) * (edot[u0] + edot[Q + u0]);
      const float e1 = expf(cj[u0 + 1]) * (edot[u0 + 1] + edot[Q + u0 + 1]);
      const float f0 = expf(cl - cj[u0]) * (fdot[u0] + fdot[Q + u0]);
      const float f1 =
          expf(cl - cj[u0 + 1]) * (fdot[u0 + 1] + fdot[Q + u0 + 1]);
      // f before u (exclusive), e from u on (inclusive).
      float fb = __shfl_up_sync(0xffffffffu, scan_up(f0 + f1), 1);
      if (lane == 0) fb = 0.f;
      const float ea = scan_down(e0 + e1);
      float eb = __shfl_down_sync(0xffffffffu, ea, 1);
      if (lane == 31) eb = 0.f;
      float gs = 0.f, q0 = 0.f, q1 = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        gs += redj[w];
        q0 += quad[w * Q + u0];
        q1 += quad[w * Q + u0 + 1];
      }
      gs *= expf(cl);
      if (u0 < L) a.da[(row0 + u0) * a.H + h] = (ea + gs) + (fb + q0);
      if (u0 + 1 < L)
        a.da[(row0 + u0 + 1) * a.H + h] = ((e1 + eb) + gs) + ((fb + f0) + q1);
    }
  }

  // The group's parts of dB and dC, rows t < L, all 64 columns.
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int n = n0 + 8 * nt + 2 * tig;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = half ? r_hi : r_lo;
      if (t >= L) continue;
      const size_t o = ((row0 + t) * a.groups + grp) * TILE + n;
      *reinterpret_cast<float2*>(a.dBg + o) =
          make_float2(dBa[nt][2 * half], dBa[nt][2 * half + 1]);
      *reinterpret_cast<float2*>(a.dCg + o) =
          make_float2(dCa[nt][2 * half], dCa[nt][2 * half + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launch 4: dB and dC, the groups' parts added in group order.
__global__ void __launch_bounds__(PASS_THREADS)
mamba_bwd_group_sum_kernel(const Args a, int count) {
  const int i = blockIdx.x * PASS_THREADS + threadIdx.x;
  if (i >= count) return;
  const size_t row = i / a.N;
  const int n = i % a.N;
  const float* pb = a.dBg + row * a.groups * TILE + n;
  const float* pc = a.dCg + row * a.groups * TILE + n;
  float sb = 0.f, sc = 0.f;
  for (int q = 0; q < a.groups; ++q) {
    sb += pb[q * TILE];
    sc += pc[q * TILE];
  }
  a.dB[i] = sb;
  a.dC[i] = sc;
}

struct Layout {
  size_t states, adj, decay, dBg, dCg, bytes;
};

size_t up256(size_t n) { return (n + 255) / 256 * 256; }

Layout layout(int b, int S, int H, int group) {
  const size_t nc = (S + Q - 1) / Q, cells = b * nc * H;
  const size_t parts = static_cast<size_t>(b) * S * ((H + group - 1) / group) *
                       TILE * 4;
  Layout l;
  l.states = 0;
  l.adj = up256(cells * STATE * 4);
  l.decay = l.adj + up256(cells * STATE * 4);
  l.dBg = l.decay + up256(cells * 4);
  l.dCg = l.dBg + up256(parts);
  l.bytes = l.dCg + up256(parts);
  return l;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename Kernel>
int resident_of(Kernel kernel, int bytes) {
  int device = 0, sms = 0, blocks = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess ||
      allow_smem(kernel, bytes) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS,
                                                    bytes) != cudaSuccess)
    return 0;
  return blocks * sms;
}

}  // namespace

// Bytes of scratch a call needs with `group` heads a block of launch 3.
extern "C" long long mamba_scan_bwd_sm90_scratch_bytes(int b, int S, int H,
                                                       int group) {
  if (group < 1) return -1;
  return static_cast<long long>(layout(b, S, H, group).bytes);
}

// Launches the four phases on `stream` of the current device, checking each
// launch, and returns the first CUDA error (0 on success).  dy, dtx and ddtx
// are (b, S, H, P), a_log and da (b, S, H), B, C, dB and dC (b, S, N), all
// contiguous float32; `scratch` holds mamba_scan_bwd_sm90_scratch_bytes(b,
// S, H, group3) bytes, 256-byte aligned; group1 and group3 are the heads a
// block of launches 1 and 3 takes (1 to 32).  The caller checks shapes,
// 1 <= P, N <= 64, b, S, H >= 1 and every size below 2**31.
extern "C" int mamba_scan_bwd_sm90_f32(const void* dy, const void* dtx,
                                       const void* a_log, const void* B,
                                       const void* C, void* ddtx, void* da,
                                       void* dB, void* dC, void* scratch,
                                       int b, int S, int H, int P, int N,
                                       int group1, int group3, void* stream) {
  if (P < 1 || P > TILE || N < 1 || N > TILE || group1 < 1 ||
      group1 > GMAX || group3 < 1 || group3 > GMAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout l = layout(b, S, H, group3);
  uint8_t* base = static_cast<uint8_t*>(scratch);
  Args a;
  a.dy = static_cast<const float*>(dy);
  a.x = static_cast<const float*>(dtx);
  a.a_log = static_cast<const float*>(a_log);
  a.B = static_cast<const float*>(B);
  a.C = static_cast<const float*>(C);
  a.dx = static_cast<float*>(ddtx);
  a.da = static_cast<float*>(da);
  a.dB = static_cast<float*>(dB);
  a.dC = static_cast<float*>(dC);
  a.states = reinterpret_cast<float*>(base + l.states);
  a.adj = reinterpret_cast<float*>(base + l.adj);
  a.decay = reinterpret_cast<float*>(base + l.decay);
  a.dBg = reinterpret_cast<float*>(base + l.dBg);
  a.dCg = reinterpret_cast<float*>(base + l.dCg);
  a.S = S;
  a.H = H;
  a.P = P;
  a.N = N;
  a.nc = (S + Q - 1) / Q;
  a.groups = (H + group3 - 1) / group3;
  a.vec_x = P % 4 == 0 && reinterpret_cast<uintptr_t>(dtx) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(dy) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(ddtx) % 16 == 0;
  a.vec_bc = N % 4 == 0 && reinterpret_cast<uintptr_t>(B) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(C) % 16 == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if ((err = allow_smem(mamba_bwd_chunk_kernel, ChunkSmem::BYTES)) !=
          cudaSuccess ||
      (err = allow_smem(mamba_bwd_grad_kernel, GradSmem::BYTES)) !=
          cudaSuccess)
    return static_cast<int>(err);
  a.group = group1;
  mamba_bwd_chunk_kernel<<<dim3(a.nc, (H + group1 - 1) / group1, b), THREADS,
                           ChunkSmem::BYTES, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int states = b * H * (STATE / 4);
  mamba_bwd_pass_kernel<<<(2 * states + PASS_THREADS - 1) / PASS_THREADS,
                          PASS_THREADS, 0, st>>>(a, states);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  a.group = group3;
  mamba_bwd_grad_kernel<<<dim3(a.nc, a.groups, b), THREADS, GradSmem::BYTES,
                          st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int sums = b * S * N;
  mamba_bwd_group_sum_kernel<<<(sums + PASS_THREADS - 1) / PASS_THREADS,
                               PASS_THREADS, 0, st>>>(a, sums);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of launch `phase` (1: chunk sums, 3: chunk
// gradients); 0 otherwise.

extern "C" int mamba_scan_bwd_sm90_smem_bytes(int phase) {
  return phase == 1 ? ChunkSmem::BYTES : phase == 3 ? GradSmem::BYTES : 0;
}

// How many blocks of launch `phase` (1: chunk sums, 3: chunk gradients) the
// current device holds at once (0 on error).
extern "C" int mamba_scan_bwd_sm90_resident_blocks(int phase) {
  return phase == 1   ? resident_of(mamba_bwd_chunk_kernel, ChunkSmem::BYTES)
         : phase == 3 ? resident_of(mamba_bwd_grad_kernel, GradSmem::BYTES)
                      : 0;
}

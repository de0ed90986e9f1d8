// The TF32x3 products of the mLSTM scan's kernels for Hopper (sm_90a):
// phases B and D of csrc/mlstm_scan_sm90.cu and launches 4 and 5 of
// csrc/mlstm_scan_bwd_sm90.cu.  A TF32x3 product takes hi = tf32(x) and lo
// = tf32(x - hi) of each f32 operand (cvt.rna) and sums lo.hi + hi.lo +
// hi.hi in f32 on the tensor cores, blocks of THREADS threads (two
// warpgroups) taking TILE rows of A and of B.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 128;        // rows of A and of B a block takes

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The operand tiles of the TF32 products are K-major: rows of KW = 16
// floats (64 bytes), 16-byte chunk j of row r at j ^ ((r / 2) % 4) (the
// 64-byte swizzle a TMA box would write); 8-row groups 512 bytes apart.
__device__ __forceinline__ int swz(int row, int byte) {
  return row * 64 + ((((byte >> 4) ^ (row >> 1)) & 3) << 4) + (byte & 15);
}

__device__ __forceinline__ uint64_t k_major(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) | (2ull << 62);
}

// x as hi = tf32(x) and lo = tf32(x - hi), as bit patterns.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

__device__ __forceinline__ void split4(float4 v, uint4& hi, uint4& lo) {
  split(v.x, hi.x, lo.x);
  split(v.y, hi.y, lo.y);
  split(v.z, hi.z, lo.z);
  split(v.w, hi.w, lo.w);
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

// d[0..64) += A.B for one k8 step: A (64 x 8) and B (128 x 8), K-major
// TF32 tiles in shared memory, by descriptor.  Register 4j + 2h + e of a
// thread of warp w holds row 16 (w % 4) + lane / 4 + 8h, column 8j +
// 2 (lane % 4) + e.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t a,
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
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
      : "l"(a), "l"(b), "r"(1));
}

// Keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous products.
__device__ __forceinline__ void pin(float (&r)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// cp.async with zero fill: `bytes` of 0 reads nothing and writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// rows x cols floats (cols % 4 == 0) into dst (row stride cols) by
// cp.async over NT threads; source row r at src + r * stride; row r valid
// below rvalid and column c below cvalid, zeros elsewhere (read from
// nowhere: `safe` is any valid address).  `vec`: 16-byte copies (rows
// 16-byte aligned, cvalid % 4 == 0).
template <int NT = THREADS>
__device__ __forceinline__ void copy_tile(float* dst, const float* src,
                                          size_t stride, int rows, int cols,
                                          int rvalid, int cvalid, bool vec,
                                          const float* safe) {
  const int c4 = cols / 4;
  for (int i = threadIdx.x; i < rows * c4; i += NT) {
    const int r = i / c4, c = 4 * (i % c4);
    float* d = dst + r * cols + c;
    const float* g = src + r * stride + c;
    const bool row_ok = r < rvalid;
    if (vec) {
      const bool ok = row_ok && c < cvalid;
      cp_async16(d, ok ? g : safe, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const bool ok = row_ok && c + u < cvalid;
        cp_async4(d + u, ok ? g + u : safe, ok ? 4 : 0);
      }
    }
  }
}

// The products run through one pipeline: per k-tile of KW = 16 steps of
// the reduction, the inputs (A's 128 rows and B's 128 rows, f32, as they
// lie in memory) arrive by cp.async in a ring of NS stages, are split into
// hi and lo planes of K-major tiles (the 64-byte swizzle, transposed where
// the input's rows run along k), and two warpgroups run m64n128k8 wgmmas
// on them, 64 rows each, while the next tiles copy and split.  Two
// barriers per k-tile guard the buffers: tile t is split into one while
// t - 1's products may run from the other, and t - 2's are done in every
// warpgroup.  The ring and buffers come to 96 KB and the kernels to 128
// registers, so two blocks share an SM and one block's copies and splits
// overlap the other's products.
constexpr int KW = 16;
constexpr int PLANE = TILE * KW * 4;   // 8 KB: hi or lo of one operand
constexpr int BUF = 4 * PLANE;         // A hi, A lo, B hi, B lo
constexpr int NBUF = 2;
constexpr int NS = 2;                  // ring stages of raw k-tiles
constexpr int STAGE = 2 * TILE * KW;   // floats: A's and B's raw k-tile
constexpr int PIPE = NBUF * BUF + NS * STAGE * 4;   // bytes, 1024-aligned

__device__ __forceinline__ uint8_t* pipe_of(unsigned char* raw) {
  return raw + (1024 - smem_addr(raw) % 1024) % 1024;
}

// acc += this warpgroup's A rows . B over one k-tile: per k8 step (32 bytes
// of each row) lo.hi + hi.lo + hi.hi.
__device__ __forceinline__ void products(float (&acc)[64], uint32_t buf,
                                         int wg) {
  const uint32_t a_hi = buf + wg * 64 * 64, a_lo = a_hi + PLANE;
  const uint32_t b_hi = buf + 2 * PLANE, b_lo = b_hi + PLANE;
#pragma unroll
  for (int k = 0; k < KW * 4; k += 32) {
    wgmma_tf32(acc, k_major(a_lo + k), k_major(b_hi + k));
    wgmma_tf32(acc, k_major(a_hi + k), k_major(b_lo + k));
    wgmma_tf32(acc, k_major(a_hi + k), k_major(b_hi + k));
  }
}

// Runs the k-tiles [0, nk) of one product into acc: copy(t, stage) starts
// tile t's cp.asyncs into a ring stage, split(t, stage, buf) splits it into
// a buffer.  `it` counts k-tiles across calls, to rotate the buffers.
template <class Copy, class Split>
__device__ __forceinline__ void gemm(float (&acc)[64], uint8_t* pipe, int nk,
                                     int& it, Copy copy, Split split) {
  const int wg = threadIdx.x / 128;
  float* ring = reinterpret_cast<float*>(pipe + NBUF * BUF);
  __syncthreads();   // the ring and buffers of an earlier call are free
#pragma unroll
  for (int t = 0; t < NS - 1; ++t) {
    if (t < nk) copy(t, ring + t * STAGE);
    cp_async_commit();
  }
  for (int t = 0; t < nk; ++t, ++it) {
    cp_async_wait<NS - 2>();
    __syncthreads();   // tile t landed; stage (t - 1) % NS is split
    if (t + NS - 1 < nk) copy(t + NS - 1, ring + ((t + NS - 1) % NS) * STAGE);
    cp_async_commit();
    uint8_t* buf = pipe + (it % NBUF) * BUF;
    split(t, ring + (t % NS) * STAGE, buf);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    pin(acc);
    wgmma_fence();
    products(acc, smem_addr(buf), wg);
    wgmma_commit();
    wgmma_wait<1>();
    pin(acc);
  }
  wgmma_wait<0>();
  pin(acc);
}

// Split a float4 at k = 4 ch .. 4 ch + 3 of row `row` into the hi and lo
// planes at `hi` (lo one plane on).
__device__ __forceinline__ void put(uint8_t* hi, int row, int ch, float4 v) {
  uint4 h, l;
  split4(v, h, l);
  const int off = swz(row, 16 * ch);
  *reinterpret_cast<uint4*>(hi + off) = h;
  *reinterpret_cast<uint4*>(hi + PLANE + off) = l;
}

// The value as it lies, for put_rows and put_transposed.
struct Same {
  __device__ float operator()(int, float v) const { return v; }
};

// A raw k-tile whose rows run along m or n (TILE rows of KW floats) into
// the planes at `hi`: thread i takes rows i / 4 and i / 4 + 64, floats 4 (i
// % 4) .., each value v of row r as f(r, v) gives it.
template <class F>
__device__ __forceinline__ void put_rows(uint8_t* hi, const float* raw, F f) {
  const int ch = threadIdx.x % 4;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int row = threadIdx.x / 4 + 64 * u;
    const float4 x = *reinterpret_cast<const float4*>(raw + row * KW + 4 * ch);
    put(hi, row, ch, make_float4(f(row, x.x), f(row, x.y), f(row, x.z),
                                 f(row, x.w)));
  }
}

// A raw k-tile whose rows run along k (KW rows of 128 floats), transposed
// into row m = tid % 128 of the planes at `hi`: this thread's 8 floats at k
// = 8 (tid / 128) .., each value v at k as f(k, v) gives it; returns them.
template <class F>
__device__ __forceinline__ void put_transposed(uint8_t* hi, const float* raw,
                                               F f, float (&x)[8]) {
  const int m = threadIdx.x % TILE, k0 = 8 * (threadIdx.x / TILE);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = f(k0 + i, raw[(k0 + i) * TILE + m]);
  put(hi, m, k0 / 4, make_float4(x[0], x[1], x[2], x[3]));
  put(hi, m, k0 / 4 + 1, make_float4(x[4], x[5], x[6], x[7]));
}

// Copies a raw k-tile of 128 rows x KW floats (rows along m or n) into the
// ring; `rstride` apart, valid rows below rvalid and columns below cvalid.
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          size_t rstride, int rvalid,
                                          int cvalid, bool vec,
                                          const float* safe) {
  copy_tile(dst, src, rstride, TILE, KW, rvalid, cvalid, vec, safe);
}

// Copies a raw k-tile of KW rows x 128 floats (rows along k).
__device__ __forceinline__ void copy_cols(float* dst, const float* src,
                                          size_t rstride, int rvalid,
                                          int cvalid, bool vec,
                                          const float* safe) {
  copy_tile(dst, src, rstride, KW, TILE, rvalid, cvalid, vec, safe);
}

}  // namespace

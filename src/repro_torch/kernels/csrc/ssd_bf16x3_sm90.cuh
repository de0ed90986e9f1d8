// The pieces the SSD scan's forward (csrc/mamba_scan_sm90.cu) and backward
// (csrc/mamba_scan_bwd_sm90.cu) kernels share for Hopper (sm_90a): f32
// operands split into hi = bf16(v) and lo = bf16(v - hi) for products as
// a_lo.b_hi + a_hi.b_lo + a_hi.b_hi on the tensor cores, guarded 16-byte
// loads, and the chunk's cumulative log decays as warp scans.  Everything
// is inline and in an anonymous namespace: each kernel file compiles its
// own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two f32 as hi and lo bf16 pairs.
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 f = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - f.x, y - f.y));
}

// Four f32 as hi and lo bf16, four of each packed in 8 bytes.
__device__ __forceinline__ void split4(float4 v, uint2& hi, uint2& lo) {
  split2(v.x, v.y, hi.x, lo.x);
  split2(v.z, v.w, hi.y, lo.y);
}

// Four floats of row `row` (n valid columns) from column c0; zeros past n.
// `vec`: n % 4 == 0 and the rows 16-byte aligned.
__device__ __forceinline__ float4 load4(const float* row, int c0, int n,
                                        bool vec) {
  if (vec)
    return c0 < n ? __ldg(reinterpret_cast<const float4*>(row + c0))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = c0 + i < n ? __ldg(row + c0 + i) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// The cumulative log decays of the block's heads h0 .. h0+G-1 over its
// chunk of L steps, cum[j][s] (a = 0 past L, so cum[j][Q-1] = cum at L-1),
// from a_log (rows of H heads) starting at row row0.
// All threads load; each warp then scans whole heads, Q/32 steps a lane.
template <int Q>
__device__ __forceinline__ void chunk_cumsum(const float* a_log, int H,
                                             float* cum, size_t row0, int h0,
                                             int G, int L, int nthreads) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  for (int i = tid; i < Q * G; i += nthreads) {
    const int s = i / G, j = i % G;
    cum[j * Q + s] = s < L ? __ldg(a_log + (row0 + s) * H + h0 + j) : 0.f;
  }
  __syncthreads();
  constexpr int PER = Q / 32;
  for (int j = warp; j < G; j += nthreads / 32) {
    float v[PER];
    float run = 0.f;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      run += cum[j * Q + lane * PER + k];
      v[k] = run;
    }
    float before = run;   // inclusive scan of the lanes' totals
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, before, off);
      if (lane >= off) before += up;
    }
    before -= run;
#pragma unroll
    for (int k = 0; k < PER; ++k) cum[j * Q + lane * PER + k] = before + v[k];
  }
  __syncthreads();
}

}  // namespace

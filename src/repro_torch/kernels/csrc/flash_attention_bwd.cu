// Flash attention backward in f32 for Hopper (sm_90a), on the CUDA cores:
// dq, dk and dv of the forward in flash_attention.cu, for the output
// gradient dO.  GQA, causal (top-left), optional sliding window and logit
// softcap; f32 in and out.  bf16 inputs go to the tensor-core backward in
// flash_attention_bwd_sm90.cu, whose header gives the formulas; this file
// computes the same ones in the same three launches:
//   (a) D_i = rowsum(dO * O), one f32 per query row (O is the forward's
//       f32 output, exact);
//   (b) one block per (64-key tile, KV head): it walks the group's query
//       heads and their visible query tiles, recomputes S^T = K.Q^T and
//       dP^T = V.dO^T, forms P^T = exp(x - lse) and dS^T, and accumulates
//       dV += P^T.dO and dK += dS^T.Q in registers;
//   (c) one block per (64-query tile, query head): it walks the visible key
//       tiles and accumulates dQ += dS.K in registers.
// No atomics: each output element has one writer and every sum a fixed
// order, so two launches give the same bits.
//
// The Pallas TPU kernel src/repro/kernels/flash_attention.py:84 has no
// backward (JAX trains through the einsum attention_scores); this gives the
// port's f32 forward kernel its gradient.  What bounds it on an H100 SXM:
// 14*D operations per visible (query, key) pair as built (S and dP in both
// (b) and (c), dV, dK, dQ) at 67 TFLOP/s, f32 on the CUDA cores; it stays
// there because f32 inputs are held exact to reordered f32 sums, which the
// tensor cores (TF32 at best) cannot give.  It serves the f32 twins that
// carry training's correctness and any f32 training; it is built to be
// right, not fast.  The design follows the f32 forward: 256 threads as 16 x
// 16, each thread a 4 x (BQ/16) patch of the 64 x BQ score tile, its
// operands read as float4 from shared rows padded to D + 4 floats (rows tx,
// tx + 16, ... so that a quarter warp's float4 loads fall in distinct
// banks); P and dS go through shared memory to the second products, where
// each thread owns 4 rows x D/16 columns of dK and dV (or dQ).  Tiles no
// row can see are skipped and masks applied only on edge tiles, as in the
// forward; rows past S or T are zeros.
//
// Shared memory: (b) 4 * (2*64*(D+4) + 2*BQ*(D+4) + 2*64*(BQ+4) + 2*BQ)
// bytes: 104,960 at D = 64, 218,368 at D = 256 (BQ = 32 there); (c)
// 4 * (2*64*(D+4) + 2*BKC*(D+4) + 64*(BKC+4)): 87,040 at D = 64, 208,896
// at D = 256 (BKC = 32).  What it leaves on the table: loads that overlap
// the math, S and dP computed twice.

#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 64;              // rows a block owns: keys (b), queries (c)
constexpr int THREADS = 256;          // 16 x 16

template <int D>
struct F32Tiles {
  static constexpr int LDF = D + 4;                 // shared row stride
  static constexpr int BQ = D == 256 ? 32 : 64;     // queries a step of (b)
  static constexpr int BKC = D == 256 ? 32 : 64;    // keys a step of (c)
  static constexpr int DC = D / 16;                 // columns a thread owns
  static constexpr int SMEM_B =
      4 * (2 * ROWS * LDF + 2 * BQ * LDF + 2 * ROWS * (BQ + 4) + 2 * BQ);
  static constexpr int SMEM_C =
      4 * (2 * ROWS * LDF + 2 * BKC * LDF + ROWS * (BKC + 4));
  static_assert(D % 16 == 0, "head dim");
  static_assert(SMEM_B <= 232448 && SMEM_C <= 232448, "shared memory");
};

struct BwdArgs {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* lse;
  const float* di;
  float* dq;
  float* dk;
  float* dv;
  int S, T, group, causal, window;
  float scale, softcap;
};

__device__ __forceinline__ bool visible(int i, int j, int S, int T,
                                        int causal, int window) {
  bool ok = i < S && j < T;
  if (causal) ok = ok && j <= i;
  if (window > 0) ok = ok && j > i - window;
  return ok;
}

// P of the raw score s, and ds = P (dp - di) x'(s) through the softcap and
// the 1/sqrt(D) scale.
__device__ __forceinline__ float grad_at(const BwdArgs& a, float s, float dp,
                                         float lse, float di, bool vis,
                                         float& ds) {
  float x, dx;
  if (a.softcap > 0.f) {
    const float t = tanhf(s * (a.scale / a.softcap));
    x = a.softcap * t;
    dx = (1.f - t * t) * a.scale;
  } else {
    x = s * a.scale;
    dx = a.scale;
  }
  const float p = vis ? expf(x - lse) : 0.f;
  ds = p * (dp - di) * dx;
  return p;
}

__device__ __forceinline__ float dot4(float4 x, float4 y, float acc) {
  acc = fmaf(x.x, y.x, acc);
  acc = fmaf(x.y, y.y, acc);
  acc = fmaf(x.z, y.z, acc);
  return fmaf(x.w, y.w, acc);
}

__device__ __forceinline__ float lane_of(float4 x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

// Rows [r0, r0 + n) of a (rows, D) f32 matrix into shared rows of stride
// D + 4, rows at or past `rows` as zeros.
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int r0, int n, int rows) {
  constexpr int CH = D / 4;
  for (int i = threadIdx.x; i < n * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < rows)
      x = *reinterpret_cast<const float4*>(
          src + static_cast<size_t>(r0 + r) * D + 4 * c);
    *reinterpret_cast<float4*>(dst + r * (D + 4) + 4 * c) = x;
  }
}

// (a): D_i = sum_d dO_id O_id, one warp a row.
__global__ void __launch_bounds__(256)
flash_bwd_f32_dot_do_o_kernel(const float* __restrict__ dout,
                              const float* __restrict__ o,
                              float* __restrict__ di, int rows, int D) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const size_t base = static_cast<size_t>(row) * D;
  float sum = 0.f;
  for (int c = lane; c < D; c += 32) sum = fmaf(dout[base + c], o[base + c], sum);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) di[row] = sum;
}

// (b): dK and dV of one 64-key tile of one KV head.
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_f32_dkdv_kernel(const BwdArgs a) {
  using C = F32Tiles<D>;
  constexpr int BQ = C::BQ, RQ = BQ / 16, LDF = C::LDF, LDP = BQ + 4;
  constexpr int DC = C::DC;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;                 // [64][LDF]
  float* sV = sK + ROWS * LDF;      // [64][LDF]
  float* sQ = sV + ROWS * LDF;      // [BQ][LDF]
  float* sO = sQ + BQ * LDF;        // dO, [BQ][LDF]
  float* sP = sO + BQ * LDF;        // P^T, [64][LDP]
  float* sS = sP + ROWS * LDP;      // dS^T, [64][LDP]
  float* sL = sS + ROWS * LDP;      // lse, [BQ]
  float* sD = sL + BQ;              // D_i, [BQ]

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int kvh = blockIdx.x;
  const int k0 = blockIdx.y * ROWS;
  int q_lo = a.causal ? k0 : 0;
  int q_hi = a.S;
  if (a.window > 0) q_hi = min(q_hi, k0 + ROWS - 1 + a.window);
  q_lo = q_lo / BQ * BQ;
  const int nq = q_hi > q_lo ? (q_hi - q_lo + BQ - 1) / BQ : 0;
  const int steps = a.group * nq;

  const size_t kv_off = static_cast<size_t>(kvh) * a.T * D;
  load_rows<D>(sK, a.k + kv_off, k0, ROWS, a.T);
  load_rows<D>(sV, a.v + kv_off, k0, ROWS, a.T);

  float dk[4][DC], dv[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int step = 0; step < steps; ++step) {
    const int bh = kvh * a.group + step / nq;
    const int q0 = q_lo + (step % nq) * BQ;
    const size_t q_off = static_cast<size_t>(bh) * a.S * D;
    __syncthreads();   // the previous step is done with sQ, sO, sP, sS
    load_rows<D>(sQ, a.q + q_off, q0, BQ, a.S);
    load_rows<D>(sO, a.dout + q_off, q0, BQ, a.S);
    for (int r = threadIdx.x; r < BQ; r += THREADS) {
      const bool ok = q0 + r < a.S;
      const size_t row = static_cast<size_t>(bh) * a.S + q0 + r;
      sL[r] = ok ? a.lse[row] : 0.f;
      sD[r] = ok ? a.di[row] : 0.f;
    }
    __syncthreads();

    float s[4][RQ], dp[4][RQ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < RQ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 kx[4], vx[4], qx[RQ], ox[RQ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kx[i] = *reinterpret_cast<const float4*>(sK + (ty + 16 * i) * LDF + d);
        vx[i] = *reinterpret_cast<const float4*>(sV + (ty + 16 * i) * LDF + d);
      }
#pragma unroll
      for (int j = 0; j < RQ; ++j) {
        qx[j] = *reinterpret_cast<const float4*>(sQ + (tx + 16 * j) * LDF + d);
        ox[j] = *reinterpret_cast<const float4*>(sO + (tx + 16 * j) * LDF + d);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < RQ; ++j) {
          s[i][j] = dot4(kx[i], qx[j], s[i][j]);
          dp[i][j] = dot4(vx[i], ox[j], dp[i][j]);
        }
    }

    const bool edge = (a.causal && k0 + ROWS - 1 > q0) ||
                      (a.window > 0 && q0 + BQ - 1 - k0 >= a.window) ||
                      k0 + ROWS > a.T || q0 + BQ > a.S;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < RQ; ++j) {
        const int key = ty + 16 * i, col = tx + 16 * j;
        const bool vis = !edge || visible(q0 + col, k0 + key, a.S, a.T,
                                          a.causal, a.window);
        float ds;
        sP[key * LDP + col] =
            grad_at(a, s[i][j], dp[i][j], sL[col], sD[col], vis, ds);
        sS[key * LDP + col] = ds;
      }
    __syncthreads();

#pragma unroll 2
    for (int qq = 0; qq < BQ; qq += 4) {
      float4 p4[4], d4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p4[i] = *reinterpret_cast<const float4*>(sP + (ty + 16 * i) * LDP + qq);
        d4[i] = *reinterpret_cast<const float4*>(sS + (ty + 16 * i) * LDP + qq);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const float ov = sO[(qq + e) * LDF + tx + 16 * c];
          const float qv = sQ[(qq + e) * LDF + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv[i][c] = fmaf(lane_of(p4[i], e), ov, dv[i][c]);
            dk[i][c] = fmaf(lane_of(d4[i], e), qv, dk[i][c]);
          }
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= a.T) continue;
    const size_t row = kv_off + static_cast<size_t>(key) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      a.dk[row + tx + 16 * c] = dk[i][c];
      a.dv[row + tx + 16 * c] = dv[i][c];
    }
  }
}

// (c): dQ of one 64-query tile of one query head.
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_f32_dq_kernel(const BwdArgs a, int q_tiles) {
  using C = F32Tiles<D>;
  constexpr int BKC = C::BKC, RK = BKC / 16, LDF = C::LDF, LDS = BKC + 4;
  constexpr int DC = C::DC;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                 // [64][LDF]
  float* sO = sQ + ROWS * LDF;      // dO, [64][LDF]
  float* sK = sO + ROWS * LDF;      // [BKC][LDF]
  float* sV = sK + BKC * LDF;       // [BKC][LDF]
  float* sS = sV + BKC * LDF;       // dS, [64][LDS]

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.x;
  const int q0 = (q_tiles - 1 - static_cast<int>(blockIdx.y)) * ROWS;
  int k_lo = 0, k_hi = a.T;
  if (a.window > 0) k_lo = max(0, q0 - a.window + 1) / BKC * BKC;
  if (a.causal) k_hi = min(a.T, q0 + ROWS);

  const size_t q_off = static_cast<size_t>(bh) * a.S * D;
  const size_t kv_off = static_cast<size_t>(bh / a.group) * a.T * D;
  load_rows<D>(sQ, a.q + q_off, q0, ROWS, a.S);
  load_rows<D>(sO, a.dout + q_off, q0, ROWS, a.S);
  float lse[4], di[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    const size_t at = static_cast<size_t>(bh) * a.S + (row < a.S ? row : 0);
    lse[i] = a.lse[at];
    di[i] = a.di[at];
  }

  float dq[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dq[i][c] = 0.f;

  for (int kb = k_lo; kb < k_hi; kb += BKC) {
    __syncthreads();   // the previous tile is done with sK, sV, sS
    load_rows<D>(sK, a.k + kv_off, kb, BKC, a.T);
    load_rows<D>(sV, a.v + kv_off, kb, BKC, a.T);
    __syncthreads();

    float s[4][RK], dp[4][RK];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qx[4], ox[4], kx[RK], vx[RK];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qx[i] = *reinterpret_cast<const float4*>(sQ + (ty + 16 * i) * LDF + d);
        ox[i] = *reinterpret_cast<const float4*>(sO + (ty + 16 * i) * LDF + d);
      }
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        kx[j] = *reinterpret_cast<const float4*>(sK + (tx + 16 * j) * LDF + d);
        vx[j] = *reinterpret_cast<const float4*>(sV + (tx + 16 * j) * LDF + d);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) {
          s[i][j] = dot4(qx[i], kx[j], s[i][j]);
          dp[i][j] = dot4(ox[i], vx[j], dp[i][j]);
        }
    }

    const bool edge = (a.causal && kb + BKC - 1 > q0) ||
                      (a.window > 0 && q0 + ROWS - 1 - kb >= a.window) ||
                      kb + BKC > a.T || q0 + ROWS > a.S;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int row = ty + 16 * i, key = tx + 16 * j;
        const bool vis = !edge || visible(q0 + row, kb + key, a.S, a.T,
                                          a.causal, a.window);
        float ds;
        grad_at(a, s[i][j], dp[i][j], lse[i], di[i], vis, ds);
        sS[row * LDS + key] = ds;
      }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BKC; kk += 4) {
      float4 d4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        d4[i] = *reinterpret_cast<const float4*>(sS + (ty + 16 * i) * LDS + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const float kv = sK[(kk + e) * LDF + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            dq[i][c] = fmaf(lane_of(d4[i], e), kv, dq[i][c]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.S) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      a.dq[q_off + static_cast<size_t>(row) * D + tx + 16 * c] = dq[i][c];
  }
}

template <int D>
int launch(const BwdArgs& a, const float* o, float* di, int BH, int BKV,
           cudaStream_t stream) {
  using C = F32Tiles<D>;
  const int rows = BH * a.S;
  flash_bwd_f32_dot_do_o_kernel<<<(rows + 7) / 8, 256, 0, stream>>>(
      a.dout, o, di, rows, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_f32_dkdv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM_B);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_f32_dkdv_kernel<D><<<dim3(BKV, (a.T + ROWS - 1) / ROWS), THREADS,
                                 C::SMEM_B, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_f32_dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM_C);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int q_tiles = (a.S + ROWS - 1) / ROWS;
  flash_bwd_f32_dq_kernel<D><<<dim3(BH, q_tiles), THREADS, C::SMEM_C,
                               stream>>>(a, q_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the three kernels on `stream` and returns the CUDA error (0 on
// success).  q, dout, o, dq: (BH, S, D); k, v, dk, dv: (BKV, T, D); all
// contiguous f32, 16-byte aligned; lse and di (scratch, written by the
// first launch): (BH, S) f32.  The caller checks shapes, BH % BKV == 0, D in
// {16, 32, 64, 80, 96, 128, 256}, BH and S / 64 within the grid's 65535, and
// every index below 2**31.
extern "C" int flash_attention_bwd_f32(
    const float* q, const float* k, const float* v, const float* o,
    const float* lse, const float* dout, float* dq, float* dk, float* dv,
    float* di, int BH, int BKV, int S, int T, int D, int causal, int window,
    float softcap, void* stream) {
  BwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = lse;
  a.di = di;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.S = S;
  a.T = T;
  a.group = BH / BKV;
  a.causal = causal;
  a.window = window;
  a.scale = 1.0f / sqrtf(static_cast<float>(D));
  a.softcap = softcap;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(a, o, di, BH, BKV, s);
    case 32: return launch<32>(a, o, di, BH, BKV, s);
    case 64: return launch<64>(a, o, di, BH, BKV, s);
    case 80: return launch<80>(a, o, di, BH, BKV, s);
    case 96: return launch<96>(a, o, di, BH, BKV, s);
    case 128: return launch<128>(a, o, di, BH, BKV, s);
    case 256: return launch<256>(a, o, di, BH, BKV, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

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
// tensor cores (TF32 at best for f32) cannot give.  The design:
//   * one block of 256 threads owns 64 query rows of one query head; it
//     keeps them in shared memory (pre-scaled by 1/sqrt(D)) and walks
//     the key axis in 64-key tiles, staging K (transposed) and V in shared
//     memory; the KV head bh / group is read in place, never copied;
//   * each thread owns a 4x4 patch of the 64x64 score tile and 4 rows x
//     D/16 columns of the output accumulator, in registers; the running
//     max m and sum l of its 4 rows are reduced across the 16 threads
//     that share them with warp shuffles;
//   * tiles wholly above the diagonal (causal) or wholly left of every
//     row's window are skipped, since they add nothing; a row that sees no
//     key at all (S >= T + window) would get 0 where JAX gives the mean of
//     v, so the wrapper refuses such windows;
//   * masked logits are -1e30 as in JAX, so a row whose first visited tile
//     is wholly masked takes exp(0) garbage that the first visible key's
//     alpha = exp(-1e30 - m) = 0 wipes; keys past T (the ragged edge) are
//     -inf and add nothing at all.  The final divide is by max(l, 1e-30).
// Where the caller passes a pointer, the epilogue also writes each row's
// log-sum-exp of its logits (m + ln l) for the backward in
// flash_attention_bwd.cu; o is computed the same way either way.
// Shared memory is 4 * (2*68*D + 64*D + 64*68) bytes: 222,208 at D = 256,
// so one block per SM; 81,408 at zamba2's D = 80 and 94,208 at phi3's
// D = 96, two.  What it leaves on
// the table: loads that overlap the previous tile's math, and more than one
// block per SM at D = 256.

#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;              // query rows per block
constexpr int BK = 64;              // keys per tile
constexpr int THREADS = 256;        // 16 x 16
constexpr int RQ = BQ / 16;         // query rows per thread
constexpr int RK = BK / 16;         // score columns per thread
constexpr int PAD = 4;              // keeps float4 alignment, spreads banks
constexpr int QS = BQ + PAD;        // row stride of Qt and Pt
constexpr int KS = BK + PAD;        // row stride of Kt
constexpr float MASKED = -1e30f;    // the JAX kernel's NEG_INF
#define NO_KEY __int_as_float(0xff800000)   // -inf

static_assert(RQ == 4 && RK == 4, "the float4 paths assume 4x4 patches");

struct FlashArgs {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* lse;   // null, or the rows' log-sum-exp for the backward
  int S, T, group, causal, window;
  float scale, softcap;
};

template <int D>
constexpr int smem_floats() {
  return 2 * D * QS + BK * D + BK * QS;   // Qt, Kt, Vs, Pt (QS == KS)
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_fwd_kernel(const FlashArgs a) {
  // Each thread owns output columns c(m, e) = m*16*VEC + tx*VEC + e: VEC
  // is the widest of 4, 2 and 1 that divides D / 16 (1 at D = 80, 2 at
  // D = 96).
  constexpr int VEC = (D / 16) % 4 == 0 ? 4 : (D / 16) % 2 == 0 ? 2 : 1;
  constexpr int NCH = D / (16 * VEC);
  constexpr int DC = NCH * VEC;             // = D / 16
  static_assert(D % 16 == 0 && DC == D / 16, "head dim");

  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                 // [D][QS]  q, transposed, pre-scaled
  float* Kt = Qt + D * QS;          // [D][KS]  k tile, transposed
  float* Vs = Kt + D * KS;          // [BK][D]  v tile
  float* Pt = Vs + BK * D;          // [BK][QS] probabilities, transposed

  const int tid = threadIdx.x;
  const int tx = tid % 16;          // score columns / output columns
  const int ty = tid / 16;          // query rows; 16 lanes share one ty
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const float* q = a.q + (size_t)bh * a.S * D;
  const size_t kv_off = (size_t)(bh / a.group) * a.T * D;
  const float* k = a.k + kv_off;
  const float* v = a.v + kv_off;
  float* o = a.o + (size_t)bh * a.S * D;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int qi = q0 + r;
    Qt[d * QS + r] = qi < a.S ? q[(size_t)qi * D + d] * a.scale : 0.f;
  }

  // Keys any row of this tile can see: none past the tile's last row when
  // causal, none at or before q0 - window when windowed.
  int k_begin = 0, k_end = a.T;
  if (a.causal) k_end = min(a.T, q0 + BQ);
  if (a.window > 0) k_begin = max(0, q0 - a.window + 1);

  float m[RQ], l[RQ], acc[RQ][DC];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = MASKED;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int kb = k_begin; kb < k_end; kb += BK) {
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, d = i % D;
      const int kj = kb + r;
      float kv = 0.f, vv = 0.f;
      if (kj < a.T) {
        kv = k[(size_t)kj * D + d];
        vv = v[(size_t)kj * D + d];
      }
      Kt[d * KS + r] = kv;
      Vs[r * D + d] = vv;
    }
    __syncthreads();   // also orders the Q tile's stores before first use

    float s[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(&Qt[d * QS + ty * RQ]);
      const float4 kv = *reinterpret_cast<const float4*>(&Kt[d * KS + tx * RK]);
      const float qa[RQ] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[RK] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

    float mt[RQ];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qi = q0 + ty * RQ + i;
      mt[i] = m[i];
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int kj = kb + tx * RK + j;
        float x = s[i][j];
        if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
        bool visible = true;
        if (a.causal) visible = visible && kj <= qi;
        if (a.window > 0) visible = visible && kj > qi - a.window;
        x = visible ? x : MASKED;
        if (kj >= a.T) x = NO_KEY;   // past the ragged edge
        s[i][j] = x;
        mt[i] = fmaxf(mt[i], x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], off));
    }

    float rs[RQ];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      rs[i] = 0.f;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        s[i][j] = expf(s[i][j] - mt[i]);
        rs[i] += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], off);
      const float alpha = expf(m[i] - mt[i]);
      m[i] = mt[i];
      l[i] = l[i] * alpha + rs[i];
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < RK; ++j)
      *reinterpret_cast<float4*>(&Pt[(tx * RK + j) * QS + ty * RQ]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float4 pv = *reinterpret_cast<const float4*>(&Pt[j * QS + ty * RQ]);
      const float pa[RQ] = {pv.x, pv.y, pv.z, pv.w};
      const float* vrow = Vs + j * D;
      float va[DC];
#pragma unroll
      for (int mm = 0; mm < NCH; ++mm) {
        if constexpr (VEC == 4) {
          const float4 t =
              *reinterpret_cast<const float4*>(vrow + mm * 64 + tx * 4);
          va[mm * 4 + 0] = t.x;
          va[mm * 4 + 1] = t.y;
          va[mm * 4 + 2] = t.z;
          va[mm * 4 + 3] = t.w;
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            va[mm * VEC + e] = vrow[mm * 16 * VEC + tx * VEC + e];
        }
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pa[i], va[c], acc[i][c]);
    }
    __syncthreads();   // before the next tile overwrites Kt, Vs and Pt
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qi = q0 + ty * RQ + i;
    if (qi >= a.S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    if (a.lse != nullptr && tx == 0)
      a.lse[(size_t)bh * a.S + qi] = m[i] + logf(denom);
#pragma unroll
    for (int mm = 0; mm < NCH; ++mm)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int c = mm * 16 * VEC + tx * VEC + e;
        o[(size_t)qi * D + c] = acc[i][mm * VEC + e] / denom;
      }
  }
}

template <int D>
int launch(const FlashArgs& a, int BH, cudaStream_t stream) {
  constexpr int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_fwd_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.S + BQ - 1) / BQ, BH);
  flash_attention_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns the CUDA error (0 on success).  q, k, v
// and o are contiguous float32; the caller checks shapes, BH % BKV == 0, D
// in {16, 32, 64, 80, 96, 128, 256}, BH <= 65535 and every index below 2**31.
// lse, where not null, gets each row's log-sum-exp of its logits ((BH, S),
// for the backward in flash_attention_bwd.cu); o is the same either way.
extern "C" int flash_attention_f32(const float* q, const float* k,
                                   const float* v, float* o, float* lse,
                                   int BH, int BKV, int S, int T, int D,
                                   int causal, int window, float softcap,
                                   void* stream) {
  FlashArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lse = lse;
  a.S = S;
  a.T = T;
  a.group = BH / BKV;
  a.causal = causal;
  a.window = window;
  a.scale = 1.0f / sqrtf(static_cast<float>(D));
  a.softcap = softcap;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(a, BH, s);
    case 32: return launch<32>(a, BH, s);
    case 64: return launch<64>(a, BH, s);
    case 80: return launch<80>(a, BH, s);
    case 96: return launch<96>(a, BH, s);
    case 128: return launch<128>(a, BH, s);
    case 256: return launch<256>(a, BH, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Stabilised mLSTM scan for Hopper (sm_90a), f32 in and out.
//
// Replaces the Pallas TPU kernel src/repro/kernels/mlstm_scan.py
// (mlstm_scan_kernel, body _kernel).  Per (batch b, head h), token by
// token, with log f_t = logsigmoid(f_pre_t) and m_0 = -1e30:
//
//   m_t = max(log f_t + m_{t-1}, i_t)
//   i_s = exp(i_t - m_t),  f_s = exp(log f_t + m_{t-1} - m_t)
//   C_t = f_s C_{t-1} + i_s v_t k_t^T      (P x P matrix memory, C_0 = 0)
//   n_t = f_s n_{t-1} + i_s k_t            (P vector, n_0 = 0)
//   h_t = C_t q_t / max(|n_t . q_t|, 1)
//
// with q, k, v (b, S, H, P) and i_pre, f_pre (b, S, H).
//
// What bounds it on an H100 SXM: per step and head the recurrence does
// about 5 P^2 operations (C's update 3 P^2, C q 2 P^2) and moves 16 P bytes
// (q, k, v in, h out), some 160 operations per byte at P = 512, far above
// the f32 CUDA cores' balance (67 TFLOP/s over 3.35 TB/s: 20).  So
// operations bound it, and the recurrence is sequential in t: per-step
// latency sets the time unless every SM holds a share of every step.
//
// What is hard, and what this design does about it:
//   * The state does not fit one block: at P = 512, C is 1 MiB per (b, h)
//     against 227 KB of shared memory.  C is split by rows (the v / h
//     index): a block owns R = 16 rows of C and the same 16 entries of h,
//     so there are ceil(P / 16) blocks per (b, h), 128 at xlstm-1.3b's
//     batch 1 with H = 4, which fills the card.  The slice lives in
//     registers: 8 warps, each warp owns 64 columns of all 16 rows, each
//     lane 4 rows x 8 columns (two float4 groups, so its shared-memory
//     reads are conflict-free).
//   * Blocks never talk.  Each block updates the whole n itself (one more
//     "row" spread over its 256 threads, 2 columns each) and computes the
//     gates itself: n adds 1 / 16 to a block's 16 rows of work.
//   * No block barrier per step.  A warp reduces its rows' partial sums of
//     C q over its 8 lanes of a row group with shuffles (transposed, so
//     4 rows take 4 shuffles) and n . q over all 32 lanes; it parks one
//     partial per (step, row) and per step in shared memory.  The division
//     h = num / den, which needs every warp's partials, waits for the end
//     of a run of T = 16 steps: one barrier per run.
//   * Inputs arrive ahead of use: q and k for all P columns, the block's 16
//     entries of v and the two gate inputs of a run are copied into shared
//     memory with cp.async while the previous run computes (two buffers).
//   * The gates: every warp runs the scalar m chain itself, in the same
//     order as the plain version (lanes compute logsigmoid of a run's
//     steps in parallel; the max / add chain is serial; the exps parallel
//     again), and broadcasts i_s and f_s with a shuffle each step.
// Shared memory: 2 x 16 x 512 x 4 x 2 (q, k) + the v, gate and partial
// buffers = 150,784 bytes, one block per SM.  What it leaves on the table:
// every block re-reads all of q and k from L2 (ceil(P / 16)-fold); the
// products run in f32 on the CUDA cores; P below 512 is padded with zeros
// to 512 columns.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int T = 16;            // steps per run (one barrier per run)
constexpr int R = 16;            // rows of C per block
constexpr int PMAX = 512;        // columns: 8 warps x 64
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr float M0 = -1e30f;     // the stabiliser before the first step

struct ScanArgs {
  const float* q;
  const float* k;
  const float* v;
  const float* i_pre;
  const float* f_pre;
  float* h;
  int S, H, P;
  int row_blocks;                // ceil(P / R) blocks per (b, h)
  bool vec16;                    // q and k rows copied as 16-byte chunks
};

struct Smem {
  float q[2][T][PMAX];
  float k[2][T][PMAX];
  float v[2][T][R];
  float i_raw[2][T];
  float f_raw[2][T];
  float num[2][T][R][WARPS];     // per-warp partials of C q
  float den[2][T][WARPS];        // per-warp partials of n . q
};

__device__ __forceinline__ void cp_async4(void* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async16(void* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copies run `run`'s q, k (all P columns), v (this block's rows) and gate
// inputs into buffer `buf`; steps past S and columns past P are not copied.
__device__ void stage(const ScanArgs& a, Smem& s, int buf, int run, int bi,
                      int hh, int r0) {
  const int tid = threadIdx.x;
  const int t0 = run * T;
  const int L = min(T, a.S - t0);
  const int P = a.P, H = a.H;
  const size_t row0 = (size_t)bi * a.S + t0;         // (b, t0) in (b, S)
  if (a.vec16) {
    const int chunks = P / 4;
    for (int i = tid; i < L * chunks; i += THREADS) {
      const int t = i / chunks, c = 4 * (i % chunks);
      const size_t g = ((row0 + t) * H + hh) * P + c;
      cp_async16(&s.q[buf][t][c], a.q + g);
      cp_async16(&s.k[buf][t][c], a.k + g);
    }
  } else {
    for (int i = tid; i < L * P; i += THREADS) {
      const int t = i / P, c = i % P;
      const size_t g = ((row0 + t) * H + hh) * P + c;
      cp_async4(&s.q[buf][t][c], a.q + g);
      cp_async4(&s.k[buf][t][c], a.k + g);
    }
  }
  const int rows = min(R, P - r0);
  for (int i = tid; i < L * R; i += THREADS) {
    const int t = i / R, r = i % R;
    if (r < rows)
      cp_async4(&s.v[buf][t][r], a.v + ((row0 + t) * H + hh) * P + r0 + r);
  }
  if (tid < L) {
    cp_async4(&s.i_raw[buf][tid], a.i_pre + (row0 + tid) * H + hh);
    cp_async4(&s.f_raw[buf][tid], a.f_pre + (row0 + tid) * H + hh);
  }
}

// h for run `run` from the parked partials: thread (t, r) sums the warps'
// partials of step t, row r, and divides by max(|n . q|, 1).
__device__ void finish(const ScanArgs& a, const Smem& s, int buf, int run,
                       int bi, int hh, int r0) {
  const int tid = threadIdx.x;
  const int t = tid / R, r = tid % R;
  const int t0 = run * T;
  if (t0 + t >= a.S || r0 + r >= a.P) return;
  float num = 0.f, den = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    num += s.num[buf][t][r][w];
    den += s.den[buf][t][w];
  }
  den = fmaxf(fabsf(den), 1.f);
  a.h[(((size_t)bi * a.S + t0 + t) * a.H + hh) * a.P + r0 + r] = num / den;
}

// The steps of one run for this lane: C's 4 x 8 slice and n's 2 columns
// updated in place, and the partials of C q and n . q parked in shared
// memory.  A full run (kFull) is straight-line code, so the compiler can
// overlap one step's shuffle reductions with the next step's products.
template <bool kFull>
__device__ __forceinline__ void run_steps(Smem& s, int buf, int L, int warp,
                                          int lane, int c0, int cn, int rsum,
                                          float is_l, float fs_l,
                                          float (&C)[4][8], float& n0,
                                          float& n1) {
  const int rg = lane / 8, cg = lane % 8;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    if (!kFull && t >= L) break;
    const float fs = __shfl_sync(0xffffffffu, fs_l, t);
    const float is = __shfl_sync(0xffffffffu, is_l, t);
    const float4 qa = *reinterpret_cast<const float4*>(&s.q[buf][t][c0]);
    const float4 qb =
        *reinterpret_cast<const float4*>(&s.q[buf][t][c0 + 32]);
    const float4 ka = *reinterpret_cast<const float4*>(&s.k[buf][t][c0]);
    const float4 kb =
        *reinterpret_cast<const float4*>(&s.k[buf][t][c0 + 32]);
    const float4 vv = *reinterpret_cast<const float4*>(&s.v[buf][t][rg * 4]);
    const float qv[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
    const float kv[8] = {ka.x, ka.y, ka.z, ka.w, kb.x, kb.y, kb.z, kb.w};
    const float va[4] = {is * vv.x, is * vv.y, is * vv.z, is * vv.w};
    float acc[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float lo = 0.f, hi = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        C[i][j] = fmaf(va[i], kv[j], fs * C[i][j]);
        if (j < 4)
          lo = fmaf(C[i][j], qv[j], lo);
        else
          hi = fmaf(C[i][j], qv[j], hi);
      }
      acc[i] = lo + hi;
    }
    const float2 nk = *reinterpret_cast<const float2*>(&s.k[buf][t][cn]);
    const float2 nq = *reinterpret_cast<const float2*>(&s.q[buf][t][cn]);
    n0 = fmaf(is, nk.x, fs * n0);
    n1 = fmaf(is, nk.y, fs * n1);
    float d = fmaf(n1, nq.y, n0 * nq.x);

    // Sum the 4 rows over the 8 lanes of the row group, transposed: at
    // each level a lane keeps half its rows and sends the other half.
    const bool up4 = cg & 4, up2 = cg & 2;
    float k0 = up4 ? acc[2] : acc[0], k1 = up4 ? acc[3] : acc[1];
    const float s0 = up4 ? acc[0] : acc[2], s1 = up4 ? acc[1] : acc[3];
    k0 += __shfl_xor_sync(0xffffffffu, s0, 4);
    k1 += __shfl_xor_sync(0xffffffffu, s1, 4);
    float kk = up2 ? k1 : k0;
    kk += __shfl_xor_sync(0xffffffffu, up2 ? k0 : k1, 2);
    kk += __shfl_xor_sync(0xffffffffu, kk, 1);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      d += __shfl_xor_sync(0xffffffffu, d, off);
    if ((cg & 1) == 0) s.num[buf][t][rsum][warp] = kk;
    if (lane == 0) s.den[buf][t][warp] = d;
  }
}

static_assert(T * R == THREADS, "finish() gives each thread one output");
static_assert(T <= 32, "a run's gates sit one per lane");

__global__ void __launch_bounds__(THREADS, 1)
mlstm_scan_kernel(const ScanArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int rg = lane / 8;           // row group: rows 4 rg .. 4 rg + 3
  const int cg = lane % 8;           // column group within the warp
  const int bh = blockIdx.x / a.row_blocks;
  const int r0 = (blockIdx.x % a.row_blocks) * R;
  const int bi = bh / a.H, hh = bh % a.H;
  // This lane's columns of C: c0 + 0..3 and c0 + 32 + 0..3.
  const int c0 = warp * 64 + cg * 4;
  // Its 2 columns of n: the 64 of the warp split over the 32 lanes.
  const int cn = warp * 64 + (rg >= 2 ? 32 : 0) + cg * 4 + (rg & 1) * 2;
  // After the transposed reduction this lane holds the sum of row rsum.
  const int rsum = rg * 4 + (cg >> 1);

  // Zeros past P (columns) and past this block's rows stay zero: the
  // copies never write there, so padding adds nothing to C, n or h.
  {
    float* z = reinterpret_cast<float*>(&s);
    const int n = (sizeof(s.q) + sizeof(s.k) + sizeof(s.v)) / sizeof(float);
    for (int i = tid; i < n; i += THREADS) z[i] = 0.f;
  }
  __syncthreads();

  const int runs = (a.S + T - 1) / T;
  stage(a, s, 0, 0, bi, hh, r0);
  cp_async_commit();

  float C[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) C[i][j] = 0.f;
  float n0 = 0.f, n1 = 0.f;
  float m = M0;                      // the same in every lane

  for (int run = 0; run < runs; ++run) {
    const int buf = run & 1;
    const int L = min(T, a.S - run * T);
    cp_async_wait_all();
    // Run `run`'s inputs are visible; every warp is done with run - 1, so
    // buffer buf ^ 1 is free and run - 1's partials are complete.
    __syncthreads();
    if (run + 1 < runs) stage(a, s, buf ^ 1, run + 1, bi, hh, r0);
    cp_async_commit();
    if (run > 0) finish(a, s, buf ^ 1, run - 1, bi, hh, r0);

    // Gates of this run: lane t holds step t's i_s and f_s.
    const float ir = lane < L ? s.i_raw[buf][lane] : 0.f;
    const float fr = lane < L ? s.f_raw[buf][lane] : 0.f;
    const float lf = fminf(fr, 0.f) - log1pf(expf(-fabsf(fr)));
    float m_prev = 0.f, m_new = 0.f;
#pragma unroll
    for (int t = 0; t < T; ++t) {
      if (t < L) {
        const float lft = __shfl_sync(0xffffffffu, lf, t);
        const float it = __shfl_sync(0xffffffffu, ir, t);
        const float mt = fmaxf(lft + m, it);
        if (lane == t) {
          m_prev = m;
          m_new = mt;
        }
        m = mt;
      }
    }
    const float is_l = expf(ir - m_new);
    const float fs_l = expf((lf + m_prev) - m_new);

    if (L == T)
      run_steps<true>(s, buf, L, warp, lane, c0, cn, rsum, is_l, fs_l, C, n0,
                      n1);
    else
      run_steps<false>(s, buf, L, warp, lane, c0, cn, rsum, is_l, fs_l, C,
                       n0, n1);
  }
  __syncthreads();
  finish(a, s, (runs - 1) & 1, runs - 1, bi, hh, r0);
}

}  // namespace

// Launches on `stream` and returns the CUDA error (0 on success).  q, k, v
// and h are (b, S, H, P), i_pre and f_pre (b, S, H), all contiguous
// float32; the caller checks shapes, 1 <= P <= 512, b, S, H >= 1, and every
// index below 2**31.
extern "C" int mlstm_scan_f32(const void* q, const void* k, const void* v,
                              const void* i_pre, const void* f_pre, void* h,
                              int b, int S, int H, int P, void* stream) {
  constexpr int smem = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ScanArgs args;
  args.q = static_cast<const float*>(q);
  args.k = static_cast<const float*>(k);
  args.v = static_cast<const float*>(v);
  args.i_pre = static_cast<const float*>(i_pre);
  args.f_pre = static_cast<const float*>(f_pre);
  args.h = static_cast<float*>(h);
  args.S = S;
  args.H = H;
  args.P = P;
  args.row_blocks = (P + R - 1) / R;
  args.vec16 = P % 4 == 0 &&
               ((reinterpret_cast<std::uintptr_t>(q) |
                 reinterpret_cast<std::uintptr_t>(k)) & 15) == 0;
  mlstm_scan_kernel<<<b * H * args.row_blocks, THREADS, smem,
                      static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mlstm_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

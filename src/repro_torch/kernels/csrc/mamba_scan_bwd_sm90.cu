// Backward of the Mamba2 / SSD scan for Hopper (sm_90a): f32 in and out,
// chunk parallel, every product in f32 on the CUDA cores.
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
// the pair terms), agrees with it to a few thousandths of the 1e-4 limit
// where d a_log is of the order of the other gradients; where d a_log
// vanishes (a full reset, ~1e-12) its differences lose all of it, and the
// quadrant sums keep it to 3e-7 of itself (the CPU emulation in
// tests/test_torch_mamba_scan.py).  Four launches:
//   1. chunk sums: per (b, chunk, head) the chunk's own state dS_c =
//      sum_s e^{cum_L - cum_s} x_s (x) B_s and its own adjoint L_c =
//      sum_t e^{cum_t} dy_t (x) C_t, both P x N, and e^{cum_L};
//   2. passes: per state element, forwards over the chunks the state
//      entering each chunk (S0_{c+1} = e^{A_c} S0_c + dS_c), backwards the
//      adjoint leaving it (Gh_c = L_{c+1} + e^{A_{c+1}} Gh_{c+1}), each in
//      place over the chunk sums: the forward's states are recomputed in
//      f32 here, not taken from the forward's bf16x3 scratch;
//   3. chunk gradients: per (b, chunk, head) the masked products
//      E1 = [s>=t] e^{cum_s - cum_t} C_s.B_t, E2 = [s>=t] e^{..} dy_s.x_t and
//      the pair terms W of (1), then dx, this head's dB and dC, and da;
//   4. head sums: dB and dC summed over the heads, in head order.
// The exp is taken only where its exponent is <= 0 (masked before the
// exp, s <= t), so a = -30 (a full reset) gives exact zeros, not NaN.
// dB and dC are sums over every head (80 at zamba2): each block writes its
// head's part to a scratch and launch 4 adds them in one order; there are
// no atomics, and two launches give the same bits.
//
// The chunk is 64 steps whatever the forward's: P and N are at most 64, so
// a block holds x, dy, B, C, S0, Gh and the three Q x Q products in shared
// memory (150 KB).  The work is ten products of 64^3 multiply-adds per (b,
// chunk, head); at zamba2's training shape (b 4, S 1024, H 80, P = N = 64)
// 27 GFLOP on the CUDA cores, against 0.26 GB of inputs and outputs:
// operations bound it.  A first version: the tensor cores (wgmma) and fewer barriers are
// what would make it fast.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int Q = 64;              // steps per chunk
constexpr int TILE = 64;           // P and N as the blocks hold them
constexpr int LD = TILE + 1;       // row stride of the shared tiles
constexpr int STATE = TILE * TILE; // floats of one state in the scratch
constexpr int THREADS = 256;       // a 4 x 4 block of a 64 x 64 product each
constexpr int PASS_THREADS = 256;

using Tile = float[LD];

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
  float* dBh;     // (b, S, H, N): each head's part of dB
  float* dCh;     // (b, S, H, N): each head's part of dC
  int S, H, P, N, nc;
};

struct ChunkSmem {
  Tile x[Q], dy[Q], B[Q], C[Q];
  float cum[Q], gl[Q], gr[Q];
};

struct GradSmem {
  Tile x[Q], dy[Q], B[Q], C[Q], S0[TILE], G[TILE], E1[Q], E2[Q], W[Q];
  float cum[Q], gl[Q], gr[Q], e[Q], f[Q], red[THREADS / 32];
};

// rows [t0, t0 + Q) of a (rows, width)-strided operand into a zero-padded
// Q x TILE tile: row t at base + t * stride, `cols` of its floats.
__device__ void load_tile(Tile* dst, const float* base, size_t stride,
                          int rows, int cols) {
  for (int i = threadIdx.x; i < Q * TILE; i += THREADS) {
    const int r = i / TILE, c = i % TILE;
    dst[r][c] = r < rows && c < cols ? base[r * stride + c] : 0.f;
  }
}

// The chunk's inputs, its a_log, cum (summed in order), e^{cum_t} and
// e^{cum_L - cum_t}; padded steps have a_log = 0, so cum_L is the last
// real step's.
__device__ void load_chunk(const Args& a, int c, int hh, int bi, Tile* x,
                           Tile* dy, Tile* Bt, Tile* Ct, float* cum,
                           float* gl, float* gr) {
  const int t0 = c * Q, rows = min(Q, a.S - t0);
  const size_t row0 = static_cast<size_t>(bi) * a.S + t0;
  const size_t hp = static_cast<size_t>(a.H) * a.P;
  load_tile(x, a.x + (row0 * a.H + hh) * a.P, hp, rows, a.P);
  load_tile(dy, a.dy + (row0 * a.H + hh) * a.P, hp, rows, a.P);
  load_tile(Bt, a.B + row0 * a.N, a.N, rows, a.N);
  load_tile(Ct, a.C + row0 * a.N, a.N, rows, a.N);
  for (int i = threadIdx.x; i < Q; i += THREADS)
    cum[i] = i < rows ? a.a_log[(row0 + i) * a.H + hh] : 0.f;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int i = 1; i < Q; ++i) cum[i] += cum[i - 1];
  __syncthreads();
  for (int i = threadIdx.x; i < Q; i += THREADS) {
    gl[i] = expf(cum[i]);
    gr[i] = expf(cum[Q - 1] - cum[i]);
  }
  __syncthreads();
}

// acc[i][j] += sum_k a(r_i, k) b(k, c_j) over k < 64, r_i = tr + 16 i,
// c_j = tc + 16 j; a(r, k) = TA ? A[k][r] : A[r][k], b(k, c) = TB ? Bm[c][k]
// : Bm[k][c].  Rows and columns 16 apart keep the loads off shared banks.
template <bool TA, bool TB>
__device__ __forceinline__ void mm(const Tile* A, const Tile* Bm,
                                   float (&acc)[4][4], int tr, int tc) {
#pragma unroll 4
  for (int k = 0; k < TILE; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = TA ? A[k][tr + 16 * i] : A[tr + 16 * i][k];
      bv[i] = TB ? Bm[tc + 16 * i][k] : Bm[k][tc + 16 * i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

__device__ __forceinline__ size_t cell(const Args& a, int bi, int c, int hh) {
  return (static_cast<size_t>(bi) * a.nc + c) * a.H + hh;
}

// Launch 1: dS_c and L_c per (chunk, head, batch).
__global__ void __launch_bounds__(THREADS)
mamba_bwd_chunk_kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t raw[];
  ChunkSmem& s = *reinterpret_cast<ChunkSmem*>(raw);
  const int c = blockIdx.x, hh = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  load_chunk(a, c, hh, bi, s.x, s.dy, s.B, s.C, s.cum, s.gl, s.gr);
  for (int i = tid; i < Q * TILE; i += THREADS) {
    const int r = i / TILE, k = i % TILE;
    s.x[r][k] *= s.gr[r];
    s.dy[r][k] *= s.gl[r];
  }
  __syncthreads();
  const size_t at = cell(a, bi, c, hh);
  float acc[4][4];
  zero(acc);
  mm<true, false>(s.x, s.B, acc, tr, tc);
  float* out = a.states + at * STATE;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[(tr + 16 * i) * TILE + tc + 16 * j] = acc[i][j];
  zero(acc);
  mm<true, false>(s.dy, s.C, acc, tr, tc);
  out = a.adj + at * STATE;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[(tr + 16 * i) * TILE + tc + 16 * j] = acc[i][j];
  if (tid == 0) a.decay[at] = s.gl[Q - 1];
}

// Launch 2: per state element, the state entering each chunk (forwards)
// and the adjoint leaving it (backwards), in place.
__global__ void __launch_bounds__(PASS_THREADS)
mamba_bwd_pass_kernel(const Args a, int count) {
  const int i = blockIdx.x * PASS_THREADS + threadIdx.x;
  if (i >= count) return;
  const int bh = i / STATE, e = i % STATE;
  const int bi = bh / a.H, hh = bh % a.H;
  float run = 0.f;
  for (int c = 0; c < a.nc; ++c) {
    const size_t at = cell(a, bi, c, hh);
    float* p = a.states + at * STATE + e;
    const float own = *p;
    *p = run;
    run = fmaf(a.decay[at], run, own);
  }
  run = 0.f;
  for (int c = a.nc - 1; c >= 0; --c) {
    const size_t at = cell(a, bi, c, hh);
    float* p = a.adj + at * STATE + e;
    const float own = *p;
    *p = run;
    run = fmaf(a.decay[at], run, own);
  }
}

// Sums v over the 16 lanes that share tr (lanes 0-15 or 16-31 of a warp).
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Launch 3: per (chunk, head, batch) dx, this head's dB and dC, and da.
__global__ void __launch_bounds__(THREADS, 1)
mamba_bwd_grad_kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t raw[];
  GradSmem& s = *reinterpret_cast<GradSmem*>(raw);
  const int c = blockIdx.x, hh = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const int t0 = c * Q, rows = min(Q, a.S - t0);
  const size_t at = cell(a, bi, c, hh);
  for (int i = tid; i < STATE; i += THREADS) {
    s.S0[i / TILE][i % TILE] = a.states[at * STATE + i];
    s.G[i / TILE][i % TILE] = a.adj[at * STATE + i];
  }
  load_chunk(a, c, hh, bi, s.x, s.dy, s.B, s.C, s.cum, s.gl, s.gr);

  // E1 = D o (C B^T), E2 = D o (dy x^T) with D[r][k] = [r >= k]
  // e^{cum_r - cum_k}, and the pair terms W = [r > k] D o CB o dyx.
  {
    float cb[4][4], yx[4][4];
    zero(cb);
    zero(yx);
    mm<false, true>(s.C, s.B, cb, tr, tc);
    mm<false, true>(s.dy, s.x, yx, tr, tc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tr + 16 * i, k = tc + 16 * j;
        const float d = r >= k ? expf(s.cum[r] - s.cum[k]) : 0.f;
        const float e1 = d * cb[i][j];
        s.E1[r][k] = e1;
        s.E2[r][k] = d * yx[i][j];
        s.W[r][k] = r > k ? e1 * yx[i][j] : 0.f;
      }
  }
  __syncthreads();

  const size_t row0 = static_cast<size_t>(bi) * a.S + t0;
  float acc[4][4], carry[4][4];
  // dx = E1^T dy + e^{cum_L - cum_t} (B Gh^T); the row dots x_t.(Gh B_t).
  zero(acc);
  zero(carry);
  mm<true, false>(s.E1, s.dy, acc, tr, tc);
  mm<false, true>(s.B, s.G, carry, tr, tc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = tr + 16 * i;
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = tc + 16 * j;
      dot = fmaf(s.x[t][p], carry[i][j], dot);
      if (t < rows && p < a.P)
        a.dx[((row0 + t) * a.H + hh) * a.P + p] =
            fmaf(s.gr[t], carry[i][j], acc[i][j]);
    }
    dot = sum16(dot);
    if (tc == 0) s.f[t] = s.gr[t] * dot;
  }
  // this head's dB = E2^T C + e^{cum_L - cum_t} (x Gh).
  zero(acc);
  zero(carry);
  mm<true, false>(s.E2, s.C, acc, tr, tc);
  mm<false, false>(s.x, s.G, carry, tr, tc);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = tr + 16 * i, n = tc + 16 * j;
      if (t < rows && n < a.N)
        a.dBh[((row0 + t) * a.H + hh) * a.N + n] =
            fmaf(s.gr[t], carry[i][j], acc[i][j]);
    }
  // this head's dC = E2 B + e^{cum_t} (dy S0); the row dots C_t.(S0^T dy_t).
  zero(acc);
  zero(carry);
  mm<false, false>(s.E2, s.B, acc, tr, tc);
  mm<false, false>(s.dy, s.S0, carry, tr, tc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = tr + 16 * i;
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = tc + 16 * j;
      dot = fmaf(s.C[t][n], carry[i][j], dot);
      if (t < rows && n < a.N)
        a.dCh[((row0 + t) * a.H + hh) * a.N + n] =
            fmaf(s.gl[t], carry[i][j], acc[i][j]);
    }
    dot = sum16(dot);
    if (tc == 0) s.e[t] = s.gl[t] * dot;
  }
  // <Gh, S0>, over the block in one order.
  float gs = 0.f;
  for (int i = tid; i < STATE; i += THREADS)
    gs = fmaf(s.G[i / TILE][i % TILE], s.S0[i / TILE][i % TILE], gs);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) gs += __shfl_xor_sync(0xffffffffu, gs, o);
  if (tid % 32 == 0) s.red[tid / 32] = gs;
  __syncthreads();
  // The quadrant sums of W: each row's exclusive prefix sums in place,
  // then each column's sum from its diagonal down.
  if (tid < Q) {
    float run = 0.f;
    for (int k = 0; k < Q; ++k) {
      const float w = s.W[tid][k];
      s.W[tid][k] = run;
      run += w;
    }
  }
  __syncthreads();
  if (tid < rows) {
    const int u = tid;
    float quad = 0.f, e = 0.f, f = 0.f, gs_all = 0.f;
    for (int t = u; t < Q; ++t) {
      quad += s.W[t][u];
      e += s.e[t];
    }
    for (int k = 0; k < u; ++k) f += s.f[k];
    for (int w = 0; w < THREADS / 32; ++w) gs_all += s.red[w];
    a.da[(row0 + u) * a.H + hh] = (e + s.gl[Q - 1] * gs_all) + (f + quad);
  }
}

// Launch 4: dB and dC, each head's part summed in head order.
__global__ void __launch_bounds__(PASS_THREADS)
mamba_bwd_head_sum_kernel(const Args a, int count) {
  const int i = blockIdx.x * PASS_THREADS + threadIdx.x;
  if (i >= count) return;
  const size_t row = i / a.N;
  const int n = i % a.N;
  const float* b = a.dBh + row * a.H * a.N + n;
  const float* c = a.dCh + row * a.H * a.N + n;
  float sb = 0.f, sc = 0.f;
  for (int h = 0; h < a.H; ++h) {
    sb += b[h * a.N];
    sc += c[h * a.N];
  }
  a.dB[i] = sb;
  a.dC[i] = sc;
}

struct Layout {
  size_t states, adj, decay, dBh, dCh, bytes;
};

size_t up256(size_t n) { return (n + 255) / 256 * 256; }

Layout layout(int b, int S, int H, int N) {
  const size_t nc = (S + Q - 1) / Q, cells = b * nc * H;
  Layout l;
  l.states = 0;
  l.adj = up256(cells * STATE * 4);
  l.decay = l.adj + up256(cells * STATE * 4);
  l.dBh = l.decay + up256(cells * 4);
  l.dCh = l.dBh + up256(static_cast<size_t>(b) * S * H * N * 4);
  l.bytes = l.dCh + up256(static_cast<size_t>(b) * S * H * N * 4);
  return l;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// Bytes of scratch a call needs.
extern "C" long long mamba_scan_bwd_sm90_scratch_bytes(int b, int S, int H,
                                                       int N) {
  return static_cast<long long>(layout(b, S, H, N).bytes);
}

// Launches the four phases on `stream` of the current device, checking each
// launch, and returns the first CUDA error (0 on success).  dy, dtx and ddtx
// are (b, S, H, P), a_log and da (b, S, H), B, C, dB and dC (b, S, N), all
// contiguous float32; `scratch` holds mamba_scan_bwd_sm90_scratch_bytes(b,
// S, H, N) bytes, 256-byte aligned.  The caller checks shapes, 1 <= P, N <=
// 64, b, S, H >= 1 and every size below 2**31.
extern "C" int mamba_scan_bwd_sm90_f32(const void* dy, const void* dtx,
                                       const void* a_log, const void* B,
                                       const void* C, void* ddtx, void* da,
                                       void* dB, void* dC, void* scratch,
                                       int b, int S, int H, int P, int N,
                                       void* stream) {
  if (P < 1 || P > TILE || N < 1 || N > TILE)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout l = layout(b, S, H, N);
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
  a.dBh = reinterpret_cast<float*>(base + l.dBh);
  a.dCh = reinterpret_cast<float*>(base + l.dCh);
  a.S = S;
  a.H = H;
  a.P = P;
  a.N = N;
  a.nc = (S + Q - 1) / Q;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if ((err = allow_smem(mamba_bwd_chunk_kernel, sizeof(ChunkSmem))) !=
          cudaSuccess ||
      (err = allow_smem(mamba_bwd_grad_kernel, sizeof(GradSmem))) !=
          cudaSuccess)
    return static_cast<int>(err);
  const dim3 grid(a.nc, H, b);
  mamba_bwd_chunk_kernel<<<grid, THREADS, sizeof(ChunkSmem), st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int states = b * H * STATE;
  mamba_bwd_pass_kernel<<<(states + PASS_THREADS - 1) / PASS_THREADS,
                          PASS_THREADS, 0, st>>>(a, states);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  mamba_bwd_grad_kernel<<<grid, THREADS, sizeof(GradSmem), st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int sums = b * S * N;
  mamba_bwd_head_sum_kernel<<<(sums + PASS_THREADS - 1) / PASS_THREADS,
                              PASS_THREADS, 0, st>>>(a, sums);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of launch `phase` (1: chunk sums, 3: chunk
// gradients); 0 otherwise.
extern "C" int mamba_scan_bwd_sm90_smem_bytes(int phase) {
  return phase == 1 ? static_cast<int>(sizeof(ChunkSmem))
                    : phase == 3 ? static_cast<int>(sizeof(GradSmem)) : 0;
}

// Fused CONV + BN(folded) [+ residual ADD] [+ ReLU] for Hopper (sm_90a), f32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_conv.py
// (fused_conv_kernel, body _kernel): the PIMcore fused op of the paper's
// Table I (CONV_BN / CONV_BN_RELU / ADD_RELU).
//
//   y[b,oh,ow,n] = [relu]( sum_k patch(b,oh,ow)[k] * w[k,n] * scale[n]
//                          + shift[n] [+ residual[b,oh,ow,n]] )
//
// x is NHWC, w is HWIO, so w is already the (K = kh*kw*Cin) x Cout matrix of
// an implicit GEMM whose rows are the B*OH*OW output pixels.  k runs over
// (r, c, ci) with ci fastest, which is also the order of a patch row in NHWC
// memory, so neighbouring threads read neighbouring addresses even at Cin=3.
//
// What bounds it on an H100 SXM: the card's balance is 67 TFLOP/s f32 (CUDA
// cores; the tensor cores take no plain f32) over 3.35 TB/s, about 20
// operations per byte.  At batch 8 the stem and the 3x3 convs of ResNet18
// do 60-330 operations per byte they must move, and the 1x1/s2 downsamples,
// which read only every other input row and column, 21-60; stage 2's
// downsample sits at the balance.  So every conv is bound by operations,
// and the design's job is to keep the FMA units fed from registers:
//   * one block computes a 64-pixel x 64-channel output tile; each step
//     stages a 16-deep slice of input patches and of weights in shared
//     memory, so each weight is read once per tile from device memory and
//     reused by all 64 pixels (the paper's GBUF weight broadcast);
//   * each thread keeps a 4x4 register tile of sums and reads its operands
//     as float4 from shared memory: 16 FMAs for two shared loads;
//   * the epilogue (scale, shift, residual, ReLU) runs on the registers and
//     stores each output once: the fused layer makes one device-memory
//     round trip, as on the PIM bank and the TPU.
// Ragged edges are masked in the kernel, so unlike the Pallas version there
// is no pad-to-tile-and-crop and no Cout % block requirement: any OH, OW,
// Cout, and Cin=3 (the stem's K=147) go through the same code.
// Not done here (later work): tensor cores via TF32/bf16 wgmma, TMA loads,
// double-buffered staging, split-K for the small late-stage grids.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;              // output pixels per block
constexpr int BN = 64;              // output channels per block
constexpr int BK = 16;              // reduction depth staged per step
constexpr int TM = 4;               // pixels per thread
constexpr int TN = 4;               // channels per thread
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256
constexpr int A_ROWS = THREADS / BK;             // pixels one A-load pass covers
constexpr int B_ROWS = THREADS / BN;             // k rows one B-load pass covers
constexpr int A_STRIDE = BM + 4;    // keeps float4 alignment, spreads banks
constexpr int OUT_OF_IMAGE = -(1 << 28);

static_assert(BM % A_ROWS == 0 && BK % B_ROWS == 0, "tile shape");

struct ConvArgs {
  const float* x;
  const float* w;
  const float* scale;
  const float* shift;
  const float* residual;            // nullptr when there is no ADD
  float* y;
  int B, H, W, Cin, kh, kw, Cout, OH, OW, stride, pad, relu;
};

__global__ void __launch_bounds__(THREADS)
fused_conv_f32_kernel(const ConvArgs a) {
  __shared__ __align__(16) float As[BK][A_STRIDE];  // patches, k-major
  __shared__ __align__(16) float Bs[BK][BN];        // weights, k-major

  const int tid = threadIdx.x;
  const int M = a.B * a.OH * a.OW;
  const int K = a.kh * a.kw * a.Cin;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // Patch loader: thread owns column k0 + a_k of the slice and BM / A_ROWS
  // pixels; each pixel's image offset and window corner are decoded once.
  const int a_k = tid % BK;
  const int a_m = tid / BK;
  int img[BM / A_ROWS], ih0[BM / A_ROWS], iw0[BM / A_ROWS];
#pragma unroll
  for (int i = 0; i < BM / A_ROWS; ++i) {
    const int m = m0 + a_m + i * A_ROWS;
    img[i] = 0;
    ih0[i] = OUT_OF_IMAGE;
    iw0[i] = OUT_OF_IMAGE;
    if (m < M) {
      const int ow = m % a.OW;
      const int t = m / a.OW;
      const int oh = t % a.OH;
      img[i] = (t / a.OH) * a.H * a.W * a.Cin;
      ih0[i] = oh * a.stride - a.pad;
      iw0[i] = ow * a.stride - a.pad;
    }
  }
  // Weight loader: thread owns channel n0 + b_n and BK / B_ROWS k rows.
  const int b_n = tid % BN;
  const int b_k = tid / BN;
  const bool n_ok = n0 + b_n < a.Cout;

  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    const int k = k0 + a_k;
    const bool k_ok = k < K;
    int ci = 0, r = 0, c = 0;
    if (k_ok) {
      ci = k % a.Cin;
      const int rc = k / a.Cin;
      c = rc % a.kw;
      r = rc / a.kw;
    }
#pragma unroll
    for (int i = 0; i < BM / A_ROWS; ++i) {
      const int ih = ih0[i] + r;
      const int iw = iw0[i] + c;
      float v = 0.f;   // zero padding and the ragged edges of M and K
      if (k_ok && ih >= 0 && ih < a.H && iw >= 0 && iw < a.W)
        v = __ldg(a.x + img[i] + (ih * a.W + iw) * a.Cin + ci);
      As[a_k][a_m + i * A_ROWS] = v;
    }
#pragma unroll
    for (int i = 0; i < BK / B_ROWS; ++i) {
      const int kk = k0 + b_k + i * B_ROWS;
      Bs[b_k + i * B_ROWS][b_n] =
          (n_ok && kk < K) ? __ldg(a.w + kk * a.Cout + n0 + b_n) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float am[TM] = {av.x, av.y, av.z, av.w};
      const float bn[TN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(am[i], bn[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n >= a.Cout) continue;
      const int o = m * a.Cout + n;   // NHWC output is the (M, Cout) matrix
      float v = acc[i][j] * __ldg(a.scale + n) + __ldg(a.shift + n);
      if (a.residual != nullptr) v += __ldg(a.residual + o);
      if (a.relu && v < 0.f) v = 0.f;   // keeps NaN, as torch.relu does
      a.y[o] = v;
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).  The
// caller checks shapes and keeps every index below 2**31.
extern "C" int fused_conv_f32(const void* x, const void* w, const void* scale,
                              const void* shift, const void* residual, void* y,
                              int B, int H, int W, int Cin, int kh, int kw,
                              int Cout, int OH, int OW, int stride, int pad,
                              int relu, void* stream) {
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
  const int M = B * OH * OW;
  const dim3 grid((M + BM - 1) / BM, (Cout + BN - 1) / BN);
  fused_conv_f32_kernel<<<grid, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fused_conv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

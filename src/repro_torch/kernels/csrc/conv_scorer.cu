// Fused 3x3 SAME convolution + bias + ReLU over NHWC float32, for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/conv_scorer.py::conv_scorer
// (body _conv_kernel). It computes what that kernel computes,
//     out = relu(conv3x3_sSAME(x, w) + b),
// x (N, H, W, Cin) NHWC, w (3, 3, Cin, Cout) HWIO, out (N, Ho, Wo, Cout),
// and is not a block-by-block copy of the Pallas grid.
//
// Bound on an H100 SXM (67 TFLOP/s fp32 without tensor cores, 3.35 TB/s),
// at the main path's largest chunk: 1024 frames of op_L5c32s100, five
// layers. Operations count 2*Cin per in-bounds tap of each output (taps
// on the SAME padding are skipped); bytes read x, w, b once and write out
// once.
//     L1 100x100x3  -> 50x50x32   4.36 GFLOP  451 MB   bytes       134 us
//     L2 50x50x32   -> 25x25x32  11.48 GFLOP  410 MB   operations  171 us
//     L3 25x25x32   -> 13x13x32   2.87 GFLOP  104 MB   operations   43 us
//     L4 13x13x32   -> 7x7x32     0.76 GFLOP   29 MB   operations   11 us
//     L5 7x7x32     -> 4x4x32     0.21 GFLOP  8.6 MB   operations  3.1 us
// About 19.7 GFLOP and 1.0 GB in all: 0.294 ms of fp32 operations against
// 0.299 ms of bytes, so the chunk as a whole is bound by bytes. Layer by
// layer the bounds sum to about 0.36 ms: operations set every layer but
// the first, which is set by its bytes. chip_smoke.py computes these
// bounds from each run's shapes and prints them beside the measured times.
//
// The design is the simple one that is right first:
//   * one thread per output element (n, ho, wo, co), co fastest, so a
//     warp's stores are contiguous and its x loads are broadcasts;
//   * all of w (at most 9*32*32 floats, 36 KB) and b staged in shared
//     memory, read conflict-free because neighbouring threads take
//     neighbouring co;
//   * SAME padding by bounds checks on the unpadded input, with the
//     smaller half of the padding before (top, left), as XLA pads; no
//     padded copy of x is made in device memory;
//   * fp32 FMA accumulation in the fixed order kh, kw, ci, the order of
//     the Pallas kernel's nine shifted dot products.
// Each output reads only its own image's pixels, in an order fixed by
// (kh, kw, ci) alone, so its value does not depend on N: zero rows that
// pad a batch to its bucket cannot change real rows, and the small and
// bucketed dispatch layers agree bit for bit in the convolution by
// construction. Tensor cores (wgmma), TMA, an implicit GEMM and a group
// axis for stacked superbatches are later work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void conv3x3_bias_relu(const float* __restrict__ x,
                                  const float* __restrict__ w,
                                  const float* __restrict__ b,
                                  float* __restrict__ out, long long total,
                                  int H, int W, int Cin, int Cout, int Ho,
                                  int Wo, int stride, int top, int left) {
  extern __shared__ float smem[];
  float* ws = smem;                     // 9 * Cin * Cout, HWIO order
  float* bs = smem + 9 * Cin * Cout;    // Cout
  const int nw = 9 * Cin * Cout;
  for (int i = threadIdx.x; i < nw; i += blockDim.x) ws[i] = w[i];
  for (int i = threadIdx.x; i < Cout; i += blockDim.x) bs[i] = b[i];
  __syncthreads();

  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int co = (int)(idx % Cout);
  long long r = idx / Cout;
  const int wo = (int)(r % Wo);
  r /= Wo;
  const int ho = (int)(r % Ho);
  const long long n = r / Ho;

  const float* xn = x + n * H * W * Cin;
  float acc = 0.0f;
  for (int kh = 0; kh < 3; ++kh) {
    const int hi = ho * stride - top + kh;
    if (hi < 0 || hi >= H) continue;    // zero padding adds nothing
    for (int kw = 0; kw < 3; ++kw) {
      const int wi = wo * stride - left + kw;
      if (wi < 0 || wi >= W) continue;
      const float* xp = xn + ((long long)hi * W + wi) * Cin;
      const float* wp = ws + (kh * 3 + kw) * Cin * Cout + co;
      for (int ci = 0; ci < Cin; ++ci) acc = fmaf(xp[ci], wp[ci * Cout], acc);
    }
  }
  const float v = acc + bs[co];
  out[idx] = v > 0.0f ? v : 0.0f;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); 0 means launched.
// The caller (kernels/conv_scorer.py) has checked shapes, types and
// contiguity and computed the output size and the SAME padding offsets.
extern "C" int conv_scorer_f32(const void* x, const void* w, const void* b,
                               void* out, int N, int H, int W, int Cin,
                               int Cout, int Ho, int Wo, int stride, int top,
                               int left, void* stream) {
  const long long total = (long long)N * Ho * Wo * Cout;
  if (total == 0) return 0;
  const size_t smem = (size_t)(9 * Cin * Cout + Cout) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv3x3_bias_relu, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (total + kThreads - 1) / kThreads;
  conv3x3_bias_relu<<<(unsigned int)blocks, kThreads, smem,
                      (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (const float*)b, (float*)out, total,
      H, W, Cin, Cout, Ho, Wo, stride, top, left);
  return (int)cudaGetLastError();
}

// The scorer's dense and head layers, out = relu(h @ Wd + bd) @ Wh + bh,
// in float32, for sm_90a.
//
// Replaces no Pallas kernel. It stands for the two XLA matmuls of the
// JAX package's scorer body (repro/core/runtime.py:200-201), which the
// port ran as torch.matmul: cuBLAS may pick another algorithm, and so
// another order of summation, when the row count changes, and the same
// frame then scored differently in the 32-row small layer and the 64-row
// bucketed layer (5.96e-8 on an H100). Here each output is summed over k
// in one fixed order that depends on neither M nor the row's place in a
// block, so every dispatch layer gives the same bits for a frame: the
// port's invariant that all dispatch layers agree.
//
// h (M, feat), Wd (feat, dense), bd (dense,), Wh (dense, 2), bh (2,),
// out (M, 2); dense <= 64 (the operator family's 16, 32 or 64).
//
// Bound on an H100 SXM: at M 1024, feat 512, dense 64 it reads 2.2 MB
// (0.66 us at 3.35 TB/s) and does 67 MFLOP on the CUDA cores (1.0 us at
// 67 TFLOP/s of float32). The design is the simple one that is right:
//   * one block of 128 threads per 8 rows, 16 threads a row, each
//     thread holding up to 4 of the row's dense units;
//   * the block's rows of h and Wd come into shared memory by cp.async
//     in k-chunks as deep as 96 KB allows (all of feat 512 in two), all
//     of a chunk's copies in flight at once, read coalesced;
//   * a dense unit's sum is one float32 accumulator, fmaf over k = 0,
//     1, ..., feat - 1 in order, then + bd and relu; a head output is one
//     accumulator over the dense units in order, then + bh.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;                   // rows of h per block
constexpr int kLanes = 16;                 // threads per row
constexpr int kThreads = kRows * kLanes;
constexpr int kMaxDense = 64;
constexpr int kUnits = kMaxDense / kLanes; // dense units a thread holds
constexpr int kSmemBudget = 96 * 1024;     // two blocks an SM

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// k-rows of a chunk: h's kRows rows and Wd's rows of that depth.
int chunk_depth(int feat, int dense) {
  const int kc = kSmemBudget / (int)(sizeof(float) * (kRows + dense));
  return kc < feat ? kc : feat;
}

__global__ void __launch_bounds__(kThreads)
    dense_head(const float* __restrict__ h, const float* __restrict__ wd,
               const float* __restrict__ bd, const float* __restrict__ wh,
               const float* __restrict__ bh, float* __restrict__ out, int M,
               int feat, int dense, int kc) {
  extern __shared__ float smem[];
  float* h_s = smem;                     // kRows x kc
  float* w_s = smem + kRows * kc;        // kc x dense
  __shared__ float hid[kRows][kMaxDense + 1];

  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, M - row0);
  const int r = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  float acc[kUnits];
#pragma unroll
  for (int u = 0; u < kUnits; ++u) acc[u] = 0.0f;

  for (int k0 = 0; k0 < feat; k0 += kc) {
    const int kn = min(kc, feat - k0);
    __syncthreads();   // the previous chunk is no longer read
    for (int i = threadIdx.x; i < rows * kn; i += kThreads) {
      const int rr = i / kn, kk = i % kn;
      cp_async4(h_s + rr * kc + kk, h + (long long)(row0 + rr) * feat + k0 + kk);
    }
    for (int i = threadIdx.x; i < kn * dense; i += kThreads)
      cp_async4(w_s + i, wd + (long long)k0 * dense + i);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    if (r < rows) {
      const float* hr = h_s + r * kc;
      for (int kk = 0; kk < kn; ++kk) {
        const float hv = hr[kk];
#pragma unroll
        for (int u = 0; u < kUnits; ++u) {
          const int j = lane + kLanes * u;
          if (j < dense) acc[u] = fmaf(hv, w_s[kk * dense + j], acc[u]);
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    const int j = lane + kLanes * u;
    if (j < dense) {
      const float v = acc[u] + bd[j];
      hid[r][j] = v > 0.0f ? v : 0.0f;
    }
  }
  __syncthreads();
  if (threadIdx.x < rows * 2) {
    const int rr = threadIdx.x / 2, c = threadIdx.x % 2;
    float s = 0.0f;
    for (int j = 0; j < dense; ++j) s = fmaf(hid[rr][j], wh[j * 2 + c], s);
    out[(long long)(row0 + rr) * 2 + c] = s + bh[c];
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); 0 means launched.
// The caller (kernels/scorer_head.py) has checked shapes (dense <= 64),
// types and contiguity.
extern "C" int scorer_head_f32(const void* h, const void* wd, const void* bd,
                               const void* wh, const void* bh, void* out,
                               int M, int feat, int dense, void* stream) {
  if (M == 0) return 0;
  if (dense < 1 || dense > kMaxDense || feat < 1)
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      dense_head, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget);
  if (attr != cudaSuccess) return (int)attr;
  const int kc = chunk_depth(feat, dense);
  const size_t smem = sizeof(float) * (size_t)kc * (kRows + dense);
  const unsigned int blocks = (unsigned int)((M + kRows - 1) / kRows);
  dense_head<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)h, (const float*)wd, (const float*)bd, (const float*)wh,
      (const float*)bh, (float*)out, M, feat, dense, kc);
  return (int)cudaGetLastError();
}

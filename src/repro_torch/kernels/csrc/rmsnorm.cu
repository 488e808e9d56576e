// Row-wise RMSNorm, y = x * rsqrt(mean(x^2) + eps) * scale, for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/rmsnorm.py::rmsnorm (body
// _rms_kernel). x (R, D) in float32 or bfloat16, scale (D,) float32, out
// (R, D) in x's type; the sum of squares, the scaling and the product
// with scale are float32, and the result is rounded to x's type once, as
// the Pallas kernel and the model's layers.rmsnorm do.
//
// Bound on an H100 SXM: bytes. A row does 3 operations per element
// against 2 bytes read and 2 written in bf16, far below the 295
// operations per byte at which the tensor cores would set the limit, so
// the least time is (R * D * 2 * sizeof(T) + 4 * D) / 3.35 TB/s. At the
// served shapes (D = 2560): a 2048-token prefill moves 21 MB (6.3 us);
// a decode tick over 8 slots moves 92 KB (0.03 us), where the launch
// itself is the cost.
//
// The design is the simple one that is right first:
//   * one block of 256 threads per row; neighbouring threads read
//     neighbouring elements, so every load and store is coalesced;
//   * the float32 sum of squares is reduced by warp shuffles and then
//     across the eight warps in shared memory, in a fixed order, so a
//     row's result does not depend on the number of rows;
//   * the row is read a second time for the output; at D = 2560 it is
//     5 KB in bf16 and comes from L1/L2, not device memory.
// Several rows per block and 16-byte vector loads are later work.
#include "common.cuh"

namespace {

using repro_torch::from_float;
using repro_torch::to_float;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_rows(const T* __restrict__ x, const float* __restrict__ scale,
                 T* __restrict__ out, int D, float eps) {
  __shared__ float warp_sums[kWarps];
  const T* xr = x + (long long)blockIdx.x * D;
  T* outr = out + (long long)blockIdx.x * D;
  float ss = 0.0f;
  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float v = to_float(xr[i]);
    ss = fmaf(v, v, ss);
  }
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = 0.0f;
  for (int w = 0; w < kWarps; ++w) total += warp_sums[w];
  const float r = 1.0f / sqrtf(total / (float)D + eps);
  for (int i = threadIdx.x; i < D; i += kThreads) {
    outr[i] = from_float<T>(to_float(xr[i]) * r * scale[i]);
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Launches on `stream` and returns
// cudaGetLastError(); 0 means launched. The caller (kernels/rmsnorm.py)
// has checked shapes, types and contiguity.
extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* out,
                           int dtype, long long rows, int D, float eps,
                           void* stream) {
  if (rows == 0 || D == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    rmsnorm_rows<float><<<(unsigned int)rows, kThreads, 0, s>>>(
        (const float*)x, (const float*)scale, (float*)out, D, eps);
  } else if (dtype == 1) {
    rmsnorm_rows<__nv_bfloat16><<<(unsigned int)rows, kThreads, 0, s>>>(
        (const __nv_bfloat16*)x, (const float*)scale, (__nv_bfloat16*)out, D,
        eps);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

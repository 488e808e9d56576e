// Grouped expert matmul, out[e] = x[e] @ w[e], for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/moe_gmm.py::moe_gmm (body
// _gmm_kernel): x (E, C, K), w (E, K, F) -> out (E, C, F), all in float32
// or all in bfloat16. The sum over K is float32 and is rounded to x's
// type once, as the TPU kernel's float32 VMEM accumulator and the plain
// version (kernels/ref.py::moe_gmm) do. C, the expert capacity, is any
// integer (ragged); K and F are multiples of 8.
//
// Bound on an H100 SXM, at the shapes serving granite-moe-3b-a800m gives
// it (E = 40 experts, d = 1536, expert hidden 512, bf16):
//   * a decode tick (8 slots, capacity 8): 0.5 GFLOP against 62.9 MB of
//     weights per call, so bytes: 18.8 us at 3.35 TB/s. Every weight
//     element is read from device memory once per call: a block takes
//     all C <= 64 rows of its expert, and the rows of a C tile with no
//     capacity row skip their arithmetic;
//   * a 2048-token prefill (capacity 512): 32.2 GFLOP (32.6 us at 989
//     TFLOP/s on the tensor cores) against 146.8 MB (43.8 us), so bytes
//     again, at about 44 us.
//
// The design is the simple one that is right first. The TPU kernel
// carries its K sum in VMEM scratch across a sequential grid dimension;
// here a loop inside the block takes that dimension's place:
//   * one block of 256 threads per (64-column F tile, 64-row C tile,
//     expert);
//   * the K loop stages 32-deep slices of x (transposed) and w through
//     shared memory as float32, each thread loading 16 bytes of each;
//     the next slice's loads are issued before the current slice's
//     arithmetic, so they are in flight while it runs;
//   * each thread keeps a 4 x 4 tile of float32 accumulators in
//     registers and adds k = 0, 1, ..., K-1 in that order with fmaf, so
//     a row's result depends on neither C nor the other rows (the port's
//     batch-independence invariant);
//   * the ragged C and F edges and a K tail are masked in the kernel:
//     loads past them read zeros, stores past them are skipped.
// Tensor cores (mma.sync, then wgmma with TMA), a skinny decode path and
// skipping experts that received no rows are later work.
#include "common.cuh"

namespace {

using repro_torch::from_float;
using repro_torch::load8;

constexpr int kBM = 64;    // rows of C per block
constexpr int kBN = 64;    // columns of F per block
constexpr int kBK = 32;    // depth of a shared-memory slice of K
constexpr int kThreads = 256;
constexpr int kPad = 4;    // keeps float4 reads aligned, spreads banks

template <typename T>
__device__ __forceinline__ void load_chunk(const T* p, bool ok, float* v) {
  if (ok) {
    load8(p, v);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gmm_tile(const T* __restrict__ x, const T* __restrict__ w,
             T* __restrict__ out, int C, int K, int F) {
  __shared__ __align__(16) float xs[kBK][kBM + kPad];  // xs[k][row]
  __shared__ __align__(16) float ws[kBK][kBN + kPad];  // ws[k][col]
  const int e = blockIdx.z;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  const T* xe = x + (long long)e * C * K;
  const T* we = w + (long long)e * K * F;

  // loads: thread t brings 8 consecutive k of row t / 4 of the x slice,
  // and 8 consecutive columns of k-row t / 8 of the w slice
  const int xr = threadIdx.x >> 2, xk = (threadIdx.x & 3) * 8;
  const int wk = threadIdx.x >> 3, wc = (threadIdx.x & 7) * 8;
  const bool x_row_ok = row0 + xr < C;
  const bool w_col_ok = col0 + wc < F;
  const T* xp = xe + (long long)(row0 + xr) * K + xk;
  const T* wp = we + (long long)wk * F + col0 + wc;

  // arithmetic: thread (ty, tx) owns rows ty*4.. and columns tx*4.. of
  // the tile; a warp holds two ty, so the rows past C skip as whole warps
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const bool has_rows = row0 + ty * 4 < C;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  float xv[8], wv[8];
  load_chunk(xp, x_row_ok && xk < K, xv);
  load_chunk(wp, w_col_ok && wk < K, wv);
  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < 8; ++i) xs[xk + i][xr] = xv[i];
    *reinterpret_cast<float4*>(&ws[wk][wc]) =
        make_float4(wv[0], wv[1], wv[2], wv[3]);
    *reinterpret_cast<float4*>(&ws[wk][wc + 4]) =
        make_float4(wv[4], wv[5], wv[6], wv[7]);
    __syncthreads();
    const int k1 = k0 + kBK;
    if (k1 < K) {   // the next slice, in flight during this one's FMAs
      load_chunk(xp + k1, x_row_ok && k1 + xk < K, xv);
      load_chunk(wp + (long long)k1 * F, w_col_ok && k1 + wk < K, wv);
    }
    if (has_rows) {
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  if (!has_rows) return;
  T* oe = out + (long long)e * C * F;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= C) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx * 4 + j;
      if (c < F) oe[(long long)r * F + c] = from_float<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, void* out, int E, int C, int K,
           int F, cudaStream_t stream) {
  const dim3 grid((unsigned int)((F + kBN - 1) / kBN),
                  (unsigned int)((C + kBM - 1) / kBM), (unsigned int)E);
  gmm_tile<T><<<grid, kThreads, 0, stream>>>((const T*)x, (const T*)w,
                                             (T*)out, C, K, F);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Launches on `stream` and returns
// cudaGetLastError(); 0 means launched. The caller (kernels/moe_gmm.py)
// has checked shapes (K % 8 == 0, F % 8 == 0), types, contiguity and
// 16-byte alignment.
extern "C" int moe_gmm_fwd(const void* x, const void* w, void* out,
                           int dtype, int E, int C, int K, int F,
                           void* stream) {
  if (E == 0 || C == 0 || F == 0) return 0;
  if (E > 65535 || (C + kBM - 1) / kBM > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(x, w, out, E, C, K, F, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, out, E, C, K, F, s);
  return (int)cudaErrorInvalidValue;
}

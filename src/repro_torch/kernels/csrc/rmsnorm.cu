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
// The design reads each row once and keeps it in registers:
//   * T threads take a row (a power of two, 32 to 256), the fewest that
//     hold it in at most 32 values a thread, K 16-byte vectors (4 in
//     bf16, 8 in float32): D 2560 takes 128 threads in either type, 1536
//     64 in bf16; 7168 takes 256 with 4 vectors in bf16 and 7 in
//     float32. A block of 256 threads takes 256 / T rows;
//   * thread t holds vectors t, t + T, ..., t + (K-1) T of its row, each
//     loaded by one 16-byte load and held as loaded (bf16 pairs stay
//     packed, 4 registers a vector), and scale's matching values by
//     float4 loads issued beside x's, before the sum; the output pass
//     reuses x from registers;
//   * the float32 sum of squares: each thread over its values in order,
//     then xor shuffles within the warp, then, where a row spans several
//     warps, the warps' sums added in warp order from shared memory;
//   * a row whose bytes are not a whole number of 16-byte vectors, or a
//     tensor not 16-byte aligned, takes the same kernel with scalar loads
//     (VEC = false): the same values in the same threads and the same
//     order, one element at a time.
// The order of the sum depends only on D, so a row's result does not
// depend on the row count: the 8 rows of a decode tick and the 2048 of a
// prefill give the same bits for the same row.
//
// The backward (training; the JAX package has no backward Pallas kernel
// and trains through XLA's derivative): with r = rsqrt(mean(x^2) + eps)
// recomputed from the row,
//   dx = r (dy s) - x r^3 mean(dy s x),   dscale = sum over rows dy x r,
// float32 inside, dx rounded once to x's type. rmsnorm_bwd_rows keeps the
// forward's layout (a row's values in its threads' registers, x and dy
// each read once) and reduces sum(x^2) and sum(dy s x) together; a block
// walks rows with a stride of the grid and sums each column's dy x r
// over its rows in registers, then over its row slots in shared memory
// in slot order, into one partial row. rmsnorm_bwd_scale adds the
// blocks' partial rows in block order. No float atomics: dscale has the
// same bits from run to run. The grid is at most kPartials blocks, so
// the caller's scratch holds kPartials partial rows. Bound: bytes, x, dy
// and dx once each (3 R D sizeof(T)) plus the partials; at 4096 x 1536
// bf16 37.7 MB, 11.3 us.
#include <stdint.h>

#include "common.cuh"

namespace {

using repro_torch::from_float;

constexpr int kBlock = 256;   // threads of a block
constexpr int kValues = 32;   // values a thread holds at most
constexpr int kPartials = 264;   // backward blocks at most: 2 an SM

template <typename T>
struct Vec {
  static constexpr int kN = 16 / sizeof(T);    // elements in 16 bytes
  static constexpr int kMaxK = kValues / kN;   // vectors a thread holds
};

template <typename T, bool VEC>
__device__ __forceinline__ void load_scale(const float* scale, int i,
                                           int limit, float (&s)[Vec<T>::kN]) {
  constexpr int n = Vec<T>::kN;
  if (VEC && i + n <= limit) {
#pragma unroll
    for (int e = 0; e < n; e += 4) {
      const float4 a = *reinterpret_cast<const float4*>(scale + i + e);
      s[e] = a.x; s[e + 1] = a.y; s[e + 2] = a.z; s[e + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < n; ++e) s[e] = i + e < limit ? scale[i + e] : 0.0f;
  }
}

template <typename T, bool VEC>
__device__ __forceinline__ void store_vec(T* row, int i, int limit,
                                          const float (&v)[Vec<T>::kN]) {
  constexpr int n = Vec<T>::kN;
  if (VEC && i + n <= limit) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(row + i) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      uint4 u;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        h[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
      *reinterpret_cast<uint4*>(row + i) = u;
    }
  } else {
#pragma unroll
    for (int e = 0; e < n; ++e)
      if (i + e < limit) row[i + e] = from_float<T>(v[e]);
  }
}

// The n values of one 16-byte vector as floats.
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[Vec<T>::kN]) {
  if constexpr (sizeof(T) == 4) {
    v[0] = __uint_as_float(u.x); v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z); v[3] = __uint_as_float(u.w);
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      v[2 * e] = f.x;
      v[2 * e + 1] = f.y;
    }
  }
}

// TPR threads a row, K vectors a thread; kBlock / TPR rows a block.
template <typename T, int K, bool VEC>
__global__ void __launch_bounds__(kBlock)
    rmsnorm_rows(const T* __restrict__ x, const float* __restrict__ scale,
                 T* __restrict__ out, long long rows, int D, int TPR,
                 float eps) {
  constexpr int n = Vec<T>::kN;
  __shared__ float warp_sums[kBlock / 32];
  const int rpb = kBlock / TPR;                      // rows a block
  const int local = threadIdx.x / TPR;
  const int t = threadIdx.x % TPR;
  const long long row = (long long)blockIdx.x * rpb + local;
  const bool live = row < rows;
  const T* xr = x + (live ? row : 0) * D;

  // x held as loaded, 16 bytes a vector (bf16 pairs stay packed), and
  // scale's matching values beside it, all loaded before the sum
  uint4 raw[K];
  float sc[K][n];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = (k * TPR + t) * n;
    const int limit = live ? D : 0;
    if (VEC && i + n <= limit) {
      raw[k] = *reinterpret_cast<const uint4*>(xr + i);
    } else {
      T* e = reinterpret_cast<T*>(&raw[k]);
#pragma unroll
      for (int j = 0; j < n; ++j)
        e[j] = i + j < limit ? xr[i + j] : from_float<T>(0.0f);
    }
    load_scale<T, VEC>(scale, i, limit, sc[k]);
  }
  float ss = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float v[n];
    unpack<T>(raw[k], v);
#pragma unroll
    for (int e = 0; e < n; ++e) ss = fmaf(v[e], v[e], ss);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (TPR > 32) {
    const int wpr = TPR / 32;                        // warps a row
    if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = ss;
    __syncthreads();
    const float* mine = warp_sums + local * wpr;
    ss = 0.0f;
    for (int w = 0; w < wpr; ++w) ss += mine[w];
  }
  if (!live) return;
  const float r = 1.0f / sqrtf(ss / (float)D + eps);
  T* outr = out + row * D;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float v[n];
    unpack<T>(raw[k], v);
#pragma unroll
    for (int e = 0; e < n; ++e) v[e] = v[e] * r * sc[k][e];
    store_vec<T, VEC>(outr, (k * TPR + t) * n, D, v);
  }
}

template <typename T, int K>
int launch_k(const T* x, const float* scale, T* out, long long rows, int D,
             int tpr, bool vec, float eps, cudaStream_t s) {
  const int rpb = kBlock / tpr;
  const long long blocks = (rows + rpb - 1) / rpb;
  if (vec)
    rmsnorm_rows<T, K, true><<<(unsigned int)blocks, kBlock, 0, s>>>(
        x, scale, out, rows, D, tpr, eps);
  else
    rmsnorm_rows<T, K, false><<<(unsigned int)blocks, kBlock, 0, s>>>(
        x, scale, out, rows, D, tpr, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* scale, void* out, long long rows,
           int D, float eps, cudaStream_t s) {
  constexpr int n = Vec<T>::kN;
  const int nvec = (D + n - 1) / n;
  constexpr int kMaxK = Vec<T>::kMaxK;
  int tpr = 32;
  while (tpr < kBlock && nvec > kMaxK * tpr) tpr *= 2;
  const int k = (nvec + tpr - 1) / tpr;
  if (k > kMaxK) return (int)cudaErrorInvalidValue;
  // 16-byte vectors need whole vectors per row and aligned tensors
  const bool vec = D % n == 0 &&
      ((uintptr_t)x | (uintptr_t)out | (uintptr_t)scale) % 16 == 0;
  const T* xt = (const T*)x;
  const float* sc = (const float*)scale;
  T* ot = (T*)out;
  switch (k) {
    case 1: return launch_k<T, 1>(xt, sc, ot, rows, D, tpr, vec, eps, s);
    case 2: return launch_k<T, 2>(xt, sc, ot, rows, D, tpr, vec, eps, s);
    case 3: return launch_k<T, 3>(xt, sc, ot, rows, D, tpr, vec, eps, s);
    case 4: return launch_k<T, 4>(xt, sc, ot, rows, D, tpr, vec, eps, s);
  }
  if constexpr (kMaxK > 4) {   // float32
    switch (k) {
      case 5: return launch_k<T, 5>(xt, sc, ot, rows, D, tpr, vec, eps, s);
      case 6: return launch_k<T, 6>(xt, sc, ot, rows, D, tpr, vec, eps, s);
      case 7: return launch_k<T, 7>(xt, sc, ot, rows, D, tpr, vec, eps, s);
      case 8: return launch_k<T, 8>(xt, sc, ot, rows, D, tpr, vec, eps, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// -- backward -----------------------------------------------------------------

// TPR threads a row, K vectors a thread, kBlock / TPR row slots a block;
// the block walks rows base + slot, base stepping by the grid's rows.
template <typename T, int K, bool VEC>
__global__ void __launch_bounds__(kBlock)
    rmsnorm_bwd_rows(const T* __restrict__ x, const float* __restrict__ scale,
                     const T* __restrict__ dy, T* __restrict__ dx,
                     float* __restrict__ partials, long long rows, int D,
                     int TPR, float eps) {
  constexpr int n = Vec<T>::kN;
  __shared__ float warp_sums[kBlock / 32][2];
  __shared__ float slots[kBlock * kValues];   // (row slots, D) column sums
  const int rpb = kBlock / TPR;
  const int local = threadIdx.x / TPR;
  const int t = threadIdx.x % TPR;
  const int wpr = TPR / 32;

  float sc[K][n], acc[K][n];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    load_scale<T, VEC>(scale, (k * TPR + t) * n, D, sc[k]);
#pragma unroll
    for (int e = 0; e < n; ++e) acc[k][e] = 0.0f;
  }

  for (long long base = (long long)blockIdx.x * rpb; base < rows;
       base += (long long)gridDim.x * rpb) {
    const long long row = base + local;
    const bool live = row < rows;
    const int limit = live ? D : 0;
    const T* xr = x + (live ? row : 0) * D;
    const T* dyr = dy + (live ? row : 0) * D;
    uint4 rx[K], rd[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = (k * TPR + t) * n;
      if (VEC && i + n <= limit) {
        rx[k] = *reinterpret_cast<const uint4*>(xr + i);
        rd[k] = *reinterpret_cast<const uint4*>(dyr + i);
      } else {
        T* ex = reinterpret_cast<T*>(&rx[k]);
        T* ed = reinterpret_cast<T*>(&rd[k]);
#pragma unroll
        for (int j = 0; j < n; ++j) {
          ex[j] = i + j < limit ? xr[i + j] : from_float<T>(0.0f);
          ed[j] = i + j < limit ? dyr[i + j] : from_float<T>(0.0f);
        }
      }
    }
    float ss = 0.0f, dot = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float xv[n], dv[n];
      unpack<T>(rx[k], xv);
      unpack<T>(rd[k], dv);
#pragma unroll
      for (int e = 0; e < n; ++e) {
        ss = fmaf(xv[e], xv[e], ss);
        dot = fmaf(dv[e] * sc[k][e], xv[e], dot);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
      dot += __shfl_xor_sync(0xffffffffu, dot, o);
    }
    if (TPR > 32) {
      __syncthreads();   // the previous row's warp sums are read
      if ((threadIdx.x & 31) == 0) {
        warp_sums[threadIdx.x >> 5][0] = ss;
        warp_sums[threadIdx.x >> 5][1] = dot;
      }
      __syncthreads();
      ss = dot = 0.0f;
      for (int w = 0; w < wpr; ++w) {
        ss += warp_sums[local * wpr + w][0];
        dot += warp_sums[local * wpr + w][1];
      }
    }
    if (!live) continue;
    const float r = 1.0f / sqrtf(ss / (float)D + eps);
    const float c = r * r * r * (dot / (float)D);
    T* dxr = dx + row * D;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float xv[n], dv[n], out[n];
      unpack<T>(rx[k], xv);
      unpack<T>(rd[k], dv);
#pragma unroll
      for (int e = 0; e < n; ++e) {
        out[e] = r * (dv[e] * sc[k][e]) - xv[e] * c;
        acc[k][e] = fmaf(dv[e] * xv[e], r, acc[k][e]);
      }
      store_vec<T, VEC>(dxr, (k * TPR + t) * n, D, out);
    }
  }

  // the block's row slots, added in slot order, into its partial row
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int e = 0; e < n; ++e) {
      const int i = (k * TPR + t) * n + e;
      if (i < D) slots[local * D + i] = acc[k][e];
    }
  __syncthreads();
  for (int i = threadIdx.x; i < D; i += kBlock) {
    float sum = 0.0f;
    for (int l = 0; l < rpb; ++l) sum += slots[l * D + i];
    partials[(long long)blockIdx.x * D + i] = sum;
  }
}

// dscale[i] = the blocks' partial rows at column i, added in block order.
__global__ void __launch_bounds__(kBlock)
    rmsnorm_bwd_scale(const float* __restrict__ partials,
                      float* __restrict__ dscale, int blocks, int D) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= D) return;
  float sum = 0.0f;
  for (int b = 0; b < blocks; ++b) sum += partials[(long long)b * D + i];
  dscale[i] = sum;
}

template <typename T, int K>
int launch_bwd_k(const T* x, const float* scale, const T* dy, T* dx,
                 float* partials, float* dscale, long long rows, int D,
                 int tpr, bool vec, float eps, cudaStream_t s) {
  const int rpb = kBlock / tpr;
  const long long need = (rows + rpb - 1) / rpb;
  const int blocks = (int)(need < kPartials ? need : kPartials);
  if (vec)
    rmsnorm_bwd_rows<T, K, true><<<blocks, kBlock, 0, s>>>(
        x, scale, dy, dx, partials, rows, D, tpr, eps);
  else
    rmsnorm_bwd_rows<T, K, false><<<blocks, kBlock, 0, s>>>(
        x, scale, dy, dx, partials, rows, D, tpr, eps);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rmsnorm_bwd_scale<<<(D + kBlock - 1) / kBlock, kBlock, 0, s>>>(
      partials, dscale, blocks, D);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* scale, const void* dy, void* dx,
               void* partials, void* dscale, long long rows, int D, float eps,
               cudaStream_t s) {
  constexpr int n = Vec<T>::kN;
  const int nvec = (D + n - 1) / n;
  constexpr int kMaxK = Vec<T>::kMaxK;
  int tpr = 32;
  while (tpr < kBlock && nvec > kMaxK * tpr) tpr *= 2;
  const int k = (nvec + tpr - 1) / tpr;
  if (k > kMaxK) return (int)cudaErrorInvalidValue;
  const bool vec = D % n == 0 &&
      ((uintptr_t)x | (uintptr_t)dy | (uintptr_t)dx | (uintptr_t)scale) % 16 == 0;
  const T* xt = (const T*)x;
  const T* dyt = (const T*)dy;
  const float* sc = (const float*)scale;
  T* dxt = (T*)dx;
  float* pt = (float*)partials;
  float* ds = (float*)dscale;
  switch (k) {
    case 1: return launch_bwd_k<T, 1>(xt, sc, dyt, dxt, pt, ds, rows, D, tpr, vec, eps, s);
    case 2: return launch_bwd_k<T, 2>(xt, sc, dyt, dxt, pt, ds, rows, D, tpr, vec, eps, s);
    case 3: return launch_bwd_k<T, 3>(xt, sc, dyt, dxt, pt, ds, rows, D, tpr, vec, eps, s);
    case 4: return launch_bwd_k<T, 4>(xt, sc, dyt, dxt, pt, ds, rows, D, tpr, vec, eps, s);
  }
  if constexpr (kMaxK > 4) {   // float32
    switch (k) {
      case 5: return launch_bwd_k<T, 5>(xt, sc, dyt, dxt, pt, ds, rows, D, tpr, vec, eps, s);
      case 6: return launch_bwd_k<T, 6>(xt, sc, dyt, dxt, pt, ds, rows, D, tpr, vec, eps, s);
      case 7: return launch_bwd_k<T, 7>(xt, sc, dyt, dxt, pt, ds, rows, D, tpr, vec, eps, s);
      case 8: return launch_bwd_k<T, 8>(xt, sc, dyt, dxt, pt, ds, rows, D, tpr, vec, eps, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Launches on `stream` and returns
// cudaGetLastError(); 0 means launched. The caller (kernels/rmsnorm.py)
// has checked shapes, types and contiguity, and that D is at most 8192.
extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* out,
                           int dtype, long long rows, int D, float eps,
                           void* stream) {
  if (rows == 0 || D == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(x, scale, out, rows, D, eps, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, scale, out, rows, D, eps, s);
  return (int)cudaErrorInvalidValue;
}

// The backward: dx (rows, D) in x's type and dscale (D,) float32 from x,
// scale and dy; partials is (kPartials = 264, D) float32 scratch. Two
// launches on `stream`; returns cudaGetLastError(), 0 when both
// launched. The caller has checked what rmsnorm_fwd's caller checks, for
// dy and dx too.
extern "C" int rmsnorm_bwd(const void* x, const void* scale, const void* dy,
                           void* dx, void* partials, void* dscale, int dtype,
                           long long rows, int D, float eps, void* stream) {
  if (D == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (rows == 0) return (int)cudaMemsetAsync(dscale, 0, (size_t)D * 4, s);
  if (dtype == 0)
    return launch_bwd<float>(x, scale, dy, dx, partials, dscale, rows, D, eps,
                             s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(x, scale, dy, dx, partials, dscale, rows,
                                     D, eps, s);
  return (int)cudaErrorInvalidValue;
}

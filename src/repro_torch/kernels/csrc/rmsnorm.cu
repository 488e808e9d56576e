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
// float32 inside, dx rounded once to x's type. Bound: bytes, x and dy
// read once and dx written once (3 R D sizeof(T), plus scale and dscale);
// the partial rows below are the design's overhead, not the function's
// work. At 4096 x 1536 bf16 37.7 MB, 11.3 us.
//
// rmsnorm_bwd_kernel is one cooperative launch whose grid is the blocks
// the card holds at once (occupancy x SMs: one block an SM where a
// thread's registers pass 128), or fewer, so that every block takes the
// same number of row groups give or take one:
//   * rows: the forward's layout (T threads a row, K vectors a thread;
//     row groups of 256 / T rows), sum(x^2) and sum(dy s x) reduced
//     together in the forward's order, dx's per-row arithmetic in a fixed
//     order, so a row's dx does not depend on the row count. Block b
//     takes a fixed range of row groups, worked out from (rows, D, grid);
//   * prefetch: each thread loads its vectors of the next row groups'
//     x and dy into registers (16-byte loads; two groups ahead where a
//     thread holds at most 20 values a row, else one) before it reduces
//     the current group, so every warp keeps loads in flight and its
//     first rows land after one memory latency. A thread holds
//     scale and its column sums in registers, except float32 at K 7 and
//     8, which read scale from shared memory. No thread spills at any K
//     (launch bounds of one block an SM). A tensor or row that is not
//     16-byte aligned takes the same kernel with scalar loads and stores
//     (VEC = false): the same values in the same threads and order;
//   * dscale, inside the launch and in a fixed order: each row slot sums
//     dy x r over its rows in registers; the block adds its slots in slot
//     order into one partial row (grid x D floats of scratch); a
//     grid-wide barrier (cooperative_groups); then every block sums
//     slices of 8 columns over all partial rows: 32 splits of the rows
//     (split p takes rows p, p + 32, ... in order), added by xor shuffles
//     and then warp by warp. No float atomics and no counter: the bits
//     depend on (rows, D, type, grid) only, and the grid on the card.
#include <cooperative_groups.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

#include "common.cuh"

namespace {

using repro_torch::from_float;

constexpr int kBlock = 256;   // threads of a block
constexpr int kValues = 32;   // values a thread holds at most

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

// dscale's column sums across the grid: a slice of kSlice columns is
// summed by the whole block, its partial rows split kSplits ways (lanes
// 8 apart, then the block's 8 warps), each split's rows loaded kBatch at
// a time; a block takes kRound slices between two barriers.
constexpr int kSlice = 8;
constexpr int kSplits = kBlock / kSlice;
constexpr int kBatch = 16;
constexpr int kRound = 8;
// dynamic shared memory at most: the row slots' column sums (256 / T
// rows of D, at most 8192 floats) and scale (8192 floats)
constexpr int kMaxSmem = 2 * 8192 * 4;

// What a thread keeps in registers at K vectors: how many row groups it
// has loaded ahead of the one it reduces (two where it holds at most 20
// values a row: bf16 up to K 2, float32 up to K 5; more loads in flight
// there were faster, elsewhere slower), and whether scale is read from
// shared memory instead of held (float32 at K 7 and 8, where x, dy, scale
// and the column sums would not fit twice).
template <typename T, int K>
struct BwdRegs {
  static constexpr bool kSharedScale = sizeof(T) == 4 && K >= 7;
  static constexpr int kAhead = K * Vec<T>::kN <= 20 ? 2 : 1;
};

// One cooperative launch. Rows: TPR threads a row, K vectors a thread,
// kBlock / TPR row slots a block; block b takes the row groups [G b /
// grid, G (b + 1) / grid) of the G groups, each group's x and dy loaded
// kAhead groups before it is reduced. Then dscale: each block's partial
// row, a grid-wide barrier, every block sums column slices.
template <typename T, int K, bool VEC>
__global__ void __launch_bounds__(kBlock, 1)
    rmsnorm_bwd_kernel(const T* __restrict__ x,
                       const float* __restrict__ scale,
                       const T* __restrict__ dy, T* __restrict__ dx,
                       float* __restrict__ partials,
                       float* __restrict__ dscale, long long rows, int D,
                       int TPR, float eps) {
  constexpr int n = Vec<T>::kN;
  constexpr int kAhead = BwdRegs<T, K>::kAhead;
  constexpr bool kSharedScale = BwdRegs<T, K>::kSharedScale;
  extern __shared__ __align__(16) float smem[];   // row slots, then scale
  __shared__ float warp_sums[2][kBlock / 32][2];
  __shared__ float col_sums[kRound][kBlock / 32][kSlice];
  const int rpb = kBlock / TPR;
  const int local = threadIdx.x / TPR;
  const int t = threadIdx.x % TPR;
  const int wpr = TPR / 32;
  const long long groups = (rows + rpb - 1) / rpb;
  const long long g0 = groups * blockIdx.x / gridDim.x;
  const long long count = groups * (blockIdx.x + 1) / gridDim.x - g0;

  // group g0 + j's x and dy, held as loaded (bf16 pairs packed), zeros
  // past the rows
  auto load = [&](long long j, uint4 (&rx)[K], uint4 (&rd)[K]) {
    const long long row = (g0 + j) * rpb + local;
    const int limit = row < rows ? D : 0;
    const T* xr = x + (row < rows ? row : 0) * D;
    const T* dyr = dy + (row < rows ? row : 0) * D;
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
        for (int q = 0; q < n; ++q) {
          ex[q] = i + q < limit ? xr[i + q] : from_float<T>(0.0f);
          ed[q] = i + q < limit ? dyr[i + q] : from_float<T>(0.0f);
        }
      }
    }
  };
  // buffer 0: the group being reduced; 1..kAhead: the ones after it
  uint4 bx[kAhead + 1][K], bd[kAhead + 1][K];
#pragma unroll
  for (int a = 0; a < kAhead; ++a)
    if (a < count) load(a, bx[a], bd[a]);

  float* s_scale = smem + rpb * D;
  float sc[kSharedScale ? 1 : K][n], acc[K][n];
  if constexpr (kSharedScale) {
    for (int i = threadIdx.x; i < D; i += kBlock) s_scale[i] = scale[i];
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if constexpr (!kSharedScale)
      load_scale<T, VEC>(scale, (k * TPR + t) * n, D, sc[k]);
#pragma unroll
    for (int e = 0; e < n; ++e) acc[k][e] = 0.0f;
  }
  // scale's values of vector k: held, or read from shared memory
  auto scale_of = [&](int k, float (&v)[n]) {
    if constexpr (kSharedScale) {
      load_scale<T, VEC>(s_scale, (k * TPR + t) * n, D, v);
    } else {
#pragma unroll
      for (int e = 0; e < n; ++e) v[e] = sc[k][e];
    }
  };

  for (long long j = 0; j < count; ++j) {
    if (j + kAhead < count) load(j + kAhead, bx[kAhead], bd[kAhead]);
    const long long row = (g0 + j) * rpb + local;
    float ss = 0.0f, dot = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float xv[n], dv[n], sv[n];
      unpack<T>(bx[0][k], xv);
      unpack<T>(bd[0][k], dv);
      scale_of(k, sv);
#pragma unroll
      for (int e = 0; e < n; ++e) {
        ss = fmaf(xv[e], xv[e], ss);
        dot = fmaf(dv[e] * sv[e], xv[e], dot);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
      dot += __shfl_xor_sync(0xffffffffu, dot, o);
    }
    if (TPR > 32) {   // two buffers: group j - 1's reads end before j's barrier
      float (*ws)[2] = warp_sums[j & 1];
      if ((threadIdx.x & 31) == 0) {
        ws[threadIdx.x >> 5][0] = ss;
        ws[threadIdx.x >> 5][1] = dot;
      }
      __syncthreads();
      ss = dot = 0.0f;
      for (int w = 0; w < wpr; ++w) {
        ss += ws[local * wpr + w][0];
        dot += ws[local * wpr + w][1];
      }
    }
    if (row < rows) {
      const float r = 1.0f / sqrtf(ss / (float)D + eps);
      const float c = r * r * r * (dot / (float)D);
      T* dxr = dx + row * D;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float xv[n], dv[n], sv[n], out[n];
        unpack<T>(bx[0][k], xv);
        unpack<T>(bd[0][k], dv);
        scale_of(k, sv);
#pragma unroll
        for (int e = 0; e < n; ++e) {
          out[e] = r * (dv[e] * sv[e]) - xv[e] * c;
          acc[k][e] = fmaf(dv[e] * xv[e], r, acc[k][e]);
        }
        store_vec<T, VEC>(dxr, (k * TPR + t) * n, D, out);
      }
    }
#pragma unroll
    for (int a = 0; a < kAhead; ++a)
#pragma unroll
      for (int k = 0; k < K; ++k) {
        bx[a][k] = bx[a + 1][k];
        bd[a][k] = bd[a + 1][k];
      }
  }

  // the block's row slots, added in slot order, into its partial row (with
  // one block, into dscale). A thread's n columns go out as float4s (VEC),
  // which keeps shared memory's banks apart.
  float* mine = gridDim.x == 1 ? dscale : partials + (long long)blockIdx.x * D;
  float* dst = rpb == 1 ? mine : smem + local * D;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = (k * TPR + t) * n;
    if (VEC && i + n <= D) {
#pragma unroll
      for (int e = 0; e < n; e += 4)
        *reinterpret_cast<float4*>(dst + i + e) =
            make_float4(acc[k][e], acc[k][e + 1], acc[k][e + 2],
                        acc[k][e + 3]);
    } else {
#pragma unroll
      for (int e = 0; e < n; ++e)
        if (i + e < D) dst[i + e] = acc[k][e];
    }
  }
  if (rpb > 1) {
    __syncthreads();
    for (int i = threadIdx.x; i < D; i += kBlock) {
      float sum = 0.0f;
      for (int l = 0; l < rpb; ++l) sum += smem[l * D + i];
      mine[i] = sum;
    }
  }
  if (gridDim.x == 1) return;
  cooperative_groups::this_grid().sync();

  // dscale[c]: the grid's partial rows at column c, in a fixed tree. Split
  // p = tid / kSlice adds rows p, p + 32, ... in order (loaded kBatch at a
  // time, then added); lanes 8 and 16 apart add theirs (xor shuffles);
  // warp 0's sums, then warp 1's, ...
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = lane % kSlice, split = threadIdx.x / kSlice;
  const int grid = gridDim.x;
  const int slices = (D + kSlice - 1) / kSlice;
  for (int first = blockIdx.x; first < slices; first += grid * kRound) {
    float sum[kRound];
#pragma unroll
    for (int m = 0; m < kRound; ++m) sum[m] = 0.0f;
    for (int m = 0; m < kRound; ++m) {
      const int c = (first + m * grid) * kSlice + col;
      if (c >= D) break;
      for (int b0 = split; b0 < grid; b0 += kBatch * kSplits) {
        float v[kBatch];
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          const int b = b0 + q * kSplits;
          v[q] = b < grid ? __ldcg(partials + (long long)b * D + c) : 0.0f;
        }
#pragma unroll
        for (int q = 0; q < kBatch; ++q)
          if (b0 + q * kSplits < grid) sum[m] += v[q];
      }
    }
#pragma unroll
    for (int m = 0; m < kRound; ++m) {
      sum[m] += __shfl_xor_sync(0xffffffffu, sum[m], 8);
      sum[m] += __shfl_xor_sync(0xffffffffu, sum[m], 16);
      if (lane < kSlice) col_sums[m][warp][lane] = sum[m];
    }
    __syncthreads();
    if (threadIdx.x < kRound * kSlice) {
      const int m = threadIdx.x / kSlice, cc = threadIdx.x % kSlice;
      const int c = (first + m * grid) * kSlice + cc;
      if (c < D) {
        float total = 0.0f;
        for (int w = 0; w < kBlock / 32; ++w) total += col_sums[m][w][cc];
        dscale[c] = total;
      }
    }
    __syncthreads();
  }
}

// What one backward call takes: its tensors and shape, its threads a row,
// and the dynamic shared memory of its kernel. `partial_rows` set: only
// report the scratch rows it needs.
struct Bwd {
  const void* x;
  const void* scale;
  const void* dy;
  void* dx;
  void* partials;
  void* dscale;
  long long rows;
  int D, tpr;
  float eps;
  cudaStream_t stream;
  int* partial_rows;
};

// Blocks of `fn` an SM holds with `smem` bytes of dynamic shared memory,
// times the SMs of the current device; computed once a kernel, device and
// size (the first call also lifts the kernel's shared memory limit).
int resident_blocks(const void* fn, int smem, int* blocks) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int>, int> cache;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const auto key = std::make_tuple(fn, dev, smem);
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *blocks = hit->second;
    return 0;
  }
  int per_sm = 0, sms = 0;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxSmem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kBlock,
                                                      smem);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *blocks = cache[key] = per_sm * sms;
  return 0;
}

// The grid: as many blocks as the card holds at once, or fewer, so that
// every block takes the same number of row groups, give or take one.
template <typename T, int K, bool VEC>
int run_bwd(const Bwd& a) {
  auto fn = rmsnorm_bwd_kernel<T, K, VEC>;
  const int rpb = kBlock / a.tpr;
  const int smem =
      (rpb + (BwdRegs<T, K>::kSharedScale ? 1 : 0)) * a.D * (int)sizeof(float);
  int resident = 0;
  const int e = resident_blocks((const void*)fn, smem, &resident);
  if (e) return e;
  const long long groups = (a.rows + rpb - 1) / rpb;
  const long long rounds = (groups + resident - 1) / resident;
  const int grid = (int)((groups + rounds - 1) / rounds);
  if (a.partial_rows) {
    *a.partial_rows = grid > 1 ? grid : 0;
    return 0;
  }
  const T* x = (const T*)a.x;
  const float* scale = (const float*)a.scale;
  const T* dy = (const T*)a.dy;
  T* dx = (T*)a.dx;
  float* partials = (float*)a.partials;
  float* dscale = (float*)a.dscale;
  long long rows = a.rows;
  int D = a.D, tpr = a.tpr;
  float eps = a.eps;
  void* args[] = {&x, &scale, &dy, &dx, &partials, &dscale,
                  &rows, &D, &tpr, &eps};
  return (int)cudaLaunchCooperativeKernel((const void*)fn, dim3(grid),
                                          dim3(kBlock), args, smem,
                                          a.stream);
}

template <typename T, int K>
int run_bwd_k(const Bwd& a, bool vec) {
  return vec ? run_bwd<T, K, true>(a) : run_bwd<T, K, false>(a);
}

template <typename T>
int launch_bwd(Bwd a) {
  constexpr int n = Vec<T>::kN;
  const int nvec = (a.D + n - 1) / n;
  constexpr int kMaxK = Vec<T>::kMaxK;
  int tpr = 32;
  while (tpr < kBlock && nvec > kMaxK * tpr) tpr *= 2;
  const int k = (nvec + tpr - 1) / tpr;
  if (k > kMaxK) return (int)cudaErrorInvalidValue;
  const bool vec = a.D % n == 0 &&
      ((uintptr_t)a.x | (uintptr_t)a.dy | (uintptr_t)a.dx |
       (uintptr_t)a.scale) % 16 == 0;
  a.tpr = tpr;
  switch (k) {
    case 1: return run_bwd_k<T, 1>(a, vec);
    case 2: return run_bwd_k<T, 2>(a, vec);
    case 3: return run_bwd_k<T, 3>(a, vec);
    case 4: return run_bwd_k<T, 4>(a, vec);
  }
  if constexpr (kMaxK > 4) {   // float32
    switch (k) {
      case 5: return run_bwd_k<T, 5>(a, vec);
      case 6: return run_bwd_k<T, 6>(a, vec);
      case 7: return run_bwd_k<T, 7>(a, vec);
      case 8: return run_bwd_k<T, 8>(a, vec);
    }
  }
  return (int)cudaErrorInvalidValue;
}

int dispatch_bwd(const Bwd& a, int dtype) {
  if (dtype == 0) return launch_bwd<float>(a);
  if (dtype == 1) return launch_bwd<__nv_bfloat16>(a);
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

// The rows of float32 scratch (each D wide) that rmsnorm_bwd needs with
// these tensors on the current device: the grid's blocks, or 0 when one
// block does it all. A negative value is a CUDA error, negated.
extern "C" int rmsnorm_bwd_partials(const void* x, const void* scale,
                                    const void* dy, const void* dx, int dtype,
                                    long long rows, int D) {
  if (rows == 0 || D == 0) return 0;
  int need = 0;
  const Bwd a{x,    scale, dy,   (void*)dx, nullptr, nullptr,
              rows, D,     0,    0.0f,      nullptr, &need};
  const int e = dispatch_bwd(a, dtype);
  return e ? -e : need;
}

// The backward: dx (rows, D) in x's type and dscale (D,) float32 from x,
// scale and dy, by one cooperative launch on `stream`; partials holds
// rmsnorm_bwd_partials(...) rows of D floats. Returns the launch's CUDA
// error, 0 when launched. The caller has checked what rmsnorm_fwd's
// caller checks, for dy and dx too.
extern "C" int rmsnorm_bwd(const void* x, const void* scale, const void* dy,
                           void* dx, void* partials, void* dscale, int dtype,
                           long long rows, int D, float eps, void* stream) {
  if (D == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (rows == 0) return (int)cudaMemsetAsync(dscale, 0, (size_t)D * 4, s);
  const Bwd a{x, scale, dy, dx, partials, dscale, rows, D, 0, eps, s, nullptr};
  return dispatch_bwd(a, dtype);
}

// AdamW's update of every parameter of a model in one launch, for sm_90a.
//
// Replaces no Pallas kernel: the JAX package's update
// (repro/train/optimizer.py::apply_updates) is elementwise jnp code that
// XLA fuses. The port ran it as an eager loop, about 18 kernels a
// parameter, each reading or writing whole float32 tensors; that loop is
// now the plain version, kernels/ref.py::adamw_update, and this kernel
// gives its bits.
//
// Each element, in the loop's float32 operations and order (scale: the
// clip factor; b1c, b2c: the bias corrections; p in its own type, g in
// p's type, m and v float32):
//   g = grad * scale
//   m = m * b1 + (1 - b1) * g
//   v = v * b2 + (1 - b2) * (g * g)
//   delta = (m / b1c) / (sqrt(v / b2c) + eps)
//   delta = delta + wd * p                  (a parameter that decays)
//   p = p - lr * delta, rounded once to p's type, to nearest even
// every step written with the _rn intrinsics: the build's flags leave
// -fmad=true, and a contracted multiply-add would change the bits. The
// divisions are true divisions, as the loop's are (its divisors are
// tensors on the card; PyTorch takes a reciprocal only for a divisor on
// the host). The Python floats b1, 1 - b1, b2, 1 - b2, eps and wd come
// rounded to float32 as PyTorch rounds a scalar for a float32 tensor;
// lr, b1c and b2c by value, from the same float32 host scalars the loop
// copied to the card; scale through a pointer, as the global norm left
// it on the card.
//
// Bound on an H100 SXM: bytes. About 17 operations an element against 28
// bytes (float32 p: p, g, m and v read, p, m and v written; 22 in bf16),
// far below the 295 operations a byte at which compute would bind:
// h2o-danube-1.8b's 1.83 G float32 parameters move 51 GB, 15.3 ms at
// 3.35 TB/s; granite-moe-3b-a800m's 3.30 G 92 GB, 27.6 ms.
//
// Design:
//   * one launch for every tensor: a table of one 64-byte row a tensor
//     (its four addresses, size, first chunk and flags), built by the
//     wrapper in pinned memory and copied ahead on the launch's stream;
//   * each tensor cut into chunks of `chunk` elements (a multiple of 8);
//     a persistent grid (the blocks the card holds at once) takes the
//     chunks of all tensors in turn, block b chunks b, b + grid, ...,
//     finding each chunk's tensor by walking the table forward, so a
//     few hundred small tensors (norm scales, routers) cost a chunk each
//     and no launch;
//   * 256 threads a block, 8 consecutive elements a thread: 16-byte
//     loads and stores (two a float32 array, one a bf16 one), so each
//     element is read once and written once and no temporary reaches
//     device memory. A chunk's last elements that make no whole vector,
//     and every element of a tensor not 16-byte aligned, take the same
//     arithmetic one at a time;
//   * no atomics and no reduction: an element's bits depend on its own
//     inputs alone, not on the chunking, the grid or the batch.
#include <stdint.h>

#include <mutex>

#include "common.cuh"

namespace {

using repro_torch::from_float;
using repro_torch::load8;
using repro_torch::to_float;

constexpr int kBlock = 256;
constexpr int kVec = 8;
constexpr int kMaxDevices = 64;

// A tensor's row of the table (kernels/adamw.py writes it as 8 int64).
struct Row {
  long long p, g, m, v;  // addresses
  long long n;           // elements
  long long first;       // its first chunk among all the tensors' chunks
  long long flags;       // kDecay | kAligned | kBf16
  long long unused;
};
constexpr long long kDecay = 1;    // takes the decoupled decay
constexpr long long kAligned = 2;  // p, g, m and v 16-byte aligned
constexpr long long kBf16 = 4;     // p and g bfloat16 (else float32)

struct Scalars {
  float b1, omb1, b2, omb2, eps, wd, lr, b1c, b2c;
};

// One element: the loop's operations in the loop's order; m and v in
// place, the new parameter returned in float32.
__device__ __forceinline__ float update(float p, float g, float& m, float& v,
                                        float scale, const Scalars& s,
                                        bool decay) {
  g = __fmul_rn(g, scale);
  m = __fadd_rn(__fmul_rn(m, s.b1), __fmul_rn(s.omb1, g));
  v = __fadd_rn(__fmul_rn(v, s.b2), __fmul_rn(s.omb2, __fmul_rn(g, g)));
  float delta = __fdiv_rn(__fdiv_rn(m, s.b1c),
                          __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.b2c)), s.eps));
  if (decay) delta = __fadd_rn(delta, __fmul_rn(s.wd, p));
  return __fsub_rn(p, __fmul_rn(s.lr, delta));
}

__device__ __forceinline__ void store8(float* p, const float* o) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(o[4], o[5], o[6], o[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* o) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(o[2 * i], o[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// Elements [lo, hi) of one tensor, by the block's threads.
template <typename T>
__device__ __forceinline__ void update_range(const Row& r, long long lo,
                                             long long hi, float scale,
                                             const Scalars& s) {
  T* p = reinterpret_cast<T*>(r.p);
  const T* g = reinterpret_cast<const T*>(r.g);
  float* m = reinterpret_cast<float*>(r.m);
  float* v = reinterpret_cast<float*>(r.v);
  const bool decay = (r.flags & kDecay) != 0;
  // lo is a multiple of 8, so in an aligned tensor every vector is too
  const long long mid =
      (r.flags & kAligned) ? lo + (hi - lo) / kVec * kVec : lo;
  for (long long i = lo + (long long)threadIdx.x * kVec; i < mid;
       i += (long long)kBlock * kVec) {
    float pv[kVec], gv[kVec], mv[kVec], vv[kVec];
    load8(p + i, pv);
    load8(g + i, gv);
    load8(m + i, mv);
    load8(v + i, vv);
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      pv[k] = update(pv[k], gv[k], mv[k], vv[k], scale, s, decay);
    store8(p + i, pv);
    store8(m + i, mv);
    store8(v + i, vv);
  }
  for (long long i = mid + threadIdx.x; i < hi; i += kBlock) {
    float mi = m[i], vi = v[i];
    const float pi =
        update(to_float(p[i]), to_float(g[i]), mi, vi, scale, s, decay);
    p[i] = from_float<T>(pi);
    m[i] = mi;
    v[i] = vi;
  }
}

__global__ void __launch_bounds__(kBlock)
    adamw_kernel(const Row* __restrict__ table, int tensors, long long chunks,
                 long long chunk, const float* __restrict__ scale_ptr,
                 Scalars s) {
  const float scale = *scale_ptr;
  int t = 0;
  for (long long c = blockIdx.x; c < chunks; c += gridDim.x) {
    // chunks only grow, so the tensor that holds c is t or a later one;
    // an empty tensor shares its first chunk with the next and is passed
    while (t + 1 < tensors && table[t + 1].first <= c) ++t;
    const Row r = table[t];
    const long long lo = (c - r.first) * chunk;
    const long long hi = lo + chunk < r.n ? lo + chunk : r.n;
    if (r.flags & kBf16)
      update_range<__nv_bfloat16>(r, lo, hi, scale, s);
    else
      update_range<float>(r, lo, hi, scale, s);
  }
}

// The blocks the current device holds at once (occupancy x SMs), found
// once a device.
int resident_blocks(int* blocks) {
  static std::mutex mu;
  static int cache[kMaxDevices] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (cache[dev] == 0) {
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, adamw_kernel,
                                                      kBlock, 0);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    cache[dev] = per_sm * sms;
  }
  *blocks = cache[dev];
  return 0;
}

}  // namespace

// The update of `tensors` tensors whose rows `table` holds on the card
// (their chunks numbered 0 .. chunks - 1 in table order), scale a float32
// on the card, on `stream`. Returns the launch's CUDA error, 0 when
// launched (or when there is nothing to update).
extern "C" int adamw_update(const void* table, int tensors, long long chunks,
                            long long chunk, const void* scale, float b1,
                            float omb1, float b2, float omb2, float eps,
                            float wd, float lr, float b1c, float b2c,
                            void* stream) {
  if (chunks == 0) return 0;
  if (tensors < 1 || chunk < kVec || chunk % kVec)
    return (int)cudaErrorInvalidValue;
  int blocks = 0;
  const int e = resident_blocks(&blocks);
  if (e) return e;
  const int grid = (int)(chunks < blocks ? chunks : blocks);
  const Scalars s{b1, omb1, b2, omb2, eps, wd, lr, b1c, b2c};
  adamw_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      (const Row*)table, tensors, chunks, chunk, (const float*)scale, s);
  return (int)cudaGetLastError();
}

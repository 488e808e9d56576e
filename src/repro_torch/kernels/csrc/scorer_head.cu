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
// The order of summation, which fixes the bits (the same as the first
// version of this kernel): a dense unit's sum is one float32
// accumulator, fmaf over k = 0, 1, ..., feat - 1 in order, then + bd and
// relu; a head output is one accumulator, fmaf over the dense units in
// order, then + bh.
//
// Bound on an H100 SXM: at M 1024, feat 512, dense 64 it reads 2.2 MB
// (0.66 us at 3.35 TB/s) and does 67 MFLOP on the CUDA cores (1.0 us at
// 67 TFLOP/s of float32). The fixed order keeps it from that bound: no
// sum may be split over k, so each output is a chain of feat dependent
// FMAs, and each FMA takes an operand from shared memory that a thread
// can reuse only for the few outputs it holds. The design spreads the
// chains over the card:
//   * the dense units are split over the blocks of a thread block
//     cluster, 16 units (4 column quads) a block, 32 rows of h a block,
//     so a block copies only its 16 columns of Wd (32 KB at feat 512)
//     and M 1024 at dense 64 takes 128 blocks;
//   * a thread holds R rows x 4 consecutive dense units: one 16-byte
//     shared load of Wd feeds 4 R FMAs, one of h 16. R is 2 once the grid
//     has a block for every SM (shared-memory traffic then bounds it, and
//     the second row halves Wd's), 1 below (more warps hide latency);
//   * the loads of the next 4 k are issued before the FMAs of these 4 (a
//     warp issues in order), in two register sets used in turn;
//   * h's rows and Wd's columns come into shared memory in 128-deep
//     k-chunks by 16-byte cp.async (4-byte where feat or dense is no
//     multiple of 4) through a ring of 4 stages: chunks c+1 .. c+3 are in
//     flight while chunk c is summed (all of feat 512 from the start);
//   * after the dense layer each block keeps its relu(h Wd + bd) units in
//     shared memory; the cluster's first block reads the others' units
//     through distributed shared memory and sums the two head outputs of
//     its rows.
//
// The grouped form (scorer_head_grouped_f32) stands for the same two
// matmuls under jax.vmap in the JAX package's stacked superbatch: h (Q,
// M, feat) with each member's own Wd, bd, Wh, bh stacked on a leading
// axis, one launch for all Q members. The member is grid z, outside the
// cluster (whose blocks are the dense tiles along x); each block offsets
// its pointers by its member and then does what a block of the
// ungrouped launch does. R (rows a thread) is picked from one member's
// block count, so it does not change with Q, and member q's output is
// bit for bit the ungrouped kernel's on its own inputs.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kUnits = 16;                 // dense units of a block
constexpr int kQuads = kUnits / 4;
constexpr int kMaxDense = 64;
constexpr int kChunk = 128;                // k-depth of a stage
constexpr int kStages = 4;                 // chunks in the ring
constexpr int kLdH = kChunk + 4;           // padded h row in shared memory

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// `bytes` (4 or 16) from global to shared memory; zeros where !valid.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
  }
}

// acc[e] = fmaf(x, w[e], acc[e]) for the 4 units of a column quad
__device__ __forceinline__ void fma4(float (&acc)[4], float x, float4 w) {
  acc[0] = fmaf(x, w.x, acc[0]);
  acc[1] = fmaf(x, w.y, acc[1]);
  acc[2] = fmaf(x, w.z, acc[2]);
  acc[3] = fmaf(x, w.w, acc[3]);
}

constexpr int kRows = 32;                  // rows of h a block

__host__ __device__ constexpr int stage_floats() {
  return kRows * kLdH + kChunk * kUnits;
}
// R rows a thread: 4 quads x 32 / R row groups
template <int R>
__host__ __device__ constexpr int threads() {
  return kQuads * kRows / R;
}

// Block (x = dense tile of the cluster, y = row tile of 32 rows).
// VEC: feat and dense are multiples of 4 (16-byte copies).
template <int R, bool VEC>
__global__ void __launch_bounds__(threads<R>())
    dense_head(const float* __restrict__ h, const float* __restrict__ wd,
               const float* __restrict__ bd, const float* __restrict__ wh,
               const float* __restrict__ bh, float* __restrict__ out, int M,
               int feat, int dense) {
  constexpr int kThreads = threads<R>();
  constexpr int kRowGroups = kRows / R;
  extern __shared__ __align__(16) float smem[];
  __shared__ float hid[kRows][kUnits];
  __shared__ float bd_s[kMaxDense], wh_s[2 * kMaxDense];

  // the block's member (grid z): its slices of every array
  const long long m = blockIdx.z;
  h += m * M * feat;
  wd += m * feat * dense;
  bd += m * dense;
  wh += m * 2 * dense;
  bh += m * 2;
  out += m * 2 * M;

  cg::cluster_group cluster = cg::this_cluster();
  const int tile = blockIdx.x;               // = the block's cluster rank
  const int row0 = blockIdx.y * kRows;
  const int u0 = tile * kUnits;
  const int q = threadIdx.x % kQuads;
  const int rg = threadIdx.x / kQuads;

  auto load = [&](int c) {
    const int k0 = c * kChunk;
    float* h_s = smem + (c % kStages) * stage_floats();
    float* w_s = h_s + kRows * kLdH;
    if (k0 < feat) {
      const int kn = min(kChunk, feat - k0);
      constexpr int E = VEC ? 4 : 1;         // floats a copy
      for (int i = threadIdx.x; i < kRows * (kChunk / E); i += kThreads) {
        const int r = i / (kChunk / E), k = (i % (kChunk / E)) * E;
        const bool ok = row0 + r < M && k < kn;
        cp_async<4 * E>(h_s + r * kLdH + k,
                        ok ? h + (long long)(row0 + r) * feat + k0 + k : h,
                        ok);
      }
      for (int i = threadIdx.x; i < kChunk * (kUnits / E); i += kThreads) {
        const int k = i / (kUnits / E), j = (i % (kUnits / E)) * E;
        const bool ok = k < kn && u0 + j < dense;
        cp_async<4 * E>(w_s + k * kUnits + j,
                        ok ? wd + (long long)(k0 + k) * dense + u0 + j : wd,
                        ok);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  float acc[R][4];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;

  const int n_chunks = (feat + kChunk - 1) / kChunk;
  for (int c = 0; c < kStages - 1; ++c) load(c);
  // the layers' small weights, read by every thread, while chunks fly
  for (int i = threadIdx.x; i < dense; i += kThreads) {
    bd_s[i] = bd[i];
    wh_s[2 * i] = wh[2 * i];
    wh_s[2 * i + 1] = wh[2 * i + 1];
  }
  for (int c = 0; c < n_chunks; ++c) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
    __syncthreads();             // chunk c is in; chunk c - 1 is summed
    load(c + kStages - 1);       // into chunk c - 1's stage
    const float* h_s = smem + (c % kStages) * stage_floats();
    const float* w_s = h_s + kRows * kLdH;
    const int kn = min(kChunk, feat - c * kChunk);
    // 4 k a step; the next step's shared loads are issued before this
    // step's FMAs (a warp issues in order), in two register sets used in
    // turn, so no copy between them
    const int k4n = kn & ~3;
    float4 ha[R], wa[4], hb[R], wb[4];
    auto fetch = [&](int k, float4 (&hv)[R], float4 (&w)[4]) {
#pragma unroll
      for (int i = 0; i < R; ++i)
        hv[i] = *reinterpret_cast<const float4*>(
            h_s + (rg + kRowGroups * i) * kLdH + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        w[kk] =
            *reinterpret_cast<const float4*>(w_s + (k + kk) * kUnits + q * 4);
    };
    auto step = [&](const float4 (&hv)[R], const float4 (&w)[4]) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < R; ++i)
          fma4(acc[i], kk == 0 ? hv[i].x : kk == 1 ? hv[i].y
                       : kk == 2 ? hv[i].z : hv[i].w, w[kk]);
    };
    if (k4n > 0) fetch(0, ha, wa);
    for (int k = 0; k < k4n; k += 8) {
      if (k + 4 < k4n) fetch(k + 4, hb, wb);
      step(ha, wa);
      if (k + 4 >= k4n) break;
      if (k + 8 < k4n) fetch(k + 8, ha, wa);
      step(hb, wb);
    }
    for (int k = k4n; k < kn; ++k) {
      const float4 wk =
          *reinterpret_cast<const float4*>(w_s + k * kUnits + q * 4);
#pragma unroll
      for (int i = 0; i < R; ++i)
        fma4(acc[i], h_s[(rg + kRowGroups * i) * kLdH + k], wk);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();                           // the ring is free
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = u0 + q * 4 + e;
      if (j < dense) {
        const float v = acc[i][e] + bd_s[j];
        hid[rg + kRowGroups * i][q * 4 + e] = v > 0.0f ? v : 0.0f;
      }
    }
  cluster.sync();                            // every block's units are in
  if (tile == 0) {
    // the row tile's dense units from every block of the cluster
    // the row tile's dense units from every block of the cluster: all
    // the remote loads first, then the stores
    float* all = smem;                       // kRows x kMaxDense
    constexpr int kPer = kRows * kMaxDense / kThreads;
    float got[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = u * kThreads + threadIdx.x;
      const int r = i / kMaxDense, j = i % kMaxDense;
      got[u] = j < dense ? cluster.map_shared_rank(&hid[0][0], j / kUnits)
                               [r * kUnits + j % kUnits]
                         : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) all[u * kThreads + threadIdx.x] = got[u];
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * 2; i += kThreads) {
      const int r = i / 2, c = i % 2;
      if (row0 + r < M) {
        const float* a = all + r * kMaxDense;
        float s = 0.0f;
#pragma unroll 16
        for (int j = 0; j < dense; ++j) s = fmaf(a[j], wh_s[j * 2 + c], s);
        out[(long long)(row0 + r) * 2 + c] = s + bh[c];
      }
    }
  }
  cluster.sync();                            // peers' units read: exit
}

template <int R, bool VEC>
int launch(const float* h, const float* wd, const float* bd, const float* wh,
           const float* bh, float* out, int Q, int M, int feat, int dense,
           cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * kStages * stage_floats();
  static_assert(sizeof(float) * kRows * kMaxDense <= smem,
                "the gathered units fit in the stages");
  static const cudaError_t attr = cudaFuncSetAttribute(
      dense_head<R, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const int tiles = (dense + kUnits - 1) / kUnits;
  cudaLaunchConfig_t cfg = {};
  const int row_tiles = (M + kRows - 1) / kRows;
  cfg.gridDim = dim3((unsigned)tiles, (unsigned)row_tiles, (unsigned)Q);
  cfg.blockDim = dim3(threads<R>());
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = (unsigned)tiles;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, dense_head<R, VEC>, h, wd, bd,
                                           wh, bh, out, M, feat, dense);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); 0 means launched.
// The caller (kernels/scorer_head.py) has checked shapes (dense <= 64),
// types and contiguity. Q members, every array with the member as its
// leading axis.
extern "C" int scorer_head_grouped_f32(const void* h, const void* wd,
                                       const void* bd, const void* wh,
                                       const void* bh, void* out, int Q, int M,
                                       int feat, int dense, void* stream) {
  if (M == 0 || Q == 0) return 0;
  if (dense < 1 || dense > kMaxDense || feat < 1 || Q > 65535)
    return (int)cudaErrorInvalidValue;
  // 2 rows a thread once the grid has a block for every SM (the card is
  // then bound by shared-memory traffic, which the second row halves for
  // Wd); 1 while it has fewer blocks (then more warps hide more latency).
  // The blocks of one member decide, so a member's bits do not see Q.
  const int blocks = (dense + kUnits - 1) / kUnits * ((M + kRows - 1) / kRows);
  const auto fn = blocks >= 128
                      ? (feat % 4 == 0 && dense % 4 == 0 ? launch<2, true>
                                                         : launch<2, false>)
                      : (feat % 4 == 0 && dense % 4 == 0 ? launch<1, true>
                                                         : launch<1, false>);
  return fn((const float*)h, (const float*)wd, (const float*)bd,
            (const float*)wh, (const float*)bh, (float*)out, Q, M, feat,
            dense, (cudaStream_t)stream);
}

// The ungrouped launch: one member.
extern "C" int scorer_head_f32(const void* h, const void* wd, const void* bd,
                               const void* wh, const void* bh, void* out,
                               int M, int feat, int dense, void* stream) {
  return scorer_head_grouped_f32(h, wd, bd, wh, bh, out, 1, M, feat, dense,
                                 stream);
}

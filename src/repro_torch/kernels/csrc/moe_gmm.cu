// Grouped expert matmul, out[e] = x[e] @ w[e], for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/moe_gmm.py::moe_gmm (body
// _gmm_kernel, pallas_call at l.50): x (E, C, K), w (E, K, F) -> out
// (E, C, F), all in float32 or all in bfloat16. The sum over K is float32
// and is rounded to x's type once, as the TPU kernel's float32 VMEM
// accumulator and the plain version (kernels/ref.py::moe_gmm) do. C, the
// expert capacity, is any integer (ragged); K and F are multiples of 8.
//
// Bound on an H100 SXM, at the shapes serving granite-moe-3b-a800m gives
// it (E = 40 experts, d = 1536, expert hidden 512, bf16):
//   * a decode tick (8 slots, capacity 8): 0.5 GFLOP against 62.9 MB of
//     weights per call, so bytes: 18.8 us at 3.35 TB/s;
//   * a 2048-token prefill (capacity 512): 32.2 GFLOP (32.6 us at 989
//     TFLOP/s on the tensor cores) against 146.8 MB (43.8 us), so bytes
//     again, at about 44 us.
// Float32 on the CUDA cores could never come near either: 32.2 GFLOP at
// 67 TFLOP/s is 0.48 ms.
//
// bfloat16 (the served path) runs on the tensor cores:
//   * one block per (128-column F tile, 128-row C tile, expert), experts
//     outermost so that the blocks of one expert share its weights in L2;
//   * a producer warp brings 64-deep K slices of x (128 x 64, K-major)
//     and w (64 x 128, as two 64-column boxes, F-major) by TMA into a
//     ring of 3 stages in shared memory (32 KB a stage, 97 KB a block, so
//     two blocks share an SM), each stage's arrival counted in bytes on an
//     mbarrier, so that the next slices are in flight while the tensor
//     cores work on one (4, 5 and 6 stages at one block an SM were no
//     faster at C 512 and up to 23% slower at C 8);
//   * two consumer warpgroups, 64 rows of C each, run wgmma m64n128k16
//     (bf16 in, float32 accumulators in registers) on each stage as it
//     arrives, x from the 128-byte-swizzled K-major tile and w as the
//     MN-major ("transposed") B operand, and release the stage once its
//     products are done;
//   * the ragged C edge and a K tail arrive as zeros (TMA fills a box past
//     the tensor's edge with zeros), and rows past C or columns past F are
//     not stored; a warpgroup whose 64 rows all lie past C skips its
//     products, so a decode tick (C 8) costs the weights' bytes and little
//     more.
// The backward (training; the JAX package trains through XLA's
// derivative and has no backward kernel) is the same kernel with other
// operand majors, template parameters TA and TB of the product: dx =
// dy.w^T reads w in place as a K-major B operand (<0, 0>), and dw =
// x^T.dy reads x in place as an MN-major A operand and dy as the MN-major
// B operand (<1, 1>), so neither makes a transposed copy. dw's contracted
// axis is the capacity C, whose edge TMA fills with zeros: C needs no
// padding, since x's and dy's rows (d and f elements) are whole 16-byte
// units. Bound at granite-moe-3b-a800m's training shape (E 40, C 1024,
// 1536 <-> 512): 4 E C d f = 129 GFLOP, 0.130 ms at 989 TFLOP/s, just
// above the 420 MB of x, w, dy read and dx, dw written (0.125 ms at 3.35
// TB/s). The float32 backward is the CUDA-core kernel with the same
// operand majors (gmm_tile<float, TA, TB>), also reading in place.
// A row's sum is the same at every C: the tile shape, the 64-deep stages
// and the 16-deep instructions are fixed, so row r is always reduced at
// the same place of the same tile in the same order, and no split of K is
// made. The skinny swap (F on M, C on N) would waste fewer tensor-core
// rows at C 8, but the waste costs about 4 us of a call bound by 19 us of
// bytes, and one variant for every C keeps a row's bits independent of C.
//
// float32 keeps the CUDA-core kernel below: the tensor cores take float32
// only as TF32, which keeps about three digits and would break the 1e-4
// agreement with the plain version. It stages 32-deep slices of x
// (transposed) and w through shared memory, each thread keeping a 4 x 4
// tile of float32 accumulators and adding k = 0, 1, ..., K-1 in that
// order with fmaf, so a row's result depends on neither C nor the other
// rows, and the backward's products, read in place through other
// operand majors, have the bits of the forward kernel on copies.
#include "common.cuh"
#include "hopper.cuh"

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

// One operand of gmm_tile: eight consecutive elements a thread per
// 32-deep slice of K, staged transposed or not into the slice's shared
// tile s[k][m or n]. When K is the contiguous axis (K-major: x in the
// forward, dy and w in dx), thread t loads 8 consecutive k of row t / 4
// and scatters them down a column; otherwise (MN-major: w in the
// forward, x and dy in dw), 8 consecutive rows or columns at k-row t / 8,
// stored as they lie. `rows` is M or N, `lim0` the tile's first row.
template <typename T, int MN_MAJOR, int W>
struct Operand {
  const T* p;
  long long step;   // elements from one slice of K to the next
  int r, k;         // this thread's row (or first of 8) and k in a slice
  bool row_ok;

  __device__ __forceinline__ Operand(const T* base, int rows, int K,
                                     int first) {
    if (MN_MAJOR) {
      k = threadIdx.x >> 3;
      r = (threadIdx.x & 7) * 8;
      p = base + (long long)k * rows + first + r;
      step = (long long)kBK * rows;
    } else {
      r = threadIdx.x >> 2;
      k = (threadIdx.x & 3) * 8;
      p = base + (long long)(first + r) * K + k;
      step = kBK;
    }
    row_ok = first + r < rows;
  }
  // the slice at k0's eight values, zeros past K or past the rows
  __device__ __forceinline__ void load(int k0, int K, float* v) const {
    load_chunk(p + (k0 / kBK) * step, row_ok && k0 + k < K, v);
  }
  __device__ __forceinline__ void stage(float (*s)[W + kPad],
                                        const float* v) const {
    if (MN_MAJOR) {
      *reinterpret_cast<float4*>(&s[k][r]) = make_float4(v[0], v[1], v[2],
                                                         v[3]);
      *reinterpret_cast<float4*>(&s[k][r + 4]) =
          make_float4(v[4], v[5], v[6], v[7]);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) s[k + i][r] = v[i];
    }
  }
};

// out[e] (M x N) = A[e] (M x K) . B[e] (K x N) on the CUDA cores; A is a
// (E, M, K) tensor when TA == 0, (E, K, M) when TA == 1, B is (E, K, N)
// when TB == 1, (E, N, K) when TB == 0 (the majors of gmm_wgmma). Every
// output adds k = 0, 1, ..., K-1 in that order with fmaf, whatever the
// majors, so the backward's dx and dw have the bits the forward kernel
// gives on transposed copies.
template <typename T, int TA, int TB>
__global__ void __launch_bounds__(kThreads)
    gmm_tile(const T* __restrict__ a, const T* __restrict__ b,
             T* __restrict__ out, int M, int K, int N) {
  __shared__ __align__(16) float xs[kBK][kBM + kPad];  // xs[k][row]
  __shared__ __align__(16) float ws[kBK][kBN + kPad];  // ws[k][col]
  const int e = blockIdx.z;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  const Operand<T, TA, kBM> oa(a + (long long)e * M * K, M, K, row0);
  const Operand<T, TB == 0 ? 0 : 1, kBN> ob(b + (long long)e * K * N, N, K,
                                            col0);

  // arithmetic: thread (ty, tx) owns rows ty*4.. and columns tx*4.. of
  // the tile; a warp holds two ty, so the rows past M skip as whole warps
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const bool has_rows = row0 + ty * 4 < M;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  float xv[8], wv[8];
  oa.load(0, K, xv);
  ob.load(0, K, wv);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    oa.stage(xs, xv);
    ob.stage(ws, wv);
    __syncthreads();
    const int k1 = k0 + kBK;
    if (k1 < K) {   // the next slice, in flight during this one's FMAs
      oa.load(k1, K, xv);
      ob.load(k1, K, wv);
    }
    if (has_rows) {
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 av4 = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
        const float4 bv4 = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
        const float av[4] = {av4.x, av4.y, av4.z, av4.w};
        const float bv[4] = {bv4.x, bv4.y, bv4.z, bv4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  if (!has_rows) return;
  T* oe = out + (long long)e * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= M) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx * 4 + j;
      if (c < N) oe[(long long)r * N + c] = from_float<T>(acc[i][j]);
    }
  }
}

// -- bfloat16: TMA ring + wgmma -------------------------------------------

namespace hp = repro_torch::hopper;

constexpr int kTM = 128;                     // rows of C per block
constexpr int kTN = 128;                     // columns of F per block
constexpr int kTK = 64;                      // depth of a stage
constexpr int kStages = 3;
constexpr int kConsumers = 256;              // two warpgroups
constexpr int kTcThreads = kConsumers + 32;  // and one producer warp
constexpr int kXBytes = kTM * kTK * 2;       // 16 KB, 128 rows of 128 B
constexpr int kWBox = kTK * 64 * 2;          // 8 KB, 64 k-rows of 128 B
constexpr int kStageBytes = kXBytes + 2 * kWBox;
constexpr int kTcSmem = kStages * kStageBytes + 1024;  // + alignment

// A (M x K) and B (K x N) of one expert's product, each K-major (TA or
// TB 0: K is the contiguous axis) or MN-major (1: M or N is), read in
// place by TMA from (E, rows, cols) tensors; out (E, M, N) row-major.
// The forward is <0, 1> (x K-major, w MN-major); the backward's dx =
// dy.w^T is <0, 0> (w read as a K-major B) and dw = x^T.dy is <1, 1> (x
// read as an MN-major A). A stage holds 16 KB of A and 16 KB of B either
// way: one 128-row box of 64 K-elements when K-major, two 64-wide boxes of
// 64 K-rows when MN-major.
template <int TA, int TB>
__global__ void __launch_bounds__(kTcThreads, 1)
    gmm_wgmma(const __grid_constant__ CUtensorMap amap,
              const __grid_constant__ CUtensorMap bmap,
              __nv_bfloat16* __restrict__ out, int M, int K, int N) {
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  extern __shared__ uint8_t dyn[];
  // swizzled tiles sit on 1024-byte boundaries
  uint8_t* base = dyn + ((1024 - (hp::smem_u32(dyn) & 1023)) & 1023);
  const int e = blockIdx.z;
  const int row0 = blockIdx.y * kTM;
  const int col0 = blockIdx.x * kTN;
  const int nk = (K + kTK - 1) / kTK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], kConsumers);
    }
    hp::mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == 2) {   // the producer warp; one lane starts the copies
    if (threadIdx.x == kConsumers) {
      hp::tma_prefetch(&amap);
      hp::tma_prefetch(&bmap);
      for (int i = 0; i < nk; ++i) {
        const int s = i % kStages;
        if (i >= kStages) hp::mbar_wait(&empty[s], ((i / kStages) - 1) & 1);
        uint8_t* st = base + s * kStageBytes;
        uint8_t* sb = st + kXBytes;
        hp::mbar_arrive_expect_tx(&full[s], kStageBytes);
        if (TA == 0) {
          hp::tma_load_3d(st, &amap, &full[s], i * kTK, row0, e);
        } else {
          hp::tma_load_3d(st, &amap, &full[s], row0, i * kTK, e);
          hp::tma_load_3d(st + kWBox, &amap, &full[s], row0 + 64, i * kTK,
                          e);
        }
        if (TB == 0) {
          hp::tma_load_3d(sb, &bmap, &full[s], i * kTK, col0, e);
        } else {
          hp::tma_load_3d(sb, &bmap, &full[s], col0, i * kTK, e);
          hp::tma_load_3d(sb + kWBox, &bmap, &full[s], col0 + 64, i * kTK,
                          e);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: rows row0 + 64 wg .. + 63 of the tile; one
  // whose rows all lie past M only releases each stage as it arrives (a
  // branch of its own, so that no wgmma sits on a divergent path, which
  // ptxas would serialize)
  if (row0 + wg * 64 >= M) {
    for (int i = 0; i < nk; ++i) {
      const int s = i % kStages;
      hp::mbar_wait(&full[s], (i / kStages) & 1);
      hp::mbar_arrive(&empty[s]);
    }
    return;
  }
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  for (int i = 0; i < nk; ++i) {
    const int s = i % kStages;
    hp::mbar_wait(&full[s], (i / kStages) & 1);
    const uint8_t* st = base + s * kStageBytes;
    const uint8_t* sb = st + kXBytes;
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTK / 16; ++kk) {
      // K-major: rows of 128 B (64 K-elements), 8-row groups 1024 B
      // apart; the k16 step moves 32 B along the row. MN-major: 64-wide
      // blocks 8 KB apart, 8-K-row groups 1024 B apart; the step moves 16
      // rows. A warpgroup's 64 rows of A are one block.
      const uint64_t da =
          TA == 0 ? hp::make_desc(st + wg * 64 * 128 + kk * 32, 16, 1024,
                                  128)
                  : hp::make_desc(st + wg * kWBox + kk * 16 * 128, kWBox,
                                  1024, 128);
      const uint64_t db =
          TB == 0 ? hp::make_desc(sb + kk * 32, 16, 1024, 128)
                  : hp::make_desc(sb + kk * 16 * 128, kWBox, 1024, 128);
      hp::Wgmma<128>::ss<TA, TB>(acc, da, db, 1);
    }
    hp::wgmma_commit();
    hp::wgmma_wait<1>();   // the previous stage's products are done
    if (i > 0) hp::mbar_arrive(&empty[(i - 1) % kStages]);
  }
  hp::wgmma_wait<0>();

  const int t = threadIdx.x % 128;
  const int r = row0 + wg * 64 + (t / 32) * 16 + (t % 32) / 4;
  __nv_bfloat16* oe = out + (long long)e * M * N;
#pragma unroll
  for (int j = 0; j < kTN / 8; ++j) {
    const int c = col0 + 8 * j + 2 * (t % 4);
    if (c >= N) continue;   // N % 8 == 0, so c + 1 < N too
    if (r < M)
      *reinterpret_cast<uint32_t*>(oe + (long long)r * N + c) =
          hp::pack_bf16(acc[4 * j], acc[4 * j + 1]);
    if (r + 8 < M)
      *reinterpret_cast<uint32_t*>(oe + (long long)(r + 8) * N + c) =
          hp::pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// The map of a bf16 operand of E experts, each `rows` x `cols` row-major
// (cols contiguous, a multiple of 8), read in boxes of `box_cols` x
// `box_rows`: 64 x 128 for a K-major operand, 64 x 64 for an MN-major one.
bool operand_map(CUtensorMap* map, const void* p, int E, int rows, int cols,
                 int box_cols, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2,
                                 (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  return hp::encode_bf16(map, p, 3, dims, strides, box);
}

// out[e] (M x N) = A[e] (M x K) . B[e] (K x N). A is a (E, M, K) tensor
// when TA == 0, (E, K, M) when TA == 1; B is (E, K, N) when TB == 1,
// (E, N, K) when TB == 0.
template <int TA, int TB>
int launch_bf16(const void* a, const void* b, void* out, int E, int M, int K,
                int N, cudaStream_t stream) {
  if ((M + kTM - 1) / kTM > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap amap, bmap;
  const bool ok =
      (TA == 0 ? operand_map(&amap, a, E, M, K, kTK, kTM)
               : operand_map(&amap, a, E, K, M, 64, kTK)) &&
      (TB == 1 ? operand_map(&bmap, b, E, K, N, 64, kTK)
               : operand_map(&bmap, b, E, N, K, kTK, kTN));
  if (!ok) return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      gmm_wgmma<TA, TB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kTcSmem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((unsigned int)((N + kTN - 1) / kTN),
                  (unsigned int)((M + kTM - 1) / kTM), (unsigned int)E);
  gmm_wgmma<TA, TB><<<grid, kTcThreads, kTcSmem, stream>>>(
      amap, bmap, (__nv_bfloat16*)out, M, K, N);
  return (int)cudaGetLastError();
}

// -- float32: the CUDA cores ----------------------------------------------

template <int TA, int TB>
int launch_f32(const void* a, const void* b, void* out, int E, int M, int K,
               int N, cudaStream_t stream) {
  if ((M + kBM - 1) / kBM > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned int)((N + kBN - 1) / kBN),
                  (unsigned int)((M + kBM - 1) / kBM), (unsigned int)E);
  gmm_tile<float, TA, TB><<<grid, kThreads, 0, stream>>>(
      (const float*)a, (const float*)b, (float*)out, M, K, N);
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
  if (E > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_f32<0, 1>(x, w, out, E, C, K, F, s);
  if (dtype == 1) return launch_bf16<0, 1>(x, w, out, E, C, K, F, s);
  return (int)cudaErrorInvalidValue;
}

// The backward, x (E, C, d), w (E, d, f) and dy (E, C, f) read in place:
// dx (E, C, d) = dy . w^T, then dw (E, d, f) = x^T . dy, two launches on
// `stream`; dtype 0 float32, 1 bfloat16; returns cudaGetLastError(), 0
// when both launched. C may be any size (dw's contracted axis: its edge
// arrives as zeros); the caller has checked d % 8 == 0, f % 8 == 0,
// types, contiguity and 16-byte alignment, and handles C == 0.
extern "C" int moe_gmm_bwd(const void* x, const void* w, const void* dy,
                           void* dx, void* dw, int dtype, int E, int C,
                           int d, int f, void* stream) {
  if (E == 0 || C == 0 || d == 0 || f == 0) return 0;
  if (E > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  int e1;
  if (dtype == 0) {
    e1 = launch_f32<0, 0>(dy, w, dx, E, C, f, d, s);
    return e1 != 0 ? e1 : launch_f32<1, 1>(x, dy, dw, E, d, C, f, s);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  e1 = launch_bf16<0, 0>(dy, w, dx, E, C, f, d, s);
  return e1 != 0 ? e1 : launch_bf16<1, 1>(x, dy, dw, E, d, C, f, s);
}

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
// rows.
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

__global__ void __launch_bounds__(kTcThreads, 1)
    gmm_wgmma(const __grid_constant__ CUtensorMap xmap,
              const __grid_constant__ CUtensorMap wmap,
              __nv_bfloat16* __restrict__ out, int C, int K, int F) {
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
      hp::tma_prefetch(&xmap);
      hp::tma_prefetch(&wmap);
      for (int i = 0; i < nk; ++i) {
        const int s = i % kStages;
        if (i >= kStages) hp::mbar_wait(&empty[s], ((i / kStages) - 1) & 1);
        uint8_t* st = base + s * kStageBytes;
        hp::mbar_arrive_expect_tx(&full[s], kStageBytes);
        hp::tma_load_3d(st, &xmap, &full[s], i * kTK, row0, e);
        hp::tma_load_3d(st + kXBytes, &wmap, &full[s], col0, i * kTK, e);
        hp::tma_load_3d(st + kXBytes + kWBox, &wmap, &full[s], col0 + 64,
                        i * kTK, e);
      }
    }
    return;
  }

  // consumer warpgroup wg: rows row0 + 64 wg .. + 63 of the tile
  const bool active = row0 + wg * 64 < C;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  for (int i = 0; i < nk; ++i) {
    const int s = i % kStages;
    hp::mbar_wait(&full[s], (i / kStages) & 1);
    if (active) {
      const uint8_t* st = base + s * kStageBytes;
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTK / 16; ++kk) {
        // x: K-major, rows of 128 B, 8-row groups 1024 B apart; the k16
        // step moves 32 B along the row. w: MN-major, 64-column blocks
        // 8 KB apart, 8-k-row groups 1024 B apart; the step moves 16 rows.
        const uint64_t da =
            hp::make_desc(st + wg * 64 * 128 + kk * 32, 16, 1024, 128);
        const uint64_t db =
            hp::make_desc(st + kXBytes + kk * 16 * 128, kWBox, 1024, 128);
        hp::Wgmma<128>::ss<0, 1>(acc, da, db, 1);
      }
      hp::wgmma_commit();
      hp::wgmma_wait<1>();   // the previous stage's products are done
      if (i > 0) hp::mbar_arrive(&empty[(i - 1) % kStages]);
    } else {
      hp::mbar_arrive(&empty[s]);
    }
  }
  if (!active) return;
  hp::wgmma_wait<0>();

  const int t = threadIdx.x % 128;
  const int r = row0 + wg * 64 + (t / 32) * 16 + (t % 32) / 4;
  __nv_bfloat16* oe = out + (long long)e * C * F;
#pragma unroll
  for (int j = 0; j < kTN / 8; ++j) {
    const int c = col0 + 8 * j + 2 * (t % 4);
    if (c >= F) continue;   // F % 8 == 0, so c + 1 < F too
    if (r < C)
      *reinterpret_cast<uint32_t*>(oe + (long long)r * F + c) =
          hp::pack_bf16(acc[4 * j], acc[4 * j + 1]);
    if (r + 8 < C)
      *reinterpret_cast<uint32_t*>(oe + (long long)(r + 8) * F + c) =
          hp::pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

int launch_bf16(const void* x, const void* w, void* out, int E, int C, int K,
                int F, cudaStream_t stream) {
  if ((C + kTM - 1) / kTM > 65535) return (int)cudaErrorInvalidValue;
  // x as (K, C, E) and w as (F, K, E), innermost first
  CUtensorMap xmap, wmap;
  const cuuint64_t xd[3] = {(cuuint64_t)K, (cuuint64_t)C, (cuuint64_t)E};
  const cuuint64_t xs[2] = {(cuuint64_t)K * 2, (cuuint64_t)C * K * 2};
  const cuuint32_t xb[3] = {kTK, kTM, 1};
  const cuuint64_t wd[3] = {(cuuint64_t)F, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint64_t ws[2] = {(cuuint64_t)F * 2, (cuuint64_t)K * F * 2};
  const cuuint32_t wb[3] = {64, kTK, 1};
  if (!hp::encode_bf16(&xmap, x, 3, xd, xs, xb) ||
      !hp::encode_bf16(&wmap, w, 3, wd, ws, wb))
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      gmm_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((unsigned int)((F + kTN - 1) / kTN),
                  (unsigned int)((C + kTM - 1) / kTM), (unsigned int)E);
  gmm_wgmma<<<grid, kTcThreads, kTcSmem, stream>>>(
      xmap, wmap, (__nv_bfloat16*)out, C, K, F);
  return (int)cudaGetLastError();
}

// -- float32: the CUDA cores ----------------------------------------------

int launch_f32(const void* x, const void* w, void* out, int E, int C, int K,
               int F, cudaStream_t stream) {
  if ((C + kBM - 1) / kBM > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned int)((F + kBN - 1) / kBN),
                  (unsigned int)((C + kBM - 1) / kBM), (unsigned int)E);
  gmm_tile<float><<<grid, kThreads, 0, stream>>>(
      (const float*)x, (const float*)w, (float*)out, C, K, F);
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
  if (dtype == 0) return launch_f32(x, w, out, E, C, K, F, s);
  if (dtype == 1) return launch_bf16(x, w, out, E, C, K, F, s);
  return (int)cudaErrorInvalidValue;
}

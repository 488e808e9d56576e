// Flash attention forward (prefill): causal and/or sliding-window GQA
// attention with an online softmax, for sm_90a.
//
// Replaces the Pallas TPU kernel
// repro/kernels/flash_attention.py::flash_attention (body _fa_kernel).
// q (B, Sq, H, D); k, v the compact GQA tensors (B, Sk, KV, D), query
// head h reading kv head h / (H/KV) (the TPU kernel takes k, v expanded
// to H heads); out (B, Sq, H, D) in q's type. Query row i sits at
// absolute position q_offset + i and key row j at j; the pair is kept
// iff (not causal or j <= pos) and (no window or j > pos - window), as in
// repro/kernels/ref.py::attention. Scores, softmax and the accumulator
// are float32; p stays float32 (the model rounds it to the compute type
// before P.V, the TPU kernels do not).
//
// Bound on an H100 SXM: operations at long prompts, bytes at short ones.
// Each kept (q, k) pair costs 4 * D operations (Q.K and P.V) per head;
// at 989 TFLOP/s of bf16 tensor-core work a 2048-token causal prefill of
// one layer (32 heads, D = 80) needs 21.5 GFLOP, 22 us, against 2.6 MB of
// q, k, v and out (0.8 us at 3.35 TB/s).
//
// The design is the simple one that is right first, on the CUDA cores in
// float32 (no tensor cores, TMA or wgmma yet, so it cannot approach that
// bound):
//   * one block of 128 threads per (64-row query tile, head, batch);
//     the q tile and each 64-row K and V tile are staged in shared memory
//     as float32, rows padded by one float against bank conflicts;
//   * a thread owns 4 query rows x 8 key columns of the score tile and
//     4 query rows x D/8 columns of the accumulator, in registers; the
//     eight threads that share a row reduce its max and sum by xor
//     shuffles and pass p through shared memory within their warp;
//   * the ragged edge is masked in the kernel: query rows past Sq are
//     computed on zeros and not stored, key rows past Sk are masked, so
//     no length has to be a multiple of a tile (the TPU kernel asserts
//     S % block == 0);
//   * key tiles that lie wholly outside the causal or window band of the
//     query tile are never loaded: a 4096-wide window over 8192 tokens
//     reads about half of the keys.
// Head dims 16, 32, 64, 80 and 128 are compiled (80 is the served one:
// ten 16-byte loads of bf16 per row).
#include "common.cuh"

namespace {

using repro_torch::from_float;
using repro_torch::load8;

constexpr int kBq = 64;        // query rows per block
constexpr int kBk = 64;        // key rows per tile
constexpr int kThreads = 128;  // 16 row groups of 4 rows x 8 column groups
constexpr int kPs = kBk + 1;   // padded row stride of the p tile

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBq * (D + 1) + kBk * (D + 1) + kBk * D + kBq * kPs);
}

// Rows [row0, row0 + rows) of a (B, S, heads, D) tensor at head `head`
// into a float32 tile with row stride `ld`; rows past S are zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, float* tile,
                                          int ld, int b, int row0, int rows,
                                          int S, int heads, int head) {
  constexpr int C8 = D / 8;
  for (int u = threadIdx.x; u < rows * C8; u += kThreads) {
    const int r = u / C8;
    const int c = (u % C8) * 8;
    float t[8];
    if (row0 + r < S) {
      load8(src + (((long long)b * S + row0 + r) * heads + head) * D + c, t);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) t[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) tile[r * ld + c + e] = t[e];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out, int Sq, int Sk,
              int H, int KV, int causal, int window, int q_offset,
              float scale) {
  constexpr int C = D / 8;      // accumulator columns per thread
  constexpr int QS = D + 1;
  extern __shared__ float smem[];
  float* q_s = smem;                 // kBq x QS
  float* k_s = q_s + kBq * QS;       // kBk x QS
  float* v_s = k_s + kBk * QS;       // kBk x D
  float* p_s = v_s + kBk * D;        // kBq x kPs

  const int q0 = blockIdx.x * kBq;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int rg = threadIdx.x >> 3;   // rows rg*4 .. rg*4+3 of the tile
  const int cg = threadIdx.x & 7;    // key columns cg + 8j, acc cols cg + 8c

  load_tile<T, D>(q, q_s, QS, b, q0, kBq, Sq, H, h);

  // the band of keys any row of this tile may keep
  const int pos_lo = q0 + q_offset;
  const int pos_hi = min(q0 + kBq, Sq) - 1 + q_offset;
  int k_lo = 0, k_hi = Sk - 1;
  if (window > 0) k_lo = max(0, pos_lo - window + 1);
  if (causal) k_hi = min(k_hi, pos_hi);

  float acc[4][C], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.0f;
  }

  for (int k0 = (k_lo / kBk) * kBk; k0 <= k_hi; k0 += kBk) {
    __syncthreads();   // the previous tile's K and V are no longer read
    load_tile<T, D>(k, k_s, QS, b, k0, kBk, Sk, KV, kvh);
    load_tile<T, D>(v, v_s, D, b, k0, kBk, Sk, KV, kvh);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = q_s[(rg * 4 + i) * QS + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kb[j] = k_s[(cg + 8 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int pos = q0 + rg * 4 + i + q_offset;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + cg + 8 * j;
        const bool keep = kpos < Sk && (!causal || kpos <= pos) &&
                          (window <= 0 || kpos > pos - window);
        s[i][j] = keep ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float mn = fmaxf(m[i], mx);
      // a row with no kept key so far keeps m = -inf, l = 0 and acc = 0
      const float corr = mn == -INFINITY ? 1.0f : expf(m[i] - mn);
      float rowsum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.0f : expf(s[i][j] - mn);
        rowsum += p;
        p_s[(rg * 4 + i) * kPs + cg + 8 * j] = p;
      }
      rowsum += __shfl_xor_sync(0xffffffffu, rowsum, 1);
      rowsum += __shfl_xor_sync(0xffffffffu, rowsum, 2);
      rowsum += __shfl_xor_sync(0xffffffffu, rowsum, 4);
      l[i] = l[i] * corr + rowsum;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] *= corr;
    }
    __syncwarp();   // a row's p is written by the eight lanes that read it

#pragma unroll 4
    for (int j = 0; j < kBk; ++j) {
      float pa[4], vb[C];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = p_s[(rg * 4 + i) * kPs + j];
#pragma unroll
      for (int c = 0; c < C; ++c) vb[c] = v_s[j * D + cg + 8 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[i][c] = fmaf(pa[i], vb[c], acc[i][c]);
    }
    __syncwarp();   // p is read before the next tile overwrites it
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg * 4 + i;
    if (row >= Sq) continue;
    T* o = out + (((long long)b * Sq + row) * H + h) * D;
    const float lsum = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < C; ++c) o[cg + 8 * c] = from_float<T>(acc[i][c] / lsum);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int KV, int causal, int window,
           int q_offset, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned int)((Sq + kBq - 1) / kBq), (unsigned int)H,
                  (unsigned int)B);
  flash_fwd<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Sq, Sk, H, KV, causal,
      window, q_offset, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dim(const void* q, const void* k, const void* v, void* out, int B,
               int Sq, int Sk, int H, int KV, int D, int causal, int window,
               int q_offset, float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, out, B, Sq, Sk, H, KV, causal, window, q_offset, scale, s);
    case 32: return launch<T, 32>(q, k, v, out, B, Sq, Sk, H, KV, causal, window, q_offset, scale, s);
    case 64: return launch<T, 64>(q, k, v, out, B, Sq, Sk, H, KV, causal, window, q_offset, scale, s);
    case 80: return launch<T, 80>(q, k, v, out, B, Sq, Sk, H, KV, causal, window, q_offset, scale, s);
    case 128: return launch<T, 128>(q, k, v, out, B, Sq, Sk, H, KV, causal, window, q_offset, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; window <= 0 means none. Launches on
// `stream` and returns cudaGetLastError(); 0 means launched. The caller
// (kernels/flash_attention.py) has checked shapes (D in {16, 32, 64, 80,
// 128}, H % KV == 0), types, contiguity and 16-byte alignment, and
// resolved q_offset.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int dtype,
                                   int B, int Sq, int Sk, int H, int KV,
                                   int D, int causal, int window,
                                   int q_offset, float scale, void* stream) {
  if (B == 0 || Sq == 0 || H == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_dim<float>(q, k, v, out, B, Sq, Sk, H, KV, D, causal,
                             window, q_offset, scale, s);
  if (dtype == 1)
    return launch_dim<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, KV, D,
                                     causal, window, q_offset, scale, s);
  return (int)cudaErrorInvalidValue;
}

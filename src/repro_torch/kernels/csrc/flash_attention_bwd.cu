// Flash attention backward (training): dQ, dK, dV of causal and/or
// sliding-window GQA attention, for sm_90a.
//
// The JAX package has no backward Pallas kernel (its model trains
// through XLA's derivative of plain attention); this is the backward of
// the port's forward kernel, flash_attention.cu, which saves each row's
// log-sum-exp L (B, H, Sq) float32. q, o, dO (B, Sq, H, D); k, v (B, Sk,
// KV, D), query head h reading kv head h / (H/KV); the same keep rule as
// the forward (causal, window, q_offset). With s = scale q.k and
// P = exp(s - L):
//   dV_j = sum_i P_ij dO_i,  dP_ij = dO_i . v_j,  Delta_i = dO_i . o_i,
//   dS_ij = P_ij (dP_ij - Delta_i),
//   dQ_i = scale sum_j dS_ij k_j,  dK_j = scale sum_i dS_ij q_i,
// every product and sum in float32, each gradient rounded once to the
// input's type. In bfloat16, P is rounded to bfloat16 before it
// multiplies dO, as the forward rounds it before P.V.
//
// Two kernels, neither with an atomic, so a gradient has the same bits
// from run to run:
//   * flash_bwd_dq: one block per (query tile, head, batch). It computes
//     Delta of its rows from dO and o (written to `delta` for the second
//     kernel), then walks the key tiles of its band in order and sums dQ
//     in registers;
//   * flash_bwd_dkdv: one block per (key tile, kv head, batch), launched
//     after the first on the same stream. It walks the group's query
//     heads in order and, for each, the query tiles of its band in order,
//     and sums dK and dV in registers: the GQA sum over a group's heads
//     stays inside one block, in a fixed order.
// Both stage their tiles in shared memory as float32 and run on the CUDA
// cores: 256 threads, each owning 4 rows x (columns strided by the
// column-group count) of every product. Tiles are 64 rows (32 at D 256,
// whose four 64-row tiles would not fit in shared memory).
//
// Bound on an H100 SXM: operations. Per kept (q, k) pair and head the
// backward does 4 products of length D (dP, dV, dK, dQ; 8 D operations,
// plus the recomputed S, 2 D, in each kernel): 10 D operations at the
// least. At granite-moe-3b-a800m's training shape (B 4, S 1024, 24 heads
// of 64, causal) that is 32 GFLOP, 0.48 ms at the 67 TFLOP/s float32
// rate of the CUDA cores (0.033 ms at the bf16 tensor-core rate, which
// this first kernel does not use).
#include "common.cuh"

namespace {

using repro_torch::from_float;
using repro_torch::load8;

constexpr int kThreads = 256;

template <int D>
struct Tile {
  static constexpr int kRows = D > 128 ? 32 : 64;   // rows of q and k tiles
  static constexpr int kLd = D + 1;                 // padded row stride
};

// Rows [row0, row0 + rows) of a (B, S, heads, D) tensor at head `head`
// into a float32 tile with row stride `ld`; rows past S are zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          float* tile, int ld, int b,
                                          int row0, int rows, int S,
                                          int heads, int head) {
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

__device__ __forceinline__ bool kept(int kpos, int pos, int Sk, int causal,
                                     int window) {
  return kpos < Sk && (!causal || kpos <= pos) &&
         (window <= 0 || kpos > pos - window);
}

template <typename T>
__device__ __forceinline__ float round_p(float p) {
  return repro_torch::to_float(from_float<T>(p));
}

template <int D>
constexpr size_t dq_smem() {
  using L = Tile<D>;
  return sizeof(float) * (4 * L::kRows * L::kLd + L::kRows * (L::kRows + 1) +
                          2 * L::kRows);
}

// dQ of one query tile, and Delta of its rows.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ o,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 float* __restrict__ delta, T* __restrict__ dq, int Sq,
                 int Sk, int H, int KV, int causal, int window, int q_offset,
                 float scale) {
  using L = Tile<D>;
  constexpr int BQ = L::kRows, BK = L::kRows, LD = L::kLd;
  constexpr int RG = BQ / 4;             // row groups of 4 query rows
  constexpr int CG = kThreads / RG;      // column groups
  constexpr int NK = BK / CG;            // key columns a thread
  constexpr int ND = D / CG;             // head-dim columns a thread
  extern __shared__ float smem[];
  float* q_s = smem;                     // BQ x LD
  float* do_s = q_s + BQ * LD;           // BQ x LD
  float* k_s = do_s + BQ * LD;           // BK x LD (o's tile first)
  float* v_s = k_s + BK * LD;            // BK x LD
  float* ds_s = v_s + BK * LD;           // BQ x (BK + 1)
  float* lse_s = ds_s + BQ * (BK + 1);   // BQ
  float* dl_s = lse_s + BQ;              // BQ

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int rg = threadIdx.x / CG;
  const int cg = threadIdx.x % CG;
  const long long row_base = ((long long)b * H + h) * Sq;

  load_tile<T, D>(q, q_s, LD, b, q0, BQ, Sq, H, h);
  load_tile<T, D>(dout, do_s, LD, b, q0, BQ, Sq, H, h);
  load_tile<T, D>(o, k_s, LD, b, q0, BQ, Sq, H, h);
  __syncthreads();
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    float dl = 0.0f;
    for (int d = 0; d < D; ++d) dl = fmaf(do_s[r * LD + d], k_s[r * LD + d], dl);
    const bool live = q0 + r < Sq;
    dl_s[r] = dl;
    lse_s[r] = live ? lse[row_base + q0 + r] : 0.0f;
    if (live) delta[row_base + q0 + r] = dl;
  }

  const int pos_lo = q0 + q_offset;
  const int pos_hi = min(q0 + BQ, Sq) - 1 + q_offset;
  int k_lo = 0, k_hi = Sk - 1;
  if (window > 0) k_lo = max(0, pos_lo - window + 1);
  if (causal) k_hi = min(k_hi, pos_hi);

  float acc[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < ND; ++c) acc[i][c] = 0.0f;

  for (int k0 = (k_lo / BK) * BK; k0 <= k_hi; k0 += BK) {
    __syncthreads();   // o's tile, or the previous K, V and dS, are read
    load_tile<T, D>(k, k_s, LD, b, k0, BK, Sk, KV, kvh);
    load_tile<T, D>(v, v_s, LD, b, k0, BK, Sk, KV, kvh);
    __syncthreads();
    float s[4][NK], dp[4][NK];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NK; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[4], da[4], kb[NK], vb[NK];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = q_s[(rg * 4 + i) * LD + d];
        da[i] = do_s[(rg * 4 + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        kb[j] = k_s[(cg + CG * j) * LD + d];
        vb[j] = v_s[(cg + CG * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NK; ++j) {
          s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
          dp[i][j] = fmaf(da[i], vb[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg * 4 + i;
      const int pos = q0 + r + q_offset;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const int c = cg + CG * j;
        const bool keep = q0 + r < Sq && kept(k0 + c, pos, Sk, causal, window);
        const float p = keep ? expf(s[i][j] * scale - lse_s[r]) : 0.0f;
        ds_s[r * (BK + 1) + c] = p * (dp[i][j] - dl_s[r]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float dsa[4], kb[ND];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsa[i] = ds_s[(rg * 4 + i) * (BK + 1) + kk];
#pragma unroll
      for (int c = 0; c < ND; ++c) kb[c] = k_s[kk * LD + cg + CG * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < ND; ++c) acc[i][c] = fmaf(dsa[i], kb[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg * 4 + i;
    if (row >= Sq) continue;
    T* dst = dq + (((long long)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < ND; ++c) dst[cg + CG * c] = from_float<T>(acc[i][c] * scale);
  }
}

template <int D>
constexpr size_t dkdv_smem() {
  using L = Tile<D>;
  return sizeof(float) * (4 * L::kRows * L::kLd +
                          2 * L::kRows * (L::kRows + 1) + 2 * L::kRows);
}

// dK and dV of one key tile of one kv head, summed over the group's query
// heads in order.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dk,
                   T* __restrict__ dv, int Sq, int Sk, int H, int KV,
                   int causal, int window, int q_offset, float scale) {
  using L = Tile<D>;
  constexpr int BQ = L::kRows, BK = L::kRows, LD = L::kLd;
  constexpr int RG = BK / 4;             // row groups of 4 key rows
  constexpr int CG = kThreads / RG;      // column groups
  constexpr int NQ = BQ / CG;            // query columns a thread
  constexpr int ND = D / CG;             // head-dim columns a thread
  extern __shared__ float smem[];
  float* k_s = smem;                     // BK x LD
  float* v_s = k_s + BK * LD;            // BK x LD
  float* q_s = v_s + BK * LD;            // BQ x LD
  float* do_s = q_s + BQ * LD;           // BQ x LD
  float* p_s = do_s + BQ * LD;           // BK x (BQ + 1)
  float* ds_s = p_s + BK * (BQ + 1);     // BK x (BQ + 1)
  float* lse_s = ds_s + BK * (BQ + 1);   // BQ
  float* dl_s = lse_s + BQ;              // BQ

  const int k0 = blockIdx.x * BK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int g = H / KV;
  const int rg = threadIdx.x / CG;
  const int cg = threadIdx.x % CG;

  load_tile<T, D>(k, k_s, LD, b, k0, BK, Sk, KV, kvh);
  load_tile<T, D>(v, v_s, LD, b, k0, BK, Sk, KV, kvh);

  // the query rows any key of this tile may be kept by
  int i_lo = 0, i_hi = Sq - 1;
  if (causal) i_lo = max(0, k0 - q_offset);
  if (window > 0) i_hi = min(i_hi, k0 + BK - 2 + window - q_offset);

  float dka[4][ND], dva[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < ND; ++c) dka[i][c] = dva[i][c] = 0.0f;

  for (int j = 0; j < g; ++j) {
    const int h = kvh * g + j;
    const long long row_base = ((long long)b * H + h) * Sq;
    for (int q0 = (i_lo / BQ) * BQ; q0 <= i_hi; q0 += BQ) {
      __syncthreads();   // the previous Q, dO, P and dS are read
      load_tile<T, D>(q, q_s, LD, b, q0, BQ, Sq, H, h);
      load_tile<T, D>(dout, do_s, LD, b, q0, BQ, Sq, H, h);
      for (int r = threadIdx.x; r < BQ; r += kThreads) {
        const bool live = q0 + r < Sq;
        lse_s[r] = live ? lse[row_base + q0 + r] : 0.0f;
        dl_s[r] = live ? delta[row_base + q0 + r] : 0.0f;
      }
      __syncthreads();
      float st[4][NQ], dpt[4][NQ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NQ; ++c) st[i][c] = dpt[i][c] = 0.0f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float ka[4], va[4], qb[NQ], db[NQ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ka[i] = k_s[(rg * 4 + i) * LD + d];
          va[i] = v_s[(rg * 4 + i) * LD + d];
        }
#pragma unroll
        for (int c = 0; c < NQ; ++c) {
          qb[c] = q_s[(cg + CG * c) * LD + d];
          db[c] = do_s[(cg + CG * c) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < NQ; ++c) {
            st[i][c] = fmaf(ka[i], qb[c], st[i][c]);
            dpt[i][c] = fmaf(va[i], db[c], dpt[i][c]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rg * 4 + i;
#pragma unroll
        for (int c = 0; c < NQ; ++c) {
          const int qc = cg + CG * c;
          const bool keep = q0 + qc < Sq &&
              kept(k0 + r, q0 + qc + q_offset, Sk, causal, window);
          const float p = keep ? expf(st[i][c] * scale - lse_s[qc]) : 0.0f;
          p_s[r * (BQ + 1) + qc] = round_p<T>(p);
          ds_s[r * (BQ + 1) + qc] = p * (dpt[i][c] - dl_s[qc]);
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int qq = 0; qq < BQ; ++qq) {
        float pa[4], dsa[4], db[ND], qb[ND];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pa[i] = p_s[(rg * 4 + i) * (BQ + 1) + qq];
          dsa[i] = ds_s[(rg * 4 + i) * (BQ + 1) + qq];
        }
#pragma unroll
        for (int c = 0; c < ND; ++c) {
          db[c] = do_s[qq * LD + cg + CG * c];
          qb[c] = q_s[qq * LD + cg + CG * c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < ND; ++c) {
            dva[i][c] = fmaf(pa[i], db[c], dva[i][c]);
            dka[i][c] = fmaf(dsa[i], qb[c], dka[i][c]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + rg * 4 + i;
    if (row >= Sk) continue;
    const long long off = (((long long)b * Sk + row) * KV + kvh) * D;
#pragma unroll
    for (int c = 0; c < ND; ++c) {
      dk[off + cg + CG * c] = from_float<T>(dka[i][c] * scale);
      dv[off + cg + CG * c] = from_float<T>(dva[i][c]);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int B, int Sq, int Sk, int H, int KV,
           int causal, int window, int q_offset, float scale,
           cudaStream_t s) {
  constexpr int R = Tile<D>::kRows;
  constexpr size_t s1 = dq_smem<D>(), s2 = dkdv_smem<D>();
  static const cudaError_t a1 = cudaFuncSetAttribute(
      flash_bwd_dq<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)s1);
  static const cudaError_t a2 = cudaFuncSetAttribute(
      flash_bwd_dkdv<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)s2);
  if (a1 != cudaSuccess) return (int)a1;
  if (a2 != cudaSuccess) return (int)a2;
  const dim3 g1((unsigned int)((Sq + R - 1) / R), (unsigned int)H,
                (unsigned int)B);
  flash_bwd_dq<T, D><<<g1, kThreads, s1, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)o, (const T*)dout, lse,
      delta, (T*)dq, Sq, Sk, H, KV, causal, window, q_offset, scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 g2((unsigned int)((Sk + R - 1) / R), (unsigned int)KV,
                (unsigned int)B);
  flash_bwd_dkdv<T, D><<<g2, kThreads, s2, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dk, (T*)dv, Sq, Sk, H, KV, causal, window, q_offset, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(int dtype, const void* q, const void* k, const void* v,
             const void* o, const void* dout, const float* lse, float* delta,
             void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H,
             int KV, int causal, int window, int q_offset, float scale,
             cudaStream_t s) {
  if (dtype == 0)
    return launch<float, D>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq,
                            Sk, H, KV, causal, window, q_offset, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, D>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                    B, Sq, Sk, H, KV, causal, window,
                                    q_offset, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; window <= 0 means none. lse: the
// forward's (B, H, Sq) float32; delta: (B, H, Sq) float32 scratch. Two
// launches on `stream` (dQ, then dK and dV); returns cudaGetLastError(),
// 0 when both launched. The caller (kernels/flash_attention.py) has
// checked shapes (D in {16, 32, 64, 80, 128, 256}, H % KV == 0), types,
// contiguity and 16-byte alignment, resolved q_offset, and handles Sq or
// Sk of 0.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv,
                                   int dtype, int B, int Sq, int Sk, int H,
                                   int KV, int D, int causal, int window,
                                   int q_offset, float scale, void* stream) {
  if (B == 0 || Sq == 0 || Sk == 0 || H == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  float* dl = (float*)delta;
#define REPRO_BWD(DIM)                                                      \
  case DIM:                                                                 \
    return launch_d<DIM>(dtype, q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq, \
                         Sk, H, KV, causal, window, q_offset, scale, s);
  switch (D) {
    REPRO_BWD(16)
    REPRO_BWD(32)
    REPRO_BWD(64)
    REPRO_BWD(80)
    REPRO_BWD(128)
    REPRO_BWD(256)
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_BWD
}

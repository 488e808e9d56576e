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
// every product's sum in float32, each gradient rounded once to the
// input's type.
//
// Two kernels, neither with an atomic, so a gradient has the same bits
// from run to run and whatever the batch:
//   * dQ: one block per (query tile, head, batch). It computes Delta of
//     its rows from dO and o (written to `delta` for the second kernel),
//     then walks the key tiles of its band in order and sums dQ in
//     registers;
//   * dK/dV: one block per (key tile, kv head, batch), launched after the
//     first on the same stream. It walks the group's query heads in order
//     and, for each, the query tiles of its band in order, and sums dK and
//     dV in registers: the GQA sum over a group's heads stays inside one
//     block, in a fixed order.
// Computing dQ in its own kernel recomputes S and dP there: 14 D
// operations a kept pair and head against the 10 D of the bound below.
// One kernel would sum dQ across key tiles from float32 partials in a
// fixed order, B H Sq D floats of scratch per key tile.
//
// bfloat16 at head dims 16, 32, 64, 80 and 128 runs on the tensor cores
// (flash_bwd_dq_wgmma, flash_bwd_dkdv_wgmma): a consumer warpgroup of 128
// threads over 64 rows and a producer warp, 160 threads, tiles of 64 rows
// brought by TMA into an mbarrier ring of 3 (D <= 64) or 2 stages, laid
// out as the forward's (flash_tc.cuh; D 80 is a 64-column swizzled block
// and one of 16 real and 48 zero columns):
//   * dK/dV keeps the block's K and V tiles in shared memory and rings
//     the (Q, dO) tiles of the band, with each query row's L log2 e and
//     Delta written beside them by the producer's lanes. S^T = K.Q^T and
//     dP^T = V.dO^T are wgmma m64n64k16 with both operands K-major (keys
//     on M, so no transpose); P^T = exp2(S^T scale log2 e - L log2 e) and
//     dS^T = P^T (dP^T - Delta) are formed in registers with L and Delta
//     read per query column; dV += P^T.dO and dK += dS^T.Q are wgmma
//     m64nDk16 with P^T and dS^T as the register A operand (the
//     accumulator layout of S^T is that operand's layout, as the forward
//     feeds P into P.V) and dO and Q as the MN-major B operand. P^T and
//     dS^T never go through shared memory, so no generic-proxy write
//     precedes a wgmma read;
//   * dQ keeps the block's Q and dO tiles and rings the (K, V) tiles of
//     the band: S = Q.K^T and dP = dO.V^T by ss, dS in registers, dQ +=
//     dS.K by rs with K the MN-major B operand;
//   * the keep rule is applied only on tiles that straddle the causal or
//     window edge or the ragged end of q or k; tiles outside the band are
//     never loaded; rows past Sq or Sk arrive as zeros from TMA and are
//     not stored. Under causal masking the dK/dV block of key tile 0
//     walks every query tile and the dQ block of the last query tile
//     every key tile, so each kernel's grid starts with those (the tile
//     index is the slowest grid axis);
//   * rounding: P^T is rounded to bf16 before dV += P^T.dO, as the forward
//     rounds P before P.V, and dS is rounded to bf16 before dK and dQ, as
//     the tensor cores take it; both differ from the float32 plain version
//     (kernels/ref.py::attention_bwd) within the 2e-2 limit relative to
//     the largest entry (PERF.md gives the error on the card at
//     granite-moe-3b-a800m's and h2o-danube-1.8b's training shapes).
// Registers: dK and dV accumulators (D floats a thread), S^T and dP^T (64)
// and the two A operands (32): about 210 at D 128, inside the 255 of a
// 160-thread block.
//
// float32 at every head dim, and bfloat16 at D 256 (whose dK and dV
// accumulators alone would take 256 registers a thread), keep the
// CUDA-core kernels (flash_bwd_dq, flash_bwd_dkdv): the tensor cores take
// float32 only as TF32, which would break the 1e-4 limit. They stage
// their tiles in shared memory as float32, 256 threads each owning 4 rows
// x (columns strided by the column-group count) of every product, tiles
// of 64 rows (32 at D 256, whose four 64-row tiles would not fit in
// shared memory). In bfloat16 they round P before P.dO and keep dS
// float32.
//
// Bound on an H100 SXM: operations. Per kept (q, k) pair and head the
// backward does 4 products of length D (dP, dV, dK, dQ; 8 D operations,
// plus the recomputed S, 2 D): 10 D operations at the least. At
// granite-moe-3b-a800m's training shape (B 4, S 1024, 24 heads of 64,
// causal) that is 32 GFLOP: 0.033 ms at the bf16 tensor-core rate of 989
// TFLOP/s, 0.48 ms at the 67 TFLOP/s float32 rate of the CUDA cores.
#include "common.cuh"
#include "flash_tc.cuh"
#include "hopper.cuh"

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

// -- bfloat16: TMA rings + wgmma -------------------------------------------

namespace hp = repro_torch::hopper;
using repro_torch::flash_tc::TcTile;
using repro_torch::flash_tc::fast_exp2;
using repro_torch::flash_tc::fence_regs;
using repro_torch::flash_tc::pv_async;
using repro_torch::flash_tc::scores_async;
using repro_torch::flash_tc::kTile;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTcThreads = 160;   // a consumer warpgroup and a producer warp

// The head dims whose bf16 backward runs on the tensor cores; D 256 would
// need 256 accumulator registers a thread for dK and dV alone.
template <int D>
constexpr bool tc_bwd() {
  return D <= 128;
}

template <int D>
constexpr int tc_smem() {   // two resident tiles and kStages of two more
  return TcTile<D>::kOperand * (2 + 2 * TcTile<D>::kStages) + 1024;
}

// whether a pair (query position pos, key kpos) is kept
__device__ __forceinline__ bool keep_pair(int kpos, int pos, int Sk,
                                          int causal, int window) {
  return kpos < Sk && (!causal || kpos <= pos) &&
         (window <= 0 || kpos > pos - window);
}

// whether the (query tile q0, key tile k0) pair of tiles has a masked pair
// or a row past Sq: only those tiles apply the keep rule
__device__ __forceinline__ bool edge_tile(int q0, int k0, int Sq, int Sk,
                                          int causal, int window,
                                          int q_offset) {
  return q0 + kTile > Sq || k0 + kTile > Sk ||
         (causal && k0 + kTile - 1 > q0 + q_offset) ||
         (window > 0 && k0 <= q0 + kTile - 1 + q_offset - window);
}

// Two rounded floats as the bf16 pair of a register A operand, from four
// values of an accumulator block (rows r and r + 8): a[(j%2)*2] holds row
// r, a[(j%2)*2+1] row r + 8 of 8-column block j, as the forward packs P.
__device__ __forceinline__ void pack_block(uint32_t (&a)[4][4], int j,
                                           const float (&v)[4]) {
  a[j / 2][(j % 2) * 2] = hp::pack_bf16(v[0], v[1]);
  a[j / 2][(j % 2) * 2 + 1] = hp::pack_bf16(v[2], v[3]);
}

// dQ of one 64-row query tile of one head, and Delta = rowsum(dO * O) of
// its rows. The producer warp brings the Q and dO tiles once and each K
// and V tile of the band into a ring; the consumer warpgroup computes S =
// Q.K^T and dP = dO.V^T (ss, both K-major), P = exp2(S scale log2e - L
// log2e) and dS = P (dP - Delta) in registers (the accumulator layout is
// the A operand), and dQ += dS.K (rs, K the MN-major B operand).
template <int D>
__global__ void __launch_bounds__(kTcThreads)
    flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __grid_constant__ CUtensorMap domap,
                       const __nv_bfloat16* __restrict__ o,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse,
                       float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int H,
                       int KV, int causal, int window, int q_offset,
                       float scale) {
  using L = TcTile<D>;
  constexpr int kS = L::kStages;
  __shared__ __align__(8) uint64_t q_full, full[kS], empty[kS];
  extern __shared__ uint8_t dyn[];
  uint8_t* q_s = dyn + ((1024 - (hp::smem_u32(dyn) & 1023)) & 1023);
  uint8_t* do_s = q_s + L::kOperand;
  uint8_t* kv_s = do_s + L::kOperand;

  // the last query tile first: under causal masking it walks most keys
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTile;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / (H / KV);
  const int pos_lo = q0 + q_offset;
  const int pos_hi = min(q0 + kTile, Sq) - 1 + q_offset;
  int k_lo = 0, k_hi = Sk - 1;
  if (window > 0) k_lo = max(0, pos_lo - window + 1);
  if (causal) k_hi = min(k_hi, pos_hi);
  const int t_lo = k_lo / kTile;
  const int n = k_hi >= k_lo ? k_hi / kTile - t_lo + 1 : 0;

  if (threadIdx.x == 0) {
    hp::mbar_init(&q_full, 1);
    for (int s = 0; s < kS; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], 128);
    }
    hp::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {   // the producer warp; one lane starts copies
    if (threadIdx.x == 128) {
      hp::tma_prefetch(&qmap);
      hp::tma_prefetch(&kmap);
      hp::tma_prefetch(&vmap);
      hp::tma_prefetch(&domap);
      hp::mbar_arrive_expect_tx(&q_full, 2 * L::kOperand);
      for (int c = 0; c < L::kBlocks; ++c) {
        hp::tma_load_4d(q_s + c * L::kBlock, &qmap, &q_full, c * L::kCols, h,
                        q0, b);
        hp::tma_load_4d(do_s + c * L::kBlock, &domap, &q_full, c * L::kCols,
                        h, q0, b);
      }
      for (int i = 0; i < n; ++i) {
        const int s = i % kS;
        if (i >= kS) hp::mbar_wait(&empty[s], ((i / kS) - 1) & 1);
        uint8_t* k_st = kv_s + s * 2 * L::kOperand;
        const int k0 = (t_lo + i) * kTile;
        hp::mbar_arrive_expect_tx(&full[s], 2 * L::kOperand);
        for (int c = 0; c < L::kBlocks; ++c) {
          hp::tma_load_4d(k_st + c * L::kBlock, &kmap, &full[s],
                          c * L::kCols, kvh, k0, b);
          hp::tma_load_4d(k_st + L::kOperand + c * L::kBlock, &vmap,
                          &full[s], c * L::kCols, kvh, k0, b);
        }
      }
    }
    return;
  }

  // thread t holds rows r and r + 8 of the tile, columns 8j + 2 quad +
  // {0, 1} of every 8-column block j
  const int t = threadIdx.x;
  const int quad = t % 4;
  const int r = (t / 32) * 16 + (t % 32) / 4;
  const long long row_base = ((long long)b * H + h) * Sq;
  float dl[2], l2[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int row = q0 + r + 8 * u;
    float acc = 0.0f;
    if (row < Sq) {
      const long long off = (((long long)b * Sq + row) * H + h) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(
            o + off + 8 * j + 2 * quad);
        const __nv_bfloat162 g = *reinterpret_cast<const __nv_bfloat162*>(
            dout + off + 8 * j + 2 * quad);
        acc = fmaf(__low2float(g), __low2float(a), acc);
        acc = fmaf(__high2float(g), __high2float(a), acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    dl[u] = acc;
    l2[u] = row < Sq ? lse[row_base + row] * kLog2e : 0.0f;
    if (quad == 0 && row < Sq) delta[row_base + row] = acc;
  }
  const float scale_log2 = scale * kLog2e;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  hp::mbar_wait(&q_full, 0);

  for (int i = 0; i < n; ++i) {
    const int s = i % kS;
    hp::mbar_wait(&full[s], (i / kS) & 1);
    const uint8_t* k_st = kv_s + s * 2 * L::kOperand;
    const int k0 = (t_lo + i) * kTile;
    float sc[32], dp[32];
    scores_async<D>(sc, q_s, k_st);
    scores_async<D>(dp, do_s, k_st + L::kOperand);
    hp::wgmma_wait<1>();
    fence_regs(sc);
    const bool edge = edge_tile(q0, k0, Sq, Sk, causal, window, q_offset);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = fast_exp2(sc[4 * j + e] * scale_log2 - l2[e >> 1]);
        if (edge) {
          const int kpos = k0 + 8 * j + 2 * quad + (e & 1);
          const int pos = q0 + r + 8 * (e >> 1) + q_offset;
          p = keep_pair(kpos, pos, Sk, causal, window) ? p : 0.0f;
        }
        sc[4 * j + e] = p;
      }
    hp::wgmma_wait<0>();
    fence_regs(dp);
    uint32_t dsa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[e] = sc[4 * j + e] * (dp[4 * j + e] - dl[e >> 1]);
      pack_block(dsa, j, ds);
    }
    pv_async<D>(acc, dsa, k_st);
    hp::wgmma_wait<0>();
    fence_regs(acc);
    hp::mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int row = q0 + r + 8 * u;
    if (row >= Sq) continue;
    __nv_bfloat16* dst = dq + (((long long)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j + 2 * quad) =
          hp::pack_bf16(acc[4 * j + 2 * u] * scale,
                        acc[4 * j + 2 * u + 1] * scale);
  }
}

// dK and dV of one 64-row key tile of one kv head, summed over the group's
// query heads in order and, for each, its query tiles of the band in
// order. K and V stay in shared memory; the producer warp brings each (Q,
// dO) tile pair by TMA into a ring, with the tile's L log2e and Delta
// beside it; the consumer warpgroup computes S^T = K.Q^T and dP^T =
// V.dO^T (ss, keys on M, both K-major), P^T and dS^T = P^T (dP^T -
// Delta) in registers with L and Delta read per query column, then dV +=
// P^T.dO and dK += dS^T.Q (rs, dO and Q the MN-major B operands).
template <int D>
__global__ void __launch_bounds__(kTcThreads)
    flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const __grid_constant__ CUtensorMap domap,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int Sq, int Sk,
                         int H, int KV, int causal, int window, int q_offset,
                         float scale) {
  using L = TcTile<D>;
  constexpr int kS = L::kStages;
  __shared__ __align__(8) uint64_t kv_full, full[kS], empty[kS];
  __shared__ __align__(16) float ld_s[kS][2][kTile];   // L log2e, Delta
  extern __shared__ uint8_t dyn[];
  uint8_t* k_s = dyn + ((1024 - (hp::smem_u32(dyn) & 1023)) & 1023);
  uint8_t* v_s = k_s + L::kOperand;
  uint8_t* qd_s = v_s + L::kOperand;

  // key tile 0 first: under causal masking it walks every query tile
  const int k0 = blockIdx.z * kTile;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int g = H / KV;
  // the query rows any key of this tile may be kept by, in whole tiles
  int i_lo = 0, i_hi = Sq - 1;
  if (causal) i_lo = max(0, k0 - q_offset);
  if (window > 0) i_hi = min(i_hi, k0 + kTile - 2 + window - q_offset);
  const int t_lo = i_lo / kTile;
  const int nq = i_hi >= i_lo ? i_hi / kTile - t_lo + 1 : 0;
  const int n = g * nq;

  if (threadIdx.x == 0) {
    hp::mbar_init(&kv_full, 1);
    for (int s = 0; s < kS; ++s) {
      hp::mbar_init(&full[s], 32);
      hp::mbar_init(&empty[s], 128);
    }
    hp::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {   // the producer warp
    const int lane = threadIdx.x - 128;
    if (lane == 0) {
      hp::tma_prefetch(&qmap);
      hp::tma_prefetch(&kmap);
      hp::tma_prefetch(&vmap);
      hp::tma_prefetch(&domap);
      hp::mbar_arrive_expect_tx(&kv_full, 2 * L::kOperand);
      for (int c = 0; c < L::kBlocks; ++c) {
        hp::tma_load_4d(k_s + c * L::kBlock, &kmap, &kv_full, c * L::kCols,
                        kvh, k0, b);
        hp::tma_load_4d(v_s + c * L::kBlock, &vmap, &kv_full, c * L::kCols,
                        kvh, k0, b);
      }
    }
    for (int i = 0; i < n; ++i) {
      const int s = i % kS;
      if (i >= kS) hp::mbar_wait(&empty[s], ((i / kS) - 1) & 1);
      const int h = kvh * g + i / nq;
      const int q0 = (t_lo + i % nq) * kTile;
      const long long row_base = ((long long)b * H + h) * Sq;
      // every lane writes two rows' L log2e and Delta, then arrives: the
      // arrival releases the writes to the consumers' wait
      for (int c = lane; c < kTile; c += 32) {
        const bool live = q0 + c < Sq;
        ld_s[s][0][c] = live ? lse[row_base + q0 + c] * kLog2e : 0.0f;
        ld_s[s][1][c] = live ? delta[row_base + q0 + c] : 0.0f;
      }
      if (lane == 0) {
        uint8_t* q_st = qd_s + s * 2 * L::kOperand;
        hp::mbar_arrive_expect_tx(&full[s], 2 * L::kOperand);
        for (int c = 0; c < L::kBlocks; ++c) {
          hp::tma_load_4d(q_st + c * L::kBlock, &qmap, &full[s],
                          c * L::kCols, h, q0, b);
          hp::tma_load_4d(q_st + L::kOperand + c * L::kBlock, &domap,
                          &full[s], c * L::kCols, h, q0, b);
        }
      } else {
        hp::mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // thread t holds key rows r and r + 8 of the tile, query columns 8j +
  // 2 quad + {0, 1} of every 8-column block j
  const int t = threadIdx.x;
  const int quad = t % 4;
  const int r = (t / 32) * 16 + (t % 32) / 4;
  const float scale_log2 = scale * kLog2e;
  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.0f;
  hp::mbar_wait(&kv_full, 0);

  for (int i = 0; i < n; ++i) {
    const int s = i % kS;
    hp::mbar_wait(&full[s], (i / kS) & 1);
    const uint8_t* q_st = qd_s + s * 2 * L::kOperand;
    const uint8_t* do_st = q_st + L::kOperand;
    const int q0 = (t_lo + i % nq) * kTile;
    float st[32], dpt[32];
    scores_async<D>(st, k_s, q_st);
    scores_async<D>(dpt, v_s, do_st);
    hp::wgmma_wait<1>();
    fence_regs(st);
    const bool edge = edge_tile(q0, k0, Sq, Sk, causal, window, q_offset);
    uint32_t pa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 =
          *reinterpret_cast<const float2*>(&ld_s[s][0][8 * j + 2 * quad]);
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = fast_exp2(st[4 * j + e] * scale_log2 - ((e & 1) ? l2.y : l2.x));
        if (edge) {
          const int qc = q0 + 8 * j + 2 * quad + (e & 1);
          const int kpos = k0 + r + 8 * (e >> 1);
          p[e] = qc < Sq && keep_pair(kpos, qc + q_offset, Sk, causal,
                                      window) ? p[e] : 0.0f;
        }
        st[4 * j + e] = p[e];
      }
      pack_block(pa, j, p);
    }
    hp::wgmma_wait<0>();
    fence_regs(dpt);
    uint32_t dsa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 dl =
          *reinterpret_cast<const float2*>(&ld_s[s][1][8 * j + 2 * quad]);
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[e] = st[4 * j + e] * (dpt[4 * j + e] - ((e & 1) ? dl.y : dl.x));
      pack_block(dsa, j, ds);
    }
    pv_async<D>(dva, pa, do_st);
    pv_async<D>(dka, dsa, q_st);
    hp::wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
    hp::mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int row = k0 + r + 8 * u;
    if (row >= Sk) continue;
    const long long off = (((long long)b * Sk + row) * KV + kvh) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dk + off + 8 * j + 2 * quad) =
          hp::pack_bf16(dka[4 * j + 2 * u] * scale,
                        dka[4 * j + 2 * u + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + 8 * j + 2 * quad) =
          hp::pack_bf16(dva[4 * j + 2 * u], dva[4 * j + 2 * u + 1]);
    }
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const float* lse, float* delta, void* dq,
              void* dk, void* dv, int B, int Sq, int Sk, int H, int KV,
              int causal, int window, int q_offset, float scale,
              cudaStream_t s) {
  namespace ft = repro_torch::flash_tc;
  constexpr int smem = tc_smem<D>();
  CUtensorMap qmap, kmap, vmap, domap;
  if (!ft::tile_map(&qmap, q, B, Sq, H, D) ||
      !ft::tile_map(&kmap, k, B, Sk, KV, D) ||
      !ft::tile_map(&vmap, v, B, Sk, KV, D) ||
      !ft::tile_map(&domap, dout, B, Sq, H, D))
    return (int)cudaErrorInvalidValue;
  static const cudaError_t a1 = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  static const cudaError_t a2 = cudaFuncSetAttribute(
      flash_bwd_dkdv_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (a1 != cudaSuccess) return (int)a1;
  if (a2 != cudaSuccess) return (int)a2;
  const unsigned int nq = (unsigned int)((Sq + kTile - 1) / kTile);
  const unsigned int nk = (unsigned int)((Sk + kTile - 1) / kTile);
  if (nq > 65535 || nk > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  flash_bwd_dq_wgmma<D><<<dim3(H, B, nq), kTcThreads, smem, s>>>(
      qmap, kmap, vmap, domap, (const __nv_bfloat16*)o,
      (const __nv_bfloat16*)dout, lse, delta, (__nv_bfloat16*)dq, Sq, Sk, H,
      KV, causal, window, q_offset, scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkdv_wgmma<D><<<dim3(KV, B, nk), kTcThreads, smem, s>>>(
      qmap, kmap, vmap, domap, lse, delta, (__nv_bfloat16*)dk,
      (__nv_bfloat16*)dv, Sq, Sk, H, KV, causal, window, q_offset, scale);
  return (int)cudaGetLastError();
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
  if (dtype == 1) {
    if constexpr (tc_bwd<D>())
      return launch_tc<D>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq,
                          Sk, H, KV, causal, window, q_offset, scale, s);
    else
      return launch<__nv_bfloat16, D>(q, k, v, o, dout, lse, delta, dq, dk,
                                      dv, B, Sq, Sk, H, KV, causal, window,
                                      q_offset, scale, s);
  }
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

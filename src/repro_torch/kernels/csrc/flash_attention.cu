// Flash attention forward (prefill): causal and/or sliding-window GQA
// attention with an online softmax, for sm_90a.
//
// Replaces the Pallas TPU kernel
// repro/kernels/flash_attention.py::flash_attention (body _fa_kernel,
// pallas_call at l.118). q (B, Sq, H, D); k, v the compact GQA tensors
// (B, Sk, KV, D), query head h reading kv head h / (H/KV) (the TPU kernel
// takes k, v expanded to H heads); out (B, Sq, H, D) in q's type. Query
// row i sits at absolute position q_offset + i and key row j at j; the
// pair is kept iff (not causal or j <= pos) and (no window or j > pos -
// window), as in repro/kernels/ref.py::attention. Scores, softmax, the
// row sums and the accumulator are float32.
//
// Bound on an H100 SXM: operations at long prompts, bytes at short ones.
// Each kept (q, k) pair costs 4 * D operations (Q.K and P.V) per head;
// at 989 TFLOP/s of bf16 tensor-core work a 2048-token causal prefill of
// one layer (32 heads, D = 80) needs 21.5 GFLOP, 22 us, against 2.6 MB of
// q, k, v and out (0.8 us at 3.35 TB/s).
//
// bfloat16 (the served path) runs on the tensor cores:
//   * one block per (64-row query tile, head, batch): one consumer
//     warpgroup of 128 threads and one producer warp;
//   * the producer brings the q tile once, then each 64-row K and V tile
//     of the band, by TMA, as bf16 into a ring of 2 (D > 64) or 3 stages
//     in shared memory, each stage's arrival counted in bytes on an
//     mbarrier, so the next tiles load while the tensor cores work;
//   * rows are 128-byte-swizzled 64-element column blocks (D 64, 80, 128;
//     D 80 is a block of 64 and one of 16 real and 48 zero columns), or
//     one 64- or 32-byte-swizzled block (D 32, 16);
//   * S = Q.K^T by wgmma m64n64k16 (both operands K-major in shared
//     memory, D/16 instructions), float32 in registers; a row's online max
//     and sum stay in registers across the four lanes that share it in the
//     accumulator layout;
//   * P is rounded to bf16 in registers, where the accumulator layout of S
//     is already the register A operand of P.V, and O += P.V by wgmma
//     m64nDk16 with V as the MN-major B operand: P never goes through
//     shared memory. The row sum is taken from the float32 P. This is what
//     the model's own attention does (it rounds p to the compute type
//     before P.V); the TPU kernel keeps p in float32, so the two differ by
//     that rounding, well inside the 2e-2 bf16 limit;
//   * masks are applied only on the tiles that straddle the causal or
//     window edge or the ragged end of k; key tiles that lie wholly outside
//     the band of the query tile are never loaded (a 4096-wide window over
//     8192 tokens reads about half of the keys);
//   * rows past Sq and keys past Sk arrive as zeros (TMA fills a box past
//     the tensor's edge with zeros); such keys are masked and such rows
//     not stored, so no length has to be a multiple of a tile (the TPU
//     kernel asserts S % block == 0).
//
// float32 keeps the CUDA-core kernel below: the tensor cores take float32
// only as TF32, which keeps about three digits and would break the 2e-5
// agreement with the plain version. One block of 128 threads per (64-row
// query tile, head, batch) stages the q tile and each 64-row K and V tile
// in shared memory as float32; a thread owns 4 query rows x 8 key columns
// of the score tile and 4 rows x D/8 columns of the accumulator, and p
// stays float32. Head dims 16, 32, 64, 80 and 128 are compiled in both
// types (80 is the served one).
#include "common.cuh"
#include "hopper.cuh"

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

// -- bfloat16: TMA ring + wgmma -------------------------------------------

namespace hp = repro_torch::hopper;

template <int D>
struct TcTile {
  static constexpr int kCols = D >= 64 ? 64 : D;   // elements per row
  static constexpr int kRow = kCols * 2;           // bytes per swizzled row
  static constexpr int kBlocks = (D + kCols - 1) / kCols;
  static constexpr int kBlock = 64 * kRow;         // 64 rows of one block
  static constexpr int kOperand = kBlocks * kBlock;  // a 64-row q/k/v tile
  static constexpr int kStages = D <= 64 ? 3 : 2;
  static constexpr int kSmem = kOperand * (1 + 2 * kStages) + 1024;
};

// S = Q.K^T of one 64 x 64 tile: D/16 wgmma, both operands K-major in
// shared memory; started and committed, not waited for.
template <int D>
__device__ __forceinline__ void scores_async(float (&sc)[32],
                                             const uint8_t* q_s,
                                             const uint8_t* k_st) {
  using L = TcTile<D>;
  hp::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off =
        (kk * 16 / L::kCols) * L::kBlock + (kk * 16 % L::kCols) * 2;
    hp::Wgmma<64>::ss<0, 0>(
        sc, hp::make_desc(q_s + off, 16, 8 * L::kRow, L::kRow),
        hp::make_desc(k_st + off, 16, 8 * L::kRow, L::kRow), kk > 0);
  }
  hp::wgmma_commit();
}

// O += P.V over one 64-key tile: P from registers, V the MN-major B
// operand in shared memory; started and committed, not waited for.
template <int D>
__device__ __forceinline__ void pv_async(float (&o)[D / 2],
                                         const uint32_t (&pa)[4][4],
                                         const uint8_t* v_st) {
  using L = TcTile<D>;
  hp::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBk / 16; ++kk)
    hp::Wgmma<D>::template rs<1>(
        o, pa[kk],
        hp::make_desc(v_st + kk * 16 * L::kRow, L::kBlock, 8 * L::kRow,
                      L::kRow),
        1);
  hp::wgmma_commit();
}

// 2^x by the SFU's ex2.approx (relative error ~2^-22, subnormal results
// flushed to zero), below what rounding P to bf16 loses; exp2f adds a
// range fix-up around the same instruction.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

struct Band {
  int Sk, causal, window;
  float scale_log2;
};

// The two rows a thread holds in the accumulator layout, with their
// online-softmax state: the running max m (in log2 units) and this
// thread's part of the row sum l.
struct Rows {
  int quad;
  int pos[2];
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};

  // One score tile at key k0: scale, mask (only on an edge tile), update
  // m and l, and write P, rounded to bf16, as the A operand of P.V
  // (block j of S is half of k16 step j / 2). corr rescales what was
  // summed before.
  __device__ __forceinline__ void softmax(float (&sc)[32],
                                          uint32_t (&pa)[4][4],
                                          float (&corr)[2], const Band& bd,
                                          int k0, bool edge) {
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = sc[4 * j + e] * bd.scale_log2;
        if (edge) {
          const int kpos = k0 + 8 * j + 2 * quad + (e & 1);
          const int p = pos[e >> 1];
          const bool keep = kpos < bd.Sk && (!bd.causal || kpos <= p) &&
                            (bd.window <= 0 || kpos > p - bd.window);
          v = keep ? v : -INFINITY;
        }
        sc[4 * j + e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    }
    float base[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 1));
      mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 2));
      const float mn = fmaxf(m[u], mx[u]);
      // a row with no kept key so far keeps m = -inf, l = 0 and o = 0
      base[u] = mn == -INFINITY ? 0.0f : mn;
      corr[u] = fast_exp2(m[u] - base[u]);
      m[u] = mn;
      l[u] *= corr[u];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = fast_exp2(sc[4 * j + e] - base[e >> 1]);
        l[e >> 1] += p[e];   // the row sum of the float32 P
      }
      pa[j / 2][(j % 2) * 2] = hp::pack_bf16(p[0], p[1]);
      pa[j / 2][(j % 2) * 2 + 1] = hp::pack_bf16(p[2], p[3]);
    }
  }
};

template <int D>
__global__ void __launch_bounds__(160)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    __nv_bfloat16* __restrict__ out, int Sq, int Sk, int H,
                    int KV, int causal, int window, int q_offset,
                    float scale_log2) {
  using L = TcTile<D>;
  constexpr int kS = L::kStages;
  __shared__ __align__(8) uint64_t q_full, full[kS], empty[kS];
  extern __shared__ uint8_t dyn[];
  // swizzled tiles sit on 1024-byte boundaries: the q tile, then the
  // stages, each a K tile and a V tile
  uint8_t* q_s = dyn + ((1024 - (hp::smem_u32(dyn) & 1023)) & 1023);
  uint8_t* kv_s = q_s + L::kOperand;

  const int q0 = blockIdx.x * kBq;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  // the band of keys any row of this tile may keep, in whole tiles
  const int pos_lo = q0 + q_offset;
  const int pos_hi = min(q0 + kBq, Sq) - 1 + q_offset;
  int k_lo = 0, k_hi = Sk - 1;
  if (window > 0) k_lo = max(0, pos_lo - window + 1);
  if (causal) k_hi = min(k_hi, pos_hi);
  const int t_lo = k_lo / kBk;
  const int n = k_hi >= k_lo ? k_hi / kBk - t_lo + 1 : 0;

  if (threadIdx.x == 0) {
    hp::mbar_init(&q_full, 1);
    for (int s = 0; s < kS; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], 128);
    }
    hp::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {   // the producer warp; one lane starts the copies
    if (threadIdx.x == 128) {
      hp::tma_prefetch(&qmap);
      hp::tma_prefetch(&kmap);
      hp::tma_prefetch(&vmap);
      hp::mbar_arrive_expect_tx(&q_full, L::kOperand);
      for (int c = 0; c < L::kBlocks; ++c)
        hp::tma_load_4d(q_s + c * L::kBlock, &qmap, &q_full, c * L::kCols, h,
                        q0, b);
      for (int i = 0; i < n; ++i) {
        const int s = i % kS;
        if (i >= kS) hp::mbar_wait(&empty[s], ((i / kS) - 1) & 1);
        uint8_t* k_st = kv_s + s * 2 * L::kOperand;
        const int k0 = (t_lo + i) * kBk;
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

  // the consumer warpgroup: thread t holds rows r and r + 8 of the tile,
  // columns 8j + 2(t%4) + {0, 1} of every 8-column block j
  const int t = threadIdx.x;
  Rows rows;
  rows.quad = t % 4;
  const int r = (t / 32) * 16 + (t % 32) / 4;
  rows.pos[0] = q0 + r + q_offset;
  rows.pos[1] = rows.pos[0] + 8;
  const Band band{Sk, causal, window, scale_log2};
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  hp::mbar_wait(&q_full, 0);

  for (int i = 0; i < n; ++i) {
    const int s = i % kS;
    hp::mbar_wait(&full[s], (i / kS) & 1);
    const uint8_t* k_st = kv_s + s * 2 * L::kOperand;
    float sc[32], corr[2];
    scores_async<D>(sc, q_s, k_st);
    hp::wgmma_wait<0>();
    // masks only where the tile crosses an edge of the band or of k
    const int k0 = (t_lo + i) * kBk;
    const bool edge = k0 + kBk > Sk || (causal && k0 + kBk - 1 > pos_lo) ||
                      (window > 0 && k0 <= q0 + kBq - 1 + q_offset - window);
    uint32_t pa[4][4];
    rows.softmax(sc, pa, corr, band, k0, edge);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= corr[0];
      o[4 * j + 1] *= corr[0];
      o[4 * j + 2] *= corr[1];
      o[4 * j + 3] *= corr[1];
    }
    pv_async<D>(o, pa, k_st + L::kOperand);
    hp::wgmma_wait<0>();
    hp::mbar_arrive(&empty[s]);
  }

  float inv[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    float l = rows.l[u];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[u] = 1.0f / fmaxf(l, 1e-30f);
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int row = q0 + r + 8 * u;
    if (row >= Sq) continue;
    __nv_bfloat16* dst = out + (((long long)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j + 2 * rows.quad) =
          hp::pack_bf16(o[4 * j + 2 * u] * inv[u],
                        o[4 * j + 2 * u + 1] * inv[u]);
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int B, int Sq, int Sk, int H, int KV, int causal, int window,
                int q_offset, float scale, cudaStream_t stream) {
  using L = TcTile<D>;
  if (Sk == 0)   // no key: every row is zero, as the band loop leaves it
    return (int)cudaMemsetAsync(out, 0, (size_t)B * Sq * H * D * 2, stream);
  // (B, S, heads, D) as (D, heads, S, B), innermost first, in boxes of
  // one 64-row column block of one head
  CUtensorMap qmap, kmap, vmap;
  const cuuint64_t qd[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)Sq,
                            (cuuint64_t)B};
  const cuuint64_t qs[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                            (cuuint64_t)Sq * H * D * 2};
  const cuuint64_t kd[4] = {(cuuint64_t)D, (cuuint64_t)KV, (cuuint64_t)Sk,
                            (cuuint64_t)B};
  const cuuint64_t ks[3] = {(cuuint64_t)D * 2, (cuuint64_t)KV * D * 2,
                            (cuuint64_t)Sk * KV * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)L::kCols, 1, (cuuint32_t)kBq, 1};
  if (!hp::encode_bf16(&qmap, q, 4, qd, qs, box) ||
      !hp::encode_bf16(&kmap, k, 4, kd, ks, box) ||
      !hp::encode_bf16(&vmap, v, 4, kd, ks, box))
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kSmem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((unsigned int)((Sq + kBq - 1) / kBq), (unsigned int)H,
                  (unsigned int)B);
  flash_fwd_wgmma<D><<<grid, 160, L::kSmem, stream>>>(
      qmap, kmap, vmap, (__nv_bfloat16*)out, Sq, Sk, H, KV, causal, window,
      q_offset, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// -- float32: the CUDA cores ----------------------------------------------

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B,
               int Sq, int Sk, int H, int KV, int causal, int window,
               int q_offset, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd<float, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned int)((Sq + kBq - 1) / kBq), (unsigned int)H,
                  (unsigned int)B);
  flash_fwd<float, D><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, Sq, Sk,
      H, KV, causal, window, q_offset, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int dtype,
           int B, int Sq, int Sk, int H, int KV, int causal, int window,
           int q_offset, float scale, cudaStream_t s) {
  if (dtype == 0)
    return launch_f32<D>(q, k, v, out, B, Sq, Sk, H, KV, causal, window,
                         q_offset, scale, s);
  if (dtype == 1)
    return launch_bf16<D>(q, k, v, out, B, Sq, Sk, H, KV, causal, window,
                          q_offset, scale, s);
  return (int)cudaErrorInvalidValue;
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
  switch (D) {
    case 16: return launch<16>(q, k, v, out, dtype, B, Sq, Sk, H, KV, causal, window, q_offset, scale, s);
    case 32: return launch<32>(q, k, v, out, dtype, B, Sq, Sk, H, KV, causal, window, q_offset, scale, s);
    case 64: return launch<64>(q, k, v, out, dtype, B, Sq, Sk, H, KV, causal, window, q_offset, scale, s);
    case 80: return launch<80>(q, k, v, out, dtype, B, Sq, Sk, H, KV, causal, window, q_offset, scale, s);
    case 128: return launch<128>(q, k, v, out, dtype, B, Sq, Sk, H, KV, causal, window, q_offset, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

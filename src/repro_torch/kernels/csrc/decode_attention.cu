// Decode attention: one new query row per (slot, head) against the
// slot's compact GQA ring cache, for sm_90a.
//
// Replaces the Pallas TPU kernel
// repro/kernels/decode_attention.py::decode_attention (body _dec_kernel)
// and computes the model's function, repro/models/attention.py::
// decode_attention, which that kernel does not: q (B, H, D), the compact
// cache k, v (B, S, KV, D) with query head h reading kv head h / (H/KV),
// and pos (B,), the slot's absolute position. Ring row r is valid iff
// r <= pos, or always once pos >= S; with pos >= S and KV == H this is
// the TPU kernel's function. Scores (q.k times `scale`), the softmax and
// the accumulator are float32; out (B, H, D) is rounded to q's type once.
//
// Bound on an H100 SXM: bytes. Each valid cache row is read once, K and
// V, and does 4 * D * G operations (G = H/KV query heads on the kv head)
// against 4 * D bytes in bf16, far below the 295 operations per byte of
// the tensor cores; the least time is the valid rows' bytes over
// 3.35 TB/s. At h2o-danube-1.8b's tick (8 slots, S = 4096, 8 kv heads,
// D = 80, bf16) a full cache is 84 MB (25 us); with positions spread over
// the ring about half of it is valid.
//
// Design (split-KV, "flash decoding", redesigned for Hopper):
//   * pass 1, one block per (kv-cache split of `split` rows, slot, kv
//     head): the block computes every query head of the kv head's group
//     (up to 64; a larger group runs in chunks of 64, grid z) against
//     each tile of the split, so a valid row of K and V is read from
//     device memory once for the whole group. The split size is chosen
//     by the caller from S, D, the group size and the type
//     (kernels/decode_attention.py::split_rows), never from B or pos, so
//     a slot's result does not depend on the other slots. A split past
//     the slot's valid rows returns at once;
//   * K and V tiles come into shared memory through a ring of 2-4 stages
//     of 16-byte cp.async copies (commit_group / wait_group): tiles
//     i+1 .. i+stages-1 are in flight while tile i is computed. Rows past
//     the split's last valid row are not read: they are filled with zeros
//     and masked;
//   * bfloat16 runs on the tensor cores, mma.sync m16n8k16: the group's
//     query heads, padded to a multiple of 16, are the M of S = Q.K^T,
//     64-row tiles of K the N; a warp takes one m16 tile of heads and a
//     slice of each tile's rows (4 slices for one m16 tile, 2 for 2-3, 1
//     for 4), keeps its own online softmax in registers (one exp per
//     score; a row's max over the quad of lanes that holds it), rounds p
//     to bf16 in registers, where S's accumulator layout is P's A
//     operand, and runs P.V on the same instruction (V through
//     ldmatrix.trans). Rounding p to the cache type before P.V is what
//     the model does (repro/models/attention.py l.208 rounds the
//     normalised p; here p is rounded before it is normalised, and the
//     row sum is taken from the float32 p); the plain version
//     ref.decode_attention keeps p float32, within the 2e-2 bf16 limit.
//     The warps' states merge in shared memory in a fixed order;
//   * float32 stays on the CUDA cores (TF32 would break the 2e-5 limit)
//     with the same ring and split, in 32-row tiles: a warp scores one
//     head at a time against the tile, lane j taking row j (four partial
//     sums over d), the row max and sum by xor shuffles; then each thread
//     adds p.V into float4 accumulators of its heads at one column quad,
//     one V load feeding all of them. 4 warps for up to 4 heads, 8 above;
//   * each block writes its partial state (m, l, acc) to a float32
//     scratch; pass 2, one warp per (slot, head, 32 columns), merges the
//     slot's splits in index order (a fixed order) and writes out. It is
//     launched as pass 1's programmatic dependent (Hopper's
//     griddepcontrol), so its blocks are placed while pass 1 ends. A slot
//     whose valid rows fit in one split is written by pass 1. A second
//     launch, and not the last block of each (slot, kv head), merges: a
//     large group's partial states are as large as the rows it read
//     (granite-20b's 48 heads of 128), and one block merging them all
//     was slower than its whole first pass.
// Every head of a group runs the same code over the same rows in the
// same order, so a head's bits depend neither on its place in the group
// nor on the slots beside it.
//
// A slice of a ring (decode_attention_part): under a "model" axis each
// rank holds rows row0 .. row0 + S - 1 of a ring of S_total rows
// (models/attention.py), and ring row row0 + r is valid iff
// row0 + r <= pos or pos >= S_total, so a slice's valid rows are still a
// prefix of it, possibly empty. Each (slot, head) may also give its
// float32 log-sum-exp, m + log(l) of the scaled scores, which the merge
// of the ranks' partial outputs reads; a slot with no valid row in the
// slice gets zeros and -inf, written by its first split's blocks. One
// process passes row0 = 0, S_total = S and no log-sum-exp.
#include "common.cuh"

#include <stdint.h>

namespace {

using repro_torch::from_float;

constexpr int kMaxHeads = 64;        // query heads a block takes
constexpr int kRowsBf16 = 64;        // cache rows of a bf16 tile
constexpr int kRowsF32 = 32;         // cache rows of a float32 tile
constexpr int kSmemLimit = 227 * 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; with `valid` false nothing is
// read and the destination is filled with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a.b, m16n8k16, bf16 in, float32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3},"
      " {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// pass 2 may be placed on the card once every block of pass 1 got here
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// The valid rows of slot b's slice: a prefix of it, 0 .. S.
__device__ __forceinline__ int valid_rows(const int* pos, int b, int S,
                                          int row0, int S_total) {
  if (pos == nullptr) return S;
  const int p = pos[b];
  if (p >= S_total) return S;
  const int n = p - row0 + 1;
  return n < 0 ? 0 : n > S ? S : n;
}

// What every block of one launch shares.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* pos;
  void* out;
  float* part_acc;   // (B * H, NS, D) partial accumulators
  float2* part_ml;   // (B * H, NS) partial (max, sum)
  float* lse;        // (B * H) log-sum-exp, or null
  int H, KV, S, NS, split, GB;   // GB: query heads a block takes
  int row0, S_total;             // the slice's first ring row, the ring
  float scale;
};

// The block's place: slot b, kv head kvh, chunk z of the group, split sp;
// its heads h0 .. h0 + n_heads - 1 and its valid rows [r0, r1).
struct Place {
  int b, kvh, h0, n_heads, sp, ns, r0, r1;
};

__device__ __forceinline__ bool place(const Args& a, Place& p) {
  p.sp = blockIdx.x;
  p.b = blockIdx.y / a.KV;
  p.kvh = blockIdx.y % a.KV;
  const int group = a.H / a.KV;
  p.h0 = p.kvh * group + blockIdx.z * a.GB;
  p.n_heads = min(a.GB, group - (int)blockIdx.z * a.GB);
  const int n_valid = valid_rows(a.pos, p.b, a.S, a.row0, a.S_total);
  p.ns = (n_valid + a.split - 1) / a.split;
  p.r0 = p.sp * a.split;
  p.r1 = min(n_valid, p.r0 + a.split);
  return p.r0 < n_valid;
}

// One 4-float column quad of a head's merged output, written to `out`
// rounded to T.
template <typename T>
__device__ __forceinline__ void store4(T* out, float4 a, float l) {
  const float inv = 1.0f / fmaxf(l, 1e-30f);
  out[0] = from_float<T>(a.x * inv);
  out[1] = from_float<T>(a.y * inv);
  out[2] = from_float<T>(a.z * inv);
  out[3] = from_float<T>(a.w * inv);
}

// The block's partial state of head `hl` (0 .. n_heads-1), columns
// d4*4 .. d4*4+3: to out directly when the slot has one split, else to
// the scratch.
template <typename T>
__device__ __forceinline__ void emit(const Args& a, const Place& p, int D,
                                     int hl, int d4, float m, float l,
                                     float4 acc) {
  const long long row = (long long)p.b * a.H + p.h0 + hl;
  if (p.ns == 1) {
    store4<T>((T*)a.out + row * D + d4 * 4, acc, l);
    if (a.lse != nullptr && d4 == 0) a.lse[row] = m + logf(l);
    return;
  }
  const long long at = row * a.NS + p.sp;
  reinterpret_cast<float4*>(a.part_acc + at * D)[d4] = acc;
  if (d4 == 0) a.part_ml[at] = make_float2(m, l);
}

// A slot with no valid row in the slice: its heads' output zeros and
// log-sum-exp -inf, from the blocks of its first split.
template <typename T>
__device__ __forceinline__ void empty_slot(const Args& a, const Place& p,
                                           int D) {
  if (p.ns != 0 || p.sp != 0) return;
  for (int i = threadIdx.x; i < p.n_heads * D; i += blockDim.x) {
    const long long row = (long long)p.b * a.H + p.h0 + i / D;
    ((T*)a.out)[row * D + i % D] = from_float<T>(0.0f);
    if (a.lse != nullptr && i % D == 0) a.lse[row] = -INFINITY;
  }
}

// Pass 2: one warp per (slot, head, slab of 32 float2 columns) merges
// the slot's splits in index order and writes out; a slot with one split
// was written by pass 1. Lane j takes column j of the slab; the splits
// come in groups of 16, all of a group's loads issued before its sums
// and the next group's while they run, and each split's weight from the
// lane that holds its (max, sum). It is launched as pass 1's
// programmatic dependent: its blocks are placed while pass 1 ends, and
// wait for pass 1's writes before they read.
constexpr int kCombineWarps = 8;
constexpr int kGroup = 16;                 // splits whose loads fly at once

template <typename T, int D>
__global__ void __launch_bounds__(32 * kCombineWarps)
    decode_combine(const float* __restrict__ part_acc,
                   const float2* __restrict__ part_ml,
                   const int* __restrict__ pos, T* __restrict__ out,
                   float* __restrict__ lse, int BH, int H, int S, int NS,
                   int split, int row0, int S_total) {
  constexpr int D2 = D / 2;
  constexpr int SLABS = (D2 + 31) / 32;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int warp = blockIdx.x * kCombineWarps + (threadIdx.x >> 5);
  const int row = warp / SLABS;
  const int col = (warp % SLABS) * 32 + (threadIdx.x & 31);
  const int lane = threadIdx.x & 31;
  if (row >= BH) return;
  const int ns =
      (valid_rows(pos, row / H, S, row0, S_total) + split - 1) / split;
  if (ns <= 1) return;           // written by pass 1
  const float2* ml = part_ml + (long long)row * NS;
  const float2* acc =
      reinterpret_cast<const float2*>(part_acc + (long long)row * NS * D) +
      (col < D2 ? col : 0);
  auto fetch = [&](int s0, float2 (&v)[kGroup]) {
#pragma unroll
    for (int j = 0; j < kGroup; ++j)
      v[j] = s0 + j < ns ? acc[(long long)(s0 + j) * D2]
                         : make_float2(0.0f, 0.0f);
  };
  float2 v[kGroup];
  fetch(0, v);                             // in flight beside the max
  float mx = -INFINITY;
  for (int s = lane; s < ns; s += 32) mx = fmaxf(mx, ml[s].x);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  float2 o = make_float2(0.0f, 0.0f);
  float l = 0.0f, w_mine = 0.0f, l_mine = 0.0f;
  for (int s0 = 0; s0 < ns; s0 += kGroup) {
    if (s0 % 32 == 0 && s0 + lane < ns) {  // this lane's split of the 32
      const float2 st = ml[s0 + lane];
      w_mine = expf(st.x - mx);
      l_mine = st.y;
    }
    float2 nxt[kGroup];
    if (s0 + kGroup < ns) fetch(s0 + kGroup, nxt);
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (s0 + j < ns) {
        const int src = (s0 + j) % 32;
        const float w = __shfl_sync(0xffffffffu, w_mine, src);
        l = fmaf(w, __shfl_sync(0xffffffffu, l_mine, src), l);
        o.x = fmaf(w, v[j].x, o.x);
        o.y = fmaf(w, v[j].y, o.y);
      }
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) v[j] = nxt[j];
  }
  if (col < D2) {
    const float inv = 1.0f / fmaxf(l, 1e-30f);
    T* dst = out + (long long)row * D + 2 * col;
    dst[0] = from_float<T>(o.x * inv);
    dst[1] = from_float<T>(o.y * inv);
  }
  if (lse != nullptr && col == 0) lse[row] = mx + logf(l);
}

// -- bfloat16: tensor cores ---------------------------------------------------

template <int D>
__host__ __device__ constexpr int bf16_stages() {
  return D <= 80 ? 4 : D <= 128 ? 3 : 2;
}
// a padded shared-memory row of bf16
__host__ __device__ constexpr int bf16_ld(int D) { return D + 8; }

template <int D, int MT>
__host__ __device__ constexpr size_t bf16_ring_bytes() {
  return (size_t)bf16_stages<D>() * 2 * kRowsBf16 * bf16_ld(D) * 2 +
         (size_t)16 * MT * bf16_ld(D) * 2;
}
template <int D, int MT, int WK>
__host__ __device__ constexpr size_t bf16_smem_bytes() {
  // after the loop the ring holds each warp's state: 16 rows x (D + 2)
  return bf16_ring_bytes<D, MT>() > (size_t)MT * WK * 16 * (D + 2) * 4
             ? bf16_ring_bytes<D, MT>()
             : (size_t)MT * WK * 16 * (D + 2) * 4;
}

// Warp (mi, ki) takes query heads mi*16 .. mi*16+15 of the block and rows
// ki*KW .. ki*KW+KW-1 of every 64-row tile. MT m16 tiles, WK row slices.
template <int D, int MT, int WK>
__global__ void __launch_bounds__(32 * MT * WK)
    decode_bf16(const Args a) {
  constexpr int kThreads = 32 * MT * WK;
  constexpr int LD = bf16_ld(D);
  constexpr int STAGES = bf16_stages<D>();
  constexpr int KW = kRowsBf16 / WK;     // rows of a tile a warp takes
  constexpr int NT = D / 8;              // n8 tiles of the accumulator
  constexpr int C8 = D / 8;              // 16-byte chunks of a row
  extern __shared__ __align__(16) unsigned char smem[];
  Place p;
  if (!place(a, p)) {
    empty_slot<__nv_bfloat16>(a, p, D);
    return;
  }

  using bf16 = __nv_bfloat16;
  bf16* q_s = reinterpret_cast<bf16*>(smem);                 // 16*MT x LD
  bf16* ring = q_s + 16 * MT * LD;       // STAGES x {K, V} x 64 x LD
  const bf16* kg = (const bf16*)a.k;
  const bf16* vg = (const bf16*)a.v;
  const long long row_stride = (long long)a.KV * D;
  const long long base = ((long long)p.b * a.S * a.KV + p.kvh) * D;
  const int n_tiles = (p.r1 - p.r0 + kRowsBf16 - 1) / kRowsBf16;

  auto load_tile = [&](int t) {
    if (t < n_tiles) {
      bf16* ks = ring + (t % STAGES) * 2 * kRowsBf16 * LD;
      bf16* vs = ks + kRowsBf16 * LD;
      const int t0 = p.r0 + t * kRowsBf16;
      for (int i = threadIdx.x; i < kRowsBf16 * C8; i += kThreads) {
        const int r = i / C8, c = i % C8;
        const bool ok = t0 + r < p.r1;
        const long long off = base + (ok ? (long long)(t0 + r) : 0) *
                                         row_stride + c * 8;
        cp_async16(ks + r * LD + c * 8, kg + off, ok);
        cp_async16(vs + r * LD + c * 8, vg + off, ok);
      }
    }
    cp_async_commit();    // an empty group past the end keeps the count
  };

  // the group's queries, zero past the block's heads
  const bf16* qg = (const bf16*)a.q + ((long long)p.b * a.H + p.h0) * D;
  for (int i = threadIdx.x; i < 16 * MT * C8; i += kThreads) {
    const int r = i / C8, c = i % C8;
    cp_async16(q_s + r * LD + c * 8, qg + (r < p.n_heads ? r : 0) * D + c * 8,
               r < p.n_heads);
  }
  for (int t = 0; t < STAGES - 1; ++t) load_tile(t);   // q joins tile 0

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mi = warp / WK, ki = warp % WK;
  const int g = lane >> 2, t4 = lane & 3;   // fragment row, column pair
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();             // tile t is in; tile t-1 is no longer read
    load_tile(t + STAGES - 1);
    const bf16* ks = ring + (t % STAGES) * 2 * kRowsBf16 * LD;
    const bf16* vs = ks + kRowsBf16 * LD;
    const int t0 = p.r0 + t * kRowsBf16;
#pragma unroll
    for (int c = 0; c < KW / 16; ++c) {
      const int key0 = ki * KW + c * 16;        // first row of the chunk
      if (t0 + key0 >= p.r1) break;             // the chunk is all masked
      // S = Q.K^T for 16 heads x 16 rows: two n8 tiles
      float s[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t qa[4], kb[4];
        ldmatrix_x4(qa, q_s + (mi * 16 + (lane & 15)) * LD + kk * 16 +
                            (lane >> 4) * 8);
        ldmatrix_x4(kb, ks + (key0 + (lane >> 4) * 8 + (lane & 7)) * LD +
                            kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[0], qa, kb[0], kb[1]);
        mma_bf16(s[1], qa, kb[2], kb[3]);
      }
      // online softmax of rows g (e 0, 1) and g + 8 (e 2, 3)
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = t0 + key0 + n * 8 + t4 * 2 + (e & 1);
          s[n][e] = r < p.r1 ? s[n][e] * a.scale : -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
        }
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float mn = fmaxf(m[h], mx[h]);     // finite: row key0 is valid
        corr[h] = expf(m[h] - mn);               // 0 while m is -inf
        m[h] = mn;
      }
      float sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = expf(s[n][e] - m[e >> 1]);   // 0 for a masked row
          sum[e >> 1] += s[n][e];
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = fmaf(l[h], corr[h], sum[h]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][0] *= corr[0];
        acc[n][1] *= corr[0];
        acc[n][2] *= corr[1];
        acc[n][3] *= corr[1];
      }
      // P (bf16, the accumulator layout of S is the A operand) . V
      const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]),
                              pack_bf16(s[0][2], s[0][3]),
                              pack_bf16(s[1][0], s[1][1]),
                              pack_bf16(s[1][2], s[1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vs + (key0 + (lane & 15)) * LD + dp * 16 +
                                  (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], pa, vb[0], vb[1]);
        mma_bf16(acc[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
  }
  cp_async_wait<0>();
  // a row's sum over the quad of lanes that hold it
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  __syncthreads();               // the ring is free: it takes the states
  float* st = reinterpret_cast<float*>(smem) + warp * 16 * (D + 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float* row = st + (g + 8 * h) * (D + 2);
    if (t4 == 0) {
      row[0] = m[h];
      row[1] = l[h];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      row[2 + n * 8 + t4 * 2] = acc[n][2 * h];
      row[3 + n * 8 + t4 * 2] = acc[n][2 * h + 1];
    }
  }
  __syncthreads();
  launch_dependents();
  // the WK row slices of each head, merged in order
  constexpr int D4 = D / 4;
  for (int i = threadIdx.x; i < p.n_heads * D4; i += kThreads) {
    const int hl = i / D4, d4 = i % D4;
    const int hm = hl >> 4, hr = hl & 15;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < WK; ++w)
      mx = fmaxf(mx, reinterpret_cast<float*>(smem)[((hm * WK + w) * 16 + hr) *
                                                    (D + 2)]);
    float lsum = 0.0f;
    float4 o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int w = 0; w < WK; ++w) {
      const float* row =
          reinterpret_cast<float*>(smem) + ((hm * WK + w) * 16 + hr) * (D + 2);
      if (row[1] == 0.0f) continue;         // a slice with no valid row
      const float wt = expf(row[0] - mx);
      lsum = fmaf(wt, row[1], lsum);
      o.x = fmaf(wt, row[2 + d4 * 4], o.x);
      o.y = fmaf(wt, row[3 + d4 * 4], o.y);
      o.z = fmaf(wt, row[4 + d4 * 4], o.z);
      o.w = fmaf(wt, row[5 + d4 * 4], o.w);
    }
    emit<bf16>(a, p, D, hl, d4, mx, lsum, o);
  }
}

// -- float32: CUDA cores ------------------------------------------------------

template <int D>
__host__ __device__ constexpr int f32_stages() {
  return D <= 128 ? 3 : 2;
}
// a padded shared-memory row of floats
__host__ __device__ constexpr int f32_ld(int D) { return D + 4; }

inline size_t f32_smem_bytes(int D, int stages, int gb) {
  return sizeof(float) * ((size_t)stages * 2 * kRowsF32 * f32_ld(D) +
                          (size_t)gb * D + (size_t)gb * kRowsF32 + 3 * gb);
}

// NW warps; U: float4 accumulators a thread holds, one per head of its
// head set.
template <int D, int NW, int U>
__global__ void __launch_bounds__(32 * NW) decode_f32(const Args a) {
  constexpr int kF32Threads = 32 * NW;
  constexpr int LD = f32_ld(D);
  constexpr int STAGES = f32_stages<D>();
  constexpr int C4 = D / 4;                  // 16-byte chunks of a row
  constexpr int HG = kF32Threads / C4;       // head sets
  extern __shared__ __align__(16) float fsm[];
  Place p;
  if (!place(a, p)) {
    empty_slot<float>(a, p, D);
    return;
  }

  const int GB = p.n_heads;
  float* ring = fsm;                                   // STAGES x {K, V}
  float* q_s = ring + STAGES * 2 * kRowsF32 * LD;      // GB x D
  float* p_s = q_s + a.GB * D;                         // GB x 32
  float* m_s = p_s + a.GB * kRowsF32;                  // GB
  float* l_s = m_s + a.GB;
  float* c_s = l_s + a.GB;
  const float* kg = (const float*)a.k;
  const float* vg = (const float*)a.v;
  const long long row_stride = (long long)a.KV * D;
  const long long base = ((long long)p.b * a.S * a.KV + p.kvh) * D;
  const int n_tiles = (p.r1 - p.r0 + kRowsF32 - 1) / kRowsF32;

  auto load_tile = [&](int t) {
    if (t < n_tiles) {
      float* ks = ring + (t % STAGES) * 2 * kRowsF32 * LD;
      float* vs = ks + kRowsF32 * LD;
      const int t0 = p.r0 + t * kRowsF32;
      for (int i = threadIdx.x; i < kRowsF32 * C4; i += kF32Threads) {
        const int r = i / C4, c = i % C4;
        const bool ok = t0 + r < p.r1;
        const long long off = base + (ok ? (long long)(t0 + r) : 0) *
                                         row_stride + c * 4;
        cp_async16(ks + r * LD + c * 4, kg + off, ok);
        cp_async16(vs + r * LD + c * 4, vg + off, ok);
      }
    }
    cp_async_commit();
  };

  const float* qg = (const float*)a.q + ((long long)p.b * a.H + p.h0) * D;
  for (int i = threadIdx.x; i < GB * C4; i += kF32Threads)
    cp_async16(q_s + i * 4, qg + i * 4, true);
  for (int i = threadIdx.x; i < GB; i += kF32Threads) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.0f;
  }
  for (int t = 0; t < STAGES - 1; ++t) load_tile(t);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d4 = threadIdx.x % C4, hg = threadIdx.x / C4;
  float4 acc[U];
#pragma unroll
  for (int u = 0; u < U; ++u) acc[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    load_tile(t + STAGES - 1);
    const float* ks = ring + (t % STAGES) * 2 * kRowsF32 * LD;
    const float* vs = ks + kRowsF32 * LD;
    const bool ok = p.r0 + t * kRowsF32 + lane < p.r1;
    // scores: warp w takes heads w, w + 4, ...; lane j row j of the tile
    for (int h = warp; h < GB; h += kF32Threads / 32) {
      const float4* qr = reinterpret_cast<const float4*>(q_s + h * D);
      const float4* kr = reinterpret_cast<const float4*>(ks + lane * LD);
      // four partial sums (d = 4i + e), added in a fixed order
      float4 s4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 8
      for (int c = 0; c < C4; ++c) {
        const float4 qv = qr[c], kv = kr[c];
        s4.x = fmaf(qv.x, kv.x, s4.x);
        s4.y = fmaf(qv.y, kv.y, s4.y);
        s4.z = fmaf(qv.z, kv.z, s4.z);
        s4.w = fmaf(qv.w, kv.w, s4.w);
      }
      float s = (s4.x + s4.y) + (s4.z + s4.w);
      s = ok ? s * a.scale : -INFINITY;
      float mx = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[h];
      const float mn = fmaxf(m_old, mx);     // finite: row 0 is valid
      const float pr = expf(s - mn);         // 0 for a masked row
      float sum = pr;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      p_s[h * kRowsF32 + lane] = pr;
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - mn);
        c_s[h] = corr;
        m_s[h] = mn;
        l_s[h] = fmaf(l_s[h], corr, sum);
      }
    }
    __syncthreads();
    // acc += p.V: thread (hg, d4) holds heads hg, hg + HG, ... at quad d4
    if (hg < HG) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int h = hg + HG * u;
        if (h < GB) {
          const float corr = c_s[h];
          acc[u].x *= corr;
          acc[u].y *= corr;
          acc[u].z *= corr;
          acc[u].w *= corr;
        }
      }
#pragma unroll 8
      for (int j = 0; j < kRowsF32; ++j) {
        const float4 vv = reinterpret_cast<const float4*>(vs + j * LD)[d4];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int h = hg + HG * u;
          if (h < GB) {
            const float pj = p_s[h * kRowsF32 + j];
            acc[u].x = fmaf(pj, vv.x, acc[u].x);
            acc[u].y = fmaf(pj, vv.y, acc[u].y);
            acc[u].z = fmaf(pj, vv.z, acc[u].z);
            acc[u].w = fmaf(pj, vv.w, acc[u].w);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  launch_dependents();
  if (hg < HG) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int h = hg + HG * u;
      if (h < GB) emit<float>(a, p, D, h, d4, m_s[h], l_s[h], acc[u]);
    }
  }
}

// -- launch ---------------------------------------------------------------------

template <typename K>
int set_smem(K kernel, size_t bytes) {
  if (bytes > kSmemLimit) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

template <int D, int MT, int WK>
int launch_bf16(const Args& a, dim3 grid, cudaStream_t s) {
  constexpr size_t smem = bf16_smem_bytes<D, MT, WK>();
  static const int attr = set_smem(decode_bf16<D, MT, WK>, smem);
  if (attr != 0) return attr;
  decode_bf16<D, MT, WK><<<grid, 32 * MT * WK, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <int D>
int dispatch_bf16(const Args& a, dim3 grid, cudaStream_t s) {
  switch ((a.GB + 15) / 16) {
    case 1: return launch_bf16<D, 1, 4>(a, grid, s);
    case 2: return launch_bf16<D, 2, 2>(a, grid, s);
    case 3: return launch_bf16<D, 3, 2>(a, grid, s);
    default: return launch_bf16<D, 4, 1>(a, grid, s);
  }
}

template <int D, int NW, int U>
int launch_f32(const Args& a, dim3 grid, cudaStream_t s) {
  const size_t smem = f32_smem_bytes(D, f32_stages<D>(), a.GB);
  static const int attr =
      set_smem(decode_f32<D, NW, U>,
               f32_smem_bytes(D, f32_stages<D>(), kMaxHeads));
  if (attr != 0) return attr;
  decode_f32<D, NW, U><<<grid, 32 * NW, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// The smallest U (1, 2, 4, ...) whose head sets hold the block's heads,
// at most `heads` of them.
template <int D, int NW, int HEADS, int U = 1>
int dispatch_f32_u(const Args& a, dim3 grid, cudaStream_t s) {
  constexpr int HG = 32 * NW / (D / 4);
  if constexpr (U * HG >= HEADS) {
    return launch_f32<D, NW, U>(a, grid, s);
  } else {
    if (a.GB <= U * HG) return launch_f32<D, NW, U>(a, grid, s);
    return dispatch_f32_u<D, NW, HEADS, 2 * U>(a, grid, s);
  }
}

// A warp scores a head at a time: 4 warps for up to 4 heads, 8 above
// (llama4-maverick's 5 on 4 warps left one warp two heads to score and
// one thread set two heads to sum).
template <int D>
int dispatch_f32(const Args& a, dim3 grid, cudaStream_t s) {
  if (a.GB <= 4) return dispatch_f32_u<D, 4, 4>(a, grid, s);
  return dispatch_f32_u<D, 8, kMaxHeads>(a, grid, s);
}

template <typename T, int D>
int combine(const Args& a, int B, cudaStream_t s) {
  if (a.NS == 1) return 0;       // every slot was written by pass 1
  const int rows = B * a.H;
  const int warps = rows * ((D / 2 + 31) / 32);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((warps + kCombineWarps - 1) / kCombineWarps));
  cfg.blockDim = dim3(32 * kCombineWarps);
  cfg.stream = s;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  at[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, decode_combine<T, D>, (const float*)a.part_acc,
      (const float2*)a.part_ml, a.pos, (T*)a.out, a.lse, rows, a.H, a.S,
      a.NS, a.split, a.row0, a.S_total);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <int D>
int fwd(const Args& a, int dtype, int B, dim3 grid, cudaStream_t s) {
  int err;
  if (dtype == 1) {
    err = dispatch_bf16<D>(a, grid, s);
    return err ? err : combine<__nv_bfloat16, D>(a, B, s);
  }
  err = dispatch_f32<D>(a, grid, s);
  return err ? err : combine<float, D>(a, B, s);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; pos: int32 (B,) or null for all rows
// valid. `split`: cache rows of a block of pass 1, a positive multiple of
// 64, chosen by the caller from S, D, the group size and the type.
// `part`: float32 scratch of B * H * ceil(S / split) * (D + 2) floats.
// k, v hold rows row0 .. row0 + S - 1 of a ring of S_total rows; `lse`:
// float32 (B * H) or null. Launches both passes on `stream` and returns
// cudaGetLastError(); 0 means launched. The caller
// (kernels/decode_attention.py) has checked shapes (D one of 16, 32, 64,
// 80, 128, 256, KV dividing H, 0 <= row0, row0 + S <= S_total), types,
// contiguity and 16-byte alignment.
extern "C" int decode_attention_part(const void* q, const void* k,
                                     const void* v, const void* pos,
                                     void* out, void* part, void* lse,
                                     int dtype, int B, int H, int KV, int S,
                                     int D, int split, int row0, int S_total,
                                     float scale, void* stream) {
  if (B == 0 || H == 0) return 0;
  if (KV <= 0 || H % KV || split <= 0 || split % kRowsBf16 || S <= 0 ||
      row0 < 0 || row0 + S > S_total || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int group = H / KV;
  const int gb = group < kMaxHeads ? group : kMaxHeads;
  const int chunks = (group + gb - 1) / gb;
  const int NS = (S + split - 1) / split;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.pos = (const int*)pos;
  a.out = out;
  a.part_acc = (float*)part;
  a.part_ml = reinterpret_cast<float2*>((float*)part +
                                        (size_t)B * H * NS * D);
  a.lse = (float*)lse;
  a.H = H;
  a.KV = KV;
  a.S = S;
  a.NS = NS;
  a.split = split;
  a.GB = gb;
  a.row0 = row0;
  a.S_total = S_total;
  a.scale = scale;
  const dim3 grid((unsigned)NS, (unsigned)(B * KV), (unsigned)chunks);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16: return fwd<16>(a, dtype, B, grid, s);
    case 32: return fwd<32>(a, dtype, B, grid, s);
    case 64: return fwd<64>(a, dtype, B, grid, s);
    case 80: return fwd<80>(a, dtype, B, grid, s);
    case 128: return fwd<128>(a, dtype, B, grid, s);
    case 256: return fwd<256>(a, dtype, B, grid, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The whole ring (row0 = 0, S_total = S) with no log-sum-exp, through
// the C interface of the earlier sources, so that
// benchmarks/torch_kernel_variant.py calls this build and theirs alike.
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* pos,
                                    void* out, void* part, int dtype, int B,
                                    int H, int KV, int S, int D, int split,
                                    float scale, void* stream) {
  return decode_attention_part(q, k, v, pos, out, part, nullptr, dtype, B,
                               H, KV, S, D, split, 0, S, scale, stream);
}

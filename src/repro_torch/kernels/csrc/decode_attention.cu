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
// the TPU kernel's function. Scores, softmax and the accumulator are
// float32; out (B, H, D) is rounded to q's type once. p stays float32
// (the model rounds it to the cache type before P.V; the TPU kernels
// do not).
//
// Bound on an H100 SXM: bytes. Each valid cache row is read once, K and
// V, and does 4 * D * (H/KV) operations against 4 * D bytes in bf16, far
// below the 295 operations per byte of the tensor cores; the least time
// is the valid rows' bytes over 3.35 TB/s. At the served shape (8 slots,
// S = 4096, 8 kv heads, D = 80, bf16) a full cache is 84 MB (25 us); with
// positions spread over the ring about half of it is valid.
//
// The design is the simple one that is right first, split over the cache
// so that enough blocks stream it at once (flash decoding):
//   * pass 1, one block of 4 warps per (slot, kv head, 256-row split of
//     the valid rows); a block handles the kv head's H/KV query heads
//     together, so each valid row of K and V is read from device memory
//     once; splits past the slot's valid rows return at once. Groups of
//     1 to 7 query heads are compiled as they are; a larger group (8,
//     or granite-20b's 48 on one kv head) runs in chunks of 8 heads, one
//     block per chunk, each reading the kv head's rows (from L2 after the
//     first);
//   * inside a block a row of D elements is read by D/8 lanes, 16 bytes
//     each (head dim 80: 10 lanes, 160 bytes), grouped in power-of-two
//     lane groups so that the dot product reduces by xor shuffles; each
//     lane group keeps an online softmax (m, l, acc) per query head;
//   * the lane groups' states merge in shared memory into one partial
//     state per (slot, head, split), written to a float32 scratch;
//   * pass 2, one block per (slot, head), merges the splits in order.
// Tensor cores, TMA and a tuned split size are later work.
#include "common.cuh"

namespace {

using repro_torch::from_float;
using repro_torch::load8;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kSplitRows = 256;   // cache rows per block of pass 1
constexpr int kCombineThreads = 128;

__device__ __forceinline__ int valid_rows(const int* pos, int b, int S) {
  if (pos == nullptr) return S;
  const int p = pos[b];
  return p >= S ? S : p + 1;
}

// Partial state of split `sp` for (b, h): m at part[((b*H+h)*NS+sp)*(D+2)],
// l after it, then the D accumulator values. A block takes G of the kv
// head's H/KV query heads: chunk blockIdx.z, heads z*G .. z*G+G-1 of the
// group, those past the group's end left out (zero queries, not
// written). Every head runs the same code over the same rows in the same
// order, so its result does not depend on the chunk it falls in.
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
    decode_split(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ pos,
                 float* __restrict__ part, int H, int KV, int S, int D,
                 int NS, int P, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / KV;
  const int kvh = blockIdx.x % KV;
  const int sp = blockIdx.y;
  const int group = H / KV;                 // query heads of this kv head
  const int h0 = kvh * group + blockIdx.z * G;
  const int n_heads = min(G, group - (int)blockIdx.z * G);
  const int n_valid = valid_rows(pos, b, S);
  const int r0 = sp * kSplitRows;
  if (r0 >= n_valid) return;   // pass 2 reads only the splits that ran
  const int r1 = min(n_valid, r0 + kSplitRows);

  const int C = D / 8;                    // 8-element chunks of a row
  const int lane = threadIdx.x & 31;
  const int sub = lane % P;               // chunk of this lane
  const int groups_per_warp = 32 / P;
  const int lg = (threadIdx.x >> 5) * groups_per_warp + lane / P;   // lane group
  const int n_groups = kWarps * groups_per_warp;
  const bool has_chunk = sub < C;

  float qv[G][8], acc[G][8], m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int h = h0 + g;
    if (has_chunk && g < n_heads) {
      load8(q + ((long long)b * H + h) * D + sub * 8, qv[g]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) qv[g][e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.0f;
    m[g] = -INFINITY;
    l[g] = 0.0f;
  }

  // every lane of a warp runs the same number of iterations, so the
  // shuffles below always see the whole warp
  for (int base = r0; base < r1; base += n_groups) {
    const int r = base + lg;
    const bool row_ok = r < r1;
    float kk[8], vv[8];
    if (row_ok && has_chunk) {
      const long long off = (((long long)b * S + r) * KV + kvh) * D + sub * 8;
      load8(k + off, kk);
      load8(v + off, vv);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) kk[e] = vv[e] = 0.0f;
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s = 0.0f;
#pragma unroll
      for (int e = 0; e < 8; ++e) s = fmaf(qv[g][e], kk[e], s);
      for (int o = P >> 1; o > 0; o >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, o);
      if (row_ok) {
        s *= scale;
        const float mn = fmaxf(m[g], s);
        const float corr = expf(m[g] - mn);   // 0 while m is -inf
        const float p = expf(s - mn);
        l[g] = l[g] * corr + p;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(p, vv[e], acc[g][e] * corr);
        m[g] = mn;
      }
    }
  }

  // merge the lane groups: smem holds, per group and head, m, l, acc[D]
  const int stride = D + 2;
  float* mine = smem + (lg * G) * stride;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (sub == 0) {
      mine[g * stride] = m[g];
      mine[g * stride + 1] = l[g];
    }
    if (has_chunk) {
#pragma unroll
      for (int e = 0; e < 8; ++e) mine[g * stride + 2 + sub * 8 + e] = acc[g][e];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_heads * D; i += kThreads) {
    const int g = i / D;
    const int d = i % D;
    float mx = -INFINITY;
    for (int j = 0; j < n_groups; ++j) mx = fmaxf(mx, smem[(j * G + g) * stride]);
    float lsum = 0.0f, a = 0.0f;
    for (int j = 0; j < n_groups; ++j) {
      const float* st = smem + (j * G + g) * stride;
      if (st[1] == 0.0f) continue;          // a group with no valid row
      const float w = expf(st[0] - mx);
      lsum = fmaf(w, st[1], lsum);
      a = fmaf(w, st[2 + d], a);
    }
    float* out = part + (((long long)b * H + h0 + g) * NS + sp) * stride;
    if (d == 0) {
      out[0] = mx;
      out[1] = lsum;
    }
    out[2 + d] = a;
  }
}

template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
    decode_combine(const float* __restrict__ part, const int* __restrict__ pos,
                   T* __restrict__ out, int H, int S, int D, int NS) {
  const int b = blockIdx.x / H;
  const int ns = (valid_rows(pos, b, S) + kSplitRows - 1) / kSplitRows;
  const int stride = D + 2;
  const float* st = part + (long long)blockIdx.x * NS * stride;
  float mx = -INFINITY;
  for (int i = 0; i < ns; ++i) mx = fmaxf(mx, st[i * stride]);
  for (int d = threadIdx.x; d < D; d += kCombineThreads) {
    float lsum = 0.0f, a = 0.0f;
    for (int i = 0; i < ns; ++i) {
      const float w = expf(st[i * stride] - mx);
      lsum = fmaf(w, st[i * stride + 1], lsum);
      a = fmaf(w, st[i * stride + 2 + d], a);
    }
    out[(long long)blockIdx.x * D + d] = from_float<T>(a / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int G>
int launch_split(const void* q, const void* k, const void* v, const int* pos,
                 float* part, int B, int H, int KV, int S, int D, int NS,
                 float scale, cudaStream_t stream) {
  int P = 1;
  while (P < D / 8) P <<= 1;
  const size_t smem = (size_t)kWarps * (32 / P) * G * (D + 2) * sizeof(float);
  const int chunks = (H / KV + G - 1) / G;
  const dim3 grid((unsigned int)(B * KV), (unsigned int)NS,
                  (unsigned int)chunks);
  decode_split<T, G><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, pos, part, H, KV, S, D, NS, P,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* pos,
           void* out, float* part, int B, int H, int KV, int S, int D,
           float scale, cudaStream_t stream) {
  const int NS = (S + kSplitRows - 1) / kSplitRows;
  int err;
  switch (H / KV) {
    case 1: err = launch_split<T, 1>(q, k, v, pos, part, B, H, KV, S, D, NS, scale, stream); break;
    case 2: err = launch_split<T, 2>(q, k, v, pos, part, B, H, KV, S, D, NS, scale, stream); break;
    case 3: err = launch_split<T, 3>(q, k, v, pos, part, B, H, KV, S, D, NS, scale, stream); break;
    case 4: err = launch_split<T, 4>(q, k, v, pos, part, B, H, KV, S, D, NS, scale, stream); break;
    case 5: err = launch_split<T, 5>(q, k, v, pos, part, B, H, KV, S, D, NS, scale, stream); break;
    case 6: err = launch_split<T, 6>(q, k, v, pos, part, B, H, KV, S, D, NS, scale, stream); break;
    case 7: err = launch_split<T, 7>(q, k, v, pos, part, B, H, KV, S, D, NS, scale, stream); break;
    // 8 and any larger group: chunks of 8 query heads (granite-20b's 48
    // heads on one kv head take 6 chunks)
    default: err = launch_split<T, 8>(q, k, v, pos, part, B, H, KV, S, D, NS, scale, stream); break;
  }
  if (err != 0) return err;
  decode_combine<T><<<(unsigned int)(B * H), kCombineThreads, 0, stream>>>(
      part, pos, (T*)out, H, S, D, NS);
  return (int)cudaGetLastError();
}

}  // namespace

// Rows of the cache that one block of pass 1 takes; the caller sizes the
// float32 scratch `part` as B * H * ceil(S / split_rows) * (D + 2).
extern "C" int decode_attention_split_rows() { return kSplitRows; }

// dtype: 0 float32, 1 bfloat16; pos: int32 (B,) or null for all rows
// valid. Launches both passes on `stream` and returns cudaGetLastError();
// 0 means launched. The caller (kernels/decode_attention.py) has checked
// shapes (D % 8 == 0, D <= 256, KV dividing H), types,
// contiguity and 16-byte alignment.
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* pos,
                                    void* out, void* part, int dtype, int B,
                                    int H, int KV, int S, int D, float scale,
                                    void* stream) {
  if (B == 0 || H == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k, v, (const int*)pos, out, (float*)part, B, H,
                         KV, S, D, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, (const int*)pos, out, (float*)part,
                                 B, H, KV, S, D, scale, s);
  return (int)cudaErrorInvalidValue;
}

// Fused 3x3 SAME convolution + bias + ReLU over NHWC float32, for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/conv_scorer.py::conv_scorer
// (body _conv_kernel). It computes what that kernel computes,
//     out = relu(conv3x3_sSAME(x, w) + b),
// x (N, H, W, Cin) NHWC, w (3, 3, Cin, Cout) HWIO, out (N, Ho, Wo, Cout),
// and is not a block-by-block copy of the Pallas grid.
//
// Bound on an H100 SXM (67 TFLOP/s fp32 without tensor cores, 3.35 TB/s),
// at the main path's largest chunk: 1024 frames of op_L5c32s100, five
// layers. Operations count 2*Cin per in-bounds tap of each output (taps
// on the SAME padding are skipped); bytes read x, w, b once and write out
// once.
//     L1 100x100x3  -> 50x50x32   4.36 GFLOP  451 MB   bytes       134 us
//     L2 50x50x32   -> 25x25x32  11.48 GFLOP  410 MB   operations  171 us
//     L3 25x25x32   -> 13x13x32   2.87 GFLOP  104 MB   operations   43 us
//     L4 13x13x32   -> 7x7x32     0.76 GFLOP   29 MB   operations   11 us
//     L5 7x7x32     -> 4x4x32     0.21 GFLOP  8.6 MB   operations  3.1 us
// About 19.7 GFLOP and 1.0 GB in all: 0.294 ms of fp32 operations against
// 0.299 ms of bytes, so the chunk as a whole is bound by bytes. Layer by
// layer the bounds sum to about 0.36 ms: operations set every layer but
// the first, which is set by its bytes. chip_smoke.py computes these
// bounds from each run's shapes and prints them beside the measured times.
//
// The design: an implicit GEMM on the CUDA cores (M = pixels, N = Cout,
// K = 9 * Cin), float32 throughout (the tensor cores would round x and w
// to TF32, three digits, against the 1e-4 limit).
//   * One block per strip of R output rows of one image, all Wo columns
//     and all Cout; the host picks R per layer so that a block has at
//     most 256 threads and at most 220 KB of shared memory, and the
//     strips of an image are as even as they can be. Tall strips read
//     fewer rows twice and load the weights fewer times; at layer 2 one
//     block of 9 rows an SM beat two of 4 (0.63 against 0.73 ms on an
//     H100, benchmarks/torch_kernel_variant.py).
//   * The 2R+1 input rows the strip needs come into shared memory once,
//     by cp.async: 16-byte copies of four channels where Cin is a
//     multiple of 4 (8, 16, 32), 4-byte copies otherwise (Cin 3). The
//     weights and the bias come in beside them.
//   * In shared memory a pixel takes S floats, S the least count >= Cin
//     with S = 4 (mod 8), and the columns of a row are stored grouped by
//     their index modulo the stride (even columns, then odd ones):
//     neighbouring output pixels then read neighbouring stored pixels,
//     S floats apart, and eight of them fall on eight different banks.
//   * A thread holds PX pixels x 8 output channels: PX = 4 (32
//     accumulators) on images of at least 512 output pixels, 2 on the
//     smaller ones of the later layers, where 4 would leave too few
//     threads to fill the card. For each tap and input channel it reads
//     the 8 weights as two float4 (the same address across the threads
//     of one channel group, so a broadcast) and does 8 PX FMAs; a pixel's
//     inputs come four channels at a time as one float4 where Cin is a
//     multiple of 4. At PX = 4 that is 0.16 shared-memory loads an FMA,
//     where the one-thread-per-output design made two. Neighbouring
//     threads take neighbouring channel groups of one pixel, then
//     neighbouring pixels, and a thread's pixels are spread over the
//     strip, so the threads of a warp read consecutive pixels.
//   * Stores are float4, co fastest: the channel groups of a pixel write
//     Cout * 4 contiguous bytes, and a warp's pixels are consecutive.
//     For layer 1 (Cin 3), whose output is most of the chunk's traffic,
//     that and reading x once are what count.
// The reduction order is that of the one-thread-per-output design: one
// float32 accumulator per output, taps in the order kh, kw, ci, each a
// fmaf(x, w, acc), then + b and relu. A tap on the SAME padding reads a
// zero pixel in shared memory instead of being skipped; fmaf(0, w, acc)
// is acc for a finite w (at most the sign of a zero acc differs, which
// + b and relu do not carry into the output), so the result is the
// same. An output reads only its own image's pixels, in an order fixed by
// (kh, kw, ci) alone, so its value depends neither on N nor on its place
// in a strip or a thread: zero rows that pad a batch to its bucket cannot
// change real rows, and the dispatch layers agree bit for bit.
//
// The grouped form (conv_scorer_grouped_f32) is the counterpart of
// jax.vmap of the Pallas kernel over a leading member axis, which the
// JAX package's stacked superbatch runs (repro/core/runtime.py:258):
// x (Q, N, H, W, Cin), w (Q, 3, 3, Cin, Cout), b (Q, Cout) -> out (Q, N,
// Ho, Wo, Cout), one launch for all Q members. The member is grid y;
// each block offsets x, w, b and out by its member and then does exactly
// what a block of the ungrouped launch does. The launch plan (pixels a
// thread, rows a strip, threads, shared memory) depends on the image
// shape alone, neither on N nor on Q, so member q's output is bit for
// bit the ungrouped kernel's on (x[q], w[q], b[q]).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCo = 8;               // output channels a thread holds
// pixels a thread holds: 4 where an image has at least kWide output
// pixels, 2 on the smaller images of the later layers, whose few
// outputs would otherwise leave too few threads to fill the card
constexpr int kWide = 512;
constexpr int kMaxThreads = 256;
constexpr int kSmemTarget = 220 * 1024;   // the tallest strips that fit
constexpr int kSmemMax = 232448;          // what one block may take

// Floats a pixel takes in shared memory: >= cin, = 4 (mod 8).
__host__ __device__ inline int pixel_stride(int cin) {
  const int s = (cin + 3) / 4 * 4;
  return s % 8 == 0 ? s + 4 : s;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// acc[j][c] += x[j] * w[c] for one input channel: x[j] the u-th value
// of xv[j], w the 8 weights at wp (two float4).
template <int PX>
__device__ __forceinline__ void fma_step(float (&acc)[PX][kCo],
                                         const float4 (&xv)[PX], int u,
                                         const float* wp) {
  const float4 w0 = *reinterpret_cast<const float4*>(wp);
  const float4 w1 = *reinterpret_cast<const float4*>(wp + 4);
  const float wv[kCo] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    const float x = u == 0 ? xv[j].x : u == 1 ? xv[j].y : u == 2 ? xv[j].z
                                                                 : xv[j].w;
#pragma unroll
    for (int c = 0; c < kCo; ++c) acc[j][c] = fmaf(x, wv[c], acc[j][c]);
  }
}

struct Shape {
  int H, W, Cin, Ho, Wo, stride, top, left;
  int R;        // output rows a block takes
  int strips;   // blocks an image takes
  int S;        // floats a pixel takes in shared memory
  int cols;     // stored columns of one residue class: ceil(W / stride)
  int RW;       // stored pixels a row takes: stride * cols >= W
  long long x_member;     // floats of x a member takes: N * H * W * Cin
  long long out_member;   // floats of out a member takes: N * Ho * Wo * Cout
};

// G channel groups of 8: Cout = 8 G; PX pixels a thread. VEC4: Cin is a
// multiple of 4, and a pixel's inputs are read four channels at a time.
template <int G, int PX, bool VEC4>
__global__ void __launch_bounds__(kMaxThreads)
    conv3x3_bias_relu(const float* __restrict__ x,
                      const float* __restrict__ w,
                      const float* __restrict__ b, float* __restrict__ out,
                      const Shape sh) {
  constexpr int Cout = kCo * G;
  extern __shared__ __align__(16) float smem[];
  const int Cin = sh.Cin, W = sh.W, S = sh.S;
  float* w_s = smem;                      // 9 * Cin * Cout, HWIO order
  float* b_s = w_s + 9 * Cin * Cout;      // Cout
  float* z_s = b_s + Cout;                // S zeros: the SAME padding
  float* x_s = z_s + S;                   // rows_in x RW pixels of S floats

  // the block's member (grid y): its slices of x, w, b and out
  const int m = blockIdx.y;
  x += m * sh.x_member;
  w += m * 9 * Cin * Cout;
  b += m * Cout;
  out += m * sh.out_member;
  const int n = blockIdx.x / sh.strips;
  const int ho0 = (blockIdx.x % sh.strips) * sh.R;
  const int rows_out = min(sh.R, sh.Ho - ho0);
  const int rows_in = (rows_out - 1) * sh.stride + 3;
  const int hi0 = ho0 * sh.stride - sh.top;   // image row of strip row 0
  // the strip rows that lie inside the image
  const int r_lo = max(0, -hi0);
  const int r_hi = min(rows_in, sh.H - hi0);

  // -- the strip, the weights and the bias into shared memory ------------
  const float* xn = x + (long long)n * sh.H * W * Cin;
  if (Cin % 4 == 0) {
    const int c4 = Cin / 4;
    const int units = (r_hi - r_lo) * W * c4;
    for (int u = threadIdx.x; u < units; u += blockDim.x) {
      const int q = u % c4;
      const int pix = u / c4;                   // (r - r_lo) * W + col
      const int col = pix % W;
      const int r = r_lo + pix / W;
      const int pos = (col % sh.stride) * sh.cols + col / sh.stride;
      cp_async16(x_s + (r * sh.RW + pos) * S + 4 * q,
                 xn + ((long long)(hi0 + r) * W + col) * Cin + 4 * q);
    }
  } else {
    const int units = (r_hi - r_lo) * W;
    for (int u = threadIdx.x; u < units; u += blockDim.x) {
      const int col = u % W;
      const int r = r_lo + u / W;
      const int pos = (col % sh.stride) * sh.cols + col / sh.stride;
      const float* src = xn + ((long long)(hi0 + r) * W + col) * Cin;
      float* dst = x_s + (r * sh.RW + pos) * S;
      for (int ci = 0; ci < Cin; ++ci) cp_async4(dst + ci, src + ci);
    }
  }
  const int nw4 = 9 * Cin * Cout / 4;     // Cout is a multiple of 8
  for (int i = threadIdx.x; i < nw4; i += blockDim.x)
    cp_async16(w_s + 4 * i, w + 4 * i);
  for (int i = threadIdx.x; i < Cout; i += blockDim.x) b_s[i] = b[i];
  for (int i = threadIdx.x; i < S; i += blockDim.x) z_s[i] = 0.0f;
  cp_async_wait_all();
  __syncthreads();

  // -- 4 pixels x 8 channels a thread ------------------------------------
  const int cg = threadIdx.x % G;
  const int pg = threadIdx.x / G;
  const int n_pg = blockDim.x / G;
  const int npix = rows_out * sh.Wo;
  int prow[PX], pcol[PX];   // strip row and column of each pixel
  bool pok[PX];
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    const int p = pg + j * n_pg;
    pok[j] = p < npix;
    prow[j] = pok[j] ? p / sh.Wo : 0;
    pcol[j] = pok[j] ? p % sh.Wo : 0;
  }
  float acc[PX][kCo];
#pragma unroll
  for (int j = 0; j < PX; ++j)
#pragma unroll
    for (int c = 0; c < kCo; ++c) acc[j][c] = 0.0f;

  for (int kh = 0; kh < 3; ++kh) {
    for (int kw = 0; kw < 3; ++kw) {
      // the tap's input column is pcol * stride + d: stored in residue
      // class d mod stride, shift + pcol places along it
      const int d = kw - sh.left;
      const int res = (d % sh.stride + sh.stride) % sh.stride;
      const int shift = (d - res) / sh.stride;
      const float* xp[PX];
#pragma unroll
      for (int j = 0; j < PX; ++j) {
        const int r = prow[j] * sh.stride + kh;
        const int hi = hi0 + r;
        const int col = pcol[j] * sh.stride + d;
        const bool in = pok[j] && hi >= 0 && hi < sh.H && col >= 0 && col < W;
        xp[j] = in ? x_s + (r * sh.RW + res * sh.cols + pcol[j] + shift) * S
                   : z_s;
      }
      const float* wp = w_s + (kh * 3 + kw) * Cin * Cout + cg * kCo;
      if (VEC4) {
        for (int c4 = 0; c4 < Cin; c4 += 4) {
          float4 xv[PX];
#pragma unroll
          for (int j = 0; j < PX; ++j)
            xv[j] = *reinterpret_cast<const float4*>(xp[j] + c4);
#pragma unroll
          for (int u = 0; u < 4; ++u)
            fma_step(acc, xv, u, wp + (c4 + u) * Cout);
        }
      } else {
#pragma unroll 4
        for (int ci = 0; ci < Cin; ++ci) {
          float4 xv[PX];
#pragma unroll
          for (int j = 0; j < PX; ++j) xv[j].x = xp[j][ci];
          fma_step(acc, xv, 0, wp + ci * Cout);
        }
      }
    }
  }

  // -- + bias, relu, 16-byte stores --------------------------------------
  const float* bp = b_s + cg * kCo;
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    if (!pok[j]) continue;
    float v[kCo];
#pragma unroll
    for (int c = 0; c < kCo; ++c) {
      const float t = acc[j][c] + bp[c];
      v[c] = t > 0.0f ? t : 0.0f;
    }
    float* o = out + (((long long)n * sh.Ho + ho0 + prow[j]) * sh.Wo +
                      pcol[j]) * Cout + cg * kCo;
    *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(o + 4) = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// Shared memory of a block taking R output rows.
size_t smem_bytes(const Shape& sh, int Cout, int R) {
  const int rows_in = (R - 1) * sh.stride + 3;
  return sizeof(float) * ((size_t)9 * sh.Cin * Cout + Cout + sh.S +
                          (size_t)rows_in * sh.RW * sh.S);
}

int threads_for(const Shape& sh, int Cout, int R, int px) {
  return (R * sh.Wo + px - 1) / px * (Cout / kCo);
}

template <int G, int PX, bool VEC4>
int launch_vec(const float* x, const float* w, const float* b, float* out,
               int Q, int N, const Shape& sh, int threads, size_t smem,
               cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv3x3_bias_relu<G, PX, VEC4>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (attr != cudaSuccess) return (int)attr;
  const long long blocks = (long long)N * sh.strips;
  conv3x3_bias_relu<G, PX, VEC4>
      <<<dim3((unsigned int)blocks, (unsigned int)Q), threads, smem, stream>>>(
          x, w, b, out, sh);
  return (int)cudaGetLastError();
}

template <int G, int PX>
int launch_px(const float* x, const float* w, const float* b, float* out,
              int Q, int N, const Shape& sh, int threads, size_t smem,
              cudaStream_t stream) {
  return sh.Cin % 4 == 0
             ? launch_vec<G, PX, true>(x, w, b, out, Q, N, sh, threads, smem,
                                       stream)
             : launch_vec<G, PX, false>(x, w, b, out, Q, N, sh, threads,
                                        smem, stream);
}

template <int G>
int launch(const float* x, const float* w, const float* b, float* out, int Q,
           int N, Shape sh, cudaStream_t stream) {
  constexpr int Cout = kCo * G;
  const int px = sh.Ho * sh.Wo >= kWide ? 4 : 2;
  // the most rows a block may take, then as even strips as there can be;
  // none of it looks at N or Q, so a member's bits do not depend on them
  int r_max = 1;
  while (r_max < sh.Ho &&
         threads_for(sh, Cout, r_max + 1, px) <= kMaxThreads &&
         smem_bytes(sh, Cout, r_max + 1) <= (size_t)kSmemTarget)
    ++r_max;
  sh.strips = (sh.Ho + r_max - 1) / r_max;
  sh.R = (sh.Ho + sh.strips - 1) / sh.strips;
  const size_t smem = smem_bytes(sh, Cout, sh.R);
  const int threads = threads_for(sh, Cout, sh.R, px);
  if (smem > (size_t)kSmemMax || threads > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  return px == 4
             ? launch_px<G, 4>(x, w, b, out, Q, N, sh, threads, smem, stream)
             : launch_px<G, 2>(x, w, b, out, Q, N, sh, threads, smem, stream);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); 0 means launched.
// The caller (kernels/conv_scorer.py) has checked shapes (Cout 8, 16, 24
// or 32), types, contiguity and 16-byte alignment, and computed the
// output size and the SAME padding offsets. Q members of N images each,
// every array with the member as its leading axis.
extern "C" int conv_scorer_grouped_f32(const void* x, const void* w,
                                       const void* b, void* out, int Q, int N,
                                       int H, int W, int Cin, int Cout, int Ho,
                                       int Wo, int stride, int top, int left,
                                       void* stream) {
  if ((long long)Q * N * Ho * Wo * Cout == 0) return 0;
  if (Q > 65535) return (int)cudaErrorInvalidValue;   // grid y
  const int cols = (W + stride - 1) / stride;
  Shape sh{H,    W,    Cin,  Ho,   Wo, stride, top, left,
           1,    1,    pixel_stride(Cin),      cols, stride * cols,
           (long long)N * H * W * Cin, (long long)N * Ho * Wo * Cout};
  const cudaStream_t s = (cudaStream_t)stream;
  const float *xf = (const float*)x, *wf = (const float*)w,
              *bf = (const float*)b;
  float* of = (float*)out;
  switch (Cout) {
    case 8: return launch<1>(xf, wf, bf, of, Q, N, sh, s);
    case 16: return launch<2>(xf, wf, bf, of, Q, N, sh, s);
    case 24: return launch<3>(xf, wf, bf, of, Q, N, sh, s);
    case 32: return launch<4>(xf, wf, bf, of, Q, N, sh, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The ungrouped launch: one member.
extern "C" int conv_scorer_f32(const void* x, const void* w, const void* b,
                               void* out, int N, int H, int W, int Cin,
                               int Cout, int Ho, int Wo, int stride, int top,
                               int left, void* stream) {
  return conv_scorer_grouped_f32(x, w, b, out, 1, N, H, W, Cin, Cout, Ho, Wo,
                                 stride, top, left, stream);
}

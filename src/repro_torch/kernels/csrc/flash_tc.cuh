// The tensor-core pieces that flash attention's forward
// (flash_attention.cu) and backward (flash_attention_bwd.cu) share, in
// bf16 for sm_90a: the shared-memory layout of a 64-row tile of one head
// of a (B, S, heads, D) tensor as TMA brings it, the product of two such
// tiles over the head dim (S = Q.K^T, and in the backward dP = dO.V^T and
// their transposes), the product of a 64 x 64 register operand with a
// tile (O += P.V, and in the backward dV += P^T.dO, dK += dS^T.Q,
// dQ += dS.K), and a fast 2^x.
#pragma once
#include "hopper.cuh"

namespace repro_torch {
namespace flash_tc {

namespace hp = repro_torch::hopper;

constexpr int kTile = 64;   // rows of every tile

// Rows are 128-byte-swizzled 64-element column blocks (D 64, 80, 128,
// 256; D 80 is a block of 64 and one of 16 real and 48 zero columns,
// which TMA fills past the tensor's edge), or one 64- or 32-byte-swizzled
// block (D 32, 16).
template <int D>
struct TcTile {
  static constexpr int kCols = D >= 64 ? 64 : D;   // elements per row
  static constexpr int kRow = kCols * 2;           // bytes per swizzled row
  static constexpr int kBlocks = (D + kCols - 1) / kCols;
  static constexpr int kBlock = 64 * kRow;         // 64 rows of one block
  static constexpr int kOperand = kBlocks * kBlock;  // a 64-row tile
  static constexpr int kStages = D <= 64 ? 3 : 2;    // of the tile ring
};

// S = A.B^T of two 64-row tiles over the head dim: D/16 wgmma m64n64k16,
// both operands K-major in shared memory; started and committed, not
// waited for. Thread t of the warpgroup then holds rows r = 16 (t / 32)
// + (t % 32) / 4 and r + 8 of A, columns 8j + 2 (t % 4) + {0, 1} of B's
// rows, as hopper.cuh describes.
template <int D>
__device__ __forceinline__ void scores_async(float (&sc)[32],
                                             const uint8_t* a_s,
                                             const uint8_t* b_s) {
  using L = TcTile<D>;
  hp::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off =
        (kk * 16 / L::kCols) * L::kBlock + (kk * 16 % L::kCols) * 2;
    hp::Wgmma<64>::ss<0, 0>(
        sc, hp::make_desc(a_s + off, 16, 8 * L::kRow, L::kRow),
        hp::make_desc(b_s + off, 16, 8 * L::kRow, L::kRow), kk > 0);
  }
  hp::wgmma_commit();
}

// O += P.B over one 64-row tile B: P (64 x 64) from registers in the
// accumulator layout of scores_async, B the MN-major operand in shared
// memory; started and committed, not waited for. D 256 is two n128
// products over the two halves of B (column blocks 0-1 and 2-3): the
// accumulator layout of the halves is that of one n256 product, so o
// stays one array.
template <int D>
__device__ __forceinline__ void pv_async(float (&o)[D / 2],
                                         const uint32_t (&pa)[4][4],
                                         const uint8_t* b_s) {
  using L = TcTile<D>;
  constexpr int kN = D > 128 ? 128 : D;   // columns of one product
  hp::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
    for (int half = 0; half < D / kN; ++half)
      hp::Wgmma<kN>::template rs<1>(
          *reinterpret_cast<float(*)[kN / 2]>(o + half * kN / 2), pa[kk],
          hp::make_desc(b_s + half * (kN / L::kCols) * L::kBlock +
                            kk * 16 * L::kRow,
                        L::kBlock, 8 * L::kRow, L::kRow),
          1);
  hp::wgmma_commit();
}

// Pins registers that an asynchronous wgmma wrote, after the wait that
// completes it: reads of them cannot be moved above this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// 2^x by the SFU's ex2.approx (relative error ~2^-22, subnormal results
// flushed to zero), below what rounding P to bf16 loses; exp2f adds a
// range fix-up around the same instruction.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The TMA map of a bf16 (B, S, heads, D) tensor as (D, heads, S, B),
// innermost first, in boxes of one 64-row column block of one head.
inline bool tile_map(CUtensorMap* map, const void* p, int B, int S,
                     int heads, int D) {
  const int cols = D >= 64 ? 64 : D;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)kTile, 1};
  return hp::encode_bf16(map, p, 4, dims, strides, box);
}

}  // namespace flash_tc
}  // namespace repro_torch

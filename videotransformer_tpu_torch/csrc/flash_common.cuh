// Pieces shared by the q-blocked flash-attention kernels (flash_attention.cu,
// the forward, and flash_attention_bwd.cu, the backward).
//
// Tensors are (B·H, N, HD) bf16, row-major, HD a multiple of 16 (the kernels
// are instantiated for HD = 32, 64, 96 and 128). A tile is kFlashRows rows
// of one (b·h) slice in shared memory with rows padded to HD + 8 elements:
// the 8 row addresses of one ldmatrix then fall into 8 different 16-byte
// bank groups for every instantiated HD, so the fragment reads are
// conflict-free. Rows past the slice's length are zero-filled (cp.async with
// a source size of 0), so a ragged edge reads zeros and never memory past
// the tensor.
#pragma once

#include "gemm_tile.cuh"

namespace vt {

constexpr int kFlashRows = 64;     // queries or keys per tile
constexpr int kFlashWarps = 4;     // 16 rows of a tile per warp
constexpr int kFlashThreads = kFlashWarps * 32;

template <int HD>
struct FlashTile {
  static constexpr int kLd = HD + 8;                  // padded row, elements
  static constexpr int kElems = kFlashRows * kLd;     // one tile
  static_assert(HD % 16 == 0 && HD <= 128, "head dim");
};

// Tile rows row0 .. row0 + kFlashRows of a (n, HD) slice into dst; rows at
// or past n are zero-filled. Every thread of the block takes part.
template <int HD>
__device__ __forceinline__ void load_flash_tile(bf16* dst, const bf16* src,
                                                int row0, int n) {
  constexpr int kChunks = HD / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < kFlashRows * kChunks; c += kFlashThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    const int gr = row0 + r;
    const bool valid = gr < n;
    cp_async16(dst + r * FlashTile<HD>::kLd + col,
               src + (size_t)(valid ? gr : 0) * HD + col, valid);
  }
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// The A fragments (16 rows x 16 k) of a product whose A operand is a 16 x 64
// fp32 accumulator tile (eight n8 tiles) rounded to bf16: the accumulator
// layout of m16n8k16 is its A-operand layout, so no data moves between lanes.
__device__ __forceinline__ void acc_to_a(uint32_t* a, const float (*acc)[4],
                                         int kt) {
  a[0] = pack_bf16x2(acc[2 * kt][0], acc[2 * kt][1]);
  a[1] = pack_bf16x2(acc[2 * kt][2], acc[2 * kt][3]);
  a[2] = pack_bf16x2(acc[2 * kt + 1][0], acc[2 * kt + 1][1]);
  a[3] = pack_bf16x2(acc[2 * kt + 1][2], acc[2 * kt + 1][3]);
}

// acc (16 x 64, eight n8 tiles) = A (16 rows of a tile stored [row][HD],
// row stride kLd) · Bᵀ, B a whole 64-row tile stored [row][HD]: the score
// products Q·Kᵀ, dO·Vᵀ, K·Qᵀ and V·dOᵀ.
template <int HD>
__device__ __forceinline__ void tile_product_nt(float (*acc)[4],
                                                const bf16* a_rows,
                                                const bf16* b_tile, int lane) {
  constexpr int LD = FlashTile<HD>::kLd;
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    uint32_t a[4];
    load_a_mk(a, a_rows + ks * 16, LD, lane);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t r[4];
      load_b_nk(r, b_tile + (j * 16) * LD + ks * 16, LD, lane);
      const uint32_t b0[2] = {r[0], r[1]};
      const uint32_t b1[2] = {r[2], r[3]};
      mma_16816(acc[2 * j], a, b0);
      mma_16816(acc[2 * j + 1], a, b1);
    }
  }
}

// out (16 x HD, HD/8 n8 tiles) += bf16(p) (16 x 64, an accumulator tile) · B,
// B a whole 64-row tile stored [row][HD] (rows are the product's k): the
// products P·V, dS·K, Pᵀ·dO and dSᵀ·Q.
template <int HD>
__device__ __forceinline__ void tile_product_acc(float (*out)[4],
                                                 const float (*p)[4],
                                                 const bf16* b_tile,
                                                 int lane) {
  constexpr int LD = FlashTile<HD>::kLd;
#pragma unroll
  for (int kt = 0; kt < 4; ++kt) {
    uint32_t a[4];
    acc_to_a(a, p, kt);
#pragma unroll
    for (int dn = 0; dn < HD / 16; ++dn) {
      uint32_t r[4];
      load_b_kn(r, b_tile + (kt * 16) * LD + dn * 16, LD, lane);
      const uint32_t b0[2] = {r[0], r[1]};
      const uint32_t b1[2] = {r[2], r[3]};
      mma_16816(out[2 * dn], a, b0);
      mma_16816(out[2 * dn + 1], a, b1);
    }
  }
}

}  // namespace vt

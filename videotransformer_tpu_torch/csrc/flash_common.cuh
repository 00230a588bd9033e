// Pieces shared by the tensor-core attention kernels: the flash-attention
// forward and backward (flash_attention.cu, flash_attention_bwd.cu) and the
// fused MHSA's attention stages (fused_mhsa.cu, fused_mhsa_bwd.cu).
//
// Tensors are (B·H, N, HD) bf16, row-major, HD 32, 64, 96 or 128. A tile of
// R rows of one (b·h) slice lies in shared memory as HD / PW column panels of
// R x PW, PW = 64 where HD is a multiple of 64 and 32 otherwise, each panel
// swizzled by its row of PW * 2 bytes (128 or 64): the layout one TMA box per
// panel writes and wgmma reads through a descriptor. A 96-wide head (192-byte
// rows, not a multiple of the 128-byte swizzle span) is three 64-byte panels.
// The same panels serve both operand orders: read K-major (rows are the
// product's m or n, the head dim its k: Q·Kᵀ, K·Qᵀ) or MN-major (rows are
// the product's k, the head dim its n: P·V, dS·K, Pᵀ·dO, dSᵀ·Q).
#pragma once

#include "sm90.cuh"

namespace vt {

using bf16 = __nv_bfloat16;

// The dq pass of the two-pass backward (and the forward at head dims other
// than 64, FwdCfg in flash_fwd.cuh): a block of two consumer warpgroups,
// each owning 64 query rows, and a producer warpgroup (one thread of it
// issues the TMA loads) that gives its registers to the consumers.
constexpr int kFlashBM = 128;  // queries a block
constexpr int kFlashThreads = 384;
constexpr int kFlashStages = 3;  // the K/V ring
constexpr int kFlashProducerRegs = 24;
constexpr int kFlashConsumerRegs = 240;
constexpr int kFlashBN = 80;   // keys a tile (forward and dq pass)
constexpr int kFlashBQ = 64;   // queries a tile (dk/dv pass)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int HD>
struct Panels {
  static_assert(HD % 32 == 0 && HD >= 32 && HD <= 128, "head dim");
  static constexpr int kPW = HD % 64 == 0 ? 64 : 32;  // panel width
  static constexpr int kCount = HD / kPW;
  static constexpr uint32_t kSwizzle = kPW == 64 ? 1 : 2;  // descriptor code
  static constexpr uint32_t kRowBytes = kPW * 2;
  static constexpr uint32_t kGroupBytes = 8 * kRowBytes;  // 8 rows (SBO)
};

// Turns of the consumer warpgroups at the tensor cores (named barriers 1,
// 2, ...: one a warpgroup): a warpgroup issues its products only in its
// turn and then passes the turn to the next, round the `n` warpgroups that
// have rows, so one warpgroup's exponentials run while another's products
// do. All take the same number of turns; warpgroup 0 goes first. Off
// (every call a no-op) when one warpgroup alone has rows.
struct TensorTurns {
  int me, n;
  __device__ __forceinline__ TensorTurns(int wg, int active)
      : me(wg), n(active) {
    if (n > 1 && me == n - 1) sm90::bar_arrive(1, 256);
  }
  __device__ __forceinline__ void wait() {
    if (n > 1) sm90::bar_sync(1 + me, 256);
  }
  // The last turn of the last warpgroup passes nothing: warpgroup 0 takes
  // no more.
  __device__ __forceinline__ void pass(bool last) {
    if (n > 1 && !(last && me == n - 1))
      sm90::bar_arrive(me + 1 < n ? me + 2 : 1, 256);
  }
};

// Descriptor of k16 step ks (head-dim columns 16ks..16ks+15) of the rows
// row0.. (a multiple of 8) of a ROWS-row tile, read K-major.
template <int HD, int ROWS>
__device__ __forceinline__ uint64_t desc_kmajor(const bf16* tile, int row0,
                                                int ks) {
  using P = Panels<HD>;
  constexpr int kSteps = P::kPW / 16;  // k16 steps a panel
  const bf16* p = tile + (ks / kSteps) * ROWS * P::kPW + row0 * P::kPW +
                  (ks % kSteps) * 16;
  return sm90::make_desc(p, 16, P::kGroupBytes, P::kSwizzle);
}

// The wgmma A fragments of this warp's 16 rows row0.. (a multiple of 16) of
// a tile of 64-column rows in shared memory (hd 64: one 128-byte swizzled
// panel, chunk c of row r at c ^ (r mod 8)), k16 step ks in a[4ks..4ks+3]:
// for a product whose A operand stays the same over a loop, loaded once, it
// reads half the shared memory of one with both operands there (at n = 64
// the two take the SM's whole 128 bytes a clock).
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[16],
                                             const bf16* tile, int row0,
                                             int lane) {
  const int m = lane >> 3;  // the matrix this lane addresses: rows +8,
  const int r = row0 + (m & 1) * 8 + (lane & 7);  // columns +8 (m >> 1)
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int c = 2 * ks + (m >> 1);
    sm90::ldmatrix_x4(a + 4 * ks, tile + r * 64 + ((c ^ (r & 7)) << 3));
  }
}

// Descriptor of rows 16kk..16kk+15 of a ROWS-row tile read MN-major, as the
// B operand whose k is the tile's rows and whose n is the head dim: LBO steps
// from one panel to the next along n, SBO from 8 rows to the next along k.
template <int HD, int ROWS>
__device__ __forceinline__ uint64_t desc_mnmajor(const bf16* tile, int kk) {
  using P = Panels<HD>;
  return sm90::make_desc(tile + kk * 16 * P::kPW, ROWS * P::kRowBytes,
                         P::kGroupBytes, P::kSwizzle);
}

// TMA loads of the ROWS x HD tile at rows row0.. and columns col0.. of
// batch entry z of a map, one box a panel, counted on `bar` (ROWS * HD * 2
// bytes, zero-filled rows included).
template <int HD, int ROWS>
__device__ __forceinline__ void tma_tile(bf16* tile, const CUtensorMap* map,
                                         uint64_t* bar, int col0, int row0,
                                         int z) {
  using P = Panels<HD>;
#pragma unroll
  for (int p = 0; p < P::kCount; ++p)
    sm90::tma_load_3d(tile + p * ROWS * P::kPW, map, bar, col0 + p * P::kPW,
                      row0, z);
}

// Where the (b·h) slice bh of each operand of the flash kernels lies.
// B5 and B6 take (B·H, N, HD) tensors: slice bh is batch entry bh of the
// maps, columns from 0, output rows HD elements apart (`heads` 1:
// plain_layout). B1's and B3's long attention read q, k and v in place from
// qkv (rows, 3·Da), do and o from (rows, Da), and write attn (rows, Da) or
// dqkv (rows, 3·Da) in place: slice bh is head bh % heads of sequence
// bh / heads (the maps' batch entry), whose columns start head·HD past the
// operand's own first column (q 0, k Da, v 2Da within qkv; do and o 0).
struct HeadLayout {
  int heads;
  int q_col, k_col, v_col;  // first columns of q, k, v in their maps
  int q_ld, kv_ld;          // row strides of the outputs o / dq and dk / dv
  __device__ __forceinline__ int seq(int bh) const { return bh / heads; }
  __device__ __forceinline__ int head_col(int bh, int hd) const {
    return (bh % heads) * hd;
  }
  // offset of row `row` of slice bh in an output of N rows a sequence
  __device__ __forceinline__ size_t out_row(int bh, int N, int row, int ld,
                                            int hd) const {
    return ((size_t)seq(bh) * N + row) * ld + head_col(bh, hd);
  }
};

inline HeadLayout plain_layout(int hd) { return {1, 0, 0, 0, hd, hd}; }

// The 1024-byte aligned start of dynamic shared memory (swizzled panels
// repeat every 8 rows, up to 1024 bytes); launches ask for 1024 bytes more.
__device__ __forceinline__ unsigned char* flash_smem_base(unsigned char* raw) {
  const uint32_t a = sm90::smem_addr(raw);
  return raw + ((1024 - (a & 1023)) & 1023);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragments of a product whose A operand is a 64 x N fp32 accumulator
// rounded to bf16: wgmma's accumulator layout is its register-A layout (k16
// step kk takes n8 blocks 2kk and 2kk + 1), so a[i] packs acc[2i], acc[2i+1]
// and no data moves between threads.
template <int R>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[R / 2],
                                         const float (&acc)[R]) {
#pragma unroll
  for (int i = 0; i < R / 2; ++i) a[i] = pack_bf16x2(acc[2 * i], acc[2 * i + 1]);
}

// Column (within the n extent) of accumulator element i of this thread
// (t = lane % 4); it lies on row lane / 4 + 8 when (i >> 1) & 1.
__device__ __forceinline__ int acc_col(int i, int t) {
  return (i / 4) * 8 + 2 * t + (i & 1);
}

// Softmax of one 64-row score tile held in wgmma's accumulator layout, in
// place (s -> p in fp32): scores × scale, keys with valid(row, col) false
// get p = 0, the max over the row's valid keys, p = exp(s - max), and the
// row sums (of this thread's rows lane/4 and lane/4 + 8) before rounding.
// `col0` offsets the columns of this accumulator within the row.
template <int R, class Valid>
__device__ __forceinline__ void scale_and_max(float (&s)[R], float (&mx)[2],
                                              int col0, int t, float scale,
                                              Valid valid) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int h = (i >> 1) & 1;
    s[i] *= scale;
    if (valid(h, col0 + acc_col(i, t))) mx[h] = fmaxf(mx[h], s[i]);
  }
}

template <int R, class Valid>
__device__ __forceinline__ void exp_and_sum(float (&s)[R], const float (&mx)[2],
                                            float (&sum)[2], int col0, int t,
                                            Valid valid) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int h = (i >> 1) & 1;
    const bool in = valid(h, col0 + acc_col(i, t));
    const float p = in ? __expf(s[i] - mx[h]) : 0.0f;
    sum[h] += p;  // the row sum is taken before p is rounded
    s[i] = p;
  }
}

__device__ __forceinline__ void quad_reduce(float (&v)[2], bool is_max) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      const float w = __shfl_xor_sync(0xffffffffu, v[h], o);
      v[h] = is_max ? fmaxf(v[h], w) : v[h] + w;
    }
}

// Host: a map reading ROWS-row tiles of a (BH, N, HD) bf16 tensor in panels.
template <int HD>
inline bool flash_map(CUtensorMap* map, const void* base, int BH, int N,
                      int rows) {
  return make_tensor_map_3d(map, base, BH, N, HD, rows, Panels<HD>::kPW);
}

}  // namespace vt

// A warp-specialised bf16 GEMM for Hopper (sm_90a): TMA loads through an
// mbarrier ring, wgmma products with fp32 accumulators in registers, and
// the epilogues of the port's fused kernels applied from the registers.
// Used by fused_mhsa.cu (B1: the qkv product with LayerNorm folded into its
// A operand, the output projection with the residual), fused_ffn.cu (B2:
// fc1 with the bias and GELU, fc2 with the bias), fused_ffn_bwd.cu (B4: dh
// with the GELU backward, the weight gradients split over the rows, dxn) and
// fused_mhsa_bwd.cu (B3: the projection gradients, do, d_xn, d_wqkv).
//
//   C[M, N] = epilogue(A · B)
//
// Operand layouts (template flags):
//   TA = 0: A stored [M][K] (K contiguous)      TA = 1: A stored [K][M]
//   TB = 0: B stored [N][K] (nn.Linear's W)     TB = 1: B stored [K][N]
// TA = 1 / TB = 1 read the operand MN-major straight from shared memory
// (wgmma's transpose bits), so no transpose pass touches device memory: a
// weight gradient gᵀ·h reads g and h as they lie, [rows][·].
//
// Persistent blocks, one a SM, walk the 128 x BN output tiles (n fastest,
// so the blocks running together share A's rows in L2), K step 64; BN is
// 128, or 256 for LN_A (below).
// Warpgroup 2 gives up its registers (setmaxnreg) and one of its threads
// keeps TMA loads in flight through a ring of kStages stages, tile after
// tile. Warpgroups 0 and 1 take the block's tiles in turn (ping-pong): each
// issues two m64n128k16 wgmma products a k16 step for its whole tile,
// releases a stage once the products that read it are done, and applies
// the epilogue from registers while the other warpgroup's products run, so
// the epilogues and their stores overlap the tensor cores' work. Each tile
// (and each split-K slice of it) is summed whole by one warpgroup in k
// order, so the result does not depend on the number of blocks.
// Tiles lie in shared memory as TMA writes them with the 128-byte swizzle:
// K-major tiles as rows of 64 k, MN-major tiles as panels of 64 m (or n) by
// 64 k. Rows past M or N and k past K are zero-filled by TMA and masked on
// store, so M and K may be ragged; N and the row strides must be multiples
// of 8 (16-byte TMA strides).
//
// Split K: slice z takes k tiles [z·per, (z+1)·per) and, with an fp32
// epilogue, writes its own partial C[z][M][N]; the caller sums the slices in
// index order (no atomics: the same bits on every run). The slice count is
// the caller's, from the shape alone.
//
// LN_A: the A operand is LayerNorm'ed in shared memory before its products
// (xn = bf16(((x - mean) · rstd) · w + b), per-row mean and rstd from a
// pre-pass), so the normalised rows never reach device memory. Those
// products run cooperatively on 128 x 256 tiles: each consumer warpgroup
// rewrites its 64 rows of each stage, fences them for the tensor cores and
// issues its products. Each A tile is rewritten once for each 256-column
// block (nine times at qkv's 2304 columns), which costs more than the
// products' own issue: see PERF.md for the measured price of the fold.
#pragma once

#include "sm90.cuh"

namespace vt {
namespace wg {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;
constexpr int kBK = 64;
constexpr int kThreads = 384;  // consumer warpgroups 0, 1; producer 2
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr uint32_t kABytes = kBM * kBK * 2;

template <int BN>
struct Cfg {
  static_assert(BN == 128 || BN == 256, "tile width");
  static constexpr int kStages = BN == 128 ? 6 : 4;
  static constexpr uint32_t kBBytes = BN * kBK * 2;
  static constexpr size_t kSmem =
      1024 + (size_t)kStages * (kABytes + kBBytes) + 16 * kStages;
};

enum Epi {
  kBias = 0,          // C = bf16(acc + bias)
  kBiasResidual = 1,  // C = bf16(acc + bias + aux_in)
  kF32 = 2,           // C (fp32, split-K slice z) = acc
  kGeluBwd = 3,       // d = acc · gelu'(aux_in); C = bf16(d);
                      // aux_out = bf16(gelu(aux_in)); col_part += d by column
  kBiasGelu = 4,      // C = bf16(gelu(acc + bias))
  kBiasGeluSave = 5,  // the same, and aux_out = bf16(acc + bias)
  kPlain = 6,         // C = bf16(acc)
};

struct Params {
  const bf16* bias;      // [N]
  const bf16* aux_in;    // [M][N]: residual, or h_pre (kGeluBwd)
  void* C;               // [M][N] bf16, or [slices][M][N] fp32 (kF32)
  bf16* aux_out;         // [M][N] (kGeluBwd, kBiasGeluSave)
  float* col_part;       // [8 · ceil(M / 128)][N] (kGeluBwd): one row a warp
  const float2* ln_stats;  // [M] (mean, rstd) (LN_A)
  const bf16* ln_w;        // [K] (LN_A)
  const bf16* ln_b;        // [K] (LN_A)
  int M, N, K;
  int ktiles_per_slice;  // k tiles of one split-K slice
};

// Rows of the column partials a kGeluBwd launch over M rows writes.
inline int col_part_rows(int M) { return 8 * ((M + kBM - 1) / kBM); }

// The exact erf-GELU of v and its derivative (fused_ffn_pallas.py::
// _gelu_grad), sharing one erff: gelu = 0.5·v·(1 + erf(v/√2)), gelu' =
// cdf + v·pdf; of two values at once, (gelu(v.x), gelu'(v.x), gelu(v.y),
// gelu'(v.y)). Not inlined: the epilogue calls it 64 times a thread, and
// inlined copies of erff and expf overflow the instruction cache; two values
// a call keep two independent chains in flight.
__device__ __noinline__ float4 gelu_and_grad(float2 v) {
  const float ex = erff(v.x * 0.70710678118654752f);
  const float ey = erff(v.y * 0.70710678118654752f);
  const float px = expf(-0.5f * v.x * v.x) * 0.39894228040143268f;
  const float py = expf(-0.5f * v.y * v.y) * 0.39894228040143268f;
  return make_float4(0.5f * v.x * (1.0f + ex), 0.5f * (1.0f + ex) + v.x * px,
                     0.5f * v.y * (1.0f + ey), 0.5f * (1.0f + ey) + v.y * py);
}

// A thread's 16 values of one group of four 8-column blocks, [block][half]
// [2], as the epilogue below walks them.
struct Floats16 {
  float v[16];
};

// The exact erf-GELU, 0.5·v·(1 + erf(v/√2)), with erff (fp32 rounding, as
// torch.erf), of one group's 16 values: not inlined, for the reason above,
// and 16 values a call, because one warp a scheduler runs the epilogue and
// the call's independent erff chains are what hide their latency (fc1 at
// (37656, 768) on an H100: 2 values a call 0.537 ms, 4 0.491, 16 0.471;
// PERF.md).
__device__ __noinline__ Floats16 gelu16(Floats16 a) {
  Floats16 r;
#pragma unroll
  for (int i = 0; i < 16; ++i)
    r.v[i] = 0.5f * a.v[i] * (1.0f + erff(a.v[i] * 0.70710678118654752f));
  return r;
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (64 x N fp32 over the warpgroup) += A · B, one k16 step, both operands
// from shared memory; TA / TB as at the top (the instruction's transpose
// bits: 0 K-major, 1 MN-major). Accumulator layout as sm90::Wgmma's.
template <int N, int TA, int TB>
struct WgmmaSS;

template <int TA, int TB>
struct WgmmaSS<128, TA, TB> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct WgmmaSS<256, TA, TB> {
  static __device__ __forceinline__ void run(float (&d)[128], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  }
};

// Descriptors of k16 step ks of the operands: of A, rows 64·half.. of the
// tile. K-major tiles are rows of 128 bytes (SBO: 8 rows); MN-major tiles are
// panels of 64 (m or n) x 64 k, each row 128 bytes (LBO: the next panel
// along m or n, SBO: the next 8 k).
template <int TA>
__device__ __forceinline__ uint64_t desc_a(const bf16* a, int half, int ks) {
  const bf16* rows = a + half * 64 * kBK;
  if (TA == 0) return sm90::make_desc(rows + ks * 16, 16, 1024, 1);
  return sm90::make_desc(rows + ks * 16 * 64, 64 * 128, 1024, 1);
}

template <int TB>
__device__ __forceinline__ uint64_t desc_b(const bf16* b, int ks) {
  if (TB == 0) return sm90::make_desc(b + ks * 16, 16, 1024, 1);
  return sm90::make_desc(b + ks * 16 * 64, 64 * 128, 1024, 1);
}

// One stage: the A tile (128 rows of m by 64 k) and the B tile (BN by 64 k).
template <int BN, int TA, int TB>
__device__ __forceinline__ void load_stage(bf16* a, bf16* b,
                                           const CUtensorMap* am,
                                           const CUtensorMap* bm,
                                           uint64_t* bar, int m0, int n0,
                                           int k0) {
  if (TA == 0) {
    sm90::tma_load_3d(a, am, bar, k0, m0, 0);
  } else {
#pragma unroll
    for (int p = 0; p < kBM / 64; ++p)
      sm90::tma_load_3d(a + p * 64 * kBK, am, bar, m0 + 64 * p, k0, 0);
  }
  if (TB == 0) {
    sm90::tma_load_3d(b, bm, bar, k0, n0, 0);
  } else {
#pragma unroll
    for (int p = 0; p < BN / 64; ++p)
      sm90::tma_load_3d(b + p * 64 * kBK, bm, bar, n0 + 64 * p, k0, 0);
  }
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// LN_A: LayerNorm of rows 64·half.. of a K-major A stage (rows of
// 64 k, 128-byte swizzle), in place. Each thread rewrites four 16-byte
// chunks c = tid + 128i of the 64 x 8; chunk c lies in row r = c / 8 at
// physical position pc = c % 8, which holds the k columns 8 · (pc ^ (r % 8))
// .. . For the four chunks of one thread pc and r % 8 are the same, so one
// 16-byte piece each of the LayerNorm weight and bias serves them all; the
// rows' (mean, rstd) come from load_row_stats, once a tile, and a value
// becomes bf16(((x - mean) · rstd) · w + b), the plain version's order.
__device__ __forceinline__ void load_row_stats(float2 (&st)[4], int half,
                                               int m0, const Params& p) {
  const int tid = threadIdx.x % 128;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + half * 64 + (tid >> 3) + 16 * i;
    st[i] = row < p.M ? __ldg(p.ln_stats + row) : make_float2(0.0f, 0.0f);
  }
}

__device__ __forceinline__ void layernorm_rows(bf16* a, int half, int k0,
                                               const float2 (&st)[4],
                                               const Params& p) {
  const int tid = threadIdx.x % 128;
  const int pc = tid & 7;
  const int col = k0 + 8 * (pc ^ ((tid >> 3) & 7));
  const uint4 wv = __ldg(reinterpret_cast<const uint4*>(p.ln_w + col));
  const uint4 bv = __ldg(reinterpret_cast<const uint4*>(p.ln_b + col));
  const __nv_bfloat162* ws = reinterpret_cast<const __nv_bfloat162*>(&wv);
  const __nv_bfloat162* bs = reinterpret_cast<const __nv_bfloat162*>(&bv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = (tid >> 3) + 16 * i;
    uint4* ptr = reinterpret_cast<uint4*>(a + (half * 64 + r) * kBK + pc * 8);
    uint4 v = *ptr;
    __nv_bfloat162* xs = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = __bfloat1622float2(xs[e]);
      const float2 w = __bfloat1622float2(ws[e]);
      const float2 b = __bfloat1622float2(bs[e]);
      xs[e] = __floats2bfloat162_rn((x.x - st[i].x) * st[i].y * w.x + b.x,
                                    (x.y - st[i].x) * st[i].y * w.y + b.y);
    }
    *ptr = v;
  }
}

// Output tile t of the walk: (split-K slice, m tile, n tile).
struct Tile {
  int z, mt, m0, n0, kt0, nkt;
};

template <int BN>
__device__ __forceinline__ Tile tile_of(int t, const Params& p) {
  const int mts = (p.M + kBM - 1) / kBM, nts = (p.N + BN - 1) / BN;
  const int ktiles = (p.K + kBK - 1) / kBK;
  Tile tl;
  tl.z = t / (mts * nts);
  const int r = t % (mts * nts);
  tl.mt = r / nts;
  tl.m0 = tl.mt * kBM;
  tl.n0 = (r % nts) * BN;
  tl.kt0 = tl.z * p.ktiles_per_slice;
  tl.nkt = max(0, min(ktiles, tl.kt0 + p.ktiles_per_slice) - tl.kt0);
  return tl;
}

// Lane t of each quad holds x[k] = its two bf16 columns (2t, 2t + 1) of n8
// block k of one row (wgmma's accumulator layout); it returns the eight
// columns of block t, so that each lane stores 16 bytes and a quad a whole
// 64-byte row segment: full 32-byte sectors, where 4-byte stores would
// write half sectors.
__device__ __forceinline__ uint4 quad_transpose(const uint32_t (&x)[4],
                                                int t) {
  auto pick = [&](int k) {
    return k == 0 ? x[0] : k == 1 ? x[1] : k == 2 ? x[2] : x[3];
  };
  uint32_t v[4];
  v[0] = pick(t);
#pragma unroll
  for (int r = 1; r < 4; ++r)
    v[r] = __shfl_xor_sync(0xffffffffu, pick(t ^ r), r);
  // column pair k of block t came from lane k = t ^ r
  auto col = [&](int k) {
    const int r = k ^ t;
    return r == 0 ? v[0] : r == 1 ? v[1] : r == 2 ? v[2] : v[3];
  };
  return make_uint4(col(0), col(1), col(2), col(3));
}

// The epilogue from registers, of tile `tl`: row lane/4 (+8) of the warp's
// 16, columns 8j + 2(lane%4) + {0, 1} of n8 block j. N is a multiple of 8,
// so a block is valid for the whole warp or for none of it. Blocks go in
// groups of four: the residual or h_pre of a group is loaded before any of
// its stores, so the loads overlap, and bf16 results are stored 16 bytes a
// lane (quad_transpose); fp32 results 8 bytes a lane (full sectors already).
template <int EPI>
__host__ __device__ constexpr bool has_aux() {
  return EPI == kBiasResidual || EPI == kGeluBwd;
}

template <int EPI>
__host__ __device__ constexpr bool has_bias() {
  return EPI == kBias || EPI == kBiasResidual || EPI == kBiasGelu ||
         EPI == kBiasGeluSave;
}

// Epilogues that write a second bf16 output, aux_out.
template <int EPI>
__host__ __device__ constexpr bool has_aux_out() {
  return EPI == kGeluBwd || EPI == kBiasGeluSave;
}

// The residual or h_pre of this thread's accumulator positions, [n8 block]
// [half]; loaded before the tile's products, so that their latency hides
// behind them.
template <int BN, int EPI>
struct Aux {
  __nv_bfloat162 v[has_aux<EPI>() ? BN / 8 : 1][2];
};

template <int BN, int EPI>
__device__ __forceinline__ void load_aux(Aux<BN, EPI>& aux, const Params& p,
                                         const Tile& tl, int half, int warp,
                                         int lane) {
  if (!has_aux<EPI>()) return;
  const int row0 = tl.m0 + half * 64 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = tl.n0 + j * 8 + 2 * (lane & 3);
      const int row = row0 + 8 * h;
      aux.v[j][h] = __floats2bfloat162_rn(0.0f, 0.0f);
      if (col < p.N && row < p.M)
        aux.v[j][h] = __ldg(reinterpret_cast<const __nv_bfloat162*>(
            p.aux_in + (size_t)row * p.N + col));
    }
}

template <int BN, int EPI>
__device__ __forceinline__ void epilogue(const float (&acc)[BN / 2],
                                         const Aux<BN, EPI>& aux,
                                         const Params& p, const Tile& tl,
                                         int half, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int row0 = tl.m0 + half * 64 + warp * 16 + g;
  const int n0 = tl.n0;
#pragma unroll
  for (int j0 = 0; j0 < BN / 8; j0 += 4) {
    uint32_t out[2][4], out2[2][4];  // [half][block]: C, and aux_out
    Floats16 pre{};  // fc1's values before the GELU
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h) out[h][jj] = out2[h][jj] = 0u;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = j0 + jj;
      const int col = n0 + j * 8 + 2 * t;
      if (col >= p.N) continue;
      float2 bv = make_float2(0.0f, 0.0f);
      if (has_bias<EPI>())
        bv = __bfloat1622float2(
            __ldg(reinterpret_cast<const __nv_bfloat162*>(p.bias + col)));
      float cs0 = 0.0f, cs1 = 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        float v0 = acc[4 * j + 2 * h] + bv.x;
        float v1 = acc[4 * j + 2 * h + 1] + bv.y;
        if (EPI == kF32) {
          if (row < p.M) {
            float* c = static_cast<float*>(p.C) + (size_t)tl.z * p.M * p.N;
            *reinterpret_cast<float2*>(c + (size_t)row * p.N + col) =
                make_float2(v0, v1);
          }
          continue;
        }
        const float2 av = __bfloat1622float2(
            aux.v[has_aux<EPI>() ? j : 0][h]);
        if (EPI == kGeluBwd) {
          const float4 gg = gelu_and_grad(av);
          v0 *= gg.y;
          v1 *= gg.w;
          if (row < p.M) {
            cs0 += v0;  // db1 is summed from the fp32 dh_pre
            cs1 += v1;
          }
          out2[h][jj] = pack2(gg.x, gg.z);
        }
        if (EPI == kBiasResidual) {
          v0 += av.x;
          v1 += av.y;
        }
        if (EPI == kBiasGelu || EPI == kBiasGeluSave) {
          if (EPI == kBiasGeluSave) out2[h][jj] = pack2(v0, v1);  // h_pre
          pre.v[4 * jj + 2 * h] = v0;  // the GELU and C below
          pre.v[4 * jj + 2 * h + 1] = v1;
          continue;
        }
        out[h][jj] = pack2(v0, v1);
      }
      if (EPI == kGeluBwd) {
        // lanes g = 0..7 of one column pair hold the warp's 16 rows
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          cs0 += __shfl_xor_sync(0xffffffffu, cs0, o);
          cs1 += __shfl_xor_sync(0xffffffffu, cs1, o);
        }
        if (g == 0)
          *reinterpret_cast<float2*>(
              p.col_part +
              (size_t)(tl.mt * 8 + half * 4 + warp) * p.N + col) =
              make_float2(cs0, cs1);
      }
    }
    if (EPI == kBiasGelu || EPI == kBiasGeluSave) {
      pre = gelu16(pre);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          out[h][jj] =
              pack2(pre.v[4 * jj + 2 * h], pre.v[4 * jj + 2 * h + 1]);
    }
    if (EPI == kF32) continue;
    const int col = n0 + (j0 + t) * 8;  // this lane's block after the swap
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      const uint4 c = quad_transpose(out[h], t);
      uint4 c2 = make_uint4(0, 0, 0, 0);
      if (has_aux_out<EPI>()) c2 = quad_transpose(out2[h], t);
      if (row >= p.M || col >= p.N) continue;
      const size_t off = (size_t)row * p.N + col;
      *reinterpret_cast<uint4*>(static_cast<bf16*>(p.C) + off) = c;
      if (has_aux_out<EPI>())
        *reinterpret_cast<uint4*>(p.aux_out + off) = c2;
    }
  }
}

template <int BN, int TA, int TB, int EPI, bool LN_A>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap a_map,
                const __grid_constant__ CUtensorMap b_map, const Params p,
                int tiles) {
  using C = Cfg<BN>;
  constexpr int ST = C::kStages;
  extern __shared__ unsigned char gemm_smem[];
  const uint32_t raw = sm90::smem_addr(gemm_smem);
  unsigned char* base = gemm_smem + ((1024 - (raw & 1023)) & 1023);
  bf16* As = reinterpret_cast<bf16*>(base);
  bf16* Bs = reinterpret_cast<bf16*>(base + ST * kABytes);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(base + ST * (kABytes + C::kBBytes));
  uint64_t* empty = full + ST;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      sm90::mbar_init(full + s, 1);
      // the consuming warps: one warpgroup's, both with LN_A
      sm90::mbar_init(empty + s, LN_A ? 8 : 4);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer
    sm90::regs_dec<kProducerRegs>();
    if (threadIdx.x == 256) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const Tile tl = tile_of<BN>(t, p);
        for (int i = 0; i < tl.nkt; ++i, ++it) {
          const int s = it % ST;
          if (it >= ST) sm90::mbar_wait(empty + s, (it / ST - 1) & 1);
          sm90::mbar_expect_tx(full + s, kABytes + C::kBBytes);
          load_stage<BN, TA, TB>(As + s * kBM * kBK, Bs + s * BN * kBK,
                                 &a_map, &b_map, full + s, tl.m0, tl.n0,
                                 (tl.kt0 + i) * kBK);
        }
      }
    }
    return;
  }

  sm90::regs_inc<kConsumerRegs>();
  const int lane = threadIdx.x % 32;
  const int warp = (threadIdx.x % 128) / 32;
  if constexpr (LN_A) {
    // Both warpgroups on every tile, 64 rows each: each LayerNorms its
    // rows of a stage in shared memory, fences them for the tensor cores
    // and syncs its 128 threads; the rewrite of stage k + 1 overlaps the
    // products of stage k.
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const Tile tl = tile_of<BN>(t, p);
      float2 stats[4];
      load_row_stats(stats, wg, tl.m0, p);
      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
      for (int i = 0; i < tl.nkt; ++i, ++it) {
        const int s = it % ST;
        sm90::mbar_wait(full + s, (it / ST) & 1);
        bf16* a = As + s * kBM * kBK;
        const bf16* b = Bs + s * BN * kBK;
        layernorm_rows(a, wg, (tl.kt0 + i) * kBK, stats, p);
        fence_proxy_async();
        sm90::bar_sync(1 + wg, 128);
        sm90::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kBK / 16; ++ks)
          WgmmaSS<BN, TA, TB>::run(acc, desc_a<TA>(a, wg, ks),
                                   desc_b<TB>(b, ks));
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();  // the products of the previous stage are done
        if (i > 0 && lane == 0) sm90::mbar_arrive(empty + (it - 1) % ST);
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      if (tl.nkt > 0 && lane == 0) sm90::mbar_arrive(empty + (it - 1) % ST);
      epilogue<BN, EPI>(acc, Aux<BN, EPI>{}, p, tl, wg, warp, lane);
    }
  } else {
    // Turns: a warpgroup waits for its turn before its tile's first stage and
    // passes it on after its last (named barriers 3 and 4), so that it never
    // waits on a stage more than one use ahead of the ring: mbarrier parity
    // tells only the next use from the one before.
    const int turns = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
    int it = 0;  // stages of the ring consumed so far, by either warpgroup
    for (int t = blockIdx.x, turn = 0; t < tiles; t += gridDim.x, ++turn) {
      const Tile tl = tile_of<BN>(t, p);
      if ((turn & 1) != wg) {  // the other warpgroup's tile
        it += tl.nkt;
        continue;
      }
      if (turn > 0) sm90::bar_sync(3 + wg, 256);
      Aux<BN, EPI> aux[2];
#pragma unroll
      for (int mh = 0; mh < 2; ++mh)
        load_aux<BN, EPI>(aux[mh], p, tl, mh, warp, lane);
      float acc0[BN / 2], acc1[BN / 2];  // rows 0-63 and 64-127 of the tile
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc0[i] = acc1[i] = 0.0f;
      for (int i = 0; i < tl.nkt; ++i, ++it) {
        const int s = it % ST;
        sm90::mbar_wait(full + s, (it / ST) & 1);
        const bf16* a = As + s * kBM * kBK;
        const bf16* b = Bs + s * BN * kBK;
        sm90::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kBK / 16; ++ks) {
          WgmmaSS<BN, TA, TB>::run(acc0, desc_a<TA>(a, 0, ks),
                                   desc_b<TB>(b, ks));
          WgmmaSS<BN, TA, TB>::run(acc1, desc_a<TA>(a, 1, ks),
                                   desc_b<TB>(b, ks));
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();  // the products of the previous stage are done
        if (i > 0 && lane == 0) sm90::mbar_arrive(empty + (it - 1) % ST);
      }
      if (turn + 1 < turns) sm90::bar_arrive(4 - wg, 256);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc0);
      sm90::fence_regs(acc1);
      if (tl.nkt > 0 && lane == 0) sm90::mbar_arrive(empty + (it - 1) % ST);
      epilogue<BN, EPI>(acc0, aux[0], p, tl, 0, warp, lane);
      epilogue<BN, EPI>(acc1, aux[1], p, tl, 1, warp, lane);
    }
  }
}

// The card's SM count: the number of persistent blocks.
inline cudaError_t sm_count(int* n) {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err != cudaSuccess) return err;
  }
  *n = count;
  return cudaSuccess;
}

// C = epilogue(A · B) on `stream`, A and B as the TA / TB layouts above;
// `slices` > 1 splits K (fp32 epilogue only), each slice taking
// p.ktiles_per_slice k tiles.
template <int BN, int TA, int TB, int EPI, bool LN_A = false>
inline cudaError_t launch_gemm(const bf16* A, const bf16* B, Params p,
                               int slices, cudaStream_t stream) {
  if (p.M < 1 || p.N < 1 || p.K < 1 || p.N % 8 || slices < 1 ||
      (slices > 1 && EPI != kF32) || (LN_A && (TA != 0 || p.K % kBK)))
    return cudaErrorInvalidValue;
  if (slices == 1) p.ktiles_per_slice = (p.K + kBK - 1) / kBK;
  CUtensorMap am, bm;
  const bool ok_a = TA == 0 ? make_tensor_map_3d(&am, A, 1, p.M, p.K, kBM, kBK)
                            : make_tensor_map_3d(&am, A, 1, p.K, p.M, kBK, 64);
  const bool ok_b = TB == 0 ? make_tensor_map_3d(&bm, B, 1, p.N, p.K, BN, kBK)
                            : make_tensor_map_3d(&bm, B, 1, p.K, p.N, kBK, 64);
  if (!ok_a || !ok_b) return cudaErrorInvalidValue;
  constexpr size_t smem = Cfg<BN>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel<BN, TA, TB, EPI, LN_A>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int tiles = ((p.M + kBM - 1) / kBM) * ((p.N + BN - 1) / BN) * slices;
  const int grid = tiles < sms ? tiles : sms;
  gemm_kernel<BN, TA, TB, EPI, LN_A><<<grid, kThreads, smem, stream>>>(
      am, bm, p, tiles);
  return cudaGetLastError();
}

// Per-row LayerNorm statistics (mean, rstd) in fp32, one warp a row, in the
// order of layernorm.cuh: the mean, then the mean of squared deviations.
__global__ void __launch_bounds__(256)
    ln_stats_kernel(const bf16* __restrict__ x, float2* __restrict__ stats,
                    int rows, int D, float eps) {
  const int row = (blockIdx.x * 256 + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warp leaves together
  const __nv_bfloat162* xr =
      reinterpret_cast<const __nv_bfloat162*>(x + (size_t)row * D);
  float s = 0.0f;
  for (int i = lane; i < D / 2; i += 32) {
    const float2 v = __bfloat1622float2(xr[i]);
    s += v.x + v.y;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const float mean = s / D;
  float q = 0.0f;
  for (int i = lane; i < D / 2; i += 32) {
    const float2 v = __bfloat1622float2(xr[i]);
    q += (v.x - mean) * (v.x - mean) + (v.y - mean) * (v.y - mean);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
  if (lane == 0) stats[row] = make_float2(mean, rsqrtf(q / D + eps));
}

inline cudaError_t launch_ln_stats(const bf16* x, float2* stats, int rows,
                                   int D, float eps, cudaStream_t stream) {
  if (D % 2) return cudaErrorInvalidValue;
  ln_stats_kernel<<<(rows + 7) / 8, 256, 0, stream>>>(x, stats, rows, D, eps);
  return cudaGetLastError();
}

// out (rows, N) = bf16(LayerNorm(x) · Wᵀ + bias), x (rows, K), W (N, K):
// the statistics into `stats` (rows float2), then the LayerNorm folded into
// the A operand. B1's qkv stage; B3's recompute mode runs this same code
// again, so its qkv has the forward's bits.
inline cudaError_t launch_ln_linear(const bf16* x, const bf16* ln_w,
                                    const bf16* ln_b, const bf16* w,
                                    const bf16* bias, float2* stats,
                                    bf16* out, int rows, int K, int N,
                                    float eps, cudaStream_t stream) {
  cudaError_t err = launch_ln_stats(x, stats, rows, K, eps, stream);
  if (err != cudaSuccess) return err;
  Params p{};
  p.bias = bias;
  p.C = out;
  p.ln_stats = stats;
  p.ln_w = ln_w;
  p.ln_b = ln_b;
  p.M = rows;
  p.N = N;
  p.K = K;
  return launch_gemm<256, 0, 0, kBias, true>(x, w, p, 1, stream);
}

}  // namespace wg
}  // namespace vt

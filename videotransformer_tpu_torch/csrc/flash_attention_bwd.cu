// q-blocked flash attention, backward, for Hopper (sm_90a).
//
// Replaces videotransformer_tpu/kernels/flash_attention_pallas.py::_bwd_kernel
// (reached through _flash_bwd / the custom_vjp of flash_attention). From q,
// k, v, the forward's output o and row log-sum-exp lse, and the output
// gradient do, all per (b·h) slice:
//
//   p     = exp(q kᵀ · scale - lse)                     fp32
//   delta = rowsum(do · o)                              fp32
//   dp    = do vᵀ                                       fp32
//   ds    = p · (dp - delta) · scale                    fp32
//   dv    = bf16(p)ᵀ do,  dq = bf16(ds) k,  dk = bf16(ds)ᵀ q   fp32 sums
//
// dq comes back in q's dtype; dk and dv are summed in fp32 and returned in
// k's dtype, the TPU kernel's contract. The TPU kernel took delta as
// rowsum(dp · p) over the whole key row it held; here a key row is walked in
// tiles, so delta is rowsum(do · o) = rowsum(dp · p) (o = p v), from the
// saved bf16 o: one cheap pass instead of a second walk over the keys. The
// plain version (kernels/flash_attention.py) follows this order.
//
// The TPU grid ran its query blocks in order and added dk/dv into resident
// fp32 blocks. On the card blocks run in no order, so the work is split:
//
//   1. delta: one warp per query row.
//   2. dq: one block per (64-query tile, b·h), looping over 64-key tiles
//      (double-buffered K and V, cp.async); dq stays in registers.
//   3. dk, dv: one block per (64-key tile, b·h, query split), looping over
//      the split's 64-query tiles (double-buffered Q, dO, lse, delta); dk
//      and dv stay in registers and are written as fp32 partials.
//   4. the partials of the splits are added in split order and rounded.
//
// The query splits exist for occupancy: at MViT's first block B·H = 8 and
// Nkv = 393 give 56 key tiles against 132 SMs, each over 392 query tiles;
// the splits bring the grid to at least four blocks per SM. No atomics: every
// sum has a fixed order, and two runs give the same bits.
//
// Bound: 10·Nq·Nkv·hd FLOPs for the five products (the dq and dk/dv passes
// recompute Q·Kᵀ and dO·Vᵀ each, 14·Nq·Nkv·hd issued) against
// (4·Nq + 6·Nkv)·hd·2 bytes: tensor-core bound at the MViT shapes. mma.sync
// m16n8k16 throughout; wgmma/TMA are later work.

#include "flash_common.cuh"

namespace vt {

constexpr int kMinBwdBlocks = 4 * 132;  // dk/dv grid target: 4 a SM

// Query tiles each split of the dk/dv pass walks, and the number of splits.
__host__ __device__ inline int bwd_tiles_per_split(int BH, int Nq, int Nkv) {
  const int nqt = (Nq + kFlashRows - 1) / kFlashRows;
  const int nkt = (Nkv + kFlashRows - 1) / kFlashRows;
  int want = (kMinBwdBlocks + nkt * BH - 1) / (nkt * BH);
  want = want < 1 ? 1 : (want > nqt ? nqt : want);
  return (nqt + want - 1) / want;
}

__host__ __device__ inline int bwd_splits(int BH, int Nq, int Nkv) {
  const int nqt = (Nq + kFlashRows - 1) / kFlashRows;
  const int per = bwd_tiles_per_split(BH, Nq, Nkv);
  return (nqt + per - 1) / per;
}

// ---- 1. delta = rowsum(do · o) ---------------------------------------------

__global__ void __launch_bounds__(256)
    flash_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                       float* __restrict__ delta, int rows, int hd) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const bf16* orow = o + (size_t)row * hd;
  const bf16* drow = dout + (size_t)row * hd;
  float s = 0.0f;
  for (int d = lane; d < hd; d += 32)
    s += __bfloat162float(orow[d]) * __bfloat162float(drow[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

// ---- 2. dq -------------------------------------------------------------------

template <int HD>
__host__ __device__ constexpr size_t flash_dq_smem() {
  return (size_t)6 * FlashTile<HD>::kElems * sizeof(bf16);  // Q, dO, 2 K, 2 V
}

template <int HD>
__global__ void __launch_bounds__(kFlashThreads)
    flash_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int Nq, int Nkv, float scale) {
  using T = FlashTile<HD>;
  constexpr int LD = T::kLd;
  extern __shared__ __align__(128) unsigned char flash_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(flash_smem);
  bf16* dOs = Qs + T::kElems;
  bf16* Ks = dOs + T::kElems;     // [2][tile]
  bf16* Vs = Ks + 2 * T::kElems;  // [2][tile]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kFlashRows;
  const size_t qoff = (size_t)bh * Nq;
  const bf16* kb = k + (size_t)bh * Nkv * HD;
  const bf16* vb = v + (size_t)bh * Nkv * HD;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int nkt = (Nkv + kFlashRows - 1) / kFlashRows;

  load_flash_tile<HD>(Qs, q + qoff * HD, q0, Nq);
  load_flash_tile<HD>(dOs, dout + qoff * HD, q0, Nq);
  load_flash_tile<HD>(Ks, kb, 0, Nkv);
  load_flash_tile<HD>(Vs, vb, 0, Nkv);
  cp_async_commit();

  float row_lse[2], row_delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + g + i * 8;
    row_lse[i] = row < Nq ? lse[qoff + row] : 0.0f;
    row_delta[i] = row < Nq ? delta[qoff + row] : 0.0f;
  }
  float acc[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.0f;

  const bf16* my_q = Qs + warp * 16 * LD;
  const bf16* my_do = dOs + warp * 16 * LD;
  for (int kt = 0; kt < nkt; ++kt) {
    if (kt + 1 < nkt) {
      const int buf = (kt + 1) & 1;
      load_flash_tile<HD>(Ks + buf * T::kElems, kb, (kt + 1) * kFlashRows, Nkv);
      load_flash_tile<HD>(Vs + buf * T::kElems, vb, (kt + 1) * kFlashRows, Nkv);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Kt = Ks + (kt & 1) * T::kElems;
    const bf16* Vt = Vs + (kt & 1) * T::kElems;

    float p[8][4], dp[8][4];
    tile_product_nt<HD>(p, my_q, Kt, lane);
    tile_product_nt<HD>(dp, my_do, Vt, lane);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kt * kFlashRows + n * 8 + t * 2 + (e & 1);
        const float pe = col < Nkv
                             ? expf(p[n][e] * scale - row_lse[e >> 1])
                             : 0.0f;
        p[n][e] = pe * (dp[n][e] - row_delta[e >> 1]) * scale;  // ds
      }
    tile_product_acc<HD>(acc, p, Kt, lane);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + g + i * 8;
    if (row >= Nq) continue;
    bf16* dst = dq + (qoff + row) * HD + t * 2;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
      *reinterpret_cast<__nv_bfloat162*>(dst + d * 8) =
          __floats2bfloat162_rn(acc[d][2 * i], acc[d][2 * i + 1]);
  }
}

// ---- 3. dk, dv partials --------------------------------------------------

template <int HD>
__host__ __device__ constexpr size_t flash_dkdv_smem() {
  // K, V, 2 Q, 2 dO tiles; 2 x (lse, delta) rows
  return (size_t)6 * FlashTile<HD>::kElems * sizeof(bf16) +
         (size_t)4 * kFlashRows * sizeof(float);
}

template <int HD>
__global__ void __launch_bounds__(kFlashThreads)
    flash_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      float* __restrict__ dk_part, float* __restrict__ dv_part,
                      int BH, int Nq, int Nkv, float scale, int per_split) {
  using T = FlashTile<HD>;
  constexpr int LD = T::kLd;
  extern __shared__ __align__(128) unsigned char flash_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(flash_smem);
  bf16* Vs = Ks + T::kElems;
  bf16* Qs = Vs + T::kElems;       // [2][tile]
  bf16* dOs = Qs + 2 * T::kElems;  // [2][tile]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * T::kElems);  // [2][64]
  float* delta_s = lse_s + 2 * kFlashRows;                        // [2][64]

  const int k0 = blockIdx.x * kFlashRows;
  const int bh = blockIdx.y;
  const int split = blockIdx.z;
  const size_t qoff = (size_t)bh * Nq;
  const bf16* qb = q + qoff * HD;
  const bf16* dob = dout + qoff * HD;
  const int nqt = (Nq + kFlashRows - 1) / kFlashRows;
  const int qt0 = split * per_split;
  const int qt1 = min(nqt, qt0 + per_split);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;

  auto issue = [&](int qt) {
    const int buf = qt & 1;
    load_flash_tile<HD>(Qs + buf * T::kElems, qb, qt * kFlashRows, Nq);
    load_flash_tile<HD>(dOs + buf * T::kElems, dob, qt * kFlashRows, Nq);
    for (int r = threadIdx.x; r < kFlashRows; r += kFlashThreads) {
      const int row = qt * kFlashRows + r;
      lse_s[buf * kFlashRows + r] = row < Nq ? lse[qoff + row] : 0.0f;
      delta_s[buf * kFlashRows + r] = row < Nq ? delta[qoff + row] : 0.0f;
    }
  };

  load_flash_tile<HD>(Ks, k + (size_t)bh * Nkv * HD, k0, Nkv);
  load_flash_tile<HD>(Vs, v + (size_t)bh * Nkv * HD, k0, Nkv);
  issue(qt0);
  cp_async_commit();

  float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[d][e] = dv[d][e] = 0.0f;

  const bf16* my_k = Ks + warp * 16 * LD;
  const bf16* my_v = Vs + warp * 16 * LD;
  for (int qt = qt0; qt < qt1; ++qt) {
    if (qt + 1 < qt1) issue(qt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int buf = qt & 1;
    const bf16* Qt = Qs + buf * T::kElems;
    const bf16* dOt = dOs + buf * T::kElems;
    const float* lse_t = lse_s + buf * kFlashRows;
    const float* delta_t = delta_s + buf * kFlashRows;

    // pᵀ (16 keys x 64 queries); padded queries give 0
    float p[8][4];
    tile_product_nt<HD>(p, my_k, Qt, lane);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + t * 2 + (e & 1);
        p[n][e] = qt * kFlashRows + c < Nq
                      ? expf(p[n][e] * scale - lse_t[c])
                      : 0.0f;
      }
    tile_product_acc<HD>(dv, p, dOt, lane);
    float ds[8][4];
    tile_product_nt<HD>(ds, my_v, dOt, lane);  // dpᵀ
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + t * 2 + (e & 1);
        ds[n][e] = p[n][e] * (ds[n][e] - delta_t[c]) * scale;
      }
    tile_product_acc<HD>(dk, ds, Qt, lane);
    __syncthreads();
  }

  const size_t base = ((size_t)split * BH + bh) * Nkv;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = k0 + warp * 16 + g + i * 8;
    if (row >= Nkv) continue;
    float* dkr = dk_part + (base + row) * HD + t * 2;
    float* dvr = dv_part + (base + row) * HD + t * 2;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      *reinterpret_cast<float2*>(dkr + d * 8) =
          make_float2(dk[d][2 * i], dk[d][2 * i + 1]);
      *reinterpret_cast<float2*>(dvr + d * 8) =
          make_float2(dv[d][2 * i], dv[d][2 * i + 1]);
    }
  }
}

// ---- 4. sum the partials in split order ------------------------------------

__global__ void __launch_bounds__(256)
    flash_sum_splits_kernel(const float* __restrict__ part,
                            bf16* __restrict__ out, size_t n, int splits) {
  const size_t i = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int z = 0; z < splits; ++z) s += part[(size_t)z * n + i];
  out[i] = __float2bfloat16(s);
}

template <int HD>
cudaError_t launch_flash_bwd(const bf16* q, const bf16* k, const bf16* v,
                             const bf16* o, const float* lse, const bf16* dout,
                             float* delta, float* scratch, bf16* dq, bf16* dk,
                             bf16* dv, int BH, int Nq, int Nkv, float scale,
                             cudaStream_t st) {
  const int rows = BH * Nq;
  flash_delta_kernel<<<(rows + 7) / 8, 256, 0, st>>>(o, dout, delta, rows, HD);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr size_t dq_smem = flash_dq_smem<HD>();
  err = cudaFuncSetAttribute(flash_dq_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dq_smem);
  if (err != cudaSuccess) return err;
  dim3 dq_grid((Nq + kFlashRows - 1) / kFlashRows, BH);
  flash_dq_kernel<HD><<<dq_grid, kFlashThreads, dq_smem, st>>>(
      q, k, v, dout, lse, delta, dq, Nq, Nkv, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int per = bwd_tiles_per_split(BH, Nq, Nkv);
  const int splits = bwd_splits(BH, Nq, Nkv);
  const size_t n = (size_t)BH * Nkv * HD;
  float* dk_part = scratch;
  float* dv_part = scratch + (size_t)splits * n;
  constexpr size_t kv_smem = flash_dkdv_smem<HD>();
  err = cudaFuncSetAttribute(flash_dkdv_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kv_smem);
  if (err != cudaSuccess) return err;
  dim3 kv_grid((Nkv + kFlashRows - 1) / kFlashRows, BH, splits);
  flash_dkdv_kernel<HD><<<kv_grid, kFlashThreads, kv_smem, st>>>(
      q, k, v, dout, lse, delta, dk_part, dv_part, BH, Nq, Nkv, scale, per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const unsigned blocks = (unsigned)((n + 255) / 256);
  flash_sum_splits_kernel<<<blocks, 256, 0, st>>>(dk_part, dk, n, splits);
  flash_sum_splits_kernel<<<blocks, 256, 0, st>>>(dv_part, dv, n, splits);
  return cudaGetLastError();
}

}  // namespace vt

extern "C" {

// fp32 floats of scratch vt_flash_attention_bwd needs: the dk and dv
// partials of every query split; -1 when that is not an int.
int vt_flash_bwd_scratch_floats(int BH, int Nq, int Nkv, int hd) {
  const long long n = 2LL * vt::bwd_splits(BH, Nq, Nkv) * BH * Nkv * hd;
  return n > 0x7fffffffLL ? -1 : (int)n;
}

// q, o, do, dq (BH, Nq, hd) and k, v, dk, dv (BH, Nkv, hd) bf16; lse and
// delta (BH, Nq) fp32 (delta is written); scratch as sized above. hd is 32,
// 64, 96 or 128.
int vt_flash_attention_bwd(const void* q, const void* k, const void* v,
                           const void* o, const void* lse, const void* dout,
                           void* delta, void* scratch, void* dq, void* dk,
                           void* dv, int BH, int Nq, int Nkv, int hd,
                           float scale, void* stream) {
  using vt::bf16;
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* ob = static_cast<const bf16*>(o);
  const float* lb = static_cast<const float*>(lse);
  const bf16* db = static_cast<const bf16*>(dout);
  float* del = static_cast<float*>(delta);
  float* scr = static_cast<float*>(scratch);
  bf16* dqb = static_cast<bf16*>(dq);
  bf16* dkb = static_cast<bf16*>(dk);
  bf16* dvb = static_cast<bf16*>(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BH < 1 || Nq < 1 || Nkv < 1) return cudaErrorInvalidValue;
#define VT_FLASH_BWD(HD)                                                   \
  vt::launch_flash_bwd<HD>(qb, kb, vb, ob, lb, db, del, scr, dqb, dkb, dvb, \
                           BH, Nq, Nkv, scale, st)
  switch (hd) {
    case 32: return VT_FLASH_BWD(32);
    case 64: return VT_FLASH_BWD(64);
    case 96: return VT_FLASH_BWD(96);
    case 128: return VT_FLASH_BWD(128);
    default: return cudaErrorInvalidValue;
  }
#undef VT_FLASH_BWD
}

}  // extern "C"

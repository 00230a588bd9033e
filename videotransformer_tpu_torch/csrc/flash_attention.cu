// Flash attention, forward (B5), for Hopper (sm_90a): the C entry point of
// flash_fwd.cuh's kernel on (B·H, N, hd) tensors. The design, its bound and
// its numerics are stated there.

#include "flash_fwd.cuh"

namespace vt {

template <int HD>
cudaError_t launch_plain_fwd(const bf16* q, const bf16* k, const bf16* v,
                             bf16* o, float* lse, int BH, int Nq, int Nkv,
                             float scale, cudaStream_t st) {
  using C = FwdCfg<HD>;
  CUtensorMap qm, km, vm;
  if (!flash_map<HD>(&qm, q, BH, Nq, C::kBM) ||
      !flash_map<HD>(&km, k, BH, Nkv, C::kBN) ||
      !flash_map<HD>(&vm, v, BH, Nkv, C::kBN))
    return cudaErrorInvalidValue;
  return launch_flash_fwd<HD>(qm, km, vm, o, lse, BH, Nq, Nkv, scale,
                              plain_layout(HD), st);
}

}  // namespace vt

extern "C" {

// q (BH, Nq, hd), k and v (BH, Nkv, hd), bf16, 16-byte aligned; o (BH, Nq,
// hd) bf16 and lse (BH, Nq) fp32 are written. hd is 32, 64, 96 or 128;
// scale > 0.
int vt_flash_attention_fwd(const void* q, const void* k, const void* v,
                           void* o, void* lse, int BH, int Nq, int Nkv,
                           int hd, float scale, void* stream) {
  using vt::bf16;
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  bf16* ob = static_cast<bf16*>(o);
  float* lb = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BH < 1 || Nq < 1 || Nkv < 1 || !(scale > 0.0f))
    return cudaErrorInvalidValue;
  switch (hd) {
    case 32: return vt::launch_plain_fwd<32>(qb, kb, vb, ob, lb, BH, Nq, Nkv, scale, st);
    case 64: return vt::launch_plain_fwd<64>(qb, kb, vb, ob, lb, BH, Nq, Nkv, scale, st);
    case 96: return vt::launch_plain_fwd<96>(qb, kb, vb, ob, lb, BH, Nq, Nkv, scale, st);
    case 128: return vt::launch_plain_fwd<128>(qb, kb, vb, ob, lb, BH, Nq, Nkv, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"

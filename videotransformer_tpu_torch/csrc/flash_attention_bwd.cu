// Flash attention, backward (B6), for Hopper (sm_90a): the C entry point of
// flash_bwd.cuh's kernels on (B·H, N, hd) tensors. The design, its bound and
// its numerics are stated there.

#include "flash_bwd.cuh"

namespace vt {

template <int HD>
cudaError_t launch_plain_bwd(const bf16* q, const bf16* k, const bf16* v,
                             const bf16* o, const float* lse, const bf16* dout,
                             float* rows, float* scratch, bf16* dq, bf16* dk,
                             bf16* dv, int BH, int Nq, int Nkv, float scale,
                             cudaStream_t st) {
  const void* ops[5] = {q, k, v, o, dout};  // in BwdOperand order
  FlashBwdMaps m;
  auto mk = [&](CUtensorMap* map, int which, int rows) {
    const bool keys = which == kBwdK || which == kBwdV;
    return flash_map<HD>(map, ops[which], BH, keys ? Nkv : Nq, rows);
  };
  if (!flash_bwd_maps<HD>(m, mk)) return cudaErrorInvalidValue;
  return launch_flash_bwd<HD>(m, lse, rows, scratch, dq, dk, dv, BH, Nq, Nkv,
                              scale, plain_layout(HD), st);
}

}  // namespace vt

extern "C" {

// fp32 floats of the row arrays vt_flash_attention_bwd writes (lse·log2e and
// delta, each padded to a multiple of 128 query rows a slice).
int vt_flash_bwd_row_floats(int BH, int Nq) {
  const size_t n = vt::flash_bwd_row_floats(BH, Nq);
  return n > 0x7fffffffu ? -1 : (int)n;
}

// fp32 floats of scratch vt_flash_attention_bwd needs: the dk and dv
// partials of every query split (0 with one split); -1 when that is not an
// int.
int vt_flash_bwd_scratch_floats(int BH, int Nq, int Nkv, int hd) {
  const size_t n = vt::flash_bwd_scratch_floats(BH, Nq, Nkv, hd);
  return n > 0x7fffffffu ? -1 : (int)n;
}

// q, o, do, dq (BH, Nq, hd) and k, v, dk, dv (BH, Nkv, hd) bf16, 16-byte
// aligned; lse (BH, Nq) fp32; rows and scratch fp32 as sized above (written).
// hd is 32, 64, 96 or 128; scale > 0.
int vt_flash_attention_bwd(const void* q, const void* k, const void* v,
                           const void* o, const void* lse, const void* dout,
                           void* rows, void* scratch, void* dq, void* dk,
                           void* dv, int BH, int Nq, int Nkv, int hd,
                           float scale, void* stream) {
  using vt::bf16;
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* ob = static_cast<const bf16*>(o);
  const float* lb = static_cast<const float*>(lse);
  const bf16* db = static_cast<const bf16*>(dout);
  float* rw = static_cast<float*>(rows);
  float* scr = static_cast<float*>(scratch);
  bf16* dqb = static_cast<bf16*>(dq);
  bf16* dkb = static_cast<bf16*>(dk);
  bf16* dvb = static_cast<bf16*>(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BH < 1 || Nq < 1 || Nkv < 1 || !(scale > 0.0f))
    return cudaErrorInvalidValue;
#define VT_FLASH_BWD(HD)                                                  \
  vt::launch_plain_bwd<HD>(qb, kb, vb, ob, lb, db, rw, scr, dqb, dkb, dvb, \
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

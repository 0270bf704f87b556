// Flash-attention backward entry points (C interface of the `flash` library).
//
// Replaces the Pallas TPU backward kernels of
// lumina_t2x_tpu/ops/flash_attention.py:
//   lumina_flash_bwd_fused <- _bwd_fused_kernel (_flash_bwd_fused_impl): one sweep, dK dV and dQ
//   lumina_flash_bwd_dq    <- _bwd_dq_kernel    (_flash_bwd_impl, first pallas_call)
//   lumina_flash_bwd_dkv   <- _bwd_dkv_kernel   (_flash_bwd_impl, second pallas_call)
// Each entry point is a distinct C function so the Python wrapper can count
// its launches. bf16 inputs launch the Hopper kernels of flash_bwd_sm90.cu
// (wgmma, TMA rings, dQ by bulk reduce-add or, for lumina_flash_bwd_dq, per
// q tile in registers); fp32 inputs launch the register-tiled FFMA kernels
// of flash_bwd_fp32_sm90.cu (exact to fp32; dQ of the fused sweep by bulk
// reduce-add too).
//
// What both compute (the Pallas kernels' math, not their TPU mechanics),
// from the forward's per-row log-sum-exp and delta = rowsum(dO * O):
//   s  = scale * q . k                 over valid keys (kv_mask != 0, j < Sk)
//   p  = exp(min(s - lse, 0))          0 on masked keys and on rows with lse = -inf
//   ds = p * (dO . v - delta) * scale
//   dV = sum_rows p^T dO,  dK = sum_rows ds^T q,  dQ = ds k
// A fully masked query row (lse = -inf) has dQ = 0 and adds nothing to dK or
// dV; a masked key has dK = dV = 0. GQA: dK and dV come out per kv head,
// summed over its q heads in fp32.

#include <cuda_runtime.h>

#include "flash_bwd_fp32_sm90.cuh"
#include "flash_bwd_sm90.cuh"

// Every entry point takes the same arguments. meta (int64[28]): B, Sq, Sk,
// Hq, Hkv, D, then element strides q, k, v, dout, dq, dk, dv (b, s, h each)
// and mask (b). mask may be null (every key valid). lse and delta are
// contiguous (B, Hq, Sq) fp32. lumina_flash_bwd_fused adds into dq, a zeroed
// fp32 buffer, and writes dk, dv; lumina_flash_bwd_dq writes dq (q's dtype)
// only; lumina_flash_bwd_dkv writes dk, dv only. bf16 inputs go to
// flash_bwd_sm90.cu (flash_bwd_sm90.cuh), fp32 to flash_bwd_fp32_sm90.cu
// (flash_bwd_fp32_sm90.cuh). Each returns the cudaError_t of the launch (0
// on success).
#define LUMINA_FLASH_BWD_ARGS                                                              \
  const void *q, const void *k, const void *v, const int *mask, const void *dout,          \
      const float *lse, const float *delta, void *dq, void *dk, void *dv, const long long *meta, \
      float scale, int is_bf16, void *stream
#define LUMINA_FLASH_BWD_CALL(which) \
  flash_bwd_fp32_sm90(which, q, k, v, mask, dout, lse, delta, dq, dk, dv, meta, scale, stream)

extern "C" {

int lumina_flash_bwd_fused(LUMINA_FLASH_BWD_ARGS) {
  if (is_bf16)
    return flash_bwd_sm90(true, q, k, v, mask, dout, lse, delta, dq, dk, dv, meta, scale, stream);
  return LUMINA_FLASH_BWD_CALL(Which::kFused);
}

int lumina_flash_bwd_dq(LUMINA_FLASH_BWD_ARGS) {
  if (is_bf16)
    return flash_bwd_dq_sm90(q, k, v, mask, dout, lse, delta, dq, meta, scale, stream);
  return LUMINA_FLASH_BWD_CALL(Which::kDq);
}

int lumina_flash_bwd_dkv(LUMINA_FLASH_BWD_ARGS) {
  if (is_bf16)
    return flash_bwd_sm90(false, q, k, v, mask, dout, lse, delta, dq, dk, dv, meta, scale, stream);
  return LUMINA_FLASH_BWD_CALL(Which::kDkv);
}

}  // extern "C"

// Flash-attention backward entry points (C interface of the `flash` library).
//
// Replaces the Pallas TPU backward kernels of
// lumina_t2x_tpu/ops/flash_attention.py:
//   lumina_flash_bwd_fused <- _bwd_fused_kernel (_flash_bwd_fused_impl): one sweep, dK dV and dQ
//   lumina_flash_bwd_dq    <- _bwd_dq_kernel    (_flash_bwd_impl, first pallas_call)
//   lumina_flash_bwd_dkv   <- _bwd_dkv_kernel   (_flash_bwd_impl, second pallas_call)
// Each entry point is a distinct C function so the Python wrapper can count
// its launches, and takes the operands' dtype as a code (0 fp32, 1 bf16, 2
// fp16; the wrapper's `_DTYPE_CODES`). bf16 and fp16 inputs launch that
// type's instantiation of the Hopper kernels of flash_bwd_sm90.cu (wgmma on
// .bf16 or .f16 operands, TMA rings, dQ by bulk reduce-add or, for
// lumina_flash_bwd_dq, per q tile in registers; fp16 packs dS at a power of
// two set by max|dO|, see that file); fp32 inputs launch the register-tiled
// FFMA kernels of flash_bwd_fp32_sm90.cu (exact to fp32; dQ of the fused
// sweep by bulk reduce-add too). No fp16 input is cast to another type.
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
// contiguous (B, Hq, Sq) fp32; do_amax is fp16's max|dO| (one fp16 on the
// card) or null, read by the Hopper kernels only. lumina_flash_bwd_fused adds
// into dq, a zeroed fp32 buffer, and writes dk, dv; lumina_flash_bwd_dq
// writes dq (q's dtype) only; lumina_flash_bwd_dkv writes dk, dv only. bf16
// and fp16 inputs go to flash_bwd_sm90.cu (flash_bwd_sm90.cuh), fp32 to
// flash_bwd_fp32_sm90.cu (flash_bwd_fp32_sm90.cuh), another dtype code is
// refused. Each returns the cudaError_t of the launch (0 on success).
#define LUMINA_FLASH_BWD_ARGS                                                                \
  const void *q, const void *k, const void *v, const int *mask, const void *dout,            \
      const float *lse, const float *delta, const void *do_amax, void *dq, void *dk, void *dv,  \
      const long long *meta, float scale, int dtype, void *stream
#define LUMINA_FLASH_BWD_CALL(which) \
  flash_bwd_fp32_sm90(which, q, k, v, mask, dout, lse, delta, dq, dk, dv, meta, scale, stream)

namespace {

// the dtype codes of the entry points' `dtype`
constexpr int kFp32 = 0, kBf16 = 1, kFp16 = 2;

bool hopper(int dtype) { return dtype == kBf16 || dtype == kFp16; }

}  // namespace

extern "C" {

int lumina_flash_bwd_fused(LUMINA_FLASH_BWD_ARGS) {
  if (hopper(dtype))
    return flash_bwd_sm90(dtype == kFp16, true, q, k, v, mask, dout, lse, delta, do_amax, dq, dk,
                          dv, meta, scale, stream);
  if (dtype != kFp32) return (int)cudaErrorInvalidValue;
  return LUMINA_FLASH_BWD_CALL(Which::kFused);
}

int lumina_flash_bwd_dq(LUMINA_FLASH_BWD_ARGS) {
  if (hopper(dtype))
    return flash_bwd_dq_sm90(dtype == kFp16, q, k, v, mask, dout, lse, delta, do_amax, dq, meta,
                             scale, stream);
  if (dtype != kFp32) return (int)cudaErrorInvalidValue;
  return LUMINA_FLASH_BWD_CALL(Which::kDq);
}

int lumina_flash_bwd_dkv(LUMINA_FLASH_BWD_ARGS) {
  if (hopper(dtype))
    return flash_bwd_sm90(dtype == kFp16, false, q, k, v, mask, dout, lse, delta, do_amax, dq, dk,
                          dv, meta, scale, stream);
  if (dtype != kFp32) return (int)cudaErrorInvalidValue;
  return LUMINA_FLASH_BWD_CALL(Which::kDkv);
}

}  // extern "C"

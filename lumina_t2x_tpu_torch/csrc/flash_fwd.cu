// Flash-attention forward entry points (C interface of the `flash` library).
//
// Replaces the Pallas TPU forward kernels of
// lumina_t2x_tpu/ops/flash_attention.py:
//   lumina_flash_small_kv   <- _flash_small_kv_kernel   (_flash_small_kv_impl)
//   lumina_flash_online     <- _flash_kernel_fused_sum  (_flash_attention_fwd_impl, static_max=None)
//   lumina_flash_static_max <- _flash_kernel_static_max (_flash_attention_fwd_impl, static_max=bound)
//   lumina_flash_online_lse <- _flash_kernel_res        (_flash_fwd_res_impl, static_max=None)
//   lumina_flash_static_max_lse <- _flash_kernel_res_static_max (_flash_fwd_res_impl, static_max=bound)
//   lumina_flash_rope       <- _flash_rope_kernel       (_flash_rope_fwd_impl, rotate_k=True)
//   lumina_flash_rope_q     <- _flash_rope_q_kernel     (_flash_rope_fwd_impl, rotate_k=False)
// Each entry point is a distinct C function so the Python wrapper can count
// its launches, and takes the operands' dtype as a code (0 fp32, 1 bf16, 2
// fp16; the wrapper's `_DTYPE_CODES`). For bf16 and fp16 inputs every one
// launches that type's instantiation of the Hopper kernel of
// flash_fwd_sm90.cu (wgmma on .bf16 or .f16 operands, exp2, a TMA K/V ring;
// the LSE written from the consumers' registers; the rope entry points with
// q rotated in shared memory by the (Sq, D) tables, k rotated beforehand by
// rope_rotate.cu; fp16's static max packs each row's p at a power-of-two
// scale, see that file). No fp16 input is cast to another type.
// For fp32 inputs every one launches the register-tiled FFMA kernel of
// flash_fwd_fp32_sm90.cu (exact to fp32; the audio app's FlagDiT-1D runs in
// fp32 through lumina_flash_small_kv), with the same (static max, LSE)
// flags; the fp32 rope entry points take q and k already rotated
// (rope_rotate.cu, the same formula in fp32) and run its online kernel.
//
// What both compute (the Pallas kernels' math, not their TPU mechanics):
//   s   = scale * q . k            over valid keys (kv_mask != 0, j < Sk)
//   p   = exp(s - m)               online running max m, with rescale, or
//   p   = exp(min(s - bound, 55))  with a fixed bound (static max)
//   out = sum_j p v_j / sum_j p    fp32 accumulation
//   lse = m + log(l) | bound + log(l)   (the *_lse entry points; (B, Hq, Sq) fp32)
// A query row whose keys are all masked outputs 0 and has lse = -inf.
//
// Layout: q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D), read in place from
// element strides (the last dim must be contiguous); GQA maps q head h to kv
// head h / (Hq / Hkv); the ragged last KV tile and q tile are masked in the
// kernels, nothing is padded in device memory.

#include <cuda_runtime.h>

#include "flash_fwd_fp32_sm90.cuh"
#include "flash_fwd_sm90.cuh"

namespace {

// the dtype codes of the entry points' `dtype`
constexpr int kFp32 = 0, kBf16 = 1, kFp16 = 2;

// The forward entry points' dispatch: bf16 and fp16 to the Hopper kernel,
// fp32 to the fp32 kernel, another code refused.
int forward(bool static_max, const void* q, const void* k, const void* v, const int* mask,
            void* out, float* lse, const long long* meta, float scale, float bound, int dtype,
            void* stream) {
  if (dtype == kBf16 || dtype == kFp16)
    return flash_fwd_sm90(dtype == kFp16, static_max, q, k, v, mask, out, lse, nullptr, nullptr,
                          meta, scale, bound, stream);
  if (dtype != kFp32) return (int)cudaErrorInvalidValue;
  return flash_fwd_fp32_sm90(static_max, q, k, v, mask, out, lse, meta, scale, bound, stream);
}

// The two rope entry points: bf16 and fp16 q unrotated, rotated by the
// Hopper kernel from the (Sq, D) tables; fp32 q already rotated (no
// tables), on the fp32 kernel's online instantiation. k arrives as the
// entry point takes it (rotated by the caller for lumina_flash_rope).
int rope_forward(const void* q, const void* k, const void* v, const int* mask, void* out,
                 const float* rope_cos, const float* rope_sin, const long long* meta, float scale,
                 int dtype, void* stream) {
  if (dtype == kBf16 || dtype == kFp16) {
    if (rope_cos == nullptr || rope_sin == nullptr) return (int)cudaErrorInvalidValue;
    return flash_fwd_sm90(dtype == kFp16, false, q, k, v, mask, out, nullptr, rope_cos, rope_sin,
                          meta, scale, 0.f, stream);
  }
  if (dtype != kFp32 || rope_cos != nullptr || rope_sin != nullptr)
    return (int)cudaErrorInvalidValue;
  return flash_fwd_fp32_sm90(false, q, k, v, mask, out, nullptr, meta, scale, 0.f, stream);
}

}  // namespace

// Every entry point takes the same arguments. meta (int64[19]): B, Sq, Sk,
// Hq, Hkv, D, then element strides q (b, s, h), k (b, s, h), v (b, s, h),
// out (b, s, h), mask (b). mask may be null (every key valid); lse (B, Hq, Sq)
// fp32 is written only by the two *_lse entry points, bound read only by the
// two static_max ones; dtype is the code of q, k, v and out. Each returns
// the cudaError_t of the launch (0 on success).
#define LUMINA_FLASH_ARGS                                                               \
  const void *q, const void *k, const void *v, const int *mask, void *out, float *lse, \
      const long long *meta, float scale, float bound, int dtype, void *stream

// The two rope entry points take the same meta and, instead of lse and
// bound, the (Sq, D) fp32 tables cos_full and sin_signed (contiguous): bf16
// and fp16 q arrive unrotated with both tables, fp32 q rotated with neither
// (see rope_forward). lumina_flash_rope needs Sk == Sq and k rotated by the
// key positions; lumina_flash_rope_q takes k as it is.
#define LUMINA_FLASH_ROPE_ARGS                                                          \
  const void *q, const void *k, const void *v, const int *mask, void *out,             \
      const float *rope_cos, const float *rope_sin, const long long *meta, float scale, \
      int dtype, void *stream

extern "C" {

int lumina_flash_small_kv(LUMINA_FLASH_ARGS) {
  return forward(false, q, k, v, mask, out, nullptr, meta, scale, 0.f, dtype, stream);
}

int lumina_flash_online(LUMINA_FLASH_ARGS) {
  return forward(false, q, k, v, mask, out, nullptr, meta, scale, 0.f, dtype, stream);
}

int lumina_flash_static_max(LUMINA_FLASH_ARGS) {
  return forward(true, q, k, v, mask, out, nullptr, meta, scale, bound, dtype, stream);
}

int lumina_flash_online_lse(LUMINA_FLASH_ARGS) {
  return forward(false, q, k, v, mask, out, lse, meta, scale, 0.f, dtype, stream);
}

int lumina_flash_static_max_lse(LUMINA_FLASH_ARGS) {
  return forward(true, q, k, v, mask, out, lse, meta, scale, bound, dtype, stream);
}

int lumina_flash_rope(LUMINA_FLASH_ROPE_ARGS) {
  if (meta[2] != meta[1]) return (int)cudaErrorInvalidValue;  // Sk == Sq
  return rope_forward(q, k, v, mask, out, rope_cos, rope_sin, meta, scale, dtype, stream);
}

int lumina_flash_rope_q(LUMINA_FLASH_ROPE_ARGS) {
  return rope_forward(q, k, v, mask, out, rope_cos, rope_sin, meta, scale, dtype, stream);
}

}  // extern "C"

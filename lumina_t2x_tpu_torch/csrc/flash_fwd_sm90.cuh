// The bf16 and fp16 streaming attention forward of flash_fwd_sm90.cu, called by the
// C entry points lumina_flash_small_kv, lumina_flash_online,
// lumina_flash_static_max, lumina_flash_online_lse,
// lumina_flash_static_max_lse, lumina_flash_rope and lumina_flash_rope_q of
// flash_fwd.cu (whose fp32 inputs take flash_fwd_fp32_sm90.cu).
//
// f16: the operands (q, k, v, out) are fp16, else bf16.
// meta (int64[19]) as those entry points take it: B, Sq, Sk, Hq, Hkv, D,
// then element strides of q (b, s, h), k (b, s, h), v (b, s, h), out
// (b, s, h) and the mask (b). lse: a contiguous (B, Hq, Sq) fp32 tensor that
// receives each row's log-sum-exp, or null. rope_cos, rope_sin: the
// contiguous (Sq, D) fp32 tables cos_full and sin_signed by which the kernel
// rotates q (online, no LSE), or both null. Returns a cudaError_t (0 on
// success); cudaErrorInvalidValue for what the kernel does not take (D not a
// multiple of 8 or above 128, a base or a stride not in whole 16-byte chunks,
// one table without the other, a rotation with a bound or an LSE).

#pragma once

int flash_fwd_sm90(bool f16, bool static_max, const void* q, const void* k, const void* v,
                   const int* mask, void* out, float* lse, const float* rope_cos,
                   const float* rope_sin, const long long* meta, float scale, float bound,
                   void* stream);

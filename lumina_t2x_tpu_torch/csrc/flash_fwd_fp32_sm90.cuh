// The fp32 attention forward of flash_fwd_fp32_sm90.cu, called by the C
// entry points lumina_flash_small_kv, lumina_flash_online,
// lumina_flash_static_max, lumina_flash_online_lse,
// lumina_flash_static_max_lse, lumina_flash_rope and lumina_flash_rope_q of
// flash_fwd.cu for fp32 inputs (bf16 takes flash_fwd_sm90.cu).
//
// meta (int64[19]) as those entry points take it: B, Sq, Sk, Hq, Hkv, D,
// then element strides of q (b, s, h), k (b, s, h), v (b, s, h), out
// (b, s, h) and the mask (b). mask: (B, Sk) int32 or null (every key
// valid). lse: a contiguous (B, Hq, Sq) fp32 tensor that receives each row's
// log-sum-exp, or null. bound is read only with static_max. Returns a
// cudaError_t (0 on success); cudaErrorInvalidValue for what the kernel does
// not take (D outside 1..128, Hq not a multiple of Hkv, Sk < 1).

#pragma once

int flash_fwd_fp32_sm90(bool static_max, const void* q, const void* k, const void* v,
                        const int* mask, void* out, float* lse, const long long* meta,
                        float scale, float bound, void* stream);

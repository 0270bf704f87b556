// The fp32 attention backward of flash_bwd_fp32_sm90.cu, called by the C
// entry points lumina_flash_bwd_fused (Which::kFused), lumina_flash_bwd_dkv
// (Which::kDkv) and lumina_flash_bwd_dq (Which::kDq) of flash_bwd.cu for
// fp32 inputs (bf16 takes flash_bwd_sm90.cu).
//
// meta (int64[28]) as those entry points take it: B, Sq, Sk, Hq, Hkv, D,
// then element strides of q, k, v, dout, dq, dk, dv (b, s, h each) and the
// mask (b). mask: (B, Sk) int32 or null (every key valid). lse and delta:
// contiguous (B, Hq, Sq) fp32. kFused adds dQ into dq, a zeroed fp32
// buffer, and writes dk, dv; kDkv writes dk, dv only; kDq writes dq only.
// Returns a cudaError_t (0 on success); cudaErrorInvalidValue for what the
// kernels do not take (D outside 1..128, Hq not a multiple of Hkv, Sk < 1).

#pragma once

enum class Which { kDkv = 0, kFused = 1, kDq = 2 };  // as flash_attention._BWD_SM90_KERNELS

int flash_bwd_fp32_sm90(Which which, const void* q, const void* k, const void* v, const int* mask,
                        const void* dout, const float* lse, const float* delta, void* dq,
                        void* dk, void* dv, const long long* meta, float scale, void* stream);

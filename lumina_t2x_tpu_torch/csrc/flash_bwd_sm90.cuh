// The bf16 flash-attention backward of flash_bwd_sm90.cu, called by the C
// entry points lumina_flash_bwd_fused / lumina_flash_bwd_dkv
// (flash_bwd_sm90) and lumina_flash_bwd_dq (flash_bwd_dq_sm90) of
// flash_bwd.cu, which keep their fp32 path on the kernels there.
//
// meta (int64[28]) as those entry points take it: B, Sq, Sk, Hq, Hkv, D,
// then element strides of q, k, v, dout, dq, dk, dv (b, s, h each) and the
// mask (b). flash_bwd_sm90, fused: dq is a zeroed fp32 buffer the kernel
// adds dQ into; otherwise dq is not touched. flash_bwd_dq_sm90 writes dq
// (bf16, q's shape) only. Each returns a cudaError_t (0 on success);
// cudaErrorInvalidValue for what the kernels do not take (D not a multiple
// of 8 or above 128, a base or a stride not in whole 16-byte chunks).

#pragma once

int flash_bwd_sm90(bool fused, const void* q, const void* k, const void* v, const int* mask,
                   const void* dout, const float* lse, const float* delta, void* dq, void* dk,
                   void* dv, const long long* meta, float scale, void* stream);

int flash_bwd_dq_sm90(const void* q, const void* k, const void* v, const int* mask,
                      const void* dout, const float* lse, const float* delta, void* dq,
                      const long long* meta, float scale, void* stream);

// The attention backward's delta = rowsum(dO * O), hand-written CUDA C++ for
// sm_90a: lumina_bwd_delta, which every backward entry point (bf16, fp16 and
// fp32; lumina_flash_bwd_fused, _dq, _dkv) reads. It replaces no Pallas
// kernel: the JAX package computes delta outside its kernels, with one fp32
// einsum in `_bwd_prepare` (lumina_t2x_tpu/ops/flash_attention.py:680), and
// the port did it eagerly (fp32 copies of dO and O, their fp32 product, a
// sum and a transposed copy: ~7x the bytes of the two inputs). Its plain
// version is `ops/flash_attention.bwd_delta_plain`.
//
// What it computes: for each row (b, s, h) of O and dO (B, S, H, D) of one
// dtype (bf16, fp16 or fp32), delta[b, h, s] = sum_d dO[b, s, h, d] *
// O[b, s, h, d], products and sum in fp32 (one fma a term in d order; for
// contiguous inputs, of each 16-byte vector, the vectors' sums then added in
// order), into a contiguous (B, H, S) fp32 tensor. O and dO are read in place from
// element strides (last dim contiguous), each element once, with no copy.
//
// Layout: a block of 256 threads owns 256 rows in the inputs' order ((b, s)
// then h), one thread a row; the 4-byte writes go to (b, h, s), where L2
// (which holds all of delta at the shapes the port trains) merges them.
// Contiguous inputs (the training path's): the block's rows are one run of
// 256 * D elements of each input, read in 16-byte vectors (8 bf16 or fp16, 4
// fp32) by consecutive threads, so that each load of a warp reads 512
// contiguous bytes; each vector's partial dot goes to shared memory, then a
// thread sums its row's partials in order. Otherwise a thread reads its row
// itself, in vectors when D, the strides and both bases are whole vectors,
// else element by element. What bounds it on the card: bytes. At the
// ImageNet 600M's (256, 256, 32, 48) bf16 it reads 2 x 201 MB and writes 8.4
// MB (0.123 ms at 3.35 TB/s).

#include <cuda_runtime.h>

#include <stdint.h>

#include "sm90_common.cuh"

namespace {

constexpr int kRows = 256;  // rows (threads) a block

// fp32 of one element of T
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(fp16 x) { return __half2float(x); }

// acc += the products of one 16-byte vector of O and dO
template <class T>
__device__ __forceinline__ float dot_vec(const uint4& o, const uint4& d, float acc) {
  const uint32_t ow[4] = {o.x, o.y, o.z, o.w}, dw[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (std::is_same<T, float>::value) {
      acc = fmaf(__uint_as_float(dw[i]), __uint_as_float(ow[i]), acc);
    } else {
      acc = fmaf(Elem<T>::lo(dw[i]), Elem<T>::lo(ow[i]), acc);
      acc = fmaf(Elem<T>::hi(dw[i]), Elem<T>::hi(ow[i]), acc);
    }
  }
  return acc;
}

struct Args {
  int S, H, D;
  long long rows;                  // B * S * H
  long long o_sb, o_ss, o_sh;      // element strides of O
  long long d_sb, d_ss, d_sh;      // and of dO
};

template <class T, bool kVec>
__global__ void __launch_bounds__(kRows) bwd_delta_kernel(const T* __restrict__ o,
                                                          const T* __restrict__ dout,
                                                          float* __restrict__ delta, Args a) {
  const long long r = (long long)blockIdx.x * kRows + threadIdx.x;  // ((b * S) + s) * H + h
  if (r >= a.rows) return;
  const int h = (int)(r % a.H);
  const long long bs = r / a.H;
  const int s = (int)(bs % a.S), b = (int)(bs / a.S);
  const T* orow = o + b * a.o_sb + s * a.o_ss + h * a.o_sh;
  const T* drow = dout + b * a.d_sb + s * a.d_ss + h * a.d_sh;
  float acc = 0.f;
  if constexpr (kVec) {
    constexpr int kPer = 16 / sizeof(T);  // elements a vector
    const uint4* ov = reinterpret_cast<const uint4*>(orow);
    const uint4* dv = reinterpret_cast<const uint4*>(drow);
#pragma unroll 4
    for (int i = 0; i < a.D / kPer; ++i) acc = dot_vec<T>(__ldg(ov + i), __ldg(dv + i), acc);
  } else {
    for (int i = 0; i < a.D; ++i) acc = fmaf(to_f32(drow[i]), to_f32(orow[i]), acc);
  }
  delta[((long long)b * a.H + h) * a.S + s] = acc;
}

// delta of contiguous O and dO: the block's rows as one run of 16-byte
// vectors, read by consecutive threads; vector i's partial dot into
// part[i], then thread r sums row r's D / (16 / sizeof(T)) partials in order
template <class T>
__global__ void __launch_bounds__(kRows) bwd_delta_flat_kernel(const T* __restrict__ o,
                                                               const T* __restrict__ dout,
                                                               float* __restrict__ delta, Args a) {
  extern __shared__ float part[];  // kRows * per_row
  const int per_row = a.D / (16 / (int)sizeof(T));
  const long long r0 = (long long)blockIdx.x * kRows;
  const int rows = (int)min((long long)kRows, a.rows - r0);
  const uint4* ov = reinterpret_cast<const uint4*>(o + r0 * a.D);
  const uint4* dv = reinterpret_cast<const uint4*>(dout + r0 * a.D);
  const int n = rows * per_row;
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += kRows)
    part[i] = dot_vec<T>(__ldg(ov + i), __ldg(dv + i), 0.f);
  __syncthreads();
  if ((int)threadIdx.x >= rows) return;
  float acc = 0.f;
  for (int i = 0; i < per_row; ++i) acc += part[threadIdx.x * per_row + i];
  const long long r = r0 + threadIdx.x;  // ((b * S) + s) * H + h
  const int h = (int)(r % a.H);
  const long long bs = r / a.H;
  const int s = (int)(bs % a.S), b = (int)(bs / a.S);
  delta[((long long)b * a.H + h) * a.S + s] = acc;
}

template <class T>
int launch(const void* o, const void* dout, float* delta, const Args& a, cudaStream_t stream) {
  const long long chunk = 16 / sizeof(T);
  const bool vec = a.D % chunk == 0 && a.o_sb % chunk == 0 && a.o_ss % chunk == 0 &&
                   a.o_sh % chunk == 0 && a.d_sb % chunk == 0 && a.d_ss % chunk == 0 &&
                   a.d_sh % chunk == 0 && aligned16(o) && aligned16(dout);
  const long long hd = (long long)a.H * a.D, shd = a.S * hd;
  const bool flat = vec && a.D / chunk <= 32 && a.o_sh == a.D && a.o_ss == hd &&
                    a.o_sb == shd && a.d_sh == a.D && a.d_ss == hd && a.d_sb == shd;
  const dim3 grid((unsigned)((a.rows + kRows - 1) / kRows));
  const T* op = static_cast<const T*>(o);
  const T* dp = static_cast<const T*>(dout);
  if (flat)
    bwd_delta_flat_kernel<T><<<grid, kRows, kRows * (a.D / chunk) * 4, stream>>>(op, dp, delta,
                                                                                a);
  else if (vec)
    bwd_delta_kernel<T, true><<<grid, kRows, 0, stream>>>(op, dp, delta, a);
  else
    bwd_delta_kernel<T, false><<<grid, kRows, 0, stream>>>(op, dp, delta, a);
  return (int)cudaGetLastError();
}

}  // namespace

// meta (int64[10]): B, S, H, D, then the element strides (b, s, h) of out and
// of dout (the last dim contiguous). dtype: 0 fp32, 1 bf16, 2 fp16 (the
// flash entry points' codes); another code, or D above 1024, is refused.
// Writes delta, a contiguous (B, H, S) fp32 tensor. Returns the launch's
// cudaError_t (0 on success).
extern "C" int lumina_bwd_delta(const void* out, const void* dout, float* delta,
                                const long long* meta, int dtype, void* stream) {
  Args a;
  const long long B = meta[0];
  a.S = (int)meta[1];
  a.H = (int)meta[2];
  a.D = (int)meta[3];
  a.o_sb = meta[4];
  a.o_ss = meta[5];
  a.o_sh = meta[6];
  a.d_sb = meta[7];
  a.d_ss = meta[8];
  a.d_sh = meta[9];
  a.rows = B * a.S * a.H;
  if (a.D <= 0 || a.D > 1024) return (int)cudaErrorInvalidValue;
  if (a.rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(out, dout, delta, a, s);
    case 1: return launch<bf16>(out, dout, delta, a, s);
    case 2: return launch<fp16>(out, dout, delta, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

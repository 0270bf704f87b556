// RoPE rotation of a whole (B, S, H, D) tensor, hand-written CUDA C++ for
// sm_90a: lumina_rope_rotate, the key half of the fused-RoPE forwards
//   _flash_rope_kernel (lumina_t2x_tpu/ops/flash_attention.py, via
//   `_rotate_tile` on each k tile)
// and, in fp32, the query half of both rope kernels (the fp32 template
// rotates nothing). Its plain version is `ops/rope.apply_rope`.
//
// What it computes: out = x*cos_full + swap_pairs(x)*sin_signed per
// interleaved pair (2i, 2i+1), from the (S, D) fp32 tables of
// `ops/rope.rot_tables` indexed by sequence position:
//   out[2i]   = x[2i] cos_full[2i]     + x[2i+1] sin_signed[2i]
//   out[2i+1] = x[2i+1] cos_full[2i+1] + x[2i] sin_signed[2i+1]
// in fp32, each product and the sum rounded separately (no FMA
// contraction), then once to x's dtype: `apply_rope` bit for bit.
//
// Layout: x (B, S, H, D) bf16 or fp32 read in place from element strides
// (last dim contiguous); out a contiguous (B, S, H, D) tensor of x's dtype.
// One thread per vector of 8 bf16 (16 bytes) or 2 fp32 elements: D, the
// strides and the base in whole vectors.
//
// Why a kernel of its own: rotating k inside the Hopper forward would
// repeat it for each of the 22 q blocks of a head and read the fp32 tables
// from L2 each time (1.6-3.3 GB across the grid at the 2B shape); rotated
// once here, a key row costs one read and one write per kv head, so GQA adds
// nothing. What bounds it on the card: bytes. At B=2, S=4096, H=32, D=72
// bf16 it reads 37.7 MB and writes 37.7 MB (0.023 ms at 3.35 TB/s); the
// 2.4 MB of tables stay in L2 and each block's rows share them in L1.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Params {
  const void* x;
  void* out;
  const float* cos_full;    // (S, D) fp32
  const float* sin_signed;  // (S, D) fp32
  int B, S, H, D;
  long long sb, ss, sh;
};

template <typename T, int kVec>
struct alignas(sizeof(T) * kVec) Vec {
  T v[kVec];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads) rope_rotate_kernel(Params p, int total) {
  const int i = blockIdx.x * kThreads + threadIdx.x;  // vector index in out
  if (i >= total) return;
  const int per_head = p.D / kVec, per_row = p.H * per_head;
  const int row = i / per_row, rem = i - row * per_row;
  const int h = rem / per_head, c = (rem - h * per_head) * kVec;
  const int b = row / p.S, s = row - b * p.S;
  const Vec<T, kVec> x = *reinterpret_cast<const Vec<T, kVec>*>(
      static_cast<const T*>(p.x) + b * p.sb + (long long)s * p.ss + h * p.sh + c);
  const Vec<float, kVec> cs =
      *reinterpret_cast<const Vec<float, kVec>*>(p.cos_full + (long long)s * p.D + c);
  const Vec<float, kVec> sn =
      *reinterpret_cast<const Vec<float, kVec>*>(p.sin_signed + (long long)s * p.D + c);
  Vec<T, kVec> y;
#pragma unroll
  for (int j = 0; j < kVec; j += 2) {
    const float x0 = to_f32(x.v[j]), x1 = to_f32(x.v[j + 1]);
    y.v[j] = from_f32<T>(__fadd_rn(__fmul_rn(x0, cs.v[j]), __fmul_rn(x1, sn.v[j])));
    y.v[j + 1] = from_f32<T>(__fadd_rn(__fmul_rn(x1, cs.v[j + 1]), __fmul_rn(x0, sn.v[j + 1])));
  }
  *reinterpret_cast<Vec<T, kVec>*>(static_cast<T*>(p.out) + (long long)i * kVec) = y;
}

template <typename T, int kVec>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int kBytes = sizeof(T) * kVec;
  const long long total = (long long)p.B * p.S * p.H * (p.D / kVec);
  if (p.D % kVec != 0 || p.sb % kVec != 0 || p.ss % kVec != 0 || p.sh % kVec != 0 ||
      reinterpret_cast<uintptr_t>(p.x) % kBytes != 0 ||
      reinterpret_cast<uintptr_t>(p.out) % kBytes != 0 ||
      reinterpret_cast<uintptr_t>(p.cos_full) % (4 * kVec) != 0 ||
      reinterpret_cast<uintptr_t>(p.sin_signed) % (4 * kVec) != 0 || total >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  if (total == 0) return 0;
  const int blocks = (int)((total + kThreads - 1) / kThreads);
  rope_rotate_kernel<T, kVec><<<blocks, kThreads, 0, stream>>>(p, (int)total);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, S, H, D) read from element strides, out contiguous (B, S, H, D) of
// x's dtype (bf16 if is_bf16, else fp32), tables (S, D) fp32 contiguous.
// meta (int64[7]): B, S, H, D, then x's element strides (b, s, h). Returns
// the cudaError_t of the launch (0 on success); cudaErrorInvalidValue when
// D, a stride or a base is not in whole vectors (8 bf16, 2 fp32), or a
// table's base not in whole vectors of as many floats.
int lumina_rope_rotate(const void* x, void* out, const float* cos_full, const float* sin_signed,
                       const long long* meta, int is_bf16, void* stream) {
  Params p;
  p.x = x;
  p.out = out;
  p.cos_full = cos_full;
  p.sin_signed = sin_signed;
  p.B = (int)meta[0];
  p.S = (int)meta[1];
  p.H = (int)meta[2];
  p.D = (int)meta[3];
  p.sb = meta[4];
  p.ss = meta[5];
  p.sh = meta[6];
  if (p.D <= 0 || p.D % 2 != 0 || cos_full == nullptr || sin_signed == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16, 8>(p, s) : launch<float, 2>(p, s);
}

}  // extern "C"

// Flash-attention backward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU backward kernels of
// lumina_t2x_tpu/ops/flash_attention.py:
//   lumina_flash_bwd_fused <- _bwd_fused_kernel (_flash_bwd_fused_impl): one sweep, dK dV and dQ
//   lumina_flash_bwd_dq    <- _bwd_dq_kernel    (_flash_bwd_impl, first pallas_call)
//   lumina_flash_bwd_dkv   <- _bwd_dkv_kernel   (_flash_bwd_impl, second pallas_call)
// For bf16 inputs lumina_flash_bwd_fused and lumina_flash_bwd_dkv launch the
// Hopper kernel of flash_bwd_sm90.cu instead (wgmma, a TMA ring of Q/dO
// tiles, dQ by bulk reduce-add); their fp32 path, and lumina_flash_bwd_dq in
// both dtypes, stay here.
//
// What they compute (the Pallas kernels' math, not their TPU mechanics), from
// the forward's per-row log-sum-exp and delta = rowsum(dO * O):
//   s  = scale * q . k                 over valid keys (kv_mask != 0, j < Sk)
//   p  = exp(min(s - lse, 0))          0 on masked keys and on rows with lse = -inf
//   ds = p * (dO . v - delta) * scale
//   dV = sum_rows p^T dO,  dK = sum_rows ds^T q,  dQ = ds k
// A fully masked query row (lse = -inf) has dQ = 0 and adds nothing to dK or
// dV; a masked key has dK = dV = 0. GQA: one block owns a kv head and sweeps
// the q heads of its group, so dK and dV come out per kv head, summed in fp32.
//
// Layout: q/dO (B, Sq, Hq, D), k/v (B, Sk, Hkv, D), read in place from element
// strides (last dim contiguous); lse and delta (B, Hq, Sq) fp32; dQ, dK, dV
// written with their own strides. head_dim is zero-padded to a multiple of 16
// in shared memory (72 -> 80 at 2B); padded lanes never reach device memory.
//
// Design and what bounds it on the card. 64x64 tiles, 4 warps per block, the
// same building blocks as flash_fwd.cu: bf16 WMMA 16x16x16 products with fp32
// accumulation (bf16 K7; fp32 inputs, all three: fp32 FMA, exact to fp32). P
// and dS enter the bf16 products as a pair hi + lo (~16 mantissa bits), so
// the kernels compute the fp32-P/dS backward of their plain version (the
// Pallas kernels round p and ds to bf16 once). The TPU's dQ partials per KV
// block (no atomics there) are gone: the fused kernel adds each tile's dQ
// into a zeroed fp32 buffer with atomicAdd, which the wrapper casts to q's
// dtype. The dq/dkv pair needs no atomics and is deterministic. At the 2B
// training shapes (B=2, H=32, S=4096, D=72) one backward does five S x S x D
// products (s, dp, dV, dK, dQ; three of them twice for the hi/lo pair), ~1.2
// TFLOP, against ~0.2 GB of q/k/v/dO traffic per sweep: bound by math issue
// and, in this first version, by the shared-memory round trips around every
// WMMA product and by one ~165 KB block per SM. flash_bwd_sm90.cu, which bf16 K6/K8 run, is the
// redesign (wgmma with register accumulators, TMA, bulk dQ reduce-adds).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

#include <math.h>
#include <stdint.h>
#include <type_traits>

#include "flash_bwd_sm90.cuh"

namespace {

constexpr int kB = 64;         // q rows per tile = keys per tile
constexpr int kThreads = 128;  // 4 warps; thread pair (2r, 2r+1) owns tile row r
constexpr int kMaxHeadDim = 128;
constexpr int kMaxSmem = 232448;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* mask;  // (B, Sk) int32 or nullptr
  const void* dout;
  const float* lse;    // (B, Hq, Sq)
  const float* delta;  // (B, Hq, Sq)
  void* dq;            // T (dq kernel) or fp32 accumulator (fused kernel)
  void* dk;
  void* dv;
  int B, Sq, Sk, Hq, Hkv, D, DP;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  long long dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  long long m_sb;
  float scale;
};

template <typename T>
constexpr bool kIsBf16 = std::is_same<T, __nv_bfloat16>::value;

template <typename T>
struct Layout {
  int tld, sld, dld, pld, ald;  // leading dims in elements
  size_t x0, x1, y0, y1, s, dp, p, plo, ds, dslo, a0, a1, lse, delta, kv, total;

  __host__ __device__ explicit Layout(int dp_) {
    const int pad = 16 / (int)sizeof(T);
    tld = dp_ + pad;
    sld = (dp_ > kB ? dp_ : kB) + 4;
    dld = kB + 4;
    pld = kB + pad;
    ald = dp_ + 4;
    size_t off = 0;
    auto take = [&off](size_t bytes) {
      size_t at = off;
      off += (bytes + 127) / 128 * 128;
      return at;
    };
    const size_t tile = sizeof(T) * kB * tld;
    x0 = take(tile);
    x1 = take(tile);
    y0 = take(tile);
    y1 = take(tile);
    s = take(sizeof(float) * kB * sld);
    dp = take(sizeof(float) * kB * dld);
    p = take(sizeof(T) * kB * pld);
    plo = take(kIsBf16<T> ? sizeof(T) * kB * pld : 0);
    ds = take(sizeof(T) * kB * pld);
    dslo = take(kIsBf16<T> ? sizeof(T) * kB * pld : 0);
    a0 = take(sizeof(float) * kB * ald);
    a1 = take(sizeof(float) * kB * ald);
    lse = take(sizeof(float) * kB);
    delta = take(sizeof(float) * kB);
    kv = take(sizeof(int) * kB);
    total = off;
  }
};

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// (64 x D) rows row0.. of a (B, S, H, D) tensor -> shared (64 x DP), zero
// outside S and D
template <typename T>
__device__ void load_tile(T* dst, int ld, const T* src, long long sb, long long ss, long long sh,
                          int b, int h, int row0, int S, int D, int DP) {
  const T zero = from_f32<T>(0.f);
  for (int idx = threadIdx.x; idx < kB * DP; idx += kThreads) {
    const int r = idx / DP;
    const int c = idx - r * DP;
    const int s = row0 + r;
    T val = zero;
    if (s < S && c < D) val = src[b * sb + (long long)s * ss + h * sh + c];
    dst[r * ld + c] = val;
  }
}

__device__ void zero_f32(float* dst, int ld, int cols) {
  for (int idx = threadIdx.x; idx < kB * cols; idx += kThreads) {
    const int r = idx / cols;
    dst[r * ld + (idx - r * cols)] = 0.f;
  }
}

// C (64 x 64, fp32) = A (64 x DP) . B^T (B: 64 x DP); warp w owns rows 16w..
template <typename T>
__device__ void mm_abt(const T* A, const T* Bm, int ld, float* C, int ldc, int DP) {
  if constexpr (kIsBf16<T>) {
    using namespace nvcuda;
    const int w = threadIdx.x / 32;
    for (int n = 0; n < kB / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < DP / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bf;
        wmma::load_matrix_sync(a, A + (16 * w) * ld + kk * 16, ld);
        wmma::load_matrix_sync(bf, Bm + (16 * n) * ld + kk * 16, ld);
        wmma::mma_sync(acc, a, bf, acc);
      }
      wmma::store_matrix_sync(C + (16 * w) * ldc + 16 * n, acc, ldc, wmma::mem_row_major);
    }
  } else {
    const int r = threadIdx.x >> 1;
    const int j0 = (threadIdx.x & 1) * (kB / 2);
    for (int j = j0; j < j0 + kB / 2; ++j) {
      float acc = 0.f;
      for (int d = 0; d < DP; ++d) acc = fmaf(to_f32(A[r * ld + d]), to_f32(Bm[j * ld + d]), acc);
      C[r * ldc + j] = acc;
    }
  }
}

// C (64 x DP, fp32) += A^T . B, A (64 q rows x 64 keys), B (64 q rows x DP);
// C rows are keys. fp32 FMA: the kernel that uses it runs fp32 only (bf16
// dK/dV run flash_bwd_sm90.cu).
template <typename T>
__device__ void mm_atb(const T* A, int lda, const T* Bm, int ldb, float* C, int ldc, int DP) {
  const int r = threadIdx.x >> 1;
  const int c0 = (threadIdx.x & 1) * (DP / 2);
  for (int c = c0; c < c0 + DP / 2; ++c) {
    float acc = C[r * ldc + c];
    for (int j = 0; j < kB; ++j) acc = fmaf(to_f32(A[j * lda + r]), to_f32(Bm[j * ldb + c]), acc);
    C[r * ldc + c] = acc;
  }
}

// C (64 x DP, fp32) (+)= (A + Alo) . B, A (64 q rows x 64 keys), B (64 keys x DP)
template <typename T, bool kAccumulate>
__device__ void mm_ab(const T* A, const T* Alo, int lda, const T* Bm, int ldb, float* C, int ldc,
                      int DP) {
  if constexpr (kIsBf16<T>) {
    using namespace nvcuda;
    const int w = threadIdx.x / 32;
    for (int n = 0; n < DP / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      float* c = C + (16 * w) * ldc + 16 * n;
      if constexpr (kAccumulate) {
        wmma::load_matrix_sync(acc, c, ldc, wmma::mem_row_major);
      } else {
        wmma::fill_fragment(acc, 0.f);
      }
      for (int kk = 0; kk < kB / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a, alo;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
        wmma::load_matrix_sync(a, A + (16 * w) * lda + kk * 16, lda);
        wmma::load_matrix_sync(alo, Alo + (16 * w) * lda + kk * 16, lda);
        wmma::load_matrix_sync(bf, Bm + (16 * kk) * ldb + 16 * n, ldb);
        wmma::mma_sync(acc, a, bf, acc);
        wmma::mma_sync(acc, alo, bf, acc);
      }
      wmma::store_matrix_sync(c, acc, ldc, wmma::mem_row_major);
    }
  } else {
    const int r = threadIdx.x >> 1;
    const int c0 = (threadIdx.x & 1) * (DP / 2);
    for (int c = c0; c < c0 + DP / 2; ++c) {
      float acc = kAccumulate ? C[r * ldc + c] : 0.f;
      for (int j = 0; j < kB; ++j) acc = fmaf(to_f32(A[r * lda + j]), to_f32(Bm[j * ldb + c]), acc);
      C[r * ldc + c] = acc;
    }
  }
}

// per-row lse and delta of q rows q0.. of head h; rows past Sq get lse -inf
__device__ void load_row_stats(const Params& p, float* lse_s, float* delta_s, int b, int h,
                               int q0) {
  if (threadIdx.x < kB) {
    const int s = q0 + threadIdx.x;
    const long long at = ((long long)b * p.Hq + h) * p.Sq + s;
    lse_s[threadIdx.x] = s < p.Sq ? p.lse[at] : -INFINITY;
    delta_s[threadIdx.x] = s < p.Sq ? p.delta[at] : 0.f;
  }
}

__device__ void load_key_valid(const Params& p, int* kvalid, int b, int j0) {
  if (threadIdx.x < kB) {
    const int j = j0 + threadIdx.x;
    kvalid[threadIdx.x] = (j < p.Sk) && (p.mask == nullptr || p.mask[b * p.m_sb + j] != 0);
  }
}

// P and dS of one (q tile x key tile) from S = q.k^T and dP = dO.v^T, as
// bf16 hi/lo pairs (fp32 as is); thread pair (2r, 2r+1) owns row r
template <typename T>
__device__ void softmax_grad(const float* S, int sld, const float* dP, int dld, const float* lse_s,
                             const float* delta_s, const int* kvalid, T* P, T* Plo, T* dS, T* dSlo,
                             int pld, float scale) {
  const int r = threadIdx.x >> 1;
  const int j0 = (threadIdx.x & 1) * (kB / 2);
  const float lse = lse_s[r];
  const float delta = delta_s[r];
  const bool row_ok = lse != -INFINITY;
  for (int j = j0; j < j0 + kB / 2; ++j) {
    float pj = 0.f, dsj = 0.f;
    if (row_ok && kvalid[j]) {
      pj = expf(fminf(S[r * sld + j] * scale - lse, 0.f));
      dsj = pj * (dP[r * dld + j] - delta) * scale;
    }
    const T ph = from_f32<T>(pj);
    const T dh = from_f32<T>(dsj);
    P[r * pld + j] = ph;
    dS[r * pld + j] = dh;
    if constexpr (kIsBf16<T>) {
      Plo[r * pld + j] = from_f32<T>(pj - to_f32(ph));
      dSlo[r * pld + j] = from_f32<T>(dsj - to_f32(dh));
    }
  }
}

// One block per (64-key tile, kv head, batch): sweeps the q tiles of every q
// head of the group, accumulating dK and dV in shared fp32; with kFusedDq it
// also adds each tile's dQ into the fp32 buffer p.dq (the fused sweep).
// fp32 only: bf16 runs flash_bwd_sm90.cu.
template <typename T, bool kFusedDq>
__global__ void __launch_bounds__(kThreads) flash_bwd_kv_kernel(Params p) {
  static_assert(!kIsBf16<T>, "bf16 dK/dV run flash_bwd_sm90.cu");
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout<T> L(p.DP);
  T* Ks = reinterpret_cast<T*>(smem + L.x0);
  T* Vs = reinterpret_cast<T*>(smem + L.x1);
  T* Qs = reinterpret_cast<T*>(smem + L.y0);
  T* dOs = reinterpret_cast<T*>(smem + L.y1);
  float* Ss = reinterpret_cast<float*>(smem + L.s);
  float* dPs = reinterpret_cast<float*>(smem + L.dp);
  T* Ps = reinterpret_cast<T*>(smem + L.p);
  T* Plo = reinterpret_cast<T*>(smem + L.plo);
  T* dSs = reinterpret_cast<T*>(smem + L.ds);
  T* dSlo = reinterpret_cast<T*>(smem + L.dslo);
  float* dKa = reinterpret_cast<float*>(smem + L.a0);
  float* dVa = reinterpret_cast<float*>(smem + L.a1);
  float* lse_s = reinterpret_cast<float*>(smem + L.lse);
  float* delta_s = reinterpret_cast<float*>(smem + L.delta);
  int* kvalid = reinterpret_cast<int*>(smem + L.kv);

  const int j0 = blockIdx.x * kB;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = p.Hq / p.Hkv;
  const int DP = p.DP;
  const T* q = static_cast<const T*>(p.q);
  const T* dout = static_cast<const T*>(p.dout);

  load_tile<T>(Ks, L.tld, static_cast<const T*>(p.k), p.k_sb, p.k_ss, p.k_sh, b, hk, j0, p.Sk,
               p.D, DP);
  load_tile<T>(Vs, L.tld, static_cast<const T*>(p.v), p.v_sb, p.v_ss, p.v_sh, b, hk, j0, p.Sk,
               p.D, DP);
  load_key_valid(p, kvalid, b, j0);
  zero_f32(dKa, L.ald, DP);
  zero_f32(dVa, L.ald, DP);

  for (int h = hk * rep; h < (hk + 1) * rep; ++h) {
    for (int q0 = 0; q0 < p.Sq; q0 += kB) {
      __syncthreads();  // previous tile's Q, dO, P, dS, S no longer read
      load_tile<T>(Qs, L.tld, q, p.q_sb, p.q_ss, p.q_sh, b, h, q0, p.Sq, p.D, DP);
      load_tile<T>(dOs, L.tld, dout, p.o_sb, p.o_ss, p.o_sh, b, h, q0, p.Sq, p.D, DP);
      load_row_stats(p, lse_s, delta_s, b, h, q0);
      __syncthreads();
      mm_abt<T>(Qs, Ks, L.tld, Ss, L.sld, DP);
      mm_abt<T>(dOs, Vs, L.tld, dPs, L.dld, DP);
      __syncthreads();
      softmax_grad<T>(Ss, L.sld, dPs, L.dld, lse_s, delta_s, kvalid, Ps, Plo, dSs, dSlo, L.pld,
                      p.scale);
      __syncthreads();
      mm_atb<T>(Ps, L.pld, dOs, L.tld, dVa, L.ald, DP);
      mm_atb<T>(dSs, L.pld, Qs, L.tld, dKa, L.ald, DP);
      if constexpr (kFusedDq) {
        mm_ab<T, false>(dSs, dSlo, L.pld, Ks, L.tld, Ss, L.sld, DP);  // dQ tile into S
        __syncthreads();
        float* dq = static_cast<float*>(p.dq);
        for (int idx = threadIdx.x; idx < kB * p.D; idx += kThreads) {
          const int r = idx / p.D;
          const int c = idx - r * p.D;
          const int s = q0 + r;
          if (s < p.Sq && lse_s[r] != -INFINITY)
            atomicAdd(dq + b * p.dq_sb + (long long)s * p.dq_ss + h * p.dq_sh + c, Ss[r * L.sld + c]);
        }
      }
    }
  }
  __syncthreads();

  T* dk = static_cast<T*>(p.dk);
  T* dv = static_cast<T*>(p.dv);
  for (int idx = threadIdx.x; idx < kB * p.D; idx += kThreads) {
    const int r = idx / p.D;
    const int c = idx - r * p.D;
    const int s = j0 + r;
    if (s >= p.Sk) continue;
    dk[b * p.dk_sb + (long long)s * p.dk_ss + hk * p.dk_sh + c] = from_f32<T>(dKa[r * L.ald + c]);
    dv[b * p.dv_sb + (long long)s * p.dv_ss + hk * p.dv_sh + c] = from_f32<T>(dVa[r * L.ald + c]);
  }
}

// One block per (64-row q tile, q head, batch): sweeps the key tiles and
// accumulates dQ in shared fp32 (the dQ half of the two-kernel backward).
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout<T> L(p.DP);
  T* Qs = reinterpret_cast<T*>(smem + L.x0);
  T* dOs = reinterpret_cast<T*>(smem + L.x1);
  T* Ks = reinterpret_cast<T*>(smem + L.y0);
  T* Vs = reinterpret_cast<T*>(smem + L.y1);
  float* Ss = reinterpret_cast<float*>(smem + L.s);
  float* dPs = reinterpret_cast<float*>(smem + L.dp);
  T* Ps = reinterpret_cast<T*>(smem + L.p);
  T* Plo = reinterpret_cast<T*>(smem + L.plo);
  T* dSs = reinterpret_cast<T*>(smem + L.ds);
  T* dSlo = reinterpret_cast<T*>(smem + L.dslo);
  float* dQa = reinterpret_cast<float*>(smem + L.a0);
  float* lse_s = reinterpret_cast<float*>(smem + L.lse);
  float* delta_s = reinterpret_cast<float*>(smem + L.delta);
  int* kvalid = reinterpret_cast<int*>(smem + L.kv);

  const int q0 = blockIdx.x * kB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int DP = p.DP;

  load_tile<T>(Qs, L.tld, static_cast<const T*>(p.q), p.q_sb, p.q_ss, p.q_sh, b, h, q0, p.Sq,
               p.D, DP);
  load_tile<T>(dOs, L.tld, static_cast<const T*>(p.dout), p.o_sb, p.o_ss, p.o_sh, b, h, q0, p.Sq,
               p.D, DP);
  load_row_stats(p, lse_s, delta_s, b, h, q0);
  zero_f32(dQa, L.ald, DP);

  for (int j0 = 0; j0 < p.Sk; j0 += kB) {
    __syncthreads();  // previous tile's K, V, P, dS no longer read
    load_tile<T>(Ks, L.tld, static_cast<const T*>(p.k), p.k_sb, p.k_ss, p.k_sh, b, hk, j0, p.Sk,
                 p.D, DP);
    load_tile<T>(Vs, L.tld, static_cast<const T*>(p.v), p.v_sb, p.v_ss, p.v_sh, b, hk, j0, p.Sk,
                 p.D, DP);
    load_key_valid(p, kvalid, b, j0);
    __syncthreads();
    mm_abt<T>(Qs, Ks, L.tld, Ss, L.sld, DP);
    mm_abt<T>(dOs, Vs, L.tld, dPs, L.dld, DP);
    __syncthreads();
    softmax_grad<T>(Ss, L.sld, dPs, L.dld, lse_s, delta_s, kvalid, Ps, Plo, dSs, dSlo, L.pld,
                    p.scale);
    __syncthreads();
    mm_ab<T, true>(dSs, dSlo, L.pld, Ks, L.tld, dQa, L.ald, DP);
  }
  __syncthreads();

  T* dq = static_cast<T*>(p.dq);
  for (int idx = threadIdx.x; idx < kB * p.D; idx += kThreads) {
    const int r = idx / p.D;
    const int c = idx - r * p.D;
    const int s = q0 + r;
    if (s >= p.Sq) continue;
    dq[b * p.dq_sb + (long long)s * p.dq_ss + h * p.dq_sh + c] = from_f32<T>(dQa[r * L.ald + c]);
  }
}

enum class Which { kFused, kDq, kDkv };

template <typename T>
int launch_typed(Which which, const Params& p, cudaStream_t stream) {
  const Layout<T> L(p.DP);
  if (L.total > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  auto run = [&](auto kernel, dim3 grid) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)L.total);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kThreads, L.total, stream>>>(p);
    return (int)cudaGetLastError();
  };
  if constexpr (!kIsBf16<T>) {  // bf16 dK/dV and the fused sweep: flash_bwd_sm90.cu
    const dim3 kv_grid((p.Sk + kB - 1) / kB, p.Hkv, p.B);
    if (which == Which::kFused) return run(flash_bwd_kv_kernel<T, true>, kv_grid);
    if (which == Which::kDkv) return run(flash_bwd_kv_kernel<T, false>, kv_grid);
  } else if (which != Which::kDq) {
    return (int)cudaErrorInvalidValue;
  }
  return run(flash_bwd_dq_kernel<T>, dim3((p.Sq + kB - 1) / kB, p.Hq, p.B));
}

int launch(Which which, const void* q, const void* k, const void* v, const int* mask,
           const void* dout, const float* lse, const float* delta, void* dq, void* dk, void* dv,
           const long long* meta, float scale, int is_bf16, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.mask = mask;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.B = (int)meta[0];
  p.Sq = (int)meta[1];
  p.Sk = (int)meta[2];
  p.Hq = (int)meta[3];
  p.Hkv = (int)meta[4];
  p.D = (int)meta[5];
  long long* strides[] = {&p.q_sb, &p.q_ss, &p.q_sh, &p.k_sb, &p.k_ss, &p.k_sh,
                          &p.v_sb, &p.v_ss, &p.v_sh, &p.o_sb, &p.o_ss, &p.o_sh,
                          &p.dq_sb, &p.dq_ss, &p.dq_sh, &p.dk_sb, &p.dk_ss, &p.dk_sh,
                          &p.dv_sb, &p.dv_ss, &p.dv_sh, &p.m_sb};
  for (int i = 0; i < 22; ++i) *strides[i] = meta[6 + i];
  p.DP = (p.D + 15) / 16 * 16;
  p.scale = scale;
  if (p.D <= 0 || p.D > kMaxHeadDim || p.Hkv <= 0 || p.Hq % p.Hkv != 0 || p.Sk <= 0)
    return (int)cudaErrorInvalidValue;
  if (p.Sq == 0 || p.B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch_typed<__nv_bfloat16>(which, p, s);
  return launch_typed<float>(which, p, s);
}

}  // namespace

// Every entry point takes the same arguments. meta (int64[28]): B, Sq, Sk,
// Hq, Hkv, D, then element strides q, k, v, dout, dq, dk, dv (b, s, h each)
// and mask (b). mask may be null (every key valid). lse and delta are
// contiguous (B, Hq, Sq) fp32. lumina_flash_bwd_fused adds into dq, a zeroed
// fp32 buffer, and writes dk, dv; lumina_flash_bwd_dq writes dq (q's dtype)
// only; lumina_flash_bwd_dkv writes dk, dv only. Each returns the cudaError_t
// of the launch (0 on success).
#define LUMINA_FLASH_BWD_ARGS                                                              \
  const void *q, const void *k, const void *v, const int *mask, const void *dout,          \
      const float *lse, const float *delta, void *dq, void *dk, void *dv, const long long *meta, \
      float scale, int is_bf16, void *stream
#define LUMINA_FLASH_BWD_CALL(which) \
  launch(which, q, k, v, mask, dout, lse, delta, dq, dk, dv, meta, scale, is_bf16, stream)

extern "C" {

int lumina_flash_bwd_fused(LUMINA_FLASH_BWD_ARGS) {
  if (is_bf16)
    return flash_bwd_sm90(true, q, k, v, mask, dout, lse, delta, dq, dk, dv, meta, scale, stream);
  return LUMINA_FLASH_BWD_CALL(Which::kFused);
}

int lumina_flash_bwd_dq(LUMINA_FLASH_BWD_ARGS) { return LUMINA_FLASH_BWD_CALL(Which::kDq); }

int lumina_flash_bwd_dkv(LUMINA_FLASH_BWD_ARGS) {
  if (is_bf16)
    return flash_bwd_sm90(false, q, k, v, mask, dout, lse, delta, dq, dk, dv, meta, scale, stream);
  return LUMINA_FLASH_BWD_CALL(Which::kDkv);
}

}  // extern "C"

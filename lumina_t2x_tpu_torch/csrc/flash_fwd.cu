// Flash-attention forward for Hopper (sm_90a), hand-written CUDA C++.
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
// its launches. For bf16 inputs lumina_flash_small_kv, lumina_flash_online,
// lumina_flash_static_max, lumina_flash_online_lse and
// lumina_flash_static_max_lse launch the Hopper kernel of flash_fwd_sm90.cu
// (registers, exp2, a K/V ring; the LSE written from the consumers'
// registers). One templated kernel here (kStaticMax, kEmitLse, kRope) runs
// the rest: all seven entry points for fp32, and the two rope entry points
// for bf16 (its only bf16 instantiations).
//
// What it computes (the Pallas kernels' math, not their TPU mechanics):
//   s   = scale * q . k            over valid keys (kv_mask != 0, j < Sk)
//   p   = exp(s - m)               online running max m, with rescale, or
//   p   = exp(min(s - bound, 55))  with a fixed bound (kStaticMax)
//   out = sum_j p v_j / sum_j p    fp32 accumulation, output in q's dtype
//   lse = m + log(l) | bound + log(l)   (kEmitLse, fp32 only; plain (B, Hq, Sq) fp32)
// A query row whose keys are all masked outputs 0 and has lse = -inf.
//
// Fused RoPE (kRope, the two rope entry points; online softmax, no LSE): q and
// k arrive unrotated. Once a q tile (and, with kRopeQK, each k tile) sits in
// shared memory it is rotated there, in fp32, by the interleaved-pair formula
// of `_rotate_tile`:  x * cos_full + swap_pairs(x) * sin_signed,  from (S, D)
// fp32 tables the host builds from the angles (`ops/rope.rot_tables`; angles
// reach ~200 rad at extrapolated sizes, so no in-kernel sincos). Each
// product and the sum are rounded separately (__fmul_rn / __fadd_rn: no FMA
// contraction), then rounded once to the operand dtype, so the rotated tile
// equals the plain `apply_rope` bit for bit and the rest of the kernel is
// the online kernel's. Query rows index the table by query position, key rows
// by key position (self-attention: Sq == Sk, one table). The zero pad of
// head_dim (72 -> 80) is never touched: pairs (2i, 2i+1) lie inside D. With
// kRopeQK every k tile is rotated again for every q tile (64 times per head
// at S=4096); the rotation is ~3 fp32 operations per element against
// 4*Sq*D tensor-core operations per k row, so it is cheap next to the
// products, and the extra cost is the table reads from L2.
//
// Layout: q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D), read in place from
// element strides (the last dim must be contiguous); GQA maps q head h to kv
// head h / (Hq / Hkv); the ragged last KV tile and q tile are masked here,
// nothing is padded in device memory.
//
// Design and what bounds it on the card. One block of 4 warps per
// (64-row q tile, q head, batch); the block streams 64-key K/V tiles through
// shared memory. bf16 inputs use WMMA 16x16x16 bf16 tensor-core products
// with fp32 accumulation, head_dim zero-padded to a multiple of 16 in shared
// memory (72 -> 80 at 2B); fp32 inputs use fp32 FMA (exact to fp32, for
// tests and the fp32 model). The probabilities P enter the PV product as a
// bf16 pair p_hi + p_lo (two WMMA products, ~16 mantissa bits) and the
// denominator sums the fp32 p, so the kernel computes the fp32-P softmax of
// its plain version (the Pallas kernels round P to bf16 once; over 24
// random-weight 2B layers that rounding alone moves the output by ~2%
// relative L2). At the 2B main-path shapes (B=2, H=32, S=4096, D=72) the
// forward does 4*B*H*S*S*D = 309 GFLOP against ~38 MB of q/k/v/out traffic
// per K/V re-read sweep, so it is bound by math issue, and in this first
// version by the shared-memory round trips around each WMMA
// product (S, P and the O accumulator live in shared memory so the per-row
// softmax can run on plain threads). flash_fwd_sm90.cu is the redesign
// (wgmma with register accumulators, a TMA ring, warp specialisation) that
// bf16 K1-K5 run; bf16 K9 is to follow it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

#include <math.h>
#include <stdint.h>
#include <type_traits>

#include "flash_fwd_sm90.cuh"

namespace {

constexpr int kBQ = 64;        // q rows per block
constexpr int kBK = 64;        // keys per streamed tile
constexpr int kThreads = 128;  // 4 warps; thread pair (2r, 2r+1) owns row r
constexpr int kMaxHeadDim = 128;
// fused-RoPE modes of the forward template
constexpr int kRopeNone = 0;
constexpr int kRopeQ = 1;   // rotate q only (cross-attention to caption keys)
constexpr int kRopeQK = 2;  // rotate q and k (self-attention, Sq == Sk)

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* mask;  // (B, Sk) int32 or nullptr
  void* out;
  float* lse;       // (B, Hq, Sq) fp32 or nullptr
  const float* rope_cos;  // (Sq, D) fp32 cos_full, rope entry points only
  const float* rope_sin;  // (Sq, D) fp32 sin_signed
  int B, Sq, Sk, Hq, Hkv, D, DP;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  long long m_sb;
  float scale;
  float bound;
};

template <typename T>
struct Layout {
  // leading dims in elements; padded so WMMA pointers stay 32-byte aligned
  // and rows do not all start in the same shared-memory bank
  int qld, pld, sld, old_;
  size_t q_off, k_off, v_off, s_off, p_off, plo_off, o_off, st_off, kv_off, total;

  __host__ __device__ explicit Layout(int dp) {
    const int pad = 16 / (int)sizeof(T);
    qld = dp + pad;
    pld = kBK + pad;
    sld = kBK + 4;
    old_ = dp + 4;
    size_t off = 0;
    auto take = [&off](size_t bytes) {
      size_t at = off;
      off += (bytes + 127) / 128 * 128;
      return at;
    };
    q_off = take(sizeof(T) * kBQ * qld);
    k_off = take(sizeof(T) * kBK * qld);
    v_off = take(sizeof(T) * kBK * qld);
    s_off = take(sizeof(float) * kBQ * sld);
    p_off = take(sizeof(T) * kBQ * pld);
    plo_off = take(std::is_same<T, float>::value ? 0 : sizeof(T) * kBQ * pld);
    o_off = take(sizeof(float) * kBQ * old_);
    st_off = take(sizeof(float) * 2 * kBQ);  // running max, running sum
    kv_off = take(sizeof(int) * kBK);        // key-valid flags of the tile
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

// Copy a (rows x D) tile starting at row `row0` of a (B, S, H, D) tensor into
// shared memory as (rows x DP), zero-filling rows >= S and columns >= D.
template <typename T>
__device__ void load_tile(T* dst, int ld, const T* src, long long sb, long long ss,
                          long long sh, int b, int h, int row0, int S, int rows,
                          int D, int DP) {
  const T zero = from_f32<T>(0.f);
  for (int idx = threadIdx.x; idx < rows * DP; idx += kThreads) {
    const int r = idx / DP;
    const int c = idx - r * DP;
    const int s = row0 + r;
    T val = zero;
    if (s < S && c < D) val = src[b * sb + (long long)s * ss + h * sh + c];
    dst[r * ld + c] = val;
  }
}

// Rotate rows [0, rows) of a shared-memory tile whose first row is sequence
// position row0, in place: out = x * cos_full + swap_pairs(x) * sin_signed in
// fp32 with separately rounded products and sum, rounded once to T. One
// thread owns one (2i, 2i+1) pair, so the update is race-free; rows at or
// past S (zero-filled) are left as they are.
template <typename T>
__device__ void rotate_tile(T* tile, int ld, const float* cos_full, const float* sin_signed,
                            int row0, int S, int rows, int D) {
  const int pairs = D / 2;
  for (int idx = threadIdx.x; idx < rows * pairs; idx += kThreads) {
    const int r = idx / pairs;
    const int c = 2 * (idx - r * pairs);
    const int s = row0 + r;
    if (s >= S) continue;
    const float* cs = cos_full + (long long)s * D + c;
    const float* sn = sin_signed + (long long)s * D + c;
    const float x0 = to_f32(tile[r * ld + c]);
    const float x1 = to_f32(tile[r * ld + c + 1]);
    tile[r * ld + c] = from_f32<T>(__fadd_rn(__fmul_rn(x0, cs[0]), __fmul_rn(x1, sn[0])));
    tile[r * ld + c + 1] = from_f32<T>(__fadd_rn(__fmul_rn(x1, cs[1]), __fmul_rn(x0, sn[1])));
  }
}

// S (kBQ x kBK, fp32) = Q (kBQ x DP) . K^T
template <typename T>
__device__ void qk_tile(const T* Qs, const T* Ks, float* Ss, const Layout<T>& L, int DP) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    using namespace nvcuda;
    const int w = threadIdx.x / 32;
    for (int n = 0; n < kBK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < DP / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bf;
        wmma::load_matrix_sync(a, Qs + (16 * w) * L.qld + kk * 16, L.qld);
        wmma::load_matrix_sync(bf, Ks + (16 * n) * L.qld + kk * 16, L.qld);
        wmma::mma_sync(acc, a, bf, acc);
      }
      wmma::store_matrix_sync(Ss + (16 * w) * L.sld + 16 * n, acc, L.sld, wmma::mem_row_major);
    }
  } else {
    const int r = threadIdx.x >> 1;
    const int j0 = (threadIdx.x & 1) * (kBK / 2);
    for (int c = 0; c < kBK / 2; ++c) {
      const int j = j0 + c;
      float acc = 0.f;
      for (int d = 0; d < DP; ++d) acc = fmaf(to_f32(Qs[r * L.qld + d]), to_f32(Ks[j * L.qld + d]), acc);
      Ss[r * L.sld + j] = acc;
    }
  }
}

// O (kBQ x DP, fp32) += P (kBQ x kBK) . V (kBK x DP); for bf16, P = Ps + Plo
template <typename T>
__device__ void pv_tile(const T* Ps, const T* Plo, const T* Vs, float* Os, const Layout<T>& L,
                        int DP) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    using namespace nvcuda;
    const int w = threadIdx.x / 32;
    for (int n = 0; n < DP / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      float* o = Os + (16 * w) * L.old_ + 16 * n;
      wmma::load_matrix_sync(acc, o, L.old_, wmma::mem_row_major);
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a, alo;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
        wmma::load_matrix_sync(a, Ps + (16 * w) * L.pld + kk * 16, L.pld);
        wmma::load_matrix_sync(alo, Plo + (16 * w) * L.pld + kk * 16, L.pld);
        wmma::load_matrix_sync(bf, Vs + (16 * kk) * L.qld + 16 * n, L.qld);
        wmma::mma_sync(acc, a, bf, acc);
        wmma::mma_sync(acc, alo, bf, acc);
      }
      wmma::store_matrix_sync(o, acc, L.old_, wmma::mem_row_major);
    }
  } else {
    const int r = threadIdx.x >> 1;
    const int half = DP / 2;
    const int c0 = (threadIdx.x & 1) * half;
    for (int c = c0; c < c0 + half; ++c) {
      float acc = Os[r * L.old_ + c];
      for (int j = 0; j < kBK; ++j) acc = fmaf(to_f32(Ps[r * L.pld + j]), to_f32(Vs[j * L.qld + c]), acc);
      Os[r * L.old_ + c] = acc;
    }
  }
}

template <typename T, bool kStaticMax, bool kEmitLse, int kRope>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(Params p) {
  static_assert(kRope == kRopeNone || (!kStaticMax && !kEmitLse),
                "the fused-RoPE forward is the online kernel without LSE");
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout<T> L(p.DP);
  T* Qs = reinterpret_cast<T*>(smem + L.q_off);
  T* Ks = reinterpret_cast<T*>(smem + L.k_off);
  T* Vs = reinterpret_cast<T*>(smem + L.v_off);
  float* Ss = reinterpret_cast<float*>(smem + L.s_off);
  T* Ps = reinterpret_cast<T*>(smem + L.p_off);
  T* Plo = reinterpret_cast<T*>(smem + L.plo_off);
  float* Os = reinterpret_cast<float*>(smem + L.o_off);
  float* m_s = reinterpret_cast<float*>(smem + L.st_off);
  float* l_s = m_s + kBQ;
  int* kvalid = reinterpret_cast<int*>(smem + L.kv_off);

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int DP = p.DP;
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);

  load_tile<T>(Qs, L.qld, q, p.q_sb, p.q_ss, p.q_sh, b, h, q0, p.Sq, kBQ, p.D, DP);
  if constexpr (kRope != kRopeNone) {
    __syncthreads();  // the whole q tile has landed; the loop's barrier orders the rotation
    rotate_tile<T>(Qs, L.qld, p.rope_cos, p.rope_sin, q0, p.Sq, kBQ, p.D);
  }
  for (int idx = threadIdx.x; idx < kBQ * DP; idx += kThreads) {
    const int r = idx / DP;
    Os[r * L.old_ + (idx - r * DP)] = 0.f;
  }
  if (threadIdx.x < kBQ) {
    m_s[threadIdx.x] = -INFINITY;
    l_s[threadIdx.x] = 0.f;
  }

  const int r = threadIdx.x >> 1;
  const int half = threadIdx.x & 1;
  const int jc0 = half * (kBK / 2);
  const int oc0 = half * (DP / 2);

  for (int j0 = 0; j0 < p.Sk; j0 += kBK) {
    __syncthreads();  // previous tile's K/V/P no longer read
    load_tile<T>(Ks, L.qld, k, p.k_sb, p.k_ss, p.k_sh, b, hk, j0, p.Sk, kBK, p.D, DP);
    load_tile<T>(Vs, L.qld, v, p.v_sb, p.v_ss, p.v_sh, b, hk, j0, p.Sk, kBK, p.D, DP);
    if (threadIdx.x < kBK) {
      const int j = j0 + threadIdx.x;
      kvalid[threadIdx.x] = (j < p.Sk) && (p.mask == nullptr || p.mask[b * p.m_sb + j] != 0);
    }
    __syncthreads();
    if constexpr (kRope == kRopeQK) {
      rotate_tile<T>(Ks, L.qld, p.rope_cos, p.rope_sin, j0, p.Sk, kBK, p.D);
      __syncthreads();
    }

    qk_tile<T>(Qs, Ks, Ss, L, DP);
    __syncthreads();

    // softmax update of row r over this thread's half of the tile
    const float* srow = Ss + r * L.sld;
    T* prow = Ps + r * L.pld;
    T* plorow = Plo + r * L.pld;
    float alpha = 1.f;
    float m_new = 0.f;
    if constexpr (!kStaticMax) {
      float mx = -INFINITY;
      for (int c = 0; c < kBK / 2; ++c) {
        const int j = jc0 + c;
        if (kvalid[j]) mx = fmaxf(mx, srow[j] * p.scale);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_old = m_s[r];
      m_new = fmaxf(m_old, mx);
      alpha = (m_new == -INFINITY) ? 1.f : expf(m_old - m_new);
    }
    float lsum = 0.f;
    for (int c = 0; c < kBK / 2; ++c) {
      const int j = jc0 + c;
      float pj = 0.f;
      if (kvalid[j]) {
        const float s = srow[j] * p.scale;
        pj = kStaticMax ? expf(fminf(s - p.bound, 55.f)) : expf(s - m_new);
      }
      const T pt = from_f32<T>(pj);
      prow[j] = pt;
      if constexpr (!std::is_same<T, float>::value) plorow[j] = from_f32<T>(pj - to_f32(pt));
      lsum += pj;
    }
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    if constexpr (!kStaticMax) {
      for (int c = oc0; c < oc0 + DP / 2; ++c) Os[r * L.old_ + c] *= alpha;
    }
    __syncwarp();
    if (half == 0) {
      if constexpr (!kStaticMax) m_s[r] = m_new;
      l_s[r] = l_s[r] * alpha + lsum;
    }
    __syncthreads();

    pv_tile<T>(Ps, Plo, Vs, Os, L, DP);
  }
  __syncthreads();

  T* out = static_cast<T*>(p.out);
  for (int idx = threadIdx.x; idx < kBQ * p.D; idx += kThreads) {
    const int rr = idx / p.D;
    const int c = idx - rr * p.D;
    const int s = q0 + rr;
    if (s >= p.Sq) continue;
    const float l = l_s[rr];
    const float o = l > 0.f ? Os[rr * L.old_ + c] / l : 0.f;
    out[b * p.o_sb + (long long)s * p.o_ss + h * p.o_sh + c] = from_f32<T>(o);
  }
  if constexpr (kEmitLse) {
    if (threadIdx.x < kBQ && q0 + threadIdx.x < p.Sq) {
      const float l = l_s[threadIdx.x];
      const float base = kStaticMax ? p.bound : m_s[threadIdx.x];
      p.lse[((long long)b * p.Hq + h) * p.Sq + q0 + threadIdx.x] = l > 0.f ? base + logf(l) : -INFINITY;
    }
  }
}

template <typename T, bool kStaticMax, bool kEmitLse, int kRope>
int launch_typed(const Params& p, cudaStream_t stream) {
  const Layout<T> L(p.DP);
  auto kernel = flash_fwd_kernel<T, kStaticMax, kEmitLse, kRope>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.total);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.Sq + kBQ - 1) / kBQ, p.Hq, p.B);
  kernel<<<grid, kThreads, L.total, stream>>>(p);
  return (int)cudaGetLastError();
}

template <bool kStaticMax, bool kEmitLse, int kRope = kRopeNone>
int launch(const void* q, const void* k, const void* v, const int* mask, void* out,
           float* lse, const long long* meta, float scale, float bound, int is_bf16,
           void* stream, const float* rope_cos = nullptr, const float* rope_sin = nullptr) {
  Params p;
  p.rope_cos = rope_cos;
  p.rope_sin = rope_sin;
  p.q = q;
  p.k = k;
  p.v = v;
  p.mask = mask;
  p.out = out;
  p.lse = lse;
  p.B = (int)meta[0];
  p.Sq = (int)meta[1];
  p.Sk = (int)meta[2];
  p.Hq = (int)meta[3];
  p.Hkv = (int)meta[4];
  p.D = (int)meta[5];
  p.q_sb = meta[6];
  p.q_ss = meta[7];
  p.q_sh = meta[8];
  p.k_sb = meta[9];
  p.k_ss = meta[10];
  p.k_sh = meta[11];
  p.v_sb = meta[12];
  p.v_ss = meta[13];
  p.v_sh = meta[14];
  p.o_sb = meta[15];
  p.o_ss = meta[16];
  p.o_sh = meta[17];
  p.m_sb = meta[18];
  p.DP = (p.D + 15) / 16 * 16;
  p.scale = scale;
  p.bound = bound;
  if (p.D <= 0 || p.D > kMaxHeadDim || p.Hkv <= 0 || p.Hq % p.Hkv != 0 || p.Sk <= 0)
    return (int)cudaErrorInvalidValue;
  if (kRope != kRopeNone &&
      (p.D % 2 != 0 || rope_cos == nullptr || rope_sin == nullptr || (kRope == kRopeQK && p.Sk != p.Sq)))
    return (int)cudaErrorInvalidValue;
  if (p.Sq == 0 || p.B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // bf16 takes this template only for K9 (online, no LSE, rotation); bf16
  // K1-K5 go to flash_fwd_sm90.cu before reaching here
  if constexpr (!kStaticMax && !kEmitLse && kRope != kRopeNone) {
    if (is_bf16) return launch_typed<__nv_bfloat16, false, false, kRope>(p, s);
  } else {
    if (is_bf16) return (int)cudaErrorInvalidValue;
  }
  return launch_typed<float, kStaticMax, kEmitLse, kRope>(p, s);
}

}  // namespace

// Every entry point takes the same arguments. meta (int64[19]): B, Sq, Sk,
// Hq, Hkv, D, then element strides q (b, s, h), k (b, s, h), v (b, s, h),
// out (b, s, h), mask (b). mask may be null (every key valid); lse (B, Hq, Sq)
// fp32 is written only by the two *_lse entry points, bound read only by the
// two static_max ones. Each returns the cudaError_t of the launch (0 on
// success).
#define LUMINA_FLASH_ARGS                                                               \
  const void *q, const void *k, const void *v, const int *mask, void *out, float *lse, \
      const long long *meta, float scale, float bound, int is_bf16, void *stream

// The two rope entry points take unrotated q and k, the same meta, and the
// (Sq, D) fp32 tables cos_full and sin_signed (contiguous) instead of lse
// and bound; lumina_flash_rope needs Sk == Sq.
#define LUMINA_FLASH_ROPE_ARGS                                                          \
  const void *q, const void *k, const void *v, const int *mask, void *out,             \
      const float *rope_cos, const float *rope_sin, const long long *meta, float scale, \
      int is_bf16, void *stream

extern "C" {

int lumina_flash_small_kv(LUMINA_FLASH_ARGS) {
  if (is_bf16) return flash_fwd_sm90(false, q, k, v, mask, out, nullptr, meta, scale, 0.f, stream);
  return launch<false, false>(q, k, v, mask, out, nullptr, meta, scale, 0.f, is_bf16, stream);
}

int lumina_flash_online(LUMINA_FLASH_ARGS) {
  if (is_bf16) return flash_fwd_sm90(false, q, k, v, mask, out, nullptr, meta, scale, 0.f, stream);
  return launch<false, false>(q, k, v, mask, out, nullptr, meta, scale, 0.f, is_bf16, stream);
}

int lumina_flash_static_max(LUMINA_FLASH_ARGS) {
  if (is_bf16) return flash_fwd_sm90(true, q, k, v, mask, out, nullptr, meta, scale, bound, stream);
  return launch<true, false>(q, k, v, mask, out, nullptr, meta, scale, bound, is_bf16, stream);
}

int lumina_flash_online_lse(LUMINA_FLASH_ARGS) {
  if (is_bf16) return flash_fwd_sm90(false, q, k, v, mask, out, lse, meta, scale, 0.f, stream);
  return launch<false, true>(q, k, v, mask, out, lse, meta, scale, 0.f, is_bf16, stream);
}

int lumina_flash_static_max_lse(LUMINA_FLASH_ARGS) {
  if (is_bf16) return flash_fwd_sm90(true, q, k, v, mask, out, lse, meta, scale, bound, stream);
  return launch<true, true>(q, k, v, mask, out, lse, meta, scale, bound, is_bf16, stream);
}

int lumina_flash_rope(LUMINA_FLASH_ROPE_ARGS) {
  return launch<false, false, kRopeQK>(q, k, v, mask, out, nullptr, meta, scale, 0.f, is_bf16,
                                       stream, rope_cos, rope_sin);
}

int lumina_flash_rope_q(LUMINA_FLASH_ROPE_ARGS) {
  return launch<false, false, kRopeQ>(q, k, v, mask, out, nullptr, meta, scale, 0.f, is_bf16,
                                      stream, rope_cos, rope_sin);
}

}  // extern "C"

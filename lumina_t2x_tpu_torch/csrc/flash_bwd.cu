// Flash-attention backward, hand-written CUDA C++: the fp32 kernels.
//
// Replaces the Pallas TPU backward kernels of
// lumina_t2x_tpu/ops/flash_attention.py:
//   lumina_flash_bwd_fused <- _bwd_fused_kernel (_flash_bwd_fused_impl): one sweep, dK dV and dQ
//   lumina_flash_bwd_dq    <- _bwd_dq_kernel    (_flash_bwd_impl, first pallas_call)
//   lumina_flash_bwd_dkv   <- _bwd_dkv_kernel   (_flash_bwd_impl, second pallas_call)
// For bf16 inputs the three entry points launch the Hopper kernels of
// flash_bwd_sm90.cu instead (wgmma, TMA rings, dQ by bulk reduce-add or, for
// lumina_flash_bwd_dq, per q tile in registers); the kernels here run fp32
// inputs (the tests and the fp32 model), exact to fp32.
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
// in shared memory; padded lanes never reach device memory.
//
// Design: 64x64 tiles, 4 warps per block, fp32 FMA products through shared
// memory. The TPU's dQ partials per KV block (no atomics there) are gone:
// the fused kernel adds each tile's dQ into a zeroed fp32 buffer with
// atomicAdd; the dq/dkv pair needs no atomics and is deterministic. No
// workload runs fp32 attention at scale; the bf16 redesigns are in
// flash_bwd_sm90.cu.

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "flash_bwd_sm90.cuh"

namespace {

constexpr int kB = 64;         // q rows per tile = keys per tile
constexpr int kThreads = 128;  // 4 warps; thread pair (2r, 2r+1) owns tile row r
constexpr int kMaxHeadDim = 128;
constexpr int kMaxSmem = 232448;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const int* mask;  // (B, Sk) int32 or nullptr
  const float* dout;
  const float* lse;    // (B, Hq, Sq)
  const float* delta;  // (B, Hq, Sq)
  float* dq;           // the dq kernel's output or the fused kernel's zeroed accumulator
  float* dk;
  float* dv;
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

struct Layout {
  int tld, sld, dld, pld, ald;  // leading dims in elements
  size_t x0, x1, y0, y1, s, dp, p, ds, a0, a1, lse, delta, kv, total;

  __host__ __device__ explicit Layout(int dp_) {
    tld = dp_ + 4;
    sld = (dp_ > kB ? dp_ : kB) + 4;
    dld = kB + 4;
    pld = kB + 4;
    ald = dp_ + 4;
    size_t off = 0;
    auto take = [&off](size_t bytes) {
      size_t at = off;
      off += (bytes + 127) / 128 * 128;
      return at;
    };
    const size_t tile = sizeof(float) * kB * tld;
    x0 = take(tile);
    x1 = take(tile);
    y0 = take(tile);
    y1 = take(tile);
    s = take(sizeof(float) * kB * sld);
    dp = take(sizeof(float) * kB * dld);
    p = take(sizeof(float) * kB * pld);
    ds = take(sizeof(float) * kB * pld);
    a0 = take(sizeof(float) * kB * ald);
    a1 = take(sizeof(float) * kB * ald);
    lse = take(sizeof(float) * kB);
    delta = take(sizeof(float) * kB);
    kv = take(sizeof(int) * kB);
    total = off;
  }
};

// (64 x D) rows row0.. of a (B, S, H, D) tensor -> shared (64 x DP), zero
// outside S and D
__device__ void load_tile(float* dst, int ld, const float* src, long long sb, long long ss,
                          long long sh, int b, int h, int row0, int S, int D, int DP) {
  for (int idx = threadIdx.x; idx < kB * DP; idx += kThreads) {
    const int r = idx / DP;
    const int c = idx - r * DP;
    const int s = row0 + r;
    float val = 0.f;
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

// C (64 x 64) = A (64 x DP) . B^T (B: 64 x DP); thread pair (2r, 2r+1) owns row r
__device__ void mm_abt(const float* A, const float* Bm, int ld, float* C, int ldc, int DP) {
  const int r = threadIdx.x >> 1;
  const int j0 = (threadIdx.x & 1) * (kB / 2);
  for (int j = j0; j < j0 + kB / 2; ++j) {
    float acc = 0.f;
    for (int d = 0; d < DP; ++d) acc = fmaf(A[r * ld + d], Bm[j * ld + d], acc);
    C[r * ldc + j] = acc;
  }
}

// C (64 x DP) += A^T . B, A (64 q rows x 64 keys), B (64 q rows x DP); C rows are keys
__device__ void mm_atb(const float* A, int lda, const float* Bm, int ldb, float* C, int ldc,
                       int DP) {
  const int r = threadIdx.x >> 1;
  const int c0 = (threadIdx.x & 1) * (DP / 2);
  for (int c = c0; c < c0 + DP / 2; ++c) {
    float acc = C[r * ldc + c];
    for (int j = 0; j < kB; ++j) acc = fmaf(A[j * lda + r], Bm[j * ldb + c], acc);
    C[r * ldc + c] = acc;
  }
}

// C (64 x DP) (+)= A . B, A (64 q rows x 64 keys), B (64 keys x DP)
template <bool kAccumulate>
__device__ void mm_ab(const float* A, int lda, const float* Bm, int ldb, float* C, int ldc,
                      int DP) {
  const int r = threadIdx.x >> 1;
  const int c0 = (threadIdx.x & 1) * (DP / 2);
  for (int c = c0; c < c0 + DP / 2; ++c) {
    float acc = kAccumulate ? C[r * ldc + c] : 0.f;
    for (int j = 0; j < kB; ++j) acc = fmaf(A[r * lda + j], Bm[j * ldb + c], acc);
    C[r * ldc + c] = acc;
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

// P and dS of one (q tile x key tile) from S = q.k^T and dP = dO.v^T;
// thread pair (2r, 2r+1) owns row r
__device__ void softmax_grad(const float* S, int sld, const float* dP, int dld, const float* lse_s,
                             const float* delta_s, const int* kvalid, float* P, float* dS, int pld,
                             float scale) {
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
    P[r * pld + j] = pj;
    dS[r * pld + j] = dsj;
  }
}

// One block per (64-key tile, kv head, batch): sweeps the q tiles of every q
// head of the group, accumulating dK and dV in shared fp32; with kFusedDq it
// also adds each tile's dQ into the fp32 buffer p.dq (the fused sweep).
template <bool kFusedDq>
__global__ void __launch_bounds__(kThreads) flash_bwd_kv_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(p.DP);
  float* Ks = reinterpret_cast<float*>(smem + L.x0);
  float* Vs = reinterpret_cast<float*>(smem + L.x1);
  float* Qs = reinterpret_cast<float*>(smem + L.y0);
  float* dOs = reinterpret_cast<float*>(smem + L.y1);
  float* Ss = reinterpret_cast<float*>(smem + L.s);
  float* dPs = reinterpret_cast<float*>(smem + L.dp);
  float* Ps = reinterpret_cast<float*>(smem + L.p);
  float* dSs = reinterpret_cast<float*>(smem + L.ds);
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

  load_tile(Ks, L.tld, p.k, p.k_sb, p.k_ss, p.k_sh, b, hk, j0, p.Sk, p.D, DP);
  load_tile(Vs, L.tld, p.v, p.v_sb, p.v_ss, p.v_sh, b, hk, j0, p.Sk, p.D, DP);
  load_key_valid(p, kvalid, b, j0);
  zero_f32(dKa, L.ald, DP);
  zero_f32(dVa, L.ald, DP);

  for (int h = hk * rep; h < (hk + 1) * rep; ++h) {
    for (int q0 = 0; q0 < p.Sq; q0 += kB) {
      __syncthreads();  // previous tile's Q, dO, P, dS, S no longer read
      load_tile(Qs, L.tld, p.q, p.q_sb, p.q_ss, p.q_sh, b, h, q0, p.Sq, p.D, DP);
      load_tile(dOs, L.tld, p.dout, p.o_sb, p.o_ss, p.o_sh, b, h, q0, p.Sq, p.D, DP);
      load_row_stats(p, lse_s, delta_s, b, h, q0);
      __syncthreads();
      mm_abt(Qs, Ks, L.tld, Ss, L.sld, DP);
      mm_abt(dOs, Vs, L.tld, dPs, L.dld, DP);
      __syncthreads();
      softmax_grad(Ss, L.sld, dPs, L.dld, lse_s, delta_s, kvalid, Ps, dSs, L.pld, p.scale);
      __syncthreads();
      mm_atb(Ps, L.pld, dOs, L.tld, dVa, L.ald, DP);
      mm_atb(dSs, L.pld, Qs, L.tld, dKa, L.ald, DP);
      if constexpr (kFusedDq) {
        mm_ab<false>(dSs, L.pld, Ks, L.tld, Ss, L.sld, DP);  // dQ tile into S
        __syncthreads();
        float* dq = p.dq;
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

  for (int idx = threadIdx.x; idx < kB * p.D; idx += kThreads) {
    const int r = idx / p.D;
    const int c = idx - r * p.D;
    const int s = j0 + r;
    if (s >= p.Sk) continue;
    p.dk[b * p.dk_sb + (long long)s * p.dk_ss + hk * p.dk_sh + c] = dKa[r * L.ald + c];
    p.dv[b * p.dv_sb + (long long)s * p.dv_ss + hk * p.dv_sh + c] = dVa[r * L.ald + c];
  }
}

// One block per (64-row q tile, q head, batch): sweeps the key tiles and
// accumulates dQ in shared fp32 (the dQ half of the two-kernel backward).
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(p.DP);
  float* Qs = reinterpret_cast<float*>(smem + L.x0);
  float* dOs = reinterpret_cast<float*>(smem + L.x1);
  float* Ks = reinterpret_cast<float*>(smem + L.y0);
  float* Vs = reinterpret_cast<float*>(smem + L.y1);
  float* Ss = reinterpret_cast<float*>(smem + L.s);
  float* dPs = reinterpret_cast<float*>(smem + L.dp);
  float* Ps = reinterpret_cast<float*>(smem + L.p);
  float* dSs = reinterpret_cast<float*>(smem + L.ds);
  float* dQa = reinterpret_cast<float*>(smem + L.a0);
  float* lse_s = reinterpret_cast<float*>(smem + L.lse);
  float* delta_s = reinterpret_cast<float*>(smem + L.delta);
  int* kvalid = reinterpret_cast<int*>(smem + L.kv);

  const int q0 = blockIdx.x * kB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int DP = p.DP;

  load_tile(Qs, L.tld, p.q, p.q_sb, p.q_ss, p.q_sh, b, h, q0, p.Sq, p.D, DP);
  load_tile(dOs, L.tld, p.dout, p.o_sb, p.o_ss, p.o_sh, b, h, q0, p.Sq, p.D, DP);
  load_row_stats(p, lse_s, delta_s, b, h, q0);
  zero_f32(dQa, L.ald, DP);

  for (int j0 = 0; j0 < p.Sk; j0 += kB) {
    __syncthreads();  // previous tile's K, V, P, dS no longer read
    load_tile(Ks, L.tld, p.k, p.k_sb, p.k_ss, p.k_sh, b, hk, j0, p.Sk, p.D, DP);
    load_tile(Vs, L.tld, p.v, p.v_sb, p.v_ss, p.v_sh, b, hk, j0, p.Sk, p.D, DP);
    load_key_valid(p, kvalid, b, j0);
    __syncthreads();
    mm_abt(Qs, Ks, L.tld, Ss, L.sld, DP);
    mm_abt(dOs, Vs, L.tld, dPs, L.dld, DP);
    __syncthreads();
    softmax_grad(Ss, L.sld, dPs, L.dld, lse_s, delta_s, kvalid, Ps, dSs, L.pld, p.scale);
    __syncthreads();
    mm_ab<true>(dSs, L.pld, Ks, L.tld, dQa, L.ald, DP);
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < kB * p.D; idx += kThreads) {
    const int r = idx / p.D;
    const int c = idx - r * p.D;
    const int s = q0 + r;
    if (s >= p.Sq) continue;
    p.dq[b * p.dq_sb + (long long)s * p.dq_ss + h * p.dq_sh + c] = dQa[r * L.ald + c];
  }
}

enum class Which { kFused, kDq, kDkv };

// fp32 only: bf16 inputs run flash_bwd_sm90.cu before reaching here
int launch(Which which, const void* q, const void* k, const void* v, const int* mask,
           const void* dout, const float* lse, const float* delta, void* dq, void* dk, void* dv,
           const long long* meta, float scale, void* stream) {
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.mask = mask;
  p.dout = static_cast<const float*>(dout);
  p.lse = lse;
  p.delta = delta;
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
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
  const Layout L(p.DP);
  if (L.total > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t stream_ = static_cast<cudaStream_t>(stream);
  auto run = [&](auto kernel, dim3 grid) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)L.total);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kThreads, L.total, stream_>>>(p);
    return (int)cudaGetLastError();
  };
  const dim3 kv_grid((p.Sk + kB - 1) / kB, p.Hkv, p.B);
  if (which == Which::kFused) return run(flash_bwd_kv_kernel<true>, kv_grid);
  if (which == Which::kDkv) return run(flash_bwd_kv_kernel<false>, kv_grid);
  return run(flash_bwd_dq_kernel, dim3((p.Sq + kB - 1) / kB, p.Hq, p.B));
}

}  // namespace

// Every entry point takes the same arguments. meta (int64[28]): B, Sq, Sk,
// Hq, Hkv, D, then element strides q, k, v, dout, dq, dk, dv (b, s, h each)
// and mask (b). mask may be null (every key valid). lse and delta are
// contiguous (B, Hq, Sq) fp32. lumina_flash_bwd_fused adds into dq, a zeroed
// fp32 buffer, and writes dk, dv; lumina_flash_bwd_dq writes dq (q's dtype)
// only; lumina_flash_bwd_dkv writes dk, dv only. bf16 inputs go to
// flash_bwd_sm90.cu (flash_bwd_sm90.cuh), fp32 to the kernels here. Each
// returns the cudaError_t of the launch (0 on success).
#define LUMINA_FLASH_BWD_ARGS                                                              \
  const void *q, const void *k, const void *v, const int *mask, const void *dout,          \
      const float *lse, const float *delta, void *dq, void *dk, void *dv, const long long *meta, \
      float scale, int is_bf16, void *stream
#define LUMINA_FLASH_BWD_CALL(which) \
  launch(which, q, k, v, mask, dout, lse, delta, dq, dk, dv, meta, scale, stream)

extern "C" {

int lumina_flash_bwd_fused(LUMINA_FLASH_BWD_ARGS) {
  if (is_bf16)
    return flash_bwd_sm90(true, q, k, v, mask, dout, lse, delta, dq, dk, dv, meta, scale, stream);
  return LUMINA_FLASH_BWD_CALL(Which::kFused);
}

int lumina_flash_bwd_dq(LUMINA_FLASH_BWD_ARGS) {
  if (is_bf16)
    return flash_bwd_dq_sm90(q, k, v, mask, dout, lse, delta, dq, meta, scale, stream);
  return LUMINA_FLASH_BWD_CALL(Which::kDq);
}

int lumina_flash_bwd_dkv(LUMINA_FLASH_BWD_ARGS) {
  if (is_bf16)
    return flash_bwd_sm90(false, q, k, v, mask, dout, lse, delta, dq, dk, dv, meta, scale, stream);
  return LUMINA_FLASH_BWD_CALL(Which::kDkv);
}

}  // extern "C"

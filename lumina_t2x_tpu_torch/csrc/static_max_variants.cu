// Static-max attention with four per-logit op chains (K10) and a
// software-pipelined key loop (K11), hand-written CUDA C++ for Hopper
// (sm_90a). The kernels of the per-logit-work experiment
// (`lumina_t2x_tpu_torch/exps/vpu_op_reduction.py`):
//   lumina_static_max_v0..v3 <- _kernel_v0.._kernel_v3 (exps/vpu_op_reduction.py, `_loop`)
//   lumina_static_max_v4     <- _kernel_v4             (exps/vpu_op_reduction.py, `_loop_v4`)
// They are kept apart from flash_fwd.cu so that the experiment cannot change
// the model's attention kernels (K1-K9).
//
// What they compute, per (batch, head, query row), with s = q . k the fp32
// dot of a query row and a key row:
//   v0  t = s*scale (rounded); t = -2.3819763e38 on masked keys; p = exp(min(t - bound, clamp))
//   v1  p = exp(min(fma(s, scale, -bound), clamp)); p = 0 on masked keys
//   v2  p = exp2(min(fma(s, c1, -b2), clamp2)), c1 = scale*log2(e), b2 = bound*log2(e),
//       clamp2 = clamp*log2(e) folded on the host; p = 0 on masked keys
//   v3  v2 with no mask (the mask is ignored, as in the JAX kernel)
//   v4  v1's function; its output equals v1's bit for bit
//   out = sum_j bf16(p_j) v_j / max(sum_j bf16(p_j), 1e-30), in bf16
// P is rounded once to bf16, as `p.astype(v_ref.dtype)` does, and the
// denominator sums those same bf16 values (the JAX kernels get it from a
// ones column appended to v; here it is summed directly). Keys past Sk add
// nothing in every variant. The chains are written with __fmul_rn /
// __fsub_rn (v0: no FMA contraction, two roundings) and fmaf (v1-v4: one), so
// v0 and v1 compile to different code: nvcc would contract v0's mul and sub
// into one FFMA by default. v2/v3 call exp2f, one MUFU.EX2 with a denormal
// fix-up, where expf adds a range reduction around it.
//
// Layout: q, k, v bf16 (B, S, H, D), read in place from element strides
// (last dim contiguous, strides and base 16-byte aligned); D a multiple of
// 8, at most 128, zero-padded to kDP (32, 80 or 128) in shared memory; mask
// (B, Sk) int32 or null; out bf16 (B, Sq, H, D). As many kv heads as q heads.
//
// Design and what bounds it on the card. One block of 4 warps per (64-row
// q tile, head, batch); each warp owns 16 query rows. Q stays in registers
// as mma.sync A fragments; the 64-key K/V tiles stream through a 3-stage
// cp.async ring in shared memory; S = Q K^T (mma.sync.m16n8k16, fp32
// accumulators) stays in registers, where each thread runs the per-logit
// chain on its 32 logits, rounds P to bf16 straight into the A fragments of
// the PV product, and keeps its partial row sums; O accumulates in
// registers. Nothing of S or P goes through shared memory (unlike
// flash_fwd.cu). At the experiment's shape (B=2, S=4096, H=32, D=72) the two
// products are 4*B*H*S*S*D = 309 GFLOP (0.313 ms at 989 TFLOP/s), and the
// 1.07e9 logits need 0.275 ms of exp alone on the special-function units
// (16 results per clock per SM): two floors of nearly the same size, which
// is what the variants probe. K11 issues the QK^T of key tile j+1 into a
// second register S before the chain and PV of tile j, so the tensor cores
// have independent work while the chain runs; the accumulation order over
// key tiles is v1's, so only the issue order differs. This replaces the TPU
// grid's nk+1 steps and clamped index maps, which exist only because a
// Pallas grid runs in order.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <math.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

using namespace warp_mma;
using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;   // query rows per block, 16 per warp
constexpr int kBK = 64;   // keys per streamed tile
constexpr int kThreads = 128;
constexpr int kStages = 3;
constexpr int kNT = kBK / 8;   // 8-key column tiles of S
constexpr int kPK = kBK / 16;  // 16-key slices of P (A fragments of PV)
constexpr float kMaskedLogit = -2.3819763e38f;  // v0's select value (JAX's _NEG_INF)

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const int* mask;  // (B, Sk) int32 or null
  bf16* out;
  int B, Sq, Sk, H, D;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  long long m_sb;
  float scale, bound, clamp;  // v2/v3: already multiplied by log2(e)
};

template <int kDP>
struct Smem {
  static constexpr int kLD = kDP + 8;  // row stride: the 8 rows of an ldmatrix hit distinct banks
  static constexpr int kTile = kBK * kLD;
  // Q, then K and V of each stage, then the 64 key-valid bits of each stage
  static constexpr size_t kBytes = sizeof(bf16) * (1 + 2 * kStages) * kTile +
                                   sizeof(unsigned long long) * kStages;
  __device__ static bf16* q(unsigned char* base) { return reinterpret_cast<bf16*>(base); }
  __device__ static bf16* k(unsigned char* base, int st) { return q(base) + (1 + 2 * st) * kTile; }
  __device__ static bf16* v(unsigned char* base, int st) { return q(base) + (2 + 2 * st) * kTile; }
  __device__ static unsigned long long* bits(unsigned char* base) {
    return reinterpret_cast<unsigned long long*>(q(base) + (1 + 2 * kStages) * kTile);
  }
};

// rows [row0, row0 + 64) of head h, batch b of a (B, S, H, D) tensor into a
// (64 x kDP) shared tile, asynchronously; rows past S and columns past D are
// zero-filled
template <int kDP>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long sb, long long ss,
                                          long long sh, int b, int h, int row0, int S, int D) {
  constexpr int kChunks = kDP / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < kBK * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = idx - r * kChunks;
    const int s = row0 + r;
    const bool valid = s < S && c * 8 < D;
    const bf16* g = valid ? src + b * sb + (long long)s * ss + h * sh + c * 8 : src;
    cp_async_16(dst + r * Smem<kDP>::kLD + c * 8, g, valid);
  }
}

// key tile j0 of stage st: K and V asynchronously, and its key-valid bits
// (j < Sk and, with a mask, mask != 0) by warps 0 and 1
template <int kDP>
__device__ __forceinline__ void load_keys(unsigned char* smem, int st, const Params& p, int b,
                                          int h, int j0) {
  load_tile<kDP>(Smem<kDP>::k(smem, st), p.k, p.k_sb, p.k_ss, p.k_sh, b, h, j0, p.Sk, p.D);
  load_tile<kDP>(Smem<kDP>::v(smem, st), p.v, p.v_sb, p.v_ss, p.v_sh, b, h, j0, p.Sk, p.D);
  const int w = threadIdx.x / 32;
  if (w < 2) {
    const int j = j0 + 32 * w + threadIdx.x % 32;
    const bool ok = j < p.Sk && (p.mask == nullptr || p.mask[b * p.m_sb + j] != 0);
    const unsigned word = __ballot_sync(0xffffffffu, ok);
    if (threadIdx.x % 32 == 0) reinterpret_cast<unsigned*>(Smem<kDP>::bits(smem) + st)[w] = word;
  }
}

// this warp's 16 query rows as A fragments
template <int kDP>
__device__ __forceinline__ void load_q_frags(uint32_t (&qf)[kDP / 16][4], const bf16* Qs) {
  const int lane = threadIdx.x % 32;
  const bf16* row = Qs + (16 * (threadIdx.x / 32) + lane % 16) * Smem<kDP>::kLD + (lane / 16) * 8;
#pragma unroll
  for (int kk = 0; kk < kDP / 16; ++kk) ldmatrix_x4(qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3], row + 16 * kk);
}

// s (16 rows x 64 keys, fp32) = Q K^T
template <int kDP>
__device__ __forceinline__ void qk(float (&s)[kNT][4], const uint32_t (&qf)[kDP / 16][4],
                                   const bf16* Ks) {
  const int lane = threadIdx.x % 32;
  // matrices of one ldmatrix.x4: keys 8n..8n+7 at d 0-7 and 8-15, then keys 8n+8..8n+15
  const bf16* row = Ks + (lane % 8 + (lane / 16) * 8) * Smem<kDP>::kLD + ((lane / 8) % 2) * 8;
#pragma unroll
  for (int n = 0; n < kNT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kDP / 16; ++kk) {
#pragma unroll
    for (int n = 0; n < kNT; n += 2) {
      uint32_t b0, b1, b2, b3;
      ldmatrix_x4(b0, b1, b2, b3, row + 8 * n * Smem<kDP>::kLD + 16 * kk);
      mma_bf16(s[n], qf[kk], b0, b1);
      mma_bf16(s[n + 1], qf[kk], b2, b3);
    }
  }
}

// one logit through variant kVariant's chain; kSelect: apply the key-valid bit
template <int kVariant, bool kSelect>
__device__ __forceinline__ float chain(float s, bool valid, const Params& p) {
  if constexpr (kVariant == 0) {
    float t = __fmul_rn(s, p.scale);
    if (kSelect && !valid) t = kMaskedLogit;
    return expf(fminf(__fsub_rn(t, p.bound), p.clamp));
  } else if constexpr (kVariant == 1) {
    const float e = expf(fminf(fmaf(s, p.scale, -p.bound), p.clamp));
    return (kSelect && !valid) ? 0.f : e;
  } else {
    const float e = exp2f(fminf(fmaf(s, p.scale, -p.bound), p.clamp));
    return (kSelect && !valid) ? 0.f : e;
  }
}

// P = bf16(chain(S)) as the A fragments of PV, and this thread's share of
// the two row sums of the same bf16 values. `bits`: the tile's key-valid
// bits shifted so that bit c is this thread's column 8n + c of S
template <int kVariant, bool kSelect>
__device__ __forceinline__ void probs(uint32_t (&pf)[kPK][4], float (&rowsum)[2],
                                      const float (&s)[kNT][4], unsigned long long bits,
                                      const Params& p) {
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    const bool v0 = (bits >> (8 * n)) & 1ull;
    const bool v1 = (bits >> (8 * n + 1)) & 1ull;
    const uint32_t top = pack_bf16(chain<kVariant, kSelect>(s[n][0], v0, p),
                                   chain<kVariant, kSelect>(s[n][1], v1, p));
    const uint32_t bot = pack_bf16(chain<kVariant, kSelect>(s[n][2], v0, p),
                                   chain<kVariant, kSelect>(s[n][3], v1, p));
    rowsum[0] += bf16_lo(top);
    rowsum[0] += bf16_hi(top);
    rowsum[1] += bf16_lo(bot);
    rowsum[1] += bf16_hi(bot);
    pf[n / 2][(n % 2) * 2] = top;      // rows g, keys 16kk + 2t (+8 for odd n)
    pf[n / 2][(n % 2) * 2 + 1] = bot;  // rows g + 8
  }
}

// o (16 rows x kDP, fp32) += P V
template <int kDP>
__device__ __forceinline__ void pv(float (&o)[kDP / 8][4], const uint32_t (&pf)[kPK][4],
                                   const bf16* Vs) {
  const int lane = threadIdx.x % 32;
  // transposed matrices of one ldmatrix.x4: keys 0-7 and 8-15 at d 8n..8n+7, then d 8n+8..
  const bf16* row = Vs + (lane % 8 + ((lane / 8) % 2) * 8) * Smem<kDP>::kLD + (lane / 16) * 8;
#pragma unroll
  for (int kk = 0; kk < kPK; ++kk) {
#pragma unroll
    for (int n = 0; n < kDP / 8; n += 2) {
      uint32_t b0, b1, b2, b3;
      ldmatrix_x4_trans(b0, b1, b2, b3, row + 16 * kk * Smem<kDP>::kLD + 8 * n);
      mma_bf16(o[n], pf[kk], b0, b1);
      mma_bf16(o[n + 1], pf[kk], b2, b3);
    }
  }
}

// the chain and PV of one key tile; v3 applies the key-valid bits only on
// the ragged last tile (keys past Sk), as it has no mask
template <int kVariant, int kDP>
__device__ __forceinline__ void tile_update(float (&o)[kDP / 8][4], float (&rowsum)[2],
                                            const float (&s)[kNT][4], unsigned char* smem, int st,
                                            int j0, const Params& p) {
  const unsigned long long bits = Smem<kDP>::bits(smem)[st] >> (2 * (threadIdx.x % 4));
  uint32_t pf[kPK][4];
  if (kVariant == 3 && j0 + kBK <= p.Sk) {
    probs<kVariant, false>(pf, rowsum, s, bits, p);
  } else {
    probs<kVariant, true>(pf, rowsum, s, bits, p);
  }
  pv<kDP>(o, pf, Smem<kDP>::v(smem, st));
}

template <int kDP>
__device__ __forceinline__ void write_out(const float (&o)[kDP / 8][4], float (&rowsum)[2],
                                          const Params& p, int b, int h, int q0) {
  const int lane = threadIdx.x % 32;
  const int t = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rowsum[i] += __shfl_xor_sync(0xffffffffu, rowsum[i], 1);
    rowsum[i] += __shfl_xor_sync(0xffffffffu, rowsum[i], 2);
  }
  const float den[2] = {fmaxf(rowsum[0], 1e-30f), fmaxf(rowsum[1], 1e-30f)};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int s = q0 + 16 * (threadIdx.x / 32) + lane / 4 + 8 * half;
    if (s >= p.Sq) continue;
    bf16* row = p.out + b * p.o_sb + (long long)s * p.o_ss + h * p.o_sh;
#pragma unroll
    for (int n = 0; n < kDP / 8; ++n) {
      const int c = 8 * n + 2 * t;
      if (c >= p.D) break;
      *reinterpret_cast<__nv_bfloat162*>(row + c) =
          __floats2bfloat162_rn(o[n][2 * half] / den[half], o[n][2 * half + 1] / den[half]);
    }
  }
}

// K10: variant kVariant, QK^T of a tile issued after the previous tile's PV
template <int kVariant, int kDP>
__global__ void __launch_bounds__(kThreads) static_max_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int nk = (p.Sk + kBK - 1) / kBK;

  load_tile<kDP>(Smem<kDP>::q(smem), p.q, p.q_sb, p.q_ss, p.q_sh, b, h, q0, p.Sq, p.D);
  load_keys<kDP>(smem, 0, p, b, h, 0);
  cp_async_commit();
  if (nk > 1) load_keys<kDP>(smem, 1, p, b, h, kBK);
  cp_async_commit();

  uint32_t qf[kDP / 16][4];
  float o[kDP / 8][4];
#pragma unroll
  for (int n = 0; n < kDP / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float rowsum[2] = {0.f, 0.f};

  for (int j = 0; j < nk; ++j) {
    const int st = j % kStages;
    if (j + 2 < nk) load_keys<kDP>(smem, (j + 2) % kStages, p, b, h, (j + 2) * kBK);
    cp_async_commit();
    cp_async_wait<2>();  // tile j (and Q) landed
    __syncthreads();
    if (j == 0) load_q_frags<kDP>(qf, Smem<kDP>::q(smem));
    float s[kNT][4];
    qk<kDP>(s, qf, Smem<kDP>::k(smem, st));
    tile_update<kVariant, kDP>(o, rowsum, s, smem, st, j * kBK, p);
    __syncthreads();  // stage st is refilled at the next iteration
  }
  write_out<kDP>(o, rowsum, p, b, h, q0);
}

// K11: v1's function with the QK^T of tile j+1 issued before the chain and
// PV of tile j, into a second register S
template <int kDP>
__global__ void __launch_bounds__(kThreads) static_max_v4_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int nk = (p.Sk + kBK - 1) / kBK;

  load_tile<kDP>(Smem<kDP>::q(smem), p.q, p.q_sb, p.q_ss, p.q_sh, b, h, q0, p.Sq, p.D);
  load_keys<kDP>(smem, 0, p, b, h, 0);
  cp_async_commit();
  if (nk > 1) load_keys<kDP>(smem, 1, p, b, h, kBK);
  cp_async_commit();

  uint32_t qf[kDP / 16][4];
  float o[kDP / 8][4];
#pragma unroll
  for (int n = 0; n < kDP / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float rowsum[2] = {0.f, 0.f};

  cp_async_wait<1>();  // Q and tile 0 landed
  __syncthreads();
  load_q_frags<kDP>(qf, Smem<kDP>::q(smem));
  float s_cur[kNT][4], s_next[kNT][4];
  qk<kDP>(s_cur, qf, Smem<kDP>::k(smem, 0));

  for (int j = 0; j < nk; ++j) {
    const int st = j % kStages;
    if (j + 2 < nk) load_keys<kDP>(smem, (j + 2) % kStages, p, b, h, (j + 2) * kBK);
    cp_async_commit();
    if (j + 1 < nk) {
      cp_async_wait<1>();  // tile j+1 landed
      __syncthreads();
      qk<kDP>(s_next, qf, Smem<kDP>::k(smem, (j + 1) % kStages));
    }
    tile_update<1, kDP>(o, rowsum, s_cur, smem, st, j * kBK, p);
    if (j + 1 < nk) {
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s_cur[n][e] = s_next[n][e];
    }
    __syncthreads();  // stage st is refilled at the next iteration
  }
  write_out<kDP>(o, rowsum, p, b, h, q0);
}

template <int kDP>
int launch_dp(int variant, const Params& p, cudaStream_t stream) {
  void (*kernel)(Params) = variant == 0   ? static_max_kernel<0, kDP>
                           : variant == 1 ? static_max_kernel<1, kDP>
                           : variant == 2 ? static_max_kernel<2, kDP>
                           : variant == 3 ? static_max_kernel<3, kDP>
                                          : static_max_v4_kernel<kDP>;
  const int bytes = (int)Smem<kDP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.Sq + kBQ - 1) / kBQ, p.H, p.B);
  kernel<<<grid, kThreads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

int launch(int variant, const void* q, const void* k, const void* v, const int* mask, void* out,
           const long long* meta, float scale, float bound, float clamp, void* stream) {
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.mask = variant == 3 ? nullptr : mask;
  p.out = static_cast<bf16*>(out);
  p.B = (int)meta[0];
  p.Sq = (int)meta[1];
  p.Sk = (int)meta[2];
  p.H = (int)meta[3];
  p.D = (int)meta[4];
  p.q_sb = meta[5];
  p.q_ss = meta[6];
  p.q_sh = meta[7];
  p.k_sb = meta[8];
  p.k_ss = meta[9];
  p.k_sh = meta[10];
  p.v_sb = meta[11];
  p.v_ss = meta[12];
  p.v_sh = meta[13];
  p.o_sb = meta[14];
  p.o_ss = meta[15];
  p.o_sh = meta[16];
  p.m_sb = meta[17];
  p.scale = scale;
  p.bound = bound;
  p.clamp = clamp;
  // cp.async moves 16-byte chunks: D, the strides and the bases in whole chunks
  for (int i = 5; i <= 16; ++i)
    if (meta[i] % 8 != 0) return (int)cudaErrorInvalidValue;
  if (p.D <= 0 || p.D > 128 || p.D % 8 != 0 || p.Sk <= 0 || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  if (p.Sq == 0 || p.B == 0 || p.H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.D <= 32) return launch_dp<32>(variant, p, s);
  if (p.D <= 80) return launch_dp<80>(variant, p, s);
  return launch_dp<128>(variant, p, s);
}

}  // namespace

// Every entry point takes the same arguments. meta (int64[18]): B, Sq, Sk,
// H, D, then element strides of q (b, s, h), k (b, s, h), v (b, s, h), out
// (b, s, h) and the mask (b). mask may be null (every key valid; v3 ignores
// it). scale, bound and clamp as the variant uses them (v2/v3: times
// log2(e)). Each returns the cudaError_t of the launch (0 on success).
#define LUMINA_STATIC_MAX_ARGS                                                         \
  const void *q, const void *k, const void *v, const int *mask, void *out,            \
      const long long *meta, float scale, float bound, float clamp, void *stream
#define LUMINA_STATIC_MAX_CALL q, k, v, mask, out, meta, scale, bound, clamp, stream

extern "C" {

int lumina_static_max_v0(LUMINA_STATIC_MAX_ARGS) { return launch(0, LUMINA_STATIC_MAX_CALL); }
int lumina_static_max_v1(LUMINA_STATIC_MAX_ARGS) { return launch(1, LUMINA_STATIC_MAX_CALL); }
int lumina_static_max_v2(LUMINA_STATIC_MAX_ARGS) { return launch(2, LUMINA_STATIC_MAX_CALL); }
int lumina_static_max_v3(LUMINA_STATIC_MAX_ARGS) { return launch(3, LUMINA_STATIC_MAX_CALL); }
int lumina_static_max_v4(LUMINA_STATIC_MAX_ARGS) { return launch(4, LUMINA_STATIC_MAX_CALL); }

}  // extern "C"

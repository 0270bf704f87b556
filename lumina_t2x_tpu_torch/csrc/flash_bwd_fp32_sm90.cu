// fp32 attention backward for Hopper (sm_90a), hand-written CUDA C++:
// register-tiled FFMA products, exact to fp32 (no tensor-core TF32).
// Replaces, for fp32 inputs, the Pallas TPU kernels of
// lumina_t2x_tpu/ops/flash_attention.py
//   _bwd_fused_kernel :619 (pallas_call :791)  flash_bwd_kv_kernel<true>  (lumina_flash_bwd_fused)
//   _bwd_dkv_kernel   :584 (pallas_call :729)  flash_bwd_kv_kernel<false> (lumina_flash_bwd_dkv)
//   _bwd_dq_kernel    :552 (pallas_call :699)  flash_bwd_dq_kernel        (lumina_flash_bwd_dq)
// The C entry points stay in flash_bwd.cu (launch counters "bwd_fused",
// "bwd_dkv", "bwd_dq"), which hands fp32 inputs to flash_bwd_fp32_sm90()
// and bf16 to flash_bwd_sm90.cu. Both trainers' --precision fp32 (and the
// image trainer's fp16, cast to fp32 by the wrapper) take every attention
// backward through these kernels.
//
// What they compute, from the forward's per-row log-sum-exp and
// delta = rowsum(dO * O), over the valid keys (kv_mask != 0, j < Sk), in
// the exp2 domain (the host folds scale*log2(e); lse*log2(e) per row):
//   s  = q . k
//   p  = exp2(min(s*scale2 - lse*log2(e), 0))
//   ds = p * (dO . v - delta) * scale
//   dV = sum_rows p^T dO,  dK = sum_rows ds^T q,  dQ = ds k
// A query row with lse = -inf (no valid key) or past Sq, and a masked key,
// get p = ds = 0 by a select, so neither garbage in shared memory nor the
// unguarded exp2(min(+inf, 0)) = 1 reaches a sum: such a row gets dQ = 0
// and adds nothing to dK or dV; a masked key gets dK = dV = 0. GQA: a dK/dV
// block owns a kv head and sweeps the q heads of its group, summing dK and
// dV over the group in registers. Products and sums are fp32 FFMA.
//
// What bounds them. At the 2B's (B=2, Sq=Sk=4096, H=32, D=72) the fused
// sweep's five products are 10*B*H*Sq*Sk*D = 773 GFLOP: 11.54 ms at the
// 67 TFLOP/s fp32 rate outside the tensor cores (K8's four 9.23 ms, K7's
// three 6.92 ms); its 0.48 GB of operands and gradients take 0.14 ms at
// 3.35 TB/s. At the music trainer's (32, 256, 16, 72) the fused sweep is
// 24.2 GFLOP over its 256 frames (0.361 ms) and 7.3 GFLOP over its 77
// caption keys (0.108 ms), both above their bytes (0.090 / 0.059 ms). FFMA
// issue bounds them on paper; what bounds them on the card is the shared
// memory that feeds the FFMAs. An SM issues 4 warp FFMAs a clock but moves
// 128 bytes of shared memory into registers a clock (32 floats: a warp's
// LDS.128 takes 4 clocks, broadcast or not), so a product stays FFMA-bound
// only while a thread does at least 4 FFMAs per float it loads. Register
// tiles set that ratio: a thread tile of R x C outputs does R*C FFMAs per
// R + C floats of depth. The first fp32 kernels, which these replace, did
// half an FFMA per float (scalar products, both operands from shared
// memory, bank conflicts), kept eight 64-row tiles and dK/dV in ~199 KB of
// shared memory (one 4-warp block an SM), added dQ by one scalar atomicAdd
// per element, and loaded behind __syncthreads: 21-23x their bounds on an
// H100 SXM. Here a thread does 2 FFMAs per float in the scores (4 x 4
// tiles), 2.9 in dV/dK and K7's dQ, 2.2 in the fused dQ; a design with 2 x 8
// score tiles and one-row dQ tiles (1.6, 1.8 and 1.0) ran 3.0-3.4x the
// bounds there, this one 2.3-2.5x.
//
// Design of the dK/dV kernel (K6 with dQ, K8 without): a block of 4 warps
// per (64 keys, kv head, batch); warp w owns keys 16w .. 16w + 15 of the
// block; hi = lane / 8, lo = lane % 8. K and V are copied once; (q head of
// the group, 32-row q tile) pairs stream Q, dO, lse and delta through a
// ring of 2 stages, the next stage's copies in flight during the current
// one's products. Per q tile a thread computes, in registers,
//   S^T, dP^T  its keys 16w + hi + 4i x q rows lo + 8m (i, m < 4): each
//              k-step of 4 depth columns loads 4 K, 4 V, 4 Q and 4 dO float4s
//              for 128 FFMAs;
//   P, dS      the select above, one FMA, a min and one MUFU.EX2 a logit;
// writes P and dS into its warp's own buffers ([q row][16 keys], pitch 20;
// __syncwarp only), and runs
//   dV += P^T dO, dK += dS^T Q   its keys 16w + 4hi + i x columns
//              2 (lo + 8c) .. +1, c < NC = round_up(D, 16) / 16: per q row
//              a float4 each of P and dS and NC float2s each of dO and Q for
//              16 NC FFMAs
// with dK and dV (4 x 2NC floats each a thread) in registers for the whole
// sweep, written once at the end. Rows of Q, dO, K and V are padded to a
// pitch of round_up(D, 8) + 4 floats, so the 4 or 8 consecutive rows a warp
// reads at once fall in distinct banks; the buffers' pitches do the same for
// their stores and loads. dQ (fused only): after a block barrier a thread
// takes q rows lo + 8m (m < 4) and columns cq + 16c (cq = thread / 8) of
// the tile and sums dS K over the block's 64 keys, warp by warp from their
// dS buffers (per 4 keys 4 float4s of dS and 4 NC K floats for 16 NC
// FFMAs); the tile goes into a 32 x D staging tile and one thread adds it
// into the zeroed fp32 dQ buffer with one TMA bulk reduce-add
// (tma_reduce_add of sm90_common.cuh; rows past Sq are clipped), one per (q
// tile, 64 keys): no scalar atomics. The reduce reads the staging tile
// asynchronously; the next tile waits for that read (bulk_wait_read) before
// its barrier. The order of the adds into dQ varies from run to run, so
// fused dQ is not bitwise repeatable; the K7 + K8 pair is. A dQ buffer not
// in whole 16-byte chunks (head_dim not a multiple of 4) is added by
// atomicAdd per element.
//
// Design of the dQ kernel (K7): a block of 4 warps per (64 q rows, q head,
// batch); warp w owns rows 16w .. 16w + 15. Q and dO are copied once;
// 32-key K/V sub-tiles stream through a ring of 2 stages. Per sub-tile a
// thread computes S and dP for rows 16w + hi + 4i x keys lo + 8m (4 x 4, as
// above), dS by the same select with its rows' lse and delta held in
// registers, writes dS into its warp's buffer ([q row][32 keys], pitch 40),
// and adds dQ += dS K for rows 16w + (lane % 4) + 4m x columns
// 2 (lane / 4 + 8c) .. +1 over the sub-tile's keys below Sk, rounded up to
// 4 (per 4 keys 4 float4s of dS and 4 NC K float2s for 32 NC FFMAs); dQ (4
// x 2NC floats a thread) is written once.
//
// Copies: whole rows of 4D bytes by TMA bulk copies (cp.async.bulk), a row
// a thread, completing on the stage's mbarrier; lse, delta and the key mask
// by 4-byte cp.async. An operand whose base, strides or head_dim are not
// whole 16-byte chunks is read in place by 4-byte cp.async (columns
// D..round_up(D, 4) zero-filled). K rows past Sk are zeroed (they meet dS =
// 0 in dQ). Shared memory at head_dim 72: 108,048 bytes for the fused
// kernel, 98,832 for K8, 88,336 for K7, so two blocks share an SM; none
// spills at the head_dims checked (30, 48, 72, 96, 128). The q sweep of a
// dK/dV block is not split across blocks: the music trainer's
// cross-attention over 77 keys already has 1024 blocks (2 key blocks x 16
// heads x 32) for the card's 264 resident slots.

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_bwd_fp32_sm90.cuh"
#include "sm90_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kKeys = 64;       // keys per dK/dV block: 16 a warp
constexpr int kQT = 32;         // q rows per streamed tile of the dK/dV kernel
constexpr int kPdsPitch = 20;   // floats per q row of a dK/dV warp's P or dS buffer (16 keys + 4)
constexpr int kRowsQ = 64;      // q rows per dQ block: 16 a warp
constexpr int kSub = 32;        // keys per streamed sub-tile of the dQ kernel
constexpr int kDsPitch = 40;    // floats per q row of a dQ warp's dS buffer (32 keys + 8)
constexpr int kStages = 2;
constexpr int kMaxHeadDim = 128;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const int* mask;  // (B, Sk) int32 or null
  const float* dout;
  const float* lse;    // (B, Hq, Sq)
  const float* delta;  // (B, Hq, Sq)
  float* dq;           // K7's output, or the fused sweep's zeroed fp32 accumulator
  float* dk;
  float* dv;
  int B, Sq, Sk, Hq, Hkv, D;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  long long dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  long long m_sb;
  float scale;
  float scale2;  // scale * log2(e)
  int pitch;     // floats per row of Q, dO, K and V in shared memory
  int vec;       // bits 0-6: q, k, v, dout, dq, dk, dv in whole 16-byte chunks
};

constexpr int kVecQ = 1, kVecK = 2, kVecV = 4, kVecO = 8, kVecDq = 16, kVecDk = 32, kVecDv = 64;

// The dK/dV block's shared memory in floats: K and V (64 rows each), the
// ring's stages (Q and dO of 32 rows, lse and delta), each warp's P and dS
// buffers (32 q rows x 16 keys each), the fused sweep's 32 x D dQ staging
// tile (128-byte aligned, the bulk reduce's box) and each stage's mbarrier
// (8 bytes).
struct KvSmem {
  int k, v, stage, stage_floats, buf, dq, bar, total;
  static constexpr int kBufFloats = 2 * kQT * kPdsPitch;  // a warp's P, then dS
  __host__ __device__ KvSmem(int pitch, int D, bool fused) {
    k = 0;
    v = k + kKeys * pitch;
    stage = v + kKeys * pitch;
    stage_floats = 2 * kQT * pitch + 2 * kQT;
    buf = stage + kStages * stage_floats;
    dq = (buf + kWarps * kBufFloats + 31) & ~31;
    bar = (dq + (fused ? kQT * D : 0) + 1) & ~1;
    total = bar + 2 * kStages;
  }
  __host__ __device__ int bytes() const { return 4 * total; }
};

// The dQ block's shared memory in floats: Q and dO (64 rows each), the
// ring's stages (K and V of 32 keys, the key-valid flags), each warp's dS
// buffer (16 q rows x 32 keys) and each stage's mbarrier.
struct DqSmem {
  int q, o, stage, stage_floats, buf, bar, total;
  __host__ __device__ explicit DqSmem(int pitch) {
    q = 0;
    o = q + kRowsQ * pitch;
    stage = o + kRowsQ * pitch;
    stage_floats = 2 * kSub * pitch + kSub;
    buf = stage + kStages * stage_floats;
    bar = buf + kWarps * 16 * kDsPitch;
    total = bar + 2 * kStages;
  }
  __host__ __device__ int bytes() const { return 4 * total; }
};

// -- arithmetic ----------------------------------------------------------------------

// a . b + acc over the 4 lanes of two float4s, in order x, y, z, w
__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}
__device__ __forceinline__ float lane4(const float4& a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}

// -- loads ---------------------------------------------------------------------------
//
// Rows [0, n) of a tile whose row r is element row row0 + r of an (S, D)
// slice at `base` (row stride ss), into shared rows of `pitch` floats. In
// whole 16-byte chunks (`vec`), thread first + r bulk-copies row r; rows at
// or past S are not copied. Otherwise a warp a row by 4-byte cp.async,
// zero-filling rows past S and the columns D..round_up(D, 4), in the
// thread's current cp.async group.

// the bytes thread `threadIdx.x` bulk-copies for load_rows(..., first)
__device__ __forceinline__ uint32_t row_bytes(int first, int row0, int S, int n, int D, bool vec) {
  const int r = (int)threadIdx.x - first;
  return vec && r >= 0 && r < n && row0 + r < S ? 4u * D : 0u;
}

__device__ __forceinline__ void load_rows(float* dst, int pitch, const float* base, long long ss,
                                          int row0, int S, int n, int D, bool vec, uint32_t bar,
                                          int first) {
  if (vec) {
    const int r = (int)threadIdx.x - first;
    if (r >= 0 && r < n && row0 + r < S)
      bulk_copy(dst + r * pitch, base + (long long)(row0 + r) * ss, 4u * D, bar);
    return;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d4 = (D + 3) & ~3;
  for (int r = warp; r < n; r += kWarps) {
    const int s = row0 + r;
    const bool in = s < S;
    const float* src = base + (in ? (long long)s * ss : 0ll);
    for (int c = lane; c < d4; c += 32)
      cp4(dst + r * pitch + c, src + (c < D ? c : 0), in && c < D);
  }
}

// Rows [n, rows) of a tile loaded with vec bulk copies zeroed: K rows past
// Sk enter dQ = dS K (times dS = 0) and must not hold garbage. The cp.async
// path zero-fills them itself.
__device__ __forceinline__ void zero_rows(float* tile, int pitch, int n, int rows) {
  for (int i = threadIdx.x; i < (rows - n) * pitch; i += kThreads) tile[n * pitch + i] = 0.f;
}

// -- the dK/dV kernel ------------------------------------------------------------------

// q tile t of a dK/dV block: its q head and first row
struct QTile {
  int h, q0;
  __device__ QTile(const Params& p, int hk, int t) {
    const int nq = (p.Sq + kQT - 1) / kQT;
    h = hk * (p.Hq / p.Hkv) + t / nq;
    q0 = (t % nq) * kQT;
  }
};

// Q and dO rows (threads 0-31, 32-63) and lse and delta (threads 64-95,
// 96-127) of q tile t into ring slot `slot`; with `kv`, also the block's K
// and V rows (threads 0-63, 64-127). Every thread arrives on the slot's
// mbarrier once, with the bytes of its bulk copies.
__device__ __forceinline__ void load_q_tile(const Params& p, const KvSmem& L, float* smem,
                                            int hk, int b, int j0, int t, int slot, bool kv) {
  const QTile tile(p, hk, t);
  const bool vq = p.vec & kVecQ, vk = p.vec & kVecK, vv = p.vec & kVecV, vo = p.vec & kVecO;
  const int kn = min(kKeys, p.Sk - j0);
  float* st = smem + L.stage + slot * L.stage_floats;
  const uint32_t bar = smem_addr(smem + L.bar) + 8 * slot;
  uint32_t bytes = row_bytes(0, tile.q0, p.Sq, kQT, p.D, vq) +
                   row_bytes(kQT, tile.q0, p.Sq, kQT, p.D, vo);
  if (kv) bytes += row_bytes(0, 0, kn, kKeys, p.D, vk) + row_bytes(kKeys, 0, kn, kKeys, p.D, vv);
  mbar_expect_tx(bar, bytes);
  // the slot's last readers (generic proxy) are done: a block barrier came
  // between; order them before the bulk copies (async proxy)
  fence_async_smem();
  const float* qb = p.q + b * p.q_sb + tile.h * p.q_sh;
  const float* ob = p.dout + b * p.o_sb + tile.h * p.o_sh;
  load_rows(st, p.pitch, qb, p.q_ss, tile.q0, p.Sq, kQT, p.D, vq, bar, 0);
  load_rows(st + kQT * p.pitch, p.pitch, ob, p.o_ss, tile.q0, p.Sq, kQT, p.D, vo, bar, kQT);
  if (threadIdx.x >= 2 * kQT) {
    const int i = threadIdx.x & (kQT - 1), s = tile.q0 + i;
    const float* src = (threadIdx.x < 3 * kQT ? p.lse : p.delta) +
                       ((long long)b * p.Hq + tile.h) * p.Sq + min(s, p.Sq - 1);
    cp4(st + 2 * kQT * p.pitch + (threadIdx.x - 2 * kQT), src, s < p.Sq);
  }
  if (kv) {
    load_rows(smem + L.k, p.pitch, p.k + b * p.k_sb + hk * p.k_sh, p.k_ss, j0, p.Sk, kKeys, p.D,
              vk, bar, 0);
    load_rows(smem + L.v, p.pitch, p.v + b * p.v_sb + hk * p.v_sh, p.v_ss, j0, p.Sk, kKeys, p.D,
              vv, bar, kKeys);
    if (vk) zero_rows(smem + L.k, p.pitch, kn, kKeys);
  }
}

// One block per (64 keys, kv head, batch): sweeps the 32-row q tiles of
// every q head of the group, dK and dV in registers; with kFusedDq each
// tile's dQ over the block's keys is added into the fp32 buffer by one TMA
// bulk reduce-add through `tdq` (or atomics without kVecDq).
template <bool kFusedDq, int kNC>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_kv_kernel(const __grid_constant__ Params p, const __grid_constant__ CUtensorMap tdq) {
  extern __shared__ __align__(128) float smem[];
  const KvSmem L(p.pitch, p.D, kFusedDq);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // S^T: keys hi + 4i, q rows lo + 8m; dK/dV: keys 4 hi + i, columns 2 (lo + 8c)
  const int hi = lane >> 3, lo = lane & 7;
  const int pitch = p.pitch;
  const int j0 = blockIdx.x * kKeys, hk = blockIdx.y, b = blockIdx.z;
  const int tiles = (p.Hq / p.Hkv) * ((p.Sq + kQT - 1) / kQT);
  const uint32_t bars = smem_addr(smem + L.bar);

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(bars + 8 * i, kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  load_q_tile(p, L, smem, hk, b, j0, 0, 0, true);
  cp_commit();

  // the warp's keys 16w + hi + 4i of the scores: bit i when valid
  unsigned kok = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = j0 + 16 * warp + hi + 4 * i;
    if (j < p.Sk && (p.mask == nullptr || p.mask[b * p.m_sb + j] != 0)) kok |= 1u << i;
  }
  // dK and dV of keys 16w + 4hi + i, columns 2 (lo + 8c) + e
  float dk[4][2 * kNC], dv[4][2 * kNC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 2 * kNC; ++e) dk[i][e] = dv[i][e] = 0.f;
  const float* kt = smem + L.k + (16 * warp + hi) * pitch;  // key hi; hi + 4i at + 4i pitch
  const float* vt = smem + L.v + (16 * warp + hi) * pitch;
  float* pbuf = smem + L.buf + warp * KvSmem::kBufFloats;  // [q row][16 keys]
  float* dbuf = pbuf + kQT * kPdsPitch;
  const int nk = (p.D + 3) >> 2;

  for (int t = 0; t < tiles; ++t) {
    const int slot = t % kStages;
    if (t + 1 < tiles) {
      load_q_tile(p, L, smem, hk, b, j0, t + 1, (t + 1) % kStages, false);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    mbar_wait(bars + 8 * slot, (t / kStages) & 1);  // the stage's bulk copies
    __syncthreads();  // stage t landed for every thread's copies
    const QTile tile(p, hk, t);
    const int qn = min(kQT, p.Sq - tile.q0);
    const float* Qs = smem + L.stage + slot * L.stage_floats;
    const float* Os = Qs + kQT * pitch;
    const float* lse_s = Os + kQT * pitch;
    const float* delta_s = lse_s + kQT;

    // S^T = K Q^T and dP^T = V dO^T: 4 keys x 4 q rows a thread; a k-step
    // of 4 depth columns loads 16 float4s for 128 FFMAs
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int m = 0; m < 4; ++m) s[i][m] = dp[i][m] = 0.f;
    const float* qc = Qs + lo * pitch;
    const float* oc = Os + lo * pitch;
    // at head_dim above 96 dK and dV take 128 registers a thread: no
    // unrolling beyond the 128 FFMAs of a step, or ptxas spills
#pragma unroll(kNC > 6 ? 1 : 2)
    for (int kk = 0; kk < nk; ++kk) {
      float4 kf[4], vf[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kf[i] = *reinterpret_cast<const float4*>(kt + 4 * i * pitch + 4 * kk);
        vf[i] = *reinterpret_cast<const float4*>(vt + 4 * i * pitch + 4 * kk);
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float4 x = *reinterpret_cast<const float4*>(qc + 8 * m * pitch + 4 * kk);
        const float4 o = *reinterpret_cast<const float4*>(oc + 8 * m * pitch + 4 * kk);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][m] = dot4(kf[i], x, s[i][m]);
          dp[i][m] = dot4(vf[i], o, dp[i][m]);
        }
      }
    }

    // P and dS into the warp's buffers, [q row][key]
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int j = lo + 8 * m;
      const float lse = lse_s[j], dl = delta_s[j];
      const bool row_ok = j < qn && lse != -INFINITY;
      const float lse2 = lse * kLog2e;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool ok = row_ok && ((kok >> i) & 1u);
        const float pe = ok ? ex2(fminf(fmaf(s[i][m], p.scale2, -lse2), 0.f)) : 0.f;
        pbuf[j * kPdsPitch + hi + 4 * i] = pe;
        dbuf[j * kPdsPitch + hi + 4 * i] = ok ? pe * (dp[i][m] - dl) * p.scale : 0.f;
      }
    }
    __syncwarp();

    // dV += P^T dO, dK += dS^T Q over the tile's rows below Sq: per row one
    // float4 each of P and dS and NC float2s each of dO and Q for 16 NC FFMAs
    const float* pr = pbuf + 4 * hi;
    const float* dr = dbuf + 4 * hi;
    const float* oq = Os + 2 * lo;
    const float* qq = Qs + 2 * lo;
#pragma unroll(kNC > 6 ? 1 : 2)
    for (int j = 0; j < qn; ++j) {
      const float4 p4 = *reinterpret_cast<const float4*>(pr + j * kPdsPitch);
      const float4 d4 = *reinterpret_cast<const float4*>(dr + j * kPdsPitch);
#pragma unroll
      for (int c = 0; c < kNC; ++c) {
        const float2 o = *reinterpret_cast<const float2*>(oq + j * pitch + 16 * c);
        const float2 x = *reinterpret_cast<const float2*>(qq + j * pitch + 16 * c);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv[i][2 * c] = fmaf(lane4(p4, i), o.x, dv[i][2 * c]);
          dv[i][2 * c + 1] = fmaf(lane4(p4, i), o.y, dv[i][2 * c + 1]);
          dk[i][2 * c] = fmaf(lane4(d4, i), x.x, dk[i][2 * c]);
          dk[i][2 * c + 1] = fmaf(lane4(d4, i), x.y, dk[i][2 * c + 1]);
        }
      }
    }

    if constexpr (kFusedDq) {
      const bool vdq = p.vec & kVecDq;
      if (vdq && threadIdx.x == 0) bulk_wait_read<0>();  // the previous tile's reduce read it
      __syncthreads();  // every warp's dS is written; the staging tile is free
      // dQ rows lo + 8m of the tile, columns cq + 16c, over the block's 64
      // keys: per 4 keys 4 float4s of dS and 4 NC K floats for 16 NC FFMAs
      const int cq = threadIdx.x >> 3;
      float acc[4][kNC];
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int c = 0; c < kNC; ++c) acc[m][c] = 0.f;
      for (int kw = 0; kw < kWarps; ++kw) {
        const float* ds = smem + L.buf + kw * KvSmem::kBufFloats + kQT * kPdsPitch +
                          lo * kPdsPitch;
        const float* kc = smem + L.k + 16 * kw * pitch + cq;
#pragma unroll
        for (int u4 = 0; u4 < 4; ++u4) {
          float4 d[4];
#pragma unroll
          for (int m = 0; m < 4; ++m)
            d[m] = *reinterpret_cast<const float4*>(ds + 8 * m * kPdsPitch + 4 * u4);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
#pragma unroll
            for (int c = 0; c < kNC; ++c) {
              const float kv = kc[(4 * u4 + u) * pitch + 16 * c];
#pragma unroll
              for (int m = 0; m < 4; ++m) acc[m][c] = fmaf(lane4(d[m], u), kv, acc[m][c]);
            }
          }
        }
      }
      // the staging tile: 32 rows of D floats, the bulk reduce's box
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int c = 0; c < kNC; ++c)
          if (cq + 16 * c < p.D) smem[L.dq + (lo + 8 * m) * p.D + cq + 16 * c] = acc[m][c];
      fence_async_smem();
      __syncthreads();  // the staging tile is written; the stage and buffers are free
      if (vdq) {
        if (threadIdx.x == 0) {
          tma_reduce_add(&tdq, smem_addr(smem + L.dq), 0, tile.h, tile.q0, b);
          bulk_commit();
        }
      } else {
        float* dq = p.dq + b * p.dq_sb + tile.h * p.dq_sh;
        for (int i = threadIdx.x; i < qn * p.D; i += kThreads) {
          const int row = i / p.D;
          atomicAdd(dq + (long long)(tile.q0 + row) * p.dq_ss + (i - row * p.D), smem[L.dq + i]);
        }
      }
    } else {
      __syncthreads();  // the stage and the buffers are refilled next
    }
  }
  if (kFusedDq && (p.vec & kVecDq) && threadIdx.x == 0)
    bulk_wait_all();  // the last reduce has read the staging tile

  // dK and dV of the thread's keys below Sk
  const bool vdk = p.vec & kVecDk, vdv = p.vec & kVecDv;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = j0 + 16 * warp + 4 * hi + i;
    if (j >= p.Sk) continue;
    float* dkr = p.dk + b * p.dk_sb + (long long)j * p.dk_ss + hk * p.dk_sh;
    float* dvr = p.dv + b * p.dv_sb + (long long)j * p.dv_ss + hk * p.dv_sh;
#pragma unroll
    for (int c = 0; c < kNC; ++c) {
      const int col = 2 * (lo + 8 * c);
      if (col >= p.D) continue;
      if (vdk) {
        *reinterpret_cast<float2*>(dkr + col) = make_float2(dk[i][2 * c], dk[i][2 * c + 1]);
      } else {
        dkr[col] = dk[i][2 * c];
        if (col + 1 < p.D) dkr[col + 1] = dk[i][2 * c + 1];
      }
      if (vdv) {
        *reinterpret_cast<float2*>(dvr + col) = make_float2(dv[i][2 * c], dv[i][2 * c + 1]);
      } else {
        dvr[col] = dv[i][2 * c];
        if (col + 1 < p.D) dvr[col + 1] = dv[i][2 * c + 1];
      }
    }
  }
}

// -- the dQ kernel ---------------------------------------------------------------------

// K and V rows of sub-tile st (threads 0-31, 32-63) and its key-valid flags
// (threads 64-95) into ring slot `slot`; for st = 0 also the block's Q and
// dO rows (threads 0-63, 64-127). Every thread arrives on the slot's
// mbarrier once, with the bytes of its bulk copies.
__device__ __forceinline__ void load_kv_tile(const Params& p, const DqSmem& L, float* smem, int h,
                                             int hk, int b, int q0, int st, int slot) {
  const bool vq = p.vec & kVecQ, vk = p.vec & kVecK, vv = p.vec & kVecV, vo = p.vec & kVecO;
  const int t0 = st * kSub;
  float* kst = smem + L.stage + slot * L.stage_floats;
  float* vst = kst + kSub * p.pitch;
  int* valid = reinterpret_cast<int*>(vst + kSub * p.pitch);
  const uint32_t bar = smem_addr(smem + L.bar) + 8 * slot;
  uint32_t bytes = row_bytes(0, t0, p.Sk, kSub, p.D, vk) + row_bytes(kSub, t0, p.Sk, kSub, p.D, vv);
  if (st == 0)
    bytes += row_bytes(0, q0, p.Sq, kRowsQ, p.D, vq) + row_bytes(kRowsQ, q0, p.Sq, kRowsQ, p.D, vo);
  mbar_expect_tx(bar, bytes);
  fence_async_smem();  // as in load_q_tile
  if (st == 0) {
    load_rows(smem + L.q, p.pitch, p.q + b * p.q_sb + h * p.q_sh, p.q_ss, q0, p.Sq, kRowsQ, p.D,
              vq, bar, 0);
    load_rows(smem + L.o, p.pitch, p.dout + b * p.o_sb + h * p.o_sh, p.o_ss, q0, p.Sq, kRowsQ,
              p.D, vo, bar, kRowsQ);
  }
  load_rows(kst, p.pitch, p.k + b * p.k_sb + hk * p.k_sh, p.k_ss, t0, p.Sk, kSub, p.D, vk, bar, 0);
  load_rows(vst, p.pitch, p.v + b * p.v_sb + hk * p.v_sh, p.v_ss, t0, p.Sk, kSub, p.D, vv, bar,
            kSub);
  if (vk) zero_rows(kst, p.pitch, max(0, min(kSub, p.Sk - t0)), kSub);
  if (threadIdx.x >= 2 * kSub && threadIdx.x < 3 * kSub) {
    const int i = threadIdx.x - 2 * kSub, j = t0 + i;
    if (p.mask != nullptr)
      cp4(valid + i, p.mask + b * p.m_sb + min(j, p.Sk - 1), j < p.Sk);
    else
      valid[i] = j < p.Sk;
  }
}

// One block per (64 q rows, q head, batch): sweeps the 32-key sub-tiles,
// dQ in registers, written once (the dQ half of the two-kernel backward).
template <int kNC>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dq_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) float smem[];
  const DqSmem L(p.pitch);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hi = lane >> 3, lo = lane & 7;  // S: rows hi + 4i, keys lo + 8m
  const int rq = lane & 3, cg = lane >> 2;  // dQ: rows rq + 4m, columns 2 (cg + 8c) + e
  const int pitch = p.pitch;
  const int q0 = blockIdx.x * kRowsQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int n_stages = (p.Sk + kSub - 1) / kSub;
  const uint32_t bars = smem_addr(smem + L.bar);

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(bars + 8 * i, kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  load_kv_tile(p, L, smem, h, hk, b, q0, 0, 0);
  cp_commit();

  // the score rows q0 + 16w + hi + 4i: lse*log2(e), delta, whether they count
  float lse2[4], dl[4];
  unsigned row_ok = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 16 * warp + hi + 4 * i;
    const long long at = ((long long)b * p.Hq + h) * p.Sq + row;
    const float lse = row < p.Sq ? p.lse[at] : -INFINITY;
    if (lse != -INFINITY) row_ok |= 1u << i;
    lse2[i] = lse != -INFINITY ? lse * kLog2e : 0.f;
    dl[i] = row < p.Sq ? p.delta[at] : 0.f;
  }
  float acc[4][2 * kNC];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int e = 0; e < 2 * kNC; ++e) acc[m][e] = 0.f;
  const float* qr = smem + L.q + (16 * warp + hi) * pitch;  // row hi; hi + 4i at + 4i pitch
  const float* orw = smem + L.o + (16 * warp + hi) * pitch;
  float* buf = smem + L.buf + warp * 16 * kDsPitch;  // [warp's q row][32 keys]
  const int nk = (p.D + 3) >> 2;

  for (int st = 0; st < n_stages; ++st) {
    const int slot = st % kStages;
    if (st + 1 < n_stages) {
      load_kv_tile(p, L, smem, h, hk, b, q0, st + 1, (st + 1) % kStages);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    mbar_wait(bars + 8 * slot, (st / kStages) & 1);
    __syncthreads();  // sub-tile st (and Q, dO) landed for every thread's copies
    const float* kst = smem + L.stage + slot * L.stage_floats;
    const float* vst = kst + kSub * pitch;
    const int* valid = reinterpret_cast<const int*>(vst + kSub * pitch);
    const int jn = min(kSub, p.Sk - st * kSub);
    unsigned ok = 0;
#pragma unroll
    for (int m = 0; m < 4; ++m) ok |= (valid[lo + 8 * m] != 0 ? 1u : 0u) << m;

    // S = Q K^T and dP = dO V^T: 4 rows x 4 keys a thread
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int m = 0; m < 4; ++m) s[i][m] = dp[i][m] = 0.f;
    const float* kc = kst + lo * pitch;
    const float* vc = vst + lo * pitch;
#pragma unroll 2
    for (int kk = 0; kk < nk; ++kk) {
      float4 qf[4], of[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qf[i] = *reinterpret_cast<const float4*>(qr + 4 * i * pitch + 4 * kk);
        of[i] = *reinterpret_cast<const float4*>(orw + 4 * i * pitch + 4 * kk);
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float4 x = *reinterpret_cast<const float4*>(kc + 8 * m * pitch + 4 * kk);
        const float4 y = *reinterpret_cast<const float4*>(vc + 8 * m * pitch + 4 * kk);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][m] = dot4(qf[i], x, s[i][m]);
          dp[i][m] = dot4(of[i], y, dp[i][m]);
        }
      }
    }

    // dS into the warp's buffer, [q row][key]
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const bool keep = ((row_ok >> i) & (ok >> m) & 1u) != 0;
        const float pe = keep ? ex2(fminf(fmaf(s[i][m], p.scale2, -lse2[i]), 0.f)) : 0.f;
        buf[(hi + 4 * i) * kDsPitch + lo + 8 * m] = keep ? pe * (dp[i][m] - dl[i]) * p.scale : 0.f;
      }
    __syncwarp();

    // dQ += dS K over the sub-tile's keys below Sk (rounded up to 4; K rows
    // past Sk are zero): per 4 keys 4 float4s of dS and 4 NC K float2s for
    // 32 NC FFMAs
    const float* dr = buf + rq * kDsPitch;
    const float* kq = kst + 2 * cg;
    for (int u4 = 0; u4 < (jn + 3) >> 2; ++u4) {
      float4 d[4];
#pragma unroll
      for (int m = 0; m < 4; ++m)
        d[m] = *reinterpret_cast<const float4*>(dr + 4 * m * kDsPitch + 4 * u4);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int c = 0; c < kNC; ++c) {
          const float2 x = *reinterpret_cast<const float2*>(kq + (4 * u4 + u) * pitch + 16 * c);
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            acc[m][2 * c] = fmaf(lane4(d[m], u), x.x, acc[m][2 * c]);
            acc[m][2 * c + 1] = fmaf(lane4(d[m], u), x.y, acc[m][2 * c + 1]);
          }
        }
      }
    }
    __syncthreads();  // the slot and the buffers are refilled next
  }

  // dQ of the thread's rows below Sq
  const bool vdq = p.vec & kVecDq;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int row = q0 + 16 * warp + rq + 4 * m;
    if (row >= p.Sq) continue;
    float* out = p.dq + b * p.dq_sb + (long long)row * p.dq_ss + h * p.dq_sh;
#pragma unroll
    for (int c = 0; c < kNC; ++c) {
      const int col = 2 * (cg + 8 * c);
      if (col >= p.D) continue;
      if (vdq) {
        *reinterpret_cast<float2*>(out + col) = make_float2(acc[m][2 * c], acc[m][2 * c + 1]);
      } else {
        out[col] = acc[m][2 * c];
        if (col + 1 < p.D) out[col + 1] = acc[m][2 * c + 1];
      }
    }
  }
}

// -- host ------------------------------------------------------------------------------

int pitch_of(int D) { return ((D + 7) & ~7) + 4; }

// shared memory and grid of a kernel at these shapes
struct Plan {
  int bytes = 0, rows = 0, tile = 0;
  long long blocks = 0;
};

Plan make_plan(Which which, int B, int Sq, int Sk, int Hq, int Hkv, int D) {
  Plan plan;
  if (which == Which::kDq) {
    plan.bytes = DqSmem(pitch_of(D)).bytes();
    plan.rows = kRowsQ;
    plan.tile = kSub;
    plan.blocks = (long long)((Sq + kRowsQ - 1) / kRowsQ) * Hq * B;
  } else {
    plan.bytes = KvSmem(pitch_of(D), D, which == Which::kFused).bytes();
    plan.rows = kKeys;
    plan.tile = kQT;
    plan.blocks = (long long)((Sk + kKeys - 1) / kKeys) * Hkv * B;
  }
  return plan;
}

// the kernel of `which` at PV width kNC
template <int kNC>
const void* kernel_of(Which which) {
  if (which == Which::kFused) return reinterpret_cast<const void*>(flash_bwd_kv_kernel<true, kNC>);
  if (which == Which::kDkv) return reinterpret_cast<const void*>(flash_bwd_kv_kernel<false, kNC>);
  return reinterpret_cast<const void*>(flash_bwd_dq_kernel<kNC>);
}

template <int kNC>
cudaError_t set_smem_once(Which which) {
  // once per instantiation: the most any plan asks for
  static const cudaError_t errs[3] = {
      cudaFuncSetAttribute(kernel_of<kNC>(Which::kDkv),
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax),
      cudaFuncSetAttribute(kernel_of<kNC>(Which::kFused),
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax),
      cudaFuncSetAttribute(kernel_of<kNC>(Which::kDq),
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax)};
  return errs[static_cast<int>(which)];
}

// f(std::integral_constant<int, NC>{}) for the width of head_dim D:
// round_up(D, 16) columns, 16 NC, NC = 1..8
template <typename F>
int by_width(int D, F&& f) {
  switch ((D + 15) / 16) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    default: return f(std::integral_constant<int, 8>{});
  }
}

template <int kNC>
int launch_nc(Which which, const Params& p, const CUtensorMap& tdq, const Plan& plan,
              cudaStream_t stream) {
  const cudaError_t err = set_smem_once<kNC>(which);
  if (err != cudaSuccess) return (int)err;
  if (which == Which::kDq) {
    const dim3 grid((p.Sq + kRowsQ - 1) / kRowsQ, p.Hq, p.B);
    flash_bwd_dq_kernel<kNC><<<grid, kThreads, plan.bytes, stream>>>(p);
  } else {
    const dim3 grid((p.Sk + kKeys - 1) / kKeys, p.Hkv, p.B);
    if (which == Which::kFused)
      flash_bwd_kv_kernel<true, kNC><<<grid, kThreads, plan.bytes, stream>>>(p, tdq);
    else
      flash_bwd_kv_kernel<false, kNC><<<grid, kThreads, plan.bytes, stream>>>(p, tdq);
  }
  return (int)cudaGetLastError();
}

template <int kNC>
int attributes_nc(Which which, const Plan& plan, long long* out) {
  const void* kernel = kernel_of<kNC>(which);
  cudaError_t err = set_smem_once<kNC>(which);
  cudaFuncAttributes a;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, plan.bytes);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (long long)a.localSizeBytes;
  out[2] = (long long)a.sharedSizeBytes + plan.bytes;
  out[3] = blocks;
  out[4] = kThreads;
  out[5] = plan.rows;
  out[6] = plan.tile;
  out[7] = plan.blocks;
  return 0;
}

bool chunks16(const void* ptr, long long sb, long long ss, long long sh) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && sb % 4 == 0 && ss % 4 == 0 && sh % 4 == 0;
}

}  // namespace

int flash_bwd_fp32_sm90(Which which, const void* q, const void* k, const void* v, const int* mask,
                        const void* dout, const float* lse, const float* delta, void* dq,
                        void* dk, void* dv, const long long* meta, float scale, void* stream) {
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
  long long* strides[] = {&p.q_sb,  &p.q_ss,  &p.q_sh,  &p.k_sb,  &p.k_ss,  &p.k_sh,
                          &p.v_sb,  &p.v_ss,  &p.v_sh,  &p.o_sb,  &p.o_ss,  &p.o_sh,
                          &p.dq_sb, &p.dq_ss, &p.dq_sh, &p.dk_sb, &p.dk_ss, &p.dk_sh,
                          &p.dv_sb, &p.dv_ss, &p.dv_sh, &p.m_sb};
  for (int i = 0; i < 22; ++i) *strides[i] = meta[6 + i];
  p.scale = scale;
  p.scale2 = scale * kLog2e;  // the exp2 domain, folded here
  if (p.D <= 0 || p.D > kMaxHeadDim || p.Hkv <= 0 || p.Hq % p.Hkv != 0 || p.Sk <= 0)
    return (int)cudaErrorInvalidValue;
  if (p.Sq == 0 || p.B == 0) return 0;
  p.pitch = pitch_of(p.D);
  const bool d4 = p.D % 4 == 0;
  const bool with_dq = which != Which::kDkv, with_dkv = which != Which::kDq;
  p.vec = (d4 && chunks16(q, p.q_sb, p.q_ss, p.q_sh) ? kVecQ : 0) |
          (d4 && chunks16(k, p.k_sb, p.k_ss, p.k_sh) ? kVecK : 0) |
          (d4 && chunks16(v, p.v_sb, p.v_ss, p.v_sh) ? kVecV : 0) |
          (d4 && chunks16(dout, p.o_sb, p.o_ss, p.o_sh) ? kVecO : 0) |
          (with_dq && d4 && chunks16(dq, p.dq_sb, p.dq_ss, p.dq_sh) ? kVecDq : 0) |
          (with_dkv && d4 && chunks16(dk, p.dk_sb, p.dk_ss, p.dk_sh) ? kVecDk : 0) |
          (with_dkv && d4 && chunks16(dv, p.dv_sb, p.dv_ss, p.dv_sh) ? kVecDv : 0);
  // the fused sweep's dQ buffer as the (D, Hq, Sq, B) map of its bulk
  // reduce-adds, box D columns x 32 rows; atomics where it cannot be made
  CUtensorMap tdq = {};
  if (which == Which::kFused && (p.vec & kVecDq) &&
      !make_map_4d(&tdq, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, dq, p.B, p.Sq, p.Hq, p.D, p.dq_sb,
                   p.dq_ss, p.dq_sh, p.D, kQT, CU_TENSOR_MAP_SWIZZLE_NONE))
    p.vec &= ~kVecDq;
  const Plan plan = make_plan(which, p.B, p.Sq, p.Sk, p.Hq, p.Hkv, p.D);
  if (plan.bytes > (int)kSmemMax) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_width(p.D, [&](auto nc) {
    return launch_nc<decltype(nc)::value>(which, p, tdq, plan, s);
  });
}

// The plan and the compiled kernel's resources for `which` (0 dK/dV, 1
// fused, 2 dQ) at the shapes of meta (B, Sq, Sk, Hq, Hkv, D, as the entry
// points take it; 8 values into out): registers per thread, local-memory
// (spill) bytes per thread, shared memory per block, resident blocks per
// SM, threads per block, rows per block (keys for dK/dV, q rows for dQ),
// rows per streamed tile (q rows, keys), blocks in the grid. Launches
// nothing.
extern "C" int lumina_flash_bwd_fp32_attributes(int which, const long long* meta, long long* out) {
  const int D = (int)meta[5];
  if (D <= 0 || D > kMaxHeadDim || which < 0 || which > 2) return (int)cudaErrorInvalidValue;
  const Which w = static_cast<Which>(which);
  const Plan plan = make_plan(w, (int)meta[0], (int)meta[1], (int)meta[2], (int)meta[3],
                              (int)meta[4], D);
  return by_width(D, [&](auto nc) { return attributes_nc<decltype(nc)::value>(w, plan, out); });
}

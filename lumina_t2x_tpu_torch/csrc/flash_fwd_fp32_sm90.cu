// fp32 attention forward for Hopper (sm_90a), hand-written CUDA C++:
// register-tiled FFMA products, exact to fp32 (no tensor-core TF32).
// Replaces, for fp32 inputs, the Pallas TPU kernels of
// lumina_t2x_tpu/ops/flash_attention.py
//   _flash_small_kv_kernel        :240  (lumina_flash_small_kv)
//   _flash_kernel_fused_sum       :228  (lumina_flash_online)
//   _flash_kernel_static_max      :66   (lumina_flash_static_max)
//   _flash_kernel_res             :430  (lumina_flash_online_lse)
//   _flash_kernel_res_static_max  :446  (lumina_flash_static_max_lse)
//   _flash_rope_kernel            :956  (lumina_flash_rope, q and k rotated by rope_rotate.cu)
//   _flash_rope_q_kernel          :963  (lumina_flash_rope_q, q rotated by rope_rotate.cu)
// The C entry points stay in flash_fwd.cu (launch counters "small_kv",
// "online", "static_max", "online_lse", "static_max_lse", "rope",
// "rope_q"); each calls flash_fwd_fp32_sm90() for fp32 inputs. The audio
// app's FlagDiT-1D runs in fp32: every self- and cross-attention of a served
// request is K1 on this kernel.
//
// What it computes, per (batch, q head h, query row), with s = q . k over the
// valid keys of kv head h / (Hq / Hkv) (kv_mask != 0, j < Sk), in the exp2
// domain (the host folds scale*log2(e), bound*log2(e) and 55*log2(e)):
//   online      x = s*scale2, p = exp2(x - m), m the running row max, with rescale
//   static max  p = exp2(min(s*scale2 - bound2, clamp2))
//   out = sum_j p v_j / sum_j p, 0 for a row without a valid key; with an
//   lse pointer also lse = ln2 * (m + log2 l) (online) or ln2 * (bound2 +
//   log2 l) (static max), -inf where l = 0. Products and sums are fp32 FFMA.
//
// What bounds it. At FlagDiT-1D's served shape (B=2, Sq=Sk=128, H=16, D=72)
// the two products are 4*B*H*Sq*Sk*D = 151 MFLOP, 2.3 us at the 67 TFLOP/s
// fp32 rate outside the tensor cores, and q, k, v, out are 4.7 MB, 1.4 us at
// 3.35 TB/s: the card is not filled by the work, so the time is fixed cost
// -- the launch, the latency of the first loads, one block's serial chain
// (QK^T, the softmax, PV, the merge) -- with the wrapper's host time beside
// it. At the 2B's (2, 4096, 32, 72) the products are 309 GFLOP, 4.61 ms at
// 67 TFLOP/s: FFMA issue bounds it, and the shared-memory loads that feed
// the FFMAs are the first thing to run out.
//
// Design. A block is 4 warps; warp w takes 32 query rows (row group wr =
// w % WR) and one key sub-tile of 32 keys in every WK (wk = w / WR), with
// WR * WK = 4. The host picks (WR, WK) per call: (4, 1) -- 128 rows a block,
// every warp on every key -- while that grid fills the 132 SMs, else (2, 2)
// or (1, 4), so the audio shape runs 128 blocks of 32 rows (the template ran
// 64 blocks of 64). Key-split warps keep their own running max, sum and O
// and are merged once at the end through shared memory.
// Register tiling: lane = 4 * rg + cg; a thread owns rows rg + 8i (i < 4)
// of its warp's 32 and, of a sub-tile, keys cg + 4c (c < 8): S is 4 x 8 in
// registers, and each k-step of 4 depth columns loads 4 Q and 8 K float4s
// from shared memory for 128 FFMAs. For PV it owns columns 4 (cg + 4c) ..+3
// (c < NC = round_up(D, 16) / 16) of the same rows: O is 4 x 4NC in
// registers; each key loads one float4 of P^T (the 4 rows) and NC of V for
// 16 NC FFMAs. Rows are padded to a pitch of round_up(D, 8) + 4 floats (a
// multiple of 4 and an odd number of 16-byte chunks), so the 8 rows (Q) or 4
// keys (K) a warp reads at once fall in distinct banks, the other lanes
// reading the same addresses (broadcast). The row softmax runs in registers:
// the max over a row's 4 lanes by __shfl_xor_sync, one ex2.approx per
// logit; the row sums stay per lane until the epilogue. P is written once,
// transposed, to the warp's own 32 x 36 buffer for PV (__syncwarp only).
// K/V sub-tiles stream through a ring of 2 stages of 32 * WK keys, the next
// stage's copy in flight during the current one's products; Q is copied
// once with the first stage. At Sk <= 128 with (1, 4) all keys fit one stage
// (73.7 KB at D=72). Copies are TMA bulk copies (cp.async.bulk), a row of 4D
// bytes each, a row a thread, completing on the stage's mbarrier: 16-byte
// cp.async from 128 threads kept too few bytes in flight to fill an SM's
// 73.7 KB of K/V quickly; the TMA unit keeps many more. An operand whose
// base, strides or head_dim are not whole 16-byte chunks is read in place by
// 4-byte cp.async.ca (columns D..round_up(D, 4) zero-filled), in the same kernel:
// nothing is copied on the host. Keys past Sk are masked (and past PV's last
// key), q rows past Sq are not stored. The epilogue multiplies O by 1/l and
// stores float4s (scalars for an output not in whole chunks), and writes the
// LSE for K4/K5. cudaFuncSetAttribute runs once per instantiation.

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_fwd_fp32_sm90.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 32;            // query rows per warp: 8 row groups x 4 rows
constexpr int kSub = 32;             // keys per sub-tile: 4 lanes x 8 keys
constexpr int kPPitch = kSub + 4;    // floats per key of a warp's P^T buffer
constexpr int kStages = 2;           // K/V ring
constexpr int kMaxHeadDim = 128;
constexpr int kSmemMax = 232448;     // shared memory a block can use
constexpr float kClamp = 55.f;       // exponent clamp of the static max (nats)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const int* mask;  // (B, Sk) int32 or null
  float* out;
  float* lse;       // (B, Hq, Sq) fp32 contiguous, or null
  int B, Sq, Sk, Hq, Hkv, D;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  long long m_sb;
  float scale2;  // scale * log2(e)
  float bound2;  // bound * log2(e)
  float clamp2;  // 55 * log2(e)
  int wr, wk;    // warps along query rows and along keys, wr * wk = 4
  int pitch;     // floats per row of Q, K and V in shared memory
  int vec;       // bits 0-3: q, k, v, out in whole 16-byte chunks
};

// The block's shared memory in floats: Q (32 wr rows), the K and V rings
// (kStages x 32 wk keys each), each warp's P^T (32 keys x kPPitch), the
// key-valid flags of each stage and each stage's mbarrier (8 bytes). After
// the key loop the K ring holds the key-split warps' partial results for the
// merge.
struct Smem {
  int q, k, v, pt, valid, bar, total;
  __host__ __device__ Smem(int wr, int wk, int pitch) {
    q = 0;
    k = q + kRows * wr * pitch;
    v = k + kStages * kSub * wk * pitch;
    pt = v + kStages * kSub * wk * pitch;
    valid = pt + kWarps * kSub * kPPitch;
    bar = valid + kStages * kSub * wk;  // even: 8-byte aligned
    total = bar + 2 * kStages;
  }
  __host__ __device__ int bytes() const { return 4 * total; }
};

// -- PTX -----------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 4 bytes, or 4 zero bytes when !full (src is not read)
__device__ __forceinline__ void cp4(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(full ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// `bytes` (a multiple of 16, both addresses 16-byte aligned) by the TMA
// unit, counted on the mbarrier `bar` as they land
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// this thread's arrival, announcing the bytes its bulk copies will bring
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}
// 2^x in one MUFU.EX2 (results below 2^-126 flush to 0; ex2(-inf) = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// -- loads ---------------------------------------------------------------------------
//
// An operand in whole 16-byte chunks (`vec`) comes in by bulk copies, one
// row of 4D bytes each, a row a thread; rows at or past S are not copied
// (their shared rows keep whatever they held: a q row past Sq is not
// stored, a key past Sk is masked and past PV's last key). Otherwise a lane
// copies 4 bytes per element with cp.async, a warp a row, zero-filling rows
// past S and the columns D..round_up(D, 4), which enter QK^T.

// the bytes this thread's bulk copies of rows [0, n) bring
__device__ __forceinline__ uint32_t bulk_bytes(int row0, int S, int n, int D) {
  const int rows = max(0, min(n, S - row0) - (int)threadIdx.x);
  return (uint32_t)((rows + kThreads - 1) / kThreads) * 4u * D;
}

// Rows [0, n) of a tile whose row r is element row0 + r of a (S, D) slice at
// `base` (row stride ss), into shared rows of `pitch` floats.
__device__ __forceinline__ void load_rows(float* dst, int pitch, const float* base, long long ss,
                                          int row0, int S, int n, int D, bool vec, uint32_t bar) {
  if (vec) {
    for (int r = threadIdx.x; r < min(n, S - row0); r += kThreads)
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

// The K and V rows and key-valid flags of stage `st` into ring slot `slot`
// (with the block's Q rows for stage 0): only the sub-tiles that hold a key
// below Sk (the others are never read). Every thread arrives on the slot's
// mbarrier once, with the bytes of its own bulk copies; the cp.async copies
// go in the thread's current group.
__device__ __forceinline__ void load_stage(const Params& p, const Smem& L, float* smem, int st,
                                           int slot, const float* qb, int q0, const float* kb,
                                           const float* vb, int b) {
  const int keys = kSub * p.wk;
  const int j0 = st * keys;
  const int n = min(keys, (p.Sk - j0 + kSub - 1) / kSub * kSub);
  const int q_rows = st == 0 ? kRows * p.wr : 0;
  const uint32_t bar = smem_addr(smem + L.bar) + 8 * slot;
  const bool vq = p.vec & 1, vk = p.vec & 2, vv = p.vec & 4;
  mbar_arrive_tx(bar, (vq ? bulk_bytes(q0, p.Sq, q_rows, p.D) : 0u) +
                          (vk ? bulk_bytes(j0, p.Sk, n, p.D) : 0u) +
                          (vv ? bulk_bytes(j0, p.Sk, n, p.D) : 0u));
  // the slot's last readers (generic proxy) are done: a block barrier came
  // between; order them before the bulk copies (async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (q_rows) load_rows(smem + L.q, p.pitch, qb, p.q_ss, q0, p.Sq, q_rows, p.D, vq, bar);
  load_rows(smem + L.k + slot * keys * p.pitch, p.pitch, kb, p.k_ss, j0, p.Sk, n, p.D, vk, bar);
  load_rows(smem + L.v + slot * keys * p.pitch, p.pitch, vb, p.v_ss, j0, p.Sk, n, p.D, vv, bar);
  int* valid = reinterpret_cast<int*>(smem + L.valid) + slot * keys;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int j = j0 + i;
    if (p.mask != nullptr)
      cp4(valid + i, p.mask + b * p.m_sb + min(j, p.Sk - 1), j < p.Sk);
    else
      valid[i] = j < p.Sk;
  }
}

// -- one warp's sub-tile -------------------------------------------------------------

// S = Q K^T for the thread's 4 rows x 8 keys, the softmax update, P^T to the
// warp's buffer, O += P V. q: the thread's first row (rows + 8i * pitch);
// kt, vt: the sub-tile's first key; ok: bit c set when key cg + 4c is valid;
// jn: keys of the sub-tile below Sk.
template <bool kStaticMax, int kNC>
__device__ __forceinline__ void sub_tile(const Params& p, const float* q, const float* kt,
                                         const float* vt, float* pt, unsigned ok, int jn,
                                         float (&o)[4][4 * kNC], float (&m)[4], float (&l)[4]) {
  const int lane = threadIdx.x & 31;
  const int rg = lane >> 2, cg = lane & 3;
  const int pitch = p.pitch;
  float s[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) s[i][c] = 0.f;
  const float* kc = kt + cg * pitch;
  const int nk = (p.D + 3) >> 2;
  // at head_dim above 96 O takes 112-128 registers a thread: no unrolling
  // beyond the 128 FFMAs of a step, or ptxas spills
#pragma unroll(kNC > 6 ? 1 : 2)
  for (int kk = 0; kk < nk; ++kk) {
    float4 qv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      qv[i] = *reinterpret_cast<const float4*>(q + 8 * i * pitch + 4 * kk);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float4 kv = *reinterpret_cast<const float4*>(kc + 4 * c * pitch + 4 * kk);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i][c] = fmaf(qv[i].x, kv.x, s[i][c]);
        s[i][c] = fmaf(qv[i].y, kv.y, s[i][c]);
        s[i][c] = fmaf(qv[i].z, kv.z, s[i][c]);
        s[i][c] = fmaf(qv[i].w, kv.w, s[i][c]);
      }
    }
  }

  if constexpr (kStaticMax) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        s[i][c] = (ok >> c) & 1u ? ex2(fminf(fmaf(s[i][c], p.scale2, -p.bound2), p.clamp2)) : 0.f;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        s[i][c] = (ok >> c) & 1u ? s[i][c] * p.scale2 : -INFINITY;
        mx = fmaxf(mx, s[i][c]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      // a row with no valid key so far keeps m = -inf and o = l = 0
      const float alpha = m_new == -INFINITY ? 1.f : ex2(m[i] - m_new);
      const float shift = m_new == -INFINITY ? 0.f : m_new;
      m[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int e = 0; e < 4 * kNC; ++e) o[i][e] *= alpha;
#pragma unroll
      for (int c = 0; c < 8; ++c) s[i][c] = ex2(s[i][c] - shift);  // masked: 0
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) l[i] += s[i][c];

  // P^T: key cg + 4c, the thread's 4 rows side by side at column 4 rg
#pragma unroll
  for (int c = 0; c < 8; ++c)
    *reinterpret_cast<float4*>(pt + (cg + 4 * c) * kPPitch + 4 * rg) =
        make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
  __syncwarp();

  // O += P V over the sub-tile's keys below Sk (V is zero past them). The
  // columns past D hold whatever the pad or the next row holds: they never
  // meet the others and are not stored.
  const float* vc = vt + 4 * cg;
  const float* pr = pt + 4 * rg;
#pragma unroll(kNC > 6 ? 1 : 4)
  for (int j = 0; j < jn; ++j) {
    const float4 pv = *reinterpret_cast<const float4*>(pr + j * kPPitch);
#pragma unroll
    for (int c = 0; c < kNC; ++c) {
      const float4 vv = *reinterpret_cast<const float4*>(vc + j * pitch + 16 * c);
      const float pj[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        o[i][4 * c] = fmaf(pj[i], vv.x, o[i][4 * c]);
        o[i][4 * c + 1] = fmaf(pj[i], vv.y, o[i][4 * c + 1]);
        o[i][4 * c + 2] = fmaf(pj[i], vv.z, o[i][4 * c + 2]);
        o[i][4 * c + 3] = fmaf(pj[i], vv.w, o[i][4 * c + 3]);
      }
    }
  }
  __syncwarp();  // the buffer is rewritten by the next sub-tile
}

// -- the kernel ----------------------------------------------------------------------

template <bool kStaticMax, int kNC>
__global__ void __launch_bounds__(kThreads) flash_fwd_fp32_sm90_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const Smem L(p.wr, p.wk, p.pitch);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = lane >> 2, cg = lane & 3;
  const int wr = warp % p.wr, wk = warp / p.wr;
  const int keys = kSub * p.wk;  // keys per stage
  const int q0 = blockIdx.x * kRows * p.wr;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const float* qb = p.q + b * p.q_sb + h * p.q_sh;
  const float* kb = p.k + b * p.k_sb + hk * p.k_sh;
  const float* vb = p.v + b * p.v_sb + hk * p.v_sh;
  const int n_stages = (p.Sk + keys - 1) / keys;
  const uint32_t bars = smem_addr(smem + L.bar);

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(bars + 8 * i, kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  load_stage(p, L, smem, 0, 0, qb, q0, kb, vb, b);
  cp_commit();

  float o[4][4 * kNC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 4 * kNC; ++e) o[i][e] = 0.f;
  }
  const float* q = smem + L.q + (wr * kRows + rg) * p.pitch;
  float* pt = smem + L.pt + warp * kSub * kPPitch;

  for (int st = 0; st < n_stages; ++st) {
    if (st + 1 < n_stages) {
      load_stage(p, L, smem, st + 1, (st + 1) % kStages, qb, q0, kb, vb, b);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    mbar_wait(bars + 8 * (st % kStages), (st / kStages) & 1);  // the stage's bulk copies
    __syncthreads();  // stage st (and Q) landed for every thread's copies
    const int t0 = st * keys + wk * kSub;  // the warp's sub-tile
    if (t0 < p.Sk) {
      const int slot = st % kStages;
      const int row = slot * keys + wk * kSub;
      const int* valid = reinterpret_cast<const int*>(smem + L.valid) + row;
      unsigned ok = 0;
#pragma unroll
      for (int c = 0; c < 8; ++c) ok |= (valid[cg + 4 * c] != 0 ? 1u : 0u) << c;
      sub_tile<kStaticMax, kNC>(p, q, smem + L.k + row * p.pitch, smem + L.v + row * p.pitch, pt,
                                ok, min(kSub, p.Sk - t0), o, m, l);
    }
    __syncthreads();  // slot st % kStages is refilled by the next iteration
  }

  // the row sums over the row's 4 lanes
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }

  // key-split warps: wk > 0 hand (m, l, O) to wk = 0 through the free K ring
  if (p.wk > 1) {
    constexpr int kCols = 16 * kNC;
    constexpr int kSlot = kRows * (kCols + 2);
    float* part = smem + L.k;
    if (wk > 0) {
      float* po = part + ((wk - 1) * p.wr + wr) * kSlot;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rg + 8 * i;
#pragma unroll
        for (int c = 0; c < kNC; ++c)
          *reinterpret_cast<float4*>(po + r * kCols + 4 * (cg + 4 * c)) =
              make_float4(o[i][4 * c], o[i][4 * c + 1], o[i][4 * c + 2], o[i][4 * c + 3]);
        if (cg == 0) {
          po[kRows * kCols + r] = m[i];
          po[kRows * kCols + kRows + r] = l[i];
        }
      }
    }
    __syncthreads();
    if (wk > 0) return;
    for (int w = 1; w < p.wk; ++w) {
      const float* po = part + ((w - 1) * p.wr + wr) * kSlot;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rg + 8 * i;
        const float mw = po[kRows * kCols + r], lw = po[kRows * kCols + kRows + r];
        float a = 1.f, aw = 1.f;
        if constexpr (!kStaticMax) {
          const float m_new = fmaxf(m[i], mw);
          a = m_new == -INFINITY ? 0.f : ex2(m[i] - m_new);
          aw = m_new == -INFINITY ? 0.f : ex2(mw - m_new);
          m[i] = m_new;
        }
        l[i] = l[i] * a + lw * aw;
#pragma unroll
        for (int c = 0; c < kNC; ++c) {
          const float4 ow = *reinterpret_cast<const float4*>(po + r * kCols + 4 * (cg + 4 * c));
          o[i][4 * c] = o[i][4 * c] * a + ow.x * aw;
          o[i][4 * c + 1] = o[i][4 * c + 1] * a + ow.y * aw;
          o[i][4 * c + 2] = o[i][4 * c + 2] * a + ow.z * aw;
          o[i][4 * c + 3] = o[i][4 * c + 3] * a + ow.w * aw;
        }
      }
    }
  }

  // epilogue: O / l, 0 for a row without a valid key; the LSE for K4/K5
  const bool vec_out = p.vec & 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + wr * kRows + rg + 8 * i;
    if (row >= p.Sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    float* out = p.out + b * p.o_sb + (long long)row * p.o_ss + h * p.o_sh;
#pragma unroll
    for (int c = 0; c < kNC; ++c) {
      const int col = 4 * (cg + 4 * c);
      if (col >= p.D) continue;
      const float r4[4] = {o[i][4 * c] * inv, o[i][4 * c + 1] * inv, o[i][4 * c + 2] * inv,
                           o[i][4 * c + 3] * inv};
      if (vec_out) {
        *reinterpret_cast<float4*>(out + col) = make_float4(r4[0], r4[1], r4[2], r4[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < p.D) out[col + e] = r4[e];
      }
    }
    if (p.lse != nullptr && cg == 0)
      p.lse[((long long)b * p.Hq + h) * p.Sq + row] =
          l[i] > 0.f ? kLn2 * ((kStaticMax ? p.bound2 : m[i]) + log2f(l[i])) : -INFINITY;
  }
}

// -- host ------------------------------------------------------------------------------

// The block's plan: (WR, WK) and its shared memory. (4, 1) while its grid
// fills the card's SMs, else (2, 2), else (1, 4) (the most blocks), each
// only if its shared memory fits a block.
struct Plan {
  int wr = 0, wk = 0, pitch = 0, bytes = 0;
  long long blocks = 0;
};

int sm_count() {
  static const int count = [] {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 132;
    return n;
  }();
  return count;
}

Plan make_plan(int B, int Sq, int Hq, int D) {
  Plan best;
  const int pitch = ((D + 7) & ~7) + 4;
  for (int wr = 4; wr >= 1; wr /= 2) {
    const int bytes = Smem(wr, kWarps / wr, pitch).bytes();
    if (bytes > kSmemMax) continue;
    best.wr = wr;
    best.wk = kWarps / wr;
    best.pitch = pitch;
    best.bytes = bytes;
    best.blocks = (long long)((Sq + kRows * wr - 1) / (kRows * wr)) * Hq * B;
    if (best.blocks >= sm_count()) break;
  }
  return best;
}

template <bool kStaticMax, int kNC>
cudaError_t set_smem_once() {
  // once per instantiation: the most any plan asks for
  static const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_fp32_sm90_kernel<kStaticMax, kNC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemMax);
  return err;
}

// f(std::integral_constant<int, NC>{}) for the PV width of head_dim D:
// round_up(D, 16) columns, NC = 1..8 float4s a lane
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

template <bool kStaticMax, int kNC>
int launch_nc(const Params& p, const Plan& plan, cudaStream_t stream) {
  const cudaError_t err = set_smem_once<kStaticMax, kNC>();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Sq + kRows * plan.wr - 1) / (kRows * plan.wr), p.Hq, p.B);
  flash_fwd_fp32_sm90_kernel<kStaticMax, kNC><<<grid, kThreads, plan.bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <bool kStaticMax>
int launch(const Params& p, const Plan& plan, cudaStream_t s) {
  return by_width(p.D, [&](auto nc) {
    return launch_nc<kStaticMax, decltype(nc)::value>(p, plan, s);
  });
}

template <bool kStaticMax, int kNC>
int attributes_nc(const Plan& plan, long long* out) {
  auto kernel = flash_fwd_fp32_sm90_kernel<kStaticMax, kNC>;
  cudaError_t err = set_smem_once<kStaticMax, kNC>();
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
  out[5] = kRows * plan.wr;
  out[6] = plan.wk;
  out[7] = plan.blocks;
  return 0;
}

template <bool kStaticMax>
int attributes(int D, const Plan& plan, long long* out) {
  return by_width(D, [&](auto nc) {
    return attributes_nc<kStaticMax, decltype(nc)::value>(plan, out);
  });
}

bool chunks16(const void* ptr, long long sb, long long ss, long long sh) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && sb % 4 == 0 && ss % 4 == 0 && sh % 4 == 0;
}

}  // namespace

int flash_fwd_fp32_sm90(bool static_max, const void* q, const void* k, const void* v,
                        const int* mask, void* out, float* lse, const long long* meta,
                        float scale, float bound, void* stream) {
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.mask = mask;
  p.out = static_cast<float*>(out);
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
  // the exp2 domain: every constant of the logit chain times log2(e), folded here
  p.scale2 = scale * kLog2e;
  p.bound2 = bound * kLog2e;
  p.clamp2 = kClamp * kLog2e;
  if (p.D <= 0 || p.D > kMaxHeadDim || p.Hkv <= 0 || p.Hq % p.Hkv != 0 || p.Sk <= 0)
    return (int)cudaErrorInvalidValue;
  if (p.Sq == 0 || p.B == 0) return 0;
  const bool d4 = p.D % 4 == 0;
  p.vec = (d4 && chunks16(q, p.q_sb, p.q_ss, p.q_sh) ? 1 : 0) |
          (d4 && chunks16(k, p.k_sb, p.k_ss, p.k_sh) ? 2 : 0) |
          (d4 && chunks16(v, p.v_sb, p.v_ss, p.v_sh) ? 4 : 0) |
          (d4 && chunks16(out, p.o_sb, p.o_ss, p.o_sh) ? 8 : 0);
  const Plan plan = make_plan(p.B, p.Sq, p.Hq, p.D);
  if (plan.wr == 0) return (int)cudaErrorInvalidValue;
  p.wr = plan.wr;
  p.wk = plan.wk;
  p.pitch = plan.pitch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_max ? launch<true>(p, plan, s) : launch<false>(p, plan, s);
}

// The plan and the compiled kernel's resources for the shapes of meta (B,
// Sq, Sk, Hq, Hkv, D, as the entry points take it; 8 values into out):
// registers per thread, local-memory (spill) bytes per thread, shared memory
// per block, resident blocks per SM, threads per block, query rows per
// block, key-split warps (WK), blocks in the grid. Launches nothing.
extern "C" int lumina_flash_fwd_fp32_attributes(int static_max, const long long* meta,
                                                long long* out) {
  const int D = (int)meta[5];
  if (D <= 0 || D > kMaxHeadDim) return (int)cudaErrorInvalidValue;
  const Plan plan = make_plan((int)meta[0], (int)meta[1], (int)meta[3], D);
  if (plan.wr == 0) return (int)cudaErrorInvalidValue;
  return static_max ? attributes<true>(D, plan, out) : attributes<false>(D, plan, out);
}

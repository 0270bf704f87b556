// bf16 flash-attention backward for Hopper (sm_90a), hand-written CUDA C++:
// wgmma warpgroups with the transposed scores, dK and dV in registers, fed
// by a producer warp through an asynchronous ring of Q/dO tiles; and a dQ
// kernel with the scores and dQ in registers, fed through a ring of K/V
// tiles.
// Replaces the Pallas TPU kernels of lumina_t2x_tpu/ops/flash_attention.py
//   fused (dK, dV and dQ) <- _bwd_fused_kernel (_flash_bwd_fused_impl)
//   dK and dV only        <- _bwd_dkv_kernel   (_flash_bwd_impl, second pallas_call)
//   dQ only               <- _bwd_dq_kernel    (_flash_bwd_impl, first pallas_call)
// for bf16 inputs; the C entry points lumina_flash_bwd_fused,
// lumina_flash_bwd_dkv and lumina_flash_bwd_dq stay in flash_bwd.cu (launch
// counters "bwd_fused", "bwd_dkv", "bwd_dq"), which calls flash_bwd_sm90()
// or flash_bwd_dq_sm90() for bf16 and keeps its own kernels for fp32. One
// kernel serves the first two: a template flag compiles the dQ step out for
// dK/dV only. The dQ kernel is described after them ("The dQ kernel").
//
// What it computes, from the forward's per-row log-sum-exp and
// delta = rowsum(dO * O), over the valid keys (kv_mask != 0, j < Sk):
//   s  = scale * q . k
//   p  = exp(min(s - lse, 0))
//   ds = p * (dO . v - delta) * scale
//   dV = sum_rows p^T dO,  dK = sum_rows ds^T q,  dQ = ds k
// A masked key gets dK = dV = 0 and adds nothing to dQ; a query row with
// lse = -inf (no valid key) or past Sq adds nothing and gets dQ = 0. GQA: a
// block owns a kv head and sweeps the q heads of its group, so dK and dV are
// summed over the group in fp32 registers and written once, per kv head.
// p runs in the exp2 domain: the host folds scale*log2(e), the producer
// stores lse*log2(e) per row, so a logit costs one FMA, a min and one
// MUFU.EX2. The producer stores +inf for a row with lse = -inf or past Sq:
// exp2(min(s*scale2 - inf, 0)) = 0, where lse = -inf itself would give
// exp2(min(+inf, 0)) = 1. What the Pallas kernels do for the TPU is not
// carried over: the per-KV-block dQ partials (no atomics there) and the
// lane-replicated LSE and delta.
//
// Design. One block of three warpgroups per (128-key tile, kv head, batch).
// Warpgroup 0 is the producer: one thread loads the block's K and V tiles
// once, then, for each (q head of the group, 64-row q tile), the Q and dO
// tiles with TMA (cp.async.bulk.tensor) into a ring of 2-4 stages; its warp
// writes the tile's lse*log2(e) and delta beside them and every lane
// arrives on the stage's "full" mbarrier. Warpgroups 1 and 2 are consumers
// of 64 keys each; setmaxnreg moves registers from the producer (24 a
// thread) to them (240). Per q tile a consumer
//   S^T  = K_c Q^T   wgmma.m64n64k16, A = K_c, B = Q from shared memory
//   dP^T = V_c dO^T  (K-major), depth 72 run as 80 (columns 72-79 zero)
// as two groups, turns S^T into P^T as soon as the first is done and dP^T
// into dS^T when the second is, then
//   dV_c += P^T dO   wgmma.m64n72k16, A = P^T from registers as the bf16
//   dK_c += dS^T Q   pair hi + lo, B = dO / Q MN-major (transposed)
// The rows of the transposed scores are keys, so a thread's key-valid bits
// are per row and its lse/delta per column. S^T, dP^T, P, dS and the dK/dV
// accumulators (36 + 36 fp32 a thread at head_dim 72) never leave registers;
// the accumulator layout of S^T is the A-fragment layout of the next
// products. The consumer then frees the ring stage.
// dQ (fused only). Each consumer stages its dS^T (hi, lo) in shared memory,
// key rows of 64 q columns in one 128-byte-swizzled atom, and computes its
// keys' share dQ_c = dS_c K_c (wgmma.m64n72k16, A = dS MN-major, B = K_c
// MN-major, both from shared memory). Consumer 1 writes its fp32 share into
// a staging tile, consumer 0 adds its own there, and one thread adds the
// tile into the fp32 dQ buffer with one TMA bulk reduce-add
// (cp.reduce.async.bulk.tensor ... add; rows past Sq are clipped): one
// 64 x D fp32 add per (q tile, 128 keys), coalesced in L2. Two staging tiles
// alternate, so a reduce still reading one does not hold the next tile.
//
// P and dS as bf16 pairs. dV, dK and dQ take P and dS as hi = bf16(x) and
// lo = bf16(x - hi): two wgmma over the same B per 16-row slice (~16
// mantissa bits; the Pallas kernels round them once), so the kernel computes
// the fp32-P backward of its plain version (flash_bwd_plain).
//
// What bounds it on the card: at B=2, S=4096, H=32, D=72 the five products
// are 10*B*H*S*S*D = 773 GFLOP (0.78 ms at 989 TFLOP/s); with depth 80 and
// the pairs the tensor cores do 1.64x that (1.29 ms), and the 1.07e9 exp
// take 0.275 ms on the special-function units. Q and dO are re-read by each
// of the 32 key tiles of a kv head (2.4 GB from L2), and the dQ reduce adds
// 2.4 GB of fp32 into L2. `exps/bwd_sm90_breakdown.py` times the parts.
//
// The dQ kernel (the split backward's first half: the route the JAX package
// takes when the fused sweep's fp32 dQ partials would pass 1 GiB). Per q
// row it computes, over the valid keys in 64-key tiles,
//   dQ = sum_j dS_j K_j,  dS_j = P_j (dO V_j^T - delta) scale,
//   P_j = exp2(min(Q K_j^T scale2 - lse2, 0))
// and writes dQ once, rounded to bf16: no fp32 buffer, no zeroing, no
// atomics and no reduce-add, so the result is deterministic. The layout is
// the forward kernel's (sm90_common.cuh: KvRing, produce_kv) with one
// product more. One block of three warpgroups per (128 q rows, q head,
// batch): the producer warp loads the block's Q and dO tiles once and rings
// the kv head's 64-key K/V tiles past them (at least 3 stages, 5 at head_dim
// 72), with the tiles' key-valid bits from its ballots; two consumer
// warpgroups of 64 q rows each read their rows' lse*log2(e) (+inf for lse =
// -inf or a row past Sq, so p = 0) and delta from device memory once.
// setmaxnreg gives 24 registers to the producer and 240 to the consumers:
// S and dP take 32 fp32 each, dQ 36 (64 x 72 / 128) and the dS pair's A
// fragments 32, more than the forward's 160. Per key tile j a consumer
// issues three wgmma groups,
//   S  = Q K^T    wgmma.m64n64k16, A = Q, B = K from shared memory (K-major),
//   dP = dO V^T   depth 72 run as 80 (the forward's qk product)
//   dQ += dS K    of tile j - 1, wgmma.m64n72k16, A = dS from registers as
//                 the bf16 pair hi + lo, B = K MN-major (the forward's PV)
// and runs tile j's chain (P, then dS) as soon as its two products are
// done, beside dQ's; it packs dS(j) once dQ's product is done with the dS
// registers and frees the stage of tile j - 1. The two consumers share the
// ring but not a schedule (no ping-pong): each warpgroup's chain overlaps
// its own dQ product and the other warpgroup's products.
// What bounds it: at B=2, S=4096, H=32, D=72 the three products are
// 6*B*H*S*S*D = 464 GFLOP (0.469 ms at 989 TFLOP/s); with depth 80 and the
// pair the tensor cores do 1.41x that (0.66 ms), the 1.07e9 exp take 0.275
// ms on the special-function units, and K and V are re-read by each of the
// 32 q tiles of a head (2.4 GB from L2).

#include <math.h>
#include <stdint.h>

#include "flash_bwd_sm90.cuh"
#include "sm90_common.cuh"

namespace {

constexpr int kBN = 128;                           // keys per block
constexpr int kKeys = 64;                          // keys per consumer warpgroup
constexpr int kConsumers = kBN / kKeys;            // consumer warpgroups
constexpr int kBM = 64;                            // q rows per tile
constexpr int kThreads = 128 * (1 + kConsumers);   // producer warpgroup + consumers
// setmaxnreg: 128 * kProducerRegs + 128 * kConsumers * kConsumerRegs <= 65536
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
// named barriers (0 is __syncthreads): a dQ staging tile is free / holds
// consumer 1's share (both consumers), consumer c's own (kBarOwn + c)
constexpr int kBarFree = 1, kBarStaged = 2, kBarOwn = 3;

struct Params {
  const int* mask;     // (B, Sk) int32 or null
  const float* lse;    // (B, Hq, Sq)
  const float* delta;  // (B, Hq, Sq)
  bf16* dk;            // the dK/dV kernel (dQ fused: through its tensor map)
  bf16* dv;
  bf16* dq;            // the dQ kernel
  int B, Sq, Sk, Hq, Hkv, D;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  long long dq_sb, dq_ss, dq_sh;
  long long m_sb;
  float scale;   // ds = p * (dp - delta) * scale
  float scale2;  // scale * log2(e)
};

// -- shared memory ------------------------------------------------------------------

template <int kDK, int kDN, bool kFusedDq>
struct Smem {
  // K, V (kBN rows) and Q, dO (kBM rows) in atoms of 64 columns x rows
  // (128-byte swizzled rows), one TMA box per atom; columns past D arrive
  // as zeros. kDN <= kDK, so kAtoms covers the products' width too.
  static constexpr int kAtoms = (kDK + kAtomCols - 1) / kAtomCols;
  static constexpr uint32_t kKAtom = kBN * kSwizzle, kQAtom = kBM * kSwizzle;
  static constexpr uint32_t kKV = 2 * kAtoms * kKAtom;          // K, then V
  static constexpr uint32_t kStageBytes = 2 * kAtoms * kQAtom;  // Q, then dO
  // per consumer: dS^T hi and lo, 64 key rows x 64 q columns (one atom each)
  static constexpr uint32_t kDSTile = kKeys * kSwizzle;
  static constexpr uint32_t kDSBytes = kFusedDq ? 2 * kConsumers * kDSTile : 0;
  // two fp32 dQ staging tiles, kBM rows of D <= kDN floats
  static constexpr uint32_t kStagingTile = kBM * kDN * 4;
  static constexpr uint32_t kStagingBytes = kFusedDq ? 2 * kStagingTile : 0;
  static constexpr uint32_t kStats = 2 * kBM * 4;  // lse*log2(e), delta per stage
  static constexpr uint32_t kAlign = 1024;         // the dynamic base is rounded up to this
  static constexpr uint32_t kFixed = kKV + kDSBytes + kStagingBytes + 8;
  // ring stages: as many as fit, at most 4
  static constexpr int kFit =
      (int)((kSmemMax - kAlign - kFixed) / (kStageBytes + kStats + 16));
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static_assert(kStages >= 2, "the ring needs at least 2 stages");
  static constexpr uint32_t kRing = kKV;
  static constexpr uint32_t kDS = kRing + kStages * kStageBytes;
  static constexpr uint32_t kStaging = kDS + kDSBytes;
  static constexpr uint32_t kStatsAt = kStaging + kStagingBytes;
  static constexpr uint32_t kBars = kStatsAt + kStages * kStats;  // kv_full, full[], empty[]
  static constexpr uint32_t kBytes = kAlign + kBars + 8 * (1 + 2 * kStages);
  static_assert(kBytes <= kSmemMax, "shared memory");
  __device__ static uint32_t k() { return 0; }
  __device__ static uint32_t v() { return kAtoms * kKAtom; }
  __device__ static uint32_t q(int st) { return kRing + st * kStageBytes; }
  __device__ static uint32_t dout(int st) { return kRing + st * kStageBytes + kAtoms * kQAtom; }
  __device__ static uint32_t ds(int c, int lo) { return kDS + (2 * c + lo) * kDSTile; }
  __device__ static uint32_t staging(int buf) { return kStaging + buf * kStagingTile; }
  __device__ static uint32_t stats(int st) { return kStatsAt + st * kStats; }
  __device__ static uint32_t kv_full() { return kBars; }
  __device__ static uint32_t full(int st) { return kBars + 8 * (1 + st); }
  __device__ static uint32_t empty(int st) { return kBars + 8 * (1 + kStages + st); }
};

// -- consumer -----------------------------------------------------------------------

// dS^T (hi or lo fragments) into its staging atom: key row r of 128 bytes,
// q column pair (8n + 2t, +1) in 16-byte chunk n ^ (r % 8) (the 128-byte
// swizzle), so that wgmma reads it back as an MN-major A operand
__device__ __forceinline__ void store_ds(uint32_t tile, const uint32_t (&x)[4][4], int row, int t) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = row + 8 * r;
      const uint32_t at = tile + key * kSwizzle + ((n ^ (key & 7)) << 4) + 4 * t;
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at), "r"(x[n / 2][2 * (n % 2) + r])
                   : "memory");
    }
}

// P^T in place of S^T: p = exp2(min(s * scale2 - lse2, 0)), 0 on a masked
// key; rows are keys (key_ok per row), columns q rows (lse2 per column)
__device__ __forceinline__ void probs(float (&s)[32], const float* lse2, const bool (&key_ok)[2],
                                      int t, float scale2) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float2 l2 = *reinterpret_cast<const float2*>(lse2 + 8 * n + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = ex2(fminf(fmaf(s[4 * n + e], scale2, -((e & 1) ? l2.y : l2.x)), 0.f));
      s[4 * n + e] = key_ok[e >> 1] ? x : 0.f;
    }
  }
}

// dS^T in place of dP^T: ds = p * (dp - delta) * scale
__device__ __forceinline__ void dscores(float (&dp)[32], const float (&p)[32], const float* delta,
                                        int t, float scale) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float2 d2 = *reinterpret_cast<const float2*>(delta + 8 * n + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dp[4 * n + e] = p[4 * n + e] * (dp[4 * n + e] - ((e & 1) ? d2.y : d2.x)) * scale;
  }
}

// The block's dQ tile of iteration `it` into device memory: consumer 1
// writes its share into staging tile it % 2 (q row r at r * D floats),
// consumer 0 adds its own there, and one thread adds the tile into the fp32
// dQ buffer with one bulk reduce-add. Staging tile it % 2 is free once the
// reduce of iteration it - 2 has read it (consumer 0 arrives on kBarFree
// after that, consumer 1 waits there).
template <int kDN>
__device__ __forceinline__ void add_dq(const float (&dq)[kDN / 2], float* stage,
                                       uint32_t stage_addr, const CUtensorMap* tdq, int c,
                                       int tid, int row0, int t, int D, bool last, int h, int q0,
                                       int b) {
  if (c == 1) {
    bar_sync(kBarFree);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int n = 0; n < kDN / 8; ++n) {
        const int col = 8 * n + 2 * t;
        if (col < D)
          *reinterpret_cast<float2*>(stage + (row0 + 8 * r) * D + col) =
              make_float2(dq[4 * n + 2 * r], dq[4 * n + 2 * r + 1]);
      }
    bar_arrive(kBarStaged);
  } else {
    bar_sync(kBarStaged);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int n = 0; n < kDN / 8; ++n) {
        const int col = 8 * n + 2 * t;
        if (col < D) {
          float2* at = reinterpret_cast<float2*>(stage + (row0 + 8 * r) * D + col);
          const float2 x = *at;
          *at = make_float2(x.x + dq[4 * n + 2 * r], x.y + dq[4 * n + 2 * r + 1]);
        }
      }
    fence_async_smem();
    bar_sync<128>(kBarOwn);
    if (tid == 0) {
      tma_reduce_add(tdq, stage_addr, 0, h, q0, b);
      bulk_commit();
      bulk_wait_read<1>();  // the other staging tile's reduce has read it
    }
    if (!last) bar_arrive(kBarFree);
  }
}

template <int kDK, int kDN, bool kFusedDq>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_sm90_kernel(const __grid_constant__ Params p, const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tdo,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdq) {
  using L = Smem<kDK, kDN, kFusedDq>;
  constexpr int kStages = L::kStages;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (smem_addr(smem) + L::kAlign - 1) & ~(L::kAlign - 1);
  unsigned char* gbase = smem + (base - smem_addr(smem));  // the same bytes, generic address
  const int j0 = blockIdx.x * kBN, hk = blockIdx.y, b = blockIdx.z;
  const int rep = p.Hq / p.Hkv;
  const int nq = (p.Sq + kBM - 1) / kBM;
  const int n_it = rep * nq;  // (q head of the group, q tile), q tiles innermost
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(base + L::kv_full(), 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(base + L::full(st), 32);                 // every producer lane
      mbar_init(base + L::empty(st), 128 * kConsumers);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one warp keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    // the maps are (D, H, S, B) with a box of 64 columns x rows: one box per
    // atom; columns past D and rows past S arrive as zeros
    if (lane == 0) {
      mbar_expect_tx(base + L::kv_full(), L::kKV);
      for (int a = 0; a < L::kAtoms; ++a) {
        tma_load(base + L::k() + a * L::kKAtom, &tk, base + L::kv_full(), a * kAtomCols, hk, j0, b);
        tma_load(base + L::v() + a * L::kKAtom, &tv, base + L::kv_full(), a * kAtomCols, hk, j0, b);
      }
    }
    for (int it = 0; it < n_it; ++it) {
      const int st = it % kStages, h = hk * rep + it / nq, q0 = (it % nq) * kBM;
      float lse2[2], delta[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = q0 + 32 * i + lane;
        const long long at = ((long long)b * p.Hq + h) * p.Sq + row;
        const float lse = row < p.Sq ? p.lse[at] : -INFINITY;
        // +inf: p = exp2(min(s*scale2 - inf, 0)) = 0 for a row past Sq or
        // without a valid key
        lse2[i] = lse == -INFINITY ? INFINITY : lse * kLog2e;
        delta[i] = row < p.Sq ? p.delta[at] : 0.f;
      }
      mbar_wait(base + L::empty(st), ((it / kStages) & 1) ^ 1);  // round 0 passes at once
      float* stats = reinterpret_cast<float*>(gbase + L::stats(st));
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        stats[32 * i + lane] = lse2[i];
        stats[kBM + 32 * i + lane] = delta[i];
      }
      if (lane == 0) {
        mbar_expect_tx(base + L::full(st), L::kStageBytes);
        for (int a = 0; a < L::kAtoms; ++a) {
          tma_load(base + L::q(st) + a * L::kQAtom, &tq, base + L::full(st), a * kAtomCols, h, q0,
                   b);
          tma_load(base + L::dout(st) + a * L::kQAtom, &tdo, base + L::full(st), a * kAtomCols, h,
                   q0, b);
        }
      } else {
        mbar_arrive(base + L::full(st));
      }
    }
  } else {
    // ---- consumers: 64 keys each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int c = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid / 32, g = tid % 32 / 4, t = tid % 4;
    const int row0 = 16 * warp + g;  // this thread's key rows: row0, row0 + 8
    const uint32_t k_addr = base + L::k() + c * kKeys * kSwizzle;
    const uint32_t v_addr = base + L::v() + c * kKeys * kSwizzle;
    bool key_ok[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = j0 + c * kKeys + row0 + 8 * r;
      key_ok[r] = key < p.Sk && (p.mask == nullptr || p.mask[b * p.m_sb + key] != 0);
    }

    float dk[kDN / 2], dv[kDN / 2];
#pragma unroll
    for (int i = 0; i < kDN / 2; ++i) dk[i] = dv[i] = 0.f;
    float s[32], dp[32];
    uint32_t phi[4][4], plo[4][4], dhi[4][4], dlo[4][4];

    if (kFusedDq && c == 0) bar_arrive(kBarFree);  // staging tile 0 is free
    mbar_wait(base + L::kv_full(), 0);
    for (int it = 0; it < n_it; ++it) {
      const int st = it % kStages;
      mbar_wait(base + L::full(st), (it / kStages) & 1);
      wgmma_fence();
      qk<kDK, L::kKAtom, L::kQAtom>(s, k_addr, base + L::q(st));
      wgmma_commit();
      qk<kDK, L::kKAtom, L::kQAtom>(dp, v_addr, base + L::dout(st));
      wgmma_commit();

      const float* stats = reinterpret_cast<const float*>(gbase + L::stats(st));
      wgmma_wait<1>();
      pin(s);
      probs(s, stats, key_ok, t, p.scale2);
      wgmma_wait<0>();
      pin(dp);
      dscores(dp, s, stats + kBM, t, p.scale);

      // dV += P^T dO, then dK += dS^T Q, packing dS beside the first
      pack_pair(s, phi, plo);
      pin(dv);
      pin(phi);
      pin(plo);
      wgmma_fence();
      mma_pair<kDN, L::kQAtom>(dv, phi, plo, base + L::dout(st));
      wgmma_commit();
      pack_pair(dp, dhi, dlo);
      pin(dk);
      pin(dhi);
      pin(dlo);
      wgmma_fence();
      mma_pair<kDN, L::kQAtom>(dk, dhi, dlo, base + L::q(st));
      wgmma_commit();
      if constexpr (kFusedDq) {
        store_ds(base + L::ds(c, 0), dhi, row0, t);
        store_ds(base + L::ds(c, 1), dlo, row0, t);
      }
      wgmma_wait<0>();
      pin(dv);
      pin(dk);
      mbar_arrive(base + L::empty(st));

      if constexpr (kFusedDq) {
        // dQ_c = dS_c K_c (64 q rows x kDN), this consumer's 64 keys
        fence_async_smem();
        bar_sync<128>(kBarOwn + c);
        float dq[kDN / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t kd = swz_desc(k_addr + kk * 16 * kSwizzle, L::kKAtom, 8 * kSwizzle);
#pragma unroll
          for (int lo = 0; lo < 2; ++lo)
            wgmma_ss_tt(dq, swz_desc(base + L::ds(c, lo) + kk * 16 * kSwizzle, L::kDSTile,
                                     8 * kSwizzle), kd, kk > 0 || lo > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        pin(dq);

        const int h = hk * rep + it / nq, q0 = (it % nq) * kBM;
        add_dq<kDN>(dq, reinterpret_cast<float*>(gbase + L::staging(it & 1)),
                    base + L::staging(it & 1), &tdq, c, tid, row0, t, p.D, it + 1 == n_it, h, q0,
                    b);
      }
    }
    if (kFusedDq && tid == 0 && c == 0) bulk_wait_all();

    // dK and dV of this consumer's keys, per kv head (0 for a masked key)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = j0 + c * kKeys + row0 + 8 * r;
      if (key >= p.Sk) continue;
      bf16* dk_row = p.dk + b * p.dk_sb + (long long)key * p.dk_ss + hk * p.dk_sh;
      bf16* dv_row = p.dv + b * p.dv_sb + (long long)key * p.dv_ss + hk * p.dv_sh;
#pragma unroll
      for (int n = 0; n < kDN / 8; ++n) {
        const int col = 8 * n + 2 * t;
        if (col >= p.D) break;
        *reinterpret_cast<__nv_bfloat162*>(dk_row + col) =
            __floats2bfloat162_rn(dk[4 * n + 2 * r], dk[4 * n + 2 * r + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv_row + col) =
            __floats2bfloat162_rn(dv[4 * n + 2 * r], dv[4 * n + 2 * r + 1]);
      }
    }
  }
}

template <int kDK, int kDN, bool kFusedDq>
int launch_dims(const Params& p, const void* const* ptrs, const long long* meta,
                cudaStream_t stream) {
  // ptrs: q, k, v, dout, dq; meta strides from index 6 (q, k, v, dout, dq)
  CUtensorMap tq, tdo, tk, tv, tdq = {};
  if (!make_map(&tq, ptrs[0], p.B, p.Sq, p.Hq, p.D, meta[6], meta[7], meta[8], kBM) ||
      !make_map(&tk, ptrs[1], p.B, p.Sk, p.Hkv, p.D, meta[9], meta[10], meta[11], kBN) ||
      !make_map(&tv, ptrs[2], p.B, p.Sk, p.Hkv, p.D, meta[12], meta[13], meta[14], kBN) ||
      !make_map(&tdo, ptrs[3], p.B, p.Sq, p.Hq, p.D, meta[15], meta[16], meta[17], kBM))
    return (int)cudaErrorInvalidValue;
  // dQ, fp32: box D columns x 64 rows, unswizzled (the staging tile's layout)
  if (kFusedDq && !make_map_4d(&tdq, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ptrs[4], p.B, p.Sq, p.Hq,
                               p.D, meta[18], meta[19], meta[20], p.D, kBM,
                               CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_bwd_sm90_kernel<kDK, kDN, kFusedDq>;
  const int bytes = (int)Smem<kDK, kDN, kFusedDq>::kBytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.Sk + kBN - 1) / kBN, p.Hkv, p.B);
  kernel<<<grid, kThreads, bytes, stream>>>(p, tq, tdo, tk, tv, tdq);
  return (int)cudaGetLastError();
}

// the products' depth and width by head_dim: 64/64, 80/72 (the 2B), 128/128
template <bool kFusedDq>
int launch(const Params& p, const void* const* ptrs, const long long* meta, cudaStream_t stream) {
  if (p.D <= 64) return launch_dims<64, 64, kFusedDq>(p, ptrs, meta, stream);
  if (p.D <= 72) return launch_dims<80, 72, kFusedDq>(p, ptrs, meta, stream);
  return launch_dims<128, 128, kFusedDq>(p, ptrs, meta, stream);
}

// -- the dQ kernel -------------------------------------------------------------------

// Q, dO, then the K/V ring of 64-key tiles (sm90_common.cuh, the forward's
// layout with a second q-side tile): 5 stages at head_dim 72 and 128, 8 at 64
constexpr int kDqRows = 64;                  // q rows per consumer warpgroup
constexpr int kDqBQ = kDqRows * kConsumers;  // q rows per block
template <int kDK, int kDN>
using DqSmem = KvRing<kDqBQ, 2, kDK, kDN>;

// P in place of S: p = exp2(min(s * scale2 - lse2, 0)), 0 on an invalid
// key; rows are q rows (lse2 per row: s[4n + e] at row g + 8 * (e >> 1)),
// columns keys (the tile's key-valid bits, bit j: key j). A tile whose keys
// are all valid skips the selects.
__device__ __forceinline__ void probs_rows(float (&s)[32], unsigned long long bits, int t,
                                           const float (&lse2)[2], float scale2) {
  const bool all_valid = bits == ~0ull;
  bits >>= 2 * t;
  if (all_valid) {
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = ex2(fminf(fmaf(s[i], scale2, -lse2[(i >> 1) & 1]), 0.f));
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float x = ex2(fminf(fmaf(s[i], scale2, -lse2[(i >> 1) & 1]), 0.f));
      s[i] = key_valid(bits, i) ? x : 0.f;
    }
  }
}

// dS in place of dP: ds = p * (dp - delta) * scale, rows are q rows
__device__ __forceinline__ void dscores_rows(float (&dp)[32], const float (&p)[32],
                                             const float (&delta)[2], float scale) {
#pragma unroll
  for (int i = 0; i < 32; ++i) dp[i] = p[i] * (dp[i] - delta[(i >> 1) & 1]) * scale;
}

template <int kDK, int kDN>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_sm90_dq_kernel(const __grid_constant__ Params p,
                             const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tdo,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv) {
  using L = DqSmem<kDK, kDN>;
  static_assert(L::kAtomsV == L::kAtomsK, "dP = dO V^T reads V as deep as S = Q K^T reads K");
  constexpr int kStages = L::kStages;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (smem_addr(smem) + L::kAlign - 1) & ~(L::kAlign - 1);
  unsigned long long* bits =
      reinterpret_cast<unsigned long long*>(smem + (base - smem_addr(smem)) + L::kBits);
  const int q0 = blockIdx.x * kDqBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int nk = (p.Sk + L::kBK - 1) / L::kBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(base + L::q_full(), 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(base + L::full(st), 1);                   // the producer's arrive + bytes
      mbar_init(base + L::empty(st), 128 * kConsumers);   // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- dQ producer: the Q and dO tiles once, then the K/V ring ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0) {
      mbar_expect_tx(base + L::q_full(), L::kQBytes);
      for (int a = 0; a < L::kAtomsK; ++a) {
        tma_load(base + L::q(0) + a * L::kQAtom, &tq, base + L::q_full(), a * kAtomCols, h, q0,
                 b);
        tma_load(base + L::q(1) + a * L::kQAtom, &tdo, base + L::q_full(), a * kAtomCols, h, q0,
                 b);
      }
    }
    produce_kv<L>(base, bits, &tk, &tv, p.mask ? p.mask + b * p.m_sb : nullptr, p.Sk, hk, b,
                  lane);
  } else {
    // ---- dQ consumers: 64 q rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int c = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid / 32, lane = tid % 32, t = lane % 4;
    const int row0 = q0 + c * kDqRows + 16 * warp + lane / 4;  // this thread's rows: +0, +8
    const uint32_t q_addr = base + L::q(0) + c * kDqRows * kSwizzle;
    const uint32_t do_addr = base + L::q(1) + c * kDqRows * kSwizzle;
    // +inf: p = exp2(min(s*scale2 - inf, 0)) = 0 for a row past Sq or
    // without a valid key (lse = -inf)
    float lse2[2], delta[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const long long at = ((long long)b * p.Hq + h) * p.Sq + row;
      const float lse = row < p.Sq ? p.lse[at] : -INFINITY;
      lse2[r] = lse == -INFINITY ? INFINITY : lse * kLog2e;
      delta[r] = row < p.Sq ? p.delta[at] : 0.f;
    }

    float dq[kDN / 2];
#pragma unroll
    for (int i = 0; i < kDN / 2; ++i) dq[i] = 0.f;
    float s[32], dp[32];
    uint32_t dhi[4][4], dlo[4][4];

    mbar_wait(base + L::q_full(), 0);
    mbar_wait(base + L::full(0), 0);
    wgmma_fence();
    qk<kDK, L::kQAtom, L::kAtom>(s, q_addr, base + L::k(0));
    wgmma_commit();
    qk<kDK, L::kQAtom, L::kAtom>(dp, do_addr, base + L::v(0));
    wgmma_commit();
    wgmma_wait<1>();
    pin(s);
    probs_rows(s, bits[0], t, lse2, p.scale2);
    wgmma_wait<0>();
    pin(dp);
    dscores_rows(dp, s, delta, p.scale);
    pack_pair(dp, dhi, dlo);

    // Per tile j: S(j) = Q K^T, dP(j) = dO V^T and dQ += dS(j-1) K(j-1) in
    // three wgmma groups; the chain of tile j runs as soon as its products
    // are done, beside dQ's, and packs dS(j) once dQ's is done with the dS
    // registers; the stage of tile j-1 is then free.
    for (int j = 1; j < nk; ++j) {
      const int st = j % kStages, prev = (j - 1) % kStages;
      mbar_wait(base + L::full(st), (j / kStages) & 1);
      pin(dq);
      pin(dhi);
      pin(dlo);
      wgmma_fence();
      qk<kDK, L::kQAtom, L::kAtom>(s, q_addr, base + L::k(st));
      wgmma_commit();
      qk<kDK, L::kQAtom, L::kAtom>(dp, do_addr, base + L::v(st));
      wgmma_commit();
      mma_pair<kDN, L::kAtom>(dq, dhi, dlo, base + L::k(prev));
      wgmma_commit();
      wgmma_wait<2>();
      pin(s);
      probs_rows(s, bits[st], t, lse2, p.scale2);
      wgmma_wait<1>();
      pin(dp);
      dscores_rows(dp, s, delta, p.scale);
      wgmma_wait<0>();
      pin(dq);
      mbar_arrive(base + L::empty(prev));
      pack_pair(dp, dhi, dlo);
    }
    pin(dq);
    pin(dhi);
    pin(dlo);
    wgmma_fence();
    mma_pair<kDN, L::kAtom>(dq, dhi, dlo, base + L::k((nk - 1) % kStages));
    wgmma_commit();
    wgmma_wait<0>();
    pin(dq);

    // dQ, rounded once to bf16, for rows < Sq
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= p.Sq) continue;
      bf16* out = p.dq + b * p.dq_sb + (long long)row * p.dq_ss + h * p.dq_sh;
#pragma unroll
      for (int n = 0; n < kDN / 8; ++n) {
        const int col = 8 * n + 2 * t;
        if (col >= p.D) break;
        *reinterpret_cast<__nv_bfloat162*>(out + col) =
            __floats2bfloat162_rn(dq[4 * n + 2 * r], dq[4 * n + 2 * r + 1]);
      }
    }
  }
}

template <int kDK, int kDN>
int launch_dq_dims(const Params& p, const void* const* ptrs, const long long* meta,
                   cudaStream_t stream) {
  // ptrs: q, k, v, dout; meta strides from index 6 (q, k, v, dout)
  CUtensorMap tq, tdo, tk, tv;
  if (!make_map(&tq, ptrs[0], p.B, p.Sq, p.Hq, p.D, meta[6], meta[7], meta[8], kDqBQ) ||
      !make_map(&tk, ptrs[1], p.B, p.Sk, p.Hkv, p.D, meta[9], meta[10], meta[11], 64) ||
      !make_map(&tv, ptrs[2], p.B, p.Sk, p.Hkv, p.D, meta[12], meta[13], meta[14], 64) ||
      !make_map(&tdo, ptrs[3], p.B, p.Sq, p.Hq, p.D, meta[15], meta[16], meta[17], kDqBQ))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_bwd_sm90_dq_kernel<kDK, kDN>;
  const int bytes = (int)DqSmem<kDK, kDN>::kBytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.Sq + kDqBQ - 1) / kDqBQ, p.Hq, p.B);
  kernel<<<grid, kThreads, bytes, stream>>>(p, tq, tdo, tk, tv);
  return (int)cudaGetLastError();
}

// -- entry helpers --------------------------------------------------------------------

// the compiled kernel's resources (see lumina_flash_bwd_sm90_attributes)
template <class Kernel>
int kernel_attributes(Kernel kernel, int bytes, long long* out) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  cudaFuncAttributes a;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, bytes);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = kProducerRegs;
  out[2] = kConsumerRegs;
  out[3] = (long long)a.localSizeBytes;
  out[4] = (long long)a.sharedSizeBytes + bytes;
  out[5] = blocks;
  out[6] = kThreads;
  return 0;
}

// 0: dK/dV only, 1: fused, 2: dQ
template <int kDK, int kDN>
int attributes_dims(int which, long long* out) {
  if (which == 2)
    return kernel_attributes(flash_bwd_sm90_dq_kernel<kDK, kDN>, (int)DqSmem<kDK, kDN>::kBytes,
                             out);
  if (which == 1)
    return kernel_attributes(flash_bwd_sm90_kernel<kDK, kDN, true>,
                             (int)Smem<kDK, kDN, true>::kBytes, out);
  return kernel_attributes(flash_bwd_sm90_kernel<kDK, kDN, false>,
                           (int)Smem<kDK, kDN, false>::kBytes, out);
}

// Params from the entry points' arguments (dk, dv and dq left unset), or
// false for what the kernels do not take: D not a multiple of 8 or above
// 128, q/k/v/dout strides or bases not in whole 16-byte chunks (TMA moves
// 16-byte chunks)
bool make_params(Params& p, const void* q, const void* k, const void* v, const int* mask,
                 const void* dout, const float* lse, const float* delta, const long long* meta,
                 float scale) {
  p.mask = mask;
  p.lse = lse;
  p.delta = delta;
  p.dk = p.dv = p.dq = nullptr;
  p.B = (int)meta[0];
  p.Sq = (int)meta[1];
  p.Sk = (int)meta[2];
  p.Hq = (int)meta[3];
  p.Hkv = (int)meta[4];
  p.D = (int)meta[5];
  p.dq_sb = meta[18];
  p.dq_ss = meta[19];
  p.dq_sh = meta[20];
  p.dk_sb = meta[21];
  p.dk_ss = meta[22];
  p.dk_sh = meta[23];
  p.dv_sb = meta[24];
  p.dv_ss = meta[25];
  p.dv_sh = meta[26];
  p.m_sb = meta[27];
  p.scale = scale;
  p.scale2 = scale * kLog2e;  // the exp2 domain, folded here
  for (int i = 6; i <= 17; ++i)
    if (meta[i] % 8 != 0) return false;
  return p.D > 0 && p.D <= 128 && p.D % 8 == 0 && p.Hkv > 0 && p.Hq % p.Hkv == 0 && p.Sk > 0 &&
         aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout);
}

}  // namespace

int flash_bwd_sm90(bool fused, const void* q, const void* k, const void* v, const int* mask,
                   const void* dout, const float* lse, const float* delta, void* dq, void* dk,
                   void* dv, const long long* meta, float scale, void* stream) {
  Params p;
  if (!make_params(p, q, k, v, mask, dout, lse, delta, meta, scale))
    return (int)cudaErrorInvalidValue;
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  // the fused dq (fp32) in whole 16-byte chunks; dk and dv take bf16 pairs
  for (int i = 18; i <= 20; ++i)
    if (fused && meta[i] % 4 != 0) return (int)cudaErrorInvalidValue;
  for (int i = 21; i <= 26; ++i)
    if (meta[i] % 2 != 0) return (int)cudaErrorInvalidValue;
  if ((fused && !aligned16(dq)) || reinterpret_cast<uintptr_t>(dk) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(dv) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (p.Sq == 0 || p.B == 0) return 0;
  const void* ptrs[5] = {q, k, v, dout, dq};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fused ? launch<true>(p, ptrs, meta, s) : launch<false>(p, ptrs, meta, s);
}

int flash_bwd_dq_sm90(const void* q, const void* k, const void* v, const int* mask,
                      const void* dout, const float* lse, const float* delta, void* dq,
                      const long long* meta, float scale, void* stream) {
  Params p;
  if (!make_params(p, q, k, v, mask, dout, lse, delta, meta, scale))
    return (int)cudaErrorInvalidValue;
  p.dq = static_cast<bf16*>(dq);
  // dq (bf16) takes bf16 pairs
  for (int i = 18; i <= 20; ++i)
    if (meta[i] % 2 != 0) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(dq) % 4 != 0) return (int)cudaErrorInvalidValue;
  if (p.Sq == 0 || p.B == 0) return 0;
  const void* ptrs[4] = {q, k, v, dout};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // QK^T depth and dQ width by head_dim: 64/64, 80/72 (the 2B), 128/128
  if (p.D <= 64) return launch_dq_dims<64, 64>(p, ptrs, meta, s);
  if (p.D <= 72) return launch_dq_dims<80, 72>(p, ptrs, meta, s);
  return launch_dq_dims<128, 128>(p, ptrs, meta, s);
}

// The compiled kernel's resources at a head_dim (7 values into out):
// registers per thread as compiled (the launch bound), the producer's and
// the consumers' registers after setmaxnreg, local-memory (spill) bytes per
// thread, shared memory per block, resident blocks per SM, threads per block.
// which: 0 the dK/dV kernel (K8), 1 the fused sweep (K6), 2 the dQ kernel (K7).
extern "C" int lumina_flash_bwd_sm90_attributes(int which, int head_dim, long long* out) {
  if (which < 0 || which > 2) return (int)cudaErrorInvalidValue;
  if (head_dim <= 64) return attributes_dims<64, 64>(which, out);
  if (head_dim <= 72) return attributes_dims<80, 72>(which, out);
  return attributes_dims<128, 128>(which, out);
}

// bf16 and fp16 flash-attention backward for Hopper (sm_90a), hand-written CUDA C++:
// wgmma warpgroups with the transposed scores, dK and dV in registers, fed
// by a producer warp through an asynchronous ring of Q/dO tiles; and a dQ
// kernel with the scores and dQ in registers, fed through a ring of K/V
// tiles.
// Replaces the Pallas TPU kernels of lumina_t2x_tpu/ops/flash_attention.py
//   fused (dK, dV and dQ) <- _bwd_fused_kernel (_flash_bwd_fused_impl)
//   dK and dV only        <- _bwd_dkv_kernel   (_flash_bwd_impl, second pallas_call)
//   dQ only               <- _bwd_dq_kernel    (_flash_bwd_impl, first pallas_call)
// for bf16 and fp16 inputs (the operand type T, one instantiation each); the
// C entry points lumina_flash_bwd_fused, lumina_flash_bwd_dkv and
// lumina_flash_bwd_dq stay in flash_bwd.cu (launch counters "bwd_fused",
// "bwd_dkv", "bwd_dq"), which calls flash_bwd_sm90() or flash_bwd_dq_sm90()
// for bf16 and fp16 (fp32 runs flash_bwd_fp32_sm90.cu). One
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
// Design. One block of three warpgroups per (128-key tile, kv head, batch)
// (two at head_dim <= 48: "Widths", below). Warpgroup 0 is the producer: one
// thread loads the block's K and V tiles once, then, for each (q head of the
// group, 64-row q tile), the Q and dO tiles with TMA (cp.async.bulk.tensor)
// into a ring of 2-4 stages; its warp writes the tile's lse*log2(e) and
// delta beside them and every lane arrives on the stage's "full" mbarrier.
// Warpgroups 1 and 2 are consumers of 64 keys each; setmaxnreg moves
// registers from the producer (24 a thread) to them (240). Per q tile a
// consumer
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
// MN-major, both from shared memory), writes it in fp32 into its own
// staging tile, and one of its threads adds the tile into the fp32 dQ
// buffer with one TMA bulk reduce-add (cp.reduce.async.bulk.tensor ... add;
// rows past Sq are clipped): one 64 x D fp32 add per (q tile, 64 keys),
// coalesced in L2. That thread waits for the reduce to have read the tile
// before the consumer's next dQ product. A staging row takes D floats
// rounded to 8 or 24 modulo 32 (`staged_cols`; the tensor map's box is as
// wide, its columns past D outside the tensor): a warp's float2 stores then
// cover the banks once a phase, where rows D = 96 floats apart put eight on
// one bank. On an H100 (`exps/bwd_sm90_breakdown.py` at the Flag-DiT 5B's
// (2, 4160, 32, 96)) the dQ step of the 96-wide sweep took 1.77 ms of 4.0
// with unpadded rows and consumer 1 handing its share to consumer 0, 1.10
// with padded rows, 0.99 with a tile and a reduce per consumer (twice the
// reduce-adds, which cost L2 little: 0.19 ms for all of them there); a
// 128-byte-swizzled tile of 32-column boxes, one reduce a box, slowed the
// 2B's sweep by a quarter instead.
//
// P and dS as pairs. dV, dK and dQ take P and dS as hi = T(x) and lo =
// T(x - hi): two wgmma over the same B per 16-row slice (~16 mantissa bits
// in bf16, ~22 in fp16; the Pallas kernels round them once), so the kernel
// computes the fp32-P backward of its plain version (flash_bwd_plain).
//
// fp16. The same kernels on wgmma's .f16 operands (m64nNk16.f32.f16.f16,
// the same shapes, swizzles and fp32 accumulators). p <= 1 packs as it is,
// but ds = p (dO . v - delta) scale carries dO's magnitude times p's
// (~1e-4 at 4096 keys): in an fp16 trainer dS falls under fp16's smallest
// normal, 2^-14, where the pair keeps a few bits or none (at dO ~ 2^-20
// every dS flushes to 0). Every output is linear in dO, so dS is packed at
// 2^-e, e = floor(log2 max|dO|), read on the card from `do_amax` (one
// reduction over dO in the wrapper, no host sync): the scale folds into the
// chain's `scale`, costs nothing per element, and dK and dQ are multiplied
// by 2^e in fp32 before they are stored (dQ before its staging), so the
// powers of two are exact. dV = P^T dO needs none. bf16 has fp32's exponent
// range and takes do_amax = null (scale 1).
//
// Widths. The products' depth (S^T, dP^T: head_dim rounded up to 16) and
// width (dV, dK, dQ: a multiple of 8) come from head_dim: 48/48 up to 48,
// 64/64, 80/72 (the 2B), 96/96 (the Flag-DiT 5B) and 128/128; K and Q stay
// in 64-column atoms (one at 48, two at 72 and 96), columns past D arriving
// as zeros. 96/96 (two consumers, 168 registers a thread at launch, 240 a
// consumer thread): dK and dV take 48 + 48 fp32 a thread, S^T and dP^T 32 +
// 32, the P and dS pairs 32 + 32 once S^T and dP^T are spent, so the pairs
// in flight beside the accumulators need ~160 of the 240, and ptxas
// serializes nothing, with 0 spill bytes. At 128/128 dK and dV take 128 fp32
// a thread and ptxas serializes the dK/dV kernel's wgmma in both types
// (C7512, insufficient registers; reusing P's registers for dS, issuing S
// and dP in turn, splitting the products into two n64 halves or unrolling
// the loop once did not lift it); no main path runs head_dim above 96.
// 48/48 (head_dim <= 48, the ImageNet 600M's and the Small's): a block sees
// few q tiles (4 at Sq = 256, 16 at 1024), so its fixed cost -- the K/V
// load, setmaxnreg, barrier set-up, the dK/dV store -- weighs more than its
// products. The block is then one consumer of 64 keys and the producer (256
// threads, Sweep<1>), two blocks an SM, so that one block's prologue and
// epilogue run beside the other's sweep: 128 registers a thread at launch,
// 24 to the producer and 232 to the consumer after setmaxnreg (dK, dV 24 +
// 24, S^T, dP^T 32 + 32), shared memory within half the SM's (K/V 16 KB, a
// 3-stage ring of 16.5 KB, dS 16 KB, a 14 KB dQ staging tile). The
// two-consumer block does not fit twice: at 104 registers a consumer thread
// (half the SM's 65536 over 384 threads, less the producer's) S^T, dP^T, dK
// and dV alone take 112.
//
// What bounds it on the card: at B=2, S=4096, H=32, D=72 the five products
// are 10*B*H*S*S*D = 773 GFLOP (0.78 ms at 989 TFLOP/s); with depth 80 and
// the pairs the tensor cores do 1.64x that (1.29 ms), and the 1.07e9 exp
// take 0.275 ms on the special-function units. Q and dO are re-read by each
// of the 32 key tiles of a kv head (2.4 GB from L2), and the dQ reduces add
// 4.8 GB of fp32 into L2 (a tile per 64 keys). `exps/bwd_sm90_breakdown.py`
// times the parts.
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

constexpr int kKeys = 64;                          // keys per consumer warpgroup
constexpr int kConsumers = 2;                      // consumer warpgroups (the dQ kernel's)
constexpr int kBM = 64;                            // q rows per tile
constexpr int kThreads = 128 * (1 + kConsumers);   // producer warpgroup + consumers
// setmaxnreg: 128 * kProducerRegs + 128 * kConsumers * kConsumerRegs <= 65536
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr uint32_t kSmemSm = 233472;  // shared memory of an SM (1024 of it reserved a block)

// The dK/dV sweep's block by its consumer warpgroups: two of 64 keys, one
// block an SM (the 64/64, 80/72, 96/96 and 128/128 instantiations), or one,
// two blocks an SM (48/48): the registers of one block (128 a thread at
// launch) go 24 to the producer and 232 to the consumer after setmaxnreg,
// and its shared memory stays within half the SM's.
template <int kCons>
struct Sweep {
  static constexpr int kBN = kKeys * kCons;            // keys per block
  static constexpr int kThreads = 128 * (1 + kCons);
  static constexpr int kMinBlocks = kCons == 1 ? 2 : 1;  // resident blocks an SM
  static constexpr int kConsumerRegs = kCons == 1 ? 232 : 240;
  static_assert(128 * kProducerRegs + 128 * kCons * kConsumerRegs <= 65536 / kMinBlocks,
                "setmaxnreg hands out more registers than the block has");
  // shared memory a block may take
  static constexpr uint32_t kSmem = kMinBlocks == 1 ? kSmemMax : kSmemSm / kMinBlocks - 1024;
};
// named barrier of consumer c's warpgroup: kBarOwn + c (0 is __syncthreads)
constexpr int kBarOwn = 1;

struct Params {
  const int* mask;     // (B, Sk) int32 or null
  const float* lse;    // (B, Hq, Sq)
  const float* delta;  // (B, Hq, Sq)
  const fp16* do_amax;  // fp16: max|dO| on the card (the dS scale), or null
  void* dk;            // T; the dK/dV kernel (dQ fused: through its tensor map)
  void* dv;
  void* dq;            // T; the dQ kernel
  int B, Sq, Sk, Hq, Hkv, D;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  long long dq_sb, dq_ss, dq_sh;
  long long m_sb;
  float scale;   // ds = p * (dp - delta) * scale
  float scale2;  // scale * log2(e)
};

// -- shared memory ------------------------------------------------------------------

// Floats a row of the fp32 dQ staging tile takes at head_dim D in the kDN
// instantiation: D rounded to 8 or 24 modulo 32, so that the eight rows of a
// warp's float2 stores fall on four bank offsets (rows D = 96 floats apart
// put all eight on one). The dQ tensor map's box is this wide; its columns
// past D lie outside the tensor and the reduce-add skips them. 128/128 keeps
// D (its shared memory has no room).
__host__ __device__ constexpr int staged_cols(int D, int kDN) {
  return (kDN > 96 || D % 16 == 8) ? D : D + 8;
}

template <int kDK, int kDN, bool kFusedDq, int kCons>
struct Smem {
  static constexpr int kBN = Sweep<kCons>::kBN;
  // K, V (kBN rows) and Q, dO (kBM rows) in atoms of 64 columns x rows
  // (128-byte swizzled rows), one TMA box per atom; columns past D arrive
  // as zeros. kDN <= kDK, so kAtoms covers the products' width too.
  static constexpr int kAtoms = (kDK + kAtomCols - 1) / kAtomCols;
  static constexpr uint32_t kKAtom = kBN * kSwizzle, kQAtom = kBM * kSwizzle;
  static constexpr uint32_t kKV = 2 * kAtoms * kKAtom;          // K, then V
  static constexpr uint32_t kStageBytes = 2 * kAtoms * kQAtom;  // Q, then dO
  // per consumer: dS^T hi and lo, 64 key rows x 64 q columns (one atom each)
  static constexpr uint32_t kDSTile = kKeys * kSwizzle;
  static constexpr uint32_t kDSBytes = kFusedDq ? 2 * kCons * kDSTile : 0;
  // an fp32 dQ staging tile per consumer, kBM rows of staged_cols(D) floats
  static constexpr uint32_t kStagingTile = kBM * (kDN > 96 ? kDN : kDN + 8) * 4;
  static constexpr uint32_t kStagingBytes = kFusedDq ? kCons * kStagingTile : 0;
  static constexpr uint32_t kStats = 2 * kBM * 4;  // lse*log2(e), delta per stage
  static constexpr uint32_t kAlign = 1024;         // the dynamic base is rounded up to this
  static constexpr uint32_t kFixed = kKV + kDSBytes + kStagingBytes + 8;
  // ring stages: as many as fit in the block's share, at most 4
  static constexpr int kFit =
      (int)((Sweep<kCons>::kSmem - kAlign - kFixed) / (kStageBytes + kStats + 16));
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static_assert(kStages >= 2, "the ring needs at least 2 stages");
  static constexpr uint32_t kRing = kKV;
  static constexpr uint32_t kDS = kRing + kStages * kStageBytes;
  static constexpr uint32_t kStaging = kDS + kDSBytes;
  static constexpr uint32_t kStatsAt = kStaging + kStagingBytes;
  static constexpr uint32_t kBars = kStatsAt + kStages * kStats;  // kv_full, full[], empty[]
  static constexpr uint32_t kBytes = kAlign + kBars + 8 * (1 + 2 * kStages);
  static_assert(kBytes <= Sweep<kCons>::kSmem, "shared memory");
  __device__ static uint32_t k() { return 0; }
  __device__ static uint32_t v() { return kAtoms * kKAtom; }
  __device__ static uint32_t q(int st) { return kRing + st * kStageBytes; }
  __device__ static uint32_t dout(int st) { return kRing + st * kStageBytes + kAtoms * kQAtom; }
  __device__ static uint32_t ds(int c, int lo) { return kDS + (2 * c + lo) * kDSTile; }
  __device__ static uint32_t staging(int c) { return kStaging + c * kStagingTile; }
  __device__ static uint32_t stats(int st) { return kStatsAt + st * kStats; }
  __device__ static uint32_t kv_full() { return kBars; }
  __device__ static uint32_t full(int st) { return kBars + 8 * (1 + st); }
  __device__ static uint32_t empty(int st) { return kBars + 8 * (1 + kStages + st); }
};

// -- consumer -----------------------------------------------------------------------

// The dS scale's pair (up, down) = (2^-e, 2^e), e = floor(log2 max|dO|), or
// (1, 1) without do_amax or for a max|dO| of 0 or not finite
__device__ __forceinline__ float2 ds_scales(const fp16* do_amax) {
  if (do_amax != nullptr) {
    const float a = __half2float(*do_amax);
    if (a > 0.f && a <= 3.4028235e38f) {
      const int e = min(max(ilog2(a), -100), 100);
      return make_float2(pow2(-e), pow2(e));
    }
  }
  return make_float2(1.f, 1.f);
}

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

// This consumer's dQ share of a tile into device memory: its threads write
// the share (times `down`, which unscales dS's scale) into the consumer's
// staging tile (q row r at r * staged_cols(D) floats), and one thread adds
// the tile into the fp32 dQ buffer with one bulk reduce-add. The tile is
// written again a q tile later, after the consumer's barrier ahead of its
// next dQ product, before which that thread waits for the reduce to have
// read it (the loop in the kernel). Each consumer adds its own share: the
// reduce-adds are cheap in L2, and the consumers never wait on each other.
template <int kDN>
__device__ __forceinline__ void add_dq(const float (&dq)[kDN / 2], float down, float* stage,
                                       uint32_t stage_addr, const CUtensorMap* tdq, int barrier,
                                       int tid, int row0, int t, int D, int h, int q0, int b) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int n = 0; n < kDN / 8; ++n) {
      const int col = 8 * n + 2 * t;
      if (col < D)
        *reinterpret_cast<float2*>(stage + (row0 + 8 * r) * staged_cols(D, kDN) + col) =
            make_float2(dq[4 * n + 2 * r] * down, dq[4 * n + 2 * r + 1] * down);
    }
  fence_async_smem();
  bar_sync<128>(barrier);
  if (tid == 0) {
    tma_reduce_add(tdq, stage_addr, 0, h, q0, b);
    bulk_commit();
  }
}

template <class T, int kDK, int kDN, bool kFusedDq, int kCons>
__global__ void __launch_bounds__(Sweep<kCons>::kThreads, Sweep<kCons>::kMinBlocks)
    flash_bwd_sm90_kernel(const __grid_constant__ Params p, const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tdo,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdq) {
  using L = Smem<kDK, kDN, kFusedDq, kCons>;
  constexpr int kStages = L::kStages;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (smem_addr(smem) + L::kAlign - 1) & ~(L::kAlign - 1);
  unsigned char* gbase = smem + (base - smem_addr(smem));  // the same bytes, generic address
  const int j0 = blockIdx.x * L::kBN, hk = blockIdx.y, b = blockIdx.z;
  const int rep = p.Hq / p.Hkv;
  const int nq = (p.Sq + kBM - 1) / kBM;
  const int n_it = rep * nq;  // (q head of the group, q tile), q tiles innermost
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(base + L::kv_full(), 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(base + L::full(st), 32);                 // every producer lane
      mbar_init(base + L::empty(st), 128 * kCons);  // every consumer thread
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
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(Sweep<kCons>::kConsumerRegs));
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
    const float2 ds2 = ds_scales(p.do_amax);
    const float ds_scale = p.scale * ds2.x;  // dS at 2^-e (fp16; 1 for bf16)

    float dk[kDN / 2], dv[kDN / 2];
#pragma unroll
    for (int i = 0; i < kDN / 2; ++i) dk[i] = dv[i] = 0.f;
    float s[32], dp[32];
    uint32_t phi[4][4], plo[4][4], dhi[4][4], dlo[4][4];

    mbar_wait(base + L::kv_full(), 0);
    for (int it = 0; it < n_it; ++it) {
      const int st = it % kStages;
      mbar_wait(base + L::full(st), (it / kStages) & 1);
      wgmma_fence();
      qk<kDK, L::kKAtom, L::kQAtom, T>(s, k_addr, base + L::q(st));
      wgmma_commit();
      qk<kDK, L::kKAtom, L::kQAtom, T>(dp, v_addr, base + L::dout(st));
      wgmma_commit();

      const float* stats = reinterpret_cast<const float*>(gbase + L::stats(st));
      wgmma_wait<1>();
      pin(s);
      probs(s, stats, key_ok, t, p.scale2);
      wgmma_wait<0>();
      pin(dp);
      dscores(dp, s, stats + kBM, t, ds_scale);

      // dV += P^T dO, then dK += dS^T Q, packing dS beside the first
      pack_pair<T>(s, phi, plo);
      pin(dv);
      pin(phi);
      pin(plo);
      wgmma_fence();
      mma_pair<kDN, L::kQAtom, T>(dv, phi, plo, base + L::dout(st));
      wgmma_commit();
      pack_pair<T>(dp, dhi, dlo);
      pin(dk);
      pin(dhi);
      pin(dlo);
      wgmma_fence();
      mma_pair<kDN, L::kQAtom, T>(dk, dhi, dlo, base + L::q(st));
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
        if (tid == 0) bulk_wait_read<0>();  // the last reduce has read the staging tile
        bar_sync<128>(kBarOwn + c);
        float dq[kDN / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t kd = swz_desc(k_addr + kk * 16 * kSwizzle, L::kKAtom, 8 * kSwizzle);
#pragma unroll
          for (int lo = 0; lo < 2; ++lo)
            wgmma_ss_tt<T>(dq, swz_desc(base + L::ds(c, lo) + kk * 16 * kSwizzle, L::kDSTile,
                                     8 * kSwizzle), kd, kk > 0 || lo > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        pin(dq);

        const int h = hk * rep + it / nq, q0 = (it % nq) * kBM;
        add_dq<kDN>(dq, ds2.y, reinterpret_cast<float*>(gbase + L::staging(c)),
                    base + L::staging(c), &tdq, kBarOwn + c, tid, row0, t, p.D, h, q0, b);
      }
    }
    if (kFusedDq && tid == 0) bulk_wait_all();

    // dK (unscaled from dS's scale) and dV of this consumer's keys, per kv
    // head (0 for a masked key)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = j0 + c * kKeys + row0 + 8 * r;
      if (key >= p.Sk) continue;
      T* dk_row = static_cast<T*>(p.dk) + b * p.dk_sb + (long long)key * p.dk_ss + hk * p.dk_sh;
      T* dv_row = static_cast<T*>(p.dv) + b * p.dv_sb + (long long)key * p.dv_ss + hk * p.dv_sh;
#pragma unroll
      for (int n = 0; n < kDN / 8; ++n) {
        const int col = 8 * n + 2 * t;
        if (col >= p.D) break;
        *reinterpret_cast<uint32_t*>(dk_row + col) =
            Elem<T>::pack(dk[4 * n + 2 * r] * ds2.y, dk[4 * n + 2 * r + 1] * ds2.y);
        *reinterpret_cast<uint32_t*>(dv_row + col) =
            Elem<T>::pack(dv[4 * n + 2 * r], dv[4 * n + 2 * r + 1]);
      }
    }
  }
}

// The compiled kernel's registers a thread at launch (numRegs), or 0
template <class Kernel>
int launch_registers(Kernel kernel) {
  cudaFuncAttributes a;
  return cudaFuncGetAttributes(&a, kernel) == cudaSuccess ? a.numRegs : 0;
}

template <class T, int kDK, int kDN, bool kFusedDq, int kCons>
int launch_dims(const Params& p, const void* const* ptrs, const long long* meta,
                cudaStream_t stream) {
  using S = Sweep<kCons>;
  // ptrs: q, k, v, dout, dq; meta strides from index 6 (q, k, v, dout, dq)
  CUtensorMap tq, tdo, tk, tv, tdq = {};
  if (!make_map<T>(&tq, ptrs[0], p.B, p.Sq, p.Hq, p.D, meta[6], meta[7], meta[8], kBM) ||
      !make_map<T>(&tk, ptrs[1], p.B, p.Sk, p.Hkv, p.D, meta[9], meta[10], meta[11], S::kBN) ||
      !make_map<T>(&tv, ptrs[2], p.B, p.Sk, p.Hkv, p.D, meta[12], meta[13], meta[14], S::kBN) ||
      !make_map<T>(&tdo, ptrs[3], p.B, p.Sq, p.Hq, p.D, meta[15], meta[16], meta[17], kBM))
    return (int)cudaErrorInvalidValue;
  // dQ, fp32: box staged_cols(D) columns x 64 rows, unswizzled (the
  // staging tile's layout; columns past D are outside the tensor)
  if (kFusedDq && !make_map_4d(&tdq, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ptrs[4], p.B, p.Sq, p.Hq,
                               p.D, meta[18], meta[19], meta[20], staged_cols(p.D, kDN), kBM,
                               CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_bwd_sm90_kernel<T, kDK, kDN, kFusedDq, kCons>;
  // the block's registers at launch must cover what setmaxnreg hands out,
  // or setmaxnreg.inc would wait for registers the block never gets
  static const int regs = launch_registers(kernel);
  if (regs * S::kThreads < 128 * (kProducerRegs + kCons * S::kConsumerRegs))
    return (int)cudaErrorLaunchOutOfResources;
  const int bytes = (int)Smem<kDK, kDN, kFusedDq, kCons>::kBytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.Sk + S::kBN - 1) / S::kBN, p.Hkv, p.B);
  kernel<<<grid, S::kThreads, bytes, stream>>>(p, tq, tdo, tk, tv, tdq);
  return (int)cudaGetLastError();
}

// The products' depth and width by head_dim: 48/48 (one consumer, two
// blocks an SM), 64/64, 80/72 (the 2B), 96/96, 128/128 (two consumers).
// `fn` is called with a value of that instantiation's Dims.
template <int kDK, int kDN, int kCons>
struct Dims {
  static constexpr int kDepth = kDK, kWidth = kDN, kConsumers = kCons;
};
template <class Fn>
int by_head_dim(int d, Fn fn) {
  if (d <= 48) return fn(Dims<48, 48, 1>{});
  if (d <= 64) return fn(Dims<64, 64, 2>{});
  if (d <= 72) return fn(Dims<80, 72, 2>{});
  if (d <= 96) return fn(Dims<96, 96, 2>{});
  return fn(Dims<128, 128, 2>{});
}

template <class T, bool kFusedDq>
int launch(const Params& p, const void* const* ptrs, const long long* meta, cudaStream_t stream) {
  return by_head_dim(p.D, [&](auto dims) {
    using X = decltype(dims);
    return launch_dims<T, X::kDepth, X::kWidth, kFusedDq, X::kConsumers>(p, ptrs, meta, stream);
  });
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

template <class T, int kDK, int kDN>
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
    const float2 ds2 = ds_scales(p.do_amax);
    const float ds_scale = p.scale * ds2.x;  // dS at 2^-e (fp16; 1 for bf16)

    float dq[kDN / 2];
#pragma unroll
    for (int i = 0; i < kDN / 2; ++i) dq[i] = 0.f;
    float s[32], dp[32];
    uint32_t dhi[4][4], dlo[4][4];

    mbar_wait(base + L::q_full(), 0);
    mbar_wait(base + L::full(0), 0);
    wgmma_fence();
    qk<kDK, L::kQAtom, L::kAtom, T>(s, q_addr, base + L::k(0));
    wgmma_commit();
    qk<kDK, L::kQAtom, L::kAtom, T>(dp, do_addr, base + L::v(0));
    wgmma_commit();
    wgmma_wait<1>();
    pin(s);
    probs_rows(s, bits[0], t, lse2, p.scale2);
    wgmma_wait<0>();
    pin(dp);
    dscores_rows(dp, s, delta, ds_scale);
    pack_pair<T>(dp, dhi, dlo);

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
      qk<kDK, L::kQAtom, L::kAtom, T>(s, q_addr, base + L::k(st));
      wgmma_commit();
      qk<kDK, L::kQAtom, L::kAtom, T>(dp, do_addr, base + L::v(st));
      wgmma_commit();
      mma_pair<kDN, L::kAtom, T>(dq, dhi, dlo, base + L::k(prev));
      wgmma_commit();
      wgmma_wait<2>();
      pin(s);
      probs_rows(s, bits[st], t, lse2, p.scale2);
      wgmma_wait<1>();
      pin(dp);
      dscores_rows(dp, s, delta, ds_scale);
      wgmma_wait<0>();
      pin(dq);
      mbar_arrive(base + L::empty(prev));
      pack_pair<T>(dp, dhi, dlo);
    }
    pin(dq);
    pin(dhi);
    pin(dlo);
    wgmma_fence();
    mma_pair<kDN, L::kAtom, T>(dq, dhi, dlo, base + L::k((nk - 1) % kStages));
    wgmma_commit();
    wgmma_wait<0>();
    pin(dq);

    // dQ, unscaled from dS's scale and rounded once to T, for rows < Sq
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= p.Sq) continue;
      T* out = static_cast<T*>(p.dq) + b * p.dq_sb + (long long)row * p.dq_ss + h * p.dq_sh;
#pragma unroll
      for (int n = 0; n < kDN / 8; ++n) {
        const int col = 8 * n + 2 * t;
        if (col >= p.D) break;
        *reinterpret_cast<uint32_t*>(out + col) =
            Elem<T>::pack(dq[4 * n + 2 * r] * ds2.y, dq[4 * n + 2 * r + 1] * ds2.y);
      }
    }
  }
}

template <class T, int kDK, int kDN>
int launch_dq_dims(const Params& p, const void* const* ptrs, const long long* meta,
                   cudaStream_t stream) {
  // ptrs: q, k, v, dout; meta strides from index 6 (q, k, v, dout)
  CUtensorMap tq, tdo, tk, tv;
  if (!make_map<T>(&tq, ptrs[0], p.B, p.Sq, p.Hq, p.D, meta[6], meta[7], meta[8], kDqBQ) ||
      !make_map<T>(&tk, ptrs[1], p.B, p.Sk, p.Hkv, p.D, meta[9], meta[10], meta[11], 64) ||
      !make_map<T>(&tv, ptrs[2], p.B, p.Sk, p.Hkv, p.D, meta[12], meta[13], meta[14], 64) ||
      !make_map<T>(&tdo, ptrs[3], p.B, p.Sq, p.Hq, p.D, meta[15], meta[16], meta[17], kDqBQ))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_bwd_sm90_dq_kernel<T, kDK, kDN>;
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
int kernel_attributes(Kernel kernel, int bytes, int threads, int consumer_regs,
                      long long* out) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  cudaFuncAttributes a;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, bytes);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = kProducerRegs;
  out[2] = consumer_regs;
  out[3] = (long long)a.localSizeBytes;
  out[4] = (long long)a.sharedSizeBytes + bytes;
  out[5] = blocks;
  out[6] = threads;
  return 0;
}

// 0: dK/dV only, 1: fused (both by by_head_dim), 2: dQ (64/64, 80/72,
// 128/128); out[7], out[8]: the instantiation's product depth and width
template <class T>
int attributes(int which, int head_dim, long long* out) {
  if (which == 2) {
    auto dq = [&](auto kernel, int bytes, int depth, int width) {
      out[7] = depth;
      out[8] = width;
      return kernel_attributes(kernel, bytes, kThreads, kConsumerRegs, out);
    };
    if (head_dim <= 64)
      return dq(flash_bwd_sm90_dq_kernel<T, 64, 64>, DqSmem<64, 64>::kBytes, 64, 64);
    if (head_dim <= 72)
      return dq(flash_bwd_sm90_dq_kernel<T, 80, 72>, DqSmem<80, 72>::kBytes, 80, 72);
    return dq(flash_bwd_sm90_dq_kernel<T, 128, 128>, DqSmem<128, 128>::kBytes, 128, 128);
  }
  return by_head_dim(head_dim, [&](auto dims) {
    using X = decltype(dims);
    using S = Sweep<X::kConsumers>;
    out[7] = X::kDepth;
    out[8] = X::kWidth;
    if (which == 1)
      return kernel_attributes(
          flash_bwd_sm90_kernel<T, X::kDepth, X::kWidth, true, X::kConsumers>,
          (int)Smem<X::kDepth, X::kWidth, true, X::kConsumers>::kBytes, S::kThreads,
          S::kConsumerRegs, out);
    return kernel_attributes(
        flash_bwd_sm90_kernel<T, X::kDepth, X::kWidth, false, X::kConsumers>,
        (int)Smem<X::kDepth, X::kWidth, false, X::kConsumers>::kBytes, S::kThreads,
        S::kConsumerRegs, out);
  });
}

// Params from the entry points' arguments (dk, dv and dq left unset), or
// false for what the kernels do not take: D not a multiple of 8 or above
// 128, q/k/v/dout strides or bases not in whole 16-byte chunks (TMA moves
// 16-byte chunks)
bool make_params(Params& p, const void* q, const void* k, const void* v, const int* mask,
                 const void* dout, const float* lse, const float* delta, const void* do_amax,
                 const long long* meta, float scale) {
  p.mask = mask;
  p.lse = lse;
  p.delta = delta;
  p.do_amax = static_cast<const fp16*>(do_amax);
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

int flash_bwd_sm90(bool f16, bool fused, const void* q, const void* k, const void* v,
                   const int* mask, const void* dout, const float* lse, const float* delta,
                   const void* do_amax, void* dq, void* dk, void* dv, const long long* meta,
                   float scale, void* stream) {
  Params p;
  if (!make_params(p, q, k, v, mask, dout, lse, delta, do_amax, meta, scale))
    return (int)cudaErrorInvalidValue;
  p.dk = dk;
  p.dv = dv;
  // the fused dq (fp32) in whole 16-byte chunks; dk and dv take pairs of T
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
  if (f16)
    return fused ? launch<fp16, true>(p, ptrs, meta, s) : launch<fp16, false>(p, ptrs, meta, s);
  return fused ? launch<bf16, true>(p, ptrs, meta, s) : launch<bf16, false>(p, ptrs, meta, s);
}

namespace {

template <class T>
int launch_dq(const Params& p, const void* const* ptrs, const long long* meta, cudaStream_t s) {
  // QK^T depth and dQ width by head_dim: 64/64, 80/72 (the 2B), 128/128
  if (p.D <= 64) return launch_dq_dims<T, 64, 64>(p, ptrs, meta, s);
  if (p.D <= 72) return launch_dq_dims<T, 80, 72>(p, ptrs, meta, s);
  return launch_dq_dims<T, 128, 128>(p, ptrs, meta, s);
}

}  // namespace

int flash_bwd_dq_sm90(bool f16, const void* q, const void* k, const void* v, const int* mask,
                      const void* dout, const float* lse, const float* delta,
                      const void* do_amax, void* dq, const long long* meta, float scale,
                      void* stream) {
  Params p;
  if (!make_params(p, q, k, v, mask, dout, lse, delta, do_amax, meta, scale))
    return (int)cudaErrorInvalidValue;
  p.dq = dq;
  // dq (T) takes pairs of T
  for (int i = 18; i <= 20; ++i)
    if (meta[i] % 2 != 0) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(dq) % 4 != 0) return (int)cudaErrorInvalidValue;
  if (p.Sq == 0 || p.B == 0) return 0;
  const void* ptrs[4] = {q, k, v, dout};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f16 ? launch_dq<fp16>(p, ptrs, meta, s) : launch_dq<bf16>(p, ptrs, meta, s);
}

// The compiled kernel's resources at a head_dim, for bf16 (f16 = 0) or fp16
// operands (9 values into out): registers per thread as compiled (the
// launch bound), the producer's and the consumers' registers after
// setmaxnreg, local-memory (spill) bytes per thread, shared memory per
// block, resident blocks per SM, threads per block, and the instantiation's
// product depth and width.
// which: 0 the dK/dV kernel (K8), 1 the fused sweep (K6), 2 the dQ kernel (K7).
extern "C" int lumina_flash_bwd_sm90_attributes(int which, int head_dim, int f16,
                                                long long* out) {
  if (which < 0 || which > 2) return (int)cudaErrorInvalidValue;
  return f16 ? attributes<fp16>(which, head_dim, out) : attributes<bf16>(which, head_dim, out);
}

// bf16 streaming attention forward for Hopper (sm_90a), hand-written CUDA C++:
// wgmma warpgroups fed by a producer warp through an asynchronous K/V ring.
// Replaces the Pallas TPU kernels of lumina_t2x_tpu/ops/flash_attention.py
//   small KV       <- _flash_small_kv_kernel,                       static_max=None
//   online         <- _flash_kernel_fused_sum (+ _fused_sum_step), static_max=None
//   static max     <- _flash_kernel_static_max,                     static_max=bound
//   online + LSE   <- _flash_kernel_res,                            static_max=None
//   static + LSE   <- _flash_kernel_res_static_max,                 static_max=bound
//   fused RoPE     <- _flash_rope_kernel, _flash_rope_q_kernel       (online, q rotated)
// for bf16 inputs; the C entry points lumina_flash_small_kv,
// lumina_flash_online, lumina_flash_static_max, lumina_flash_online_lse,
// lumina_flash_static_max_lse, lumina_flash_rope and lumina_flash_rope_q
// stay in flash_fwd.cu (launch counters "small_kv", "online", "static_max",
// "online_lse", "static_max_lse", "rope", "rope_q"), which calls
// flash_fwd_sm90() for bf16 and keeps its own template for fp32. The
// small-KV kernel (Sk <= 1024, the caption cross-attention) is the online
// kernel's function over all keys: the online softmax over 64-key tiles is
// the single-pass exact softmax up to fp32 rounding, so it is the same
// kernel, 1-16 key tiles per block.
//
// What it computes, per (batch, q head h, query row), with s = q . k over the
// valid keys of kv head h / (Hq / Hkv) (kv_mask != 0, j < Sk):
//   online      p = exp(s*scale - m), m the running row max, with rescale
//   static max  p = exp(min(s*scale - bound, 55))
//   out = sum_j p v_j / sum_j p (fp32), 0 for a row without a valid key;
//   with an lse pointer, also the row's log-sum-exp (B, Hq, Sq) fp32:
//   lse = ln2 * (m2 + log2 l), m2 the running max (online) or bound*log2(e)
//   (static max), in log2 units: the static max's bound + ln l
//   and -inf where l = 0 (a row without a valid key). The lse pointer is a
//   runtime test in the epilogue, not a template flag: the main loop is the
//   same, and one store per row costs nothing beside it.
// Fused RoPE (the online kernel, no LSE): with the rope_cos / rope_sin
// pointers, the (Sq, D) fp32 tables cos_full and sin_signed of
// `ops/rope.rot_tables`, q arrives unrotated and each consumer warpgroup
// rotates its own 64 rows of the Q tile in shared memory once, before its
// first product: x*cos_full + swap_pairs(x)*sin_signed, each product and the
// sum rounded separately (no FMA contraction), then once to bf16, so the
// rotated tile equals `apply_rope` bit for bit. Each q row is rotated once
// in the whole grid. k is rotated before the launch, once per kv head, by
// rope_rotate.cu: rotating it here would repeat the work and the table
// reads for each of the 22 q blocks of a head. Like the lse pointer, the
// tables are a runtime test outside the main loop.
// Both run in the exp2 domain: the host folds scale*log2(e), bound*log2(e)
// and 55*log2(e), so each logit costs one FMA (or FMUL), a min and one
// MUFU.EX2. What the Pallas kernels do for the TPU is not carried over: the
// ones column appended to v for the denominator (the row sums here are the
// fp32 p in registers), the nk+1-step grid, and the LSE's 1e-30 clamp and
// lane-replicated (..., 128) layout.
//
// Design. One block of four warpgroups per (192 query rows, q head,
// batch). Warpgroup 0 is the producer: one thread loads the block's Q tile,
// then each 64-key K/V tile, with TMA (cp.async.bulk.tensor) into a ring of
// up to 8 stages in shared memory (5 at head_dim 72); a stage's "full"
// mbarrier completes when its bytes have landed. The producer warp's two
// ballots write the tile's 64 key-valid bits beside it (j < Sk and the mask,
// read one tile ahead).
// It refills a stage once its "empty" mbarrier, on which every consumer
// thread arrives, has completed. The ring's layout (KvRing), its producer
// loop (produce_kv) and the pair product (mma_pair) live in
// sm90_common.cuh, shared with the backward's dQ kernel. Warpgroups 1-3 are consumers, 64 query
// rows each; setmaxnreg moves registers from the producer (24 a thread) to
// them (160). For key tile j a consumer issues two wgmma groups,
//   S  = Q K^T   wgmma.m64n64k16, A = Q and B = K from shared memory
//                (K-major), depth 72 run as 80 (5 steps of 16, columns 72-79 zero)
//   O += P V     of tile j - 1, wgmma.m64n72k16, A = P from registers, B = V
//                from shared memory (MN-major, transposed)
// and runs the exp part of S(j)'s chain as soon as the first group is done,
// beside the second (FlashAttention-3's intra-warpgroup overlap); it packs
// P(j) once PV(j - 1) is done with the P registers. Named barriers make the
// consumers issue their groups in turn (FlashAttention-3's ping-pong, over
// three warpgroups), so the chains run while another warpgroup's products
// do; a third consumer (over two) also cuts each K/V tile's reads from L2 per
// query row by a third. S, P and O never leave registers: S's accumulator
// layout is PV's A-fragment layout.
//
// P as a bf16 pair. P enters PV as hi = bf16(p) and lo = bf16(p - hi): two
// wgmma over the same V per 16-key slice (~16 mantissa bits of p), and the
// denominator sums the fp32 p. Rounded once, P put the 2B forward 2.31e-2
// from plain (over its 2e-2 bar); the pair keeps it at 1.84e-2. The cost:
// PV's tensor work doubles, from 64*64*72 to 2*64*64*72 multiply-adds per
// warpgroup and tile, so a tile's products are 64*64*(80 + 144) instead of
// 64*64*(80 + 72) (1.47x), plus a second pack and a subtraction per logit.
//
// Shared memory. Q, K and V are stored in 128-byte-swizzled atoms of 64
// columns x rows (TMA's SWIZZLE_128B pattern, wgmma layout type 1), one TMA
// box per atom. An atom is 64 bf16 wide and cannot cover D=72 in one piece:
// columns 64-127 take a second atom, whose box (at column 64 of a tensor
// map whose innermost extent is D) reads columns 64-71 and zero-fills the
// rest, so QK^T's depth padding to 80 reads zeros. The unused columns cost
// shared memory (5 ring stages of 32 KB fit), not copies; 128-byte boxes
// keep TMA's reads in whole 32-byte sectors. Descriptors:
//   Q, K (K-major): SBO = 8 rows = 1024 bytes; k-step kk moves the start
//                   address 32 bytes along the swizzled row (LBO unused)
//   V (MN-major):   LBO = the atom stride (64 columns), SBO = 8 keys = 1024
//                   bytes; the 16-key slice kk starts 2048 bytes further
//
// What bounds it on the card: at B=2, S=4096, H=32, D=72 the two products
// are 4*B*H*S*S*D = 309 GFLOP (0.313 ms at 989 TFLOP/s); with the depth
// padded to 80 and the hi/lo pair the tensor cores do 1.56x that (0.49 ms),
// and the 1.07e9 exp take 0.275 ms on the special-function units. K and V
// are re-read by each of the 22 q tiles of a head: 1.6 GB per call from L2.
// The consumers' instruction issue (the chain, the pair's packing) sets the
// pace (`exps/fwd_sm90_breakdown.py` times the parts). The LSE adds one
// log2f and one 4-byte store per row (1 MB at that shape), after the
// last product. The rotation reads 8 table bytes per q element from L2
// (151 MB at that shape, from a 2.4 MB table) and does 3 fp32 operations
// per element before the first product.

#include <math.h>
#include <stdint.h>

#include "flash_fwd_sm90.cuh"
#include "sm90_common.cuh"

namespace {

constexpr int kBK = 64;                            // keys per tile
constexpr int kRows = 64;                          // query rows per consumer warpgroup
constexpr int kConsumers = 3;                      // consumer warpgroups
constexpr int kBQ = kRows * kConsumers;            // query rows per block
constexpr int kThreads = 128 * (1 + kConsumers);   // producer warpgroup + consumers
// setmaxnreg: 128 * kProducerRegs + 128 * kConsumers * kConsumerRegs <= 65536
constexpr int kProducerRegs = 24, kConsumerRegs = 160;
constexpr int kBarFirst = 1;                       // named barrier kBarFirst + c: consumer c's turn
constexpr int kBarRope = kBarFirst + kConsumers;   // kBarRope + c: consumer c's rotated rows
constexpr float kClamp = 55.f;  // exponent clamp of the static-max kernel (nats)
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const int* mask;  // (B, Sk) int32 or null
  bf16* out;
  float* lse;       // (B, Hq, Sq) fp32 contiguous, or null (no LSE)
  const float* rope_cos;  // (Sq, D) fp32 cos_full, or null (q arrives rotated)
  const float* rope_sin;  // (Sq, D) fp32 sin_signed
  int B, Sq, Sk, Hq, Hkv, D;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  long long m_sb;
  float scale2;  // scale * log2(e)
  float bound2;  // bound * log2(e)
  float clamp2;  // 55 * log2(e)
};

// -- shared memory ------------------------------------------------------------------

// Q, then the K/V ring (sm90_common.cuh): 5 stages at head_dim 72 and 128, 8 at 64
template <int kDK, int kDN>
using Smem = KvRing<kBQ, 1, kDK, kDN>;

// -- consumer -----------------------------------------------------------------------

// The per-logit chain of one tile, first half: s holds this thread's 32
// logits of rows g and g + 8 (s[4n + e]: key 8n + 2t + (e & 1), row g + 8 *
// (e >> 1)), `bits` the tile's key-valid bits (bit j: key j). Replaces s by
// the fp32 p and adds it to the row sums l; online, it first moves the
// running max m and scales l by alpha, which it returns for o (whose
// product of the previous tile may still be running). A tile whose keys
// are all valid (every tile but a ragged or masked one) skips the selects.
template <bool kStaticMax>
__device__ __forceinline__ void exp_tile(float (&s)[kBK / 2], unsigned long long bits, int t,
                                         float (&l)[2], float (&m)[2], float (&alpha)[2],
                                         const Params& p) {
  const bool all_valid = bits == ~0ull;
  bits >>= 2 * t;
  if constexpr (kStaticMax) {
    if (all_valid) {
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i)
        s[i] = ex2(fminf(fmaf(s[i], p.scale2, -p.bound2), p.clamp2));
    } else {
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        const float e = ex2(fminf(fmaf(s[i], p.scale2, -p.bound2), p.clamp2));
        s[i] = key_valid(bits, i) ? e : 0.f;
      }
    }
  } else {
    float mx[2] = {-INFINITY, -INFINITY};
    if (all_valid) {
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        s[i] *= p.scale2;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        s[i] = key_valid(bits, i) ? s[i] * p.scale2 : -INFINITY;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
    }
    float shift[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      // a row with no valid key so far keeps m = -inf and o = l = 0
      alpha[r] = m_new == -INFINITY ? 1.f : ex2(m[r] - m_new);
      shift[r] = m_new == -INFINITY ? 0.f : m_new;
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) s[i] = ex2(s[i] - shift[(i >> 1) & 1]);  // masked: 0
  }
#pragma unroll
  for (int n = 0; n < kBK / 8; ++n) {
    l[0] += s[4 * n] + s[4 * n + 1];
    l[1] += s[4 * n + 2] + s[4 * n + 3];
  }
}

// Second half, once the previous tile's PV has finished with o and the P
// registers: online, o *= alpha; then P as the hi/lo A fragments of PV.
template <bool kStaticMax, int kDN>
__device__ __forceinline__ void pack_tile(const float (&s)[kBK / 2], const float (&alpha)[2],
                                          float (&o)[kDN / 2], uint32_t (&phi)[4][4],
                                          uint32_t (&plo)[4][4]) {
  if constexpr (!kStaticMax) {
#pragma unroll
    for (int i = 0; i < kDN / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
  }
  pack_pair(s, phi, plo);
}

// Rotates a consumer's 64 rows of the Q tile in place (`q_rows`: their first
// row in the swizzled atoms; `row0`: its query position): each thread takes
// whole 16-byte chunks, 4 bf16 pairs (2i, 2i+1), which never straddle a
// chunk. A chunk's column c sits at chunk c % 8 ^ (row % 8) of the row in
// atom c / 8 (the 128-byte swizzle). Rows at or past Sq (zero-filled) and
// the columns past D are left as they are. The writes go through the
// generic proxy: each thread fences them for the async proxy (wgmma), and
// the warpgroup waits for all of them on its own named barrier.
template <uint32_t kQAtom>
__device__ __forceinline__ void rotate_q(unsigned char* q_rows, int row0, int c, int tid,
                                         const Params& p) {
  const int chunks = p.D / 8;
  for (int i = tid; i < kRows * chunks; i += 128) {
    const int r = i / chunks, cc = i - r * chunks;
    const int row = row0 + r;
    if (row >= p.Sq) continue;
    uint4* at = reinterpret_cast<uint4*>(q_rows + (cc / 8) * kQAtom + r * kSwizzle +
                                         ((cc % 8 ^ r % 8) << 4));
    const float4* cs = reinterpret_cast<const float4*>(p.rope_cos + (long long)row * p.D + 8 * cc);
    const float4* sn = reinterpret_cast<const float4*>(p.rope_sin + (long long)row * p.D + 8 * cc);
    const float4 c0 = __ldg(cs), c1 = __ldg(cs + 1), s0 = __ldg(sn), s1 = __ldg(sn + 1);
    const float cf[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
    const float sf[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    const uint4 x = *at;
    uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float x0 = bf16_lo(w[j]), x1 = bf16_hi(w[j]);
      w[j] = pack_bf16(__fadd_rn(__fmul_rn(x0, cf[2 * j]), __fmul_rn(x1, sf[2 * j])),
                       __fadd_rn(__fmul_rn(x1, cf[2 * j + 1]), __fmul_rn(x0, sf[2 * j + 1])));
    }
    *at = make_uint4(w[0], w[1], w[2], w[3]);
  }
  fence_async_smem();
  bar_sync<128>(kBarRope + c);
}

template <bool kStaticMax, int kDK, int kDN>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ Params p, const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv) {
  using L = Smem<kDK, kDN>;
  static_assert(L::kBK == kBK, "the chain's tile is the ring's");
  constexpr int kStages = L::kStages;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (smem_addr(smem) + L::kAlign - 1) & ~(L::kAlign - 1);
  unsigned long long* bits =
      reinterpret_cast<unsigned long long*>(smem + (base - smem_addr(smem)) + L::kBits);
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int nk = (p.Sk + kBK - 1) / kBK;
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
    // ---- producer: one warp keeps the ring full with TMA ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    // the maps are (D, H, S, B) with a box of 64 columns x rows: one box per
    // atom; columns past D (the pad to kDK) and rows past S arrive as zeros
    if (lane == 0) {
      mbar_expect_tx(base + L::q_full(), L::kQBytes);
      for (int a = 0; a < L::kAtomsK; ++a)
        tma_load(base + L::kQ + a * L::kQAtom, &tq, base + L::q_full(), kAtomCols * a, h, q0, b);
    }
    produce_kv<L>(base, bits, &tk, &tv, p.mask ? p.mask + b * p.m_sb : nullptr, p.Sk, hk, b,
                  lane);
  } else {
    // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int c = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    // the consumers issue their products in turn: 0, 1, ..., kConsumers - 1, 0, ...
    const int mine = kBarFirst + c, other = kBarFirst + (c + 1) % kConsumers;
    const uint32_t q_addr = base + L::kQ + c * kRows * kSwizzle;  // this warpgroup's rows

    float o[kDN / 2];
#pragma unroll
    for (int i = 0; i < kDN / 2; ++i) o[i] = 0.f;
    float l[2] = {0.f, 0.f}, m[2] = {-INFINITY, -INFINITY};
    float s[kBK / 2];
    uint32_t phi[4][4], plo[4][4];

    float alpha[2];

    if (c == kConsumers - 1) bar_arrive(kBarFirst);  // consumer 0 issues first
    mbar_wait(base + L::q_full(), 0);
    if (p.rope_cos != nullptr)
      rotate_q<L::kQAtom>(smem + (base - smem_addr(smem)) + L::kQ + c * kRows * kSwizzle,
                          q0 + c * kRows, c, tid, p);
    mbar_wait(base + L::full(0), 0);
    bar_sync(mine);
    wgmma_fence();
    qk<kDK, L::kQAtom, L::kAtom>(s, q_addr, base + L::k(0));
    wgmma_commit();
    bar_arrive(other);
    wgmma_wait<0>();
    pin(s);
    exp_tile<kStaticMax>(s, bits[0], tid % 4, l, m, alpha, p);
    pack_tile<kStaticMax, kDN>(s, alpha, o, phi, plo);

    // Per tile j: S(j) = QK^T and O += P(j-1) V(j-1) in two wgmma groups;
    // the chain of S(j) runs as soon as the first group is done, beside the
    // second (FlashAttention-3's intra-warpgroup overlap), and packs P(j)
    // once the second is done with the P registers.
    for (int j = 1; j < nk; ++j) {
      const int st = j % kStages, prev = (j - 1) % kStages;
      mbar_wait(base + L::full(st), (j / kStages) & 1);
      bar_sync(mine);
      pin(o);
      pin(phi);
      pin(plo);
      wgmma_fence();
      qk<kDK, L::kQAtom, L::kAtom>(s, q_addr, base + L::k(st));
      wgmma_commit();
      mma_pair<kDN, L::kAtom>(o, phi, plo, base + L::v(prev));
      wgmma_commit();
      bar_arrive(other);
      wgmma_wait<1>();
      pin(s);
      exp_tile<kStaticMax>(s, bits[st], tid % 4, l, m, alpha, p);
      wgmma_wait<0>();
      pin(o);
      mbar_arrive(base + L::empty(prev));
      pack_tile<kStaticMax, kDN>(s, alpha, o, phi, plo);
    }

    bar_sync(mine);
    pin(o);
    pin(phi);
    pin(plo);
    wgmma_fence();
    mma_pair<kDN, L::kAtom>(o, phi, plo, base + L::v((nk - 1) % kStages));
    wgmma_commit();
    if (c != kConsumers - 1) bar_arrive(other);  // consumer 0 has no later turn to take
    wgmma_wait<0>();
    pin(o);

    const int warp = tid / 32, lane = tid % 32;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + c * kRows + 16 * warp + lane / 4 + 8 * r;
      if (row >= p.Sq) continue;
      // l and m are the same on the row's quad: its first lane writes the LSE,
      // whose base is the running max or the bound, both in log2 units
      if (p.lse != nullptr && lane % 4 == 0)
        p.lse[((long long)b * p.Hq + h) * p.Sq + row] =
            l[r] > 0.f ? kLn2 * ((kStaticMax ? p.bound2 : m[r]) + log2f(l[r])) : -INFINITY;
      const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
      bf16* out = p.out + b * p.o_sb + (long long)row * p.o_ss + h * p.o_sh;
#pragma unroll
      for (int n = 0; n < kDN / 8; ++n) {
        const int col = 8 * n + 2 * (lane % 4);
        if (col >= p.D) break;
        *reinterpret_cast<__nv_bfloat162*>(out + col) =
            __floats2bfloat162_rn(o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv);
      }
    }
  }
}

template <bool kStaticMax, int kDK, int kDN>
int launch_dims(const Params& p, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, p.q, p.B, p.Sq, p.Hq, p.D, p.q_sb, p.q_ss, p.q_sh, kBQ) ||
      !make_map(&tk, p.k, p.B, p.Sk, p.Hkv, p.D, p.k_sb, p.k_ss, p.k_sh, kBK) ||
      !make_map(&tv, p.v, p.B, p.Sk, p.Hkv, p.D, p.v_sb, p.v_ss, p.v_sh, kBK))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_fwd_sm90_kernel<kStaticMax, kDK, kDN>;
  const int bytes = (int)Smem<kDK, kDN>::kBytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.Sq + kBQ - 1) / kBQ, p.Hq, p.B);
  kernel<<<grid, kThreads, bytes, stream>>>(p, tq, tk, tv);
  return (int)cudaGetLastError();
}

// QK^T depth and PV width by head_dim: 64/64, 80/72 (the 2B), 128/128
template <bool kStaticMax>
int launch(const Params& p, cudaStream_t stream) {
  if (p.D <= 64) return launch_dims<kStaticMax, 64, 64>(p, stream);
  if (p.D <= 72) return launch_dims<kStaticMax, 80, 72>(p, stream);
  return launch_dims<kStaticMax, 128, 128>(p, stream);
}

template <bool kStaticMax, int kDK, int kDN>
int attributes_dims(long long* out) {
  auto kernel = flash_fwd_sm90_kernel<kStaticMax, kDK, kDN>;
  const int bytes = (int)Smem<kDK, kDN>::kBytes;
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

}  // namespace

int flash_fwd_sm90(bool static_max, const void* q, const void* k, const void* v, const int* mask,
                   void* out, float* lse, const float* rope_cos, const float* rope_sin,
                   const long long* meta, float scale, float bound, void* stream) {
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.mask = mask;
  p.out = static_cast<bf16*>(out);
  p.lse = lse;
  p.rope_cos = rope_cos;
  p.rope_sin = rope_sin;
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
  // TMA moves 16-byte chunks: D, the strides and the bases in whole chunks
  for (int i = 6; i <= 17; ++i)
    if (meta[i] % 8 != 0) return (int)cudaErrorInvalidValue;
  if (p.D <= 0 || p.D > 128 || p.D % 8 != 0 || p.Hkv <= 0 || p.Hq % p.Hkv != 0 || p.Sk <= 0 ||
      !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  // the rotation: both tables, 16-byte aligned rows of D floats, online and no LSE
  if ((rope_cos == nullptr) != (rope_sin == nullptr) ||
      (rope_cos != nullptr && (static_max || lse != nullptr || !aligned16(rope_cos) ||
                               !aligned16(rope_sin))))
    return (int)cudaErrorInvalidValue;
  if (p.Sq == 0 || p.B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_max ? launch<true>(p, s) : launch<false>(p, s);
}

// The compiled kernel's resources at a head_dim (7 values into out):
// registers per thread as compiled (the launch bound), the producer's and
// the consumers' registers after setmaxnreg, local-memory (spill) bytes per
// thread, shared memory per block, resident blocks per SM, threads per block.
extern "C" int lumina_flash_fwd_sm90_attributes(int static_max, int head_dim, long long* out) {
  if (head_dim <= 64)
    return static_max ? attributes_dims<true, 64, 64>(out) : attributes_dims<false, 64, 64>(out);
  if (head_dim <= 72)
    return static_max ? attributes_dims<true, 80, 72>(out) : attributes_dims<false, 80, 72>(out);
  return static_max ? attributes_dims<true, 128, 128>(out) : attributes_dims<false, 128, 128>(out);
}

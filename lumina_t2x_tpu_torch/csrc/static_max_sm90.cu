// K11 on the Hopper forward's K/V ring, hand-written CUDA C++ for sm_90a:
//   lumina_static_max_v4 <- _kernel_v4 (exps/vpu_op_reduction.py, `_loop_v4`)
// and its serial anchor (lumina_static_max_v4_serial: the same products in
// the same order, issued one after the other). The per-logit-work
// experiment's (`lumina_t2x_tpu_torch/exps/vpu_op_reduction.py`) question:
// does issuing the next key tile's QK^T before this tile's chain and PV hide
// the chain? K10's v0-v3 stay in static_max_variants.cu.
//
// What it computes is v1's function, per (batch, head, query row), with s =
// q . k the fp32 dot of a query row and a key row:
//   p = expf(fminf(fmaf(s, scale, -bound), clamp)); p = 0 on a key whose
//   valid bit is 0 (j >= Sk or mask 0)
//   out = sum_j bf16(p_j) v_j / max(sum_j bf16(p_j), 1e-30), in bf16
// P is rounded once to bf16 and the row sums add those same bf16 values in
// fp32, v1's order (the low then the high key of each pair, row by row).
//
// Layout: q, k, v bf16 (B, S, H, D), read in place from element strides
// (last dim contiguous, strides and base 16-byte aligned); D a multiple of
// 8, at most 128; mask (B, Sk) int32 or null; out bf16 (B, Sq, H, D). As
// many kv heads as q heads.
//
// Design: the forward's (flash_fwd_sm90.cu) ring and layout, through
// sm90_common.cuh (KvRing, produce_kv, the swizzled descriptors). One block
// of three warpgroups per (128 query rows, head, batch): a TMA producer warp
// loads Q once, then 64-key K/V tiles with their key-valid bits into the
// ring (6 stages at head_dim 72); two consumer warpgroups of 64 rows each
// (setmaxnreg 24 / 240), with no named-barrier ping-pong: inside a
// warpgroup the only overlap is v4's, and the hardware interleaves the two
// warpgroups freely. Products, per key tile:
//   S = Q K^T    wgmma m64n64k16, both from shared memory (K-major), depth
//                72 run as 80
//   O += P V     wgmma m64n72k16, P from registers (rounded once: one
//                product, where the forward's K3 carries the hi/lo pair), V
//                MN-major
// kPipelined (v4), for tile j: issue S(j+1) into the second accumulator; run
// the chain of S(j) and pack P(j); issue O += P(j) V(j); wait for both, then
// release stage j. The serial anchor: issue S(j), wait, run the chain, issue
// PV(j), wait. Both sum the same products in the same order, so they agree
// bit for bit, and only the issue order differs: v4's tensor cores run
// S(j+1) while the chain of S(j) runs. v4 waits for PV(j) too, not only for
// S(j+1): every loop that kept PV(j) in flight into the next tile (each
// variant tried, one group count per tile or not) made ptxas serialize the
// products (C7514 / C7515 / C7517 / C7519 in -Xptxas -v), which runs them
// in the serial anchor's order.
//
// What bounds it on the card: at B=2, S=4096, H=32, D=72 the two products
// are 4*B*H*S*S*D = 309 GFLOP (0.313 ms at 989 TFLOP/s; the depth padded to
// 80 adds 1/18), and the 1.07e9 logits' exp 0.275 ms on the special-function
// units; expf's range reduction and the bf16 packing add to each logit's
// chain on the FMA pipes. K and V are re-read by each of the 32 q tiles of
// a head from L2.

#include <math.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

constexpr int kBK = 64;                            // keys per tile
constexpr int kRows = 64;                          // query rows per consumer warpgroup
constexpr int kConsumers = 2;
constexpr int kBQ = kRows * kConsumers;            // query rows per block
constexpr int kThreads = 128 * (1 + kConsumers);   // producer warpgroup + consumers
// setmaxnreg: 128 * kProducerRegs + 128 * kConsumers * kConsumerRegs <= 65536
constexpr int kProducerRegs = 24, kConsumerRegs = 240;

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
  float scale, bound, clamp;
};

// Q, then the K/V ring (sm90_common.cuh)
template <int kDK, int kDN>
using Smem = KvRing<kBQ, 1, kDK, kDN>;

// v1's chain on this thread's 32 logits of a tile (s[4n + e]: key 8n + 2t +
// (e & 1), row g + 8 * (e >> 1)), P rounded once to bf16 into the A
// fragments of PV (k-step n / 2), and the row sums of the same bf16 values.
// `bits`: the tile's key-valid bits (bit j: key j); a tile whose keys are
// all valid skips the selects.
__device__ __forceinline__ void chain_pack(const float (&s)[32], unsigned long long bits, int t,
                                           uint32_t (&pf)[4][4], float (&rowsum)[2],
                                           const Params& p) {
  const bool all_valid = bits == ~0ull;
  bits >>= 2 * t;
  float e[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    e[i] = expf(fminf(fmaf(s[i], p.scale, -p.bound), p.clamp));
    if (!all_valid && !key_valid(bits, i)) e[i] = 0.f;
  }
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const uint32_t top = pack_bf16(e[4 * n], e[4 * n + 1]);      // row g,     keys 8n + 2t, +1
    const uint32_t bot = pack_bf16(e[4 * n + 2], e[4 * n + 3]);  // row g + 8
    rowsum[0] += bf16_lo(top);
    rowsum[0] += bf16_hi(top);
    rowsum[1] += bf16_lo(bot);
    rowsum[1] += bf16_hi(bot);
    pf[n / 2][2 * (n % 2)] = top;
    pf[n / 2][2 * (n % 2) + 1] = bot;
  }
}

// o (64 x kDN) += P V over the tile's 64 keys: V MN-major, LBO = the atom
// stride, SBO = 8 keys; the 16-key slice kk starts 16 rows further
template <int kDN, uint32_t kAtom>
__device__ __forceinline__ void pv(float (&o)[kDN / 2], const uint32_t (&pf)[4][4],
                                   uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<kDN>(o, pf[kk], swz_desc(v_addr + kk * 16 * kSwizzle, kAtom, 8 * kSwizzle));
}

template <bool kPipelined, int kDK, int kDN>
__global__ void __launch_bounds__(kThreads, 1)
    static_max_sm90_kernel(const __grid_constant__ Params p,
                           const __grid_constant__ CUtensorMap tq,
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
    // ---- producer: Q once, then the K/V ring ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0) {
      mbar_expect_tx(base + L::q_full(), L::kQBytes);
      for (int a = 0; a < L::kAtomsK; ++a)
        tma_load(base + L::kQ + a * L::kQAtom, &tq, base + L::q_full(), kAtomCols * a, h, q0, b);
    }
    produce_kv<L>(base, bits, &tk, &tv, p.mask ? p.mask + b * p.m_sb : nullptr, p.Sk, h, b,
                  lane);
    return;
  }

  // ---- consumers: 64 query rows each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int c = wg - 1;
  const int tid = threadIdx.x - 128 * wg;
  const int t = tid % 4;
  const uint32_t q_addr = base + L::kQ + c * kRows * kSwizzle;  // this warpgroup's rows

  float o[kDN / 2];
#pragma unroll
  for (int i = 0; i < kDN / 2; ++i) o[i] = 0.f;
  float rowsum[2] = {0.f, 0.f};
  float s[2][32];  // S(j) and S(j + 1): tile j's is s[j % 2]
  uint32_t pf[4][4];

  mbar_wait(base + L::q_full(), 0);
  if constexpr (kPipelined) {
    mbar_wait(base + L::full(0), 0);
    wgmma_fence();
    qk<kDK, L::kQAtom, L::kAtom>(s[0], q_addr, base + L::k(0));
    wgmma_commit();
    wgmma_wait<0>();
    pin(s[0]);
  }
  // two tiles an iteration, so that the two S accumulators keep their
  // registers (tile j's is s[j % 2], indexed by a constant). Every tile
  // ends with nothing in flight: an accumulator read or written by other
  // instructions while a product that shares its wait is in flight, or
  // across the loop's back edge, makes ptxas serialize the products.
  for (int j2 = 0; j2 < nk; j2 += 2) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = j2 + u;
      if (j < nk) {
        const int st = j % kStages;
        if constexpr (kPipelined) {
          if (j + 1 < nk) {  // S(j + 1) into the other accumulator, beside the chain of S(j)
            const int nx = (j + 1) % kStages;
            mbar_wait(base + L::full(nx), ((j + 1) / kStages) & 1);
            wgmma_fence();
            qk<kDK, L::kQAtom, L::kAtom>(s[1 - u], q_addr, base + L::k(nx));
            wgmma_commit();
            pin(s[u]);  // the chain of S(j) after the issue, not hoisted above it
          }
        } else {
          mbar_wait(base + L::full(st), (j / kStages) & 1);
          wgmma_fence();
          qk<kDK, L::kQAtom, L::kAtom>(s[u], q_addr, base + L::k(st));
          wgmma_commit();
          wgmma_wait<0>();
          pin(s[u]);
        }
        chain_pack(s[u], bits[st], t, pf, rowsum, p);
        wgmma_fence();
        pv<kDN, L::kAtom>(o, pf, base + L::v(st));
        wgmma_commit();
        wgmma_wait<0>();  // PV(j) (and S(j + 1)): stage j is free
        pin(o);
        if constexpr (kPipelined) {
          if (j + 1 < nk) pin(s[1 - u]);
        }
        mbar_arrive(base + L::empty(st));
      }
    }
  }

  // out = O / max(l, 1e-30), rows < Sq
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rowsum[r] += __shfl_xor_sync(0xffffffffu, rowsum[r], 1);
    rowsum[r] += __shfl_xor_sync(0xffffffffu, rowsum[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + c * kRows + 16 * warp + lane / 4 + 8 * r;
    if (row >= p.Sq) continue;
    const float den = fmaxf(rowsum[r], 1e-30f);
    bf16* out = p.out + b * p.o_sb + (long long)row * p.o_ss + h * p.o_sh;
#pragma unroll
    for (int n = 0; n < kDN / 8; ++n) {
      const int col = 8 * n + 2 * t;
      if (col >= p.D) break;
      *reinterpret_cast<__nv_bfloat162*>(out + col) =
          __floats2bfloat162_rn(o[4 * n + 2 * r] / den, o[4 * n + 2 * r + 1] / den);
    }
  }
}

template <bool kPipelined, int kDK, int kDN>
int launch_dims(const Params& p, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, p.q, p.B, p.Sq, p.H, p.D, p.q_sb, p.q_ss, p.q_sh, kBQ) ||
      !make_map(&tk, p.k, p.B, p.Sk, p.H, p.D, p.k_sb, p.k_ss, p.k_sh, kBK) ||
      !make_map(&tv, p.v, p.B, p.Sk, p.H, p.D, p.v_sb, p.v_ss, p.v_sh, kBK))
    return (int)cudaErrorInvalidValue;
  auto kernel = static_max_sm90_kernel<kPipelined, kDK, kDN>;
  const int bytes = (int)Smem<kDK, kDN>::kBytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.Sq + kBQ - 1) / kBQ, p.H, p.B);
  kernel<<<grid, kThreads, bytes, stream>>>(p, tq, tk, tv);
  return (int)cudaGetLastError();
}

// QK^T depth and PV width by head_dim: 64/64, 80/72 (the 2B), 128/128
template <bool kPipelined>
int launch(const Params& p, cudaStream_t stream) {
  if (p.D <= 64) return launch_dims<kPipelined, 64, 64>(p, stream);
  if (p.D <= 72) return launch_dims<kPipelined, 80, 72>(p, stream);
  return launch_dims<kPipelined, 128, 128>(p, stream);
}

int run(bool pipelined, const void* q, const void* k, const void* v, const int* mask, void* out,
        const long long* meta, float scale, float bound, float clamp, void* stream) {
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.mask = mask;
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
  // TMA moves 16-byte chunks: D, the strides and the bases in whole chunks
  for (int i = 5; i <= 16; ++i)
    if (meta[i] % 8 != 0) return (int)cudaErrorInvalidValue;
  if (p.D <= 0 || p.D > 128 || p.D % 8 != 0 || p.Sk <= 0 || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  if (p.Sq == 0 || p.B == 0 || p.H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return pipelined ? launch<true>(p, s) : launch<false>(p, s);
}

template <bool kPipelined, int kDK, int kDN>
int attributes_dims(long long* out) {
  auto kernel = static_max_sm90_kernel<kPipelined, kDK, kDN>;
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

template <bool kPipelined>
int attributes(int head_dim, long long* out) {
  if (head_dim <= 64) return attributes_dims<kPipelined, 64, 64>(out);
  if (head_dim <= 72) return attributes_dims<kPipelined, 80, 72>(out);
  return attributes_dims<kPipelined, 128, 128>(out);
}

}  // namespace

// The entry points take static_max_variants.cu's arguments: meta (int64[18]):
// B, Sq, Sk, H, D, then element strides of q (b, s, h), k (b, s, h), v (b,
// s, h), out (b, s, h) and the mask (b); mask may be null (every key
// valid). Each returns the cudaError_t of the launch (0 on success).
extern "C" {

int lumina_static_max_v4(const void* q, const void* k, const void* v, const int* mask, void* out,
                         const long long* meta, float scale, float bound, float clamp,
                         void* stream) {
  return run(true, q, k, v, mask, out, meta, scale, bound, clamp, stream);
}

// the serial anchor: v4's products in v4's order, each waited for in turn
int lumina_static_max_v4_serial(const void* q, const void* k, const void* v, const int* mask,
                                void* out, const long long* meta, float scale, float bound,
                                float clamp, void* stream) {
  return run(false, q, k, v, mask, out, meta, scale, bound, clamp, stream);
}

// The compiled kernel's resources at a head_dim (7 values into out, as
// lumina_flash_fwd_sm90_attributes): registers per thread as compiled, the
// producer's and the consumers' registers after setmaxnreg, local-memory
// (spill) bytes per thread, shared memory per block, resident blocks per
// SM, threads per block.
int lumina_static_max_sm90_attributes(int pipelined, int head_dim, long long* out) {
  return pipelined ? attributes<true>(head_dim, out) : attributes<false>(head_dim, out);
}

}  // extern "C"

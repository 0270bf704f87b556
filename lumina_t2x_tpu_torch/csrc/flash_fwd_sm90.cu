// bf16 and fp16 streaming attention forward for Hopper (sm_90a), hand-written
// CUDA C++: wgmma warpgroups fed by a producer warp through an asynchronous
// K/V ring.
// Replaces the Pallas TPU kernels of lumina_t2x_tpu/ops/flash_attention.py
//   small KV       <- _flash_small_kv_kernel,                       static_max=None
//   online         <- _flash_kernel_fused_sum (+ _fused_sum_step), static_max=None
//   static max     <- _flash_kernel_static_max,                     static_max=bound
//   online + LSE   <- _flash_kernel_res,                            static_max=None
//   static + LSE   <- _flash_kernel_res_static_max,                 static_max=bound
//   fused RoPE     <- _flash_rope_kernel, _flash_rope_q_kernel       (online, q rotated)
// for bf16 and fp16 inputs (the operand type T, one instantiation each); the
// C entry points lumina_flash_small_kv,
// lumina_flash_online, lumina_flash_static_max, lumina_flash_online_lse,
// lumina_flash_static_max_lse, lumina_flash_rope and lumina_flash_rope_q
// stay in flash_fwd.cu (launch counters "small_kv", "online", "static_max",
// "online_lse", "static_max_lse", "rope", "rope_q"), which calls
// flash_fwd_sm90() for bf16 and fp16 and flash_fwd_fp32_sm90() for fp32. The
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
// sum rounded separately (no FMA contraction), then once to T, so the
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
// Design. One block per (64 or 192 query rows, q head, batch): a producer
// warpgroup and one or three consumer warpgroups (`Block`, chosen at launch
// from head_dim, Sq and Sk: `by_shape`; the K/V-resident block below
// streams 64-row Q tiles to two). Warpgroup 0 is the producer: one
// thread loads the block's Q tile, then each 64-key K/V tile, with TMA
// (cp.async.bulk.tensor) into a ring of up to 8 stages in the block's share
// of shared memory (5 at 80/72 in the 192-row block, 3 in its 64-row
// block); a stage's "full" mbarrier completes when its bytes have landed.
// The producer warp's two ballots write the tile's 64 key-valid bits beside
// it (j < Sk and the mask, read one tile ahead).
// It refills a stage once its "empty" mbarrier, on which every consumer
// thread arrives, has completed. The ring's layout (KvRing), its producer
// loop (produce_kv) and the pair product (mma_pair) live in
// sm90_common.cuh, shared with the backward's dQ kernel. The other
// warpgroups are consumers, 64 query rows each; setmaxnreg moves registers
// from the producer (24 a thread) to them (160 with three consumers, 136
// with one and three blocks an SM). For key tile j a consumer
// issues two wgmma groups,
//   S  = Q K^T   wgmma.m64n64k16, A = Q and B = K from shared memory
//                (K-major), depth 72 run as 80 (5 steps of 16, columns 72-79 zero)
//   O += P V     of tile j - 1, wgmma.m64n72k16, A = P from registers, B = V
//                from shared memory (MN-major, transposed)
// and runs the exp part of S(j)'s chain as soon as the first group is done,
// beside the second (FlashAttention-3's intra-warpgroup overlap); it packs
// P(j) once PV(j - 1) is done with the P registers. Named barriers make the
// consumers of a block issue their groups in turn (FlashAttention-3's
// ping-pong, over two or three warpgroups), so the chains run while another
// warpgroup's products do; a third consumer (over two) also cuts each K/V
// tile's reads from L2 per query row by a third. S, P and O never leave
// registers: S's accumulator layout is PV's A-fragment layout.
//
// Blocks. 192 rows, one block an SM, over more than 1024 keys (the 2B's,
// SD3's and the Flag-DiT 5B's self-attention) and above 80/72. Over at
// most 1024 a block sees at most 16 key tiles, and its fixed cost --
// barrier set-up, setmaxnreg, the Q load, filling the ring, the epilogue's
// stores -- weighs: at Sq = 256 the 192-row block's loads and barriers
// alone took 0.59 of the ImageNet 600M trainer's 0.91-0.95 ms on an H100
// (`exps/fwd_sm90_breakdown.py`), and it computes 384 row slots for 256
// rows. There, up to 80/72, the block is one consumer of 64 rows, three
// resident an SM (80 registers a thread at launch, 136 a consumer thread
// after setmaxnreg; shared memory within a third of the SM's: a 4-stage
// ring at 48/48 and 64/64, 3 at 80/72), so that one block's prologue and
// epilogue run beside the others' loops: 0.57 ms at the 600M trainer's
// shape. At 80/72 it fits only with Q's, K's and V's columns 64-79 in
// narrow atoms (Shared memory, below; 72,784 bytes), PV then an n64 and an
// n16 product a slice. `exps/fwd_sm90_breakdown.py --blocks` times each
// block; at 80/72 on an H100 (device ms, static max / online), against
// 64 rows two an SM, 128 rows one an SM and 192 rows, each with Q's and
// K's columns 64-79 in narrow atoms and V in whole ones (3, 7 and 7
// stages):
//   the music trainer (32, 256, 16, 72) over 256 keys: three an SM
//   0.062 / 0.063, two 0.069 / 0.068, 128 rows 0.058 / 0.064, 192 rows
//   0.070 / 0.073; over its 77 caption keys 0.040 / 0.041, 0.043 / 0.045,
//   0.047 / 0.049, 0.052 / 0.053; the 2B (2, 4096, 32, 72) over its 256
//   caption keys 0.115 / 0.116, 0.131 / 0.131, 0.119 / 0.124, 0.110 /
//   0.115, over 32 0.061 / 0.063, 0.068 / 0.068, 0.074 / 0.075, 0.069 /
//   0.071.
// Two an SM and 128 rows are slower than three an SM almost everywhere. The
// 192-row block keeps whole atoms: with 7 stages on narrow Q and K the 2B's
// K2 / K3 over 4096 keys were no faster (`exps/fwd_head_dim_times.py`).
// Above 80/72 two blocks do not fit (Q and three stages of whole
// 128-column atoms take 115,792 bytes with the alignment pad, past half the
// SM's 115,712; two consumers' blocks, two an SM, leave 104 registers a
// consumer thread, where o, S and the P pair alone take 112 at 96/96). A
// 128-row block, one an SM, took the ImageNet 7B's single K1 call from
// 0.084-0.087 to 0.101-0.104 ms on an H100, though its device time fell
// (`exps/fwd_head_dim_times.py`), so above 80/72 the block stays at 192
// rows whatever Sq is.
//
// The K/V-resident block (80/72 over at most 256 keys and at least 512
// query rows: the 2B's caption cross-attention, 4096 rows over 256 or 32
// keys, and the 128K-token forward's). A 64-row block reads each K/V tile
// from L2 once per 64 rows (~302 MB a call at the 2B's 256 caption keys,
// against the call's ~80 MB of Q, K, V and O), and its loads alone took
// its whole time; 192 rows read a third as much and were hardly faster,
// their fixed costs exposed at one block an SM. So here a block holds a
// head's K/V, at most 4 tiles, in 4 stages loaded once (the ring's producer
// loop, never refilled) and streams 64-row Q tiles through a ring of its
// own (`QRing`: two stages a consumer, "full" and "empty" mbarriers); two
// consumers take the tiles in turn (tiles c, c + 2, ...), each through
// the same products and chain as every other block (`attend_rows`, the
// turns as above), and write O / l over the tile's own Q stage, in its
// swizzled atoms, then store it with one TMA box per atom (`store_rows`)
// and give the stage back. One an SM, whole atoms fit (196,608 bytes with
// two consumers; two an SM need narrow ones). A block takes one (batch, q
// head)'s tiles, as many as one wave of the SMs leaves each head
// (`resident_tiles`, set at launch: 32 at the 2B's (2, 4096, 32, 72), two
// blocks a head, 128 blocks), so each SM runs one prologue; a block's last
// round may hold a tile past Sq, computed and not written, so that both
// consumers take as many turns. On an H100 (`exps/fwd_head_dim_times.py`,
// device ms under the profiler, the 64-row block it replaces in brackets):
// K1 at (2, 4096, 32, 72) over 256 keys 0.079-0.080 (0.116-0.120; sdpa
// 0.082-0.098), over 32 keys 0.039 (0.062-0.068; sdpa 0.050-0.051); K4 over
// 8 / 40 / 136 keys 0.039 / 0.039-0.040 / 0.068-0.070 (0.062 / 0.063 /
// 0.098-0.100); `rope_q` at 131072 rows over 256 keys 2.14-2.18 (2.58), but
// over 32 keys 0.092-0.096 (0.088): each consumer rotates each tile on its
// own path. What did not help (`--blocks`, the same card): K/V on narrow
// atoms (PV n64 + n16; ~5% slower), three Q stages a consumer or more, three
// consumers, one consumer two an SM, a consumer's tiles run as one stream
// of steps (slower, and ptxas C7511 on the static max); the stores by TMA
// took 0.056 to 0.044 at 32 keys, the rows set at launch (one wave) 0.087
// to 0.076 at 256 (`PERF.md` §6).
// A block does not change a row's arithmetic: every block and width gives
// the same bits (a zero column adds exact zeros to each fp32 sum).
//
// P as a pair. P enters PV as hi = T(p) and lo = T(p - hi): two wgmma over
// the same V per 16-key slice (~16 mantissa bits of p in bf16, ~22 in
// fp16), and the denominator sums the fp32 p. Rounded once, bf16 P put the
// 2B forward 2.31e-2 from plain (over its 2e-2 bar); the pair keeps it at
// 1.84e-2. The cost: PV's tensor work doubles, from 64*64*72 to 2*64*64*72
// multiply-adds per warpgroup and tile, so a tile's products are
// 64*64*(80 + 144) instead of 64*64*(80 + 72) (1.47x), plus a second pack
// and a subtraction per logit.
//
// fp16. The same kernel on wgmma's .f16 operands (m64nNk16.f32.f16.f16, the
// same shapes, swizzles and fp32 accumulators), with what fp16's 5 exponent
// bits need: its largest value is 65504 (about e^11.1) and its smallest
// normal 2^-14. The online kernel packs p <= 1, which fits. The static max
// does not: p = exp(min(s - bound, 55)) passes 65504 when a row's logits
// pass its bound by 11 nats (a stale or low bound), and sits below 2^-14,
// where the pair loses its bits, when they stay 10 nats under it (the
// calibrated bound's margin puts most rows there). So each row packs p * sc,
// sc a power of two kept in the registers of the online kernel's running
// max (unused by the static max): it starts at 2^127, and when a tile's
// largest p * sc reaches 2^15 (a warp vote on one compare per element row),
// the quad's row max sets sc = 2^(14 - floor(log2 max p)) and O's
// accumulator is scaled by the ratio, as the online kernel applies alpha.
// So the row's largest p packs into [2^14, 2^15) whatever the bound, and
// the scaling is exact: the denominator sums the unscaled fp32 p (the LSE
// reads it as before) and the epilogue divides O by l * sc. bf16 packs p
// as it is (its exponent range is fp32's).
//
// Shared memory. Q, K and V are stored in 128-byte-swizzled atoms of 64
// columns x rows (TMA's SWIZZLE_128B pattern, wgmma layout type 1), one TMA
// box per atom. An atom is 64 bf16 wide and cannot cover D=72 in one piece.
// In 80/72's 64-row block Q's and K's columns 64-79 -- QK^T's fifth
// k-step, its own wgmma -- take a narrow atom: 16 columns x rows of 32
// bytes, 32-byte swizzled (SWIZZLE_32B, layout type 3), whose box (at
// column 64 of a tensor map whose innermost extent is D) reads columns
// 64-71 and zero-fills 72-79, so the depth's padding to 80 reads zeros. So
// do V's (a key's 16 columns a 32-byte row, MN-major), and PV runs an n64
// and an n16 product a slice. Each row then takes 160 bytes instead of 256,
// a 64-key stage 20,480 bytes instead of 32,768, and Q and three stages fit
// in a third of the SM. The 192-row block keeps whole second atoms
// (columns 72-127 zero-filled, which costs shared memory, not reads; 5
// stages) and PV n72. Descriptors:
//   Q, K (K-major): SBO = 8 rows = 1024 bytes; k-step kk moves the start
//                   address 32 bytes along the swizzled row (LBO unused);
//                   the narrow atom: SBO = 8 rows = 256 bytes
//   V (MN-major):   LBO = the atom stride (64 columns), SBO = 8 keys = 1024
//                   bytes; the 16-key slice kk starts 2048 bytes further
//                   (the narrow atom: SBO 256, the slice 512 bytes further)
//
// Widths. QK^T's depth and PV's width by head_dim: 48/48 up to 48 (three
// k16 steps in one atom; n48), 64/64, 80/72, 96/96 (six steps over two
// atoms; n96) and 128/128, so that no more than a 16-column step of depth
// and an 8-column slice of width are padding (the 64/64 and 128/128 that
// head_dim 48 and 96 ran before did a third more tensor work).
//
// What bounds it on the card: at B=2, S=4096, H=32, D=72 the two products
// are 4*B*H*S*S*D = 309 GFLOP (0.313 ms at 989 TFLOP/s); with the depth
// padded to 80 and the hi/lo pair the tensor cores do 1.56x that (0.49 ms),
// and the 1.07e9 exp take 0.275 ms on the special-function units. K and V
// are re-read by each of the 22 q tiles of a head: 1.6 GB per call from L2.
// The consumers' instruction issue (the chain, the pair's packing) sets the
// pace (`exps/fwd_sm90_breakdown.py` times the parts). At 64/64 over SD3's
// joint sequence (2, 4429, 24, 64) the products alone (with the pair) take
// 0.355 ms on an H100, the pair's tensor peak, and the kernel 0.74 / 0.78
// (static max / online): the chain runs beside them for little of its
// time. Tried there and dropped (`--chain`; none lowered the time): the
// row max in four chains of four (0.77 against 0.77 online), o scaled only
// when a row's max moved in the warp (0.81), both (0.84), the scale in the
// exp's FMA (0.85); the consumers issuing without turns (0.79-0.80);
// S(j + 1) issued as soon as PV(j - 1) is done, into a second set of S
// registers (0.94 / 1.10); two consumers in 128 rows and 64 rows three an
// SM (device 0.73 / 0.79 and 0.69 / 0.75 against 0.69 / 0.72). 128-key
// tiles are not built: they move the running max and the row sums 128 keys
// at a time, which changes a row's bits, so every width and block would
// have to move with them.
// The LSE adds one log2f and one 4-byte store per row (1 MB at that
// shape), after the last product. The rotation reads 8 table bytes per q element from L2
// (151 MB at that shape, from a 2.4 MB table) and does 3 fp32 operations
// per element before the first product.

#include <math.h>
#include <stdint.h>

#include "flash_fwd_sm90.cuh"
#include "sm90_common.cuh"

namespace {

constexpr int kBK = 64;                            // keys per tile
constexpr int kRows = 64;                          // query rows per consumer warpgroup
constexpr int kProducerRegs = 24;                  // a producer thread's after setmaxnreg
constexpr uint32_t kSmemSm = 233472;  // shared memory of an SM (1024 of it reserved a block)
constexpr int kBarFirst = 1;                       // named barrier kBarFirst + c: consumer c's turn
constexpr float kClamp = 55.f;  // exponent clamp of the static-max kernel (nats)
constexpr float kPackTop = 32768.f;  // fp16 static max: a row's packed p stays below 2^15
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  const void* q;    // (B, Sq, Hq, D) of the operand type T, as k and v
  const void* k;
  const void* v;
  const int* mask;  // (B, Sk) int32 or null
  void* out;        // T
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
  int q_tiles;   // the K/V-resident block's 64-row Q tiles a block (`resident_tiles`)
};

// -- the block ----------------------------------------------------------------------

// A block by its consumer warpgroups (kCons, 64 query rows at a time each)
// and the blocks to be resident on an SM (kBlocks): the launch bound, the
// registers setmaxnreg hands the consumers, and the block's share of the
// SM's shared memory. The SM's 65536 registers go to the resident threads
// (in 8s, at most 255 a thread); of a block's, 24 a thread to the producer
// warpgroup and the rest to the consumers, at most 240 a thread. kTiles != 0
// makes it the K/V-resident block: 64-row Q tiles of one (batch, q head) a
// block, kTiles of them or, with kTilesAtLaunch, as many as `resident_tiles`
// gives the call, which its consumers take in turn from a ring of two
// stages a consumer.
constexpr int kTilesAtLaunch = -1;
template <int kCons, int kBlocks, int kTiles = 0>
struct Block {
  static_assert(kTiles <= 0 || kTiles % kCons == 0, "every consumer takes as many Q tiles");
  static constexpr int kQTiles = kTiles, kConsumers = kCons;
  static constexpr bool kKvResident = kTiles != 0;
  // query rows per block (the K/V-resident block: at launch, 0 here)
  static constexpr int kBQ = kRows * (kKvResident ? (kTiles > 0 ? kTiles : 0) : kCons);
  static constexpr int kQBox = kKvResident ? kRows : kBQ;  // rows of a Q load
  static constexpr int kQStages = 2 * kCons;  // the K/V-resident block's Q ring
  static constexpr int kThreads = 128 * (1 + kCons);  // producer warpgroup + consumers
  static constexpr int kLaunchRegs =
      65536 / (kThreads * kBlocks) / 8 * 8 < 248 ? 65536 / (kThreads * kBlocks) / 8 * 8 : 248;
  static constexpr int kFree = (kLaunchRegs * kThreads - 128 * kProducerRegs) / (128 * kCons);
  static constexpr int kConsumerRegs = kFree / 8 * 8 < 240 ? kFree / 8 * 8 : 240;
  static_assert(128 * kProducerRegs + 128 * kCons * kConsumerRegs <= kLaunchRegs * kThreads,
                "setmaxnreg hands out more registers than the block has");
  static constexpr uint32_t kSmem = kBlocks == 1 ? kSmemMax : kSmemSm / kBlocks - 1024;
  static constexpr int kPerSm = kBlocks;
  static constexpr int kBarRope = kBarFirst + kCons;  // kBarRope + c: consumer c's rotated rows
};

// -- shared memory ------------------------------------------------------------------

// Q, then the K/V ring (sm90_common.cuh) in the block's share of the SM:
// with the 192-row block 5 stages at head_dim 72, 96 and 128, 8 at 48 and
// 64. 80/72's 64-row block, three an SM, keeps Q's, K's and V's columns
// 64-79 in narrow atoms (3 stages).
template <int kDK, int kDN, class B>
using Ring = KvRing<B::kBQ, 1, kDK, kDN, B::kSmem, kDK % kAtomCols == 16 && B::kPerSm == 3>;

// The K/V-resident block's: a ring of kQStages 64-row Q tiles, then the
// kKvTiles K/V stages that hold all of a head's keys (Sk <= 256) from the
// block's start to its end (KvRing with the budget that fits exactly
// kKvTiles stages); past the ring's mbarriers, each Q stage's "full" (the
// producer's arrive and bytes) and "empty" (every thread of the consumer
// that took the tile). One an SM, whole atoms fit (two or three consumers:
// 196,608 or 229,376 bytes at 80/72); two an SM take Q's, K's and V's
// columns 64-79 in narrow atoms (kNarrow; a `--blocks` candidate).
constexpr int kKvTiles = 4;
template <int kDK, int kDN, int kQStages, bool kNarrow,
          class P = KvRing<kRows, kQStages, kDK, kDN, kSmemMax, kNarrow>>
struct QRing : KvRing<kRows, kQStages, kDK, kDN,
                      P::kAlign + P::kQBytes + kKvTiles * P::kStageBytes + 512, kNarrow> {
  using Base = KvRing<kRows, kQStages, kDK, kDN,
                      P::kAlign + P::kQBytes + kKvTiles * P::kStageBytes + 512, kNarrow>;
  static_assert(Base::kStages == kKvTiles, "one stage for each key tile");
  static constexpr uint32_t kQBars = Base::kBytes - Base::kAlign;
  static constexpr uint32_t kBytes = Base::kBytes + 16 * kQStages;
  __device__ static uint32_t q_full(int i) { return kQBars + 8 * i; }
  __device__ static uint32_t q_empty(int i) { return kQBars + 8 * (kQStages + i); }
};

template <int kDK, int kDN, class B, bool = (B::kQTiles != 0)>
struct SmemOf {
  using type = Ring<kDK, kDN, B>;
};
template <int kDK, int kDN, class B>
struct SmemOf<kDK, kDN, B, true> {
  using type = QRing<kDK, kDN, B::kQStages, (kDK % kAtomCols == 16 && B::kPerSm > 1)>;
};
template <int kDK, int kDN, class B>
using Smem = typename SmemOf<kDK, kDN, B>::type;

// PV's width: kDN, or 80 where V's columns 64-79 are a narrow atom (n64 +
// n16 products; columns 72-79 of V arrive as zeros)
template <class L, int kDN>
constexpr int kPvWidth = L::kNarrow ? kAtomCols + 16 : kDN;

// -- consumer -----------------------------------------------------------------------

// The per-logit chain of one tile, first half: s holds this thread's 32
// logits of rows g and g + 8 (s[4n + e]: key 8n + 2t + (e & 1), row g + 8 *
// (e >> 1)), `bits` the tile's key-valid bits (bit j: key j). Replaces s by
// the fp32 p and adds it to the row sums l; online, it first moves the
// running max m and scales l by alpha, which it returns for o (whose
// product of the previous tile may still be running). A tile whose keys
// are all valid (every tile but a ragged or masked one) skips the selects.
// fp16 static max: m holds the rows' scales sc, alpha their change, and s
// leaves as p * sc (see the header).
template <class T, bool kStaticMax>
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
    if constexpr (kIsF16<T>) {
      float mx[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      alpha[0] = alpha[1] = 1.f;
      if (__any_sync(0xffffffffu, mx[0] * m[0] >= kPackTop || mx[1] * m[1] >= kPackTop)) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          // max p >= 2^15 / 2^127: 14 - floor(log2 max p) lies in [-66, 126]
          if (mx[r] * m[r] >= kPackTop) {
            const float sc = pow2(14 - ilog2(mx[r]));
            alpha[r] = sc / m[r];  // a power of two; 0 when it underflows (o was ~0)
            m[r] = sc;
          }
        }
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
  if constexpr (kStaticMax && kIsF16<T>) {
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) s[i] *= m[(i >> 1) & 1];
  }
}

// Second half, once the previous tile's PV has finished with o and the P
// registers: online, o *= alpha (fp16 static max: when a row's scale moved
// in the warp); then P as the hi/lo A fragments of PV.
template <class T, bool kStaticMax, int kN>
__device__ __forceinline__ void pack_tile(const float (&s)[kBK / 2], const float (&alpha)[2],
                                          float (&o)[kN], uint32_t (&phi)[4][4],
                                          uint32_t (&plo)[4][4]) {
  if (!kStaticMax ||
      (kIsF16<T> && __any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f))) {
#pragma unroll
    for (int i = 0; i < kN; ++i) o[i] *= alpha[(i >> 1) & 1];
  }
  pack_pair<T>(s, phi, plo);
}

// Rotates a consumer's 64 rows of the Q tile in place (`q_rows`: their first
// row in the swizzled atoms; `q_tail`: in the narrow atom, if L has one;
// `row0`: its query position): each thread takes whole 16-byte chunks, 4
// pairs (2i, 2i+1) of T, which never straddle a chunk. A chunk cc sits at
// chunk cc % 8 ^ (row % 8) of the row in atom cc / 8 (the 128-byte swizzle),
// or, past the whole atoms of a narrow Q, at chunk cc % 2 ^ (row / 4 % 2) of
// the narrow atom's 32-byte row (the 32-byte swizzle). Rows at or past Sq
// (zero-filled) and the columns past D are left as they are. The writes go
// through the generic proxy: each thread fences them for the async proxy
// (wgmma), and the warpgroup waits for all of them on its own named barrier.
template <class T, class L, int kBarRope>
__device__ __forceinline__ void rotate_q(unsigned char* q_rows, unsigned char* q_tail, int row0,
                                         int c, int tid, const Params& p) {
  const int chunks = p.D / 8;
  for (int i = tid; i < kRows * chunks; i += 128) {
    const int r = i / chunks, cc = i - r * chunks;
    const int row = row0 + r;
    if (row >= p.Sq) continue;
    const bool narrow = L::kNarrow && cc / 8 == L::kWideK;
    uint4* at = reinterpret_cast<uint4*>(
        narrow ? q_tail + r * kNarrowRow + ((cc % 2 ^ r / 4 % 2) << 4)
               : q_rows + (cc / 8) * L::kQAtom + r * kSwizzle + ((cc % 8 ^ r % 8) << 4));
    const float4* cs = reinterpret_cast<const float4*>(p.rope_cos + (long long)row * p.D + 8 * cc);
    const float4* sn = reinterpret_cast<const float4*>(p.rope_sin + (long long)row * p.D + 8 * cc);
    const float4 c0 = __ldg(cs), c1 = __ldg(cs + 1), s0 = __ldg(sn), s1 = __ldg(sn + 1);
    const float cf[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
    const float sf[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    const uint4 x = *at;
    uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float x0 = Elem<T>::lo(w[j]), x1 = Elem<T>::hi(w[j]);
      w[j] = Elem<T>::pack(__fadd_rn(__fmul_rn(x0, cf[2 * j]), __fmul_rn(x1, sf[2 * j])),
                           __fadd_rn(__fmul_rn(x1, cf[2 * j + 1]), __fmul_rn(x0, sf[2 * j + 1])));
    }
    *at = make_uint4(w[0], w[1], w[2], w[3]);
  }
  fence_async_smem();
  bar_sync<128>(kBarRope + c);
}

// S(j) = Q K(j)^T of this consumer's rows (q_addr; q_tail: its rows in Q's
// narrow atom) over the K tile of stage st
template <class L, int kDK, class T>
__device__ __forceinline__ void qk_tile(float (&s)[kBK / 2], uint32_t q_addr, uint32_t q_tail,
                                        uint32_t base, int st) {
  if constexpr (L::kNarrow)
    qk_narrow<kDK, L::kQAtom, L::kAtom, T>(s, q_addr, base + L::k(st), q_tail,
                                           base + L::k_tail(st));
  else
    qk<kDK, L::kQAtom, L::kAtom, T>(s, q_addr, base + L::k(st));
}

// O += P(j) V(j) over the V tile of stage st (o: kPvWidth / 2 a thread)
template <class L, int kDN, class T, int kN>
__device__ __forceinline__ void pv_tile(float (&o)[kN], const uint32_t (&phi)[4][4],
                                        const uint32_t (&plo)[4][4], uint32_t base, int st) {
  if constexpr (L::kNarrow)
    mma_pair_narrow<L::kAtom, T>(o, phi, plo, base + L::v(st), base + L::v_tail(st));
  else
    mma_pair<kDN, L::kAtom, T>(o, phi, plo, base + L::v(st));
}

// The epilogue of a K/V-resident consumer's 64 rows from query position
// row0 (the other blocks' stores from registers: the end of the kernel's
// consumer loop): O / l in T written over the tile's own Q stage (q_rows;
// q_tail: its narrow atom), in Q's swizzled atoms, then stored by one TMA
// box per atom, which writes no row at or past Sq and no column at or past
// D; the row's LSE, where the pointer is set, from registers. Gives the
// stage back (its "empty" mbarrier) once the stores have read it.
template <class T, bool kStaticMax, class L, int kBar, int kN>
__device__ __forceinline__ void store_rows(const float (&o)[kN], float (&l)[2],
                                           const float (&m)[2], unsigned char* q_rows,
                                           unsigned char* q_tail, uint32_t q_empty, int row0,
                                           int h, int b, int c, int tid, const CUtensorMap* to,
                                           const CUtensorMap* to2, const Params& p) {
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = 16 * warp + lane / 4 + 8 * r, row = row0 + rr;
    // l and m are the same on the row's quad: its first lane writes the LSE,
    // whose base is the running max or the bound, both in log2 units
    if (p.lse != nullptr && lane % 4 == 0 && row < p.Sq)
      p.lse[((long long)b * p.Hq + h) * p.Sq + row] =
          l[r] > 0.f ? kLn2 * ((kStaticMax ? p.bound2 : m[r]) + log2f(l[r])) : -INFINITY;
    // fp16 static max: o holds p * sc (l * sc lies in [2^14, 2^32])
    const float den = kStaticMax && kIsF16<T> ? l[r] * m[r] : l[r];
    const float inv = l[r] > 0.f ? 1.f / den : 0.f;
#pragma unroll
    for (int n = 0; n < kN / 4; ++n) {
      // columns 8n + 2t, +1: 16-byte chunk n % 8 of atom n / 8, swizzled by
      // the row (128-byte rows), or of the narrow atom (32-byte rows)
      const bool narrow = L::kNarrow && n / 8 == L::kWideK;
      unsigned char* at =
          narrow ? q_tail + rr * kNarrowRow + ((n % 2 ^ rr / 4 % 2) << 4)
                 : q_rows + (n / 8) * L::kQAtom + rr * kSwizzle + ((n % 8 ^ rr % 8) << 4);
      *reinterpret_cast<uint32_t*>(at + 4 * (lane % 4)) =
          Elem<T>::pack(o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv);
    }
  }
  fence_async_smem();
  bar_sync<128>(kBar + c);
  if (tid == 0) {
    if (row0 < p.Sq) {  // a tile past Sq stores nothing
      const uint32_t q = smem_addr(q_rows);
      for (int a = 0; a < L::kWideK; ++a)
        tma_store(to, q + a * L::kQAtom, kAtomCols * a, h, row0, b);
      if (L::kNarrow) tma_store(to2, smem_addr(q_tail), kAtomCols * L::kWideK, h, row0, b);
      bulk_commit();
      bulk_wait_read<0>();
    }
    mbar_arrive(q_empty);
  }
}

// The rounds of a K/V-resident block's consumers: its 64-row Q tiles past
// q0, at most p.q_tiles, rounded up to a whole round (a tile past Sq is
// computed on what its stage holds and not written)
template <class Bk>
__device__ __forceinline__ int resident_rounds(int q0, const Params& p) {
  const int tiles = min(p.q_tiles, (p.Sq - q0 + kRows - 1) / kRows);
  return (tiles + Bk::kConsumers - 1) / Bk::kConsumers;
}

// A K/V-resident block's consumer on one 64-row Q tile (q_addr; q_tail:
// its rows in Q's narrow atom) over the nk resident key tiles: the other
// blocks' per-tile sequence (the consumer loop of flash_fwd_sm90_kernel,
// kept there as it is so that their code does not change), the same
// products and chain in the same order. Leaves O unnormalised in o, the row
// sums in l and the running max (fp16 static max: the rows' scales) in m.
// `last`: the consumer's last tile of the block (the last consumer's final
// product then ends the turns: consumer 0 has no later one).
template <class T, bool kStaticMax, int kDK, int kDN, class L, int kConsumers, int kN>
__device__ __forceinline__ void attend_rows(float (&o)[kN], float (&l)[2], float (&m)[2],
                                            uint32_t q_addr, uint32_t q_tail, uint32_t base,
                                            const unsigned long long* bits, int nk, int c,
                                            int tid, bool last, const Params& p) {
  constexpr int kStages = L::kStages;
  // two or more consumers issue their products in turn: 0, 1, ..., kConsumers - 1,
  // 0, ...; a lone one (whose turns are the block's) waits for no barrier
  constexpr bool kTurns = kConsumers > 1;
  const int mine = kBarFirst + c, other = kBarFirst + (c + 1) % kConsumers;
#pragma unroll
  for (int i = 0; i < kN; ++i) o[i] = 0.f;
  // m: the running max (online), or the rows' scales (fp16 static max)
  const float m0 = kStaticMax && kIsF16<T> ? pow2(127) : -INFINITY;
  l[0] = l[1] = 0.f;
  m[0] = m[1] = m0;
  float s[kBK / 2];
  uint32_t phi[4][4], plo[4][4];
  float alpha[2];

  mbar_wait(base + L::full(0), 0);
  if (kTurns) bar_sync(mine);
  wgmma_fence();
  qk_tile<L, kDK, T>(s, q_addr, q_tail, base, 0);
  wgmma_commit();
  if (kTurns) bar_arrive(other);
  wgmma_wait<0>();
  pin(s);
  exp_tile<T, kStaticMax>(s, bits[0], tid % 4, l, m, alpha, p);
  pack_tile<T, kStaticMax, kN>(s, alpha, o, phi, plo);

  // Per tile j: S(j) = QK^T and O += P(j-1) V(j-1) in two wgmma groups;
  // the chain of S(j) runs as soon as the first group is done, beside the
  // second (FlashAttention-3's intra-warpgroup overlap), and packs P(j)
  // once the second is done with the P registers.
  for (int j = 1; j < nk; ++j) {
    const int st = j % kStages, prev = (j - 1) % kStages;
    mbar_wait(base + L::full(st), (j / kStages) & 1);
    if (kTurns) bar_sync(mine);
    pin(o);
    pin(phi);
    pin(plo);
    wgmma_fence();
    qk_tile<L, kDK, T>(s, q_addr, q_tail, base, st);
    wgmma_commit();
    pv_tile<L, kDN, T>(o, phi, plo, base, prev);
    wgmma_commit();
    if (kTurns) bar_arrive(other);
    wgmma_wait<1>();
    pin(s);
    exp_tile<T, kStaticMax>(s, bits[st], tid % 4, l, m, alpha, p);
    wgmma_wait<0>();
    pin(o);
    mbar_arrive(base + L::empty(prev));
    pack_tile<T, kStaticMax, kN>(s, alpha, o, phi, plo);
  }

  if (kTurns) bar_sync(mine);
  pin(o);
  pin(phi);
  pin(plo);
  wgmma_fence();
  pv_tile<L, kDN, T>(o, phi, plo, base, (nk - 1) % kStages);
  wgmma_commit();
  if (kTurns && !(last && c == kConsumers - 1)) bar_arrive(other);
  wgmma_wait<0>();
  pin(o);
}

// tq2, tk2 and tv2: Q's, K's and V's narrow atoms (unused without them); to
// and to2: the output's whole and narrow atoms (the K/V-resident block's
// stores)
template <class T, bool kStaticMax, int kDK, int kDN, int kCons, int kBlocks, int kTiles>
__global__ void __launch_bounds__(Block<kCons, kBlocks, kTiles>::kThreads, kBlocks)
    flash_fwd_sm90_kernel(const __grid_constant__ Params p, const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tq2,
                          const __grid_constant__ CUtensorMap tk2,
                          const __grid_constant__ CUtensorMap tv2,
                          const __grid_constant__ CUtensorMap to,
                          const __grid_constant__ CUtensorMap to2) {
  using Bk = Block<kCons, kBlocks, kTiles>;
  using L = Smem<kDK, kDN, Bk>;
  static_assert(L::kBK == kBK, "the chain's tile is the ring's");
  static_assert(L::kBytes <= Bk::kSmem, "the block's share of the SM");
  constexpr int kStages = L::kStages, kConsumers = kCons, kBQ = Bk::kBQ;
  constexpr bool kKvResident = Bk::kKvResident;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (smem_addr(smem) + L::kAlign - 1) & ~(L::kAlign - 1);
  unsigned long long* bits =
      reinterpret_cast<unsigned long long*>(smem + (base - smem_addr(smem)) + L::kBits);
  const int q0 = blockIdx.x * (kKvResident ? p.q_tiles * kRows : kBQ), h = blockIdx.y,
            b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int nk = (p.Sk + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    if constexpr (kKvResident) {
      for (int i = 0; i < Bk::kQStages; ++i) {
        mbar_init(base + L::q_full(i), 1);     // the producer's arrive + bytes
        mbar_init(base + L::q_empty(i), 1);    // the consumer's store of the tile's rows
      }
    } else {
      mbar_init(base + L::q_full(), 1);
    }
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
    if constexpr (!kKvResident) {
      if (lane == 0) {
        mbar_expect_tx(base + L::q_full(), L::kQBytes);
        for (int a = 0; a < L::kWideK; ++a)
          tma_load(base + L::kQ + a * L::kQAtom, &tq, base + L::q_full(), kAtomCols * a, h, q0,
                   b);
        if (L::kNarrow)
          tma_load(base + L::kQ + L::kQTailAt, &tq2, base + L::q_full(), kAtomCols * L::kWideK,
                   h, q0, b);
      }
      produce_kv<L>(base, bits, &tk, &tv, p.mask ? p.mask + b * p.m_sb : nullptr, p.Sk, hk, b,
                    lane, &tk2, &tv2);
    } else {
      // The K/V-resident block: Q tile i, in the order the consumers take
      // them, into Q stage i % kQStages once its consumer has given it back
      const auto load_q = [&](int i) {
        const int st = i % Bk::kQStages, row = q0 + i * kRows;
        mbar_wait(base + L::q_empty(st), ((i / Bk::kQStages) & 1) ^ 1);  // round 0 at once
        if (row >= p.Sq) {
          mbar_arrive(base + L::q_full(st));
          return;
        }
        mbar_expect_tx(base + L::q_full(st), L::kQTile);
        for (int a = 0; a < L::kWideK; ++a)
          tma_load(base + L::q(st) + a * L::kQAtom, &tq, base + L::q_full(st), kAtomCols * a, h,
                   row, b);
        if (L::kNarrow)
          tma_load(base + L::q(st) + L::kQTailAt, &tq2, base + L::q_full(st),
                   kAtomCols * L::kWideK, h, row, b);
      };
      const int tiles = resident_rounds<Bk>(q0, p) * kConsumers;
      // each consumer's first tile ahead of the keys (its first product needs both);
      // then the nk <= kStages key tiles, each into a stage of its own at once, to
      // stay there (no consumer waits for a refill); then the other Q tiles
      for (int i = 0; lane == 0 && i < kConsumers; ++i) load_q(i);
      produce_kv<L>(base, bits, &tk, &tv, p.mask ? p.mask + b * p.m_sb : nullptr, p.Sk, hk, b,
                    lane, &tk2, &tv2);
      for (int i = kConsumers; lane == 0 && i < tiles; ++i) load_q(i);
    }
  } else if constexpr (kKvResident) {
    // ---- consumers: 64-row Q tiles in turn ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(Bk::kConsumerRegs));
    const int c = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    constexpr int kN = kPvWidth<L, kDN> / 2;
    float o[kN], l[2], m[2];
    if (kConsumers > 1 && c == kConsumers - 1) bar_arrive(kBarFirst);  // consumer 0 issues first
    // consumer c takes the block's Q tiles c, c + kConsumers, ...: each
    // through the same products and chain over the resident K/V tiles, its
    // rows stored from its own stage
    const int rounds = resident_rounds<Bk>(q0, p);
    for (int t = 0; t < rounds; ++t) {
      const int i = t * kConsumers + c, st = i % Bk::kQStages, row0 = q0 + i * kRows;
      const uint32_t q_addr = base + L::q(st), q_tail = q_addr + L::kQTailAt;
      mbar_wait(base + L::q_full(st), (i / Bk::kQStages) & 1);
      if (p.rope_cos != nullptr)
        rotate_q<T, L, Bk::kBarRope>(smem + (q_addr - smem_addr(smem)),
                                     smem + (q_tail - smem_addr(smem)), row0, c, tid, p);
      attend_rows<T, kStaticMax, kDK, kDN, L, kConsumers>(o, l, m, q_addr, q_tail, base, bits,
                                                          nk, c, tid, t + 1 == rounds, p);
      store_rows<T, kStaticMax, L, Bk::kBarRope>(
          o, l, m, smem + (q_addr - smem_addr(smem)), smem + (q_tail - smem_addr(smem)),
          base + L::q_empty(st), row0, h, b, c, tid, &to, &to2, p);
    }
    if (tid == 0) bulk_wait_all();
  } else {
    // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(Bk::kConsumerRegs));
    const int c = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    // two or more consumers issue their products in turn: 0, 1, ..., kConsumers - 1,
    // 0, ...; a lone one (whose turns are the block's) waits for no barrier
    constexpr bool kTurns = kConsumers > 1;
    const int mine = kBarFirst + c, other = kBarFirst + (c + 1) % kConsumers;
    const uint32_t q_addr = base + L::kQ + c * kRows * kSwizzle;  // this warpgroup's rows
    const uint32_t q_tail = base + L::kQ + L::kQTailAt + c * kRows * kNarrowRow;

    constexpr int kN = kPvWidth<L, kDN> / 2;
    float o[kN];
#pragma unroll
    for (int i = 0; i < kN; ++i) o[i] = 0.f;
    // m: the running max (online), or the rows' scales (fp16 static max)
    const float m0 = kStaticMax && kIsF16<T> ? pow2(127) : -INFINITY;
    float l[2] = {0.f, 0.f}, m[2] = {m0, m0};
    float s[kBK / 2];
    uint32_t phi[4][4], plo[4][4];

    float alpha[2];

    if (kTurns && c == kConsumers - 1) bar_arrive(kBarFirst);  // consumer 0 issues first
    mbar_wait(base + L::q_full(), 0);
    if (p.rope_cos != nullptr)
      rotate_q<T, L, Bk::kBarRope>(smem + (q_addr - smem_addr(smem)),
                                   smem + (q_tail - smem_addr(smem)), q0 + c * kRows, c, tid, p);
    mbar_wait(base + L::full(0), 0);
    if (kTurns) bar_sync(mine);
    wgmma_fence();
    qk_tile<L, kDK, T>(s, q_addr, q_tail, base, 0);
    wgmma_commit();
    if (kTurns) bar_arrive(other);
    wgmma_wait<0>();
    pin(s);
    exp_tile<T, kStaticMax>(s, bits[0], tid % 4, l, m, alpha, p);
    pack_tile<T, kStaticMax, kN>(s, alpha, o, phi, plo);

    // Per tile j: S(j) = QK^T and O += P(j-1) V(j-1) in two wgmma groups;
    // the chain of S(j) runs as soon as the first group is done, beside the
    // second (FlashAttention-3's intra-warpgroup overlap), and packs P(j)
    // once the second is done with the P registers.
    for (int j = 1; j < nk; ++j) {
      const int st = j % kStages, prev = (j - 1) % kStages;
      mbar_wait(base + L::full(st), (j / kStages) & 1);
      if (kTurns) bar_sync(mine);
      pin(o);
      pin(phi);
      pin(plo);
      wgmma_fence();
      qk_tile<L, kDK, T>(s, q_addr, q_tail, base, st);
      wgmma_commit();
      pv_tile<L, kDN, T>(o, phi, plo, base, prev);
      wgmma_commit();
      if (kTurns) bar_arrive(other);
      wgmma_wait<1>();
      pin(s);
      exp_tile<T, kStaticMax>(s, bits[st], tid % 4, l, m, alpha, p);
      wgmma_wait<0>();
      pin(o);
      mbar_arrive(base + L::empty(prev));
      pack_tile<T, kStaticMax, kN>(s, alpha, o, phi, plo);
    }

    if (kTurns) bar_sync(mine);
    pin(o);
    pin(phi);
    pin(plo);
    wgmma_fence();
    pv_tile<L, kDN, T>(o, phi, plo, base, (nk - 1) % kStages);
    wgmma_commit();
    if (kTurns && c != kConsumers - 1) bar_arrive(other);  // consumer 0 has no later turn
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
      // fp16 static max: o holds p * sc (l * sc lies in [2^14, 2^32])
      const float den = kStaticMax && kIsF16<T> ? l[r] * m[r] : l[r];
      const float inv = l[r] > 0.f ? 1.f / den : 0.f;
      T* out = static_cast<T*>(p.out) + b * p.o_sb + (long long)row * p.o_ss + h * p.o_sh;
#pragma unroll
      for (int n = 0; n < kDN / 8; ++n) {
        const int col = 8 * n + 2 * (lane % 4);
        if (col >= p.D) break;
        *reinterpret_cast<uint32_t*>(out + col) =
            Elem<T>::pack(o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv);
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

// The products' depth and width, and the block, of an instantiation
template <int kDK, int kDN, int kCons, int kBlocks, int kTiles = 0>
struct Dims {
  static constexpr int kDepth = kDK, kWidth = kDN, kConsumers = kCons, kMinBlocks = kBlocks,
                       kQTiles = kTiles;
};

// The K/V-resident block's reach: at most kKvTiles key tiles, and at least
// kResidentRows query rows
constexpr int kResidentKeys = kKvTiles * kBK, kResidentRows = 512;

// The K/V-resident block's 64-row Q tiles a block at launch: each (batch, q
// head)'s tiles split evenly over as many blocks as one wave of the card's
// SMs leaves it (at least one), in whole rounds of kCons consumers
int resident_tiles(int B, int Hq, int Sq, int kCons) {
  static const int sms = [] {
    int device = 0, count = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
    return count > 0 ? count : 1;
  }();
  const int per_head = sms / (B * Hq) > 1 ? sms / (B * Hq) : 1;
  const int tiles = ((Sq + kRows - 1) / kRows + per_head - 1) / per_head;
  return (tiles + kCons - 1) / kCons * kCons;
}

// Calls `fn` with the Dims of the instantiation that runs head_dim d at Sq
// query rows over Sk keys: the depth and width of the header's Widths, the
// block of its Blocks (at 80/72 the K/V-resident block over at most 256
// keys and at least 512 query rows; 64 rows three an SM up to 80/72 over at
// most 1024 keys; else 192 rows one an SM).
template <class Fn>
int by_shape(int d, int sq, int sk, Fn fn) {
  const bool few_keys = sk <= 1024;
  if (d <= 48) return few_keys ? fn(Dims<48, 48, 1, 3>{}) : fn(Dims<48, 48, 3, 1>{});
  if (d <= 64) return few_keys ? fn(Dims<64, 64, 1, 3>{}) : fn(Dims<64, 64, 3, 1>{});
  if (d <= 72) {
    if (sk <= kResidentKeys && sq >= kResidentRows)
      return fn(Dims<80, 72, 2, 1, kTilesAtLaunch>{});
    return few_keys ? fn(Dims<80, 72, 1, 3>{}) : fn(Dims<80, 72, 3, 1>{});
  }
  if (d <= 96) return fn(Dims<96, 96, 3, 1>{});
  return fn(Dims<128, 128, 3, 1>{});
}

template <class T, bool kStaticMax, int kDK, int kDN, int kCons, int kBlocks, int kTiles>
int launch_dims(const Params& p, cudaStream_t stream) {
  using Bk = Block<kCons, kBlocks, kTiles>;
  using L = Smem<kDK, kDN, Bk>;
  // the K/V-resident block holds every key tile in a stage of its own
  if (Bk::kKvResident && (p.Sk + kBK - 1) / kBK > L::kStages) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tq2, tk2, tv2;
  if (!make_map<T>(&tq, p.q, p.B, p.Sq, p.Hq, p.D, p.q_sb, p.q_ss, p.q_sh, Bk::kQBox) ||
      !make_map<T>(&tk, p.k, p.B, p.Sk, p.Hkv, p.D, p.k_sb, p.k_ss, p.k_sh, kBK) ||
      !make_map<T>(&tv, p.v, p.B, p.Sk, p.Hkv, p.D, p.v_sb, p.v_ss, p.v_sh, kBK))
    return (int)cudaErrorInvalidValue;
  if (L::kNarrow) {
    if (!make_narrow_map<T>(&tq2, p.q, p.B, p.Sq, p.Hq, p.D, p.q_sb, p.q_ss, p.q_sh, Bk::kQBox) ||
        !make_narrow_map<T>(&tk2, p.k, p.B, p.Sk, p.Hkv, p.D, p.k_sb, p.k_ss, p.k_sh, kBK) ||
        !make_narrow_map<T>(&tv2, p.v, p.B, p.Sk, p.Hkv, p.D, p.v_sb, p.v_ss, p.v_sh, kBK))
      return (int)cudaErrorInvalidValue;
  } else {
    tq2 = tq;
    tk2 = tk;
    tv2 = tv;
  }
  CUtensorMap to = tq, to2 = tq2;  // the output, stored by the K/V-resident block
  if (Bk::kKvResident &&
      (!make_map<T>(&to, p.out, p.B, p.Sq, p.Hq, p.D, p.o_sb, p.o_ss, p.o_sh, kRows) ||
       (L::kNarrow &&
        !make_narrow_map<T>(&to2, p.out, p.B, p.Sq, p.Hq, p.D, p.o_sb, p.o_ss, p.o_sh, kRows))))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_fwd_sm90_kernel<T, kStaticMax, kDK, kDN, kCons, kBlocks, kTiles>;
  // the block's registers at launch must cover what setmaxnreg hands out,
  // or setmaxnreg.inc would wait for registers the block never gets
  static const int regs = launch_registers(kernel);
  if (regs * Bk::kThreads < 128 * (kProducerRegs + kCons * Bk::kConsumerRegs))
    return (int)cudaErrorLaunchOutOfResources;
  const int bytes = (int)L::kBytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  Params pk = p;
  pk.q_tiles = kTiles < 0 ? resident_tiles(p.B, p.Hq, p.Sq, kCons) : kTiles;
  const int rows = Bk::kKvResident ? pk.q_tiles * kRows : Bk::kBQ;
  dim3 grid((p.Sq + rows - 1) / rows, p.Hq, p.B);
  kernel<<<grid, Bk::kThreads, bytes, stream>>>(pk, tq, tk, tv, tq2, tk2, tv2, to, to2);
  return (int)cudaGetLastError();
}

template <class T, bool kStaticMax>
int launch(const Params& p, cudaStream_t stream) {
  return by_shape(p.D, p.Sq, p.Sk, [&](auto dims) {
    using X = decltype(dims);
    return launch_dims<T, kStaticMax, X::kDepth, X::kWidth, X::kConsumers, X::kMinBlocks,
                       X::kQTiles>(p, stream);
  });
}

template <class T, bool kStaticMax, int kDK, int kDN, int kCons, int kBlocks, int kTiles>
int attributes_dims(long long* out) {
  using Bk = Block<kCons, kBlocks, kTiles>;
  auto kernel = flash_fwd_sm90_kernel<T, kStaticMax, kDK, kDN, kCons, kBlocks, kTiles>;
  const int bytes = (int)Smem<kDK, kDN, Bk>::kBytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  cudaFuncAttributes a;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, Bk::kThreads, bytes);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = kProducerRegs;
  out[2] = Bk::kConsumerRegs;
  out[3] = (long long)a.localSizeBytes;
  out[4] = (long long)a.sharedSizeBytes + bytes;
  out[5] = blocks;
  out[6] = Bk::kThreads;
  out[7] = kDK;
  out[8] = kDN;
  out[9] = Bk::kBQ;  // 0: set at launch (`resident_tiles`)
  out[10] = Smem<kDK, kDN, Bk>::kStages;
  out[11] = kBlocks;
  out[12] = kCons;
  out[13] = Bk::kKvResident ? Bk::kQStages : 0;
  return 0;
}

}  // namespace

int flash_fwd_sm90(bool f16, bool static_max, const void* q, const void* k, const void* v,
                   const int* mask, void* out, float* lse, const float* rope_cos,
                   const float* rope_sin, const long long* meta, float scale, float bound,
                   void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.mask = mask;
  p.out = out;
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
  p.q_tiles = 0;  // set at launch for the K/V-resident block
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
  if (f16) return static_max ? launch<fp16, true>(p, s) : launch<fp16, false>(p, s);
  return static_max ? launch<bf16, true>(p, s) : launch<bf16, false>(p, s);
}

namespace {

template <class T>
int attributes(int static_max, int head_dim, int sq, int sk, long long* out) {
  return by_shape(head_dim, sq, sk, [&](auto dims) {
    using X = decltype(dims);
    return static_max ? attributes_dims<T, true, X::kDepth, X::kWidth, X::kConsumers,
                                        X::kMinBlocks, X::kQTiles>(out)
                      : attributes_dims<T, false, X::kDepth, X::kWidth, X::kConsumers,
                                        X::kMinBlocks, X::kQTiles>(out);
  });
}

}  // namespace

// The resources of the kernel that runs head_dim at Sq query rows over Sk
// keys, for bf16 (f16 = 0) or fp16 operands (14 values into out): registers
// per thread as compiled (the launch bound), the producer's and the
// consumers' registers after setmaxnreg, local-memory (spill) bytes per
// thread, shared memory per block, resident blocks per SM, threads per
// block, the products' depth and width, query rows per block, K/V stages,
// the blocks an SM it is built for, its consumer warpgroups and its Q
// ring's stages (0: one Q load a block). Launches nothing.
extern "C" int lumina_flash_fwd_sm90_attributes(int static_max, int head_dim, int sq, int sk,
                                                int f16, long long* out) {
  return f16 ? attributes<fp16>(static_max, head_dim, sq, sk, out)
             : attributes<bf16>(static_max, head_dim, sq, sk, out);
}

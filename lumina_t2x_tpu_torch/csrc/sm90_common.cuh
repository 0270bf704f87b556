// PTX helpers shared by the Hopper (sm_90a) attention kernels,
// flash_fwd_sm90.cu and flash_bwd_sm90.cu (and the fp32 kernels,
// flash_fwd_fp32_sm90.cu and flash_bwd_fp32_sm90.cu, which take its copies,
// mbarriers and exp2): TMA loads and reductions, row bulk copies and 4-byte
// cp.async, mbarriers, named barriers, wgmma descriptors and products, the
// operand types (bf16 and fp16: packing, wgmma and tensor-map types) and the
// hi/lo pair products, exp2, powers of two, the 4-D tensor maps, and the K/V ring
// (its shared-memory layout and its producer loop) that the forward kernel
// and the backward's dQ kernel both stream keys through. Everything here
// lives in an anonymous namespace, so each source that includes it gets its
// own copy and the library that links both has no duplicate symbols.

#pragma once

#include <cuda.h>  // CUtensorMap; its encoder is looked up in libcuda at run time
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
using fp16 = __half;

constexpr uint32_t kSmemMax = 232448;  // shared memory a block can use
constexpr int kSwizzle = 128;          // bytes per operand row in an atom
constexpr int kAtomCols = kSwizzle / 2;  // 2-byte (bf16, fp16) columns per atom
constexpr int kNarrowRow = 32;         // bytes per row of a narrow (16-column) atom
constexpr float kLog2e = 1.4426950408889634f;

// -- PTX ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// a box of a 4-D tensor map (coordinates innermost first) into shared
// memory; the barrier counts its bytes as they land (out-of-range elements
// are zero-filled and count too)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// adds a box of shared memory into a 4-D tensor map's elements in device
// memory (fp32 add in L2; elements out of range are skipped), in this
// thread's bulk group
__device__ __forceinline__ void tma_reduce_add(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                               int c2, int c3) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.4d.global.shared::cta.add.bulk_group"
      " [%0, {%1, %2, %3, %4}], [%5];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(src)
      : "memory");
}
// a box of shared memory into a 4-D tensor map's elements in device memory
// (elements out of range are not written), in this thread's bulk group
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%1, %2, %3, %4}], [%5];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(src)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// until at most kPending of this thread's bulk groups still read shared memory
template <int kPending>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(kPending) : "memory");
}
// until every bulk group of this thread has completed
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// orders this thread's shared-memory writes before later reads by the
// async proxy (wgmma operands, bulk copies)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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
// 4 bytes by cp.async, or 4 zero bytes when !full (src is not read), in
// this thread's current cp.async group
__device__ __forceinline__ void cp4(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(full ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// until at most kPending of this thread's cp.async groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// arrive and expect `bytes` more of asynchronous copies in this phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// until the phase of parity `parity` has completed
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

// named barrier `id` over kThreads threads: wait for all, or arrive only
template <int kThreads = 256>
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kThreads) : "memory");
}
template <int kThreads = 256>
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kThreads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// keep the compiler from moving accesses of wgmma operands across the asm
// that issues or waits for the product
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// wgmma matrix descriptor of an operand in 128-byte-swizzled atoms (layout
// type 1; 3: a narrow atom's 32-byte swizzle): start address, leading and
// stride byte offsets (16-byte units, 14 bits each), base offset 0 (atoms
// start on 1024-byte boundaries)
__device__ __forceinline__ uint64_t swz_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                             uint64_t layout = 1) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// 2^x in one MUFU.EX2 (results below 2^-126 flush to 0; ex2(-inf) = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 2^e exactly, for an integer e in [-126, 127]
__device__ __forceinline__ float pow2(int e) { return __int_as_float((127 + e) << 23); }
// floor(log2 x) of a normal positive float
__device__ __forceinline__ int ilog2(float x) { return ((__float_as_int(x) >> 23) & 0xff) - 127; }

// -- operand types -------------------------------------------------------------------
//
// The Hopper attention kernels take bf16 or fp16 operands (a template
// parameter T); both are 2 bytes wide, so tiles, swizzles, descriptors and
// fragment layouts are the same and only the conversions and the wgmma type
// differ. Elem<T>: two values packed in a 32-bit register (lo in the low
// half), the low and high value back as fp32, and the tensor-map type.
template <class T>
struct Elem;
template <>
struct Elem<bf16> {
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  __device__ static uint32_t pack(float lo, float hi) { return pack_bf16(lo, hi); }
  __device__ static float lo(uint32_t v) { return bf16_lo(v); }
  __device__ static float hi(uint32_t v) { return bf16_hi(v); }
};
template <>
struct Elem<fp16> {
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  __device__ static uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  __device__ static float lo(uint32_t v) {
    return __half2float(__ushort_as_half(static_cast<unsigned short>(v & 0xffffu)));
  }
  __device__ static float hi(uint32_t v) {
    return __half2float(__ushort_as_half(static_cast<unsigned short>(v >> 16)));
  }
};
template <class T>
constexpr bool kIsF16 = std::is_same<T, fp16>::value;

// -- wgmma products (fp32 accumulators, bf16 or fp16 operands) ---------------------
//
// ss: A (64 x 16) and B (16 x N) from shared memory through descriptors;
// kTA / kTB = 1 reads A / B MN-major (transposed), 0 K-major; `accumulate`
// = 0 overwrites d. rs: A from registers (the accumulator-to-fragment
// layout), B from shared memory MN-major, d += A B. Each takes the operand
// type T (bf16 by default): the same instruction as .bf16.bf16 or .f16.f16.

#define LUMINA_WG_D8 "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),      \
      "+f"(d[6]), "+f"(d[7])
#define LUMINA_WG_D24 "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),      \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),  \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
#define LUMINA_WG_D32 LUMINA_WG_D24, "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),          \
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define LUMINA_WG_D36 LUMINA_WG_D32, "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
#define LUMINA_WG_D48 LUMINA_WG_D36, "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),          \
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),  \
      "+f"(d[47])
#define LUMINA_WG_D64 LUMINA_WG_D48, "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),          \
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]),  \
      "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define LUMINA_WG_R8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define LUMINA_WG_R24 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "    \
  "%16, %17, %18, %19, %20, %21, %22, %23"
#define LUMINA_WG_R32 LUMINA_WG_R24 ", %24, %25, %26, %27, %28, %29, %30, %31"
#define LUMINA_WG_R36 LUMINA_WG_R32 ", %32, %33, %34, %35"
#define LUMINA_WG_R48 LUMINA_WG_R36 ", %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
#define LUMINA_WG_R64 LUMINA_WG_R48 ", %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, "   \
  "%59, %60, %61, %62, %63"

// the asm of one product, its operand type a string literal: TY "bf16" or "f16"
#define LUMINA_WG_SS(TY, N, R, D, NA, NB, NACC, TRANS)                                        \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #NACC ", 0;\n"                           \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " {" R              \
               "}, %" #NA ", %" #NB ", p, 1, 1, " TRANS ";\n}\n"                              \
               : D                                                                              \
               : "l"(desc_a), "l"(desc_b), "r"(accumulate))
#define LUMINA_WG_RS(TY, N, R, D, A0, A1, A2, A3, NB, NACC)                                    \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #NACC ", 0;\n"                           \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " {" R              \
               "}, {%" #A0 ", %" #A1 ", %" #A2 ", %" #A3 "}, %" #NB ", p, 1, 1, 1;\n}\n"        \
               : D                                                                              \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))

// d (64 x 64) = [d +] A B, both from shared memory, K-major
template <class T = bf16>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                             int accumulate) {
  if constexpr (kIsF16<T>)
    LUMINA_WG_SS("f16", 64, LUMINA_WG_R32, LUMINA_WG_D32, 32, 33, 34, "0, 0");
  else
    LUMINA_WG_SS("bf16", 64, LUMINA_WG_R32, LUMINA_WG_D32, 32, 33, 34, "0, 0");
}

// d (64 x N) = [d +] A B, both from shared memory and MN-major; N = 48, 64,
// 72, 96, 128 by d's size
template <class T = bf16>
__device__ __forceinline__ void wgmma_ss_tt(float (&d)[24], uint64_t desc_a, uint64_t desc_b,
                                            int accumulate) {
  if constexpr (kIsF16<T>)
    LUMINA_WG_SS("f16", 48, LUMINA_WG_R24, LUMINA_WG_D24, 24, 25, 26, "1, 1");
  else
    LUMINA_WG_SS("bf16", 48, LUMINA_WG_R24, LUMINA_WG_D24, 24, 25, 26, "1, 1");
}
template <class T = bf16>
__device__ __forceinline__ void wgmma_ss_tt(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                            int accumulate) {
  if constexpr (kIsF16<T>)
    LUMINA_WG_SS("f16", 64, LUMINA_WG_R32, LUMINA_WG_D32, 32, 33, 34, "1, 1");
  else
    LUMINA_WG_SS("bf16", 64, LUMINA_WG_R32, LUMINA_WG_D32, 32, 33, 34, "1, 1");
}
template <class T = bf16>
__device__ __forceinline__ void wgmma_ss_tt(float (&d)[36], uint64_t desc_a, uint64_t desc_b,
                                            int accumulate) {
  if constexpr (kIsF16<T>)
    LUMINA_WG_SS("f16", 72, LUMINA_WG_R36, LUMINA_WG_D36, 36, 37, 38, "1, 1");
  else
    LUMINA_WG_SS("bf16", 72, LUMINA_WG_R36, LUMINA_WG_D36, 36, 37, 38, "1, 1");
}
template <class T = bf16>
__device__ __forceinline__ void wgmma_ss_tt(float (&d)[48], uint64_t desc_a, uint64_t desc_b,
                                            int accumulate) {
  if constexpr (kIsF16<T>)
    LUMINA_WG_SS("f16", 96, LUMINA_WG_R48, LUMINA_WG_D48, 48, 49, 50, "1, 1");
  else
    LUMINA_WG_SS("bf16", 96, LUMINA_WG_R48, LUMINA_WG_D48, 48, 49, 50, "1, 1");
}
template <class T = bf16>
__device__ __forceinline__ void wgmma_ss_tt(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                            int accumulate) {
  if constexpr (kIsF16<T>)
    LUMINA_WG_SS("f16", 128, LUMINA_WG_R64, LUMINA_WG_D64, 64, 65, 66, "1, 1");
  else
    LUMINA_WG_SS("bf16", 128, LUMINA_WG_R64, LUMINA_WG_D64, 64, 65, 66, "1, 1");
}

// d (64 x N) += A (registers) B (shared memory, MN-major); N = 16, 48, 64,
// 72, 96, 128 by d's size
template <class T = bf16>
__device__ __forceinline__ void wgmma_rs_n(float (&d)[8], const uint32_t (&a)[4], uint64_t desc_b) {
  if constexpr (kIsF16<T>)
    LUMINA_WG_RS("f16", 16, LUMINA_WG_R8, LUMINA_WG_D8, 8, 9, 10, 11, 12, 13);
  else
    LUMINA_WG_RS("bf16", 16, LUMINA_WG_R8, LUMINA_WG_D8, 8, 9, 10, 11, 12, 13);
}
template <class T = bf16>
__device__ __forceinline__ void wgmma_rs_n(float (&d)[24], const uint32_t (&a)[4], uint64_t desc_b) {
  if constexpr (kIsF16<T>)
    LUMINA_WG_RS("f16", 48, LUMINA_WG_R24, LUMINA_WG_D24, 24, 25, 26, 27, 28, 29);
  else
    LUMINA_WG_RS("bf16", 48, LUMINA_WG_R24, LUMINA_WG_D24, 24, 25, 26, 27, 28, 29);
}
template <class T = bf16>
__device__ __forceinline__ void wgmma_rs_n(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  if constexpr (kIsF16<T>)
    LUMINA_WG_RS("f16", 64, LUMINA_WG_R32, LUMINA_WG_D32, 32, 33, 34, 35, 36, 37);
  else
    LUMINA_WG_RS("bf16", 64, LUMINA_WG_R32, LUMINA_WG_D32, 32, 33, 34, 35, 36, 37);
}
template <class T = bf16>
__device__ __forceinline__ void wgmma_rs_n(float (&d)[36], const uint32_t (&a)[4], uint64_t desc_b) {
  if constexpr (kIsF16<T>)
    LUMINA_WG_RS("f16", 72, LUMINA_WG_R36, LUMINA_WG_D36, 36, 37, 38, 39, 40, 41);
  else
    LUMINA_WG_RS("bf16", 72, LUMINA_WG_R36, LUMINA_WG_D36, 36, 37, 38, 39, 40, 41);
}
template <class T = bf16>
__device__ __forceinline__ void wgmma_rs_n(float (&d)[48], const uint32_t (&a)[4], uint64_t desc_b) {
  if constexpr (kIsF16<T>)
    LUMINA_WG_RS("f16", 96, LUMINA_WG_R48, LUMINA_WG_D48, 48, 49, 50, 51, 52, 53);
  else
    LUMINA_WG_RS("bf16", 96, LUMINA_WG_R48, LUMINA_WG_D48, 48, 49, 50, 51, 52, 53);
}
template <class T = bf16>
__device__ __forceinline__ void wgmma_rs_n(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
  if constexpr (kIsF16<T>)
    LUMINA_WG_RS("f16", 128, LUMINA_WG_R64, LUMINA_WG_D64, 64, 65, 66, 67, 68, 69);
  else
    LUMINA_WG_RS("bf16", 128, LUMINA_WG_R64, LUMINA_WG_D64, 64, 65, 66, 67, 68, 69);
}

template <int kDN, class T = bf16>
__device__ __forceinline__ void wgmma_rs(float (&o)[kDN / 2], const uint32_t (&a)[4],
                                         uint64_t v_desc) {
  wgmma_rs_n<T>(o, a, v_desc);
}

// S = A B^T over depth kDK in k-steps of 16 columns (32 bytes): step kk
// reads atom kk / 4 of A and B at byte kk % 4 * 32 of each 128-byte row;
// both K-major, SBO = 8 rows (LBO is not used within an atom). kAtomA and
// kAtomB are the byte strides of the two operands' 64-column atoms.
template <int kDK, uint32_t kAtomA, uint32_t kAtomB, class T = bf16>
__device__ __forceinline__ void qk(float (&s)[32], uint32_t a_addr, uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < kDK / 16; ++kk) {
    constexpr int kSteps = kAtomCols / 16;  // k-steps per atom
    const uint32_t at = kk % kSteps * 32;
    wgmma_ss_n64<T>(s, swz_desc(a_addr + kk / kSteps * kAtomA + at, 16, 8 * kSwizzle),
                 swz_desc(b_addr + kk / kSteps * kAtomB + at, 16, 8 * kSwizzle), kk > 0);
  }
}

// qk() over a depth whose last 16 columns (kDK % 64 == 16) lie in narrow
// atoms, A's at a_tail and B's at b_tail: rows of 32 bytes, 32-byte swizzled
// (TMA's SWIZZLE_32B, layout type 3), SBO = 8 rows = 256 bytes. The same
// products in the same order as qk() over 64-column atoms.
template <int kDK, uint32_t kAtomA, uint32_t kAtomB, class T = bf16>
__device__ __forceinline__ void qk_narrow(float (&s)[32], uint32_t a_addr, uint32_t b_addr,
                                          uint32_t a_tail, uint32_t b_tail) {
  static_assert(kDK % kAtomCols == 16, "one narrow k-step after whole atoms");
  qk<kDK - 16, kAtomA, kAtomB, T>(s, a_addr, b_addr);
  wgmma_ss_n64<T>(s, swz_desc(a_tail, 16, 8 * kNarrowRow, 3),
                  swz_desc(b_tail, 16, 8 * kNarrowRow, 3), 1);
}

// -- hi/lo pairs --------------------------------------------------------------------
//
// x (a 64 x 64 accumulator: x[4n + e] at row g + 8 * (e >> 1), column
// 8n + 2t + (e & 1)) as the A fragments of four 16-column k-steps, split
// into the pair hi = T(x) and lo = T(x - hi): ~16 mantissa bits in bf16,
// ~22 in fp16 while x - hi stays above fp16's smallest normal, 2^-14 (the
// kernels keep what they pack at most 2^15; see each one's header)
template <class T = bf16>
__device__ __forceinline__ void pack_pair(const float (&x)[32], uint32_t (&hi)[4][4],
                                          uint32_t (&lo)[4][4]) {
  using E = Elem<T>;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const uint32_t top = E::pack(x[4 * n], x[4 * n + 1]);      // row g,     columns 8n + 2t, +1
    const uint32_t bot = E::pack(x[4 * n + 2], x[4 * n + 3]);  // row g + 8
    hi[n / 2][2 * (n % 2)] = top;
    hi[n / 2][2 * (n % 2) + 1] = bot;
    lo[n / 2][2 * (n % 2)] = E::pack(x[4 * n] - E::lo(top), x[4 * n + 1] - E::hi(top));
    lo[n / 2][2 * (n % 2) + 1] = E::pack(x[4 * n + 2] - E::lo(bot), x[4 * n + 3] - E::hi(bot));
  }
}

// acc (64 x kDN) += (A_hi + A_lo) B over 64 rows of K: A from registers, B
// (rows of 128 bytes per atom, atom stride kAtom) MN-major: LBO = the atom
// stride, SBO = 8 rows; slice kk starts 16 rows further. The forward's
// O += P V, the backward's dV += P^T dO, dK += dS^T Q and dQ += dS K.
template <int kDN, uint32_t kAtom, class T = bf16>
__device__ __forceinline__ void mma_pair(float (&acc)[kDN / 2], const uint32_t (&hi)[4][4],
                                         const uint32_t (&lo)[4][4], uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t desc = swz_desc(b_addr + kk * 16 * kSwizzle, kAtom, 8 * kSwizzle);
    wgmma_rs<kDN, T>(acc, hi[kk], desc);
    wgmma_rs<kDN, T>(acc, lo[kk], desc);
  }
}

// mma_pair() at width 80 over a B whose columns 64-79 lie in a narrow atom
// at b_tail (rows of 32 bytes, 32-byte swizzled, MN-major: SBO = 8 rows =
// 256 bytes): each slice as an n64 product over the 64-column atom into
// acc[0..31] and an n16 over the narrow one into acc[32..39] -- the columns
// and their sums of mma_pair<80>, in the same order
template <uint32_t kAtom, class T = bf16>
__device__ __forceinline__ void mma_pair_narrow(float (&acc)[40], const uint32_t (&hi)[4][4],
                                                const uint32_t (&lo)[4][4], uint32_t b_addr,
                                                uint32_t b_tail) {
  float(&wide)[32] = *reinterpret_cast<float(*)[32]>(&acc[0]);
  float(&tail)[8] = *reinterpret_cast<float(*)[8]>(&acc[32]);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t desc = swz_desc(b_addr + kk * 16 * kSwizzle, kAtom, 8 * kSwizzle);
    const uint64_t narrow = swz_desc(b_tail + kk * 16 * kNarrowRow, 0, 8 * kNarrowRow, 3);
    wgmma_rs_n<T>(wide, hi[kk], desc);
    wgmma_rs_n<T>(tail, hi[kk], narrow);
    wgmma_rs_n<T>(wide, lo[kk], desc);
    wgmma_rs_n<T>(tail, lo[kk], narrow);
  }
}

// whether the key of a thread's accumulator element i (x[4n + e]: key
// 8n + 2t + (e & 1)) is valid, from a tile's key-valid bits shifted right
// by 2t (bit j: key j)
__device__ __forceinline__ bool key_valid(unsigned long long bits, int i) {
  return ((bits >> (8 * (i / 4) + (i & 1))) & 1ull) != 0;
}

// -- tensor maps ------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up in libcuda (the library links the CUDA runtime only)
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(ptr);
  }();
  return fn;
}

// a (B, S, H, D) tensor of `esize`-byte elements with element strides sb,
// ss, sh as the 4-D TMA map (D, H, S, B), box `cols` columns x `rows` rows
// of one head. Strides in bytes must be multiples of 16, as the callers
// check.
bool make_map_4d(CUtensorMap* map, CUtensorMapDataType type, int esize, const void* ptr, int B,
                 int S, int H, int D, long long sb, long long ss, long long sh, int cols, int rows,
                 CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)(sh * esize), (cuuint64_t)(ss * esize),
                                 (cuuint64_t)(sb * esize)};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  EncodeTiled encode = encoder();
  return encode != nullptr &&
         encode(map, type, 4, const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a bf16 or fp16 (T) (B, S, H, D) tensor as one 128-byte-swizzled atom of
// a tile: box 64 columns x `rows` rows; columns past D and rows past S
// arrive as zeros
template <class T = bf16>
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int D, long long sb,
              long long ss, long long sh, int rows) {
  return make_map_4d(map, Elem<T>::kMap, 2, ptr, B, S, H, D, sb, ss, sh, kAtomCols, rows,
                     CU_TENSOR_MAP_SWIZZLE_128B);
}

// the same tensor as one narrow atom: box 16 columns x `rows` rows, 32-byte
// swizzled
template <class T = bf16>
bool make_narrow_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int D, long long sb,
                     long long ss, long long sh, int rows) {
  return make_map_4d(map, Elem<T>::kMap, 2, ptr, B, S, H, D, sb, ss, sh, kNarrowRow / 2, rows,
                     CU_TENSOR_MAP_SWIZZLE_32B);
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

// -- the K/V ring -------------------------------------------------------------------
//
// Shared memory of a block that loads kQTiles tiles of kBQ query rows once
// (the forward: Q; the dQ kernel: Q, then dO) and streams 64-key K and V
// tiles through a ring of stages. Each tile is stored in atoms of 64
// columns x rows (128-byte swizzled rows), one TMA box per atom: columns
// 0-63, 64-127; columns past D arrive as zeros. With kNarrow (a depth kDK
// of 64n + 16 and a width kDN of 64n + 8 or 16: the forward's 80/72) the
// last atom of Q, K and V is narrow, 16 columns x rows of 32 bytes, 32-byte
// swizzled (columns 64-79; 72-79 arrive as zeros; V MN-major, a key's 16
// columns a row): a row of each takes 160 bytes instead of 256, and a 64-key
// stage 20,480 bytes instead of 32,768. After the ring, per stage, the tile's 64
// key-valid bits (u64); then the mbarriers q_full, full[], empty[]. The ring
// has as many stages as fit in kBudget bytes (a block's share of the SM: all
// it may take, or half or a third of the SM's when two or three blocks are
// to be resident), at most 8. Every atom starts on a 1024-byte boundary.
template <int kBQ, int kQTiles, int kDK, int kDN, uint32_t kBudget = kSmemMax,
          bool kNarrow_ = false>
struct KvRing {
  static constexpr int kBK = 64;  // keys per tile
  static constexpr bool kNarrow = kNarrow_;
  static_assert(!kNarrow || (kDK % kAtomCols == 16 && kDN % kAtomCols > 0 &&
                             kDN % kAtomCols <= 16),
                "a narrow atom holds the last 16 columns");
  static constexpr int kAtomsK = (kDK + kAtomCols - 1) / kAtomCols;
  static constexpr int kAtomsV = (kDN + kAtomCols - 1) / kAtomCols;
  static constexpr int kWideK = kNarrow ? kAtomsK - 1 : kAtomsK;  // Q's and K's whole atoms
  static constexpr uint32_t kQAtom = kBQ * kSwizzle, kAtom = kBK * kSwizzle;
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kQTailAt = kWideK * kQAtom;  // Q's narrow atom
  static constexpr uint32_t kQTile = kQTailAt + (kNarrow ? kBQ * kNarrowRow : 0);
  static constexpr uint32_t kQBytes = kQTiles * kQTile;
  static constexpr uint32_t kKTailAt = kWideK * kAtom;  // K's narrow atom in a stage
  static constexpr uint32_t kKBytes = kKTailAt + (kNarrow ? kBK * kNarrowRow : 0);
  static constexpr int kWideV = kNarrow ? kAtomsV - 1 : kAtomsV;  // V's whole atoms
  static constexpr uint32_t kVTailAt = kWideV * kAtom;  // V's narrow atom in a stage
  static constexpr uint32_t kVBytes = kVTailAt + (kNarrow ? kBK * kNarrowRow : 0);
  static constexpr uint32_t kStageBytes = kKBytes + kVBytes;
  static constexpr uint32_t kAlign = 1024;  // the dynamic base is rounded up to this
  static_assert(kQTile % kAlign == 0 && kKBytes % kAlign == 0, "atoms on 1024-byte boundaries");
  static constexpr int kFit = (kBudget - kAlign - kQBytes - 512) / kStageBytes;
  static constexpr int kStages = kFit < 8 ? kFit : 8;
  static_assert(kStages >= 3, "the ring needs at least 3 stages");
  static constexpr uint32_t kBits = kQBytes + kStages * kStageBytes;  // u64 per stage
  static constexpr uint32_t kBars = kBits + 8 * kStages;  // q_full, full[kStages], empty[kStages]
  static constexpr uint32_t kBytes = kAlign + kBars + 8 * (1 + 2 * kStages);
  static_assert(kBytes <= kBudget, "shared memory");
  __device__ static uint32_t q(int i) { return kQ + i * kQTile; }
  __device__ static uint32_t k(int st) { return kQBytes + st * kStageBytes; }
  __device__ static uint32_t k_tail(int st) { return kQBytes + st * kStageBytes + kKTailAt; }
  __device__ static uint32_t v(int st) { return kQBytes + st * kStageBytes + kKBytes; }
  __device__ static uint32_t v_tail(int st) { return v(st) + kVTailAt; }
  __device__ static uint32_t q_full() { return kBars; }
  __device__ static uint32_t full(int st) { return kBars + 8 * (1 + st); }
  __device__ static uint32_t empty(int st) { return kBars + 8 * (1 + kStages + st); }
};

// The producer warp's loop over the key tiles of a KvRing: for tile j, the
// warp's two ballots give its 64 key-valid bits (j0 + i < Sk and the mask,
// read one tile ahead), and lane 0 waits until the stage is free (its
// "empty" mbarrier, on which every consumer thread arrives), writes the
// bits beside it and loads K and V with TMA, one box per atom, counted by
// the stage's "full" mbarrier. The maps are (D, H, S, B) with a box of 64
// columns x 64 keys (tk_narrow, tv_narrow: K's and V's narrow atoms, 16
// columns, where the ring has them); keys past Sk arrive as zeros.
template <class L>
__device__ __forceinline__ void produce_kv(uint32_t base, unsigned long long* bits,
                                           const CUtensorMap* tk, const CUtensorMap* tv,
                                           const int* mask_row, int Sk, int hk, int b, int lane,
                                           const CUtensorMap* tk_narrow = nullptr,
                                           const CUtensorMap* tv_narrow = nullptr) {
  constexpr int kBK = L::kBK, kStages = L::kStages;
  const int nk = (Sk + kBK - 1) / kBK;
  // mask values of keys j0 + lane and j0 + 32 + lane
  int m0 = mask_row && lane < Sk ? mask_row[lane] : 1;
  int m1 = mask_row && 32 + lane < Sk ? mask_row[32 + lane] : 1;
  for (int j = 0; j < nk; ++j) {
    const int st = j % kStages, j0 = j * kBK;
    const unsigned w0 = __ballot_sync(0xffffffffu, j0 + lane < Sk && m0 != 0);
    const unsigned w1 = __ballot_sync(0xffffffffu, j0 + 32 + lane < Sk && m1 != 0);
    if (mask_row && j + 1 < nk) {
      m0 = j0 + kBK + lane < Sk ? mask_row[j0 + kBK + lane] : 0;
      m1 = j0 + kBK + 32 + lane < Sk ? mask_row[j0 + kBK + 32 + lane] : 0;
    }
    if (lane == 0) {
      mbar_wait(base + L::empty(st), ((j / kStages) & 1) ^ 1);  // round 0 passes at once
      bits[st] = (unsigned long long)w1 << 32 | w0;
      mbar_expect_tx(base + L::full(st), L::kStageBytes);
      for (int a = 0; a < L::kWideK; ++a)
        tma_load(base + L::k(st) + a * L::kAtom, tk, base + L::full(st), a * kAtomCols, hk, j0, b);
      if (L::kNarrow)
        tma_load(base + L::k_tail(st), tk_narrow, base + L::full(st), L::kWideK * kAtomCols, hk,
                 j0, b);
      for (int a = 0; a < L::kWideV; ++a)
        tma_load(base + L::v(st) + a * L::kAtom, tv, base + L::full(st), a * kAtomCols, hk, j0, b);
      if (L::kNarrow)
        tma_load(base + L::v_tail(st), tv_narrow, base + L::full(st), L::kWideV * kAtomCols, hk,
                 j0, b);
    }
  }
}

}  // namespace

// Tensor-core probe: a chain of perturbed (M, K) @ (K, N) products with the
// operands resident on chip, hand-written CUDA C++ for Hopper (sm_90a):
//   lumina_mma_chain <- _kernel (exps/mxu_k_quantum.py, launched by `_run`)
// The kernel of `lumina_t2x_tpu_torch/exps/mxu_k_quantum.py`.
//
// What it computes: out[M, N] = sum_{j < iters} bf16(f32(a) + f32(j) * 1e-6) @ w,
// fp32, with a (M, K) and w (K, N) bf16, row-major and contiguous. The
// perturbation is the JAX kernel's: f32(j) * 1e-6 and the add are rounded
// separately (__fmul_rn / __fadd_rn: no FMA contraction), and the sum is
// rounded once to bf16 (round to nearest even), so the A operand of every
// product equals JAX's bit for bit. It keeps the products from being
// hoisted out of the loop; the sum over j is carried in the accumulators.
//
// Design: the product is the Hopper forward's PV product (flash_fwd_sm90.cu),
// wgmma with A from registers. A block holds one A row tile (64 x K16, K16 =
// K rounded up to 16, zero-padded) and one w column tile (K16 x BN) in shared
// memory, copied once and kept for the whole loop, as the TPU kernel keeps
// both in VMEM. Two warpgroups read A's m64k16 fragments back with ldmatrix
// (the mma.sync A layout, which is wgmma's register A), perturb them in
// registers and issue wgmma.mma_async.m64nBNk16 against w, four k-steps a
// batch (one fence, one commit), one batch running while the next batch's
// fragments are prepared. The perturbation (unpack, 8 FADD, pack per k-step
// and thread) is spread over BN columns, up to 256 (mma.sync spread it over
// 32).
//
// w is stored transposed, K-major in 128-byte-swizzled atoms of 64 depth
// columns x BN rows: the forward's K operand layout (SBO = 8 rows, a k-step
// moves the start 32 bytes along the row). V's MN-major layout would take 64
// columns an atom whatever BN is, and at K = 1024 the A tile (129 KB) and one
// such atom (128 KB) exceed the 227 KB a block can use; K-major stores BN
// rows of K16 without padding, so BN <= 48 fits there, any BN <= 256 at K = 72.
//
// The grid fills the card: blocks over (64-row tiles, BN-column tiles, j
// slices). The host's plan (`mxu_k_quantum.plan`) picks BN among the
// instantiated widths (one product of width N rounded up to 8 where it fits,
// else column tiles) and splits the iterations j into slices until the grid
// has at least 10/11 of the card's SMs in blocks; inside a block the two
// warpgroups split the block's iterations over the same tiles. Sums combine
// in a fixed order, with no atomics: warpgroup 1's accumulators through
// shared memory into warpgroup 0's, then, with more than one slice, an fp32
// partial buffer (slices, M, N) that a second kernel sums in slice order.
// The output is the same from run to run.
//
// What bounds it on the card: 2*M*N*K*iters operations against 989 TFLOP/s
// (K = 72 runs as depth 80: 10/9 of that); the bytes (a, w, out once, the
// partials) are negligible. With every SM busy at every shape, the time per
// product at N = 64 / 72 / 80 / 128 reads how wgmma charges width and the
// K-sweep how it charges depth (in steps of 16).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <stdint.h>

#include "mma_probe_wgmma.cuh"
#include "sm90_common.cuh"
#include "warp_mma.cuh"

namespace {

constexpr int kRows = 64;                // rows of out per block (one wgmma M)
constexpr int kWarpgroups = 2;           // split the block's iterations
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kGroup = 4;                // k-steps a batch: one fence, one commit
constexpr int kMaxK = 1024;

__host__ __device__ constexpr int round16(int x) { return (x + 15) / 16 * 16; }

// Shared memory: the w tile's atoms from the 1024-byte-aligned base, then
// the A tile (row stride K16 + 8: the 8 rows of an ldmatrix in distinct
// banks), which warpgroup 1's accumulators overwrite once both are done.
// Must equal `mxu_k_quantum.shared_bytes`.
__host__ __device__ constexpr int w_atoms(int k) {
  return (round16(k) + kAtomCols - 1) / kAtomCols;
}
__host__ __device__ constexpr size_t a_bytes(int k, int bn) {
  return 2ull * kRows * (round16(k) + 8) > 4ull * kRows * bn ? 2ull * kRows * (round16(k) + 8)
                                                             : 4ull * kRows * bn;
}
__host__ __device__ constexpr size_t smem_bytes(int k, int bn) {
  return 1024 + (size_t)bn * kSwizzle * w_atoms(k) + a_bytes(k, bn);
}

template <int kBN>
__global__ void __launch_bounds__(kThreads, 1)
    mma_chain_kernel(const bf16* a, const bf16* w, float* out, int M, int N, int K, int iters,
                     int slices) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t raw = smem_addr(smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* tile = smem + (base - raw);
  const int k16 = round16(K), lda = k16 + 8;
  const uint32_t atom = kBN * kSwizzle;  // bytes of one 64-column atom of w
  bf16* As = reinterpret_cast<bf16*>(tile + w_atoms(K) * atom);
  const int m0 = blockIdx.x * kRows, n0 = blockIdx.y * kBN, slice = blockIdx.z;
  const bf16 zero = __float2bfloat16(0.f);

  for (int idx = threadIdx.x; idx < kRows * k16; idx += kThreads) {
    const int r = idx / k16, c = idx - r * k16;
    As[r * lda + c] = (m0 + r < M && c < K) ? a[(long long)(m0 + r) * K + c] : zero;
  }
  // w[c][n0 + n] at row n, column c of the transposed tile: atom c / 64,
  // 16-byte chunk (c % 64) / 8 swizzled by the row (128-byte pattern)
  for (int idx = threadIdx.x; idx < k16 * kBN; idx += kThreads) {
    const int c = idx / kBN, n = idx - c * kBN;
    const bf16 v = (c < K && n0 + n < N) ? w[(long long)c * N + n0 + n] : zero;
    *reinterpret_cast<bf16*>(tile + (c / kAtomCols) * atom + n * kSwizzle +
                             ((((c % kAtomCols) / 8) ^ (n % 8)) * 16) + (c % 8) * 2) = v;
  }
  fence_async_smem();  // the w tile is read by wgmma (the async proxy)
  __syncthreads();

  // this block's iterations, then this warpgroup's half of them. Both
  // warpgroups run `half` iterations, so that every count the loop tests is
  // the same for the whole block (a product issued under a condition that
  // depends on the thread makes ptxas serialize the products); warpgroup
  // 1's extra iteration, where the count is odd, and a last batch's steps
  // past the end multiply zero fragments.
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int jb = (int)((long long)slice * iters / slices);
  const int je = (int)((long long)(slice + 1) * iters / slices);
  const int half = (je - jb + 1) / 2;
  const int j0 = jb + wg * half, j1 = wg == 0 ? jb + half : je;

  const int warp = tid / 32, lane = tid % 32;
  const bf16* a_row = As + (16 * warp + lane % 16) * lda + (lane / 16) * 8;
  const int ksteps = k16 / 16;
  const int total = half * ksteps;

  float acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
  // the steps (j, kk) in order, kGroup a batch: its fragments loaded and
  // perturbed, one fence, its products, one commit; two batches of
  // fragment registers, so that one batch's products run while the next
  // batch's fragments are prepared
  uint32_t af[2][kGroup][4];
  int kks[kGroup];
  int j = j0, kk = 0;
  for (int s = 0; s < total; s += 2 * kGroup) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s0 = s + h * kGroup;
      if (s0 < total) {
        wgmma_wait<1>();  // the batch that read buffer h is done
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          warp_mma::ldmatrix_x4(af[h][g][0], af[h][g][1], af[h][g][2], af[h][g][3],
                                a_row + 16 * kk);
          const float pert = __fmul_rn((float)j, 1e-6f);
          const bool live = s0 + g < total && j < j1;
#pragma unroll
          for (int r = 0; r < 4; ++r)
            af[h][g][r] = live ? pack_bf16(__fadd_rn(bf16_lo(af[h][g][r]), pert),
                                           __fadd_rn(bf16_hi(af[h][g][r]), pert))
                               : 0u;
          kks[g] = kk;
          if (++kk == ksteps) {
            kk = 0;
            ++j;
          }
        }
        wgmma_fence();
#pragma unroll
        for (int g = 0; g < kGroup; ++g)
          wgmma_probe(acc, af[h][g],
                      swz_desc(base + (kks[g] / 4) * atom + (kks[g] % 4) * 32, 16, 8 * kSwizzle));
        wgmma_commit();
      }
    }
  }
  wgmma_wait<0>();
  pin(acc);

  // warpgroup 0 + warpgroup 1, in that order
  __syncthreads();  // both are done with A and w
  float* partner = reinterpret_cast<float*>(As);
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) partner[i * 128 + tid] = acc[i];
  }
  __syncthreads();
  if (wg != 0) return;
  float* dst = slices > 1 ? out + (long long)slice * M * N : out;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) {
    const int r = m0 + 16 * warp + g + 8 * ((i >> 1) & 1);
    const int c = n0 + 8 * (i / 4) + 2 * t + (i & 1);
    if (r < M && c < N) dst[(long long)r * N + c] = acc[i] + partner[i * 128 + tid];
  }
}

// out[i] = partial[0][i] + partial[1][i] + ... in slice order
__global__ void mma_chain_sum_kernel(const float* partial, float* out, long long count,
                                     int slices) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < count;
       i += (long long)gridDim.x * blockDim.x) {
    float s = partial[i];
    for (int z = 1; z < slices; ++z) s += partial[z * count + i];
    out[i] = s;
  }
}

template <int kBN>
int launch_bn(const bf16* a, const bf16* w, float* out, float* partial, int M, int N, int K,
              int iters, int slices, cudaStream_t stream) {
  const size_t bytes = smem_bytes(K, kBN);
  if (bytes > kSmemMax) return (int)cudaErrorInvalidValue;
  auto kernel = mma_chain_kernel<kBN>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((M + kRows - 1) / kRows, (N + kBN - 1) / kBN, slices);
  kernel<<<grid, kThreads, bytes, stream>>>(a, w, slices > 1 ? partial : out, M, N, K, iters,
                                            slices);
  err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return (int)err;
  const long long count = (long long)M * N;
  const int blocks = (int)((count + 255) / 256 < 1056 ? (count + 255) / 256 : 1056);
  mma_chain_sum_kernel<<<blocks, 256, 0, stream>>>(partial, out, count, slices);
  return (int)cudaGetLastError();
}

template <int kBN>
int attributes_bn(int k, long long* out) {
  const size_t bytes = smem_bytes(k, kBN);
  if (bytes > kSmemMax) return (int)cudaErrorInvalidValue;
  auto kernel = mma_chain_kernel<kBN>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, bytes);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (long long)attr.localSizeBytes;
  out[2] = (long long)attr.sharedSizeBytes + (long long)bytes;
  out[3] = blocks;
  out[4] = kThreads;
  return 0;
}

// the widths the plan may pick (`mxu_k_quantum.WIDTHS`)
#define LUMINA_PROBE_WIDTHS(X) \
  X(8) X(16) X(24) X(32) X(40) X(48) X(64) X(72) X(80) X(96) X(128) X(144) X(192) X(256)

}  // namespace

extern "C" {

// a (M, K) bf16, w (K, N) bf16, out (M, N) fp32, all row-major and
// contiguous; K <= 1024. The plan: bn, a width of LUMINA_PROBE_WIDTHS, and
// slices (1 <= slices <= max(iters, 1)); partial (slices, M, N) fp32 when
// slices > 1, else unused. Grid: ceil(M/64) x ceil(N/bn) x slices blocks of
// 256 threads, then the slices' sum. Returns the cudaError_t of the launches
// (0 on success).
int lumina_mma_chain(const void* a, const void* w, void* out, void* partial, int M, int N, int K,
                     int iters, int bn, int slices, void* stream) {
  if (M < 0 || N < 0 || K <= 0 || K > kMaxK || iters < 0 || slices < 1 ||
      slices > (iters > 1 ? iters : 1) || (slices > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  const bf16* pa = static_cast<const bf16*>(a);
  const bf16* pw = static_cast<const bf16*>(w);
  float* po = static_cast<float*>(out);
  float* pp = static_cast<float*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
#define LUMINA_PROBE_CASE(n) \
  case n:                    \
    return launch_bn<n>(pa, pw, po, pp, M, N, K, iters, slices, s);
    LUMINA_PROBE_WIDTHS(LUMINA_PROBE_CASE)
#undef LUMINA_PROBE_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// The compiled kernel's resources at width bn and depth k (5 values into
// out): registers per thread, local-memory (spill) bytes per thread, shared
// memory per block, resident blocks per SM, threads per block.
int lumina_mma_chain_attributes(int bn, int k, long long* out) {
  if (k <= 0 || k > kMaxK) return (int)cudaErrorInvalidValue;
  switch (bn) {
#define LUMINA_PROBE_CASE(n) \
  case n:                    \
    return attributes_bn<n>(k, out);
    LUMINA_PROBE_WIDTHS(LUMINA_PROBE_CASE)
#undef LUMINA_PROBE_CASE
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

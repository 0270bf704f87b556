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
// Design and what bounds it on the card. One block of 4 warps owns a 64 x 32
// tile of out (each warp 16 rows x 32 columns, four 8-column mma tiles).
// The block copies its A rows (64 x K) and W columns (K x 32) into shared
// memory once, zero-padded to K16 = K rounded up to 16 (at most 214 KB at
// K = 1024) and keeps them there for the whole loop, as the TPU kernel keeps
// both in VMEM. Each iteration reads the A fragments back with ldmatrix,
// perturbs them in registers, and runs mma.sync.m16n8k16 against W
// fragments read with ldmatrix.trans, accumulating in fp32 registers.
// mma.sync takes depth in steps of 16 and width in steps of 8, so K = 72
// runs as 80 here by construction (the tiles are zero-padded to K16) and
// N = 72 as exactly 9 8-column tiles (tiles past N are skipped): the
// instruction shape answers the TPU probe's question, and the sweeps show
// the rate this loop reaches, not the quantum. The perturbation (unpack,
// 8 FADD, pack per 16-wide k slice and warp, 4 products) is issued beside
// the products and caps that rate. Work:
// 2*M*N*K*iters operations against 989 TFLOP/s; the bytes (a, w, out once)
// are negligible. At small N the grid has few blocks (ceil(M/64) *
// ceil(N/32): 16 at N = 8), so fewer SMs than the card's 132 hold work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <stdint.h>

#include "warp_mma.cuh"

namespace {

using namespace warp_mma;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBM = 16 * kWarps;  // rows of out per block
constexpr int kBN = 32;           // columns of out per block
constexpr int kLDW = kBN + 8;     // W tile row stride: ldmatrix rows in distinct banks
constexpr int kMaxK = 1024;

__host__ __device__ constexpr int round16(int x) { return (x + 15) / 16 * 16; }

size_t smem_bytes(int k) {
  const int k16 = round16(k);
  return sizeof(bf16) * ((size_t)kBM * (k16 + 8) + (size_t)k16 * kLDW);
}

__global__ void __launch_bounds__(kThreads)
mma_chain_kernel(const bf16* a, const bf16* w, float* out, int M, int N, int K, int iters) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int k16 = round16(K);
  const int lda = k16 + 8;  // A tile row stride
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Ws = As + kBM * lda;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const bf16 zero = __float2bfloat16(0.f);

  for (int idx = threadIdx.x; idx < kBM * k16; idx += kThreads) {
    const int r = idx / k16, c = idx - r * k16;
    As[r * lda + c] = (m0 + r < M && c < K) ? a[(long long)(m0 + r) * K + c] : zero;
  }
  for (int idx = threadIdx.x; idx < k16 * kBN; idx += kThreads) {
    const int r = idx / kBN, c = idx - r * kBN;
    Ws[r * kLDW + c] = (r < K && n0 + c < N) ? w[(long long)r * N + n0 + c] : zero;
  }
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  // A: rows 0-15 of this warp at k 0-7 and 8-15; W: the transposed matrices of
  // k 0-7 and 8-15 at columns 8i..8i+7, then at columns 8i+8..8i+15
  const bf16* a_row = As + (16 * warp + lane % 16) * lda + (lane / 16) * 8;
  const bf16* w_row = Ws + (lane % 8 + ((lane / 8) % 2) * 8) * kLDW + (lane / 16) * 8;
  const int n_tiles = min(kBN / 8, (N - n0 + 7) / 8);  // 8-column tiles inside N

  float acc[kBN / 8][4];
#pragma unroll
  for (int i = 0; i < kBN / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int j = 0; j < iters; ++j) {
    const float pert = __fmul_rn((float)j, 1e-6f);
    for (int kk = 0; kk < k16 / 16; ++kk) {
      uint32_t af[4];
      ldmatrix_x4(af[0], af[1], af[2], af[3], a_row + 16 * kk);
#pragma unroll
      for (int r = 0; r < 4; ++r)
        af[r] = pack_bf16(__fadd_rn(bf16_lo(af[r]), pert), __fadd_rn(bf16_hi(af[r]), pert));
#pragma unroll
      for (int i = 0; i < kBN / 8; i += 2) {
        if (i >= n_tiles) break;
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4_trans(b0, b1, b2, b3, w_row + 16 * kk * kLDW + 8 * i);
        mma_bf16(acc[i], af, b0, b1);
        if (i + 1 < n_tiles) mma_bf16(acc[i + 1], af, b2, b3);
      }
    }
  }

  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < kBN / 8; ++i) {
    const int c = n0 + 8 * i + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + 16 * warp + g + 8 * half;
      if (r >= M) continue;
      if (c < N) out[(long long)r * N + c] = acc[i][2 * half];
      if (c + 1 < N) out[(long long)r * N + c + 1] = acc[i][2 * half + 1];
    }
  }
}

}  // namespace

extern "C" {

// a (M, K) bf16, w (K, N) bf16, out (M, N) fp32, all row-major and
// contiguous; K <= 1024. Grid: ceil(M/64) x ceil(N/32) blocks of 128 threads.
// Returns the cudaError_t of the launch (0 on success).
int lumina_mma_chain(const void* a, const void* w, void* out, int M, int N, int K, int iters,
                     void* stream) {
  if (M < 0 || N < 0 || K <= 0 || K > kMaxK || iters < 0) return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  const int bytes = (int)smem_bytes(K);
  cudaError_t err = cudaFuncSetAttribute(mma_chain_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  mma_chain_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(w), static_cast<float*>(out), M, N,
      K, iters);
  return (int)cudaGetLastError();
}

}  // extern "C"

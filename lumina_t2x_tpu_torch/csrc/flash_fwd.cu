// Flash-attention forward entry points, hand-written CUDA C++ for sm_90a,
// and the fp32 forward template.
//
// Replaces the Pallas TPU forward kernels of
// lumina_t2x_tpu/ops/flash_attention.py:
//   lumina_flash_small_kv   <- _flash_small_kv_kernel   (_flash_small_kv_impl)
//   lumina_flash_online     <- _flash_kernel_fused_sum  (_flash_attention_fwd_impl, static_max=None)
//   lumina_flash_static_max <- _flash_kernel_static_max (_flash_attention_fwd_impl, static_max=bound)
//   lumina_flash_online_lse <- _flash_kernel_res        (_flash_fwd_res_impl, static_max=None)
//   lumina_flash_static_max_lse <- _flash_kernel_res_static_max (_flash_fwd_res_impl, static_max=bound)
//   lumina_flash_rope       <- _flash_rope_kernel       (_flash_rope_fwd_impl, rotate_k=True)
//   lumina_flash_rope_q     <- _flash_rope_q_kernel     (_flash_rope_fwd_impl, rotate_k=False)
// Each entry point is a distinct C function so the Python wrapper can count
// its launches. For bf16 inputs every one launches the Hopper kernel of
// flash_fwd_sm90.cu (registers, exp2, a K/V ring; the LSE written from the
// consumers' registers; the rope entry points with q rotated in shared
// memory by the (Sq, D) tables, k rotated beforehand by rope_rotate.cu).
// The template here (kStaticMax, kEmitLse) runs fp32 inputs only: exact to
// fp32, for tests and an fp32 model: the audio app's FlagDiT-1D, which runs
// in fp32, calls it through `lumina_flash_small_kv`. The fp32 rope
// entry points take q and k already rotated (rope_rotate.cu, the same
// formula in fp32) and run the online template.
//
// What the template computes (the Pallas kernels' math, not their TPU
// mechanics):
//   s   = scale * q . k            over valid keys (kv_mask != 0, j < Sk)
//   p   = exp(s - m)               online running max m, with rescale, or
//   p   = exp(min(s - bound, 55))  with a fixed bound (kStaticMax)
//   out = sum_j p v_j / sum_j p    fp32 accumulation and output
//   lse = m + log(l) | bound + log(l)   (kEmitLse; plain (B, Hq, Sq) fp32)
// A query row whose keys are all masked outputs 0 and has lse = -inf.
//
// Layout: q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D), read in place from
// element strides (the last dim must be contiguous); GQA maps q head h to kv
// head h / (Hq / Hkv); the ragged last KV tile and q tile are masked here,
// nothing is padded in device memory.
//
// Design and what bounds it on the card. One block of 4 warps per (64-row
// q tile, q head, batch); the block streams 64-key K/V tiles through
// shared memory, S, P and the O accumulator live in shared memory, and
// thread pair (2r, 2r+1) runs row r's softmax and its share of the fp32
// FMA products. At the 2B shapes (B=2, H=32, S=4096, D=72) the forward does
// 4*B*H*S*S*D = 309 GFLOP, 4.6 ms at the 67 TFLOP/s fp32 rate outside the
// tensor cores; this plain design runs far from that (shared-memory round
// trips around every product).

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "flash_fwd_sm90.cuh"

namespace {

constexpr int kBQ = 64;        // q rows per block
constexpr int kBK = 64;        // keys per streamed tile
constexpr int kThreads = 128;  // 4 warps; thread pair (2r, 2r+1) owns row r
constexpr int kMaxHeadDim = 128;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const int* mask;  // (B, Sk) int32 or nullptr
  float* out;
  float* lse;       // (B, Hq, Sq) fp32 or nullptr
  int B, Sq, Sk, Hq, Hkv, D;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  long long m_sb;
  float scale;
  float bound;
};

struct Layout {
  // leading dims in floats; padded so rows do not all start in the same
  // shared-memory bank
  int qld, pld, sld, old_;
  size_t q_off, k_off, v_off, s_off, p_off, o_off, st_off, kv_off, total;

  __host__ __device__ explicit Layout(int d) {
    qld = d + 4;
    pld = kBK + 4;
    sld = kBK + 4;
    old_ = d + 4;
    size_t off = 0;
    auto take = [&off](size_t bytes) {
      size_t at = off;
      off += (bytes + 127) / 128 * 128;
      return at;
    };
    q_off = take(sizeof(float) * kBQ * qld);
    k_off = take(sizeof(float) * kBK * qld);
    v_off = take(sizeof(float) * kBK * qld);
    s_off = take(sizeof(float) * kBQ * sld);
    p_off = take(sizeof(float) * kBQ * pld);
    o_off = take(sizeof(float) * kBQ * old_);
    st_off = take(sizeof(float) * 2 * kBQ);  // running max, running sum
    kv_off = take(sizeof(int) * kBK);        // key-valid flags of the tile
    total = off;
  }
};

// Copy a (rows x D) tile starting at row `row0` of a (B, S, H, D) tensor into
// shared memory, zero-filling rows >= S.
__device__ void load_tile(float* dst, int ld, const float* src, long long sb, long long ss,
                          long long sh, int b, int h, int row0, int S, int rows, int D) {
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx - r * D;
    const int s = row0 + r;
    dst[r * ld + c] = s < S ? src[b * sb + (long long)s * ss + h * sh + c] : 0.f;
  }
}

// S (kBQ x kBK) = Q (kBQ x D) . K^T
__device__ void qk_tile(const float* Qs, const float* Ks, float* Ss, const Layout& L, int D) {
  const int r = threadIdx.x >> 1;
  const int j0 = (threadIdx.x & 1) * (kBK / 2);
  for (int c = 0; c < kBK / 2; ++c) {
    const int j = j0 + c;
    float acc = 0.f;
    for (int d = 0; d < D; ++d) acc = fmaf(Qs[r * L.qld + d], Ks[j * L.qld + d], acc);
    Ss[r * L.sld + j] = acc;
  }
}

// O (kBQ x D) += P (kBQ x kBK) . V (kBK x D)
__device__ void pv_tile(const float* Ps, const float* Vs, float* Os, const Layout& L, int D) {
  const int r = threadIdx.x >> 1;
  const int c0 = (threadIdx.x & 1) ? D / 2 : 0;
  const int c1 = (threadIdx.x & 1) ? D : D / 2;
  for (int c = c0; c < c1; ++c) {
    float acc = Os[r * L.old_ + c];
    for (int j = 0; j < kBK; ++j) acc = fmaf(Ps[r * L.pld + j], Vs[j * L.qld + c], acc);
    Os[r * L.old_ + c] = acc;
  }
}

template <bool kStaticMax, bool kEmitLse>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(p.D);
  float* Qs = reinterpret_cast<float*>(smem + L.q_off);
  float* Ks = reinterpret_cast<float*>(smem + L.k_off);
  float* Vs = reinterpret_cast<float*>(smem + L.v_off);
  float* Ss = reinterpret_cast<float*>(smem + L.s_off);
  float* Ps = reinterpret_cast<float*>(smem + L.p_off);
  float* Os = reinterpret_cast<float*>(smem + L.o_off);
  float* m_s = reinterpret_cast<float*>(smem + L.st_off);
  float* l_s = m_s + kBQ;
  int* kvalid = reinterpret_cast<int*>(smem + L.kv_off);

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int D = p.D;

  load_tile(Qs, L.qld, p.q, p.q_sb, p.q_ss, p.q_sh, b, h, q0, p.Sq, kBQ, D);
  for (int idx = threadIdx.x; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D;
    Os[r * L.old_ + (idx - r * D)] = 0.f;
  }
  if (threadIdx.x < kBQ) {
    m_s[threadIdx.x] = -INFINITY;
    l_s[threadIdx.x] = 0.f;
  }

  const int r = threadIdx.x >> 1;
  const int half = threadIdx.x & 1;
  const int jc0 = half * (kBK / 2);
  const int oc0 = half ? D / 2 : 0;
  const int oc1 = half ? D : D / 2;

  for (int j0 = 0; j0 < p.Sk; j0 += kBK) {
    __syncthreads();  // previous tile's K/V/P no longer read
    load_tile(Ks, L.qld, p.k, p.k_sb, p.k_ss, p.k_sh, b, hk, j0, p.Sk, kBK, D);
    load_tile(Vs, L.qld, p.v, p.v_sb, p.v_ss, p.v_sh, b, hk, j0, p.Sk, kBK, D);
    if (threadIdx.x < kBK) {
      const int j = j0 + threadIdx.x;
      kvalid[threadIdx.x] = (j < p.Sk) && (p.mask == nullptr || p.mask[b * p.m_sb + j] != 0);
    }
    __syncthreads();

    qk_tile(Qs, Ks, Ss, L, D);
    __syncthreads();

    // softmax update of row r over this thread's half of the tile
    const float* srow = Ss + r * L.sld;
    float* prow = Ps + r * L.pld;
    float alpha = 1.f;
    float m_new = 0.f;
    if constexpr (!kStaticMax) {
      float mx = -INFINITY;
      for (int c = 0; c < kBK / 2; ++c) {
        const int j = jc0 + c;
        if (kvalid[j]) mx = fmaxf(mx, srow[j] * p.scale);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_old = m_s[r];
      m_new = fmaxf(m_old, mx);
      alpha = (m_new == -INFINITY) ? 1.f : expf(m_old - m_new);
    }
    float lsum = 0.f;
    for (int c = 0; c < kBK / 2; ++c) {
      const int j = jc0 + c;
      float pj = 0.f;
      if (kvalid[j]) {
        const float s = srow[j] * p.scale;
        pj = kStaticMax ? expf(fminf(s - p.bound, 55.f)) : expf(s - m_new);
      }
      prow[j] = pj;
      lsum += pj;
    }
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    if constexpr (!kStaticMax) {
      for (int c = oc0; c < oc1; ++c) Os[r * L.old_ + c] *= alpha;
    }
    __syncwarp();
    if (half == 0) {
      if constexpr (!kStaticMax) m_s[r] = m_new;
      l_s[r] = l_s[r] * alpha + lsum;
    }
    __syncthreads();

    pv_tile(Ps, Vs, Os, L, D);
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < kBQ * D; idx += kThreads) {
    const int rr = idx / D;
    const int c = idx - rr * D;
    const int s = q0 + rr;
    if (s >= p.Sq) continue;
    const float l = l_s[rr];
    p.out[b * p.o_sb + (long long)s * p.o_ss + h * p.o_sh + c] = l > 0.f ? Os[rr * L.old_ + c] / l : 0.f;
  }
  if constexpr (kEmitLse) {
    if (threadIdx.x < kBQ && q0 + threadIdx.x < p.Sq) {
      const float l = l_s[threadIdx.x];
      const float base = kStaticMax ? p.bound : m_s[threadIdx.x];
      p.lse[((long long)b * p.Hq + h) * p.Sq + q0 + threadIdx.x] = l > 0.f ? base + logf(l) : -INFINITY;
    }
  }
}

// the fp32 template (bf16 takes flash_fwd_sm90.cu before reaching here)
template <bool kStaticMax, bool kEmitLse>
int launch(const void* q, const void* k, const void* v, const int* mask, void* out, float* lse,
           const long long* meta, float scale, float bound, void* stream) {
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
  p.scale = scale;
  p.bound = bound;
  if (p.D <= 0 || p.D > kMaxHeadDim || p.Hkv <= 0 || p.Hq % p.Hkv != 0 || p.Sk <= 0)
    return (int)cudaErrorInvalidValue;
  if (p.Sq == 0 || p.B == 0) return 0;
  const Layout L(p.D);
  auto kernel = flash_fwd_kernel<kStaticMax, kEmitLse>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.total);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.Sq + kBQ - 1) / kBQ, p.Hq, p.B);
  kernel<<<grid, kThreads, L.total, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// The two rope entry points: bf16 q unrotated, rotated by the Hopper
// kernel from the (Sq, D) tables; fp32 q already rotated (no tables), on
// the online template. k arrives as the entry point takes it (rotated by
// the caller for lumina_flash_rope).
int rope_forward(const void* q, const void* k, const void* v, const int* mask, void* out,
                 const float* rope_cos, const float* rope_sin, const long long* meta, float scale,
                 int is_bf16, void* stream) {
  if (is_bf16) {
    if (rope_cos == nullptr || rope_sin == nullptr) return (int)cudaErrorInvalidValue;
    return flash_fwd_sm90(false, q, k, v, mask, out, nullptr, rope_cos, rope_sin, meta, scale,
                          0.f, stream);
  }
  if (rope_cos != nullptr || rope_sin != nullptr) return (int)cudaErrorInvalidValue;
  return launch<false, false>(q, k, v, mask, out, nullptr, meta, scale, 0.f, stream);
}

}  // namespace

// Every entry point takes the same arguments. meta (int64[19]): B, Sq, Sk,
// Hq, Hkv, D, then element strides q (b, s, h), k (b, s, h), v (b, s, h),
// out (b, s, h), mask (b). mask may be null (every key valid); lse (B, Hq, Sq)
// fp32 is written only by the two *_lse entry points, bound read only by the
// two static_max ones. Each returns the cudaError_t of the launch (0 on
// success).
#define LUMINA_FLASH_ARGS                                                               \
  const void *q, const void *k, const void *v, const int *mask, void *out, float *lse, \
      const long long *meta, float scale, float bound, int is_bf16, void *stream

// The two rope entry points take the same meta and, instead of lse and
// bound, the (Sq, D) fp32 tables cos_full and sin_signed (contiguous): bf16
// q arrives unrotated with both tables, fp32 q rotated with neither (see
// rope_forward). lumina_flash_rope needs Sk == Sq and k rotated by the key
// positions; lumina_flash_rope_q takes k as it is.
#define LUMINA_FLASH_ROPE_ARGS                                                          \
  const void *q, const void *k, const void *v, const int *mask, void *out,             \
      const float *rope_cos, const float *rope_sin, const long long *meta, float scale, \
      int is_bf16, void *stream

extern "C" {

int lumina_flash_small_kv(LUMINA_FLASH_ARGS) {
  if (is_bf16)
    return flash_fwd_sm90(false, q, k, v, mask, out, nullptr, nullptr, nullptr, meta, scale, 0.f,
                          stream);
  return launch<false, false>(q, k, v, mask, out, nullptr, meta, scale, 0.f, stream);
}

int lumina_flash_online(LUMINA_FLASH_ARGS) {
  if (is_bf16)
    return flash_fwd_sm90(false, q, k, v, mask, out, nullptr, nullptr, nullptr, meta, scale, 0.f,
                          stream);
  return launch<false, false>(q, k, v, mask, out, nullptr, meta, scale, 0.f, stream);
}

int lumina_flash_static_max(LUMINA_FLASH_ARGS) {
  if (is_bf16)
    return flash_fwd_sm90(true, q, k, v, mask, out, nullptr, nullptr, nullptr, meta, scale, bound,
                          stream);
  return launch<true, false>(q, k, v, mask, out, nullptr, meta, scale, bound, stream);
}

int lumina_flash_online_lse(LUMINA_FLASH_ARGS) {
  if (is_bf16)
    return flash_fwd_sm90(false, q, k, v, mask, out, lse, nullptr, nullptr, meta, scale, 0.f,
                          stream);
  return launch<false, true>(q, k, v, mask, out, lse, meta, scale, 0.f, stream);
}

int lumina_flash_static_max_lse(LUMINA_FLASH_ARGS) {
  if (is_bf16)
    return flash_fwd_sm90(true, q, k, v, mask, out, lse, nullptr, nullptr, meta, scale, bound,
                          stream);
  return launch<true, true>(q, k, v, mask, out, lse, meta, scale, bound, stream);
}

int lumina_flash_rope(LUMINA_FLASH_ROPE_ARGS) {
  if (meta[2] != meta[1]) return (int)cudaErrorInvalidValue;  // Sk == Sq
  return rope_forward(q, k, v, mask, out, rope_cos, rope_sin, meta, scale, is_bf16, stream);
}

int lumina_flash_rope_q(LUMINA_FLASH_ROPE_ARGS) {
  return rope_forward(q, k, v, mask, out, rope_cos, rope_sin, meta, scale, is_bf16, stream);
}

}  // extern "C"

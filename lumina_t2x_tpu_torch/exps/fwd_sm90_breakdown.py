"""Where the time of the bf16 attention forward goes on the card
(`csrc/flash_fwd_sm90.cu`: K2 `flash_online` and K3 `flash_static_max` at
4096 keys, K1 `flash_small_kv` at the caption's 256 and 32).

    python -m lumina_t2x_tpu_torch.exps.fwd_sm90_breakdown

Builds variants of the kernel's source, each with one part taken out, and
times each at the 2B's query shape (B=2, Sq=4096, H=32, D=72, bf16, static
bound 16.14 and online) for each key length of the main path (`SKS`: the
self-attention's 4096, the sampler's 256 caption tokens, the served
worker's and the trainer's 32), beside one `scaled_dot_product_attention`
call on the same inputs. At the caption's key lengths it also times K1
itself: `flash_small_kv` by CUDA events around the wrapper, and its
kernel's device time under `torch.profiler` (the difference is the
wrapper's host time). The variants:

  kernel         the source as it is
  loads only     the consumers skip the products and the chain: what the
                 TMA ring and the barriers alone take
  compute only   the producer loads Q but no K/V tile (it arrives on each
                 stage's barrier at once): the products and the chain on
                 whatever the ring holds
  products only  compute only, without the chain: the tensor-core work
  P once         P rounded once to bf16: no lo product, no second pack

Only "kernel" computes the function; the others are timings. Each variant
is compiled with nvcc into `build/fwd_sm90_breakdown/` from the source with
`sm90_common.cuh` pasted in (the K/V ring's producer and the pair product
live there); the edits are checked, so a changed kernel fails here instead
of timing something else. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess

import torch

from ..ops import cuda_lib
from ..ops import flash_attention as fa
from . import device_label, device_ms, source_with_common, time_ms

B, S, H, D = 2, 4096, 32, 72
SKS = (4096, 256, 32)  # key lengths: self-attention, sampler captions, served / trainer captions
BOUND = 16.14
SOURCE = cuda_lib._CSRC / "flash_fwd_sm90.cu"
_BUILD = cuda_lib._BUILD_ROOT.parent / "fwd_sm90_breakdown"

# the parts of the source a variant takes out (each must occur once)
_LOOP_PRODUCTS = """      qk<kDK, L::kQAtom, L::kAtom, T>(s, q_addr, base + L::k(st));
      wgmma_commit();
      mma_pair<kDN, L::kAtom, T>(o, phi, plo, base + L::v(prev));
"""
_LOOP_EXP = "      exp_tile<T, kStaticMax>(s, bits[st], tid % 4, l, m, alpha, p);\n"
_LOOP_PACK = "      pack_tile<T, kStaticMax, kDN>(s, alpha, o, phi, plo);\n"
_KV_LOADS = """      mbar_expect_tx(base + L::full(st), L::kStageBytes);
      for (int a = 0; a < L::kAtomsK; ++a)
        tma_load(base + L::k(st) + a * L::kAtom, tk, base + L::full(st), a * kAtomCols, hk, j0, b);
      for (int a = 0; a < L::kAtomsV; ++a)
        tma_load(base + L::v(st) + a * L::kAtom, tv, base + L::full(st), a * kAtomCols, hk, j0, b);
"""
_NO_KV = "      mbar_arrive(base + L::full(st));\n"
_LO_PRODUCT = "    wgmma_rs<kDN, T>(acc, lo[kk], desc);\n"
_LO_PACK = """    lo[n / 2][2 * (n % 2)] = E::pack(x[4 * n] - E::lo(top), x[4 * n + 1] - E::hi(top));
    lo[n / 2][2 * (n % 2) + 1] = E::pack(x[4 * n + 2] - E::lo(bot), x[4 * n + 3] - E::hi(bot));
"""
_EDITS = {
    "kernel": [],
    "loads only": [(_LOOP_PRODUCTS, ""), (_LOOP_EXP, ""), (_LOOP_PACK, "")],
    "compute only": [(_KV_LOADS, _NO_KV)],
    "products only": [(_KV_LOADS, _NO_KV), (_LOOP_EXP, ""), (_LOOP_PACK, "")],
    "P once": [(_LO_PRODUCT, ""), (_LO_PACK, "")],
}
# each variant exports the launcher under a C name (bf16 K2/K3: no LSE, no rotation)
_ENTRY = """
extern "C" int breakdown_fwd(int static_max, const void* q, const void* k, const void* v,
                             const int* mask, void* out, const long long* meta, float scale,
                             float bound, void* stream) {
  return flash_fwd_sm90(false, static_max != 0, q, k, v, mask, out, nullptr, nullptr, nullptr,
                        meta, scale, bound, stream);
}
"""


def kernel_source() -> str:
    """The kernel's source with the shared header pasted in: what the variants edit."""
    return source_with_common(SOURCE)


def variant_source(name: str, source: str) -> str:
    """The kernel's source (`kernel_source()`) with variant `name`'s parts
    taken out."""
    for old, new in _EDITS[name]:
        if source.count(old) != 1:
            raise RuntimeError(f"variant {name!r}: the kernel source changed; update its edits")
        source = source.replace(old, new)
    return source + _ENTRY


def build(names) -> dict:
    """{variant: ctypes library}, compiled in parallel (once per source)."""
    source = kernel_source()
    jobs = {}
    for name in names:
        text = variant_source(name, source)
        out = _BUILD / hashlib.sha256(text.encode()).hexdigest()[:16] / "libvariant.so"
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            (out.parent / "variant.cu").write_text(text)
            flags = [f for f in cuda_lib._NVCC_FLAGS if f not in ("-Xptxas", "-v")]
            jobs[name] = (out, subprocess.Popen(
                [cuda_lib.nvcc(), *flags, "-shared", "-I", str(cuda_lib._CSRC), "-o", str(out),
                 str(out.parent / "variant.cu")], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
        else:
            jobs[name] = (out, None)
    libs = {}
    for name, (out, proc) in jobs.items():
        if proc is not None:
            _, err = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on variant {name!r}:\n{err}")
        lib = ctypes.CDLL(str(out))
        lib.breakdown_fwd.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
        lib.breakdown_fwd.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main():
    if not torch.cuda.is_available():
        raise SystemExit("fwd_sm90_breakdown times CUDA kernel variants: it needs a CUDA device")
    device = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    libs = build(list(_EDITS))
    g = torch.Generator(device=device).manual_seed(0)
    q = torch.randn(B, S, H, D, generator=g, device=device).to(torch.bfloat16)
    out = torch.empty_like(q)
    scale = D ** -0.5
    for sk in SKS:
        k, v = (torch.randn(B, sk, H, D, generator=g, device=device).to(torch.bfloat16)
                for _ in range(2))
        meta = fa._fwd_meta(q, k, v, out, None)
        sdpa = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale=scale), device)
        print(f"{device_label(device)}; B={B} Sq={S} Sk={sk} H={H} D={D} bf16; "
              f"scaled_dot_product_attention {sdpa:.3f} ms", flush=True)
        if not fa.streams_kv(sk):  # K1's key lengths: the wrapper and its kernel
            k1 = lambda: fa.flash_small_kv(q, k, v, None, scale)
            dev = device_ms(k1, "flash_fwd_sm90")
            print(f"flash_small_kv (K1) {time_ms(k1, device):.3f} ms by CUDA events around the "
                  f"wrapper, " + (f"{dev:.3f} ms" if dev is not None else "not traced")
                  + " of its kernel's device time a call under torch.profiler", flush=True)
        for name, lib in libs.items():
            ms = {}
            for static_max in (True, False):
                def call():
                    err = lib.breakdown_fwd(int(static_max), q.data_ptr(), k.data_ptr(),
                                            v.data_ptr(), None, out.data_ptr(), meta, scale, BOUND,
                                            torch.cuda.current_stream(device).cuda_stream)
                    if err:
                        raise RuntimeError(f"variant {name!r}: cudaError {err}")
                ms[static_max] = time_ms(call, device)
            print(f"{name:14s} Sk={sk:4d} static max {ms[True]:.3f} ms, online {ms[False]:.3f} ms",
                  flush=True)


if __name__ == "__main__":
    main()

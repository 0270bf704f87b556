"""Where the time of the bf16 flash-attention backward goes on the card
(`csrc/flash_bwd_sm90.cu`, K6 `flash_bwd_fused` and K8 `flash_bwd_dkv`;
K7 `flash_bwd_dq` timed whole).

    python -m lumina_t2x_tpu_torch.exps.bwd_sm90_breakdown

Builds variants of the kernel's source, each with one part taken out, and
times each at the 2B training shape (B=2, S=4096, H=32, D=72, bf16), as the
fused sweep and as dK/dV only (the K8 instantiation: no dQ), beside one
autograd backward of `scaled_dot_product_attention` on the same inputs.
It also times K7 itself at the trainer's key lengths (`DQ_SKS`: the
self-attention's 4096, the captions' 32): `flash_bwd_dq` by CUDA events
around the wrapper, and its kernel's device time under `torch.profiler`
(the difference is the wrapper's, mostly its eager delta). The variants:

  kernel         the source as it is
  loads only     the consumers skip the products, the chain and dQ: what the
                 TMA ring and the barriers alone take
  products only  the producer loads K and V but no Q/dO tile (it arrives on
                 each stage's barrier at once) and the consumers skip the
                 chain (exp2 and ds): the tensor-core work and the packing
  no dQ reduce   dQ is computed but not combined nor added into device memory
  P/dS once      P and dS rounded once to bf16: no lo products, no lo packs

Only "kernel" computes the function; the others are timings. Each variant
is compiled with nvcc into `build/bwd_sm90_breakdown/` from the source with
`sm90_common.cuh` pasted in (the pair products live there); the edits are
checked, so a changed kernel fails here instead of timing something else.
Needs a CUDA device and nvcc.
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
DQ_SKS = (4096, 32)  # K7's key lengths: self-attention, trainer captions
SOURCE = cuda_lib._CSRC / "flash_bwd_sm90.cu"
_BUILD = cuda_lib._BUILD_ROOT.parent / "bwd_sm90_breakdown"

# the parts of the source a variant takes out: (old, new) replaces text that
# occurs once; (start, end, new) replaces the span from start through end
_TILE_MATH = ("      wgmma_fence();\n      qk<kDK, L::kKAtom, L::kQAtom>(s, k_addr",
              "      pin(dk);\n      mbar_arrive(base + L::empty(st));\n",
              "      mbar_arrive(base + L::empty(st));\n")
_DQ_TILE = ("      if constexpr (kFusedDq) {\n        // dQ_c", "      if constexpr (false) {\n"
            "        // dQ_c")
_FIRST_FREE = ("    if (kFusedDq && c == 0) bar_arrive(kBarFree);  // staging tile 0 is free\n", "")
_QDO_LOADS = ("      if (lane == 0) {\n        mbar_expect_tx(base + L::full(st), L::kStageBytes);",
              "        mbar_arrive(base + L::full(st));\n      }\n",
              "      mbar_arrive(base + L::full(st));\n")
_CHAIN = [("      probs(s, stats, key_ok, t, p.scale2);\n", ""),
          ("      dscores(dp, s, stats + kBM, t, p.scale);\n", "")]
_ADD_DQ = ("        add_dq<kDN>(", "                    b);\n", "")
_ONCE = [("    wgmma_rs<kDN>(acc, lo[kk], desc);\n", ""),
         ("    lo[n / 2][2 * (n % 2)] = pack_bf16(x[4 * n] - bf16_lo(top), x[4 * n + 1] - "
          "bf16_hi(top));\n", ""),
         ("    lo[n / 2][2 * (n % 2) + 1] =\n        pack_bf16(x[4 * n + 2] - bf16_lo(bot), "
          "x[4 * n + 3] - bf16_hi(bot));\n", ""),
         ("        store_ds(base + L::ds(c, 1), dlo, row0, t);\n", ""),
         ("for (int lo = 0; lo < 2; ++lo)", "for (int lo = 0; lo < 1; ++lo)")]
_EDITS = {
    "kernel": [],
    "loads only": [_TILE_MATH, _DQ_TILE, _FIRST_FREE],
    "products only": [_QDO_LOADS, *_CHAIN],
    "no dQ reduce": [_ADD_DQ, _FIRST_FREE],
    "P/dS once": _ONCE,
}
# each variant exports the launcher under a C name
_ENTRY = """
extern "C" int breakdown_bwd(int fused, const void* q, const void* k, const void* v,
                             const int* mask, const void* dout, const float* lse,
                             const float* delta, void* dq, void* dk, void* dv,
                             const long long* meta, float scale, void* stream) {
  return flash_bwd_sm90(fused != 0, q, k, v, mask, dout, lse, delta, dq, dk, dv, meta, scale,
                        stream);
}
"""


def kernel_source() -> str:
    """The kernel's source with the shared header pasted in: what the variants edit."""
    return source_with_common(SOURCE)


def variant_source(name: str, source: str) -> str:
    """The kernel's source (`kernel_source()`) with variant `name`'s parts
    taken out."""
    for edit in _EDITS[name]:
        if len(edit) == 2:
            old, new = edit
            if source.count(old) != 1:
                raise RuntimeError(f"variant {name!r}: the kernel source changed; update its edits")
            source = source.replace(old, new)
        else:
            start, end, new = edit
            a = source.find(start)
            b = source.find(end, a)
            if source.count(start) != 1 or a < 0 or b < 0:
                raise RuntimeError(f"variant {name!r}: the kernel source changed; update its edits")
            source = source[:a] + new + source[b + len(end):]
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
        lib.breakdown_bwd.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 10 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_void_p]
        lib.breakdown_bwd.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main():
    if not torch.cuda.is_available():
        raise SystemExit("bwd_sm90_breakdown times CUDA kernel variants: it needs a CUDA device")
    device = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    libs = build(list(_EDITS))
    g = torch.Generator(device=device).manual_seed(0)
    q, k, v, dout = (torch.randn(B, S, H, D, generator=g, device=device).to(torch.bfloat16)
                     for _ in range(4))
    scale = D ** -0.5
    out, lse = fa.flash_online_lse(q, k, v, None, scale)
    delta = fa._bwd_delta(out, dout)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    meta = (ctypes.c_longlong * 28)(B, S, S, H, H, D, *q.stride()[:3], *k.stride()[:3],
                                    *v.stride()[:3], *dout.stride()[:3], *dq.stride()[:3],
                                    *dk.stride()[:3], *dv.stride()[:3], 0)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    ref = torch.nn.functional.scaled_dot_product_attention(*(t.transpose(1, 2) for t in leaves),
                                                           scale=scale)
    sdpa = time_ms(lambda: torch.autograd.grad(ref, leaves, dout.transpose(1, 2),
                                               retain_graph=True), device)
    print(f"{device_label(device)}; B={B} S={S} H={H} D={D} bf16; scaled_dot_product_attention "
          f"backward {sdpa:.3f} ms")
    for sk in DQ_SKS:
        ks, vs = (k, v) if sk == S else (
            torch.randn(B, sk, H, D, generator=g, device=device).to(torch.bfloat16)
            for _ in range(2))
        o, l = fa.flash_online_lse(q, ks, vs, None, scale)
        k7 = lambda: fa.flash_bwd_dq(q, ks, vs, None, o, l, dout, scale)
        dev = device_ms(k7, "flash_bwd_sm90_dq")
        print(f"flash_bwd_dq (K7) Sk={sk}: {time_ms(k7, device):.3f} ms by CUDA events around the "
              f"wrapper, " + (f"{dev:.3f} ms" if dev is not None else "not traced")
              + " of its kernel's device time a call under torch.profiler", flush=True)
    for name, lib in libs.items():
        ms = {}
        for fused in (True, False):
            def call():
                err = lib.breakdown_bwd(int(fused), q.data_ptr(), k.data_ptr(), v.data_ptr(), None,
                                        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                                        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), meta, scale,
                                        torch.cuda.current_stream(device).cuda_stream)
                if err:
                    raise RuntimeError(f"variant {name!r}: cudaError {err}")
            ms[fused] = time_ms(call, device)
        print(f"{name:14s} fused {ms[True]:.3f} ms, dK/dV only {ms[False]:.3f} ms", flush=True)


if __name__ == "__main__":
    main()

"""Flash-attention forward: hand-written Hopper kernels and their plain
PyTorch versions (counterpart of `lumina_t2x_tpu/ops/flash_attention.py`).

Four entry points, each with its own launch counter (`LAUNCHES`), each
standing in for one Pallas TPU forward kernel:

| entry point        | Pallas kernel (lumina_t2x_tpu/ops/flash_attention.py) |
| ------------------ | ------------------------------------------------------ |
| `flash_small_kv`   | `_flash_small_kv_kernel` (Sk <= 1024, caption cross-attn) |
| `flash_online`     | `_flash_kernel_fused_sum` (streaming, running max)      |
| `flash_static_max` | `_flash_kernel_static_max` (streaming, fixed bound)     |
| `flash_online_lse` | `_flash_kernel_res` (streaming + per-row log-sum-exp)   |

The CUDA C++ source is `lumina_t2x_tpu_torch/csrc/flash_fwd.cu`; it is built
with `nvcc` at first use into `build/kernels/<source hash>/` at the repository
root and bound through ctypes. A wrapper takes its plain version only for CPU
tensors; for CUDA tensors it launches the kernel or raises.

Contract shared by kernel and plain version: q (B, Sq, Hq, D), k/v
(B, Sk, Hkv, D), optional key mask (B, Sk) with nonzero on valid keys, GQA
q head h -> kv head h // (Hq / Hkv), runtime `scale`, fp32 accumulation,
P kept to fp32 precision (the Pallas kernels round it to v's dtype before
PV), output in q's dtype. A query row whose keys are all masked outputs 0 and has
LSE -inf (the JAX kernels disagree among themselves on such rows; the main
path never has them).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

from .attention import default_attn_scale

_NEG_INF = -2.3819763e38  # most-negative bf16-representable float32
# whole-KV threshold: Sk <= this takes the small-KV entry point
_SMALL_KV_MAX = 1024
# exponent clamp of the static-max kernel: exp(55) * 131072 keys stays far
# inside fp32 range
_STATIC_MAX_CLAMP = 55.0

# launches of each kernel; a wrapper adds one where it launches, nowhere else
LAUNCHES = {"small_kv": 0, "online": 0, "static_max": 0, "online_lse": 0}
# calls of the plain versions on CUDA tensors (the main path should make none)
PLAIN_CUDA_CALLS = {"count": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    PLAIN_CUDA_CALLS["count"] = 0


# -- static-max bound (inference slot) ----------------------------------------

_flash_static_max: Optional[float] = None


def set_flash_static_max(bound: Optional[float]) -> None:
    """Install (or clear, with None) the fixed softmax bound used by the
    streaming self-attention on the inference path."""
    global _flash_static_max
    _flash_static_max = float(bound) if bound is not None else None


def get_flash_static_max() -> Optional[float]:
    """The bound the next streaming call will use (the
    `LUMINA_FLASH_STATIC_MAX` env pin wins over the setting)."""
    v = os.environ.get("LUMINA_FLASH_STATIC_MAX", "")
    return float(v) if v else _flash_static_max


def streams_kv(sk: int) -> bool:
    """True when a call with Sk keys takes a streaming entry point (the only
    ones a static bound affects)."""
    return sk > _SMALL_KV_MAX


# -- plain versions ------------------------------------------------------------


def _logits(q, k, kv_mask, scale):
    """fp32 (B, Hkv, rep, Sq, Sk) scaled logits and the (B, 1, 1, 1, Sk)
    key-valid mask."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    qg = q.float().reshape(b, sq, hkv, hq // hkv, d)
    s = torch.einsum("bqhrd,bkhd->bhrqk", qg, k.float()) * scale
    if kv_mask is None:
        valid = torch.ones((b, 1, 1, 1, sk), dtype=torch.bool, device=q.device)
    else:
        valid = (kv_mask != 0)[:, None, None, None, :]
    return s.masked_fill(~valid, _NEG_INF), valid


def _finish(p, v, q, l):
    """out = (p @ v) / l, 0 where no key is valid; back to (B, Sq, Hq, D)."""
    b, sq, hq, d = q.shape
    pv = torch.einsum("bhrqk,bkhd->bqhrd", p, v.float())
    denom = l.permute(0, 3, 1, 2)[..., None]  # (B, Sq, Hkv, rep, 1)
    out = torch.where(denom > 0, pv / denom.clamp_min(1e-30), torch.zeros_like(pv))
    return out.reshape(b, sq, hq, d).to(q.dtype)


def _count_plain(q):
    if q.is_cuda:
        PLAIN_CUDA_CALLS["count"] += 1


def _exact_softmax_plain(q, k, v, kv_mask, scale):
    """Exact masked softmax attention in fp32: (out, lse (B, Hq, Sq))."""
    _count_plain(q)
    b, sq, hq, _ = q.shape
    s, valid = _logits(q, k, kv_mask, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1)  # (B, Hkv, rep, Sq)
    lse = torch.where(l > 0, m[..., 0] + torch.log(l), torch.full_like(l, float("-inf")))
    return _finish(p, v, q, l), lse.reshape(b, hq, sq)


def flash_small_kv_plain(q, k, v, kv_mask, scale):
    """Plain version of `flash_small_kv`: max, exp, sum, PV over all keys."""
    return _exact_softmax_plain(q, k, v, kv_mask, scale)[0]


def flash_online_plain(q, k, v, kv_mask, scale):
    """Plain version of `flash_online`: the online softmax is exact, so its
    plain version is the exact masked softmax."""
    return _exact_softmax_plain(q, k, v, kv_mask, scale)[0]


def flash_online_lse_plain(q, k, v, kv_mask, scale):
    """Plain version of `flash_online_lse`: (out, lse) with lse (B, Hq, Sq)
    fp32, -inf on fully masked rows."""
    return _exact_softmax_plain(q, k, v, kv_mask, scale)


def flash_static_max_plain(q, k, v, kv_mask, scale, bound):
    """Plain version of `flash_static_max`: p = exp(min(s - bound, 55)) with
    no running max and no rescale."""
    _count_plain(q)
    s, valid = _logits(q, k, kv_mask, scale)
    p = torch.exp(torch.clamp(s - bound, max=_STATIC_MAX_CLAMP))
    p = torch.where(valid, p, torch.zeros_like(p))
    return _finish(p, v, q, p.sum(dim=-1))


# -- the CUDA library ----------------------------------------------------------

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_lib = None
BUILD_INFO = {"seconds": None, "path": None, "compiled": False, "ptxas": ""}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not default.exists():
        raise RuntimeError("nvcc not found: the flash-attention kernels are built "
                           "from lumina_t2x_tpu_torch/csrc with the CUDA toolkit")
    return str(default)


def build_library():
    """Compile `csrc/*.cu` into a shared library keyed by a hash of the
    sources and flags (once per source version) and load it."""
    global _lib
    if _lib is not None:
        return _lib
    sources = sorted(_CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out_dir = _BUILD_ROOT / digest.hexdigest()[:16]
    lib_path = out_dir / "liblumina_flash.so"
    t0 = time.perf_counter()
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"liblumina_flash.{os.getpid()}.so"
        proc = subprocess.run([_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), *map(str, sources)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        BUILD_INFO["ptxas"] = proc.stderr
        BUILD_INFO["compiled"] = True
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    ptr = ctypes.c_void_p
    for name in LAUNCHES:  # q, k, v, mask, out, lse, meta, scale, bound, is_bf16, stream
        fn = getattr(lib, f"lumina_flash_{name}")
        fn.argtypes = [ptr] * 6 + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                                   ctypes.c_float, ctypes.c_int, ptr]
        fn.restype = ctypes.c_int
    BUILD_INFO["seconds"] = time.perf_counter() - t0
    BUILD_INFO["path"] = str(lib_path)
    _lib = lib
    return lib


def _launch(name, q, k, v, kv_mask, scale, bound=0.0, with_lse=False):
    """Check what the kernel takes, allocate the outputs and launch
    `lumina_flash_<name>` on the current stream; returns out or (out, lse).
    Tensors made here (contiguous copies, the int32 mask) may be freed while
    the kernel runs: the caching allocator reuses their memory only for work
    queued after it on the same stream."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash kernels take CUDA tensors (CPU tensors take the plain version)")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernels take bf16 or fp32 q/k/v of one dtype, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    b, sq, hq, d = q.shape
    _, sk, hkv, dk = k.shape
    if k.shape[0] != b or dk != d or d > 128 or sk == 0:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} (head_dim <= 128)")
    _check_gqa_heads(hq, hkv)
    lib = build_library()
    with torch.cuda.device(q.device):
        q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
        if kv_mask is not None:
            kv_mask = kv_mask.to(device=q.device, dtype=torch.int32).contiguous()
            if tuple(kv_mask.shape) != (b, sk):
                raise ValueError(f"kv_mask shape {tuple(kv_mask.shape)} != {(b, sk)}")
        out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
        lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) if with_lse else None
        meta = (ctypes.c_longlong * 19)(
            b, sq, sk, hq, hkv, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            kv_mask.stride(0) if kv_mask is not None else 0,
        )
        err = getattr(lib, f"lumina_flash_{name}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            kv_mask.data_ptr() if kv_mask is not None else None, out.data_ptr(),
            lse.data_ptr() if with_lse else None, meta, scale, bound,
            int(q.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash kernel {name} launch failed: cudaError {err}")
    LAUNCHES[name] += 1
    return (out, lse) if with_lse else out


def _scale(q, scale):
    return default_attn_scale(q.shape[-1]) if scale is None else float(scale)


# -- entry points ----------------------------------------------------------------


def flash_small_kv(q, k, v, kv_mask=None, scale: Optional[float] = None):
    """Single-pass attention for Sk <= 1024 (replaces `_flash_small_kv_kernel`)."""
    if not q.is_cuda:
        return flash_small_kv_plain(q, k, v, kv_mask, _scale(q, scale))
    return _launch("small_kv", q, k, v, kv_mask, _scale(q, scale))


def flash_online(q, k, v, kv_mask=None, scale: Optional[float] = None):
    """Streaming online-softmax attention (replaces `_flash_kernel_fused_sum`)."""
    if not q.is_cuda:
        return flash_online_plain(q, k, v, kv_mask, _scale(q, scale))
    return _launch("online", q, k, v, kv_mask, _scale(q, scale))


def flash_static_max(q, k, v, kv_mask=None, scale: Optional[float] = None, *, bound: float):
    """Streaming attention with a fixed softmax bound (replaces
    `_flash_kernel_static_max`)."""
    if not q.is_cuda:
        return flash_static_max_plain(q, k, v, kv_mask, _scale(q, scale), float(bound))
    return _launch("static_max", q, k, v, kv_mask, _scale(q, scale), bound=float(bound))


def flash_online_lse(q, k, v, kv_mask=None, scale: Optional[float] = None):
    """Streaming attention that also returns the per-row log-sum-exp as a
    (B, Hq, Sq) fp32 tensor (replaces `_flash_kernel_res`)."""
    if not q.is_cuda:
        return flash_online_lse_plain(q, k, v, kv_mask, _scale(q, scale))
    return _launch("online_lse", q, k, v, kv_mask, _scale(q, scale), with_lse=True)


def _check_gqa_heads(hq: int, hkv: int):
    if hq % hkv != 0:
        raise ValueError(f"GQA requires n_q_heads ({hq}) divisible by n_kv_heads ({hkv})")


def _route(q, k):
    """The JAX package's dispatch: Sk <= 1024 takes the small-KV entry point;
    longer KV streams, with the installed static bound when there is one.
    Returns (entry point name, keyword arguments)."""
    _check_gqa_heads(q.shape[2], k.shape[2])
    if k.shape[1] <= _SMALL_KV_MAX:
        return "small_kv", {}
    bound = get_flash_static_max()
    return ("online", {}) if bound is None else ("static_max", {"bound": bound})


def flash_attention(q, k, v, kv_mask=None, scale: Optional[float] = None):
    """Flash attention: the entry point `_route` picks."""
    name, kw = _route(q, k)
    return globals()[f"flash_{name}"](q, k, v, kv_mask, scale, **kw)


def flash_attention_plain(q, k, v, kv_mask=None, scale: Optional[float] = None):
    """`flash_attention` over the plain versions, on any device: the
    reference a run on the card compares the kernels with."""
    name, kw = _route(q, k)
    return globals()[f"flash_{name}_plain"](q, k, v, kv_mask, _scale(q, scale), **kw)


def flash_lse_range(q, k, v, kv_mask=None, scale: Optional[float] = None):
    """(max, min) over valid query rows of the attention log-sum-exp, as a
    (2,) fp32 tensor: the calibration probe of the static-max kernel
    (`lse >= rowmax(scaled logits)`). Fully masked rows (lse -inf) are left
    out of the min."""
    _, lse = flash_online_lse(q, k, v, kv_mask, scale)
    finite = torch.isfinite(lse)
    mx = lse.masked_fill(~finite, float("-inf")).amax()
    mn = lse.masked_fill(~finite, float("inf")).amin()
    return torch.stack([mx, mn])

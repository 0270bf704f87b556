"""Flash attention: hand-written Hopper kernels and their plain PyTorch
versions (counterpart of `lumina_t2x_tpu/ops/flash_attention.py`).

Eight entry points, each with its own launch counter (`LAUNCHES`), each
standing in for one Pallas TPU kernel:

| entry point            | Pallas kernel (lumina_t2x_tpu/ops/flash_attention.py)   |
| ---------------------- | -------------------------------------------------------- |
| `flash_small_kv`       | `_flash_small_kv_kernel` (Sk <= 1024, caption cross-attn) |
| `flash_online`         | `_flash_kernel_fused_sum` (streaming, running max)        |
| `flash_static_max`     | `_flash_kernel_static_max` (streaming, fixed bound)       |
| `flash_online_lse`     | `_flash_kernel_res` (streaming + per-row log-sum-exp)     |
| `flash_static_max_lse` | `_flash_kernel_res_static_max` (fixed bound + LSE)        |
| `flash_bwd_fused`      | `_bwd_fused_kernel` (one-sweep backward)                  |
| `flash_bwd_dq`         | `_bwd_dq_kernel` (two-kernel backward, dQ)                |
| `flash_bwd_dkv`        | `_bwd_dkv_kernel` (two-kernel backward, dK and dV)        |

The first three serve inference (no autograd); under autograd
`flash_attention` runs `_FlashAttention`, whose forward is `flash_online_lse`
or, with a train bound installed on a streaming call, `flash_static_max_lse`,
and whose backward is `flash_bwd_fused` or `flash_bwd_dq` + `flash_bwd_dkv`,
chosen by the JAX package's rule (`use_fused_bwd`).

The CUDA C++ sources are `lumina_t2x_tpu_torch/csrc/flash_{fwd,bwd}.cu`; they
are built with `nvcc` at first use into `build/kernels/<source hash>/` at the
repository root and bound through ctypes. A wrapper takes its plain version
only for CPU tensors; for CUDA tensors it launches the kernel or raises.

Contract shared by kernel and plain version: q (B, Sq, Hq, D), k/v
(B, Sk, Hkv, D), optional key mask (B, Sk) with nonzero on valid keys, GQA
q head h -> kv head h // (Hq / Hkv), runtime `scale`, fp32 accumulation,
P (and dS) kept to fp32 precision (the Pallas kernels round them to the
operand dtype), outputs in the inputs' dtypes. A query row whose keys are all
masked outputs 0, has LSE -inf and gets dQ 0 (the JAX kernels disagree among
themselves on such rows; the main path never has them).
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
_FWD_ENTRIES = ("small_kv", "online", "static_max", "online_lse", "static_max_lse")
_BWD_ENTRIES = ("bwd_fused", "bwd_dq", "bwd_dkv")
LAUNCHES = {name: 0 for name in _FWD_ENTRIES + _BWD_ENTRIES}
# calls of the plain versions on CUDA tensors (the main path should make none)
PLAIN_CUDA_CALLS = {"count": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    PLAIN_CUDA_CALLS["count"] = 0


# -- static-max bounds: the inference slot and the train slot -------------------
#
# Two separate slots, as in the JAX package: the inference slot is installed
# by `pipelines/sample_lib.autocalibrate_flash_static_max` and read only by
# the no-grad dispatch; the train slot is installed by
# `pipelines/train_lib.autocalibrate_flash_static_max_train` and read only by
# the autograd forward (`_FlashAttention`, which also serves the remat
# recompute). A sampling bound never applies to a training step.

_flash_static_max: Optional[float] = None
_flash_static_max_train: Optional[float] = None


def set_flash_static_max(bound: Optional[float]) -> None:
    """Install (or clear, with None) the fixed softmax bound used by the
    streaming self-attention on the inference path."""
    global _flash_static_max
    _flash_static_max = float(bound) if bound is not None else None


def set_flash_static_max_train(bound: Optional[float]) -> None:
    """Install (or clear) the fixed softmax bound of the training path."""
    global _flash_static_max_train
    _flash_static_max_train = float(bound) if bound is not None else None


def get_flash_static_max(train: bool = False) -> Optional[float]:
    """The bound the next streaming call will use: the train slot under
    autograd, the inference slot otherwise. The env pins
    (`LUMINA_FLASH_STATIC_MAX_TRAIN`, `LUMINA_FLASH_STATIC_MAX`) win over the
    settings."""
    if train:
        v = os.environ.get("LUMINA_FLASH_STATIC_MAX_TRAIN", "")
        return float(v) if v else _flash_static_max_train
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


def _static_max_softmax_plain(q, k, v, kv_mask, scale, bound):
    """p = exp(min(s - bound, 55)) with no running max and no rescale:
    (out, lse) with lse = bound + log l, -inf on fully masked rows."""
    _count_plain(q)
    b, sq, hq, _ = q.shape
    s, valid = _logits(q, k, kv_mask, scale)
    p = torch.exp(torch.clamp(s - bound, max=_STATIC_MAX_CLAMP))
    p = torch.where(valid, p, torch.zeros_like(p))
    l = p.sum(dim=-1)
    lse = torch.where(l > 0, bound + torch.log(l), torch.full_like(l, float("-inf")))
    return _finish(p, v, q, l), lse.reshape(b, hq, sq)


def flash_static_max_plain(q, k, v, kv_mask, scale, bound):
    """Plain version of `flash_static_max`."""
    return _static_max_softmax_plain(q, k, v, kv_mask, scale, bound)[0]


def flash_static_max_lse_plain(q, k, v, kv_mask, scale, bound):
    """Plain version of `flash_static_max_lse`: (out, lse)."""
    return _static_max_softmax_plain(q, k, v, kv_mask, scale, bound)


def flash_bwd_plain(q, k, v, kv_mask, out, lse, dout, scale):
    """Plain version of the backward kernels (`flash_bwd_fused`, and
    `flash_bwd_dq` + `flash_bwd_dkv`, which compute the same function), in
    fp32 from the forward's LSE: p = exp(min(s - lse, 0)), ds = p * (dp -
    rowsum(dO * O)) * scale. Returns (dq, dk, dv) in the inputs' dtypes, dk
    and dv per kv head. Fully masked rows (lse -inf) get dq 0 and add
    nothing; masked keys get dk = dv = 0."""
    _count_plain(q)
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    rep = hq // hkv
    s, valid = _logits(q, k, kv_mask, scale)  # (B, Hkv, rep, Sq, Sk)
    lse5 = lse.float().reshape(b, hkv, rep, sq, 1)
    row_ok = torch.isfinite(lse5)
    p = torch.exp(torch.clamp(s - torch.where(row_ok, lse5, torch.zeros_like(lse5)), max=0.0))
    p = torch.where(valid & row_ok, p, torch.zeros_like(p))
    do = dout.float().reshape(b, sq, hkv, rep, d)
    delta = (do * out.float().reshape(b, sq, hkv, rep, d)).sum(-1).permute(0, 2, 3, 1)
    dp = torch.einsum("bqhrd,bkhd->bhrqk", do, v.float())
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhrqk,bkhd->bqhrd", ds, k.float()).reshape(b, sq, hq, d)
    dk = torch.einsum("bhrqk,bqhrd->bkhd", ds, q.float().reshape(b, sq, hkv, rep, d))
    dv = torch.einsum("bhrqk,bqhrd->bkhd", p, do)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# -- the CUDA library ----------------------------------------------------------

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_NVCC_FLAGS = [*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
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
        nvcc, pid = _nvcc(), os.getpid()
        objs = [out_dir / f"{src.stem}.{pid}.o" for src in sources]
        # one nvcc per source, all started together
        procs = [subprocess.Popen([nvcc, *_NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for src, obj in zip(sources, objs)]
        logs = [proc.communicate() for proc in procs]
        for src, proc, (out, err) in zip(sources, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):\n{out}\n{err}")
        tmp = out_dir / f"liblumina_flash.{pid}.so"
        proc = subprocess.run([nvcc, *_ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        BUILD_INFO["ptxas"] = "".join(err for _, err in logs)
        BUILD_INFO["compiled"] = True
        os.replace(tmp, lib_path)
        for obj in objs:
            obj.unlink()
    lib = ctypes.CDLL(str(lib_path))
    ptr, meta = ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong)
    # forward: q, k, v, mask, out, lse, meta, scale, bound, is_bf16, stream
    fwd = [ptr] * 6 + [meta, ctypes.c_float, ctypes.c_float, ctypes.c_int, ptr]
    # backward: q, k, v, mask, dout, lse, delta, dq, dk, dv, meta, scale, is_bf16, stream
    bwd = [ptr] * 10 + [meta, ctypes.c_float, ctypes.c_int, ptr]
    for name in LAUNCHES:
        fn = getattr(lib, f"lumina_flash_{name}")
        fn.argtypes = fwd if name in _FWD_ENTRIES else bwd
        fn.restype = ctypes.c_int
    BUILD_INFO["seconds"] = time.perf_counter() - t0
    BUILD_INFO["path"] = str(lib_path)
    _lib = lib
    return lib


def _check_inputs(q, k, v, kv_mask):
    """Validate what every kernel takes; returns (q, k, v, int32 mask or
    None) with a contiguous last dim."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash kernels take CUDA tensors (CPU tensors take the plain version)")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernels take bf16 or fp32 q/k/v of one dtype, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    b, _, hq, d = q.shape
    _, sk, hkv, dk = k.shape
    if k.shape[0] != b or dk != d or d > 128 or sk == 0:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} (head_dim <= 128)")
    _check_gqa_heads(hq, hkv)
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    if kv_mask is not None:
        kv_mask = kv_mask.to(device=q.device, dtype=torch.int32).contiguous()
        if tuple(kv_mask.shape) != (b, sk):
            raise ValueError(f"kv_mask shape {tuple(kv_mask.shape)} != {(b, sk)}")
    return q, k, v, kv_mask


def _launch(name, q, k, v, kv_mask, scale, bound=0.0, with_lse=False):
    """Check what the kernel takes, allocate the outputs and launch
    `lumina_flash_<name>` on the current stream; returns out or (out, lse).
    Tensors made here (contiguous copies, the int32 mask) may be freed while
    the kernel runs: the caching allocator reuses their memory only for work
    queued after it on the same stream."""
    q, k, v, kv_mask = _check_inputs(q, k, v, kv_mask)
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    lib = build_library()
    with torch.cuda.device(q.device):
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


def _bwd_delta(out, dout):
    """delta = rowsum(dO * O) as a contiguous (B, Hq, Sq) fp32 tensor."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _launch_bwd(name, q, k, v, kv_mask, out, lse, dout, scale):
    """Check what the backward kernels take, allocate the outputs (dq as a
    zeroed fp32 buffer for the fused sweep) and launch `lumina_flash_<name>`
    on the current stream; returns (dq, dk, dv), None where the kernel does
    not write."""
    q, k, v, kv_mask = _check_inputs(q, k, v, kv_mask)
    b, sq, hq, d = q.shape
    if dout.shape != q.shape or not dout.is_cuda or tuple(lse.shape) != (b, hq, sq):
        raise ValueError(f"bad shapes dout {tuple(dout.shape)} lse {tuple(lse.shape)} "
                         f"for q {tuple(q.shape)}")
    lib = build_library()
    with torch.cuda.device(q.device):
        dout = dout.to(q.dtype)
        dout = dout if dout.stride(-1) == 1 else dout.contiguous()
        delta = _bwd_delta(out, dout)
        lse = lse.float().contiguous()
        new = lambda shape, dtype: torch.empty(shape, dtype=dtype, device=q.device)
        dq = dk = dv = None
        if name == "bwd_fused":
            dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        elif name == "bwd_dq":
            dq = new(q.shape, q.dtype)
        if name != "bwd_dq":
            dk, dv = new(k.shape, k.dtype), new(v.shape, v.dtype)
        strides = lambda t: t.stride()[:3] if t is not None else (0, 0, 0)
        meta = (ctypes.c_longlong * 28)(
            b, sq, k.shape[1], hq, k.shape[2], d,
            *strides(q), *strides(k), *strides(v), *strides(dout), *strides(dq),
            *strides(dk), *strides(dv), kv_mask.stride(0) if kv_mask is not None else 0,
        )
        ptr = lambda t: t.data_ptr() if t is not None else None
        err = getattr(lib, f"lumina_flash_{name}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(kv_mask), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), ptr(dq), ptr(dk), ptr(dv), meta, scale,
            int(q.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash kernel {name} launch failed: cudaError {err}")
    LAUNCHES[name] += 1
    return dq, dk, dv


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


def flash_static_max_lse(q, k, v, kv_mask=None, scale: Optional[float] = None, *,
                         bound: float):
    """Streaming attention with a fixed softmax bound that also returns the
    per-row LSE = bound + log l (replaces `_flash_kernel_res_static_max`)."""
    if not q.is_cuda:
        return flash_static_max_lse_plain(q, k, v, kv_mask, _scale(q, scale), float(bound))
    return _launch("static_max_lse", q, k, v, kv_mask, _scale(q, scale), bound=float(bound),
                   with_lse=True)


def flash_bwd_fused(q, k, v, kv_mask, out, lse, dout, scale: Optional[float] = None):
    """One-sweep backward: (dq, dk, dv), dk and dv per kv head (replaces
    `_bwd_fused_kernel`; dQ is summed with atomics in fp32, not as per-KV-block
    partials)."""
    if not q.is_cuda:
        return flash_bwd_plain(q, k, v, kv_mask, out, lse, dout, _scale(q, scale))
    dq, dk, dv = _launch_bwd("bwd_fused", q, k, v, kv_mask, out, lse, dout, _scale(q, scale))
    return dq.to(q.dtype), dk, dv


def flash_bwd_dq(q, k, v, kv_mask, out, lse, dout, scale: Optional[float] = None):
    """dQ of the two-kernel backward (replaces `_bwd_dq_kernel`)."""
    if not q.is_cuda:
        return flash_bwd_plain(q, k, v, kv_mask, out, lse, dout, _scale(q, scale))[0]
    return _launch_bwd("bwd_dq", q, k, v, kv_mask, out, lse, dout, _scale(q, scale))[0]


def flash_bwd_dkv(q, k, v, kv_mask, out, lse, dout, scale: Optional[float] = None):
    """(dK, dV) of the two-kernel backward, per kv head (replaces
    `_bwd_dkv_kernel`)."""
    if not q.is_cuda:
        return flash_bwd_plain(q, k, v, kv_mask, out, lse, dout, _scale(q, scale))[1:]
    return _launch_bwd("bwd_dkv", q, k, v, kv_mask, out, lse, dout, _scale(q, scale))[1:]


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def use_fused_bwd(b: int, sq: int, hq: int, d: int, sk: int) -> bool:
    """The JAX package's choice of backward (`_use_fused_bwd` with the blocks
    of `_pick_bwd_blocks`), so that both packages take the same route for the
    same shapes: the one-sweep kernel while its fp32 dQ partials (nk * |dQ|)
    would stay within 1 GiB, else dq + dkv. The blocks are JAX's defaults;
    the port's kernels tile by 64 whatever they are. `LUMINA_FLASH_FUSED_BWD=1/0`
    overrides."""
    v = os.environ.get("LUMINA_FLASH_FUSED_BWD", "")
    if v:
        return v != "0"
    block_q, block_k = min(1024, _round_up(sq, 128)), min(1024, _round_up(sk, 128))
    nk = _round_up(sk, block_k) // block_k
    return 4 * b * hq * _round_up(sq, block_q) * d * nk <= 1 << 30


class _FlashAttention(torch.autograd.Function):
    """Differentiable flash attention (counterpart of the JAX custom_vjp
    `_flash_attention`, `_fwd`/`_bwd`). Forward: the LSE forward, with the
    train bound when one is installed and the call streams (`flash_static_max_lse`),
    else `flash_online_lse`; it saves q, k, v, mask, out and lse. Backward:
    `flash_bwd_fused`, or `flash_bwd_dq` + `flash_bwd_dkv`, by
    `use_fused_bwd`. `plain=True` runs the plain versions on any device (the
    reference a run on the card compares the kernels with)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, scale, plain):
        bound = get_flash_static_max(train=True) if streams_kv(k.shape[1]) else None
        if bound is None:
            fn = flash_online_lse_plain if plain else flash_online_lse
            out, lse = fn(q, k, v, kv_mask, scale)
        elif plain:
            out, lse = flash_static_max_lse_plain(q, k, v, kv_mask, scale, bound)
        else:
            out, lse = flash_static_max_lse(q, k, v, kv_mask, scale, bound=bound)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        ctx.scale, ctx.plain = scale, plain
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        args = (q, k, v, kv_mask, out, lse, dout, ctx.scale)
        if ctx.plain:
            dq, dk, dv = flash_bwd_plain(*args)
        elif use_fused_bwd(q.shape[0], q.shape[1], q.shape[2], q.shape[3], k.shape[1]):
            dq, dk, dv = flash_bwd_fused(*args)
        else:
            dq = flash_bwd_dq(*args)
            dk, dv = flash_bwd_dkv(*args)
        return dq, dk, dv, None, None, None


def _differentiable(q, k, v) -> bool:
    return torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)


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
    """Flash attention: `_FlashAttention` under autograd, else the entry
    point `_route` picks."""
    if _differentiable(q, k, v):
        _check_gqa_heads(q.shape[2], k.shape[2])
        return _FlashAttention.apply(q, k, v, kv_mask, _scale(q, scale), False)
    name, kw = _route(q, k)
    return globals()[f"flash_{name}"](q, k, v, kv_mask, scale, **kw)


def flash_attention_plain(q, k, v, kv_mask=None, scale: Optional[float] = None):
    """`flash_attention` over the plain versions, on any device: the
    reference a run on the card compares the kernels with."""
    if _differentiable(q, k, v):
        _check_gqa_heads(q.shape[2], k.shape[2])
        return _FlashAttention.apply(q, k, v, kv_mask, _scale(q, scale), True)
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

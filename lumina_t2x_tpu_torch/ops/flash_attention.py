"""Flash attention: hand-written Hopper kernels and their plain PyTorch
versions (counterpart of `lumina_t2x_tpu/ops/flash_attention.py`).

Ten entry points, each with its own launch counter (`LAUNCHES`), each
standing in for one Pallas TPU kernel, and `rope_rotate`, the rotation the
fused-RoPE route runs before its forward:

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
| `flash_rope`           | `_flash_rope_kernel` (online, q and k rotated in-kernel)  |
| `flash_rope_q`         | `_flash_rope_q_kernel` (online, q rotated in-kernel)      |
| `rope_rotate`          | `_rotate_tile` of `_flash_rope_kernel`'s k (once a call)  |

The first three serve inference (no autograd); under autograd
`flash_attention` runs `_FlashAttention`, whose forward is `flash_online_lse`
or, with a train bound installed on a streaming call, `flash_static_max_lse`,
and whose backward is `flash_bwd_fused` or `flash_bwd_dq` + `flash_bwd_dkv`,
chosen by the JAX package's rule (`use_fused_bwd`). `flash_attention_rope`
(the `LUMINA_FUSE_ROPE=1` path) takes unrotated q and k: without autograd it
runs `flash_rope` or `flash_rope_q`; under autograd `_FlashAttentionRope`,
whose backward rotates q (and k) in plain PyTorch, runs `flash_online_lse`
and the backward kernels, and inverse-rotates dq (and dk).

The CUDA C++ sources are `lumina_t2x_tpu_torch/csrc/flash_fwd.cu` (the
forward entry points), `csrc/flash_bwd.cu` (the backward entry points), the
Hopper redesigns `csrc/flash_fwd_sm90.cu`
(bf16 `flash_small_kv`, `flash_online`, `flash_static_max`,
`flash_online_lse`, `flash_static_max_lse`, `flash_rope`, `flash_rope_q`;
the LSE written from the consumers' registers, q rotated in shared memory),
`csrc/flash_fwd_fp32_sm90.cu` (the same seven forwards in fp32: FFMA products
tiled in registers, exact to fp32; operands not in whole 16-byte chunks read
in place by 4-byte copies, any head_dim up to 128) and
`csrc/flash_bwd_sm90.cu` (bf16 `flash_bwd_fused` / `flash_bwd_dkv`, and
`flash_bwd_dq`'s own kernel: q rows as the block, a ring of K/V tiles),
`csrc/flash_bwd_fp32_sm90.cu` (the three backwards in fp32: FFMA products
tiled in registers, dK/dV or dQ held in registers, the fused sweep's dQ
added by TMA bulk reduce-adds), with `csrc/rope_rotate.cu` (`rope_rotate`);
they are built into one library by
`ops/cuda_lib.py` at first use, under `build/kernels/<source hash>/` at the
repository root, and bound through ctypes. A wrapper takes its plain version only for CPU
tensors; for CUDA tensors it launches the kernel or raises. The bf16 Hopper
kernels read q, k, v (and dout) through TMA tensor maps in 16-byte chunks:
they take head_dim a multiple of 8 (else ValueError; so does every bf16
call, `flash_small_kv`, `flash_bwd_dq` and the fused-RoPE ones included),
and an operand whose
base or (b, s, h) strides are not whole chunks, or whose strides do not
grow from h to s to b, is copied contiguous first (`_chunk_aligned`; a
strided view such as q, k, v of a fused (B, S, 3, H, D) tensor is read in
place).

fp16 q/k/v take the fp32 kernels: each entry point casts them (and dout,
out) to fp32 once at the wrapper, runs the fp32 kernel and returns its
outputs in fp16 (gradients in their inputs' dtype; the LSE stays fp32).
This is the route for fp16, not a fallback: no fp16 kernel exists, and any
dtype other than bf16, fp16 and fp32 raises.

Contract shared by kernel and plain version: q (B, Sq, Hq, D), k/v
(B, Sk, Hkv, D), optional key mask (B, Sk) with nonzero on valid keys, GQA
q head h -> kv head h // (Hq / Hkv), runtime `scale`, fp32 accumulation,
P (and dS) kept to fp32 precision (the Pallas kernels round them to the
operand dtype), outputs in the inputs' dtypes. A query row whose keys are all
masked outputs 0, has LSE -inf and gets dQ 0 (the JAX kernels disagree among
themselves on such rows; the main path never has them).
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import threading
from typing import Optional

import torch
import torch.autograd.forward_ad as fwAD

from . import cuda_lib
from .attention import default_attn_scale
from .rope import apply_rope, rot_tables

_NEG_INF = -2.3819763e38  # most-negative bf16-representable float32
# whole-KV threshold: Sk <= this takes the small-KV entry point
_SMALL_KV_MAX = 1024
# exponent clamp of the static-max kernel: exp(55) * 131072 keys stays far
# inside fp32 range
_STATIC_MAX_CLAMP = 55.0

# launches of each kernel; a wrapper adds one where it launches, nowhere else
_FWD_ENTRIES = ("small_kv", "online", "static_max", "online_lse", "static_max_lse")
_BWD_ENTRIES = ("bwd_fused", "bwd_dq", "bwd_dkv")
_ROPE_ENTRIES = ("rope", "rope_q")
LAUNCHES = {name: 0 for name in _FWD_ENTRIES + _BWD_ENTRIES + _ROPE_ENTRIES + ("rope_rotate",)}
# calls of the plain versions on CUDA tensors (the main path should make none)
PLAIN_CUDA_CALLS = {"count": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    PLAIN_CUDA_CALLS["count"] = 0


# -- static-max bounds: the inference slot and the train slot -------------------
#
# Two separate slots, as in the JAX package: the inference slot
# (`set_flash_static_max`) is read only by the no-grad dispatch; the train
# slot is installed by `pipelines/train_lib.autocalibrate_flash_static_max_train`
# and read only by the autograd forward (`_FlashAttention`, which also serves
# the remat recompute). A sampling bound never applies to a training step.
# A sampler (`pipelines/sample_lib.build_t2i_sample_fn`) carries its own
# calibrated bound and runs inside `flash_static_max_scope`, which wins over
# the inference slot for its thread.

_flash_static_max: Optional[float] = None
_flash_static_max_train: Optional[float] = None
_UNSCOPED = object()
_scoped = threading.local()


def set_flash_static_max(bound: Optional[float]) -> None:
    """Install (or clear, with None) the fixed softmax bound used by the
    streaming self-attention on the inference path."""
    global _flash_static_max
    _flash_static_max = float(bound) if bound is not None else None


def set_flash_static_max_train(bound: Optional[float]) -> None:
    """Install (or clear) the fixed softmax bound of the training path."""
    global _flash_static_max_train
    _flash_static_max_train = float(bound) if bound is not None else None


@contextlib.contextmanager
def flash_static_max_scope(bound: Optional[float]):
    """Within the block, this thread's inference calls use `bound` (None: the
    online kernel) whatever the process-wide slot holds. A sampler runs its
    trajectory in the scope of the bound it was built with, as a JAX sampler
    bakes its bound in when it is traced."""
    prev = getattr(_scoped, "bound", _UNSCOPED)
    _scoped.bound = float(bound) if bound is not None else None
    try:
        yield
    finally:
        _scoped.bound = prev


def get_flash_static_max(train: bool = False) -> Optional[float]:
    """The bound the next streaming call will use: the train slot under
    autograd, the inference slot otherwise (this thread's
    `flash_static_max_scope` first). The env pins
    (`LUMINA_FLASH_STATIC_MAX_TRAIN`, `LUMINA_FLASH_STATIC_MAX`) win over the
    settings."""
    if train:
        v = os.environ.get("LUMINA_FLASH_STATIC_MAX_TRAIN", "")
        return float(v) if v else _flash_static_max_train
    v = os.environ.get("LUMINA_FLASH_STATIC_MAX", "")
    if v:
        return float(v)
    scoped = getattr(_scoped, "bound", _UNSCOPED)
    return _flash_static_max if scoped is _UNSCOPED else scoped


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


def flash_rope_plain(q, k, v, angles, kv_mask, scale):
    """Plain version of `flash_rope`: `apply_rope` on q and k (fp32, rounded
    to the operand dtype), then the exact masked softmax."""
    return flash_online_plain(apply_rope(q, angles), apply_rope(k, angles), v, kv_mask, scale)


def flash_rope_q_plain(q, k, v, angles, kv_mask, scale):
    """Plain version of `flash_rope_q`: only q is rotated."""
    return flash_online_plain(apply_rope(q, angles), k, v, kv_mask, scale)


# -- the CUDA library ----------------------------------------------------------

_ptr, _meta = ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong)
# forward: q, k, v, mask, out, lse, meta, scale, bound, is_bf16, stream
_FWD_ARGS = [_ptr] * 6 + [_meta, ctypes.c_float, ctypes.c_float, ctypes.c_int, _ptr]
# backward: q, k, v, mask, dout, lse, delta, dq, dk, dv, meta, scale, is_bf16, stream
_BWD_ARGS = [_ptr] * 10 + [_meta, ctypes.c_float, ctypes.c_int, _ptr]
# rope: q, k, v, mask, out, cos_full, sin_signed, meta, scale, is_bf16, stream
_ROPE_ARGS = [_ptr] * 7 + [_meta, ctypes.c_float, ctypes.c_int, _ptr]
# rope_rotate: x, out, cos_full, sin_signed, meta (int64[7]), is_bf16, stream
_ROTATE_ARGS = [_ptr] * 4 + [_meta, ctypes.c_int, _ptr]
LIBRARY = "flash"  # the library of K1-K9 (`ops/cuda_lib.py`)
cuda_lib.declare(LIBRARY, ["flash_fwd.cu", "flash_bwd.cu", "flash_fwd_sm90.cu",
                          "flash_fwd_fp32_sm90.cu", "flash_bwd_sm90.cu",
                          "flash_bwd_fp32_sm90.cu", "rope_rotate.cu"], {
    **{f"lumina_flash_{name}": _FWD_ARGS for name in _FWD_ENTRIES},
    **{f"lumina_flash_{name}": _BWD_ARGS for name in _BWD_ENTRIES},
    **{f"lumina_flash_{name}": _ROPE_ARGS for name in _ROPE_ENTRIES},
    "lumina_rope_rotate": _ROTATE_ARGS,
    # static_max (fused), head_dim, out (int64[7]); launch nothing
    "lumina_flash_fwd_sm90_attributes": [ctypes.c_int, ctypes.c_int, _meta],
    # which (0 dK/dV, 1 fused, 2 dQ), head_dim, out (int64[7])
    "lumina_flash_bwd_sm90_attributes": [ctypes.c_int, ctypes.c_int, _meta],
    # static_max, meta (the forward's, shapes read), out (int64[8]); launch nothing
    "lumina_flash_fwd_fp32_attributes": [ctypes.c_int, _meta, _meta],
    # which (0 dK/dV, 1 fused, 2 dQ), meta (the backward's, shapes read), out
    # (int64[8]); launch nothing
    "lumina_flash_bwd_fp32_attributes": [ctypes.c_int, _meta, _meta]})
_SM90_ATTRIBUTES = ("registers", "producer_registers", "consumer_registers", "local_bytes",
                    "shared_bytes", "blocks_per_sm", "threads")


def _attributes(symbol, flag, head_dim):
    out = (ctypes.c_longlong * len(_SM90_ATTRIBUTES))()
    err = getattr(cuda_lib.build_library(LIBRARY), symbol)(int(flag), int(head_dim), out)
    if err != 0:
        raise RuntimeError(f"{symbol} failed: cudaError {err}")
    return dict(zip(_SM90_ATTRIBUTES, out))


def sm90_attributes(static_max: bool, head_dim: int = 72) -> dict:
    """Resources of the compiled bf16 streaming kernel (`csrc/flash_fwd_sm90.cu`;
    with or without the LSE, one instantiation) at `head_dim`, from the CUDA
    runtime: registers per thread as compiled (the launch bound) and per
    producer / consumer thread after `setmaxnreg`, local-memory (spill) bytes
    per thread, shared memory per block, resident blocks per SM, threads per
    block."""
    return _attributes("lumina_flash_fwd_sm90_attributes", static_max, head_dim)


_FP32_ATTRIBUTES = ("registers", "local_bytes", "shared_bytes", "blocks_per_sm", "threads",
                    "rows_per_block", "key_warps", "grid_blocks")


def fp32_attributes(static_max: bool, b: int, sq: int, sk: int, hq: int, hkv: int,
                    d: int) -> dict:
    """The fp32 forward (`csrc/flash_fwd_fp32_sm90.cu`) at these shapes: its
    plan -- query rows per block, key-split warps, blocks in the grid -- and
    the resources of the instantiation it launches (registers per thread,
    local-memory (spill) bytes per thread, shared memory per block with the
    plan's, resident blocks per SM, threads per block), from the CUDA
    runtime. Launches nothing."""
    meta = (ctypes.c_longlong * 19)(b, sq, sk, hq, hkv, d)
    out = (ctypes.c_longlong * len(_FP32_ATTRIBUTES))()
    err = cuda_lib.build_library(LIBRARY).lumina_flash_fwd_fp32_attributes(int(static_max), meta,
                                                                            out)
    if err != 0:
        raise RuntimeError(f"lumina_flash_fwd_fp32_attributes failed: cudaError {err}")
    return dict(zip(_FP32_ATTRIBUTES, out))


_BWD_SM90_KERNELS = ("dkv", "fused", "dq")  # the C entry's `which`, in order


def bwd_sm90_attributes(kernel: str, head_dim: int = 72) -> dict:
    """`sm90_attributes` of a bf16 backward kernel (`csrc/flash_bwd_sm90.cu`):
    `kernel` is "fused" (the fused sweep, K6), "dkv" (dK/dV only, K8) or "dq"
    (the dQ kernel, K7)."""
    if kernel not in _BWD_SM90_KERNELS:
        raise ValueError(f"kernel must be one of {_BWD_SM90_KERNELS}, not {kernel!r}")
    return _attributes("lumina_flash_bwd_sm90_attributes", _BWD_SM90_KERNELS.index(kernel),
                       head_dim)


_BWD_FP32_ATTRIBUTES = ("registers", "local_bytes", "shared_bytes", "blocks_per_sm", "threads",
                        "rows_per_block", "rows_per_tile", "grid_blocks")


def bwd_fp32_attributes(kernel: str, b: int, sq: int, sk: int, hq: int, hkv: int,
                        d: int) -> dict:
    """The fp32 backward (`csrc/flash_bwd_fp32_sm90.cu`) at these shapes:
    `kernel` "fused" (K6), "dkv" (K8) or "dq" (K7). Its plan -- rows per
    block (keys for K6/K8, q rows for K7), rows per streamed tile (q rows,
    keys), blocks in the grid -- and the resources of the instantiation it
    launches (registers per thread, local-memory (spill) bytes per thread,
    shared memory per block, resident blocks per SM, threads per block),
    from the CUDA runtime. Launches nothing."""
    if kernel not in _BWD_SM90_KERNELS:
        raise ValueError(f"kernel must be one of {_BWD_SM90_KERNELS}, not {kernel!r}")
    meta = (ctypes.c_longlong * 28)(b, sq, sk, hq, hkv, d)
    out = (ctypes.c_longlong * len(_BWD_FP32_ATTRIBUTES))()
    err = cuda_lib.build_library(LIBRARY).lumina_flash_bwd_fp32_attributes(
        _BWD_SM90_KERNELS.index(kernel), meta, out)
    if err != 0:
        raise RuntimeError(f"lumina_flash_bwd_fp32_attributes failed: cudaError {err}")
    return dict(zip(_BWD_FP32_ATTRIBUTES, out))


_KERNEL_DTYPES = (torch.bfloat16, torch.float16, torch.float32)


def _fp32_if_fp16(*tensors):
    """The fp16 route: fp16 tensors cast to fp32 (the fp32 kernels run them;
    there is no fp16 kernel), other tensors and None as they are."""
    return tuple(t.float() if t is not None and t.dtype == torch.float16 else t for t in tensors)


def _check_inputs(q, k, v, kv_mask):
    """Validate what every kernel takes; returns (q, k, v, int32 mask or
    None) with a contiguous last dim."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash kernels take CUDA tensors (CPU tensors take the plain version)")
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernels take bf16, fp16 or fp32 q/k/v of one dtype, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    qs, ks = q.shape, k.shape
    if len(qs) != 4 or len(ks) != 4 or v.shape != ks:
        raise ValueError(f"bad shapes q {tuple(qs)} k {tuple(ks)} v {tuple(v.shape)}")
    b, _, hq, d = qs
    kb, sk, hkv, dk = ks
    if kb != b or dk != d or d > 128 or sk == 0:
        raise ValueError(f"bad shapes q {tuple(qs)} k {tuple(ks)} (head_dim <= 128)")
    _check_gqa_heads(hq, hkv)
    if q.stride(-1) != 1:
        q = q.contiguous()
    if k.stride(-1) != 1:
        k = k.contiguous()
    if v.stride(-1) != 1:
        v = v.contiguous()
    if kv_mask is not None:
        kv_mask = kv_mask.to(device=q.device, dtype=torch.int32).contiguous()
        if tuple(kv_mask.shape) != (b, sk):
            raise ValueError(f"kv_mask shape {tuple(kv_mask.shape)} != {(b, sk)}")
    return q, k, v, kv_mask


# the entry points whose bf16 inputs take the Hopper kernels of
# `csrc/flash_fwd_sm90.cu` (K1-K5) and `csrc/flash_bwd_sm90.cu` (K6-K8)
_SM90_ENTRIES = ("small_kv", "online", "static_max", "online_lse", "static_max_lse")
_SM90_BWD_ENTRIES = ("bwd_fused", "bwd_dq", "bwd_dkv")


def _sm90_head_dim(name, d):
    if d % 8:
        raise ValueError(f"bf16 flash_{name} takes head_dim a multiple of 8 (16-byte "
                         f"chunks), got {d}")


def _chunk_aligned(t):
    """t as a bf16 Hopper kernel's TMA tensor map reads it -- base and
    (b, s, h) element strides in whole 16-byte chunks, 0 < h stride <= s
    stride <= b stride -- t itself when it is so, else a contiguous copy."""
    sb, ss, sh = t.stride()[:3]
    if t.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in (sb, ss, sh)) and 0 < sh <= ss <= sb:
        return t
    return torch.empty_like(t, memory_format=torch.contiguous_format).copy_(t)


_META = ctypes.c_longlong * 19


def _fwd_meta(q, k, v, out, kv_mask):
    """meta (int64[19]) of the forward entry points: shapes, then element
    strides of q, k, v, out (b, s, h) and the mask (b). Filled by slice
    assignment: ctypes' 19-argument constructor costs several microseconds
    a call."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    meta = _META()
    meta[:] = (b, sq, sk, hq, hkv, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *out.stride()[:3], kv_mask.stride(0) if kv_mask is not None else 0)
    return meta


_SAME_DEVICE = contextlib.nullcontext()


def _on_device(t):
    """`torch.cuda.device(t.device)`, or nothing when that device is already
    the current one (the usual case: the guard costs a few us a call)."""
    index = t.get_device()
    return _SAME_DEVICE if index == torch.cuda.current_device() else torch.cuda.device(index)


def _stream(t):
    """The raw handle of the current stream of t's device."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _launch(name, q, k, v, kv_mask, scale, bound=0.0, with_lse=False):
    """Check what the kernel takes, allocate the outputs and launch
    `lumina_flash_<name>` on the current stream; returns out or (out, lse).
    fp16 inputs run the fp32 kernel (`_fp32_if_fp16`), out comes back fp16.
    Tensors made here (contiguous copies, the int32 mask) may be freed while
    the kernel runs: the caching allocator reuses their memory only for work
    queued after it on the same stream."""
    q, k, v, kv_mask = _check_inputs(q, k, v, kv_mask)
    half = q.dtype == torch.float16
    q, k, v = _fp32_if_fp16(q, k, v)
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    if name in _SM90_ENTRIES and q.dtype == torch.bfloat16:
        _sm90_head_dim(name, d)
        q, k, v = (_chunk_aligned(t) for t in (q, k, v))
    lib = cuda_lib.build_library(LIBRARY)
    with _on_device(q):
        out = (torch.empty_like(q) if q.is_contiguous()
               else torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device))
        lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) if with_lse else None
        err = getattr(lib, f"lumina_flash_{name}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            kv_mask.data_ptr() if kv_mask is not None else None, out.data_ptr(),
            lse.data_ptr() if with_lse else None, _fwd_meta(q, k, v, out, kv_mask), scale, bound,
            int(q.dtype == torch.bfloat16), _stream(q))
    if err != 0:
        raise RuntimeError(f"flash kernel {name} launch failed: cudaError {err}")
    LAUNCHES[name] += 1
    if half:
        out = out.half()
    return (out, lse) if with_lse else out


# the last angle table's rotation tables: (angles, its version, head_dim,
# cos_full, sin_signed). A forward hands one angles tensor to every layer,
# which calls the fused-RoPE kernels twice, so the tables are built once
_ROT_CACHE = [None]


def _rotation_tables(angles, d):
    """`rot_tables(angles, d)` as contiguous (Sq, D) fp32 tensors, reused
    while the same, unmodified angles tensor comes back."""
    hit = _ROT_CACHE[0]
    if hit is not None and hit[0] is angles and hit[1] == angles._version and hit[2] == d:
        return hit[3], hit[4]
    cos_full, sin_signed = (t.contiguous() for t in rot_tables(angles, d))
    _ROT_CACHE[0] = (angles, angles._version, d, cos_full, sin_signed)
    return cos_full, sin_signed


def _rotatable(t):
    """t as `lumina_rope_rotate` reads it -- base and (b, s, h) element
    strides in whole vectors of 8 bf16 or 2 fp32 elements -- t itself when
    it is so, else a contiguous copy."""
    n = 8 if t.dtype == torch.bfloat16 else 2
    if t.data_ptr() % (n * t.element_size()) == 0 and all(st % n == 0 for st in t.stride()[:3]):
        return t
    return torch.empty_like(t, memory_format=torch.contiguous_format).copy_(t)


def _rotate(x, cos_full, sin_signed):
    """Launch `lumina_rope_rotate` on a CUDA (B, S, H, D) tensor with the
    contiguous (S, D) fp32 tables; returns the rotated tensor, contiguous."""
    x = _rotatable(x if x.stride(-1) == 1 else x.contiguous())
    b, s, h, d = x.shape
    out = torch.empty((b, s, h, d), dtype=x.dtype, device=x.device)
    err = cuda_lib.build_library(LIBRARY).lumina_rope_rotate(
        x.data_ptr(), out.data_ptr(), cos_full.data_ptr(), sin_signed.data_ptr(),
        (ctypes.c_longlong * 7)(b, s, h, d, *x.stride()[:3]), int(x.dtype == torch.bfloat16),
        _stream(x))
    if err != 0:
        raise RuntimeError(f"rope_rotate launch failed: cudaError {err}")
    LAUNCHES["rope_rotate"] += 1
    return out


def _check_rope_args(name, q, k, angles):
    """What the fused-RoPE route takes beyond `_check_inputs`: (S, D/2)
    angles for an even head_dim, Sk == Sq for `rope`, and head_dim a
    multiple of 8 in bf16 (the Hopper forward's and `rope_rotate`'s 16-byte
    chunks). Raises ValueError before anything is launched."""
    sq, d = q.shape[1], q.shape[-1]
    if d % 2 or tuple(angles.shape) != (sq, d // 2):
        raise ValueError(f"angles {tuple(angles.shape)} must be (Sq, D/2) = {(sq, d // 2)}")
    if name == "rope" and k.shape[1] != sq:
        raise ValueError(f"flash_rope rotates k by the query positions: Sk {k.shape[1]} != Sq {sq}")
    if q.dtype == torch.bfloat16:
        _sm90_head_dim(name, d)


def _rope_rotated_first(name, dtype):
    """The operands `rope_rotate` turns before the forward of `name` runs:
    k for `rope` (bf16 q is rotated inside the Hopper forward), and q as
    well in fp32 (the fp32 forward rotates nothing)."""
    first = ("k",) if name == "rope" else ()
    return first if dtype == torch.bfloat16 else ("q", *first)


def _launch_rope(name, q, k, v, angles, kv_mask, scale):
    """Check what the fused-RoPE route takes, build the (Sq, D) fp32
    rotation tables on the card with `rot_tables` (the plain version's
    arithmetic; `_rotation_tables` reuses them across a forward's calls),
    rotate the operands `_rope_rotated_first` names with `rope_rotate`'s
    kernel and launch `lumina_flash_<name>`: in bf16 the Hopper forward,
    handed the tables to rotate q in shared memory; in fp32 the fp32
    forward's online kernel (fp16 q/k/v too, cast to fp32 first). Returns
    out in q's dtype."""
    _check_rope_args(name, q, k, angles)
    q, k, v, kv_mask = _check_inputs(q, k, v, kv_mask)
    half = q.dtype == torch.float16
    q, k, v = _fp32_if_fp16(q, k, v)
    b, sq, hq, d = q.shape
    bf16 = q.dtype == torch.bfloat16
    lib = cuda_lib.build_library(LIBRARY)
    with _on_device(q):
        cos_full, sin_signed = _rotation_tables(angles.to(q.device), d)
        first = _rope_rotated_first(name, q.dtype)
        if "q" in first:
            q = _rotate(q, cos_full, sin_signed)
        if "k" in first:
            k = _rotate(k, cos_full, sin_signed)
        if bf16:
            q, k, v = (_chunk_aligned(t) for t in (q, k, v))
        out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
        err = getattr(lib, f"lumina_flash_{name}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            kv_mask.data_ptr() if kv_mask is not None else None, out.data_ptr(),
            cos_full.data_ptr() if bf16 else None, sin_signed.data_ptr() if bf16 else None,
            _fwd_meta(q, k, v, out, kv_mask), scale, int(bf16), _stream(q))
    if err != 0:
        raise RuntimeError(f"flash kernel {name} launch failed: cudaError {err}")
    LAUNCHES[name] += 1
    return out.half() if half else out


def _bwd_delta(out, dout):
    """delta = rowsum(dO * O) as a contiguous (B, Hq, Sq) fp32 tensor."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _launch_bwd(name, q, k, v, kv_mask, out, lse, dout, scale):
    """Check what the backward kernels take, allocate the outputs (dq as a
    zeroed fp32 buffer for the fused sweep) and launch `lumina_flash_<name>`
    on the current stream; returns (dq, dk, dv), None where the kernel does
    not write. fp16 inputs run the fp32 kernels (`_fp32_if_fp16`); dk, dv
    and `bwd_dq`'s dq come back fp16 (the fused sweep's fp32 dq is cast by
    `flash_bwd_fused`)."""
    q, k, v, kv_mask = _check_inputs(q, k, v, kv_mask)
    half = q.dtype == torch.float16
    q, k, v, out, dout = _fp32_if_fp16(q, k, v, out, dout)
    b, sq, hq, d = q.shape
    if dout.shape != q.shape or not dout.is_cuda or tuple(lse.shape) != (b, hq, sq):
        raise ValueError(f"bad shapes dout {tuple(dout.shape)} lse {tuple(lse.shape)} "
                         f"for q {tuple(q.shape)}")
    lib = cuda_lib.build_library(LIBRARY)
    with _on_device(q):
        dout = dout.to(q.dtype)
        dout = dout if dout.stride(-1) == 1 else dout.contiguous()
        if name in _SM90_BWD_ENTRIES and q.dtype == torch.bfloat16:
            _sm90_head_dim(name, d)
            q, k, v, dout = (_chunk_aligned(t) for t in (q, k, v, dout))
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
            int(q.dtype == torch.bfloat16), _stream(q))
    if err != 0:
        raise RuntimeError(f"flash kernel {name} launch failed: cudaError {err}")
    LAUNCHES[name] += 1
    if half:
        dk, dv = _fp16(dk), _fp16(dv)
        dq = dq if name == "bwd_fused" else _fp16(dq)
    return dq, dk, dv


def _fp16(t):
    return t.half() if t is not None else None


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
    `_bwd_fused_kernel`; dQ is summed in fp32 in device memory by bulk
    reduce-adds of whole tiles, in an order that varies from run to run, not
    as per-KV-block partials)."""
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


def flash_rope(q, k, v, angles, kv_mask=None, scale: Optional[float] = None):
    """Online-softmax attention of unrotated q and k (Sq == Sk), both rotated
    by the (Sq, D/2) fp32 `angles` (replaces `_flash_rope_kernel`): k once by
    `rope_rotate`'s kernel, bf16 q inside the Hopper forward (fp32 q by
    `rope_rotate` too)."""
    if not q.is_cuda:
        return flash_rope_plain(q, k, v, angles, kv_mask, _scale(q, scale))
    return _launch_rope("rope", q, k, v, angles, kv_mask, _scale(q, scale))


def flash_rope_q(q, k, v, angles, kv_mask=None, scale: Optional[float] = None):
    """Online-softmax attention of unrotated q, rotated in-kernel (bf16; fp32
    by `rope_rotate`), to keys that carry no rotation, any Sk (replaces
    `_flash_rope_q_kernel`)."""
    if not q.is_cuda:
        return flash_rope_q_plain(q, k, v, angles, kv_mask, _scale(q, scale))
    return _launch_rope("rope_q", q, k, v, angles, kv_mask, _scale(q, scale))


def rope_rotate(x, angles):
    """`apply_rope(x, angles)` of a (B, S, H, D) bf16 or fp32 tensor by
    (S, D/2) angles, as one kernel (`csrc/rope_rotate.cu`; the key half of
    `flash_rope`) on the card, bit for bit; the plain version (`apply_rope`)
    on the CPU. The result is contiguous."""
    if not x.is_cuda:
        return apply_rope(x, angles)
    if x.dtype not in (torch.bfloat16, torch.float32) or x.dim() != 4:
        raise TypeError(f"rope_rotate takes a bf16 or fp32 (B, S, H, D) tensor, got {x.dtype} "
                        f"{tuple(x.shape)}")
    s, d = x.shape[1], x.shape[3]
    if d % (8 if x.dtype == torch.bfloat16 else 2) or tuple(angles.shape) != (s, d // 2):
        raise ValueError(f"rope_rotate takes head_dim a multiple of 8 (bf16) or 2 (fp32) and "
                         f"(S, D/2) angles: x {tuple(x.shape)}, angles {tuple(angles.shape)}")
    with _on_device(x):
        return _rotate(x, *_rotation_tables(angles.to(x.device), d))


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
        dq, dk, dv = _attention_bwd(q, k, v, kv_mask, out, lse, dout, ctx.scale, ctx.plain)
        return dq, dk, dv, None, None, None


def _attention_bwd(q, k, v, kv_mask, out, lse, dout, scale, plain):
    """(dq, dk, dv) from the forward's out and LSE: the plain backward, or
    `flash_bwd_fused` / `flash_bwd_dq` + `flash_bwd_dkv` by `use_fused_bwd`."""
    args = (q, k, v, kv_mask, out, lse, dout, scale)
    if plain:
        return flash_bwd_plain(*args)
    if use_fused_bwd(q.shape[0], q.shape[1], q.shape[2], q.shape[3], k.shape[1]):
        return flash_bwd_fused(*args)
    return (flash_bwd_dq(*args), *flash_bwd_dkv(*args))


class _FlashAttentionRope(torch.autograd.Function):
    """Differentiable fused-RoPE attention (counterpart of the JAX custom_vjp
    `_flash_attention_rope`, `_rope_fwd`/`_rope_bwd`). Forward: `flash_rope`
    (`rotate_k`) or `flash_rope_q`; it saves the unrotated q, k, v, the mask
    and the angles. Backward: `apply_rope` on q (and k), `flash_online_lse`
    (never the static-max LSE forward, whatever train bound is installed),
    the backward kernels by `use_fused_bwd`, then dq (and dk) rotated back
    by -angles: the rotation is orthogonal. `plain=True` runs the plain
    versions on any device."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, angles, scale, rotate_k, plain):
        out = _rope_entry(rotate_k, plain)(q, k, v, angles, kv_mask, scale)
        ctx.save_for_backward(q, k, v, kv_mask, angles)
        ctx.scale, ctx.rotate_k, ctx.plain = scale, rotate_k, plain
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_mask, angles = ctx.saved_tensors
        q_rot = apply_rope(q, angles)
        k_rot = apply_rope(k, angles) if ctx.rotate_k else k
        lse_fwd = flash_online_lse_plain if ctx.plain else flash_online_lse
        out, lse = lse_fwd(q_rot, k_rot, v, kv_mask, ctx.scale)
        dq, dk, dv = _attention_bwd(q_rot, k_rot, v, kv_mask, out, lse, dout, ctx.scale, ctx.plain)
        dq = apply_rope(dq, -angles)
        if ctx.rotate_k:
            dk = apply_rope(dk, -angles)
        return dq, dk, dv, None, None, None, None, None


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


def _refuse_forward_ad(q, k, v):
    """Raise on a forward-mode dual input: the kernels read the primal
    values and would drop the tangent (neither they nor JAX's custom_vjp
    have a forward-mode rule)."""
    # _current_level is -1 outside every dual level: a check that costs
    # nothing on the paths that use no forward mode
    if fwAD._current_level >= 0 and any(fwAD.unpack_dual(t).tangent is not None
                                        for t in (q, k, v)):
        raise RuntimeError("flash attention has no forward-mode derivative (nor has the JAX "
                           "package's custom_vjp): run forward-mode AD, such as "
                           "Sampler.sample_ode_likelihood, on a model built with "
                           "attn_impl=\"xla\"")


def flash_attention(q, k, v, kv_mask=None, scale: Optional[float] = None):
    """Flash attention: `_FlashAttention` under autograd, else the entry
    point `_route` picks. A forward-mode dual input raises."""
    _refuse_forward_ad(q, k, v)
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


def _rope_entry(rotate_k, plain):
    if rotate_k:
        return flash_rope_plain if plain else flash_rope
    return flash_rope_q_plain if plain else flash_rope_q


def _rope_call(q, k, v, angles, kv_mask, scale, rotate_k, plain):
    if not plain:
        _refuse_forward_ad(q, k, v)
    _check_gqa_heads(q.shape[2], k.shape[2])
    if rotate_k and k.shape[1] != q.shape[1]:
        raise ValueError(f"rotate_k rotates k by the query positions: Sk {k.shape[1]} != "
                         f"Sq {q.shape[1]}")
    angles = angles.float()
    scale = _scale(q, scale)
    if _differentiable(q, k, v):
        return _FlashAttentionRope.apply(q, k, v, kv_mask, angles, scale, bool(rotate_k), plain)
    return _rope_entry(rotate_k, plain)(q, k, v, angles, kv_mask, scale)


def flash_attention_rope(q, k, v, angles, kv_mask=None, scale: Optional[float] = None,
                         rotate_k: bool = True):
    """Flash attention with the RoPE rotation fused into the kernel
    (counterpart of the JAX `flash_attention_rope`). q and k are UNROTATED;
    `angles` is the (Sq, D/2) angle table. rotate_k=True (self-attention,
    Sq == Sk) equals `flash_attention(apply_rope(q), apply_rope(k), v)`;
    rotate_k=False (cross-attention) rotates only q and k keeps its own
    length. `_FlashAttentionRope` under autograd, else `flash_rope` /
    `flash_rope_q`."""
    return _rope_call(q, k, v, angles, kv_mask, scale, rotate_k, False)


def flash_attention_rope_plain(q, k, v, angles, kv_mask=None, scale: Optional[float] = None,
                               rotate_k: bool = True):
    """`flash_attention_rope` over the plain versions, on any device: the
    reference a run on the card compares the kernels with."""
    return _rope_call(q, k, v, angles, kv_mask, scale, rotate_k, True)


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

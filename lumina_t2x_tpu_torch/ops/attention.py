"""Attention ops (counterpart of `lumina_t2x_tpu/ops/attention.py`): the
softmax scale functions, the K/V pooling of `kv_merge` (`pool_kv_2d`), a
plain masked GQA `sdpa`, and the dispatcher between it and the hand-written
flash kernels (`ops/flash_attention.py`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

_NEG_INF = -1e9  # large-negative bias, as in the JAX sdpa


def proportional_attn_scale(seqlen: int, base_seqlen: int, head_dim: int) -> float:
    """Entropy-preserving softmax scale for resolution extrapolation."""
    return math.sqrt(math.log(seqlen, base_seqlen) / head_dim)


def default_attn_scale(head_dim: int) -> float:
    return math.sqrt(1.0 / head_dim)


def anagram_attn_scale(seqlen: int, base_seqlen: int, head_dim: int) -> float:
    """Visual-anagrams' altered proportional scale log_base(seqlen)/sqrt(d)."""
    return math.log(seqlen, base_seqlen) / math.sqrt(head_dim)


def pool_kv_2d(k, v, grid_h: int, grid_w: int, merge_ratio: int):
    """Average-pool K and V over the (grid_h, grid_w) token grid with
    kernel = stride = merge_ratio: the visual-anagrams `kv_merge` trick,
    which shortens the keys by merge_ratio^2 while the queries stay full
    length. The grid is cropped to a multiple of merge_ratio.

    k, v: (B, S, Hkv, D) with S == grid_h * grid_w. Returns the pooled
    (k, v) of length (grid_h // r) * (grid_w // r)."""
    if merge_ratio <= 1:
        return k, v
    r = merge_ratio
    gh, gw = grid_h // r, grid_w // r

    def pool(x):
        b, _, hh, d = x.shape
        x = x.reshape(b, grid_h, grid_w, hh, d)[:, : gh * r, : gw * r]
        x = x.reshape(b, gh, r, gw, r, hh, d).mean(dim=(2, 4))
        return x.reshape(b, gh * gw, hh, d)

    return pool(k), pool(v)


def sdpa(q, k, v, kv_mask=None, scale: Optional[float] = None):
    """Masked scaled-dot-product attention (non-causal), plain PyTorch.

    q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D) with Hkv dividing Hq (GQA);
    kv_mask: optional (B, Sk), nonzero on valid keys. Logits and softmax in
    fp32; returns (B, Sq, Hq, D) in q's dtype. Like the JAX sdpa, masked keys
    get a -1e9 bias, so a fully masked row averages v.
    """
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    if hq % hkv != 0:
        raise ValueError(f"query heads {hq} must be a multiple of kv heads {hkv}")
    rep = hq // hkv
    if scale is None:
        scale = default_attn_scale(d)
    qg = q.reshape(b, sq, hkv, rep, d)
    logits = torch.einsum("bqhrd,bkhd->bhrqk", qg.float(), k.float()) * scale
    if kv_mask is not None:
        bias = torch.where(kv_mask.bool()[:, None, None, None, :], 0.0, _NEG_INF)
        logits = logits + bias
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhrqk,bkhd->bqhrd", probs.to(v.dtype), v)
    return out.reshape(b, sq, hq, d).to(q.dtype)


def resolve_impl(impl: str) -> str:
    """'auto' -> 'flash' on every device: the flash entry points run their
    CUDA kernels on the card and their plain versions on the CPU."""
    return "flash" if impl == "auto" else impl


def attention(q, k, v, kv_mask=None, scale: Optional[float] = None, impl: str = "auto"):
    """Dispatch between the plain `sdpa` ("xla", the JAX package's name for
    it), the flash entry points ("flash" | "auto"), and the flash entry
    points' plain versions on any device ("plain", the kernels' reference)."""
    impl = resolve_impl(impl)
    if impl == "flash":
        from .flash_attention import flash_attention

        return flash_attention(q, k, v, kv_mask=kv_mask, scale=scale)
    if impl == "plain":
        from .flash_attention import flash_attention_plain

        return flash_attention_plain(q, k, v, kv_mask=kv_mask, scale=scale)
    if impl != "xla":
        raise ValueError(f"unknown attention impl {impl!r} "
                         "(use 'auto', 'flash', 'plain' or 'xla')")
    return sdpa(q, k, v, kv_mask=kv_mask, scale=scale)

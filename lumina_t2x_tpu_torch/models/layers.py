"""Shared model building blocks (counterpart of
`lumina_t2x_tpu/models/layers.py`), as `nn.Module`s.

Conventions, as in the JAX package:
- parameters are stored in `param_dtype` (fp32 by default) and activations
  run in `dtype`: a `Linear` casts its weight to its input's dtype, as
  flax's `nn.Dense(dtype=...)` does;
- norms, RoPE and softmax are fp32 islands, and norm weights and the
  cross-attention gate are fp32 parameters at any `param_dtype`;
- parameter names follow the reference state-dict keys
  (`core/checkpoint.state_dict_from_jax_params`), so a converted state dict
  loads with `strict=True`.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..ops.attention import attention as attention_op
from ..ops.attention import default_attn_scale, resolve_impl
from ..ops.flash_attention import flash_lse_range, streams_kv
from ..ops.norms import layer_norm, rms_norm
from ..ops.rope import apply_rope


class Linear(nn.Linear):
    """nn.Linear whose parameters are cast to the input's dtype at use."""

    def forward(self, x):
        w = self.weight.to(x.dtype)
        b = self.bias.to(x.dtype) if self.bias is not None else None
        return F.linear(x, w, b)


def _linear(in_f, out_f, *, bias=True, init="xavier", device=None, dtype=torch.float32):
    lin = Linear(in_f, out_f, bias=bias, device=device, dtype=dtype)
    with torch.no_grad():
        if init == "xavier":
            nn.init.xavier_uniform_(lin.weight)
        elif init == "normal":
            nn.init.normal_(lin.weight, std=0.02)
        elif init == "zeros":
            nn.init.zeros_(lin.weight)
        else:
            raise ValueError(init)
        if lin.bias is not None:
            nn.init.zeros_(lin.bias)
    return lin


def modulate(x, scale):
    """x * (1 + scale); scale is (B, D), x is (B, S, D). (The JAX package's
    shift term serves the families not ported yet.)"""
    return x * (1.0 + scale[:, None, :]).to(x.dtype)


class RMSNorm(nn.Module):
    """RMSNorm with a learned fp32 gain, computed in fp32."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=torch.float32))

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps)


class LayerNorm(nn.Module):
    """LayerNorm in fp32, optional fp32 affine."""

    def __init__(self, dim: int, eps: float = 1e-6, use_affine: bool = True, device=None):
        super().__init__()
        self.eps = eps
        if use_affine:
            self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=torch.float32))
            self.bias = nn.Parameter(torch.zeros(dim, device=device, dtype=torch.float32))
        else:
            self.weight = self.bias = None

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


def timestep_embedding(t, dim: int, max_period: int = 10000):
    """Sinusoidal timestep embedding: cos then sin halves, fp32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class TimestepEmbedder(nn.Module):
    """Sinusoidal frequencies -> 2-layer SiLU MLP (`t_embedder.mlp.{0,2}`)."""

    def __init__(self, hidden_size: int, frequency_embedding_size: int = 256,
                 dtype=torch.float32, param_dtype=torch.float32, device=None):
        super().__init__()
        self.frequency_embedding_size = frequency_embedding_size
        self.dtype = dtype
        kw = dict(init="normal", device=device, dtype=param_dtype)
        self.mlp = nn.Sequential(_linear(frequency_embedding_size, hidden_size, **kw),
                                 nn.SiLU(), _linear(hidden_size, hidden_size, **kw))

    def forward(self, t):
        return self.mlp(timestep_embedding(t, self.frequency_embedding_size).to(self.dtype))


class CaptionEmbedder(nn.Sequential):
    """LayerNorm + zero-init projection of pooled caption features
    (`cap_embedder.0`, `cap_embedder.1`)."""

    def __init__(self, cap_feat_dim: int, hidden_size: int, param_dtype=torch.float32,
                 device=None):
        super().__init__(
            LayerNorm(cap_feat_dim, eps=1e-5, device=device),
            _linear(cap_feat_dim, hidden_size, init="zeros", device=device, dtype=param_dtype),
        )


def pooled_caption(cap_feats, cap_mask):
    """Masked mean over caption tokens."""
    m = cap_mask.float()[..., None]
    pooled = (cap_feats.float() * m).sum(dim=1) / m.sum(dim=1).clamp_min(1e-6)
    return pooled.to(cap_feats.dtype)


def ffn_hidden_size(hidden_dim: int, multiple_of: int, ffn_dim_multiplier=None) -> int:
    """LLaMA SwiGLU width: 2/3 of the nominal hidden, optional multiplier,
    rounded up to multiple_of."""
    hidden = int(2 * hidden_dim / 3)
    if ffn_dim_multiplier is not None:
        hidden = int(ffn_dim_multiplier * hidden)
    return multiple_of * ((hidden + multiple_of - 1) // multiple_of)


class FeedForward(nn.Module):
    """SwiGLU MLP: w2(silu(w1 x) * w3 x)."""

    def __init__(self, dim: int, hidden_dim: int, multiple_of: int = 256,
                 ffn_dim_multiplier=None, param_dtype=torch.float32, device=None):
        super().__init__()
        hidden = ffn_hidden_size(hidden_dim, multiple_of, ffn_dim_multiplier)
        kw = dict(bias=False, device=device, dtype=param_dtype)
        self.w1 = _linear(dim, hidden, **kw)
        self.w2 = _linear(hidden, dim, **kw)
        self.w3 = _linear(dim, hidden, **kw)

    def forward(self, x):
        return self.w2(F.silu(self.w1(x)) * self.w3(x))


class Attention(nn.Module):
    """Joint self-attention plus optional gated cross-attention to caption
    features (zero-init per-head tanh gate).

    `lse_recorder`: when a list is given and the self-attention streams
    (more than 1024 keys, `flash` impl), the module appends the (max, min)
    log-sum-exp of its self-attention rows (`flash_lse_range`): the
    static-max calibration probe (`pipelines/sample_lib.py`).
    """

    def __init__(self, dim: int, n_heads: int, n_kv_heads: Optional[int] = None,
                 qk_norm: bool = False, y_dim: int = 0, attn_impl: str = "auto",
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.n_heads = n_heads
        self.n_kv_heads = n_kv_heads or n_heads
        self.head_dim = dim // n_heads
        self.attn_impl = attn_impl
        self.qk_norm = qk_norm
        kw = dict(bias=False, device=device, dtype=param_dtype)
        self.wq = _linear(dim, n_heads * self.head_dim, **kw)
        self.wk = _linear(dim, self.n_kv_heads * self.head_dim, **kw)
        self.wv = _linear(dim, self.n_kv_heads * self.head_dim, **kw)
        self.wo = _linear(n_heads * self.head_dim, dim, **kw)
        nkw = dict(eps=1e-5, device=device)
        if qk_norm:
            self.q_norm = LayerNorm(n_heads * self.head_dim, **nkw)
            self.k_norm = LayerNorm(self.n_kv_heads * self.head_dim, **nkw)
        self.y_dim = y_dim
        if y_dim > 0:
            self.wk_y = _linear(y_dim, self.n_kv_heads * self.head_dim, **kw)
            self.wv_y = _linear(y_dim, self.n_kv_heads * self.head_dim, **kw)
            if qk_norm:
                self.ky_norm = LayerNorm(self.n_kv_heads * self.head_dim, **nkw)
            self.gate = nn.Parameter(torch.zeros(n_heads, device=device, dtype=torch.float32))

    def forward(self, x, x_mask, angles, y=None, y_mask=None,
                attn_scale: Optional[float] = None,
                lse_recorder: Optional[List[torch.Tensor]] = None):
        b, s, _ = x.shape
        hd, nh, nkv = self.head_dim, self.n_heads, self.n_kv_heads
        xq, xk, xv = self.wq(x), self.wk(x), self.wv(x)
        if self.qk_norm:
            xq, xk = self.q_norm(xq), self.k_norm(xk)
        xq = xq.reshape(b, s, nh, hd)
        xk = xk.reshape(b, s, nkv, hd)
        xv = xv.reshape(b, s, nkv, hd)
        if angles is not None:
            xq = apply_rope(xq, angles)
            xk = apply_rope(xk, angles)

        scale = attn_scale if attn_scale is not None else default_attn_scale(hd)
        impl = resolve_impl(self.attn_impl)
        out = attention_op(xq, xk, xv, kv_mask=x_mask, scale=scale, impl=impl)
        if lse_recorder is not None and impl == "flash" and streams_kv(xk.shape[1]):
            lse_recorder.append(flash_lse_range(xq, xk, xv, x_mask, scale))

        if self.y_dim > 0 and y is not None:
            yk = self.wk_y(y)
            if self.qk_norm:
                yk = self.ky_norm(yk)
            yv = self.wv_y(y)
            ly = y.shape[1]
            yk = yk.reshape(b, ly, nkv, hd)
            yv = yv.reshape(b, ly, nkv, hd)
            # cross-attention always uses the default 1/sqrt(d) scale
            out_y = attention_op(xq, yk, yv, kv_mask=y_mask, impl=impl)
            out = out + out_y * torch.tanh(self.gate).to(out.dtype)[None, None, :, None]

        return self.wo(out.reshape(b, s, nh * hd))


class FinalLayer(nn.Module):
    """Final LayerNorm + scale-only adaLN modulate + zero-init projection (the
    NextDiT T2I head; the JAX package's shift+scale variant belongs to the
    Flag-DiT and ImageNet families, not ported yet)."""

    def __init__(self, hidden_size: int, patch_size: int, out_channels: int,
                 cond_dim: int, param_dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(init="zeros", device=device, dtype=param_dtype)
        self.norm_final = LayerNorm(hidden_size, eps=1e-6, use_affine=False)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), _linear(cond_dim, hidden_size, **kw))
        self.linear = _linear(hidden_size, patch_size * patch_size * out_channels, **kw)

    def forward(self, x, c):
        return self.linear(modulate(self.norm_final(x), self.adaLN_modulation(c)))


def patchify(x, patch_size: int):
    """(B, C, H, W) -> (B, L, p*p*C) tokens, last dim ordered (C, ph, pw)."""
    b, c, h, w = x.shape
    p = patch_size
    x = x.reshape(b, c, h // p, p, w // p, p).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, (h // p) * (w // p), c * p * p)


def unpatchify(tokens, h: int, w: int, patch_size: int, out_channels: int):
    """(B, L, p*p*C_out) -> (B, C_out, H, W); token last dim ordered
    (ph, pw, C_out)."""
    b = tokens.shape[0]
    p = patch_size
    gh, gw = h // p, w // p
    x = tokens[:, : gh * gw].reshape(b, gh, gw, p, p, out_channels)
    x = torch.einsum("nhwpqc->nchpwq", x)
    return x.reshape(b, out_channels, h, w)


# -- activation rematerialisation ------------------------------------------------

_WEIGHT_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """Save every weight-matmul output (the 2-D `mm`/`addmm` a `Linear`
    lowers to; attention's batched products are `bmm` and are recomputed):
    the counterpart of `dots_with_no_batch_dims_saveable`."""
    return CheckpointPolicy.MUST_SAVE if op in _WEIGHT_MATMULS else CheckpointPolicy.PREFER_RECOMPUTE


def _dots_slim_policy(ctx, op, *args, **kwargs):
    """As `_dots_policy`, but recompute the expanding matmuls too (output
    larger than the activation input): in a DiT block exactly the FFN
    up-projections w1 and w3 (`_dots_slim_policy` of the JAX package)."""
    if op not in _WEIGHT_MATMULS:
        return CheckpointPolicy.PREFER_RECOMPUTE
    lhs, rhs = (args[0], args[1]) if op == torch.ops.aten.mm.default else (args[1], args[2])
    if rhs.shape[1] <= lhs.shape[1]:  # output no wider than the input
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


REMAT_POLICIES = {"full": None, "dots": _dots_policy, "dots_slim": _dots_slim_policy}


def maybe_remat(fn: Callable, remat: bool, policy: str = "dots") -> Callable:
    """Wrap a block's forward in non-reentrant `torch.utils.checkpoint` with
    a selective policy (counterpart of the JAX package's `maybe_remat`; the
    reference's `--checkpointing` is all-or-nothing full-block remat).

    policy:
      - "full": save nothing, recompute the whole block in the backward;
      - "dots" (default): keep every weight-matmul output, recompute the
        elementwise chains, norms and attention (whose kernels, launched
        through ctypes, re-run in the recompute);
      - "dots_slim": like "dots" but recompute the FFN up-projections too.
    Returns `fn` itself when `remat` is false."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy: {policy!r} (use 'full', 'dots' or 'dots_slim')")
    if not remat:
        return fn
    chosen = REMAT_POLICIES[policy]
    kwargs = {"use_reentrant": False}
    if chosen is not None:
        kwargs["context_fn"] = functools.partial(create_selective_checkpoint_contexts, chosen)
    return functools.partial(checkpoint, fn, **kwargs)

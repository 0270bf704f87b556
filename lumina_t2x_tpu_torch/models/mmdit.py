"""MMDiT, the Stable Diffusion 3 transformer (counterpart of
`lumina_t2x_tpu/models/mmdit.py`).

- image tokens: 2x2 patchify -> linear, plus the 2-D sin-cos position table
  of diffusers' convention (`sincos_pos_embed_2d`);
- context tokens: text features -> linear; pooled text + timestep -> the
  adaLN conditioning vector;
- each block modulates the two streams with their own 6-chunk adaLN,
  projects per-stream QKV with optional qk RMSNorm (eps 1e-6), runs joint
  attention over [context; image] through `ops/attention.attention` (the
  hand-written flash kernels on the card, their plain versions on the CPU;
  the JAX package calls its XLA `sdpa` there, the same function), splits
  back, and applies per-stream output projections and GELU (tanh) MLPs;
- the last block drops the context stream (context_pre_only); the final
  layer is an adaLN shift/scale and a zero-init linear to p^2 * C.

Parameter names follow the JAX module's (`x_embedder`, `blocks.<i>.x_q`,
`blocks.<i>.x_q_norm`, `final_adaLN`, ...): `core/checkpoint.
mmdit_state_dict_from_jax_params` carries JAX params across and
`codecs/mmdit_import.import_sd3_mmdit_weights` a diffusers state dict.
Pairs with `transport/mini.MiniODE(use_sd3=True)` and the DreamBooth trainer.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention as attention_op
from ..ops.norms import layer_norm, rms_norm
from .layers import TimestepEmbedder, _linear, modulate, patchify, unpatchify


@functools.lru_cache(maxsize=32)
def _pos_table(dim: int, gh: int, gw: int, max_size, base_size) -> np.ndarray:
    if max_size is None:
        ph = np.arange(gh, dtype=np.float64) * ((base_size / gh) if base_size else 1.0)
        pw = np.arange(gw, dtype=np.float64) * ((base_size / gw) if base_size else 1.0)
    else:
        if gh > max_size or gw > max_size:
            raise ValueError(f"grid ({gh},{gw}) exceeds pos_embed_max_size {max_size}")
        scale = (base_size or max_size) / max_size
        top, left = (max_size - gh) // 2, (max_size - gw) // 2
        ph = (top + np.arange(gh, dtype=np.float64)) * scale
        pw = (left + np.arange(gw, dtype=np.float64)) * scale

    def one_axis(pos, d):
        omega = 1.0 / 10000 ** (np.arange(d // 2, dtype=np.float64) / (d / 2.0))
        out = np.einsum("p,f->pf", pos, omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    ew, eh = one_axis(pw, dim // 2), one_axis(ph, dim // 2)
    grid = np.concatenate([np.repeat(ew[None], gh, 0), np.repeat(eh[:, None], gw, 1)], axis=-1)
    return grid.reshape(gh * gw, dim).astype(np.float32)


def sincos_pos_embed_2d(dim: int, gh: int, gw: int, max_size: Optional[int] = None,
                        base_size: Optional[int] = None, device=None) -> torch.Tensor:
    """(gh * gw, dim) fp32 2-D sin-cos position table in diffusers'
    convention (`PatchEmbed` / `get_2d_sincos_pos_embed`): the first dim/2
    channels encode the column (w) coordinate, the second half the row.
    With `max_size` (SD3: 192) positions come from a (max_size, max_size)
    grid scaled by base_size / max_size (SD3: 64 / 192), and the (gh, gw)
    window is centre-cropped out; without it positions are
    arange * base_size / g (plain arange without base_size)."""
    return torch.from_numpy(_pos_table(dim, gh, gw, max_size, base_size)).to(device)


class MMDiTBlock(nn.Module):
    def __init__(self, dim: int, n_heads: int, qk_norm: bool = True,
                 context_pre_only: bool = False, mlp_ratio: float = 4.0,
                 attn_impl: str = "auto", param_dtype=torch.float32, device=None):
        super().__init__()
        self.dim, self.n_heads, self.head_dim = dim, n_heads, dim // n_heads
        self.qk_norm, self.context_pre_only = qk_norm, context_pre_only
        self.attn_impl = attn_impl
        kw = dict(device=device, dtype=param_dtype)
        zeros = dict(init="zeros", **kw)
        hidden = int(dim * mlp_ratio)
        self.x_adaLN = _linear(dim, 6 * dim, **zeros)
        self.c_adaLN = _linear(dim, (2 if context_pre_only else 6) * dim, **zeros)
        for prefix in ("x", "c"):
            for name in ("q", "k", "v"):
                setattr(self, f"{prefix}_{name}", _linear(dim, dim, **kw))
            if qk_norm:
                for name in ("q", "k"):
                    setattr(self, f"{prefix}_{name}_norm", nn.Parameter(
                        torch.ones(self.head_dim, device=device, dtype=torch.float32)))
        self.x_proj = _linear(dim, dim, **kw)
        self.x_mlp_in = _linear(dim, hidden, **kw)
        self.x_mlp_out = _linear(hidden, dim, **kw)
        if not context_pre_only:
            self.c_proj = _linear(dim, dim, **kw)
            self.c_mlp_in = _linear(dim, hidden, **kw)
            self.c_mlp_out = _linear(hidden, dim, **kw)

    def _qkv(self, h, prefix):
        b, s, _ = h.shape
        shape = (b, s, self.n_heads, self.head_dim)
        q = getattr(self, f"{prefix}_q")(h).reshape(shape)
        k = getattr(self, f"{prefix}_k")(h).reshape(shape)
        v = getattr(self, f"{prefix}_v")(h).reshape(shape)
        if self.qk_norm:
            q = rms_norm(q, getattr(self, f"{prefix}_q_norm"), eps=1e-6)
            k = rms_norm(k, getattr(self, f"{prefix}_k_norm"), eps=1e-6)
        return q, k, v

    def _mlp(self, h, prefix):
        hidden = F.gelu(getattr(self, f"{prefix}_mlp_in")(h), approximate="tanh")
        return getattr(self, f"{prefix}_mlp_out")(hidden)

    def forward(self, x, c, cond):
        """x: image tokens (B, Sx, D); c: context tokens (B, Sc, D); cond:
        the (B, D) adaLN vector. Returns (x, c), c None when pre_only."""
        sx1, scx1, gx1, sx2, scx2, gx2 = self.x_adaLN(F.silu(cond)).chunk(6, dim=-1)
        c_chunks = self.c_adaLN(F.silu(cond)).chunk(2 if self.context_pre_only else 6, dim=-1)
        qx, kx, vx = self._qkv(modulate(layer_norm(x, eps=1e-6), scx1, sx1), "x")
        qc, kc, vc = self._qkv(modulate(layer_norm(c, eps=1e-6), c_chunks[1], c_chunks[0]), "c")
        # joint attention over [context; image]
        attn = attention_op(torch.cat([qc, qx], dim=1), torch.cat([kc, kx], dim=1),
                            torch.cat([vc, vx], dim=1), impl=self.attn_impl)
        b, sc = x.shape[0], c.shape[1]
        attn_c, attn_x = attn[:, :sc], attn[:, sc:]

        x = x + gx1[:, None, :].to(x.dtype) * self.x_proj(attn_x.reshape(b, -1, self.dim))
        x = x + gx2[:, None, :].to(x.dtype) * self._mlp(
            modulate(layer_norm(x, eps=1e-6), scx2, sx2), "x")
        if self.context_pre_only:
            return x, None
        c = c + c_chunks[2][:, None, :].to(c.dtype) * self.c_proj(attn_c.reshape(b, -1, self.dim))
        c = c + c_chunks[5][:, None, :].to(c.dtype) * self._mlp(
            modulate(layer_norm(c, eps=1e-6), c_chunks[4], c_chunks[3]), "c")
        return x, c


class MMDiT(nn.Module):
    """SD3-style dual-stream transformer over (B, C, H, W) latents and text.
    `dtype` is the activation dtype; parameters are stored in
    `param_dtype`."""

    def __init__(self, patch_size: int = 2, in_channels: int = 16, dim: int = 1536,
                 n_layers: int = 24, n_heads: int = 24, context_dim: int = 4096,
                 pooled_dim: int = 2048, out_channels: Optional[int] = None,
                 qk_norm: bool = True, pos_embed_max_size: Optional[int] = None,
                 pos_embed_base_size: Optional[int] = None, dtype=torch.float32,
                 param_dtype=torch.float32, attn_impl: str = "auto", device=None):
        super().__init__()
        self.patch_size, self.in_channels, self.dim = patch_size, in_channels, dim
        self.n_layers, self.n_heads, self.qk_norm = n_layers, n_heads, qk_norm
        self.out_channels = out_channels or in_channels
        self.pos_embed_max_size, self.pos_embed_base_size = pos_embed_max_size, pos_embed_base_size
        self.dtype, self.attn_impl = dtype, attn_impl
        kw = dict(device=device, dtype=param_dtype)
        self.x_embedder = _linear(patch_size * patch_size * in_channels, dim, **kw)
        self.context_embedder = _linear(context_dim, dim, **kw)
        self.t_embedder = TimestepEmbedder(dim, dtype=dtype, param_dtype=param_dtype,
                                           device=device)
        self.pooled_hidden = _linear(pooled_dim, dim, **kw)
        self.pooled_in = _linear(dim, dim, **kw)
        self.blocks = nn.ModuleList([
            MMDiTBlock(dim, n_heads, qk_norm=qk_norm, context_pre_only=(i == n_layers - 1),
                       attn_impl=attn_impl, param_dtype=param_dtype, device=device)
            for i in range(n_layers)])
        self.final_adaLN = _linear(dim, 2 * dim, init="zeros", **kw)
        self.final_linear = _linear(dim, patch_size * patch_size * self.out_channels,
                                    init="zeros", **kw)

    def set_attn_impl(self, impl: str) -> None:
        """Route every joint attention through `impl` ('flash', 'plain', 'xla')."""
        self.attn_impl = impl
        for block in self.blocks:
            block.attn_impl = impl

    def forward(self, x, t, context, pooled):
        """x (B, C, H, W); t (B,) timesteps in SD3's convention (~[0, 1000]);
        context (B, Sc, context_dim); pooled (B, pooled_dim). Returns the
        (B, C_out, H, W) fp32 prediction."""
        _, _, h, w = x.shape
        p = self.patch_size
        tokens = self.x_embedder(patchify(x.to(self.dtype), p))
        pos = sincos_pos_embed_2d(self.dim, h // p, w // p, self.pos_embed_max_size,
                                  self.pos_embed_base_size, device=x.device)
        tokens = tokens + pos[None].to(tokens.dtype)
        c = self.context_embedder(context.to(self.dtype))
        cond = self.t_embedder(t) + self.pooled_in(F.silu(self.pooled_hidden(
            pooled.to(self.dtype))))
        for block in self.blocks:
            tokens, c = block(tokens, c, cond)
        shift, scale = self.final_adaLN(F.silu(cond)).chunk(2, dim=-1)
        tokens = self.final_linear(modulate(layer_norm(tokens, eps=1e-6), scale, shift))
        return unpatchify(tokens, h, w, p, self.out_channels).float()


def MMDiT_SD3_Medium(**kwargs):
    """SD3-medium's shape: 24 layers, dim 1536, 24 heads, 16 latent channels,
    the 192 x 192 position table scaled by 64 / 192."""
    kwargs.setdefault("pos_embed_max_size", 192)
    kwargs.setdefault("pos_embed_base_size", 64)
    return MMDiT(patch_size=2, in_channels=16, dim=1536, n_layers=24, n_heads=24, **kwargs)

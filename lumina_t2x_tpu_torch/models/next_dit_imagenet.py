"""Class-conditional NextDiT for ImageNet (counterpart of
`lumina_t2x_tpu/models/next_dit_imagenet.py`).

SandwichNorm2 blocks: parameter-free fp32 RMSNorm inner norms
(`attention_norm1`, `ffn_norm1`) with scale-modulate, learned RMSNorm outer
norms (`attention_norm`, `ffn_norm`), a 4-chunk adaLN (scale, tanh gate; no
shift); timestep + label embedding as the conditioning; 2-D RoPE; a
shift+scale final layer. No cross-attention and no token mask. Parameter
names are the reference Next-DiT-ImageNet state-dict keys
(`core/checkpoint.imagenet_state_dict_from_jax_params`).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.attention import default_attn_scale
from ..ops.norms import rms_norm
from ..ops.rope import rope_angles_2d
from .layers import (
    Attention,
    FeedForward,
    FinalLayer,
    LabelEmbedder,
    RMSNorm,
    TimestepEmbedder,
    _linear,
    modulate,
    patchify,
    unpatchify,
)


class NextDiTImageNetBlock(nn.Module):
    """`TransformerBlockSandwichNorm2`."""

    def __init__(self, dim: int, n_heads: int, n_kv_heads: Optional[int], multiple_of: int,
                 ffn_dim_multiplier: Optional[float], norm_eps: float, qk_norm: bool,
                 attn_impl: str = "auto", param_dtype=torch.float32, device=None):
        super().__init__()
        self.norm_eps = norm_eps
        self.head_dim = dim // n_heads
        cond_dim = min(dim, 1024)
        self.adaLN_modulation = nn.Sequential(
            nn.SiLU(), _linear(cond_dim, 4 * dim, init="zeros", device=device, dtype=param_dtype))
        self.attention = Attention(dim, n_heads, n_kv_heads, qk_norm=qk_norm, attn_impl=attn_impl,
                                   param_dtype=param_dtype, device=device)
        self.attention_norm = RMSNorm(dim, eps=norm_eps, device=device)
        self.feed_forward = FeedForward(dim, 4 * dim, multiple_of, ffn_dim_multiplier,
                                        param_dtype=param_dtype, device=device)
        self.ffn_norm = RMSNorm(dim, eps=norm_eps, device=device)

    def forward(self, x, angles, adaln_input):
        scale_msa, gate_msa, scale_mlp, gate_mlp = self.adaLN_modulation(adaln_input).chunk(4, -1)
        attn_out = self.attention(modulate(rms_norm(x, None, self.norm_eps), scale_msa), None,
                                  angles, attn_scale=default_attn_scale(self.head_dim))
        x = x + torch.tanh(gate_msa)[:, None, :].to(x.dtype) * self.attention_norm(attn_out)
        mlp_out = self.feed_forward(modulate(rms_norm(x, None, self.norm_eps), scale_mlp))
        return x + torch.tanh(gate_mlp)[:, None, :].to(x.dtype) * self.ffn_norm(mlp_out)


class NextDiTImageNet(nn.Module):
    """See module docstring. `dtype` is the activation dtype; parameters are
    stored in `param_dtype`."""

    def __init__(self, patch_size: int = 2, in_channels: int = 4, dim: int = 4096,
                 n_layers: int = 32, n_heads: int = 32, n_kv_heads: Optional[int] = None,
                 multiple_of: int = 256, ffn_dim_multiplier: Optional[float] = None,
                 norm_eps: float = 1e-5, class_dropout_prob: float = 0.1,
                 num_classes: int = 1000, learn_sigma: bool = True, qk_norm: bool = False,
                 rope_theta: float = 10000.0, dtype=torch.float32, param_dtype=torch.float32,
                 attn_impl: str = "auto", device=None):
        super().__init__()
        self.patch_size = patch_size
        self.in_channels = in_channels
        self.dim = dim
        self.n_layers = n_layers
        self.n_heads = n_heads
        self.num_classes = num_classes
        self.learn_sigma = learn_sigma
        self.qk_norm = qk_norm
        self.rope_theta = rope_theta
        self.dtype = dtype
        cond_dim = min(dim, 1024)
        self.x_embedder = _linear(patch_size * patch_size * in_channels, dim, device=device,
                                  dtype=param_dtype)
        self.t_embedder = TimestepEmbedder(cond_dim, dtype=dtype, param_dtype=param_dtype,
                                           device=device)
        self.y_embedder = LabelEmbedder(num_classes, cond_dim, class_dropout_prob, dtype=dtype,
                                        param_dtype=param_dtype, device=device)
        self.layers = nn.ModuleList([
            NextDiTImageNetBlock(dim, n_heads, n_kv_heads, multiple_of, ffn_dim_multiplier,
                                 norm_eps, qk_norm, attn_impl=attn_impl, param_dtype=param_dtype,
                                 device=device)
            for _ in range(n_layers)
        ])
        self.final_layer = FinalLayer(dim, patch_size, self.out_channels, cond_dim,
                                      modulation="shift_scale", param_dtype=param_dtype,
                                      device=device)

    @property
    def out_channels(self):
        return self.in_channels * 2 if self.learn_sigma else self.in_channels

    def forward(self, x, t, y, *, rope_scaling_factor: float = 1.0, ntk_factor: float = 1.0,
                train: bool = False, force_drop_ids=None,
                generator: Optional[torch.Generator] = None):
        """x (B, C, H, W), t (B,) times in [0, 1], y (B,) integer labels.
        Returns the (B, in_channels, H, W) fp32 velocity. `generator` draws
        the label dropout under `train`."""
        b, c, h, w = x.shape
        p = self.patch_size
        head_dim = self.dim // self.n_heads
        gh, gw = h // p, w // p
        angles = rope_angles_2d(head_dim, gh, gw, self.rope_theta,
                                linear_factor=rope_scaling_factor, ntk_factor=ntk_factor,
                                device=x.device).reshape(gh * gw, head_dim // 2)

        tokens = self.x_embedder(patchify(x.to(self.dtype), p))
        adaln_input = self.t_embedder(t) + self.y_embedder(
            y, train=train, force_drop_ids=force_drop_ids, generator=generator)
        for layer in self.layers:
            tokens = layer(tokens, angles, adaln_input)
        tokens = self.final_layer(tokens, adaln_input)
        out = unpatchify(tokens, h, w, p, self.out_channels)
        if self.learn_sigma:
            out = out[:, : self.out_channels // 2]
        return out.float()


def forward_with_cfg(model: NextDiTImageNet, x, t, y, cfg_scale, num_cfg_channels: int = 3,
                     **kwargs):
    """Duplicated-half-batch CFG: the first half of x runs with the labels
    and the null labels of `y`; guidance is applied to the first
    `num_cfg_channels` channels only (3 of 4, as in the reference), the rest
    pass through."""
    half = x[: x.shape[0] // 2]
    out = model(torch.cat([half, half], dim=0), t, y, **kwargs)
    eps, rest = out[:, :num_cfg_channels], out[:, num_cfg_channels:]
    b = eps.shape[0] // 2
    cond_eps, uncond_eps = eps[:b], eps[b:]
    half_eps = uncond_eps + cfg_scale * (cond_eps - uncond_eps)
    return torch.cat([torch.cat([half_eps, half_eps], dim=0), rest], dim=1)


# -- configs -------------------------------------------------------------------


def NextDiT_ImageNet_Tiny_patch2(**kwargs):
    """~1M-param debug config: CLI smoke tests and CPU drives."""
    return NextDiTImageNet(patch_size=2, dim=64, n_layers=2, n_heads=4, multiple_of=16, **kwargs)


def NextDiT_ImageNet_Small_patch2(**kwargs):
    return NextDiTImageNet(patch_size=2, dim=384, n_layers=8, n_heads=8, multiple_of=64, **kwargs)


def NextDiT_ImageNet_600M_patch2(**kwargs):
    return NextDiTImageNet(patch_size=2, dim=1536, n_layers=16, n_heads=32, **kwargs)


def NextDiT_ImageNet_2B_patch2(**kwargs):
    return NextDiTImageNet(patch_size=2, dim=2304, n_layers=24, n_heads=32, **kwargs)


def NextDiT_ImageNet_3B_patch2(**kwargs):
    return NextDiTImageNet(patch_size=2, dim=3072, n_layers=32, n_heads=32, **kwargs)


def NextDiT_ImageNet_7B_patch2(**kwargs):
    return NextDiTImageNet(patch_size=2, dim=4096, n_layers=32, n_heads=32, **kwargs)

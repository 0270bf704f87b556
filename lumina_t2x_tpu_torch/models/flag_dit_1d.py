"""FlagDiT-1D (counterpart of `lumina_t2x_tpu/models/flag_dit_1d.py`): the
temporal denoiser of text-to-audio and text-to-music, a Flag-DiT over
(B, C, T) mel-spectrogram latents.

- `proj_in`: a linear embedding of the latent channels, one token per frame;
- 1-D RoPE over time with linear and NTK factors;
- conditioning = timestep embedding + LayerNorm(eps 1e-5)-projected mean of
  the context tokens (all of them valid);
- Flag-DiT blocks (`models/flag_dit.FlagDiTBlock`): 6-chunk adaLN whose
  input is the full hidden size, gated cross-attention to the context;
- final layer: affine-free LayerNorm (eps 1e-6), shift/scale adaLN, then a
  zero-init linear back to the latent channels. The output is fp32 (B, C, T).

Parameter names are the reference state-dict keys (`proj_in`,
`t_embedder.mlp.*`, `cap_embedder.{0,1}`, `blocks.<i>.*`, `final_layer.*`):
`core/checkpoint.import_flag_dit_1d_weights` reads a reference file and
`flag_dit_1d_state_dict_from_jax_params` carries a JAX tree across. The
adaLN and final layer start at zero, as in the reference's DiT-style scheme.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.attention import default_attn_scale, proportional_attn_scale
from ..ops.rope import rope_angles_1d
from .flag_dit import FlagDiTBlock
from .layers import FinalLayer, LayerNorm, TimestepEmbedder, _linear, maybe_remat, pooled_caption


class FlagDiT1D(nn.Module):
    """(B, C, T) latents, (B,) times in [0, 1000), (B, L, context_dim)
    context -> (B, C, T) fp32 velocity."""

    def __init__(self, in_channels: int, context_dim: int, hidden_size: int = 1152,
                 depth: int = 28, num_heads: int = 16, max_len: int = 1000,
                 n_kv_heads: Optional[int] = None, multiple_of: int = 256,
                 ffn_dim_multiplier: Optional[float] = None, norm_eps: float = 1e-5,
                 qk_norm: bool = False, rope_theta: float = 10000.0,
                 rope_scaling_factor: float = 1.0, ntk_factor: float = 1.0,
                 dtype=torch.float32, param_dtype=torch.float32, attn_impl: str = "auto",
                 remat: bool = False, remat_policy: str = "dots", device=None):
        super().__init__()
        maybe_remat(None, False, remat_policy)  # rejects an unknown policy
        self.in_channels = in_channels
        self.hidden_size = hidden_size
        self.num_heads = num_heads
        self.max_len = max_len
        self.rope_theta = rope_theta
        self.rope_scaling_factor = rope_scaling_factor
        self.ntk_factor = ntk_factor
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.remat = remat
        self.remat_policy = remat_policy
        pk = dict(device=device, dtype=param_dtype)
        self.proj_in = _linear(in_channels, hidden_size, **pk)
        self.t_embedder = TimestepEmbedder(hidden_size, dtype=dtype, param_dtype=param_dtype,
                                           device=device)
        self.cap_embedder = nn.Sequential(LayerNorm(context_dim, eps=1e-5, device=device),
                                          _linear(context_dim, hidden_size, **pk))
        self.blocks = nn.ModuleList([
            FlagDiTBlock(hidden_size, num_heads, n_kv_heads, multiple_of, ffn_dim_multiplier,
                         norm_eps, qk_norm, context_dim, attn_impl=attn_impl,
                         param_dtype=param_dtype, device=device, cond_dim=hidden_size)
            for _ in range(depth)
        ])
        self.final_layer = FinalLayer(hidden_size, 1, in_channels, hidden_size,
                                      modulation="shift_scale", param_dtype=param_dtype,
                                      device=device)

    def set_attn_impl(self, impl: str) -> None:
        """Route every attention site through `impl` ('flash', 'plain', 'xla')."""
        self.attn_impl = impl
        for block in self.blocks:
            block.attention.attn_impl = impl

    def forward(self, x, t, context, *, proportional_attn: bool = False,
                base_seqlen: Optional[int] = None):
        b, _, seq = x.shape
        head_dim = self.hidden_size // self.num_heads
        h = self.proj_in(x.to(self.dtype).transpose(1, 2))  # (B, T, hidden)
        angles = rope_angles_1d(head_dim, torch.arange(seq), self.rope_theta,
                                linear_factor=self.rope_scaling_factor,
                                ntk_factor=self.ntk_factor, device=x.device)
        context = context.to(self.dtype)
        # every context token is valid: the pooled mean is a plain mean and
        # the cross-attention runs unmasked
        cap_mask = torch.ones(context.shape[:2], dtype=torch.int32, device=x.device)
        cond = self.t_embedder(t) + self.cap_embedder(pooled_caption(context, cap_mask))
        attn_scale = (proportional_attn_scale(seq, base_seqlen, head_dim)
                      if proportional_attn and base_seqlen else default_attn_scale(head_dim))
        remat = self.remat and torch.is_grad_enabled()
        for block in self.blocks:
            h = maybe_remat(block, remat, self.remat_policy)(
                h, None, angles, context, None, cond, attn_scale)
        return self.final_layer(h, cond).transpose(1, 2).float()

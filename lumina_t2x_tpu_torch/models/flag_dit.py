"""Flag-DiT (counterpart of `lumina_t2x_tpu/models/flag_dit.py`): the
LLaMA-style DiT of the 5B text-to-image model (`DiT_Llama_5B_patch2`) and
its class-conditional ImageNet variants.

- 1-D RoPE over the whole token sequence, with linear and NTK factors;
- a learnable `[eol]` column appended to each row of patches (text model),
  so an item holds (H/p) * (W/p + 1) tokens; the head drops it again;
- pre-norm blocks with a 6-chunk adaLN (shift, scale, gate for attention and
  FFN), gates not tanh'd, and the gated zero-init cross-attention to the
  caption features of the port's `layers.Attention`;
- class-conditional (`num_classes > 0`): a label embedding in place of the
  pooled caption, no cross-attention, labels taken as the keyword `y`;
- a shift+scale final layer.

Parameter names are the reference `DiT_Llama` state-dict keys, the ones the
JAX package's `import_flag_dit_weights` reads (its `pad_token` and
`freqs_cis` have no counterpart here, as in JAX), so a reference `.pth` /
`.safetensors` loads with `init_from`; `core/checkpoint.flag_dit_state_dict_from_jax_params`
carries a JAX tree across. With `remat` each block runs under
`torch.utils.checkpoint` with the `remat_policy` of `layers.maybe_remat`
while gradients are enabled.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from ..ops.attention import default_attn_scale, proportional_attn_scale
from ..ops.rope import rope_angles_1d
from .layers import (
    Attention,
    CaptionEmbedder,
    FeedForward,
    FinalLayer,
    LabelEmbedder,
    RMSNorm,
    TimestepEmbedder,
    _linear,
    cfg_mix,
    maybe_remat,
    modulate,
    patchify,
    pooled_caption,
    unpatchify,
)


class FlagDiTBlock(nn.Module):
    """Pre-norm block with a 6-chunk adaLN whose gates are not tanh'd."""

    def __init__(self, dim: int, n_heads: int, n_kv_heads: Optional[int], multiple_of: int,
                 ffn_dim_multiplier: Optional[float], norm_eps: float, qk_norm: bool,
                 y_dim: int, attn_impl: str = "auto", param_dtype=torch.float32, device=None):
        super().__init__()
        cond_dim = min(dim, 1024)
        self.adaLN_modulation = nn.Sequential(
            nn.SiLU(), _linear(cond_dim, 6 * dim, init="zeros", device=device, dtype=param_dtype))
        nk = dict(eps=norm_eps, device=device)
        if y_dim > 0:
            self.attention_y_norm = RMSNorm(y_dim, **nk)
        self.attention = Attention(dim, n_heads, n_kv_heads, qk_norm=qk_norm, y_dim=y_dim,
                                   attn_impl=attn_impl, param_dtype=param_dtype, device=device)
        self.attention_norm = RMSNorm(dim, **nk)
        self.feed_forward = FeedForward(dim, 4 * dim, multiple_of, ffn_dim_multiplier,
                                        param_dtype=param_dtype, device=device)
        self.ffn_norm = RMSNorm(dim, **nk)

    def forward(self, x, x_mask, angles, y, y_mask, adaln_input, attn_scale=None,
                lse_recorder: Optional[List[torch.Tensor]] = None):
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = \
            self.adaLN_modulation(adaln_input).chunk(6, dim=-1)
        y_normed = self.attention_y_norm(y) if y is not None else None
        attn_out = self.attention(
            modulate(self.attention_norm(x), scale_msa, shift_msa), x_mask, angles, y_normed,
            y_mask, attn_scale, lse_recorder)
        x = x + gate_msa[:, None, :].to(x.dtype) * attn_out
        mlp_out = self.feed_forward(modulate(self.ffn_norm(x), scale_mlp, shift_mlp))
        return x + gate_mlp[:, None, :].to(x.dtype) * mlp_out


class FlagDiT(nn.Module):
    """See module docstring. `cap_feat_dim > 0` (and `num_classes == 0`): the
    text model; `num_classes > 0`: class-conditional. `dtype` is the
    activation dtype; parameters are stored in `param_dtype`."""

    def __init__(self, patch_size: int = 2, in_channels: int = 4, dim: int = 4096,
                 n_layers: int = 32, n_heads: int = 32, n_kv_heads: Optional[int] = None,
                 multiple_of: int = 256, ffn_dim_multiplier: Optional[float] = None,
                 norm_eps: float = 1e-5, learn_sigma: bool = True, qk_norm: bool = False,
                 cap_feat_dim: int = 0, num_classes: int = 0, class_dropout_prob: float = 0.1,
                 rope_theta: float = 10000.0, use_eol_token: bool = True,
                 dtype=torch.float32, param_dtype=torch.float32, attn_impl: str = "auto",
                 remat: bool = False, remat_policy: str = "dots", device=None):
        super().__init__()
        maybe_remat(None, False, remat_policy)  # rejects an unknown policy
        self.patch_size = patch_size
        self.in_channels = in_channels
        self.dim = dim
        self.n_layers = n_layers
        self.n_heads = n_heads
        self.learn_sigma = learn_sigma
        self.qk_norm = qk_norm
        self.num_classes = num_classes
        self.cap_feat_dim = cap_feat_dim if num_classes == 0 else 0
        self.rope_theta = rope_theta
        self.use_eol_token = use_eol_token
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.remat = remat
        self.remat_policy = remat_policy
        cond_dim = min(dim, 1024)
        pk = dict(device=device, dtype=param_dtype)

        self.x_embedder = _linear(patch_size * patch_size * in_channels, dim, **pk)
        if use_eol_token:
            self.eol_token = nn.Parameter(torch.empty(dim, **pk))
            nn.init.normal_(self.eol_token, std=0.02)
        self.t_embedder = TimestepEmbedder(cond_dim, dtype=dtype, param_dtype=param_dtype,
                                           device=device)
        if num_classes > 0:
            self.y_embedder = LabelEmbedder(num_classes, cond_dim, class_dropout_prob,
                                            dtype=dtype, param_dtype=param_dtype, device=device)
        else:
            self.cap_embedder = CaptionEmbedder(cap_feat_dim, cond_dim, param_dtype=param_dtype,
                                                device=device)
        self.layers = nn.ModuleList([
            FlagDiTBlock(dim, n_heads, n_kv_heads, multiple_of, ffn_dim_multiplier, norm_eps,
                         qk_norm, self.cap_feat_dim, attn_impl=attn_impl,
                         param_dtype=param_dtype, device=device)
            for _ in range(n_layers)
        ])
        self.final_layer = FinalLayer(dim, patch_size, self.out_channels, cond_dim,
                                      modulation="shift_scale", param_dtype=param_dtype,
                                      device=device)

    @property
    def out_channels(self):
        return self.in_channels * 2 if self.learn_sigma else self.in_channels

    def set_attn_impl(self, impl: str) -> None:
        """Route every attention site through `impl` ('flash', 'plain', 'xla')."""
        self.attn_impl = impl
        for layer in self.layers:
            layer.attention.attn_impl = impl

    def forward(self, x, t, cap_feats=None, cap_mask=None, y=None, *,
                rope_scaling_factor: float = 1.0, ntk_factor: float = 1.0,
                proportional_attn: bool = False, base_seqlen: Optional[int] = None,
                train: bool = False, force_drop_ids=None,
                generator: Optional[torch.Generator] = None,
                lse_recorder: Optional[List[torch.Tensor]] = None):
        """x (B, C, H, W), t (B,) times in [0, 1]; the text model takes
        cap_feats (B, Ly, cap_feat_dim) and cap_mask (B, Ly), the
        class-conditional one the (B,) labels `y` (a keyword: the third
        positional slot is cap_feats), whose dropout under `train` is drawn
        from `generator`. Returns the (B, in_channels, H, W) fp32 velocity."""
        b, c, h, w = x.shape
        p = self.patch_size
        head_dim = self.dim // self.n_heads
        gh, gw = h // p, w // p

        tokens = self.x_embedder(patchify(x.to(self.dtype), p))
        if self.use_eol_token:
            eol = self.eol_token.to(tokens.dtype).expand(b, gh, 1, self.dim)
            tokens = torch.cat([tokens.reshape(b, gh, gw, self.dim), eol], dim=2)
            tokens = tokens.reshape(b, gh * (gw + 1), self.dim)
        seq_len = tokens.shape[1]
        angles = rope_angles_1d(head_dim, torch.arange(seq_len), self.rope_theta,
                                linear_factor=rope_scaling_factor, ntk_factor=ntk_factor,
                                device=x.device)

        t_emb = self.t_embedder(t)
        if self.num_classes > 0:
            cond = t_emb + self.y_embedder(y, train=train, force_drop_ids=force_drop_ids,
                                           generator=generator)
            cap_feats_c = cap_mask_c = None
        else:
            cond = t_emb + self.cap_embedder(pooled_caption(cap_feats.to(self.dtype), cap_mask))
            cap_feats_c, cap_mask_c = cap_feats.to(self.dtype), cap_mask

        attn_scale = (proportional_attn_scale(seq_len, base_seqlen, head_dim)
                      if proportional_attn and base_seqlen else default_attn_scale(head_dim))
        remat = self.remat and torch.is_grad_enabled()
        for layer in self.layers:
            tokens = maybe_remat(layer, remat, self.remat_policy)(
                tokens, None, angles, cap_feats_c, cap_mask_c, cond, attn_scale, lse_recorder)

        tokens = self.final_layer(tokens, cond)
        if self.use_eol_token:  # drop the [eol] column
            tokens = tokens.reshape(b, gh, gw + 1, -1)[:, :, :gw].reshape(b, gh * gw, -1)
        out = unpatchify(tokens, h, w, p, self.out_channels)
        if self.learn_sigma:
            out = out[:, : self.out_channels // 2]
        return out.float()


def forward_with_cfg(model: FlagDiT, x, t, cfg_scale, num_cfg_channels: int = 3,
                     rope_scaling_factor: float = 1.0, ntk_factor: float = 1.0,
                     **cond_kwargs):
    """Duplicated-half-batch CFG: the first half of x runs with the
    conditional and the unconditional rows of `cond_kwargs` (cap_feats /
    cap_mask, or y), which also carry `proportional_attn`, `base_seqlen`
    and `lse_recorder`; guidance is applied to the first `num_cfg_channels`
    channels."""
    half = x[: x.shape[0] // 2]
    out = model(torch.cat([half, half], dim=0), t, rope_scaling_factor=rope_scaling_factor,
                ntk_factor=ntk_factor, **cond_kwargs)
    return cfg_mix(out, cfg_scale, num_cfg_channels)


# -- configs -------------------------------------------------------------------


def FlagDiT_5B_patch2(**kwargs):
    """`DiT_Llama_5B_patch2`: caption features 4096 wide (LLaMA-2-7B's) unless
    `cap_feat_dim` says otherwise."""
    kwargs.setdefault("cap_feat_dim", 4096)
    return FlagDiT(patch_size=2, dim=3072, n_layers=32, n_heads=32, **kwargs)


def FlagDiT_ImageNet_600M_patch2(**kwargs):
    kwargs.setdefault("num_classes", 1000)
    return FlagDiT(patch_size=2, dim=1536, n_layers=16, n_heads=32, use_eol_token=False,
                   **kwargs)


def FlagDiT_ImageNet_3B_patch2(**kwargs):
    kwargs.setdefault("num_classes", 1000)
    return FlagDiT(patch_size=2, dim=3072, n_layers=32, n_heads=32, use_eol_token=False,
                   **kwargs)


def FlagDiT_ImageNet_7B_patch2(**kwargs):
    kwargs.setdefault("num_classes", 1000)
    return FlagDiT(patch_size=2, dim=4096, n_layers=32, n_heads=32, use_eol_token=False,
                   **kwargs)

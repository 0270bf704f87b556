"""NextDiT text-to-image denoiser (counterpart of
`lumina_t2x_tpu/models/next_dit.py`): the uniform-grid path and the
variable-aspect `img_sizes` list path.

Sandwich RMSNorm around attention and FFN, 4-chunk adaLN (scale + tanh
gate), gated zero-init cross-attention to caption features, 2-D RoPE with
time-aware scaling and the proportional attention scale. The blocks run as a
plain Python loop over `layers`; with `remat` each block runs under
`torch.utils.checkpoint` with the `remat_policy` of `layers.maybe_remat`
whenever autograd is on.

`kv_merge_ratio > 1` average-pools the self-attention's rotated K and V over
the token grid (`ops/attention.pool_kv_2d`, the visual-anagrams trick).

`seq_shard_axis` (with `seq_shard_mesh`, a `DeviceMesh`; without one the
whole default process group) splits the image tokens over that axis's ranks:
each rank embeds and runs its S / n tokens with the RoPE angles of their
global positions, the self-attention sees every rank's keys through the
all-gather of `ops/context_parallel`, and the output tokens are gathered
before unpatchify, so every rank returns the whole output. Parameter
gradients of such a forward are each rank's share; a trainer sums them over
the axis.

`img_sizes` (the reference's list path): the batch is padded to one bucket
(H, W) and item i holds an (H_i, W_i) latent in its top-left corner. Each
item's H_i/p x W_i/p tokens are gathered to the front of its row (row-major
over its own grid), the rest of the row is `pad_token`, `x_mask` (the
self-attention's key mask) marks the item's tokens, and the RoPE angles are
the item's grid positions', (B, L, head_dim/2), the last row repeated over
the padding. The output is scattered back to the bucket's grid with the
positions outside the item zeroed. (JAX's scatter reads its validity mask
at the wrong index and leaves token 0's output there; ROADMAP's reference
caveats.) `kv_merge_ratio > 1` and sequence sharding take the uniform grid
only.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..ops.attention import anagram_attn_scale, default_attn_scale, proportional_attn_scale
from ..ops.rope import rope_angles_2d_timeaware
from ..parallel.comm import gather_replicated
from ..parallel.mesh import axis_group
from .layers import (
    REMAT_POLICIES,
    Attention,
    CaptionEmbedder,
    FeedForward,
    FinalLayer,
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


class NextDiTBlock(nn.Module):
    """Sandwich-norm transformer block with 4-chunk adaLN; its attention
    module is an `attention_cls`."""

    attention_cls = Attention

    def __init__(self, dim: int, n_heads: int, n_kv_heads: Optional[int], multiple_of: int,
                 ffn_dim_multiplier: Optional[float], norm_eps: float, qk_norm: bool,
                 y_dim: int, attn_impl: str = "auto", param_dtype=torch.float32, device=None):
        super().__init__()
        cond_dim = min(dim, 1024)
        self.adaLN_modulation = nn.Sequential(
            nn.SiLU(), _linear(cond_dim, 4 * dim, init="zeros", device=device, dtype=param_dtype))
        nk = dict(eps=norm_eps, device=device)
        self.attention_y_norm = RMSNorm(y_dim, **nk)
        self.attention = self.attention_cls(dim, n_heads, n_kv_heads, qk_norm=qk_norm,
                                            y_dim=y_dim, attn_impl=attn_impl,
                                            param_dtype=param_dtype, device=device)
        self.attention_norm1 = RMSNorm(dim, **nk)
        self.attention_norm2 = RMSNorm(dim, **nk)
        self.feed_forward = FeedForward(dim, 4 * dim, multiple_of, ffn_dim_multiplier,
                                        param_dtype=param_dtype, device=device)
        self.ffn_norm1 = RMSNorm(dim, **nk)
        self.ffn_norm2 = RMSNorm(dim, **nk)

    def forward(self, x, x_mask, angles, y, y_mask, adaln_input, attn_scale=None,
                lse_recorder: Optional[List[torch.Tensor]] = None, kv_merge=None):
        mod = self.adaLN_modulation(adaln_input)
        scale_msa, gate_msa, scale_mlp, gate_mlp = mod.chunk(4, dim=-1)
        y_normed = self.attention_y_norm(y) if y is not None else None
        attn_out = self.attention(
            modulate(self.attention_norm1(x), scale_msa), x_mask, angles, y_normed, y_mask,
            attn_scale, lse_recorder, kv_merge)
        x = x + torch.tanh(gate_msa)[:, None, :].to(x.dtype) * self.attention_norm2(attn_out)
        mlp_out = self.feed_forward(modulate(self.ffn_norm1(x), scale_mlp))
        return x + torch.tanh(gate_mlp)[:, None, :].to(x.dtype) * self.ffn_norm2(mlp_out)


class NextDiT(nn.Module):
    """See module docstring. `dtype` is the activation dtype; parameters are
    stored in `param_dtype`; the layers are `block_cls` blocks."""

    block_cls = NextDiTBlock

    def __init__(self, patch_size: int = 2, in_channels: int = 4, dim: int = 4096,
                 n_layers: int = 32, n_heads: int = 32, n_kv_heads: Optional[int] = None,
                 multiple_of: int = 256, ffn_dim_multiplier: Optional[float] = None,
                 norm_eps: float = 1e-5, learn_sigma: bool = True, qk_norm: bool = False,
                 cap_feat_dim: int = 5120, rope_theta: float = 10000.0,
                 dtype=torch.float32, param_dtype=torch.float32, attn_impl: str = "auto",
                 remat: bool = False, remat_policy: str = "dots",
                 seq_shard_axis: Optional[str] = None, seq_shard_mesh=None, device=None):
        super().__init__()
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat policy: {remat_policy!r} "
                             f"(use one of {sorted(REMAT_POLICIES)})")
        self.patch_size = patch_size
        self.in_channels = in_channels
        self.dim = dim
        self.n_layers = n_layers
        self.n_heads = n_heads
        self.n_kv_heads = n_kv_heads
        self.learn_sigma = learn_sigma
        self.qk_norm = qk_norm
        self.cap_feat_dim = cap_feat_dim
        self.rope_theta = rope_theta
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.remat = remat
        self.remat_policy = remat_policy
        cond_dim = min(dim, 1024)
        pk = dict(device=device, dtype=param_dtype)

        self.x_embedder = _linear(patch_size * patch_size * in_channels, dim, **pk)
        self.pad_token = nn.Parameter(torch.empty(dim, **pk))
        nn.init.normal_(self.pad_token, std=0.02)
        self.t_embedder = TimestepEmbedder(cond_dim, dtype=dtype, param_dtype=param_dtype,
                                           device=device)
        self.cap_embedder = CaptionEmbedder(cap_feat_dim, cond_dim, param_dtype=param_dtype,
                                            device=device)
        self.layers = nn.ModuleList([
            self.block_cls(dim, n_heads, n_kv_heads, multiple_of, ffn_dim_multiplier, norm_eps,
                           qk_norm, cap_feat_dim, attn_impl=attn_impl, param_dtype=param_dtype,
                           device=device)
            for _ in range(n_layers)
        ])
        self.final_layer = FinalLayer(dim, patch_size, self.out_channels, cond_dim,
                                      param_dtype=param_dtype, device=device)
        self.seq_group = None
        if seq_shard_axis is not None:
            self.seq_group = axis_group(seq_shard_mesh, seq_shard_axis if seq_shard_mesh
                                        is not None else None)
            for layer in self.layers:
                layer.attention.seq_group = self.seq_group

    @property
    def out_channels(self):
        return self.in_channels * 2 if self.learn_sigma else self.in_channels

    def set_attn_impl(self, impl: str) -> None:
        """Route every attention site through `impl` ('flash', 'plain', 'xla')."""
        self.attn_impl = impl
        for layer in self.layers:
            layer.attention.attn_impl = impl

    def forward(self, x, t, cap_feats, cap_mask, *, img_sizes=None, rope_timestep=1.0,
                scale_factor: float = 1.0, scale_watershed: float = 1.0,
                proportional_attn: bool = False, base_seqlen: Optional[int] = None,
                attn_scale_variant: str = "proportional", kv_merge_ratio: int = 1,
                lse_recorder: Optional[List[torch.Tensor]] = None, train: bool = False):
        """Denoise step: x (B, C, H, W) latents, t (B,) times in [0, 1],
        cap_feats (B, Ly, cap_feat_dim), cap_mask (B, Ly). `img_sizes`: the
        per-item (H_i, W_i) latent sizes of a padded bucket batch (module
        docstring). Returns the (B, C, H, W) fp32 velocity. `train` is
        accepted and unused, as in the JAX t2i model (it has no dropout)."""
        b, c, h, w = x.shape
        p = self.patch_size
        head_dim = self.dim // self.n_heads
        gh, gw = h // p, w // p
        seq_len = gh * gw
        kv_merge = None
        if img_sizes is not None and (kv_merge_ratio > 1 or self.seq_group is not None):
            raise ValueError("kv_merge_ratio and sequence sharding take the uniform grid: "
                             "pass img_sizes=None")
        if kv_merge_ratio > 1:
            if gh % kv_merge_ratio or gw % kv_merge_ratio:
                raise ValueError(f"kv_merge_ratio {kv_merge_ratio} does not divide the "
                                 f"{gh} x {gw} token grid")
            kv_merge = (gh, gw, kv_merge_ratio)

        angles = rope_angles_2d_timeaware(
            head_dim, gh, gw, self.rope_theta, scale_factor=scale_factor,
            scale_watershed=scale_watershed, timestep=rope_timestep, device=x.device,
        ).reshape(seq_len, head_dim // 2)

        patches = patchify(x.to(self.dtype), p)
        if self.seq_group is not None:  # this rank's tokens, at their global positions
            if kv_merge is not None:
                raise ValueError("kv_merge_ratio does not run on a sequence-sharded model")
            n, r = dist.get_world_size(self.seq_group), dist.get_rank(self.seq_group)
            if seq_len % n:
                raise ValueError(f"{seq_len} tokens do not split over {n} sequence ranks")
            rows = slice(r * (seq_len // n), (r + 1) * (seq_len // n))
            patches, angles = patches[:, rows], angles[rows]
        tokens = self.x_embedder(patches)
        x_mask = None  # uniform grid: every image token is valid
        if img_sizes is not None:
            gather, x_mask, angles, scatter, grid_valid = _list_layout(
                img_sizes, b, gh, gw, p, angles, x.device)
            tokens = torch.gather(tokens, 1, gather[:, :, None].expand(-1, -1, tokens.shape[-1]))
            tokens = torch.where(x_mask[:, :, None].bool(), tokens,
                                 self.pad_token.to(tokens.dtype))

        adaln_input = self.t_embedder(t) + self.cap_embedder(
            pooled_caption(cap_feats.to(self.dtype), cap_mask))

        if proportional_attn and base_seqlen:
            scale_fn = (anagram_attn_scale if attn_scale_variant == "anagram"
                        else proportional_attn_scale)
            attn_scale = scale_fn(seq_len, base_seqlen, head_dim)
        else:
            attn_scale = default_attn_scale(head_dim)

        cap_feats_c = cap_feats.to(self.dtype)
        remat = self.remat and torch.is_grad_enabled()
        for layer in self.layers:
            tokens = maybe_remat(layer, remat, self.remat_policy)(
                tokens, x_mask, angles, cap_feats_c, cap_mask, adaln_input, attn_scale,
                lse_recorder, kv_merge)

        tokens = self.final_layer(tokens, adaln_input)
        tokens = gather_replicated(tokens, self.seq_group, dim=1)
        if img_sizes is not None:  # back to the bucket's grid, zero outside each item
            tokens = torch.gather(tokens, 1, scatter[:, :, None].expand(-1, -1, tokens.shape[-1]))
            tokens = tokens * grid_valid[:, :, None].to(tokens.dtype)
        out = unpatchify(tokens, h, w, p, self.out_channels)
        if self.learn_sigma:
            out = out[:, : self.out_channels // 2]
        return out.float()


def _list_layout(img_sizes, b: int, gh: int, gw: int, p: int, angles, device):
    """The list path's index tensors on `device`: `gather` (B, L) takes each
    item's tokens (row-major over its own grid) to the front of its row and
    repeats its last token after them; `x_mask` (B, L) int32 marks those
    tokens; `angles` (B, L, d/2) are their grid positions' angles, the last
    row repeated; `scatter` (B, L) sends each grid position back to its
    token (0 outside the item) and `grid_valid` (B, L) marks the item's grid
    positions."""
    if len(img_sizes) != b:
        raise ValueError(f"img_sizes has {len(img_sizes)} items for a batch of {b}")
    seq_len = gh * gw
    gather, mask, scatter, valid = (np.zeros((b, seq_len), np.int64) for _ in range(4))
    for i, (hi, wi) in enumerate(img_sizes):
        ghi, gwi = hi // p, wi // p
        if not (0 < ghi <= gh and 0 < gwi <= gw):
            raise ValueError(f"item {i}: latent {hi}x{wi} is not inside the {gh * p}x{gw * p} "
                             f"bucket")
        idx = (np.arange(ghi)[:, None] * gw + np.arange(gwi)[None, :]).reshape(-1)
        n = idx.shape[0]
        gather[i, :n], gather[i, n:] = idx, idx[-1]
        mask[i, :n] = 1
        scatter[i, idx] = np.arange(n)
        valid[i, idx] = 1
    gather_t = torch.from_numpy(gather).to(device)
    item_angles = angles[gather_t]  # a padded token repeats the last token's angles
    return (gather_t, torch.from_numpy(mask).to(device, torch.int32), item_angles,
            torch.from_numpy(scatter).to(device), torch.from_numpy(valid).to(device))


def forward_with_cfg(model: NextDiT, x, t, cap_feats, cap_mask, cfg_scale, *,
                     scale_factor: float = 1.0, scale_watershed: float = 1.0,
                     base_seqlen: Optional[int] = None, proportional_attn: bool = False,
                     attn_scale_variant: str = "proportional", kv_merge_ratio: int = 1,
                     num_cfg_channels: int = 3,
                     lse_recorder: Optional[List[torch.Tensor]] = None):
    """Duplicated-half-batch CFG forward: the first half of x runs with the
    conditional and the unconditional caption rows; guidance is applied to
    the first `num_cfg_channels` channels."""
    half = x[: x.shape[0] // 2]
    combined = torch.cat([half, half], dim=0)
    out = model(combined, t, cap_feats, cap_mask, rope_timestep=t[0],
                scale_factor=scale_factor, scale_watershed=scale_watershed,
                proportional_attn=proportional_attn, base_seqlen=base_seqlen,
                attn_scale_variant=attn_scale_variant, kv_merge_ratio=kv_merge_ratio,
                lse_recorder=lse_recorder)
    return cfg_mix(out, cfg_scale, num_cfg_channels)


# -- configs -------------------------------------------------------------------


def NextDiT_2B_patch2(**kwargs):
    return NextDiT(patch_size=2, dim=2304, n_layers=24, n_heads=32, **kwargs)


def NextDiT_2B_GQA_patch2(**kwargs):
    return NextDiT(patch_size=2, dim=2304, n_layers=24, n_heads=32, n_kv_heads=8, **kwargs)


def NextDiT_600M_patch2(**kwargs):
    return NextDiT(patch_size=2, dim=1536, n_layers=16, n_heads=32, **kwargs)


def NextDiT_Tiny_patch2(**kwargs):
    """~1M-param debug config for smoke tests of the CLI."""
    return NextDiT(patch_size=2, dim=64, n_layers=2, n_heads=4, multiple_of=16, **kwargs)

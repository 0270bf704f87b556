"""Region-controlled compositional NextDiT (counterpart of
`lumina_t2x_tpu/models/compositional.py`).

- the caption features hold num_y rows: the region captions, then the
  negative caption last; the image batch is the CFG pair (cond, uncond);
- the cross-attention runs per caption row: the cond image's queries
  attend every region caption, the uncond image's the last caption; each
  region's output is kept only on its own cells (the query-side region
  mask) and the regions are summed into the cond row;
- the regions form an h_split x w_split grid over the patches, with the
  `(h + 1) * (w + 1) - 1` region ids and an all-ones last row
  (`build_region_mask`);
- the adaLN pools the *global* caption.

The self-attention goes through `ops.attention.attention` (the flash
kernels on the card); the per-region cross-attention runs the plain `sdpa`,
as the JAX module's does (that path has no Pallas kernel). Parameter names
are those of NextDiT-2B, so `core/checkpoint.state_dict_from_jax_params`
and a NextDiT-2B checkpoint load into it unchanged.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.attention import attention as attention_op
from ..ops.attention import default_attn_scale, proportional_attn_scale, sdpa
from ..ops.rope import apply_rope, rope_angles_2d_timeaware
from .layers import (Attention, cfg_mix, maybe_remat, modulate, patchify, pooled_caption,
                     unpatchify)
from .next_dit import NextDiT, NextDiTBlock


def build_region_mask(num_y: int, grid_h: int, grid_w: int, h_split_num: int,
                      w_split_num: int, device=None) -> torch.Tensor:
    """(num_y, grid_h * grid_w) bool mask of the cells each caption row
    conditions."""
    mask = np.zeros((num_y, grid_h, grid_w), bool)
    hp, wp = grid_h // h_split_num, grid_w // w_split_num
    for hs in range(h_split_num):
        for ws in range(w_split_num):
            region_id = (hs + 1) * (ws + 1) - 1
            mask[region_id, hp * hs: hp * (hs + 1), wp * ws: wp * (ws + 1)] = True
    mask[-1] = True
    return torch.from_numpy(mask.reshape(num_y, grid_h * grid_w)).to(device)


class CompositionalAttention(Attention):
    """`layers.Attention`'s parameters; self-attention plus the per-region
    caption cross-attention."""

    def forward(self, x, x_mask, angles, y, y_mask, region_mask, attn_scale=None):
        b, s, _ = x.shape
        hd, nh, nkv = self.head_dim, self.n_heads, self.n_kv_heads
        xq, xk, xv = self.wq(x), self.wk(x), self.wv(x)
        if self.qk_norm:
            xq, xk = self.q_norm(xq), self.k_norm(xk)
        xq = apply_rope(xq.reshape(b, s, nh, hd), angles)
        xk = apply_rope(xk.reshape(b, s, nkv, hd), angles)
        xv = xv.reshape(b, s, nkv, hd)
        scale = attn_scale if attn_scale is not None else default_attn_scale(hd)
        out = attention_op(xq, xk, xv, kv_mask=x_mask, scale=scale, impl=self.attn_impl)

        if self.y_dim > 0 and y is not None:
            num_y, ly = y.shape[0], y.shape[1]
            yk = self.wk_y(y)
            if self.qk_norm:
                yk = self.ky_norm(yk)
            yk = yk.reshape(num_y, ly, nkv, hd)
            yv = self.wv_y(y).reshape(num_y, ly, nkv, hd)
            # cond queries attend every region caption, the uncond row the last
            q_rep = torch.cat([xq[0:1].expand(num_y - 1, s, nh, hd), xq[-1:]], dim=0)
            out_y = sdpa(q_rep, yk, yv, kv_mask=y_mask)  # (num_y, S, H, D)
            out_y = out_y * region_mask[:, :, None, None].to(out_y.dtype)
            out_y = out_y * torch.tanh(self.gate).to(out_y.dtype)[None, None, :, None]
            out_y = torch.cat([out_y[:-1].sum(dim=0, keepdim=True), out_y[-1:]], dim=0)
            out = out + out_y

        return self.wo(out.reshape(b, s, nh * hd))


class CompositionalBlock(NextDiTBlock):
    """NextDiT's sandwich-norm block over `CompositionalAttention`."""

    attention_cls = CompositionalAttention

    def forward(self, x, x_mask, angles, y, y_mask, region_mask, adaln_input, attn_scale=None):
        scale_msa, gate_msa, scale_mlp, gate_mlp = self.adaLN_modulation(adaln_input).chunk(4, -1)
        attn_out = self.attention(
            modulate(self.attention_norm1(x), scale_msa), x_mask, angles,
            self.attention_y_norm(y), y_mask, region_mask, attn_scale)
        x = x + torch.tanh(gate_msa)[:, None, :].to(x.dtype) * self.attention_norm2(attn_out)
        mlp_out = self.feed_forward(modulate(self.ffn_norm1(x), scale_mlp))
        return x + torch.tanh(gate_mlp)[:, None, :].to(x.dtype) * self.ffn_norm2(mlp_out)


class NextDiTCompositional(NextDiT):
    """NextDiT with region-masked caption cross-attention (caption features
    2048 wide by default, Gemma-2B's)."""

    block_cls = CompositionalBlock

    def __init__(self, *args, cap_feat_dim: int = 2048, **kwargs):
        super().__init__(*args, cap_feat_dim=cap_feat_dim, **kwargs)

    def forward(self, x, t, cap_feats, cap_mask, global_cap_feats, global_cap_mask, *,
                h_split_num: int = 1, w_split_num: int = 1, rope_timestep=1.0,
                scale_factor: float = 1.0, scale_watershed: float = 1.0,
                proportional_attn: bool = False, base_seqlen: Optional[int] = None):
        """x (2, C, H, W): the CFG pair; cap_feats (num_y, Ly, D): the region
        captions and the negative caption last; global_cap_* (2, Lg, D): the
        global caption and the negative one, pooled for the adaLN."""
        b, c, h, w = x.shape
        p = self.patch_size
        head_dim = self.dim // self.n_heads
        gh, gw = h // p, w // p
        seq_len = gh * gw
        angles = rope_angles_2d_timeaware(
            head_dim, gh, gw, self.rope_theta, scale_factor=scale_factor,
            scale_watershed=scale_watershed, timestep=rope_timestep, device=x.device,
        ).reshape(seq_len, head_dim // 2)
        region_mask = build_region_mask(cap_feats.shape[0], gh, gw, h_split_num, w_split_num,
                                        device=x.device)
        tokens = self.x_embedder(patchify(x.to(self.dtype), p))
        adaln_input = self.t_embedder(t) + self.cap_embedder(
            pooled_caption(global_cap_feats.to(self.dtype), global_cap_mask))
        attn_scale = (proportional_attn_scale(seq_len, base_seqlen, head_dim)
                      if proportional_attn and base_seqlen else default_attn_scale(head_dim))
        cap_feats_c = cap_feats.to(self.dtype)
        remat = self.remat and torch.is_grad_enabled()
        for layer in self.layers:
            tokens = maybe_remat(layer, remat, self.remat_policy)(
                tokens, None, angles, cap_feats_c, cap_mask, region_mask, adaln_input,
                attn_scale)
        tokens = self.final_layer(tokens, adaln_input)
        out = unpatchify(tokens, h, w, p, self.out_channels)
        if self.learn_sigma:
            out = out[:, : self.out_channels // 2]
        return out.float()


def forward_with_cfg(model: NextDiTCompositional, x, t, cap_feats, cap_mask, cfg_scale, *,
                     global_cap_feats, global_cap_mask, h_split_num: int = 1,
                     w_split_num: int = 1, scale_factor: float = 1.0,
                     scale_watershed: float = 1.0, base_seqlen: Optional[int] = None,
                     proportional_attn: bool = False, num_cfg_channels: int = 3):
    """CFG over the (cond, uncond) pair; the RoPE timestep is t[0]."""
    half = x[: x.shape[0] // 2]
    out = model(torch.cat([half, half], dim=0), t, cap_feats, cap_mask, global_cap_feats,
                global_cap_mask, h_split_num=h_split_num, w_split_num=w_split_num,
                rope_timestep=t[0], scale_factor=scale_factor, scale_watershed=scale_watershed,
                proportional_attn=proportional_attn, base_seqlen=base_seqlen)
    return cfg_mix(out, cfg_scale, num_cfg_channels)


def NextDiT_2B_patch2_Compositional(**kwargs):
    return NextDiTCompositional(patch_size=2, dim=2304, n_layers=24, n_heads=32, **kwargs)

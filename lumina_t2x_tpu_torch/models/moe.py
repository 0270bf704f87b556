"""Mixture-of-Experts NextDiT, class-conditional (counterpart of
`lumina_t2x_tpu/models/moe.py`, the Next-DiT-MoE family).

- `TimeMoEFFN`: the gate reads the raw timestep embedding, so an item's
  top-k experts serve all of its tokens;
- `SpaceMoEFFN`: per-token top-k with a static capacity per expert,
  ceil(T * k / E * capacity_factor) over the T tokens of the batch; an
  expert's overflow is dropped in token order (the position of a token in
  an expert's queue is the running count over the flattened (T,) order), so
  a dropped token contributes 0 for that expert;
- `NextDiTMoEBlock`: SandwichNorm2 (parameter-free inner RMSNorms, learned
  outer ones) with a 4-chunk adaLN (modes `time`, `space`, `dense`) or a
  6-chunk one with TimeMoE then SpaceMoE (`both`).

Both FFNs compute the JAX functions: the top-k of the gate logits in fp32,
ties broken toward the lower expert index as `lax.top_k` breaks them, the
softmax over the selected logits only, the weighted sum over the k slots.
The mechanism differs: JAX gathers each item's expert matrices (TimeMoE,
(B, d, h) per slot) or builds a (T, E, C) one-hot dispatch (SpaceMoE); the
port groups the (row, slot) pairs by expert (`_expert_outputs`: one
argsort, one count read back to the host per call) and runs one set of
GEMMs per expert on the rows routed to it (`index_select`), placing the
results with `index_copy`.

Parameter names are the reference layout that the JAX package's
`import_next_dit_moe_weights` reads (`feed_forward.experts.<j>.w{1,2,3}.weight`,
`feed_forward.gate.weight`; `feed_forward_{time,space}` and
`ffn_norm_{time,space}` for `both`); `core/checkpoint.moe_state_dict_from_jax_params`
carries a JAX tree across. The gates are fp32 parameters at any
`param_dtype`, as in JAX.

Expert parallelism (`ep_axis` with `ep_mesh`, a `DeviceMesh`; without one
the whole default process group): each `SpaceMoEFFN` keeps only its rank's
E / n experts (`shard_experts`; their state-dict names are unchanged, so a
rank loads its share of a full state dict). The routing (top-k, capacity,
drop order) is computed on every rank from all T tokens, exactly as
unsharded. With the tokens replicated over the group (JAX's `ep_axis`
semantics: x is the global array) each rank runs its experts on the tokens
routed to them and the combined outputs are summed over the group; the
backward sums the ranks' shares of the gradients of x and of the routing
weights, so x and the router gate get their whole gradients on every rank,
as unsharded. With `ep_tokens="sharded"` each rank holds its own rows of
the tokens: the routing's queue positions count the rows of lower ranks
first (so capacity and drops are the global ones), the kept (token, slot)
pairs go to their experts' ranks by `all_to_all`, and the outputs come back
the same way; a rank's x gradient is then that of its rows, and its gate
gradient its rows' share (a data-parallel reduce sums them), as any
replicated parameter's under data parallelism.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..ops.attention import default_attn_scale
from ..ops.norms import rms_norm
from ..ops.rope import rope_angles_2d
from ..parallel.comm import copy_to_group, sum_replicated
from ..parallel.mesh import axis_group
from .layers import (
    Attention,
    FeedForward,
    FinalLayer,
    LabelEmbedder,
    RMSNorm,
    TimestepEmbedder,
    _linear,
    maybe_remat,
    modulate,
    patchify,
    unpatchify,
)


def top_k_lower_index(logits, k: int):
    """(values, indices) of the k largest logits along the last axis, ties
    broken toward the lower index (`lax.top_k`'s order; `torch.topk` does
    not promise one): a stable descending sort."""
    values, indices = torch.sort(logits, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _owned(experts):
    """(global expert index, module) pairs of a ModuleList (all experts) or
    of an expert-parallel rank's ModuleDict (keys: global indices)."""
    if isinstance(experts, nn.ModuleDict):
        return [(int(j), m) for j, m in experts.items()]
    return list(enumerate(experts))


def _expert_outputs(x, top_i, experts, keep=None, num_experts=None):
    """(N, k, ...) outputs: entry (n, s) is `experts[top_i[n, s]](x[n])`, or
    0 where `keep` (N, k) is false or the expert is not held here. The
    pairs are sorted by expert (stable, so each expert sees its rows in
    order), each expert runs once on its rows, and the results go back to
    their (n, s) places."""
    n, k = top_i.shape
    e = num_experts if num_experts is not None else len(experts)
    flat = top_i.reshape(-1)
    if keep is not None:  # dropped pairs sort into a bucket past the last expert
        flat = torch.where(keep.reshape(-1), flat, e)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=e + 1).tolist()
    starts = np.cumsum([0] + counts).tolist()
    rows = order // k
    outs, places = [], []
    for j, expert in _owned(experts):
        if counts[j]:
            outs.append(expert(x.index_select(0, rows[starts[j]:starts[j + 1]])))
            places.append(order[starts[j]:starts[j + 1]])
    buf = x.new_zeros((n * k, *x.shape[1:]))
    if outs:
        buf = buf.index_copy(0, torch.cat(places), torch.cat(outs))
    return buf.reshape(n, k, *x.shape[1:])


class _MoEFFN(nn.Module):
    """The experts (SwiGLU FFNs of the dense block's width) and a bias-free
    fp32 gate over `gate_in` features."""

    def __init__(self, dim: int, gate_in: int, multiple_of: int, ffn_dim_multiplier,
                 num_experts: int, num_experts_per_tok: int, param_dtype=torch.float32,
                 device=None):
        super().__init__()
        self.num_experts_per_tok = num_experts_per_tok
        self.experts = nn.ModuleList([
            FeedForward(dim, 4 * dim, multiple_of, ffn_dim_multiplier, param_dtype=param_dtype,
                        device=device)
            for _ in range(num_experts)
        ])
        self.gate = _linear(gate_in, num_experts, bias=False, device=device)

    def route(self, features):
        """Top-k expert ids and their softmax weights (fp32) of each row of
        `features`, from fp32 gate logits."""
        logits = F.linear(features.float(), self.gate.weight.float())
        top_w, top_i = top_k_lower_index(logits, self.num_experts_per_tok)
        return torch.softmax(top_w, dim=-1), top_i


class TimeMoEFFN(_MoEFFN):
    """Per-item top-k expert SwiGLU, gated on the (B, C) conditioning."""

    def forward(self, x, cond):
        weights, top_i = self.route(cond)
        weights = weights.to(x.dtype)
        outs = _expert_outputs(x, top_i, self.experts)  # (B, k, S, d)
        out = weights[:, 0, None, None] * outs[:, 0]
        for slot in range(1, top_i.shape[1]):
            out = out + weights[:, slot, None, None] * outs[:, slot]
        return out


class SpaceMoEFFN(_MoEFFN):
    """Per-token top-k expert SwiGLU with a static capacity per expert."""

    def __init__(self, *args, capacity_factor: float = 2.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.capacity_factor = capacity_factor
        self.num_experts = len(self.experts)
        self.ep_group, self.ep_tokens = None, "replicated"

    def shard_experts(self, group, tokens: str = "replicated"):
        """Keep this rank's E / n experts of `group` (expert parallelism);
        `tokens`: "replicated" (every rank holds all tokens) or "sharded"
        (each rank its own rows)."""
        if tokens not in ("replicated", "sharded"):
            raise ValueError(f"ep tokens {tokens!r}: use 'replicated' or 'sharded'")
        n, r = dist.get_world_size(group), dist.get_rank(group)
        if self.num_experts % n:
            raise ValueError(f"{self.num_experts} experts do not split over {n} ranks")
        per = self.num_experts // n
        self.experts = nn.ModuleDict({str(j): self.experts[j]
                                      for j in range(r * per, (r + 1) * per)})
        self.ep_group, self.ep_tokens = group, tokens

    def forward(self, x):
        b, s, d = x.shape
        e, k = self.num_experts, self.num_experts_per_tok
        t = b * s
        sharded = self.ep_group is not None and self.ep_tokens == "sharded"
        total = t * dist.get_world_size(self.ep_group) if sharded else t
        capacity = int(math.ceil(total * k / e * self.capacity_factor))
        xt = x.reshape(t, d)
        weights, top_i = self.route(xt)  # (T, k)
        chosen = torch.zeros((t, e), dtype=torch.int32, device=x.device).scatter_(1, top_i, 1)
        position = torch.cumsum(chosen, dim=0) - 1  # queue position, token order
        if sharded:  # the rows of lower ranks come first in the global order
            counts = [torch.empty(e, dtype=torch.int32, device=x.device)
                      for _ in range(dist.get_world_size(self.ep_group))]
            dist.all_gather(counts, chosen.sum(dim=0, dtype=torch.int32), group=self.ep_group)
            position = position + sum(counts[:dist.get_rank(self.ep_group)],
                                      torch.zeros_like(counts[0]))
        keep = (position < capacity).gather(1, top_i)  # (T, k)
        if sharded:
            outs = _dispatch_all_to_all(xt, top_i, keep, self.experts, e, self.ep_group)
        else:
            if self.ep_group is not None:  # the backward sums the ranks' shares
                xt = copy_to_group(xt, self.ep_group)
                weights = copy_to_group(weights, self.ep_group)
            outs = _expert_outputs(xt, top_i, self.experts, keep, e)  # (T, k, d)
        out = (weights * keep)[:, 0, None] * outs[:, 0].float()
        for slot in range(1, k):
            out = out + (weights * keep)[:, slot, None] * outs[:, slot].float()
        if self.ep_group is not None and not sharded:  # each rank added its experts' share
            out = sum_replicated(out, self.ep_group)
        return out.to(x.dtype).reshape(b, s, d)


def _dispatch_all_to_all(xt, top_i, keep, experts, e, group):
    """(T, k, d) expert outputs of this rank's rows when the experts are
    split over `group`: the kept (row, slot) pairs go to their expert's rank
    sorted by expert, each rank runs its experts on what it received, and
    the outputs return to their senders' (row, slot) places."""
    from torch.distributed.nn.functional import all_to_all_single

    n = dist.get_world_size(group)
    per = e // n
    t, k = top_i.shape
    flat = torch.where(keep.reshape(-1), top_i.reshape(-1), e)
    order = torch.argsort(flat, stable=True)
    sent = int((flat < e).sum())
    order = order[:sent]
    expert_of = flat[order]
    send_counts = torch.bincount(expert_of // per, minlength=n)
    recv_counts = torch.empty_like(send_counts)
    dist.all_to_all_single(recv_counts, send_counts, group=group)
    send_splits, recv_splits = send_counts.tolist(), recv_counts.tolist()
    rows_in = all_to_all_single(torch.empty((sum(recv_splits), xt.shape[1]), dtype=xt.dtype,
                                            device=xt.device),
                                xt.index_select(0, order // k), recv_splits, send_splits,
                                group=group)
    ids_in = torch.empty(sum(recv_splits), dtype=expert_of.dtype, device=xt.device)
    dist.all_to_all_single(ids_in, expert_of.contiguous(), recv_splits, send_splits,
                           group=group)
    outs_in = rows_in.new_zeros(rows_in.shape)
    pieces, places = [], []
    for j, expert in _owned(experts):
        sel = (ids_in == j).nonzero().reshape(-1)
        if sel.numel():
            pieces.append(expert(rows_in.index_select(0, sel)))
            places.append(sel)
    if pieces:
        outs_in = outs_in.index_copy(0, torch.cat(places), torch.cat(pieces))
    back = all_to_all_single(torch.empty((sent, xt.shape[1]), dtype=xt.dtype, device=xt.device),
                             outs_in, send_splits, recv_splits, group=group)
    buf = xt.new_zeros((t * k, xt.shape[1])).index_copy(0, order, back)
    return buf.reshape(t, k, xt.shape[1])


class NextDiTMoEBlock(nn.Module):
    """SandwichNorm2 block with a MoE FFN; see the module docstring."""

    def __init__(self, dim: int, n_heads: int, n_kv_heads: Optional[int], multiple_of: int,
                 ffn_dim_multiplier: Optional[float], norm_eps: float, qk_norm: bool,
                 moe_mode: str = "time", num_experts: int = 8, num_experts_per_tok: int = 2,
                 capacity_factor: float = 2.0, attn_impl: str = "auto",
                 param_dtype=torch.float32, device=None):
        super().__init__()
        if moe_mode not in ("time", "space", "both", "dense"):
            raise ValueError(f"unknown moe_mode {moe_mode!r} (use time, space, both or dense)")
        self.moe_mode = moe_mode
        self.norm_eps = norm_eps
        self.head_dim = dim // n_heads
        cond_dim = min(dim, 1024)
        n_chunks = 6 if moe_mode == "both" else 4
        pk = dict(param_dtype=param_dtype, device=device)
        self.adaLN_modulation = nn.Sequential(
            nn.SiLU(), _linear(cond_dim, n_chunks * dim, init="zeros", device=device,
                               dtype=param_dtype))
        self.attention = Attention(dim, n_heads, n_kv_heads, qk_norm=qk_norm,
                                   attn_impl=attn_impl, **pk)
        self.attention_norm = RMSNorm(dim, eps=norm_eps, device=device)
        moe = dict(multiple_of=multiple_of, ffn_dim_multiplier=ffn_dim_multiplier,
                   num_experts=num_experts, num_experts_per_tok=num_experts_per_tok, **pk)
        time_moe = lambda: TimeMoEFFN(dim, cond_dim, **moe)
        space_moe = lambda: SpaceMoEFFN(dim, dim, capacity_factor=capacity_factor, **moe)
        if moe_mode == "both":
            self.feed_forward_time = time_moe()
            self.ffn_norm_time = RMSNorm(dim, eps=norm_eps, device=device)
            self.feed_forward_space = space_moe()
            self.ffn_norm_space = RMSNorm(dim, eps=norm_eps, device=device)
        else:
            self.feed_forward = {
                "time": time_moe, "space": space_moe,
                "dense": lambda: FeedForward(dim, 4 * dim, multiple_of, ffn_dim_multiplier, **pk),
            }[moe_mode]()
            self.ffn_norm = RMSNorm(dim, eps=norm_eps, device=device)

    def _inner(self, x, scale):
        return modulate(rms_norm(x, None, self.norm_eps), scale)

    def forward(self, x, angles, adaln_input, time_input):
        chunks = self.adaLN_modulation(adaln_input).chunk(6 if self.moe_mode == "both" else 4, -1)
        scale_msa, gate_msa = chunks[0], chunks[1]
        attn_out = self.attention(self._inner(x, scale_msa), None, angles,
                                  attn_scale=default_attn_scale(self.head_dim))
        x = x + torch.tanh(gate_msa)[:, None, :].to(x.dtype) * self.attention_norm(attn_out)
        if self.moe_mode == "both":
            scale_t, gate_t, scale_s, gate_s = chunks[2:]
            t_out = self.feed_forward_time(self._inner(x, scale_t), time_input)
            x = x + torch.tanh(gate_t)[:, None, :].to(x.dtype) * self.ffn_norm_time(t_out)
            s_out = self.feed_forward_space(self._inner(x, scale_s))
            return x + torch.tanh(gate_s)[:, None, :].to(x.dtype) * self.ffn_norm_space(s_out)
        scale_mlp, gate_mlp = chunks[2], chunks[3]
        h = self._inner(x, scale_mlp)
        ffn_out = (self.feed_forward(h, time_input) if self.moe_mode == "time"
                   else self.feed_forward(h))
        return x + torch.tanh(gate_mlp)[:, None, :].to(x.dtype) * self.ffn_norm(ffn_out)


class NextDiTMoE(nn.Module):
    """Class-conditional NextDiT with MoE FFNs. `dtype` is the activation
    dtype; parameters are stored in `param_dtype`."""

    def __init__(self, patch_size: int = 2, in_channels: int = 4, dim: int = 1536,
                 n_layers: int = 16, n_heads: int = 32, n_kv_heads: Optional[int] = None,
                 multiple_of: int = 256, ffn_dim_multiplier: Optional[float] = None,
                 norm_eps: float = 1e-5, class_dropout_prob: float = 0.1,
                 num_classes: int = 1000, learn_sigma: bool = True, qk_norm: bool = False,
                 moe_mode: str = "time", num_experts: int = 8, num_experts_per_tok: int = 2,
                 capacity_factor: float = 2.0, ep_axis: Optional[str] = None,
                 rope_theta: float = 10000.0, dtype=torch.float32, param_dtype=torch.float32,
                 attn_impl: str = "auto", remat: bool = False, remat_policy: str = "dots",
                 ep_mesh=None, ep_tokens: str = "replicated", device=None):
        super().__init__()
        maybe_remat(None, False, remat_policy)  # rejects an unknown policy
        self.patch_size = patch_size
        self.in_channels = in_channels
        self.dim = dim
        self.n_layers = n_layers
        self.n_heads = n_heads
        self.num_classes = num_classes
        self.learn_sigma = learn_sigma
        self.qk_norm = qk_norm
        self.moe_mode = moe_mode
        self.rope_theta = rope_theta
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.remat = remat
        self.remat_policy = remat_policy
        cond_dim = min(dim, 1024)
        self.x_embedder = _linear(patch_size * patch_size * in_channels, dim, device=device,
                                  dtype=param_dtype)
        self.t_embedder = TimestepEmbedder(cond_dim, dtype=dtype, param_dtype=param_dtype,
                                           device=device)
        self.y_embedder = LabelEmbedder(num_classes, cond_dim, class_dropout_prob, dtype=dtype,
                                        param_dtype=param_dtype, device=device)
        self.layers = nn.ModuleList([
            NextDiTMoEBlock(dim, n_heads, n_kv_heads, multiple_of, ffn_dim_multiplier, norm_eps,
                            qk_norm, moe_mode=moe_mode, num_experts=num_experts,
                            num_experts_per_tok=num_experts_per_tok,
                            capacity_factor=capacity_factor, attn_impl=attn_impl,
                            param_dtype=param_dtype, device=device)
            for _ in range(n_layers)
        ])
        self.final_layer = FinalLayer(dim, patch_size, self.out_channels, cond_dim,
                                      modulation="shift_scale", param_dtype=param_dtype,
                                      device=device)
        if ep_axis is not None:
            group = axis_group(ep_mesh, ep_axis if ep_mesh is not None else None)
            for mod in self.modules():
                if isinstance(mod, SpaceMoEFFN):
                    mod.shard_experts(group, ep_tokens)

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
        t_emb = self.t_embedder(t)
        adaln_input = t_emb + self.y_embedder(y, train=train, force_drop_ids=force_drop_ids,
                                              generator=generator)
        remat = self.remat and torch.is_grad_enabled()
        for layer in self.layers:
            # the TimeMoE gates read the raw timestep embedding
            tokens = maybe_remat(layer, remat, self.remat_policy)(tokens, angles, adaln_input,
                                                                  t_emb)
        tokens = self.final_layer(tokens, adaln_input)
        out = unpatchify(tokens, h, w, p, self.out_channels)
        if self.learn_sigma:
            out = out[:, : self.out_channels // 2]
        return out.float()


# -- configs -------------------------------------------------------------------


def NextDiT_MoE_600M_patch2_Time(**kwargs):
    return NextDiTMoE(dim=1536, n_layers=16, n_heads=32, moe_mode="time",
                      num_experts=8, num_experts_per_tok=2, **kwargs)


def NextDiT_MoE_600M_patch2_Spatial(**kwargs):
    return NextDiTMoE(dim=1536, n_layers=16, n_heads=32, moe_mode="space",
                      num_experts=8, num_experts_per_tok=2, **kwargs)


def NextDiT_MoE_600M_patch2_Both(**kwargs):
    return NextDiTMoE(dim=1536, n_layers=16, n_heads=32, moe_mode="both",
                      num_experts=4, num_experts_per_tok=2, **kwargs)

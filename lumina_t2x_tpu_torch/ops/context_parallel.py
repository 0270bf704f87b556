"""Context-parallel attention: the token axis split over a process group
(counterpart of `lumina_t2x_tpu/ops/context_parallel.py`).

Each rank holds the queries, keys, values and key mask of its S / n tokens,
(B, S/n, H, D), and gets the attention output of its queries over all S keys.

- `allgather_context_attention`: K, V and the mask are all-gathered along
  the sequence (differentiable: the backward sums each key block's gradient
  from every rank), then the port's attention entry runs on the full keys
  (`flash`: K1 for <= 1024 keys, else K2, under autograd the K4 forward and
  K6-K8 backward).
- `ring_context_attention`: the K/V/mask blocks rotate around the ring n - 1
  times (`batch_isend_irecv`); each block is folded into a running
  (out, lse) state by `ring_fold`, whose block step is K4
  (`flash_online_lse`) on the card and its plain version on the CPU. Memory
  O(S/n) per rank; forward only (the kernel entry has no autograd).

The fold: out = (w1 out_run + w2 out_blk) / (w1 + w2) with w = exp(lse - m),
m = max(lse_run, lse_blk), lse = m + log(w1 + w2). A block whose keys are all
masked gives out 0 and lse -inf; while the running lse is still -inf too,
m is -inf and the weights would be exp(-inf + inf) = NaN, so the fold keeps
0 there. A row with no valid key at all ends at 0, as the flash kernels give.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from .attention import attention as attention_op
from .attention import default_attn_scale


def _gather_seq(x, group):
    """All-gather along dim 1, differentiable."""
    from torch.distributed.nn.functional import all_gather

    if dist.get_world_size(group) == 1:
        return x
    return torch.cat(all_gather(x.contiguous(), group=group), dim=1)


def allgather_context_attention(q, k, v, group=None, kv_mask=None,
                                scale: Optional[float] = None, impl: str = "auto"):
    """q/k/v: this rank's (B, S/n, H, D) token slices; kv_mask (B, S/n).
    Returns this rank's (B, S/n, Hq, D) output over all keys."""
    if scale is None:
        scale = default_attn_scale(q.shape[-1])
    k_all, v_all = _gather_seq(k, group), _gather_seq(v, group)
    mask_all = None if kv_mask is None else _gather_seq(kv_mask, group)
    return attention_op(q, k_all, v_all, kv_mask=mask_all, scale=scale, impl=impl)


def fold_block(state, out_blk, lse_blk):
    """Fold one key block's (out (B, Sq, Hq, D), lse (B, Hq, Sq) fp32) into
    the running fp32 (out, lse) state (None: the first block)."""
    out_blk = out_blk.float()
    if state is None:
        return out_blk, lse_blk
    out_run, lse_run = state
    m = torch.maximum(lse_run, lse_blk)
    live = torch.isfinite(m)
    m_safe = torch.where(live, m, torch.zeros_like(m))
    w1 = torch.where(live, torch.exp(lse_run - m_safe), torch.zeros_like(m))
    w2 = torch.where(live, torch.exp(lse_blk - m_safe), torch.zeros_like(m))
    denom = w1 + w2
    lse = torch.where(live, m_safe + torch.log(torch.where(live, denom, torch.ones_like(m))), m)
    # (B, Hq, Sq) weights -> (B, Sq, Hq, 1)
    w1_, w2_ = (w.permute(0, 2, 1)[..., None] for w in (w1, w2))
    d_ = torch.where(live, denom, torch.ones_like(denom)).permute(0, 2, 1)[..., None]
    out = (w1_ * out_run + w2_ * out_blk) / d_
    return out, lse


def ring_fold(q, blocks: Sequence, scale: Optional[float] = None,
              block_fn: Optional[Callable] = None):
    """Attention of q over keys given as an iterable of (k, v, mask) blocks,
    each through `block_fn(q, k, v, mask, scale) -> (out, lse)` (default
    `flash_online_lse`, K4) and `fold_block`. Returns out in q's dtype."""
    if block_fn is None:
        from .flash_attention import flash_online_lse as block_fn
    if scale is None:
        scale = default_attn_scale(q.shape[-1])
    state = None
    for k, v, mask in blocks:
        state = fold_block(state, *block_fn(q, k, v, mask, scale))
    return state[0].to(q.dtype)


def _ring_blocks(k, v, kv_mask, group):
    """The resident block, then the n - 1 blocks that arrive around the ring
    (rank r receives rank r - 1's block at each rotation)."""
    from ..parallel.pipeline import _shift

    n = dist.get_world_size(group)
    yield k, v, kv_mask
    for _ in range(n - 1):
        k, v, kv_mask = (_shift(t, group, 1) for t in (k, v, kv_mask))
        yield k, v, kv_mask


@torch.no_grad()
def ring_context_attention(q, k, v, group=None, kv_mask=None, scale: Optional[float] = None,
                           block_fn: Optional[Callable] = None):
    """Ring attention: q/k/v this rank's (B, S/n, H, D) slices, kv_mask
    (B, S/n). Returns this rank's (B, S/n, Hq, D) output over all keys."""
    if kv_mask is None:
        kv_mask = torch.ones(k.shape[:2], dtype=torch.int32, device=k.device)
    return ring_fold(q, _ring_blocks(k, v, kv_mask.to(torch.int32), group), scale, block_fn)

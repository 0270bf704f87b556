"""Collectives with the gradients tensor parallelism needs (Megatron's
f/g pairs), for the places where DTensor does not carry the layout: a
tensor-parallel rank's head slice of a replicated parameter, the LayerNorm
statistics over heads split across ranks, and a sum over ranks whose result
every rank then uses in the same replicated computation."""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.nn.functional import all_reduce as _all_reduce_grad_summed


class _SliceToGroup(torch.autograd.Function):
    """Forward: this rank's chunk of a tensor every rank holds whole.
    Backward: the chunks' gradients gathered, so the replicated tensor gets
    its whole gradient on every rank."""

    @staticmethod
    def forward(ctx, x, group, dim):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        ctx.group, ctx.dim = group, dim
        return x.chunk(n, dim=dim)[r].contiguous()

    @staticmethod
    def backward(ctx, grad):
        n = dist.get_world_size(ctx.group)
        parts = [torch.empty_like(grad) for _ in range(n)]
        dist.all_gather(parts, grad.contiguous(), group=ctx.group)
        return torch.cat(parts, dim=ctx.dim), None, None


class _SumReplicated(torch.autograd.Function):
    """Forward: the sum over the group's ranks. Backward: identity -- every
    rank uses the sum in the same replicated computation, so its gradient
    there is already the whole gradient."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyToGroup(torch.autograd.Function):
    """Forward: identity (every rank holds the same tensor). Backward: the
    sum over the group -- each rank's downstream uses it for its own part
    (its experts), so each rank holds one share of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """`x`, replicated over `group`, entering work that each rank does for
    its own part: the backward sums the ranks' gradients."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    return _CopyToGroup.apply(x, group)


def slice_to_group(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's chunk along `dim` of a tensor replicated over `group`."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    return _SliceToGroup.apply(x, group, dim)


def sum_replicated(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over `group`, for a result every rank goes on using alike."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    return _SumReplicated.apply(x, group)


def sum_partial(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over `group` of partial values whose downstream differs by rank
    (a rank's own heads): the backward sums the gradients too."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    return _all_reduce_grad_summed(x, group=group)


def tp_layer_norm(x, weight, bias, eps: float, group):
    """LayerNorm over the full feature width when each rank of `group` holds
    a contiguous slice of the features (its heads): the mean and variance
    are fp32 sums over the group; `weight` and `bias` are the full
    replicated parameters, each rank applying its slice."""
    xf = x.float()
    n = x.shape[-1] * dist.get_world_size(group)
    mean = sum_partial(xf.sum(dim=-1, keepdim=True), group) / n
    centred = xf - mean
    var = sum_partial(centred.pow(2).sum(dim=-1, keepdim=True), group) / n
    normed = centred * torch.rsqrt(var + eps)
    if weight is not None:
        normed = normed * slice_to_group(weight, group).float()
    if bias is not None:
        normed = normed + slice_to_group(bias, group).float()
    return normed.to(x.dtype)


class _GatherReplicated(torch.autograd.Function):
    """Forward: the group's pieces concatenated along `dim`. Backward: this
    rank's slice of the gradient -- every rank uses the gathered tensor in
    the same replicated computation."""

    @staticmethod
    def forward(ctx, x, group, dim):
        n = dist.get_world_size(group)
        ctx.group, ctx.dim = group, dim
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return grad.chunk(n, dim=ctx.dim)[r].contiguous(), None, None


def gather_replicated(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """All-gather along `dim`, for a result every rank goes on using alike."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    return _GatherReplicated.apply(x, group, dim)


def max_over_ranks(values, device):
    """Each of the floats `values` maximised over every rank of the default
    group (unchanged in one process): under tensor parallelism a rank sees
    only its heads, so the static-max calibrations take their extremes here."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return list(values)
    t = torch.tensor(list(values), dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.tolist()

"""Gradient-norm utilities (counterpart of
`lumina_t2x_tpu/parallel/grad_norm.py`): the global L2 norm of gradients
that may be DTensors, each global element counted once however many ranks
hold it, the uniform rescale and the clip."""

from __future__ import annotations

from typing import Dict, Iterable, Union

import torch

from .sharding import ShardLayout, model_parallel_dim_dict, to_local


def get_model_parallel_dim_dict(params) -> dict:
    """name -> the dim sharded over `model` (None if replicated)."""
    return model_parallel_dim_dict(params)


def calculate_l2_grad_norm(grads: Union[Dict[str, torch.Tensor], Iterable[torch.Tensor]],
                           model_parallel_dim_dict=None) -> torch.Tensor:
    """fp32 global L2 norm of `grads` (a dict or a sequence of tensors or
    DTensors). `model_parallel_dim_dict` is accepted for the reference's
    signature and unused: a DTensor carries its layout."""
    del model_parallel_dim_dict
    items = dict(grads) if isinstance(grads, dict) else dict(enumerate(grads))
    layout = ShardLayout(items)
    total = torch.stack([layout.once(k, to_local(g).float().pow(2).sum())
                         for k, g in items.items()]).sum()
    return torch.sqrt(layout.all_reduce(total))


def scale_grad(grads, factor):
    """Uniformly rescale gradients, in place (`grads` a dict or sequence)."""
    for g in (grads.values() if isinstance(grads, dict) else grads):
        to_local(g).mul_(factor)
    return grads


def clip_grad_norm(grads, max_norm: float, eps: float = 1e-6):
    """norm + clip in one call: grads * min(1, max_norm / (norm + eps));
    returns (grads, norm)."""
    norm = calculate_l2_grad_norm(grads)
    scale = torch.clamp(max_norm / (norm + eps), max=1.0)
    return scale_grad(grads, scale), norm

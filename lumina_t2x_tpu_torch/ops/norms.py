"""Normalization ops (counterpart of `lumina_t2x_tpu/ops/norms.py`).

Both norms are float32 islands: the input is upcast, normalised, scaled and
cast back to its own dtype.
"""

from __future__ import annotations

from typing import Optional

import torch


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
             eps: float = 1e-5) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * weight, computed in float32.

    `weight=None` gives the parameter-free variant."""
    xf = x.float()
    normed = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    if weight is not None:
        normed = normed * weight.float()
    return normed.to(x.dtype)


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm with optional affine, float32 island."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).pow(2).mean(dim=-1, keepdim=True)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        normed = normed * weight.float()
    if bias is not None:
        normed = normed + bias.float()
    return normed.to(x.dtype)

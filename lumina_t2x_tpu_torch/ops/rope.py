"""Rotary position embeddings (counterpart of `lumina_t2x_tpu/ops/rope.py`).

Angles are real float32 tensors; rotation is the interleaved-pair formula
  out[2k]   = x[2k] cos_k - x[2k+1] sin_k
  out[2k+1] = x[2k] sin_k + x[2k+1] cos_k
with the pair swap done as a view/stack, in a float32 island.
"""

from __future__ import annotations

import numpy as np
import torch


def _as_f32(v, device=None) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _scale_factors(scale_factor, scale_watershed, timestep):
    """Time-aware selection of (linear_factor, ntk_factor); the comparison is
    made in float32, as the JAX package makes it. With scale_factor 1 both
    branches give (1, 1), so the timestep is not read."""
    if scale_factor == 1.0:
        return 1.0, 1.0
    below = np.float32(float(timestep)) < np.float32(scale_watershed)
    return (scale_factor, 1.0) if below else (1.0, scale_factor)


def _freqs(head_dim: int, step: int, theta: float, linear_factor, ntk_factor,
           device=None) -> torch.Tensor:
    exponents = (torch.arange(0, head_dim, step, dtype=torch.float32, device=device)
                 [: head_dim // step] / head_dim)
    theta_eff = _as_f32(theta, device) * _as_f32(ntk_factor, device)
    return torch.exp(-exponents * torch.log(theta_eff)) / _as_f32(linear_factor, device)


def rope_angles_1d(head_dim: int, positions, theta: float = 10000.0,
                   linear_factor=1.0, ntk_factor=1.0, device=None) -> torch.Tensor:
    """Angles for 1-D RoPE: (len(positions), head_dim // 2), float32."""
    freqs = _freqs(head_dim, 2, theta, linear_factor, ntk_factor, device)
    positions = _as_f32(positions, device)
    return torch.outer(positions, freqs)


def rope_angles_2d(head_dim: int, height: int, width: int, theta: float = 10000.0,
                   linear_factor=1.0, ntk_factor=1.0, device=None) -> torch.Tensor:
    """Angles for 2-D axis-factorized RoPE: (height, width, head_dim // 2),
    interleaving the height and width frequencies per pair."""
    if head_dim % 4 != 0:
        raise ValueError(f"2d rope needs head dim divisible by 4, got {head_dim}")
    freqs = _freqs(head_dim, 4, theta, linear_factor, ntk_factor, device)
    angles_h = torch.outer(torch.arange(height, dtype=torch.float32, device=device), freqs)
    angles_w = torch.outer(torch.arange(width, dtype=torch.float32, device=device), freqs)
    grid = torch.stack([
        angles_h[:, None, :].expand(height, width, head_dim // 4),
        angles_w[None, :, :].expand(height, width, head_dim // 4),
    ], dim=-1)  # (H, W, d/4, 2)
    return grid.reshape(height, width, head_dim // 2)


def rope_angles_2d_timeaware(head_dim: int, height: int, width: int,
                             theta: float = 10000.0, scale_factor=1.0,
                             scale_watershed=1.0, timestep=1.0,
                             device=None) -> torch.Tensor:
    """2-D angles with the time-aware linear/NTK watershed switch. `timestep`
    is a host scalar: the port's step loop runs in Python."""
    linear_factor, ntk_factor = _scale_factors(scale_factor, scale_watershed, timestep)
    return rope_angles_2d(head_dim, height, width, theta, linear_factor, ntk_factor, device)


def rot_tables(angles: torch.Tensor, head_dim: int):
    """(..., head_dim//2) angles -> (..., head_dim) float32 (cos_full,
    sin_signed): cos_full repeats each cos twice, sin_signed is
    (-s0, s0, -s1, s1, ...)."""
    cos = torch.cos(angles.float())
    sin = torch.sin(angles.float())
    cos_full = torch.repeat_interleave(cos, 2, dim=-1)
    sin_signed = torch.stack([-sin, sin], dim=-1).reshape(*sin.shape[:-1], head_dim)
    return cos_full, sin_signed


def _swap_pairs(x: torch.Tensor) -> torch.Tensor:
    """(..., 2k, 2k+1) -> (..., 2k+1, 2k) along the last dim."""
    pairs = x.unflatten(-1, (-1, 2))
    return torch.stack([pairs[..., 1], pairs[..., 0]], dim=-1).flatten(-2)


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate pairs of channels of x (..., seq, n_heads, head_dim) by angles
    (seq, head_dim//2) or (batch, seq, head_dim//2). Math in float32; the
    result has x's dtype."""
    head_dim = x.shape[-1]
    ang = angles[None, :, None, :] if angles.dim() == 2 else angles[:, :, None, :]
    cos_full, sin_signed = rot_tables(ang, head_dim)
    xf = x.float()
    out = xf * cos_full + _swap_pairs(xf) * sin_signed
    if out.shape != x.shape:
        out = out.reshape(x.shape)
    return out.to(x.dtype)

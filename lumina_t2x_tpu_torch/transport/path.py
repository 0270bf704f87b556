"""Coupling plans (counterpart of `lumina_t2x_tpu/transport/path.py`): the
linear path x_t = t * x1 + (1 - t) * x0. The VP and GVP paths are not ported
yet (ROADMAP queue 1, item 4)."""

from __future__ import annotations

import torch


def expand_t_like_x(t, x):
    """Reshape a (B,) time vector for broadcasting against (B, ...) data."""
    return t.reshape(t.shape[0], *([1] * (x.dim() - 1)))


class LinearPath:
    """Linear coupling: alpha_t = t, sigma_t = 1 - t."""

    def alpha_t(self, t):
        return t, torch.ones_like(t)

    def sigma_t(self, t):
        return 1.0 - t, -torch.ones_like(t)

    def d_alpha_alpha_ratio(self, t):
        return 1.0 / t

    def drift(self, x, t):
        """Score-parameterized SDE drift; returns (-drift_mean, diffusion_var)."""
        t = expand_t_like_x(t, x)
        alpha_ratio = self.d_alpha_alpha_ratio(t)
        sigma_t, d_sigma_t = self.sigma_t(t)
        return -(alpha_ratio * x), alpha_ratio * sigma_t**2 - sigma_t * d_sigma_t

    def velocity_to_score(self, velocity, x, t):
        t = expand_t_like_x(t, x)
        alpha_t, d_alpha_t = self.alpha_t(t)
        sigma_t, d_sigma_t = self.sigma_t(t)
        reverse_alpha_ratio = alpha_t / d_alpha_t
        var = sigma_t**2 - reverse_alpha_ratio * d_sigma_t * sigma_t
        return (reverse_alpha_ratio * velocity - x) / var

    def interpolant(self, t, x0, x1):
        """Return (x_t, u_t): the point on the path and its velocity."""
        t = expand_t_like_x(t, x1)
        alpha_t, d_alpha_t = self.alpha_t(t)
        sigma_t, d_sigma_t = self.sigma_t(t)
        return alpha_t * x1 + sigma_t * x0, d_alpha_t * x1 + d_sigma_t * x0

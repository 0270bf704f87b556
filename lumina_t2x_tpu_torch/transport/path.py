"""Coupling plans (counterpart of `lumina_t2x_tpu/transport/path.py`): the
time-dependent interpolation x_t = alpha_t * x1 + sigma_t * x0 between noise
(x0, t=0) and data (x1, t=1) for the linear, VP and GVP paths, the drift and
diffusion terms of the associated SDE, and the conversions between the
velocity, score and noise parameterizations."""

from __future__ import annotations

import math

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

    def diffusion(self, x, t, form="constant", norm=1.0):
        """The SDE's diffusion coefficient in one of the reference's forms."""
        t = expand_t_like_x(t, x)
        if form == "constant":
            return torch.full_like(t, norm)
        if form == "SBDM":
            return norm * self.drift(x, t)[1]
        if form == "sigma":
            return norm * self.sigma_t(t)[0]
        if form == "linear":
            return norm * (1.0 - t)
        if form == "decreasing":
            return 0.25 * (norm * torch.cos(math.pi * t) + 1.0) ** 2
        if form == "increasing-decreasing":
            return norm * torch.sin(math.pi * t) ** 2
        raise NotImplementedError(f"Diffusion form {form} not implemented")

    # -- parameterization conversions ----------------------------------------

    def velocity_to_score(self, velocity, x, t):
        t = expand_t_like_x(t, x)
        alpha_t, d_alpha_t = self.alpha_t(t)
        sigma_t, d_sigma_t = self.sigma_t(t)
        reverse_alpha_ratio = alpha_t / d_alpha_t
        var = sigma_t**2 - reverse_alpha_ratio * d_sigma_t * sigma_t
        return (reverse_alpha_ratio * velocity - x) / var

    def velocity_to_noise(self, velocity, x, t):
        t = expand_t_like_x(t, x)
        alpha_t, d_alpha_t = self.alpha_t(t)
        sigma_t, d_sigma_t = self.sigma_t(t)
        reverse_alpha_ratio = alpha_t / d_alpha_t
        var = reverse_alpha_ratio * d_sigma_t - sigma_t
        return (reverse_alpha_ratio * velocity - x) / var

    def score_to_velocity(self, score, x, t):
        drift_mean, var = self.drift(x, t)
        return var * score - drift_mean

    # -- interpolant ----------------------------------------------------------

    def interpolant(self, t, x0, x1):
        """Return (x_t, u_t): the point on the path and its velocity."""
        t = expand_t_like_x(t, x1)
        alpha_t, d_alpha_t = self.alpha_t(t)
        sigma_t, d_sigma_t = self.sigma_t(t)
        return alpha_t * x1 + sigma_t * x0, d_alpha_t * x1 + d_sigma_t * x0


class VPPath(LinearPath):
    """Variance-preserving path (log-mean coefficient of a linear beta
    schedule from sigma_min to sigma_max)."""

    def __init__(self, sigma_min=0.1, sigma_max=20.0):
        self.sigma_min = sigma_min
        self.sigma_max = sigma_max

    def _log_mean_coeff(self, t):
        return (-0.25 * ((1.0 - t) ** 2) * (self.sigma_max - self.sigma_min)
                - 0.5 * (1.0 - t) * self.sigma_min)

    def _d_log_mean_coeff(self, t):
        return 0.5 * (1.0 - t) * (self.sigma_max - self.sigma_min) + 0.5 * self.sigma_min

    def alpha_t(self, t):
        alpha = torch.exp(self._log_mean_coeff(t))
        return alpha, alpha * self._d_log_mean_coeff(t)

    def sigma_t(self, t):
        p_sigma_t = 2.0 * self._log_mean_coeff(t)
        sigma = torch.sqrt(1.0 - torch.exp(p_sigma_t))
        d_sigma = torch.exp(p_sigma_t) * (2.0 * self._d_log_mean_coeff(t)) / (-2.0 * sigma)
        return sigma, d_sigma

    def d_alpha_alpha_ratio(self, t):
        return self._d_log_mean_coeff(t)

    def drift(self, x, t):
        t = expand_t_like_x(t, x)
        beta_t = self.sigma_min + (1.0 - t) * (self.sigma_max - self.sigma_min)
        return -0.5 * beta_t * x, beta_t / 2.0


class GVPPath(LinearPath):
    """Generalized VP (trigonometric) path: alpha_t = sin(pi t / 2),
    sigma_t = cos(pi t / 2)."""

    def alpha_t(self, t):
        return torch.sin(t * math.pi / 2.0), math.pi / 2.0 * torch.cos(t * math.pi / 2.0)

    def sigma_t(self, t):
        return torch.cos(t * math.pi / 2.0), -math.pi / 2.0 * torch.sin(t * math.pi / 2.0)

    def d_alpha_alpha_ratio(self, t):
        return math.pi / (2.0 * torch.tan(t * math.pi / 2.0))

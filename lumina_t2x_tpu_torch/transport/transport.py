"""Flow-matching transport, sampling side (counterpart of
`lumina_t2x_tpu/transport/transport.py`): the enums, the integration
interval, the probability-flow drift and the fixed-step ODE sampler. Model
callables have the signature `model_fn(x, t) -> out` with t of shape (B,).

Not ported yet (ROADMAP queue 1, items 4 and 7): the adaptive ODE methods,
`sample_sde`, the likelihood sampler and `training_losses`.
"""

from __future__ import annotations

import enum

import torch

from . import path as path_mod
from .solvers import make_time_grid, odeint_fixed


class ModelType(enum.Enum):
    NOISE = enum.auto()
    SCORE = enum.auto()
    VELOCITY = enum.auto()


class PathType(enum.Enum):
    LINEAR = enum.auto()
    GVP = enum.auto()
    VP = enum.auto()


class WeightType(enum.Enum):
    NONE = enum.auto()
    VELOCITY = enum.auto()
    LIKELIHOOD = enum.auto()


_ADAPTIVE = ("dopri5", "dopri8", "adaptive")


class Transport:
    """Holds the transport configuration."""

    def __init__(self, *, model_type, path_type, loss_type, train_eps, sample_eps, snr_type):
        if path_type != PathType.LINEAR:
            raise NotImplementedError(f"{path_type} is not ported yet (ROADMAP queue 1, item 4)")
        self.model_type = model_type
        self.path_type = path_type
        self.loss_type = loss_type
        self.path_sampler = path_mod.LinearPath()
        self.train_eps = train_eps
        self.sample_eps = sample_eps
        self.snr_type = snr_type

    def check_interval(self, train_eps, sample_eps, *, diffusion_form="SBDM", sde=False,
                       reverse=False, eval=False, last_step_size=0.0):
        """Integration interval selection (the linear path's branch: the only
        path the port has)."""
        t0, t1 = 0.0, 1.0
        eps = train_eps if not eval else sample_eps
        if self.model_type != ModelType.VELOCITY or sde:
            t0 = eps if (diffusion_form == "SBDM" and sde) or self.model_type != ModelType.VELOCITY else 0
            t1 = 1.0 - eps if (not sde or last_step_size == 0) else 1.0 - last_step_size
        if reverse:
            t0, t1 = 1.0 - t0, 1.0 - t1
        return t0, t1

    def get_drift(self):
        """Probability-flow ODE drift."""

        def score_ode(x, t, model_fn):
            drift_mean, drift_var = self.path_sampler.drift(x, t)
            return -drift_mean + drift_var * model_fn(x, t)

        def noise_ode(x, t, model_fn):
            drift_mean, drift_var = self.path_sampler.drift(x, t)
            sigma_t, _ = self.path_sampler.sigma_t(path_mod.expand_t_like_x(t, x))
            return -drift_mean + drift_var * (model_fn(x, t) / -sigma_t)

        def velocity_ode(x, t, model_fn):
            return model_fn(x, t)

        if self.model_type == ModelType.NOISE:
            return noise_ode
        if self.model_type == ModelType.SCORE:
            return score_ode
        return velocity_ode


class Sampler:
    """Sampling-side companion to Transport."""

    def __init__(self, transport: Transport):
        self.transport = transport
        self.drift = transport.get_drift()

    def time_grid(self, num_steps: int, time_shifting_factor=None, reverse=False):
        """The (num_steps,) fp32 grid `sample_ode` integrates over."""
        t0, t1 = self.transport.check_interval(
            self.transport.train_eps, self.transport.sample_eps, sde=False,
            eval=True, reverse=reverse, last_step_size=0.0,
        )
        return make_time_grid(t0, t1, num_steps, time_shifting_factor)

    def sample_ode(self, *, sampling_method="midpoint", num_steps=50, atol=1e-6, rtol=1e-3,
                   reverse=False, time_shifting_factor=None, return_all=False):
        """Return `sample_fn(x_init, model_fn) -> samples` for a fixed-step
        method (euler, midpoint, heun, rk4)."""
        if sampling_method.lower() in _ADAPTIVE:
            raise NotImplementedError(f"adaptive ODE method {sampling_method!r} is not "
                                      "ported yet (ROADMAP queue 1, item 4)")
        base_drift = self.drift
        if reverse:
            drift = lambda x, t, model_fn: base_drift(x, torch.ones_like(t) * (1.0 - t), model_fn)
        else:
            drift = base_drift
        ts = self.time_grid(num_steps, time_shifting_factor, reverse=reverse)

        def sample_fn(x, model_fn):
            b = x.shape[0]

            def f(xx, t_scalar):
                t = torch.full((b,), float(t_scalar), dtype=torch.float32, device=xx.device)
                return drift(xx, t, model_fn)

            return odeint_fixed(f, x, ts, method=sampling_method, return_all=return_all)

        return sample_fn

"""Flow-matching transport (counterpart of
`lumina_t2x_tpu/transport/transport.py`): the enums, the integration
interval, the training times (`sample_t`) and the velocity-matching loss
(`Transport.training_losses`), the probability-flow drift and the fixed-step
ODE sampler. Model callables have the signature `model_fn(x, t) -> out` with
t of shape (B,). Random draws come from an explicit `torch.Generator`, or are
handed in as tensors.

Not ported yet (ROADMAP queue 1, item 5): the adaptive ODE methods,
`sample_sde` and the likelihood sampler.
"""

from __future__ import annotations

import enum
from typing import Callable, Optional

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


def sample_t(batch: int, snr_type: str = "uniform", t0: float = 0.0, t1: float = 1.0, *,
             generator: Optional[torch.Generator] = None, device=None, draw=None):
    """Training times by `snr_type`: uniform, uniform_{t0}_{t1}, lognorm
    (sigmoid of a standard normal) or shift_{factor}. `draw`: the (B,)
    variates (uniform, or standard normal for lognorm); drawn from
    `generator` when None."""
    lognorm = snr_type == "lognorm"
    if draw is None:
        sample = torch.randn if lognorm else torch.rand
        draw = sample((batch,), generator=generator, device=device, dtype=torch.float32)
    if snr_type.startswith("uniform"):
        if "_" in snr_type:
            _, lo, hi = snr_type.split("_")
            t0, t1 = float(lo), float(hi)
        return draw * (t1 - t0) + t0
    if lognorm:
        return torch.sigmoid(draw) * (t1 - t0) + t0
    if snr_type.startswith("shift"):
        try:
            shift_factor = float(snr_type.split("_")[1])
        except (IndexError, ValueError):
            raise ValueError(f"illegal snr_type: {snr_type}; time shift should be "
                             "shift_{factor}, like shift_3.0") from None
        return (shift_factor * draw) / (1.0 + (shift_factor - 1.0) * draw)
    raise ValueError(f"Unknown snr type: {snr_type}")


def mean_flat(x):
    return x.reshape(x.shape[0], -1).mean(dim=-1)


class Transport:
    """Holds the transport configuration."""

    def __init__(self, *, model_type, path_type, loss_type, train_eps, sample_eps, snr_type):
        if path_type != PathType.LINEAR:
            raise NotImplementedError(f"{path_type} is not ported yet (ROADMAP queue 1, item 5)")
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

    def training_losses(self, model_fn: Callable, x1, loss_mask=None, *,
                        generator: Optional[torch.Generator] = None, t=None, x0=None):
        """Velocity-matching MSE loss. `t` (B,) and the noise `x0` are drawn
        from `generator` unless given (tests hand in the JAX package's
        draws). `loss_mask` (B, ...) with 1 on valid pixels restricts each
        item's mean. Returns {"loss": (B,), "task_loss": (B,) detached}."""
        if self.model_type != ModelType.VELOCITY:
            raise NotImplementedError("training is defined for velocity models only "
                                      "(as in the reference)")
        b = x1.shape[0]
        if t is None:
            t0, t1 = self.check_interval(self.train_eps, self.sample_eps)
            t = sample_t(b, self.snr_type, t0, t1, generator=generator, device=x1.device)
        if x0 is None:
            x0 = torch.randn(x1.shape, generator=generator, device=x1.device, dtype=x1.dtype)
        xt, ut = self.path_sampler.interpolant(t, x0, x1)
        sq = (model_fn(xt, t).float() - ut.float()) ** 2
        if loss_mask is not None:
            m = loss_mask.float()
            task_loss = (sq * m).reshape(b, -1).sum(-1) / m.reshape(b, -1).sum(-1).clamp_min(1.0)
        else:
            task_loss = mean_flat(sq)
        return {"loss": task_loss, "task_loss": task_loss.detach()}

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
                                      "ported yet (ROADMAP queue 1, item 5)")
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

"""Flow-matching transport (counterpart of
`lumina_t2x_tpu/transport/transport.py`): the enums, the integration
interval, the training times (`sample_t`) and the velocity-matching loss
(`Transport.training_losses`), the prior, the probability-flow drift and the
score under each parameterization, and the samplers: `sample_ode` (fixed-step
or adaptive dopri5/dopri8), `sample_sde` with its last-step options, and
`sample_ode_likelihood`, the Hutchinson estimate of log p(x) through
forward-mode derivatives (`torch.autograd.forward_ad`). Model callables have
the signature `model_fn(x, t) -> out` with t of shape (B,). Random draws come
from an explicit `torch.Generator`, or are handed in as tensors.
"""

from __future__ import annotations

import enum
import math
from typing import Callable, Optional

import torch
import torch.autograd.forward_ad as fwAD

from . import path as path_mod
from .solvers import (fixed_nfe, make_time_grid, odeint_adaptive, odeint_dopri8, odeint_fixed,
                      sdeint)


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
_PATHS = {
    PathType.LINEAR: path_mod.LinearPath,
    PathType.GVP: path_mod.GVPPath,
    PathType.VP: path_mod.VPPath,
}


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
        self.model_type = model_type
        self.path_type = path_type
        self.loss_type = loss_type
        self.path_sampler = _PATHS[path_type]()
        self.train_eps = train_eps
        self.sample_eps = sample_eps
        self.snr_type = snr_type

    def check_interval(self, train_eps, sample_eps, *, diffusion_form="SBDM", sde=False,
                       reverse=False, eval=False, last_step_size=0.0):
        """Integration interval selection: VP stops eps short of t=1; the
        linear and GVP paths step in by eps from the ends for non-velocity
        models and SDEs."""
        t0, t1 = 0.0, 1.0
        eps = train_eps if not eval else sample_eps
        if self.path_type == PathType.VP:
            t1 = 1.0 - eps if (not sde or last_step_size == 0) else 1.0 - last_step_size
        elif self.model_type != ModelType.VELOCITY or sde:
            t0 = eps if (diffusion_form == "SBDM" and sde) or self.model_type != ModelType.VELOCITY else 0
            t1 = 1.0 - eps if (not sde or last_step_size == 0) else 1.0 - last_step_size
        if reverse:
            t0, t1 = 1.0 - t0, 1.0 - t1
        return t0, t1

    def prior_logp(self, z):
        """Standard normal log-density per batch element."""
        z = z.reshape(z.shape[0], -1)
        return -z.shape[1] / 2.0 * math.log(2 * math.pi) - (z**2).sum(dim=-1) / 2.0

    def draw(self, x1, generator: Optional[torch.Generator] = None, t=None, x0=None):
        """A training step's (t, x0) for the batch `x1`: the times, then the
        noise, each drawn from `generator` unless given."""
        if t is None:
            t0, t1 = self.check_interval(self.train_eps, self.sample_eps)
            t = sample_t(x1.shape[0], self.snr_type, t0, t1, generator=generator,
                         device=x1.device)
        if x0 is None:
            x0 = torch.randn(x1.shape, generator=generator, device=x1.device, dtype=x1.dtype)
        return t, x0

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
        if t is None or x0 is None:
            t, x0 = self.draw(x1, generator, t, x0)
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

    def get_score(self):
        """Score function under the chosen parameterization."""
        path = self.path_sampler
        if self.model_type == ModelType.NOISE:
            return lambda x, t, model_fn: model_fn(x, t) / -path.sigma_t(
                path_mod.expand_t_like_x(t, x))[0]
        if self.model_type == ModelType.SCORE:
            return lambda x, t, model_fn: model_fn(x, t)
        return lambda x, t, model_fn: path.velocity_to_score(model_fn(x, t), x, t)


class Sampler:
    """Sampling-side companion to Transport. Each `sample_fn` it returns
    records the drift evaluations of its last call as `sample_fn.nfe`."""

    def __init__(self, transport: Transport):
        self.transport = transport
        self.drift = transport.get_drift()
        self.score = transport.get_score()

    def time_grid(self, num_steps: int, time_shifting_factor=None, reverse=False):
        """The (num_steps,) fp32 grid `sample_ode` integrates over."""
        t0, t1 = self.transport.check_interval(
            self.transport.train_eps, self.transport.sample_eps, sde=False,
            eval=True, reverse=reverse, last_step_size=0.0,
        )
        return make_time_grid(t0, t1, num_steps, time_shifting_factor)

    def sample_ode(self, *, sampling_method="dopri5", num_steps=50, atol=1e-6, rtol=1e-3,
                   reverse=False, time_shifting_factor=None, return_all=False):
        """Return `sample_fn(x_init, model_fn) -> samples`: a fixed-step
        method (euler, midpoint, heun, rk4) over the `num_steps` points of the
        grid, or an adaptive one (dopri5 / adaptive, dopri8) saving at them
        with tolerances `atol` / `rtol`. x_init is a tensor or a tuple of
        tensors."""
        base_drift = self.drift
        if reverse:
            drift = lambda x, t, model_fn: base_drift(x, torch.ones_like(t) * (1.0 - t), model_fn)
        else:
            drift = base_drift
        ts = self.time_grid(num_steps, time_shifting_factor, reverse=reverse)
        method = sampling_method.lower()

        def sample_fn(x, model_fn):
            first = x[0] if isinstance(x, (tuple, list)) else x
            b = first.shape[0]

            def f(xx, t_scalar):
                t = torch.full((b,), float(t_scalar), dtype=torch.float32, device=first.device)
                return drift(xx, t, model_fn)

            if method in _ADAPTIVE:
                solver = odeint_dopri8 if method == "dopri8" else odeint_adaptive
                out, sample_fn.nfe = solver(f, x, ts, atol=atol, rtol=rtol,
                                            return_all=return_all)
                return out
            out = odeint_fixed(f, x, ts, method=method, return_all=return_all)
            sample_fn.nfe = fixed_nfe(method, ts.shape[0])
            return out

        sample_fn.nfe = 0
        return sample_fn

    def _sde_drift_diffusion(self, diffusion_form, diffusion_norm):
        def diffusion_fn(x, t, model_fn):
            return self.transport.path_sampler.diffusion(x, t, form=diffusion_form,
                                                         norm=diffusion_norm)

        def sde_drift(x, t, model_fn):
            return self.drift(x, t, model_fn) + diffusion_fn(x, t, model_fn) * self.score(
                x, t, model_fn)

        return sde_drift, diffusion_fn

    def _last_step_fn(self, sde_drift, last_step, last_step_size):
        """The configurable final step: none, Mean, Tweedie or Euler."""
        if last_step is None:
            return lambda x, t, model_fn: x
        if last_step == "Mean":
            return lambda x, t, model_fn: x + sde_drift(x, t, model_fn) * last_step_size
        if last_step == "Tweedie":
            alpha = self.transport.path_sampler.alpha_t
            sigma = self.transport.path_sampler.sigma_t
            return lambda x, t, model_fn: x / alpha(t)[0][0] + (sigma(t)[0][0] ** 2) / alpha(
                t)[0][0] * self.score(x, t, model_fn)
        if last_step == "Euler":
            return lambda x, t, model_fn: x + self.drift(x, t, model_fn) * last_step_size
        raise NotImplementedError(last_step)

    def sample_sde(self, *, sampling_method="Euler", diffusion_form="SBDM", diffusion_norm=1.0,
                   last_step="Mean", last_step_size=0.04, num_steps=250):
        """Return `sample_fn(x_init, model_fn, generator=None, noise=None) ->
        x_final`: Euler-Maruyama or Heun steps over the grid, then the last
        step. The Gaussian draws come from `generator`, or are the
        num_steps - 1 tensors of `noise`."""
        if last_step is None:
            last_step_size = 0.0
        sde_drift, sde_diffusion = self._sde_drift_diffusion(diffusion_form, diffusion_norm)
        t0, t1 = self.transport.check_interval(
            self.transport.train_eps, self.transport.sample_eps,
            diffusion_form=diffusion_form, sde=True, eval=True, reverse=False,
            last_step_size=last_step_size,
        )
        ts = make_time_grid(t0, t1, num_steps)
        last_fn = self._last_step_fn(sde_drift, last_step, last_step_size)

        def sample_fn(x, model_fn, generator: Optional[torch.Generator] = None, noise=None):
            b = x.shape[0]

            def batched(fn):
                return lambda xx, t_scalar: fn(
                    xx, torch.full((b,), float(t_scalar), dtype=torch.float32, device=x.device),
                    model_fn)

            x_last, _ = sdeint(batched(sde_drift), batched(sde_diffusion), x, ts,
                               generator=generator, method=sampling_method.lower(), noise=noise)
            t_last = torch.full((b,), float(t1), dtype=torch.float32, device=x.device)
            return last_fn(x_last, t_last, model_fn)

        return sample_fn

    def sample_ode_likelihood(self, *, sampling_method="dopri5", num_steps=50, atol=1e-6,
                              rtol=1e-3):
        """Return `sample_fn(x, model_fn, generator=None, eps=None) ->
        (logp, z)`: the Hutchinson estimate of the data log-likelihood
        (JAX's `sample_ode_likelihood`, the reference's `transport.py:393-450`).
        The state (x, delta_logp) runs from the data at t = 1 - t0 to the
        prior over the sampling grid, with drift (-v, sum(jvp(v)(eps) * eps))
        where v = drift(x, 1 - t); then logp = prior_logp(z) - delta_logp.
        Fixed-step methods or dopri5 / dopri8 over the pair (the error norm
        of an adaptive step spans both leaves, as JAX's `_error_ratio`).

        The Rademacher probe `eps` (+-1 in x's shape and dtype) is drawn from
        `generator`, or handed in. The Jacobian-vector product is forward
        mode, under `torch.no_grad`, so remat stays off. The flash-attention
        kernels have no forward-mode derivative (nor do JAX's: its custom_vjp
        has none), so their entry points refuse a dual input: run the model
        with `attn_impl="xla"`, as JAX's likelihood runs."""
        drift = self.drift
        ts = self.time_grid(num_steps)
        method = sampling_method.lower()

        def sample_fn(x, model_fn, generator: Optional[torch.Generator] = None, eps=None):
            b = x.shape[0]
            if eps is None:
                eps = torch.randint(0, 2, x.shape, generator=generator, device=x.device)
                eps = (2 * eps - 1).to(x.dtype)
            eps = eps.to(device=x.device, dtype=x.dtype)

            def f(state, t_scalar):
                xx, _ = state
                t = torch.full((b,), float(1.0 - t_scalar), dtype=torch.float32, device=x.device)
                with fwAD.dual_level():
                    d, jvp = fwAD.unpack_dual(drift(fwAD.make_dual(xx, eps), t, model_fn))
                if jvp is None:  # a drift that does not depend on x
                    jvp = torch.zeros_like(d)
                return -d, (jvp * eps).reshape(b, -1).sum(dim=-1)

            init = (x, torch.zeros((b,), dtype=x.dtype, device=x.device))
            with torch.no_grad():
                if method in _ADAPTIVE:
                    solver = odeint_dopri8 if method == "dopri8" else odeint_adaptive
                    (z, delta_logp), sample_fn.nfe = solver(f, init, ts, atol=atol, rtol=rtol)
                else:
                    z, delta_logp = odeint_fixed(f, init, ts, method=method)
                    sample_fn.nfe = fixed_nfe(method, ts.shape[0])
                return self.transport.prior_logp(z) - delta_logp, z

        sample_fn.nfe = 0
        return sample_fn

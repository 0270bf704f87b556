"""Conditional flow matching for audio and music (counterpart of
`lumina_t2x_tpu/transport/cfm.py`, the reference's `CFM(LatentDiffusion_audio)`):

- the OT-CFM objective: u_t = x1 - (1 - sigma_min) x0 and
  x_t = t x1 + (1 - (1 - sigma_min) t) x0 with sigma_min = 1e-4, t drawn as
  an integer step in [0, num_timesteps) and normalised;
- sampling: Euler over `linspace(0, 1, num_steps)` (num_steps points, so
  num_steps - 1 steps) through `solvers.odeint_fixed`, the model taking the
  float time `t * num_timesteps` (the JAX package's; the reference passes
  it as a long);
- CFG by a duplicated batch, the unconditional rows first:
  e = e_uncond + w (e_cond - e_uncond);
- `t_start` truncation and an `x_latent` warm start.

Random draws come from an explicit `torch.Generator` or are handed in as
tensors, which is how the tests give the port the JAX draws.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from .solvers import odeint_fixed

Noise = Union[torch.Tensor, torch.Generator, None]


class CFM:
    def __init__(self, sigma_min: float = 1e-4, num_timesteps: int = 1000):
        self.sigma_min = sigma_min
        self.num_timesteps = num_timesteps

    def draw(self, x1, generator: Optional[torch.Generator] = None, t=None, noise=None):
        """A training step's (t, noise) for the batch `x1`: the integer
        steps, then the noise, each drawn from `generator` unless given."""
        if t is None:
            t = torch.randint(0, self.num_timesteps, (x1.shape[0],), generator=generator,
                              device=x1.device)
        if noise is None:
            noise = torch.randn(x1.shape, generator=generator, device=x1.device, dtype=x1.dtype)
        return t, noise

    def p_losses(self, generator: Optional[torch.Generator], model_fn: Callable, x1, *,
                 t=None, noise=None):
        """OT-CFM MSE loss; model_fn(x_t, t_int) with t_int in [0, N). `t`
        (B,) and `noise` (x1's shape) replace the draws from `generator`,
        which draws t first, then the noise."""
        b = x1.shape[0]
        t, x0 = self.draw(x1, generator, t, noise)
        ut = x1 - (1.0 - self.sigma_min) * x0
        t_n = (t.float() / self.num_timesteps).reshape(b, *([1] * (x1.dim() - 1)))
        x_noisy = t_n * x1 + (1.0 - (1.0 - self.sigma_min) * t_n) * x0
        model_output = model_fn(x_noisy, t)
        loss = ((model_output.float() - ut.float()) ** 2).mean(dim=tuple(range(1, x1.dim())))
        return {"loss": loss.mean(), "loss_simple": loss}

    def sample(self, noise: Noise, model_fn: Callable, shape, *, num_steps: int = 25,
               solver: str = "euler", t_start: Optional[int] = None, x_latent=None,
               return_traj: bool = False, device=None):
        """Integrate the flow from noise: the starting latent is `x_latent`,
        else `noise` (a tensor of `shape`, or a generator to draw it from on
        `device`); model_fn(x, t_batch) as in training."""
        ts = torch.linspace(0.0, 1.0, num_steps, dtype=torch.float32)
        if t_start is not None:
            ts = ts[t_start:]
        if x_latent is not None:
            x0 = x_latent
        elif isinstance(noise, torch.Tensor):
            x0 = noise
        else:
            x0 = torch.randn(shape, generator=noise, device=device)
        b = x0.shape[0]

        def drift(x, t_scalar):
            t_batch = torch.full((b,), float(t_scalar * self.num_timesteps), device=x.device)
            return model_fn(x, t_batch)

        return odeint_fixed(drift, x0, ts, method=solver, return_all=return_traj)

    def sample_cfg(self, noise: Noise, model_fn: Callable, shape, cond, uncond, *,
                   guidance_scale: float = 1.0, num_steps: int = 25, solver: str = "euler",
                   t_start: Optional[int] = None, x_latent=None):
        """CFG sampling: model_fn(x_in, t_in, c_in) with
        c_in = cat([uncond, cond])."""
        c_in = torch.cat([uncond, cond], dim=0)

        def guided(x, t_batch):
            out = model_fn(torch.cat([x, x], dim=0), torch.cat([t_batch, t_batch], dim=0), c_in)
            e_uncond, e_cond = out.chunk(2, dim=0)
            return e_uncond + guidance_scale * (e_cond - e_uncond)

        return self.sample(noise, guided, shape, num_steps=num_steps, solver=solver,
                           t_start=t_start, x_latent=x_latent, device=cond.device)

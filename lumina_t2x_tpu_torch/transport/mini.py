"""Mini transport (counterpart of `lumina_t2x_tpu/transport/mini.py`): the
single-file flow API of the mini pipeline, the SD3 sampler's and the
DreamBooth trainer's.

- `training_losses_mini`: linear-path velocity MSE with uniform t; t and
  the noise are drawn from an explicit generator or handed in as tensors;
- `MiniODE`: Lumina mode integrates t: 0 -> 1 with the t-shift warp; SD3
  mode reverses time (t: 1 -> 0), applies SD3's shift
  t -> f t / (1 + (f - 1) t), hands the model t * 1000 and folds CFG into
  the drift over duplicated halves (uncond first); `strength` truncates the
  grid for img2img. Both run on `solvers.odeint_fixed`.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .solvers import odeint_fixed


def training_losses_mini(model_fn: Callable, x1, loss_mask=None, *,
                         generator: Optional[torch.Generator] = None, t=None, x0=None):
    """Linear-path velocity MSE: xt = t x1 + (1 - t) x0, target x1 - x0.
    `t` (B,) and the noise `x0` are drawn from `generator` unless given.
    Returns {"loss": (B,)}."""
    b = x1.shape[0]
    if t is None:
        t = torch.rand((b,), generator=generator, device=x1.device)
    if x0 is None:
        x0 = torch.randn(x1.shape, generator=generator, device=x1.device, dtype=x1.dtype)
    t_ = t.reshape(b, *([1] * (x1.dim() - 1)))
    xt = t_ * x1 + (1.0 - t_) * x0
    sq = (model_fn(xt, t).float() - (x1 - x0).float()) ** 2
    if loss_mask is not None:
        m = loss_mask.float()
        loss = (sq * m).reshape(b, -1).sum(-1) / m.reshape(b, -1).sum(-1).clamp_min(1.0)
    else:
        loss = sq.reshape(b, -1).mean(-1)
    return {"loss": loss}


class MiniODE:
    def __init__(self, num_steps: int, sampler_type: str = "euler",
                 time_shifting_factor: Optional[float] = None, t0: float = 0.0,
                 t1: float = 1.0, use_sd3: bool = False, strength: float = 1.0):
        f = time_shifting_factor
        if use_sd3:
            t = torch.linspace(t1, t0, num_steps, dtype=torch.float32)
            if f:
                t = (f * t) / (1.0 + (f - 1.0) * t)
        else:
            t = torch.linspace(t0, t1, num_steps, dtype=torch.float32)
            if f:
                t = t / (t + f - f * t)
        if strength != 1.0:
            t = t[int(num_steps * (1.0 - strength)):]
        self.t = t
        self.use_sd3 = use_sd3
        self.sampler_type = sampler_type

    def sample(self, x, model_fn: Callable, cfg_scale: Optional[float] = None,
               return_all: bool = False):
        """Lumina mode: model_fn(x, t_batch). SD3 mode: model_fn(x, t * 1000)
        on the first half duplicated, guided as uncond + cfg (cond - uncond)
        and returned for both halves."""
        b = x.shape[0]
        if not self.use_sd3:
            def drift(xx, t_scalar):
                t = torch.as_tensor(t_scalar, dtype=torch.float32).expand(b)
                return model_fn(xx, t.to(xx.device))
        else:
            if cfg_scale is None:
                raise ValueError("SD3 mode needs cfg_scale")

            def drift(xx, t_scalar):
                t = (torch.as_tensor(t_scalar, dtype=torch.float32) * 1000.0).expand(b)
                t = t.to(xx.device)
                half = xx[: b // 2]
                out = model_fn(torch.cat([half, half], dim=0), t)
                uncond, cond = out.chunk(2, dim=0)
                guided = uncond + cfg_scale * (cond - uncond)
                return torch.cat([guided, guided], dim=0)

        return odeint_fixed(drift, x, self.t, method=self.sampler_type, return_all=return_all)

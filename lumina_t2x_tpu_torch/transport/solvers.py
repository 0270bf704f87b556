"""Fixed-step ODE solvers (counterpart of `lumina_t2x_tpu/transport/solvers.py`)
as a plain Python step loop. The adaptive dopri5/dopri8 solvers and the SDE
solvers are not ported yet (ROADMAP queue 1, item 4)."""

from __future__ import annotations

from typing import Callable, Optional

import torch


def time_shift(t, factor: Optional[float]):
    """Warp a time grid toward t=0: t / (t + f - f*t)."""
    if factor is None:
        return t
    return t / (t + factor - factor * t)


def make_time_grid(t0: float, t1: float, num_steps: int,
                   time_shifting_factor: Optional[float] = None) -> torch.Tensor:
    """`num_steps` POINTS (num_steps - 1 intervals) from t0 to t1, fp32."""
    t = torch.linspace(t0, t1, num_steps, dtype=torch.float32)
    return time_shift(t, time_shifting_factor)


def _euler_step(f, x, t, dt):
    return x + dt * f(x, t)


def _midpoint_step(f, x, t, dt):
    k1 = f(x, t)
    return x + dt * f(x + 0.5 * dt * k1, t + 0.5 * dt)


def _heun_step(f, x, t, dt):
    k1 = f(x, t)
    k2 = f(x + dt * k1, t + dt)
    return x + 0.5 * dt * (k1 + k2)


def _rk4_step(f, x, t, dt):
    k1 = f(x, t)
    k2 = f(x + 0.5 * dt * k1, t + 0.5 * dt)
    k3 = f(x + 0.5 * dt * k2, t + 0.5 * dt)
    k4 = f(x + dt * k3, t + dt)
    return x + dt / 6.0 * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


_FIXED_STEPPERS = {
    "euler": _euler_step,
    "midpoint": _midpoint_step,
    "heun": _heun_step,
    "rk4": _rk4_step,
}


def odeint_fixed(drift_fn: Callable, x0: torch.Tensor, ts, method: str = "midpoint",
                 return_all: bool = False):
    """Integrate dx/dt = drift_fn(x, t) over the n-1 intervals of the grid
    `ts` (n points). `t` reaches drift_fn as a 0-d fp32 tensor on the host, and
    `dt` likewise, so the arithmetic is the JAX package's fp32 arithmetic.
    Returns the final state, or the (n, ...) trajectory with `return_all`."""
    stepper = _FIXED_STEPPERS.get(method.lower())
    if stepper is None:
        raise NotImplementedError(f"Unknown fixed-step method: {method}")
    ts = torch.as_tensor(ts, dtype=torch.float32).cpu()
    x = x0
    traj = [x0]
    for i in range(ts.shape[0] - 1):
        t, t_next = ts[i], ts[i + 1]
        x = stepper(drift_fn, x, t, t_next - t)
        if return_all:
            traj.append(x)
    return torch.stack(traj) if return_all else x

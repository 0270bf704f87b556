"""ODE and SDE solvers (counterpart of `lumina_t2x_tpu/transport/solvers.py`)
as plain Python step loops on the host: the fixed-step methods, the adaptive
Dormand-Prince dopri5 (PI step-size control, torchdiffeq's dense output) and
DOP853 (dopri8), and the Euler-Maruyama / Heun SDE steppers.

A state is a tensor or a tuple of tensors (the JAX solvers take a pytree).
Times reach the drift as 0-d fp32 tensors on the host, and the step sizes
likewise, so the arithmetic is the JAX package's fp32 arithmetic. The
adaptive loops accept or reject each trial step on the host: a trial reads
one error norm back from the device, one synchronize per trial. They return
`(x, nfe)`, the number of drift evaluations beside the result.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
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


# -- states: a tensor or a tuple of tensors ------------------------------------------


def _map(fn, *states):
    if isinstance(states[0], (tuple, list)):
        return tuple(fn(*leaves) for leaves in zip(*states))
    return fn(*states)


def _leaves(state):
    return list(state) if isinstance(state, (tuple, list)) else [state]


def _axpy(x, a, k):
    """x + a * k over states."""
    return _map(lambda xx, kk: xx + a * kk, x, k)


def _stack_traj(traj):
    if isinstance(traj[0], (tuple, list)):
        return tuple(torch.stack(leaves) for leaves in zip(*traj))
    return torch.stack(traj)


# -- fixed-step ODE solvers ------------------------------------------------------------


def _euler_step(f, x, t, dt):
    return _axpy(x, dt, f(x, t))


def _midpoint_step(f, x, t, dt):
    k1 = f(x, t)
    return _axpy(x, dt, f(_axpy(x, 0.5 * dt, k1), t + 0.5 * dt))


def _heun_step(f, x, t, dt):
    k1 = f(x, t)
    k2 = f(_axpy(x, dt, k1), t + dt)
    return _map(lambda xx, a, b: xx + 0.5 * dt * (a + b), x, k1, k2)


def _rk4_step(f, x, t, dt):
    k1 = f(x, t)
    k2 = f(_axpy(x, 0.5 * dt, k1), t + 0.5 * dt)
    k3 = f(_axpy(x, 0.5 * dt, k2), t + 0.5 * dt)
    k4 = f(_axpy(x, dt, k3), t + dt)
    return _map(lambda xx, a, b, c, d: xx + dt / 6.0 * (a + 2.0 * b + 2.0 * c + d),
                x, k1, k2, k3, k4)


_FIXED_STEPPERS = {
    "euler": (_euler_step, 1),
    "midpoint": (_midpoint_step, 2),
    "heun": (_heun_step, 2),
    "rk4": (_rk4_step, 4),
}


def fixed_nfe(method: str, num_points: int) -> int:
    """Drift evaluations of `odeint_fixed` over a grid of `num_points`."""
    return _FIXED_STEPPERS[method.lower()][1] * (num_points - 1)


def odeint_fixed(drift_fn: Callable, x0, ts, method: str = "midpoint",
                 return_all: bool = False):
    """Integrate dx/dt = drift_fn(x, t) over the n-1 intervals of the grid
    `ts` (n points). Returns the final state, or the (n, ...) trajectory with
    `return_all`."""
    if method.lower() not in _FIXED_STEPPERS:
        raise NotImplementedError(f"Unknown fixed-step method: {method}")
    stepper = _FIXED_STEPPERS[method.lower()][0]
    ts = torch.as_tensor(ts, dtype=torch.float32).cpu()
    x = x0
    traj = [x0]
    for i in range(ts.shape[0] - 1):
        t, t_next = ts[i], ts[i + 1]
        x = stepper(drift_fn, x, t, t_next - t)
        if return_all:
            traj.append(x)
    return _stack_traj(traj) if return_all else x


# -- adaptive Runge-Kutta (Dormand-Prince) ---------------------------------------------

_DOPRI5_C = np.array([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0])
_DOPRI5_A = [
    np.array([]),
    np.array([1 / 5]),
    np.array([3 / 40, 9 / 40]),
    np.array([44 / 45, -56 / 15, 32 / 9]),
    np.array([19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729]),
    np.array([9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656]),
    np.array([35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84]),
]
_DOPRI5_B = np.array([35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0])
_DOPRI5_B_ERR = _DOPRI5_B - np.array(
    [5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40])
# torchdiffeq's dopri5 dense-output midpoint weights (DPS_C_MID):
# y(t + dt/2) ~= y0 + dt * sum(C_MID_i * k_i)
_DOPRI5_C_MID = np.array([
    6025192743 / 30085553152 / 2, 0.0, 51252292925 / 65400821598 / 2,
    -2691868925 / 45128329728 / 2, 187940372067 / 1594534317056 / 2,
    -1776094331 / 19743644256 / 2, 11237099 / 235043384 / 2,
])


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _interp_fit(y0, y1, y_mid, f0, f1, dt):
    """Quartic Hermite through (y0, f0), (y_mid), (y1, f1) on [0, 1]: the
    torchdiffeq dense-output polynomial."""
    a = _map(lambda Y0, Y1, YM, F0, F1: 2 * dt * (F1 - F0) - 8 * (Y0 + Y1) + 16 * YM,
             y0, y1, y_mid, f0, f1)
    b = _map(lambda Y0, Y1, YM, F0, F1: dt * (5 * F0 - 3 * F1) + 18 * Y0 + 14 * Y1 - 32 * YM,
             y0, y1, y_mid, f0, f1)
    c = _map(lambda Y0, Y1, YM, F0, F1: dt * (F1 - 4 * F0) - 11 * Y0 - 5 * Y1 + 16 * YM,
             y0, y1, y_mid, f0, f1)
    d = _map(lambda F0: dt * F0, f0)
    return (a, b, c, d, y0)


def _interp_eval(coefs, frac):
    """Evaluate the fitted polynomial at frac in [0, 1] (Horner)."""
    a, b, c, d, e = coefs
    x = torch.clamp(frac, 0.0, 1.0)
    return _map(lambda A, B, C, D, E: E + x * (D + x * (C + x * (B + x * A))), a, b, c, d, e)


def _scaled_sq_sum(err, x0, x1, atol, rtol):
    """sum over the state of (err / (atol + rtol * max(|x0|, |x1|)))^2, fp32,
    as a 0-d tensor on the state's device."""
    terms = [((e.float() / (atol + rtol * torch.maximum(a.abs(), b.abs()).float())) ** 2).sum()
             for e, a, b in zip(_leaves(err), _leaves(x0), _leaves(x1))]
    return torch.stack(terms).sum()


def _numel(state) -> int:
    return sum(leaf.numel() for leaf in _leaves(state))


def _is_descending(ts) -> bool:
    return bool(ts[1] < ts[0])


def _solve_reflected(solver, drift_fn, x0, ts, **kw):
    """Integrate a DESCENDING grid by time reflection: y(s) = x(-s) solves
    dy/ds = -f(y, -s) on the ascending grid -ts."""

    def neg_drift(x, s):
        return _map(lambda v: -v, drift_fn(x, -s))

    return solver(neg_drift, x0, -ts, **kw)


def _factor(ratio: float, safety: float, order: float, min_factor: float, max_factor: float):
    """The controller's step-size factor, in fp32 as the JAX loop computes it."""
    r = torch.clamp(_f32(ratio), min=1e-10)
    return torch.clamp(safety * torch.pow(r, -1.0 / order), min_factor, max_factor)


def odeint_adaptive(drift_fn: Callable, x0, ts, atol: float = 1e-6, rtol: float = 1e-3,
                    max_steps: int = 4096, return_all: bool = False):
    """Adaptive dopri5 with a PI step-size controller and torchdiffeq-style
    dense output: the controller chooses the step sizes freely (save points
    never clip a step) and each requested point of `ts` is read off the
    quartic Hermite interpolant of the step that crossed it. The first stage
    of a step is the last of the accepted step before it (FSAL), so a trial
    costs 6 drift evaluations; `max_steps` bounds the trials per save
    interval. Returns (final state or (n, ...) trajectory, NFE)."""
    ts = torch.as_tensor(ts, dtype=torch.float32).cpu()
    if _is_descending(ts):
        return _solve_reflected(odeint_adaptive, drift_fn, x0, ts, atol=atol, rtol=rtol,
                                max_steps=max_steps, return_all=return_all)
    n_stages = 7
    safety, min_factor, max_factor, order = 0.9, 0.2, 10.0, 5.0
    nfe = 0

    def f(x, t):
        nonlocal nfe
        nfe += 1
        return drift_fn(x, t)

    def rk_step(x, t, dt, k0):
        ks = [k0]
        for i in range(1, n_stages):
            xi = x
            for j, aij in enumerate(_DOPRI5_A[i]):
                xi = _map(lambda xx, kk: xx + dt * float(aij) * kk, xi, ks[j])
            ks.append(f(xi, t + float(_DOPRI5_C[i]) * dt))
        x_next, y_mid = x, x
        err = _map(torch.zeros_like, x)
        for i in range(n_stages):
            if _DOPRI5_B[i] != 0.0:
                x_next = _map(lambda xx, kk: xx + dt * float(_DOPRI5_B[i]) * kk, x_next, ks[i])
            if _DOPRI5_B_ERR[i] != 0.0:
                err = _map(lambda ee, kk: ee + dt * float(_DOPRI5_B_ERR[i]) * kk, err, ks[i])
            if _DOPRI5_C_MID[i] != 0.0:
                y_mid = _map(lambda ym, kk: ym + dt * float(_DOPRI5_C_MID[i]) * kk, y_mid, ks[i])
        # FSAL: ks[6] is drift(x_next, t + dt)
        return x_next, err, y_mid, ks[0], ks[6]

    n_el = _numel(x0)
    x, t = x0, ts[0]
    dt = (ts[-1] - ts[0]) / 100.0
    f0 = f(x0, ts[0])
    zero = _map(torch.zeros_like, x0)
    coefs, ct0, cdt = (zero, zero, zero, zero, x0), ts[0], _f32(1.0)
    saves = [x0]
    for i in range(1, ts.shape[0]):
        t_end, trials = ts[i], 0
        while bool(t < t_end - 1e-12) and trials < max_steps:
            x_prop, err, y_mid, k0, f1 = rk_step(x, t, dt, f0)
            ratio = float(torch.sqrt(_scaled_sq_sum(err, x, x_prop, atol, rtol) / n_el))
            if ratio <= 1.0:
                coefs = _interp_fit(x, x_prop, y_mid, k0, f1, dt)
                ct0, cdt = t, dt
                x, t, f0 = x_prop, t + dt, f1
            dt = dt * _factor(ratio, safety, order, min_factor, max_factor)
            trials += 1
        if return_all or i == ts.shape[0] - 1:
            saves.append(_interp_eval(coefs, (t_end - ct0) / cdt))
    return (_stack_traj(saves) if return_all else saves[-1]), nfe


def odeint_dopri8(drift_fn: Callable, x0, ts, atol: float = 1e-6, rtol: float = 1e-3,
                  max_steps: int = 4096, return_all: bool = False):
    """8th-order Dormand-Prince (DOP853) with scipy's published tables and
    Hairer's combined 5th/3rd-order error estimate. As in the JAX solver,
    each save boundary clips the step that would cross it (no dense output),
    and an accepted clipped step keeps the controller's preferred size. A
    trial costs 12 drift evaluations (the 13th stage is the next step's
    first). Returns (final state or (n, ...) trajectory, NFE)."""
    ts = torch.as_tensor(ts, dtype=torch.float32).cpu()
    if _is_descending(ts):
        return _solve_reflected(odeint_dopri8, drift_fn, x0, ts, atol=atol, rtol=rtol,
                                max_steps=max_steps, return_all=return_all)
    from scipy.integrate._ivp import dop853_coefficients as _dc

    n_stages = int(_dc.N_STAGES)  # 12
    A = np.asarray(_dc.A)[:n_stages, :n_stages]
    B = np.asarray(_dc.B)
    C = np.asarray(_dc.C)[:n_stages]
    E3, E5 = np.asarray(_dc.E3), np.asarray(_dc.E5)  # 13 entries (with f(x_new))
    safety, min_factor, max_factor, order = 0.9, 0.2, 10.0, 8.0
    n_el = _numel(x0)
    nfe = 0

    def f(x, t):
        nonlocal nfe
        nfe += 1
        return drift_fn(x, t)

    def rk_step(x, t, dt, k0):
        ks = [k0]
        for i in range(1, n_stages):
            xi = x
            for j in range(i):
                if A[i, j] != 0.0:
                    xi = _map(lambda xx, kk: xx + dt * float(A[i, j]) * kk, xi, ks[j])
            ks.append(f(xi, t + float(C[i]) * dt))
        x_next = x
        for i in range(n_stages):
            if B[i] != 0.0:
                x_next = _map(lambda xx, kk: xx + dt * float(B[i]) * kk, x_next, ks[i])
        ks.append(f(x_next, t + dt))  # k13: the next step's first stage

        def weighted(E):
            acc = _map(torch.zeros_like, x)
            for i, e in enumerate(E):
                if e != 0.0:
                    acc = _map(lambda aa, kk: aa + float(e) * kk, acc, ks[i])
            return acc

        return x_next, weighted(E5), weighted(E3), ks[12]

    def error_norm(x, x_new, err5, err3, dt):
        e5 = _scaled_sq_sum(err5, x, x_new, atol, rtol)
        e3 = _scaled_sq_sum(err3, x, x_new, atol, rtol)
        denom = e5 + 0.01 * e3
        corr = torch.where(denom > 0, e5 / torch.sqrt(denom * n_el), torch.zeros_like(e5))
        return float(dt.abs() * corr.cpu())

    x, dt = x0, (ts[-1] - ts[0]) / 50.0
    f0 = f(x0, ts[0])
    saves = [x0]
    for t, t_end in zip(ts[:-1], ts[1:]):
        trials = 0
        while bool(t < t_end - 1e-12) and trials < max_steps:
            # dt is the controller's preferred step; only the executed step
            # is clipped at the save boundary
            dt_step = torch.minimum(dt, t_end - t)
            clipped = bool(dt_step < dt)
            x_prop, err5, err3, f1 = rk_step(x, t, dt_step, f0)
            ratio = error_norm(x, x_prop, err5, err3, dt_step)
            accept = ratio <= 1.0
            if accept:
                x, t, f0 = x_prop, t + dt_step, f1
            if not (accept and clipped):
                dt = dt_step * _factor(ratio, safety, order, min_factor, max_factor)
            trials += 1
        if return_all:
            saves.append(x)
    return (_stack_traj(saves) if return_all else x), nfe


# -- SDE solvers -----------------------------------------------------------------------


def sdeint(drift_fn: Callable, diffusion_fn: Callable, x0: torch.Tensor, ts,
           generator: Optional[torch.Generator] = None, method: str = "euler",
           return_all: bool = False, noise=None):
    """Euler-Maruyama or Heun steps over ts[:-1] (the configurable last step
    is the Sampler's). Each step's Gaussian draw w comes from `generator`, or
    is `noise[i]` (a sequence of n-1 tensors shaped like x, which is how the
    tests give the port the JAX package's draws). Returns (x_last, mean_x_last)
    at the pre-last-step state, or the (n-1, ...) trajectory of x with
    `return_all`."""
    steppers = {"euler": _em_step, "heun": _sde_heun_step}
    if method.lower() not in steppers:
        raise NotImplementedError(f"Unknown SDE method: {method}")
    stepper = steppers[method.lower()]
    ts = torch.as_tensor(ts, dtype=torch.float32).cpu()
    dt = ts[1] - ts[0]
    x, mean_x, traj = x0, x0, []
    for i, t in enumerate(ts[:-1]):
        if noise is not None:
            w = noise[i].to(device=x.device, dtype=x.dtype)
        else:
            w = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
        x, mean_x = stepper(drift_fn, diffusion_fn, x, t, dt, w * torch.sqrt(dt))
        if return_all:
            traj.append(x)
    return torch.stack(traj) if return_all else (x, mean_x)


def _em_step(drift_fn, diffusion_fn, x, t, dt, dw):
    mean_x = x + drift_fn(x, t) * dt
    return mean_x + torch.sqrt(2.0 * diffusion_fn(x, t)) * dw, mean_x


def _sde_heun_step(drift_fn, diffusion_fn, x, t, dt, dw):
    xhat = x + torch.sqrt(2.0 * diffusion_fn(x, t)) * dw
    k1 = drift_fn(xhat, t)
    k2 = drift_fn(xhat + dt * k1, t + dt)
    return xhat + 0.5 * dt * (k1 + k2), xhat

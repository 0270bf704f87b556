"""Classifier-free guidance wrappers (counterpart of
`lumina_t2x_tpu/transport/cfg.py`): model-agnostic duplicated-batch CFG over
`model_fn(x, t)`, guiding the first `num_cfg_channels` channels as the
reference does, and CFG active only inside a time interval."""

from __future__ import annotations

from typing import Callable

import torch


def cfg_wrapper(model_fn: Callable, cfg_scale: float, num_cfg_channels: int = 3):
    """Wrap `model_fn(x, t)` for duplicated-batch CFG: x is (2B, ...) with
    rows [0:B] conditional and [B:2B] unconditional (the conditioning is
    baked into model_fn). Guidance applies to the first `num_cfg_channels`
    channels (axis 1); -1 or None guides all of them."""

    def guided(x, t):
        b = x.shape[0] // 2
        half = x[:b]
        out = model_fn(torch.cat([half, half], dim=0), t)
        nc = out.shape[1] if num_cfg_channels in (-1, None) else num_cfg_channels
        eps, rest = out[:, :nc], out[:, nc:]
        cond_eps, uncond_eps = eps[:b], eps[b:]
        half_eps = uncond_eps + cfg_scale * (cond_eps - uncond_eps)
        return torch.cat([torch.cat([half_eps, half_eps], dim=0), rest], dim=1)

    return guided


def cfg_interval_wrapper(model_fn: Callable, cfg_scale: float, num_cfg_channels: int = 3,
                         t_low: float = 0.0, t_high: float = 1.0):
    """CFG active only for t[0] within [t_low, t_high] (guidance interval);
    outside it the conditional rows pass unguided."""
    guided = cfg_wrapper(model_fn, cfg_scale, num_cfg_channels)
    unguided = cfg_wrapper(model_fn, 1.0, num_cfg_channels)

    def fn(x, t):
        t0 = float(t[0])
        return guided(x, t) if t_low <= t0 <= t_high else unguided(x, t)

    return fn

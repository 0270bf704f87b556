"""Text-to-image sampling (counterpart of
`lumina_t2x_tpu/pipelines/sample_lib.py`): CFG duplication, time-aware RoPE
scaling and the fixed-step ODE solver, driven as a plain Python step loop,
plus the static-max calibration of the streaming attention kernel.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch

from ..models.next_dit import forward_with_cfg as next_dit_cfg
from ..ops.attention import resolve_impl
from ..ops.flash_attention import set_flash_static_max, streams_kv
from ..transport import Sampler, create_transport
from ..transport.solvers import time_shift


def resolution_scale_factor(width: int, height: int, train_res: int = 1024) -> float:
    """`scale_factor = sqrt(w*h / train_res^2)`."""
    return math.sqrt(width * height / train_res**2)


def _cfg_kwargs(model, width, height, train_res, scale_watershed, proportional_attn,
                vae_downsample, time_aware_scaling=True):
    """The forward_with_cfg keywords the sampler and the probe share."""
    do_extrapolation = (width * height) > (train_res * train_res)
    if not time_aware_scaling:
        scale_factor, scale_watershed = 1.0, 1.0
    else:
        scale_factor = resolution_scale_factor(width, height, train_res) if do_extrapolation else 1.0
    return dict(
        scale_factor=scale_factor,
        scale_watershed=scale_watershed if do_extrapolation else 1.0,
        proportional_attn=proportional_attn and do_extrapolation,
        base_seqlen=(train_res // vae_downsample // model.patch_size) ** 2,
    )


def build_t2i_sample_fn(
    model,
    *,
    width: int = 1024,
    height: int = 1024,
    num_steps: int = 30,
    solver: str = "midpoint",
    cfg_scale: float = 4.0,
    time_shifting_factor: Optional[float] = 4.0,
    train_res: int = 1024,
    scale_watershed: float = 0.3,
    proportional_attn: bool = True,
    path_type: str = "Linear",
    vae_downsample: int = 8,
    time_aware_scaling: bool = True,
):
    """Text-to-image sampler. Returns `sample_fn(z, cap_feats, cap_mask) ->
    latents`: z is the (B, C, H/8, W/8) starting noise, cap_feats holds the
    conditional rows then the unconditional (empty-prompt) rows, (2B, Ly, D).
    The grid has `num_steps` points, so a fixed-step solver takes
    num_steps - 1 steps (midpoint: two CFG forwards per step)."""
    sampler = Sampler(create_transport(path_type, "velocity"))
    ode_fn = sampler.sample_ode(sampling_method=solver, num_steps=num_steps,
                                time_shifting_factor=time_shifting_factor)
    kw = _cfg_kwargs(model, width, height, train_res, scale_watershed, proportional_attn,
                     vae_downsample, time_aware_scaling)

    @torch.no_grad()
    def sample_fn(z, cap_feats, cap_mask):
        b = z.shape[0]

        def model_fn(x, t):
            return next_dit_cfg(model, x, t, cap_feats, cap_mask, cfg_scale, **kw)

        out = ode_fn(torch.cat([z, z], dim=0), model_fn)
        return out[:b]

    return sample_fn


@torch.no_grad()
def autocalibrate_flash_static_max(
    model,
    cap_feats,
    cap_mask,
    *,
    width: int = 1024,
    height: int = 1024,
    cfg_scale: float = 4.0,
    time_shifting_factor: Optional[float] = 4.0,
    train_res: int = 1024,
    scale_watershed: float = 0.3,
    proportional_attn: bool = True,
    in_channels: int = 4,
    vae_downsample: int = 8,
    num_probe_steps: int = 6,
    margin: float = 6.0,
    spread_limit: float = 60.0,
    z: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Optional[float]:
    """Measure and install a static softmax bound for the streaming
    self-attention of a qk-norm model.

    Runs a short Euler probe trajectory (`num_probe_steps`) at the real
    shapes; each streaming self-attention site appends its (max, min) row
    log-sum-exp to an explicit recorder (`lse >= rowmax` always). The bound
    is max(lse) + margin, installed with `set_flash_static_max` and
    returned. Returns None, leaving the online kernel in place, when the
    `LUMINA_FLASH_STATIC_MAX` env var pins a bound, when
    `LUMINA_FLASH_STATIC_MAX_AUTO=0`, when the model has no qk-norm or does
    not use the flash impl, when the self-attention does not stream
    (<= 1024 tokens), or when the measured spread exceeds `spread_limit`.

    z: the (B, C, H/8, W/8) probe noise; drawn from `generator` when None.
    """
    if os.environ.get("LUMINA_FLASH_STATIC_MAX", ""):
        return None
    if os.environ.get("LUMINA_FLASH_STATIC_MAX_AUTO", "1") == "0":
        return None
    set_flash_static_max(None)
    if not getattr(model, "qk_norm", False):
        return None
    if resolve_impl(getattr(model, "attn_impl", "auto")) != "flash":
        return None
    lh, lw = height // vae_downsample, width // vae_downsample
    if not streams_kv((lh // model.patch_size) * (lw // model.patch_size)):
        return None

    kw = _cfg_kwargs(model, width, height, train_res, scale_watershed, proportional_attn,
                     vae_downsample)
    device = cap_feats.device
    if z is None:
        z = torch.randn((cap_feats.shape[0] // 2, in_channels, lh, lw), generator=generator,
                        device=device)
    x = torch.cat([z, z], dim=0).to(device)
    ts = torch.linspace(0.0, 1.0, num_probe_steps + 1, dtype=torch.float32)
    if time_shifting_factor:
        ts = time_shift(ts, time_shifting_factor)

    gmax, gmin = -math.inf, math.inf
    for i in range(num_probe_steps):
        t = torch.full((x.shape[0],), float(ts[i]), dtype=torch.float32, device=device)
        recorder = []
        vel = next_dit_cfg(model, x, t, cap_feats, cap_mask, cfg_scale, lse_recorder=recorder, **kw)
        if not recorder:
            return None
        ranges = torch.stack(recorder)
        gmax = max(gmax, float(ranges[:, 0].max()))
        gmin = min(gmin, float(ranges[:, 1].min()))
        x = x + (float(ts[i + 1]) - float(ts[i])) * vel

    if not math.isfinite(gmax) or not math.isfinite(gmin) or gmax - gmin > spread_limit:
        return None
    bound = gmax + margin
    set_flash_static_max(bound)
    return bound

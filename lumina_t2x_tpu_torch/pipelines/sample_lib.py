"""Sampling (counterpart of `lumina_t2x_tpu/pipelines/sample_lib.py`): the
class-conditional, text-to-image and image-to-image samplers (CFG
duplication, time-aware RoPE scaling for NextDiT or the NTK extrapolation of
Flag-DiT, the fixed-step or adaptive ODE solver, driven as a plain Python
step loop), plus the static-max calibration of the streaming attention
kernel. Each `sample_fn` records the model evaluations of its last call as
`sample_fn.nfe`.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch

from ..models.flag_dit import FlagDiT
from ..models.flag_dit import forward_with_cfg as flag_dit_cfg
from ..models.next_dit import forward_with_cfg as next_dit_cfg
from ..models.next_dit_imagenet import forward_with_cfg as imagenet_cfg
from ..ops.attention import resolve_impl
from ..ops.flash_attention import flash_static_max_scope, streams_kv
from ..parallel.comm import max_over_ranks
from ..transport import Sampler, create_transport
from ..transport.solvers import fixed_nfe, odeint_fixed, time_shift


def resolution_scale_factor(width: int, height: int, train_res: int = 1024) -> float:
    """`scale_factor = sqrt(w*h / train_res^2)`."""
    return math.sqrt(width * height / train_res**2)


def build_class_cond_sample_fn(
    model,
    *,
    num_steps: int = 30,
    solver: str = "midpoint",
    cfg_scale: float = 4.0,
    time_shifting_factor: Optional[float] = None,
    latent_size: int = 32,
    in_channels: int = 4,
    path_type: str = "Linear",
    rope_scaling_factor: float = 1.0,
    ntk_factor: float = 1.0,
):
    """Class-conditional sampler (NextDiT-ImageNet, Flag-DiT ImageNet,
    Next-DiT-MoE). Returns `sample_fn(z, labels) -> latents`:
    z is the (B, in_channels, latent_size, latent_size) starting noise,
    labels the (B,) class ids; the unconditional half-batch takes the null
    class (`model.num_classes`). The self-attention runs the online kernels
    (no static bound), as the JAX sampler calibrates none. An adaptive
    solver runs at the default tolerances (atol 1e-6, rtol 1e-3): the JAX
    class-conditional sampler takes none."""
    sampler = Sampler(create_transport(path_type, "velocity"))
    ode_fn = sampler.sample_ode(sampling_method=solver, num_steps=num_steps,
                                time_shifting_factor=time_shifting_factor)
    shape = (in_channels, latent_size, latent_size)

    @torch.no_grad()
    def sample_fn(z, labels):
        if tuple(z.shape[1:]) != shape:
            raise ValueError(f"noise of shape {tuple(z.shape)}: expected (B, *{shape})")
        b = z.shape[0]
        y = torch.cat([labels, torch.full_like(labels, model.num_classes)])

        def model_fn(x, t):
            return imagenet_cfg(model, x, t, y, cfg_scale, rope_scaling_factor=rope_scaling_factor,
                                ntk_factor=ntk_factor)

        with flash_static_max_scope(None):
            out = ode_fn(torch.cat([z, z], dim=0), model_fn)
        sample_fn.nfe = ode_fn.nfe
        return out[:b]

    sample_fn.nfe = 0
    return sample_fn


def _t2i_cfg(model, width, height, train_res, scale_watershed, proportional_attn,
             vae_downsample, time_aware_scaling=True, attn_scale_variant="proportional",
             kv_merge_ratio=1):
    """The CFG forward the sampler and the probe share:
    `fn(x, t, cap_feats, cap_mask, cfg_scale, lse_recorder=None)`. NextDiT
    scales its RoPE time-aware beyond `train_res`^2 and takes the anagram
    scale variant and `kv_merge_ratio`; Flag-DiT instead takes the NTK
    factor seq_len / base_seqlen over the image tokens (the [eol] column
    left out), with no time-aware scaling."""
    do_extrapolation = (width * height) > (train_res * train_res)
    base_seqlen = (train_res // vae_downsample // model.patch_size) ** 2
    proportional_attn = proportional_attn and do_extrapolation
    if isinstance(model, FlagDiT):
        seq_len = ((height // vae_downsample // model.patch_size)
                   * (width // vae_downsample // model.patch_size))
        kw = dict(ntk_factor=seq_len / base_seqlen if do_extrapolation else 1.0,
                  proportional_attn=proportional_attn, base_seqlen=base_seqlen)
        return lambda x, t, cap_feats, cap_mask, cfg_scale, lse_recorder=None: flag_dit_cfg(
            model, x, t, cfg_scale, cap_feats=cap_feats, cap_mask=cap_mask,
            lse_recorder=lse_recorder, **kw)
    if not time_aware_scaling:
        scale_factor, scale_watershed = 1.0, 1.0
    else:
        scale_factor = resolution_scale_factor(width, height, train_res) if do_extrapolation else 1.0
    kw = dict(scale_factor=scale_factor,
              scale_watershed=scale_watershed if do_extrapolation else 1.0,
              proportional_attn=proportional_attn, base_seqlen=base_seqlen,
              attn_scale_variant=attn_scale_variant, kv_merge_ratio=kv_merge_ratio)
    return lambda x, t, cap_feats, cap_mask, cfg_scale, lse_recorder=None: next_dit_cfg(
        model, x, t, cap_feats, cap_mask, cfg_scale, lse_recorder=lse_recorder, **kw)


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
    static_max: Optional[float] = None,
    atol: float = 1e-6,
    rtol: float = 1e-3,
):
    """Text-to-image sampler (NextDiT, Flag-DiT). Returns `sample_fn(z, cap_feats, cap_mask) ->
    latents`: z is the (B, C, H/8, W/8) starting noise, cap_feats holds the
    conditional rows then the unconditional (empty-prompt) rows, (2B, Ly, D).
    The grid has `num_steps` points, so a fixed-step solver takes
    num_steps - 1 steps (midpoint: two CFG forwards per step); atol / rtol
    are the tolerances of the adaptive solvers (dopri5, dopri8).

    static_max: the softmax bound of the streaming self-attention (from
    `autocalibrate_flash_static_max`; None: the online kernel). Every run
    of the sampler uses it, whatever bound other samplers or threads hold,
    as a JAX sampler bakes in the bound it was traced with; the
    `LUMINA_FLASH_STATIC_MAX` pin still wins."""
    sampler = Sampler(create_transport(path_type, "velocity"))
    ode_fn = sampler.sample_ode(sampling_method=solver, num_steps=num_steps,
                                time_shifting_factor=time_shifting_factor, atol=atol, rtol=rtol)
    cfg = _t2i_cfg(model, width, height, train_res, scale_watershed, proportional_attn,
                   vae_downsample, time_aware_scaling)

    @torch.no_grad()
    def sample_fn(z, cap_feats, cap_mask):
        b = z.shape[0]

        def model_fn(x, t):
            return cfg(x, t, cap_feats, cap_mask, cfg_scale)

        with flash_static_max_scope(static_max):
            out = ode_fn(torch.cat([z, z], dim=0), model_fn)
        sample_fn.nfe = ode_fn.nfe
        return out[:b]

    sample_fn.nfe = 0
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
    attn_scale_variant: str = "proportional",
    kv_merge_ratio: int = 1,
) -> Optional[float]:
    """Measure a static softmax bound for the streaming self-attention of a
    qk-norm model.

    Runs a short Euler probe trajectory (`num_probe_steps`) at the real
    shapes; each streaming self-attention site appends its (max, min) row
    log-sum-exp to an explicit recorder (`lse >= rowmax` always). The bound
    is max(lse) + margin, returned for `build_t2i_sample_fn(static_max=)`:
    nothing is installed, and the probe itself runs the online kernel
    whatever bound the process holds. Returns None (the online kernel) when
    the `LUMINA_FLASH_STATIC_MAX` env var pins a bound, when
    `LUMINA_FLASH_STATIC_MAX_AUTO=0`, when the model has no qk-norm or does
    not use the flash impl, when the self-attention does not stream
    (<= 1024 tokens), or when the measured spread exceeds `spread_limit`.

    z: the (B, C, H/8, W/8) probe noise; drawn from `generator` when None.
    attn_scale_variant, kv_merge_ratio: the NextDiT forward's (the anagram
    app's phase 2); under `kv_merge_ratio` > 1 only sites whose pooled keys
    still stream record, so a probe with none returns None.
    """
    if os.environ.get("LUMINA_FLASH_STATIC_MAX", ""):
        return None
    if os.environ.get("LUMINA_FLASH_STATIC_MAX_AUTO", "1") == "0":
        return None
    if not getattr(model, "qk_norm", False):
        return None
    if resolve_impl(getattr(model, "attn_impl", "auto")) != "flash":
        return None
    lh, lw = height // vae_downsample, width // vae_downsample
    if not streams_kv((lh // model.patch_size) * (lw // model.patch_size)):
        return None

    cfg = _t2i_cfg(model, width, height, train_res, scale_watershed, proportional_attn,
                   vae_downsample, attn_scale_variant=attn_scale_variant,
                   kv_merge_ratio=kv_merge_ratio)
    device = cap_feats.device
    if z is None:
        z = torch.randn((cap_feats.shape[0] // 2, in_channels, lh, lw), generator=generator,
                        device=device)
    x = torch.cat([z, z], dim=0).to(device)
    ts = torch.linspace(0.0, 1.0, num_probe_steps + 1, dtype=torch.float32)
    if time_shifting_factor:
        ts = time_shift(ts, time_shifting_factor)

    gmax, gmin = -math.inf, math.inf
    with flash_static_max_scope(None):
        for i in range(num_probe_steps):
            t = torch.full((x.shape[0],), float(ts[i]), dtype=torch.float32, device=device)
            recorder = []
            vel = cfg(x, t, cap_feats, cap_mask, cfg_scale, lse_recorder=recorder)
            if not recorder:
                return None
            ranges = torch.stack(recorder)
            gmax = max(gmax, float(ranges[:, 0].max()))
            gmin = min(gmin, float(ranges[:, 1].min()))
            x = x + (float(ts[i + 1]) - float(ts[i])) * vel

    gmax, neg_gmin = max_over_ranks([gmax, -gmin], device)
    gmin = -neg_gmin
    if not math.isfinite(gmax) or not math.isfinite(gmin) or gmax - gmin > spread_limit:
        return None
    return gmax + margin


def build_img2img_sample_fn(
    model,
    *,
    strength: float = 0.6,
    num_steps: int = 30,
    solver: str = "midpoint",
    cfg_scale: float = 4.0,
    time_shifting_factor: Optional[float] = 4.0,
    static_max: Optional[float] = None,
):
    """SDEdit-style image-to-image: the ODE starts from `z * (1 - t0) + x1 * t0`,
    t0 = 1 - strength, over the `num_steps`-point grid of [t0, 1], time-shifted
    and re-normalised to start at t0 and end at 1. Returns
    `sample_fn(z, x1, cap_feats, cap_mask) -> latents`: z the starting noise
    and x1 the image's latent, both (B, C, h, w); cap_feats holds the
    conditional rows then the unconditional ones. The model runs the plain
    NextDiT CFG forward (no RoPE scaling), as in JAX. `static_max`: the
    bound of the streaming self-attention, as in `build_t2i_sample_fn`."""
    if not 0.0 < strength <= 1.0:
        raise ValueError(f"strength must be in (0, 1], got {strength} "
                         "(0 would leave a degenerate single-point schedule)")
    if num_steps < 2:
        raise ValueError(f"num_steps must be >= 2, got {num_steps} "
                         "(the truncated grid renormalization needs a span)")
    t0 = 1.0 - strength
    ts = torch.linspace(t0, 1.0, num_steps, dtype=torch.float32)
    ts = time_shift(ts, time_shifting_factor) if time_shifting_factor else ts
    ts = t0 + (ts - ts[0]) * (1.0 - t0) / (ts[-1] - ts[0])

    @torch.no_grad()
    def sample_fn(z, x1, cap_feats, cap_mask):
        if z.shape != x1.shape:
            raise ValueError(f"noise {tuple(z.shape)} and latent {tuple(x1.shape)} differ")
        b = x1.shape[0]
        x_start = z * (1.0 - t0) + x1 * t0

        def drift(x, t_scalar):
            t = torch.full((x.shape[0],), float(t_scalar), dtype=torch.float32, device=x.device)
            return next_dit_cfg(model, x, t, cap_feats, cap_mask, cfg_scale)

        with flash_static_max_scope(static_max):
            out = odeint_fixed(drift, torch.cat([x_start, x_start], dim=0), ts, method=solver)
        sample_fn.nfe = fixed_nfe(solver, num_steps)
        return out[:b]

    sample_fn.nfe = 0
    return sample_fn

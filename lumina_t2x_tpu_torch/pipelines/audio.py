"""Audio / music generation glue and the latent-diffusion scaffold
(counterpart of `lumina_t2x_tpu/pipelines/audio.py`):

- beta schedules, the DDIM timestep / sigma tables and a DDIM sampler (the
  legacy pre-CFM path), its per-step noise explicit;
- `instantiate_from_config` / `get_obj_from_str`, the target-string
  factories of OmegaConf-style configs; `load_music_config` reads the port's
  copy of the text-to-music config (`configs/lumina-text2music.yaml` in this
  package, whose targets are the port's classes);
- the `LambdaLinearScheduler` warm-up learning-rate factor;
- `generate_audio`: CFM sample over FlagDiT-1D -> 1-D VAE decode -> BigVGAN.
"""

from __future__ import annotations

import importlib
import logging
import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..transport.cfm import CFM, Noise
from ..utils.yaml_subset import parse_yaml_subset

MUSIC_CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "configs", "lumina-text2music.yaml")


# -- beta schedules and DDIM tables -----------------------------------------------------


def make_beta_schedule(schedule: str, n_timestep: int, linear_start=1e-4, linear_end=2e-2,
                       cosine_s=8e-3) -> np.ndarray:
    if schedule == "linear":
        betas = np.linspace(linear_start ** 0.5, linear_end ** 0.5, n_timestep,
                            dtype=np.float64) ** 2
    elif schedule == "cosine":
        timesteps = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
        alphas = np.cos(timesteps / (1 + cosine_s) * np.pi / 2) ** 2
        alphas = alphas / alphas[0]
        betas = np.clip(1 - alphas[1:] / alphas[:-1], 0, 0.999)
    elif schedule == "sqrt_linear":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    elif schedule == "sqrt":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64) ** 0.5
    else:
        raise ValueError(f"schedule '{schedule}' unknown.")
    return betas.astype(np.float64)


def make_ddim_timesteps(ddim_discr_method: str, num_ddim_timesteps: int,
                        num_ddpm_timesteps: int) -> np.ndarray:
    if ddim_discr_method == "uniform":
        c = num_ddpm_timesteps // num_ddim_timesteps
        ddim_timesteps = np.asarray(list(range(0, num_ddpm_timesteps, c)))
    elif ddim_discr_method == "quad":
        ddim_timesteps = (np.linspace(0, np.sqrt(num_ddpm_timesteps * 0.8),
                                      num_ddim_timesteps) ** 2).astype(int)
    else:
        raise NotImplementedError(ddim_discr_method)
    return ddim_timesteps + 1


def make_ddim_sampling_parameters(alphacums, ddim_timesteps, eta: float):
    alphas = alphacums[ddim_timesteps]
    alphas_prev = np.asarray([alphacums[0]] + alphacums[ddim_timesteps[:-1]].tolist())
    sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev))
    return sigmas, alphas, alphas_prev


def ddim_sample(noise: Noise, model_fn: Callable, shape, *, num_ddpm_timesteps=1000,
                num_steps=50, eta=0.0, beta_schedule="linear", cfg_fn=None,
                step_noise: Optional[Sequence[torch.Tensor]] = None, device=None):
    """The legacy DDIM sampler; model_fn predicts eps(x, t). `cfg_fn`, when
    given, replaces model_fn as the eps predictor (the guided combination).

    The start is `noise` (a tensor of `shape`, or a generator to draw it from
    on `device`). The step noise (scaled by each step's sigma; zero at
    eta 0) is `step_noise[i]` for step i, else drawn from the same generator
    step by step.

    The timesteps keep the reference's +1: the model is conditioned at
    t in {1, c + 1, ...} and the alphas are indexed there, with alphas_prev
    anchored at alphacums[0], so the last step is a real denoise."""
    betas = make_beta_schedule(beta_schedule, num_ddpm_timesteps)
    alphas_cumprod = np.cumprod(1.0 - betas)
    ts = make_ddim_timesteps("uniform", num_steps, num_ddpm_timesteps)
    sigmas, a_t, a_prev = make_ddim_sampling_parameters(alphas_cumprod, ts, eta)
    rows = torch.from_numpy(np.stack([ts, a_t, a_prev, sigmas], axis=1)[::-1].astype(np.float32))
    generator = noise if isinstance(noise, torch.Generator) else None
    x = noise if isinstance(noise, torch.Tensor) else torch.randn(shape, generator=generator,
                                                                  device=device)
    eps_fn = cfg_fn if cfg_fn is not None else model_fn
    b = x.shape[0]
    for i, (t, at, aprev, sigma) in enumerate(rows):
        eps = eps_fn(x, torch.full((b,), float(t), device=x.device))
        pred_x0 = (x - torch.sqrt(1.0 - at) * eps) / torch.sqrt(at)
        dir_xt = torch.sqrt(torch.clamp(1.0 - aprev - sigma ** 2, min=0.0)) * eps
        z = (step_noise[i] if step_noise is not None
             else torch.randn(x.shape, generator=generator, device=x.device))
        x = torch.sqrt(aprev) * pred_x0 + dir_xt + sigma * z
    return x


# -- config-string factory ------------------------------------------------------------


def get_obj_from_str(string: str, reload: bool = False):
    module, cls = string.rsplit(".", 1)
    mod = importlib.import_module(module)
    if reload:
        importlib.reload(mod)
    return getattr(mod, cls)


def instantiate_from_config(config):
    if "target" not in config:
        raise KeyError("Expected key `target` to instantiate.")
    return get_obj_from_str(config["target"])(**config.get("params", {}))


def load_music_config(path: str = MUSIC_CONFIG) -> dict:
    """The text-to-music config as a dict of `target` / `params` sections."""
    with open(path) as f:
        return parse_yaml_subset(f.read())


# -- learning-rate schedule -----------------------------------------------------------


def lambda_linear_schedule(warm_up_steps, f_min, f_max, f_start, cycle_lengths,
                           verbosity_interval: int = 0):
    """`LambdaLinearScheduler` with the reference's cycle lists: each of the
    five arguments is a per-cycle list (a scalar is one cycle); the active
    cycle is the first whose cumulative end >= step; within it a linear
    warm-up f_start -> f_max over warm_up_steps, then the linear decay
    f_min + (f_max - f_min) (L - n) / L, not clamped at f_min (the reference
    applies no min). Steps past the last cycle stay in it. Returns
    f(step) -> float, computed in fp32."""
    as_list = lambda v: list(v) if isinstance(v, (list, tuple)) else [v]  # noqa: E731
    wu, fmn, fmx, fst, cl = (np.asarray(as_list(v), np.float32) for v in
                             (warm_up_steps, f_min, f_max, f_start, cycle_lengths))
    if not len(wu) == len(fmn) == len(fmx) == len(fst) == len(cl):
        raise ValueError("all five schedule arguments must have the same number of cycles")
    cum = np.cumsum([0] + [int(c) for c in cl])
    ends, starts = cum[1:].astype(np.float32), cum[:-1].astype(np.float32)
    one = np.float32(1.0)

    def f(step):
        s = np.float32(step)
        cycle = int(np.clip(np.sum(s > ends), 0, len(cl) - 1))
        n = s - starts[cycle]
        if verbosity_interval > 0 and int(step) % verbosity_interval == 0:
            logging.getLogger(__name__).info(f"lr schedule: step {int(step)} cycle {cycle}")
        if n < wu[cycle]:
            return float(fst[cycle] + (fmx[cycle] - fst[cycle]) * n / max(wu[cycle], one))
        return float(fmn[cycle] + (fmx[cycle] - fmn[cycle]) * (cl[cycle] - n) / cl[cycle])

    return f


# -- end-to-end generation ------------------------------------------------------------


def generate_audio(noise: Noise, denoiser_fn: Callable, vae_decode_fn: Callable,
                   vocoder_fn: Optional[Callable], *, cond, uncond, latent_shape,
                   guidance_scale: float = 3.0, num_steps: int = 25, solver: str = "euler",
                   scale_factor: float = 1.0):
    """cond / uncond text features -> CFM latent sample -> mel -> waveform.

    denoiser_fn(x, t, context) is FlagDiT-1D; vae_decode_fn(z) -> mel;
    vocoder_fn(mel) -> waveform (optional). `noise`: the starting latent or
    a generator. `scale_factor` is the LDM latent scale (a trained
    checkpoint's `scale_factor` buffer): the latents are divided by it before
    the decode."""
    z = CFM().sample_cfg(noise, denoiser_fn, latent_shape, cond, uncond,
                         guidance_scale=guidance_scale, num_steps=num_steps, solver=solver)
    mel = vae_decode_fn(z / scale_factor)
    if vocoder_fn is None:
        return mel, None
    return mel, vocoder_fn(mel)

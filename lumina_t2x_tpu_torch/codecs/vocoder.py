"""The BigVGAN vocoder, mel -> waveform (counterpart of
`lumina_t2x_tpu/codecs/vocoder.py`, the reference's BigVGAN generator):

- SnakeBeta: x + (1 / (exp(beta) + 1e-9)) sin^2(exp(alpha) x), per channel,
  in fp32;
- the alias-free activation: 2x FIR upsample -> snake -> 2x FIR downsample
  with kaiser-windowed sinc filters (`upsample2_fir`, `downsample2_fir`),
  depthwise convolutions;
- AMP blocks (dilated conv stacks with alias-free snakes between),
  transposed-conv upsampling, conv_pre / conv_post and a tanh output.

Plain torch in (B, C, T), cuDNN's convolutions on the card (the JAX package
runs `lax.conv` here, outside any Pallas kernel). The transposed
convolutions are torch's `ConvTranspose1d(padding=(k - rate) // 2)`, the
reference's, so that T mel frames become T * prod(rates) samples. Module
names are the reference generator's after weight-norm removal
(`conv_pre`, `ups.<i>.0`, `resblocks.<n>.convs{1,2}.<d>`,
`resblocks.<n>.activations.<k>.act.{alpha,beta}`, `activation_post.act`,
`conv_post`): `import_bigvgan_weights` rebuilds the weight-normed weights of
a `best_netG.pt` and `core/checkpoint.bigvgan_state_dict_from_jax` carries a
JAX tree across.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def kaiser_sinc_filter1d(cutoff: float, half_width: float, kernel_size: int) -> np.ndarray:
    """Kaiser-windowed sinc low-pass FIR (`alias_free_torch/filter.py`)."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    delta_f = 4 * half_width
    a = 2.285 * (half_size - 1) * math.pi * delta_f + 7.95
    if a > 50.0:
        beta = 0.1102 * (a - 8.7)
    elif a >= 21.0:
        beta = 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21.0)
    else:
        beta = 0.0
    window = np.kaiser(kernel_size, beta)
    if even:
        time = np.arange(-half_size, half_size) + 0.5
    else:
        time = np.arange(kernel_size) - half_size
    if cutoff == 0:
        return np.zeros(kernel_size)
    f = 2 * cutoff * window * np.sinc(2 * cutoff * time)
    return (f / f.sum()).astype(np.float32)


def _depthwise_fir(x, fir: np.ndarray, stride: int = 1):
    """x (B, C, T): the same FIR correlated with every channel, no padding;
    the taps follow x's dtype and device."""
    c = x.shape[1]
    w = torch.as_tensor(fir, dtype=x.dtype, device=x.device).reshape(1, 1, -1).expand(c, 1, -1)
    return F.conv1d(x, w, stride=stride, groups=c)


def upsample2_fir(x, kernel_size: int = 12):
    """Replicate-pad by k/2 - 1, zero-stuff 2x, low-pass, crop: the
    reference's `UpSample1d` (transposed conv, stride 2) as a valid
    correlation of the stuffed signal at offset 2(k/2 - 1) + (k - 2)/2 - (k - 1)."""
    b, c, t = x.shape
    pad = kernel_size // 2 - 1
    xe = F.pad(x, (pad, pad), mode="replicate")
    stuffed = torch.zeros(b, c, 2 * (t + 2 * pad), dtype=x.dtype, device=x.device)
    stuffed[..., ::2] = xe
    fir = 2 * kaiser_sinc_filter1d(0.25, 0.3, kernel_size)
    off = 2 * pad + (kernel_size - 2) // 2 - (kernel_size - 1)
    return _depthwise_fir(stuffed, fir)[..., off: off + 2 * t]


def downsample2_fir(x, kernel_size: int = 12):
    """Replicate-pad (k/2 - 1, k/2), then a stride-2 low-pass: the
    reference's `DownSample1d`."""
    fir = kaiser_sinc_filter1d(0.25, 0.3, kernel_size)
    xe = F.pad(x, (kernel_size // 2 - 1, kernel_size // 2), mode="replicate")
    return _depthwise_fir(xe, fir, stride=2)


class SnakeBeta(nn.Module):
    """x + (1/beta) sin^2(alpha x), per-channel log-scale alpha and beta."""

    def __init__(self, channels: int, alpha_logscale: bool = True):
        super().__init__()
        self.alpha_logscale = alpha_logscale
        self.alpha = nn.Parameter(torch.zeros(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        alpha, beta = self.alpha.float(), self.beta.float()
        if self.alpha_logscale:
            alpha, beta = torch.exp(alpha), torch.exp(beta)
        xf = x.float()
        out = xf + (1.0 / (beta[None, :, None] + 1e-9)) * torch.sin(alpha[None, :, None] * xf) ** 2
        return out.to(x.dtype)


class AliasFreeSnake(nn.Module):
    """up2 -> snake -> down2 (the reference's `Activation1d`, `act` inside)."""

    def __init__(self, channels: int):
        super().__init__()
        self.act = SnakeBeta(channels)

    def forward(self, x):
        return downsample2_fir(self.act(upsample2_fir(x)))


class AMPBlock(nn.Module):
    """Anti-aliased multi-periodicity block, variant 1: for each dilation d,
    snake -> dilated conv -> snake -> conv, added to the input."""

    def __init__(self, channels: int, kernel_size: int = 3, dilations: Sequence[int] = (1, 3, 5)):
        super().__init__()
        k = kernel_size
        self.convs1 = nn.ModuleList([nn.Conv1d(channels, channels, k, dilation=d,
                                               padding=d * (k - 1) // 2) for d in dilations])
        self.convs2 = nn.ModuleList([nn.Conv1d(channels, channels, k, padding=(k - 1) // 2)
                                     for _ in dilations])
        self.activations = nn.ModuleList([AliasFreeSnake(channels)
                                          for _ in range(2 * len(dilations))])

    def forward(self, x):
        for i, (c1, c2) in enumerate(zip(self.convs1, self.convs2)):
            h = c1(self.activations[2 * i](x))
            x = x + c2(self.activations[2 * i + 1](h))
        return x


class BigVGAN(nn.Module):
    """mel (B, mel_bins, T) -> waveform (B, T * prod(upsample_rates))."""

    def __init__(self, mel_bins: int = 80, upsample_rates: Sequence[int] = (4, 4, 2, 2, 2, 2),
                 upsample_kernel_sizes: Sequence[int] = (8, 8, 4, 4, 4, 4),
                 upsample_initial_channel: int = 1536,
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5),) * 3):
        super().__init__()
        self.num_kernels = len(resblock_kernel_sizes)
        ch = upsample_initial_channel
        self.conv_pre = nn.Conv1d(mel_bins, ch, 7, padding=3)
        ups, resblocks = [], []
        for rate, k in zip(upsample_rates, upsample_kernel_sizes):
            ups.append(nn.ModuleList([nn.ConvTranspose1d(ch, ch // 2, k, rate,
                                                         padding=(k - rate) // 2)]))
            ch //= 2
            resblocks += [AMPBlock(ch, rk, rd)
                          for rk, rd in zip(resblock_kernel_sizes, resblock_dilation_sizes)]
        self.ups = nn.ModuleList(ups)
        self.resblocks = nn.ModuleList(resblocks)
        self.activation_post = AliasFreeSnake(ch)
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3)

    def forward(self, mel):
        x = self.conv_pre(mel)
        nk = self.num_kernels
        for i, up in enumerate(self.ups):
            x = up[0](x)
            acc = self.resblocks[i * nk](x)
            for j in range(1, nk):
                acc = acc + self.resblocks[i * nk + j](x)
            x = acc / nk
        x = self.conv_post(self.activation_post(x))
        return torch.tanh(x)[:, 0]


def _wn_weight(sd, name: str) -> torch.Tensor:
    """A weight-normed weight rebuilt: g * v / ||v||, the norm over every
    axis but 0 (torch's default dim=0); a plain `.weight` as it is."""
    if f"{name}.weight" in sd:
        return torch.as_tensor(sd[f"{name}.weight"]).float()
    g = torch.as_tensor(sd[f"{name}.weight_g"]).double()
    v = torch.as_tensor(sd[f"{name}.weight_v"]).double()
    norm = v.pow(2).sum(dim=tuple(range(1, v.dim())), keepdim=True).sqrt()
    return (g * v / norm).float()


def import_bigvgan_weights(state_dict: Dict) -> Dict[str, torch.Tensor]:
    """A reference BigVGAN generator state dict (`best_netG.pt`, optionally
    nested under "generator"; snakebeta activations, weight-normed convs)
    -> the port's `BigVGAN` state dict: each `weight_g` / `weight_v` pair
    becomes its `weight`, the resamplers' fixed filters are dropped (the
    port computes them), the rest is kept as fp32;
    `load_state_dict(..., strict=True)` checks the architecture."""
    sd = state_dict
    if isinstance(sd.get("generator"), dict):
        sd = sd["generator"]
    out = {}
    for key, value in sd.items():
        if key.endswith(".filter") or key.endswith(".weight_g"):
            continue
        if key.endswith(".weight_v"):
            name = key[: -len(".weight_v")]
            out[f"{name}.weight"] = _wn_weight(sd, name)
        else:
            out[key] = torch.as_tensor(value).float()
    return out


class VocoderBigVGAN:
    """Inference wrapper: mel spectrogram -> waveform (numpy, on the host)."""

    def __init__(self, model: BigVGAN):
        self.model = model.eval().requires_grad_(False)

    @classmethod
    def create(cls, seed: int = 0, mel_bins: int = 80, device="cuda", **kwargs):
        """Random weights from `seed` (the snake parameters at their zero
        init)."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = BigVGAN(mel_bins=mel_bins, **kwargs)
        return cls(model.to(device))

    @classmethod
    def from_torch_checkpoint(cls, ckpt_path: str, mel_bins: int = 80, device="cuda",
                              **kwargs):
        """The reference's trained vocoder (`best_netG.pt`)."""
        from ..core.checkpoint import load_torch_state_dict

        model = BigVGAN(mel_bins=mel_bins, **kwargs)
        model.load_state_dict(import_bigvgan_weights(load_torch_state_dict(ckpt_path)),
                              strict=True)
        return cls(model.to(device))

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @torch.no_grad()
    def vocode(self, mel) -> np.ndarray:
        """(B, mel, T) or (mel, T), a tensor or an array -> (B, T * rate)."""
        mel = torch.as_tensor(mel, dtype=torch.float32, device=self.device)
        if mel.dim() == 2:
            mel = mel[None]
        return self.model(mel).float().cpu().numpy()

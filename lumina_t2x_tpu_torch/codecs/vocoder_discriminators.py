"""BigVGAN's discriminators (MPD and MRD) and GAN losses, for fine-tuning
the vocoder (counterpart of `lumina_t2x_tpu/codecs/vocoder_discriminators.py`,
the reference's `vocoder/bigvgan/models.py:289-492`).

- `WNConv`: weight-normed convolution, w = g * v / ||v|| (the norm over all
  axes but the output channel), recomputed at each call from the
  `weight_v` / `weight_g` parameters, the reference's state-dict names, so
  a reference `MultiPeriodDiscriminator` / `MultiResolutionDiscriminator`
  state dict loads as it is;
- the period discriminator folds time into (T / period, period) and runs
  strided (5, 1) convolutions; the resolution discriminator's front end is
  the magnitude STFT with a rectangular `win_length` window centred in the
  `n_fft` frame, center=False and (n_fft - hop) / 2 reflect padding (the
  reference's `torch.stft(window=None)`);
- feature, discriminator and generator losses; the real branch's feature
  maps are detached in `feature_loss` (the generator step's).

Plain torch in NCHW, cuDNN's convolutions on the card. Defaults are
BigVGAN-base's: periods (2, 3, 5, 7, 11), resolutions
((1024, 120, 600), (2048, 240, 1200), (512, 50, 240)), channel multiplier 1.
`core/checkpoint.discriminator_state_dict_from_jax` carries a JAX tree
across.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

LRELU_SLOPE = 0.1


class WNConv(nn.Module):
    """Weight-normed Conv2d / Conv1d (by the kernel's rank)."""

    def __init__(self, cin: int, cout: int, kernel_size: Tuple[int, ...],
                 stride: Tuple[int, ...] = None, padding: Tuple[int, ...] = None):
        super().__init__()
        nd = len(kernel_size)
        conv = (nn.Conv2d if nd == 2 else nn.Conv1d)(cin, cout, kernel_size)
        self.stride = stride or (1,) * nd
        self.padding = padding or tuple(k // 2 for k in kernel_size)
        v = conv.weight.detach()
        self.weight_v = nn.Parameter(v.clone())
        self.weight_g = nn.Parameter(v.pow(2).sum(dim=tuple(range(1, v.dim())),
                                                  keepdim=True).sqrt())
        self.bias = nn.Parameter(torch.zeros(cout))
        self._conv = F.conv2d if nd == 2 else F.conv1d

    def forward(self, x):
        v = self.weight_v
        norm = v.pow(2).sum(dim=tuple(range(1, v.dim())), keepdim=True).sqrt()
        w = v / norm.clamp_min(1e-12) * self.weight_g
        return self._conv(x, w, self.bias, stride=self.stride, padding=self.padding)


def _waveform(x):
    """(B, T) or (B, 1, T) -> (B, 1, T)."""
    return x[:, None] if x.dim() == 2 else x


class PeriodDiscriminator(nn.Module):
    """DiscriminatorP: (B, 1, T) -> (scores (B, N), feature maps)."""

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3,
                 channel_mult: float = 1.0):
        super().__init__()
        self.period = period
        m = channel_mult
        widths = [1, int(32 * m), int(128 * m), int(512 * m), int(1024 * m)]
        pad = (kernel_size - 1) // 2
        self.convs = nn.ModuleList(
            [WNConv(cin, cout, (kernel_size, 1), (stride, 1), (pad, 0))
             for cin, cout in zip(widths[:-1], widths[1:])]
            + [WNConv(widths[-1], int(1024 * m), (kernel_size, 1), (1, 1), (2, 0))])
        self.conv_post = WNConv(int(1024 * m), 1, (3, 1), (1, 1), (1, 0))

    def forward(self, x) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        x = _waveform(x)
        b, c, t = x.shape
        if t % self.period:
            pad = self.period - t % self.period
            x = F.pad(x, (0, pad), mode="reflect")
            t += pad
        x = x.reshape(b, c, t // self.period, self.period)
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.flatten(1), fmap


class ResolutionDiscriminator(nn.Module):
    """DiscriminatorR: the magnitude spectrogram (B, 1, F, T) through (3, 9)
    convolutions striding time."""

    def __init__(self, resolution: Tuple[int, int, int], channel_mult: float = 1.0):
        super().__init__()
        self.resolution = tuple(resolution)  # (n_fft, hop, win_length)
        ch = int(32 * channel_mult)
        specs = [((3, 9), (1, 1)), ((3, 9), (1, 2)), ((3, 9), (1, 2)), ((3, 9), (1, 2)),
                 ((3, 3), (1, 1))]
        self.convs = nn.ModuleList([WNConv(1 if i == 0 else ch, ch, k, s,
                                           (k[0] // 2, k[1] // 2))
                                    for i, (k, s) in enumerate(specs)])
        self.conv_post = WNConv(ch, 1, (3, 3), (1, 1), (1, 1))

    def spectrogram(self, x):
        """(B, T) -> |STFT| (B, frames, n_fft // 2 + 1), fp32."""
        n_fft, hop, win = self.resolution
        pad = (n_fft - hop) // 2
        x = F.pad(x.float()[:, None], (pad, pad), mode="reflect")[:, 0]
        off = (n_fft - win) // 2
        frames = x.unfold(-1, n_fft, hop)[..., off:off + win]
        frames = F.pad(frames, (0, n_fft - win))
        return torch.fft.rfft(frames, dim=-1).abs()

    def forward(self, x) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        x = self.spectrogram(_waveform(x)[:, 0]).transpose(1, 2)[:, None]  # (B, 1, F, T)
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.flatten(1), fmap


class _Multi(nn.Module):
    def forward(self, y, y_hat):
        scores_r, scores_g, fmaps_r, fmaps_g = [], [], [], []
        for d in self.discriminators:
            sr, fr = d(y)
            sg, fg = d(y_hat)
            scores_r.append(sr)
            fmaps_r.append(fr)
            scores_g.append(sg)
            fmaps_g.append(fg)
        return scores_r, scores_g, fmaps_r, fmaps_g


class MultiPeriodDiscriminator(_Multi):
    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11), channel_mult: float = 1.0):
        super().__init__()
        self.discriminators = nn.ModuleList([PeriodDiscriminator(p, channel_mult=channel_mult)
                                             for p in periods])


class MultiResolutionDiscriminator(_Multi):
    def __init__(self, resolutions: Sequence[Tuple[int, int, int]] = (
            (1024, 120, 600), (2048, 240, 1200), (512, 50, 240)), channel_mult: float = 1.0):
        super().__init__()
        self.discriminators = nn.ModuleList([ResolutionDiscriminator(r, channel_mult)
                                             for r in resolutions])


# -- GAN losses ---------------------------------------------------------------------------


def feature_loss(fmaps_r, fmaps_g):
    """2 * sum of mean |real - fake| over every feature map; the real maps
    are detached (the generator step's loss)."""
    loss = 0.0
    for fr, fg in zip(fmaps_r, fmaps_g):
        for rl, gl in zip(fr, fg):
            loss = loss + torch.mean(torch.abs(rl.detach() - gl))
    return loss * 2.0


def discriminator_loss(scores_r, scores_g):
    loss, r_losses, g_losses = 0.0, [], []
    for dr, dg in zip(scores_r, scores_g):
        r = torch.mean((1.0 - dr) ** 2)
        g = torch.mean(dg ** 2)
        loss = loss + r + g
        r_losses.append(r)
        g_losses.append(g)
    return loss, r_losses, g_losses


def generator_loss(scores_g):
    loss, per = 0.0, []
    for dg in scores_g:
        term = torch.mean((1.0 - dg) ** 2)
        per.append(term)
        loss = loss + term
    return loss, per


# -- reference state dicts ----------------------------------------------------------------


def _import(state_dict) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).float() for k, v in state_dict.items()
            if k.startswith("discriminators.")}


def import_mpd_weights(state_dict) -> Dict[str, torch.Tensor]:
    """A reference `MultiPeriodDiscriminator.state_dict()`
    (`discriminators.<i>.convs.<j>` / `.conv_post`, weight-normed) -> the
    port's state dict: the same names, fp32 tensors;
    `load_state_dict(..., strict=True)` checks the architecture."""
    return _import(state_dict)


def import_mrd_weights(state_dict) -> Dict[str, torch.Tensor]:
    """A reference `MultiResolutionDiscriminator.state_dict()` -> the port's
    state dict, as `import_mpd_weights`."""
    return _import(state_dict)

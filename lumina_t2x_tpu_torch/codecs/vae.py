"""SD / SDXL / SD3 VAE (AutoencoderKL), counterpart of
`lumina_t2x_tpu/codecs/vae.py`.

The CompVis KL-VAE: GroupNorm-32 / SiLU ResNet blocks, single-head
attention in the mid blocks, stride-2 downsampling after a (0, 1, 0, 1) pad,
nearest-2x upsampling; NCHW throughout. Parameter names are the diffusers
layout (`encoder.down_blocks.{i}.resnets.{j}.conv1`,
`decoder.up_blocks.{bi}.upsamplers.0.conv` with `bi` deepest first,
`*.mid_block.attentions.0.to_q`, `to_out.0`, `conv_norm_out`, ...), so a
diffusers state dict loads with `load_state_dict`; attention projections
stored as 1x1 conv weights load as well. `core/checkpoint.vae_state_dict_from_jax`
carries a JAX VAE's weights over.

Parameters are fp32; convolutions and projections compute in `dtype`, as
flax's `nn.Conv(dtype=...)` does, while GroupNorm and the attention scores
and softmax are fp32 islands. The attention is plain torch (two matmuls and
a softmax over h*w tokens at the bottleneck width), as the JAX package
computes it outside any kernel: at a 1024^2 decode its fp32 scores are
16384^2 (1 GiB) per sample.
"""

from __future__ import annotations

import math
import re
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..core.checkpoint import load_torch_state_dict

VAE_SCALE = {"ema": 0.18215, "mse": 0.18215, "sdxl": 0.13025, "sd3": 1.5305}
VAE_SHIFT = {"ema": 0.0, "mse": 0.0, "sdxl": 0.0, "sd3": 0.0609}


class DiagonalGaussian:
    """The VAE posterior: moments split in two along `dim` (mean, log
    variance), the log variance clipped to [-30, 20]."""

    def __init__(self, moments: torch.Tensor, dim: int = -1):
        self.mean, logvar = moments.chunk(2, dim=dim)
        self.logvar = logvar.clamp(-30.0, 20.0)
        self.std = torch.exp(0.5 * self.logvar)

    def sample(self, noise=None):
        """mean + std * noise; `noise` is a tensor of the mean's shape, or a
        `torch.Generator` (or None) to draw it from."""
        if not isinstance(noise, torch.Tensor):
            noise = torch.randn(self.mean.shape, generator=noise, device=self.mean.device,
                                dtype=self.mean.dtype)
        return self.mean + self.std * noise

    def mode(self):
        return self.mean

    def kl(self):
        return 0.5 * torch.sum(self.mean ** 2 + torch.exp(self.logvar) - 1.0 - self.logvar,
                               dim=tuple(range(1, self.mean.dim())))


class _Conv2d(nn.Conv2d):
    """nn.Conv2d computing in `dtype`: input and fp32 parameters are cast
    at use."""

    def __init__(self, cin, cout, kernel, stride=1, padding=0, dtype=torch.float32, device=None):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding, device=device)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt), self.stride, self.padding)


class _Linear(nn.Linear):
    """nn.Linear computing in `dtype`, as `_Conv2d`."""

    def __init__(self, cin, cout, dtype=torch.float32, device=None):
        super().__init__(cin, cout, device=device)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class _GroupNorm(nn.GroupNorm):
    """GroupNorm-32, eps 1e-6, always in fp32 (flax promotes to its fp32
    parameters): returns fp32 whatever the input dtype."""

    def __init__(self, channels, device=None):
        super().__init__(32, channels, eps=1e-6, device=device)

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias, self.eps)


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm1 = _GroupNorm(in_ch, device=device)
        self.conv1 = _Conv2d(in_ch, out_ch, 3, padding=1, **kw)
        self.norm2 = _GroupNorm(out_ch, device=device)
        self.conv2 = _Conv2d(out_ch, out_ch, 3, padding=1, **kw)
        self.conv_shortcut = _Conv2d(in_ch, out_ch, 1, **kw) if in_ch != out_ch else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over the h*w positions, scale 1/sqrt(c),
    fp32 scores and softmax."""

    def __init__(self, channels: int, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.group_norm = _GroupNorm(channels, device=device)
        self.to_q = _Linear(channels, channels, **kw)
        self.to_k = _Linear(channels, channels, **kw)
        self.to_v = _Linear(channels, channels, **kw)
        self.to_out = nn.ModuleList([_Linear(channels, channels, **kw)])

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # projections saved as (c, c, 1, 1) conv weights load as linear ones
        for name in ("to_q", "to_k", "to_v", "to_out.0"):
            key = f"{prefix}{name}.weight"
            if key in state_dict and state_dict[key].dim() == 4:
                state_dict[key] = state_dict[key][:, :, 0, 0]
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x):
        b, c, h, w = x.shape
        flat = self.group_norm(x).reshape(b, c, h * w).transpose(1, 2)
        q, k, v = self.to_q(flat), self.to_k(flat), self.to_v(flat)
        attn = torch.softmax(torch.matmul(q.float(), k.float().transpose(1, 2)).div_(math.sqrt(c)),
                             dim=-1)
        out = self.to_out[0](torch.matmul(attn.to(v.dtype), v))
        return x + out.transpose(1, 2).reshape(b, c, h, w)


class Downsample(nn.Module):
    """(0, 1, 0, 1) zero pad, then a stride-2 3x3 conv without padding."""

    def __init__(self, channels: int, dtype=torch.float32, device=None):
        super().__init__()
        self.conv = _Conv2d(channels, channels, 3, stride=2, dtype=dtype, device=device)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    """Nearest 2x, then a 3x3 conv."""

    def __init__(self, channels: int, dtype=torch.float32, device=None):
        super().__init__()
        self.conv = _Conv2d(channels, channels, 3, padding=1, dtype=dtype, device=device)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class _Block(nn.Module):
    """A resolution level: `resnets`, then an optional `downsamplers.0` or
    `upsamplers.0` (the diffusers containers)."""

    def __init__(self, in_ch, out_ch, n_resnets, resample=None, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.resnets = nn.ModuleList([ResnetBlock(in_ch if j == 0 else out_ch, out_ch, **kw)
                                      for j in range(n_resnets)])
        if resample is Downsample:
            self.downsamplers = nn.ModuleList([Downsample(out_ch, **kw)])
        elif resample is Upsample:
            self.upsamplers = nn.ModuleList([Upsample(out_ch, **kw)])

    def forward(self, x):
        for resnet in self.resnets:
            x = resnet(x)
        for resample in getattr(self, "downsamplers", getattr(self, "upsamplers", ())):
            x = resample(x)
        return x


class _MidBlock(nn.Module):
    def __init__(self, channels, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.resnets = nn.ModuleList([ResnetBlock(channels, channels, **kw) for _ in range(2)])
        self.attentions = nn.ModuleList([AttnBlock(channels, **kw)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class Encoder(nn.Module):
    """Image (B, in_channels, H, W) -> moments (B, 2 z_channels, H/f, W/f),
    f = 2^(len(ch_mult) - 1)."""

    def __init__(self, ch=128, ch_mult: Sequence[int] = (1, 2, 4, 4), num_res_blocks=2,
                 z_channels=4, in_channels=3, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.conv_in = _Conv2d(in_channels, ch, 3, padding=1, **kw)
        blocks, prev = [], ch
        for i, mult in enumerate(ch_mult):
            resample = Downsample if i != len(ch_mult) - 1 else None
            blocks.append(_Block(prev, ch * mult, num_res_blocks, resample, **kw))
            prev = ch * mult
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = _MidBlock(prev, **kw)
        self.conv_norm_out = _GroupNorm(prev, device=device)
        self.conv_out = _Conv2d(prev, 2 * z_channels, 3, padding=1, **kw)

    def forward(self, x):
        h = self.conv_in(x)
        for block in self.down_blocks:
            h = block(h)
        return self.conv_out(F.silu(self.conv_norm_out(self.mid_block(h))))


class Decoder(nn.Module):
    """Latent (B, z_channels, h, w) -> image (B, out_channels, h f, w f);
    `up_blocks` run deepest first."""

    def __init__(self, ch=128, ch_mult: Sequence[int] = (1, 2, 4, 4), num_res_blocks=2,
                 z_channels=4, out_channels=3, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        top = ch * ch_mult[-1]
        self.conv_in = _Conv2d(z_channels, top, 3, padding=1, **kw)
        self.mid_block = _MidBlock(top, **kw)
        blocks, prev = [], top
        for i in reversed(range(len(ch_mult))):
            blocks.append(_Block(prev, ch * ch_mult[i], num_res_blocks + 1,
                                 Upsample if i != 0 else None, **kw))
            prev = ch * ch_mult[i]
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = _GroupNorm(prev, device=device)
        self.conv_out = _Conv2d(prev, out_channels, 3, padding=1, **kw)

    def forward(self, z):
        h = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            h = block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    """KL-VAE, NCHW in and out. SD/SDXL VAEs wrap the latents in 1x1
    `quant_conv` / `post_quant_conv`; SD3's (z_channels=16) has neither
    (`use_quant_conv=False`)."""

    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, z_channels: int = 4, out_channels: int = 3,
                 use_quant_conv: bool = True, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.z_channels = z_channels
        self.use_quant_conv = use_quant_conv
        self.encoder = Encoder(ch, ch_mult, num_res_blocks, z_channels, out_channels, **kw)
        self.decoder = Decoder(ch, ch_mult, num_res_blocks, z_channels, out_channels, **kw)
        if use_quant_conv:
            self.quant_conv = _Conv2d(2 * z_channels, 2 * z_channels, 1, **kw)
            self.post_quant_conv = _Conv2d(z_channels, z_channels, 1, **kw)

    def encode_moments(self, x):
        """x: (B, 3, H, W) in [-1, 1] -> moments (B, 2z, H/f, W/f)."""
        h = self.encoder(x)
        return self.quant_conv(h) if self.use_quant_conv else h

    def decode(self, z):
        """z: (B, z, h, w) -> (B, 3, H, W), in `dtype`."""
        return self.decoder(self.post_quant_conv(z) if self.use_quant_conv else z)


def encode_to_latent(vae: AutoencoderKL, x, noise=None, vae_type: str = "ema"):
    """Sampled, scaled latent, as in training: `noise` is the posterior's
    standard-normal draw (a tensor), or a `torch.Generator` to draw it from."""
    return latent_from_moments(vae.encode_moments(x), noise, vae_type)


def latent_from_moments(moments, noise=None, vae_type: str = "ema"):
    """`encode_to_latent` from the encoder's moments (B, 2z, h, w)."""
    z = DiagonalGaussian(moments, dim=1).sample(noise)
    return (z - VAE_SHIFT[vae_type]) * VAE_SCALE[vae_type]


def decode_from_latent(vae: AutoencoderKL, z, vae_type: str = "ema"):
    """Inverse scaling + decode."""
    return vae.decode(z / VAE_SCALE[vae_type] + VAE_SHIFT[vae_type])


def pooled_latent_standin(pixels: torch.Tensor, channels: int = 4) -> torch.Tensor:
    """The latent stand-in without a VAE: (B, 3, H, W) pixels average-pooled
    by 8, the pixel channels tiled to `channels` latent channels."""
    b, c, h, w = pixels.shape
    pooled = pixels.reshape(b, c, h // 8, 8, w // 8, 8).mean(dim=(3, 5))
    return pooled.repeat(1, -(-channels // c), 1, 1)[:, :channels]


def _levels(state_dict, pattern):
    """1 + the largest index `pattern`'s group takes over the keys."""
    return 1 + max(int(m.group(1)) for m in map(re.compile(pattern).match, state_dict) if m)


def architecture(state_dict) -> dict:
    """AutoencoderKL's arguments, read off a diffusers-layout state dict's
    names and shapes."""
    ch = state_dict["encoder.conv_in.weight"].shape[0]
    levels = _levels(state_dict, r"encoder\.down_blocks\.(\d+)\.")
    return dict(
        ch=ch,
        ch_mult=tuple(state_dict[f"encoder.down_blocks.{i}.resnets.0.conv1.weight"].shape[0] // ch
                      for i in range(levels)),
        num_res_blocks=_levels(state_dict, r"encoder\.down_blocks\.0\.resnets\.(\d+)\."),
        z_channels=state_dict["decoder.conv_in.weight"].shape[1],
        out_channels=state_dict["decoder.conv_out.weight"].shape[0],
        use_quant_conv="quant_conv.weight" in state_dict,
    )


def load_vae(vae_ckpt: str, device=None, dtype=torch.float32) -> AutoencoderKL:
    """An AutoencoderKL holding a diffusers-format checkpoint (`.safetensors`
    or `.pth`), in eval mode on `device`, computing in `dtype`. Its
    architecture is read off the checkpoint (`architecture`: SD/SDXL's z=4
    with quant convs, SD3's z=16 without); every parameter must load."""
    state_dict = load_torch_state_dict(vae_ckpt)
    vae = AutoencoderKL(**architecture(state_dict), dtype=dtype, device=device)
    vae.load_state_dict(state_dict, strict=True)
    return vae.eval()


def load_or_init_vae(vae_ckpt: Optional[str], device=None, dtype=torch.float32) -> AutoencoderKL:
    """`load_vae(vae_ckpt)`, or without a file the default SD-VAE with
    weights from seed 0, built on the CPU so that they are the same on every
    device (the JAX pipelines' smoke mode)."""
    if vae_ckpt:
        return load_vae(vae_ckpt, device=device, dtype=dtype)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return AutoencoderKL(dtype=dtype).to(device).eval()

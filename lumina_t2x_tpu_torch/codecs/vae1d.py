"""The 1-D mel-spectrogram VAE of audio and music (counterpart of
`lumina_t2x_tpu/codecs/vae1d.py`, the Make-An-Audio-2 KL autoencoder): the
80 mel bins are channels over time, (B, mel, T) <-> (B, embed, T / rate).

- ResnetBlock1D: GroupNorm-32 (eps 1e-6) / SiLU / Conv1d(k, pad k//2) twice,
  a 1x1 shortcut where the width changes;
- AttnBlock1D: single-head attention over time at the bottleneck;
- Downsample1D: (0, 1) pad then a stride-2 conv; Upsample1D: nearest 2x then
  a conv;
- double_z moments and the quant / post-quant 1x1 convs; a VQ variant.

Plain torch in (B, C, T), cuDNN's convolutions on the card (the JAX package
runs `lax.conv` here, outside any Pallas kernel). Module names are the
reference's CompVis keys (`encoder.down.<i>.block.<j>`, `mid.block_1`,
`decoder.up.<i>.upsample` ...), so a reference state dict loads as it is
(`import_autoencoder_kl_1d_weights` strips the LDM prefix) and
`core/checkpoint.vae1d_state_dict_from_jax` carries a JAX tree across. The
decoder's resnets keep the reference's kernel size 3 whatever the
configured size, which only its conv_in / conv_out take.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .vae import DiagonalGaussian


def _norm(ch: int) -> nn.GroupNorm:
    return nn.GroupNorm(32, ch, eps=1e-6)


class ResnetBlock1D(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3):
        super().__init__()
        k = kernel_size
        self.norm1 = _norm(in_ch)
        self.conv1 = nn.Conv1d(in_ch, out_ch, k, padding=k // 2)
        self.norm2 = _norm(out_ch)
        self.conv2 = nn.Conv1d(out_ch, out_ch, k, padding=k // 2)
        if in_ch != out_ch:
            self.nin_shortcut = nn.Conv1d(in_ch, out_ch, 1)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock1D(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.norm = _norm(ch)
        self.q, self.k, self.v, self.proj_out = (nn.Conv1d(ch, ch, 1) for _ in range(4))

    def forward(self, x):
        h = self.norm(x)
        q, k, v = self.q(h), self.k(h), self.v(h)
        logits = torch.einsum("bct,bcs->bts", q.float(), k.float()) / math.sqrt(x.shape[1])
        out = torch.einsum("bts,bcs->bct", torch.softmax(logits, dim=-1).to(v.dtype), v)
        return x + self.proj_out(out)


class Downsample1D(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv1d(ch, ch, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1)))


class Upsample1D(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv1d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(torch.repeat_interleave(x, 2, dim=-1))


class _Level(nn.Module):
    """One resolution level: `block` (resnets), `attn` (empty where the
    level has none) and an optional `downsample` / `upsample`."""

    def __init__(self, blocks, attns, resample_name: Optional[str] = None, resample=None):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        self.attn = nn.ModuleList(attns)
        if resample_name:
            setattr(self, resample_name, resample)

    def forward(self, h):
        for i, block in enumerate(self.block):
            h = block(h)
            if len(self.attn):
                h = self.attn[i](h)
        for name in ("downsample", "upsample"):
            if hasattr(self, name):
                h = getattr(self, name)(h)
        return h


class _Mid(nn.Module):
    def __init__(self, ch: int, kernel_size: int, use_attn: bool):
        super().__init__()
        self.block_1 = ResnetBlock1D(ch, ch, kernel_size)
        if use_attn:
            self.attn_1 = AttnBlock1D(ch)
        self.block_2 = ResnetBlock1D(ch, ch, kernel_size)

    def forward(self, h):
        h = self.block_1(h)
        if hasattr(self, "attn_1"):
            h = self.attn_1(h)
        return self.block_2(h)


def _down_levels(ch_mult, down_layers):
    return (tuple(range(len(ch_mult) - 1)) if down_layers is None else tuple(down_layers))


class Encoder1D(nn.Module):
    """(B, in_channels, T) -> (B, [2 *] z_channels, t). `down_layers` lists
    the levels that downsample (None: every level but the last);
    `attn_layers` the levels with an AttnBlock1D after each resnet. The
    bottleneck's attention is unconditional, as in the reference."""

    def __init__(self, in_channels: int = 80, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4),
                 num_res_blocks: int = 2, z_channels: int = 20, double_z: bool = True,
                 use_mid_attn: bool = True, attn_layers: Sequence[int] = (),
                 down_layers: Optional[Sequence[int]] = None, kernel_size: int = 3):
        super().__init__()
        ks = kernel_size
        downs = _down_levels(ch_mult, down_layers)
        self.conv_in = nn.Conv1d(in_channels, ch, ks, padding=ks // 2)
        levels, block_in = [], ch
        for i, mult in enumerate(ch_mult):
            blocks, attns = [], []
            for _ in range(num_res_blocks):
                blocks.append(ResnetBlock1D(block_in, ch * mult, ks))
                block_in = ch * mult
                if i in attn_layers:
                    attns.append(AttnBlock1D(block_in))
            levels.append(_Level(blocks, attns, "downsample" if i in downs else None,
                                 Downsample1D(block_in) if i in downs else None))
        self.down = nn.ModuleList(levels)
        self.mid = _Mid(block_in, ks, use_mid_attn)
        self.norm_out = _norm(block_in)
        self.conv_out = nn.Conv1d(block_in, 2 * z_channels if double_z else z_channels, ks,
                                  padding=ks // 2)

    def forward(self, x):
        h = self.conv_in(x)
        for level in self.down:
            h = level(h)
        h = self.mid(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class Decoder1D(nn.Module):
    """(B, z_channels, t) -> (B, out_channels, T): upsamples at the levels
    after each of `down_layers`. Its resnets use kernel size 3 (the
    reference's quirk); conv_in and conv_out the configured one."""

    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4),
                 num_res_blocks: int = 2, out_channels: int = 80, z_channels: int = 20,
                 use_mid_attn: bool = True, attn_layers: Sequence[int] = (),
                 down_layers: Optional[Sequence[int]] = None, kernel_size: int = 3):
        super().__init__()
        ks = kernel_size
        ups = {d + 1 for d in _down_levels(ch_mult, down_layers)}
        block_in = ch * ch_mult[-1]
        self.conv_in = nn.Conv1d(z_channels, block_in, ks, padding=ks // 2)
        self.mid = _Mid(block_in, 3, use_mid_attn)
        levels = [None] * len(ch_mult)
        for i, mult in reversed(list(enumerate(ch_mult))):
            blocks, attns = [], []
            for _ in range(num_res_blocks + 1):
                blocks.append(ResnetBlock1D(block_in, ch * mult))
                block_in = ch * mult
                if i in attn_layers:
                    attns.append(AttnBlock1D(block_in))
            levels[i] = _Level(blocks, attns, "upsample" if i in ups else None,
                               Upsample1D(block_in) if i in ups else None)
        self.up = nn.ModuleList(levels)  # indexed by level, run deepest first
        self.norm_out = _norm(block_in)
        self.conv_out = nn.Conv1d(block_in, out_channels, ks, padding=ks // 2)

    def forward(self, z):
        h = self.mid(self.conv_in(z))
        for level in reversed(self.up):
            h = level(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class VectorQuantizer(nn.Module):
    """Nearest-codebook lookup with straight-through gradients and the
    commitment loss; the codebook starts U(-1/n, 1/n)."""

    def __init__(self, n_embed: int = 1024, embed_dim: int = 20, beta: float = 0.25):
        super().__init__()
        self.beta = beta
        self.embedding = nn.Embedding(n_embed, embed_dim)
        nn.init.uniform_(self.embedding.weight, -1.0 / n_embed, 1.0 / n_embed)

    def forward(self, z):
        """z (B, T, embed_dim) -> (z_q, indices (B, T), vq_loss)."""
        codebook = self.embedding.weight.float()
        zf = z.float()
        d = ((zf ** 2).sum(-1, keepdim=True) - 2.0 * zf @ codebook.T
             + (codebook ** 2).sum(-1)[None, None, :])
        idx = d.argmin(dim=-1)
        z_q = codebook[idx]
        loss = (torch.mean((z_q.detach() - zf) ** 2) * self.beta
                + torch.mean((z_q - zf.detach()) ** 2))
        z_q = zf + (z_q - zf).detach()
        return z_q.to(z.dtype), idx, loss


class VQModel1D(nn.Module):
    def __init__(self, mel_bins: int = 80, embed_dim: int = 20, n_embed: int = 1024,
                 ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4), num_res_blocks: int = 2,
                 z_channels: int = 20):
        super().__init__()
        self.encoder = Encoder1D(mel_bins, ch, ch_mult, num_res_blocks, z_channels, False)
        self.decoder = Decoder1D(ch, ch_mult, num_res_blocks, mel_bins, z_channels)
        self.quant_conv = nn.Conv1d(z_channels, embed_dim, 1)
        self.post_quant_conv = nn.Conv1d(embed_dim, z_channels, 1)
        self.quantize = VectorQuantizer(n_embed, embed_dim)

    def encode(self, x):
        """(B, mel, T) -> (z_q (B, embed, t), indices (B, t), vq_loss)."""
        h = self.quant_conv(self.encoder(x))
        z_q, idx, loss = self.quantize(h.transpose(1, 2))
        return z_q.transpose(1, 2), idx, loss

    def decode(self, z_q):
        return self.decoder(self.post_quant_conv(z_q))

    def forward(self, x):
        z_q, idx, loss = self.encode(x)
        return self.decode(z_q), idx, loss


class AutoencoderKL1D(nn.Module):
    """(B, mel_bins, T) <-> (B, embed_dim, T / 2^len(down levels))."""

    def __init__(self, mel_bins: int = 80, embed_dim: int = 20, ch: int = 128,
                 ch_mult: Sequence[int] = (1, 2, 4), num_res_blocks: int = 2,
                 z_channels: int = 20, attn_layers: Sequence[int] = (),
                 down_layers: Optional[Sequence[int]] = None, kernel_size: int = 3):
        super().__init__()
        arch = dict(attn_layers=attn_layers, down_layers=down_layers, kernel_size=kernel_size)
        self.encoder = Encoder1D(mel_bins, ch, ch_mult, num_res_blocks, z_channels, True, **arch)
        self.decoder = Decoder1D(ch, ch_mult, num_res_blocks, mel_bins, z_channels, **arch)
        self.quant_conv = nn.Conv1d(2 * z_channels, 2 * embed_dim, 1)
        self.post_quant_conv = nn.Conv1d(embed_dim, z_channels, 1)

    def encode_moments(self, x):
        """(B, mel, T) -> (B, 2 * embed, t)."""
        return self.quant_conv(self.encoder(x))

    def decode(self, z):
        """(B, embed, t) -> (B, mel, T)."""
        return self.decoder(self.post_quant_conv(z))

    def forward(self, x, noise=None):
        """Decode a posterior sample: `noise` is a tensor of the latent's
        shape or a generator (`DiagonalGaussian.sample`)."""
        posterior = DiagonalGaussian(self.encode_moments(x), dim=1)
        return self.decode(posterior.sample(noise)), posterior


_LDM_PREFIX = "first_stage_model."
_VAE1D_KEYS = re.compile(r"(encoder|decoder|quant_conv|post_quant_conv|quantize)\.")


def import_autoencoder_kl_1d_weights(state_dict: Dict) -> Dict[str, torch.Tensor]:
    """A reference / Make-An-Audio-2 1-D `AutoencoderKL` state dict (CompVis
    names), bare or inside an LDM checkpoint (the `first_stage_model.`
    prefix is stripped), -> the state dict of the port's `AutoencoderKL1D`:
    the names are the same, so this keeps the autoencoder's entries (not the
    loss's) as fp32 tensors; `load_state_dict(..., strict=True)` checks the
    architecture."""
    if any(k.startswith(_LDM_PREFIX) for k in state_dict):
        state_dict = {k[len(_LDM_PREFIX):]: v for k, v in state_dict.items()
                      if k.startswith(_LDM_PREFIX)}
    return {k: torch.as_tensor(v).float() for k, v in state_dict.items()
            if _VAE1D_KEYS.match(k)}


def import_vq_model_1d_weights(state_dict: Dict) -> Dict[str, torch.Tensor]:
    """A 1-D `VQModel` state dict (CompVis encoder / decoder names plus the
    `quantize.embedding.weight` codebook) -> the port's `VQModel1D` state
    dict, as `import_autoencoder_kl_1d_weights` does."""
    return import_autoencoder_kl_1d_weights(state_dict)


def make_an_audio_2_vae(**overrides) -> AutoencoderKL1D:
    """The shipped Make-An-Audio-2 mel VAE (`lumina-text2music.yaml:43-65`):
    80 mel bins, ch 384, ch_mult (1, 2, 4), kernel 5, downsampling only at
    level 0 (rate 2), no per-level attention, z 20 with double_z."""
    cfg = dict(mel_bins=80, embed_dim=20, ch=384, ch_mult=(1, 2, 4), num_res_blocks=2,
               z_channels=20, attn_layers=(), down_layers=(0,), kernel_size=5)
    cfg.update(overrides)
    return AutoencoderKL1D(**cfg)

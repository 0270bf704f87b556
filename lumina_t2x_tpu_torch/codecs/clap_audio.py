"""The CLAP audio tower (Cnn14): waveform -> joint-embedding audio features
(counterpart of `lumina_t2x_tpu/codecs/clap_audio.py`), the judge of
generated audio against its prompt together with the caption tower
(`text_encoders.CLAPTextEncoder`).

- Log-mel front end with torchlibrosa's semantics: periodic Hann window,
  center=True with reflect padding, power 2, a Slaney-normalised mel
  filterbank (librosa's htk=False, norm='slaney'), 10 log10(max(mel, 1e-10)).
  The frames are cut by `unfold` and transformed by `torch.fft.rfft`.
- Cnn14 in eval mode over an explicit parameter dict (batch norms folded to
  scale / shift at import; conv weights OIHW; linear weights (out, in)):
  6 conv blocks, mean over mel, max + mean over time, fc1, a sigmoid head.
- `resample_waveform`: the rational kaiser-sinc resampler of the JAX
  package (a `lax.conv` with input dilation p and stride q), computed
  polyphase: each output sample sums only the ~2 * zeros taps that meet
  input samples, instead of convolving the p-times zero-stuffed signal.

No torchaudio; plain torch (cuDNN's convolutions) on the card.
`core/checkpoint.clap_audio_params_from_jax` carries a JAX parameter dict
across.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .text_encoders import clap_projection

# -- mel front end -----------------------------------------------------------------------


def _hz_to_mel(f):
    """librosa's htk=False (Slaney) scale: linear below 1 kHz, log above."""
    f = np.asarray(f, np.float64)
    mel = f / (200.0 / 3.0)
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / (200.0 / 3.0)
    logstep = math.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-12) / min_log_hz) / logstep, mel)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    f = m * (200.0 / 3.0)
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / (200.0 / 3.0)
    logstep = math.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), f)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float,
                   fmax: Optional[float] = None) -> np.ndarray:
    """(n_freq, n_mels) Slaney-normalised triangular filterbank: the
    transpose of librosa.filters.mel, laid out for a right matmul."""
    fmax = sr / 2.0 if fmax is None else fmax
    fftfreqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    mel_pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2:] - mel_pts[:-2])
    return (weights * enorm[:, None]).T.astype(np.float32)


def hann_window(n: int) -> np.ndarray:
    """Periodic (fftbins=True) Hann window, torch.hann_window's default."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float32)


def stft_power(x: torch.Tensor, n_fft: int, hop: int,
               window: Optional[torch.Tensor] = None) -> torch.Tensor:
    """|STFT|^2 with center=True and reflect padding: (B, L) ->
    (B, L // hop + 1, n_fft // 2 + 1), fp32."""
    if window is None:
        window = torch.from_numpy(hann_window(n_fft)).to(x.device)
    pad = n_fft // 2
    xp = F.pad(x.float()[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = xp.unfold(-1, n_fft, hop) * window  # (B, T, n_fft)
    return torch.fft.rfft(frames, dim=-1).abs() ** 2


def logmel(x: torch.Tensor, sr: int = 44100, n_fft: int = 1024, hop: int = 320,
           n_mels: int = 64, fmin: float = 50.0, fmax: float = 14000.0,
           amin: float = 1e-10) -> torch.Tensor:
    """(B, L) waveform -> (B, T, n_mels) log-mel, 10 log10(max(mel, amin))
    (torchlibrosa's power_to_db with ref 1 and no top_db)."""
    power = stft_power(x, n_fft, hop)
    fb = torch.from_numpy(mel_filterbank(sr, n_fft, n_mels, fmin, fmax)).to(x.device)
    return 10.0 * torch.log10(torch.clamp(power @ fb, min=amin))


# -- Cnn14 (eval mode) over an explicit parameter dict -------------------------------------


def _affine(x, p):
    """A folded eval-mode batch norm over the channel axis of NCHW."""
    return x * p["scale"][None, :, None, None] + p["shift"][None, :, None, None]


def cnn14_embedding(params: Dict, mel_db: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T, n_mels) log-mel -> (embedding (B, out_emb), clipwise (B, classes)):
    bn0 per mel bin, 6 conv blocks (3x3 conv-bn-relu twice, then a 2x2 mean
    pool except after the sixth), mean over mel, max + mean over time,
    fc1 + relu, a sigmoid head. Dropout is the identity in eval mode."""
    x = mel_db[:, None] * params["bn0"]["scale"] + params["bn0"]["shift"]  # (B, 1, T, mel)
    for i in range(1, 7):
        blk = params[f"conv_block{i}"]
        x = F.relu(_affine(F.conv2d(x, blk["conv1"], padding=1), blk["bn1"]))
        x = F.relu(_affine(F.conv2d(x, blk["conv2"], padding=1), blk["bn2"]))
        if i < 6:
            x = F.avg_pool2d(x, 2)
    x = x.mean(dim=3)  # over mel -> (B, C, T')
    x = x.amax(dim=2) + x.mean(dim=2)  # over time -> (B, C)
    x = F.relu(F.linear(x, params["fc1"]["weight"], params["fc1"]["bias"]))
    clipwise = torch.sigmoid(F.linear(x, params["fc_audioset"]["weight"],
                                      params["fc_audioset"]["bias"]))
    return x, clipwise


def clap_audio_embed(params: Dict, waveform: torch.Tensor, sr: int = 44100) -> torch.Tensor:
    """(B, L) waveform at `sr` -> L2-normalised CLAP audio embedding (B, d_proj)."""
    fe = params["frontend"]
    mel = logmel(waveform, sr=sr, n_fft=fe["n_fft"], hop=fe["hop"], n_mels=fe["n_mels"],
                 fmin=fe["fmin"], fmax=fe["fmax"])
    emb, _ = cnn14_embedding(params["cnn14"], mel)
    proj = clap_projection(emb, params["projection"])
    return proj / proj.norm(dim=-1, keepdim=True)


def clap_similarity(text_emb, audio_emb, logit_scale: float = 1.0 / 0.07):
    """(n_audio, n_text) similarity logits: scale * (text @ audio^T)^T, both
    L2-normalised (`CLAPWrapper.compute_similarity`)."""
    return (logit_scale * text_emb @ audio_emb.T).T


def clap_score(text_emb, audio_emb):
    """Per-pair CLAP score: the cosine of matched rows, no logit scale."""
    return (text_emb * audio_emb).sum(dim=-1)


# -- preprocessing ------------------------------------------------------------------------


def tile_or_crop(wave: np.ndarray, duration_samples: int,
                 start: Optional[int] = None) -> np.ndarray:
    """Repeat a short clip or crop a long one to exactly `duration_samples`
    (`start=None`: the reference's random crop; an int for determinism)."""
    wave = np.asarray(wave).reshape(-1)
    if duration_samples >= wave.shape[0]:
        reps = int(np.ceil(duration_samples / wave.shape[0]))
        return np.tile(wave, reps)[:duration_samples]
    lo = np.random.randint(0, wave.shape[0] - duration_samples) if start is None else start
    return wave[lo:lo + duration_samples]


def resample_waveform(x, sr_in: int, sr_out: int, zeros: int = 24,
                      chunk: int = 65536) -> torch.Tensor:
    """Rational kaiser-sinc resampling (B, L) -> (B, (L - 1) p // q + 1), with
    p / q = sr_out / sr_in in lowest terms: the taps
    `vocoder.kaiser_sinc_filter1d(0.5 / m, 0.6 / m, 2 zeros m + 1) * p`
    (m = max(p, q)) over the p-times zero-stuffed input, zero-padded by
    zeros m on each side, read at stride q. Output m draws on the taps
    j = j0 + k p that meet a stuffed input sample, j0 = (width - m q) mod p,
    so it is computed as a gather of those taps and input samples, `chunk`
    outputs at a time."""
    x = torch.as_tensor(x, dtype=torch.float32)
    if sr_in == sr_out:
        return x
    from .vocoder import kaiser_sinc_filter1d

    g = math.gcd(sr_in, sr_out)
    p, q = sr_out // g, sr_in // g
    m_max = max(p, q)
    width = zeros * m_max
    n_taps = 2 * width + 1
    fir = torch.from_numpy(kaiser_sinc_filter1d(0.5 / m_max, 0.6 / m_max, n_taps)
                           .reshape(-1) * p).to(x.device)
    length = x.shape[-1]
    n_out = (length - 1) * p // q + 1
    per_out = -(-n_taps // p)  # taps that can meet an input sample
    k = torch.arange(per_out, device=x.device)
    outs = []
    for lo in range(0, n_out, chunk):
        m = torch.arange(lo, min(lo + chunk, n_out), device=x.device)
        u = m * q - width
        j0 = torch.remainder(-u, p)
        j = j0[:, None] + k * p  # (M, per_out) tap indices
        n = torch.div(u + j0, p, rounding_mode="floor")[:, None] + k  # input indices
        valid = (j < n_taps) & (n >= 0) & (n < length)
        taps = torch.where(valid, fir[j.clamp(max=n_taps - 1)], 0.0)
        outs.append((x[:, n.clamp(0, length - 1)] * taps).sum(-1))
    return torch.cat(outs, dim=-1)


# -- weight import ------------------------------------------------------------------------


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32) if not isinstance(a, torch.Tensor)
                           else a).float()


def _fold_bn(sd, prefix: str, eps: float = 1e-5) -> Dict[str, torch.Tensor]:
    """An eval-mode BatchNorm as scale / shift:
    (x - rm) / sqrt(rv + eps) * g + b == x * scale + shift."""
    g, b = _t(sd[f"{prefix}.weight"]), _t(sd[f"{prefix}.bias"])
    rm, rv = _t(sd[f"{prefix}.running_mean"]), _t(sd[f"{prefix}.running_var"])
    scale = g / torch.sqrt(rv + eps)
    return {"scale": scale, "shift": b - rm * scale}


def import_clap_audio_weights(state_dict, *, sample_rate: int = 44100, window_size: int = 1024,
                              hop_size: int = 320, mel_bins: int = 64, fmin: float = 50.0,
                              fmax: float = 14000.0) -> Dict:
    """A CLAP checkpoint's audio branch (`audio_encoder.base.*` Cnn14 and
    `audio_encoder.projection.*`) -> the parameter dict of
    `clap_audio_embed`: batch norms folded, conv and linear weights in
    torch's layouts, the front-end geometry and exp(logit_scale)."""
    base = "audio_encoder.base"
    cnn: Dict = {"bn0": _fold_bn(state_dict, f"{base}.bn0")}
    for i in range(1, 7):
        blk = f"{base}.conv_block{i}"
        cnn[f"conv_block{i}"] = {"conv1": _t(state_dict[f"{blk}.conv1.weight"]),
                                 "conv2": _t(state_dict[f"{blk}.conv2.weight"]),
                                 "bn1": _fold_bn(state_dict, f"{blk}.bn1"),
                                 "bn2": _fold_bn(state_dict, f"{blk}.bn2")}
    for fc in ("fc1", "fc_audioset"):
        cnn[fc] = {"weight": _t(state_dict[f"{base}.{fc}.weight"]),
                   "bias": _t(state_dict[f"{base}.{fc}.bias"])}
    proj = {name: {"weight": _t(state_dict[f"audio_encoder.projection.{name}.weight"])}
            for name in ("linear1", "linear2")}
    proj["layer_norm"] = {"weight": _t(state_dict["audio_encoder.projection.layer_norm.weight"]),
                          "bias": _t(state_dict["audio_encoder.projection.layer_norm.bias"])}
    params = {"cnn14": cnn, "projection": proj,
              "frontend": {"n_fft": window_size, "hop": hop_size, "n_mels": mel_bins,
                           "fmin": fmin, "fmax": fmax, "sample_rate": sample_rate}}
    if "logit_scale" in state_dict:
        params["logit_scale"] = float(np.exp(_t(state_dict["logit_scale"]).numpy()))
    return params


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


class CLAPAudioEncoder:
    """Waveform-side CLAP scorer, paired with `CLAPTextEncoder`:

        enc = CLAPAudioEncoder.from_clap_checkpoint("CLAP_weights_2022.pth")
        a = enc.embed(waveform, sr=16000)      # resamples, tiles to 5 s
        score = clap_score(text_embeddings, a)
    """

    def __init__(self, params: Dict, duration: float = 5.0, device="cuda"):
        self.params = _to_device(params, torch.device(device))
        self.duration = duration
        self.device = torch.device(device)

    @classmethod
    def from_clap_checkpoint(cls, ckpt_path: str, device="cuda", **geometry):
        sd = torch.load(ckpt_path, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "model" in sd:
            sd = sd["model"]
        return cls(import_clap_audio_weights(sd, **geometry), device=device)

    @torch.no_grad()
    def embed(self, waveform, sr: int, start: Optional[int] = 0) -> torch.Tensor:
        """(B, L) or (L,) waveform at `sr` -> (B, d_proj) normalised
        embeddings on the encoder's device: resampled to the tower's rate,
        tiled or cropped to the clip duration (`start=None`: a random crop)."""
        wave = torch.as_tensor(np.atleast_2d(np.asarray(waveform, np.float32)))
        target_sr = self.params["frontend"]["sample_rate"]
        if sr != target_sr:
            wave = resample_waveform(wave.to(self.device), sr, target_sr).cpu()
        n = int(self.duration * target_sr)
        wave = np.stack([tile_or_crop(w, n, start=start) for w in wave.numpy()])
        return clap_audio_embed(self.params, torch.from_numpy(wave).to(self.device),
                                sr=target_sr)

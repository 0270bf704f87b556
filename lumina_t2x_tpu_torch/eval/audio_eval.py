"""CLAP-score evaluation of generated audio against its prompts (counterpart
of `lumina_t2x_tpu/eval/audio_eval.py`): the cosine between the CLAP text
embedding of each prompt and the CLAP audio embedding of its clip, the
conventional "CLAP score" (`CLAPWrapper.compute_similarity` without the
logit scale).

    from lumina_t2x_tpu_torch.codecs.clap_audio import CLAPAudioEncoder
    from lumina_t2x_tpu_torch.codecs.text_encoders import CLAPTextEncoder
    audio_enc = CLAPAudioEncoder.from_clap_checkpoint("CLAP_weights_2022.pth")
    text_enc = CLAPTextEncoder.from_clap_checkpoint(
        "CLAP_weights_2022.pth", BertModel(config).cuda(), tokenizer)
    report = clap_eval_directory(text_enc, audio_enc, "outputs/", "prompts.txt")
"""

from __future__ import annotations

import json
import os
import re
import wave
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def _natural_key(name: str):
    """Sort key comparing digit runs as numbers: 2.wav < 10.wav."""
    return [int(p) if p.isdigit() else p for p in re.split(r"(\d+)", name)]


def _numpy(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """A PCM WAV file as a mono float32 waveform in [-1, 1] and its sample
    rate (the inverse of `pipelines.audio_app.save_wav`): channels averaged;
    16- and 32-bit signed and 8-bit unsigned samples."""
    with wave.open(path, "rb") as f:
        n_ch, sampwidth, sr = f.getnchannels(), f.getsampwidth(), f.getframerate()
        raw = f.readframes(f.getnframes())
    if sampwidth == 2:
        x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif sampwidth == 4:
        x = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif sampwidth == 1:
        x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width {sampwidth} in {path}")
    if n_ch > 1:
        x = x.reshape(-1, n_ch).mean(axis=1)
    return x, sr


def clap_scores(text_encoder, audio_encoder, wav_paths: Sequence[str],
                prompts: Sequence[str], batch_size: int = 8) -> np.ndarray:
    """CLAP score of wav_paths[i] against prompts[i]. Clips of one sample
    rate and length embed as one batch; the deterministic crop keeps the
    metric reproducible."""
    if len(wav_paths) != len(prompts):
        raise ValueError(f"{len(wav_paths)} wavs vs {len(prompts)} prompts")
    scores: List[np.ndarray] = []
    for lo in range(0, len(wav_paths), batch_size):
        text_emb = _numpy(text_encoder.embed(list(prompts[lo:lo + batch_size])))
        waves = [read_wav(p) for p in wav_paths[lo:lo + batch_size]]
        audio_emb = np.empty((len(waves), text_emb.shape[-1]), np.float32)
        groups: Dict[Tuple[int, int], List[int]] = {}
        for i, (w, sr) in enumerate(waves):
            groups.setdefault((sr, w.shape[0]), []).append(i)
        for (sr, _), idxs in groups.items():
            emb = _numpy(audio_encoder.embed(np.stack([waves[i][0] for i in idxs]), sr=sr))
            audio_emb[idxs] = emb
        scores.append(np.sum(text_emb * audio_emb, axis=-1))
    return np.concatenate(scores) if scores else np.zeros((0,), np.float32)


def clap_eval_directory(text_encoder, audio_encoder, wav_dir: str,
                        prompts: "str | Sequence[str]", batch_size: int = 8) -> Dict:
    """Score every .wav in `wav_dir` against its prompt: `prompts` is a list
    (one per wav, in natural filename order: 2.wav before 10.wav) or a text
    file of one prompt per line. Returns {"mean_clap_score", "n",
    "per_file": {name: score}}."""
    wavs = sorted((f for f in os.listdir(wav_dir) if f.lower().endswith(".wav")),
                  key=_natural_key)
    if isinstance(prompts, str):
        with open(prompts) as f:
            prompts = [line.rstrip("\n") for line in f if line.strip()]
    if len(wavs) != len(prompts):
        raise ValueError(f"{len(wavs)} wavs in {wav_dir} vs {len(prompts)} prompts")
    scores = clap_scores(text_encoder, audio_encoder, [os.path.join(wav_dir, w) for w in wavs],
                         prompts, batch_size=batch_size)
    return {"mean_clap_score": float(scores.mean()) if len(scores) else 0.0,
            "n": len(scores), "per_file": {w: float(s) for w, s in zip(wavs, scores)}}


def write_report(report: Dict, path: str) -> str:
    with open(path, "w") as f:
        json.dump(report, f, indent=2)
    return path

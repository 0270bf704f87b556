"""The port's CLAP-score evaluation (`lumina_t2x_tpu_torch/eval/audio_eval.py`)
against the JAX package's: `read_wav` on 8-, 16- and 32-bit and stereo
files, and `clap_scores` / `clap_eval_directory` over a directory of clips
at two sample rates and lengths (so that the audio tower resamples, tiles,
crops and groups), natural filename order, and the report.

Both packages get the same towers: the audio tower from the JAX tests'
random CLAP state dict (`tests/test_clap_audio._rand_sd`, an 8 kHz
geometry, 1 s clips) through each importer, and the caption tower as the
JAX tests' deterministic stand-in text model (`tests/test_audio_eval`:
hidden states seeded by the first token id) with its projection head. fp32
on the CPU. Bar: atol 2e-4 / rtol 2e-3.
"""

import json
import os
import wave

import numpy as np
import pytest
import torch
from torch import nn

from lumina_t2x_tpu.codecs.clap_audio import CLAPAudioEncoder as JEncoder
from lumina_t2x_tpu.eval import audio_eval as jae
from lumina_t2x_tpu.pipelines.audio_app import save_wav as j_save_wav
from lumina_t2x_tpu_torch.codecs.clap_audio import CLAPAudioEncoder, import_clap_audio_weights
from lumina_t2x_tpu_torch.codecs.text_encoders import CLAPTextEncoder
from lumina_t2x_tpu_torch.core.checkpoint import clap_projection_from_jax
from lumina_t2x_tpu_torch.eval import audio_eval as tae
from lumina_t2x_tpu_torch.pipelines.audio_app import save_wav
from test_audio_eval import _FakeTok, _audio_encoder, _text_encoder
from test_clap_audio import _rand_sd

ATOL, RTOL = 2e-4, 2e-3


class _FakeTorchText(nn.Module):
    """The JAX tests' `_FakeTextModel` as a torch module."""

    def __init__(self, dim=33):
        super().__init__()
        self.dim = dim
        self.anchor = nn.Parameter(torch.zeros(1))  # gives the encoder a device

    def forward(self, input_ids, attention_mask):
        rows = [np.random.RandomState(int(seq[0]) + 1).normal(0, 1, (len(seq), self.dim))
                .astype(np.float32) for seq in input_ids.cpu().numpy()]
        return type("Out", (), {"last_hidden_state": torch.from_numpy(np.stack(rows))})


def _towers():
    jtext, jaudio = _text_encoder(np.random.RandomState(0)), _audio_encoder(np.random.RandomState(1))
    ttext = CLAPTextEncoder(_FakeTorchText(), _FakeTok(),
                            clap_projection_from_jax(jtext.projection_params), max_length=16)
    taudio = CLAPAudioEncoder(import_clap_audio_weights(
        _rand_sd(np.random.RandomState(1)), sample_rate=8000, window_size=256, hop_size=80,
        mel_bins=64, fmin=50, fmax=4000), duration=1.0, device="cpu")
    return (jtext, jaudio), (ttext, taudio)


@pytest.mark.parametrize("width,channels", [(1, 1), (2, 1), (4, 1), (2, 2)])
def test_read_wav_matches_jax(tmp_path, width, channels):
    path = str(tmp_path / "x.wav")
    rng = np.random.default_rng(width * channels)
    dtype = {1: np.uint8, 2: np.int16, 4: np.int32}[width]
    info = np.iinfo(dtype)
    frames = rng.integers(info.min, info.max, (301, channels), endpoint=True).astype(dtype)
    with wave.open(path, "wb") as f:
        f.setnchannels(channels)
        f.setsampwidth(width)
        f.setframerate(11025)
        f.writeframes(frames.tobytes())
    got, sr = tae.read_wav(path)
    ref, ref_sr = jae.read_wav(path)
    assert sr == ref_sr == 11025 and got.dtype == np.float32 and got.shape == (301,)
    np.testing.assert_array_equal(got, ref)


def test_clap_scores_and_directory_report_match_jax(tmp_path):
    (jtext, jaudio), (ttext, taudio) = _towers()
    rng = np.random.default_rng(2)
    clips = {"1.wav": (8000, 6000), "2.wav": (16000, 20000), "10.wav": (8000, 6000),
             "3.wav": (16000, 9000)}  # (rate, samples): tiled, cropped, resampled
    for name, (sr, n) in clips.items():
        j_save_wav(rng.uniform(-0.7, 0.7, n).astype(np.float32), str(tmp_path / name), sr)
    prompts = ["rain on a roof", "a dog barks", "thunder", "a violin"]
    prompt_file = tmp_path / "prompts.txt"
    prompt_file.write_text("\n".join(prompts) + "\n")
    report = tae.clap_eval_directory(ttext, taudio, str(tmp_path), str(prompt_file),
                                     batch_size=3)
    ref = jae.clap_eval_directory(jtext, jaudio, str(tmp_path), prompts, batch_size=3)
    assert list(report["per_file"]) == ["1.wav", "2.wav", "3.wav", "10.wav"] == list(ref["per_file"])
    assert report["n"] == ref["n"] == 4
    np.testing.assert_allclose(list(report["per_file"].values()), list(ref["per_file"].values()),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(report["mean_clap_score"], ref["mean_clap_score"], atol=ATOL,
                               rtol=RTOL)
    out = tae.write_report(report, str(tmp_path / "report.json"))
    with open(out) as f:
        assert json.load(f) == report
    paths = [str(tmp_path / n) for n in ("1.wav", "10.wav")]
    np.testing.assert_allclose(tae.clap_scores(ttext, taudio, paths, prompts[:2]),
                               jae.clap_scores(jtext, jaudio, paths, prompts[:2]), atol=ATOL,
                               rtol=RTOL)
    with pytest.raises(ValueError):
        tae.clap_scores(ttext, taudio, paths, prompts)
    os.remove(prompt_file)
    with pytest.raises(ValueError):
        tae.clap_eval_directory(ttext, taudio, str(tmp_path), prompts[:3])
    save_wav(np.zeros(10, np.float32), str(tmp_path / "x.wav"))
    assert tae.read_wav(str(tmp_path / "x.wav"))[1] == 16000


def test_audio_encoder_loads_a_clap_checkpoint(tmp_path):
    """`CLAPAudioEncoder.from_clap_checkpoint` on a `{"model": state dict}`
    file embeds as JAX's encoder from the same file does (a 16 kHz clip,
    resampled to the tower's 8 kHz)."""
    path = str(tmp_path / "clap.pth")
    torch.save({"model": _rand_sd(np.random.RandomState(1))}, path)
    geometry = dict(sample_rate=8000, window_size=256, hop_size=80, mel_bins=64, fmin=50,
                    fmax=4000)
    enc = CLAPAudioEncoder.from_clap_checkpoint(path, device="cpu", **geometry)
    ref = JEncoder.from_clap_checkpoint(path, **geometry)
    enc.duration = ref.duration = 1.0
    wave_16k = np.random.default_rng(3).uniform(-0.5, 0.5, (1, 12000)).astype(np.float32)
    np.testing.assert_allclose(enc.embed(wave_16k, sr=16000).numpy(),
                               np.asarray(ref.embed(wave_16k, sr=16000)), atol=ATOL, rtol=RTOL)

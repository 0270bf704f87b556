"""The port's CLAP judge against the JAX package's: the audio tower
(`lumina_t2x_tpu_torch/codecs/clap_audio.py`: the log-mel front end at a
length that is not a multiple of the hop, Cnn14, the projection, the whole
embedding, the polyphase resampler at 16 -> 44.1 kHz and back) and the
caption tower (`codecs/text_encoders.py`: `clap_projection`,
`extract_clap_caption_weights` and `CLAPTextEncoder` over a small
transformers BERT, the same torch state dict loaded by both sides: the
torch `BertModel` here, `FlaxBertModel` there).

The audio tower's weights are the JAX tests' random CLAP state dict
(`tests/test_clap_audio._rand_sd`: Cnn14 at an eighth of its widths), read
by both packages' importers. fp32 on the CPU, inputs from numpy. Bar: atol
2e-4 / rtol 2e-3; the log-mel in dB, whose values reach ~100, is held to
rtol 2e-3 with atol 2e-3.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from transformers import BertConfig, BertModel, FlaxBertModel

from lumina_t2x_tpu.codecs import clap_audio as jca
from lumina_t2x_tpu.codecs import text_encoders as jte
from lumina_t2x_tpu_torch.codecs import clap_audio as tca
from lumina_t2x_tpu_torch.codecs import text_encoders as tte
from lumina_t2x_tpu_torch.core.checkpoint import clap_audio_params_from_jax
from test_clap_audio import _rand_sd

ATOL, RTOL = 2e-4, 2e-3
GEOMETRY = dict(sample_rate=8000, window_size=256, hop_size=80, mel_bins=64, fmin=50,
                fmax=4000)


@functools.lru_cache(maxsize=None)
def _audio_params():
    sd = _rand_sd(np.random.RandomState(0))
    return jca.import_clap_audio_weights(sd, **GEOMETRY), tca.import_clap_audio_weights(
        sd, **GEOMETRY)


def _wave(seed, n):
    return np.random.default_rng(seed).uniform(-0.8, 0.8, (2, n)).astype(np.float32)


def test_front_end_matches_jax_off_the_hop_grid():
    x = _wave(1, 1001)  # 1001 = 12 hops + 41
    power = tca.stft_power(torch.from_numpy(x), 256, 80)
    ref = np.asarray(jca.stft_power(jnp.asarray(x), 256, 80))
    assert power.shape == ref.shape == (2, 1001 // 80 + 1, 129)
    np.testing.assert_allclose(power.numpy(), ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(tca.mel_filterbank(8000, 256, 64, 50, 4000),
                                  jca.mel_filterbank(8000, 256, 64, 50, 4000))
    np.testing.assert_array_equal(tca.hann_window(256), jca.hann_window(256))
    kw = dict(sr=8000, n_fft=256, hop=80, n_mels=64, fmin=50, fmax=4000)
    np.testing.assert_allclose(tca.logmel(torch.from_numpy(x), **kw).numpy(),
                               np.asarray(jca.logmel(jnp.asarray(x), **kw)), atol=2e-3, rtol=RTOL)


def test_cnn14_projection_and_embedding_match_jax():
    jparams, tparams = _audio_params()
    mel = np.random.default_rng(2).standard_normal((2, 40, 64)).astype(np.float32) * 10 - 40
    emb, clip = tca.cnn14_embedding(tparams["cnn14"], torch.from_numpy(mel))
    ref_emb, ref_clip = jax.jit(jca.cnn14_embedding)(
        jax.tree.map(jnp.asarray, jparams["cnn14"]), jnp.asarray(mel))
    np.testing.assert_allclose(emb.numpy(), np.asarray(ref_emb), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(clip.numpy(), np.asarray(ref_clip), atol=ATOL, rtol=RTOL)
    proj = tte.clap_projection(emb, tparams["projection"])
    ref_proj = jte.clap_projection(ref_emb, jax.tree.map(jnp.asarray, jparams["projection"]))
    np.testing.assert_allclose(proj.numpy(), np.asarray(ref_proj), atol=ATOL, rtol=RTOL)

    x = _wave(3, 8000)
    got = tca.clap_audio_embed(tparams, torch.from_numpy(x), sr=8000)
    ref = jca.clap_audio_embed(jparams, jnp.asarray(x), sr=8000)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(tca.clap_score(got, got).numpy(), 1.0, atol=1e-5)
    np.testing.assert_allclose(tca.clap_similarity(got, got.flip(0)).numpy(),
                               np.asarray(jca.clap_similarity(ref, ref[::-1])), atol=ATOL,
                               rtol=RTOL)
    assert tparams["logit_scale"] == pytest.approx(jparams["logit_scale"])


def test_the_jax_parameter_dict_crosses_over():
    jparams, tparams = _audio_params()
    bridged = clap_audio_params_from_jax(jparams)
    flat = lambda tree, pre="": {  # noqa: E731
        f"{pre}{k}": v for key, sub in tree.items()
        for k, v in (flat(sub, f"{key}/").items() if isinstance(sub, dict) else [(key, sub)])}
    a, b = flat(bridged), flat(tparams)
    assert set(a) == set(b)
    for key in a:
        if isinstance(b[key], torch.Tensor):
            np.testing.assert_allclose(a[key].numpy(), b[key].numpy(), atol=1e-6, rtol=1e-6)
        else:
            assert a[key] == b[key], key


@pytest.mark.parametrize("sr_in,sr_out,n", [(16000, 44100, 401), (44100, 16000, 1103),
                                            (8000, 16000, 97)])
def test_polyphase_resampler_matches_the_dilated_convolution(sr_in, sr_out, n):
    x = _wave(4, n)
    got = tca.resample_waveform(x, sr_in, sr_out, chunk=256)
    ref = np.asarray(jca.resample_waveform(x, sr_in, sr_out))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_tile_or_crop_matches_jax():
    w = np.arange(7, dtype=np.float32)
    for n, start in ((17, 0), (4, 2), (7, 0)):
        np.testing.assert_array_equal(tca.tile_or_crop(w, n, start=start),
                                      jca.tile_or_crop(w, n, start=start))


BERT = dict(vocab_size=1200, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, max_position_embeddings=128)


def test_caption_tower_matches_jax_on_one_state_dict(tmp_path):
    torch.manual_seed(0)
    base = BertModel(BertConfig(**BERT)).eval()
    d_proj = 24
    g = torch.Generator().manual_seed(1)
    sd = {f"caption_encoder.base.{k}": v for k, v in base.state_dict().items()}
    sd.update({"caption_encoder.projection.linear1.weight": 0.2 * torch.randn(d_proj, 32, generator=g),
               "caption_encoder.projection.linear2.weight": 0.2 * torch.randn(d_proj, d_proj,
                                                                            generator=g),
               "caption_encoder.projection.layer_norm.weight": 1 + 0.1 * torch.randn(d_proj,
                                                                                   generator=g),
               "caption_encoder.projection.layer_norm.bias": 0.1 * torch.randn(d_proj, generator=g),
               "audio_encoder.base.bn0.weight": torch.ones(3)})
    path = str(tmp_path / "clap.pth")
    torch.save({"model": sd}, path)
    tok = tte.BertHashTokenizer(vocab_size=BERT["vocab_size"])
    jenc = jte.CLAPTextEncoder.from_clap_checkpoint(path, FlaxBertModel(BertConfig(**BERT)), tok,
                                                    max_length=16)
    tenc = tte.CLAPTextEncoder.from_clap_checkpoint(path, BertModel(BertConfig(**BERT)), tok,
                                                    max_length=16)
    prompts = ["rain on a tin roof", "a solo cello playing a slow melody", ""]
    feats, mask = tenc.encode(prompts)
    ref_feats, ref_mask = jenc.encode(prompts)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    assert feats.shape == (3, 16, d_proj)
    np.testing.assert_allclose(feats.numpy(), np.asarray(ref_feats), atol=ATOL, rtol=RTOL)
    emb = tenc.embed(prompts)
    np.testing.assert_allclose(emb.numpy(), np.asarray(jenc.embed(prompts)), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(emb.norm(dim=-1).numpy(), 1.0, atol=1e-5)
    with pytest.raises(ValueError):
        tte.CLAPTextEncoder(base, tok).embed(["x"])

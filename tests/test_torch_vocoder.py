"""The port's BigVGAN vocoder (`lumina_t2x_tpu_torch/codecs/vocoder.py`) and
discriminators (`codecs/vocoder_discriminators.py`) against the JAX
package's: the alias-free FIR pair at odd lengths, the generator at the
app's debug config and at kernel 8 / rate 4 then kernel 4 / rate 2 on odd
input lengths (torch's `ConvTranspose1d(padding=(k - rate) // 2)` against
flax's SAME transposed convolution of the time-flipped kernel), the import
from a weight-normed `best_netG.pt`-style state dict, and MPD / MRD with
their three losses.

The port's modules are built from a seed with every parameter perturbed
(snake alpha / beta by 0.3 * N(0, 1)); their weights reach the JAX models
through the JAX package's importers. fp32 on the CPU, inputs from numpy.
Bar: atol 2e-4 / rtol 2e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumina_t2x_tpu.codecs import vocoder as jvoc
from lumina_t2x_tpu.codecs import vocoder_discriminators as jdisc
from lumina_t2x_tpu_torch.codecs import vocoder as tvoc
from lumina_t2x_tpu_torch.codecs import vocoder_discriminators as tdisc
from lumina_t2x_tpu_torch.core.checkpoint import (bigvgan_state_dict_from_jax,
                                                  discriminator_state_dict_from_jax)

ATOL, RTOL = 2e-4, 2e-3
CONFIGS = {  # (mel bins, input frames, BigVGAN keywords)
    "debug": (80, 9, dict(upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
                          upsample_initial_channel=32, resblock_kernel_sizes=(3,),
                          resblock_dilation_sizes=((1, 3),))),
    "k8r4_k4r2": (8, 7, dict(upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
                             upsample_initial_channel=32, resblock_kernel_sizes=(3, 5),
                             resblock_dilation_sizes=((1, 3), (1, 2)))),
}


def _perturb(model, seed, scale=0.05):
    torch.manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.add_((0.3 if name.endswith((".alpha", ".beta")) else scale) * torch.randn(p.shape))
    return model.eval()


@pytest.mark.parametrize("t", [7, 13])
def test_fir_pair_matches_jax_at_odd_lengths(t):
    x = np.random.default_rng(t).standard_normal((2, t, 5)).astype(np.float32)  # (B, T, C)
    xt = torch.from_numpy(x.transpose(0, 2, 1).copy())
    up = tvoc.upsample2_fir(xt)
    assert up.shape == (2, 5, 2 * t)
    np.testing.assert_allclose(up.numpy().transpose(0, 2, 1),
                               np.asarray(jvoc.upsample2_fir(jnp.asarray(x))), atol=ATOL, rtol=RTOL)
    down = tvoc.downsample2_fir(up)
    ref = jvoc.downsample2_fir(jvoc.upsample2_fir(jnp.asarray(x)))
    np.testing.assert_allclose(down.numpy().transpose(0, 2, 1), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_array_equal(tvoc.kaiser_sinc_filter1d(0.25, 0.3, 12),
                                  jvoc.kaiser_sinc_filter1d(0.25, 0.3, 12))


def _weight_normed(sd):
    """A reference-style state dict: every conv weight as (weight_g,
    weight_v) with v = 1.7 w (so g v / ||v|| rebuilds w), plus the
    resamplers' fixed filter buffers."""
    out = {}
    for key, w in sd.items():
        w = w.numpy()
        if key.endswith(".weight") and w.ndim == 3:
            name = key[: -len(".weight")]
            out[f"{name}.weight_v"] = 1.7 * w
            out[f"{name}.weight_g"] = np.sqrt((w.astype(np.float64) ** 2).sum(
                axis=(1, 2), keepdims=True)).astype(np.float32)
        else:
            out[key] = w
    out["resblocks.0.activations.0.upsample.filter"] = np.ones((1, 1, 12), np.float32)
    return out


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_bigvgan_from_weight_normed_state_dict_matches_jax(config):
    mel, frames, kw = CONFIGS[config]
    tmodel = _perturb(tvoc.BigVGAN(mel_bins=mel, **kw), 1)
    wn = _weight_normed(tmodel.state_dict())
    ported = tvoc.BigVGAN(mel_bins=mel, **kw).eval()
    ported.load_state_dict(tvoc.import_bigvgan_weights({"generator": wn}), strict=True)
    params = jvoc.import_bigvgan_weights(
        {"generator": wn}, upsample_rates=kw["upsample_rates"],
        resblock_kernel_sizes=kw["resblock_kernel_sizes"],
        resblock_dilation_sizes=kw["resblock_dilation_sizes"])
    back = bigvgan_state_dict_from_jax(params)
    assert set(back) == set(ported.state_dict())
    for key, value in ported.state_dict().items():
        np.testing.assert_allclose(back[key].numpy(), value.numpy(), atol=1e-6, rtol=1e-5)

    x = np.random.default_rng(2).standard_normal((2, mel, frames)).astype(np.float32)
    jmodel = jvoc.BigVGAN(mel_bins=mel, **kw)
    ref = np.asarray(jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = ported(torch.from_numpy(x))
    rate = int(np.prod(kw["upsample_rates"]))
    assert got.shape == ref.shape == (2, frames * rate)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_vocoder_wrapper_loads_a_checkpoint_and_vocodes(tmp_path):
    mel, frames, kw = CONFIGS["debug"]
    tmodel = _perturb(tvoc.BigVGAN(mel_bins=mel, **kw), 3)
    path = str(tmp_path / "best_netG.pt")
    torch.save({"generator": {k: torch.from_numpy(v) for k, v in
                              _weight_normed(tmodel.state_dict()).items()}}, path)
    voc = tvoc.VocoderBigVGAN.from_torch_checkpoint(path, mel_bins=mel, device="cpu", **kw)
    x = np.random.default_rng(4).standard_normal((mel, frames)).astype(np.float32)
    wav = voc.vocode(x)
    with torch.no_grad():
        ref = tmodel(torch.from_numpy(x)[None]).numpy()
    assert isinstance(wav, np.ndarray) and wav.shape == (1, frames * 4)
    np.testing.assert_allclose(wav, ref, atol=ATOL, rtol=RTOL)
    assert tvoc.VocoderBigVGAN.create(0, mel_bins=mel, device="cpu", **kw).vocode(x).shape == (1, 36)


PERIODS, RESOLUTIONS, MULT = (2, 3), ((64, 16, 40), (32, 8, 24)), 0.25


def _disc_pair(kind):
    if kind == "mpd":
        tmodel = tdisc.MultiPeriodDiscriminator(PERIODS, channel_mult=MULT)
        names = [f"p{p}" for p in PERIODS]
        jmodel = jdisc.MultiPeriodDiscriminator(PERIODS, channel_mult=MULT)
        importer = lambda sd: jdisc.import_mpd_weights(sd, PERIODS)  # noqa: E731
    else:
        tmodel = tdisc.MultiResolutionDiscriminator(RESOLUTIONS, channel_mult=MULT)
        names = [f"r{r[0]}" for r in RESOLUTIONS]
        jmodel = jdisc.MultiResolutionDiscriminator(RESOLUTIONS, channel_mult=MULT)
        importer = lambda sd: jdisc.import_mrd_weights(sd, RESOLUTIONS)  # noqa: E731
    tmodel = _perturb(tmodel, 5)
    sd = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    variables = importer(sd)
    back = discriminator_state_dict_from_jax(variables, names)
    assert set(back) == set(sd)
    assert all(np.array_equal(back[k].numpy(), v) for k, v in sd.items())
    ported = (tdisc.MultiPeriodDiscriminator(PERIODS, channel_mult=MULT) if kind == "mpd" else
              tdisc.MultiResolutionDiscriminator(RESOLUTIONS, channel_mult=MULT))
    importer_t = tdisc.import_mpd_weights if kind == "mpd" else tdisc.import_mrd_weights
    ported.load_state_dict(importer_t({**sd, "extra.buffer": np.zeros(1)}), strict=True)
    return jmodel, variables, ported


@pytest.mark.parametrize("kind", ["mpd", "mrd"])
def test_discriminators_and_losses_match_jax(kind):
    jmodel, variables, tmodel = _disc_pair(kind)
    rng = np.random.default_rng(6)
    y, y_hat = (rng.uniform(-0.9, 0.9, (2, 101)).astype(np.float32) for _ in range(2))

    def losses(sr, sg, fr, fg, lib):
        d_loss, d_r, d_g = lib.discriminator_loss(sr, sg)
        g_loss, g_per = lib.generator_loss(sg)
        return [d_loss, *d_r, *d_g, g_loss, *g_per, lib.feature_loss(fr, fg)]

    def jax_fn(v, a, b):
        out = jmodel.apply(v, a, b)
        return out, losses(*out, jdisc)

    (jsr, jsg, jfr, jfg), jl = jax.jit(jax_fn)(variables, jnp.asarray(y), jnp.asarray(y_hat))
    with torch.no_grad():
        sr, sg, fr, fg = tmodel(torch.from_numpy(y)[:, None], torch.from_numpy(y_hat))
        tl = losses(sr, sg, fr, fg, tdisc)
    for got, ref in zip(sr + sg, list(jsr) + list(jsg)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    for got, ref in zip([f for maps in fr + fg for f in maps],
                        [f for maps in list(jfr) + list(jfg) for f in maps]):
        ref = np.asarray(ref)  # NHWC against the port's NCHW
        np.testing.assert_allclose(got.numpy(), np.moveaxis(ref, -1, 1), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose([float(v) for v in tl], [float(v) for v in jl], atol=ATOL,
                               rtol=RTOL)

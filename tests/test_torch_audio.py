"""The port's audio and music generation path against the JAX package's:
FlagDiT-1D (`lumina_t2x_tpu_torch/models/flag_dit_1d.py`) and its weight
bridges, the CFM objective and samplers (`transport/cfm.py`), the DDIM
sampler, the LR schedule, the port's copy of the music config
(`pipelines/audio.py`), the structured captions, `save_wav` and the whole
generation path (`generate_audio` over FlagDiT-1D, the 1-D VAE and BigVGAN)
on a tiny stack (`pipelines/audio_app.py`).

Tiny config: FlagDiT-1D 64 wide, 2 layers, 4 heads, 8 latent channels,
context 32 wide. The port's model is built from a seed with every parameter
perturbed by 0.02 * N(0, 1) (the zero-initialised adaLN, final layer and
gates would otherwise make the output exactly 0); its state dict, in the
reference layout, reaches the JAX model through the JAX package's
`import_flag_dit_1d_weights`. The JAX models run `attn_impl="xla"`. Random
draws (t, the noise, DDIM's step noise) are made by JAX and handed to the
port. fp32 on the CPU, inputs from numpy. Bar: atol 2e-4 / rtol 2e-3; the
whole generation path (24 model evaluations, the VAE and the vocoder in
series) is held to atol 1e-3 / rtol 1e-2.
"""

import functools
import io
import wave
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumina_t2x_tpu.codecs import vae1d as jv
from lumina_t2x_tpu.codecs import vocoder as jvoc
from lumina_t2x_tpu.core.checkpoint import import_flag_dit_1d_weights as j_import_fd1d
from lumina_t2x_tpu.models.flag_dit_1d import FlagDiT1D as JFlagDiT1D
from lumina_t2x_tpu.pipelines import audio as ja
from lumina_t2x_tpu.pipelines import audio_app as japp
from lumina_t2x_tpu.transport.cfm import CFM as JCFM
from lumina_t2x_tpu_torch.codecs import vae1d as tv
from lumina_t2x_tpu_torch.codecs import vocoder as tvoc
from lumina_t2x_tpu_torch.core.checkpoint import (flag_dit_1d_state_dict_from_jax_params,
                                                  import_flag_dit_1d_weights)
from lumina_t2x_tpu_torch.models import MODELS
from lumina_t2x_tpu_torch.models.flag_dit_1d import FlagDiT1D
from lumina_t2x_tpu_torch.pipelines import audio as ta
from lumina_t2x_tpu_torch.pipelines import audio_app as tapp
from lumina_t2x_tpu_torch.transport.cfm import CFM

ATOL, RTOL = 2e-4, 2e-3
C, D, L = 8, 32, 5
TINY = dict(in_channels=C, context_dim=D, hidden_size=64, depth=2, num_heads=4, multiple_of=16)


def _perturb(model, seed, scale=0.02):
    torch.manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(scale * torch.randn(p.shape))
    return model.eval()


@functools.lru_cache(maxsize=None)
def _pair(qk_norm=False):
    """The port's tiny FlagDiT-1D (perturbed) and the JAX model with its
    weights."""
    torch.manual_seed(0)
    tmodel = _perturb(FlagDiT1D(qk_norm=qk_norm, **TINY), 1)
    sd = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    params = j_import_fd1d(sd, depth=TINY["depth"])
    return JFlagDiT1D(qk_norm=qk_norm, attn_impl="xla", **TINY), params, tmodel


def _inputs(seed, b=2, t=12):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, C, t)).astype(np.float32),
            rng.uniform(0, 1000, b).astype(np.float32),
            rng.standard_normal((b, L, D)).astype(np.float32))


@pytest.mark.parametrize("qk_norm", [False, True])
def test_flag_dit_1d_forward_matches_jax(qk_norm):
    jmodel, params, tmodel = _pair(qk_norm)
    x, t, ctx = _inputs(2)
    ref = jax.jit(jmodel.apply)({"params": params}, *map(jnp.asarray, (x, t, ctx)))
    with torch.no_grad():
        got = tmodel(*map(torch.from_numpy, (x, t, ctx)))
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    # the bridge carries the JAX tree back to the port's state dict unchanged
    back = flag_dit_1d_state_dict_from_jax_params(params)
    assert set(back) == set(tmodel.state_dict())
    assert all(torch.equal(back[k], v) for k, v in tmodel.state_dict().items())


def test_reference_state_dict_loads_and_registry_builds():
    _, _, tmodel = _pair()
    sd = {**tmodel.state_dict(), "freqs_cis": torch.zeros(3)}  # a reference buffer
    fresh = FlagDiT1D(**TINY)
    fresh.load_state_dict(import_flag_dit_1d_weights(sd), strict=True)
    assert all(torch.equal(a, b) for a, b in zip(fresh.state_dict().values(),
                                                  tmodel.state_dict().values()))
    model = MODELS["FlagDiT1D_music"](hidden_size=64, depth=1, num_heads=4, multiple_of=16)
    assert model.proj_in.in_features == 20 and model.cap_embedder[1].in_features == 1024
    assert model.blocks[0].adaLN_modulation[1].in_features == 64  # the full hidden size


def test_proportional_attention_matches_jax():
    jmodel, params, tmodel = _pair()
    x, t, ctx = _inputs(3, t=16)
    kw = dict(proportional_attn=True, base_seqlen=8)
    ref = jax.jit(functools.partial(jmodel.apply, **kw))({"params": params},
                                                         *map(jnp.asarray, (x, t, ctx)))
    with torch.no_grad():
        got = tmodel(*map(torch.from_numpy, (x, t, ctx)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_cfm_loss_matches_jax_with_its_draws():
    jmodel, params, tmodel = _pair()
    x1, _, ctx = _inputs(4)
    rng = jax.random.PRNGKey(3)
    t = jnp.asarray([17, 903])
    ref = jax.jit(lambda p, x, c: JCFM().p_losses(
        rng, lambda xn, tt: jmodel.apply({"params": p}, xn, tt, c), x, t=t))(
        params, jnp.asarray(x1), jnp.asarray(ctx))
    noise = jax.random.normal(jax.random.split(rng)[1], x1.shape)  # p_losses' second key
    with torch.no_grad():
        got = CFM().p_losses(None, lambda xn, tt: tmodel(xn, tt, torch.from_numpy(ctx)),
                             torch.from_numpy(x1), t=torch.from_numpy(np.asarray(t)),
                             noise=torch.from_numpy(np.array(noise)))
    np.testing.assert_allclose(got["loss_simple"].numpy(), np.asarray(ref["loss_simple"]),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]), atol=ATOL, rtol=RTOL)


def _drift(lib):
    """A cheap stand-in velocity that depends on x, the float time t and
    (for CFG) the context."""
    def fn(x, t, c=None):
        out = -0.5 * x + 1e-3 * t[:, None, None]
        if c is not None:
            out = out * (1.0 + c.mean(axis=(1, 2)) if lib is jnp else
                         1.0 + c.mean(dim=(1, 2)))[:, None, None]
        return out
    return fn


@pytest.mark.parametrize("mode", ["noise", "t_start_x_latent", "cfg"])
def test_cfm_samplers_match_jax(mode):
    rng = jax.random.PRNGKey(5)
    shape = (2, 3, 6)
    noise = np.array(jax.random.normal(rng, shape))
    latent = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    if mode == "cfg":
        cond, uncond = (np.random.default_rng(s).standard_normal((2, 4, 5)).astype(np.float32)
                        for s in (7, 8))
        ref = JCFM().sample_cfg(rng, _drift(jnp), shape, jnp.asarray(cond), jnp.asarray(uncond),
                                guidance_scale=3.0, num_steps=6)
        got = CFM().sample_cfg(torch.from_numpy(noise), _drift(torch), shape,
                               torch.from_numpy(cond), torch.from_numpy(uncond),
                               guidance_scale=3.0, num_steps=6)
    elif mode == "noise":
        ref = JCFM().sample(rng, _drift(jnp), shape, num_steps=25, return_traj=True)
        got = CFM().sample(torch.from_numpy(noise), _drift(torch), shape, num_steps=25,
                           return_traj=True)
        assert got.shape == (25, *shape)  # 25 points: 24 Euler steps
    else:
        kw = dict(num_steps=10, t_start=4)
        ref = JCFM().sample(rng, _drift(jnp), shape, x_latent=jnp.asarray(latent), **kw)
        got = CFM().sample(None, _drift(torch), shape, x_latent=torch.from_numpy(latent), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_matches_jax_with_fed_noise(eta):
    rng = jax.random.PRNGKey(9)
    shape, steps = (2, 3, 8), 10
    eps = lambda x, t: 0.3 * x + 1e-3 * t[:, None, None]  # noqa: E731
    ref = ja.ddim_sample(rng, eps, shape, num_steps=steps, eta=eta)
    key, step_noise = rng, []
    for _ in range(steps):  # the scan's chain of splits
        key, sub = jax.random.split(key)
        step_noise.append(torch.from_numpy(np.array(jax.random.normal(sub, shape))))
    got = ta.ddim_sample(torch.from_numpy(np.array(jax.random.normal(rng, shape))), eps, shape,
                         num_steps=steps, eta=eta, step_noise=step_noise)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(ta.make_ddim_timesteps("uniform", 10, 1000),
                                  ja.make_ddim_timesteps("uniform", 10, 1000))
    for schedule in ("linear", "cosine", "sqrt_linear", "sqrt"):
        np.testing.assert_array_equal(ta.make_beta_schedule(schedule, 50),
                                      ja.make_beta_schedule(schedule, 50))


def test_lambda_linear_schedule_matches_jax_across_two_cycles():
    kw = dict(warm_up_steps=[5, 10], f_min=[0.1, 0.2], f_max=[1.0, 0.8], f_start=[0.0, 0.05],
              cycle_lengths=[20, 30])
    ours, ref = ta.lambda_linear_schedule(**kw), ja.lambda_linear_schedule(**kw)
    steps = [0, 3, 5, 12, 20, 21, 25, 33, 50, 60]
    np.testing.assert_allclose([ours(s) for s in steps], [float(ref(s)) for s in steps],
                               atol=1e-6, rtol=1e-6)
    one = dict(warm_up_steps=4, f_min=0.5, f_max=1.0, f_start=0.1, cycle_lengths=8)
    np.testing.assert_allclose([ta.lambda_linear_schedule(**one)(s) for s in range(12)],
                               [float(ja.lambda_linear_schedule(**one)(s)) for s in range(12)],
                               atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError):
        ta.lambda_linear_schedule(warm_up_steps=[1, 2], f_min=0, f_max=1, f_start=0,
                                  cycle_lengths=[3, 4])


def test_music_config_is_the_jax_config_with_the_port_targets():
    import yaml

    # by the repository's path, not the working directory (another test file
    # on the same worker may have changed it)
    with open(Path(__file__).resolve().parents[1] / "configs" / "lumina-text2music.yaml") as f:
        ref = yaml.safe_load(f)
    ours = ta.load_music_config()
    assert set(ours) == set(ref)
    for name, section in ref.items():
        assert ours[name]["target"] == section["target"].replace("lumina_t2x_tpu.",
                                                                 "lumina_t2x_tpu_torch.")
        assert ours[name].get("params") == section.get("params")
        assert ours[name].get("pretrained") == section.get("pretrained")
        assert callable(ta.get_obj_from_str(ours[name]["target"]))
    assert isinstance(ta.instantiate_from_config(ours["model"]), CFM)
    vae = ta.instantiate_from_config(ours["first_stage"])
    assert isinstance(vae, tv.AutoencoderKL1D) and len(vae.encoder.down) == 3
    sched = ta.instantiate_from_config(ours["lr_scheduler"])
    ref_sched = ja.instantiate_from_config(ref["lr_scheduler"])
    assert sched(5000) == pytest.approx(float(ref_sched(5000)), rel=1e-6)
    with pytest.raises(KeyError):
        ta.instantiate_from_config({"params": {}})


@pytest.mark.parametrize("caption", ["rain followed by thunder", "Birds chirping, then a dog barks "
                                     "after a car passes.", "a quiet hum", " , . ", ""])
def test_structured_captions_match_jax(caption):
    assert tapp.natural_to_structured(caption) == japp.natural_to_structured(caption)
    assert tapp.natural_to_structured(caption, str.upper) == caption.upper()


def test_save_wav_writes_the_jax_bytes(tmp_path):
    wav = np.concatenate([np.linspace(-1.5, 1.5, 999), [0.0, 1.0, -1.0]]).astype(np.float32)
    ours, ref = io.BytesIO(), tmp_path / "ref.wav"
    tapp.save_wav(wav, ours, sample_rate=22050)
    japp.save_wav(wav, str(ref), sample_rate=22050)
    assert ours.getvalue() == ref.read_bytes()
    path = tapp.save_wav(wav, str(tmp_path / "ours.wav"))
    japp.save_wav(wav, str(ref))
    assert open(path, "rb").read() == ref.read_bytes()


VAE_TINY = dict(mel_bins=80, embed_dim=C, ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=C)
VOC_DEBUG = dict(upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4), upsample_initial_channel=32,
                 resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),))


def test_generate_audio_matches_jax_on_the_tiny_stack():
    """FlagDiT-1D -> CFM with CFG 3 over 25 points -> the app's VAE at ch 32
    -> the debug BigVGAN, the same weights and starting noise on both
    sides."""
    jmodel, params, tmodel = _pair()
    torch.manual_seed(2)
    vae = _perturb(tv.AutoencoderKL1D(**VAE_TINY), 3, 0.05)
    vae_params = jv.import_autoencoder_kl_1d_weights(
        {k: v.numpy() for k, v in vae.state_dict().items()}, ch_mult=(1, 2), num_res_blocks=1)
    voc = _perturb(tvoc.BigVGAN(**VOC_DEBUG), 4, 0.05)
    voc_params = jvoc.import_bigvgan_weights(
        {k: v.numpy() for k, v in voc.state_dict().items()}, upsample_rates=(2, 2),
        resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),))
    jvae, jvocoder = jv.AutoencoderKL1D(**VAE_TINY), jvoc.BigVGAN(**VOC_DEBUG)

    rng = jax.random.PRNGKey(11)
    shape = (1, C, 8)
    cond, uncond = (np.random.default_rng(s).standard_normal((1, L, D)).astype(np.float32)
                    for s in (12, 13))
    ref_mel, ref_wav = ja.generate_audio(
        rng, lambda x, t, c: jmodel.apply({"params": params}, x, t, c),
        jax.jit(lambda z: jvae.apply({"params": vae_params}, z, method=jvae.decode)),
        jax.jit(lambda m: jvocoder.apply({"params": voc_params}, m)),
        cond=jnp.asarray(cond), uncond=jnp.asarray(uncond), latent_shape=shape,
        guidance_scale=3.0, num_steps=25, scale_factor=0.7)
    gen = tapp.GenSamples(tmodel, vae.decode, voc, latent_channels=C, latent_length=8,
                          guidance_scale=3.0, num_steps=25, scale_factor=0.7)
    mel, wav = gen.gen_test_sample(torch.from_numpy(np.array(jax.random.normal(rng, shape))),
                                   torch.from_numpy(cond), torch.from_numpy(uncond))
    assert mel.shape == (1, 80, 16) and wav.shape == (1, 64)
    np.testing.assert_allclose(mel, np.asarray(ref_mel), atol=1e-3, rtol=1e-2)
    np.testing.assert_allclose(wav, np.asarray(ref_wav), atol=1e-3, rtol=1e-2)
    assert np.abs(wav).max() > 1e-3


def test_gradio_ui_needs_gradio(monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, "gradio", None)
    with pytest.raises(ImportError):
        tapp.build_audio_gradio_ui(tapp.GenSamples(None, None))


def test_cli_writes_a_wav_on_the_debug_stack(tmp_path, capsys):
    out = tapp.main(["--task", "audio", "--prompt", "rain followed by thunder", "--struct_caption",
                     "--output_dir", str(tmp_path), "--num_steps", "3", "--latent_length", "16",
                     "--debug", "--device", "cpu"])
    with wave.open(out, "rb") as f:
        assert (f.getnchannels(), f.getsampwidth(), f.getframerate()) == (1, 2, 16000)
        assert f.getnframes() == 16 * 4  # 8 latent frames -> 16 mel frames -> x4 (debug rates)
    assert "structured caption: <rain& start>@<thunder& end>" in capsys.readouterr().out

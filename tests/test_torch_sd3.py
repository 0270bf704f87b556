"""The port's mini transport (`lumina_t2x_tpu_torch/transport/mini.py`) and
SD3 sampler (`pipelines/sample_sd3.py`) against the JAX package's:
`MiniODE`'s time grids (Lumina and SD3 shifts, `strength`), its sampling in
both modes (SD3's t * 1000 and in-loop CFG over duplicated halves) with a
tiny MMDiT as the model, `training_losses_mini` with JAX's draws handed in,
and `sample_sd3.main --debug` end to end (npy latents, then PNGs through a
random z=16 VAE file, and the resume from data.json).

A tiny MMDiT (dim 64, 3 layers, 4 heads, 4 latent channels) with weights
carried by `core/checkpoint.mmdit_state_dict_from_jax_params`, fp32 on the
CPU, inputs from numpy. Bar: atol 2e-4 / rtol 2e-3.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumina_t2x_tpu.transport import mini as j_mini
from lumina_t2x_tpu_torch import models as t_models
from lumina_t2x_tpu_torch.codecs.clip_text import build_sd3_prompt_encoder
from lumina_t2x_tpu_torch.models import mmdit as t_mmdit
from lumina_t2x_tpu_torch.pipelines import sample_sd3
from lumina_t2x_tpu_torch.transport import mini as t_mini

from test_torch_mmdit import _pair as mmdit_pair

ATOL, RTOL = 2e-4, 2e-3


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(ref, np.float32),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("kw", [
    dict(use_sd3=False), dict(use_sd3=False, time_shifting_factor=4.0),
    dict(use_sd3=True, time_shifting_factor=3.0), dict(use_sd3=True, strength=0.6),
    dict(use_sd3=False, time_shifting_factor=4.0, strength=0.5, t0=0.1)])
def test_mini_ode_grid_matches_jax(kw):
    np.testing.assert_allclose(t_mini.MiniODE(9, **kw).t.numpy(),
                               np.asarray(j_mini.MiniODE(9, **kw).t), atol=1e-7)


@pytest.mark.parametrize("sampler", ["euler", "midpoint"])
@pytest.mark.parametrize("use_sd3", [False, True])
def test_mini_ode_sample_matches_jax(use_sd3, sampler):
    """The tiny MMDiT as the model: SD3 mode hands it t * 1000 and guides
    the duplicated first half; Lumina mode hands it t."""
    jmodel, variables, tmodel = mmdit_pair()
    rng = np.random.default_rng(4)
    z = rng.standard_normal((1, 4, 8, 8)).astype(np.float32)
    z = np.concatenate([z, z])
    ctx = rng.standard_normal((2, 5, 24)).astype(np.float32)
    pooled = rng.standard_normal((2, 16)).astype(np.float32)
    kw = dict(sampler_type=sampler, time_shifting_factor=3.0, use_sd3=use_sd3)
    cfg = 7.0 if use_sd3 else None
    ref = j_mini.MiniODE(4, **kw).sample(
        jnp.asarray(z), lambda x, t: jmodel.apply(variables, x, t, jnp.asarray(ctx),
                                                  jnp.asarray(pooled)), cfg_scale=cfg)
    with torch.no_grad():
        got = t_mini.MiniODE(4, **kw).sample(
            torch.from_numpy(z), lambda x, t: tmodel(x, t, torch.from_numpy(ctx),
                                                     torch.from_numpy(pooled)), cfg_scale=cfg)
    _close(got, ref)
    if use_sd3:
        np.testing.assert_array_equal(got[0].numpy(), got[1].numpy())
        with pytest.raises(ValueError):
            t_mini.MiniODE(4, **kw).sample(torch.from_numpy(z), lambda x, t: x)


def test_training_losses_mini_matches_jax():
    """JAX's draws (split of the key into t and noise) handed in; a
    nonlinear stand-in model that reads both xt and t."""
    rng = np.random.default_rng(5)
    x1 = rng.standard_normal((3, 4, 8, 8)).astype(np.float32)
    w = rng.standard_normal((4, 4)).astype(np.float32)
    mask = (rng.uniform(size=(3, 4, 8, 8)) > 0.3).astype(np.float32)
    key = jax.random.PRNGKey(6)
    t_rng, noise_rng = jax.random.split(key)
    t = np.asarray(jax.random.uniform(t_rng, (3,)))
    x0 = np.asarray(jax.random.normal(noise_rng, x1.shape, jnp.float32))
    j_fn = lambda xt, tt: jnp.tanh(jnp.einsum("bchw,cd->bdhw", xt, w)) * tt[:, None, None, None]
    t_fn = lambda xt, tt: torch.tanh(torch.einsum("bchw,cd->bdhw", xt, torch.from_numpy(w))) \
        * tt[:, None, None, None]
    for loss_mask in (None, mask):
        ref = j_mini.training_losses_mini(
            key, j_fn, jnp.asarray(x1),
            None if loss_mask is None else jnp.asarray(loss_mask))["loss"]
        got = t_mini.training_losses_mini(
            t_fn, torch.from_numpy(x1), None if loss_mask is None else torch.from_numpy(loss_mask),
            t=torch.from_numpy(t.copy()), x0=torch.from_numpy(x0.copy()))["loss"]
        _close(got, ref)
    drawn = t_mini.training_losses_mini(t_fn, torch.from_numpy(x1),
                                        generator=torch.Generator().manual_seed(0))["loss"]
    assert drawn.shape == (3,) and torch.isfinite(drawn).all()


def _tiny_sd3(**kw):
    return t_mmdit.MMDiT(**dict(patch_size=2, in_channels=16, dim=64, n_layers=2, n_heads=4,
                                pos_embed_max_size=12, pos_embed_base_size=4, **kw))


def test_sample_sd3_main_debug(tmp_path, monkeypatch):
    """--debug samples random weights from --seed with the debug towers: the
    saved latent equals MiniODE's sample on the same draws; a z=16 VAE file
    turns the outputs into PNGs; data.json resumes."""
    from test_torch_vae import diffusers_sd

    from lumina_t2x_tpu_torch.core.checkpoint import save_safetensors

    monkeypatch.setitem(t_models.MODELS, "MMDiT_SD3_Medium", _tiny_sd3)
    captions = tmp_path / "captions.txt"
    captions.write_text("a red fox\n\na cat on a mat\n")
    out = tmp_path / "out"
    argv = ["--caption_path", str(captions), "--image_save_path", str(out), "--resolution",
            "1:64x32", "--num_sampling_steps", "3", "--seed", "2", "--precision", "fp32",
            "--device", "cpu", "--debug"]
    info = sample_sd3.main(argv)
    assert [i["idx"] for i in info] == [0, 1] and info[1]["resolution"] == "64x32"
    lat = np.load(info[1]["path"])
    assert lat.shape == (16, 4, 8) and np.isfinite(lat).all()

    torch.manual_seed(2)
    model = _tiny_sd3().eval()
    enc = build_sd3_prompt_encoder(debug=True)
    ctx, pooled = enc.encode_cfg_pair("a cat on a mat")
    z = torch.randn((1, 16, 4, 8), generator=torch.Generator().manual_seed((2 << 20) + 1))
    with torch.no_grad():
        ref = t_mini.MiniODE(3, "euler", 3.0, use_sd3=True).sample(
            torch.cat([z, z]), lambda x, t: model(x, t, ctx, pooled), cfg_scale=7.0)[0]
    np.testing.assert_array_equal(lat, ref.numpy())

    assert sample_sd3.main(argv) == info  # everything collected: nothing sampled again

    vae_path = str(tmp_path / "vae.safetensors")
    vae_sd = diffusers_sd((1, 1, 1, 1), z=16, quant=False)
    save_safetensors({k: torch.from_numpy(v) for k, v in vae_sd.items()}, vae_path)
    png_out = tmp_path / "png"
    argv = ["--caption_path", str(captions), "--image_save_path", str(png_out), "--resolution",
            "1:64x64", "--num_sampling_steps", "2", "--precision", "fp32", "--device", "cpu",
            "--vae_ckpt", vae_path]
    info = sample_sd3.main(argv)
    assert all(i["path"].endswith(".png") and os.path.exists(i["path"]) for i in info)
    assert json.load(open(png_out / "data.json"))[0]["num_sampling_steps"] == 2
    with pytest.raises(SystemExit):
        sample_sd3.main(["--caption_path", str(tmp_path / "missing.txt"), "--device", "cpu"])

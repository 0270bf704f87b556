"""The port's image-to-image sampling (`pipelines/sample_lib.build_img2img_sample_fn`,
`pipelines/sample_img2img.py`) against the JAX package's: the trajectory
from the same noise and latent, the strength and step checks, the stand-in
latent, and the CLI on a tiny PNG with and without a VAE.

The tiny NextDiT of `test_torch_next_dit.py` (dim 64, 2 layers, 4 heads,
caption dim 32, qk-norm, weights perturbed by 0.02 * N(0, 1)), fp32 on the
CPU, inputs from numpy. Bar: atol 2e-4 / rtol 2e-3.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from lumina_t2x_tpu.pipelines import sample_lib as j_sl
from lumina_t2x_tpu.pipelines import sample_img2img as j_app
from lumina_t2x_tpu_torch.codecs.vae import pooled_latent_standin
from lumina_t2x_tpu_torch.core import checkpoint as t_ckpt
from lumina_t2x_tpu_torch.pipelines import sample_img2img as t_app
from lumina_t2x_tpu_torch.pipelines import sample_lib as t_sl

from test_torch_next_dit import _pair
from test_torch_vae import diffusers_sd

ATOL, RTOL = 2e-4, 2e-3


@pytest.mark.parametrize("strength,shift", [(0.6, 4.0), (1.0, None)])
def test_trajectory_matches_jax(strength, shift):
    """A 4-point midpoint trajectory, CFG 4, over the grid of [1 - strength,
    1]; JAX draws z from its rng and the port is handed the same z."""
    jmodel, params, tmodel = _pair()
    rng = np.random.default_rng(3)
    x1 = rng.standard_normal((1, 4, 8, 8)).astype(np.float32)
    cap = rng.standard_normal((2, 6, 32)).astype(np.float32)
    mask = np.ones((2, 6), np.int32)
    mask[1, 2:] = 0
    kw = dict(strength=strength, num_steps=4, cfg_scale=4.0, time_shifting_factor=shift)
    key = jax.random.PRNGKey(4)
    ref = jax.jit(j_sl.build_img2img_sample_fn(jmodel, **kw))(
        {"params": params}, key, *map(jnp.asarray, (x1, cap, mask)))
    z = np.array(jax.random.normal(key, x1.shape))
    fn = t_sl.build_img2img_sample_fn(tmodel, **kw)
    got = fn(*map(torch.from_numpy, (z, x1, cap, mask)))
    assert got.shape == x1.shape and fn.nfe == 6
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("kw,match", [(dict(strength=0.0), "strength"),
                                      (dict(strength=1.5), "strength"),
                                      (dict(num_steps=1), "num_steps")])
def test_strength_and_step_errors(kw, match):
    for build in (j_sl.build_img2img_sample_fn, t_sl.build_img2img_sample_fn):
        with pytest.raises(ValueError, match=match):
            build(None, **kw)


def test_stand_in_latent_matches_jax():
    """Without a VAE: the pixels average-pooled by 8, channel 0 repeated."""
    pixels = np.random.default_rng(5).uniform(-1, 1, (1, 3, 16, 24)).astype(np.float32)
    got = pooled_latent_standin(torch.from_numpy(pixels))
    pooled = pixels.reshape(1, 3, 2, 8, 3, 8).mean((3, 5))
    ref = np.concatenate([pooled, pooled[:, :1]], axis=1)
    assert got.shape == (1, 4, 2, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)


@pytest.fixture()
def image(tmp_path):
    rng = np.random.default_rng(6)
    path = tmp_path / "in.png"
    Image.fromarray(rng.integers(0, 256, (80, 96, 3), dtype=np.uint8)).save(path)
    return str(path)


def _cli(tmp_path, image, *extra):
    return t_app.main(["--model", "NextDiT_Tiny_patch2", "--image_path", image,
                       "--caption", "a fox", "--image_size", "64", "--num_sampling_steps", "3",
                       "--device", "cpu", "--precision", "fp32",
                       "--image_save_path", str(tmp_path / "out"), *extra])


def test_cli_without_vae(tmp_path, image):
    """The stand-in latent of the 64^2 center crop; the .npy latent and the
    manifest, as JAX's CLI writes them."""
    manifest = _cli(tmp_path, image)
    out = np.load(manifest["output"])
    assert manifest["output"].endswith("img2img.npy") and out.shape == (1, 4, 8, 8)
    assert np.isfinite(out).all() and manifest["nfe"] == 4
    assert manifest["static_max"] is None  # 16 tokens: nothing streams
    with open(tmp_path / "out" / "data.json") as f:
        assert json.load(f)["args"]["strength"] == 0.6
    assert set(vars(j_app.parse_args(["--image_path", image]))) <= set(manifest["args"])


def test_cli_with_vae(tmp_path, image):
    """The tiny VAE encodes the crop (posterior noise from --seed) and
    decodes the result to a 64x64 PNG."""
    vae = str(tmp_path / "vae.safetensors")
    t_ckpt.save_safetensors({k: torch.from_numpy(v) for k, v in
                             diffusers_sd((1, 1, 2, 2), seed=4).items()}, vae)
    manifest = _cli(tmp_path, image, "--vae_ckpt", vae, "--strength", "0.8")
    png = np.asarray(Image.open(manifest["output"]))
    assert manifest["output"].endswith("img2img.png") and png.shape == (64, 64, 3)
    assert manifest["encode_ms"] > 0 and png.std() > 0

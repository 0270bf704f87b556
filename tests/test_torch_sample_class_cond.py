"""The port's sampler CLI (`lumina_t2x_tpu_torch/pipelines/sample.py`): the
class-conditional branch, the VAE outputs of both branches, the FID npz and
`--pixel_space`, on the CPU with the Tiny NextDiT-ImageNet and a tiny
factor-8 VAE (`tests/test_torch_vae.py`'s diffusers-layout state dict, whose
architecture `load_vae` reads off the file). PNGs are held against the JAX
package's `decode_from_latent` of the same latents, converted as the JAX
sampler converts, within one level of 255.
"""

import functools
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from lumina_t2x_tpu.codecs import vae as jv
from lumina_t2x_tpu.pipelines import sample as j_sample
from lumina_t2x_tpu_torch.core import checkpoint as t_ckpt
from lumina_t2x_tpu_torch.models import get_model
from lumina_t2x_tpu_torch.pipelines import sample as t_sample
from lumina_t2x_tpu_torch.pipelines import sample_lib as t_sl

from test_torch_next_dit_imagenet import _pair
from test_torch_vae import diffusers_sd

VAE_MULT = (1, 1, 2, 2)  # factor 8, as the sampler's latents assume


def _argv(out_dir, *extra):
    return ["--device", "cpu", "--precision", "fp32", "--num_sampling_steps", "3",
            "--image_save_path", str(out_dir), *extra]


@pytest.fixture(scope="module")
def tiny_vae(tmp_path_factory):
    """(path of a tiny VAE's .safetensors, the JAX VAE's jitted decode of
    `decode_from_latent` -> the JAX sampler's uint8 HWC images)."""
    sd = diffusers_sd(VAE_MULT, seed=12)
    path = str(tmp_path_factory.mktemp("vae") / "vae.safetensors")
    t_ckpt.save_safetensors({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    jmodel = jv.AutoencoderKL(ch=32, ch_mult=VAE_MULT, num_res_blocks=1)
    variables = {"params": jv.import_autoencoder_kl_weights(sd, ch_mult=VAE_MULT,
                                                            num_res_blocks=1, ch=32)}
    decode = jax.jit(functools.partial(jv.decode_from_latent, jmodel, vae_type="ema"))

    def to_uint8(latents):
        img = np.asarray(decode(variables, jnp.asarray(latents)))
        return np.clip((img + 1) / 2 * 255, 0, 255).astype(np.uint8).transpose(0, 2, 3, 1)

    return path, to_uint8


@pytest.fixture(scope="module")
def imagenet_ckpt(tmp_path_factory):
    """A port checkpoint of the randomised Tiny NextDiT-ImageNet, with its
    model_args, and the model."""
    model = _pair()[2]
    path = t_ckpt.save_weights(str(tmp_path_factory.mktemp("ckpt") / "ckpt"), model.state_dict(),
                               {"model": "NextDiT_ImageNet_Tiny_patch2"})
    return path, model


def _png(path):
    with open(path, "rb") as f:
        return np.asarray(Image.open(io.BytesIO(f.read())))


def test_defaults_are_the_jax_samplers():
    """The flags both CLIs have default alike: the 600M ImageNet model at
    256^2, the ema VAE scale, no labels."""
    ours, theirs = vars(t_sample.parse_args([])), vars(j_sample.parse_args([]))
    shared = sorted(set(ours) & set(theirs))
    assert {"model", "resolution", "labels", "vae", "vae_ckpt", "num_fid_samples",
            "batch_size", "pixel_space", "num_classes"} <= set(shared)
    assert {k: ours[k] for k in shared} == {k: theirs[k] for k in shared}
    assert ours["model"] == "NextDiT_ImageNet_600M_patch2" and ours["resolution"] == ["1:256x256"]


def test_class_cond_latents_equal_the_sample_fn(tmp_path, imagenet_ckpt):
    """`--ckpt` picks the model from its model_args; the `.npy` latents equal
    `build_class_cond_sample_fn` over the same weights and the noise drawn
    from `--seed`."""
    ckpt, model = imagenet_ckpt
    manifest = t_sample.main(_argv(tmp_path, "--ckpt", ckpt, "--labels", "5,42,1",
                                   "--resolution", "1:64x64"))
    assert manifest["args"]["model"] == "NextDiT_ImageNet_Tiny_patch2"
    assert [item["name"] for item in manifest["items"]] == ["5", "42", "1"]
    got = np.stack([np.load(item["path"]) for item in manifest["items"]])
    assert manifest["items"][0]["path"].endswith("5_.npy")
    z = torch.randn((3, 4, 8, 8), generator=torch.Generator("cpu").manual_seed(0))
    fn = t_sl.build_class_cond_sample_fn(model, num_steps=3, solver="midpoint", cfg_scale=4.0,
                                         latent_size=8)
    np.testing.assert_array_equal(got, fn(z, torch.tensor([5, 42, 1])).numpy())
    with open(tmp_path / "data.json") as f:
        assert len(json.load(f)["items"]) == 3


@pytest.mark.parametrize("branch", ["class-cond", "t2i"])
def test_vae_png_matches_jax_decode(tmp_path, tiny_vae, imagenet_ckpt, branch):
    """`--vae_ckpt` writes PNGs equal, within one level, to the JAX
    package's decode of the latents the same run writes without a VAE."""
    vae_path, jax_uint8 = tiny_vae
    if branch == "class-cond":
        extra = ["--ckpt", imagenet_ckpt[0], "--labels", "3,7", "--resolution", "1:64x64"]
        tag = "_"
    else:
        extra = ["--model", "NextDiT_Tiny_patch2", "--debug", "--cap_feat_dim", "32",
                 "--resolution", "1:64x48"]
        tag = "_64x48"
    latents = t_sample.main(_argv(tmp_path / "npy", *extra))
    pngs = t_sample.main(_argv(tmp_path / "png", *extra, "--vae_ckpt", vae_path))
    assert all(item["path"].endswith(f"{tag}.png") for item in pngs["items"])
    got = np.stack([_png(item["path"]) for item in pngs["items"]])
    ref = jax_uint8(np.stack([np.load(item["path"]) for item in latents["items"]]))
    assert got.shape == ref.shape == ((2, 64, 64, 3) if branch == "class-cond" else (1, 48, 64, 3))
    assert np.abs(got.astype(np.int32) - ref.astype(np.int32)).max() <= 1


@pytest.mark.parametrize("decoded", [True, False])
def test_fid_npz(tmp_path, tiny_vae, imagenet_ckpt, decoded):
    """`--num_fid_samples 5 --batch_size 2`: three trajectories over labels
    drawn from `--seed`; `arr_0` the uint8 images through the VAE, or the
    float32 latents without one; `arr_1` the labels."""
    extra = ["--vae_ckpt", tiny_vae[0]] if decoded else []
    manifest = t_sample.main(_argv(tmp_path, "--ckpt", imagenet_ckpt[0], "--resolution",
                                   "1:64x64", "--num_fid_samples", "5", "--batch_size", "2",
                                   "--seed", "3", *extra))
    (item,) = manifest["items"]
    assert item["n"] == 5
    data = np.load(item["fid_npz"])
    rng = np.random.default_rng(3)
    labels = np.concatenate([rng.integers(0, 1000, (2,)) for _ in range(3)])[:5]
    np.testing.assert_array_equal(data["arr_1"], labels)
    if decoded:
        assert data["arr_0"].shape == (5, 64, 64, 3) and data["arr_0"].dtype == np.uint8
        assert item["fid_npz"].endswith("samples_5x64x64.npz")
    else:
        assert data["arr_0"].shape == (5, 4, 8, 8) and data["arr_0"].dtype == np.float32


def test_pixel_space_png(tmp_path):
    """`--pixel_space`: the model denoises RGB pixels, written as PNGs with
    the sampler's conversion and no VAE."""
    manifest = t_sample.main(_argv(tmp_path, "--model", "NextDiT_ImageNet_Tiny_patch2",
                                   "--debug", "--pixel_space", "--labels", "9",
                                   "--resolution", "1:16x16"))
    (item,) = manifest["items"]
    torch.manual_seed(0)
    model = get_model("NextDiT_ImageNet_Tiny_patch2", in_channels=3).eval()
    z = torch.randn((1, 3, 16, 16), generator=torch.Generator("cpu").manual_seed(0))
    fn = t_sl.build_class_cond_sample_fn(model, num_steps=3, latent_size=16, in_channels=3)
    ref = np.clip((fn(z, torch.tensor([9])).numpy() + 1) / 2 * 255, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(_png(item["path"]), ref[0].transpose(1, 2, 0))


def test_ckpt_model_args_set_num_classes_and_pixel_space(tmp_path):
    """A checkpoint whose model_args record `num_classes` and `pixel_space`
    samples a pixel-space model of that many classes with no flag given."""
    model = get_model("NextDiT_ImageNet_Tiny_patch2", in_channels=3, num_classes=10)
    ckpt = t_ckpt.save_weights(str(tmp_path / "ckpt"), model.state_dict(),
                               {"model": "NextDiT_ImageNet_Tiny_patch2", "num_classes": 10,
                                "pixel_space": True})
    manifest = t_sample.main(_argv(tmp_path / "out", "--ckpt", ckpt, "--labels", "1,9",
                                   "--resolution", "1:16x16"))
    assert manifest["args"]["num_classes"] == 10 and manifest["args"]["pixel_space"]
    assert [_png(item["path"]).shape for item in manifest["items"]] == [(16, 16, 3)] * 2
    with pytest.raises(SystemExit, match="class-conditional"):
        t_sample.main(_argv(tmp_path / "t2i", "--model", "NextDiT_Tiny_patch2", "--debug",
                            "--pixel_space"))

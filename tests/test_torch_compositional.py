"""The port's region-controlled compositional NextDiT
(`lumina_t2x_tpu_torch/models/compositional.py`) and its app
(`pipelines/compositional_app.py`) against the JAX package's: the region
mask, the forward at 1x2 and 2x2 splits, the CFG wrapper, the trajectory,
and the app's `main`.

A tiny config (dim 64, 2 layers, 4 heads, caption dim 32, qk-norm), fp32 on
the CPU, inputs from numpy, weights carried by NextDiT's bridge
(`core/checkpoint.state_dict_from_jax_params`) and perturbed by
0.02 * N(0, 1) so the zero-init layers do not zero the output. The JAX model
runs `attn_impl="xla"`. Bar: atol 2e-4 / rtol 2e-3.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from lumina_t2x_tpu.models import compositional as j_comp
from lumina_t2x_tpu.models import get_model as j_get_model
from lumina_t2x_tpu.pipelines import compositional_app as j_app
from lumina_t2x_tpu_torch import models as t_models
from lumina_t2x_tpu_torch.core import checkpoint as t_ckpt
from lumina_t2x_tpu_torch.core.checkpoint import state_dict_from_jax_params
from lumina_t2x_tpu_torch.models import compositional as t_comp
from lumina_t2x_tpu_torch.models import next_dit as t_nd
from lumina_t2x_tpu_torch.pipelines import compositional_app as t_app
from lumina_t2x_tpu_torch.utils import hashed_caption_features

from test_torch_vae import diffusers_sd

ATOL, RTOL = 2e-4, 2e-3
TINY = dict(patch_size=2, dim=64, n_layers=2, n_heads=4, multiple_of=16, cap_feat_dim=32,
            qk_norm=True)


@pytest.mark.parametrize("split", [(1, 4), (2, 2), (3, 1)])
def test_region_mask_matches_jax(split):
    num_y = split[0] * split[1] + 1
    ref = np.asarray(j_comp.build_region_mask(num_y, 6, 8, *split))
    got = t_comp.build_region_mask(num_y, 6, 8, *split)
    assert got.dtype == torch.bool and got.shape == (num_y, 48)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got[-1].all()


@functools.lru_cache(maxsize=None)
def _pair():
    jmodel = j_comp.NextDiTCompositional(attn_impl="xla", **TINY)
    variables = jax.jit(jmodel.init, static_argnames=("h_split_num", "w_split_num"))(
        jax.random.PRNGKey(2), jnp.zeros((2, 4, 8, 8)), jnp.zeros((2,)), jnp.zeros((3, 5, 32)),
        jnp.ones((3, 5), jnp.int32), jnp.zeros((2, 5, 32)), jnp.ones((2, 5), jnp.int32),
        h_split_num=1, w_split_num=2)
    flat = traverse_util.flatten_dict(jax.tree.map(np.asarray, variables["params"]))
    rng = np.random.default_rng(2)
    params = traverse_util.unflatten_dict(
        {k: (v + 0.02 * rng.standard_normal(v.shape)).astype(np.float32) for k, v in flat.items()})
    tmodel = t_comp.NextDiTCompositional(**TINY).eval()
    tmodel.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return jmodel, params, tmodel


def _captions(seed, num_y, ly=7):
    rng = np.random.default_rng(seed)
    cap = rng.standard_normal((num_y, ly, 32)).astype(np.float32)
    mask = np.ones((num_y, ly), np.int32)
    mask[0, 5:] = 0
    gcap = rng.standard_normal((2, ly, 32)).astype(np.float32)
    gmask = np.ones((2, ly), np.int32)
    gmask[1, 2:] = 0
    return cap, mask, gcap, gmask


@pytest.mark.parametrize("split", [(1, 2), (2, 2)])
def test_forward_matches_jax(split):
    jmodel, params, tmodel = _pair()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    t = rng.uniform(0, 1, 2).astype(np.float32)
    caps = _captions(4, split[0] * split[1] + 1)
    kw = dict(h_split_num=split[0], w_split_num=split[1])
    ref = jax.jit(functools.partial(jmodel.apply, **kw))(
        {"params": params}, *map(jnp.asarray, (x, t, *caps)))
    with torch.no_grad():
        got = tmodel(*map(torch.from_numpy, (x, t, *caps)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_forward_with_cfg_matches_jax():
    """The RoPE timestep is t[0]; a watershed and scale factor make it count."""
    jmodel, params, tmodel = _pair()
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    t = np.full(2, 0.2, np.float32)
    caps = _captions(6, 3)
    kw = dict(h_split_num=1, w_split_num=2, scale_factor=2.0, scale_watershed=0.3,
              proportional_attn=True, base_seqlen=4)
    ref = jax.jit(functools.partial(j_comp.forward_with_cfg, jmodel, cfg_scale=4.0, **kw))(
        {"params": params}, *map(jnp.asarray, (x, t, caps[0], caps[1])),
        global_cap_feats=jnp.asarray(caps[2]), global_cap_mask=jnp.asarray(caps[3]))
    with torch.no_grad():
        got = t_comp.forward_with_cfg(tmodel, *map(torch.from_numpy, (x, t, caps[0], caps[1])),
                                      4.0, global_cap_feats=torch.from_numpy(caps[2]),
                                      global_cap_mask=torch.from_numpy(caps[3]), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(got[0, :3].numpy(), got[1, :3].numpy())


def test_trajectory_matches_jax():
    """A 3-point midpoint trajectory at a 1x2 split; z from JAX's rng."""
    jmodel, params, tmodel = _pair()
    cap, mask, gcap, gmask = _captions(7, 3)
    kw = dict(h_split_num=1, w_split_num=2, num_steps=3, cfg_scale=4.0)
    key = jax.random.PRNGKey(8)
    ref = jax.jit(j_app.build_compositional_sample_fn(jmodel, latent_h=8, latent_w=8, **kw))(
        {"params": params}, key, *map(jnp.asarray, (cap, mask, gcap, gmask)))
    z = np.array(jax.random.normal(key, (1, 4, 8, 8)))
    fn = t_app.build_compositional_sample_fn(tmodel, **kw)
    got = fn(*map(torch.from_numpy, (z, cap, mask, gcap, gmask)))
    assert got.shape == (1, 4, 8, 8) and fn.nfe == 4
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_nextdit_2b_weights_load_unchanged():
    """The registry's compositional 2B has NextDiT-2B's names and shapes
    (meta device) and JAX's parameter count."""
    comp = t_models.get_model("NextDiT_2B_patch2_Compositional", qk_norm=True, device="meta")
    plain = t_nd.NextDiT_2B_patch2(qk_norm=True, cap_feat_dim=2048, device="meta")
    assert {k: v.shape for k, v in comp.state_dict().items()} == \
        {k: v.shape for k, v in plain.state_dict().items()}
    jmodel = j_get_model("NextDiT_2B_patch2_Compositional", qk_norm=True)
    shapes = jax.eval_shape(
        functools.partial(jmodel.init, h_split_num=1, w_split_num=1), jax.random.PRNGKey(0),
        jnp.zeros((2, 4, 8, 8)), jnp.zeros((2,)), jnp.zeros((2, 4, 2048)),
        jnp.ones((2, 4), jnp.int32), jnp.zeros((2, 4, 2048)), jnp.ones((2, 4), jnp.int32))
    assert sum(p.numel() for p in comp.parameters()) == sum(
        int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))


def test_app_main_with_explicit_features(tmp_path, monkeypatch):
    """`main` on the tiny model (2048-wide captions, as the app encodes
    them): its latent equals the sample function's on the hashed features of
    the region, negative and global captions and the noise of --seed; with
    `--vae_ckpt` it also writes the decoded PNG."""
    def tiny(**kw):  # zero-init layers perturbed, or the latent would be the noise
        model = t_comp.NextDiTCompositional(**{**kw, **TINY, "cap_feat_dim": 2048})
        g = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for p in model.parameters():
                p.add_(0.02 * torch.randn(p.shape, generator=g))
        return model

    monkeypatch.setattr(t_app, "NextDiT_2B_patch2_Compositional", tiny)
    vae = str(tmp_path / "vae.safetensors")
    t_ckpt.save_safetensors({k: torch.from_numpy(v) for k, v in
                             diffusers_sd((1, 1, 2, 2), seed=3).items()}, vae)
    regions = ["a red fox", "a frozen lake"]
    argv = ["--region_prompts", *regions, "--global_prompt", "a winter landscape",
            "--h_split_num", "1", "--w_split_num", "2", "--resolution", "64x64",
            "--num_sampling_steps", "3", "--seed", "5", "--debug", "--device", "cpu",
            "--image_save_path", str(tmp_path / "out"), "--vae_ckpt", vae]
    manifest = t_app.main(argv)
    got = np.load(manifest["output"])
    with open(tmp_path / "out" / "data.json") as f:
        assert json.load(f)["args"]["region_prompts"] == regions
    with open(manifest["png"], "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"

    feats = lambda caps: torch.from_numpy(np.stack([hashed_caption_features(c, 2048)
                                                    for c in caps]))
    cap, gcap = feats(regions + [t_app.NEGATIVE_CAP]), feats(["a winter landscape",
                                                              t_app.NEGATIVE_CAP])
    torch.manual_seed(5)
    model = t_app.NextDiT_2B_patch2_Compositional(qk_norm=True, dtype=torch.float32).eval()
    z = torch.randn((1, 4, 8, 8), generator=torch.Generator().manual_seed(5))
    ref = t_app.build_compositional_sample_fn(model, h_split_num=1, w_split_num=2,
                                              num_steps=3)(
        z, cap, torch.ones(3, 32, dtype=torch.int32), gcap, torch.ones(2, 32, dtype=torch.int32))
    assert got.shape == (1, 4, 8, 8) and np.isfinite(got).all()
    assert not np.allclose(got, z.numpy(), atol=1e-3)
    np.testing.assert_array_equal(got, ref.numpy())
    with pytest.raises(SystemExit, match="3 region prompts"):
        t_app.main(argv[:3] + ["a third"] + argv[3:])

"""The port's visual anagrams (`lumina_t2x_tpu_torch/pipelines/anagrams.py`,
`anagrams_app.py`) and the NextDiT `kv_merge` branch against the JAX
package's: every view of `VIEW_MAP` and its inverse, the blur at kernels
wider than the image, `pool_kv_2d` and the kv_merge forward, the
`jax.image.resize` resampling (bicubic 32 -> 256 and non-square, the
antialiased linear downsample, nearest), both phases and the two-phase
`generate_anagram` on a tiny NextDiT, the tiled VAE, and the app's `main`
with `--debug`.

A tiny NextDiT (dim 64, 2 layers, 4 heads, caption dim 32, qk-norm), fp32
on the CPU, inputs from numpy, weights carried by NextDiT's bridge and
perturbed by 0.02 * N(0, 1). The JAX model runs `attn_impl="xla"`; the
port's runs the flash entry points' plain versions. Bar: atol 2e-4 /
rtol 2e-3.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from lumina_t2x_tpu.models import next_dit as j_nd
from lumina_t2x_tpu.ops.attention import pool_kv_2d as j_pool_kv_2d
from lumina_t2x_tpu.pipelines import anagrams as j_ana
from lumina_t2x_tpu.pipelines import anagrams_app as j_app
from lumina_t2x_tpu.transport.solvers import time_shift as j_time_shift
from lumina_t2x_tpu_torch import models as t_models
from lumina_t2x_tpu_torch.core.checkpoint import state_dict_from_jax_params
from lumina_t2x_tpu_torch.models import next_dit as t_nd
from lumina_t2x_tpu_torch.ops.attention import pool_kv_2d as t_pool_kv_2d
from lumina_t2x_tpu_torch.pipelines import anagrams as t_ana
from lumina_t2x_tpu_torch.pipelines import anagrams_app as t_app
from lumina_t2x_tpu_torch.pipelines import sample_lib as t_sample_lib

ATOL, RTOL = 2e-4, 2e-3
TINY = dict(patch_size=2, dim=64, n_layers=2, n_heads=4, multiple_of=16, cap_feat_dim=32,
            qk_norm=True)


def _close(got, ref, **kw):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(ref, np.float32),
                               **{"atol": ATOL, "rtol": RTOL, **kw})


@pytest.mark.parametrize("name", sorted(j_ana.VIEW_MAP))
def test_view_and_inverse_match_jax(name):
    x = np.random.default_rng(0).standard_normal((4, 32, 32)).astype(np.float32)
    jview, tview = j_ana.VIEW_MAP[name](), t_ana.VIEW_MAP[name]()
    xt = torch.from_numpy(x)
    _close(tview.view(xt), jview.view(jnp.asarray(x)))
    _close(tview.inverse_view(xt), jview.inverse_view(jnp.asarray(x)))
    _close(tview.inverse_view(tview.view(xt)), jview.inverse_view(jview.view(jnp.asarray(x))))


def test_view_factory_and_save_view():
    assert sorted(t_ana.VIEW_MAP) == sorted(j_ana.VIEW_MAP)
    views = t_ana.get_anagrams_views(["identity", "skew", "patch_permute"], [None, 2.0, 4])
    assert views[1].skew_factor == 2.0 and views[2].num_patches == 4
    with pytest.raises(NotImplementedError):
        t_ana.get_anagrams_views(["nope"])
    x = np.random.default_rng(1).standard_normal((3, 64, 64)).astype(np.float32)
    _close(t_ana.MotionBlurView().save_view(torch.from_numpy(x)),
           j_ana.MotionBlurView().save_view(jnp.asarray(x)))


@pytest.mark.parametrize("size,kernel", [(8, 33), (5, 9), (64, 67)])
def test_gaussian_blur_reflect_matches_jax(size, kernel):
    """Reflect padding wider than the image repeats the reflection, as numpy's."""
    x = np.random.default_rng(size).standard_normal((3, size, size + 3)).astype(np.float32)
    _close(t_ana.gaussian_blur(torch.from_numpy(x), 2.0, kernel),
           j_ana.gaussian_blur(jnp.asarray(x), 2.0, kernel))


@pytest.mark.parametrize("src,dst,method", [
    ((1, 3, 32, 32), (1, 3, 256, 256), "bicubic"),
    ((1, 3, 20, 28), (1, 3, 48, 72), "bicubic"),
    ((2, 4, 24, 40), (2, 4, 3, 5), "linear"),
    ((1, 3, 6, 5), (1, 3, 48, 40), "nearest"),
])
def test_image_resize_matches_jax(src, dst, method):
    x = np.random.default_rng(3).standard_normal(src).astype(np.float32)
    _close(t_ana.image_resize(torch.from_numpy(x), dst, method),
           jax.image.resize(jnp.asarray(x), dst, method=method), atol=1e-5)


def test_bicubic_differs_from_torch_interpolate():
    """torch's bicubic (a = -0.75, clamped borders) is another function."""
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((1, 3, 16, 16))
                         .astype(np.float32))
    ours = t_ana.image_resize(x, (1, 3, 64, 64), "bicubic")
    theirs = torch.nn.functional.interpolate(x, size=(64, 64), mode="bicubic")
    assert (ours - theirs).abs().max() > 1e-2


@pytest.mark.parametrize("grid,r", [((6, 8), 2), ((7, 9), 2), ((6, 6), 3), ((4, 4), 1)])
def test_pool_kv_2d_matches_jax(grid, r):
    rng = np.random.default_rng(5)
    k, v = (rng.standard_normal((2, grid[0] * grid[1], 3, 8)).astype(np.float32)
            for _ in range(2))
    got = t_pool_kv_2d(torch.from_numpy(k), torch.from_numpy(v), *grid, r)
    ref = j_pool_kv_2d(jnp.asarray(k), jnp.asarray(v), *grid, r)
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        _close(a, b)


@functools.lru_cache(maxsize=None)
def _pair():
    jmodel = j_nd.NextDiT(attn_impl="xla", **TINY)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(2), jnp.zeros((2, 4, 8, 8)),
                                     jnp.zeros((2,)), jnp.zeros((2, 5, 32)),
                                     jnp.ones((2, 5), jnp.int32))
    flat = traverse_util.flatten_dict(jax.tree.map(np.asarray, variables["params"]))
    rng = np.random.default_rng(2)
    params = traverse_util.unflatten_dict(
        {k: (v + 0.02 * rng.standard_normal(v.shape)).astype(np.float32) for k, v in flat.items()})
    tmodel = t_nd.NextDiT(**TINY).eval()
    tmodel.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return jmodel, {"params": params}, tmodel


def _captions(seed, ly=7):
    rng = np.random.default_rng(seed)
    cap = rng.standard_normal((2, ly, 32)).astype(np.float32)
    mask = np.ones((2, ly), np.int32)
    mask[1, 3:] = 0
    return cap, mask


@pytest.mark.parametrize("kw", [
    dict(kv_merge_ratio=2),
    dict(kv_merge_ratio=2, proportional_attn=True, base_seqlen=4, attn_scale_variant="anagram",
         scale_factor=2.0, scale_watershed=0.3),
    dict(kv_merge_ratio=4),
])
def test_kv_merge_forward_with_cfg_matches_jax(kw):
    jmodel, variables, tmodel = _pair()
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    t = np.full(2, 0.3, np.float32)
    cap, mask = _captions(7)
    ref = j_nd.forward_with_cfg(jmodel, variables, *map(jnp.asarray, (x, t, cap, mask)), 4.0,
                                **kw)
    with torch.no_grad():
        got = t_nd.forward_with_cfg(tmodel, *map(torch.from_numpy, (x, t, cap, mask)), 4.0, **kw)
    _close(got, ref)
    with torch.no_grad():  # the pooling changes the output
        plain = t_nd.forward_with_cfg(tmodel, *map(torch.from_numpy, (x, t, cap, mask)), 4.0,
                                      **dict(kw, kv_merge_ratio=1))
    assert (plain - got).abs().max() > 1e-4


def test_kv_merge_masked_pool_and_bad_ratio():
    """A pooled key is valid if any key of its window is (the layer's mask
    path), and a ratio that does not divide the grid is refused."""
    _, _, tmodel = _pair()
    layer = tmodel.layers[0].attention
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((1, 16, 64)).astype(np.float32))
    mask = torch.ones(1, 16, dtype=torch.int32)
    mask[0, :2] = 0  # half of the first 2x2 window
    with torch.no_grad():
        merged = layer(x, mask, None, kv_merge=(4, 4, 2))
        full = layer(x, torch.ones(1, 16, dtype=torch.int32), None, kv_merge=(4, 4, 2))
    _close(merged, full)
    cap, cmask = _captions(9)
    with pytest.raises(ValueError):
        tmodel(torch.zeros(2, 4, 6, 6), torch.zeros(2), torch.from_numpy(cap),
               torch.from_numpy(cmask), kv_merge_ratio=2)


def _fns(cap, mask, **kw):
    jmodel, variables, tmodel = _pair()
    jfn = lambda x, t: j_nd.forward_with_cfg(jmodel, variables, x, t, jnp.asarray(cap),
                                             jnp.asarray(mask), 4.0, **kw)
    tfn = lambda x, t: t_nd.forward_with_cfg(tmodel, x, t, torch.from_numpy(cap),
                                             torch.from_numpy(mask), 4.0, **kw)
    return jfn, tfn


def _grid(n):
    return j_time_shift(jnp.linspace(0.0, 1.0, n), 4.0)


@pytest.mark.parametrize("views", [("identity", "rotate_180"), ("flip", "negate")])
def test_init_phase_matches_jax(views):
    caps = [_captions(10), _captions(11)]
    pairs = [_fns(c, m, kv_merge_ratio=2) for c, m in caps]
    z = np.random.default_rng(12).standard_normal((1, 4, 8, 8)).astype(np.float32)
    z = np.concatenate([z, z])
    ts = _grid(4)
    ref = j_ana.anagram_init_phase([p[0] for p in pairs], j_ana.get_anagrams_views(views),
                                   jnp.asarray(z), ts)
    with torch.no_grad():
        got = t_ana.anagram_init_phase([p[1] for p in pairs], t_ana.get_anagrams_views(views),
                                       torch.from_numpy(z), torch.from_numpy(np.asarray(ts)))
    _close(got, ref)


def test_upscale_phase_matches_jax():
    views = ("identity", "rotate_cw")
    kw = dict(proportional_attn=True, base_seqlen=4, attn_scale_variant="anagram",
              scale_factor=2.0, scale_watershed=0.3, kv_merge_ratio=2)
    caps = [_captions(13), _captions(14)]
    pairs = [_fns(c, m, **kw) for c, m in caps]
    rng = np.random.default_rng(15)
    z = np.repeat(rng.standard_normal((1, 4, 8, 8)).astype(np.float32), 2, 0)
    guidance = np.repeat(rng.standard_normal((1, 4, 8, 8)).astype(np.float32), 2, 0)
    ts = _grid(4)
    ref = j_ana.anagram_upscale_phase([p[0] for p in pairs], j_ana.get_anagrams_views(views),
                                      jnp.asarray(z), jnp.asarray(guidance), ts)
    with torch.no_grad():
        got = t_ana.anagram_upscale_phase([p[1] for p in pairs], t_ana.get_anagrams_views(views),
                                          torch.from_numpy(z), torch.from_numpy(guidance),
                                          torch.from_numpy(np.asarray(ts)))
    _close(got, ref)


def _jax_debug_vae():
    def decode(z):
        return jax.image.resize(z[:, :3].astype(jnp.float32),
                                (z.shape[0], 3, z.shape[2] * 8, z.shape[3] * 8), method="nearest")

    def encode(img):
        b, c, h, w = img.shape
        z = img.reshape(b, c, h // 8, 8, w // 8, 8).mean((3, 5))
        return jnp.concatenate([z, z[:, :1]], axis=1)

    return encode, decode


@pytest.mark.parametrize("kv_merge_ratio", [1, 2])
def test_generate_anagram_two_phases_match_jax(kv_merge_ratio):
    """Phase 1 at 8^2 latents, the bicubic upsample to 128^2 pixels, the
    tiled re-encode and phase 2 at 16^2 (time-aware RoPE scaling past
    train_res), with the JAX draws handed to the port as tensors."""
    jmodel, variables, tmodel = _pair()
    caps = [_captions(16), _captions(17)]
    views = ("identity", "rotate_180")
    kw = dict(num_steps=3, cfg_scale=4.0, time_shifting_factor=4.0, proportional_attn=True,
              scale_watershed=0.3, kv_merge_ratio=kv_merge_ratio, train_res=64)
    j_enc, j_dec = _jax_debug_vae()
    # JAX takes base_seqlen and overwrites it in phase 2; the port has no such argument
    ref1, ref2 = j_app.generate_anagram(
        jmodel, variables, [jnp.asarray(c) for c, _ in caps], [jnp.asarray(m) for _, m in caps],
        j_ana.get_anagrams_views(views), base_latent=8, seed=3, upscale_latent=16,
        vae_encode_fn=j_enc, vae_decode_fn=j_dec, base_seqlen=16, **kw)
    rng = jax.random.PRNGKey(3)
    z = np.asarray(jax.random.normal(rng, (1, 4, 8, 8)))
    z2 = np.asarray(jax.random.normal(jax.random.fold_in(rng, 1), (1, 4, 16, 16)))
    t_enc, t_dec = t_app._debug_vae()
    got1, got2, info = t_app.generate_anagram(
        tmodel, [torch.from_numpy(c) for c, _ in caps], [torch.from_numpy(m) for _, m in caps],
        t_ana.get_anagrams_views(views), z=torch.from_numpy(z), z2=torch.from_numpy(z2),
        vae_encode_fn=t_enc, vae_decode_fn=t_dec, **kw)
    _close(got1, ref1)
    _close(got2, ref2)
    assert info["static_max"] is None  # 256 tokens: nothing streams


def test_calibration_under_anagram_scale_and_kv_merge():
    """The probe takes the anagram scale; pooled keys that no longer stream
    leave nothing to record (as the JAX probe)."""
    _, _, tmodel = _pair()
    cap, mask = map(torch.from_numpy, _captions(18))
    kw = dict(width=544, height=544, train_res=256, num_probe_steps=2,
              generator=torch.Generator().manual_seed(0))
    bound = t_sample_lib.autocalibrate_flash_static_max(
        tmodel, cap, mask, attn_scale_variant="anagram", **kw)
    other = t_sample_lib.autocalibrate_flash_static_max(tmodel, cap, mask, **kw)
    assert bound is not None and np.isfinite(bound) and bound != other
    assert t_sample_lib.autocalibrate_flash_static_max(
        tmodel, cap, mask, attn_scale_variant="anagram", kv_merge_ratio=2, **kw) is None


def test_tiled_vae_matches_jax():
    rng = np.random.default_rng(19)
    img = rng.standard_normal((1, 3, 40, 56)).astype(np.float32)
    lat = rng.standard_normal((1, 4, 5, 7)).astype(np.float32)
    j_enc, j_dec = _jax_debug_vae()
    t_enc, t_dec = t_app._debug_vae()
    assert t_ana.get_tile_views(40, 56, 16, 8) == j_ana.get_tile_views(40, 56, 16, 8)
    _close(t_ana.tiled_encode(t_enc, torch.from_numpy(img), window=16, stride=8),
           j_ana.tiled_encode(j_enc, jnp.asarray(img), window=16, stride=8))
    _close(t_ana.tiled_decode(t_dec, torch.from_numpy(lat), window=2, stride=1),
           j_ana.tiled_decode(j_dec, jnp.asarray(lat), window=2, stride=1))
    # windows larger than the image: one tile
    _close(t_ana.tiled_encode(t_enc, torch.from_numpy(img)), j_enc(jnp.asarray(img)))


def test_app_main_debug(tmp_path, monkeypatch):
    """`main --debug` on a shrunk registry entry: phase 1, the stand-in
    upsample and phase 2, one PNG per view and phase, and the saved latents
    equal `generate_anagram` on the same draws; then the GIF morph."""
    monkeypatch.setitem(t_models.MODELS, "NextDiT_2B_patch2",
                        lambda **kw: t_nd.NextDiT(**dict(TINY, **kw)))
    argv = ["--prompts", "a cat", "a dog", "--views", "identity", "flip", "--base_res", "64",
            "--resolution", "128", "--num_inference_steps", "3", "--kv_merge_ratio", "2",
            "--save_dir", str(tmp_path), "--seed", "5", "--device", "cpu", "--debug"]
    manifest = t_app.main(argv)
    assert len(manifest["paths"]) == 4 and all(os.path.exists(p) for p in manifest["paths"])
    data = json.load(open(os.path.join(tmp_path, "illusion", "0005", "data.json")))
    assert data["static_max"] is None and data["phase2_seconds"] > 0
    p1, p2 = np.load(manifest["phase1_npy"]), np.load(manifest["phase2_npy"])
    assert p1.shape == (1, 4, 8, 8) and p2.shape == (1, 4, 16, 16)

    torch.manual_seed(5)
    model = t_models.get_model("NextDiT_2B_patch2", cap_feat_dim=2048, qk_norm=True).eval()
    feats = [torch.stack([t_app.pseudo_caption_features(t, 5) for t in (p, t_app.NEGATIVE_CAP)])
             for p in ("a cat", "a dog")]
    masks = [torch.ones(2, 32, dtype=torch.int32)] * 2
    gen = torch.Generator().manual_seed(5)
    z = torch.randn((1, 4, 8, 8), generator=gen)
    z2 = torch.randn((1, 4, 16, 16), generator=gen)
    enc, dec = t_app._debug_vae()
    r1, r2, _ = t_app.generate_anagram(
        model, feats, masks, t_ana.get_anagrams_views(["identity", "flip"]), z=z, z2=z2,
        num_steps=3, scale_watershed=0.3, kv_merge_ratio=2,
        vae_encode_fn=enc, vae_decode_fn=dec)
    np.testing.assert_array_equal(p1, r1.numpy())
    np.testing.assert_array_equal(p2, r2.numpy())

    from PIL import Image

    a = np.asarray(Image.open(manifest["paths"][0]))
    b = np.asarray(Image.open(manifest["paths"][1]))
    gif = t_app.animate_two_view(a, b, str(tmp_path / "morph.gif"), num_frames=4, hold_frames=2)
    ref = j_app.animate_two_view(a, b, str(tmp_path / "ref.gif"), num_frames=4, hold_frames=2)
    assert Image.open(gif).n_frames > 2
    assert open(gif, "rb").read() == open(ref, "rb").read()


def test_app_phase1_only_without_vae(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(t_models.MODELS, "NextDiT_2B_patch2",
                        lambda **kw: t_nd.NextDiT(**dict(TINY, **kw)))
    manifest = t_app.main(["--prompts", "a", "--views", "identity", "--base_res", "32",
                           "--resolution", "64", "--num_inference_steps", "2",
                           "--save_dir", str(tmp_path), "--device", "cpu"])
    assert "phase2_npy" not in manifest and len(manifest["paths"]) == 1
    assert "running phase 1 only" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        t_app.main(["--prompts", "a", "b", "--views", "identity", "--device", "cpu"])


def test_app_restores_ema_stream(tmp_path, monkeypatch):
    """--ckpt loads the checkpoint's ema stream (`core/checkpoint.init_from`)
    over the seed's weights."""
    from lumina_t2x_tpu_torch.core.checkpoint import save_weights

    monkeypatch.setitem(t_models.MODELS, "NextDiT_2B_patch2",
                        lambda **kw: t_nd.NextDiT(**dict(TINY, **kw)))
    torch.manual_seed(123)
    donor = t_models.get_model("NextDiT_2B_patch2", cap_feat_dim=2048, qk_norm=True).eval()
    with torch.no_grad():
        for p in donor.parameters():
            p.add_(0.02 * torch.randn_like(p))
    ckpt = save_weights(str(tmp_path / "ckpt"), donor.state_dict(), {"model": "NextDiT_2B_patch2"})
    argv = ["--prompts", "a cat", "--views", "identity", "--base_res", "32", "--resolution", "32",
            "--num_inference_steps", "2", "--save_dir", str(tmp_path / "out"), "--device", "cpu",
            "--debug", "--ckpt", ckpt]
    got = np.load(t_app.main(argv)["phase1_npy"])
    feats = torch.stack([t_app.pseudo_caption_features(t, 0) for t in ("a cat", t_app.NEGATIVE_CAP)])
    z = torch.randn((1, 4, 4, 4), generator=torch.Generator().manual_seed(0))
    ref, _, _ = t_app.generate_anagram(donor, [feats], [torch.ones(2, 32, dtype=torch.int32)],
                                       t_ana.get_anagrams_views(["identity"]), z=z, num_steps=2,
                                       scale_watershed=0.3)
    np.testing.assert_array_equal(got, ref.numpy())
    assert np.abs(got).max() > 0

"""The port's MMDiT (`lumina_t2x_tpu_torch/models/mmdit.py`) and its
importer (`codecs/mmdit_import.py`) against the JAX package's: the
position table at SD3's 192/64 and uncropped, the whole model (square and
non-square) with weights carried by `core/checkpoint.
mmdit_state_dict_from_jax_params`, and the importer on a synthetic diffusers
state dict (the torch transcription of `SD3Transformer2DModel` in
`tests/test_mmdit_parity.py`) with and without qk-norm weights, through a
`.safetensors` file whose architecture `load_sd3_mmdit` reads off.

A tiny config (dim 64, 3 layers so that the last is context-pre-only, 4
heads, 4 latent channels, context 24, pooled 16, table 12 / 4), fp32 on the
CPU, inputs from numpy. The JAX model calls its XLA `sdpa`; the port's joint
attention runs the flash entry points' plain versions. Bar: atol 2e-4 /
rtol 2e-3.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from lumina_t2x_tpu.codecs.mmdit_import import import_sd3_mmdit_weights as j_import
from lumina_t2x_tpu.models import mmdit as j_mmdit
from lumina_t2x_tpu_torch.codecs import mmdit_import as t_import
from lumina_t2x_tpu_torch.core.checkpoint import mmdit_state_dict_from_jax_params, save_safetensors
from lumina_t2x_tpu_torch.models import get_model
from lumina_t2x_tpu_torch.models import mmdit as t_mmdit

import test_mmdit_parity as diffusers_ref

ATOL, RTOL = 2e-4, 2e-3
TINY = dict(patch_size=2, in_channels=4, dim=64, n_layers=3, n_heads=4, context_dim=24,
            pooled_dim=16, qk_norm=True, pos_embed_max_size=12, pos_embed_base_size=4)


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(ref, np.float32),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("grid,max_size,base", [
    ((64, 64), 192, 64), ((48, 80), 192, 64), ((7, 5), None, None), ((6, 4), None, 3)])
def test_pos_embed_matches_jax(grid, max_size, base):
    ref = j_mmdit.sincos_pos_embed_2d(64, *grid, max_size=max_size, base_size=base)
    got = t_mmdit.sincos_pos_embed_2d(64, *grid, max_size=max_size, base_size=base)
    assert got.shape == (grid[0] * grid[1], 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    with pytest.raises(ValueError):
        t_mmdit.sincos_pos_embed_2d(64, 200, 8, max_size=192, base_size=64)


@functools.lru_cache(maxsize=None)
def _pair(qk_norm=True):
    kw = dict(TINY, qk_norm=qk_norm)
    jmodel = j_mmdit.MMDiT(**kw)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(1), jnp.zeros((1, 4, 8, 8)),
                                     jnp.zeros((1,)), jnp.zeros((1, 5, 24)), jnp.zeros((1, 16)))
    flat = traverse_util.flatten_dict(jax.tree.map(np.asarray, variables["params"]))
    rng = np.random.default_rng(1)
    params = traverse_util.unflatten_dict(
        {k: (v + 0.05 * rng.standard_normal(v.shape)).astype(np.float32) for k, v in flat.items()})
    tmodel = t_mmdit.MMDiT(**kw).eval()
    tmodel.load_state_dict(mmdit_state_dict_from_jax_params(params), strict=True)
    return jmodel, {"params": params}, tmodel


def _inputs(seed, b, h, w, sc=7):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 4, h, w)).astype(np.float32),
            np.array([17.0, 999.0, 400.0][:b], np.float32),
            rng.standard_normal((b, sc, 24)).astype(np.float32),
            rng.standard_normal((b, 16)).astype(np.float32))


@pytest.mark.parametrize("qk_norm", [True, False])
@pytest.mark.parametrize("shape", [(2, 8, 8), (1, 8, 12), (3, 12, 4)])
def test_model_matches_jax(shape, qk_norm):
    jmodel, variables, tmodel = _pair(qk_norm)
    args = _inputs(2, *shape)
    ref = jax.jit(jmodel.apply)(variables, *map(jnp.asarray, args))
    with torch.no_grad():
        got = tmodel(*map(torch.from_numpy, args))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    _close(got, ref)


def test_registry_matches_jax_param_count():
    tmodel = get_model("MMDiT_SD3_Medium", device="meta")
    jmodel = j_mmdit.MMDiT_SD3_Medium()
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 8, 8)),
                            jnp.zeros((1,)), jnp.zeros((1, 4, 4096)), jnp.zeros((1, 2048)))
    count = sum(p.numel() for p in tmodel.parameters())
    assert count == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert 2.0e9 < count < 2.1e9
    assert (tmodel.pos_embed_max_size, tmodel.pos_embed_base_size) == (192, 64)


def _diffusers_state_dict(qk_norm=True):
    """The transcription's randomised state dict (diffusers names); without
    qk-norm its norms become identities and their weights are dropped."""
    tm = diffusers_ref._randomized_torch_model()
    if not qk_norm:
        for blk in tm.transformer_blocks:
            for name in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
                setattr(blk.attn, name, torch.nn.Identity())
    return tm, {k: v.detach().clone() for k, v in tm.state_dict().items()}


@pytest.mark.parametrize("qk_norm", [True, False])
def test_importer_matches_diffusers_and_jax(qk_norm, tmp_path):
    tm, sd = _diffusers_state_dict(qk_norm)
    path = str(tmp_path / "transformer.safetensors")
    save_safetensors(sd, path)
    tmodel = t_import.load_sd3_mmdit(path, head_dim=16).eval()
    assert tmodel.qk_norm == qk_norm and len(tmodel.blocks) == 3
    assert (tmodel.pos_embed_max_size, tmodel.pos_embed_base_size) == (12, 4)
    args = _inputs(3, 2, 8, 8)
    with torch.no_grad():
        ref = tm(*map(torch.from_numpy, args))
        got = tmodel(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL, rtol=RTOL)

    np_sd = {k: v.numpy() for k, v in sd.items()}
    params = j_import(np_sd, n_layers=3, pos_embed_max_size=12, pos_embed_base_size=4)
    jmodel = j_mmdit.MMDiT(**dict(TINY, qk_norm=qk_norm))
    _close(got, jmodel.apply({"params": params}, *map(jnp.asarray, args)))
    ported = t_import.import_sd3_mmdit_weights(sd, n_layers=3, pos_embed_max_size=12,
                                               pos_embed_base_size=4)
    assert sorted(ported) == sorted(mmdit_state_dict_from_jax_params(params))
    if not qk_norm:
        # the JAX importer leaves the norms out, and a qk-norm JAX model (the
        # SD3 config's default) cannot run on that tree
        with pytest.raises(Exception, match="q_norm"):
            j_mmdit.MMDiT(**TINY).apply({"params": params}, *map(jnp.asarray, args))


def test_importer_rejects_a_drifted_pos_table():
    _, sd = _diffusers_state_dict()
    buf = sd["pos_embed.pos_embed"].reshape(12, 12, 64)
    sd["pos_embed.pos_embed"] = buf.transpose(0, 1).reshape(1, 144, 64).contiguous()
    with pytest.raises(ValueError, match="pos_embed"):
        t_import.import_sd3_mmdit_weights(sd, n_layers=3, pos_embed_max_size=12,
                                          pos_embed_base_size=4)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_importer_takes_a_half_precision_pos_table(dtype):
    """Release files store the position buffer in half precision: the port
    holds it to its own dtype's rounding, where the JAX importer's fixed
    1e-4 refuses an fp16 table."""
    _, sd = _diffusers_state_dict()
    sd["pos_embed.pos_embed"] = sd["pos_embed.pos_embed"].to(dtype)
    t_import.import_sd3_mmdit_weights(sd, n_layers=3, pos_embed_max_size=12,
                                      pos_embed_base_size=4)
    if dtype == torch.float16:
        np_sd = {k: v.float().numpy() if k == "pos_embed.pos_embed" else v.numpy()
                 for k, v in sd.items()}
        with pytest.raises(ValueError, match="pos_embed"):
            j_import(np_sd, n_layers=3, pos_embed_max_size=12, pos_embed_base_size=4)

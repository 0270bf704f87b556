"""The port's class-conditional NextDiT-ImageNet
(`lumina_t2x_tpu_torch/models/next_dit_imagenet.py`), its layers
(`LabelEmbedder`, the shift+scale `FinalLayer`), its weight bridge
(`core/checkpoint.imagenet_state_dict_from_jax_params`) and its sampler
(`pipelines/sample_lib.build_class_cond_sample_fn`) against the JAX
package's.

The Tiny config (dim 64, 2 layers, 4 heads), fp32 on the CPU, inputs from
numpy. Every parameter is perturbed by 0.02 * N(0, 1): the zero-initialised
final layer and adaLN would otherwise make the model output exactly 0. The
JAX sampler's noise comes from its rng and is handed to the port. Bar:
atol 2e-4 / rtol 2e-3.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from lumina_t2x_tpu.core.checkpoint import import_next_dit_imagenet_weights
from lumina_t2x_tpu.models import get_model as j_get_model
from lumina_t2x_tpu.models import layers as j_layers
from lumina_t2x_tpu.models import next_dit_imagenet as j_ni
from lumina_t2x_tpu.pipelines import sample_lib as j_sl
from lumina_t2x_tpu_torch.core.checkpoint import imagenet_state_dict_from_jax_params
from lumina_t2x_tpu_torch.models import MODELS, get_model
from lumina_t2x_tpu_torch.models import layers as t_layers
from lumina_t2x_tpu_torch.models import next_dit_imagenet as t_ni
from lumina_t2x_tpu_torch.pipelines import sample_lib as t_sl

ATOL, RTOL = 2e-4, 2e-3
CONFIGS = {"plain": {}, "qk_norm": dict(qk_norm=True), "pixel": dict(in_channels=3)}


def _randomized_params(jmodel, seed, chans=4):
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(seed), jnp.zeros((1, chans, 8, 8)),
                                     jnp.zeros((1,)), jnp.zeros((1,), jnp.int32))
    flat = traverse_util.flatten_dict(jax.tree.map(np.asarray, variables["params"]))
    rng = np.random.default_rng(seed)
    flat = {k: (v + 0.02 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in flat.items()}
    return traverse_util.unflatten_dict(flat)


@functools.lru_cache(maxsize=None)
def _pair(cfg="plain", scan_blocks=True):
    """A JAX Tiny NextDiTImageNet with randomized params and the port's
    model holding the same weights (built once per config)."""
    kw = CONFIGS[cfg]
    jmodel = j_ni.NextDiT_ImageNet_Tiny_patch2(attn_impl="xla", scan_blocks=scan_blocks, **kw)
    params = _randomized_params(jmodel, 2, kw.get("in_channels", 4))
    tmodel = t_ni.NextDiT_ImageNet_Tiny_patch2(**kw).eval()
    tmodel.load_state_dict(imagenet_state_dict_from_jax_params(params), strict=True)
    return jmodel, params, tmodel


def _inputs(seed, chans=4, b=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, chans, 8, 8)).astype(np.float32)
    t = rng.uniform(0, 1, b).astype(np.float32)
    y = np.array([3, 999, 0, 1000][:b], np.int32)  # 1000: the null class
    return x, t, y


@pytest.mark.parametrize("scan_blocks", [True, False])
def test_bridge_round_trip_through_the_jax_importer(scan_blocks):
    """Scanned (`layers/`) and per-layer (`layers_<i>/`) trees -> the
    reference state dict, which the JAX importer maps back to the same tree
    and the port loads strictly."""
    jmodel, params, _ = _pair("qk_norm", scan_blocks)
    sd = imagenet_state_dict_from_jax_params(params)
    assert "y_embedder.embedding_table.weight" in sd and "layers.1.ffn_norm.weight" in sd
    back = import_next_dit_imagenet_weights({k: v.numpy() for k, v in sd.items()},
                                            n_layers=2, scan_layers=scan_blocks)
    flat, flat_back = (traverse_util.flatten_dict(p) for p in (params, back))
    assert sorted(flat) == sorted(flat_back)
    for key, arr in flat.items():
        np.testing.assert_array_equal(np.asarray(flat_back[key]), arr, err_msg=str(key))
    missing, unexpected = t_ni.NextDiT_ImageNet_Tiny_patch2(qk_norm=True).load_state_dict(sd)
    assert not missing and not unexpected


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_forward_matches_jax(cfg):
    jmodel, params, tmodel = _pair(cfg)
    x, t, y = _inputs(3, tmodel.in_channels)
    ref = jax.jit(jmodel.apply)({"params": params}, *map(jnp.asarray, (x, t, y)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y).long())
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("rope", [dict(), dict(rope_scaling_factor=2.0, ntk_factor=1.5)])
def test_forward_with_cfg_matches_jax(rope):
    """CFG on the first 3 of 4 channels only: the guided channels agree
    between the halves, the fourth passes through."""
    jmodel, params, tmodel = _pair()
    x, t, _ = _inputs(5)
    y = np.array([7, 11, 1000, 1000], np.int32)
    jcfg = jax.jit(functools.partial(j_ni.forward_with_cfg, jmodel, cfg_scale=4.0, **rope))
    ref = jcfg({"params": params}, *map(jnp.asarray, (x, t, y)))
    with torch.no_grad():
        got = t_ni.forward_with_cfg(tmodel, *map(torch.from_numpy, (x, t)),
                                    torch.from_numpy(y).long(), 4.0, **rope)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(got[:2, :3].numpy(), got[2:, :3].numpy())
    assert not torch.equal(got[:2, 3], got[2:, 3])


def test_label_embedder_matches_jax():
    """The null class (row `num_classes`, present when dropout > 0) and
    `force_drop_ids`; no null row without dropout; training dropout drawn
    from a generator maps dropped labels to the null class."""
    jemb = j_layers.LabelEmbedder(10, 16, dropout_prob=0.5)
    labels = jnp.array([0, 3, 9, 10])
    params = jemb.init(jax.random.PRNGKey(0), labels)
    temb = t_layers.LabelEmbedder(10, 16, dropout_prob=0.5)
    assert temb.embedding_table.weight.shape == (11, 16)
    assert t_layers.LabelEmbedder(10, 16).embedding_table.weight.shape == (10, 16)
    with torch.no_grad():
        temb.embedding_table.weight.copy_(torch.tensor(np.asarray(params["params"]["embedding"])))
    tl = torch.tensor([0, 3, 9, 10])
    drop = np.array([1, 0, 1, 0])
    for kw_j, kw_t in (({}, {}), ({"force_drop_ids": jnp.asarray(drop)},
                                  {"force_drop_ids": torch.from_numpy(drop)})):
        ref = jemb.apply(params, labels, **kw_j)
        got = temb(tl, **kw_t)
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(ref))
    table = temb.embedding_table.weight
    g = torch.Generator().manual_seed(0)
    got = temb(torch.arange(10).repeat(20), train=True, generator=g)
    dropped = (got == table[10]).all(dim=-1)
    assert 0 < int(dropped.sum()) < 200
    kept = torch.arange(10).repeat(20)[~dropped]
    assert torch.equal(got[~dropped], table[kept])


@pytest.mark.parametrize("shift", [None, 2.0])
def test_class_cond_sampler_matches_jax(shift):
    """A 3-point midpoint trajectory with CFG 4; the JAX sampler draws z
    from its rng, and the same z is handed to the port."""
    jmodel, params, tmodel = _pair()
    labels = np.array([5, 42], np.int32)
    rng = jax.random.PRNGKey(7)
    kw = dict(num_steps=3, solver="midpoint", cfg_scale=4.0, time_shifting_factor=shift,
              latent_size=8, in_channels=4)
    ref = jax.jit(j_sl.build_class_cond_sample_fn(jmodel, **kw))(
        {"params": params}, rng, jnp.asarray(labels))
    z = np.array(jax.random.normal(rng, (2, 4, 8, 8)))
    got = t_sl.build_class_cond_sample_fn(tmodel, **kw)(torch.from_numpy(z),
                                                         torch.from_numpy(labels).long())
    assert got.shape == (2, 4, 8, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    with pytest.raises(ValueError, match="expected"):
        t_sl.build_class_cond_sample_fn(tmodel, **kw)(torch.zeros(2, 4, 4, 4),
                                                      torch.from_numpy(labels).long())


@pytest.mark.parametrize("name", sorted(n for n in MODELS if "ImageNet" in n))
def test_registry_param_counts_match_jax(name):
    """Each ImageNet registry config has the JAX config's parameter count
    (built on the meta device and through jax.eval_shape)."""
    tmodel = get_model(name, qk_norm=True, device="meta")
    jmodel = j_get_model(name, qk_norm=True)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 4, 8, 8)),
                            jnp.zeros((1,)), jnp.zeros((1,), jnp.int32))
    j_count = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in tmodel.parameters()) == j_count
    assert (tmodel.dim, tmodel.n_layers, tmodel.n_heads) == (jmodel.dim, jmodel.n_layers,
                                                             jmodel.n_heads)

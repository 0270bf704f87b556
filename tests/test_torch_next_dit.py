"""The port's NextDiT (`lumina_t2x_tpu_torch/models`) against the JAX
package's, with weights carried over by the weight bridge
(`lumina_t2x_tpu_torch.core.checkpoint.state_dict_from_jax_params`).

Tiny configs (dim 64, 2 layers, 4 heads, caption dim 32), fp32 on the CPU,
inputs from numpy. Every parameter is perturbed by 0.02 * N(0, 1): the
zero-initialised layers (final layer, adaLN, caption projection, gates)
would otherwise make the model output exactly 0 and the comparison vacuous.
Bar: atol 2e-4 / rtol 2e-3.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from lumina_t2x_tpu.core.checkpoint import export_next_dit_weights
from lumina_t2x_tpu.models import next_dit as j_nd
from lumina_t2x_tpu_torch.core.checkpoint import state_dict_from_jax_params
from lumina_t2x_tpu_torch.models import MODELS, get_model
from lumina_t2x_tpu_torch.models import next_dit as t_nd

ATOL, RTOL = 2e-4, 2e-3
TINY = dict(patch_size=2, dim=64, n_layers=2, n_heads=4, multiple_of=16, cap_feat_dim=32)


def _randomized_params(jmodel, seed, x_shape=(2, 4, 8, 8), ly=9):
    variables = jax.jit(jmodel.init)(
        jax.random.PRNGKey(seed), jnp.zeros(x_shape), jnp.zeros((2,)),
        jnp.zeros((2, ly, TINY["cap_feat_dim"])), jnp.ones((2, ly), jnp.int32))
    flat = traverse_util.flatten_dict(jax.tree.map(np.asarray, variables["params"]))
    rng = np.random.default_rng(seed)
    flat = {k: (v + 0.02 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in flat.items()}
    return traverse_util.unflatten_dict(flat)


@functools.lru_cache(maxsize=None)
def _pair(jax_impl="xla", qk_norm=True, n_kv_heads=None):
    """A JAX NextDiT with randomized params and the port's NextDiT holding
    the same weights (built once per config for the whole module)."""
    kw = dict(TINY, qk_norm=qk_norm, n_kv_heads=n_kv_heads)
    jmodel = j_nd.NextDiT(attn_impl=jax_impl, **kw)
    params = _randomized_params(jmodel, 2)
    tmodel = t_nd.NextDiT(**kw).eval()
    tmodel.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return jmodel, params, tmodel


def _inputs(seed, b=2, h=8, w=8, ly=9):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 4, h, w)).astype(np.float32)
    t = rng.uniform(0, 1, b).astype(np.float32)
    cap = rng.standard_normal((b, ly, TINY["cap_feat_dim"])).astype(np.float32)
    mask = np.ones((b, ly), np.int32)
    mask[0, 6:] = 0
    return x, t, cap, mask


@pytest.mark.parametrize("qk_norm", [True, False])
def test_bridge_matches_export(qk_norm):
    jmodel = j_nd.NextDiT(qk_norm=qk_norm, **TINY)
    params = _randomized_params(jmodel, 1)
    ref = export_next_dit_weights(params)
    got = state_dict_from_jax_params(params)
    assert sorted(got) == sorted(ref)
    for key, arr in ref.items():
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(arr), err_msg=key)
    missing, unexpected = t_nd.NextDiT(qk_norm=qk_norm, **TINY).load_state_dict(got, strict=True)
    assert not missing and not unexpected


@pytest.mark.parametrize("cfg", [
    dict(qk_norm=True), dict(qk_norm=False), dict(qk_norm=True, n_kv_heads=2)])
def test_forward_matches_jax(cfg):
    jmodel, params, tmodel = _pair(**cfg)
    x, t, cap, mask = _inputs(3)
    ref = jax.jit(jmodel.apply)({"params": params}, *map(jnp.asarray, (x, t, cap, mask)))
    with torch.no_grad():
        got = tmodel(*map(torch.from_numpy, (x, t, cap, mask)))
    assert got.dtype == torch.float32 and got.shape == (2, 4, 8, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("t0,extrapolate", [(0.1, True), (0.7, True), (0.5, False)])
def test_forward_with_cfg_matches_jax(t0, extrapolate):
    """CFG forward, with the time-aware RoPE scaling and the proportional
    scale of resolution extrapolation on either side of the watershed."""
    jmodel, params, tmodel = _pair()
    x, _, cap, mask = _inputs(5)
    t = np.full((2,), t0, np.float32)
    kw = dict(scale_factor=2.0, scale_watershed=0.3, proportional_attn=True,
              base_seqlen=8) if extrapolate else {}
    jcfg = jax.jit(functools.partial(j_nd.forward_with_cfg, jmodel, cfg_scale=4.0, **kw))
    ref = jcfg({"params": params}, *map(jnp.asarray, (x, t, cap, mask)))
    with torch.no_grad():
        got = t_nd.forward_with_cfg(tmodel, *map(torch.from_numpy, (x, t, cap, mask)), 4.0, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(got[:1, :3].numpy(), got[1:, :3].numpy())


def test_streaming_forward_matches_jax_flash():
    """1088 image tokens (latent 16x272): the self-attention streams, the
    port's plain online version against the JAX Pallas kernel (interpret)."""
    jmodel, params, tmodel = _pair(jax_impl="flash")
    x, t, cap, mask = _inputs(7, h=16, w=272)
    ref = jax.jit(jmodel.apply)({"params": params}, *map(jnp.asarray, (x, t, cap, mask)))
    with torch.no_grad():
        got = tmodel(*map(torch.from_numpy, (x, t, cap, mask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_bf16_forward_is_close_to_fp32():
    _, params, tmodel = _pair()
    t16 = t_nd.NextDiT(dtype=torch.bfloat16, qk_norm=True, **TINY).eval()
    t16.load_state_dict(state_dict_from_jax_params(params), strict=True)
    args = [torch.from_numpy(a) for a in _inputs(9)]
    with torch.no_grad():
        ref, got = tmodel(*args), t16(*args)
    assert got.dtype == torch.float32
    rel = (got - ref).norm() / ref.norm()
    assert rel < 3e-2, rel  # bf16 activations: ~8 mantissa bits per op


def test_unported_paths_raise():
    _, _, tmodel = _pair()
    args = [torch.from_numpy(a) for a in _inputs(11)]
    with pytest.raises(NotImplementedError):
        tmodel(*args, img_sizes=[(8, 8), (8, 8)])
    # sequence sharding runs over a process group (tests/test_torch_parallel.py
    # runs it on a gloo world); one process without one has none to shard over
    with pytest.raises(RuntimeError, match="process group"):
        t_nd.NextDiT(seq_shard_axis="data", **TINY)


@pytest.mark.parametrize("name", sorted(
    n for n in MODELS if n.startswith("NextDiT_")
    and not any(family in n for family in ("ImageNet", "MoE", "Compositional"))))
def test_registry_param_counts_match_jax(name):
    """Each NextDiT text-to-image registry config has the JAX config's
    parameter count (built on the meta device and through jax.eval_shape:
    nothing is allocated). The other families' counts are held in their own
    files (`test_torch_{next_dit_imagenet,flag_dit,moe,compositional}.py`)."""
    from lumina_t2x_tpu.models import get_model as j_get_model

    tmodel = get_model(name, qk_norm=True, cap_feat_dim=2048, device="meta")
    jmodel = j_get_model(name, qk_norm=True, cap_feat_dim=2048)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((2, 4, 8, 8)),
                            jnp.zeros((2,)), jnp.zeros((2, 4, 2048)), jnp.ones((2, 4), jnp.int32))
    j_count = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in tmodel.parameters()) == j_count
    assert (tmodel.dim, tmodel.n_layers, tmodel.n_heads) == (jmodel.dim, jmodel.n_layers,
                                                             jmodel.n_heads)

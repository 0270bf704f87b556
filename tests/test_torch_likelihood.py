"""The port's likelihood sampler (`Sampler.sample_ode_likelihood`,
`lumina_t2x_tpu_torch/transport/transport.py`) against the JAX package's.

The same x and the same Rademacher probe (JAX's draw, handed to the port as
a tensor) go through both, under euler and dopri5: a zero velocity field
(logp is the prior's density of x, JAX's `tests/test_transport.py` check;
dopri8 too),
a linear field c * x (the Hutchinson estimate is exact there, so logp also
meets its closed form), and the Tiny NextDiT-ImageNet with `attn_impl="xla"`
in both packages (weights carried by the bridge). The port's flash path
refuses forward mode, as JAX's custom_vjp does. fp32 on the CPU; bar atol 2e-4 / rtol 2e-3 unless
stated.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from lumina_t2x_tpu import transport as j_tr
from lumina_t2x_tpu.models import next_dit_imagenet as j_ni
from lumina_t2x_tpu_torch import transport as t_tr
from lumina_t2x_tpu_torch.core.checkpoint import imagenet_state_dict_from_jax_params
from lumina_t2x_tpu_torch.models import next_dit_imagenet as t_ni

ATOL, RTOL = 2e-4, 2e-3
METHODS = ["euler", "dopri5"]


def _both(method, num_steps=8):
    kw = dict(sampling_method=method, num_steps=num_steps)
    return (j_tr.Sampler(j_tr.create_transport()).sample_ode_likelihood(**kw),
            t_tr.Sampler(t_tr.create_transport()).sample_ode_likelihood(**kw))


def _probe(seed, shape):
    """JAX's draw of the probe, and the key that draws it."""
    rng = jax.random.PRNGKey(seed)
    return rng, np.array(jax.random.rademacher(rng, shape, dtype=jnp.float32))


@pytest.mark.parametrize("method", METHODS + ["dopri8"])
def test_zero_field_gives_the_prior_density(method):
    x = np.random.default_rng(0).standard_normal((4, 10)).astype(np.float32)
    rng, eps = _probe(1, x.shape)
    j_fn, t_fn = _both(method)
    ref, ref_z = j_fn(rng, jnp.asarray(x), lambda xx, tt: jnp.zeros_like(xx))
    logp, z = t_fn(torch.from_numpy(x), lambda xx, tt: torch.zeros_like(xx),
                   eps=torch.from_numpy(eps))
    prior = t_tr.create_transport().prior_logp(torch.from_numpy(x))
    np.testing.assert_allclose(logp.numpy(), prior.numpy(), rtol=1e-4)
    np.testing.assert_allclose(logp.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(z.numpy(), np.asarray(ref_z), atol=ATOL, rtol=RTOL)
    assert t_fn.nfe == 7 if method == "euler" else t_fn.nfe >= 6


@pytest.mark.parametrize("method", METHODS)
def test_linear_field_matches_jax_and_its_closed_form(method):
    """v = c * x: jvp(v)(eps) . eps = c * n for every probe, so the estimate
    is exact; dopri5 meets z = x e^{-c} and logp = log N(z) - c n."""
    c = 0.7
    x = np.random.default_rng(2).standard_normal((3, 2, 4, 4)).astype(np.float32)
    rng, eps = _probe(3, x.shape)
    j_fn, t_fn = _both(method)
    ref, ref_z = jax.jit(lambda r, xx: j_fn(r, xx, lambda a, tt: c * a))(rng, jnp.asarray(x))
    logp, z = t_fn(torch.from_numpy(x), lambda a, tt: c * a, eps=torch.from_numpy(eps))
    np.testing.assert_allclose(logp.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(z.numpy(), np.asarray(ref_z), atol=ATOL, rtol=RTOL)
    n = x[0].size
    # the probe term alone: c * n over the interval [0, 1], exact under any method
    delta = (t_tr.create_transport().prior_logp(z) - logp).numpy()
    np.testing.assert_allclose(delta, c * n, rtol=1e-5)
    if method == "dopri5":
        z_exact = x * math.exp(-c)
        np.testing.assert_allclose(z.numpy(), z_exact, rtol=1e-3, atol=1e-5)
        exact = t_tr.create_transport().prior_logp(torch.from_numpy(z_exact)).numpy() - c * n
        np.testing.assert_allclose(logp.numpy(), exact, rtol=1e-4)


def _imagenet_pair():
    jmodel = j_ni.NextDiT_ImageNet_Tiny_patch2(attn_impl="xla")
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(3), jnp.zeros((1, 4, 8, 8)),
                                     jnp.zeros((1,)), jnp.zeros((1,), jnp.int32))
    flat = traverse_util.flatten_dict(jax.tree.map(np.asarray, variables["params"]))
    rng = np.random.default_rng(3)
    params = traverse_util.unflatten_dict(
        {k: (v + 0.05 * rng.standard_normal(v.shape)).astype(np.float32)
         for k, v in flat.items()})
    tmodel = t_ni.NextDiT_ImageNet_Tiny_patch2(attn_impl="xla").eval()
    tmodel.load_state_dict(imagenet_state_dict_from_jax_params(params), strict=True)
    return jmodel, params, tmodel


def test_tiny_imagenet_model_matches_jax():
    """The Tiny NextDiT-ImageNet (perturbed weights, so the field bends) on
    `attn_impl="xla"`, euler and dopri5, the same x, labels and probe."""
    jmodel, params, tmodel = _imagenet_pair()
    params = jax.tree.map(jnp.asarray, params)
    x = np.random.default_rng(4).standard_normal((2, 4, 8, 8)).astype(np.float32)
    y = np.array([3, 7], np.int32)
    rng, eps = _probe(5, x.shape)

    def j_model(xx, tt):
        return jmodel.apply({"params": params}, xx, tt, jnp.asarray(y))

    def t_model(xx, tt):
        return tmodel(xx, tt, torch.from_numpy(y).long())

    for method in METHODS:
        j_fn, t_fn = _both(method, num_steps=4)
        ref, ref_z = jax.jit(lambda r, xx: j_fn(r, xx, j_model))(rng, jnp.asarray(x))
        logp, z = t_fn(torch.from_numpy(x), t_model, eps=torch.from_numpy(eps))
        assert np.isfinite(logp.numpy()).all()
        np.testing.assert_allclose(z.numpy(), np.asarray(ref_z), atol=ATOL, rtol=RTOL)
        # logp is ~-n log(2 pi)/2: hold it relative to its size
        np.testing.assert_allclose(logp.numpy(), np.asarray(ref), rtol=RTOL)


def test_generator_draws_a_rademacher_probe():
    _, t_fn = _both("euler", num_steps=3)
    x = torch.zeros(2, 5)

    def field(xx, tt):
        return xx

    gen = torch.Generator().manual_seed(0)
    logp, _ = t_fn(x, field, generator=gen)
    # v = x: the probe term is n * (t1 - t0) whatever the draw
    np.testing.assert_allclose((t_tr.create_transport().prior_logp(x) - logp).numpy(),
                               5.0, rtol=1e-6)
    again, _ = t_fn(x, field, generator=torch.Generator().manual_seed(0))
    assert torch.equal(logp, again)


def test_flash_path_refuses_forward_mode():
    """The flash kernels have no forward-mode rule (nor has JAX's
    custom_vjp): the port raises a clear error that names attn_impl="xla"."""
    tmodel = t_ni.NextDiT_ImageNet_Tiny_patch2(attn_impl="flash").eval()
    _, t_fn = _both("euler", num_steps=3)
    x = torch.zeros(1, 4, 8, 8)
    y = torch.zeros(1, dtype=torch.long)
    with pytest.raises(RuntimeError, match='attn_impl="xla"'):
        t_fn(x, lambda xx, tt: tmodel(xx, tt, y), eps=torch.ones_like(x))

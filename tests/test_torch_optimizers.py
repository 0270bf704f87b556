"""The port's optimizers and stochastic rounding
(`lumina_t2x_tpu_torch/pipelines/train_lib.py`) against the JAX package's
(`lumina_t2x_tpu/pipelines/train_lib.py`) and optax, on a small tree of
leaves fed to both unchanged (one factored 2-D leaf, one 1-D leaf, one
factored 3-D leaf), fp32 on the CPU. Bars: rtol 1e-5 / atol 1e-6 for the
optimizer arithmetic (as `tests/test_optimizers.py` pins the JAX one to
optax); bit-exact for the stochastic-rounding hash.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lumina_t2x_tpu.pipelines import train_lib as j_tl
from lumina_t2x_tpu_torch.pipelines import train_lib as t_tl


def _setup():
    rng = np.random.RandomState(0)
    params = {"w": rng.randn(8, 6).astype(np.float32), "b": rng.randn(6).astype(np.float32),
              "k": rng.randn(3, 6, 5).astype(np.float32)}
    grads = [{n: (rng.randn(*p.shape) * 2.0).astype(np.float32) for n, p in params.items()}
             for _ in range(4)]
    ema = {n: p + 0.1 for n, p in params.items()}
    return params, grads, ema


def _port_run(opt, params, grads, ema, decay, clip):
    tp = {n: torch.from_numpy(p.copy()) for n, p in params.items()}
    te = {n: torch.from_numpy(e.copy()) for n, e in ema.items()}
    state = opt.init(tp)
    for g in grads:
        tg = {n: torch.from_numpy(a) for n, a in g.items()}
        gn = torch.sqrt(sum((a ** 2).sum() for a in tg.values()))
        scale = torch.clamp(clip / (gn + 1e-6), max=1.0)
        opt.step(tg, tp, state, te, decay, scale)
    return tp, te, state


def _close(got, ref, **kw):
    for name in ref:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]), err_msg=name, **kw)


@pytest.mark.parametrize("warmup", [0, 3])
def test_fused_adamw_matches_jax(warmup):
    params, grads, ema = _setup()
    ref = j_tl.FusedAdamWEMA(3e-3, weight_decay=0.01, warmup_steps=warmup)
    rp, re_ = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, ema)
    rs = ref.init(rp)
    for g in grads:
        jg = jax.tree.map(jnp.asarray, g)
        scale = jnp.minimum(1.0, 1.0 / (optax.global_norm(jg) + 1e-6))
        rp, rs, re_ = ref.step(jg, rp, rs, re_, 0.999, scale)
    tp, te, ts = _port_run(t_tl.FusedAdamWEMA(3e-3, weight_decay=0.01, warmup_steps=warmup),
                           params, grads, ema, 0.999, 1.0)
    _close(tp, rp, rtol=1e-5, atol=1e-6)
    _close(te, re_, rtol=1e-5, atol=1e-6)
    _close(ts["mu"], rs[0].mu, rtol=1e-5, atol=1e-7)
    _close(ts["nu"], rs[0].nu, rtol=1e-5, atol=1e-9)
    assert int(ts["count"]) == int(rs[0].count) == 4


@pytest.mark.parametrize("warmup", [0, 3])
def test_adamw_matches_optax(warmup):
    """The optax chain of the JAX trainer's non-fused branch: clip, adamw
    (linear warmup schedule), apply_updates, EMA."""
    params, grads, ema = _setup()
    ref = j_tl.create_optimizer(3e-3, 0.01, warmup_steps=warmup)
    rp, re_ = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, ema)
    rs = ref.init(rp)
    for g in grads:
        jg = jax.tree.map(jnp.asarray, g)
        scale = jnp.minimum(1.0, 1.0 / (optax.global_norm(jg) + 1e-6))
        updates, rs = ref.update(jax.tree.map(lambda a: a * scale, jg), rs, rp)
        rp = optax.apply_updates(rp, updates)
        re_ = jax.tree.map(lambda e, p: e * 0.999 + (1 - 0.999) * p, re_, rp)
    tp, te, ts = _port_run(t_tl.create_optimizer(3e-3, 0.01, warmup_steps=warmup),
                           params, grads, ema, 0.999, 1.0)
    _close(tp, rp, rtol=1e-5, atol=1e-6)
    _close(te, re_, rtol=1e-5, atol=1e-6)
    _close(ts["mu"], rs[0].mu, rtol=1e-5, atol=1e-7)
    if warmup:
        assert int(ts["schedule_count"]) == int(rs[-1].count) == 4


def test_fused_adafactor_matches_jax():
    params, grads, ema = _setup()
    ref = j_tl.FusedAdafactorEMA(3e-3, min_dim_size_to_factor=4, weight_decay=0.01,
                                 stochastic_rounding=False)
    rp, re_ = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, ema)
    rs = ref.init(rp)
    for g in grads:
        jg = jax.tree.map(jnp.asarray, g)
        scale = jnp.minimum(1.0, 1.0 / (optax.global_norm(jg) + 1e-6))
        rp, rs, re_ = ref.step(jg, rp, rs, re_, 0.999, scale)
    port = t_tl.FusedAdafactorEMA(3e-3, min_dim_size_to_factor=4, weight_decay=0.01,
                                  stochastic_rounding=False)
    tp, te, ts = _port_run(port, params, grads, ema, 0.999, 1.0)
    _close(tp, rp, rtol=1e-5, atol=1e-6)
    _close(te, re_, rtol=1e-5, atol=1e-6)
    for slot in ("v_row", "v_col", "v"):
        _close(ts[slot], getattr(rs[0], slot), rtol=1e-5, atol=1e-9)
    assert ts["v_row"]["w"].shape == (6,) and ts["v"]["w"].shape == (1,)
    assert ts["v_row"]["k"].shape == (3, 5) and ts["v_col"]["k"].shape == (3, 6)


def test_adafactor_groups_layers_as_stacked_leaves():
    """`layers.<i>.X` over i is one leaf: its update-clip RMS and parameter
    scale equal those of the stacked array, as in the JAX model's tree."""
    rng = np.random.RandomState(1)
    stacked = rng.randn(2, 8, 6).astype(np.float32)
    grad = (rng.randn(2, 8, 6) * 3).astype(np.float32)
    ref = j_tl.FusedAdafactorEMA(1e-2, min_dim_size_to_factor=4, stochastic_rounding=False)
    jp = {"layers": {"w": jnp.asarray(stacked)}}
    rs = ref.init(jp)
    rp, _, _ = ref.step({"layers": {"w": jnp.asarray(grad)}}, jp, rs, jp, 0.9, jnp.ones(()))
    port = t_tl.FusedAdafactorEMA(1e-2, min_dim_size_to_factor=4, stochastic_rounding=False)
    tp = {f"layers.{i}.w": torch.from_numpy(stacked[i].copy()) for i in range(2)}
    te = {n: p.clone() for n, p in tp.items()}
    port.step({f"layers.{i}.w": torch.from_numpy(grad[i]) for i in range(2)}, tp,
              port.init(tp), te, 0.9, torch.ones(()))
    got = np.stack([tp[f"layers.{i}.w"].numpy() for i in range(2)])
    np.testing.assert_allclose(got, np.asarray(rp["layers"]["w"]), rtol=1e-5, atol=1e-6)


def test_sr_noise_bits_match_jax():
    for seed in (0, 7, 123456):
        key = jax.random.PRNGKey(seed)
        ref = np.asarray(j_tl._sr_noise_bits(key, (5, 37)))
        got = t_tl._sr_noise_bits(np.asarray(key).tolist(), (5, 37)).numpy()
        np.testing.assert_array_equal(got.astype(np.uint32), ref)


def test_stochastic_round_bf16_bit_exact():
    x = np.random.default_rng(0).standard_normal((3, 41)).astype(np.float32) * 10
    for seed in (1, 99):
        key = jax.random.PRNGKey(seed)
        ref = np.asarray(j_tl._stochastic_round_bf16(jnp.asarray(x), key)).view(np.uint16)
        got = t_tl._stochastic_round_bf16(torch.from_numpy(x), np.asarray(key).tolist())
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16), ref)


def test_stochastic_round_exact_and_unbiased():
    x = torch.tensor([1.0, -2.5, 0.0, 0.15625])  # bf16-exact
    for seed in range(3):
        out = t_tl._stochastic_round_bf16(x, [seed, seed + 11])
        assert torch.equal(out.float(), x)
    # 25% of the way from bf16(1.0) to the next value: E[SR(x)] = x
    ulp = 2.0 ** -7
    vals = t_tl._stochastic_round_bf16(torch.full((4096,), 1.0 + 0.25 * ulp), [0, 3]).float()
    assert set(vals.unique().tolist()) <= {1.0, 1.0 + ulp}
    assert 0.20 < float((vals == 1.0 + ulp).float().mean()) < 0.30
    np.testing.assert_allclose(float(vals.mean()), 1.0 + 0.25 * ulp, atol=ulp / 50)


def test_bf16_params_round_stochastically():
    """bf16 params with a generator take the stochastic store: a sub-ulp
    update moves some elements; round to nearest moves none."""
    p = {"w": torch.ones(64, 64, dtype=torch.bfloat16)}
    g = {"w": torch.full((64, 64), 1e-3)}
    for sr, moved in ((True, True), (False, False)):
        params = {n: t.clone() for n, t in p.items()}
        ema = {n: t.clone() for n, t in p.items()}
        opt = t_tl.FusedAdafactorEMA(1e-4, min_dim_size_to_factor=4, stochastic_rounding=sr,
                                     multiply_by_parameter_scale=False)
        opt.step(g, params, opt.init(params), ema, 0.9, torch.ones(()),
                 generator=torch.Generator().manual_seed(0))
        assert bool((params["w"] != 1.0).any()) == moved

"""The port's transport and sampler (`lumina_t2x_tpu_torch/transport`,
`pipelines/sample_lib.py`, `pipelines/sample.py`) against the JAX package's.

Transport functions and the four fixed-step solvers are compared on a toy
drift; then the slice itself: the tiny NextDiT (dim 64, 2 layers, 4 heads,
caption dim 32, qk-norm, weights perturbed by 0.02 * N(0, 1) so the
zero-init layers do not zero the output) sampled by the port's
`build_t2i_sample_fn` and by the JAX `chunked` `chunk_fn` over the full grid,
from the same numpy noise, with and without the static-max calibration.
fp32 on the CPU. Bars: 1e-6 for the transport arithmetic, the repo's
torch-parity bar atol 2e-4 / rtol 2e-3 for the trajectories.
"""

import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumina_t2x_tpu import transport as j_tr
from lumina_t2x_tpu.pipelines import sample_lib as j_sl
from lumina_t2x_tpu.transport import solvers as j_solvers
from lumina_t2x_tpu_torch import transport as t_tr
from lumina_t2x_tpu_torch.pipelines import sample_lib as t_sl
from lumina_t2x_tpu_torch.transport import solvers as t_solvers

from test_torch_next_dit import _pair

jfa = importlib.import_module("lumina_t2x_tpu.ops.flash_attention")
tfa = importlib.import_module("lumina_t2x_tpu_torch.ops.flash_attention")


@pytest.fixture(autouse=True)
def _reset_bounds(monkeypatch):
    """The static-max bound is module state in both packages."""
    for var in ("LUMINA_FLASH_STATIC_MAX", "LUMINA_FLASH_STATIC_MAX_AUTO",
                "LUMINA_FLASH_CALIBRATE"):
        monkeypatch.delenv(var, raising=False)
    jfa.set_flash_static_max(None)
    tfa.set_flash_static_max(None)
    yield
    jfa.set_flash_static_max(None)
    tfa.set_flash_static_max(None)


@pytest.mark.parametrize("factor", [None, 1.0, 4.0])
def test_time_grid(factor):
    got = t_solvers.make_time_grid(0.0, 1.0, 30, factor)
    ref = j_solvers.make_time_grid(0.0, 1.0, 30, factor)
    assert got.dtype == torch.float32 and got.shape == (30,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-7, rtol=1e-6)


def test_linear_path():
    rng = np.random.default_rng(0)
    x0, x1 = rng.standard_normal((2, 3, 4, 4)).astype(np.float32)
    x0, x1 = x0[None].repeat(3, 0), x1[None].repeat(3, 0)
    t = np.array([0.2, 0.5, 0.9], np.float32)
    tp, jp = t_tr.LinearPath(), j_tr.LinearPath()
    tt, jt = torch.from_numpy(t), jnp.asarray(t)
    pairs = [
        (tp.interpolant(tt, torch.from_numpy(x0), torch.from_numpy(x1)),
         jp.interpolant(jt, jnp.asarray(x0), jnp.asarray(x1))),
        (tp.drift(torch.from_numpy(x1), tt), jp.drift(jnp.asarray(x1), jt)),
        ((tp.velocity_to_score(torch.from_numpy(x0), torch.from_numpy(x1), tt),),
         (jp.velocity_to_score(jnp.asarray(x0), jnp.asarray(x1), jt),)),
    ]
    for got, ref in pairs:
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.broadcast_to(np.asarray(r), g.shape),
                                       atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("prediction", ["velocity", "noise", "score"])
def test_transport_interval_and_drift(prediction):
    tt, jt = t_tr.create_transport("Linear", prediction), j_tr.create_transport("Linear", prediction)
    for kw in (dict(), dict(eval=True), dict(reverse=True), dict(sde=True, eval=True)):
        assert tt.check_interval(tt.train_eps, tt.sample_eps, **kw) == pytest.approx(
            jt.check_interval(jt.train_eps, jt.sample_eps, **kw))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 4, 4)).astype(np.float32)
    t = np.array([0.3, 0.6], np.float32)
    got = tt.get_drift()(torch.from_numpy(x), torch.from_numpy(t), lambda a, b: torch.sin(a))
    ref = jt.get_drift()(jnp.asarray(x), jnp.asarray(t), lambda a, b: jnp.sin(a))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def _toy_drift_t(x, t):
    return torch.sin(x) * (1.0 - t) - 0.5 * x * t


def _toy_drift_j(x, t):
    return jnp.sin(x) * (1.0 - t) - 0.5 * x * t


@pytest.mark.parametrize("method", ["euler", "midpoint", "heun", "rk4"])
def test_odeint_fixed(method):
    x0 = np.random.default_rng(2).standard_normal((2, 5)).astype(np.float32)
    ts = j_solvers.make_time_grid(0.0, 1.0, 7, 4.0)
    ref = j_solvers.odeint_fixed(_toy_drift_j, jnp.asarray(x0), ts, method=method, return_all=True)
    got = t_solvers.odeint_fixed(_toy_drift_t, torch.from_numpy(x0),
                                 t_solvers.make_time_grid(0.0, 1.0, 7, 4.0), method=method,
                                 return_all=True)
    assert got.shape == (7, 2, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-5)


def test_sample_ode_and_guards():
    x0 = np.random.default_rng(3).standard_normal((2, 3)).astype(np.float32)
    kw = dict(sampling_method="midpoint", num_steps=9, time_shifting_factor=4.0)
    got = t_tr.Sampler(t_tr.create_transport()).sample_ode(**kw)(
        torch.from_numpy(x0), lambda x, t: _toy_drift_t(x, t[:, None]))
    ref = j_tr.Sampler(j_tr.create_transport()).sample_ode(**kw)(
        jnp.asarray(x0), lambda x, t: _toy_drift_j(x, t[:, None]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-5)
    with pytest.raises(NotImplementedError):
        t_tr.Sampler(t_tr.create_transport()).sample_ode(sampling_method="dopri5")
    with pytest.raises(NotImplementedError):
        t_tr.create_transport("VP")


# -- the slice: tiny NextDiT, CFG 4, time-shift 4, midpoint ------------------------

CAP_LEN = 6


def _slice_inputs(seed, lh, lw):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((1, 4, lh, lw)).astype(np.float32)
    cap = rng.standard_normal((2, CAP_LEN, 32)).astype(np.float32)
    mask = np.ones((2, CAP_LEN), np.int32)
    mask[1, 4:] = 0
    return z, cap, mask


def _jax_trajectory(jmodel, params, z, cap, mask, width, height, num_steps):
    ts, _, chunk_fn, finalize = j_sl.build_t2i_sample_fn(
        jmodel, width=width, height=height, num_steps=num_steps, solver="midpoint",
        cfg_scale=4.0, time_shifting_factor=4.0, chunked=True)
    zz = jnp.concatenate([jnp.asarray(z)] * 2, axis=0)
    return np.asarray(finalize(jax.jit(chunk_fn)({"params": params}, zz, ts,
                                                 jnp.asarray(cap), jnp.asarray(mask))))


def _port_trajectory(tmodel, z, cap, mask, width, height, num_steps):
    fn = t_sl.build_t2i_sample_fn(tmodel, width=width, height=height, num_steps=num_steps,
                                  solver="midpoint", cfg_scale=4.0, time_shifting_factor=4.0)
    return fn(*map(torch.from_numpy, (z, cap, mask))).numpy()


def _count_calls(monkeypatch, name):
    calls = []
    fn = getattr(tfa, name)
    monkeypatch.setattr(tfa, name, lambda *a, **k: calls.append(1) or fn(*a, **k))
    return calls


def test_slice_with_calibration_matches_jax(monkeypatch):
    """1088 image tokens (latent 16x272): the self-attention streams, so
    both packages calibrate a static bound and sample with it."""
    jmodel, params, tmodel = _pair(jax_impl="flash")
    z, cap, mask = _slice_inputs(4, 16, 272)
    width, height = 272 * 8, 16 * 8
    rng = jax.random.PRNGKey(5)
    probe_z = np.array(jax.random.normal(rng, (1, 4, 16, 272)))
    kw = dict(width=width, height=height, cfg_scale=4.0, time_shifting_factor=4.0,
              num_probe_steps=2)
    j_bound = j_sl.autocalibrate_flash_static_max(
        jmodel, {"params": params}, jnp.asarray(cap), jnp.asarray(mask), rng=rng, **kw)
    t_bound = t_sl.autocalibrate_flash_static_max(
        tmodel, torch.from_numpy(cap), torch.from_numpy(mask), z=torch.from_numpy(probe_z), **kw)
    assert j_bound is not None and t_bound is not None
    assert abs(t_bound - j_bound) <= 1e-3
    assert tfa.get_flash_static_max() == t_bound and jfa.get_flash_static_max() == j_bound

    ref = _jax_trajectory(jmodel, params, z, cap, mask, width, height, 3)
    static_calls = _count_calls(monkeypatch, "flash_static_max_plain")
    got = _port_trajectory(tmodel, z, cap, mask, width, height, 3)
    assert len(static_calls) == 2 * 2 * 2  # 2 midpoint steps x 2 forwards x 2 layers
    assert got.shape == (1, 4, 16, 272) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=2e-3)


def test_slice_without_calibration_matches_jax(monkeypatch):
    """64 image tokens: nothing streams, calibration declines on both sides
    and the trajectory runs the small-KV path."""
    jmodel, params, tmodel = _pair()
    z, cap, mask = _slice_inputs(6, 16, 16)
    kw = dict(width=128, height=128, num_probe_steps=2)
    assert j_sl.autocalibrate_flash_static_max(
        jmodel, {"params": params}, jnp.asarray(cap), jnp.asarray(mask), **kw) is None
    assert t_sl.autocalibrate_flash_static_max(
        tmodel, torch.from_numpy(cap), torch.from_numpy(mask), **kw) is None
    ref = _jax_trajectory(jmodel, params, z, cap, mask, 128, 128, 5)
    static_calls = _count_calls(monkeypatch, "flash_static_max_plain")
    got = _port_trajectory(tmodel, z, cap, mask, 128, 128, 5)
    assert not static_calls
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=2e-3)


def test_calibration_guards(monkeypatch):
    _, _, tmodel = _pair()
    cap, mask = torch.zeros(2, CAP_LEN, 32), torch.ones(2, CAP_LEN, dtype=torch.int32)
    kw = dict(width=2176, height=128, num_probe_steps=1)
    monkeypatch.setenv("LUMINA_FLASH_STATIC_MAX", "12.0")
    assert t_sl.autocalibrate_flash_static_max(tmodel, cap, mask, **kw) is None
    monkeypatch.delenv("LUMINA_FLASH_STATIC_MAX")
    monkeypatch.setenv("LUMINA_FLASH_STATIC_MAX_AUTO", "0")
    assert t_sl.autocalibrate_flash_static_max(tmodel, cap, mask, **kw) is None
    monkeypatch.delenv("LUMINA_FLASH_STATIC_MAX_AUTO")
    _, _, no_qk = _pair(qk_norm=False)
    assert t_sl.autocalibrate_flash_static_max(no_qk, cap, mask, **kw) is None
    assert tfa.get_flash_static_max() is None


def test_cli_writes_latents_and_manifest(tmp_path, capsys):
    from lumina_t2x_tpu_torch.pipelines.sample import main

    out_dir = tmp_path / "samples"
    manifest = main(["--model", "NextDiT_Tiny_patch2", "--qk_norm", "--debug",
                     "--device", "cpu", "--precision", "fp32", "--cap_feat_dim", "32",
                     "--resolution", "1:2176x128", "1:128x128", "--num_sampling_steps", "3",
                     "--solver", "midpoint", "--cfg_scale", "4.0",
                     "--time_shifting_factor", "4", "--image_save_path", str(out_dir)])
    assert "flash static-max calibrated" in capsys.readouterr().out
    with open(out_dir / "data.json") as f:
        on_disk = json.load(f)
    assert len(on_disk["items"]) == len(manifest["items"]) == 2
    shapes = {(4, 16, 272), (4, 16, 16)}
    for item in on_disk["items"]:
        lat = np.load(item["path"])
        assert os.path.dirname(item["path"]) == str(out_dir)
        assert lat.shape in shapes and np.isfinite(lat).all()
        assert item["steps"] == 3 and item["solver"] == "midpoint"

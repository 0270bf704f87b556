"""The port's transport (`lumina_t2x_tpu_torch/transport`) against the JAX
package's: the VP and GVP paths beside the linear one (coefficients,
interpolants, drifts, diffusion forms, parameterization conversions), the
integration intervals and the `create_transport` eps rules, the drift and
score of each prediction, the adaptive solvers (dopri5, dopri8) with their
evaluation counts, the SDE solvers and samplers with the JAX noise handed in,
the CFG wrappers, and a dopri5 trajectory of the Tiny NextDiT-ImageNet.

fp32 on the CPU, inputs from numpy seeds. Bar: atol 2e-4 / rtol 2e-3 unless
a case states otherwise. The adaptive solvers run at tolerances above fp32
resolution (1e-5): below it the error estimate of a step is rounding noise,
its accept/reject decisions follow the order of the floating-point
operations, and the JAX solver itself takes a different number of steps
under `jit` than op by op. Their results are held to 1e-4, ten times the
solver's tolerance: two step sequences each within it may differ by more
than the tolerance itself.
"""

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

from flax import traverse_util

from lumina_t2x_tpu.models import next_dit_imagenet as j_ni
from lumina_t2x_tpu_torch.core.checkpoint import imagenet_state_dict_from_jax_params
from lumina_t2x_tpu_torch.models import next_dit_imagenet as t_ni

ATOL, RTOL = 2e-4, 2e-3
PATHS = ["Linear", "GVP", "VP"]


def _close(got, ref, atol=ATOL, rtol=RTOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=atol, rtol=rtol,
                               err_msg=what)


def _xt(seed, b=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 2, 4, 4)).astype(np.float32)
    t = rng.uniform(0.05, 0.95, b).astype(np.float32)
    return x, t


# -- paths -----------------------------------------------------------------------------


@pytest.mark.parametrize("path", PATHS)
def test_path_coefficients_and_conversions_match_jax(path):
    jp = j_tr.create_transport(path).path_sampler
    tp = t_tr.create_transport(path).path_sampler
    x, t = _xt(1)
    x1 = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    v = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)
    jx, jt, jx1, jv = map(jnp.asarray, (x, t, x1, v))
    tx, tt, tx1, tv = map(torch.from_numpy, (x, t, x1, v))
    for name in ("alpha_t", "sigma_t"):
        for g, r in zip(getattr(tp, name)(tt), getattr(jp, name)(jt)):
            _close(g, r, what=name)
    _close(tp.d_alpha_alpha_ratio(tt), jp.d_alpha_alpha_ratio(jt))
    for g, r in zip(tp.interpolant(tt, tx, tx1), jp.interpolant(jt, jx, jx1)):
        _close(g, r, what="interpolant")
    for g, r in zip(tp.drift(tx, tt), jp.drift(jx, jt)):
        _close(np.broadcast_to(g, x.shape), np.broadcast_to(r, x.shape), what="drift")
    for form in ("constant", "SBDM", "sigma", "linear", "decreasing", "increasing-decreasing"):
        got = tp.diffusion(tx, tt, form=form, norm=0.7)
        ref = jp.diffusion(jx, jt, form=form, norm=0.7)
        _close(np.broadcast_to(got, x.shape), np.broadcast_to(ref, x.shape), what=form)
    with pytest.raises(NotImplementedError):
        tp.diffusion(tx, tt, form="nope")
    for name in ("velocity_to_score", "velocity_to_noise", "score_to_velocity"):
        _close(getattr(tp, name)(tv, tx, tt), getattr(jp, name)(jv, jx, jt), what=name)


@pytest.mark.parametrize("path", PATHS)
def test_intervals_eps_rules_and_prior_match_jax(path):
    for prediction in ("velocity", "score", "noise"):
        jt, tt = (m.create_transport(path, prediction) for m in (j_tr, t_tr))
        assert (tt.train_eps, tt.sample_eps) == (jt.train_eps, jt.sample_eps), prediction
        for kw in (dict(), dict(eval=True), dict(sde=True, eval=True, last_step_size=0.04),
                   dict(sde=True, diffusion_form="sigma"), dict(reverse=True, eval=True),
                   dict(sde=True, eval=True)):
            got = tt.check_interval(tt.train_eps, tt.sample_eps, **kw)
            ref = jt.check_interval(jt.train_eps, jt.sample_eps, **kw)
            np.testing.assert_allclose(got, ref, rtol=1e-12, err_msg=f"{prediction} {kw}")
    z = np.random.default_rng(4).standard_normal((3, 2, 4, 4)).astype(np.float32)
    _close(tt.prior_logp(torch.from_numpy(z)), jt.prior_logp(jnp.asarray(z)), atol=1e-4,
           rtol=1e-6)
    with pytest.raises(KeyError):
        t_tr.create_transport("nope")


def _toy_model(mod):
    w = np.random.default_rng(9).standard_normal((2, 2)).astype(np.float32) * 0.5
    if mod is jnp:
        return lambda x, t: jnp.einsum("ij,bjhw->bihw", w, x) * (1.0 + t[:, None, None, None])
    tw = torch.from_numpy(w)
    return lambda x, t: torch.einsum("ij,bjhw->bihw", tw, x) * (1.0 + t[:, None, None, None])


@pytest.mark.parametrize("path", PATHS)
def test_drift_and_score_of_each_prediction_match_jax(path):
    x, t = _xt(5)
    for prediction in ("velocity", "score", "noise"):
        jt, tt = (m.create_transport(path, prediction) for m in (j_tr, t_tr))
        for fn in ("get_drift", "get_score"):
            got = getattr(tt, fn)()(torch.from_numpy(x), torch.from_numpy(t), _toy_model(torch))
            ref = getattr(jt, fn)()(jnp.asarray(x), jnp.asarray(t), _toy_model(jnp))
            _close(got, ref, what=f"{prediction} {fn}")


# -- adaptive solvers --------------------------------------------------------------------

_A = np.array([[-1.0, 0.0], [0.0, -50.0]], np.float32)
# name: (JAX drift, port drift, x0, (t0, t1, points))
ODE_CASES = {
    "exp": (lambda x, t: -x, lambda x, t: -x, np.ones((2, 2), np.float32), (0.0, 1.0, 5)),
    "stiff": (lambda x, t: jnp.asarray(_A) @ x, lambda x, t: torch.from_numpy(_A) @ x,
              np.ones((2,), np.float32), (0.0, 1.0, 3)),
    "pytree": (lambda s, t: (-s[0], jnp.ones_like(s[1])),
               lambda s, t: (-s[0], torch.ones_like(s[1])),
               (np.ones((), np.float32), np.zeros((), np.float32)), (0.0, 1.0, 3)),
    "sin3t_dense": (lambda x, t: jnp.sin(3.0 * t) * x, lambda x, t: torch.sin(3.0 * t) * x,
                    np.array([1.0, 2.0], np.float32), (0.0, 1.0, 50)),
    "cos4t": (lambda x, t: jnp.cos(4.0 * t) * x, lambda x, t: torch.cos(4.0 * t) * x,
              np.array([0.5, 1.5], np.float32), (0.0, 1.0, 40)),
    "cos10t": (lambda x, t: jnp.cos(10.0 * t) * x, lambda x, t: torch.cos(10.0 * t) * x,
               np.ones((), np.float32), (0.0, 1.0, 2)),
    "descending": (lambda x, t: -x, lambda x, t: -x, np.ones((), np.float32), (1.0, 0.0, 4)),
    "descending_t": (lambda x, t: 2.0 * jnp.ones_like(x) * t,
                     lambda x, t: 2.0 * torch.ones_like(x) * t,
                     np.ones((), np.float32), (1.0, 0.0, 3)),
}


def _jax_counted(solver, drift, x0, ts, **kw):
    """The JAX solver under jit, with its drift evaluations counted."""
    count = [0]

    def inc():
        count[0] += 1

    def f(x, t):
        jax.debug.callback(inc, ordered=True)
        return drift(x, t)

    out = jax.jit(lambda x: solver(f, x, ts, **kw))(jax.tree.map(jnp.asarray, x0))
    jax.effects_barrier()
    return out, count[0]


@pytest.mark.parametrize("solver", ["odeint_adaptive", "odeint_dopri8"])
@pytest.mark.parametrize("case", sorted(ODE_CASES))
def test_adaptive_solvers_match_jax_with_equal_nfe(case, solver):
    jf, tf, x0, (a, b, n) = ODE_CASES[case]
    ts = np.linspace(a, b, n).astype(np.float32)
    return_all = case in ("sin3t_dense", "descending")
    kw = dict(atol=1e-5, rtol=1e-5, return_all=return_all)
    ref, ref_nfe = _jax_counted(getattr(j_solvers, solver), jf, x0, ts, **kw)
    tx0 = tuple(map(torch.from_numpy, x0)) if isinstance(x0, tuple) else torch.from_numpy(x0)
    got, nfe = getattr(t_solvers, solver)(tf, tx0, torch.from_numpy(ts), **kw)
    assert nfe == ref_nfe
    for g, r in zip(got if isinstance(got, tuple) else [got], jax.tree.leaves(ref)):
        assert g.shape == r.shape
        _close(g, r, atol=1e-4, rtol=1e-4)


def test_adaptive_solvers_reach_the_analytic_solutions():
    """x' = -x on ascending and descending grids, the dense output at the
    save points, and a tuple state."""
    ts = torch.linspace(0.0, 1.0, 11)
    traj, _ = t_solvers.odeint_adaptive(lambda x, t: -x, torch.ones(()), ts, atol=1e-6,
                                        rtol=1e-6, return_all=True)
    _close(traj, np.exp(-ts.numpy()), atol=1e-5, rtol=1e-5)
    for solver in (t_solvers.odeint_adaptive, t_solvers.odeint_dopri8):
        out, _ = solver(lambda x, t: -x, torch.ones(2), torch.linspace(1.0, 0.0, 5), atol=1e-6,
                        rtol=1e-6)
        _close(out, np.full(2, np.e), atol=1e-5, rtol=1e-5)
        (a, b), _ = solver(lambda s, t: (-s[0], torch.ones_like(s[1])),
                           (torch.ones(()), torch.zeros(())), torch.linspace(0.0, 1.0, 3),
                           atol=1e-6, rtol=1e-6)
        _close([a, b], [np.exp(-1.0), 1.0], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("method", ["dopri5", "dopri8", "midpoint"])
@pytest.mark.parametrize("reverse", [False, True])
def test_sample_ode_matches_jax(method, reverse):
    x0 = np.random.default_rng(3).standard_normal((2, 2, 4, 4)).astype(np.float32)
    kw = dict(sampling_method=method, num_steps=5, atol=1e-5, rtol=1e-5, reverse=reverse,
              time_shifting_factor=2.0)
    fn = t_tr.Sampler(t_tr.create_transport()).sample_ode(**kw)
    got = fn(torch.from_numpy(x0), _toy_model(torch))
    jfn = j_tr.Sampler(j_tr.create_transport()).sample_ode(**kw)
    ref = jax.jit(lambda x: jfn(x, _toy_model(jnp)))(jnp.asarray(x0))
    _close(got, ref, atol=1e-5, rtol=1e-5)
    assert fn.nfe == 8 if method == "midpoint" else fn.nfe > 6
    with pytest.raises(NotImplementedError):
        t_tr.Sampler(t_tr.create_transport()).sample_ode(sampling_method="nope")(
            torch.from_numpy(x0), _toy_model(torch))


# -- SDE ---------------------------------------------------------------------------------


def _jax_sde_noise(rng, shape, steps):
    """The Gaussian draws `sdeint` makes from `rng`, one per step."""
    out = []
    for _ in range(steps):
        rng, sub = jax.random.split(rng)
        out.append(torch.from_numpy(np.array(jax.random.normal(sub, shape, jnp.float32))))
    return out


@pytest.mark.parametrize("method", ["euler", "heun"])
def test_sdeint_matches_jax_with_its_noise(method):
    x0 = np.random.default_rng(6).standard_normal((2, 3)).astype(np.float32)
    ts = np.linspace(0.1, 0.9, 7).astype(np.float32)
    rng = jax.random.PRNGKey(11)
    jd = lambda x, t: -x * (1.0 + t)
    td = lambda x, t: -x * (1.0 + t)
    jg = lambda x, t: 0.1 * jnp.ones_like(x) * t
    tg = lambda x, t: 0.1 * torch.ones_like(x) * t
    ref = j_solvers.sdeint(jd, jg, jnp.asarray(x0), jnp.asarray(ts), rng, method=method)
    noise = _jax_sde_noise(rng, x0.shape, len(ts) - 1)
    got = t_solvers.sdeint(td, tg, torch.from_numpy(x0), torch.from_numpy(ts), method=method,
                           noise=noise)
    for g, r in zip(got, ref):
        _close(g, r, atol=1e-5, rtol=1e-5)
    traj = t_solvers.sdeint(td, tg, torch.from_numpy(x0), torch.from_numpy(ts), method=method,
                            noise=noise, return_all=True)
    ref_traj = j_solvers.sdeint(jd, jg, jnp.asarray(x0), jnp.asarray(ts), rng, method=method,
                                return_all=True)
    _close(traj, ref_traj, atol=1e-5, rtol=1e-5)
    drawn = t_solvers.sdeint(td, tg, torch.from_numpy(x0), torch.from_numpy(ts),
                             generator=torch.Generator().manual_seed(0), method=method)
    assert drawn[0].shape == x0.shape and torch.isfinite(drawn[0]).all()
    with pytest.raises(NotImplementedError):
        t_solvers.sdeint(td, tg, torch.from_numpy(x0), torch.from_numpy(ts), method="nope")


@pytest.mark.parametrize("last_step,path,prediction", [
    (None, "Linear", "velocity"), ("Mean", "GVP", "score"), ("Tweedie", "VP", "noise"),
    ("Euler", "Linear", "score")])
def test_sample_sde_matches_jax(last_step, path, prediction):
    """Each last step on its own path and prediction (Heun under "Euler",
    the sigma diffusion form on VP)."""
    x0 = np.random.default_rng(8).standard_normal((2, 2, 4, 4)).astype(np.float32)
    kw = dict(sampling_method="Euler" if last_step != "Euler" else "Heun",
              diffusion_form="SBDM" if path != "VP" else "sigma", last_step=last_step,
              last_step_size=0.04, num_steps=6)
    rng = jax.random.PRNGKey(2)
    jfn = j_tr.Sampler(j_tr.create_transport(path, prediction)).sample_sde(**kw)
    ref = jax.jit(lambda r, x: jfn(r, x, _toy_model(jnp)))(rng, jnp.asarray(x0))
    noise = _jax_sde_noise(rng, x0.shape, kw["num_steps"] - 1)
    got = t_tr.Sampler(t_tr.create_transport(path, prediction)).sample_sde(**kw)(
        torch.from_numpy(x0), _toy_model(torch), noise=noise)
    scale = max(1.0, float(np.abs(np.asarray(ref)).max()))
    _close(got, ref, atol=ATOL * scale)


# -- CFG ---------------------------------------------------------------------------------


@pytest.mark.parametrize("channels", [3, -1])
def test_cfg_wrappers_match_jax(channels):
    x = np.random.default_rng(10).standard_normal((4, 4, 3, 3)).astype(np.float32)
    for t_val in (0.2, 0.8):
        t = np.full((4,), t_val, np.float32)
        got = t_tr.cfg_wrapper(_toy4(torch), 3.0, channels)(torch.from_numpy(x),
                                                            torch.from_numpy(t))
        ref = j_tr.cfg_wrapper(_toy4(jnp), 3.0, channels)(jnp.asarray(x), jnp.asarray(t))
        _close(got, ref, atol=1e-6, rtol=1e-6)
        got = t_tr.cfg_interval_wrapper(_toy4(torch), 3.0, channels, 0.0, 0.5)(
            torch.from_numpy(x), torch.from_numpy(t))
        ref = j_tr.cfg_interval_wrapper(_toy4(jnp), 3.0, channels, 0.0, 0.5)(
            jnp.asarray(x), jnp.asarray(t))
        _close(got, ref, atol=1e-6, rtol=1e-6)


def _toy4(mod):
    """A model whose two half-batches differ: rows scale by their index."""
    def fn(x, t):
        scale = mod.arange(x.shape[0], dtype=x.dtype)[:, None, None, None] + 1.0
        return x * scale * (1.0 + t[:, None, None, None])
    return fn


# -- the Tiny NextDiT-ImageNet under dopri5 ----------------------------------------------


def _strong_pair(scale):
    """The Tiny NextDiT-ImageNet in both packages with every parameter
    perturbed by `scale` * N(0, 1): strong enough that the velocity bends
    along the trajectory and dopri5's error estimate is its truncation
    error, not rounding noise."""
    jmodel = j_ni.NextDiT_ImageNet_Tiny_patch2(attn_impl="xla")
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(3), jnp.zeros((1, 4, 8, 8)),
                                     jnp.zeros((1,)), jnp.zeros((1,), jnp.int32))
    flat = traverse_util.flatten_dict(jax.tree.map(np.asarray, variables["params"]))
    rng = np.random.default_rng(3)
    params = traverse_util.unflatten_dict(
        {k: (v + scale * rng.standard_normal(v.shape)).astype(np.float32)
         for k, v in flat.items()})
    tmodel = t_ni.NextDiT_ImageNet_Tiny_patch2().eval()
    tmodel.load_state_dict(imagenet_state_dict_from_jax_params(params), strict=True)
    return jmodel, params, tmodel


def test_class_cond_dopri5_trajectory_matches_jax(monkeypatch):
    """The class-conditional sampler with `solver="dopri5"` at the JAX
    branch's default tolerances, from the same weights and noise: the same
    latents within the bar and the same number of model evaluations."""
    jmodel, params, tmodel = _strong_pair(0.1)
    labels = np.array([5, 42], np.int32)
    rng = jax.random.PRNGKey(7)
    kw = dict(num_steps=3, solver="dopri5", cfg_scale=4.0, latent_size=8, in_channels=4)
    count = [0]

    def inc():
        count[0] += 1

    real_cfg = j_sl.imagenet_cfg

    def counted_cfg(*a, **k):
        jax.debug.callback(inc, ordered=True)
        return real_cfg(*a, **k)

    monkeypatch.setattr(j_sl, "imagenet_cfg", counted_cfg)
    ref = jax.jit(j_sl.build_class_cond_sample_fn(jmodel, **kw))(
        {"params": params}, rng, jnp.asarray(labels))
    jax.effects_barrier()
    z = np.array(jax.random.normal(rng, (2, 4, 8, 8)))
    fn = t_sl.build_class_cond_sample_fn(tmodel, **kw)
    got = fn(torch.from_numpy(z), torch.from_numpy(labels).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    assert fn.nfe == count[0] > 7

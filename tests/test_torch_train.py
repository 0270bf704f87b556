"""The port's training slice against the JAX package's: `sample_t` and
`Transport.training_losses` (`lumina_t2x_tpu_torch/transport`), remat
(`models/layers.maybe_remat`), the train step, the train-side calibration
and the state bridge (`pipelines/train_lib.py`, `core/checkpoint.py`), and
the trainer CLI (`pipelines/train.py`).

Train steps run the tiny NextDiT (dim 64, 2 layers, 4 heads, caption dim 32,
qk-norm, every parameter perturbed by 0.02 * N(0, 1) so no zero-init layer
zeroes the gradients) from one state carried over by
`train_state_from_jax`. The JAX model uses `attn_impl="flash"`, so its
custom_vjp runs the Pallas LSE forward and backward kernels in interpret
mode. The port gets the JAX step's draws (fold_in -> split -> split ->
sample_t / normal) as tensors. fp32 on the CPU; bar atol 2e-4 / rtol 2e-3,
with the optimizer moments held relative to their largest element (their
values are ~1e-6 of the parameters'); remat against no remat to 1e-6.
"""

import functools
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumina_t2x_tpu import transport as j_tr
from lumina_t2x_tpu.models import next_dit as j_nd
from lumina_t2x_tpu.pipelines import train_lib as j_tl
from lumina_t2x_tpu_torch import transport as t_tr
from lumina_t2x_tpu_torch.core.checkpoint import state_dict_from_jax_params, train_state_from_jax
from lumina_t2x_tpu_torch.models import layers as t_layers
from lumina_t2x_tpu_torch.models import next_dit as t_nd
from lumina_t2x_tpu_torch.pipelines import train_lib as t_tl

from test_torch_next_dit import TINY, _randomized_params

jfa = importlib.import_module("lumina_t2x_tpu.ops.flash_attention")
tfa = importlib.import_module("lumina_t2x_tpu_torch.ops.flash_attention")
ATOL, RTOL = 2e-4, 2e-3


@pytest.fixture(autouse=True)
def _reset_bounds(monkeypatch):
    for var in ("LUMINA_FLASH_STATIC_MAX", "LUMINA_FLASH_STATIC_MAX_TRAIN",
                "LUMINA_FLASH_STATIC_MAX_AUTO", "LUMINA_FLASH_CALIBRATE",
                "LUMINA_FLASH_FUSED_BWD"):
        monkeypatch.delenv(var, raising=False)

    def clear():
        for m in (jfa, tfa):
            m.set_flash_static_max(None)
            m.set_flash_static_max_train(None)

    clear()
    yield
    clear()


# -- transport ---------------------------------------------------------------------


@pytest.mark.parametrize("snr_type", ["uniform", "uniform_0.2_0.7", "lognorm", "shift_3.0"])
def test_sample_t_matches_jax(snr_type):
    rng = jax.random.PRNGKey(3)
    ref = np.asarray(j_tr.transport.sample_t(rng, 7, snr_type))
    draw = (jax.random.normal if snr_type == "lognorm" else jax.random.uniform)(rng, (7,))
    got = t_tr.sample_t(7, snr_type, draw=torch.from_numpy(np.asarray(draw)))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=1e-6)
    gen = torch.Generator().manual_seed(0)
    assert t_tr.sample_t(5, snr_type, generator=gen).shape == (5,)
    with pytest.raises(ValueError):
        t_tr.sample_t(3, "shift_x")


@pytest.mark.parametrize("masked", [False, True])
def test_training_losses_match_jax(masked):
    rng = np.random.default_rng(0)
    x1 = rng.standard_normal((3, 4, 6, 6)).astype(np.float32)
    mask = (rng.uniform(size=x1.shape) > 0.3).astype(np.float32) if masked else None
    key = jax.random.PRNGKey(11)
    jt = j_tr.create_transport("Linear", "velocity", snr_type="lognorm")
    ref = jt.training_losses(key, lambda x, t: jnp.sin(x) * t[:, None, None, None],
                             jnp.asarray(x1), loss_mask=None if mask is None else jnp.asarray(mask))
    t_key, noise_key = jax.random.split(key)
    t = j_tr.transport.sample_t(t_key, 3, "lognorm")
    x0 = jax.random.normal(noise_key, x1.shape)
    tt = t_tr.create_transport("Linear", "velocity", snr_type="lognorm")
    got = tt.training_losses(lambda x, t_: torch.sin(x) * t_[:, None, None, None],
                             torch.from_numpy(x1),
                             loss_mask=None if mask is None else torch.from_numpy(mask),
                             t=torch.from_numpy(np.asarray(t)), x0=torch.from_numpy(np.asarray(x0)))
    np.testing.assert_allclose(got["loss"].numpy(), np.asarray(ref["loss"]), atol=1e-6, rtol=1e-5)
    assert not got["task_loss"].requires_grad
    np.testing.assert_allclose(t_tr.mean_flat(torch.from_numpy(x1)).numpy(),
                               np.asarray(j_tr.transport.mean_flat(jnp.asarray(x1))), atol=1e-6)


# -- the pair of models ----------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _params():
    return _randomized_params(j_nd.NextDiT(qk_norm=True, **TINY), 2)


def _batch(seed, h=8, w=8, b=2, ly=9):
    rng = np.random.default_rng(seed)
    cap_mask = np.ones((b, ly), np.int32)
    cap_mask[0, 6:] = 0
    return {"x": rng.standard_normal((b, 4, h, w)).astype(np.float32),
            "cap_feats": rng.standard_normal((b, ly, TINY["cap_feat_dim"])).astype(np.float32),
            "cap_mask": cap_mask}


def _jcond(b):
    return {"cap_feats": b["cap_feats"], "cap_mask": b["cap_mask"]}


_tcond = _jcond


def _port_model(params, **kw):
    model = t_nd.NextDiT(qk_norm=True, **TINY, **kw)
    model.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return model


# -- remat -------------------------------------------------------------------------------


def _port_grads(model, batch, t):
    model.zero_grad()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = model(tb["x"], torch.from_numpy(t), tb["cap_feats"], tb["cap_mask"], train=True)
    (out ** 2).mean().backward()
    return {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}


@pytest.mark.parametrize("policy", ["full", "dots", "dots_slim"])
def test_remat_gradients_match_no_remat(monkeypatch, policy):
    batch, t = _batch(1), np.array([0.3, 0.8], np.float32)
    ref = _port_grads(_port_model(_params()), batch, t)
    saved = []
    if policy != "full":
        fn = t_layers.REMAT_POLICIES[policy]

        def recording(ctx, op, *args, **kwargs):
            decision = fn(ctx, op, *args, **kwargs)
            if not ctx.is_recompute and decision == t_layers.CheckpointPolicy.MUST_SAVE:
                saved.append(op)
            return decision

        monkeypatch.setitem(t_layers.REMAT_POLICIES, policy, recording)
    calls = []
    lse_fwd = tfa.flash_online_lse_plain
    monkeypatch.setattr(tfa, "flash_online_lse_plain",
                        lambda *a, **k: calls.append(1) or lse_fwd(*a, **k))
    got = _port_grads(_port_model(_params(), remat=True, remat_policy=policy), batch, t)
    assert sorted(got) == sorted(ref)
    for name in ref:
        np.testing.assert_allclose(got[name].numpy(), ref[name].numpy(), atol=1e-6, rtol=1e-6,
                                   err_msg=name)
    # the recompute re-runs the attention Function's forward: 2 layers x
    # (self + cross) attention, twice
    assert len(calls) == 2 * 2 * 2
    mm = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}
    assert set(saved) <= mm
    # dots: the 10 weight matmuls of a block (adaLN, wq, wk, wv, wo, wk_y,
    # wv_y, w1, w2, w3); dots_slim drops the expanding ones (adaLN 64->256,
    # wk_y/wv_y 32->64, w1/w3 64->176)
    assert len(saved) == {"full": 0, "dots": 2 * 10, "dots_slim": 2 * 5}[policy]


def test_remat_recompute_reads_the_same_train_bound(monkeypatch):
    """1088 image tokens stream, so the train bound applies; the forward and
    its recompute both run the static-max LSE forward with that bound."""
    tfa.set_flash_static_max_train(30.0)
    bounds = []
    fwd = tfa.flash_static_max_lse_plain
    monkeypatch.setattr(tfa, "flash_static_max_lse_plain",
                        lambda *a: bounds.append(a[-1]) or fwd(*a))
    _port_grads(_port_model(_params(), remat=True), _batch(2, 16, 272),
                np.array([0.5, 0.5], np.float32))
    assert bounds == [30.0] * 4  # 2 layers x (forward + recompute)


def test_unknown_remat_policy_raises():
    with pytest.raises(ValueError):
        t_nd.NextDiT(remat=True, remat_policy="nope", **TINY)


# -- one train step against JAX ----------------------------------------------------------


def _jax_draws(rng, step, x, snr_type, micro):
    step_rng = jax.random.fold_in(rng, step)
    _, loss_rng = jax.random.split(step_rng)
    keys = [loss_rng] if micro == 1 else [jax.random.fold_in(loss_rng, i) for i in range(micro)]
    mb = x.shape[0] // micro
    out = []
    for key in keys:
        t_key, noise_key = jax.random.split(key)
        t = j_tr.transport.sample_t(t_key, mb, snr_type)
        x0 = jax.random.normal(noise_key, (mb, *x.shape[1:]), jnp.float32)
        out.append((torch.from_numpy(np.asarray(t)), torch.from_numpy(np.asarray(x0))))
    return out


def _optimizers(kind):
    if kind == "adamw":
        return j_tl.create_optimizer(1e-3, 0.01), t_tl.create_optimizer(1e-3, 0.01)
    if kind == "fused_adamw":
        return (j_tl.FusedAdamWEMA(1e-3, weight_decay=0.01),
                t_tl.FusedAdamWEMA(1e-3, weight_decay=0.01))
    kw = dict(min_dim_size_to_factor=16, weight_decay=0.01)
    return j_tl.FusedAdafactorEMA(1e-2, **kw), t_tl.FusedAdafactorEMA(1e-2, **kw)


def _close_tree(got, ref, what, relative=False):
    """relative: atol scaled to the largest element of the whole tree (some
    gradients, such as ky_norm's bias, which a softmax cannot see, are pure
    rounding noise)."""
    atol = ATOL * max(float(r.abs().max()) for r in ref.values()) if relative else ATOL
    for name, r in ref.items():
        np.testing.assert_allclose(got[name].numpy(), r.numpy(), atol=atol, rtol=RTOL,
                                   err_msg=f"{what}: {name}")


def _run_both(kind, batches, snr_type="uniform", micro=1, grad_clip=2.0, steps=2):
    jopt, topt = _optimizers(kind)
    params = _params()
    jmodel = j_nd.NextDiT(qk_norm=True, attn_impl="flash", **TINY)
    jstate = j_tl.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                             opt_state=jopt.init(params),
                             ema_params=jax.tree.map(lambda a: jnp.asarray(a) + 0.01, params))
    model_sd, ema_sd, opt_sd = train_state_from_jax(jstate.params, jstate.ema_params,
                                                    jstate.opt_state)
    tmodel = t_nd.NextDiT(qk_norm=True, **TINY)
    tmodel.load_state_dict(model_sd, strict=True)
    tstate = t_tl.TrainState(step=0, model=tmodel, ema=ema_sd, opt_state=opt_sd)

    jt = j_tr.create_transport("Linear", "velocity", snr_type=snr_type)
    tt = t_tr.create_transport("Linear", "velocity", snr_type=snr_type)
    jstep = jax.jit(j_tl.make_train_step(jmodel, jt, jopt, _jcond, grad_clip=grad_clip,
                                         micro_batches=micro))
    tstep = t_tl.make_train_step(tmodel, tt, topt, _tcond, grad_clip=grad_clip,
                                 micro_batches=micro)
    rng = jax.random.PRNGKey(5)
    metrics = []
    for s, batch in zip(range(steps), batches):
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch), rng)
        draws = _jax_draws(rng, s, batch["x"], snr_type, micro)
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()}, 0,
                           draws=draws)
        metrics.append((jm, tm))
    return jstate, tstate, metrics


def _compare_states(jstate, tstate, metrics):
    for jm, tm in metrics:
        assert tm["skipped"] == int(jm["skipped"])
        np.testing.assert_allclose(tm["loss"], float(jm["loss"]), atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(tm["grad_norm"], float(jm["grad_norm"]), atol=ATOL, rtol=RTOL)
    assert tstate.step == int(jstate.step)
    model_sd, ema_sd, opt_sd = train_state_from_jax(jstate.params, jstate.ema_params,
                                                    jstate.opt_state)
    # ky_norm's bias gets a gradient that is zero up to rounding (a shift of
    # every caption key along one dimension moves all logits of a row alike),
    # and Adafactor's sign-like first step turns that noise into a full-size
    # update: it is held to nothing but finiteness
    noise = lambda tree: {n: v for n, v in tree.items() if not n.endswith("ky_norm.bias")}
    _close_tree(tstate.model.state_dict(), noise(model_sd), "params")
    _close_tree(tstate.ema, noise(ema_sd), "ema")
    assert all(bool(torch.isfinite(p).all()) for p in tstate.model.parameters())
    assert int(tstate.opt_state["count"]) == int(opt_sd["count"])
    for slot in ("mu", "nu", "v_row", "v_col", "v"):
        if slot in opt_sd:
            _close_tree(tstate.opt_state[slot], opt_sd[slot], slot, relative=True)


@pytest.mark.parametrize("kind,snr_type", [("adamw", "uniform"), ("fused_adamw", "lognorm"),
                                           ("adafactor", "uniform")])
def test_train_step_matches_jax(kind, snr_type):
    """Two steps at 16 image tokens (caption cross-attention and
    self-attention both on the small-KV side)."""
    _compare_states(*_run_both(kind, [_batch(10), _batch(11)], snr_type=snr_type))


def test_micro_batches_and_clip_match_jax():
    """Two micro-batches accumulated per step, and a clip small enough to
    scale every update."""
    jstate, tstate, metrics = _run_both("adamw", [_batch(12, b=4), _batch(13, b=4)], micro=2,
                                        grad_clip=0.05)
    assert all(tm["grad_norm"] > 0.05 for _, tm in metrics)
    _compare_states(jstate, tstate, metrics)


def test_nonfinite_step_is_skipped_as_in_jax():
    bad = _batch(14)
    bad["x"][0, 0, 0, 0] = np.nan
    jstate, tstate, metrics = _run_both("fused_adamw", [bad], steps=1)
    assert metrics[0][1]["skipped"] == 1 and int(metrics[0][0]["skipped"]) == 1
    assert tstate.step == 1 and int(tstate.opt_state["count"]) == 0
    model_sd, ema_sd, opt_sd = train_state_from_jax(_params(), jstate.ema_params,
                                                    jstate.opt_state)
    for name, p in tstate.model.state_dict().items():
        assert torch.equal(p, model_sd[name]), name
    for name, e in tstate.ema.items():
        assert torch.equal(e, ema_sd[name]), name


def test_streaming_train_step_with_calibrated_bound_matches_jax():
    """1088 image tokens (latent 16x272): both packages calibrate the train
    bound at the same weights from the same noise, then one step streams the
    self-attention through the static-max LSE forward and the backward."""
    params = _params()
    batch = _batch(15, 16, 272)
    jmodel = j_nd.NextDiT(qk_norm=True, attn_impl="flash", **TINY)
    jt = j_tr.create_transport("Linear", "velocity")
    rng = jax.random.PRNGKey(21)
    j_bound = j_tl.autocalibrate_flash_static_max_train(
        jmodel, params, jax.tree.map(jnp.asarray, batch), _jcond, rng=rng,
        path_sampler=jt.path_sampler)
    x0 = torch.from_numpy(np.asarray(jax.random.normal(rng, batch["x"].shape, jnp.float32)))
    t_bound = t_tl.autocalibrate_flash_static_max_train(
        _port_model(params), {k: torch.from_numpy(v) for k, v in batch.items()}, _tcond, x0=x0,
        path_sampler=t_tr.create_transport().path_sampler)
    assert j_bound is not None and t_bound is not None
    assert abs(t_bound - j_bound) <= 1e-3
    assert tfa.get_flash_static_max(train=True) == t_bound and tfa.get_flash_static_max() is None
    tfa.set_flash_static_max_train(j_bound)
    _compare_states(*_run_both("adamw", [batch], steps=1))


def test_train_calibration_guards(monkeypatch):
    model = _port_model(_params())
    small = {k: torch.from_numpy(v) for k, v in _batch(16).items()}
    assert t_tl.autocalibrate_flash_static_max_train(model, small, _tcond) is None
    big = {k: torch.from_numpy(v) for k, v in _batch(16, 16, 272).items()}
    monkeypatch.setenv("LUMINA_FLASH_STATIC_MAX_TRAIN", "12.0")
    assert t_tl.autocalibrate_flash_static_max_train(model, big, _tcond) is None
    monkeypatch.delenv("LUMINA_FLASH_STATIC_MAX_TRAIN")
    monkeypatch.setenv("LUMINA_FLASH_STATIC_MAX_AUTO", "0")
    assert t_tl.autocalibrate_flash_static_max_train(model, big, _tcond) is None
    assert tfa.get_flash_static_max(train=True) is None


# -- the state bridge ----------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["adamw", "fused_adamw", "adafactor"])
def test_train_state_bridge_layouts(kind):
    """The bridged optimizer state has the port's own layout (shapes, the
    square-weight Adafactor swap included) and loads into a live state."""
    jopt, topt = _optimizers(kind)
    params = _params()
    model_sd, ema_sd, opt_sd = train_state_from_jax(params, params, jopt.init(params))
    own = topt.init(model_sd)
    assert sorted(opt_sd) == sorted(own)
    for slot, tree in own.items():
        if isinstance(tree, dict):
            assert sorted(opt_sd[slot]) == sorted(tree)
            for name, t in tree.items():
                assert opt_sd[slot][name].shape == t.shape, (slot, name)
    if kind == "adafactor":  # wq is 64x64: rows and columns swap roles
        assert opt_sd["v_row"]["layers.0.attention.wq.weight"].shape == (64,)
        assert opt_sd["v"]["layers.1.attention_norm1.weight"].shape == (64,)


# -- the trainer CLI ---------------------------------------------------------------------------


def _cli(tmp, steps, *extra):
    from lumina_t2x_tpu_torch.pipelines.train import main

    return main(["--model", "NextDiT_Tiny_patch2", "--data_path", "synthetic://16x16",
                 "--results_dir", str(tmp), "--global_batch_size", "2", "--max_steps",
                 str(steps), "--log_every", "1", "--ckpt_every", "100", "--qk_norm",
                 "--checkpointing", "--precision", "fp32", "--cap_feat_dim", "32",
                 "--device", "cpu", "--flash_static_max", "auto", "--keep_last", "1", *extra])


@pytest.mark.parametrize("opt", [[], ["--optimizer", "adafactor", "--param_dtype", "bf16"]])
def test_cli_resume_equals_uninterrupted_run(tmp_path, opt):
    _cli(tmp_path / "a", 2, *opt)
    ckpts = tmp_path / "a" / "NextDiT_Tiny_patch2" / "checkpoints"
    assert sorted(os.listdir(ckpts)) == ["0000002"]
    assert sorted(os.listdir(ckpts / "0000002")) == ["ema", "model", "model_args.json",
                                                     "optimizer", "resume_step.txt"]
    resumed = _cli(tmp_path / "a", 3, "--auto_resume", *opt)
    straight = _cli(tmp_path / "b", 3, *opt)
    assert resumed.step == straight.step == 3
    assert sorted(os.listdir(ckpts)) == ["0000003"]  # --keep_last 1
    for name, p in straight.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[name], p), name
    for name, e in straight.ema.items():
        assert torch.equal(resumed.ema[name], e), name
    assert sorted(resumed.opt_state) == sorted(straight.opt_state)
    for slot, tree in straight.opt_state.items():
        if not isinstance(tree, dict):
            assert torch.equal(resumed.opt_state[slot], tree), slot
            continue
        for name, m in tree.items():
            assert torch.equal(resumed.opt_state[slot][name], m), (slot, name)
    with open(tmp_path / "a" / "NextDiT_Tiny_patch2" / "metrics.jsonl") as f:
        losses = [float(line.split('"train/loss": ')[1].split(",")[0]) for line in f]
    assert len(losses) == 3 and np.isfinite(losses).all()


@pytest.mark.parametrize("flag", [["--async_save", "--profile_steps", "2"],
                                  ["--async_save"],
                                  ["--model_parallel_size", "2"], ["--h2d_diet"],
                                  ["--profile_steps", "2"]])
def test_cli_unported_paths_raise(tmp_path, flag):
    # --async_save and --profile_steps are ported: a run with them completes
    # its checkpoint and writes its trace (their own tests:
    # tests/test_torch_async_checkpoint.py, tests/test_torch_profiler.py).
    # --model_parallel_size 2 runs now (tests/test_torch_sharded_train.py); in
    # one process it meets the mesh's divisibility check, as in JAX.
    # --h2d_diet is TPU-only and raises.
    if "--model_parallel_size" in flag or "--h2d_diet" in flag:
        error = AssertionError if "--model_parallel_size" in flag else NotImplementedError
        with pytest.raises(error):
            _cli(tmp_path, 1, *flag)
        return
    assert _cli(tmp_path, 2, *flag).step == 2
    exp = tmp_path / "NextDiT_Tiny_patch2"
    assert (exp / "checkpoints" / "0000002" / "resume_step.txt").exists()
    assert (exp / "trace").is_dir() == ("--profile_steps" in flag)


def test_param_dtypes_match_jax_at_bf16():
    """At param_dtype bf16 the norm weights and gates stay fp32, as in the
    JAX model (the port stored its norm weights in param_dtype before)."""
    jmodel = j_nd.NextDiT(qk_norm=True, param_dtype=jnp.bfloat16, **TINY)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((2, 4, 8, 8)),
                            jnp.zeros((2,)), jnp.zeros((2, 9, 32)), jnp.ones((2, 9), jnp.int32))
    # float16 stands in for bf16 so that the bridge can carry the tree
    marked = jax.tree.map(lambda a: np.zeros(a.shape, np.float32 if a.dtype == jnp.float32
                                             else np.float16), shapes["params"])
    ref = {n: t.dtype == torch.float32 for n, t in state_dict_from_jax_params(marked).items()}
    tmodel = t_nd.NextDiT(qk_norm=True, param_dtype=torch.bfloat16, device="meta", **TINY)
    got = {n: p.dtype == torch.float32 for n, p in tmodel.named_parameters()}
    assert got == ref
    assert sum(ref.values()) > 0 and not all(ref.values())


def test_profile_train_step_groups_and_needs_cuda(monkeypatch):
    from lumina_t2x_tpu_torch.pipelines import profile_train_step as prof

    assert prof._group("void (anonymous namespace)::flash_bwd_kv_kernel<true, 5>(Params, "
                       "CUtensorMap)") == "fp32 backward (K6-K8, flash_bwd_fp32_sm90.cu)"
    assert prof._group("void (anonymous namespace)::flash_bwd_dq_kernel<5>(Params)") == \
        "fp32 backward (K6-K8, flash_bwd_fp32_sm90.cu)"
    assert prof._group("void (anonymous namespace)::flash_bwd_sm90_kernel<80, 72, true>(Params)") \
        == "Hopper backward (bf16 K6-K8, flash_bwd_sm90.cu)"
    assert prof._group("void (anonymous namespace)::flash_bwd_sm90_dq_kernel<80, 72>(Params)") \
        == "Hopper backward (bf16 K6-K8, flash_bwd_sm90.cu)"
    assert prof._group("void (anonymous namespace)::flash_fwd_sm90_kernel<true, 80, 72>(Params)") \
        == "Hopper forward (bf16 K1-K5, K9, flash_fwd_sm90.cu)"
    assert prof._group("void (anonymous namespace)::flash_fwd_fp32_sm90_kernel<true, 5>(Params)") \
        == "fp32 forward (K1-K5, K9, flash_fwd_fp32_sm90.cu)"
    assert prof._group("nvjet_tst_128x256_64x4") == "cuBLAS GEMMs"
    assert prof._group("Memset (Device)") == "copies/memset"
    assert prof._group("some_kernel") == "other"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        prof.main([])

"""The port's sharded training (`train_lib.make_train_step` over a mesh, the
trainer CLI under torchrun's environment) on gloo CPU worlds of 4 ranks:

- one step of the tiny NextDiT (qk-norm, GQA) on a (data 2, model 2) mesh
  -- AdamW and Adafactor under FSDP2, Adafactor with the parameters
  replicated over data (`sdp`) -- from the state the JAX package's step
  starts from, with the JAX step's draws handed in: the loss, the grad norm,
  the parameters, the EMA and the optimizer state after the step against
  JAX's (its unsharded step; its slow sharding tests hold that equal to the
  sharded one). Bar as the one-process step test: atol 2e-4 / rtol 2e-3,
  the moments relative to their largest element; and AdamW with 2
  micro-batches and bf16 gradients (the first moment held closer, see its
  test);
- the trainer CLI at world 4 (2 x 2, FSDP2) against the one-process CLI of
  the same seed, 2 steps: the losses and grad norms step by step (rtol
  1e-5: only the order of the reductions differs), and a checkpoint the
  world-4 run saved at step 2 resumed by one process to step 3, against the
  world-4 run's step 3 (loss rtol 1e-5, parameters atol 1e-6);
- the music trainer (`train_audio`) at world 4 against one process, 2 steps
  (rtol 1e-5), and the image trainer with bf16 Adafactor (fp32 norms and
  gates beside bf16 weights) at world 4 against one process;
- `exps/multiprocess_dryrun.py` (2 ranks: step, collective save, restore,
  step; both ranks report the same metrics);
- the one-process trainer under `--model_parallel_size 2`: the mesh's
  divisibility error, as JAX's `create_mesh` raises it."""

import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from lumina_t2x_tpu import transport as j_tr
from lumina_t2x_tpu.models import next_dit as j_nd
from lumina_t2x_tpu.pipelines import train_lib as j_tl
from lumina_t2x_tpu_torch.core.checkpoint import load_stream, train_state_from_jax
from lumina_t2x_tpu_torch.parallel import gloo_world

ATOL, RTOL = 2e-4, 2e-3
CASES = "lumina_t2x_tpu_torch.parallel.gloo_cases"
TINY = dict(patch_size=2, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, multiple_of=16,
            cap_feat_dim=32, qk_norm=True)
BF16_ADAFACTOR = ("--optimizer", "adafactor", "--param_dtype", "bf16")
STEP_CASES = {"adamw_fsdp": ("adamw", True), "adafactor_fsdp": ("adafactor", True),
              "adafactor_sdp": ("adafactor", False)}


def _params():
    jmodel = j_nd.NextDiT(attn_impl="xla", **TINY)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(2), jnp.zeros((2, 4, 8, 8)),
                                     jnp.zeros((2,)), jnp.zeros((2, 9, 32)),
                                     jnp.ones((2, 9), jnp.int32))
    flat = traverse_util.flatten_dict(jax.tree.map(np.asarray, variables["params"]))
    rng = np.random.default_rng(2)
    return jmodel, traverse_util.unflatten_dict(
        {k: (v + 0.02 * rng.standard_normal(v.shape)).astype(np.float32)
         for k, v in flat.items()})


def _batch(seed=10, b=4, ly=9):
    rng = np.random.default_rng(seed)
    cap_mask = np.ones((b, ly), np.int32)
    cap_mask[0, 6:] = 0
    return {"x": rng.standard_normal((b, 4, 8, 8)).astype(np.float32),
            "cap_feats": rng.standard_normal((b, ly, 32)).astype(np.float32),
            "cap_mask": cap_mask}


def _optimizers(kind):
    if kind == "adamw":
        return j_tl.create_optimizer(1e-3, 0.01), ("adamw", dict(lr=1e-3, weight_decay=0.01))
    kw = dict(min_dim_size_to_factor=16, weight_decay=0.01)
    return j_tl.FusedAdafactorEMA(1e-2, **kw), ("adafactor", dict(lr=1e-2, **kw))


def _np_tree(tree):
    return {k: _np_tree(v) for k, v in tree.items()} if isinstance(tree, dict) else \
        (tree.numpy() if isinstance(tree, torch.Tensor) else tree)


def _cli_argv(results, steps, *extra):
    return ["--model", "NextDiT_Tiny_patch2", "--data_path", "synthetic://16x16",
            "--results_dir", str(results), "--global_batch_size", "4", "--max_steps", str(steps),
            "--log_every", "1", "--ckpt_every", "2", "--qk_norm", "--precision", "fp32",
            "--cap_feat_dim", "32", "--device", "cpu", "--lr", "1e-3", *extra]


def _audio_argv(results, steps, *extra):
    return ["--latent_channels", "4", "--latent_length", "16", "--context_dim", "32",
            "--context_len", "8", "--hidden_size", "64", "--depth", "2", "--num_heads", "4",
            "--global_batch_size", "4", "--log_every", "1", "--precision", "fp32",
            "--device", "cpu", "--lr", "1e-3", "--results_dir", str(results),
            "--max_steps", str(steps), "--model_parallel_size", "2", *extra]


def _metrics(results):
    with open(os.path.join(results, "NextDiT_Tiny_patch2", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _bf16_micro_case(params, batch, rng):
    """(the gloo call, the JAX reference) of one AdamW step under TP2 x
    FSDP2 with 2 micro-batches and bf16 gradients."""
    jmodel = j_nd.NextDiT(attn_impl="xla", **TINY)
    jopt, opt = _optimizers("adamw")
    jstate = j_tl.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                             opt_state=jopt.init(params),
                             ema_params=jax.tree.map(lambda a: jnp.asarray(a) + 0.01, params))
    _, loss_rng = jax.random.split(jax.random.fold_in(rng, 0))
    draws = []
    for i in range(2):  # JAX's micro-batch keys
        t_key, noise_key = jax.random.split(jax.random.fold_in(loss_rng, i))
        draws.append((np.asarray(j_tr.transport.sample_t(t_key, 2, "uniform")),
                      np.asarray(jax.random.normal(noise_key, (2, 4, 8, 8), jnp.float32))))
    model_sd, ema_sd, opt_sd = train_state_from_jax(jstate.params, jstate.ema_params,
                                                    jstate.opt_state)
    call = (f"{CASES}:sharded_train_step", dict(
        kwargs=TINY, model_sd=_np_tree(model_sd), ema_sd=_np_tree(ema_sd),
        opt_sd=_np_tree(opt_sd), optimizer=opt, batch=batch, draws=draws, mp=2, fsdp=True,
        micro_batches=2, grad_dtype="bf16"))

    def ref():
        jt = j_tr.create_transport("Linear", "velocity", snr_type="uniform")
        step = jax.jit(j_tl.make_train_step(
            jmodel, jt, jopt, lambda b: {"cap_feats": b["cap_feats"], "cap_mask": b["cap_mask"]},
            grad_clip=2.0, micro_batches=2, grad_dtype=jnp.bfloat16))
        return step(jstate, jax.tree.map(jnp.asarray, batch), rng)

    return call, ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world starts first and runs while the JAX steps compile."""
    from concurrent.futures import ThreadPoolExecutor

    jmodel, params = _params()
    batch = _batch()
    rng = jax.random.PRNGKey(5)
    _, loss_rng = jax.random.split(jax.random.fold_in(rng, 0))
    t_key, noise_key = jax.random.split(loss_rng)
    draws = [(np.asarray(j_tr.transport.sample_t(t_key, 4, "uniform")),
              np.asarray(jax.random.normal(noise_key, (4, 4, 8, 8), jnp.float32)))]
    calls, jstates = [], {}
    for kind in ("adamw", "adafactor"):
        jopt, _ = _optimizers(kind)
        jstates[kind] = (jopt, j_tl.TrainState(
            step=jnp.zeros((), jnp.int32), params=params, opt_state=jopt.init(params),
            ema_params=jax.tree.map(lambda a: jnp.asarray(a) + 0.01, params)))
    bf16_micro = _bf16_micro_case(params, batch, rng)
    for name, (kind, fsdp) in STEP_CASES.items():
        jstate = jstates[kind][1]
        model_sd, ema_sd, opt_sd = train_state_from_jax(jstate.params, jstate.ema_params,
                                                        jstate.opt_state)
        calls.append((f"{CASES}:sharded_train_step", dict(
            kwargs=TINY, model_sd=_np_tree(model_sd), ema_sd=_np_tree(ema_sd),
            opt_sd=_np_tree(opt_sd), optimizer=_optimizers(kind)[1], batch=batch, draws=draws,
            mp=2, fsdp=fsdp)))
    calls.append(bf16_micro[0])
    root = tmp_path_factory.mktemp("trainer")
    calls.append((f"{CASES}:trainer", dict(argv=_cli_argv(root / "w4", 3, "--model_parallel_size",
                                                          "2"))))
    calls.append((f"{CASES}:audio_trainer", dict(argv=_audio_argv(root / "audio4", 2))))
    calls.append((f"{CASES}:trainer", dict(argv=_cli_argv(root / "bf16w4", 2, *BF16_ADAFACTOR,
                                                          "--model_parallel_size", "2"))))
    from lumina_t2x_tpu_torch.exps import multiprocess_dryrun

    with ThreadPoolExecutor(2) as pool:
        world = pool.submit(gloo_world.run, 4, calls)
        dryrun = pool.submit(multiprocess_dryrun.main)
        jt = j_tr.create_transport("Linear", "velocity", snr_type="uniform")
        refs = {}
        for kind, (jopt, jstate) in jstates.items():
            step = jax.jit(j_tl.make_train_step(jmodel, jt, jopt, lambda b: {
                "cap_feats": b["cap_feats"], "cap_mask": b["cap_mask"]}, grad_clip=2.0))
            refs[kind] = step(jstate, jax.tree.map(jnp.asarray, batch), rng)
        bf16_ref = bf16_micro[1]()
        ranks = world.result()
        dryrun_rc = dryrun.result()
    return {"dryrun_rc": dryrun_rc, "steps": {name: (ranks[0][i], refs[kind])
                      for i, (name, (kind, _)) in enumerate(STEP_CASES.items())},
            "bf16_micro": (ranks[0][len(STEP_CASES)], bf16_ref),
            "root": root, "final_steps": [r[-3] for r in ranks],
            "audio_steps": [r[-2] for r in ranks], "bf16_steps": [r[-1] for r in ranks]}


def _close(got, ref, what, relative=False):
    atol = ATOL * max(float(np.abs(r).max()) for r in ref.values()) if relative else ATOL
    for name, r in ref.items():
        np.testing.assert_allclose(got[name], np.asarray(r), atol=atol, rtol=RTOL,
                                   err_msg=f"{what}: {name}")


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_sharded_step_matches_jax(runs, name):
    (metrics, full), (jstate, jm) = runs["steps"][name]
    np.testing.assert_allclose(metrics["loss"], float(jm["loss"]), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(metrics["grad_norm"], float(jm["grad_norm"]), atol=ATOL, rtol=RTOL)
    assert metrics["skipped"] == 0
    model_sd, ema_sd, opt_sd = train_state_from_jax(jstate.params, jstate.ema_params,
                                                    jstate.opt_state)
    noise = lambda tree: {n: v.numpy() for n, v in tree.items() if not n.endswith("ky_norm.bias")}
    _close(full["model"], noise(model_sd), "params")
    _close(full["ema"], noise(ema_sd), "ema")
    assert int(full["optimizer"]["count"]) == int(opt_sd["count"])
    for slot in ("mu", "nu", "v_row", "v_col", "v"):
        if slot in opt_sd:
            _close(full["optimizer"][slot], {n: v.numpy() for n, v in opt_sd[slot].items()},
                   slot, relative=True)


def test_sharded_step_bf16_micro_batches_matches_jax(runs):
    """AdamW under TP2 x FSDP2 with 2 micro-batches and bf16 gradients:
    each micro-batch's gradients are cast to bf16 after its backward and
    summed in bf16, as JAX's step does. The loss, the grad norm, the
    parameters and the EMA at the bar above. The first moment, 0.1 times the
    bf16 gradient at step 1, equals JAX's to fp32 rounding (rtol 1e-6) in at
    least 99% of its elements and within one bf16 ulp (rtol 2^-7; atol as
    the moments' bar above, for the elements near 0) in all:
    the fp32 sums a gradient is rounded from differ in order (the data
    ranks' reduce-scatter against JAX's whole micro-batch), which carries an
    element across a bf16 rounding boundary only rarely."""
    (metrics, full), (jstate, jm) = runs["bf16_micro"]
    np.testing.assert_allclose(metrics["loss"], float(jm["loss"]), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(metrics["grad_norm"], float(jm["grad_norm"]), atol=ATOL, rtol=RTOL)
    model_sd, ema_sd, opt_sd = train_state_from_jax(jstate.params, jstate.ema_params,
                                                    jstate.opt_state)
    noise = lambda tree: {n: v.numpy() for n, v in tree.items() if not n.endswith("ky_norm.bias")}
    _close(full["model"], noise(model_sd), "params")
    _close(full["ema"], noise(ema_sd), "ema")
    ref = noise(opt_sd["mu"])
    got = np.concatenate([full["optimizer"]["mu"][n].ravel() for n in ref])
    want = np.concatenate([ref[n].ravel() for n in ref])
    exact = np.isclose(got, want, rtol=1e-6, atol=0.0)
    assert exact.mean() >= 0.99, f"{exact.mean():.5f} of the first moment equals JAX's"
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=ATOL * np.abs(want).max())


def test_world4_trainer_equals_one_process_and_resumes_at_world1(runs, monkeypatch):
    from lumina_t2x_tpu_torch.pipelines.train import main

    # metrics without TensorBoard, as the gloo ranks write them (its import
    # loads TensorFlow)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    root = runs["root"]
    assert runs["final_steps"] == [3, 3, 3, 3]
    w4 = _metrics(root / "w4")
    main(_cli_argv(root / "w1", 2))
    w1 = _metrics(root / "w1")
    assert [m["step"] for m in w4] == [1, 2, 3] and [m["step"] for m in w1] == [1, 2]
    for a, b in zip(w4, w1):
        np.testing.assert_allclose(a["train/loss"], b["train/loss"], rtol=1e-5)
        np.testing.assert_allclose(a["train/grad_norm"], b["train/grad_norm"], rtol=1e-5)
    ckpts = root / "w4" / "NextDiT_Tiny_patch2" / "checkpoints"
    assert sorted(os.listdir(ckpts)) == ["0000002", "0000003"]
    with open(root / "w4" / "NextDiT_Tiny_patch2" / "run_summary.json") as f:
        assert json.load(f)["world_size"] == 4
    # the world-4 checkpoint of step 2, resumed by one process
    shutil.copytree(root / "w4", root / "resume")
    shutil.rmtree(root / "resume" / "NextDiT_Tiny_patch2" / "checkpoints" / "0000003")
    os.remove(root / "resume" / "NextDiT_Tiny_patch2" / "metrics.jsonl")
    resumed = main(_cli_argv(root / "resume", 3, "--auto_resume"))
    assert resumed.step == 3
    np.testing.assert_allclose(_metrics(root / "resume")[-1]["train/loss"], w4[-1]["train/loss"],
                               rtol=1e-5)
    ref = load_stream(str(ckpts / "0000003"), "model")
    for name, p in resumed.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), ref[name].numpy(), atol=1e-6, err_msg=name)


def test_world4_bf16_adafactor_trainer_equals_one_process(runs, monkeypatch):
    """bf16 parameters with fp32 norm weights and gates: FSDP2 shards the
    bf16 ones and leaves the fp32 ones replicated, their gradients reduced
    by the step. Step 1's loss from the same weights and draws (rtol 1e-5);
    the rest rtol 1e-3: bf16 weights give bf16 gradients, rounded on each
    data rank's rows before their mean rather than once on the whole batch,
    and step 2 follows a stochastically rounded update of those."""
    from lumina_t2x_tpu_torch.pipelines.train import main

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    assert runs["bf16_steps"] == [2, 2, 2, 2]
    root = runs["root"]
    main(_cli_argv(root / "bf16w1", 2, *BF16_ADAFACTOR))
    w4, w1 = _metrics(root / "bf16w4"), _metrics(root / "bf16w1")
    assert [m["step"] for m in w4] == [m["step"] for m in w1] == [1, 2]
    for k, (a, b) in enumerate(zip(w4, w1)):
        np.testing.assert_allclose(a["train/loss"], b["train/loss"], rtol=1e-5 if k == 0 else 1e-3)
        np.testing.assert_allclose(a["train/grad_norm"], b["train/grad_norm"], rtol=1e-3)


def test_world4_audio_trainer_equals_one_process(runs, monkeypatch):
    """The music trainer at world 4 (2 x 2, FSDP2) against one process."""
    from lumina_t2x_tpu_torch.pipelines import train_audio

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    assert runs["audio_steps"] == [2, 2, 2, 2]
    root = runs["root"]
    argv = _audio_argv(root / "audio1", 2)
    train_audio.main(argv[:argv.index("--model_parallel_size")])
    read = lambda d: [json.loads(line) for line in open(d / "music" / "metrics.jsonl")]
    w4, w1 = read(root / "audio4"), read(root / "audio1")
    assert [m["step"] for m in w4] == [m["step"] for m in w1] == [1, 2]
    for a, b in zip(w4, w1):
        np.testing.assert_allclose(a["train/loss"], b["train/loss"], rtol=1e-5)
        np.testing.assert_allclose(a["train/grad_norm"], b["train/grad_norm"], rtol=1e-5)


def test_multiprocess_dryrun(runs):
    """`exps/multiprocess_dryrun.py`: 2 gloo ranks, a TP2 x FSDP2 step, a
    collective save, a restore and a second step, the same losses on both
    ranks (started beside the world-4 run)."""
    assert runs["dryrun_rc"] == 0


def test_one_process_model_parallel_raises_the_mesh_error(tmp_path):
    from lumina_t2x_tpu_torch.pipelines.train import main

    with pytest.raises(AssertionError, match="not divisible by model_parallel_size=2"):
        main(_cli_argv(tmp_path, 1, "--model_parallel_size", "2"))

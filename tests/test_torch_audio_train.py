"""The port's audio / music trainer (`lumina_t2x_tpu_torch/pipelines/
train_audio.py`) against the JAX package's: one CFM train step of the tiny
FlagDiT-1D (loss, grad norm, parameters and EMA after the step, the clip
active) against JAX's `make_cfm_train_step` with JAX's draws handed to the
port, the synthetic and `.npy` data streams, then the CLI: 2 steps and a
resumed third equal 3 uninterrupted steps, and the options that belong to
other slices raise.

fp32 on the CPU. Bar: atol 2e-4 / rtol 2e-3 (the parameters after the step
to atol 1e-6: AdamW's first step moves each weight by about the learning
rate).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumina_t2x_tpu.core.checkpoint import import_flag_dit_1d_weights as j_import_fd1d
from lumina_t2x_tpu.models.flag_dit_1d import FlagDiT1D as JFlagDiT1D
from lumina_t2x_tpu.pipelines import train_audio as jta
from lumina_t2x_tpu.pipelines.train_lib import TrainState as JTrainState
from lumina_t2x_tpu.pipelines.train_lib import create_optimizer as j_create_optimizer
from lumina_t2x_tpu.transport.cfm import CFM as JCFM
from lumina_t2x_tpu_torch.core.checkpoint import (find_auto_resume, flag_dit_1d_state_dict_from_jax_params,
                                                  load_stream)
from lumina_t2x_tpu_torch.models.flag_dit_1d import FlagDiT1D
from lumina_t2x_tpu_torch.pipelines import train_audio as tta
from lumina_t2x_tpu_torch.pipelines.train_lib import create_optimizer, create_train_state
from lumina_t2x_tpu_torch.transport.cfm import CFM

ATOL, RTOL = 2e-4, 2e-3
TINY = dict(in_channels=8, context_dim=32, hidden_size=64, depth=2, num_heads=4, multiple_of=16)
CLI = ["--latent_channels", "4", "--latent_length", "16", "--context_dim", "32",
       "--context_len", "8", "--hidden_size", "64", "--depth", "2", "--num_heads", "4",
       "--global_batch_size", "2", "--log_every", "1", "--precision", "fp32", "--device", "cpu",
       "--lr", "1e-3"]


def test_train_step_matches_jax():
    torch.manual_seed(0)
    model = FlagDiT1D(**TINY)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape))
    params = j_import_fd1d({k: v.numpy() for k, v in model.state_dict().items()}, depth=2)
    lr, clip, decay = 1e-3, 0.05, 0.9
    jopt = j_create_optimizer(lr, 0.01)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                         opt_state=jopt.init(params), ema_params=jax.tree.map(jnp.array, params))
    jmodel = JFlagDiT1D(attn_impl="xla", **TINY)
    rng_np = np.random.default_rng(1)
    batch = {"x": rng_np.standard_normal((2, 8, 12)).astype(np.float32),
             "context": rng_np.standard_normal((2, 5, 32)).astype(np.float32)}
    rng = jax.random.PRNGKey(7)
    new_state, metrics = jax.jit(jta.make_cfm_train_step(jmodel, JCFM(), jopt, clip, decay))(
        jstate, jax.tree.map(jnp.asarray, batch), rng)
    # the step's draws, as `CFM.p_losses` makes them from fold_in(rng, step)
    t_rng, noise_rng = jax.random.split(jax.random.fold_in(rng, 0))
    t = jax.random.randint(t_rng, (2,), 0, 1000)
    noise = jax.random.normal(noise_rng, (2, 8, 12))

    optimizer = create_optimizer(lr, 0.01)
    state = create_train_state(model, optimizer)
    step = tta.make_cfm_train_step(model, CFM(), optimizer, clip, decay)
    state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, 0,
                    draws=(torch.from_numpy(np.array(t)), torch.from_numpy(np.array(noise))))
    assert state.step == 1
    np.testing.assert_allclose(m["loss"], float(metrics["loss"]), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(m["grad_norm"], float(metrics["grad_norm"]), atol=ATOL, rtol=RTOL)
    assert m["grad_norm"] > clip  # the clip acted
    ref_params = flag_dit_1d_state_dict_from_jax_params(new_state.params)
    ref_ema = flag_dit_1d_state_dict_from_jax_params(new_state.ema_params)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref_params[name].numpy(), atol=1e-6,
                                   rtol=RTOL, err_msg=name)
        np.testing.assert_allclose(state.ema[name].numpy(), ref_ema[name].numpy(), atol=1e-6,
                                   rtol=RTOL, err_msg=name)


def _npy_dir(root, n=5):
    rng = np.random.default_rng(3)
    for sub in ("latents", "captions"):
        os.makedirs(os.path.join(root, sub))
    for i in range(n):  # lengths on both sides of the crop
        np.save(os.path.join(root, "latents", f"{i}.npy"),
                rng.standard_normal((4, 12 + 3 * i)).astype(np.float32))
        np.save(os.path.join(root, "captions", f"{i}.npy"),
                rng.standard_normal((5 + i, 32)).astype(np.float32))
    return root


@pytest.mark.parametrize("source", ["synthetic", "npy"])
def test_data_streams_match_jax(tmp_path, source):
    path = "synthetic://" if source == "synthetic" else _npy_dir(str(tmp_path))
    args = tta.parse_args(CLI + ["--data_path", path])
    ours = (tta.synthetic_audio_batches if source == "synthetic" else tta.npy_audio_batches)(args)
    ref = (jta.synthetic_audio_batches if source == "synthetic" else jta.npy_audio_batches)(args)
    batches = [next(ours) for _ in range(3)]
    for got in batches:
        want = next(ref)
        assert got["x"].shape == (2, 4, 16) and got["context"].shape == (2, 8, 32)
        for key in ("x", "context"):
            np.testing.assert_array_equal(got[key], want[key])
    skipped = (tta.synthetic_audio_batches if source == "synthetic" else tta.npy_audio_batches)(
        args, start_step=2)
    np.testing.assert_array_equal(next(skipped)["x"], batches[2]["x"])


def test_cli_resume_equals_an_uninterrupted_run(tmp_path):
    straight, split = str(tmp_path / "straight"), str(tmp_path / "split")
    tta.main(CLI + ["--results_dir", straight, "--max_steps", "3"])
    tta.main(CLI + ["--results_dir", split, "--max_steps", "2"])
    state = tta.main(CLI + ["--results_dir", split, "--max_steps", "3", "--auto_resume",
                            "--keep_last", "1"])
    assert state.step == 3
    ckpts = sorted(os.listdir(os.path.join(split, "music", "checkpoints")))
    assert ckpts == ["0000003"]  # --keep_last 1 pruned step 2
    for stream in ("model", "ema"):
        a = load_stream(find_auto_resume(os.path.join(straight, "music")), stream)
        b = load_stream(find_auto_resume(os.path.join(split, "music")), stream)
        assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a), stream
    with open(os.path.join(split, "music", "metrics.jsonl")) as f:
        assert [int(line.split('"step": ')[1].split(",")[0]) for line in f] == [1, 2, 3]


@pytest.mark.parametrize("flag", [["--async_save"], ["--model_parallel_size", "2"]])
def test_other_slices_options_raise(tmp_path, flag):
    # --async_save is ported: the run completes its checkpoint
    # (tests/test_torch_async_checkpoint.py holds it against a synchronous
    # run). --model_parallel_size 2 runs now (tests/test_torch_sharded_train.py);
    # in one process it meets the mesh's divisibility check, as in JAX
    argv = CLI + ["--results_dir", str(tmp_path), "--max_steps", "1", *flag]
    if "--async_save" in flag:
        assert tta.main(argv).step == 1
        assert find_auto_resume(os.path.join(tmp_path, "music")).endswith("0000001")
        return
    with pytest.raises(AssertionError):
        tta.main(argv)

"""The port's DreamBooth (`lumina_t2x_tpu_torch/pipelines/dreambooth.py`)
against the JAX package's: one `make_dreambooth_step` in each conditioning
mode (NextDiT's caption features; MMDiT's context and pooled pair with SD3's
sign and t * 1000 bridge), with prior preservation and the EMA, on JAX's t
and noise handed in; the batches (image picks, stand-in latents, hashed
caption features); the prior-preservation errors; and `main` end to end with
its checkpoint.

Tiny models (NextDiT dim 64 / 2 layers / caption dim 32, qk-norm; MMDiT
dim 64 / 3 layers), fp32 on the CPU, weights carried by the bridges. Bar:
atol 2e-4 / rtol 2e-3 on the loss terms, the grad norm and the updated
weights and EMA, and the mean update difference within 1% of the learning
rate (a first Adam step is about lr * sign(g), so a gradient element near 0
may take either sign in either package).
"""

import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumina_t2x_tpu.pipelines import dreambooth as j_db
from lumina_t2x_tpu.pipelines.train_lib import TrainState as JTrainState
from lumina_t2x_tpu.pipelines.train_lib import create_optimizer as j_create_optimizer
from lumina_t2x_tpu_torch import models as t_models
from lumina_t2x_tpu_torch.core.checkpoint import (find_auto_resume, load_stream,
                                                  mmdit_state_dict_from_jax_params,
                                                  state_dict_from_jax_params)
from lumina_t2x_tpu_torch.models import mmdit as t_mmdit
from lumina_t2x_tpu_torch.models import next_dit as t_nd
from lumina_t2x_tpu_torch.pipelines import dreambooth as t_db
from lumina_t2x_tpu_torch.pipelines.train_lib import create_optimizer, create_train_state
from lumina_t2x_tpu_torch.utils import png_bytes

from test_torch_anagrams import TINY as NEXTDIT_TINY
from test_torch_anagrams import _pair as nextdit_pair
from test_torch_mmdit import TINY as MMDIT_TINY
from test_torch_mmdit import _pair as mmdit_pair

ATOL, RTOL = 2e-4, 2e-3
LR, EMA = 1e-4, 0.5


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(ref, np.float32),
                               atol=ATOL, rtol=RTOL)


def _batch(sd3, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    if sd3:
        return {"x": x, "context": rng.standard_normal((2, 5, 24)).astype(np.float32),
                "pooled": rng.standard_normal((2, 16)).astype(np.float32)}
    mask = np.ones((2, 6), np.int32)
    mask[1, 4:] = 0
    return {"x": x, "cap_feats": rng.standard_normal((2, 6, 32)).astype(np.float32),
            "cap_mask": mask}


@pytest.mark.parametrize("sd3", [False, True])
def test_step_matches_jax(sd3):
    jmodel, variables, _ = mmdit_pair() if sd3 else nextdit_pair()
    to_sd = mmdit_state_dict_from_jax_params if sd3 else state_dict_from_jax_params
    params = variables["params"]
    batch = _batch(sd3)
    j_opt = j_create_optimizer(LR)
    j_state = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          opt_state=j_opt.init(params), ema_params=jax.tree.map(jnp.array, params))
    j_step = jax.jit(j_db.make_dreambooth_step(jmodel, j_opt, 0.7, True, ema_decay=EMA,
                                               grad_clip=1.0, sd3=sd3))
    seed = 11
    j_new, j_m = j_step(j_state, jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(seed))
    # the JAX step's draws: fold_in(rng, step), then split into (t, noise)
    t_rng, noise_rng = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), 0))
    t = np.asarray(jax.random.uniform(t_rng, (2,)))
    x0 = np.asarray(jax.random.normal(noise_rng, batch["x"].shape, jnp.float32))

    tmodel = t_mmdit.MMDiT(**MMDIT_TINY) if sd3 else t_nd.NextDiT(**NEXTDIT_TINY)
    tmodel.load_state_dict(to_sd(params), strict=True)
    opt = create_optimizer(LR)
    state = create_train_state(tmodel, opt)
    step = t_db.make_dreambooth_step(tmodel, opt, 0.7, True, ema_decay=EMA, grad_clip=1.0,
                                     sd3=sd3)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    state, m = step(state, tb, seed, draws=(torch.from_numpy(t), torch.from_numpy(x0)))
    assert state.step == 1
    for key in ("loss", "grad_norm", "instance_loss", "prior_loss"):
        _close(m[key], j_m[key])
    assert float(j_m["grad_norm"]) > 1.0  # the clip scales this step

    ref, ref_ema, before = to_sd(jax.device_get(j_new.params)), to_sd(
        jax.device_get(j_new.ema_params)), to_sd(params)
    got = dict(tmodel.named_parameters())
    deltas, ema_deltas = [], []
    for name, value in ref.items():
        _close(got[name].detach(), value)
        _close(state.ema[name], ref_ema[name])
        deltas.append(((got[name].detach() - before[name]) - (value - before[name])).abs()
                      .flatten())
        ema_deltas.append(((state.ema[name] - before[name]) - (ref_ema[name] - before[name]))
                          .abs().flatten())
    # each step moves the weights by about LR and the EMA by about (1 - EMA) * LR, both
    # below atol: the mean step difference must be a small share of that
    assert torch.cat(deltas).mean() < 1e-2 * LR
    assert torch.cat(ema_deltas).mean() < 1e-2 * (1 - EMA) * LR


def _write_pngs(directory, n, seed):
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        with open(os.path.join(directory, f"{i}.png"), "wb") as f:
            f.write(png_bytes(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)))


def _args(tmp_path, **kw):
    base = dict(instance_data_dir=str(tmp_path / "inst"), class_data_dir=str(tmp_path / "cls"),
                instance_prompt="a photo of sks dog", class_prompt="a photo of a dog",
                with_prior_preservation=True, resolution=32, train_batch_size=2, seed=4,
                cap_feat_dim=32)
    return argparse.Namespace(**{**base, **kw})


@pytest.mark.parametrize("channels", [4, 16])
def test_batches_match_jax(tmp_path, channels):
    """Picks from numpy's default_rng(seed), the 8x-pool stand-in tiled to
    the latent width, the hashed caption features; instance rows first."""
    _write_pngs(tmp_path / "inst", 4, 0)
    _write_pngs(tmp_path / "cls", 3, 1)
    args = _args(tmp_path)
    ref = j_db.dreambooth_batches(args, latent_channels=channels)
    got = t_db.dreambooth_batches(args, latent_channels=channels)
    for _ in range(2):
        r, g = next(ref), next(got)
        assert g["x"].shape == (4, channels, 4, 4)
        for key in ("x", "cap_feats", "cap_mask"):
            np.testing.assert_allclose(g[key].numpy(), np.asarray(r[key]), atol=1e-6)


def test_prior_preservation_errors(tmp_path):
    _write_pngs(tmp_path / "inst", 2, 0)
    with pytest.raises(ValueError, match="requires --class_data_dir"):
        next(t_db.dreambooth_batches(_args(tmp_path, class_data_dir=None)))
    os.makedirs(tmp_path / "empty")
    with pytest.raises(ValueError, match="contains no images"):
        next(t_db.dreambooth_batches(_args(tmp_path, class_data_dir=str(tmp_path / "empty"))))


@pytest.mark.parametrize("model", ["NextDiT_2B_patch2", "MMDiT_SD3_Medium"])
def test_main_end_to_end(tmp_path, monkeypatch, model):
    """`main` on a shrunk registry entry: 2 steps with prior preservation,
    then the final checkpoint, whose ema stream holds finite weights."""
    monkeypatch.setitem(t_models.MODELS, "NextDiT_2B_patch2",
                        lambda **kw: t_nd.NextDiT(**{**NEXTDIT_TINY, **kw}))
    monkeypatch.setitem(t_models.MODELS, "MMDiT_SD3_Medium",
                        lambda **kw: t_mmdit.MMDiT(**dict(
                            patch_size=2, in_channels=16, dim=64, n_layers=2, n_heads=4,
                            pos_embed_max_size=12, pos_embed_base_size=4, **kw)))
    _write_pngs(tmp_path / "inst", 3, 0)
    _write_pngs(tmp_path / "cls", 3, 1)
    out = tmp_path / "out"
    state = t_db.main([
        "--model", model, "--instance_data_dir", str(tmp_path / "inst"),
        "--class_data_dir", str(tmp_path / "cls"), "--instance_prompt", "a photo of sks dog",
        "--class_prompt", "a photo of a dog", "--with_prior_preservation",
        "--resolution", "32", "--max_train_steps", "2", "--cap_feat_dim", "32",
        "--precision", "fp32", "--output_dir", str(out), "--device", "cpu"])
    assert state.step == 2
    ckpt = find_auto_resume(str(out))
    assert ckpt is not None and ckpt.endswith("0000002")
    ema = load_stream(ckpt, "ema")
    assert sorted(ema) == sorted(n for n, _ in state.model.named_parameters())
    assert all(torch.isfinite(v).all() for v in ema.values())

"""The port's Next-DiT-MoE (`lumina_t2x_tpu_torch/models/moe.py`) against the
JAX package's: `TimeMoEFFN` and `SpaceMoEFFN` on their own (SpaceMoE with
ample capacity and with a capacity small enough that tokens drop), the
three modes' forwards through the weight bridge
(`core/checkpoint.moe_state_dict_from_jax_params`), one train step with
gradients through the routers, a class-conditional trajectory, and the
trainer CLI.

Tiny configs (dim 64, 2 layers, 4 heads, 4 experts of hidden 48, top-2),
fp32 on the CPU, inputs from numpy. Every parameter is perturbed by
0.02 * N(0, 1) (the zero-init adaLN and final layer would otherwise zero the
output). The JAX models run `attn_impl="xla"`. Bar: atol 2e-4 / rtol 2e-3.
"""

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from lumina_t2x_tpu import transport as j_tr
from lumina_t2x_tpu.core.checkpoint import import_next_dit_moe_weights
from lumina_t2x_tpu.models import get_model as j_get_model
from lumina_t2x_tpu.models import moe as j_moe
from lumina_t2x_tpu.pipelines import sample_lib as j_sl
from lumina_t2x_tpu.pipelines import train_lib as j_tl
from lumina_t2x_tpu_torch import models as t_models
from lumina_t2x_tpu_torch import transport as t_tr
from lumina_t2x_tpu_torch.core.checkpoint import moe_state_dict_from_jax_params, train_state_from_jax
from lumina_t2x_tpu_torch.models import moe as t_moe
from lumina_t2x_tpu_torch.pipelines import sample_lib as t_sl
from lumina_t2x_tpu_torch.pipelines import train as t_train
from lumina_t2x_tpu_torch.pipelines import train_lib as t_tl

ATOL, RTOL = 2e-4, 2e-3
TINY = dict(patch_size=2, dim=64, n_layers=2, n_heads=4, multiple_of=16, num_classes=10,
            num_experts=4, num_experts_per_tok=2)
FFN = dict(dim=16, multiple_of=16, num_experts=4, num_experts_per_tok=2)
NAMES = ("NextDiT_MoE_600M_patch2_Time", "NextDiT_MoE_600M_patch2_Spatial",
         "NextDiT_MoE_600M_patch2_Both")


def _perturbed(tree, seed):
    flat = traverse_util.flatten_dict(jax.tree.map(np.asarray, tree))
    rng = np.random.default_rng(seed)
    return traverse_util.unflatten_dict(
        {k: (v + 0.02 * rng.standard_normal(v.shape)).astype(np.float32) for k, v in flat.items()})


def _ffn_state_dict(params):
    """A JAX MoE FFN's params -> the port module's state dict."""
    sd = {"gate.weight": torch.from_numpy(np.array(params["gate"]["kernel"]).T)}
    for name in ("w1", "w2", "w3"):
        for j, w in enumerate(np.asarray(params[name])):
            sd[f"experts.{j}.{name}.weight"] = torch.from_numpy(np.array(w.T))
    return sd


def test_time_moe_matches_jax():
    """Per-item routing on the conditioning: every item's top-2 of 4."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 5, 16)).astype(np.float32)
    cond = rng.standard_normal((6, 24)).astype(np.float32)
    jffn = j_moe.TimeMoEFFN(**FFN)
    params = _perturbed(jffn.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(cond))
                        ["params"], 1)
    ref = jffn.apply({"params": params}, jnp.asarray(x), jnp.asarray(cond))
    tffn = t_moe.TimeMoEFFN(16, 24, 16, None, 4, 2)
    tffn.load_state_dict(_ffn_state_dict(params), strict=True)
    with torch.no_grad():
        got = tffn(torch.from_numpy(x), torch.from_numpy(cond))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    _, top_i = tffn.route(torch.from_numpy(cond))
    assert len(set(top_i.flatten().tolist())) > 2  # the items do not all pick alike


@pytest.mark.parametrize("capacity_factor", [4.0, 0.5])
def test_space_moe_matches_jax(capacity_factor):
    """Per-token routing; at capacity factor 0.5 each expert holds
    ceil(T*k/E*0.5) = 12 of 48 token slots, so tokens drop (in token order)
    and contribute 0 for that expert, as in JAX's one-hot dispatch."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 8, 16)).astype(np.float32)
    jffn = j_moe.SpaceMoEFFN(capacity_factor=capacity_factor, **FFN)
    params = _perturbed(jffn.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"], 2)
    ref = jffn.apply({"params": params}, jnp.asarray(x))
    tffn = t_moe.SpaceMoEFFN(16, 16, 16, None, 4, 2, capacity_factor=capacity_factor)
    tffn.load_state_dict(_ffn_state_dict(params), strict=True)
    with torch.no_grad():
        got = tffn(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    _, top_i = tffn.route(torch.from_numpy(x).reshape(24, 16))
    load = torch.bincount(top_i.flatten(), minlength=4)
    capacity = int(np.ceil(24 * 2 / 4 * capacity_factor))
    assert (int(load.max()) > capacity) == (capacity_factor < 1)


def test_top_k_breaks_ties_toward_the_lower_index():
    """A zero gate ties every logit: both packages pick experts 0 and 1."""
    logits = torch.zeros(3, 5)
    logits[1, 3] = 1.0
    values, idx = t_moe.top_k_lower_index(logits, 2)
    j_values, j_idx = jax.lax.top_k(jnp.asarray(logits.numpy()), 2)
    assert idx.tolist() == np.asarray(j_idx).tolist() == [[0, 1], [3, 0], [0, 1]]
    assert torch.equal(values, torch.from_numpy(np.asarray(j_values)))


@functools.lru_cache(maxsize=None)
def _params(mode, scan_blocks):
    """Randomized JAX params of a mode (the capacity factor does not change
    the init), built once."""
    jmodel = j_moe.NextDiTMoE(attn_impl="xla", scan_blocks=scan_blocks,
                              **dict(TINY, moe_mode=mode, qk_norm=True))
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(3), jnp.zeros((2, 4, 8, 8)),
                                     jnp.zeros((2,)), jnp.zeros((2,), jnp.int32))
    return _perturbed(variables["params"], 4)


@functools.lru_cache(maxsize=None)
def _pair(mode, capacity_factor=2.0, scan_blocks=True):
    kw = dict(TINY, moe_mode=mode, capacity_factor=capacity_factor, qk_norm=True)
    jmodel = j_moe.NextDiTMoE(attn_impl="xla", scan_blocks=scan_blocks, **kw)
    params = _params(mode, scan_blocks)
    tmodel = t_moe.NextDiTMoE(**kw).eval()
    tmodel.load_state_dict(moe_state_dict_from_jax_params(params), strict=True)
    return jmodel, params, tmodel


def _inputs(seed, b=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 4, 8, 8)).astype(np.float32),
            rng.uniform(0, 1, b).astype(np.float32), np.array([3, 10, 0, 9][:b], np.int64))


@pytest.mark.parametrize("mode,capacity_factor", [("time", 2.0), ("space", 2.0),
                                                  ("space", 0.25), ("both", 2.0),
                                                  ("dense", 2.0)])
def test_forward_matches_jax(mode, capacity_factor):
    jmodel, params, tmodel = _pair(mode, capacity_factor)
    x, t, y = _inputs(5)
    ref = jax.jit(jmodel.apply)({"params": params}, *map(jnp.asarray, (x, t, y)))
    with torch.no_grad():
        got = tmodel(*map(torch.from_numpy, (x, t, y)))
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("mode", ["time", "both"])
def test_bridge_round_trip_through_the_jax_importer(mode):
    """The reference layout (`experts.<j>.w*.weight`, `gate.weight`,
    `feed_forward_{time,space}` for both) maps back to the same tree through
    the JAX importer, scanned and per layer."""
    for scan in (True, False):
        _, params, _ = _pair(mode, scan_blocks=scan)
        sd = moe_state_dict_from_jax_params(params)
        ffn = "feed_forward_time" if mode == "both" else "feed_forward"
        assert {f"layers.1.{ffn}.experts.3.w2.weight", f"layers.0.{ffn}.gate.weight"} <= set(sd)
        back = import_next_dit_moe_weights({k: v.numpy() for k, v in sd.items()}, n_layers=2,
                                           scan_layers=scan)
        flat, flat_back = (traverse_util.flatten_dict(p) for p in (params, back))
        assert sorted(flat) == sorted(flat_back)
        for key, arr in flat.items():
            np.testing.assert_array_equal(np.asarray(flat_back[key]), arr, err_msg=str(key))


@pytest.mark.parametrize("mode", ["both"])
def test_train_step_matches_jax(mode):
    """One AdamW step of `both` (a TimeMoE and a SpaceMoE a block) without
    label dropout: loss, grad norm, and the updated params, both routers'
    gates included (their gradient comes through the softmax of the selected
    logits)."""
    kw = dict(TINY, moe_mode=mode, class_dropout_prob=0.0, qk_norm=True)
    jmodel = j_moe.NextDiTMoE(attn_impl="xla", **kw)
    params = dict(_pair(mode)[1])  # without dropout the label table has no null row
    params["y_embedder"] = {"embedding": params["y_embedder"]["embedding"][:10]}
    jopt, topt = j_tl.create_optimizer(1e-3, 0.0), t_tl.create_optimizer(1e-3, 0.0)
    jstate = j_tl.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                             opt_state=jopt.init(params), ema_params=params)
    model_sd, ema_sd, opt_sd = train_state_from_jax(params, params, jstate.opt_state,
                                                    moe_state_dict_from_jax_params)
    tmodel = t_moe.NextDiTMoE(**kw)
    tmodel.load_state_dict(model_sd, strict=True)
    tstate = t_tl.TrainState(step=0, model=tmodel, ema=ema_sd, opt_state=opt_sd)
    cond = lambda b: {"y": b["y"]}
    jstep = jax.jit(j_tl.make_train_step(
        jmodel, j_tr.create_transport("Linear", "velocity", snr_type="lognorm"), jopt, cond))
    tstep = t_tl.make_train_step(
        tmodel, t_tr.create_transport("Linear", "velocity", snr_type="lognorm"), topt, cond)
    r = np.random.default_rng(6)
    batch = {"x": r.standard_normal((4, 4, 8, 8)).astype(np.float32),
             "y": r.integers(0, 10, (4,)).astype(np.int32)}
    rng = jax.random.PRNGKey(7)
    _, loss_rng = jax.random.split(jax.random.fold_in(rng, 0))
    t_key, noise_key = jax.random.split(loss_rng)
    draws = [(torch.from_numpy(np.array(j_tr.transport.sample_t(t_key, 4, "lognorm"))),
              torch.from_numpy(np.array(jax.random.normal(noise_key, (4, 4, 8, 8)))))]
    jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch), rng)
    tstate, tm = tstep(tstate, {"x": torch.from_numpy(batch["x"]),
                                "y": torch.from_numpy(batch["y"]).long()}, 0, draws=draws)
    np.testing.assert_allclose(tm["loss"], float(jm["loss"]), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(tm["grad_norm"], float(jm["grad_norm"]), atol=ATOL, rtol=RTOL)
    ref = moe_state_dict_from_jax_params(jstate.params)
    got = tstate.model.state_dict()
    gates = [n for n in ref if n.endswith("gate.weight")]
    assert gates and all(not torch.equal(got[n], model_sd[n]) for n in gates)
    for name, r_ in ref.items():
        np.testing.assert_allclose(got[name].numpy(), r_.numpy(), atol=ATOL, rtol=RTOL,
                                   err_msg=name)


def test_class_cond_trajectory_matches_jax():
    jmodel, params, tmodel = _pair("both")
    labels = np.array([5, 1], np.int32)
    kw = dict(num_steps=3, solver="midpoint", cfg_scale=4.0, latent_size=8, in_channels=4)
    key = jax.random.PRNGKey(9)
    ref = jax.jit(j_sl.build_class_cond_sample_fn(jmodel, **kw))({"params": params}, key,
                                                                  jnp.asarray(labels))
    z = np.array(jax.random.normal(key, (2, 4, 8, 8)))
    got = t_sl.build_class_cond_sample_fn(tmodel, **kw)(torch.from_numpy(z),
                                                        torch.from_numpy(labels).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_ep_axis_raises():
    # expert parallelism runs over a process group (tests/test_torch_parallel.py
    # runs it on a gloo world); one process without one has none to shard over
    with pytest.raises(RuntimeError, match="process group"):
        t_moe.NextDiTMoE(ep_axis="expert", moe_mode="space", **TINY)
    with pytest.raises(ValueError, match="moe_mode"):
        t_moe.NextDiTMoE(moe_mode="tokens", **TINY)


@pytest.mark.parametrize("name", NAMES)
def test_registry_param_counts_match_jax(name):
    """Each MoE registry config has the JAX config's parameter count (meta
    device, jax.eval_shape); the port never holds JAX's (B, d, h) per-item
    expert weights or a (T, E, C) dispatch, so only the parameters count."""
    tmodel = t_models.get_model(name, qk_norm=True, device="meta")
    jmodel = j_get_model(name, qk_norm=True)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 4, 8, 8)),
                            jnp.zeros((1,)), jnp.zeros((1,), jnp.int32))
    j_count = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in tmodel.parameters()) == j_count
    assert t_models.is_class_cond(name) and tmodel.moe_mode == jmodel.moe_mode


def test_expert_outputs_route_rows_without_per_item_weights():
    """`_expert_outputs` runs each expert once, on the rows routed to it,
    and returns (N, k, ...) in the rows' order; dropped pairs are 0."""
    calls = []

    def expert(j):
        return lambda rows: calls.append((j, rows.shape[0])) or rows * (j + 1)

    x = torch.arange(5.0)[:, None].repeat(1, 3)
    top_i = torch.tensor([[2, 0], [0, 1], [1, 2], [2, 1], [0, 2]])
    keep = torch.ones_like(top_i, dtype=torch.bool)
    keep[4, 1] = False
    out = t_moe._expert_outputs(x, top_i, [expert(j) for j in range(3)], keep)
    assert sorted(calls) == [(0, 3), (1, 3), (2, 3)]
    assert torch.equal(out[:, :, 0], torch.tensor([[0.0, 0.0], [1, 2], [4, 6], [9, 6], [4, 0]]))


def test_trainer_cli_trains_moe(tmp_path, monkeypatch):
    """The trainer takes MoE models class-conditionally (the registry's
    `Both` shrunk to the tiny config): 2 steps, finite losses, a checkpoint
    with expert weights. TensorBoard, which the trainer writes to when it
    imports, is held out: this case is about the model, not the logger."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setitem(t_models.MODELS, "NextDiT_MoE_600M_patch2_Both",
                        lambda **kw: t_moe.NextDiTMoE(**{**kw, **TINY, "moe_mode": "both"}))
    state = t_train.main(["--model", "NextDiT_MoE_600M_patch2_Both", "--data_path",
                          "synthetic://8x8", "--results_dir", str(tmp_path),
                          "--global_batch_size", "4", "--max_steps", "2", "--log_every", "1",
                          "--num_classes", "10", "--optimizer", "adafactor",
                          "--precision", "fp32", "--checkpointing", "--device", "cpu"])
    assert state.step == 2
    names = state.model.state_dict()
    assert "layers.1.feed_forward_space.experts.3.w1.weight" in names
    with open(tmp_path / "NextDiT_MoE_600M_patch2_Both" / "metrics.jsonl") as f:
        losses = [float(line.split('"train/loss": ')[1].split(",")[0]) for line in f]
    assert len(losses) == 2 and np.isfinite(losses).all()

"""The port's Flag-DiT (`lumina_t2x_tpu_torch/models/flag_dit.py`), its weight
bridge (`core/checkpoint.flag_dit_state_dict_from_jax_params`), its sampler
branches (`pipelines/sample_lib.py`: the NTK extrapolation of the
text-to-image trajectory, the calibration, the class-conditional CFG) and a
class-conditional train step against the JAX package's.

Tiny configs (dim 64, 2 layers, 4 heads, caption dim 32), fp32 on the CPU,
inputs from numpy. Every parameter is perturbed by 0.02 * N(0, 1): the
zero-initialised adaLN, final layer and gates would otherwise make the output
exactly 0. The JAX models run `attn_impl="xla"`, or "flash" (the Pallas
kernels in interpret mode) where the calibration needs the streaming kernel.
Bar: atol 2e-4 / rtol 2e-3.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from lumina_t2x_tpu import transport as j_tr
from lumina_t2x_tpu.core.checkpoint import import_flag_dit_weights
from lumina_t2x_tpu.models import flag_dit as j_fd
from lumina_t2x_tpu.models import get_model as j_get_model
from lumina_t2x_tpu.models import layers as j_layers
from lumina_t2x_tpu.pipelines import sample_lib as j_sl
from lumina_t2x_tpu.pipelines import train_lib as j_tl
from lumina_t2x_tpu_torch import models as t_models
from lumina_t2x_tpu_torch import transport as t_tr
from lumina_t2x_tpu_torch.core.checkpoint import (flag_dit_state_dict_from_jax_params,
                                                  train_state_from_jax)
from lumina_t2x_tpu_torch.models import flag_dit as t_fd
from lumina_t2x_tpu_torch.pipelines import sample as t_sample
from lumina_t2x_tpu_torch.pipelines import sample_lib as t_sl
from lumina_t2x_tpu_torch.pipelines import train_lib as t_tl

ATOL, RTOL = 2e-4, 2e-3
TINY = dict(patch_size=2, dim=64, n_layers=2, n_heads=4, multiple_of=16)
TEXT = dict(TINY, cap_feat_dim=32)
CLASS = dict(TINY, num_classes=10, use_eol_token=False)
FAMILY = ("DiT_Llama_5B_patch2", "FlagDiT_ImageNet_600M_patch2", "FlagDiT_ImageNet_3B_patch2",
          "FlagDiT_ImageNet_7B_patch2")

jfa = importlib.import_module("lumina_t2x_tpu.ops.flash_attention")
tfa = importlib.import_module("lumina_t2x_tpu_torch.ops.flash_attention")


@pytest.fixture(autouse=True)
def _reset_bounds(monkeypatch):
    """The static-max bound is module state in both packages."""
    for var in ("LUMINA_FLASH_STATIC_MAX", "LUMINA_FLASH_STATIC_MAX_AUTO",
                "LUMINA_FLASH_CALIBRATE"):
        monkeypatch.delenv(var, raising=False)
    jfa.set_flash_static_max(None)
    yield
    jfa.set_flash_static_max(None)


def _init_args(kind, b=2, ly=9):
    x, t = jnp.zeros((b, 4, 8, 8)), jnp.zeros((b,))
    if kind == "text":
        return (x, t, jnp.zeros((b, ly, 32)), jnp.ones((b, ly), jnp.int32)), {}
    return (x, t), {"y": jnp.zeros((b,), jnp.int32)}


def _randomized(jmodel, kind, seed=2):
    args, kw = _init_args(kind)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(seed), *args, **kw)
    flat = traverse_util.flatten_dict(jax.tree.map(np.asarray, variables["params"]))
    rng = np.random.default_rng(seed)
    return traverse_util.unflatten_dict(
        {k: (v + 0.02 * rng.standard_normal(v.shape)).astype(np.float32) for k, v in flat.items()})


@functools.lru_cache(maxsize=None)
def _pair(kind="text", qk_norm=True, jax_impl="xla", scan_blocks=True):
    """A JAX Flag-DiT with randomized params and the port's holding the same
    weights (built once per config)."""
    kw = dict(TEXT if kind == "text" else CLASS, qk_norm=qk_norm)
    jmodel = j_fd.FlagDiT(attn_impl=jax_impl, scan_blocks=scan_blocks, **kw)
    params = _randomized(jmodel, kind)
    tmodel = t_fd.FlagDiT(**kw).eval()
    tmodel.load_state_dict(flag_dit_state_dict_from_jax_params(params), strict=True)
    return jmodel, params, tmodel


def _inputs(seed, kind, b=2, h=8, w=8, ly=9):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 4, h, w)).astype(np.float32)
    t = rng.uniform(0, 1, b).astype(np.float32)
    if kind == "text":
        cap = rng.standard_normal((b, ly, 32)).astype(np.float32)
        mask = np.ones((b, ly), np.int32)
        mask[0, 6:] = 0
        return (x, t), dict(cap_feats=cap, cap_mask=mask)
    return (x, t), dict(y=np.array([3, 10, 0, 9][:b], np.int64))  # 10: the null class


def _run_both(jmodel, params, tmodel, args, kw, **extra):
    ref = jax.jit(functools.partial(jmodel.apply, **extra))(
        {"params": params}, *map(jnp.asarray, args), **{k: jnp.asarray(v) for k, v in kw.items()})
    with torch.no_grad():
        got = tmodel(*map(torch.from_numpy, args), **{k: torch.from_numpy(v) for k, v in kw.items()},
                     **extra)
    return got, np.asarray(ref)


@pytest.mark.parametrize("kind", ["text", "class"])
@pytest.mark.parametrize("qk_norm", [True, False])
def test_forward_matches_jax(kind, qk_norm):
    jmodel, params, tmodel = _pair(kind, qk_norm)
    args, kw = _inputs(3, kind)
    got, ref = _run_both(jmodel, params, tmodel, args, kw)
    assert got.dtype == torch.float32 and got.shape == args[0].shape
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("kind,extra", [
    ("text", dict(ntk_factor=3.0)), ("text", dict(proportional_attn=True, base_seqlen=4)),
    ("class", dict(rope_scaling_factor=2.0, ntk_factor=1.5))])
def test_rope_factors_and_proportional_scale_match_jax(kind, extra):
    """The NTK and linear RoPE factors, and the proportional scale, which
    counts the [eol] column in the text model's sequence length; a 12x16
    latent makes the rows and columns differ."""
    jmodel, params, tmodel = _pair(kind)
    args, kw = _inputs(4, kind, h=12, w=16)
    got, ref = _run_both(jmodel, params, tmodel, args, kw, **extra)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)
    plain, _ = _run_both(jmodel, params, tmodel, args, kw)
    assert not torch.allclose(got, plain, atol=1e-5)


def test_eol_column():
    """The text model appends one [eol] token per row of patches, (H/p) *
    (W/p + 1) in all, which reaches every image token through attention and
    is dropped by the head; the class-conditional model has none."""
    _, _, tmodel = _pair("text")
    seen = []
    hook = tmodel.layers[0].register_forward_hook(lambda mod, a, out: seen.append(out.shape))
    args, kw = _inputs(5, "text", h=12, w=16)
    targs = [torch.from_numpy(a) for a in args]
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    with torch.no_grad():
        base = tmodel(*targs, **tkw)
        tmodel.eol_token.add_(1.0)
        moved = tmodel(*targs, **tkw)
        tmodel.eol_token.sub_(1.0)
    hook.remove()
    assert seen[0] == (2, 6 * (8 + 1), 64)
    assert base.shape == (2, 4, 12, 16) and (moved - base).abs().min() > 0
    assert not hasattr(_pair("class")[2], "eol_token")


@pytest.mark.parametrize("kind", ["text", "class"])
def test_forward_with_cfg_matches_jax(kind):
    jmodel, params, tmodel = _pair(kind)
    args, kw = _inputs(6, kind, b=4 if kind == "class" else 2)
    if kind == "class":
        kw["y"] = np.array([7, 2, 10, 10], np.int64)
    jcfg = jax.jit(functools.partial(j_fd.forward_with_cfg, jmodel, cfg_scale=4.0,
                                     ntk_factor=2.0))
    ref = jcfg({"params": params}, *map(jnp.asarray, args),
               **{k: jnp.asarray(v) for k, v in kw.items()})
    with torch.no_grad():
        got = t_fd.forward_with_cfg(tmodel, *map(torch.from_numpy, args), 4.0, ntk_factor=2.0,
                                    **{k: torch.from_numpy(v) for k, v in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    half = got.shape[0] // 2
    np.testing.assert_array_equal(got[:half, :3].numpy(), got[half:, :3].numpy())


@pytest.mark.parametrize("scan_blocks", [True, False])
def test_bridge_round_trip_through_the_jax_importer(scan_blocks):
    """Scanned and per-layer trees -> the reference `DiT_Llama` state dict,
    which the JAX importer maps back to the same tree and the port loads
    strictly; the class-conditional tree carries its label table."""
    _, params, _ = _pair("text", True, scan_blocks=scan_blocks)
    sd = flag_dit_state_dict_from_jax_params(params)
    assert {"eol_token", "layers.1.attention.wk_y.weight", "layers.0.attention_y_norm.weight",
            "layers.0.adaLN_modulation.1.weight", "cap_embedder.1.weight"} <= set(sd)
    assert sd["layers.0.adaLN_modulation.1.weight"].shape == (6 * 64, 64)
    back = import_flag_dit_weights({k: v.numpy() for k, v in sd.items()}, n_layers=2,
                                   scan_layers=scan_blocks)
    flat, flat_back = (traverse_util.flatten_dict(p) for p in (params, back))
    assert sorted(flat) == sorted(flat_back)
    for key, arr in flat.items():
        np.testing.assert_array_equal(np.asarray(flat_back[key]), arr, err_msg=str(key))
    csd = flag_dit_state_dict_from_jax_params(_pair("class")[1])
    assert "y_embedder.embedding_table.weight" in csd and "cap_embedder.1.weight" not in csd
    missing, unexpected = t_fd.FlagDiT(**CLASS, qk_norm=True).load_state_dict(csd)
    assert not missing and not unexpected


def test_t2i_trajectory_extrapolates_as_jax():
    """A 3-point midpoint trajectory, CFG 4, t-shift 4, at 16x24 latents
    with train_res 64: the area exceeds train_res^2, so both packages run the
    NTK factor 48/4 and the proportional scale."""
    jmodel, params, tmodel = _pair("text")
    rng = np.random.default_rng(7)
    cap = rng.standard_normal((2, 9, 32)).astype(np.float32)
    mask = np.ones((2, 9), np.int32)
    mask[1, 3:] = 0
    kw = dict(width=24 * 8, height=16 * 8, num_steps=3, solver="midpoint", cfg_scale=4.0,
              time_shifting_factor=4.0, train_res=64)
    key = jax.random.PRNGKey(3)
    ref = jax.jit(j_sl.build_t2i_sample_fn(jmodel, **kw))({"params": params}, key,
                                                          jnp.asarray(cap), jnp.asarray(mask))
    z = np.array(jax.random.normal(key, (1, 4, 16, 24)))
    got = t_sl.build_t2i_sample_fn(tmodel, **kw)(*map(torch.from_numpy, (z, cap, mask)))
    assert got.shape == (1, 4, 16, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    plain = t_sl.build_t2i_sample_fn(tmodel, **dict(kw, train_res=1024))(
        *map(torch.from_numpy, (z, cap, mask)))
    assert not torch.allclose(got, plain, atol=1e-5)


def test_calibration_bound_matches_jax():
    """Latent 16x272: 1088 image tokens (1096 with the [eol] column) stream,
    so both packages calibrate; the bounds agree."""
    jmodel, params, tmodel = _pair("text", jax_impl="flash")
    rng = np.random.default_rng(8)
    cap = rng.standard_normal((2, 6, 32)).astype(np.float32)
    mask = np.ones((2, 6), np.int32)
    key = jax.random.PRNGKey(5)
    z = np.array(jax.random.normal(key, (1, 4, 16, 272)))
    kw = dict(width=272 * 8, height=16 * 8, cfg_scale=4.0, time_shifting_factor=4.0,
              num_probe_steps=2)
    j_bound = j_sl.autocalibrate_flash_static_max(
        jmodel, {"params": params}, jnp.asarray(cap), jnp.asarray(mask), rng=key, **kw)
    t_bound = t_sl.autocalibrate_flash_static_max(
        tmodel, torch.from_numpy(cap), torch.from_numpy(mask), z=torch.from_numpy(z), **kw)
    assert j_bound is not None and t_bound is not None
    assert abs(t_bound - j_bound) <= 1e-3


def test_class_cond_sampler_matches_jax():
    """The class-conditional sampler passes the labels by keyword."""
    jmodel, params, tmodel = _pair("class")
    labels = np.array([5, 1], np.int32)
    kw = dict(num_steps=3, solver="midpoint", cfg_scale=4.0, latent_size=8, in_channels=4)
    key = jax.random.PRNGKey(9)
    ref = jax.jit(j_sl.build_class_cond_sample_fn(jmodel, **kw))({"params": params}, key,
                                                                  jnp.asarray(labels))
    z = np.array(jax.random.normal(key, (2, 4, 8, 8)))
    got = t_sl.build_class_cond_sample_fn(tmodel, **kw)(torch.from_numpy(z),
                                                        torch.from_numpy(labels).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


@functools.lru_cache(maxsize=None)
def _label_embedding(jmodel):
    """The label embedding JAX's model computes under `train` (dropout from
    the key), jitted once per model."""
    @jax.jit
    def embed(params, x, y, key):
        _, inter = jmodel.apply(
            {"params": params}, jnp.zeros_like(x), jnp.zeros((x.shape[0],)), y=y, train=True,
            rngs={"label_dropout": key}, mutable=["intermediates"],
            capture_intermediates=lambda mdl, _: isinstance(mdl, j_layers.LabelEmbedder))
        return inter["intermediates"]["y_embedder"]["__call__"][0]
    return embed


def _jax_draws(jmodel, params, rng, step, batch):
    """JAX's (t, x0, label-drop mask) of one step: the mask is the rows of
    the label embedding that equal the null class's."""
    drop_rng, loss_rng = jax.random.split(jax.random.fold_in(rng, step))
    t_key, noise_key = jax.random.split(loss_rng)
    b = batch["x"].shape[0]
    t = j_tr.transport.sample_t(t_key, b, "lognorm")
    x0 = jax.random.normal(noise_key, batch["x"].shape, jnp.float32)
    emb = np.asarray(_label_embedding(jmodel)(params, jnp.asarray(batch["x"]),
                                              jnp.asarray(batch["y"]), drop_rng))
    drop = np.all(emb == np.asarray(params["y_embedder"]["embedding"])[jmodel.num_classes], -1)
    return [(torch.from_numpy(np.asarray(t)), torch.from_numpy(np.asarray(x0)),
             torch.from_numpy(drop.astype(np.int64)))]


def test_class_cond_train_step_matches_jax():
    """Two AdamW steps of the class-conditional Flag-DiT at class dropout
    0.5: loss, grad norm, then params, EMA and moments."""
    kw = dict(CLASS, class_dropout_prob=0.5, qk_norm=True)
    jmodel = j_fd.FlagDiT(attn_impl="xla", **kw)
    params = _pair("class")[1]  # the dropout rate does not change the init
    jopt, topt = j_tl.create_optimizer(1e-3, 0.01), t_tl.create_optimizer(1e-3, 0.01)
    jstate = j_tl.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                             opt_state=jopt.init(params),
                             ema_params=jax.tree.map(lambda a: jnp.asarray(a) + 0.01, params))
    to_sd = flag_dit_state_dict_from_jax_params
    model_sd, ema_sd, opt_sd = train_state_from_jax(jstate.params, jstate.ema_params,
                                                    jstate.opt_state, to_sd)
    tmodel = t_fd.FlagDiT(**kw)
    tmodel.load_state_dict(model_sd, strict=True)
    tstate = t_tl.TrainState(step=0, model=tmodel, ema=ema_sd, opt_state=opt_sd)
    cond = lambda b: {"y": b["y"]}
    jstep = jax.jit(j_tl.make_train_step(
        jmodel, j_tr.create_transport("Linear", "velocity", snr_type="lognorm"), jopt, cond))
    tstep = t_tl.make_train_step(
        tmodel, t_tr.create_transport("Linear", "velocity", snr_type="lognorm"), topt, cond)
    rng = jax.random.PRNGKey(5)
    for s in range(2):
        r = np.random.default_rng(10 + s)
        batch = {"x": r.standard_normal((4, 4, 8, 8)).astype(np.float32),
                 "y": r.integers(0, 10, (4,)).astype(np.int32)}
        draws = _jax_draws(jmodel, jstate.params, rng, s, batch)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch), rng)
        tstate, tm = tstep(tstate, {"x": torch.from_numpy(batch["x"]),
                                    "y": torch.from_numpy(batch["y"]).long()}, 0, draws=draws)
        np.testing.assert_allclose(tm["loss"], float(jm["loss"]), atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(tm["grad_norm"], float(jm["grad_norm"]), atol=ATOL, rtol=RTOL)
    model_sd, ema_sd, opt_sd = train_state_from_jax(jstate.params, jstate.ema_params,
                                                    jstate.opt_state, to_sd)
    for got, ref, rel in ((tstate.model.state_dict(), model_sd, False), (tstate.ema, ema_sd, False),
                          (tstate.opt_state["mu"], opt_sd["mu"], True)):
        atol = ATOL * max(float(r.abs().max()) for r in ref.values()) if rel else ATOL
        for name, r in ref.items():
            np.testing.assert_allclose(got[name].numpy(), r.numpy(), atol=atol, rtol=RTOL,
                                       err_msg=name)


@pytest.mark.parametrize("name", FAMILY)
def test_registry_param_counts_match_jax(name):
    """Each Flag-DiT registry config has the JAX config's parameter count
    (the meta device and jax.eval_shape: nothing is allocated); the 5B keeps
    its 4096-wide caption default."""
    text = not t_models.is_class_cond(name)
    tmodel = t_models.get_model(name, qk_norm=True, device="meta")
    jmodel = j_get_model(name, qk_norm=True)
    args, kw = _init_args("text" if text else "class", b=1)
    if text:
        args = args[:2] + (jnp.zeros((1, 4, 4096)), jnp.ones((1, 4), jnp.int32))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), *args, **kw)
    j_count = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in tmodel.parameters()) == j_count
    assert (tmodel.dim, tmodel.n_layers, tmodel.n_heads, tmodel.cap_feat_dim) == (
        jmodel.dim, jmodel.n_layers, jmodel.n_heads, 4096 if text else 0)


def test_sampler_cli_runs_flag_dit(tmp_path, monkeypatch):
    """`pipelines.sample.main` with the registry's Flag-DiT names shrunk to
    the tiny configs: the text model keeps the 5B's 4096-wide captions, the
    ImageNet one samples class-conditionally."""
    monkeypatch.setitem(t_models.MODELS, "DiT_Llama_5B_patch2",
                        lambda **kw: t_fd.FlagDiT(**{"cap_feat_dim": 4096, **kw, **TINY}))
    monkeypatch.setitem(t_models.MODELS, "FlagDiT_ImageNet_7B_patch2",
                        lambda **kw: t_fd.FlagDiT(**{"num_classes": 1000, **kw, **TINY,
                                                     "use_eol_token": False}))
    common = ["--resolution", "1:64x64", "--num_sampling_steps", "3", "--device", "cpu",
              "--precision", "fp32", "--bf16_params"]
    text = t_sample.main(["--model", "DiT_Llama_5B_patch2", "--qk_norm", "--debug",
                          "--image_save_path", str(tmp_path / "t"), *common])
    assert text["args"]["cap_feat_dim"] == 4096
    assert np.load(text["items"][0]["path"]).shape == (4, 8, 8)
    labels = t_sample.main(["--model", "FlagDiT_ImageNet_7B_patch2", "--labels", "1,2",
                            "--image_save_path", str(tmp_path / "c"), *common])
    assert [np.load(i["path"]).shape for i in labels["items"]] == [(4, 8, 8)] * 2


def test_demo_worker_serves_the_5b(monkeypatch):
    """`build_worker("DiT_Llama_5B_patch2")` (the registry entry shrunk to the
    tiny widths) builds the 5B with 2048-wide captions, as the JAX demo
    does, and serves a request through the Flag-DiT branch of the sampler."""
    from lumina_t2x_tpu_torch.pipelines import demo as t_demo

    monkeypatch.setitem(t_models.MODELS, "DiT_Llama_5B_patch2",
                        lambda **kw: t_fd.FlagDiT(**{"cap_feat_dim": 4096, **kw, **TINY}))
    worker = t_demo.build_worker("DiT_Llama_5B_patch2", "fp32", debug=True, device="cpu")
    assert isinstance(worker.model, t_fd.FlagDiT)
    assert worker.cap_feat_dim == worker.model.cap_feat_dim == 2048
    out = worker.infer(t_demo.InferenceRequest(cap="a red cube", resolution="64x64",
                                               num_sampling_steps=3))
    assert out["latents"].shape == (1, 4, 8, 8) and np.isfinite(out["latents"]).all()

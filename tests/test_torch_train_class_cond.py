"""The port's class-conditional trainer against the JAX package's: train
steps of the Tiny NextDiT-ImageNet (`pipelines/train_lib.make_train_step`
with labels, the label dropout replayed from JAX's draw) on synthetic
latents, in pixel space and on the GVP path; the ImageFolder loader's crop,
flip and normalisation (`pipelines/train.imagenet_batches`) against JAX's
`center_crop_arr` and `to_latent_input`; and the trainer CLI on a shapes
ImageFolder (`data/shapes.py`), with and without a VAE, resumed and not.

fp32 on the CPU, inputs from numpy seeds, every parameter perturbed by
0.02 * N(0, 1) (`test_torch_next_dit_imagenet._randomized_params`). The JAX
model runs `attn_impl="xla"`. Bar: atol 2e-4 / rtol 2e-3, the optimizer
moments relative to their largest element, as in `test_torch_train.py`.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from lumina_t2x_tpu import transport as j_tr
from lumina_t2x_tpu.data import imgproc as j_imgproc
from lumina_t2x_tpu.models import layers as j_layers
from lumina_t2x_tpu.models import next_dit_imagenet as j_ni
from lumina_t2x_tpu.pipelines import train_lib as j_tl
from lumina_t2x_tpu_torch import transport as t_tr
from lumina_t2x_tpu_torch.core import checkpoint as t_ckpt
from lumina_t2x_tpu_torch.core.checkpoint import (imagenet_state_dict_from_jax_params,
                                                  train_state_from_jax)
from lumina_t2x_tpu_torch.data import shapes as t_shapes
from lumina_t2x_tpu_torch.data.dataset import resumable_sampler_indices
from lumina_t2x_tpu_torch.data.loader import list_imagenet_folder
from lumina_t2x_tpu_torch.models import next_dit_imagenet as t_ni
from lumina_t2x_tpu_torch.pipelines import train as t_train
from lumina_t2x_tpu_torch.pipelines import train_lib as t_tl

from test_torch_next_dit_imagenet import _randomized_params
from test_torch_vae import diffusers_sd

ATOL, RTOL = 2e-4, 2e-3
MODEL = "NextDiT_ImageNet_Tiny_patch2"


def _jcond(b):
    return {"y": b["y"]}


def _jax_drop_mask(jmodel, params, y, key):
    """The label-dropout mask JAX's model draws from `key`: the rows of the
    y_embedder output that equal the null class's embedding."""
    b, chans = y.shape[0], jmodel.in_channels

    @jax.jit
    def embed(params, y, key):
        _, inter = jmodel.apply(
            {"params": params}, jnp.zeros((b, chans, 8, 8)), jnp.zeros((b,)), y, train=True,
            rngs={"label_dropout": key}, mutable=["intermediates"],
            capture_intermediates=lambda mdl, _: isinstance(mdl, j_layers.LabelEmbedder))
        return inter["intermediates"]["y_embedder"]["__call__"][0]

    emb = np.asarray(embed(params, jnp.asarray(y), key))
    null = np.asarray(params["y_embedder"]["embedding"])[jmodel.num_classes]
    return torch.from_numpy(np.all(emb == null, axis=-1).astype(np.int64))


def _jax_draws(jmodel, params, rng, step, batch, snr_type, micro):
    """JAX's (t, x0, label-drop mask) of each micro-batch of one step."""
    drop_rng, loss_rng = jax.random.split(jax.random.fold_in(rng, step))
    mb = batch["x"].shape[0] // micro
    out = []
    for i in range(micro):
        dkey = drop_rng if micro == 1 else jax.random.fold_in(drop_rng, i)
        lkey = loss_rng if micro == 1 else jax.random.fold_in(loss_rng, i)
        t_key, noise_key = jax.random.split(lkey)
        t = j_tr.transport.sample_t(t_key, mb, snr_type)
        x0 = jax.random.normal(noise_key, (mb, *batch["x"].shape[1:]), jnp.float32)
        drop = _jax_drop_mask(jmodel, params, batch["y"][i * mb:(i + 1) * mb], dkey)
        out.append((torch.from_numpy(np.asarray(t)), torch.from_numpy(np.asarray(x0)), drop))
    return out


def _batch(seed, chans, b=4):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((b, chans, 8, 8)).astype(np.float32),
            "y": rng.integers(0, 1000, (b,)).astype(np.int32)}


def _close_tree(got, ref, what, relative=False):
    atol = ATOL * max(float(r.abs().max()) for r in ref.values()) if relative else ATOL
    for name, r in ref.items():
        np.testing.assert_allclose(got[name].numpy(), r.numpy(), atol=atol, rtol=RTOL,
                                   err_msg=f"{what}: {name}")


@pytest.mark.parametrize("case", ["synthetic", "pixel", "gvp_micro"])
def test_class_cond_train_steps_match_jax(case):
    """Two AdamW steps at class dropout 0.5 (so both kept and dropped labels
    occur), snr lognorm; `pixel`: 3 input channels; `gvp_micro`: the GVP path
    and 2 micro-batches."""
    chans = 3 if case == "pixel" else 4
    path = "GVP" if case.startswith("gvp") else "Linear"
    micro = 2 if case.endswith("micro") else 1
    kw = dict(class_dropout_prob=0.5, in_channels=chans)
    jmodel = j_ni.NextDiT_ImageNet_Tiny_patch2(attn_impl="xla", **kw)
    params = _randomized_params(jmodel, 2, chans)
    jopt, topt = j_tl.create_optimizer(1e-3, 0.01), t_tl.create_optimizer(1e-3, 0.01)
    jstate = j_tl.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                             opt_state=jopt.init(params),
                             ema_params=jax.tree.map(lambda a: jnp.asarray(a) + 0.01, params))
    to_sd = imagenet_state_dict_from_jax_params
    model_sd, ema_sd, opt_sd = train_state_from_jax(jstate.params, jstate.ema_params,
                                                    jstate.opt_state, to_sd)
    tmodel = t_ni.NextDiT_ImageNet_Tiny_patch2(**kw)
    tmodel.load_state_dict(model_sd, strict=True)
    tstate = t_tl.TrainState(step=0, model=tmodel, ema=ema_sd, opt_state=opt_sd)
    jt = j_tr.create_transport(path, "velocity", snr_type="lognorm")
    tt = t_tr.create_transport(path, "velocity", snr_type="lognorm")
    jstep = jax.jit(j_tl.make_train_step(jmodel, jt, jopt, _jcond, micro_batches=micro))
    tstep = t_tl.make_train_step(tmodel, tt, topt, _jcond, micro_batches=micro)
    rng = jax.random.PRNGKey(5)
    drops = []
    for s in range(2):
        batch = _batch(10 + s, chans)
        draws = _jax_draws(jmodel, jstate.params, rng, s, batch, "lognorm", micro)
        drops += [d for _, _, d in draws]
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch), rng)
        tstate, tm = tstep(tstate, {"x": torch.from_numpy(batch["x"]),
                                    "y": torch.from_numpy(batch["y"]).long()}, 0, draws=draws)
        np.testing.assert_allclose(tm["loss"], float(jm["loss"]), atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(tm["grad_norm"], float(jm["grad_norm"]), atol=ATOL,
                                   rtol=RTOL)
    drops = torch.cat(drops)
    assert 0 < int(drops.sum()) < drops.numel()
    model_sd, ema_sd, opt_sd = train_state_from_jax(jstate.params, jstate.ema_params,
                                                    jstate.opt_state, to_sd)
    _close_tree(tstate.model.state_dict(), model_sd, "params")
    _close_tree(tstate.ema, ema_sd, "ema")
    _close_tree(tstate.opt_state["mu"], opt_sd["mu"], "mu", relative=True)
    _close_tree(tstate.opt_state["nu"], opt_sd["nu"], "nu", relative=True)


def test_label_dropout_comes_from_the_step_generator():
    """Without draws the step's label dropout comes from (seed, step): two
    runs of one step agree bit for bit, and the mask differs across steps."""
    def run(step):
        torch.manual_seed(0)
        model = t_ni.NextDiT_ImageNet_Tiny_patch2(class_dropout_prob=0.5)
        masks = []
        real = model.y_embedder.forward

        def spy(labels, **kw):
            out = real(labels, **kw)
            masks.append((out == model.y_embedder.embedding_table.weight[1000]).all(-1))
            return out

        model.y_embedder.forward = spy
        state = t_tl.create_train_state(model, t_tl.create_optimizer(1e-3))
        state.step = step
        fn = t_tl.make_train_step(model, t_tr.create_transport(), t_tl.create_optimizer(1e-3),
                                  _jcond)
        batch = {k: torch.from_numpy(v).long() if k == "y" else torch.from_numpy(v)
                 for k, v in _batch(3, 4, b=16).items()}
        _, m = fn(state, batch, 7)
        return masks[0], m["loss"]

    (a, la), (b, lb), (c, _) = run(0), run(0), run(1)
    assert torch.equal(a, b) and la == lb
    assert not torch.equal(a, c)


# -- the ImageFolder stream -------------------------------------------------------------


@pytest.fixture(scope="module")
def shapes_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("shapes")
    t_shapes.write_imagefolder(str(root / "train"), n_per_class=1, seed=0, size=24)
    # one non-square image in a class of its own: the crop's resize path
    odd = root / "train" / "zz_wide"
    odd.mkdir()
    Image.fromarray(t_shapes.render(3, np.random.default_rng(1), 48)[:30]).save(odd / "0.png")
    return str(root / "train")


def test_folder_crop_flip_and_normalisation_match_jax(shapes_dir):
    """Each item of `imagenet_batches` is JAX's `center_crop_arr` +
    `to_latent_input` of its file, flipped where `flip_of` (seed, position)
    says; both flips occur."""
    class Args:
        data_path, image_size, global_batch_size = shapes_dir, 16, 17
        global_seed, num_workers = 4, 2

    samples, classes = list_imagenet_folder(shapes_dir)
    assert len(classes) == 17
    batch = next(t_train.imagenet_batches(Args()))
    order = resumable_sampler_indices(len(samples), 17, 0, 1, seed=4)
    flips = []
    for pos, (x, y) in enumerate(zip(batch["x"], batch["y"])):
        path, label = samples[next(order)]
        img = j_imgproc.center_crop_arr(Image.open(path).convert("RGB"), 16)
        flips.append(t_train.flip_of(4, pos))
        if flips[-1]:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        np.testing.assert_array_equal(x, j_imgproc.to_latent_input(img))
        assert y == label
    assert any(flips) and not all(flips)


# -- the CLI -----------------------------------------------------------------------------


def _cli(results, steps, *extra):
    return t_train.main(["--model", MODEL, "--results_dir", str(results),
                         "--global_batch_size", "4", "--max_steps", str(steps),
                         "--log_every", "1", "--ckpt_every", "100", "--qk_norm",
                         "--checkpointing", "--precision", "fp32", "--device", "cpu",
                         "--num_workers", "2", "--keep_last", "1", *extra])


def _losses(results):
    with open(os.path.join(results, MODEL, "metrics.jsonl")) as f:
        return [float(line.split('"train/loss": ')[1].split(",")[0]) for line in f]


def test_cli_folder_resume_equals_uninterrupted_run(tmp_path, shapes_dir):
    """`--pixel_space` on the shapes folder: 2 steps and an `--auto_resume`
    third equal 3 straight steps bit for bit (flips, order, draws)."""
    extra = ["--data_path", shapes_dir, "--pixel_space", "--image_size", "16",
             "--num_classes", "17"]
    _cli(tmp_path / "a", 2, *extra)
    resumed = _cli(tmp_path / "a", 3, "--auto_resume", *extra)
    straight = _cli(tmp_path / "b", 3, *extra)
    assert resumed.step == straight.step == 3
    for name, p in straight.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[name], p), name
    for name, e in straight.ema.items():
        assert torch.equal(resumed.ema[name], e), name
    assert _losses(tmp_path / "a")[2] == _losses(tmp_path / "b")[2]


@pytest.mark.parametrize("data", ["folder_vae", "synthetic_vp"])
def test_cli_runs_end_to_end(tmp_path, shapes_dir, data):
    """The folder through a tiny VAE (its latents, 4 channels at 1/8 of
    --image_size), and synthetic latents and labels on the VP path; the
    checkpoint's model_args carry the class-conditional settings."""
    if data == "folder_vae":
        vae = str(tmp_path / "vae.safetensors")
        t_ckpt.save_safetensors({k: torch.from_numpy(v) for k, v in
                                 diffusers_sd((1, 1, 2, 2), seed=12).items()}, vae)
        extra = ["--data_path", shapes_dir, "--image_size", "32", "--vae_ckpt", vae,
                 "--num_classes", "17", "--class_dropout_prob", "0.5"]
    else:
        extra = ["--data_path", "synthetic://4x4", "--path_type", "VP", "--snr_type", "lognorm"]
    state = _cli(tmp_path, 2, *extra)
    assert state.step == 2 and np.isfinite(_losses(tmp_path)).all()
    assert state.model.num_classes == (17 if data == "folder_vae" else 1000)
    ckpt = tmp_path / MODEL / "checkpoints" / "0000002"
    args = t_ckpt.load_model_args(str(ckpt))
    assert args["model"] == MODEL and args["data_path"] == extra[1]
    with open(tmp_path / MODEL / "metrics.jsonl") as f:
        assert ("vae_encode_ms" in f.read()) == (data == "folder_vae")

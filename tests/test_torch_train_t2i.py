"""The port's meta-dataset text-to-image training path and its pre-encoder
against the JAX package's: `pipelines/train.py` (`t2i_batches`,
`caption_features`, the VAE encode, one train step) and
`pipelines/encode_latents.py`.

The tiny pieces of the other port tests carry over: Gemma (vocab 256, hidden
32, 3 layers; `test_torch_text_encoders`), the factor-8 SD-VAE (ch 32,
(1, 1, 2, 2), one resnet; `test_torch_vae`) and NextDiT (dim 64, 2 layers,
caption dim 32, qk-norm; `test_torch_train`). Images are PNGs written here;
`t2i_batches` decodes them with Pillow or, as the trainer does whenever g++
builds the loader (as JAX does), natively.
The JAX VAE's posterior noise and the JAX step's draws are handed to the
port as tensors. fp32 on the CPU; bar atol 2e-4 / rtol 2e-3.
"""

import argparse
import itertools
import json
import os
import random
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumina_t2x_tpu import transport as j_tr
from lumina_t2x_tpu.codecs import text_encoders as jte
from lumina_t2x_tpu.codecs import vae as jv
from lumina_t2x_tpu.models import next_dit as j_nd
from lumina_t2x_tpu.pipelines import encode_latents as j_el
from lumina_t2x_tpu.pipelines import train as j_train
from lumina_t2x_tpu.pipelines import train_lib as j_tl
from lumina_t2x_tpu_torch import transport as t_tr
from lumina_t2x_tpu_torch.codecs import text_encoders as tte
from lumina_t2x_tpu_torch.codecs import vae as tv
from lumina_t2x_tpu_torch.core.checkpoint import save_safetensors, train_state_from_jax
from lumina_t2x_tpu_torch.data import dataset as t_ds
from lumina_t2x_tpu_torch.data import imgproc as t_ip
from lumina_t2x_tpu_torch.data import native_loader as t_nl
from lumina_t2x_tpu_torch.models import next_dit as t_nd
from lumina_t2x_tpu_torch.pipelines import encode_latents as t_el
from lumina_t2x_tpu_torch.pipelines import train as t_train
from lumina_t2x_tpu_torch.pipelines import train_lib as t_tl

from test_torch_next_dit import TINY
from test_torch_text_encoders import flax_gemma, save_gemma_dir, torch_gemma
from test_torch_train import (_compare_states, _jax_draws, _jcond, _optimizers, _params,
                              _tcond)
from test_torch_vae import diffusers_sd

ATOL, RTOL = 2e-4, 2e-3
VAE_MULT = (1, 1, 2, 2)
CAPTIONS = ["a red fox in snow", "", "two boats on a lake at sunrise", "a", "city at night",
            "macro photo of a bee", "an empty room", "mountains"]


def _image(w, h, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 200 / w, yy * 200 / h, np.full((h, w), 90.0)], -1)
    return np.clip(base + rng.normal(0, 20, base.shape), 0, 255).astype(np.uint8)


def write_dataset(tmp_path, sizes):
    """PNG images of `sizes` with CAPTIONS, an annotation list and a
    block-YAML meta config; returns the config's path."""
    from lumina_t2x_tpu_torch.utils import png_bytes

    rows = []
    for i, (w, h) in enumerate(sizes):
        (tmp_path / f"{i}.png").write_bytes(png_bytes(_image(w, h, i)))
        rows.append({"path": f"{i}.png", "caption": CAPTIONS[i % len(CAPTIONS)]})
    (tmp_path / "ann.json").write_text(json.dumps(rows))
    cfg = tmp_path / "data.yaml"
    cfg.write_text(f"META:\n  - path: {tmp_path / 'ann.json'}\n    type: default\n"
                   f"    root: {tmp_path}\n")
    return str(cfg)


def tiny_vae_pair():
    sd = diffusers_sd(VAE_MULT, seed=3)
    jvae = jv.AutoencoderKL(ch=32, ch_mult=VAE_MULT, num_res_blocks=1)
    jvars = {"params": jv.import_autoencoder_kl_weights(sd, ch_mult=VAE_MULT, num_res_blocks=1,
                                                        ch=32)}
    tsd = {k: torch.from_numpy(v) for k, v in sd.items()}
    tvae = tv.AutoencoderKL(**tv.architecture(tsd))
    tvae.load_state_dict(tsd, strict=True)
    return jvae, jvars, tvae.eval(), tsd


def _args(cfg, **kw):
    base = dict(data_path=cfg, image_size=64, global_batch_size=2, global_seed=0,
                cache_data_on_disk=False, pin_bucket=None, num_workers=1,
                caption_dropout_prob=0.0, cap_feat_dim=32)
    base.update(kw)
    return argparse.Namespace(**base)


# -- one step against JAX --------------------------------------------------------------


@pytest.mark.parametrize("captions", ["encoder", "hashed"])
def test_t2i_step_matches_jax(tmp_path, captions):
    """A 64^2 meta batch (one pinned bucket: no crop to draw) through each
    package's data path, caption features (the LM's, or hashed
    pseudo-features without one) and VAE, then one AdamW step."""
    cfg = write_dataset(tmp_path, [(64, 64)] * 4)
    args = _args(cfg, pin_bucket="64x64")
    jenc = tenc = None
    if captions == "encoder":
        jenc = jte.DecoderTextEncoder(flax_gemma(), tte.char_tokenizer(), 256)
        tenc = tte.DecoderTextEncoder(torch_gemma(), tte.char_tokenizer(), 256)

    jgen = j_train.t2i_batches(args, jenc)
    jbatch = next(jgen)
    jgen.close()
    tgen = t_train.t2i_batches(args, tenc, "cpu")
    raw = next(tgen)
    tgen.close()
    # Pillow's pixels normalized as (u / 255 - 0.5) / 0.5, not u / 127.5 - 1
    np.testing.assert_allclose(raw["x"], jbatch["x"], atol=1e-6, rtol=0)
    cap_feats, cap_mask = raw["cap_feats"], raw["cap_mask"]
    assert raw["text_encode_ms"] >= 0
    np.testing.assert_array_equal(cap_mask.numpy(), jbatch["cap_mask"])
    np.testing.assert_allclose(cap_feats.numpy(), jbatch["cap_feats"], atol=ATOL, rtol=RTOL)

    jvae, jvars, tvae, _ = tiny_vae_pair()
    key = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    jlat = np.asarray(jv.encode_to_latent(jvae, jvars, jnp.asarray(jbatch["x"]), key))
    noise = torch.from_numpy(np.array(jax.random.normal(key, jlat.shape)))
    with torch.no_grad():
        tlat = tv.encode_to_latent(tvae, torch.from_numpy(raw["x"]), noise)
    np.testing.assert_allclose(tlat.numpy(), jlat, atol=ATOL, rtol=RTOL)

    jopt, topt = _optimizers("adamw")
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
    jbatch = {"x": jlat, "cap_feats": jbatch["cap_feats"], "cap_mask": jbatch["cap_mask"]}
    jstep = jax.jit(j_tl.make_train_step(jmodel, j_tr.create_transport(), jopt, _jcond))
    tstep = t_tl.make_train_step(tmodel, t_tr.create_transport(), topt, _tcond)
    rng = jax.random.PRNGKey(5)
    jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, jbatch), rng)
    tstate, tm = tstep(tstate, {"x": tlat, "cap_feats": cap_feats, "cap_mask": cap_mask}, 0,
                       draws=_jax_draws(rng, 0, jlat, "uniform", 1))
    _compare_states(jstate, tstate, [(jm, tm)])


def test_crop_origin_decoders_agree_on_a_draw(tmp_path):
    """Larger images cropped into the pinned bucket: the trainer's Pillow
    crops lie where the native decoder crops at `crop_origin`'s draw from
    the same (seed, position) (native bilinear and PIL bicubic differ in
    value, not in place)."""
    cfg = write_dataset(tmp_path, [(96, 80), (80, 96), (128, 64), (64, 64)])
    args = _args(cfg, pin_bucket="64x64")
    gen = t_train.t2i_batches(args)
    batches = [next(gen) for _ in range(3)]
    gen.close()
    dataset = t_ds.MetaDataset(cfg, t_ds.T2IItemProcessor(None))
    order = list(itertools.islice(
        t_ds.resumable_sampler_indices(len(dataset), 2, rank=0, world_size=1, seed=0), 6))
    for b, batch in enumerate(batches):
        assert batch["x"].shape == (2, 3, 64, 64)
        for i in range(2):
            pos = 2 * b + i
            data, caption = dataset.raw_image_item(order[pos])
            origin = t_ip.crop_origin(*t_nl.probe_size(data), (64, 64),
                                      random.Random(f"crop:0:{pos}"))
            native = t_nl.decode_to_tensor(data, (64, 64), origin)
            assert batch["captions"][i] == caption
            assert np.abs(native - batch["x"][i]).mean() < 0.1


def test_native_batches_are_the_native_decode_at_the_drawn_origin(tmp_path):
    """Under the native decoder (JAX's path when its library builds) each
    item is `decode_to_tensor` at `crop_origin`'s draw from (seed, position)
    bit for bit; an item that is neither JPEG nor PNG (a BMP here) is
    decoded by Pillow, as in JAX, and counted."""
    from PIL import Image

    cfg = write_dataset(tmp_path, [(96, 80), (80, 96), (128, 64), (64, 64)])
    Image.fromarray(_image(64, 64, 3)).save(tmp_path / "3.png", format="BMP")
    args = _args(cfg, pin_bucket="64x64")
    pillow = []
    gen = t_train.t2i_batches(args, native=True, pillow_items=pillow)
    batches = [next(gen) for _ in range(2)]
    gen.close()
    dataset = t_ds.MetaDataset(cfg, t_ds.T2IItemProcessor(None))
    order = list(itertools.islice(
        t_ds.resumable_sampler_indices(len(dataset), 2, rank=0, world_size=1, seed=0), 4))
    for b, batch in enumerate(batches):
        for i in range(2):
            pos = 2 * b + i
            data, caption = dataset.raw_image_item(order[pos])
            assert batch["captions"][i] == caption
            if order[pos] == 3:
                continue
            origin = t_ip.crop_origin(*t_nl.probe_size(data), (64, 64),
                                      random.Random(f"crop:0:{pos}"))
            np.testing.assert_array_equal(batch["x"][i],
                                          t_nl.decode_to_tensor(data, (64, 64), origin))
    assert pillow == [3]


# -- the CLI ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("t2i")
    sizes = [(64, 64), (96, 48), (48, 96), (64, 64), (80, 40), (96, 48), (64, 64), (48, 96)]
    cfg = write_dataset(root, sizes)
    vae_path = str(root / "vae.safetensors")
    save_safetensors(tiny_vae_pair()[3], vae_path)
    return {"cfg": cfg, "vae": vae_path, "gemma": save_gemma_dir(root / "gemma", flax_too=True),
            "root": root}


def _cli(assets, results, steps, *extra):
    return t_train.main(["--model", "NextDiT_Tiny_patch2", "--data_path", assets["cfg"],
                         "--image_size", "64", "--text_encoder", assets["gemma"],
                         "--vae_ckpt", assets["vae"], "--results_dir", str(results),
                         "--global_batch_size", "2", "--max_steps", str(steps),
                         "--log_every", "1", "--ckpt_every", "100", "--qk_norm",
                         "--precision", "fp32", "--device", "cpu", "--num_workers", "2",
                         "--keep_last", "1", *extra])


def _metrics(results):
    with open(os.path.join(results, "NextDiT_Tiny_patch2", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("captions", ["encoder", "hashed"])
def test_cli_auto_resume_skips_the_batches_it_took(assets, tmp_path, captions):
    """2 steps, then --auto_resume to 3: equal, bit for bit, to 3 steps in one
    run; the resumed run fast-forwards the stream past the 2 batches taken
    (captions dropped at the default 0.1 from (seed, step), in the collate
    thread)."""
    extra = [] if captions == "encoder" else ["--text_encoder", "", "--cap_feat_dim", "32"]
    _cli(assets, tmp_path / "a", 2, *extra)
    resumed = _cli(assets, tmp_path / "a", 3, "--auto_resume", *extra)
    straight = _cli(assets, tmp_path / "b", 3, *extra)
    assert resumed.step == straight.step == 3
    for name, p in straight.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[name], p), name
    for name, e in straight.ema.items():
        assert torch.equal(resumed.ema[name], e), name
    a, b = _metrics(tmp_path / "a"), _metrics(tmp_path / "b")
    assert [m["train/loss"] for m in a] == [m["train/loss"] for m in b]
    assert all(np.isfinite(m["train/loss"]) for m in b)
    assert [(m["train/bucket_w"], m["train/bucket_h"]) for m in a] \
        == [(m["train/bucket_w"], m["train/bucket_h"]) for m in b]
    assert {"train/data_wait_ms", "train/text_encode_ms", "train/vae_encode_ms"} <= set(b[0])
    assert resumed.model.cap_embedder[1].in_features == 32  # the encoder's hidden size


def test_captions_are_encoded_in_the_collate_thread(assets, tmp_path, monkeypatch):
    """As in JAX, the LM runs in the loader's collate thread, ahead of the
    step, not on the thread that runs the step."""
    threads = []
    real = t_train.caption_features

    def spy(*a, **kw):
        threads.append(threading.current_thread().name)
        return real(*a, **kw)

    monkeypatch.setattr(t_train, "caption_features", spy)
    _cli(assets, tmp_path, 2)
    assert len(threads) >= 2 and all(n.startswith("lumina-collate") for n in threads), threads


@pytest.mark.parametrize("builds", [True, False])
def test_cli_records_its_decoder(assets, tmp_path, monkeypatch, builds):
    """The trainer takes the native decoder whenever it builds (JAX's
    choice; libjpeg's and libpng's headers are here), else Pillow: it logs
    which and why, and writes `decoder` into run_summary.json."""
    if builds:
        ok, why = t_nl.native_status()
        assert ok, why
    else:
        monkeypatch.setattr(t_nl, "native_status",
                            lambda: (False, "fatal error: jpeglib.h: No such file or directory"))
    _cli(assets, tmp_path, 1, "--text_encoder", "", "--cap_feat_dim", "32")
    exp = tmp_path / "NextDiT_Tiny_patch2"
    with open(exp / "run_summary.json") as f:
        summary = json.load(f)
    assert summary["decoder"] == ("native" if builds else "pil")
    assert summary["decoder_pillow_items"] == 0
    with open(exp / "log.txt") as f:
        log = f.read()
    assert (("image decoder native: native library " in log) if builds else
            ("image decoder pil: the native decoder is unavailable: fatal error: jpeglib.h"
             in log))


def test_cli_rejects_what_the_meta_path_cannot_take(assets, tmp_path):
    with pytest.raises(SystemExit, match="pixel_space"):
        _cli(assets, tmp_path, 1, "--pixel_space")
    # an ImageFolder trains class-conditional models only
    with pytest.raises(SystemExit, match="class-conditional"):
        _cli(assets, tmp_path, 1, "--data_path", str(assets["root"]))


# -- encode_latents --------------------------------------------------------------------


@pytest.mark.parametrize("with_encoder", [True, False])
def test_encode_latents_matches_jax_file_for_file(assets, tmp_path, monkeypatch, with_encoder):
    jvae, jvars, _, _ = tiny_vae_pair()
    monkeypatch.setattr(jv, "load_vae", lambda path, **kw: (jvae, jvars))
    argv = ["--data_path", assets["cfg"], "--image_size", "64", "--vae_ckpt", assets["vae"],
            "--precision", "fp32", "--limit", "5"]
    if with_encoder:
        argv += ["--text_encoder", assets["gemma"]]
    random.seed(0)  # JAX crops and drops from the global generator
    j_el.main(argv + ["--out", str(tmp_path / "jax")])
    monkeypatch.setattr(t_el, "posterior_noise", lambda seed, i, shape, device: torch.from_numpy(
        np.array(jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(0), i), shape))))
    t_el.main(argv + ["--out", str(tmp_path / "port"), "--device", "cpu", "--seed", "0"])
    with open(tmp_path / "jax" / "index.json") as f:
        ref_index = json.load(f)
    with open(tmp_path / "port" / "index.json") as f:
        assert json.load(f) == ref_index
    assert len(ref_index) == 5
    for sub in ("latents", "captions"):
        names = sorted(os.listdir(tmp_path / "jax" / sub))
        assert sorted(os.listdir(tmp_path / "port" / sub)) == names and len(names) == 5
        for name in names:
            ref = np.load(tmp_path / "jax" / sub / name)
            got = np.load(tmp_path / "port" / sub / name)
            assert got.dtype == np.float32 and got.shape == ref.shape, (sub, name)
            np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL, err_msg=f"{sub}/{name}")


def test_entry_points_default_to_the_card(assets, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="cuda"):
        t_el.main(["--data_path", assets["cfg"], "--out", str(tmp_path / "e")])
    with pytest.raises(SystemExit, match="cuda"):
        t_train.main(["--model", "NextDiT_Tiny_patch2", "--data_path", assets["cfg"],
                      "--results_dir", str(tmp_path / "t")])

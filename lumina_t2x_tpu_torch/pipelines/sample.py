"""Sampling CLI (counterpart of `lumina_t2x_tpu/pipelines/sample.py`): the
class-conditional branch (a NextDiT-ImageNet, Flag-DiT ImageNet or
Next-DiT-MoE model, `--labels`, the ADM-evaluator FID npz of
`--num_fid_samples`) and the text-to-image branch (NextDiT or Flag-DiT;
caption features from the LM of `--text_encoder`, static-max calibration),
each an ODE trajectory;
PNGs through the SD-VAE of `--vae_ckpt` (or directly under `--pixel_space`),
`.npy` latents otherwise, and a `data.json` manifest.

    python -m lumina_t2x_tpu_torch.pipelines.sample \
        --model NextDiT_ImageNet_600M_patch2 --labels 207,360,387,974 \
        --resolution 1:256x256 --vae_ckpt sd-vae-ft-ema.safetensors --debug
    python -m lumina_t2x_tpu_torch.pipelines.sample --model NextDiT_2B_patch2 \
        --qk_norm --resolution 1:1024x1024 --num_sampling_steps 30 \
        --solver midpoint --cfg_scale 4.0 --time_shifting_factor 4 --debug

Weights come from `--ckpt` (the `ema` stream of a checkpoint directory,
whose `model_args` override `--model`, `--qk_norm`, `--cap_feat_dim`,
`--num_classes` and `--pixel_space`) or are random from `--seed`;
`--bf16_params` stores them in bf16 (what lets the 5B and 7B sample on one
card);
`--debug` ignores `--ckpt` and `--text_encoder`, as in the JAX package. The
text-to-image branch encodes the prompts (`--caption_path`, one per line)
and as many empty captions for CFG with `--text_encoder` (a local directory
of the LM and its tokenizer, `codecs/text_encoders.py`); without one, 32
random caption tokens per prompt stand in. The caption width is
`--cap_feat_dim`, else the checkpoint's, else the text encoder's, else the
model's own (Flag-DiT 5B: 4096, LLaMA-2-7B's) or 2048 (Gemma-2B's). The branch is chosen on the
resolved model name. Noise is drawn on the device from `--seed`. `--solver
dopri5|dopri8` integrates adaptively; the text-to-image branch passes it
`--atol` / `--rtol`, while the class-conditional branch runs it at the
default tolerances, as the JAX sampler does. Each run prints its model
evaluations (NFE).

`--model_parallel_size N` (> 1) shards the restored model's weights over N
tensor-parallel ranks (`shard_for_sampling`), as the JAX sampler places its
params on a (data, model) mesh: launch it with torchrun over a world that N
divides. Every rank runs the same trajectory; rank 0 writes the outputs.

    torchrun --standalone --nproc_per_node 2 -m lumina_t2x_tpu_torch.pipelines.sample \
        --model NextDiT_2B_patch2 --qk_norm --model_parallel_size 2 --debug
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import List

import numpy as np
import torch

from ..codecs.vae import decode_from_latent, load_vae
from ..core.checkpoint import init_from, load_model_args
from ..models import default_cap_feat_dim, get_model
from ..models import is_class_cond as class_cond_model
from ..utils import png_bytes
from .sample_lib import (autocalibrate_flash_static_max, build_class_cond_sample_fn,
                         build_t2i_sample_fn)

DEFAULT_LABELS = "207,360,387,974"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="lumina-t2x PyTorch sampler")
    p.add_argument("--ckpt", type=str, default=None,
                   help="checkpoint directory whose ema stream is sampled")
    p.add_argument("--model", type=str, default="NextDiT_ImageNet_600M_patch2")
    p.add_argument("--image_save_path", type=str, default="samples")
    p.add_argument("--caption_path", type=str, default=None, help="txt file, one prompt per line")
    p.add_argument("--labels", type=str, default=None,
                   help=f"comma-separated class ids (class-conditional; default {DEFAULT_LABELS})")
    p.add_argument("--resolution", type=str, nargs="+", default=["1:256x256"])
    p.add_argument("--num_sampling_steps", type=int, default=30)
    p.add_argument("--solver", type=str, default="midpoint",
                   choices=["euler", "midpoint", "heun", "rk4", "dopri5", "dopri8"])
    p.add_argument("--atol", type=float, default=1e-6,
                   help="adaptive-solver absolute tolerance (dopri5/dopri8, text-to-image)")
    p.add_argument("--rtol", type=float, default=1e-3,
                   help="adaptive-solver relative tolerance (dopri5/dopri8, text-to-image)")
    p.add_argument("--cfg_scale", type=float, default=4.0)
    p.add_argument("--time_shifting_factor", type=float, default=1.0)
    p.add_argument("--scaling_watershed", type=float, default=0.3)
    p.add_argument("--proportional_attn", action="store_true")
    p.add_argument("--qk_norm", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--precision", choices=["fp32", "bf16"], default="bf16")
    p.add_argument("--bf16_params", action="store_true", help="store model params in bf16")
    p.add_argument("--vae", type=str, choices=["ema", "mse", "sdxl", "sd3"], default="ema",
                   help="the latent scale and shift of --vae_ckpt's family")
    p.add_argument("--vae_ckpt", type=str, default=None,
                   help="diffusers-format AutoencoderKL weights (.safetensors or .pth): "
                        "decode the latents to PNGs, in fp32")
    p.add_argument("--pixel_space", action="store_true",
                   help="the class-conditional model denoises RGB pixels: outputs are PNGs, "
                        "no VAE (read from the checkpoint's model_args too)")
    p.add_argument("--num_classes", type=int, default=None,
                   help="class-conditional label-embedding size (default: the checkpoint's, "
                        "else the model's)")
    p.add_argument("--text_encoder", type=str, default=None,
                   help="local directory of the caption LM (Gemma-2B) and its tokenizer")
    p.add_argument("--cap_feat_dim", type=int, default=None,
                   help="caption feature width (default: the checkpoint's, else the text "
                        "encoder's hidden size, else 2048, Gemma-2B)")
    p.add_argument("--train_res", type=int, default=1024)
    p.add_argument("--batch_size", type=int, default=1,
                   help="labels per trajectory of --num_fid_samples")
    p.add_argument("--num_fid_samples", type=int, default=0,
                   help="class-conditional: sample N images over random classes into an "
                        "ADM-evaluator npz")
    p.add_argument("--model_parallel_size", type=int, default=1,
                   help="tensor-parallel ranks the model is sharded over (torchrun)")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--debug", action="store_true", help="random weights, no checkpoint needed")
    return p.parse_args(argv)


def parse_resolution(entry: str):
    """"<category>:<W>x<H>" -> (category, W, H)."""
    cat, wh = entry.split(":") if ":" in entry else ("1", entry)
    w, h = wh.lower().split("x")
    return int(cat), int(w), int(h)


def is_class_cond(args) -> bool:
    """Class-conditional sampling: labels given, or an ImageNet or MoE model."""
    return args.labels is not None or class_cond_model(args.model)


def load_model(args, dtype, param_dtype, device, cap_feat_dim=None):
    """The model of `args`: a checkpoint's recorded model args override
    `--model`, `--qk_norm`, `--cap_feat_dim`, `--num_classes` and
    `--pixel_space`, and its `ema` stream replaces the random weights (every
    parameter must be restored); random weights from `--seed` under
    `--debug` or without `--ckpt`. A text-to-image model's caption width is
    `args.cap_feat_dim`, else the checkpoint's, else `cap_feat_dim`, else
    the registry's `default_cap_feat_dim`."""
    train_args = {}
    use_ckpt = bool(args.ckpt) and not args.debug
    if use_ckpt:
        train_args = load_model_args(args.ckpt)
        args.model = train_args.get("model", args.model)
    if "qk_norm" in train_args:
        args.qk_norm = bool(train_args["qk_norm"])
    if train_args.get("pixel_space"):
        args.pixel_space = True
    if args.num_classes is None and train_args.get("num_classes") is not None:
        args.num_classes = int(train_args["num_classes"])
    kwargs = dict(qk_norm=args.qk_norm, dtype=dtype, param_dtype=param_dtype, device=device)
    if is_class_cond(args):
        if args.pixel_space:
            kwargs["in_channels"] = 3
        if args.num_classes is not None:
            kwargs["num_classes"] = args.num_classes
    else:
        if args.pixel_space:
            raise SystemExit("error: --pixel_space needs a class-conditional model")
        if args.cap_feat_dim is None:
            args.cap_feat_dim = int(train_args.get("cap_feat_dim") or cap_feat_dim
                                    or default_cap_feat_dim(args.model))
        kwargs["cap_feat_dim"] = args.cap_feat_dim
    torch.manual_seed(args.seed)
    model = get_model(args.model, **kwargs).eval()
    if use_ckpt:
        loaded = init_from(args.ckpt, model, "ema")
        missing = sorted(set(model.state_dict()) - set(loaded))
        if missing:
            raise SystemExit(f"error: --ckpt {args.ckpt} does not hold {len(missing)} parameters "
                             f"of {args.model}: {missing[:4]}...")
    return model


def shard_for_sampling(model, model_parallel_size: int):
    """Shard `model` over `model_parallel_size` tensor-parallel ranks of a
    (data, model) mesh of the whole world (`parallel.sharding.tensor_parallel`);
    a no-op at 1. The world must divide by the size."""
    if model_parallel_size <= 1:
        return model
    from ..parallel.mesh import create_mesh
    from ..parallel.sharding import tensor_parallel

    return tensor_parallel(model, create_mesh(model_parallel_size))


def main(argv=None):
    import tempfile

    from ..parallel import mesh as pmesh

    args = parse_args(argv)
    device = torch.device(args.device)
    started_group = False
    if args.model_parallel_size > 1:
        started_group = not pmesh.is_distributed() and pmesh.distributed_init(device)
        pmesh.create_mesh(args.model_parallel_size)  # the world must divide
        device = pmesh.local_device(device)
    with tempfile.TemporaryDirectory() as scratch:
        if pmesh.rank() != 0:  # the same images as rank 0's: not kept
            args.image_save_path = scratch
        manifest = _main(args, device)
    if started_group:
        torch.distributed.destroy_process_group()
    return manifest


def _main(args, device):
    os.makedirs(args.image_save_path, exist_ok=True)
    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    param_dtype = torch.bfloat16 if args.bf16_params else torch.float32
    encoder = None
    if args.text_encoder and not args.debug and not is_class_cond(args):
        if not os.path.isdir(args.text_encoder):
            raise SystemExit(f"error: --text_encoder directory not found: {args.text_encoder}")
        from ..codecs.text_encoders import DecoderTextEncoder

        encoder = DecoderTextEncoder.from_pretrained(args.text_encoder, dtype=dtype,
                                                     device=device)
        if args.cap_feat_dim is None and not args.ckpt:
            args.cap_feat_dim = encoder.hidden_size
    model = shard_for_sampling(load_model(args, dtype, param_dtype, device),
                               args.model_parallel_size)
    if encoder is not None and encoder.hidden_size != args.cap_feat_dim:
        raise SystemExit(f"error: --text_encoder gives {encoder.hidden_size}-wide features, "
                         f"the model takes {args.cap_feat_dim}")
    # fp32, as the JAX sampler decodes (`load_vae(args.vae_ckpt)`); loaded once
    vae = load_vae(args.vae_ckpt, device=device) if args.vae_ckpt else None
    gen = torch.Generator(device=device).manual_seed(args.seed)
    manifest = {"args": vars(args), "items": []}
    if is_class_cond(args):
        _sample_class_cond(args, model, vae, gen, manifest)
    else:
        _sample_t2i(args, model, vae, gen, manifest, encoder)
    with open(os.path.join(args.image_save_path, "data.json"), "w") as f:
        json.dump(manifest, f, indent=2, default=str)
    return manifest


def _sample_class_cond(args, model, vae, gen, manifest):
    _, w, _ = parse_resolution(args.resolution[0])
    latent = w if args.pixel_space else w // 8
    shift = args.time_shifting_factor if args.time_shifting_factor != 1.0 else None
    sample_fn = build_class_cond_sample_fn(
        model, num_steps=args.num_sampling_steps, solver=args.solver, cfg_scale=args.cfg_scale,
        time_shifting_factor=shift, latent_size=latent, in_channels=model.in_channels)
    shape = (model.in_channels, latent, latent)
    if args.num_fid_samples > 0:
        path = _sample_fid_npz(args, model, vae, sample_fn, shape, gen)
        manifest["items"].append({"fid_npz": path, "n": args.num_fid_samples})
        return
    labels = [int(x) for x in (args.labels or DEFAULT_LABELS).split(",")]
    y = torch.tensor(labels, dtype=torch.int64, device=gen.device)
    z = torch.randn((len(labels), *shape), generator=gen, device=gen.device)
    t_start = time.perf_counter()
    latents = sample_fn(z, y)
    seconds = time.perf_counter() - t_start
    _save_outputs(latents, args, vae, manifest, [str(label) for label in labels])
    _report(manifest, sample_fn, seconds, f"sampled {len(labels)} class-conditional images", args)


def _sample_t2i(args, model, vae, gen, manifest, encoder=None):
    prompts = ["a photo of an astronaut riding a horse"]
    if args.caption_path:
        if not os.path.exists(args.caption_path):
            raise SystemExit(f"error: --caption_path file not found: {args.caption_path}")
        with open(args.caption_path) as f:
            prompts = [line.strip() for line in f if line.strip()]
    device = gen.device
    if encoder is not None:
        # the prompts, then as many empty captions (CFG's unconditional half)
        t_start = time.perf_counter()
        cap_feats, cap_mask = encoder.encode(prompts + [""] * len(prompts))
        print(f"encoded {2 * len(prompts)} captions ({cap_mask.shape[1]} tokens) in "
              f"{time.perf_counter() - t_start:.3f}s")
        manifest["caption_tokens"] = cap_mask.sum(dim=1).tolist()
    else:
        # no text encoder: 32 random caption tokens stand in for its features
        ly = 32
        cap_feats = torch.randn((2 * len(prompts), ly, args.cap_feat_dim), generator=gen,
                                device=device)
        cap_mask = torch.ones((2 * len(prompts), ly), dtype=torch.int32, device=device)
    for res in args.resolution:
        _, w, h = parse_resolution(res)
        proportional = args.proportional_attn or (w * h > args.train_res**2)
        bound = autocalibrate_flash_static_max(
            model, cap_feats, cap_mask, width=w, height=h, cfg_scale=args.cfg_scale,
            time_shifting_factor=args.time_shifting_factor, train_res=args.train_res,
            scale_watershed=args.scaling_watershed, proportional_attn=proportional,
            generator=gen,
        )
        if bound is not None:
            print(f"flash static-max calibrated: {bound:.2f}")
        sample_fn = build_t2i_sample_fn(
            model, width=w, height=h, num_steps=args.num_sampling_steps, solver=args.solver,
            cfg_scale=args.cfg_scale, time_shifting_factor=args.time_shifting_factor,
            train_res=args.train_res, scale_watershed=args.scaling_watershed,
            proportional_attn=proportional, static_max=bound, atol=args.atol, rtol=args.rtol,
        )
        z = torch.randn((len(prompts), 4, h // 8, w // 8), generator=gen, device=device)
        t_start = time.perf_counter()
        latents = sample_fn(z, cap_feats, cap_mask)
        seconds = time.perf_counter() - t_start
        _save_outputs(latents, args, vae, manifest, prompts, res_tag=f"{w}x{h}")
        _report(manifest, sample_fn, seconds, f"sampled {len(prompts)} prompts at {w}x{h}", args)


def _report(manifest, sample_fn, seconds, what, args):
    """Record and print the trajectory's seconds and its model evaluations
    (`sample_fn.nfe`; None for a sample function that does not count)."""
    nfe = getattr(sample_fn, "nfe", None)
    manifest["nfe"], manifest["seconds"] = nfe, seconds
    print(f"{what} in {seconds:.2f}s ({args.solver}, NFE {nfe})")


def to_uint8(images: torch.Tensor) -> np.ndarray:
    """(B, 3, H, W) images in [-1, 1] -> (B, H, W, 3) uint8:
    clip((x + 1) / 2 * 255, 0, 255), truncated, as the JAX sampler converts."""
    x = images.float().cpu().numpy()
    return np.clip((x + 1) / 2 * 255, 0, 255).astype(np.uint8).transpose(0, 2, 3, 1)


def _images(latents, args, vae):
    """uint8 images of a batch of latents (through the VAE, or the pixels
    themselves under --pixel_space), or None when neither applies."""
    if vae is not None:
        with torch.no_grad():
            return to_uint8(decode_from_latent(vae, latents.float(), args.vae))
    if args.pixel_space:
        return to_uint8(latents)
    return None


def _sample_fid_npz(args, model, vae, sample_fn, shape, gen):
    """Sample N images over uniform random classes (numpy, `--seed`) into the
    ADM-evaluator npz: `arr_0` uint8 (N, H, W, 3), or the float32 latents
    (N, C, h, w) without a VAE; `arr_1` the labels."""
    n, b = args.num_fid_samples, max(args.batch_size, 1)
    rng = np.random.default_rng(args.seed)
    out, labels = [], []
    for done in range(0, n, b):
        y = rng.integers(0, model.num_classes, (b,))
        labels.append(y)
        z = torch.randn((b, *shape), generator=gen, device=gen.device)
        latents = sample_fn(z, torch.from_numpy(y).to(gen.device))
        images = _images(latents, args, vae)
        out.append(images if images is not None else latents.float().cpu().numpy())
        if (done + b) % (b * 10) == 0:
            print(f"fid sampling: {done + b}/{n}")
    arr = np.concatenate(out)[:n]
    path = os.path.join(args.image_save_path, f"samples_{n}x{arr.shape[1]}x{arr.shape[2]}.npz")
    np.savez(path, arr_0=arr, arr_1=np.concatenate(labels)[:n])
    print(f"saved FID batch to {path}")
    return path


def _save_outputs(latents: torch.Tensor, args, vae, manifest, names: List[str],
                  res_tag: str = ""):
    """One file per name: a PNG (through the VAE, or the pixels under
    --pixel_space) or the `.npy` latent."""
    for i, name in enumerate(names[: latents.shape[0]]):
        slug = "".join(c if c.isalnum() else "_" for c in name)[:64]
        images = _images(latents[i: i + 1], args, vae)
        if images is not None:
            out = os.path.join(args.image_save_path, f"{slug}_{res_tag}.png")
            with open(out, "wb") as f:
                f.write(png_bytes(images[0]))
        else:
            out = os.path.join(args.image_save_path, f"{slug}_{res_tag}.npy")
            np.save(out, latents[i].float().cpu().numpy())
        manifest["items"].append({"name": name, "path": out, "resolution": res_tag,
                                  "solver": args.solver, "steps": args.num_sampling_steps,
                                  "cfg_scale": args.cfg_scale, "seed": args.seed})


if __name__ == "__main__":
    main()

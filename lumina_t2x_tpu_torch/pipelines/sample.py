"""Text-to-image sampling CLI (counterpart of
`lumina_t2x_tpu/pipelines/sample.py`, its t2i branch): weights from
`--ckpt` (the `ema` stream of a checkpoint directory, whose `model_args`
override `--model`, `--qk_norm` and `--cap_feat_dim`) or random from
`--seed`, random caption features, static-max calibration, the ODE
trajectory, and `.npy` latents with a `data.json` manifest.

    python -m lumina_t2x_tpu_torch.pipelines.sample --model NextDiT_2B_patch2 \
        --qk_norm --resolution 1:1024x1024 --num_sampling_steps 30 \
        --solver midpoint --cfg_scale 4.0 --time_shifting_factor 4 --debug

`--debug` ignores `--ckpt`, as in the JAX package. Not ported yet (ROADMAP
queue 1): the text encoder (`--text_encoder`), the VAE decode
(`--vae_ckpt`), the class-conditional branch and the adaptive solvers that
`--atol` / `--rtol` configure.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import List

import numpy as np
import torch

from ..core.checkpoint import init_from, load_model_args
from ..models import get_model
from .sample_lib import autocalibrate_flash_static_max, build_t2i_sample_fn


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="lumina-t2x PyTorch sampler (text-to-image)")
    p.add_argument("--ckpt", type=str, default=None,
                   help="checkpoint directory whose ema stream is sampled")
    p.add_argument("--model", type=str, default="NextDiT_2B_patch2")
    p.add_argument("--image_save_path", type=str, default="samples")
    p.add_argument("--caption_path", type=str, default=None, help="txt file, one prompt per line")
    p.add_argument("--resolution", type=str, nargs="+", default=["1:1024x1024"])
    p.add_argument("--num_sampling_steps", type=int, default=30)
    p.add_argument("--solver", type=str, default="midpoint",
                   choices=["euler", "midpoint", "heun", "rk4"])
    p.add_argument("--atol", type=float, default=1e-6,
                   help="adaptive-solver absolute tolerance (the adaptive solvers are not ported)")
    p.add_argument("--rtol", type=float, default=1e-3,
                   help="adaptive-solver relative tolerance (the adaptive solvers are not ported)")
    p.add_argument("--cfg_scale", type=float, default=4.0)
    p.add_argument("--time_shifting_factor", type=float, default=1.0)
    p.add_argument("--scaling_watershed", type=float, default=0.3)
    p.add_argument("--proportional_attn", action="store_true")
    p.add_argument("--qk_norm", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--precision", choices=["fp32", "bf16"], default="bf16")
    p.add_argument("--bf16_params", action="store_true", help="store model params in bf16")
    p.add_argument("--cap_feat_dim", type=int, default=None,
                   help="caption feature width (default: the checkpoint's, else 2048, Gemma-2B)")
    p.add_argument("--vae_ckpt", type=str, default=None, help="not ported yet")
    p.add_argument("--text_encoder", type=str, default=None, help="not ported yet")
    p.add_argument("--train_res", type=int, default=1024)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--debug", action="store_true", help="random weights, no checkpoint needed")
    return p.parse_args(argv)


def parse_resolution(entry: str):
    """"<category>:<W>x<H>" -> (category, W, H)."""
    cat, wh = entry.split(":") if ":" in entry else ("1", entry)
    w, h = wh.lower().split("x")
    return int(cat), int(w), int(h)


def load_model(args, dtype, param_dtype, device):
    """The model of `args`: a checkpoint's recorded model args override
    `--model`, `--qk_norm` and `--cap_feat_dim`, and its `ema` stream
    replaces the random weights (every parameter must be restored); random
    weights from `--seed` under `--debug` or without `--ckpt`."""
    train_args = {}
    use_ckpt = bool(args.ckpt) and not args.debug
    if use_ckpt:
        train_args = load_model_args(args.ckpt)
        args.model = train_args.get("model", args.model)
    if args.cap_feat_dim is None:
        args.cap_feat_dim = int(train_args.get("cap_feat_dim") or 2048)
    if "qk_norm" in train_args:
        args.qk_norm = bool(train_args["qk_norm"])
    torch.manual_seed(args.seed)
    model = get_model(args.model, qk_norm=args.qk_norm, cap_feat_dim=args.cap_feat_dim,
                      dtype=dtype, param_dtype=param_dtype, device=device).eval()
    if use_ckpt:
        loaded = init_from(args.ckpt, model, "ema")
        missing = sorted(set(model.state_dict()) - set(loaded))
        if missing:
            raise SystemExit(f"error: --ckpt {args.ckpt} does not hold {len(missing)} parameters "
                             f"of {args.model}: {missing[:4]}...")
    return model


def main(argv=None):
    args = parse_args(argv)
    for flag in ("vae_ckpt", "text_encoder"):
        if getattr(args, flag):
            raise SystemExit(f"error: --{flag} is not ported yet (ROADMAP queue 1, item 6)")
    os.makedirs(args.image_save_path, exist_ok=True)
    device = torch.device(args.device)
    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    param_dtype = torch.bfloat16 if args.bf16_params else torch.float32
    model = load_model(args, dtype, param_dtype, device)

    prompts = ["a photo of an astronaut riding a horse"]
    if args.caption_path:
        if not os.path.exists(args.caption_path):
            raise SystemExit(f"error: --caption_path file not found: {args.caption_path}")
        with open(args.caption_path) as f:
            prompts = [line.strip() for line in f if line.strip()]
    gen = torch.Generator(device=device).manual_seed(args.seed)
    # no text encoder: 32 random caption tokens stand in for its features
    ly = 32
    cap_feats = torch.randn((2 * len(prompts), ly, args.cap_feat_dim), generator=gen,
                            device=device)
    cap_mask = torch.ones((2 * len(prompts), ly), dtype=torch.int32, device=device)

    manifest = {"args": vars(args), "items": []}
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
            proportional_attn=proportional, static_max=bound,
        )
        z = torch.randn((len(prompts), 4, h // 8, w // 8), generator=gen, device=device)
        t_start = time.perf_counter()
        latents = sample_fn(z, cap_feats, cap_mask).float().cpu().numpy()
        _save_outputs(latents, args, manifest, prompts, res_tag=f"{w}x{h}")
        print(f"sampled {len(prompts)} prompts at {w}x{h} in {time.perf_counter() - t_start:.2f}s")

    with open(os.path.join(args.image_save_path, "data.json"), "w") as f:
        json.dump(manifest, f, indent=2, default=str)
    return manifest


def _save_outputs(latents: np.ndarray, args, manifest, names: List[str], res_tag: str = ""):
    for i, name in enumerate(names[: latents.shape[0]]):
        slug = "".join(c if c.isalnum() else "_" for c in name)[:64]
        out = os.path.join(args.image_save_path, f"{slug}_{res_tag}.npy")
        np.save(out, latents[i])
        manifest["items"].append({"name": name, "path": out, "resolution": res_tag,
                                  "solver": args.solver, "steps": args.num_sampling_steps,
                                  "cfg_scale": args.cfg_scale, "seed": args.seed})


if __name__ == "__main__":
    main()

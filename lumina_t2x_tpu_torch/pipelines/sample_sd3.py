"""SD3 (MMDiT) sampler through the flow framework (counterpart of
`lumina_t2x_tpu/pipelines/sample_sd3.py`).

    python -m lumina_t2x_tpu_torch.pipelines.sample_sd3 --caption_path prompts.txt \
        --ckpt sd3_medium_transformer.safetensors --clip_l text_encoder \
        --clip_g text_encoder_2 [--t5 text_encoder_3] --vae_ckpt sd3_vae.safetensors

`MMDiT_SD3_Medium` runs the mini ODE in SD3 mode (reversed time, t * 1000,
in-loop CFG over duplicated halves; 28 Euler steps, CFG 7, shift 3 by
default), then the SD3 VAE decodes (scale 1.5305, shift 0.0609; `load_vae`
reads z = 16 and no quant convs off the file) to PNGs; without a VAE the
latents are saved as `.npy`. The transformer loads from a diffusers-format
file (`codecs/mmdit_import.load_sd3_mmdit`: its architecture read off it);
`--debug` (or no `--ckpt`) samples random weights from `--seed`. Prompts run
through the CLIP-L + CLIP-G (+ T5) triple encoder when `--clip_l`/`--clip_g`
name local HF directories, else through tiny random towers and the hash
tokenizer (`codecs/clip_text.build_sd3_prompt_encoder`). Each caption's
noise comes from a generator seeded by (seed, caption index). Writes
`images/<idx>_<W>x<H>.{png,npy}` and `data.json` (which also resumes).
Runs in bf16 by default on `--device` (default cuda).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..models import get_model
from ..transport.mini import MiniODE
from ..utils import png_bytes

SD3_VAE_SCALE = 1.5305
SD3_VAE_SHIFT = 0.0609


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="SD3 MMDiT sampler (PyTorch)")
    p.add_argument("--ckpt", type=str, default=None,
                   help="diffusers-format SD3 transformer .safetensors")
    p.add_argument("--vae_ckpt", type=str, default=None)
    p.add_argument("--clip_l", type=str, default=None,
                   help="local HF dir of the CLIP-L text tower (SD3's `text_encoder`)")
    p.add_argument("--clip_g", type=str, default=None,
                   help="local HF dir of the CLIP-G text tower (SD3's `text_encoder_2`)")
    p.add_argument("--t5", type=str, default=None,
                   help="local HF dir of the T5 encoder (`text_encoder_3`); optional, "
                        "diffusers' zeros take its place")
    p.add_argument("--caption_path", type=str, required=True)
    p.add_argument("--image_save_path", type=str, default="samples_sd3")
    p.add_argument("--resolution", type=str, nargs="+", default=["1:1024x1024"])
    p.add_argument("--num_sampling_steps", type=int, default=28)
    p.add_argument("--solver", type=str, default="euler",
                   choices=["euler", "midpoint", "heun", "rk4"])
    p.add_argument("--cfg_scale", type=float, default=7.0)
    p.add_argument("--time_shifting_factor", type=float, default=3.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--precision", type=str, default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--debug", action="store_true")
    return p.parse_args(argv)


def load_model(args, dtype, device):
    """The MMDiT of `--ckpt` (diffusers layout), or random from `--seed`."""
    if args.ckpt and not args.debug:
        from ..codecs.mmdit_import import load_sd3_mmdit

        return load_sd3_mmdit(args.ckpt, dtype=dtype, device=device).eval()
    torch.manual_seed(args.seed)
    return get_model("MMDiT_SD3_Medium", dtype=dtype, device=device).eval()


def build_prompt_encoder(args, dtype=torch.float32, device=None):
    """The CLIP-L + CLIP-G (+ T5) triple encoder
    (`codecs/clip_text.build_sd3_prompt_encoder`)."""
    from ..codecs.clip_text import build_sd3_prompt_encoder

    return build_sd3_prompt_encoder(args.clip_l, args.clip_g, args.t5, debug=args.debug,
                                    dtype=dtype, device=device)


def main(argv=None):
    args = parse_args(argv)
    if not os.path.exists(args.caption_path):
        raise SystemExit(f"error: --caption_path file not found: {args.caption_path}")
    device = torch.device(args.device)
    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    model = load_model(args, dtype, device)

    os.makedirs(os.path.join(args.image_save_path, "images"), exist_ok=True)
    info_path = os.path.join(args.image_save_path, "data.json")
    info = json.load(open(info_path)) if os.path.exists(info_path) else []
    collected = {f'{i["idx"]}_{i["resolution"]}' for i in info}
    with open(args.caption_path, encoding="utf-8") as f:
        captions = [line.strip() for line in f if line.strip()]

    vae = None
    if args.vae_ckpt and not args.debug:
        from ..codecs.vae import load_vae

        vae = load_vae(args.vae_ckpt, device=device)
    prompt_encoder = build_prompt_encoder(args, device=device)
    if args.ckpt and not args.debug and not (args.clip_l and args.clip_g):
        print("warning: --clip_l/--clip_g not given; prompts are encoded by random debug "
              "towers (images will not follow the captions). Pass the SD3 "
              "text_encoder/text_encoder_2 (and optionally --t5) dirs to sample real SD3 "
              "outputs.")
    ode = MiniODE(args.num_sampling_steps, args.solver, args.time_shifting_factor, use_sd3=True)

    for res in args.resolution:
        wh = res.split(":")[1]
        w, h = (int(v) for v in wh.split("x"))
        for idx, caption in enumerate(captions):
            sid = f"{idx}_{wh}"
            if sid in collected:
                continue
            gen = torch.Generator(device=device).manual_seed((args.seed << 20) + idx)
            z = torch.randn((1, 16, h // 8, w // 8), generator=gen, device=device)
            context, pooled = prompt_encoder.encode_cfg_pair(caption)

            def model_fn(x, t):
                return model(x, t, context, pooled)

            t0 = time.perf_counter()
            with torch.no_grad():
                samples = ode.sample(torch.cat([z, z], dim=0), model_fn,
                                     cfg_scale=args.cfg_scale)[:1]
            if samples.is_cuda:
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            out_path = os.path.join(args.image_save_path, "images", f"{sid}.npy")
            if vae is not None:
                with torch.no_grad():
                    img = vae.decode(samples.float() / SD3_VAE_SCALE + SD3_VAE_SHIFT)
                pixels = ((img[0].float().cpu().numpy() + 1.0) / 2.0).clip(0.0, 1.0)
                out_path = out_path.replace(".npy", ".png")
                with open(out_path, "wb") as f:
                    f.write(png_bytes((pixels.transpose(1, 2, 0) * 255).astype(np.uint8)))
            else:
                np.save(out_path, samples[0].float().cpu().numpy())
            info.append({"idx": idx, "caption": caption, "resolution": wh, "path": out_path,
                         "solver": args.solver, "num_sampling_steps": args.num_sampling_steps,
                         "cfg_scale": args.cfg_scale, "seed": args.seed, "seconds": seconds})
            with open(info_path, "w") as f:
                json.dump(info, f, indent=2)
            print(f"sampled {sid}: {out_path} ({seconds:.2f} s)")
    return info


if __name__ == "__main__":
    main()

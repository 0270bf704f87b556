"""Image-to-image (SDEdit-style) sampling (counterpart of
`lumina_t2x_tpu/pipelines/sample_img2img.py`).

    python -m lumina_t2x_tpu_torch.pipelines.sample_img2img --image_path in.png \
        --caption "a watercolor painting" --image_size 1024 --strength 0.6 \
        --vae_ckpt sd-vae-ft-ema.safetensors

The input image is center-cropped to `--image_size` and encoded to a latent
by the VAE of `--vae_ckpt` (its posterior noise drawn from `--seed`); without
a VAE the JAX package's stand-in latent is used: the image average-pooled by
8, its first channel repeated as the fourth. The ODE starts from
`z * (1 - t0) + x1 * t0`, t0 = 1 - strength, over the grid of [t0, 1]
(`sample_lib.build_img2img_sample_fn`); a qk-norm model's streaming
self-attention is calibrated first (`autocalibrate_flash_static_max`). The
caption and an empty one come from the LM of `--text_encoder`, else 32
random tokens of 2048 from `--seed` stand in. The weights are the `ema`
stream of `--ckpt` or random from `--seed` (`--debug` ignores `--ckpt` and
`--text_encoder`). Writes `img2img.png` with a VAE, else `img2img.npy`, and
`data.json`. Runs on `--device` (default cuda).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..codecs.vae import (decode_from_latent, encode_to_latent, load_vae,
                          pooled_latent_standin)
from ..core.checkpoint import init_from
from ..data.imgproc import center_crop_arr, to_latent_input
from ..models import get_model
from ..utils import png_bytes
from .sample_lib import autocalibrate_flash_static_max, build_img2img_sample_fn


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="lumina img2img (PyTorch)")
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--model", type=str, default="NextDiT_2B_patch2")
    p.add_argument("--image_path", type=str, required=True)
    p.add_argument("--caption", type=str, default="")
    p.add_argument("--strength", type=float, default=0.6)
    p.add_argument("--num_sampling_steps", type=int, default=30)
    p.add_argument("--solver", type=str, default="midpoint")
    p.add_argument("--cfg_scale", type=float, default=4.0)
    p.add_argument("--time_shifting_factor", type=float, default=4.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--image_save_path", type=str, default="img2img_out")
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--precision", choices=["fp32", "bf16"], default="bf16")
    p.add_argument("--vae_ckpt", type=str, default=None)
    p.add_argument("--text_encoder", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--debug", action="store_true")
    return p.parse_args(argv)


def _synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    args = parse_args(argv)
    os.makedirs(args.image_save_path, exist_ok=True)
    device = torch.device(args.device)
    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    gen = torch.Generator(device=device).manual_seed(args.seed)

    from PIL import Image

    img = center_crop_arr(Image.open(args.image_path).convert("RGB"), args.image_size)
    pixels = torch.from_numpy(to_latent_input(img))[None].to(device)
    manifest = {"args": vars(args)}
    vae = None
    t_start = time.perf_counter()
    if args.vae_ckpt:
        vae = load_vae(args.vae_ckpt, device=device, dtype=dtype)
        t_start = time.perf_counter()
        with torch.no_grad():
            x1 = encode_to_latent(vae, pixels.to(dtype), gen).float()
    else:
        x1 = pooled_latent_standin(pixels)
    _synchronize(device)
    manifest["encode_ms"] = 1e3 * (time.perf_counter() - t_start)

    if args.text_encoder and not args.debug:
        from ..codecs.text_encoders import DecoderTextEncoder

        encoder = DecoderTextEncoder.from_pretrained(args.text_encoder, dtype=dtype,
                                                     device=device)
        cap_feats, cap_mask = encoder.encode([args.caption, ""])
    else:
        cap_feats = torch.randn((2, 32, 2048), generator=gen, device=device)
        cap_mask = torch.ones((2, 32), dtype=torch.int32, device=device)

    torch.manual_seed(args.seed)
    model = get_model(args.model, cap_feat_dim=cap_feats.shape[-1], dtype=dtype, qk_norm=True,
                      device=device).eval()
    if args.ckpt and not args.debug:
        init_from(args.ckpt, model, "ema")

    t_start = time.perf_counter()
    bound = autocalibrate_flash_static_max(
        model, cap_feats, cap_mask, width=x1.shape[3] * 8, height=x1.shape[2] * 8,
        cfg_scale=args.cfg_scale, time_shifting_factor=args.time_shifting_factor,
        generator=gen)
    manifest["static_max"] = bound
    if bound is not None:
        print(f"flash static-max calibrated: {bound:.2f} in "
              f"{time.perf_counter() - t_start:.2f}s")
    sample_fn = build_img2img_sample_fn(
        model, strength=args.strength, num_steps=args.num_sampling_steps, solver=args.solver,
        cfg_scale=args.cfg_scale, time_shifting_factor=args.time_shifting_factor,
        static_max=bound)
    z = torch.randn(x1.shape, generator=gen, device=device)
    t_start = time.perf_counter()
    out = sample_fn(z, x1, cap_feats, cap_mask)
    _synchronize(device)
    manifest["seconds"], manifest["nfe"] = time.perf_counter() - t_start, sample_fn.nfe

    if vae is not None:
        with torch.no_grad():
            img = decode_from_latent(vae, out.to(dtype))[0].float().cpu().numpy()
        pixels = np.clip((img + 1.0) / 2.0, 0.0, 1.0)
        out_path = os.path.join(args.image_save_path, "img2img.png")
        with open(out_path, "wb") as f:
            f.write(png_bytes((pixels.transpose(1, 2, 0) * 255).astype(np.uint8)))
    else:
        out_path = os.path.join(args.image_save_path, "img2img.npy")
        np.save(out_path, out.float().cpu().numpy())
    manifest["output"] = out_path
    with open(os.path.join(args.image_save_path, "data.json"), "w") as f:
        json.dump(manifest, f, indent=2, default=str)
    print(f"saved {out_path} ({manifest['seconds']:.2f}s, NFE {sample_fn.nfe})")
    return manifest


if __name__ == "__main__":
    main()

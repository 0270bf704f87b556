"""Region-controlled compositional generation (counterpart of
`lumina_t2x_tpu/pipelines/compositional_app.py`): N region captions and a
global caption through `NextDiT_2B_patch2_Compositional`.

    python -m lumina_t2x_tpu_torch.pipelines.compositional_app \
        --region_prompts "a red fox" "a snowy field" "a frozen lake" "a pine forest" \
        --global_prompt "a winter landscape" --h_split_num 1 --w_split_num 4 \
        --resolution 1024x1024 --num_sampling_steps 30 --vae_ckpt sd-vae-ft-ema.safetensors

The caption rows are the region captions and the negative caption; the
adaLN pools the global caption against the negative one. Their features
come from the LM of `--text_encoder` (a local directory), else they are the
hashed pseudo-features of each caption (`utils.hashed_caption_features`, 32
tokens of 2048, the stand-in the port uses wherever no LM is loaded). The
weights are the `ema` stream of `--ckpt` (a NextDiT-2B checkpoint loads
unchanged), or random from `--seed` (`--debug` ignores `--ckpt`). Noise is
drawn on the device from `--seed`. Writes `compositional.npy` (the latent),
`data.json` and, with `--vae_ckpt`, `compositional.png`. Runs in bf16 (fp32
under `--debug`, as in JAX) on `--device` (default cuda).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..codecs.vae import decode_from_latent, load_vae
from ..core.checkpoint import init_from
from ..models.compositional import NextDiT_2B_patch2_Compositional, forward_with_cfg
from ..transport import Sampler, create_transport
from ..utils import hashed_caption_features, png_bytes

NEGATIVE_CAP = (
    "blurry, worst quality, low quality, normal quality, lowres, monochrome, grayscale"
)
CAP_FEAT_DIM = 2048


def build_compositional_sample_fn(model, *, h_split_num: int, w_split_num: int,
                                  num_steps: int = 30, solver: str = "midpoint",
                                  cfg_scale: float = 4.0, time_shifting_factor=4.0):
    """Returns `sample_fn(z, cap_feats, cap_mask, global_cap_feats,
    global_cap_mask) -> latent`: z the (1, C, h, w) starting noise,
    duplicated into the CFG pair; cap_feats the region captions and the
    negative caption last; global_cap_* the global and the negative caption."""
    sampler = Sampler(create_transport("Linear", "velocity"))
    ode_fn = sampler.sample_ode(sampling_method=solver, num_steps=num_steps,
                                time_shifting_factor=time_shifting_factor)

    @torch.no_grad()
    def sample_fn(z, cap_feats, cap_mask, global_cap_feats, global_cap_mask):
        def model_fn(x, t):
            return forward_with_cfg(
                model, x, t, cap_feats, cap_mask, cfg_scale, global_cap_feats=global_cap_feats,
                global_cap_mask=global_cap_mask, h_split_num=h_split_num,
                w_split_num=w_split_num)

        out = ode_fn(torch.cat([z, z], dim=0), model_fn)
        sample_fn.nfe = ode_fn.nfe
        return out[:1]

    sample_fn.nfe = 0
    return sample_fn


def caption_features(captions, text_encoder=None, device=None):
    """(feats (N, L, D), mask (N, L) int32) of the captions: the text
    encoder's, else 32 hashed pseudo-feature tokens of 2048 each."""
    if text_encoder is not None:
        return text_encoder.encode(list(captions))
    feats = np.stack([hashed_caption_features(c, CAP_FEAT_DIM) for c in captions])
    return (torch.from_numpy(feats).to(device),
            torch.ones(feats.shape[:2], dtype=torch.int32, device=device))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="compositional generation (PyTorch)")
    p.add_argument("--region_prompts", type=str, nargs="+", required=True)
    p.add_argument("--global_prompt", type=str, required=True)
    p.add_argument("--h_split_num", type=int, default=1)
    p.add_argument("--w_split_num", type=int, default=4)
    p.add_argument("--resolution", type=str, default="1024x1024")
    p.add_argument("--num_sampling_steps", type=int, default=30)
    p.add_argument("--cfg_scale", type=float, default=4.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--image_save_path", type=str, default="compositional_out")
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--text_encoder", type=str, default=None,
                   help="local directory of the caption LM (Gemma-2B) and its tokenizer")
    p.add_argument("--vae_ckpt", type=str, default=None,
                   help="diffusers-format AutoencoderKL weights: decode the latent to a PNG")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--debug", action="store_true")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if len(args.region_prompts) != args.h_split_num * args.w_split_num:
        raise SystemExit(f"error: {len(args.region_prompts)} region prompts for a "
                         f"{args.h_split_num} x {args.w_split_num} grid")
    w, h = (int(v) for v in args.resolution.lower().split("x"))
    device = torch.device(args.device)
    dtype = torch.float32 if args.debug else torch.bfloat16

    encoder = None
    if args.text_encoder and not args.debug:
        from ..codecs.text_encoders import DecoderTextEncoder

        encoder = DecoderTextEncoder.from_pretrained(args.text_encoder, dtype=dtype,
                                                     device=device)
    cap_feats, cap_mask = caption_features(args.region_prompts + [NEGATIVE_CAP], encoder, device)
    gfeats, gmask = caption_features([args.global_prompt, NEGATIVE_CAP], encoder, device)

    torch.manual_seed(args.seed)
    model = NextDiT_2B_patch2_Compositional(cap_feat_dim=cap_feats.shape[-1], dtype=dtype,
                                            qk_norm=True, device=device).eval()
    if args.ckpt and not args.debug:
        init_from(args.ckpt, model, "ema")
    sample_fn = build_compositional_sample_fn(
        model, h_split_num=args.h_split_num, w_split_num=args.w_split_num,
        num_steps=args.num_sampling_steps, cfg_scale=args.cfg_scale)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    z = torch.randn((1, 4, h // 8, w // 8), generator=gen, device=device)
    t_start = time.perf_counter()
    out = sample_fn(z, cap_feats, cap_mask, gfeats, gmask)
    seconds = time.perf_counter() - t_start

    os.makedirs(args.image_save_path, exist_ok=True)
    path = os.path.join(args.image_save_path, "compositional.npy")
    np.save(path, out.float().cpu().numpy())
    manifest = {"args": vars(args), "output": path, "seconds": seconds, "nfe": sample_fn.nfe}
    if args.vae_ckpt:
        with torch.no_grad():
            img = decode_from_latent(load_vae(args.vae_ckpt, device=device), out.float())
        pixels = np.clip((img[0].float().cpu().numpy() + 1) / 2 * 255, 0, 255).astype(np.uint8)
        manifest["png"] = os.path.join(args.image_save_path, "compositional.png")
        with open(manifest["png"], "wb") as f:
            f.write(png_bytes(pixels.transpose(1, 2, 0)))
    with open(os.path.join(args.image_save_path, "data.json"), "w") as f:
        json.dump(manifest, f, indent=2, default=str)
    print(f"saved {path} ({seconds:.2f}s, NFE {sample_fn.nfe})")
    return manifest


if __name__ == "__main__":
    main()

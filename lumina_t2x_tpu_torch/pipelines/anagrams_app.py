"""Visual anagrams generation and animation (counterpart of
`lumina_t2x_tpu/pipelines/anagrams_app.py`): two-phase multi-view illusion
sampling with a base-resolution phase and a guided upscale phase, and GIF
morphs between two views.

    python -m lumina_t2x_tpu_torch.pipelines.anagrams_app \
        --prompts "a painting of a snowy mountain" "a painting of a horse" \
        --views identity rotate_180 --base_res 256 --resolution 1024 \
        --vae_ckpt sd-vae-ft-ema.safetensors [--kv_merge_ratio 2]

Caption features come from the LM of `--text_encoder` (a local directory),
else they are 32 x 2048 pseudo-features drawn from (seed, crc32 of the
caption) by an explicit generator. The weights are the `ema` stream of
`--ckpt`, or random from `--seed`. Phase 2 (when `--resolution` exceeds
`--base_res`) decodes the phase-1 latent, upsamples it bicubically (as
`jax.image.resize`), re-encodes it with the tiled VAE and runs the guided
loop; it calibrates the static bound of the streaming self-attention first
and passes it into its own model functions. Without `--vae_ckpt`, `--debug`
stands latent resampling in for the VAE; otherwise only phase 1 runs.
Writes one PNG per view (`view_<i>.png`, `view_<i>_hires.png`) under
`<save_dir>/<name>/<seed>` and `data.json`. Runs in bf16 (fp32 under
`--debug`) on `--device` (default cuda).
"""

from __future__ import annotations

import argparse
import json
import os
import time
import zlib
from typing import List, Optional

import numpy as np
import torch

from ..codecs.vae import (decode_from_latent, encode_to_latent, load_vae,
                          pooled_latent_standin)
from ..core.checkpoint import init_from
from ..models import get_model
from ..models.next_dit import forward_with_cfg
from ..ops.flash_attention import flash_static_max_scope
from ..transport.solvers import time_shift
from .anagrams import (anagram_init_phase, anagram_upscale_phase, get_anagrams_views,
                       image_resize, tiled_decode, tiled_encode)
from .sample_lib import autocalibrate_flash_static_max, resolution_scale_factor

NEGATIVE_CAP = (
    "blurry, worst quality, low quality, normal quality, lowres, monochrome, grayscale"
)
CAP_FEAT_DIM, CAP_TOKENS = 2048, 32


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="visual anagrams (PyTorch)")
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--model", type=str, default="NextDiT_2B_patch2")
    p.add_argument("--prompts", type=str, nargs="+", required=True)
    p.add_argument("--views", type=str, nargs="+", required=True)
    p.add_argument("--style", type=str, default="")
    p.add_argument("--save_dir", type=str, default="anagram_out")
    p.add_argument("--name", type=str, default="illusion")
    p.add_argument("--num_inference_steps", type=int, default=30)
    p.add_argument("--cfg_scale", type=float, default=4.0)
    p.add_argument("--time_shifting_factor", type=float, default=4.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--base_res", type=int, default=256)
    p.add_argument("--resolution", type=int, default=1024)
    p.add_argument("--proportional_attn", action="store_true")
    p.add_argument("--scaling_watershed", type=float, default=0.3)
    p.add_argument("--vae_ckpt", type=str, default=None,
                   help="diffusers VAE weights: decodes the saved outputs to pixels and "
                        "enables the phase-2 pixel-space upsample")
    p.add_argument("--text_encoder", type=str, default=None,
                   help="local directory of the caption LM; without it caption features "
                        "are pseudo-features drawn from (seed, crc32 of the caption)")
    p.add_argument("--train_res", type=int, default=1024,
                   help="the checkpoint's training resolution (RoPE scaling reference for "
                        "the phase-2 extrapolation)")
    p.add_argument("--kv_merge_ratio", type=int, default=1,
                   help="AvgPool K/V over the token grid (the kv_merge trick; 1 = off)")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--debug", action="store_true")
    return p.parse_args(argv)


def pseudo_caption_features(text: str, seed: int, device=None):
    """(CAP_TOKENS, CAP_FEAT_DIM) fp32 pseudo-features of a caption, drawn
    from a CPU generator seeded by (seed, crc32 of the caption): the same in
    every process."""
    crc = zlib.crc32(text.encode()) & 0x7FFFFFFF
    g = torch.Generator().manual_seed((int(seed) << 31) + crc)
    return torch.randn((CAP_TOKENS, CAP_FEAT_DIM), generator=g).to(device)


def generate_anagram(model, cap_feats_list, cap_mask_list, views, *, z, z2=None,
                     num_steps: int = 30, cfg_scale: float = 4.0,
                     time_shifting_factor: Optional[float] = 4.0,
                     vae_encode_fn=None, vae_decode_fn=None,
                     proportional_attn: bool = False, scale_watershed: float = 1.0,
                     kv_merge_ratio: int = 1, train_res: int = 1024, calibration_generator=None):
    """Two-phase illusion generation. z: the (1, 4, b, b) phase-1 noise; z2:
    the (1, 4, u, u) phase-2 noise (None: phase 1 only). Returns (phase-1
    latent, phase-2 latent or None, info) with the calibrated bound and each
    phase's seconds in info."""
    ts = torch.linspace(0.0, 1.0, num_steps, dtype=torch.float32)
    if time_shifting_factor:
        ts = time_shift(ts, time_shifting_factor)

    def make_fn(cap_feats, cap_mask, **extra):
        return lambda x, t: forward_with_cfg(model, x, t, cap_feats, cap_mask, cfg_scale, **extra)

    info = {"static_max": None}
    model_fns = [make_fn(cf, cm, kv_merge_ratio=kv_merge_ratio)
                 for cf, cm in zip(cap_feats_list, cap_mask_list)]
    sync = torch.cuda.synchronize if z.is_cuda else (lambda: None)
    t0 = time.perf_counter()
    with torch.no_grad(), flash_static_max_scope(None):
        phase1 = anagram_init_phase(model_fns, views, torch.cat([z, z], dim=0), ts)
    sync()
    info["phase1_seconds"] = time.perf_counter() - t0
    if z2 is None:
        return phase1[:1], None, info
    if vae_encode_fn is None or vae_decode_fn is None:
        raise ValueError("phase 2 needs vae_encode_fn and vae_decode_fn")

    # decode -> bicubic upsample -> tiled re-encode -> guided loop
    t0 = time.perf_counter()
    with torch.no_grad():
        img = vae_decode_fn(phase1[:1])
        h = w = z2.shape[-1] * 8
        img_up = image_resize(img, (1, 3, h, w), "bicubic")
        guidance = tiled_encode(vae_encode_fn, img_up)
    guidance = torch.cat([guidance, guidance], dim=0)
    # the bound of the long-sequence phase, probed with the first view's captions
    bound = autocalibrate_flash_static_max(
        model, cap_feats_list[0], cap_mask_list[0], width=w, height=h, cfg_scale=cfg_scale,
        time_shifting_factor=time_shifting_factor, scale_watershed=scale_watershed,
        proportional_attn=proportional_attn, attn_scale_variant="anagram",
        kv_merge_ratio=kv_merge_ratio, generator=calibration_generator)
    info["static_max"] = bound
    sync()
    info["reencode_calibrate_seconds"] = time.perf_counter() - t0
    # phase 2 at its own resolution: the time-aware RoPE scaling beyond train_res^2
    do_extrap = (h * w) > (train_res * train_res)
    extra_hi = dict(
        scale_factor=resolution_scale_factor(w, h, train_res) if do_extrap else 1.0,
        scale_watershed=scale_watershed if do_extrap else 1.0,
        proportional_attn=proportional_attn and do_extrap, base_seqlen=(train_res // 16) ** 2,
        attn_scale_variant="anagram", kv_merge_ratio=kv_merge_ratio)
    model_fns_hi = [make_fn(cf, cm, **extra_hi) for cf, cm in zip(cap_feats_list, cap_mask_list)]
    t0 = time.perf_counter()
    with torch.no_grad(), flash_static_max_scope(bound):
        phase2 = anagram_upscale_phase(model_fns_hi, views, torch.cat([z2, z2], dim=0),
                                       guidance, ts)
    sync()
    info["phase2_seconds"] = time.perf_counter() - t0
    return phase1[:1], phase2[:1], info


def _to_image(a, pixel: bool):
    from PIL import Image

    a = a[:3]
    if pixel:
        a = np.clip((a + 1.0) / 2.0, 0.0, 1.0)
    else:
        a = (a - a.min()) / (a.max() - a.min() + 1e-6)
    return Image.fromarray((a.transpose(1, 2, 0) * 255).astype(np.uint8))


def save_illusion(latents_or_img, views, sample_dir: str, tag: str = "",
                  pixel: bool = False) -> List[str]:
    """The base image under every view, one PNG each. pixel=True: decoded
    RGB in [-1, 1]; pixel=False: latents, saved as min-max channel
    previews."""
    os.makedirs(sample_dir, exist_ok=True)
    x = torch.as_tensor(latents_or_img).float().cpu()
    paths = []
    for i, view in enumerate(views):
        viewed = view.view(x[0]).numpy()
        path = os.path.join(sample_dir, f"view_{i}{tag}.png")
        _to_image(viewed, pixel).save(path)
        paths.append(path)
    return paths


def animate_two_view(img_a, img_b, save_path: str, num_frames: int = 30,
                     hold_frames: int = 10) -> str:
    """A GIF morph between two HWC images: hold A, crossfade to B, hold B,
    fade back (Pillow)."""
    from PIL import Image

    a = np.asarray(img_a, np.float32)
    b = np.asarray(img_b, np.float32)
    fade = lambda src, dst: [(1 - (i + 1) / num_frames) * src + (i + 1) / num_frames * dst
                             for i in range(num_frames)]
    frames = [a] * hold_frames + fade(a, b) + [b] * hold_frames + fade(b, a)
    pil = [Image.fromarray(np.clip(f, 0, 255).astype(np.uint8)) for f in frames]
    pil[0].save(save_path, save_all=True, append_images=pil[1:], duration=50, loop=0)
    return save_path


def _debug_vae():
    """Latent stand-ins for the VAE under --debug: nearest 8x upsampling of
    the first 3 channels, and an 8x average pool with channel 0 repeated."""

    def decode(z):
        return image_resize(z[:, :3], (z.shape[0], 3, z.shape[2] * 8, z.shape[3] * 8),
                            "nearest")

    return pooled_latent_standin, decode


def main(argv=None):
    args = parse_args(argv)
    if len(args.prompts) != len(args.views):
        raise SystemExit("error: the number of prompts must match the number of views")
    views = get_anagrams_views(args.views)
    device = torch.device(args.device)
    dtype = torch.float32 if args.debug else torch.bfloat16

    cap_feats_list, cap_mask_list = [], []
    if args.text_encoder:
        from ..codecs.text_encoders import DecoderTextEncoder

        enc = DecoderTextEncoder.from_pretrained(args.text_encoder, dtype=dtype, device=device)
        cap_feat_dim = enc.hidden_size
        for p in args.prompts:
            feats, mask = enc.encode([f"{args.style} {p}".strip(), NEGATIVE_CAP])
            cap_feats_list.append(feats)
            cap_mask_list.append(mask)
    else:
        cap_feat_dim = CAP_FEAT_DIM
        for p in args.prompts:
            text = f"{args.style} {p}".strip()
            cap_feats_list.append(torch.stack([pseudo_caption_features(t, args.seed, device)
                                               for t in (text, NEGATIVE_CAP)]))
            cap_mask_list.append(torch.ones((2, CAP_TOKENS), dtype=torch.int32, device=device))

    torch.manual_seed(args.seed)
    model = get_model(args.model, cap_feat_dim=cap_feat_dim, qk_norm=True, dtype=dtype,
                      device=device).eval()
    if args.ckpt:
        init_from(args.ckpt, model, "ema")

    upscale_latent = args.resolution // 8 if args.resolution > args.base_res else None
    vae_encode_fn = vae_decode_fn = None
    real_vae = bool(args.vae_ckpt)
    if real_vae:
        vae = load_vae(args.vae_ckpt, device=device)
        enc_gen = torch.Generator(device=device).manual_seed(0)
        vae_decode_fn = lambda z: decode_from_latent(vae, z.float())
        vae_encode_fn = lambda x: encode_to_latent(vae, x.float(), enc_gen)
    elif upscale_latent and args.debug:
        vae_encode_fn, vae_decode_fn = _debug_vae()
    elif upscale_latent:
        print("warning: --resolution > --base_res needs --vae_ckpt for the phase-2 upsample "
              "(or --debug for the stand-in flow); running phase 1 only")
        upscale_latent = None

    gen = torch.Generator(device=device).manual_seed(args.seed)
    base_latent = args.base_res // 8
    z = torch.randn((1, 4, base_latent, base_latent), generator=gen, device=device)
    z2 = (torch.randn((1, 4, upscale_latent, upscale_latent), generator=gen, device=device)
          if upscale_latent else None)
    phase1, phase2, info = generate_anagram(
        model, cap_feats_list, cap_mask_list, views, z=z, z2=z2,
        num_steps=args.num_inference_steps, cfg_scale=args.cfg_scale,
        time_shifting_factor=args.time_shifting_factor,
        proportional_attn=args.proportional_attn, scale_watershed=args.scaling_watershed, kv_merge_ratio=args.kv_merge_ratio,
        vae_encode_fn=vae_encode_fn, vae_decode_fn=vae_decode_fn, train_res=args.train_res,
        calibration_generator=torch.Generator(device=device).manual_seed(args.seed + 1))

    sample_dir = os.path.join(args.save_dir, args.name, f"{args.seed:04d}")
    latents = {"phase1": phase1, "phase2": phase2}
    if real_vae:  # decoded pixels; latent channel previews are the no-VAE fallback
        with torch.no_grad():
            phase1 = vae_decode_fn(phase1)
            if phase2 is not None:
                phase2 = tiled_decode(vae_decode_fn, phase2)
    paths = save_illusion(phase1, views, sample_dir, pixel=real_vae)
    if phase2 is not None:
        paths += save_illusion(phase2, views, sample_dir, tag="_hires", pixel=real_vae)
    manifest = {"args": vars(args), "paths": paths, **info}
    for key, value in latents.items():
        if value is not None:
            manifest[f"{key}_npy"] = os.path.join(sample_dir, f"{key}.npy")
            np.save(manifest[f"{key}_npy"], value.float().cpu().numpy())
    with open(os.path.join(sample_dir, "data.json"), "w") as f:
        json.dump(manifest, f, indent=2, default=str)
    print(f"saved {len(paths)} views to {sample_dir}")
    return manifest


if __name__ == "__main__":
    main()

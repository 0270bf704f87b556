"""Offline latent and caption-feature pre-encoder (counterpart of
`lumina_t2x_tpu/pipelines/encode_latents.py`).

    python -m lumina_t2x_tpu_torch.pipelines.encode_latents \
        --data_path configs/data/example.yaml --out latents_out \
        --vae_ckpt sd-vae-ft-ema.safetensors --text_encoder <gemma dir>

Computes the VAE latents and the frozen LM's caption features of a meta
dataset once, so that training can skip both encoders. The layout is the
JAX tool's:

  <out>/latents/<i>.npy     float32 (C, h, w)
  <out>/captions/<i>.npy    float32 (L, D): the caption's unpadded tokens
  <out>/index.json          i -> {caption, latent_shape}

Each image is cropped by `var_center_crop` into one of the top-4 buckets of
`--image_size` (Pillow), all draws from one `random.Random(--seed)` in the
JAX tool's order (bucket, crop origin, then the encoder's caption draw). The
VAE comes from `--vae_ckpt`, else it is initialised from seed 0; its
posterior noise for item i comes from (--seed, i). Without `--text_encoder`
the captions become hashed pseudo-features, as in JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import random

import numpy as np
import torch

from ..utils import hashed_caption_features


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="pre-encode latents and caption features")
    p.add_argument("--data_path", type=str, required=True, help="meta config (json or YAML)")
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--image_size", type=int, default=1024)
    p.add_argument("--vae", type=str, choices=["ema", "mse", "sdxl", "sd3"], default="ema")
    p.add_argument("--vae_ckpt", type=str, default=None)
    p.add_argument("--text_encoder", type=str, default=None,
                   help="local directory of the caption LM and its tokenizer")
    p.add_argument("--max_caption_len", type=int, default=256)
    p.add_argument("--limit", type=int, default=0, help="0 = all items")
    p.add_argument("--precision", choices=["fp32", "bf16"], default="bf16")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def posterior_noise(seed: int, index: int, shape, device) -> torch.Tensor:
    """The VAE posterior's standard-normal draw for item `index`."""
    gen = torch.Generator(device=device).manual_seed((int(seed) << 32) + int(index))
    return torch.randn(shape, generator=gen, device=device)


def main(argv=None):
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("error: --device cuda but torch.cuda.is_available() is false")
    os.makedirs(os.path.join(args.out, "latents"), exist_ok=True)
    os.makedirs(os.path.join(args.out, "captions"), exist_ok=True)
    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32

    from ..codecs.vae import latent_from_moments, load_or_init_vae
    from ..data.dataset import MetaDataset, T2IItemProcessor
    from ..data.imgproc import generate_crop_size_list, to_latent_input, var_center_crop

    rng = random.Random(args.seed)
    crop_list = generate_crop_size_list((args.image_size // 16) ** 2, 16)
    dataset = MetaDataset(args.data_path,
                          T2IItemProcessor(lambda im: var_center_crop(im, crop_list, rng)))
    vae = load_or_init_vae(args.vae_ckpt, device=device, dtype=dtype)
    text_encoder = None
    if args.text_encoder:
        from ..codecs.text_encoders import DecoderTextEncoder

        text_encoder = DecoderTextEncoder.from_pretrained(
            args.text_encoder, dtype=dtype, max_length=args.max_caption_len, device=device)

    index = {}
    n = len(dataset) if args.limit == 0 else min(args.limit, len(dataset))
    for i in range(n):
        img, caption = dataset[i]
        x = torch.from_numpy(to_latent_input(img)[None]).to(device)
        with torch.no_grad():
            moments = vae.encode_moments(x)
            shape = (1, moments.shape[1] // 2, *moments.shape[2:])
            z = latent_from_moments(moments, posterior_noise(args.seed, i, shape, device),
                                    args.vae)[0]
        z = z.float().cpu().numpy()
        np.save(os.path.join(args.out, "latents", f"{i}.npy"), z)
        if text_encoder is not None:
            feats, mask = text_encoder.encode([caption], rng=rng)
            feats = feats[0, : int(mask[0].sum())].float().cpu().numpy()
        else:
            feats = hashed_caption_features(caption, 2048)
        np.save(os.path.join(args.out, "captions", f"{i}.npy"), feats)
        index[str(i)] = {"caption": caption, "latent_shape": list(z.shape)}
        if (i + 1) % 100 == 0:
            print(f"encoded {i + 1}/{n}")

    with open(os.path.join(args.out, "index.json"), "w") as f:
        json.dump(index, f, indent=2)
    print(f"encoded {n} items -> {args.out}")
    return args.out


if __name__ == "__main__":
    main()

"""DreamBooth fine-tuning with prior preservation (counterpart of
`lumina_t2x_tpu/pipelines/dreambooth.py`).

    python -m lumina_t2x_tpu_torch.pipelines.dreambooth --instance_data_dir dog \
        --instance_prompt "a photo of sks dog" --with_prior_preservation \
        --class_data_dir dogs --class_prompt "a photo of a dog" [--model MMDiT_SD3_Medium]

loss = MSE(instance rows) + prior_loss_weight * MSE(class rows), the mini
linear-velocity loss (`transport/mini.training_losses_mini`), then a
global-norm clip, AdamW (`train_lib.AdamW`) and the `ema` stream (with
`--ema_decay 0` it tracks the weights), and a final `save_checkpoint`.

Two conditioning modes, keyed on the model family:
- NextDiT (default): (cap_feats, cap_mask) from `--text_encoder`, else the
  hashed pseudo-features of the prompt (`utils.hashed_caption_features`);
- MMDiT (`--model MMDiT_*`): (context, pooled) from the CLIP-L + CLIP-G
  (+ T5) triple encoder (`codecs/clip_text`), with SD3's convention bridged
  onto the mini loss: x_s = (1 - s) x1 + s x0 with target x0 - x1 at
  timestep s * 1000 is the mini loss at t = 1 - s with the prediction
  negated.

Images are centre-cropped to `--resolution` and encoded by `--vae_ckpt`, or
without one stood in for by an 8x average pool tiled to the latent width
(4, or SD3's 16). Image picks come from numpy's default_rng(seed) as in
JAX; a step's t and noise from (seed, step) (`train_lib.step_generator`),
or handed in (`draws`). Runs in bf16 activations (fp32 parameters) on
`--device` (default cuda).
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Iterator, List

import numpy as np
import torch

from ..core.checkpoint import init_from, save_checkpoint
from ..core.logging import create_logger
from ..models import get_model
from ..transport.mini import training_losses_mini
from ..utils import hashed_caption_features
from .train_lib import TrainState, create_optimizer, create_train_state, step_generator

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".webp")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="DreamBooth fine-tuning (PyTorch)")
    p.add_argument("--model", type=str, default="NextDiT_2B_patch2")
    p.add_argument("--pretrained_ckpt", type=str, default=None)
    p.add_argument("--instance_data_dir", type=str, required=True)
    p.add_argument("--class_data_dir", type=str, default=None)
    p.add_argument("--instance_prompt", type=str, required=True)
    p.add_argument("--class_prompt", type=str, default=None)
    p.add_argument("--with_prior_preservation", action="store_true")
    p.add_argument("--prior_loss_weight", type=float, default=1.0)
    p.add_argument("--output_dir", type=str, default="dreambooth_out")
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--train_batch_size", type=int, default=1)
    p.add_argument("--max_train_steps", type=int, default=500)
    p.add_argument("--learning_rate", type=float, default=1e-5)
    p.add_argument("--max_grad_norm", type=float, default=1.0,
                   help="global-norm gradient clip")
    p.add_argument("--ema_decay", type=float, default=0.0,
                   help="EMA decay of the saved 'ema' stream; 0 = the ema stream tracks the "
                        "fine-tuned weights")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cap_feat_dim", type=int, default=2048)
    p.add_argument("--text_encoder", type=str, default=None)
    p.add_argument("--clip_l", type=str, default=None,
                   help="SD3 mode: local HF dir of the CLIP-L tower")
    p.add_argument("--clip_g", type=str, default=None,
                   help="SD3 mode: local HF dir of the CLIP-G tower")
    p.add_argument("--t5", type=str, default=None,
                   help="SD3 mode: local HF dir of the T5 encoder (optional)")
    p.add_argument("--vae_ckpt", type=str, default=None)
    p.add_argument("--precision", choices=["fp32", "bf16"], default="bf16")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def _image_paths(directory: str) -> List[str]:
    return sorted(os.path.join(directory, f) for f in os.listdir(directory)
                  if f.lower().endswith(IMAGE_EXTS))


def image_latents(paths, resolution: int, vae=None, generator=None, latent_channels: int = 4,
                  device=None):
    """(N, C, r/8, r/8) fp32 latents of centre-cropped images: the VAE's
    sampled, scaled latent (noise from `generator`), else an 8x average pool
    tiled to `latent_channels`."""
    from PIL import Image

    from ..codecs.vae import encode_to_latent, pooled_latent_standin
    from ..data.imgproc import center_crop_arr, to_latent_input

    imgs = torch.from_numpy(np.stack([
        to_latent_input(center_crop_arr(Image.open(p).convert("RGB"), resolution))
        for p in paths])).to(device)
    if vae is None:
        return pooled_latent_standin(imgs, latent_channels)
    with torch.no_grad():
        return encode_to_latent(vae, imgs, generator).float()


def caption_features(prompt: str, n: int, cap_feat_dim: int, text_encoder=None, device=None):
    """(cap_feats, cap_mask) of one prompt repeated n times: the text
    encoder's, else its 32 hashed pseudo-feature tokens."""
    if text_encoder is not None:
        return text_encoder.encode([prompt] * n)
    feats = torch.from_numpy(hashed_caption_features(prompt, cap_feat_dim))[None].repeat(n, 1, 1)
    return feats.to(device), torch.ones(feats.shape[:2], dtype=torch.int32, device=device)


def dreambooth_batches(args, text_encoder=None, vae=None, sd3_encoder=None,
                       latent_channels: int = 4, device=None) -> Iterator[Dict]:
    """Endless batches: `train_batch_size` instance rows, then as many class
    rows under prior preservation, with their conditioning."""
    inst_paths = _image_paths(args.instance_data_dir)
    cls_paths = []
    if args.with_prior_preservation:
        # without class images the step would split instance rows in half and
        # mislabel them (or NaN at batch size 1), so this is an error
        if not args.class_data_dir:
            raise ValueError("--with_prior_preservation requires --class_data_dir")
        cls_paths = _image_paths(args.class_data_dir)
        if not cls_paths:
            raise ValueError(f"--class_data_dir {args.class_data_dir!r} contains no images")
    rng = np.random.default_rng(args.seed)
    b = args.train_batch_size

    def latents(paths):
        pick = rng.choice(len(paths), b)
        gen = torch.Generator(device=device).manual_seed(int(rng.integers(1 << 30)))
        return image_latents([paths[i] for i in pick], args.resolution, vae, gen,
                             latent_channels, device)

    def conditioning(prompt):
        if sd3_encoder is not None:
            context, pooled = sd3_encoder.encode([prompt] * b)
            return {"context": context, "pooled": pooled}
        feats, mask = caption_features(prompt, b, args.cap_feat_dim, text_encoder, device)
        return {"cap_feats": feats, "cap_mask": mask}

    while True:
        batch = {"x": latents(inst_paths), **conditioning(args.instance_prompt)}
        if cls_paths:  # instance rows, then class rows
            cls = {"x": latents(cls_paths), **conditioning(args.class_prompt or "")}
            batch = {k: torch.cat([batch[k], cls[k]]) for k in batch}
        yield batch


def make_dreambooth_step(model, optimizer, prior_loss_weight: float, with_prior: bool,
                         ema_decay: float = 0.0, grad_clip: float = 1.0, sd3: bool = False):
    """`step(state, batch, seed, draws=None) -> (state, metrics)`: the loss
    over the batch (instance and class halves weighted under prior
    preservation), the backward, the fp32 global grad norm, the clip at
    `grad_clip`, AdamW and the EMA. `draws`: (t, x0) replacing the step
    generator's."""
    params = dict(model.named_parameters())
    names, leaves = list(params), list(params.values())

    def model_fn(batch):
        if sd3:
            # SD3's convention onto the mini loss: timestep (1 - t) * 1000, prediction negated
            return lambda xt, t: -model(xt, (1.0 - t) * 1000.0, batch["context"],
                                        batch["pooled"])
        return lambda xt, t: model(xt, t, batch["cap_feats"], batch["cap_mask"])

    def step(state: TrainState, batch: Dict[str, torch.Tensor], seed: int, draws=None):
        t, x0 = draws if draws is not None else (None, None)
        generator = step_generator(seed, state.step, batch["x"].device)
        per_item = training_losses_mini(model_fn(batch), batch["x"], generator=generator,
                                        t=t, x0=x0)["loss"]
        aux = {}
        if with_prior:
            half = per_item.shape[0] // 2
            inst, prior = per_item[:half].mean(), per_item[half:].mean()
            loss = inst + prior_loss_weight * prior
            aux = {"instance_loss": float(inst.detach()), "prior_loss": float(prior.detach())}
        else:
            loss = per_item.mean()
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]
        gnorm = torch.sqrt(torch.stack([g.float().pow(2).sum() for g in grads]).sum())
        if grad_clip and grad_clip > 0:
            scale = torch.clamp(grad_clip / (gnorm + 1e-6), max=1.0)
        else:
            scale = torch.ones((), device=gnorm.device)
        optimizer.step(dict(zip(names, grads)), params, state.opt_state, state.ema, ema_decay,
                       scale)
        state.step += 1
        return state, {"loss": float(loss.detach()), "grad_norm": float(gnorm), **aux}

    return step


def main(argv=None):
    args = parse_args(argv)
    logger = create_logger(args.output_dir)
    device = torch.device(args.device)
    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32

    sd3 = args.model.startswith("MMDiT")
    text_encoder = sd3_encoder = None
    torch.manual_seed(args.seed)
    if sd3:
        from ..codecs.clip_text import build_sd3_prompt_encoder

        sd3_encoder = build_sd3_prompt_encoder(args.clip_l, args.clip_g, args.t5, device=device)
        if not (args.clip_l and args.clip_g):
            logger.warning("SD3 mode without --clip_l/--clip_g: prompts are encoded by random "
                           "debug towers")
        model = get_model(args.model, dtype=dtype, device=device)
    else:
        if args.text_encoder:
            from ..codecs.text_encoders import DecoderTextEncoder

            text_encoder = DecoderTextEncoder.from_pretrained(args.text_encoder, dtype=dtype,
                                                              device=device)
            args.cap_feat_dim = text_encoder.hidden_size
        model = get_model(args.model, cap_feat_dim=args.cap_feat_dim, dtype=dtype,
                          qk_norm=True, device=device)
    model.train()
    vae = None
    if args.vae_ckpt:
        from ..codecs.vae import load_vae

        vae = load_vae(args.vae_ckpt, device=device)
    batches = dreambooth_batches(args, text_encoder, vae, sd3_encoder,
                                 latent_channels=16 if sd3 else 4, device=device)
    batch = next(batches)
    if args.pretrained_ckpt:
        init_from(args.pretrained_ckpt, model, "ema")
        logger.info(f"loaded pretrained weights from {args.pretrained_ckpt}")
    optimizer = create_optimizer(args.learning_rate)
    state = create_train_state(model, optimizer)  # the EMA starts from the loaded weights
    step = make_dreambooth_step(model, optimizer, args.prior_loss_weight,
                                args.with_prior_preservation, ema_decay=args.ema_decay,
                                grad_clip=args.max_grad_norm, sd3=sd3)
    for i in range(args.max_train_steps):
        state, m = step(state, batch, args.seed)
        if (i + 1) % 50 == 0 or i == 0:
            logger.info(f"(step={i + 1:07d}) Train Loss: {m['loss']:.4f}")
        batch = next(batches)
    path = save_checkpoint(args.output_dir, state.step, state, model_args=vars(args))
    logger.info(f"saved to {path}")
    return state


if __name__ == "__main__":
    main()

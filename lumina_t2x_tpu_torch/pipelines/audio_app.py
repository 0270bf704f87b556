"""Audio / music generation app (counterpart of
`lumina_t2x_tpu/pipelines/audio_app.py`): the structured-caption utility
(`natural_to_structured`, a pluggable LLM hook with a deterministic
rule-based fallback), the `GenSamples` harness (CFM sample -> 1-D VAE decode
-> BigVGAN -> waveform), `save_wav`, the shared model start-up
(`build_audio_stack`), the serving worker (`AudioWorker`) and the CLI.

On the card by default (`--device cuda`); the tests pass `--device cpu`.
The app runs in fp32, as the JAX app does (it builds FlagDiT-1D with no
dtype). Without a text encoder a prompt's features are 16 pseudo tokens
seeded by the prompt (`utils.stable_text_seed`), the unconditional ones
zeros. The latent noise comes from a `torch.Generator` seeded by the
request's seed, so the port's samples are not the JAX app's.

    python -m lumina_t2x_tpu_torch.pipelines.audio_app --task audio \\
        --prompt "rain followed by thunder" --struct_caption --output_dir out \\
        --num_steps 3 --latent_length 32 --debug --device cpu
"""

from __future__ import annotations

import argparse
import os
import re
import threading
import time
import wave
from typing import Callable, Optional

import numpy as np
import torch


def natural_to_structured(caption: str, llm_fn: Optional[Callable[[str], str]] = None) -> str:
    """Natural caption -> `<event& time>@...` structured caption: `llm_fn`
    when given (the reference asks GPT-3.5), else split on temporal
    conjunctions with coarse time tags."""
    if llm_fn is not None:
        return llm_fn(caption)
    parts = re.split(r"\bfollowed by\b|\bthen\b|\bafter\b|,", caption.lower())
    parts = [p.strip(" .") for p in parts if p.strip(" .")]
    if not parts:
        return f"<{caption}& all>"
    if len(parts) == 1:
        return f"<{parts[0]}& all>"
    tags = ["start"] + ["mid"] * (len(parts) - 2) + ["end"]
    return "@".join(f"<{p}& {t}>" for p, t in zip(parts, tags))


def _numpy(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class GenSamples:
    """Generation harness: text features -> CFM latents -> mel -> waveform."""

    def __init__(self, denoiser_fn, vae_decode_fn, vocoder_fn=None, *,
                 latent_channels: int = 20, latent_length: int = 256,
                 guidance_scale: float = 3.0, num_steps: int = 25,
                 scale_factor: float = 1.0):
        self.denoiser_fn = denoiser_fn
        self.vae_decode_fn = vae_decode_fn
        self.vocoder_fn = vocoder_fn
        self.latent_shape = (1, latent_channels, latent_length)
        self.guidance_scale = guidance_scale
        self.num_steps = num_steps
        self.scale_factor = scale_factor

    @torch.no_grad()
    def gen_test_sample(self, noise, cond, uncond):
        """`noise`: the starting latent or a generator on cond's device.
        Returns (mel, waveform or None) as numpy arrays."""
        from .audio import generate_audio

        mel, wav = generate_audio(
            noise, self.denoiser_fn, self.vae_decode_fn, self.vocoder_fn,
            cond=cond, uncond=uncond, latent_shape=self.latent_shape,
            guidance_scale=self.guidance_scale, num_steps=self.num_steps,
            scale_factor=self.scale_factor)
        return _numpy(mel), (_numpy(wav) if wav is not None else None)


def save_wav(waveform: np.ndarray, path, sample_rate: int = 16000):
    """Write mono 16-bit PCM to a path or a binary file object."""
    wav16 = (np.clip(waveform, -1.0, 1.0) * 32767).astype(np.int16)
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(wav16.tobytes())
    return path


def _pseudo_features(prompt: str, ctx_dim: int, device, tokens: int = 16):
    """(1, tokens, ctx_dim) pseudo text features seeded by the prompt, and
    zeros for the unconditional row."""
    from ..utils import stable_text_seed

    cond = np.random.default_rng(stable_text_seed(prompt)).standard_normal(
        (1, tokens, ctx_dim)).astype(np.float32)
    return (torch.from_numpy(cond).to(device),
            torch.zeros(1, tokens, ctx_dim, device=device))


def build_audio_gradio_ui(gen: GenSamples, *, task: str = "music", sample_rate: int = 16000,
                          struct_captions: bool = False, text_encode_fn=None,
                          ctx_dim: int = 1024, device="cuda"):
    """Gradio UI for audio / music generation (the audio task adds a
    structured-caption input). Raises ImportError without gradio."""
    import gradio as gr

    def encode(prompt):
        if text_encode_fn is not None:
            return text_encode_fn([prompt]), text_encode_fn([""])
        return _pseudo_features(prompt, ctx_dim, device)

    def on_submit(prompt, use_struct, guidance, steps, seed):
        text = natural_to_structured(prompt) if (use_struct and task == "audio") else prompt
        cond, uncond = encode(text)
        gen.guidance_scale = float(guidance)
        gen.num_steps = int(steps)
        generator = torch.Generator(device=cond.device).manual_seed(int(seed))
        _, wav = gen.gen_test_sample(generator, cond, uncond)
        if wav is None:
            return None, text
        return (sample_rate, wav[0]), text

    with gr.Blocks() as demo:
        gr.Markdown(f"# Lumina Text-to-{task.capitalize()}")
        prompt = gr.Textbox(label="Prompt")
        use_struct = gr.Checkbox(value=struct_captions, label="Structured caption (audio)")
        guidance = gr.Slider(1.0, 10.0, value=3.0, label="Guidance scale")
        steps = gr.Slider(5, 100, value=25, step=1, label="Sampling steps")
        seed = gr.Number(value=0, label="Seed", precision=0)
        submit = gr.Button("Generate")
        audio_out = gr.Audio(label="Result")
        caption_out = gr.Textbox(label="Effective caption")
        submit.click(on_submit, [prompt, use_struct, guidance, steps, seed],
                     [audio_out, caption_out])
    return demo


def build_audio_stack(*, debug: bool = False, vae_ckpt: Optional[str] = None,
                      vocoder_ckpt: Optional[str] = None, seed: int = 0, ctx_dim: int = 1024,
                      device="cuda"):
    """(denoiser_fn, vae_decode_fn, vocoder_fn): the model start-up shared by
    the CLI, the gradio UI and the HTTP server. Random weights from `seed`
    unless checkpoints are given. The denoiser is the FlagDiT-1D module
    itself (fp32; 1152 wide, 28 layers, 16 heads; `debug`: 64 wide, 2
    layers, 4 heads), `vae_decode_fn` the 1-D VAE's bound `decode` (random:
    ch 128 (32 under `debug`), ch_mult (1, 2), 1 resnet; `vae_ckpt`: the
    Make-An-Audio-2 VAE) and `vocoder_fn` the bound `VocoderBigVGAN.vocode`
    (1536 wide; `debug`: 32 wide, rates (2, 2)). The modules take any latent
    length (the JAX stack's `latent_length` only sets its tracing shape)."""
    from ..codecs.vae1d import (AutoencoderKL1D, import_autoencoder_kl_1d_weights,
                                make_an_audio_2_vae)
    from ..codecs.vocoder import VocoderBigVGAN
    from ..core.checkpoint import load_torch_state_dict
    from ..models.flag_dit_1d import FlagDiT1D

    device = torch.device(device)
    hidden, depth = (64, 2) if debug else (1152, 28)
    torch.manual_seed(seed)
    model = FlagDiT1D(in_channels=20, context_dim=ctx_dim, hidden_size=hidden, depth=depth,
                      num_heads=4 if debug else 16, multiple_of=16, device=device).eval()
    model.requires_grad_(False)

    if vae_ckpt:
        vae = make_an_audio_2_vae()
        vae.load_state_dict(import_autoencoder_kl_1d_weights(load_torch_state_dict(vae_ckpt)),
                            strict=True)
    else:
        torch.manual_seed(seed + 1)
        vae = AutoencoderKL1D(mel_bins=80, embed_dim=20, ch=32 if debug else 128,
                              ch_mult=(1, 2), num_res_blocks=1, z_channels=20)
    vae = vae.to(device).eval().requires_grad_(False)

    if vocoder_ckpt:
        voc = VocoderBigVGAN.from_torch_checkpoint(vocoder_ckpt, mel_bins=80, device=device)
    else:
        voc = VocoderBigVGAN.create(
            seed + 2, mel_bins=80, device=device,
            **({"upsample_rates": (2, 2), "upsample_kernel_sizes": (4, 4),
                "upsample_initial_channel": 32, "resblock_kernel_sizes": (3,),
                "resblock_dilation_sizes": ((1, 3),)} if debug else {}))
    return model, vae.decode, voc.vocode


class AudioWorker:
    """Serving-side generation worker: prompt -> (mel, wav). One generation
    owns the card at a time (the image worker's serialization contract)."""

    def __init__(self, denoiser_fn, vae_decode_fn, vocoder_fn, *, task: str = "music",
                 ctx_dim: int = 1024, latent_length: int = 128, sample_rate: int = 16000,
                 scale_factor: float = 1.0, text_encode_fn=None, llm_fn=None, device="cuda"):
        self.task = task
        self.ctx_dim = ctx_dim
        self.latent_length = latent_length
        self.sample_rate = sample_rate
        self.scale_factor = scale_factor
        self.text_encode_fn = text_encode_fn
        self.llm_fn = llm_fn
        self.device = torch.device(device)
        self._fns = (denoiser_fn, vae_decode_fn, vocoder_fn)
        self._lock = threading.Lock()

    def _encode(self, prompt: str):
        if self.text_encode_fn is not None:
            # CFG uncond = the empty prompt's features (the reference's)
            feats, _ = self.text_encode_fn([prompt, ""])
            feats = torch.as_tensor(feats, device=self.device).float()
            return feats[:1], feats[1:]
        return _pseudo_features(prompt, self.ctx_dim, self.device)

    def generate(self, prompt: str, *, use_struct: bool = False, guidance_scale: float = 3.0,
                 num_steps: int = 25, seed: int = 0):
        with self._lock:
            t0 = time.time()
            if use_struct and self.task == "audio":
                prompt = natural_to_structured(prompt, self.llm_fn)
            cond, uncond = self._encode(prompt)
            gen = GenSamples(*self._fns, latent_length=self.latent_length,
                             guidance_scale=guidance_scale, num_steps=num_steps,
                             scale_factor=self.scale_factor)
            generator = torch.Generator(device=self.device).manual_seed(seed)
            mel, wav = gen.gen_test_sample(generator, cond, uncond)
            return {"mel": mel, "wav": wav, "sample_rate": self.sample_rate,
                    "metadata": {"prompt": prompt, "task": self.task,
                                 "guidance_scale": guidance_scale, "num_steps": num_steps,
                                 "seed": seed, "elapsed_s": round(time.time() - t0, 3)}}


def main(argv=None):
    p = argparse.ArgumentParser(description="lumina audio/music generation")
    p.add_argument("--task", choices=["music", "audio"], default="music")
    p.add_argument("--prompt", type=str, required=True)
    p.add_argument("--output_dir", type=str, default="audio_out")
    p.add_argument("--guidance_scale", type=float, default=3.0)
    p.add_argument("--num_steps", type=int, default=25)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--latent_length", type=int, default=256)
    p.add_argument("--struct_caption", action="store_true",
                   help="audio task: convert prompt to structured caption")
    p.add_argument("--debug", action="store_true", help="random weights")
    p.add_argument("--vae_ckpt", type=str, default=None,
                   help="Make-An-Audio-2 mel-VAE torch checkpoint (maa2.ckpt, "
                        "lumina-text2music.yaml:48); loads real weights via "
                        "import_autoencoder_kl_1d_weights")
    p.add_argument("--vocoder_ckpt", type=str, default=None,
                   help="BigVGAN best_netG.pt; loads real weights via import_bigvgan_weights")
    p.add_argument("--latent_scale_factor", type=float, default=1.0,
                   help="LDM latent scale (the trained checkpoint's scale_factor buffer; "
                        "configs use scale_by_std so it is not 1): decode divides latents "
                        "by it")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("error: --device cuda but torch.cuda.is_available() is false")

    denoiser_fn, vae_decode, vocode = build_audio_stack(
        debug=args.debug, vae_ckpt=args.vae_ckpt, vocoder_ckpt=args.vocoder_ckpt,
        seed=args.seed, device=args.device)
    worker = AudioWorker(denoiser_fn, vae_decode, vocode, task=args.task,
                         latent_length=args.latent_length // 2,
                         scale_factor=args.latent_scale_factor, device=args.device)
    result = worker.generate(args.prompt, use_struct=args.struct_caption,
                             guidance_scale=args.guidance_scale, num_steps=args.num_steps,
                             seed=args.seed)
    if args.struct_caption and args.task == "audio":
        print(f"structured caption: {result['metadata']['prompt']}")
    os.makedirs(args.output_dir, exist_ok=True)
    out = os.path.join(args.output_dir, "sample.wav")
    save_wav(result["wav"][0], out)
    print(f"mel {result['mel'].shape} -> {out}")
    return out


if __name__ == "__main__":
    main()

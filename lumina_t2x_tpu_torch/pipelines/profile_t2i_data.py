"""Where a 2B train step on image-caption data spends its time, on one NVIDIA GPU.

    python -m lumina_t2x_tpu_torch.pipelines.profile_t2i_data [--steps 8] \
        [--gemma build/gemma_2b_random]

1. The caption encoder alone: Gemma-2B at its published widths (random bf16
   weights from seed 0 and the port's in-memory character tokenizer, saved
   to `--gemma` unless that directory holds them already) encodes 2
   captions a call, as a batch of 2 does in the trainer. For each of several
   caption lengths it times, synchronised on the host clock, the first call
   at that length and a second one at the same length: whether a call at a
   length not seen before pays a first-call cost.
2. The trainer CLI (`pipelines.train.main`) on a block-YAML meta dataset of
   16 PNGs (1024x1024 and 1536x768) at `--image_size 1024`: NextDiT_2B_patch2,
   qk-norm, bf16 Adafactor, B=2, dots remat, calibrated train bound, the
   Gemma of part 1 and a VAE from seed 0 in the loop, `--steps` steps. It
   prints each step's seconds, data wait, caption encode and VAE encode
   (the trainer's metrics.jsonl) and their means over the steps after the
   first, with the peak device memory. The trainer's final checkpoint is
   not written: it is not step time.

Needs a CUDA device, ~25 GiB of its memory and 5 GB of disk for the Gemma.
"""

import argparse
import json
import os
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch

GEMMA_2B = dict(vocab_size=256000, hidden_size=2048, intermediate_size=16384,
                num_hidden_layers=18, num_attention_heads=8, num_key_value_heads=1, head_dim=256,
                max_position_embeddings=8192)
# caption lengths in tokens (<bos> and the characters), each a new padded length
LENGTHS = (12, 40, 72, 136, 200, 256)
WORDS = "a photograph of a quiet harbour at dusk with boats and gulls over the water "


def make_gemma(path: str):
    """Gemma-2B's widths, random bf16 from seed 0, and the character
    tokenizer, saved to `path`."""
    from transformers import GemmaConfig, GemmaModel

    from lumina_t2x_tpu_torch.codecs.text_encoders import char_tokenizer

    torch.manual_seed(0)
    default_dtype = torch.get_default_dtype()
    torch.set_default_dtype(torch.bfloat16)
    try:
        with torch.device("cuda"):
            model = GemmaModel(GemmaConfig(**GEMMA_2B))
    finally:
        torch.set_default_dtype(default_dtype)
    model.save_pretrained(path)
    char_tokenizer().save_pretrained(path)
    del model
    torch.cuda.empty_cache()


def encoder_sweep(path: str):
    from lumina_t2x_tpu_torch.codecs.text_encoders import DecoderTextEncoder

    enc = DecoderTextEncoder.from_pretrained(path, dtype=torch.bfloat16, max_length=256,
                                             device="cuda")

    def timed(captions):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats, _ = enc.encode(captions)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0), feats.shape[1]

    first_ever, _ = timed(["warm-up caption", ""])
    print(f"encoder: the process's first call {first_ever:.2f} ms (2 captions, 16 tokens)")
    for n in LENGTHS:
        caption = (WORDS * 4)[:n - 1]
        first, padded = timed([caption, caption[: n // 2]])
        second, _ = timed([caption[::-1], caption[: n // 2][::-1]])
        print(f"encoder: {n} tokens (padded {padded}): first call at the length {first:.2f} ms, "
              f"second {second:.2f} ms")
    del enc
    torch.cuda.empty_cache()


def _image(w, h, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255.0 / w, yy * 255.0 / h, np.full((h, w), 15.0 * seed)], -1)
    return np.clip(base + rng.normal(0, 8, base.shape), 0, 255).astype(np.uint8)


def trainer_steps(path: str, steps: int):
    from lumina_t2x_tpu_torch.pipelines import train as train_cli
    from lumina_t2x_tpu_torch.utils import png_bytes

    sizes = [(1024, 1024), (1536, 768)] * 8
    with tempfile.TemporaryDirectory() as tmp:
        rows = []
        for i, (w, h) in enumerate(sizes):
            with open(os.path.join(tmp, f"{i}.png"), "wb") as f:
                f.write(png_bytes(_image(w, h, i)))
            rows.append({"path": f"{i}.png", "caption": (WORDS * 4)[: 8 + 15 * i]})
        with open(os.path.join(tmp, "ann.json"), "w") as f:
            json.dump(rows, f)
        cfg = os.path.join(tmp, "data.yaml")
        with open(cfg, "w") as f:
            f.write(f"META:\n  - path: {tmp}/ann.json\n    type: default\n    root: {tmp}\n")
        results = os.path.join(tmp, "results")
        train_cli.save_checkpoint = lambda *a, **k: "(not written)"
        torch.cuda.reset_peak_memory_stats()
        train_cli.main(
            ["--model", "NextDiT_2B_patch2", "--data_path", cfg, "--image_size", "1024",
             "--global_batch_size", "2", "--precision", "bf16", "--qk_norm", "--checkpointing",
             "--flash_static_max", "auto", "--optimizer", "adafactor", "--param_dtype", "bf16",
             "--text_encoder", path, "--num_workers", "4", "--results_dir", results,
             "--max_steps", str(steps), "--log_every", "1", "--ckpt_every", "100000",
             "--device", "cuda"])
        with open(os.path.join(results, "NextDiT_2B_patch2", "metrics.jsonl")) as f:
            metrics = [json.loads(line) for line in f]
    keys = ("secs_per_step", "data_wait_ms", "text_encode_ms", "vae_encode_ms")
    for m in metrics:
        print(f"trainer step {m['step']}: " + ", ".join(f"{k} {m['train/' + k]:.4f}" for k in keys)
              + f", bucket {int(m['train/bucket_w'])}x{int(m['train/bucket_h'])}")
    print("trainer steps 2-: " + ", ".join(
        f"{k} mean {statistics.mean(m['train/' + k] for m in metrics[1:]):.4f}" for k in keys)
        + f"; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--gemma", default=os.path.join("build", "gemma_2b_random"))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_t2i_data needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    if not os.path.exists(os.path.join(args.gemma, "config.json")):
        make_gemma(args.gemma)
    encoder_sweep(args.gemma)
    trainer_steps(args.gemma, args.steps)


if __name__ == "__main__":
    main()

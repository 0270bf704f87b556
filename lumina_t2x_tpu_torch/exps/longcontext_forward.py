"""The full NextDiT-2B forward at 128K image tokens on one card (counterpart
of the repository's `exps/longcontext_forward.py`).

The whole model runs at S = gh * gw = 512 * 256 = 131072 image tokens (a
1024 x 512 latent, an 8192 x 4096 px image) beside a 256-token caption:
patchify, the RoPE grid, the 24 blocks with flash attention, the final adaLN
and unpatchify, in bf16 parameters and activations, batch 1, weights
initialised once from `--seed`. Under `LUMINA_FUSE_ROPE=1` the
self-attention runs the fused-RoPE kernel over all 131072 keys and the
cross-attention its rotate-q variant over the caption (K9); else `apply_rope`
and the streaming and small-KV kernels (K2, K1), as in the JAX script,
which follows the same variable.

    python -m lumina_t2x_tpu_torch.exps.longcontext_forward [--tokens 131072] [--steps 3]

One warm forward, then `--steps` timed ones (host clock around each, ending
in a synchronize); prints one JSON line: tokens, grid, latent, ms a forward
(the fastest), tokens/s, the peak of `torch.cuda.max_memory_allocated`, and
whether the output is finite. `--device cpu` runs it on the CPU (for a tiny
`--tokens` and a small model).
"""

from __future__ import annotations

import argparse
import json
import math
import time
from typing import Dict

import torch

CAP_FEAT_DIM = 2048


def grid_for_tokens(tokens: int):
    """(gh, gw) with gh * gw == tokens, as square as powers of two allow."""
    lg = int(math.log2(tokens))
    if 2 ** lg != tokens:
        raise ValueError(f"--tokens must be a power of two, not {tokens}")
    gh = 2 ** ((lg + 1) // 2)
    return gh, tokens // gh


def build_model(name: str = "NextDiT_2B_patch2", device="cuda", seed: int = 0, **kwargs):
    """The registry model with qk-norm and 2048-wide captions, bf16
    parameters and activations unless `kwargs` say otherwise, initialised
    from `seed`."""
    from ..models import get_model

    kw = dict(cap_feat_dim=CAP_FEAT_DIM, qk_norm=True, dtype=torch.bfloat16,
              param_dtype=torch.bfloat16, device=device)
    kw.update(kwargs)
    torch.manual_seed(seed)
    return get_model(name, **kw).eval()


def forward_stats(model, tokens: int = 131072, cap_len: int = 256, steps: int = 3,
                  seed: int = 0) -> Dict:
    """One warm forward and `steps` timed ones of `model` at `tokens` image
    tokens (latent and caption features drawn from `seed`, t = 0.5); the
    JSON record the script prints."""
    device = next(model.parameters()).device
    cuda = device.type == "cuda"
    gh, gw = grid_for_tokens(tokens)
    p = model.patch_size
    g = torch.Generator(device=device).manual_seed(seed + 2)
    x = torch.randn((1, model.in_channels, gh * p, gw * p), generator=g, device=device)
    cap = torch.randn((1, cap_len, model.cap_feat_dim), generator=g, device=device)
    t = torch.full((1,), 0.5, device=device)
    mask = torch.ones((1, cap_len), dtype=torch.int32, device=device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    times = []
    with torch.no_grad():
        out = model(x, t, cap, mask)
        finite = bool(torch.isfinite(out).all())
        del out
        for _ in range(steps):
            if cuda:
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            out = model(x, t, cap, mask)
            if cuda:
                torch.cuda.synchronize(device)
            times.append(time.perf_counter() - t0)
            finite = finite and bool(torch.isfinite(out).all())
            del out
    best = min(times) if times else float("nan")
    return {"tokens": tokens, "grid": [gh, gw],
            "latent": [gh * model.patch_size, gw * model.patch_size], "cap_len": cap_len,
            "params_m": sum(q.numel() for q in model.parameters()) / 1e6,
            "ms_per_forward": 1e3 * best, "ms_all": [1e3 * s for s in times],
            "tokens_per_sec": tokens / best if times else None,
            "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30 if cuda else None,
            "device": torch.cuda.get_device_name(device) if cuda else "cpu",
            "finite": finite}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="NextDiT_2B_patch2")
    p.add_argument("--tokens", type=int, default=131072)
    p.add_argument("--cap_len", type=int, default=256)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("error: --device cuda but torch.cuda.is_available() is false")
    model = build_model(args.model, device=args.device, seed=args.seed)
    stats = {"model": args.model,
             **forward_stats(model, args.tokens, args.cap_len, args.steps, args.seed)}
    print(json.dumps(stats))
    return stats


if __name__ == "__main__":
    main()

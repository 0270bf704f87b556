"""The Hopper attention kernels' fp16 instantiations against their bf16 ones on the card.

    python -m lumina_t2x_tpu_torch.exps.fp16_times [--rounds 3] [--reps 15]

At the 2B's (2, 4096, 32, 72), every key valid, K3/K5 under the bound max
LSE + 8 (the trainer's margin): K2 (`flash_online`), K3 (`flash_static_max`),
K4 (`flash_online_lse`), K5 (`flash_static_max_lse`), K6 (`flash_bwd_fused`),
K7 (`flash_bwd_dq`) and K8 (`flash_bwd_dkv`), and the backward wrapper's two
reductions, delta = rowsum(dO * O) (`bwd_delta`, a kernel) and fp16's max|dO|
(`_do_amax`, timed on either dtype's dO). Each is the median of `--reps`
calls (CUDA events around the wrapper), bf16 and fp16 taking turns, the
first dtype alternating from round to round, so that both see the same
card in the same call. Inputs are N(0, 1) from seed 0, cast to each dtype;
out and the LSE come from the LSE forward kernel. Prints the card's name and
power limit, one line a (kernel, dtype) with each round's ms, and as the
last line a JSON object of them. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from . import time_ms

SHAPE = (2, 4096, 32, 72)  # the 2B's (B, S, H, D)
MARGIN = 8.0  # the trainer's static-max margin over the largest row LSE


def _calls(fa, q, k, v, out, lse, dout, bound):
    scale = q.shape[-1] ** -0.5
    args = (q, k, v, None, out, lse, dout, scale)
    return {"K2": lambda: fa.flash_online(q, k, v, None, scale),
            "K3": lambda: fa.flash_static_max(q, k, v, None, scale, bound=bound),
            "K4": lambda: fa.flash_online_lse(q, k, v, None, scale),
            "K5": lambda: fa.flash_static_max_lse(q, k, v, None, scale, bound=bound),
            "K6": lambda: fa.flash_bwd_fused(*args),
            "K7": lambda: fa.flash_bwd_dq(*args),
            "K8": lambda: fa.flash_bwd_dkv(*args),
            "delta": lambda: fa.bwd_delta(out, dout),
            "max|dO|": lambda: fa._do_amax(dout)}


def main(argv=None):
    if not torch.cuda.is_available():
        raise SystemExit("fp16_times times the kernels on the card: it needs a CUDA device")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=15)
    args = ap.parse_args(argv)
    from ..ops import cuda_lib
    from ..ops import flash_attention as fa

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    cuda_lib.build_library(fa.LIBRARY)
    g = torch.Generator(device="cuda").manual_seed(0)
    base = [torch.randn(*SHAPE, generator=g, device="cuda") for _ in range(4)]
    calls = {}
    for dtype in (torch.bfloat16, torch.float16):
        q, k, v, dout = (t.to(dtype) for t in base)
        out, lse = fa.flash_online_lse(q, k, v, None, SHAPE[-1] ** -0.5)
        calls[dtype] = _calls(fa, q, k, v, out, lse, dout, float(lse.max()) + MARGIN)
    rows = {}
    for rnd in range(args.rounds):
        order = (torch.bfloat16, torch.float16) if rnd % 2 == 0 else (torch.float16, torch.bfloat16)
        for dtype in order:
            for name, fn in calls[dtype].items():
                rows.setdefault(f"{name} {fa._DTYPE_TAGS[dtype]}", []).append(
                    time_ms(fn, "cuda", args.reps))
    for key, times in rows.items():
        print(f"{key}: " + " ".join(f"{t:.4f}" for t in times) + " ms", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "shape": SHAPE, "ms": rows}))


if __name__ == "__main__":
    main()

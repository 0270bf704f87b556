"""Times of the bf16 attention backward (K6, K7, K8) at head_dim 48, 72 and 96 on the card.

    python lumina_t2x_tpu_torch/exps/bwd_head_dim_times.py [--root DIR] [--label NAME]
        [--reps N] [--shapes NAME ...]

Shapes (B, S, H, D), bf16, every key valid, Sq = Sk:
  600m  (256, 256, 32, 48)  NextDiT-ImageNet 600M's training self-attention at 256^2
  small (64, 1024, 8, 48)   NextDiT-ImageNet Small in pixel space at 64^2
  5b    (2, 4160, 32, 96)   Flag-DiT 5B's at 1024^2 (64 x 65 tokens with the [eol] column)
  2b    (2, 4096, 32, 72)   NextDiT-2B's at 1024^2, the control (its 80/72 instantiation)
For each shape and each of `flash_bwd_fused` (K6), `flash_bwd_dq` (K7) and
`flash_bwd_dkv` (K8): the wrapper's ms by CUDA events (median of `--reps`
single calls) and its device time a call under `torch.profiler`, split into
the backward kernel (`flash_bwd*` kernels), delta = rowsum(dO * O) (the
tree's `bwd_delta`, or its eager `_bwd_delta` where it has no kernel), the
fused sweep's fp32 dQ zero and its cast to bf16, each of the last three
profiled alone, and what is left ("other"); beside them the sdpa backward
(`torch.autograd.grad` through `scaled_dot_product_attention`, aten's flash
backward with its own delta) on the same inputs. out and the LSE come from
the tree's `flash_online_lse`.

Inputs are N(0, 1) from seed 0. `--root` names the checkout whose port is
timed (default: the one holding this script). Run as a file, so that
another commit's tree, unpacked with `git archive` under a directory that
`.gitignore` lists, is timed by the same code in the same call: parent,
change, change, parent. The kernels are built into that tree's
`build/kernels/`. The first line is the card's name and power limit; the
last line is a JSON object of the rows. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

SHAPES = {"600m": (256, 256, 32, 48), "small": (64, 1024, 8, 48), "5b": (2, 4160, 32, 96),
          "2b": (2, 4096, 32, 72)}
BACKWARD = ("bwd_fused", "bwd_dq", "bwd_dkv")


def _events_ms(torch, fn, reps):
    """Median ms of one call by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def _device_ms(torch, fn, calls, pattern=""):
    """Device ms a call of the CUDA kernels whose names hold `pattern` (all
    kernels by default) under torch.profiler; None when the trace has none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and pattern in e.key)
    return total / 1000 / calls if total > 0 else None


def _sdpa_backward(torch, q, k, v, dout, scale):
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = torch.nn.functional.scaled_dot_product_attention(
        *(t.transpose(1, 2) for t in leaves), scale=scale)
    grad_out = dout.transpose(1, 2)
    return lambda: torch.autograd.grad(out, leaves, grad_out, retain_graph=True)


def _fmt(x):
    return "not traced" if x is None else f"{x:.4f}"


def shape_rows(torch, fa, name, reps, label):
    b, s, h, d = SHAPES[name]
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, dout = (torch.randn(b, s, h, d, generator=g, device="cuda").to(torch.bfloat16)
                     for _ in range(4))
    scale = d ** -0.5
    out, lse = fa.flash_online_lse(q, k, v, None, scale)
    args = (q, k, v, None, out, lse, dout, scale)
    delta_fn = getattr(fa, "bwd_delta", None) or fa._bwd_delta
    calls = 5
    parts = {"delta": _device_ms(torch, lambda: delta_fn(out, dout), calls),
             "dq_zero": _device_ms(torch, lambda: torch.zeros(q.shape, dtype=torch.float32,
                                                              device="cuda"), calls)}
    dq32 = torch.zeros(q.shape, dtype=torch.float32, device="cuda")
    parts["dq_cast"] = _device_ms(torch, lambda: dq32.to(torch.bfloat16), calls)
    del dq32
    row = {"shape": [b, s, h, d], "delta_kernel": hasattr(fa, "bwd_delta")}
    for entry in BACKWARD:
        fn = getattr(fa, f"flash_{entry}")
        call = lambda: fn(*args)  # noqa: E731
        total = _device_ms(torch, call, calls)
        kernel = _device_ms(torch, call, calls, "flash_bwd")
        split = {"kernel": kernel, "delta": parts["delta"]}
        if entry == "bwd_fused":
            split.update(dq_zero=parts["dq_zero"], dq_cast=parts["dq_cast"])
        known = [x for x in split.values() if x is not None]
        split["other"] = (total - sum(known)) if total is not None else None
        row[entry] = {"ms": _events_ms(torch, call, reps), "device_ms": total, "split": split}
    row["library_ms"] = _events_ms(torch, _sdpa_backward(torch, q, k, v, dout, scale), reps)
    print(f"[{label}] {name} {tuple(row['shape'])} bf16: " + "; ".join(
        f"{entry} {row[entry]['ms']:.4f} ms (device {_fmt(row[entry]['device_ms'])}: "
        + ", ".join(f"{part} {_fmt(x)}" for part, x in row[entry]["split"].items()) + ")"
        for entry in BACKWARD) + f"; sdpa backward {row['library_ms']:.4f} ms", flush=True)
    del q, k, v, dout, out, lse, args
    torch.cuda.empty_cache()
    return row


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                   help="the checkout whose port is timed")
    p.add_argument("--label", default="", help="a name for this tree in the output")
    p.add_argument("--reps", type=int, default=15, help="timed calls a median is taken over")
    p.add_argument("--shapes", nargs="+", choices=list(SHAPES), default=list(SHAPES))
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bwd_head_dim_times times CUDA kernels: it needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    sys.path.insert(0, str(Path(args.root).resolve()))
    from lumina_t2x_tpu_torch.ops import flash_attention as fa

    label = args.label or args.root
    print(f"[{label}] {fa.__file__}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = {"label": label, "device": torch.cuda.get_device_name(0), "power": smi,
              "rows": {name: shape_rows(torch, fa, name, args.reps, label)
                       for name in args.shapes}}
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()

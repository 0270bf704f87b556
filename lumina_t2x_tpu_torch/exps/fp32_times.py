"""Times of the fp32 attention kernels on the card, beside fp32 sdpa, and of the fp32 music trainer's step.

    python lumina_t2x_tpu_torch/exps/fp32_times.py [--root DIR] [--label NAME]
        [--parts {forward,backward,trainer} ...]

`forward` (`csrc/flash_fwd_fp32_sm90.cu`): K1 (`flash_small_kv`) at
FlagDiT-1D's served shape (B=2, Sq=128, H=16, D=72) over its 128 latent
frames and its 16 caption keys: CUDA events around the wrapper (median of 21
single calls), the kernel's device time a call under `torch.profiler`, the
wrapper's host time a call over 200 calls back to back; then K2-K5
(`flash_online`, `flash_static_max`, `flash_online_lse`,
`flash_static_max_lse`) at the 2B's (2, 4096, 32, 72), CUDA events (median
of 7); each beside one library call on the same inputs (sdpa; aten's
memory-efficient attention with its LSE for K4/K5). Every key is valid; K3/K5
take the bound 12.

`backward` (`csrc/flash_bwd_fp32_sm90.cu`): K6 (`flash_bwd_fused`), K7
(`flash_bwd_dq`) and K8 (`flash_bwd_dkv`) at the music trainer's FlagDiT-1D
shape (B=32, Sq=256, H=16, D=72) over its 256 latent frames and its 77
caption keys, and at the 2B's (2, 4096, 32, 72) with the last 819 keys of
batch row 1 masked: CUDA events around the wrapper (median of 7; 5 at the
2B's shape) and each kernel's device time a call under `torch.profiler`,
beside the fp32 sdpa backward on the same inputs (`torch.autograd.grad`
through `scaled_dot_product_attention`, with the key mask at the 2B's).
out and the LSE come from the plain LSE forward.

`trainer`: `pipelines.train_audio.main` at its defaults (FlagDiT-1D 1152
wide, 28 layers; synthetic://, B=32, 256 frames, 77 caption tokens) with
`--precision fp32` for 3 steps, no checkpoint written: losses, s/step, peak
memory and the attention launches.

Inputs are N(0, 1) fp32 from seed 0; TF32 is off for matmuls and
convolutions. `--parts` defaults to forward and backward. `--root` names the
checkout whose port is timed (default: the one holding this script). Run as
a file, so that another commit's tree, unpacked with `git archive` under a
directory that `.gitignore` lists, is timed by the same code in the same
call: parent, change, change, parent. The kernels are built into that tree's
`build/kernels/`. The last line is a JSON object of the rows. Needs a CUDA
device and nvcc.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

AUDIO = (2, 128, 16, 72)  # the served shape (B, Sq, H, D); keys 128 (self) and 16 (caption)
AUDIO_KEYS = (128, 16)
MUSIC = (32, 256, 16, 72)  # the music trainer's; keys 256 (self) and 77 (caption)
MUSIC_KEYS = (256, 77)
WIDE = (2, 4096, 32, 72)  # the 2B
WIDE_TAIL = 819  # masked keys of the 2B backward's batch row 1
BOUND = 12.0
BACKWARD = ("bwd_fused", "bwd_dq", "bwd_dkv")


def _events_ms(torch, fn, reps):
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


def _device_ms(torch, fn, pattern, calls):
    """Mean device time (ms) a call of the kernels whose name holds
    `pattern`, under torch.profiler; None when the trace has none."""
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


def _host_ms(torch, fn, calls=200):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = 1e3 * (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    return host


def forward_rows(torch, fa, label):
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    b, sq, h, d = AUDIO
    scale = d ** -0.5
    q = torch.randn(b, sq, h, d, generator=g, device="cuda")
    for sk in AUDIO_KEYS:
        k, v = (torch.randn(b, sk, h, d, generator=g, device="cuda") for _ in range(2))
        k1 = lambda: fa.flash_small_kv(q, k, v, None, scale)  # noqa: E731
        lib = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale=scale)
        err = (k1() - fa.flash_small_kv_plain(q, k, v, None, scale)).abs().max().item()
        row = {"ms": _events_ms(torch, k1, 21),
               "device_ms": _device_ms(torch, k1, "flash_fwd", 20),
               "host_ms": _host_ms(torch, k1), "library_ms": _events_ms(torch, lib, 21),
               "library_device_ms": _device_ms(torch, lib, "", 20), "max_abs_err": err}
        rows[f"small_kv Sk={sk}"] = row
        print(f"[{label}] small_kv fp32 {AUDIO} Sk={sk}: " + ", ".join(
            f"{key} {val:.4f}" if isinstance(val, float) else f"{key} {val}"
            for key, val in row.items()), flush=True)
    b, sq, h, d = WIDE
    scale = d ** -0.5
    q, k, v = (torch.randn(b, sq, h, d, generator=g, device="cuda") for _ in range(3))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, scale=scale)
    efficient = lambda: torch.ops.aten._scaled_dot_product_efficient_attention(  # noqa: E731
        qt, kt, vt, None, True, scale=scale)
    for entry in ("online", "static_max", "online_lse", "static_max_lse"):
        kw = {"bound": BOUND} if entry.startswith("static_max") else {}
        fn = getattr(fa, f"flash_{entry}")
        row = {"ms": _events_ms(torch, lambda: fn(q, k, v, None, scale, **kw), 7),
               "library_ms": _events_ms(torch, efficient if entry.endswith("_lse") else sdpa, 7)}
        rows[f"{entry} 2B"] = row
        print(f"[{label}] {entry} fp32 {WIDE}: kernel {row['ms']:.3f} ms, library "
              f"{row['library_ms']:.3f} ms", flush=True)
    return rows


def _backward_inputs(torch, fa, g, b, sq, sk, h, d, tail):
    q, k, v, dout = (torch.randn(b, s, h, d, generator=g, device="cuda")
                     for s in (sq, sk, sk, sq))
    mask = None
    if tail:
        mask = torch.ones(b, sk, dtype=torch.int32, device="cuda")
        mask[-1, sk - tail:] = 0
    scale = d ** -0.5
    out, lse = fa.flash_online_lse_plain(q, k, v, mask, scale)
    return (q, k, v, mask, out, lse, dout, scale)


def _sdpa_backward(torch, q, k, v, mask, dout, scale):
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    attn_mask = None if mask is None else (mask != 0)[:, None, None, :]
    out = torch.nn.functional.scaled_dot_product_attention(
        *(t.transpose(1, 2) for t in leaves), attn_mask=attn_mask, scale=scale)
    grad_out = dout.transpose(1, 2)
    return lambda: torch.autograd.grad(out, leaves, grad_out, retain_graph=True)


def backward_rows(torch, fa, label):
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    shapes = [(f"music Sk={sk}", (*MUSIC[:2], sk, *MUSIC[2:]), 0, 7) for sk in MUSIC_KEYS]
    shapes.append(("2B", (WIDE[0], WIDE[1], WIDE[1], WIDE[2], WIDE[3]), WIDE_TAIL, 5))
    for name, (b, sq, sk, h, d), tail, reps in shapes:
        args = _backward_inputs(torch, fa, g, b, sq, sk, h, d, tail)
        row = {}
        for entry in BACKWARD:
            fn = getattr(fa, f"flash_{entry}")
            call = lambda: fn(*args)  # noqa: E731
            row[entry] = {"ms": _events_ms(torch, call, reps),
                          "device_ms": _device_ms(torch, call, "flash_bwd", 5)}
        q, k, v, mask, _, _, dout, scale = args
        lib = _sdpa_backward(torch, q, k, v, mask, dout, scale)
        row["library_ms"] = _events_ms(torch, lib, reps)
        rows[name] = row
        print(f"[{label}] fp32 backward {name} {(b, sq, h, d)}: " + ", ".join(
            f"{entry} {row[entry]['ms']:.3f} ms (device "
            + (f"{row[entry]['device_ms']:.3f}" if row[entry]["device_ms"] is not None
               else "not traced") + ")" for entry in BACKWARD)
            + f"; fp32 sdpa backward {row['library_ms']:.3f} ms", flush=True)
        del args, q, k, v, mask, dout, lib
        torch.cuda.empty_cache()
    return rows


def trainer_steps(torch, fa, label):
    """3 full-depth fp32 steps of the music trainer, no checkpoint written."""
    from lumina_t2x_tpu_torch.pipelines import train_audio

    b, s, _, _ = MUSIC
    saved = train_audio.save_checkpoint
    fa.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as results:
        train_audio.save_checkpoint = lambda *args, **kwargs: "(not written)"
        try:
            state = train_audio.main(["--data_path", "synthetic://", "--global_batch_size", str(b),
                                      "--latent_length", str(s), "--context_len",
                                      str(MUSIC_KEYS[1]), "--precision", "fp32", "--log_every",
                                      "1", "--ckpt_every", "1000", "--device", "cuda",
                                      "--results_dir", results, "--max_steps", "3"])
            torch.cuda.synchronize()
        finally:
            train_audio.save_checkpoint = saved
        with open(os.path.join(results, "music", "metrics.jsonl")) as f:
            metrics = [json.loads(line) for line in f]
    del state
    out = {"losses": [m["train/loss"] for m in metrics],
           "secs_per_step": [m["train/secs_per_step"] for m in metrics],
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": {k: v for k, v in fa.LAUNCHES.items() if v},
           "plain_cuda_calls": fa.PLAIN_CUDA_CALLS["count"]}
    print(f"[{label}] train_audio fp32, B={b}, {s} frames, 3 steps: losses "
          f"{[round(x, 5) for x in out['losses']]}, s/step "
          f"{[round(x, 4) for x in out['secs_per_step']]}, peak {out['peak_gib']:.2f} GiB, "
          f"launches {out['launches']}", flush=True)
    if not all(math.isfinite(x) for x in out["losses"]):
        raise SystemExit(f"[{label}] fp32 trainer losses not finite: {out['losses']}")
    torch.cuda.empty_cache()
    return out


PARTS = {"forward": forward_rows, "backward": backward_rows, "trainer": trainer_steps}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                   help="the checkout whose port is timed")
    p.add_argument("--label", default="", help="a name for this tree in the output")
    p.add_argument("--parts", nargs="+", choices=list(PARTS), default=["forward", "backward"],
                   help="what to time (trainer: 3 fp32 steps of the music trainer at full "
                        "width and depth)")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("fp32_times times CUDA kernels: it needs a CUDA device")
    sys.path.insert(0, str(Path(args.root).resolve()))
    from lumina_t2x_tpu_torch.ops import flash_attention as fa

    label = args.label or args.root
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[{label}] {smi}; {fa.__file__}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = {"label": label, "device": torch.cuda.get_device_name(0), "power": smi}
    for part in args.parts:
        result[part] = PARTS[part](torch, fa, label)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()

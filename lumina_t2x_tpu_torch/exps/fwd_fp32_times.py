"""Times of the fp32 attention forward on the card, beside fp32 sdpa.

    python lumina_t2x_tpu_torch/exps/fwd_fp32_times.py [--root DIR] [--label NAME]

K1 (`flash_small_kv`) at FlagDiT-1D's served shape (B=2, Sq=128, H=16,
D=72) over its 128 latent frames and its 16 caption keys: CUDA events around
the wrapper (median of 21 single calls), the kernel's device time a call
under `torch.profiler`, the wrapper's host time a call over 200 calls back
to back; then K2-K5 (`flash_online`, `flash_static_max`, `flash_online_lse`,
`flash_static_max_lse`) at the 2B's (2, 4096, 32, 72), CUDA events (median
of 7); each beside one library call on the same inputs (sdpa; aten's
memory-efficient attention with its LSE for K4/K5). Inputs are N(0, 1) fp32
from seed 0, every key valid; K3/K5 take the bound 12.

`--root` names the checkout whose port is timed (default: the one holding
this script). Run as a file, so that another commit's tree, unpacked with
`git archive` under a directory that `.gitignore` lists, is timed by the
same code in the same call: parent, change, change, parent. The kernels are
built into that tree's `build/kernels/`. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

AUDIO = (2, 128, 16, 72)  # (B, Sq, H, D); keys 128 (self) and 16 (caption)
AUDIO_KEYS = (128, 16)
WIDE = (2, 4096, 32, 72)  # the 2B
BOUND = 12.0


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


def _device_ms(torch, fn, pattern, calls=20):
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


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                   help="the checkout whose port is timed")
    p.add_argument("--label", default="", help="a name for this tree in the output")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("fwd_fp32_times times CUDA kernels: it needs a CUDA device")
    sys.path.insert(0, str(Path(args.root).resolve()))
    from lumina_t2x_tpu_torch.ops import flash_attention as fa

    label = args.label or args.root
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[{label}] {smi}; {fa.__file__}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
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
        row = {"ms": _events_ms(torch, k1, 21), "device_ms": _device_ms(torch, k1, "flash_fwd"),
               "host_ms": _host_ms(torch, k1), "library_ms": _events_ms(torch, lib, 21),
               "library_device_ms": _device_ms(torch, lib, ""), "max_abs_err": err}
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
    print(json.dumps({"label": label, "device": torch.cuda.get_device_name(0), "power": smi,
                      "rows": rows}), flush=True)


if __name__ == "__main__":
    main()

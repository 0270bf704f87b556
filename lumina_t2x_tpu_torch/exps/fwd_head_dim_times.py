"""Times of the bf16 attention forward (K1-K5) at head_dim 48, 64, 72, 96 and 128 on the card.

    python lumina_t2x_tpu_torch/exps/fwd_head_dim_times.py [--root DIR] [--label NAME]
        [--reps N] [--shapes NAME ...] [--dtype bf16|fp16]

Shapes (B, Sq, H, D), bf16 (or fp16, the kernels' fp16 instantiations),
every key valid, Sk = Sq unless noted:
  small      (128, 1024, 8, 48)  NextDiT-ImageNet Small's sampler (FID batches under CFG): K1
  600m       (8, 256, 32, 48)    NextDiT-ImageNet 600M's sampler (4 labels under CFG): K1
  600m_train (256, 256, 32, 48)  the 600M's training self-attention at 256^2: K4
  7b         (8, 256, 32, 128)   Flag-DiT ImageNet 7B's sampler: K1
  5b         (2, 4160, 32, 96)   Flag-DiT 5B's at 1024^2: K2, K3, K4, K5
  2b         (2, 4096, 32, 72)   NextDiT-2B's at 1024^2, the control (80/72): K2, K3, and K1
                                 over the sampler's 256 and the trainer's 32 caption keys
                                 (the K/V-resident block), K4 and K9's rope_q over 32
  2b_gemma   (2, 4096, 32, 72)   the 2B trainer's K4 over Gemma caption lengths 8, 40, 136
  2b_128k    (1, 131072, 32, 72) the 2B's 128K-token forward: rope_q over its 256 caption
                                 keys (`exps/longcontext_forward.py`)
  mmdit_db   (2, 589, 24, 64)    MMDiT-SD3-Medium's joint sequence in DreamBooth at 256^2
                                 (64/64 over few keys): K4, K1
  music_train (32, 256, 16, 72)  the music trainer's (80/72 over few keys): K4 over its 256
                                 frames and its 77 caption keys
  2b_db      (2, 256, 32, 72)    the 2B's DreamBooth at 256^2: K4
  audio      (2, 128, 16, 72)    FlagDiT-1D's bf16 forward: K1 over 128 frames and 16 caption
                                 keys
  sd3        (2, 4429, 24, 64)   MMDiT-SD3-Medium's joint sequence at 1024^2 (64/64 over more
                                 than 1024 keys): K2, K3, K4
For each row: the wrapper's ms by CUDA events (median of `--reps` single
calls, and of `--reps` bursts of 8 calls a call), the kernel's device time a
call under `torch.profiler` (`flash_fwd` kernels; the rest of one call is the
wrapper's host time), the host's time to issue a call (the mean over 200
calls, without waiting for the card) of the wrapper and of its C entry point
alone, called with the wrapper's arguments made once (the difference is the
wrapper's Python: checks, allocation, meta, counts), and in the same call
one library call on the same inputs: `scaled_dot_product_attention` for
K1-K3, aten's flash attention with its LSE for K4/K5, by CUDA events and by
its kernels' device time under `torch.profiler` (every kernel of the call),
so that each factor reads device to device as well as on one call; K9's
`rope_q` (q rotated in the kernel, the 2B's RoPE angles on a square grid,
512 x 256 at 131072 rows) has no library call and no C entry timing. K3/K5
run under a bound 6 over the largest row LSE. Beside them, each row's bound (the
larger of its two products' operations over 989 TFLOP/s and its bytes,
each input read and each output written once, the rotation's two fp32
tables read once, over 3.35 TB/s) and its exp
floor (B*H*Sq*Sk exponentials over the special-function units' 3.9e12 a
second: 16 per clock per SM x 132 SMs x ~1.83 GHz).

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
import time
from pathlib import Path

# name: ((B, Sq, H, D), [(row, entry, Sk or None for Sq)])
SHAPES = {
    "small": ((128, 1024, 8, 48), [("K1", "small_kv", None)]),
    "600m": ((8, 256, 32, 48), [("K1", "small_kv", None)]),
    "600m_train": ((256, 256, 32, 48), [("K4", "online_lse", None)]),
    "7b": ((8, 256, 32, 128), [("K1", "small_kv", None)]),
    "5b": ((2, 4160, 32, 96), [("K2", "online", None), ("K3", "static_max", None),
                               ("K4", "online_lse", None), ("K5", "static_max_lse", None)]),
    "2b": ((2, 4096, 32, 72), [("K2", "online", None), ("K3", "static_max", None),
                               ("K1 Sk=256", "small_kv", 256), ("K1 Sk=32", "small_kv", 32),
                               ("K4 Sk=32", "online_lse", 32), ("rope_q Sk=32", "rope_q", 32)]),
    "2b_gemma": ((2, 4096, 32, 72), [(f"K4 Sk={sk}", "online_lse", sk) for sk in (8, 40, 136)]),
    "2b_128k": ((1, 131072, 32, 72), [("rope_q Sk=256", "rope_q", 256)]),
    "mmdit_db": ((2, 589, 24, 64), [("K4", "online_lse", None), ("K1", "small_kv", None)]),
    "music_train": ((32, 256, 16, 72), [("K4", "online_lse", None),
                                        ("K4 Sk=77", "online_lse", 77)]),
    "2b_db": ((2, 256, 32, 72), [("K4", "online_lse", None)]),
    "audio": ((2, 128, 16, 72), [("K1", "small_kv", None), ("K1 Sk=16", "small_kv", 16)]),
    "sd3": ((2, 4429, 24, 64), [("K2", "online", None), ("K3", "static_max", None),
                                ("K4", "online_lse", None)]),
}
BURST = 8
# H100 SXM: dense bf16 tensor rate, memory rate, exponentials a second
PEAK_BF16, HBM_BYTES_S, EXP_RATE = 989e12, 3.35e12, 3.9e12


def _events_ms(torch, fn, reps, burst=1):
    """Median ms a call by CUDA events around `burst` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(burst):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / burst)
    return statistics.median(times)


def _device_ms(torch, fn, calls, pattern):
    """Device ms a call of the CUDA kernels whose names hold `pattern` under
    torch.profiler; None when the trace has none."""
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


def _host_us(torch, fn, calls=200):
    """Mean host microseconds to issue one call of fn, without waiting for
    the card (its queue holds the calls)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / calls


def _entry_call(torch, fa, entry, q, k, v, scale, bound):
    """The C entry point of `entry` with the wrapper's arguments made once."""
    from lumina_t2x_tpu_torch.ops import cuda_lib

    out = torch.empty_like(q)
    b, sq, hq, _ = q.shape
    lse = torch.empty(b, hq, sq, device="cuda") if entry.endswith("_lse") else None
    fn = getattr(cuda_lib.build_library(fa.LIBRARY), f"lumina_flash_{entry}")
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), None, out.data_ptr(),
            lse.data_ptr() if lse is not None else None, fa._fwd_meta(q, k, v, out, None), scale,
            bound, fa._DTYPE_CODES[q.dtype], torch.cuda.current_stream().cuda_stream)
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"lumina_flash_{entry} failed: cudaError {err}")
    return lambda: fn(*args), (out, lse)


def _library(torch, entry, q, k, v, scale):
    """One library call of the same function: sdpa (K1-K3), aten's flash
    attention with LSE (K4/K5)."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if entry.endswith("_lse"):
        return lambda: torch.ops.aten._scaled_dot_product_flash_attention(qt, kt, vt, scale=scale)
    return lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, scale=scale)


def _fmt(x):
    return "not traced" if x is None else f"{x:.4f}"


def _rope_angles(s, d):
    """The 2B's RoPE angles (s, d / 2) on a gh x gw grid, gh = 2^ceil(log2(s) / 2)."""
    from lumina_t2x_tpu_torch.ops.rope import rope_angles_2d

    gh = 2 ** (s.bit_length() // 2)
    return rope_angles_2d(d, gh, s // gh, device="cuda").reshape(s, d // 2)


def shape_rows(torch, fa, name, reps, label, dtype):
    (b, s, h, d), entries = SHAPES[name]
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(b, s, h, d, generator=g, device="cuda").to(dtype)
    scale = d ** -0.5
    instantiation = getattr(fa, "fwd_sm90_instantiation", None)
    rows = {}
    for row, entry, sk in entries:
        sk = sk or s
        k, v = (torch.randn(b, sk, h, d, generator=g, device="cuda").to(dtype)
                for _ in range(2))
        kw = {}
        if entry.startswith("static_max"):
            lse = fa.flash_online_lse(q, k, v, None, scale)[1]
            kw = {"bound": float(lse.max()) + 6.0}
        fn = getattr(fa, f"flash_{entry}")
        rope = entry.startswith("rope")
        if rope:
            angles = _rope_angles(s, d)
            call = lambda: fn(q, k, v, angles, None, scale)  # noqa: E731
        else:
            call = lambda: fn(q, k, v, None, scale, **kw)  # noqa: E731
        one = _events_ms(torch, call, reps)
        device = _device_ms(torch, call, 10, "flash_fwd")
        out = {"entry": entry, "dtype": str(dtype), "shape": [b, s, h, d], "sk": sk, "ms": one,
               "burst_ms": _events_ms(torch, call, reps, BURST), "device_ms": device,
               "host_ms": None if device is None else one - device,
               "issue_us": _host_us(torch, call), "entry_issue_us": None, "library_ms": None,
               "library_burst_ms": None, "library_device_ms": None}
        keep = None
        if not rope:
            c_entry, keep = _entry_call(torch, fa, entry, q, k, v, scale, kw.get("bound", 0.0))
            library = _library(torch, entry, q, k, v, scale)
            out.update(entry_issue_us=_host_us(torch, c_entry),
                       library_ms=_events_ms(torch, library, reps),
                       library_burst_ms=_events_ms(torch, library, reps, BURST),
                       library_device_ms=_device_ms(torch, library, 10, ""))
        nbytes = 2 * (2 * b * s * h * d + 2 * b * sk * h * d) + (
            4 * b * h * s if entry.endswith("_lse") else 0) + (2 * s * d * 4 if rope else 0)
        out["bound_ms"] = 1e3 * max(4 * b * h * s * sk * d / PEAK_BF16, nbytes / HBM_BYTES_S)
        out["exp_floor_ms"] = 1e3 * b * h * s * sk / EXP_RATE
        if instantiation is not None:
            out["instantiation"] = list(instantiation(d, s, sk))
        rows[row] = out
        print(f"[{label}] {name} {row} {entry} ({b}, {s}, {h}, {d}) Sk={sk} "
              f"{'fp16' if dtype == torch.float16 else 'bf16'}"
              + (f" {out['instantiation']}" if "instantiation" in out else "")
              + f": {one:.4f} ms one call, {out['burst_ms']:.4f} in bursts of {BURST}; device "
              f"{_fmt(device)}, host {_fmt(out['host_ms'])}; issue {out['issue_us']:.1f} us"
              + ("" if rope else
                 f" (C entry {out['entry_issue_us']:.1f}); library {out['library_ms']:.4f} "
                 f"(bursts {out['library_burst_ms']:.4f}, device "
                 f"{_fmt(out['library_device_ms'])})")
              + ("; library none" if rope else "")
              + f"; bound {out['bound_ms']:.4f}, exp floor {out['exp_floor_ms']:.4f}", flush=True)
        del k, v, keep
    del q
    torch.cuda.empty_cache()
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                   help="the checkout whose port is timed")
    p.add_argument("--label", default="", help="a name for this tree in the output")
    p.add_argument("--reps", type=int, default=15, help="timed calls a median is taken over")
    p.add_argument("--shapes", nargs="+", choices=list(SHAPES), default=list(SHAPES))
    p.add_argument("--dtype", choices=["bf16", "fp16"], default="bf16",
                   help="the operands' type: the bf16 or the fp16 instantiations")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("fwd_head_dim_times times CUDA kernels: it needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    sys.path.insert(0, str(Path(args.root).resolve()))
    from lumina_t2x_tpu_torch.ops import flash_attention as fa

    label = args.label or args.root
    print(f"[{label}] {fa.__file__}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = {"bf16": torch.bfloat16, "fp16": torch.float16}[args.dtype]
    result = {"label": label, "device": torch.cuda.get_device_name(0), "power": smi,
              "rows": {name: shape_rows(torch, fa, name, args.reps, label, dtype)
                       for name in args.shapes}}
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()

"""The port's experiments: the two probes that run the last Pallas kernels of
the JAX package's `exps/` (counterparts of `exps/vpu_op_reduction.py` and
`exps/mxu_k_quantum.py`), each with its hand-written Hopper kernels.

    python -m lumina_t2x_tpu_torch.exps.vpu_op_reduction [--only ops|v4]
    python -m lumina_t2x_tpu_torch.exps.mxu_k_quantum

Both run on the card by default (`--device cuda`); `--device cpu` runs the
plain versions at the same shapes (module constants), timed with the host
clock. Beside them, `python -m lumina_t2x_tpu_torch.exps.fwd_sm90_breakdown`
times the bf16 streaming attention forward (`csrc/flash_fwd_sm90.cu`) and
`python -m lumina_t2x_tpu_torch.exps.bwd_sm90_breakdown` the bf16 backward
(`csrc/flash_bwd_sm90.cu`) with parts taken out, on the card only.
"""

from __future__ import annotations

import statistics
import time

import torch


def time_ms(fn, device, reps: int = 10) -> float:
    """Median milliseconds of one call of fn after one warm-up call: CUDA
    events on the card, the host clock on the CPU."""
    device = torch.device(device)
    fn()
    times = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(reps):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize(device)
            times.append(e0.elapsed_time(e1))
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def device_label(device) -> str:
    """What a timing ran on: the card's name, or the CPU (host clock)."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu (plain versions, host clock)"


def device_ms(fn, pattern: str, calls: int = 20):
    """Mean device time (ms) a call of fn of the kernels whose name holds
    `pattern`, under `torch.profiler`, or None when the trace has no device
    events."""
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


def source_with_common(path) -> str:
    """A Hopper kernel's source with `sm90_common.cuh` (the PTX helpers, the
    pair products and the K/V ring its kernels share) pasted in place of its
    #include, so that a breakdown variant can take parts out of those too."""
    common = (path.parent / "sm90_common.cuh").read_text().replace("#pragma once\n", "")
    include = '#include "sm90_common.cuh"\n'
    source = path.read_text()
    if source.count(include) != 1:
        raise RuntimeError(f"{path.name} does not include sm90_common.cuh once")
    return source.replace(include, common)


def require_device(device) -> torch.device:
    """The device to run on; a CUDA device must exist (no fallback to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the kernels run on the card (--device cpu runs the "
                         "plain versions)")
    return device

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


def require_device(device) -> torch.device:
    """The device to run on; a CUDA device must exist (no fallback to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the kernels run on the card (--device cpu runs the "
                         "plain versions)")
    return device

"""Tensor-core probe: how the card charges a bf16 product for its depth K
and its width N (counterpart of `exps/mxu_k_quantum.py`).

The kernel (`csrc/mma_probe.cu`) keeps a (M, K) row tile of a and a (K, N)
column tile of w in shared memory and runs ITERS chained products
out += bf16(a + j*1e-6) @ w on them with mma.sync.m16n8k16: the loop index
perturbs A so that no product can be hoisted, and the bytes are negligible,
so the time per product is the tensor cores' and the perturbation's.
mma.sync takes bf16 depth in steps of 16 and width in steps of 8, so on
this card the instruction shape answers the TPU probe's question: head_dim
72 runs as 80 in the QK^T product (depth; the kernel zero-pads K to 16) and
as exactly 72 in the PV product (width), where the TPU charged 128 for
both. The sweeps show the rate the chained loop reaches at each shape.

    python -m lumina_t2x_tpu_torch.exps.mxu_k_quantum [--device cuda]

Prints, per shape, microseconds per product, TF/s useful (2*M*N*K per
product) and the number of blocks launched (each a 64 x 32 tile of out):
at small N the grid has fewer blocks than the card has SMs, and the rate
per busy SM tells low occupancy apart from depth or width quantisation.
`mma_chain` runs its plain PyTorch version on CPU tensors and its kernel on
CUDA tensors (or raises); `LAUNCHES` counts the launches.
"""

from __future__ import annotations

import argparse
import ctypes

import torch

from ..ops import cuda_lib
from . import device_label, require_device, time_ms

M = 1024
N_DEFAULT = 1024
ITERS = 512
K_SWEEP = [(k, N_DEFAULT) for k in (8, 16, 32, 64, 72, 80, 96, 128, 144, 192, 256, 512)]
N_SWEEP = [(1024, n) for n in (8, 16, 32, 64, 72, 80, 96, 128, 144, 192, 256)]
MAX_K = 1024           # the A row tile and W column tile fit in shared memory
BLOCK_M, BLOCK_N = 64, 32  # the kernel's tile of out (csrc/mma_probe.cu)
# launches of the kernel; the wrapper adds one where it launches, nowhere else
LAUNCHES = {"mma_chain": 0}

LIBRARY = "mma_probe"  # the library of K12 (`ops/cuda_lib.py`)
_ptr = ctypes.c_void_p
# a, w, out, M, N, K, iters, stream
cuda_lib.declare(LIBRARY, ["mma_probe.cu"],
                 {"lumina_mma_chain": [_ptr] * 3 + [ctypes.c_int] * 4 + [_ptr]})


def reset_launch_counts() -> None:
    LAUNCHES["mma_chain"] = 0


def _check(a, w, iters):
    if a.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"mma_chain takes bf16 a and w, got {a.dtype}/{w.dtype}")
    if a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[0] or not 0 < a.shape[1] <= MAX_K:
        raise ValueError(f"bad shapes a {tuple(a.shape)} w {tuple(w.shape)} (0 < K <= {MAX_K})")
    if iters < 0:
        raise ValueError(f"iters {iters} < 0")


def perturbations(iters: int) -> list:
    """f32(j) * f32(1e-6) for j < iters, each product rounded to fp32."""
    return (torch.arange(iters, dtype=torch.float32) * 1e-6).tolist()


def mma_chain_plain(a, w, iters):
    """Plain version of `mma_chain`: sum over j < iters of
    bf16(f32(a) + f32(j)*1e-6) @ w, fp32."""
    af, wf = a.float(), w.float()
    out = torch.zeros(a.shape[0], w.shape[1], dtype=torch.float32, device=a.device)
    for pert in perturbations(iters):
        out += (af + pert).to(torch.bfloat16).float() @ wf
    return out


def mma_chain(a, w, iters):
    """out (M, N) fp32 = sum over j < iters of bf16(f32(a) + f32(j)*1e-6) @ w
    for bf16 a (M, K) and w (K, N), K <= 1024 (replaces `_kernel` of
    `exps/mxu_k_quantum.py`)."""
    _check(a, w, iters)
    if not a.is_cuda:
        return mma_chain_plain(a, w, iters)
    if not w.is_cuda:
        raise ValueError("mma_chain takes a and w on one device")
    a, w = a.contiguous(), w.contiguous()
    m, k = a.shape
    n = w.shape[1]
    lib = cuda_lib.build_library(LIBRARY)
    with torch.cuda.device(a.device):
        out = torch.empty((m, n), dtype=torch.float32, device=a.device)
        err = lib.lumina_mma_chain(a.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k, iters,
                                   torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"mma_chain launch failed: cudaError {err}")
    LAUNCHES["mma_chain"] += 1
    return out


def blocks(m: int, n: int) -> int:
    """Blocks the kernel launches for an (m, n) output."""
    return -(-m // BLOCK_M) * -(-n // BLOCK_N)


def sweep(name, shapes, device="cuda"):
    """Time `mma_chain` at each (K, N) of shapes, M rows and ITERS products;
    prints a row per shape and returns them as dicts."""
    device, m, iters = torch.device(device), M, ITERS
    sms = torch.cuda.get_device_properties(device).multi_processor_count \
        if device.type == "cuda" else None
    print(f"== {name} (M={m}, {iters} chained on-chip products, median of 10 calls)", flush=True)
    g = torch.Generator(device=device).manual_seed(0)
    rows = []
    for k, n in shapes:
        a = torch.randn(m, k, generator=g, device=device).to(torch.bfloat16)
        w = torch.randn(k, n, generator=g, device=device).to(torch.bfloat16)
        ms = time_ms(lambda: mma_chain(a, w, iters), device)
        us = 1e3 * ms / iters
        tf = 2 * m * n * k / us / 1e6
        row = {"K": k, "N": n, "us_per_dot": us, "tflops": tf, "blocks": blocks(m, n)}
        line = f"  K={k:4d} N={n:4d}: {us:9.3f} us/dot  {tf:7.1f} TF/s useful  {row['blocks']:4d} blocks"
        if sms:
            row["tflops_per_busy_sm"] = tf / min(row["blocks"], sms)
            line += f"  {row['tflops_per_busy_sm']:6.3f} TF/s per busy SM"
        print(line, flush=True)
        rows.append(row)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = require_device(args.device)
    print(f"device: {device_label(device)}", flush=True)
    return {"K": sweep(f"K-sweep (N={N_DEFAULT})", K_SWEEP, device),
            "N": sweep("N-sweep (K=1024)", N_SWEEP, device)}


if __name__ == "__main__":
    main()

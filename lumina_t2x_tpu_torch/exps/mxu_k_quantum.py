"""Tensor-core probe: how the card charges a bf16 product for its depth K
and its width N (counterpart of `exps/mxu_k_quantum.py`).

The kernel (`csrc/mma_probe.cu`) keeps a (64, K) row tile of a and a (K,
BN) column tile of w in shared memory and runs chained products out +=
bf16(a + j*1e-6) @ w on them with `wgmma` (m64nBNk16, A from registers,
the Hopper forward's PV product): the loop index perturbs A so that no
product can be hoisted, and the bytes are negligible, so the time per
product is the tensor cores' and the perturbation's. wgmma takes bf16 depth
in steps of 16 and width in steps of 8, up to 256: head_dim 72 runs as 80
in the QK^T product (depth; the kernel zero-pads K to 16) and as 72 in the
PV product (width), where the TPU charged 128 for both.

`plan` sets the grid on the host: BN (one product of width N rounded up to
8 where the tiles fit in shared memory, else column tiles; at K=1024 only
BN <= 48 fits beside the A tile), and j-slices of the iterations until the
grid has at least 10/11 of the card's SMs in blocks. So every SM is busy at
every sweep shape: the microseconds per product at N = 64 / 72 / 80 / 128
read how wgmma charges width (at K=1024 as column tiles of 32, 24, 40 and
32), and the K-sweep reads depth in steps of 16.

    python -m lumina_t2x_tpu_torch.exps.mxu_k_quantum [--device cuda]

Prints, per shape, microseconds per product (the kernel's: bursts of bare
launches, the wrapper's host work done once), TF/s useful (2*M*N*K per
product) and the plan: BN, j-slices and blocks launched. `mma_chain` runs
its plain PyTorch version on CPU tensors and its kernel on CUDA tensors (or
raises); `LAUNCHES` counts the launches.
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
MAX_K = 1024           # the A row tile and a w column tile fit in shared memory
BLOCK_M = 64           # rows of out per block: one wgmma M
# the wgmma widths the kernel is instantiated at (`csrc/mma_probe.cu`)
WIDTHS = (8, 16, 24, 32, 40, 48, 64, 72, 80, 96, 128, 144, 192, 256)
SMEM_MAX = 232448      # shared memory a block can use
SMS = 132              # the H100's SMs: the plan's default
BURST = 4              # launches between the sweep's CUDA events
# launches of the kernel; the wrapper adds one where it launches, nowhere else
LAUNCHES = {"mma_chain": 0}

LIBRARY = "mma_probe"  # the library of K12 (`ops/cuda_lib.py`)
_ptr = ctypes.c_void_p
_int = ctypes.c_int
cuda_lib.declare(LIBRARY, ["mma_probe.cu"], {
    # a, w, out, partial, M, N, K, iters, bn, slices, stream
    "lumina_mma_chain": [_ptr] * 4 + [_int] * 6 + [_ptr],
    # bn, k, out (int64[5])
    "lumina_mma_chain_attributes": [_int, _int, ctypes.POINTER(ctypes.c_longlong)]})
_ATTRIBUTES = ("registers", "local_bytes", "shared_bytes", "blocks_per_sm", "threads")


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


def shared_bytes(k: int, bn: int) -> int:
    """Shared memory of a block at depth k and width bn (`csrc/mma_probe.cu`
    `smem_bytes`): the 1024-byte alignment, w transposed in 64-column atoms
    of bn rows x 128 bytes, and the A tile (row stride K16 + 8), which
    warpgroup 1's fp32 accumulators overwrite at the end."""
    k16 = -(-k // 16) * 16
    return 1024 + bn * 128 * -(-k16 // 64) + max(2 * BLOCK_M * (k16 + 8), 4 * BLOCK_M * bn)


def plan(m: int, n: int, k: int, iters: int, sms: int = SMS) -> dict:
    """The kernel's grid for an (m, k) @ (k, n) chain of `iters` products on
    a card of `sms` SMs: the width bn (the narrowest instantiated width >= n
    rounded up to 8 whose tiles fit in shared memory; else column tiles of
    the fitting width that pads n least, the widest of those), the j-slices
    (enough that the grid has at least 10/11 of `sms` in blocks, at most
    `iters`), the blocks and the shared bytes of each."""
    fits = [w for w in WIDTHS if shared_bytes(k, w) <= SMEM_MAX]
    one = [w for w in fits if w >= -(-n // 8) * 8]
    bn = one[0] if one else min(fits, key=lambda w: (-(-n // w) * w, -w))
    tiles = -(-m // BLOCK_M) * -(-n // bn)
    slices = max(1, min(max(iters, 1), -(-(sms * 10 // 11) // tiles)))
    return {"bn": bn, "slices": slices, "blocks": tiles * slices,
            "shared_bytes": shared_bytes(k, bn)}


def mma_chain(a, w, iters):
    """out (M, N) fp32 = sum over j < iters of bf16(f32(a) + f32(j)*1e-6) @ w
    for bf16 a (M, K) and w (K, N), K <= 1024 (replaces `_kernel` of
    `exps/mxu_k_quantum.py`)."""
    _check(a, w, iters)
    if not a.is_cuda:
        return mma_chain_plain(a, w, iters)
    out, launch = _launcher(a, w, iters)
    launch()
    return out


def _launcher(a, w, iters):
    """The output of `mma_chain` on CUDA tensors and a function that
    launches the kernel into it: the plan, the output and the partial
    buffer made once, so that `sweep` times the kernel without the
    wrapper's host work."""
    if not (a.is_cuda and w.is_cuda):
        raise ValueError("the kernel takes a and w on one CUDA device")
    a, w = a.contiguous(), w.contiguous()
    m, k = a.shape
    n = w.shape[1]
    lib = cuda_lib.build_library(LIBRARY)
    with torch.cuda.device(a.device):
        p = plan(m, n, k, iters, torch.cuda.get_device_properties(a.device).multi_processor_count)
        out = torch.empty((m, n), dtype=torch.float32, device=a.device)
        partial = (torch.empty((p["slices"], m, n), dtype=torch.float32, device=a.device)
                   if p["slices"] > 1 else None)
        stream = torch.cuda.current_stream().cuda_stream
    args = (a.data_ptr(), w.data_ptr(), out.data_ptr(),
            partial.data_ptr() if partial is not None else None, m, n, k, iters, p["bn"],
            p["slices"], stream)

    def launch():
        err = lib.lumina_mma_chain(*args)
        if err != 0:
            raise RuntimeError(f"mma_chain launch failed: cudaError {err}")
        LAUNCHES["mma_chain"] += 1
        return a, w, partial  # alive until the launch has been enqueued

    return out, launch


def attributes(m: int, n: int, k: int, iters: int = ITERS) -> dict:
    """Resources of the compiled kernel at the width `plan` picks for the
    shape, from the CUDA runtime: registers and local-memory (spill) bytes
    per thread, shared memory per block (the static share, none, and the
    plan's dynamic bytes), resident blocks per SM, threads per block; with
    the plan's width, slices and blocks."""
    p = plan(m, n, k, iters, torch.cuda.get_device_properties(0).multi_processor_count)
    out = (ctypes.c_longlong * len(_ATTRIBUTES))()
    err = cuda_lib.build_library(LIBRARY).lumina_mma_chain_attributes(p["bn"], k, out)
    if err != 0:
        raise RuntimeError(f"lumina_mma_chain_attributes failed: cudaError {err}")
    return {**dict(zip(_ATTRIBUTES, out)), "bn": p["bn"], "slices": p["slices"],
            "blocks": p["blocks"]}


def sweep(name, shapes, device="cuda"):
    """Time the kernel at each (K, N) of shapes, M rows and ITERS products
    (on the card: bursts of BURST launches between CUDA events, the
    wrapper's host work done once; on the CPU: `mma_chain`, the plain
    version); prints a row per shape with the plan and returns them as
    dicts."""
    device, m, iters = torch.device(device), M, ITERS
    sms = torch.cuda.get_device_properties(device).multi_processor_count \
        if device.type == "cuda" else SMS
    print(f"== {name} (M={m}, {iters} chained on-chip products, median of 10 bursts of "
          f"{BURST})", flush=True)
    g = torch.Generator(device=device).manual_seed(0)
    rows = []
    for k, n in shapes:
        a = torch.randn(m, k, generator=g, device=device).to(torch.bfloat16)
        w = torch.randn(k, n, generator=g, device=device).to(torch.bfloat16)
        launch = _launcher(a, w, iters)[1] if device.type == "cuda" else \
            (lambda: mma_chain(a, w, iters))
        ms = time_ms(lambda: [launch() for _ in range(BURST)], device) / BURST
        us = 1e3 * ms / iters
        tf = 2 * m * n * k / us / 1e6
        p = plan(m, n, k, iters, sms)
        rows.append({"K": k, "N": n, "us_per_dot": us, "tflops": tf, "bn": p["bn"],
                     "slices": p["slices"], "blocks": p["blocks"]})
        print(f"  K={k:4d} N={n:4d}: {us:9.3f} us/dot  {tf:7.1f} TF/s useful  BN={p['bn']:3d}  "
              f"{p['slices']:3d} j-slices  {p['blocks']:4d} blocks", flush=True)
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

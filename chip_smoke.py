"""Drive the PyTorch port's main path once on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero before the
last line:
1. device: CUDA must be available; prints the card's name and power limit;
2. build: compiles every kernel from lumina_t2x_tpu_torch/csrc with nvcc
   (`ops/cuda_lib.py`: one library per module that owns kernels, one
   process per source, all started together) and prints the build seconds,
   then the resources of the Hopper kernels of bf16 K1-K5 and K9
   (`csrc/flash_fwd_sm90.cu`), bf16 K6-K8 (`csrc/flash_bwd_sm90.cu`: the
   backward sweep of K6/K8 and the dQ kernel of K7), K10 v0-v3 and K11
   (`csrc/static_max_sm90.cu`, one instantiation each) and K12
   (`csrc/mma_probe.cu`, at the widths of its timed shape and of K=1024):
   registers per thread (as compiled and after setmaxnreg), spill bytes (0
   required), shared memory per block, blocks per SM; and what ptxas says
   of their wgmma;
3. kernels: each CUDA entry point against its plain PyTorch version at the
   main-path shapes (B=2, S=4096, H=32, D=72; Sk=256 for the small-KV
   kernel; it, the LSE forward and the backward kernels also at the served
   and training cross-attention's Sk=32), bf16 and fp32, GQA, masked tails and a fully masked row, with
   kernel and plain times at each shape (CUDA events, median after a warm-up), the
   least time the card could take (`bound_ms`: bytes over 3.35 TB/s or
   operations over 989 TFLOP/s bf16, whichever is longer) and the time of
   one library call on the same inputs (`scaled_dot_product_attention` for
   K1-K3, aten's flash attention with its log-sum-exp for K4/K5, the sdpa
   autograd backward for K6-K8; K1 and K6-K8 also timed at Sk=32, where the
   served worker and the training cross-attention launch them); then the
   fused-RoPE kernels (K9: `rope` at Sq=Sk=4096, `rope_q` at Sk=32 and 256
   with the 2B's 1024^2 angles) against their plain versions, against
   themselves on `apply_rope`d inputs at zero angles, and bit for bit
   against the unfused entry point the same call would take on `apply_rope`d
   inputs (`flash_online` for `rope`, `flash_small_kv` for `rope_q`: K9 runs
   their kernel, with q rotated in it and k by `rope_rotate`), timed beside
   that entry point, and their gradient (`_FlashAttentionRope` through the
   kernels against the plain Function); `rope_rotate` against `apply_rope`
   bit for bit, timed at the 2B's k;
3b. experiments: the static-max variants (K10: `static_max_v0..v3`; K11:
   `static_max_v4`, which must equal v1 bit for bit) against their plain
   versions at the experiment's shape (B=2, S=4096, H=32, D=72, bound
   16.14, timed, and the five side by side; library
   `scaled_dot_product_attention`, with the exp floor B*H*S^2 / 3.9e12 s
   beside the bound) and with ragged tiles and a masked tail; their static
   SASS counts (cuobjdump; all five and K12 must run HGMMA and no HMMA);
   the tensor-core probe (K12: `mma_chain`)
   against its plain version at K 8/72/80/1024 and N 72/1024 (M=1024, 8
   iterations) and timed at K=72, N=1024, 512 iterations with its plan's
   width, j-slices and blocks (library: one cuBLAS `torch.mm` of the 512
   perturbed copies of a side by side along K against w stacked 512 times,
   fp32 out); then both experiment scripts' `main()` at their full shapes,
   the main path whose launches are counted;
4. full-width forward: one CFG forward of NextDiT_2B_patch2 (qk-norm,
   caption dim 2048, bf16, zero-init tensors randomised) at 1024^2 with 256
   caption tokens, through the kernels and through the plain versions;
5. the sampler: a 30-point midpoint trajectory (CFG 4, time-shift 4) of the
   same model through `sample_lib` with calibration, both timed; then the
   `lumina` CLI's `infer` (2B, 1024^2, the repo's settings, --debug: no
   qk-norm, so no calibration, as in the JAX CLI);
5b. serving: `build_worker` (2B, bf16, --debug, zero-init tensors
   randomised) behind `make_server` on port 0, driven with urllib:
   /api/health, one /api/generate at the defaults (1024^2, 30 steps,
   midpoint, CFG 4, t-shift 4; the main path of K1-K4, with calibration
   and K3; the calibration's seconds printed for each request that builds
   a sampler), then under LUMINA_FUSE_ROPE=1 one 1024^2 and one 512x2048
   request at 10 steps (the main path of K9: no K1-K4), and the 1024^2
   10-step request again unfused (a setting of its own: calibrated, K3),
   whose preview must agree with the fused one;
6. gradient: one loss + backward of the randomised 2B at 1024^2, B=2, 32
   caption tokens, `dots` remat, through the kernels, the plain versions and
   the plain sdpa; the kernels' gradient must lie within 1.5x the sdpa's
   distance from the plain versions (the bf16 floor);
7. recipe: 3 timed train steps of the flagship recipe (2B, 1024^2 latents,
   B=2, bf16, AdamW with its full fp32 state, dots remat, calibrated train
   bound) through `pipelines/train_lib`, with images/s and peak memory,
   then one step under `torch.profiler` (device time by kernel group: the
   first forward template's share, `csrc/flash_fwd.cu`);
8. trainer: the trainer CLI (`pipelines.train.main`, 2B at full width and
   depth, 1024^2 latents, B=2, bf16, --checkpointing, --flash_static_max
   auto, bf16 Adafactor so that two checkpoints fit the machine's disk-write
   limit) for 3 steps, then --auto_resume for a 4th step with
   LUMINA_FLASH_FUSED_BWD=0: the second main path, whose training kernel
   launches are counted; then `lumina infer --ckpt` on that checkpoint
   (10 steps, settings written to a temporary YAML file).
The line before the last is a JSON object of the kernels; the last line is
{"ok": true, "device": {...}}.
"""

import base64
import json
import math
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import zlib

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SM90_SOURCE = "lumina_t2x_tpu_torch/csrc/flash_fwd_sm90.cu"  # bf16 K1-K5, K9
SM90_BWD_SOURCE = "lumina_t2x_tpu_torch/csrc/flash_bwd_sm90.cu"  # bf16 K6-K8
ROTATE_SOURCE = "lumina_t2x_tpu_torch/csrc/rope_rotate.cu"  # K9's k
VPU_SOURCE = "lumina_t2x_tpu_torch/csrc/static_max_sm90.cu"  # K10, K11
MMA_SOURCE = "lumina_t2x_tpu_torch/csrc/mma_probe.cu"
TPU_KERNELS = "lumina_t2x_tpu/ops/flash_attention.py"
VPU_EXP = "exps/vpu_op_reduction.py"
KERNELS = {  # entry point -> (source, file:line of the Pallas kernel it replaces)
    "small_kv": (SM90_SOURCE, f"{TPU_KERNELS}:240"),       # _flash_small_kv_kernel
    "online": (SM90_SOURCE, f"{TPU_KERNELS}:228"),         # _flash_kernel_fused_sum
    "static_max": (SM90_SOURCE, f"{TPU_KERNELS}:66"),      # _flash_kernel_static_max
    "online_lse": (SM90_SOURCE, f"{TPU_KERNELS}:430"),     # _flash_kernel_res
    "static_max_lse": (SM90_SOURCE, f"{TPU_KERNELS}:446"),  # _flash_kernel_res_static_max
    "bwd_fused": (SM90_BWD_SOURCE, f"{TPU_KERNELS}:619"),  # _bwd_fused_kernel
    "bwd_dq": (SM90_BWD_SOURCE, f"{TPU_KERNELS}:552"),     # _bwd_dq_kernel
    "bwd_dkv": (SM90_BWD_SOURCE, f"{TPU_KERNELS}:584"),    # _bwd_dkv_kernel
    "rope": (SM90_SOURCE, f"{TPU_KERNELS}:956"),           # _flash_rope_kernel
    "rope_q": (SM90_SOURCE, f"{TPU_KERNELS}:963"),         # _flash_rope_q_kernel
    "rope_rotate": (ROTATE_SOURCE, f"{TPU_KERNELS}:949"),  # _rotate_tile of the k tiles
    "static_max_v0": (VPU_SOURCE, f"{VPU_EXP}:44"),        # _kernel_v0
    "static_max_v1": (VPU_SOURCE, f"{VPU_EXP}:64"),        # _kernel_v1
    "static_max_v2": (VPU_SOURCE, f"{VPU_EXP}:84"),        # _kernel_v2
    "static_max_v3": (VPU_SOURCE, f"{VPU_EXP}:106"),       # _kernel_v3
    "static_max_v4": (VPU_SOURCE, f"{VPU_EXP}:127"),       # _kernel_v4
    "mma_chain": (MMA_SOURCE, "exps/mxu_k_quantum.py:37"),  # _kernel
}
SAMPLER_KERNELS = ("small_kv", "online", "static_max", "online_lse")
ROPE_KERNELS = ("rope", "rope_q", "rope_rotate")
TRAIN_KERNELS = ("online_lse", "static_max_lse", "bwd_fused", "bwd_dq", "bwd_dkv")
B, S, H, D, CAP, TRAIN_CAP = 2, 4096, 32, 72, 256, 32
BF16_MAX, BF16_MEAN, FP32_MAX, LSE_MAX = 1e-2, 1e-3, 2e-3, 1e-3
# backward outputs, relative to the largest |reference| element: one bf16
# rounding of the output (8 mantissa bits); fp32 sums in another order
BWD_BF16_MAX, BWD_BF16_MEAN, BWD_FP32_MAX = 1e-2, 1e-3, 1e-4
GRAD_FLOOR_FACTOR = 1.5
# H100 SXM peaks (NVIDIA's data sheet, dense, at 700 W): bf16 tensor cores,
# fp32 outside them, device memory
PEAK_BF16, PEAK_FP32, HBM_BYTES_S = 989e12, 67e12, 3.35e12
# exp results per second on the special-function units: 16 per clock per SM x
# 132 SMs x ~1.83 GHz (the FlashAttention-3 paper's figure)
EXP_RATE = 3.9e12
# K12 against its plain version: fp32 sums in another order only
MMA_REL = 1e-4
PROMPT = "a photo of an astronaut riding a horse"


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def require(cond, msg):
    if not cond:
        raise SystemExit(f"FAILED: {msg}")


def time_ms(fn, reps=7):
    """Median milliseconds of one call, CUDA events, after one warm-up."""
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


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def least_time(nbytes, tensor_ops, dtype, fp32_ops=0):
    """The least time of the work: bytes moved once over the memory rate, or
    operations over the peak rate of their type, whichever is longer."""
    t_ops = tensor_ops / (PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32) + fp32_ops / PEAK_FP32
    t_bytes = nbytes / HBM_BYTES_S
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def attention_ops(q, k, products):
    """Multiply-add operations of `products` (Sq x Sk x D) products."""
    b, sq, hq, d = q.shape
    return 2 * products * b * hq * sq * k.shape[1] * d


def _sdpa(q, k, v, mask, scale):
    """One library call on (B, S, H, D) inputs (the yardstick; the port
    never calls it)."""
    attn_mask = None if mask is None else (mask != 0)[:, None, None, :]
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=attn_mask,
        scale=scale, enable_gqa=k.shape[2] != q.shape[2])


def top_kernel(fn):
    """Name of the device kernel that takes the longest in one call of fn
    (which library kernel the dispatcher picked)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):  # a trace now and then comes back without device events
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        timed = [(getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0),
                  e.key) for e in prof.key_averages()]
        timed = [t for t in timed if t[0] > 0]
        if timed:
            return max(timed)[1][:90]
    return "not traced"


def library_forward(q, k, v, mask, scale):
    fn = lambda: _sdpa(q, k, v, mask, scale)
    return {"library_ms": time_ms(fn), "library_kernel": top_kernel(fn)}


def library_forward_lse(q, k, v, mask, scale):
    """One library call that returns the output and the (B, H, Sq) fp32
    log-sum-exp, as K4/K5 do (K5's fixed bound is an implementation detail
    of the same function): aten's flash attention, which takes the timed
    case (bf16, no mask, as many kv heads as q heads). Returns its time,
    kernel and LSE."""
    assert mask is None and q.dtype == torch.bfloat16 and k.shape[2] == q.shape[2]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    fn = lambda: torch.ops.aten._scaled_dot_product_flash_attention(qt, kt, vt, scale=scale)
    return {"library_ms": time_ms(fn), "library_kernel": top_kernel(fn), "library_lse": fn()[1]}


def library_chain(a, w, iters, perturbations):
    """One library call that computes `mma_chain`'s function: the `iters`
    perturbed copies of a side by side along K times w stacked `iters`
    times, summed in fp32 and written in fp32 (`torch.mm` with `out_dtype`,
    cuBLAS). Returns its time, kernel and output."""
    a_cat = torch.cat([(a.float() + p).to(torch.bfloat16) for p in perturbations], dim=1)
    w_cat = w.repeat(iters, 1)
    fn = lambda: torch.mm(a_cat, w_cat, out_dtype=torch.float32)
    return {"library_ms": time_ms(fn), "library_kernel": top_kernel(fn), "library_out": fn()}


def library_backward(q, k, v, mask, dout, scale):
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = _sdpa(*leaves, mask, scale)
    grad_out = dout.transpose(1, 2)
    fn = lambda: torch.autograd.grad(out, leaves, grad_out, retain_graph=True)
    return {"library_ms": time_ms(fn, reps=5), "library_kernel": top_kernel(fn)}


def device_phase():
    if not torch.cuda.is_available():
        print("FAILED: torch.cuda.is_available() is false: this script needs an NVIDIA GPU",
              file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    phase("device", f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} visible, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")


def build_phase():
    """Every declared library (K1-K9, K10/K11, K12), all nvcc processes
    started together."""
    # importing a module that owns kernels declares its library
    from lumina_t2x_tpu_torch.exps import mxu_k_quantum, vpu_op_reduction
    from lumina_t2x_tpu_torch.ops import cuda_lib, flash_attention

    t0 = time.perf_counter()
    cuda_lib.build_libraries()
    phase("build", f"{time.perf_counter() - t0:.2f} s: " + "; ".join(
        f"{name} {'compiled with nvcc' if info['compiled'] else 'already built, loaded'} "
        f"({info['path']})" for name, info in cuda_lib.BUILD_INFO.items()))
    # the Hopper kernels of bf16 K1-K9, K10 and K11: their resources from
    # the CUDA runtime (K1, K4/K5 and K9 are K2/K3's instantiations, K4/K5
    # with an LSE pointer, K9 with rotation tables)
    for source, entry, info in (
            (SM90_SOURCE, "small_kv, online, online_lse, rope, rope_q",
             flash_attention.sm90_attributes(False, D)),
            (SM90_SOURCE, "static_max, static_max_lse", flash_attention.sm90_attributes(True, D)),
            (SM90_BWD_SOURCE, "bwd_fused", flash_attention.bwd_sm90_attributes("fused", D)),
            (SM90_BWD_SOURCE, "bwd_dkv", flash_attention.bwd_sm90_attributes("dkv", D)),
            (SM90_BWD_SOURCE, "bwd_dq", flash_attention.bwd_sm90_attributes("dq", D)),
            *((VPU_SOURCE, f"static_max_{variant}", vpu_op_reduction.sm90_attributes(variant, D))
              for variant in vpu_op_reduction.VARIANTS)):
        phase("build", f"{source} ({entry}, head_dim {D}): {info['registers']} registers per "
              f"thread as compiled, {info['producer_registers']} (producer) / "
              f"{info['consumer_registers']} (consumers) after setmaxnreg, "
              f"{info['local_bytes']} local (spill) bytes per thread, {info['shared_bytes']} bytes "
              f"of shared memory per block, {info['blocks_per_sm']} block(s) of "
              f"{info['threads']} threads per SM")
        require(info["local_bytes"] == 0, f"{source} ({entry}) spills")
    # K12 (no setmaxnreg: two consumer warpgroups, no producer) at the width
    # of its timed shape and of K=1024
    for kd, n in ((D, mxu_k_quantum.N_DEFAULT), (1024, mxu_k_quantum.N_DEFAULT)):
        info = mxu_k_quantum.attributes(mxu_k_quantum.M, n, kd)
        phase("build", f"{MMA_SOURCE} (mma_chain, K={kd}, N={n}: BN={info['bn']}, "
              f"{info['slices']} j-slices, {info['blocks']} blocks): {info['registers']} registers "
              f"per thread, {info['local_bytes']} local (spill) bytes per thread, "
              f"{info['shared_bytes']} bytes of shared memory per block, "
              f"{info['blocks_per_sm']} block(s) of {info['threads']} threads per SM")
        require(info["local_bytes"] == 0, f"{MMA_SOURCE} (K={kd}) spills")
    # ptxas reports a wgmma pipeline it had to serialize; print what it says
    for name in ("flash", "static_max_variants", "mma_probe"):
        notes = sorted({line.strip() for line in cuda_lib.BUILD_INFO[name]["ptxas"].splitlines()
                        if "wgmma" in line.lower()})
        phase("build", f"ptxas on {name}'s wgmma: " + ("; ".join(notes) if notes else "nothing"))


def _rand(g, *shape, dtype):
    return torch.randn(*shape, generator=g, device="cuda", dtype=torch.float32).to(dtype)


# (label, dtype, n_kv_heads, mask kind); the first is the timed main-path case
CASES = [("bf16", torch.bfloat16, H, "none"), ("fp32", torch.float32, H, "tail"),
         ("bf16 gqa8", torch.bfloat16, 8, "tail"), ("bf16 masked-row", torch.bfloat16, H, "row")]


def kernel_phase(fa):
    g = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    # (entry, Sk); the first case of each is the timed one. small_kv also runs
    # the served worker's captions and online_lse the training
    # cross-attention: one partial 64-key tile at Sk=32
    for entry, sk in (("small_kv", CAP), ("small_kv", TRAIN_CAP), ("online", S),
                      ("static_max", S), ("online_lse", S), ("online_lse", TRAIN_CAP),
                      ("static_max_lse", S)):
        kernel = getattr(fa, f"flash_{entry}")
        plain = getattr(fa, f"flash_{entry}_plain")
        worst, timed = results.get(entry, {}).get("max_abs_err", 0.0), None
        for label, dtype, hkv, mask_kind in CASES:
            q = _rand(g, B, S, H, D, dtype=dtype)
            k = _rand(g, B, sk, hkv, D, dtype=dtype)
            v = _rand(g, B, sk, hkv, D, dtype=dtype)
            mask = None
            if mask_kind != "none":
                mask = torch.ones(B, sk, dtype=torch.int32, device="cuda")
                mask[1, sk - sk // 5:] = 0
                if mask_kind == "row":
                    mask[1] = 0
            scale = D ** -0.5
            kw = {}
            if entry.startswith("static_max"):  # the calibrated bound: max row LSE + margin
                lse = fa.flash_online_lse_plain(q, k, v, mask, scale)[1]
                margin = 8.0 if entry == "static_max_lse" else 6.0
                kw = {"bound": float(lse[torch.isfinite(lse)].max()) + margin}
            got = kernel(q, k, v, mask, scale, **kw)
            ref = plain(q.float(), k.float(), v.float(), mask, scale, *kw.values())
            torch.cuda.synchronize()
            if entry.endswith("_lse"):
                (got, lse), (ref, ref_lse) = got, ref
                fin = torch.isfinite(ref_lse)
                require(torch.equal(fin, torch.isfinite(lse)), f"{entry} {label}: LSE -inf rows")
                lse_err = (lse[fin] - ref_lse[fin]).abs().max().item()
                require(lse_err <= LSE_MAX, f"{entry} {label}: LSE err {lse_err} > {LSE_MAX}")
            err = (got.float() - ref).abs()
            max_err, mean_err = err.max().item(), err.mean().item()
            bound = FP32_MAX if dtype == torch.float32 else BF16_MAX
            require(math.isfinite(max_err) and max_err <= bound,
                    f"{entry} {label}: max abs err {max_err} > {bound}")
            if dtype == torch.bfloat16:
                require(mean_err <= BF16_MEAN, f"{entry} {label}: mean abs err {mean_err}")
            if mask_kind == "row":
                require(torch.count_nonzero(got[1]).item() == 0, f"{entry}: masked row not 0")
            worst = max(worst, max_err)
            line = f"{entry} {label} (Sk={sk}): max abs err {max_err:.3g} mean {mean_err:.3g}"
            if entry.endswith("_lse"):
                line += f", LSE {lse_err:.3g}"
            if timed is None:
                timed = {"ms": time_ms(lambda: kernel(q, k, v, mask, scale, **kw)),
                         "plain_ms": time_ms(lambda: plain(q, k, v, mask, scale, *kw.values()))}
                lse_bytes = B * H * S * 4 if entry.endswith("_lse") else 0
                timed.update(least_time(_nbytes(q, k, v, mask, got) + lse_bytes,
                                        attention_ops(q, k, 2), dtype))
                if entry.endswith("_lse"):
                    timed.update(library_forward_lse(q, k, v, mask, scale))
                    lib_lse = timed.pop("library_lse")
                    line += ("; library LSE vs plain max diff "
                             + (f"{(lib_lse[fin] - ref_lse[fin]).abs().max().item():.3g}"
                                if lib_lse.shape == ref_lse.shape
                                else f"not compared (shape {tuple(lib_lse.shape)})"))
                else:
                    timed.update(library_forward(q, k, v, mask, scale))
                line += (f"; kernel {timed['ms']:.3f} ms, plain {timed['plain_ms']:.3f} ms, bound "
                         f"{timed['bound_ms']:.4f} ms ({timed['bound_by']}), library "
                         f"{timed['library_ms']:.3f} ms ({timed['library_kernel']})")
            phase("kernels", line)
            del q, k, v, got, ref
        # a second shape of an entry is printed above; the kernels line keeps the first's times
        results[entry] = {**timed, **results.get(entry, {}), "max_abs_err": worst}
    # K4/K5 run K2/K3's kernel with the LSE written in its epilogue
    phase("kernels", "bf16 LSE forwards against the same kernel without the LSE, this run: "
          + ", ".join(f"{lse} / {base} {results[lse]['ms'] / results[base]['ms']:.3f}x"
                      for lse, base in (("online_lse", "online"),
                                        ("static_max_lse", "static_max"))))
    return results


# (label, dtype, sk, n_kv_heads, mask kind); the first is the timed main-path case
BWD_CASES = [("bf16", torch.bfloat16, S, H, "none"), ("fp32", torch.float32, S, H, "tail"),
             ("bf16 gqa8", torch.bfloat16, S, 8, "tail"),
             ("bf16 masked-row", torch.bfloat16, S, H, "row"),
             ("bf16 cross-attention", torch.bfloat16, TRAIN_CAP, H, "tail")]


def _bwd_bounds(q, k, v, out, dout, lse, dtype):
    """Least times of K6, K7 and K8: read q, k, v, out, dO, LSE once; write
    what the kernel writes; 5, 3 and 4 Sq x Sk x D products."""
    reads = _nbytes(q, k, v, out, dout, lse)
    return {"bwd_fused": least_time(reads + _nbytes(q, k, v), attention_ops(q, k, 5), dtype),
            "bwd_dq": least_time(reads + _nbytes(q), attention_ops(q, k, 3), dtype),
            "bwd_dkv": least_time(reads + _nbytes(k, v), attention_ops(q, k, 4), dtype)}


def backward_kernel_phase(fa):
    """K6 and K7 + K8 against `flash_bwd_plain` on the same inputs (q, k, v,
    dO, and out/LSE from the plain LSE forward); all three also timed at the
    cross-attention's Sk=32."""
    g = torch.Generator(device="cuda").manual_seed(1)
    worst = {name: 0.0 for name in ("bwd_fused", "bwd_dq", "bwd_dkv")}
    times = {}
    for label, dtype, sk, hkv, mask_kind in BWD_CASES:
        q = _rand(g, B, S, H, D, dtype=dtype)
        k = _rand(g, B, sk, hkv, D, dtype=dtype)
        v = _rand(g, B, sk, hkv, D, dtype=dtype)
        dout = _rand(g, B, S, H, D, dtype=dtype)
        mask = None
        if mask_kind != "none":
            mask = torch.ones(B, sk, dtype=torch.int32, device="cuda")
            mask[1, sk - sk // 5:] = 0
            if mask_kind == "row":
                mask[1] = 0
        scale = D ** -0.5
        out, lse = fa.flash_online_lse_plain(q, k, v, mask, scale)
        args = (q, k, v, mask, out, lse, dout, scale)
        ref = fa.flash_bwd_plain(*args)
        got = {"bwd_fused": fa.flash_bwd_fused(*args),
               "bwd_dq": (fa.flash_bwd_dq(*args), None, None),
               "bwd_dkv": (None, *fa.flash_bwd_dkv(*args))}
        torch.cuda.synchronize()
        parts = []
        for name, outs in got.items():
            for grad, r, what in zip(outs, ref, ("dq", "dk", "dv")):
                if grad is None:
                    continue
                require(grad.dtype == r.dtype and grad.shape == r.shape, f"{name} {what} dtype/shape")
                top = max(r.float().abs().max().item(), 1e-30)
                err = (grad.float() - r.float()).abs()
                rel_max, rel_mean = err.max().item() / top, err.mean().item() / top
                bound = BWD_FP32_MAX if dtype == torch.float32 else BWD_BF16_MAX
                require(math.isfinite(rel_max) and rel_max <= bound,
                        f"{name} {what} {label}: max err {rel_max} of max|ref| > {bound}")
                if dtype == torch.bfloat16:
                    require(rel_mean <= BWD_BF16_MEAN, f"{name} {what} {label}: mean err {rel_mean}")
                if mask_kind == "row":
                    require(torch.count_nonzero(grad[1]).item() == 0,
                            f"{name} {what}: fully masked row not 0")
                worst[name] = max(worst[name], err.max().item())
                parts.append(f"{name}.{what} {rel_max:.2g}")
        line = f"backward {label} (Sk={sk}): max err / max|ref| " + ", ".join(parts)
        if not times:
            for name, fn in (("bwd_fused", fa.flash_bwd_fused), ("bwd_dq", fa.flash_bwd_dq),
                             ("bwd_dkv", fa.flash_bwd_dkv)):
                times[name] = time_ms(lambda: fn(*args), reps=5)
            times["plain"] = time_ms(lambda: fa.flash_bwd_plain(*args), reps=5)
            bounds = _bwd_bounds(q, k, v, out, dout, lse, dtype)
            library = library_backward(q, k, v, mask, dout, scale)
            line += ("; " + ", ".join(f"{n} {t:.3f} ms" for n, t in times.items())
                     + "; bounds " + ", ".join(f"{n} {b_['bound_ms']:.4f} ms ({b_['bound_by']})"
                                              for n, b_ in bounds.items())
                     + f"; library backward {library['library_ms']:.3f} ms "
                       f"({library['library_kernel']})")
        elif sk == TRAIN_CAP:  # the trainer's cross-attention: 24 of K6's (K7's) launches a step
            cross = _bwd_bounds(q, k, v, out, dout, lse, dtype)
            line += "; " + ", ".join(
                f"{name} {time_ms(lambda: fn(*args), reps=5):.3f} ms (bound "
                f"{cross[name]['bound_ms']:.4f} ms, {cross[name]['bound_by']})"
                for name, fn in (("bwd_fused", fa.flash_bwd_fused), ("bwd_dq", fa.flash_bwd_dq),
                                 ("bwd_dkv", fa.flash_bwd_dkv)))
            line += (f"; plain {time_ms(lambda: fa.flash_bwd_plain(*args), reps=5):.3f} ms; "
                     f"library backward "
                     f"{library_backward(q, k, v, mask, dout, scale)['library_ms']:.3f} ms")
        phase("kernels", line)
        del q, k, v, dout, out, lse, args, ref, got
        torch.cuda.empty_cache()
    return {name: {"max_abs_err": worst[name], "ms": times[name], "plain_ms": times["plain"],
                   **bounds[name], **library} for name in worst}


def rope_angles_2b():
    """The 2B's RoPE angles at 1024^2: a 64 x 64 token grid, (4096, 36)."""
    from lumina_t2x_tpu_torch.ops.rope import rope_angles_2d

    return rope_angles_2d(D, 64, 64, device="cuda").reshape(S, D // 2)


def rope_kernel_phase(fa):
    """K9 (`flash_rope`, `flash_rope_q`) against its plain version (the
    rotation in the operand dtype, then the fp32 softmax); against itself on
    `apply_rope`d inputs at zero angles; bit for bit against the unfused
    entry point the same call takes on `apply_rope`d inputs (`flash_online`
    for `rope` at Sk=4096, `flash_small_kv` for `rope_q` at the captions'
    Sk: K9 runs that entry point's kernel, with q rotated inside it exactly
    as `apply_rope` rotates, and k by `rope_rotate`), timed beside it;
    `rope_rotate` against `apply_rope` bit for bit on the 2B's k, timed; and
    `_FlashAttentionRope`'s gradient through the kernels against the plain
    Function. The bf16 forward bar is 1e-2 of max(1, max|ref|): the
    absolute 1e-2 where outputs stay below 1 (every Sk=4096 case), one bf16
    output rounding above it (Sk=32 outputs reach [4, 8), where half an ulp
    is 1.6e-2)."""
    from lumina_t2x_tpu_torch.ops.rope import apply_rope

    g = torch.Generator(device="cuda").manual_seed(5)
    angles = rope_angles_2b()
    scale = D ** -0.5
    results = {}
    for entry, sk in (("rope", S), ("rope_q", TRAIN_CAP), ("rope_q", CAP)):
        kernel = getattr(fa, f"flash_{entry}")
        unfused = "online" if entry == "rope" else "small_kv"  # what the same call takes unfused
        prev = results.get(entry, {"max_abs_err": 0.0, "ms": None})
        worst = prev["max_abs_err"]
        for label, dtype, hkv, mask_kind in CASES:
            q = _rand(g, B, S, H, D, dtype=dtype)
            k = _rand(g, B, sk, hkv, D, dtype=dtype)
            v = _rand(g, B, sk, hkv, D, dtype=dtype)
            mask = None
            if mask_kind != "none":
                mask = torch.ones(B, sk, dtype=torch.int32, device="cuda")
                mask[1, sk - sk // 5:] = 0
                if mask_kind == "row":
                    mask[1] = 0
            got = kernel(q, k, v, angles, mask, scale)
            q_rot = apply_rope(q, angles)
            k_rot = apply_rope(k, angles) if entry == "rope" else k
            ref = fa.flash_online_plain(q_rot.float(), k_rot.float(), v.float(), mask, scale)
            zero = kernel(q_rot, k_rot, v, torch.zeros_like(angles), mask, scale)
            same = getattr(fa, f"flash_{unfused}")(q_rot, k_rot, v, mask, scale)
            torch.cuda.synchronize()
            err = (got.float() - ref).abs()
            max_err, mean_err = err.max().item(), err.mean().item()
            top = max(1.0, ref.abs().max().item())
            bar = FP32_MAX if dtype == torch.float32 else BF16_MAX * top
            require(math.isfinite(max_err) and max_err <= bar,
                    f"{entry} {label} (Sk={sk}): max abs err {max_err} > {bar}")
            if dtype == torch.bfloat16:
                require(mean_err <= BF16_MEAN, f"{entry} {label}: mean abs err {mean_err}")
            if mask_kind == "row":
                require(torch.count_nonzero(got[1]).item() == 0, f"{entry}: masked row not 0")
            require(torch.equal(got, zero), f"{entry} {label}: K9 on rotated inputs at zero "
                    f"angles is not K9 on the unrotated ones bit for bit")
            require(torch.equal(got, same), f"{entry} {label} (Sk={sk}): not flash_{unfused} on "
                    f"apply_rope'd inputs bit for bit (max diff "
                    f"{(got.float() - same.float()).abs().max().item():.3g})")
            worst = max(worst, max_err)
            line = (f"{entry} {label} (Sk={sk}, Hkv={hkv}): max abs err {max_err:.3g} (bar "
                    f"{bar:.3g}) mean {mean_err:.3g}; equal bit for bit to itself at zero angles "
                    f"and to flash_{unfused} on apply_rope'd inputs")
            if prev["ms"] is None and "ms" not in results.get(entry, {}):
                ms = time_ms(lambda: kernel(q, k, v, angles, mask, scale))
                plain_ms = time_ms(lambda: getattr(fa, f"flash_{entry}_plain")(
                    q, k, v, angles, mask, scale))
                unfused_ms = time_ms(lambda: getattr(fa, f"flash_{unfused}")(
                    q_rot, k_rot, v, mask, scale))
                # q, k, v, the two (S, D) fp32 tables read once, out written;
                # the rotation: a multiply, a multiply and an add per element
                rotated = q.numel() + (k.numel() if entry == "rope" else 0)
                extra = least_time(_nbytes(q, k, v, mask, got) + 2 * S * D * 4,
                                   attention_ops(q, k, 2), dtype, fp32_ops=3 * rotated)
                results[entry] = {"ms": ms, "plain_ms": plain_ms, "unfused_ms": unfused_ms,
                                  **extra, "library_ms": None, "library_kernel": "none"}
                line += (f"; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, flash_{unfused} on "
                         f"rotated inputs {unfused_ms:.3f} ms, bound {extra['bound_ms']:.4f} ms "
                         f"({extra['bound_by']}), library none")
            phase("kernels", line)
            del q, k, v, got, ref, zero, same, q_rot, k_rot
        results[entry]["max_abs_err"] = worst
    torch.cuda.empty_cache()

    # rope_rotate on the 2B's k (B, S, H, D) bf16, and in fp32 on a GQA k
    # with a ragged head count
    worst = 0.0
    for label, dtype, hkv in (("bf16", torch.bfloat16, H), ("fp32 gqa8", torch.float32, 8)):
        k = _rand(g, B, S, hkv, D, dtype=dtype)
        got = fa.rope_rotate(k, angles)
        ref = apply_rope(k, angles)
        torch.cuda.synchronize()
        diff = (got.float() - ref.float()).abs().max().item()
        require(torch.equal(got, ref), f"rope_rotate {label}: not apply_rope bit for bit ({diff})")
        line = f"rope_rotate {label} (B={B}, S={S}, Hkv={hkv}, D={D}): equal to apply_rope"
        if "rope_rotate" not in results:
            # bursts of calls: the wrapper's host work runs while the queued launches do
            burst = 8
            ms = time_ms(lambda: [fa.rope_rotate(k, angles) for _ in range(burst)]) / burst
            plain_ms = time_ms(lambda: apply_rope(k, angles))
            # k read once and written once, the two (S, D) fp32 tables read once
            extra = least_time(2 * _nbytes(k) + 2 * S * D * 4, 0, dtype, fp32_ops=3 * k.numel())
            results["rope_rotate"] = {"ms": ms, "plain_ms": plain_ms, **extra,
                                      "library_ms": None, "library_kernel": "none"}
            line += (f"; kernel {ms:.4f} ms (bursts of {burst}), plain {plain_ms:.3f} ms, bound "
                     f"{extra['bound_ms']:.4f} ms ({extra['bound_by']}), library none")
        phase("kernels", line)
        worst = max(worst, diff)
        del k, got, ref
    results["rope_rotate"]["max_abs_err"] = worst

    for entry, sk, hkv, mask_kind in (("rope", S, H, "none"), ("rope_q", TRAIN_CAP, 8, "tail")):
        q = _rand(g, B, S, H, D, dtype=torch.bfloat16)
        k = _rand(g, B, sk, hkv, D, dtype=torch.bfloat16)
        v = _rand(g, B, sk, hkv, D, dtype=torch.bfloat16)
        dout = _rand(g, B, S, H, D, dtype=torch.bfloat16)
        mask = None
        if mask_kind == "tail":
            mask = torch.ones(B, sk, dtype=torch.int32, device="cuda")
            mask[1, sk - sk // 5:] = 0
        grads = {}
        for impl, fn in (("kernels", fa.flash_attention_rope),
                         ("plain", fa.flash_attention_rope_plain)):
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            fn(*leaves, angles, mask, scale, rotate_k=entry == "rope").backward(dout)
            grads[impl] = [t.grad for t in leaves]
        torch.cuda.synchronize()
        parts = []
        for what, got, ref in zip(("dq", "dk", "dv"), grads["kernels"], grads["plain"]):
            top = max(ref.float().abs().max().item(), 1e-30)
            err = (got.float() - ref.float()).abs()
            rel_max, rel_mean = err.max().item() / top, err.mean().item() / top
            require(math.isfinite(rel_max) and rel_max <= BWD_BF16_MAX,
                    f"{entry} gradient {what}: max err {rel_max} of max|ref|")
            require(rel_mean <= BWD_BF16_MEAN, f"{entry} gradient {what}: mean err {rel_mean}")
            parts.append(f"{what} {rel_max:.2g}")
        phase("kernels", f"_FlashAttentionRope gradient ({entry}, bf16, Sk={sk}, Hkv={hkv}, "
              f"mask {mask_kind}), kernels vs plain Function: max err / max|ref| "
              + ", ".join(parts))
        del q, k, v, dout, grads
        torch.cuda.empty_cache()
    return results


# (label, batch, seq, heads, masked keys at the end of batch row 1); the first
# is the experiment's timed shape
EXP_CASES = [("B2/S4096/H32/D72, all keys valid", B, S, H, 0),
             ("B2/S1000/H8/D72, ragged tiles, last 200 keys of row 1 masked", 2, 1000, 8, 200)]
# (K, N) of the K12 checks at M=1024, 8 iterations; then a ragged tile
MMA_CHECKS = [(8, 1024), (72, 1024), (80, 1024), (1024, 1024), (1024, 72), (80, 72)]


def experiments_phase():
    """K10 (`static_max_v0..v3`), K11 (`static_max_v4`) and K12
    (`mma_chain`) against their plain versions on the card, K11 against v1
    (its serial anchor) bit for bit, the five variants timed side by side,
    the kernels' static SASS counts; then both experiment `main()`s at their
    full shapes, whose launches are counted. Returns the kernels' results
    and launch counts."""
    from lumina_t2x_tpu_torch import exps
    from lumina_t2x_tpu_torch.exps import mxu_k_quantum as mxu
    from lumina_t2x_tpu_torch.exps import vpu_op_reduction as vpu
    from lumina_t2x_tpu_torch.ops import cuda_lib

    t_phase = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(7)
    scale = D ** -0.5
    results = {}
    for label, b, s, h, tail in EXP_CASES:
        q, k, v = (_rand(g, b, s, h, D, dtype=torch.bfloat16) for _ in range(3))
        mask = torch.ones(b, s, dtype=torch.int32, device="cuda")
        if tail:
            mask[1, s - tail:] = 0
        outs, parts = {}, []
        for variant in vpu.VARIANTS:
            name = f"static_max_{variant}"
            kernel, plain = vpu.ENTRIES[variant], vpu.PLAIN[variant]
            got = kernel(q, k, v, mask, scale, vpu.BOUND)
            ref = plain(q, k, v, mask, scale, vpu.BOUND)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs()
            max_err, mean_err = err.max().item(), err.mean().item()
            require(math.isfinite(max_err) and max_err <= BF16_MAX and mean_err <= BF16_MEAN,
                    f"{name} {label}: max abs err {max_err}, mean {mean_err}")
            outs[variant] = got
            entry = results.setdefault(name, {"max_abs_err": 0.0})
            entry["max_abs_err"] = max(entry["max_abs_err"], max_err)
            part = f"{variant} err {max_err:.3g}/{mean_err:.3g}"
            if not tail:  # the timed shape
                entry["ms"] = time_ms(lambda: kernel(q, k, v, mask, scale, vpu.BOUND))
                entry["plain_ms"] = time_ms(lambda: plain(q, k, v, mask, scale, vpu.BOUND), reps=3)
                entry.update(least_time(_nbytes(q, k, v, mask, got), attention_ops(q, k, 2),
                                        torch.bfloat16))
                part += f" {entry['ms']:.3f} ms (plain {entry['plain_ms']:.3f})"
            parts.append(part)
            del got, ref
        # K11 against v1, its serial anchor: the same products in the same
        # order, so bit for bit
        require(torch.equal(outs["v4"], outs["v1"]),
                f"static_max_v4 {label}: not equal to v1 bit for bit")
        line = (f"static-max variants {label}: " + ", ".join(parts)
                + "; v4 equal to v1 bit for bit")
        if not tail:
            library = library_forward(q, k, v, None, scale)  # all keys valid: the unmasked call
            exp_floor = 1e3 * b * h * s * s / EXP_RATE
            for variant in vpu.VARIANTS:
                results[f"static_max_{variant}"].update(library)
            # the five in turns, forward then backward, on the same inputs
            turns = {variant: [] for variant in vpu.VARIANTS}
            for order in (vpu.VARIANTS, vpu.VARIANTS[::-1]):
                for variant in order:
                    turns[variant].append(time_ms(
                        lambda: vpu.ENTRIES[variant](q, k, v, mask, scale, vpu.BOUND)))
            side = {variant: statistics.median(ms) for variant, ms in turns.items()}
            line += (f"; bound {results['static_max_v0']['bound_ms']:.4f} ms "
                     f"({results['static_max_v0']['bound_by']}), exp floor {exp_floor:.4f} ms, "
                     f"library {library['library_ms']:.3f} ms ({library['library_kernel']}); "
                     f"side by side (two turns each): "
                     + ", ".join(f"{variant} {side[variant]:.3f} ms "
                                 f"{[round(x, 4) for x in turns[variant]]}"
                                 for variant in vpu.VARIANTS)
                     + f"; v4 {100 * (1 - side['v4'] / side['v1']):+.1f}% vs v1 (its anchor), "
                       f"v2 {100 * (1 - side['v2'] / side['v1']):+.1f}% vs v1")
        phase("experiments", line)
        del q, k, v, outs
        torch.cuda.empty_cache()
    sass = vpu.sass_counts()
    for variant, counts in sass.items():
        phase("experiments", f"SASS static_max_{variant} (QK^T depth 80): "
              + ", ".join(f"{op} {n}" for op, n in counts.items()))
    require(set(sass) == set(vpu.VARIANTS), f"SASS of the variants not found: {sorted(sass)}")
    for variant in vpu.VARIANTS:
        require(sass[variant]["HGMMA"] > 0 and sass[variant]["HMMA"] == 0,
                f"static_max_{variant} does not run on wgmma alone")
    probe = {name: ops for name, ops in
             cuda_lib.dump_sass(cuda_lib.BUILD_INFO[mxu.LIBRARY]["path"]).items()
             if "mma_chain_kernel" in name}
    hgmma = sum(op.startswith("HGMMA") for ops in probe.values() for op in ops)
    hmma = sum(op == "HMMA" or op.startswith("HMMA.") for ops in probe.values() for op in ops)
    phase("experiments", f"SASS mma_chain ({len(probe)} widths): HGMMA {hgmma}, HMMA {hmma}")
    require(len(probe) == len(mxu.WIDTHS) and hgmma >= len(probe) and hmma == 0,
            "mma_chain does not run on wgmma alone")

    worst = 0.0
    for kd, n in MMA_CHECKS + [(40, 20)]:
        m = 100 if (kd, n) == (40, 20) else mxu.M
        a = (1e-2 * torch.randn(m, kd, generator=g, device="cuda")).to(torch.bfloat16)
        w = torch.randn(kd, n, generator=g, device="cuda").to(torch.bfloat16)
        got, ref = mxu.mma_chain(a, w, 8), mxu.mma_chain_plain(a, w, 8)
        torch.cuda.synchronize()
        rel = (got - ref).abs().max().item() / ref.abs().max().item()
        require(math.isfinite(rel) and rel <= MMA_REL, f"mma_chain M={m} K={kd} N={n}: {rel}")
        worst = max(worst, (got - ref).abs().max().item())
        plan = mxu.plan(m, n, kd, 8, torch.cuda.get_device_properties(0).multi_processor_count)
        phase("experiments", f"mma_chain M={m} K={kd} N={n}, 8 iterations (BN={plan['bn']}, "
              f"{plan['slices']} j-slices, {plan['blocks']} blocks): max err / max|ref| {rel:.3g}")
    kd, n, iters = D, mxu.N_DEFAULT, mxu.ITERS  # head_dim 72 as the depth
    a = torch.randn(mxu.M, kd, generator=g, device="cuda").to(torch.bfloat16)
    w = torch.randn(kd, n, generator=g, device="cuda").to(torch.bfloat16)
    got = mxu.mma_chain(a, w, iters)
    plan = mxu.plan(mxu.M, n, kd, iters, torch.cuda.get_device_properties(0).multi_processor_count)
    # bursts of calls: the wrapper's host work (about half the kernel's time)
    # runs while the queued launches do
    burst = 8
    entry = {"max_abs_err": worst,
             "ms": time_ms(lambda: [mxu.mma_chain(a, w, iters) for _ in range(burst)]) / burst,
             "plain_ms": time_ms(lambda: mxu.mma_chain_plain(a, w, iters), reps=3),
             **least_time(_nbytes(a, w) + 4 * mxu.M * n, 2 * mxu.M * n * kd * iters,
                          torch.bfloat16),
             **library_chain(a, w, iters, mxu.perturbations(iters))}
    lib_rel = (entry.pop("library_out") - got).abs().max().item() / got.abs().max().item()
    # one small call per product instead: launch-bound, so only a note
    per_call = iters * time_ms(lambda: torch.matmul(a, w))
    results["mma_chain"] = entry
    device = exps.device_ms(lambda: mxu.mma_chain(a, w, iters), "mma_chain")
    phase("experiments", f"mma_chain M={mxu.M} K={kd} N={n}, {iters} iterations: kernel "
          f"{entry['ms']:.4f} ms (bursts of {burst}; one call "
          f"{time_ms(lambda: mxu.mma_chain(a, w, iters)):.4f}, device time "
          f"{device if device is None else round(device, 4)}), plain {entry['plain_ms']:.3f} ms, "
          f"bound {entry['bound_ms']:.4f} ms ({entry['bound_by']}), library {entry['library_ms']:.3f} ms "
          f"(one torch.mm over K={iters}x{kd}: {entry['library_kernel']}; max diff from the "
          f"kernel's output / its max {lib_rel:.3g}); torch.matmul per product x {iters}: "
          f"{per_call:.3f} ms (launch-bound); plan: BN={plan['bn']}, {plan['slices']} j-slices, "
          f"{plan['blocks']} blocks")
    del a, w, got
    torch.cuda.empty_cache()

    vpu.reset_launch_counts()
    mxu.reset_launch_counts()
    t0 = time.perf_counter()
    vpu.main(["--device", "cuda"])
    mxu.main(["--device", "cuda"])
    torch.cuda.synchronize()
    launches = {**vpu.LAUNCHES, **mxu.LAUNCHES}
    phase("experiments", f"both experiment main()s at their full shapes: "
          f"{time.perf_counter() - t0:.1f} s; launches {launches}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    for name, count in launches.items():
        require(count > 0, f"kernel {name} was not launched by the experiments")
    torch.cuda.empty_cache()
    return results, launches


def _randomise_zero_init(model, seed):
    """0.02 * N(0, 1) into every all-zero tensor (final layer, adaLN, caption
    projection, gates): a freshly initialised NextDiT outputs exactly 0."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    n = 0
    with torch.no_grad():
        for p in model.parameters():
            if not torch.any(p):
                p.copy_(0.02 * torch.randn(p.shape, generator=g, device="cuda"))
                n += 1
    return n


def forward_phase(fa):
    from lumina_t2x_tpu_torch.models import get_model
    from lumina_t2x_tpu_torch.models.next_dit import forward_with_cfg

    torch.manual_seed(0)
    model = get_model("NextDiT_2B_patch2", qk_norm=True, cap_feat_dim=2048,
                      dtype=torch.bfloat16, device="cuda").eval()
    n = _randomise_zero_init(model, 1)
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(1, 4, 128, 128, generator=g, device="cuda").repeat(2, 1, 1, 1)
    cap = torch.randn(2, CAP, 2048, generator=g, device="cuda")
    cap_mask = torch.ones(2, CAP, dtype=torch.int32, device="cuda")  # as the sampler CLI
    t = torch.zeros(2, device="cuda")  # the first point of the time grid
    outs = {}
    with torch.no_grad():
        for impl in ("flash", "plain", "xla"):
            model.set_attn_impl(impl)
            outs[impl] = forward_with_cfg(model, x, t, cap, cap_mask, 4.0)
        model.set_attn_impl("auto")
    torch.cuda.synchronize()
    fast, ref = outs["flash"], outs["plain"]
    require(fast.shape == (2, 4, 128, 128) and bool(torch.isfinite(fast).all()),
            "2B forward: bad shape or non-finite output")
    rel = ((fast - ref).norm() / ref.norm()).item()
    # bf16 noise floor: the plain sdpa (bf16 probabilities) is another correct
    # bf16 attention; every bf16 rounding downstream turns a difference d into
    # ~sqrt(d * ulp), so any two correct paths end about this far apart
    floor = ((outs["xla"] - ref).norm() / ref.norm()).item()
    phase("forward", f"NextDiT_2B_patch2 ({sum(p.numel() for p in model.parameters()) / 1e9:.3f}B "
          f"params, {n} zero-init tensors randomised) CFG forward at 1024^2, {CAP} caption "
          f"tokens, bf16: rel L2 kernels vs plain {rel:.4g} (sdpa vs plain {floor:.4g})")
    require(rel <= 2e-2, f"2B forward rel L2 {rel} > 2e-2")
    return model, cap, cap_mask


def slice_phase(fa, model, cap, cap_mask):
    from lumina_t2x_tpu_torch.pipelines.sample_lib import (autocalibrate_flash_static_max,
                                                           build_t2i_sample_fn)

    kw = dict(width=1024, height=1024, cfg_scale=4.0, time_shifting_factor=4.0)
    g = torch.Generator(device="cuda").manual_seed(3)
    before = fa.LAUNCHES["online_lse"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bound = autocalibrate_flash_static_max(model, cap, cap_mask, generator=g, **kw)
    torch.cuda.synchronize()
    calib = time.perf_counter() - t0
    require(bound is not None and math.isfinite(bound), "calibration declined at 2B")
    phase("slice", f"flash static-max calibrated: {bound:.4f} in {calib:.3f} s "
          f"({fa.LAUNCHES['online_lse'] - before} K4 calls)")
    sample_fn = build_t2i_sample_fn(model, num_steps=30, solver="midpoint", static_max=bound, **kw)
    z = torch.randn(1, 4, 128, 128, generator=g, device="cuda")
    torch.cuda.synchronize()  # the forward phase and the probe warmed up every path
    t0 = time.perf_counter()
    latents = sample_fn(z, cap, cap_mask)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    require(latents.shape == (1, 4, 128, 128) and bool(torch.isfinite(latents).all()),
            "trajectory latents not finite")
    phase("slice", f"sample_lib 30-point midpoint, CFG 4, batch 1, 1024^2, {CAP} caption "
          f"tokens: {total:.3f} s, {1000 * total / 29:.2f} ms/step (2 CFG forwards at "
          f"batch 2), {1 / total:.4f} samples/s; latents finite, std {latents.std().item():.3f}")
    del model, sample_fn
    torch.cuda.empty_cache()


def lumina_infer(fa, label, extra_argv, config=None, steps=30):
    """`lumina infer` (the port's CLI, `pipelines.sample.main` underneath)
    into a temporary directory; checks the latents and returns the launch
    counts."""
    from lumina_t2x_tpu_torch.cli import entry_point

    with tempfile.TemporaryDirectory() as out_dir:
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        manifest = entry_point.main(["infer", PROMPT, out_dir, "--device", "cuda",
                                     "-c", config or os.path.join(ROOT, "configs/infer/settings.yaml"),
                                     *extra_argv])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(fa.LAUNCHES)
        plain_calls = fa.PLAIN_CUDA_CALLS["count"]
        items = manifest["items"]
        lat = np.load(items[0]["path"])
    require(len(items) == 1 and items[0]["steps"] == steps, f"{label}: manifest {items}")
    require(lat.shape == (4, 128, 128) and np.isfinite(lat).all(), f"{label}: latents not finite")
    require(plain_calls == 0, f"{label}: plain versions ran {plain_calls} times on CUDA")
    phase("cli", f"{label}: {manifest['args']['model']}, qk_norm {manifest['args']['qk_norm']}, "
          f"{steps} steps, latents {lat.shape} finite, std {lat.std():.3f}; wall {wall:.1f} s incl. "
          f"model set-up; launches {launches}; plain-version CUDA calls {plain_calls}")
    return launches


def cli_phase(fa):
    """`lumina infer "prompt" out --debug` at the repo's settings (2B, 1024^2,
    30 midpoint steps, CFG 4, t-shift 4; no --qk_norm, as the JAX CLI)."""
    launches = lumina_infer(fa, "lumina infer --debug", ["--debug"])
    require(launches["small_kv"] > 0 and launches["online"] > 0,
            "lumina infer did not run the attention kernels")


def _png_pixels(png):
    """RGB pixels of a PNG with one 8-bit RGB IDAT stream of filter-0 rows
    (what the server writes)."""
    require(png[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG")
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(png):
        n, tag = struct.unpack(">I4s", png[pos:pos + 8])
        data = png[pos + 8:pos + 8 + n]
        require(zlib.crc32(tag + data) & 0xFFFFFFFF == struct.unpack(">I", png[pos + 8 + n:pos + 12 + n])[0],
                f"PNG chunk {tag} CRC")
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", data[:10])
            require(depth == 8 and ctype == 2, f"PNG depth {depth} color type {ctype}")
        elif tag == b"IDAT":
            idat += data
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    require(not rows[:, 0].any(), "PNG rows not filter 0")
    return rows[:, 1:].reshape(h, w, 3)


def serving_phase(fa):
    """The 2B served over HTTP on the card: returns the launch counts of its
    main paths (K1-K4 from the default request, K9 from the fused ones)."""
    from lumina_t2x_tpu_torch.pipelines import sample_lib
    from lumina_t2x_tpu_torch.pipelines.demo import build_worker
    from lumina_t2x_tpu_torch.pipelines.serve import DemoApp, make_server

    t0 = time.perf_counter()
    worker = build_worker("NextDiT_2B_patch2", "bf16", debug=True, device="cuda")
    n = _randomise_zero_init(worker.model, 1)
    server = make_server(DemoApp(worker, model_name="NextDiT_2B_patch2"), port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    phase("serve", f"build_worker NextDiT_2B_patch2 bf16 --debug ({n} zero-init tensors "
          f"randomised) and server up in {time.perf_counter() - t0:.1f} s at {url}")

    # the worker calibrates each new setting (`demo.InferenceWorker._build_sampler`
    # looks the probe up at call time): its seconds, timed around it here
    calibrations, probe = [], sample_lib.autocalibrate_flash_static_max

    def timed_probe(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bound = probe(*args, **kwargs)
        torch.cuda.synchronize()
        calibrations.append(time.perf_counter() - t0)
        return bound

    def post(body):
        fa.reset_launch_counts()
        calibrations.clear()
        req = urllib.request.Request(url + "/api/generate", data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=900) as resp:
            status, payload = resp.status, json.loads(resp.read())
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches, plain_calls = dict(fa.LAUNCHES), fa.PLAIN_CUDA_CALLS["count"]
        require(status == 200, f"/api/generate {body}: HTTP {status}")
        pixels = _png_pixels(base64.b64decode(payload["image_png_b64"]))
        w, h = (int(x) for x in body.get("resolution", "1024x1024").split("x"))
        require(pixels.shape == (h // 8, w // 8, 3), f"preview shape {pixels.shape}")
        require(plain_calls == 0, f"{body}: plain versions ran {plain_calls} times on CUDA")
        calib = (f"calibration {calibrations[0]:.3f} s" if calibrations
                 else "no calibration (a cached setting)")
        phase("serve", f"POST /api/generate {body}: {secs:.2f} s (server-side "
              f"{payload['metadata']['elapsed_s']} s; {calib}), PNG {w // 8}x{h // 8}; launches "
              f"{ {k: v for k, v in launches.items() if v} }; plain-version CUDA calls {plain_calls}")
        return launches, pixels

    sample_lib.autocalibrate_flash_static_max = timed_probe
    try:
        with urllib.request.urlopen(url + "/api/health", timeout=60) as resp:
            health = json.loads(resp.read())
        require(health["ok"] and health["model"] == "NextDiT_2B_patch2", f"health {health}")
        phase("serve", f"GET /api/health: {health}")
        default, _ = post({"cap": PROMPT})
        for name in SAMPLER_KERNELS:
            require(default[name] > 0, f"kernel {name} was not launched by the default request")
        require(default["static_max"] > default["online"],
                "static-max is not the bulk after calibration")
        require(not any(default[name] for name in ROPE_KERNELS), "K9 ran unfused")
        os.environ["LUMINA_FUSE_ROPE"] = "1"
        try:
            fused, fused_px = post({"cap": PROMPT, "num_sampling_steps": 10})
            wide, _ = post({"cap": PROMPT, "num_sampling_steps": 10, "resolution": "512x2048"})
        finally:
            os.environ.pop("LUMINA_FUSE_ROPE")
        for launches in (fused, wide):
            require(all(launches[name] > 0 for name in ROPE_KERNELS),
                    f"K9 was not launched: {launches}")
            require(not any(launches[name] for name in SAMPLER_KERNELS),
                    f"K1-K4 ran under LUMINA_FUSE_ROPE=1: {launches}")
        unfused, unfused_px = post({"cap": PROMPT, "num_sampling_steps": 10})
        require(unfused["static_max"] > unfused["online"] and not any(
            unfused[name] for name in ROPE_KERNELS),
            f"the unfused 10-step setting did not calibrate and run K3: {unfused}")
        diff = np.abs(fused_px.astype(np.int32) - unfused_px.astype(np.int32))
        phase("serve", f"1024^2 10-step preview, fused RoPE (K9) vs unfused (K3): mean "
              f"{diff.mean():.3f}, max {diff.max()} of 255 levels")
        # the 2B forward's bf16 bar (2e-2 relative) over the preview's range
        require(diff.mean() <= 2e-2 * 255, f"fused and unfused previews differ: {diff.mean()}")
    finally:
        sample_lib.autocalibrate_flash_static_max = probe
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    del worker, server
    torch.cuda.empty_cache()
    return {**{name: default[name] for name in SAMPLER_KERNELS},
            **{name: fused[name] + wide[name] for name in ROPE_KERNELS}}


def _train_inputs(seed):
    """A fixed training batch, time and noise at the trainer's shapes."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x1 = torch.randn(B, 4, 128, 128, generator=g, device="cuda")
    x0 = torch.randn(B, 4, 128, 128, generator=g, device="cuda")
    t = torch.rand(B, generator=g, device="cuda")
    cap = torch.randn(B, TRAIN_CAP, 2048, generator=g, device="cuda")
    return x1, x0, t, cap, torch.ones(B, TRAIN_CAP, dtype=torch.int32, device="cuda")


def gradient_phase(fa):
    """One loss + backward of the randomised 2B through the kernels, the
    plain versions and the plain sdpa; distances of the whole gradient
    vector from the plain versions'."""
    from lumina_t2x_tpu_torch.models import get_model
    from lumina_t2x_tpu_torch.transport import create_transport

    torch.manual_seed(0)
    model = get_model("NextDiT_2B_patch2", qk_norm=True, cap_feat_dim=2048, dtype=torch.bfloat16,
                      remat=True, remat_policy="dots", device="cuda")
    _randomise_zero_init(model, 1)
    x1, x0, t, cap, cap_mask = _train_inputs(4)
    transport = create_transport()
    params = list(model.parameters())

    def loss_and_grads(impl):
        model.set_attn_impl(impl)
        terms = transport.training_losses(
            lambda xt, tt: model(xt, tt, cap, cap_mask, train=True), x1, t=t, x0=x0)
        loss = terms["loss"].mean()
        return loss.detach(), torch.autograd.grad(loss, params, allow_unused=True)

    fa.reset_launch_counts()
    ref_loss, ref = loss_and_grads("plain")
    ref = [torch.zeros_like(p) if r is None else r for r, p in zip(ref, params)]
    ref_norm = torch.sqrt(sum(r.float().pow(2).sum() for r in ref)).item()
    dist, losses, secs = {}, {"plain": ref_loss.item()}, {}
    for impl in ("flash", "xla"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = loss_and_grads(impl)
        torch.cuda.synchronize()
        secs[impl] = time.perf_counter() - t0
        losses[impl] = loss.item()
        diff = sum((r.float() - (0 if gr is None else gr.float())).pow(2).sum()
                   for gr, r in zip(grads, ref))
        dist[impl] = torch.sqrt(diff).item() / ref_norm
        del grads
    model.set_attn_impl("auto")
    launches = dict(fa.LAUNCHES)
    loss_rel = {impl: abs(losses[impl] - losses["plain"]) / abs(losses["plain"])
                for impl in ("flash", "xla")}
    phase("gradient", f"NextDiT_2B_patch2 loss+backward at 1024^2, B={B}, {TRAIN_CAP} caption "
          f"tokens, bf16, dots remat: gradient rel L2 kernels vs plain {dist['flash']:.4g} "
          f"(sdpa vs plain {dist['xla']:.4g}); loss {losses['flash']:.6f} / plain "
          f"{losses['plain']:.6f} / sdpa {losses['xla']:.6f} (rel {loss_rel['flash']:.3g}, sdpa "
          f"{loss_rel['xla']:.3g}); |grad| {ref_norm:.4g}; kernels {secs['flash']:.2f} s, sdpa "
          f"{secs['xla']:.2f} s; launches {launches}")
    require(all(math.isfinite(x) for x in (*dist.values(), *losses.values())),
            "2B gradient: non-finite")
    require(dist["flash"] <= GRAD_FLOOR_FACTOR * dist["xla"],
            f"2B gradient rel L2 {dist['flash']} > {GRAD_FLOOR_FACTOR} x sdpa floor {dist['xla']}")
    require(launches["bwd_fused"] > 0 and launches["online_lse"] > 0,
            "the kernels' backward did not run")
    del model, params, ref
    torch.cuda.empty_cache()


def _train_metrics(results_dir):
    with open(os.path.join(results_dir, "NextDiT_2B_patch2", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def recipe_phase(fa):
    """The flagship recipe's step (2B, 1024^2 latents, B=2, bf16 activations,
    fp32 grads, AdamW with its full fp32 state, dots remat, calibrated train
    bound) through the trainer's building blocks, 3 steps, timed. It saves
    no checkpoint: one is 29.6 GiB, and the trainer CLI legs below need two."""
    from lumina_t2x_tpu_torch.models import get_model
    from lumina_t2x_tpu_torch.pipelines import profile_train_step as prof
    from lumina_t2x_tpu_torch.pipelines import train as train_cli
    from lumina_t2x_tpu_torch.pipelines import train_lib
    from lumina_t2x_tpu_torch.transport import create_transport

    args = train_cli.parse_args(["--global_batch_size", str(B), "--cap_feat_dim", "2048"])
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    torch.manual_seed(0)
    model = get_model("NextDiT_2B_patch2", qk_norm=True, dtype=torch.bfloat16, remat=True,
                      remat_policy="dots", cap_feat_dim=2048, device="cuda")
    optimizer = train_lib.create_optimizer(1e-4, 0.0)
    state = train_lib.create_train_state(model, optimizer)
    transport = create_transport()
    step_fn = train_lib.make_train_step(model, transport, optimizer, train_cli._cond)
    batches = train_cli.synthetic_batches(args, 128, torch.device("cuda"))
    batch = next(batches)
    bound = train_lib.autocalibrate_flash_static_max_train(
        model, batch, train_cli._cond, generator=torch.Generator(device="cuda").manual_seed(1),
        path_sampler=transport.path_sampler)
    require(bound is not None and math.isfinite(bound), "train calibration declined at 2B")
    ms, metrics = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch, 0)
        torch.cuda.synchronize()
        ms.append(1000 * (time.perf_counter() - t0))
        metrics.append(m)
        batch = next(batches)
    launches = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    held = [state]

    def one_step():
        held[0], _ = step_fn(held[0], batch, 0)

    shares = prof.report(one_step, "recipe step (4th)")
    template, hopper = (dict(prof.GROUPS)[pat] for pat in ("flash_fwd", "flash_fwd_sm90"))
    state = held[0]
    phase("recipe", f"NextDiT_2B_patch2 ({sum(p.numel() for p in model.parameters()) / 1e9:.3f}B "
          f"params), AdamW fp32 state, 1024^2 latents, B={B}, bf16, fp32 grads, dots remat, "
          f"train bound {bound:.4f}: losses {[round(m['loss'], 5) for m in metrics]}, grad norms "
          f"{[round(m['grad_norm'], 4) for m in metrics]}; "
          f"{', '.join(f'{x:.1f}' for x in ms)} ms/step, "
          f"{B / (statistics.mean(ms[1:]) / 1000):.4f} images/s (steps 2-3); peak memory "
          f"{peak:.2f} GiB; launches {launches}; plain-version CUDA calls "
          f"{fa.PLAIN_CUDA_CALLS['count']}; profiled 4th step: {template} "
          f"{100 * shares.get(template, 0.0):.1f}%, {hopper} {100 * shares.get(hopper, 0.0):.1f}% "
          f"of the device time")
    require(all(math.isfinite(m["loss"]) and not m["skipped"] for m in metrics),
            "recipe steps not finite")
    for name in ("online_lse", "static_max_lse", "bwd_fused"):
        require(launches[name] > 0, f"kernel {name} was not launched by the recipe step")
    require(fa.PLAIN_CUDA_CALLS["count"] == 0, "plain versions ran on CUDA")
    del model, state, held, one_step, step_fn, optimizer, batch, batches
    fa.set_flash_static_max_train(None)
    torch.cuda.empty_cache()
    return {"ms": ms, "peak": peak}


def trainer_phase(fa):
    """The trainer CLI at full width and depth: 3 steps and a checkpoint, then
    --auto_resume for a 4th step on the two-kernel backward. The CLI legs use
    bf16 Adafactor (7.4 GiB per checkpoint): the H100 test machines allow
    45 GiB of disk writes per run, and two fp32 AdamW checkpoints are 59 GiB.
    Returns the training launch counts."""
    from lumina_t2x_tpu_torch.pipelines import train as train_cli

    with tempfile.TemporaryDirectory() as results:
        argv = ["--model", "NextDiT_2B_patch2", "--data_path", "synthetic://128x128",
                "--global_batch_size", str(B), "--precision", "bf16", "--grad_precision",
                "fp32", "--qk_norm", "--checkpointing", "--flash_static_max", "auto",
                "--optimizer", "adafactor", "--param_dtype", "bf16",
                "--results_dir", results, "--log_every", "1", "--ckpt_every", "1000",
                "--keep_last", "1"]
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        state = train_cli.main(argv + ["--max_steps", "3"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(fa.LAUNCHES)
        plain_calls = fa.PLAIN_CUDA_CALLS["count"]
        bound = fa.get_flash_static_max(train=True)
        peak = torch.cuda.max_memory_allocated() / 2**30
        require(state.step == 3, f"trainer stopped at step {state.step}")
        del state
        torch.cuda.empty_cache()
        ckpts = os.path.join(results, "NextDiT_2B_patch2", "checkpoints")
        require(os.listdir(ckpts) == ["0000003"], f"checkpoints after 3 steps: {os.listdir(ckpts)}")
        metrics = _train_metrics(results)
        steady = [m["train/secs_per_step"] for m in metrics[1:]]
        phase("trainer", f"CLI, NextDiT_2B_patch2, bf16 Adafactor, 1024^2 latents, B={B}, dots "
              f"remat: losses {[round(m['train/loss'], 5) for m in metrics]}, grad norms "
              f"{[round(m['train/grad_norm'], 4) for m in metrics]}; step 1 "
              f"{1000 * metrics[0]['train/secs_per_step']:.1f} ms (calibration included), steps "
              f"2-3 {', '.join(f'{1000 * x:.1f}' for x in steady)} ms/step, "
              f"{B / statistics.mean(steady):.4f} images/s; peak memory {peak:.2f} GiB; "
              f"calibrated train bound {bound:.4f}; wall {wall:.1f} s incl. set-up and save; "
              f"launches {launches}; plain-version CUDA calls {plain_calls}")

        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        os.environ["LUMINA_FLASH_FUSED_BWD"] = "0"
        try:
            t0 = time.perf_counter()
            state = train_cli.main(argv + ["--max_steps", "4", "--auto_resume"])
            torch.cuda.synchronize()
            wall2 = time.perf_counter() - t0
        finally:
            os.environ.pop("LUMINA_FLASH_FUSED_BWD")
        resumed = dict(fa.LAUNCHES)
        plain_calls += fa.PLAIN_CUDA_CALLS["count"]
        require(state.step == 4, f"resumed trainer stopped at step {state.step}")
        del state
        torch.cuda.empty_cache()
        require(os.listdir(ckpts) == ["0000004"], f"checkpoints after resume: {os.listdir(ckpts)}")
        settings = os.path.join(results, "settings.yaml")
        with open(settings, "w") as f:
            f.write("- infer:\n    num_sampling_steps: 10\n")
        ckpt_launches = lumina_infer(fa, "lumina infer --ckpt <trainer checkpoint>",
                                     ["--ckpt", os.path.join(ckpts, "0000004")], settings, steps=10)
        require(ckpt_launches["static_max"] > 0, "the checkpoint's qk-norm model did not calibrate")
        metrics = _train_metrics(results)
        phase("trainer", f"--auto_resume from step 3 with LUMINA_FLASH_FUSED_BWD=0: step 4 loss "
              f"{metrics[-1]['train/loss']:.5f}, {1000 * metrics[-1]['train/secs_per_step']:.1f} "
              f"ms (calibration included), peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; wall {wall2:.1f} s incl. "
              f"load and save; launches {resumed}; plain-version CUDA calls "
              f"{fa.PLAIN_CUDA_CALLS['count']}")
    require(len(metrics) == 4 and all(math.isfinite(m["train/loss"]) for m in metrics),
            "trainer losses not finite")
    require(bound is not None and math.isfinite(bound), "train calibration declined at 2B")
    for name in ("online_lse", "static_max_lse", "bwd_fused"):
        require(launches[name] > 0, f"kernel {name} was not launched by the trainer")
    for name in ("static_max_lse", "bwd_dq", "bwd_dkv"):
        require(resumed[name] > 0, f"kernel {name} was not launched by the resumed trainer")
    require(resumed["bwd_fused"] == 0, "the resumed step took the fused backward")
    require(plain_calls == 0, f"plain versions ran {plain_calls} times on CUDA")
    return {name: launches[name] + resumed[name] for name in TRAIN_KERNELS}


def main():
    device_phase()
    sys.path.insert(0, ROOT)
    from lumina_t2x_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_phase()
    results = kernel_phase(fa)
    results.update(backward_kernel_phase(fa))
    results.update(rope_kernel_phase(fa))
    exp_results, exp_launches = experiments_phase()
    results.update(exp_results)
    slice_phase(fa, *forward_phase(fa))
    cli_phase(fa)
    launches = serving_phase(fa)
    gradient_phase(fa)
    recipe_phase(fa)
    launches.update(trainer_phase(fa))  # K4: the training path's count
    launches.update(exp_launches)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[name], **{key: results[name][key] for key in keys}}
        for name, (source, replaces) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

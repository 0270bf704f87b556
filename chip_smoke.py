"""Drive the PyTorch port's main path once on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero before the
last line:
1. device: CUDA must be available; prints the card's name and power limit;
2. build: compiles the flash-attention kernels from
   lumina_t2x_tpu_torch/csrc with nvcc and prints the build seconds;
3. kernels: each CUDA entry point against its plain PyTorch version at the
   main-path shapes (B=2, S=4096, H=32, D=72; Sk=256 for the small-KV
   kernel), bf16 and fp32, GQA, masked tails and a fully masked row, with
   kernel and plain times (CUDA events, median after a warm-up);
4. full-width forward: one CFG forward of NextDiT_2B_patch2 (qk-norm,
   caption dim 2048, bf16, zero-init tensors randomised) at 1024^2 with 256
   caption tokens, through the kernels and through the plain versions;
5. the slice: a 30-point midpoint trajectory (CFG 4, time-shift 4) of the
   same model through `sample_lib` with calibration, timed; then the
   sampler CLI (`pipelines.sample.main`, 2B, 1024^2, --qk_norm --debug), the
   main path whose kernel launches are counted.
The line before the last is a JSON object of the kernels; the last line is
{"ok": true, "device": {...}}.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCE = "lumina_t2x_tpu_torch/csrc/flash_fwd.cu"
TPU_KERNELS = "lumina_t2x_tpu/ops/flash_attention.py"
KERNELS = {  # entry point -> line of the Pallas kernel it replaces
    "small_kv": 240,    # _flash_small_kv_kernel
    "online": 228,      # _flash_kernel_fused_sum
    "static_max": 66,   # _flash_kernel_static_max
    "online_lse": 430,  # _flash_kernel_res
}
B, S, H, D, CAP = 2, 4096, 32, 72, 256
BF16_MAX, BF16_MEAN, FP32_MAX, LSE_MAX = 1e-2, 1e-3, 2e-3, 1e-3


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


def build_phase(fa):
    t0 = time.perf_counter()
    fa.build_library()
    how = "compiled with nvcc" if fa.BUILD_INFO["compiled"] else "already built, loaded"
    phase("build", f"{time.perf_counter() - t0:.2f} s, {how} ({fa.BUILD_INFO['path']})")


def _rand(g, *shape, dtype):
    return torch.randn(*shape, generator=g, device="cuda", dtype=torch.float32).to(dtype)


# (label, dtype, n_kv_heads, mask kind); the first is the timed main-path case
CASES = [("bf16", torch.bfloat16, H, "none"), ("fp32", torch.float32, H, "tail"),
         ("bf16 gqa8", torch.bfloat16, 8, "tail"), ("bf16 masked-row", torch.bfloat16, H, "row")]


def kernel_phase(fa):
    g = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for entry in KERNELS:
        sk = CAP if entry == "small_kv" else S
        kernel = getattr(fa, f"flash_{entry}")
        plain = getattr(fa, f"flash_{entry}_plain")
        worst, ms, plain_ms = 0.0, None, None
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
            if entry == "static_max":  # the calibrated bound: max row LSE + margin 6
                lse = fa.flash_online_lse_plain(q, k, v, mask, scale)[1]
                kw = {"bound": float(lse[torch.isfinite(lse)].max()) + 6.0}
            got = kernel(q, k, v, mask, scale, **kw)
            ref = plain(q.float(), k.float(), v.float(), mask, scale, *kw.values())
            torch.cuda.synchronize()
            if entry == "online_lse":
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
            line = f"{entry} {label}: max abs err {max_err:.3g} mean {mean_err:.3g}"
            if ms is None:
                ms = time_ms(lambda: kernel(q, k, v, mask, scale, **kw))
                plain_ms = time_ms(lambda: plain(q, k, v, mask, scale, *kw.values()))
                line += f"; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms"
            phase("kernels", line)
            del q, k, v, got, ref
        results[entry] = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}
    return results


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
    from lumina_t2x_tpu_torch.pipelines import sample as sample_cli
    from lumina_t2x_tpu_torch.pipelines.sample_lib import (autocalibrate_flash_static_max,
                                                           build_t2i_sample_fn)

    kw = dict(width=1024, height=1024, cfg_scale=4.0, time_shifting_factor=4.0)
    g = torch.Generator(device="cuda").manual_seed(3)
    bound = autocalibrate_flash_static_max(model, cap, cap_mask, generator=g, **kw)
    require(bound is not None and math.isfinite(bound), "calibration declined at 2B")
    phase("slice", f"flash static-max calibrated: {bound:.4f}")
    sample_fn = build_t2i_sample_fn(model, num_steps=30, solver="midpoint", **kw)
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
    fa.set_flash_static_max(None)

    with tempfile.TemporaryDirectory() as out_dir:
        fa.reset_launch_counts()
        sample_cli.main(["--model", "NextDiT_2B_patch2", "--qk_norm", "--resolution",
                         "1:1024x1024", "--num_sampling_steps", "30", "--solver", "midpoint",
                         "--cfg_scale", "4.0", "--time_shifting_factor", "4", "--debug",
                         "--image_save_path", out_dir])
        torch.cuda.synchronize()
        launches = dict(fa.LAUNCHES)
        plain_calls = fa.PLAIN_CUDA_CALLS["count"]
        with open(os.path.join(out_dir, "data.json")) as f:
            items = json.load(f)["items"]
        lat = np.load(items[0]["path"])
    require(lat.shape == (4, 128, 128) and np.isfinite(lat).all(), "CLI latents not finite")
    phase("slice", f"CLI wrote {len(items)} latent(s) {lat.shape}, finite; launches {launches}; "
          f"plain-version CUDA calls {plain_calls}")
    for name, count in launches.items():
        require(count > 0, f"kernel {name} was not launched on the main path")
    require(launches["static_max"] > launches["online"], "static-max is not the bulk after calibration")
    require(plain_calls == 0, f"plain versions ran {plain_calls} times on CUDA")
    return launches


def main():
    device_phase()
    sys.path.insert(0, ROOT)
    from lumina_t2x_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_phase(fa)
    results = kernel_phase(fa)
    launches = slice_phase(fa, *forward_phase(fa))
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": f"{TPU_KERNELS}:{line}",
         "launches": launches[name], **results[name]} for name, line in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

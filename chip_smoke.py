"""Drive the PyTorch port's main path once on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero before the
last line:
1. device: CUDA must be available; prints the card's name and power limit;
2. build: compiles the flash-attention kernels from
   lumina_t2x_tpu_torch/csrc with nvcc (one process per source, in
   parallel) and prints the build seconds;
3. kernels: each CUDA entry point against its plain PyTorch version at the
   main-path shapes (B=2, S=4096, H=32, D=72; Sk=256 for the small-KV
   kernel; the LSE forward and the backward kernels also at the training
   cross-attention's Sk=32), bf16 and fp32, GQA, masked tails and a fully masked row, with
   kernel and plain times (CUDA events, median after a warm-up);
4. full-width forward: one CFG forward of NextDiT_2B_patch2 (qk-norm,
   caption dim 2048, bf16, zero-init tensors randomised) at 1024^2 with 256
   caption tokens, through the kernels and through the plain versions;
5. the sampler: a 30-point midpoint trajectory (CFG 4, time-shift 4) of the
   same model through `sample_lib` with calibration, timed; then the
   sampler CLI (`pipelines.sample.main`, 2B, 1024^2, --qk_norm --debug), the
   first main path whose kernel launches are counted;
6. gradient: one loss + backward of the randomised 2B at 1024^2, B=2, 32
   caption tokens, `dots` remat, through the kernels, the plain versions and
   the plain sdpa; the kernels' gradient must lie within 1.5x the sdpa's
   distance from the plain versions (the bf16 floor);
7. recipe: 3 timed train steps of the flagship recipe (2B, 1024^2 latents,
   B=2, bf16, AdamW with its full fp32 state, dots remat, calibrated train
   bound) through `pipelines/train_lib`, with peak memory;
8. trainer: the trainer CLI (`pipelines.train.main`, 2B at full width and
   depth, 1024^2 latents, B=2, bf16, --checkpointing, --flash_static_max
   auto, bf16 Adafactor so that two checkpoints fit the machine's disk-write
   limit) for 3 steps, then --auto_resume for a 4th step with
   LUMINA_FLASH_FUSED_BWD=0: the second main path, whose training kernel
   launches are counted.
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
FWD_SOURCE = "lumina_t2x_tpu_torch/csrc/flash_fwd.cu"
BWD_SOURCE = "lumina_t2x_tpu_torch/csrc/flash_bwd.cu"
TPU_KERNELS = "lumina_t2x_tpu/ops/flash_attention.py"
KERNELS = {  # entry point -> (source, line of the Pallas kernel it replaces)
    "small_kv": (FWD_SOURCE, 240),        # _flash_small_kv_kernel
    "online": (FWD_SOURCE, 228),          # _flash_kernel_fused_sum
    "static_max": (FWD_SOURCE, 66),       # _flash_kernel_static_max
    "online_lse": (FWD_SOURCE, 430),      # _flash_kernel_res
    "static_max_lse": (FWD_SOURCE, 446),  # _flash_kernel_res_static_max
    "bwd_fused": (BWD_SOURCE, 619),       # _bwd_fused_kernel
    "bwd_dq": (BWD_SOURCE, 552),          # _bwd_dq_kernel
    "bwd_dkv": (BWD_SOURCE, 584),         # _bwd_dkv_kernel
}
SAMPLER_KERNELS = ("small_kv", "online", "static_max", "online_lse")
TRAIN_KERNELS = ("online_lse", "static_max_lse", "bwd_fused", "bwd_dq", "bwd_dkv")
B, S, H, D, CAP, TRAIN_CAP = 2, 4096, 32, 72, 256, 32
BF16_MAX, BF16_MEAN, FP32_MAX, LSE_MAX = 1e-2, 1e-3, 2e-3, 1e-3
# backward outputs, relative to the largest |reference| element: one bf16
# rounding of the output (8 mantissa bits); fp32 sums in another order
BWD_BF16_MAX, BWD_BF16_MEAN, BWD_FP32_MAX = 1e-2, 1e-3, 1e-4
GRAD_FLOOR_FACTOR = 1.5


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
    # (entry, Sk); the first case of an entry is the timed one. online_lse also
    # runs the training cross-attention: one partial 64-key tile at Sk=32
    for entry, sk in (("small_kv", CAP), ("online", S), ("static_max", S), ("online_lse", S),
                      ("online_lse", TRAIN_CAP), ("static_max_lse", S)):
        kernel = getattr(fa, f"flash_{entry}")
        plain = getattr(fa, f"flash_{entry}_plain")
        prev = results.get(entry, {"max_abs_err": 0.0, "ms": None, "plain_ms": None})
        worst, ms, plain_ms = prev["max_abs_err"], prev["ms"], prev["plain_ms"]
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
            if ms is None:
                ms = time_ms(lambda: kernel(q, k, v, mask, scale, **kw))
                plain_ms = time_ms(lambda: plain(q, k, v, mask, scale, *kw.values()))
                line += f"; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms"
            phase("kernels", line)
            del q, k, v, got, ref
        results[entry] = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}
    return results


# (label, dtype, sk, n_kv_heads, mask kind); the first is the timed main-path case
BWD_CASES = [("bf16", torch.bfloat16, S, H, "none"), ("fp32", torch.float32, S, H, "tail"),
             ("bf16 gqa8", torch.bfloat16, S, 8, "tail"),
             ("bf16 masked-row", torch.bfloat16, S, H, "row"),
             ("bf16 cross-attention", torch.bfloat16, TRAIN_CAP, H, "tail")]


def backward_kernel_phase(fa):
    """K6 and K7 + K8 against `flash_bwd_plain` on the same inputs (q, k, v,
    dO, and out/LSE from the plain LSE forward)."""
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
            line += "; " + ", ".join(f"{n} {t:.3f} ms" for n, t in times.items())
        phase("kernels", line)
        del q, k, v, dout, out, lse, args, ref, got
        torch.cuda.empty_cache()
    return {name: {"max_abs_err": worst[name], "ms": times[name], "plain_ms": times["plain"]}
            for name in worst}


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
        fa.set_flash_static_max(None)  # the CLI's inference bound stays out of later phases
        with open(os.path.join(out_dir, "data.json")) as f:
            items = json.load(f)["items"]
        lat = np.load(items[0]["path"])
    require(lat.shape == (4, 128, 128) and np.isfinite(lat).all(), "CLI latents not finite")
    phase("slice", f"CLI wrote {len(items)} latent(s) {lat.shape}, finite; launches {launches}; "
          f"plain-version CUDA calls {plain_calls}")
    for name in SAMPLER_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched on the main path")
    require(launches["static_max"] > launches["online"], "static-max is not the bulk after calibration")
    require(plain_calls == 0, f"plain versions ran {plain_calls} times on CUDA")
    return launches


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
    phase("recipe", f"NextDiT_2B_patch2 ({sum(p.numel() for p in model.parameters()) / 1e9:.3f}B "
          f"params), AdamW fp32 state, 1024^2 latents, B={B}, bf16, fp32 grads, dots remat, "
          f"train bound {bound:.4f}: losses {[round(m['loss'], 5) for m in metrics]}, grad norms "
          f"{[round(m['grad_norm'], 4) for m in metrics]}; "
          f"{', '.join(f'{x:.1f}' for x in ms)} ms/step, "
          f"{B / (statistics.mean(ms[1:]) / 1000):.4f} images/s (steps 2-3); peak memory "
          f"{peak:.2f} GiB; launches {launches}; plain-version CUDA calls "
          f"{fa.PLAIN_CUDA_CALLS['count']}")
    require(all(math.isfinite(m["loss"]) and not m["skipped"] for m in metrics),
            "recipe steps not finite")
    for name in ("online_lse", "static_max_lse", "bwd_fused"):
        require(launches[name] > 0, f"kernel {name} was not launched by the recipe step")
    require(fa.PLAIN_CUDA_CALLS["count"] == 0, "plain versions ran on CUDA")
    del model, state, step_fn, optimizer, batch, batches
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
    build_phase(fa)
    results = kernel_phase(fa)
    results.update(backward_kernel_phase(fa))
    launches = slice_phase(fa, *forward_phase(fa))
    gradient_phase(fa)
    recipe_phase(fa)
    launches.update(trainer_phase(fa))  # K4: the training path's count
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": f"{TPU_KERNELS}:{line}",
         "launches": launches[name], **results[name]}
        for name, (source, line) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

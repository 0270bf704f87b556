"""Where the time of one 2B train step goes on one NVIDIA GPU.

    python -m lumina_t2x_tpu_torch.pipelines.profile_train_step [--warmup 2] [--timed 3]

Builds the flagship recipe's step (NextDiT_2B_patch2, qk-norm, caption dim
2048, 1024^2 latents, B=2, bf16 activations, fp32 grads, AdamW with its full
fp32 state, `dots` remat, calibrated train bound) from a seed, times
`--timed` steps on the host clock after `--warmup` steps (with images/s and
the peak device memory), then runs one step under `torch.profiler` and
prints its device time by kernel group and the 30 costliest kernels. Needs
a CUDA device and ~42 GiB of its memory.
"""

import argparse
import re
import subprocess
import time

import torch

GROUPS = (  # (pattern on the kernel name, group), first match wins
    (r"flash_bwd_sm90", "Hopper backward (bf16 K6-K8, flash_bwd_sm90.cu)"),
    (r"flash_bwd", "flash backward kernels (fp32 K6-K8)"),
    (r"flash_fwd_sm90", "Hopper forward (bf16 K1-K5, K9, flash_fwd_sm90.cu)"),
    (r"flash_fwd", "flash forward template (fp32 K1-K5, K9)"),
    (r"nvjet|gemm|xmma|cutlass|sm90|cublas", "cuBLAS GEMMs"),
    (r"elementwise", "elementwise"),
    (r"reduce", "reductions"),
    (r"foreach", "foreach"),
    (r"memcpy|memset|copy", "copies/memset"),
)


def _group(name: str) -> str:
    return next((g for pat, g in GROUPS if re.search(pat, name, re.I)), "other")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--timed", type=int, default=3)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train_step needs a CUDA device")

    from lumina_t2x_tpu_torch.models import get_model
    from lumina_t2x_tpu_torch.ops import cuda_lib
    from lumina_t2x_tpu_torch.ops import flash_attention as fa
    from lumina_t2x_tpu_torch.pipelines import train as train_cli
    from lumina_t2x_tpu_torch.pipelines import train_lib
    from lumina_t2x_tpu_torch.transport import create_transport

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    cuda_lib.build_library(fa.LIBRARY)
    cli_args = train_cli.parse_args(["--global_batch_size", "2", "--cap_feat_dim", "2048"])
    torch.manual_seed(0)
    model = get_model("NextDiT_2B_patch2", qk_norm=True, dtype=torch.bfloat16, remat=True,
                      remat_policy="dots", cap_feat_dim=2048, device="cuda")
    optimizer = train_lib.create_optimizer(1e-4, 0.0)
    state = train_lib.create_train_state(model, optimizer)
    transport = create_transport()
    step = train_lib.make_train_step(model, transport, optimizer, train_cli._cond)
    batches = train_cli.synthetic_batches(cli_args, 128, torch.device("cuda"))
    batch = next(batches)
    bound = train_lib.autocalibrate_flash_static_max_train(
        model, batch, train_cli._cond, generator=torch.Generator(device="cuda").manual_seed(1),
        path_sampler=transport.path_sampler)
    print(f"train bound {bound}")

    for _ in range(args.warmup):
        state, _ = step(state, batch, 0)
        batch = next(batches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(args.timed):
        t0 = time.perf_counter()
        state, _ = step(state, batch, 0)
        torch.cuda.synchronize()
        times.append(1000 * (time.perf_counter() - t0))
        batch = next(batches)
    print(f"host-clock ms/step {[round(t, 1) for t in times]}, "
          f"{2000 * len(times) / sum(times):.4f} images/s (B=2), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    def one_step():
        nonlocal state
        state, _ = step(state, batch, 0)

    report(one_step, "step")


def report(fn, what: str) -> dict:
    """Run fn once under `torch.profiler` and print its wall and device time,
    the device time by kernel group and the 30 costliest kernels. Returns
    {group: share of the device time}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1000 * (time.perf_counter() - t0)
    rows = sorted(((e.key, e.self_device_time_total / 1000, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  key=lambda r: -r[1])
    total = sum(t for _, t, _ in rows)
    print(f"profiled {what}: wall {wall:.1f} ms, device time {total:.1f} ms "
          f"({100 * total / wall:.1f}% busy)")
    groups = {}
    for name, t, n in rows:
        acc = groups.setdefault(_group(name), [0.0, 0])
        acc[0] += t
        acc[1] += n
    for g, (t, n) in sorted(groups.items(), key=lambda x: -x[1][0]):
        print(f"GROUP {100 * t / total:5.1f}% {t:9.1f} ms {n:6d} calls  {g}")
    for name, t, n in rows[:30]:
        print(f"{100 * t / total:5.1f}% {t:9.2f} ms {n:6d}  {name[:110]}")
    return {g: t / total for g, (t, _) in groups.items()}


if __name__ == "__main__":
    main()

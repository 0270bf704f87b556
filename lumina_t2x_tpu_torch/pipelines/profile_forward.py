"""Where the time of one 2B CFG forward of the sampler goes on one NVIDIA GPU.

    python -m lumina_t2x_tpu_torch.pipelines.profile_forward

Builds NextDiT_2B_patch2 (qk-norm, caption dim 2048, bf16, zero-init
tensors 0.02 * N(0, 1) from a seed, as chip_smoke.py does) and the sampler's
inputs at 1024^2 (a CFG batch of 2 over 4096 image tokens, 256 caption
tokens), calibrates the static softmax bound as the sampler does
(`sample_lib.autocalibrate_flash_static_max`), times TIMED CFG forwards at
the first point of the time grid under that bound on the host clock after
WARMUP, then runs one under `torch.profiler` and prints its device
time by kernel group and the 30 costliest kernels. Needs a CUDA device.
"""

import subprocess
import time

import torch

from .profile_train_step import report

WARMUP, TIMED = 2, 5  # CFG forwards before the timed ones, and timed ones


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward needs a CUDA device")

    from lumina_t2x_tpu_torch.models import get_model
    from lumina_t2x_tpu_torch.models.next_dit import forward_with_cfg
    from lumina_t2x_tpu_torch.ops import cuda_lib
    from lumina_t2x_tpu_torch.ops import flash_attention as fa
    from lumina_t2x_tpu_torch.pipelines.sample_lib import autocalibrate_flash_static_max

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    cuda_lib.build_library(fa.LIBRARY)
    torch.manual_seed(0)
    model = get_model("NextDiT_2B_patch2", qk_norm=True, cap_feat_dim=2048, dtype=torch.bfloat16,
                      device="cuda").eval()
    g = torch.Generator(device="cuda").manual_seed(1)
    with torch.no_grad():
        for w in model.parameters():
            if not torch.any(w):
                w.copy_(0.02 * torch.randn(w.shape, generator=g, device="cuda"))
    x = torch.randn(1, 4, 128, 128, generator=g, device="cuda").repeat(2, 1, 1, 1)
    cap = torch.randn(2, 256, 2048, generator=g, device="cuda")
    cap_mask = torch.ones(2, 256, dtype=torch.int32, device="cuda")
    t = torch.zeros(2, device="cuda")
    bound = autocalibrate_flash_static_max(model, cap, cap_mask, generator=g)
    print(f"static-max bound {bound}")

    def forward():
        with torch.no_grad(), fa.flash_static_max_scope(bound):
            forward_with_cfg(model, x, t, cap, cap_mask, 4.0)

    for _ in range(WARMUP):
        forward()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMED):
        t0 = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        times.append(1000 * (time.perf_counter() - t0))
    print(f"host-clock ms per CFG forward {[round(x, 1) for x in times]}")
    fa.reset_launch_counts()
    report(forward, "CFG forward")
    print(f"launches {dict((k, v) for k, v in fa.LAUNCHES.items() if v)}")


if __name__ == "__main__":
    main()

"""Where the time of a class-conditional request goes on one NVIDIA GPU: the
600M's CFG forward and the SD-VAE's decode.

    python -m lumina_t2x_tpu_torch.pipelines.profile_class_cond

Builds NextDiT_ImageNet_600M_patch2 (bf16, zero-init tensors 0.02 * N(0, 1)
from a seed, as chip_smoke.py does) and the sampler's inputs for 4 labels at
256^2 (a CFG batch of 8 over 256 tokens), times TIMED CFG forwards on the
host clock after WARMUP and profiles one (device time by kernel group, the
30 costliest kernels, K1's device time per call); then builds the full
SD-VAE from a seed and, with cuDNN's TF32 convolutions off and on, times
TIMED fp32 decodes of a 1024^2 latent and profiles one. Needs a CUDA device.
"""

import subprocess
import time

import torch

from .profile_train_step import GROUPS, report

WARMUP, TIMED = 2, 5
# the VAE's kernels: cuDNN's convolutions and layout transforms, GroupNorm's
# statistics, then the forward's groups (first match wins)
VAE_GROUPS = ((r"nchwToNhwc|nhwcToNchw", "cuDNN layout transforms"),
              (r"conv|fprop|implicit|winograd|fft", "cuDNN convolutions"),
              (r"RowwiseMoments|ComputeFusedParams", "GroupNorm statistics"), *GROUPS)


def _timed(fn):
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMED):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1000 * (time.perf_counter() - t0))
    return [round(t, 2) for t in times]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_class_cond needs a CUDA device")

    from lumina_t2x_tpu_torch.codecs.vae import AutoencoderKL, decode_from_latent
    from lumina_t2x_tpu_torch.models import get_model
    from lumina_t2x_tpu_torch.models.next_dit_imagenet import forward_with_cfg
    from lumina_t2x_tpu_torch.ops import cuda_lib
    from lumina_t2x_tpu_torch.ops import flash_attention as fa

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    cuda_lib.build_library(fa.LIBRARY)
    torch.manual_seed(0)
    model = get_model("NextDiT_ImageNet_600M_patch2", dtype=torch.bfloat16, device="cuda").eval()
    g = torch.Generator(device="cuda").manual_seed(1)
    with torch.no_grad():
        for w in model.parameters():
            if not torch.any(w):
                w.copy_(0.02 * torch.randn(w.shape, generator=g, device="cuda"))
    x = torch.randn(4, 4, 32, 32, generator=g, device="cuda").repeat(2, 1, 1, 1)
    y = torch.tensor([207, 360, 387, 974] + [model.num_classes] * 4, device="cuda")
    t = torch.full((8,), 0.5, device="cuda")

    def forward():
        with torch.no_grad():
            forward_with_cfg(model, x, t, y, 4.0)

    print(f"host-clock ms per CFG forward (batch 8, 256^2) {_timed(forward)}")
    fa.reset_launch_counts()
    report(forward, "CFG forward")
    print(f"launches {dict((k, v) for k, v in fa.LAUNCHES.items() if v)}")
    del model
    torch.cuda.empty_cache()

    torch.manual_seed(6)
    vae = AutoencoderKL(device="cuda").eval()
    z = torch.randn(1, 4, 128, 128, generator=g, device="cuda")
    tf32 = torch.backends.cudnn.allow_tf32
    try:
        for allow in (False, True):
            torch.backends.cudnn.allow_tf32 = allow
            with torch.no_grad():
                decode = lambda: decode_from_latent(vae, z)
                torch.cuda.reset_peak_memory_stats()
                times = _timed(decode)
                print(f"cuDNN TF32 {'on' if allow else 'off'}: host-clock ms per 1024^2 fp32 "
                      f"decode {times}, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
                report(decode, f"1024^2 decode, TF32 {'on' if allow else 'off'}", VAE_GROUPS)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


if __name__ == "__main__":
    main()

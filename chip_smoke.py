"""Drive the PyTorch port's main path once on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero before the
last line:
1. device: CUDA must be available; prints the card's name and power limit,
   and the installations the data path depends on (Pillow, PyYAML, h5py,
   tokenizers, transformers, g++, libjpeg's and libpng's headers);
2. build: compiles every kernel from lumina_t2x_tpu_torch/csrc with nvcc
   (`ops/cuda_lib.py`: one library per module that owns kernels, one
   process per source, all started together) and prints the build seconds,
   then the resources of the Hopper kernels of bf16 K1-K5 and K9
   (`csrc/flash_fwd_sm90.cu`), bf16 K6-K8 (`csrc/flash_bwd_sm90.cu`: the
   backward sweep of K6/K8 and the dQ kernel of K7), K10 v0-v3 and K11
   (`csrc/static_max_sm90.cu`, one instantiation each) and K12
   (`csrc/mma_probe.cu`, at the widths of its timed shape and of K=1024):
   registers per thread (as compiled and after setmaxnreg), spill bytes (0
   required), shared memory per block, blocks per SM; the fp32 forward's
   (`csrc/flash_fwd_fp32_sm90.cu`, fp32 K1-K5 and K9) plan and resources
   at the served audio shape and the 2B's; the fp32 backward's
   (`csrc/flash_bwd_fp32_sm90.cu`, fp32 and fp16 K6-K8) plan and resources
   at the music trainer's shapes and the 2B's (0 spill bytes required); and
   what ptxas says of their wgmma;
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
   served worker and the training cross-attention launch them; fp32 K6-K8
   at the 2B's shape with a masked tail, at the fp32 rate's bound over the
   valid keys, the rows of the fp16 trainer leg); then the
   fused-RoPE kernels (K9: `rope` at Sq=Sk=4096, `rope_q` at Sk=32 and 256
   with the 2B's 1024^2 angles) against their plain versions, against
   themselves on `apply_rope`d inputs at zero angles, and bit for bit
   against the unfused entry point the same call would take on `apply_rope`d
   inputs (`flash_online` for `rope`, `flash_small_kv` for `rope_q`: K9 runs
   their kernel, with q rotated in it and k by `rope_rotate`), timed beside
   that entry point, and their gradient (`_FlashAttentionRope` through the
   kernels against the plain Function); `rope_rotate` against `apply_rope`
   bit for bit, timed at the 2B's k; then K1 at the class-conditional 600M's
   self-attention (bf16 (8, 256, 32, 48): 4 labels under CFG at 256^2),
   kernel and sdpa timed in bursts of 8; K1 and K4 (forward) and K6-K8
   (backward) also at Gemma caption lengths Sk = 8, 40 and 136 with masks
   ending inside a key tile (`CAPTION_LENGTHS`), bf16, fp32 and GQA, within
   the same bars; K4 and K6-K8 at head_dim 48 (the 64/64 instantiations) at
   the class-conditional trainers' shapes (`D48_SHAPES`: the 600M recipe's
   (256, 256, 32, 48), the Small's (64, 1024, 8, 48)) and K1 at the Small's
   sampler shape, timed with bounds and library calls, then with 4:1 GQA, a
   masked tail and a fully masked row; K2-K8 at head_dim 96 (the 128/128
   instantiations) at the Flag-DiT 5B's (2, 4160, 32, 96), K1 there against
   128 caption keys (100 valid), K4 and K6-K8 against 32, and K1 at head_dim
   128 at the ImageNet 7B's (8, 256, 32, 128), the same way
   (`wide_head_kernel_phase`); K1 behind 4096 queries over kv_merge's 1024
   pooled keys and K4/K6-K8 at the 2B's DreamBooth self-attention (2, 256,
   32, 72), K2 on MMDiT-SD3-Medium's unmasked joint sequence (2, 4429, 24,
   64) and K4/K6-K8 on DreamBooth's (2, 589, 24, 64), the same way
   (`anagram_sd3_kernel_phase`); fp32 K2-K5 at the 2B's (2, 4096, 32, 72)
   against the fp32 rate's bound and fp32 sdpa / aten's memory-efficient
   attention with its LSE (`fp32_forward_phase`; printed, not on the
   kernels line: no main path runs them);
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
   same model through `sample_lib` with calibration, both timed;
5a. vae: the SD-VAE (`codecs/vae.py`: ch 128, (1, 2, 4, 4), 2 resnets, z 4,
   quant convs) from a seed, written as `.safetensors` and read back with
   `load_vae`; the trajectory's 1024^2 latent decoded in fp32 with cuDNN's
   TF32 convolutions off and on (median of 3, peak memory, FLOPs, bound);
   decode and `encode_to_latent` on the card against the CPU at 256^2 under
   both (relative L2 within 1e-3 / 1e-2); the SD3 layout decoded once;
5b. classcond: `pipelines.sample.main` with the randomised
   NextDiT_ImageNet_600M_patch2 saved as a checkpoint (`--ckpt`), 4 labels
   at 256^2, 30-point midpoint, CFG 4, `--vae_ckpt`: four PNGs from exactly
   928 K1 launches (16 layers x 58 evaluations; the main path of K1's
   600M line) and no plain-version call; then `--num_fid_samples 8
   --batch_size 4` (the ADM npz) and `--pixel_space` at 64^2; and the 2B
   through the same CLI at 1024^2, 10 steps, `--vae_ckpt`: one 1024^2 PNG;
5f. classtrain: README's "ImageNet training" recipe through the trainer CLI
   (NextDiT_ImageNet_600M_patch2, 256^2, B=256, lr 5e-4, qk-norm, lognorm,
   `--vae_ckpt` the random VAE, `--checkpointing`, bf16 Adafactor) on a
   shapes ImageFolder of 16 x 16 PNGs at 256^2: 3 steps, then
   `--auto_resume` for a 4th under LUMINA_FLASH_FUSED_BWD=0 (the head_dim-48
   600M rows' main path); s/step, imgs/s, data wait, VAE-encode ms, peak
   memory, launches; then `pipelines.sample.main --ckpt` on it with
   `--solver dopri5` and `dopri8` (4 labels at 256^2, `--vae_ckpt`): PNGs,
   NFE and seconds;
5d. textenc: GemmaModel at Gemma-2B's published widths (`GEMMA_2B`), bf16,
   random from seed 0, with the port's in-memory character-level tokenizer,
   saved to build/ and read back by `DecoderTextEncoder.from_pretrained`;
   features equal to decoder layer L-2's output (a forward hook) bit for
   bit; the encode of 2 prompts + 2 empty captions (up to 256 tokens) timed,
   with its peak memory; then `pipelines.sample.main --text_encoder` (2B,
   qk-norm, 1024^2, 10 steps, `--vae_ckpt`): one PNG, K1 at Sk=40;
5e. t2idata: the trainer CLI on a block-YAML meta dataset of 8 PNGs
   (1024x1024 and 1536x768) at --image_size 1024: 2B, 3 steps, bf16
   Adafactor, B=2, --checkpointing, Gemma-2B and the VAE in the loop,
   decoded by Pillow (the trainer's one decoder), captions encoded in the
   loader's collate thread; finite losses over at least 2 buckets, data
   wait, encoder and VAE-encode ms, peak memory; then
   `pipelines.encode_latents.main` on 4 images (no checkpoint is written: the
   call's 45 GiB of disk writes);
5g. flagdit: the Flag-DiT 5B (`DiT_Llama_5B_patch2`, 5.05B, bf16 parameters,
   zero-init tensors randomised) CFG forward at 1024^2 through the kernels,
   the plain versions and sdpa; the sampler CLI on it (`--bf16_params
   --qk_norm`, 10 points, the captions of a random LLaMA-2-7B-wide LM of 2
   layers, `--vae_ckpt`): calibrated bound, s a step, peak, launches; the
   ImageNet 7B at 256^2 (K1 at head_dim 128); compositional: the app at
   1024^2 with a 1 x 4 region grid, 30 points (K2; the region
   cross-attention plain, as in JAX); img2img: the 2B at 1024^2, strength
   0.6, 30 points (VAE encode ms, bound, seconds, PNG);
   anagrams: `anagrams_app` on the 2B (2 prompts, identity / rotate_180,
   256^2 -> 1024^2 through the random VAE) at 30 steps, phase 2
   calibrated under the anagram scale, and at --kv_merge_ratio 2 and 10
   steps (K1 over the pooled keys); sd3: `sample_sd3` on MMDiT-SD3-Medium
   (random weights written as a bf16 diffusers-layout file and read back
   through the importer; CLIP-L and CLIP-G at their published widths,
   random, with the hash tokenizer) at 1024^2, 28 Euler steps, CFG 7, the
   z=16 VAE, and one forward through the kernels against the plain
   versions; dreambooth: 3 full-width steps of the 2B and of MMDiT with
   prior preservation at 256^2 (fp32 AdamW; the third under
   LUMINA_FLASH_FUSED_BWD=0), then the CLI in both modes cut to one layer
   or block, with its checkpoint;
   then the `lumina` CLI's `infer` (2B, 1024^2, the repo's settings,
   --debug: no qk-norm, so no calibration, as in the JAX CLI);
5c. serving: `build_worker` (2B, bf16, --debug, zero-init tensors
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
   fp32 forward's share, `csrc/flash_fwd_fp32_sm90.cu`, and the Hopper
   forward's);
8. trainer: the trainer CLI (`pipelines.train.main`, 2B at full width and
   depth, 1024^2 latents, B=2, bf16, --checkpointing, --flash_static_max
   auto, bf16 Adafactor so that two checkpoints fit the machine's disk-write
   limit) for 3 steps, then --auto_resume for a 4th step with
   LUMINA_FLASH_FUSED_BWD=0: the second main path, whose training kernel
   launches are counted; then `lumina infer --ckpt` on that checkpoint
   (10 steps, settings written to a temporary YAML file);
8b. fp16train: the trainer CLI at its docstring's 2B recipe with
   `--precision fp16` (1024^2 latents, B=2, fp32 gradients, --checkpointing,
   AdamW) for 3 steps, the 3rd under LUMINA_FLASH_FUSED_BWD=0, no checkpoint:
   fp16 attention runs the fp32 kernels (cast once at the wrapper); finite
   losses, 0 plain-version calls, K4 and K6-K8 launched (the fp32 2B rows);
9. pixel: NextDiT_ImageNet_Small_patch2 in pixel space at 64^2 through the
   trainer CLI on a shapes ImageFolder, B=64, 5 steps; quality:
   `lumina_t2x_tpu_torch/exps/quality_flow.py` cut to QUALITY_STEPS steps
   and QUALITY_FID_SAMPLES samples, its summary printed (the main path of
   the head_dim-48 Small rows);
10. flagtrain: the 5B trainer (1024^2, B=2, bf16 Adafactor, remat, qk-norm,
   train bound, 3 steps, the last under LUMINA_FLASH_FUSED_BWD=0, no
   checkpoint) and the Flag-DiT ImageNet 600M (256^2, B=256, 2 steps); moe:
   the three Next-DiT-MoE 600M trainers (256^2, B=256, `dots_slim` remat, 2
   steps), Both's checkpoint sampled, the others with random weights;
11. audio: the audio and music family. Kernel rows (`audio_kernel_phase`,
   in phase 3's list): K1 in fp32 (the fp32 kernel of
   `csrc/flash_fwd_fp32_sm90.cu`: the app builds FlagDiT-1D in fp32; its
   device time under `torch.profiler` and the wrapper's host time beside the
   CUDA-event time) and bf16 at the served request's (2, 128, 16, 72) over
   its 128 frames and over the 16 caption tokens, K4 and K6-K8 at the trainer's (32, 256, 16, 72) over 256
   and over 77 keys, K6-K8 there also in fp32 (`csrc/flash_bwd_fp32_sm90.cu`);
   `audio`: `build_audio_stack(debug=False)` (FlagDiT-1D
   1152 wide, 28 layers, 16 heads, ~0.74B, fp32, zero-init tensors
   randomised; the random 1-D VAE ch 128; BigVGAN 1536 wide), one CFG forward
   through the kernels, the plain versions and sdpa in fp32 and in bf16
   activations, then `serve_audio.AudioDemoApp` behind `make_server`: one
   25-point CFG-3 request (128 latent frames -> 256 mel frames -> 65,536
   samples: exactly 1344 fp32 K1 launches, no plain-version call), a 400;
   a CFG forward, the VAE decode and the vocoder timed; `audio_app.main`
   twice, the second with `--vae_ckpt` / `--vocoder_ckpt` on random
   Make-An-Audio-2 (ch 384) and BigVGAN (weight_g / weight_v) files written
   by the phase; `audiotrain`: `train_audio.main` at its defaults (B=32, 256
   frames, 77 caption tokens, bf16, AdamW) for 3 steps without a checkpoint,
   then cut to one layer for 3 steps, a checkpoint and an `--auto_resume`
   step under LUMINA_FLASH_FUSED_BWD=0, then at full depth with
   `--precision fp32` for 3 steps (fp32 K6) and a 4th under
   LUMINA_FLASH_FUSED_BWD=0 (fp32 K7 + K8), no checkpoint; `judge`: `clap_eval_directory` over
   the three WAVs with Cnn14 and a BERT-base-wide caption tower (random, the
   hash tokenizer), then MPD and MRD forward and backward with the three
   GAN losses.
`multigpu` (after `trainer`, inside its results directory): the trainer
under `torchrun --standalone --nproc_per_node 1` (`python -m
torch.distributed.run`), NCCL, the (data 1, model 1) mesh, tensor
parallelism and FSDP2 (`--data_parallel fsdp`), trainer's argv: 3 fresh
steps held against trainer's losses and grad norms of the same seed, then
a torchrun resume of trainer's one-process checkpoint for a 5th step held
against a one-process resume of the same checkpoint (across launch modes).
The torchrun child is this script in its child mode, which calls
`pipelines.train.main` with the checkpoint write turned off: the call's 45
GiB of disk writes leave no room for another 7.4 GiB 2B checkpoint. Its
kernel launches (from its `run_summary.json`) join the kernels line. Then
the ring fold of context-parallel attention (`ops/context_parallel.ring_fold`)
at the 2B's (2, 4096, 32, 72) bf16 over 4 key blocks through K4, against K2
over all keys and against the plain ring, with no mask and with one block
wholly masked.
12. The last slice (after the audio phases): `imgsizes` (the 2B's
`img_sizes` list path, bf16: a 1024 x 1280 bucket holding a 1024^2 and a
768 x 1280 item, K2 and K4 in a calibration-probe forward, K3 under its
bound; each item against itself alone on the uniform grid and the batch
against `attn_impl="plain"` within 2e-2 relative L2; its K2-K4 rows at the
bucket's (2, 5120, 32, 72) with each row's pad keys masked are timed in
phase 3); `longcontext` (`exps/longcontext_forward.py`'s 2B forward at
131072 image tokens under LUMINA_FUSE_ROPE=1: ms, tokens/s, peak memory;
layer 0's K9 calls against the plain version on 256 sampled rows and, in
chunks, on every row; K9 and `rope_rotate` rows at that shape);
`likelihood` (`Sampler.sample_ode_likelihood` on the 600M ImageNet model,
`attn_impl="xla"`: the zero field gives the prior's density, euler and
dopri5 finite, the flash path refused); `asyncsave` (the music trainer cut to
one layer with `--async_save`: its checkpoints equal `save_checkpoint`'s of
the same state, the seconds `save` blocks against the synchronous save's,
the same resumed step-5 loss); `profile` (the 600M trainer's
`--profile_steps 2`: the trace holds the Hopper forward and backward kernels
on its CUDA timeline).
The line before the last is a JSON object of the kernels; the last line is
{"ok": true, "device": {...}}.
"""

import base64
import gc
import json
import math
import os
import re
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import zlib

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SM90_SOURCE = "lumina_t2x_tpu_torch/csrc/flash_fwd_sm90.cu"  # bf16 K1-K5, K9
FP32_SOURCE = "lumina_t2x_tpu_torch/csrc/flash_fwd_fp32_sm90.cu"  # fp32 K1-K5, K9
SM90_BWD_SOURCE = "lumina_t2x_tpu_torch/csrc/flash_bwd_sm90.cu"  # bf16 K6-K8
FP32_BWD_SOURCE = "lumina_t2x_tpu_torch/csrc/flash_bwd_fp32_sm90.cu"  # fp32 (and fp16) K6-K8
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
    # K1 at the class-conditional 600M's self-attention (the classcond path)
    "small_kv_imagenet_600m": (SM90_SOURCE, f"{TPU_KERNELS}:240"),
    # head_dim 48, the class-conditional trainers: the 600M recipe at 256^2
    # (classtrain; K7/K8 on its resumed step) and the Small in pixel space at
    # 64^2 (pixel and quality; K1 from the quality flow's sampler)
    "online_lse_d48_600m": (SM90_SOURCE, f"{TPU_KERNELS}:430"),
    "bwd_fused_d48_600m": (SM90_BWD_SOURCE, f"{TPU_KERNELS}:619"),
    "bwd_dq_d48_600m": (SM90_BWD_SOURCE, f"{TPU_KERNELS}:552"),
    "bwd_dkv_d48_600m": (SM90_BWD_SOURCE, f"{TPU_KERNELS}:584"),
    "online_lse_d48_small": (SM90_SOURCE, f"{TPU_KERNELS}:430"),
    "bwd_fused_d48_small": (SM90_BWD_SOURCE, f"{TPU_KERNELS}:619"),
    "small_kv_d48_small": (SM90_SOURCE, f"{TPU_KERNELS}:240"),
    # head_dim 96, the Flag-DiT 5B (the 128/128 instantiations): its sampler
    # (K1 on the captions, K2 and K4 in the calibration probe, K3 on the
    # trajectory) and its trainer (K4, K5 under the train bound, K6; K7/K8 on
    # its last step)
    "small_kv_d96_5b": (SM90_SOURCE, f"{TPU_KERNELS}:240"),
    "online_d96_5b": (SM90_SOURCE, f"{TPU_KERNELS}:228"),
    "static_max_d96_5b": (SM90_SOURCE, f"{TPU_KERNELS}:66"),
    "online_lse_d96_5b": (SM90_SOURCE, f"{TPU_KERNELS}:430"),
    "static_max_lse_d96_5b": (SM90_SOURCE, f"{TPU_KERNELS}:446"),
    "bwd_fused_d96_5b": (SM90_BWD_SOURCE, f"{TPU_KERNELS}:619"),
    "bwd_dq_d96_5b": (SM90_BWD_SOURCE, f"{TPU_KERNELS}:552"),
    "bwd_dkv_d96_5b": (SM90_BWD_SOURCE, f"{TPU_KERNELS}:584"),
    # head_dim 128: K1 as the Flag-DiT ImageNet 7B's self-attention
    "small_kv_d128_7b": (SM90_SOURCE, f"{TPU_KERNELS}:240"),
    # K1 over kv_merge's 1024 pooled keys behind 4096 queries (the anagram
    # app's phase 2 at --kv_merge_ratio 2)
    "small_kv_kv1024": (SM90_SOURCE, f"{TPU_KERNELS}:240"),
    # head_dim 64, MMDiT-SD3-Medium: K2 on the sampler's unmasked joint
    # [context; image] sequence at 1024^2 (333 + 4096 keys, no tile-aligned
    # length), K4 and K6-K8 on DreamBooth's at 256^2 (333 + 256)
    "online_d64_sd3": (SM90_SOURCE, f"{TPU_KERNELS}:228"),
    "online_lse_d64_sd3": (SM90_SOURCE, f"{TPU_KERNELS}:430"),
    "bwd_fused_d64_sd3": (SM90_BWD_SOURCE, f"{TPU_KERNELS}:619"),
    "bwd_dq_d64_sd3": (SM90_BWD_SOURCE, f"{TPU_KERNELS}:552"),
    "bwd_dkv_d64_sd3": (SM90_BWD_SOURCE, f"{TPU_KERNELS}:584"),
    # K4 and K6-K8 at the 2B's DreamBooth self-attention (256^2: 16 x 16 tokens)
    "online_lse_db_2b": (SM90_SOURCE, f"{TPU_KERNELS}:430"),
    "bwd_fused_db_2b": (SM90_BWD_SOURCE, f"{TPU_KERNELS}:619"),
    "bwd_dq_db_2b": (SM90_BWD_SOURCE, f"{TPU_KERNELS}:552"),
    "bwd_dkv_db_2b": (SM90_BWD_SOURCE, f"{TPU_KERNELS}:584"),
    # FlagDiT-1D (audio and music, head_dim 72): K1 in fp32 (the served app
    # builds the model in fp32: the fp32 kernel) and bf16 at the served
    # request's self-attention, K4 and K6-K8 at the trainer's
    "small_kv_fp32_audio": (FP32_SOURCE, f"{TPU_KERNELS}:240"),
    "small_kv_audio": (SM90_SOURCE, f"{TPU_KERNELS}:240"),
    "online_lse_audio": (SM90_SOURCE, f"{TPU_KERNELS}:430"),
    "bwd_fused_audio": (SM90_BWD_SOURCE, f"{TPU_KERNELS}:619"),
    "bwd_dq_audio": (SM90_BWD_SOURCE, f"{TPU_KERNELS}:552"),
    "bwd_dkv_audio": (SM90_BWD_SOURCE, f"{TPU_KERNELS}:584"),
    # fp32 K6-K8 (`csrc/flash_bwd_fp32_sm90.cu`) at the music trainer's
    # self-attention (its `--precision fp32` leg) and at the 2B's (2, 4096, 32,
    # 72), where the image trainer's `--precision fp16` leg runs them and the
    # fp32 K4 forward (fp16 cast to fp32 at the wrapper)
    "bwd_fused_fp32_audio": (FP32_BWD_SOURCE, f"{TPU_KERNELS}:619"),
    "bwd_dq_fp32_audio": (FP32_BWD_SOURCE, f"{TPU_KERNELS}:552"),
    "bwd_dkv_fp32_audio": (FP32_BWD_SOURCE, f"{TPU_KERNELS}:584"),
    "bwd_fused_fp32_2b": (FP32_BWD_SOURCE, f"{TPU_KERNELS}:619"),
    "bwd_dq_fp32_2b": (FP32_BWD_SOURCE, f"{TPU_KERNELS}:552"),
    "bwd_dkv_fp32_2b": (FP32_BWD_SOURCE, f"{TPU_KERNELS}:584"),
    "online_lse_fp32_2b": (FP32_SOURCE, f"{TPU_KERNELS}:430"),
    # the 2B's img_sizes list path (a bucket holding two aspect ratios, each
    # item's pad keys masked): K2 and K3 in the self-attention, K4 in the
    # calibration probe
    "online_imgsizes_2b": (SM90_SOURCE, f"{TPU_KERNELS}:228"),
    "static_max_imgsizes_2b": (SM90_SOURCE, f"{TPU_KERNELS}:66"),
    "online_lse_imgsizes_2b": (SM90_SOURCE, f"{TPU_KERNELS}:430"),
    # the 2B's forward at 131072 image tokens under LUMINA_FUSE_ROPE=1: K9's
    # self-attention over 131072 keys, its cross-attention over the caption,
    # and the rotation of k
    "rope_128k": (SM90_SOURCE, f"{TPU_KERNELS}:956"),
    "rope_q_128k": (SM90_SOURCE, f"{TPU_KERNELS}:963"),
    "rope_rotate_128k": (ROTATE_SOURCE, f"{TPU_KERNELS}:949"),
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
# NextDiT_ImageNet_600M_patch2 at 256^2 under CFG: 4 labels doubled, 16 x 16
# tokens, 32 heads of 48; 16 layers x 58 evaluations of a 30-point midpoint grid
IMAGENET_SHAPE, IMAGENET_LAUNCHES = (8, 256, 32, 48), 16 * 58
LABELS = "207,360,387,974"
# head_dim 48 at the class-conditional trainers' shapes (B, S, H): the 600M's
# README recipe (B=256 at 256^2: 16 x 16 tokens, 32 heads) and the Small's
# quality run (B=64 at 64^2 in pixel space: 32 x 32 tokens, 8 heads); the
# Small's sampler runs K1 on the FID batches of 64 under CFG
D48_SHAPES = {"600m": (256, 256, 32), "small": (64, 1024, 8)}
D48_K1_SMALL = (128, 1024, 8)
# head_dim 96 and 128: the Flag-DiT 5B at 1024^2 under CFG (2 rows of 64 x 65
# tokens with the [eol] column, 32 heads of 96) against up to 128 caption
# keys (the kernel check: 100 of them valid); the Flag-DiT ImageNet 7B's
# self-attention at 256^2, 4 labels under CFG
D96_SHAPE, D96_CAPTION, D128_K1 = (2, 4160, 32, 96), (128, 100), (8, 256, 32, 128)
# meta-llama/Llama-2-7b-hf's config.json (the 5B's caption LM), depth cut to
# LLAMA_LAYERS decoder layers: the features are hidden_states[-2]
LLAMA_2_7B = dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                  num_attention_heads=32, num_key_value_heads=32, max_position_embeddings=4096)
LLAMA_LAYERS = 2
# the 5B sampler's prompt: 127 characters + <bos> = 128 caption tokens
FLAG_PROMPT_CHARS = 127
# the new class-conditional trainers: 256^2 latents, B=256, 2 steps
MOE_MODELS = ("NextDiT_MoE_600M_patch2_Time", "NextDiT_MoE_600M_patch2_Spatial",
              "NextDiT_MoE_600M_patch2_Both")
# the classtrain phase: README's "ImageNet training" recipe on a 16-class
# shapes ImageFolder of 16 images each at 256^2 (one batch of 256)
CLASSTRAIN_IMAGES_PER_CLASS, CLASSTRAIN_B = 16, 256
# the quality phase: exps/quality_flow.py cut to fit this script's time
QUALITY_STEPS, QUALITY_FID_SAMPLES, QUALITY_PER_CLASS = 200, 128, 50
# H100 SXM dense TF32 tensor-core peak (NVIDIA's data sheet, 700 W)
PEAK_TF32 = 495e12
# the anagram app: NextDiT_2B_patch2, 2 prompts and views, 256^2 -> 1024^2; the
# kv_merge run is cut to fewer steps (each phase costs (steps - 1) x views x 2
# CFG forwards)
ANAGRAM_VIEWS, ANAGRAM_STEPS, ANAGRAM_KV_STEPS = ("identity", "rotate_180"), 30, 10
ANAGRAM_PROMPTS = ("an oil painting of a snowy mountain village", "an oil painting of a horse")
# K1 behind phase 2's 4096 queries over kv_merge's 1024 pooled keys
KV1024 = (2, 4096, 32)
# MMDiT-SD3-Medium: 24 heads of 64; the joint sequence is 77 CLIP + 256 T5
# (zeros) context tokens before the image's 64 x 64 (1024^2) or 16 x 16 (256^2)
SD3_CONTEXT, SD3_STEPS = 77 + 256, 28
SD3_JOINT_1024, SD3_JOINT_256 = (2, SD3_CONTEXT + 4096, 24), (2, SD3_CONTEXT + 256, 24)
# DreamBooth: the 2B's self-attention at 256^2 (instance + class row)
DB_2B = (2, 256, 32)
# FlagDiT-1D (1152 wide, 28 layers, 16 heads of 72). The served request: a CFG
# batch of 2 over 128 latent frames against the 16 pseudo caption tokens, 25
# points (24 Euler steps), a self- and a cross-attention K1 call per layer
AUDIO_SERVE, AUDIO_CONTEXT, AUDIO_POINTS, AUDIO_LAYERS = (2, 128, 16), 16, 25, 28
AUDIO_K1_LAUNCHES = (AUDIO_POINTS - 1) * AUDIO_LAYERS * 2
# the trainer's defaults: B=32 over 256 latent frames against 77 caption tokens
AUDIO_TRAIN, AUDIO_TRAIN_CONTEXT = (32, 256, 16), 77
AUDIO_PROMPTS = ("gentle rain on a tin roof followed by distant thunder",
                 "a slow cello melody over soft piano chords",
                 "birds chirping, then a dog barks")
# CLAP 2022's audio tower (Cnn14 at its published widths, AudioSet's 527
# classes) and its 1024-wide projection
CNN14_CHANNELS, CLAP_CLASSES, CLAP_PROJ = (64, 128, 256, 512, 1024, 2048), 527, 1024
# the VAE's decode on the card against the CPU's, relative L2: fp32 convolutions
# only sum in another order; TF32 rounds each convolution's operands to 10
# mantissa bits (2^-11 relative), about 30 convolutions in series
VAE_REL_FP32, VAE_REL_TF32 = 1e-3, 1e-2


# the imgsizes phase: the 2B on a 1024 x 1280 bucket (latent 128 x 160: 64 x 80
# = 5120 tokens) holding a 1024^2 item (latent 128 x 128: 4096 tokens) and a
# 768 x 1280 one (96 x 160: 48 x 80 = 3840 tokens)
IMGSIZES_BUCKET, IMGSIZES_ITEMS = (128, 160), ((128, 128), (96, 160))
IMGSIZES_SHAPE, IMGSIZES_VALID = (2, 5120, 32), (4096, 3840)
# the longcontext phase: 512 x 256 tokens (latent 1024 x 512) beside 256 caption
# tokens; K9's output checked on LONG_SAMPLE_ROWS query rows, the plain version
# timed over every row in chunks of LONG_PLAIN_CHUNK rows (a chunk's fp32
# logits over 131072 keys and 32 heads: 4.3 GB)
LONG_TOKENS, LONG_SAMPLE_ROWS, LONG_PLAIN_CHUNK = 131072, 256, 256


# Gemma captions: Sk a multiple of 8 up to 256, the CFG's empty caption one
# token (<bos>); the valid keys of the two batch rows end inside a 64-key tile
CAPTION_LENGTHS = {8: (1, 5), 40: (37, 21), 136: (130, 67)}
# google/gemma-2b's published config.json
GEMMA_2B = dict(vocab_size=256000, hidden_size=2048, intermediate_size=16384,
                num_hidden_layers=18, num_attention_heads=8, num_key_value_heads=1, head_dim=256,
                max_position_embeddings=8192)
LONG_PROMPT = ("a wide photograph of a mountain lake at sunrise, mist over the water, pine "
               "forest on both shores, a wooden rowing boat tied to a small jetty, snow on the "
               "distant peaks, soft golden light, reflections of the clouds, a heron standing in "
               "the shallows, high detail, natural colours, long exposure, 35mm film grain")


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
    of the same function): aten's flash attention in bf16, its
    memory-efficient attention (cutlass) in fp32, each on the timed case (no
    mask, as many kv heads as q heads). Returns its time, kernel and LSE."""
    assert mask is None and k.shape[2] == q.shape[2]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if q.dtype == torch.float32:
        fn = lambda: torch.ops.aten._scaled_dot_product_efficient_attention(  # noqa: E731
            qt, kt, vt, None, True, scale=scale)
    else:
        fn = lambda: torch.ops.aten._scaled_dot_product_flash_attention(  # noqa: E731
            qt, kt, vt, scale=scale)
    lse = fn()[1][..., :q.shape[1]]
    return {"library_ms": time_ms(fn), "library_kernel": top_kernel(fn), "library_lse": lse}


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
    # what decides the training image decoder (t2idata) and the data options
    import importlib

    found = []
    for module in ("PIL", "yaml", "h5py", "tokenizers", "transformers"):
        try:
            found.append(f"{module} {getattr(importlib.import_module(module), '__version__', '?')}")
        except ImportError:
            found.append(f"{module} absent")
    try:
        gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True).stdout
        found.append(gxx.splitlines()[0] if gxx else "g++ silent")
    except FileNotFoundError:
        found.append("g++ absent")
    found += [f"{h} {'present' if os.path.exists(h) else 'absent'}"
              for h in ("/usr/include/jpeglib.h", "/usr/include/png.h")]
    phase("device", "installed: " + "; ".join(found))


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
    for source, entry, head_dim, info in (
            (SM90_SOURCE, "small_kv, online, online_lse, rope, rope_q", D,
             flash_attention.sm90_attributes(False, D)),
            (SM90_SOURCE, "static_max, static_max_lse", D,
             flash_attention.sm90_attributes(True, D)),
            (SM90_SOURCE, "small_kv, the ImageNet 600M's 64/64 instantiation", IMAGENET_SHAPE[3],
             flash_attention.sm90_attributes(False, IMAGENET_SHAPE[3])),
            (SM90_BWD_SOURCE, "bwd_fused", D, flash_attention.bwd_sm90_attributes("fused", D)),
            (SM90_BWD_SOURCE, "bwd_dkv", D, flash_attention.bwd_sm90_attributes("dkv", D)),
            (SM90_BWD_SOURCE, "bwd_dq", D, flash_attention.bwd_sm90_attributes("dq", D)),
            *((SM90_SOURCE, f"{entries}, the 128/128 instantiation", d,
               flash_attention.sm90_attributes(static, d))
              for d in (96, 128) for static, entries in (
                  (False, "small_kv, online, online_lse"), (True, "static_max, static_max_lse"))),
            *((SM90_BWD_SOURCE, f"bwd_{kernel}, the 128/128 instantiation", d,
               flash_attention.bwd_sm90_attributes(kernel, d))
              for d in (96, 128) for kernel in ("fused", "dkv", "dq")),
            *((VPU_SOURCE, f"static_max_{variant}", D, vpu_op_reduction.sm90_attributes(variant, D))
              for variant in vpu_op_reduction.VARIANTS)):
        phase("build", f"{source} ({entry}, head_dim {head_dim}): {info['registers']} registers "
              f"per thread as compiled, {info['producer_registers']} (producer) / "
              f"{info['consumer_registers']} (consumers) after setmaxnreg, "
              f"{info['local_bytes']} local (spill) bytes per thread, {info['shared_bytes']} bytes "
              f"of shared memory per block, {info['blocks_per_sm']} block(s) of "
              f"{info['threads']} threads per SM")
        require(info["local_bytes"] == 0, f"{source} ({entry}) spills")
    # the fp32 forward (K1-K5, K9 in fp32): the plan the host makes and the
    # resources of the instantiation it launches, at the served audio shape
    # (the keys split over 4 warps) and at the 2B's (128 rows a block)
    for label, shape in (("FlagDiT-1D served", (*AUDIO_SERVE[:2], AUDIO_SERVE[1],
                                                 AUDIO_SERVE[2], AUDIO_SERVE[2], 72)),
                         ("2B", (B, S, S, H, H, D))):
        for static in (False, True):
            info = flash_attention.fp32_attributes(static, *shape)
            phase("build", f"{FP32_SOURCE} ({'static_max' if static else 'online'}, {label} "
                  f"{shape}): {info['rows_per_block']} query rows a block, keys split over "
                  f"{info['key_warps']} warp(s), {info['grid_blocks']} blocks; "
                  f"{info['registers']} registers per thread, {info['local_bytes']} local (spill) "
                  f"bytes per thread, {info['shared_bytes']} bytes of shared memory per block, "
                  f"{info['blocks_per_sm']} block(s) of {info['threads']} threads per SM")
            require(info["local_bytes"] == 0, f"{FP32_SOURCE} ({label}) spills")
    # the fp32 backward (K6-K8 in fp32 and fp16): plan and resources at the
    # music trainer's self- and cross-attention and at the 2B's
    b, s, h = AUDIO_TRAIN
    for label, shape in (("music trainer, 256 frames", (b, s, s, h, h, 72)),
                         ("music trainer, 77 caption keys", (b, s, AUDIO_TRAIN_CONTEXT, h, h, 72)),
                         ("2B", (B, S, S, H, H, D))):
        for kernel in ("fused", "dkv", "dq"):
            info = flash_attention.bwd_fp32_attributes(kernel, *shape)
            phase("build", f"{FP32_BWD_SOURCE} (bwd_{kernel}, {label} {shape}): "
                  f"{info['rows_per_block']} {'q rows' if kernel == 'dq' else 'keys'} a block, "
                  f"{info['rows_per_tile']} {'keys' if kernel == 'dq' else 'q rows'} a streamed "
                  f"tile, {info['grid_blocks']} blocks; {info['registers']} registers per thread, "
                  f"{info['local_bytes']} local (spill) bytes per thread, {info['shared_bytes']} "
                  f"bytes of shared memory per block, {info['blocks_per_sm']} block(s) of "
                  f"{info['threads']} threads per SM")
            require(info["local_bytes"] == 0, f"{FP32_BWD_SOURCE} (bwd_{kernel}, {label}) spills")
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


def caption_mask(sk):
    mask = torch.zeros(B, sk, dtype=torch.int32, device="cuda")
    for row, n in enumerate(CAPTION_LENGTHS[sk]):
        mask[row, :n] = 1
    return mask


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


def caption_kernel_phase(fa, results):
    """K1 (`flash_small_kv`, the sampler's cross-attention) and K4
    (`flash_online_lse`, the trainer's) at Gemma caption lengths Sk = 8, 40,
    136 with masks ending inside a key tile (`CAPTION_LENGTHS`; no row fully
    masked), bf16, fp32 and bf16 GQA, against their plain versions within the
    bf16 bar as K9's, 1e-2 of max(1, max|ref|): a row with one valid key (the
    empty caption) outputs that key's value itself, and a value in [4, 8)
    carries one bf16 output rounding of up to 1.6e-2; the bf16 case timed.
    The worst errors join the kernels line."""
    g = torch.Generator(device="cuda").manual_seed(2)
    scale = D ** -0.5
    for entry in ("small_kv", "online_lse"):
        kernel = getattr(fa, f"flash_{entry}")
        plain = getattr(fa, f"flash_{entry}_plain")
        for sk in CAPTION_LENGTHS:
            mask = caption_mask(sk)
            for label, dtype, hkv in (("bf16", torch.bfloat16, H), ("fp32", torch.float32, H),
                                      ("bf16 gqa8", torch.bfloat16, 8)):
                q = _rand(g, B, S, H, D, dtype=dtype)
                k = _rand(g, B, sk, hkv, D, dtype=dtype)
                v = _rand(g, B, sk, hkv, D, dtype=dtype)
                got = kernel(q, k, v, mask, scale)
                ref = plain(q.float(), k.float(), v.float(), mask, scale)
                torch.cuda.synchronize()
                line = f"{entry} {label} (caption Sk={sk}, valid keys {CAPTION_LENGTHS[sk]}): "
                if entry.endswith("_lse"):
                    (got, lse), (ref, ref_lse) = got, ref
                    require(bool(torch.isfinite(lse).all()), f"{entry} {label} Sk={sk}: LSE -inf")
                    lse_err = (lse - ref_lse).abs().max().item()
                    require(lse_err <= LSE_MAX, f"{entry} {label} Sk={sk}: LSE err {lse_err}")
                    line += f"LSE {lse_err:.3g}, "
                err = (got.float() - ref).abs()
                max_err, mean_err = err.max().item(), err.mean().item()
                top = max(1.0, ref.abs().max().item())
                bar = FP32_MAX if dtype == torch.float32 else BF16_MAX * top
                require(math.isfinite(max_err) and max_err <= bar,
                        f"{entry} {label} Sk={sk}: max abs err {max_err} > {bar}")
                if dtype == torch.bfloat16:
                    require(mean_err <= BF16_MEAN, f"{entry} {label} Sk={sk}: mean {mean_err}")
                results[entry]["max_abs_err"] = max(results[entry]["max_abs_err"], max_err)
                line += f"max abs err {max_err:.3g} (bar {bar:.3g}) mean {mean_err:.3g}"
                if label == "bf16":
                    ms = time_ms(lambda: kernel(q, k, v, mask, scale))
                    lse_bytes = B * H * S * 4 if entry.endswith("_lse") else 0
                    # the keys this run's masks leave valid
                    valid = sum(CAPTION_LENGTHS[sk]) / B
                    bound = least_time(_nbytes(q, k, v, mask, got) + lse_bytes,
                                       attention_ops(q, k, 2) * valid / sk, dtype)
                    line += (f"; kernel {ms:.3f} ms, plain "
                             f"{time_ms(lambda: plain(q, k, v, mask, scale)):.3f} ms, bound "
                             f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}), library "
                             f"{time_ms(lambda: _sdpa(q, k, v, mask, scale)):.3f} ms (sdpa)")
                phase("kernels", line)
                del q, k, v, got, ref
    torch.cuda.empty_cache()


# (label, dtype, sk, n_kv_heads, mask kind); the first is the timed main-path case
BWD_CASES = [("bf16", torch.bfloat16, S, H, "none"), ("fp32", torch.float32, S, H, "tail"),
             ("bf16 gqa8", torch.bfloat16, S, 8, "tail"),
             ("bf16 masked-row", torch.bfloat16, S, H, "row"),
             ("bf16 cross-attention", torch.bfloat16, TRAIN_CAP, H, "tail"),
             *(("bf16 caption", torch.bfloat16, sk, H, "caption") for sk in CAPTION_LENGTHS),
             ("fp32 caption", torch.float32, 40, H, "caption"),
             ("bf16 gqa8 caption", torch.bfloat16, 136, 8, "caption")]


def _bwd_bounds(q, k, v, out, dout, lse, dtype, mask=None):
    """Least times of K6, K7 and K8: read q, k, v, out, dO, LSE once; write
    what the kernel writes; 5, 3 and 4 Sq x Sk x D products over the keys
    `mask` leaves valid (a masked key adds nothing to any gradient)."""
    reads = _nbytes(q, k, v, out, dout, lse)
    keys = 1.0 if mask is None else (mask != 0).float().mean().item()
    return {"bwd_fused": least_time(reads + _nbytes(q, k, v), attention_ops(q, k, 5) * keys,
                                    dtype),
            "bwd_dq": least_time(reads + _nbytes(q), attention_ops(q, k, 3) * keys, dtype),
            "bwd_dkv": least_time(reads + _nbytes(k, v), attention_ops(q, k, 4) * keys, dtype)}


def backward_kernel_phase(fa):
    """K6 and K7 + K8 against `flash_bwd_plain` on the same inputs (q, k, v,
    dO, and out/LSE from the plain LSE forward); all three also timed at the
    cross-attention's Sk=32, and in fp32 at the 2B's shape (the fp32 rows).
    Bounds count the products over the keys each case's mask leaves valid."""
    g = torch.Generator(device="cuda").manual_seed(1)
    worst = {name: 0.0 for name in ("bwd_fused", "bwd_dq", "bwd_dkv")}
    times, fp32_rows = {}, {}
    for label, dtype, sk, hkv, mask_kind in BWD_CASES:
        q = _rand(g, B, S, H, D, dtype=dtype)
        k = _rand(g, B, sk, hkv, D, dtype=dtype)
        v = _rand(g, B, sk, hkv, D, dtype=dtype)
        dout = _rand(g, B, S, H, D, dtype=dtype)
        mask = None
        if mask_kind == "caption":
            mask = caption_mask(sk)
        elif mask_kind != "none":
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
        parts, case_worst = [], {}
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
                case_worst[name] = max(case_worst.get(name, 0.0), err.max().item())
                parts.append(f"{name}.{what} {rel_max:.2g}")
        line = f"backward {label} (Sk={sk}): max err / max|ref| " + ", ".join(parts)
        if not times:
            for name, fn in (("bwd_fused", fa.flash_bwd_fused), ("bwd_dq", fa.flash_bwd_dq),
                             ("bwd_dkv", fa.flash_bwd_dkv)):
                times[name] = time_ms(lambda: fn(*args), reps=5)
            times["plain"] = time_ms(lambda: fa.flash_bwd_plain(*args), reps=5)
            bounds = _bwd_bounds(q, k, v, out, dout, lse, dtype, mask)
            library = library_backward(q, k, v, mask, dout, scale)
            line += ("; " + ", ".join(f"{n} {t:.3f} ms" for n, t in times.items())
                     + "; bounds " + ", ".join(f"{n} {b_['bound_ms']:.4f} ms ({b_['bound_by']})"
                                              for n, b_ in bounds.items())
                     + f"; library backward {library['library_ms']:.3f} ms "
                       f"({library['library_kernel']})")
        elif label == "fp32":
            # fp32 K6-K8 (`csrc/flash_bwd_fp32_sm90.cu`; the fp16 trainer leg
            # runs them at this shape): their times, their least times at the
            # fp32 peak over the valid keys, plain and the fp32 library backward
            fp32_bounds = _bwd_bounds(q, k, v, out, dout, lse, dtype, mask)
            fp32_plain = time_ms(lambda: fa.flash_bwd_plain(*args), reps=3)
            fp32_library = library_backward(q, k, v, mask, dout, scale)
            timed = []
            for name, fn in (("bwd_fused", fa.flash_bwd_fused), ("bwd_dq", fa.flash_bwd_dq),
                             ("bwd_dkv", fa.flash_bwd_dkv)):
                ms = time_ms(lambda: fn(*args), reps=5)
                fp32_rows[f"{name}_fp32_2b"] = {
                    "max_abs_err": case_worst[name], "ms": ms, "plain_ms": fp32_plain,
                    "library_ms": fp32_library["library_ms"], **fp32_bounds[name]}
                timed.append(f"{name} {ms:.3f} ms (bound "
                             f"{fp32_bounds[name]['bound_ms']:.4f} ms, "
                             f"{fp32_bounds[name]['bound_by']})")
            line += (f"; {', '.join(timed)}; plain {fp32_plain:.3f} ms; fp32 library backward "
                     f"{fp32_library['library_ms']:.3f} ms ({fp32_library['library_kernel']})")
        elif label in ("bf16 cross-attention", "bf16 caption"):
            # the trainer's cross-attention: 24 of K6's (K7's) launches a step
            cross = _bwd_bounds(q, k, v, out, dout, lse, dtype, mask)
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
    return {**{name: {"max_abs_err": worst[name], "ms": times[name], "plain_ms": times["plain"],
                      **bounds[name], **library} for name in worst}, **fp32_rows}


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
def imagenet_kernel_phase(fa):
    """K1 (`flash_small_kv`) as the class-conditional 600M's self-attention:
    bf16 (B, S, H, D) = IMAGENET_SHAPE, no mask, against its plain version;
    kernel and sdpa timed in bursts of 8 calls (and one call each)."""
    g = torch.Generator(device="cuda").manual_seed(8)
    b, s, h, d = IMAGENET_SHAPE
    q, k, v = (_rand(g, b, s, h, d, dtype=torch.bfloat16) for _ in range(3))
    scale = d ** -0.5
    got = fa.flash_small_kv(q, k, v, None, scale)
    ref = fa.flash_small_kv_plain(q.float(), k.float(), v.float(), None, scale)
    err = (got.float() - ref).abs()
    max_err, mean_err = err.max().item(), err.mean().item()
    require(math.isfinite(max_err) and max_err <= BF16_MAX,
            f"small_kv at {IMAGENET_SHAPE}: max abs err {max_err} > {BF16_MAX}")
    require(mean_err <= BF16_MEAN, f"small_kv at {IMAGENET_SHAPE}: mean abs err {mean_err}")
    burst = 8
    timed = {"ms": time_ms(lambda: [fa.flash_small_kv(q, k, v, None, scale)
                                    for _ in range(burst)]) / burst,
             "plain_ms": time_ms(lambda: fa.flash_small_kv_plain(q, k, v, None, scale)),
             "library_ms": time_ms(lambda: [_sdpa(q, k, v, None, scale)
                                            for _ in range(burst)]) / burst,
             **least_time(_nbytes(q, k, v, got), attention_ops(q, k, 2), torch.bfloat16)}
    one = time_ms(lambda: fa.flash_small_kv(q, k, v, None, scale))
    one_lib = time_ms(lambda: _sdpa(q, k, v, None, scale))
    phase("kernels", f"small_kv bf16 {IMAGENET_SHAPE} (NextDiT_ImageNet_600M self-attention, "
          f"256^2 under CFG): max abs err {max_err:.3g} mean {mean_err:.3g}; kernel "
          f"{timed['ms']:.4f} ms (bursts of {burst}; one call {one:.4f}), plain "
          f"{timed['plain_ms']:.3f} ms, bound {timed['bound_ms']:.4f} ms ({timed['bound_by']}), "
          f"library {timed['library_ms']:.4f} ms (sdpa, bursts of {burst}; one call "
          f"{one_lib:.4f}, {top_kernel(lambda: _sdpa(q, k, v, None, scale))})")
    return {"small_kv_imagenet_600m": {**timed, "max_abs_err": max_err}}


def _valid_keys(valid, b, sk):
    """Each batch row's count of valid keys: `valid` is one count for every
    row, a tuple of one per row, or None (all keys)."""
    return list(valid) if isinstance(valid, tuple) else [valid or sk] * b


def _shape_inputs(g, b, s, h, hkv, d, masked, sk=None, valid=None, dtype=torch.bfloat16):
    """q (b, s, h, d) and k, v (b, sk, hkv, d) in `dtype`, sk = s by default,
    with no mask, the first `valid` keys of each row valid (one count, or a
    tuple of one per row), or (`masked`) a masked tail and a fully masked
    last batch row."""
    sk = sk or s
    q = _rand(g, b, s, h, d, dtype=dtype)
    k, v = (_rand(g, b, sk, hkv, d, dtype=dtype) for _ in range(2))
    mask = None
    if masked or valid:
        mask = torch.ones(b, sk, dtype=torch.int32, device="cuda")
        for row, n in enumerate(_valid_keys(valid, b, sk)):
            mask[row, n:] = 0
        if masked:
            mask[0, sk - sk // 5:] = 0
            mask[-1] = 0
    return q, k, v, mask


def _static_bound(fa, q, k, v, mask, entry):
    """The calibrated bound of a static-max entry: max row LSE + the
    sampler's (6) or the trainer's (8) margin; {} for the others."""
    if not entry.startswith("static_max"):
        return {}
    lse = fa.flash_online_lse_plain(q, k, v, mask, q.shape[-1] ** -0.5)[1]
    return {"bound": float(lse[torch.isfinite(lse)].max()) + (8.0 if entry.endswith("_lse")
                                                               else 6.0)}


def _check_forward(fa, entry, q, k, v, mask, label):
    """One forward entry against its plain version: (output, max abs err,
    line). The LSE of K4/K5 is held to LSE_MAX on the rows that keep a key."""
    scale = q.shape[-1] ** -0.5
    kw = _static_bound(fa, q, k, v, mask, entry)
    got = getattr(fa, f"flash_{entry}")(q, k, v, mask, scale, **kw)
    ref = getattr(fa, f"flash_{entry}_plain")(q.float(), k.float(), v.float(), mask, scale,
                                              *kw.values())
    torch.cuda.synchronize()
    line = ""
    if entry.endswith("_lse"):
        (got, lse), (ref, ref_lse) = got, ref
        fin = torch.isfinite(ref_lse)
        require(torch.equal(fin, torch.isfinite(lse)), f"{entry} {label}: LSE -inf rows")
        lse_err = (lse[fin] - ref_lse[fin]).abs().max().item()
        require(lse_err <= LSE_MAX, f"{entry} {label}: LSE err {lse_err} > {LSE_MAX}")
        line = f", LSE {lse_err:.3g}"
    err = (got.float() - ref).abs()
    max_err, mean_err = err.max().item(), err.mean().item()
    bar = FP32_MAX if q.dtype == torch.float32 else BF16_MAX
    require(math.isfinite(max_err) and max_err <= bar,
            f"{entry} {label}: max abs err {max_err} > {bar}")
    if q.dtype == torch.bfloat16:
        require(mean_err <= BF16_MEAN, f"{entry} {label}: mean abs err {mean_err} > {BF16_MEAN}")
    if mask is not None and not bool(mask[-1].any()):
        require(torch.count_nonzero(got[-1]).item() == 0, f"{entry} {label}: masked row not 0")
    return got, max_err, f"max abs err {max_err:.3g} mean {mean_err:.3g}{line}"


def _check_backward(fa, q, k, v, mask, dout, label):
    """K6, K7 and K8 against `flash_bwd_plain` (out and LSE from the plain
    LSE forward): ({entry: max abs err}, args, line). bf16 within
    BWD_BF16_MAX (max) and BWD_BF16_MEAN (mean) of max|gradient|, fp32
    within BWD_FP32_MAX."""
    scale = q.shape[-1] ** -0.5
    out, lse = fa.flash_online_lse_plain(q, k, v, mask, scale)
    args = (q, k, v, mask, out, lse, dout, scale)
    ref = fa.flash_bwd_plain(*args)
    got = {"bwd_fused": fa.flash_bwd_fused(*args), "bwd_dq": (fa.flash_bwd_dq(*args), None, None),
           "bwd_dkv": (None, *fa.flash_bwd_dkv(*args))}
    torch.cuda.synchronize()
    worst, parts = {}, []
    for name, outs in got.items():
        for grad, r, what in zip(outs, ref, ("dq", "dk", "dv")):
            if grad is None:
                continue
            top = max(r.float().abs().max().item(), 1e-30)
            err = (grad.float() - r.float()).abs()
            rel_max, rel_mean = err.max().item() / top, err.mean().item() / top
            bar = BWD_FP32_MAX if q.dtype == torch.float32 else BWD_BF16_MAX
            require(grad.dtype == r.dtype and math.isfinite(rel_max) and rel_max <= bar,
                    f"{name} {what} {label}: max err {rel_max} of max|ref| > {bar}")
            if q.dtype == torch.bfloat16:
                require(rel_mean <= BWD_BF16_MEAN, f"{name} {what} {label}: mean err {rel_mean}")
            if mask is not None and not bool(mask[-1].any()):
                require(torch.count_nonzero(grad[-1]).item() == 0,
                        f"{name} {what} {label}: fully masked row not 0")
            worst[name] = max(worst.get(name, 0.0), err.max().item())
            parts.append(f"{name}.{what} {rel_max:.2g}")
    return worst, args, "max err / max|ref| " + ", ".join(parts)


def shape_rows(fa, g, d, cases, dtype=torch.bfloat16):
    """Kernel rows at one head_dim, in `dtype` (bf16, or fp32: the fp32
    bars, no mean bar, bounds at the fp32 rate): each case (row, entry, (b, s, h),
    sk, valid) runs twice against its plain version, first with all heads (and
    the first `valid` of `sk` keys, for a caption) timed with its bound and
    library call (sdpa for K1-K3, aten's flash attention with LSE for K4/K5,
    the sdpa autograd backward for K6-K8; `entry` "bwd" stands for all three,
    rows `bwd_fused<tail>`, `bwd_dq<tail>`, `bwd_dkv<tail>` of row
    `bwd<tail>`), then with 4:1 GQA, a masked tail and a fully masked batch
    row. A row with no timed case (sk given as a check) only adds its error."""
    results = {}
    for row, entry, (b, s, h), sk, valid, timed in cases:
        for masked in (False, True):
            hkv = h // 4 if masked else h
            label = (f"{'fp32' if dtype == torch.float32 else 'bf16'} ({b}, {s}, {h}/{hkv}, {d})"
                     + (f", Sk={sk}" if sk else "")
                     + (f" ({valid} valid)" if valid else "") + (", masked" if masked else ""))
            q, k, v, mask = _shape_inputs(g, b, s, h, hkv, d, masked, sk, valid, dtype)
            # the products this run's mask needs
            keys = sum(_valid_keys(valid, b, k.shape[1])) / (b * k.shape[1])
            scale = d ** -0.5
            if entry == "bwd":
                dout = _rand(g, b, s, h, d, dtype=dtype)
                worst, args, line = _check_backward(fa, q, k, v, mask, dout, label)
                for name, err in worst.items():
                    key = f"{name}{row[len('bwd'):]}"
                    results.setdefault(key, {"max_abs_err": 0.0})
                    results[key]["max_abs_err"] = max(results[key]["max_abs_err"], err)
                if not masked and timed:
                    plain_ms = time_ms(lambda: fa.flash_bwd_plain(*args), reps=3)
                    lib = library_backward(q, k, v, mask, dout, scale)
                    bounds = _bwd_bounds(q, k, v, args[4], dout, args[5], dtype, mask)
                    parts = []
                    for name in ("bwd_fused", "bwd_dq", "bwd_dkv"):
                        fn = getattr(fa, f"flash_{name}")
                        ms = time_ms(lambda: fn(*args), reps=5)
                        results[f"{name}{row[len('bwd'):]}"].update(
                            ms=ms, plain_ms=plain_ms, library_ms=lib["library_ms"],
                            **bounds[name])
                        parts.append(f"{name} {ms:.3f} ms (bound {bounds[name]['bound_ms']:.4f} "
                                     f"ms, {bounds[name]['bound_by']})")
                    line += (f"; {', '.join(parts)}; plain {plain_ms:.3f} ms; library backward "
                             f"{lib['library_ms']:.3f} ms ({lib['library_kernel']})")
                phase("kernels", f"backward {label}: {line}")
                del dout, args
            else:
                got, err, line = _check_forward(fa, entry, q, k, v, mask, label)
                results.setdefault(row, {"max_abs_err": 0.0})
                results[row]["max_abs_err"] = max(results[row]["max_abs_err"], err)
                if not masked and timed:
                    kernel = getattr(fa, f"flash_{entry}")
                    plain = getattr(fa, f"flash_{entry}_plain")
                    kw = _static_bound(fa, q, k, v, mask, entry)
                    lse_bytes = b * h * s * 4 if entry.endswith("_lse") else 0
                    stats = {"ms": time_ms(lambda: kernel(q, k, v, mask, scale, **kw)),
                             "plain_ms": time_ms(lambda: plain(q, k, v, mask, scale,
                                                               *kw.values()), reps=3),
                             **least_time(_nbytes(q, k, v, mask, got) + lse_bytes,
                                          attention_ops(q, k, 2) * keys, dtype)}
                    lib = (library_forward_lse if entry.endswith("_lse") and mask is None
                           else library_forward)(q, k, v, mask, scale)
                    stats["library_ms"] = lib["library_ms"]
                    results[row].update(stats)
                    line += (f"; kernel {stats['ms']:.3f} ms, plain {stats['plain_ms']:.3f} ms, "
                             f"bound {stats['bound_ms']:.4f} ms ({stats['bound_by']}), library "
                             f"{stats['library_ms']:.3f} ms ({lib['library_kernel']})")
                phase("kernels", f"{entry} {label}: {line}")
                del got
            del q, k, v, mask
            torch.cuda.empty_cache()
    return results


def d48_kernel_phase(fa):
    """K4 and K6-K8 at head_dim 48 (the 64/64 instantiations) at the
    class-conditional trainers' shapes (`D48_SHAPES`), and K1 at the Small's
    sampler shape (`shape_rows`)."""
    cases = [(f"{entry}_d48_{tag}", entry, shape, None, None, True)
             for tag, shape in D48_SHAPES.items() for entry in ("online_lse", "bwd")]
    cases.append(("small_kv_d48_small", "small_kv", D48_K1_SMALL, None, None, True))
    return shape_rows(fa, torch.Generator(device="cuda").manual_seed(48), 48, cases)


def wide_head_kernel_phase(fa):
    """K1-K8 at head_dim 96 (Flag-DiT 5B: dim 3072 over 32 heads; 64 x 65
    tokens at 1024^2 with the [eol] column) and K1 at head_dim 128 (Flag-DiT
    ImageNet 7B: 4096 over 32): the 128/128 instantiations (`shape_rows`).
    K2-K8 at D96_SHAPE; K1 at Sq 4160 against the sampler's 128 caption keys
    (100 valid); K4 and K6-K8 also against the trainer's 32 caption keys;
    K1 at D128_K1."""
    b, s, h, _ = D96_SHAPE
    sk, valid = D96_CAPTION
    cases = [(f"{entry}_d96_5b", entry, (b, s, h), None, None, True)
             for entry in ("online", "static_max", "online_lse", "static_max_lse", "bwd")]
    cases += [("small_kv_d96_5b", "small_kv", (b, s, h), sk, valid, True),
              ("online_lse_d96_5b", "online_lse", (b, s, h), TRAIN_CAP, None, False),
              ("bwd_d96_5b", "bwd", (b, s, h), TRAIN_CAP, None, False)]
    g = torch.Generator(device="cuda").manual_seed(96)
    results = shape_rows(fa, g, 96, cases)
    results.update(shape_rows(fa, g, 128, [("small_kv_d128_7b", "small_kv", D128_K1[:3], None,
                                            None, True)]))
    return results


def anagram_sd3_kernel_phase(fa):
    """The new shapes of the anagram, SD3 and DreamBooth paths
    (`shape_rows`): K1 over kv_merge's 1024 pooled keys behind 4096 queries
    and K4/K6-K8 at the 2B's DreamBooth self-attention (head_dim 72); K2 on
    MMDiT-SD3-Medium's unmasked joint sequence of 4429 keys and K4/K6-K8 on
    DreamBooth's 589 (head_dim 64, the 64/64 instantiations)."""
    g = torch.Generator(device="cuda").manual_seed(15)
    results = shape_rows(fa, g, 72, [
        ("small_kv_kv1024", "small_kv", KV1024, 1024, None, True),
        ("online_lse_db_2b", "online_lse", DB_2B, None, None, True),
        ("bwd_db_2b", "bwd", DB_2B, None, None, True)])
    results.update(shape_rows(fa, g, 64, [
        ("online_d64_sd3", "online", SD3_JOINT_1024, None, None, True),
        ("online_lse_d64_sd3", "online_lse", SD3_JOINT_256, None, None, True),
        ("bwd_d64_sd3", "bwd", SD3_JOINT_256, None, None, True)]))
    return results


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
    return latents


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


def _rel_l2(got, ref):
    return ((got.float().cpu() - ref.float()).norm() / ref.float().norm()).item()


def _write_random_vae(path, seed, **arch):
    """A full-width AutoencoderKL with random weights from `seed` (CPU, fp32),
    written as a diffusers-layout `.safetensors`; returns the module."""
    from lumina_t2x_tpu_torch.codecs.vae import AutoencoderKL
    from lumina_t2x_tpu_torch.core.checkpoint import save_safetensors

    torch.manual_seed(seed)
    vae = AutoencoderKL(**arch).eval()
    save_safetensors(vae.state_dict(), path)
    return vae


def vae_phase(latent_1024, vae_dir):
    """The SD-VAE (`codecs/vae.py`, plain torch: convolutions and the
    bottleneck attention's matmuls) on the card: the full SD config from a
    seed, written as `.safetensors` and read back with `load_vae`; the slice
    phase's 1024^2 latent decoded in fp32 (median of 3, peak memory, FLOPs
    and the bound at the TF32 and fp32 peaks), with cuDNN's TF32
    convolutions off (this script's setting) and on (torch's default); the
    card's decode and encode against the CPU's at 256^2 under both; the SD3
    layout decoded once. Returns the paths of the SD-VAE file and of the SD3
    (z=16) one."""
    from torch.utils.flop_counter import FlopCounterMode

    from lumina_t2x_tpu_torch.codecs.vae import decode_from_latent, encode_to_latent, load_vae

    path = os.path.join(vae_dir, "sd_vae.safetensors")
    ref = _write_random_vae(path, 6)
    t0 = time.perf_counter()
    vae = load_vae(path, device="cuda")
    load_s = time.perf_counter() - t0
    require(all(torch.equal(a.cpu(), b) for a, b in zip(vae.state_dict().values(),
                                                         ref.state_dict().values())),
            "load_vae did not restore the written weights")
    z = latent_1024.float()
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        out = decode_from_latent(vae, z)
    flops = counter.get_total_flops()
    # the decode reads the decoder's and post_quant_conv's weights, z, writes the image
    nbytes = _nbytes(z, out, *(p for name, p in vae.named_parameters()
                                if not name.startswith(("encoder.", "quant_conv."))))
    g = torch.Generator().manual_seed(9)
    z_small = torch.randn(1, 4, 32, 32, generator=g)
    x_small = torch.rand(1, 3, 256, 256, generator=g) * 2 - 1
    noise = torch.randn(1, 4, 32, 32, generator=g)
    with torch.no_grad():
        cpu_dec = decode_from_latent(ref, z_small)
        cpu_enc = encode_to_latent(ref, x_small, noise)
    tf32_default = torch.backends.cudnn.allow_tf32
    try:
        for tf32 in (False, True):
            torch.backends.cudnn.allow_tf32 = tf32
            with torch.no_grad():
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                decode = lambda: decode_from_latent(vae, z)
                out = decode()
                times = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = decode()
                    torch.cuda.synchronize()
                    times.append(1000 * (time.perf_counter() - t0))
                peak = torch.cuda.max_memory_allocated() / 2**30
                dec = _rel_l2(decode_from_latent(vae, z_small.cuda()), cpu_dec)
                enc = _rel_l2(encode_to_latent(vae, x_small.cuda(), noise.cuda()), cpu_enc)
            bar = VAE_REL_TF32 if tf32 else VAE_REL_FP32
            require(out.shape == (1, 3, 8 * z.shape[2], 8 * z.shape[3])
                    and bool(torch.isfinite(out).all()),
                    f"1024^2 decode (TF32 {tf32}): bad shape or non-finite")
            peak_rate = PEAK_TF32 if tf32 else PEAK_FP32
            bound = 1e3 * max(flops / peak_rate, nbytes / HBM_BYTES_S)
            phase("vae", f"cuDNN TF32 convolutions {'on' if tf32 else 'off'}: 1024^2 fp32 decode "
                  f"of the slice's latent {statistics.median(times):.1f} ms (median of 3: "
                  f"{', '.join(f'{t:.1f}' for t in times)}), peak memory {peak:.2f} GiB, output "
                  f"[{out.min().item():.3f}, {out.max().item():.3f}] finite; {flops / 1e12:.3f} "
                  f"TFLOP (conv + matmul), bound {bound:.2f} ms at {peak_rate / 1e12:.0f} "
                  f"TFLOP/s; card vs CPU at 256^2: decode rel L2 {dec:.3g}, encode_to_latent "
                  f"(explicit noise) rel L2 {enc:.3g} (bar {bar:g})")
            require(dec <= bar and enc <= bar, f"VAE card vs CPU (TF32 {tf32}): decode {dec}, "
                    f"encode {enc} > {bar}")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32_default
    sd3_path = os.path.join(vae_dir, "sd3_vae.safetensors")
    _write_random_vae(sd3_path, 10, z_channels=16, use_quant_conv=False)
    sd3 = load_vae(sd3_path, device="cuda")
    require(sd3.z_channels == 16 and not sd3.use_quant_conv, "SD3 layout not read off its weights")
    with torch.no_grad():
        out3 = decode_from_latent(sd3, torch.randn(1, 16, 32, 32, generator=g).cuda(), "sd3")
    require(out3.shape == (1, 3, 256, 256) and bool(torch.isfinite(out3).all()),
            "SD3 decode: bad shape or non-finite")
    phase("vae", f"AutoencoderKL ch 128, ch_mult (1, 2, 4, 4), 2 resnets, z 4, quant convs "
          f"({sum(p.numel() for p in vae.parameters()) / 1e6:.2f}M params, seed 6): "
          f".safetensors -> load_vae in {load_s:.2f} s; SD3 layout (z 16, no quant conv) read "
          f"off its file and decoded at 256^2: finite")
    del vae, sd3, ref
    torch.cuda.empty_cache()
    return path, sd3_path


def _sample_cli(fa, argv):
    """`pipelines.sample.main(argv)` on the card: (manifest, wall seconds incl.
    set-up, the trajectory seconds the CLI prints, launches, plain-version
    CUDA calls)."""
    import contextlib
    import io

    from lumina_t2x_tpu_torch.pipelines import sample as sample_cli

    buf = io.StringIO()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        manifest = sample_cli.main(["--device", "cuda", *argv])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    said = re.findall(r" in ([0-9.]+)s", buf.getvalue())
    manifest["stdout"] = buf.getvalue()
    return (manifest, wall, float(said[-1]) if said else None, dict(fa.LAUNCHES),
            fa.PLAIN_CUDA_CALLS["count"])


def _pngs(manifest, shape):
    pixels = []
    for item in manifest["items"]:
        require(item["path"].endswith(".png"), f"not a PNG: {item['path']}")
        with open(item["path"], "rb") as f:
            pixels.append(_png_pixels(f.read()))
        require(pixels[-1].shape == shape, f"{item['path']}: {pixels[-1].shape} != {shape}")
    return pixels


def classcond_phase(fa, vae_path):
    """The class-conditional sampler through `pipelines.sample.main`:
    NextDiT_ImageNet_600M_patch2 (zero-init tensors randomised, saved as a
    port checkpoint with its model_args, passed with --ckpt), 4 labels at
    256^2, 30-point midpoint, CFG 4, decoded by the VAE into PNGs: the main
    path of K1 at the 600M's shape; then the FID npz of 8 and --pixel_space
    at 64^2. Returns K1's launch count on that path."""
    from lumina_t2x_tpu_torch.core.checkpoint import save_weights
    from lumina_t2x_tpu_torch.models import get_model

    torch.manual_seed(0)
    model = get_model("NextDiT_ImageNet_600M_patch2", device="cuda")
    n = _randomise_zero_init(model, 7)
    params = sum(p.numel() for p in model.parameters()) / 1e6
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = save_weights(os.path.join(tmp, "ckpt"), model.state_dict(),
                            {"model": "NextDiT_ImageNet_600M_patch2", "num_classes": 1000})
        del model
        torch.cuda.empty_cache()
        common = ["--ckpt", ckpt, "--resolution", "1:256x256", "--num_sampling_steps", "30",
                  "--solver", "midpoint", "--cfg_scale", "4.0", "--vae_ckpt", vae_path]
        manifest, wall, secs, launches, plain = _sample_cli(
            fa, common + ["--labels", LABELS, "--image_save_path", os.path.join(tmp, "pngs")])
        pixels = _pngs(manifest, (256, 256, 3))
        require(len(pixels) == 4, f"{len(pixels)} PNGs for 4 labels")
        require(plain == 0, f"class-conditional sampler: plain versions ran {plain} times on CUDA")
        require(launches["small_kv"] == IMAGENET_LAUNCHES,
                f"K1 launched {launches['small_kv']} times, expected {IMAGENET_LAUNCHES}")
        phase("classcond", f"sample.main --ckpt (NextDiT_ImageNet_600M_patch2, {params:.1f}M "
              f"params, {n} zero-init tensors randomised) --labels {LABELS} 256^2, 30-point "
              f"midpoint, CFG 4, bf16, --vae_ckpt: 4 PNGs 256x256 (means "
              f"{[round(float(p.mean()), 1) for p in pixels]}); trajectory and decode {secs} s, "
              f"wall {wall:.1f} s incl. set-up; launches "
              f"{ {k: v for k, v in launches.items() if v} }; plain-version CUDA calls {plain}")

        out = os.path.join(tmp, "fid")
        manifest, wall, _, fid_launches, plain = _sample_cli(
            fa, common + ["--num_fid_samples", "8", "--batch_size", "4", "--image_save_path", out])
        data = np.load(manifest["items"][0]["fid_npz"])
        arr, labels = data["arr_0"], data["arr_1"]
        require(arr.shape == (8, 256, 256, 3) and arr.dtype == np.uint8, f"FID arr_0 {arr.shape}")
        require(labels.shape == (8,) and labels.min() >= 0 and labels.max() < 1000,
                f"FID arr_1 {labels}")
        require(fid_launches["small_kv"] == 2 * IMAGENET_LAUNCHES and plain == 0,
                f"FID launches {fid_launches}, plain calls {plain}")
        phase("classcond", f"--num_fid_samples 8 --batch_size 4: arr_0 {arr.shape} {arr.dtype}, "
              f"arr_1 {labels.tolist()}; wall {wall:.1f} s; K1 launches "
              f"{fid_launches['small_kv']}")

        manifest, wall, secs, px_launches, plain = _sample_cli(
            fa, ["--model", "NextDiT_ImageNet_600M_patch2", "--debug", "--pixel_space",
                 "--resolution", "1:64x64", "--num_sampling_steps", "10",
                 "--image_save_path", os.path.join(tmp, "pixels")])
        require(len(_pngs(manifest, (64, 64, 3))) == 4 and plain == 0
                and px_launches["small_kv"] > 0, f"--pixel_space: {px_launches}, {plain}")
        phase("classcond", f"--pixel_space 64^2 --debug, 10 steps, no VAE: 4 PNGs 64x64; "
              f"{secs} s, wall {wall:.1f} s; K1 launches {px_launches['small_kv']}")
    torch.cuda.empty_cache()
    return {"small_kv_imagenet_600m": launches["small_kv"]}


def _class_metrics(results_dir, model):
    with open(os.path.join(results_dir, model, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


# the trainer CLIs `_run_trainer` drives, by module: the name of each one's step builder
TRAINER_STEPS = {"train": "make_train_step", "train_audio": "make_cfm_train_step"}


def _run_trainer(fa, argv, save=True, unfused_from=None, cli="train", before=None):
    """`pipelines.<cli>.main(argv)` (the image trainer, or "train_audio") with
    the launch counts reset: (state, wall seconds, launches, plain-version
    CUDA calls, peak GiB). `save=False` turns the trainer's checkpoint writes
    into no-ops (the call's 45 GiB of disk writes); `unfused_from=n` sets
    LUMINA_FLASH_FUSED_BWD=0 from step n (1-based) on, so that those steps
    run K7/K8, and copies the launches of the steps before it into the dict
    `before` when one is given."""
    import importlib

    train_cli = importlib.import_module(f"lumina_t2x_tpu_torch.pipelines.{cli}")
    builder = TRAINER_STEPS[cli]
    saved = (train_cli.save_checkpoint, getattr(train_cli, builder))
    if not save:
        train_cli.save_checkpoint = lambda *args, **kwargs: "(not written)"
    if unfused_from:
        def make_train_step(*args, **kwargs):
            step_fn = saved[1](*args, **kwargs)

            def step(state, *rest, **kw):
                if state.step + 1 == unfused_from and before is not None:
                    before.update(fa.LAUNCHES)
                if state.step + 1 >= unfused_from:
                    os.environ["LUMINA_FLASH_FUSED_BWD"] = "0"
                return step_fn(state, *rest, **kw)
            return step
        setattr(train_cli, builder, make_train_step)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        state = train_cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        train_cli.save_checkpoint = saved[0]
        setattr(train_cli, builder, saved[1])
        os.environ.pop("LUMINA_FLASH_FUSED_BWD", None)
    return (state, wall, dict(fa.LAUNCHES), fa.PLAIN_CUDA_CALLS["count"],
            torch.cuda.max_memory_allocated() / 2**30)


def classtrain_phase(fa, vae_path):
    """README's "ImageNet training" recipe through the trainer CLI:
    NextDiT_ImageNet_600M_patch2 at 256^2, B=256, lr 5e-4, qk-norm, lognorm
    times, --vae_ckpt (the vae phase's random VAE), on a shapes ImageFolder of
    16 classes x 16 PNGs at 256^2 (a cut of ImageNet's 1.28M images, which the
    repository does not hold), with --checkpointing (dots remat) and bf16
    Adafactor (two fp32 AdamW checkpoints of the 600M, 18 GiB, would take
    this run past the machine's 45 GiB of disk writes). 3 steps, then
    --auto_resume for a 4th under LUMINA_FLASH_FUSED_BWD=0 (K7/K8); then
    `pipelines.sample.main --ckpt` on that checkpoint, 4 labels at 256^2,
    --solver dopri5 and dopri8, --vae_ckpt: PNGs, NFE and seconds. Returns
    the launch counts of the head_dim-48 600M rows."""
    from lumina_t2x_tpu_torch.data.shapes import write_imagefolder

    model = "NextDiT_ImageNet_600M_patch2"
    with tempfile.TemporaryDirectory() as tmp:
        data, results = os.path.join(tmp, "shapes"), os.path.join(tmp, "run")
        t0 = time.perf_counter()
        n = write_imagefolder(data, CLASSTRAIN_IMAGES_PER_CLASS, seed=0, size=256)
        render_s = time.perf_counter() - t0
        argv = ["--model", model, "--data_path", data, "--image_size", "256",
                "--global_batch_size", str(CLASSTRAIN_B), "--lr", "5e-4", "--qk_norm",
                "--snr_type", "lognorm", "--vae_ckpt", vae_path, "--checkpointing",
                "--optimizer", "adafactor", "--param_dtype", "bf16", "--results_dir", results,
                "--log_every", "1", "--ckpt_every", "1000", "--keep_last", "1",
                "--num_workers", "8", "--device", "cuda"]
        state, wall, launches, plain, peak = _run_trainer(fa, argv + ["--max_steps", "3"])
        require(state.step == 3, f"class trainer stopped at step {state.step}")
        del state
        torch.cuda.empty_cache()
        m = _class_metrics(results, model)
        steady = [r["train/secs_per_step"] for r in m[1:]]
        phase("classtrain", f"train.main {model} --image_size 256 --global_batch_size "
              f"{CLASSTRAIN_B} --lr 5e-4 --qk_norm --snr_type lognorm --vae_ckpt --checkpointing, "
              f"bf16 Adafactor, on {n} shapes PNGs at 256^2 ({render_s:.1f} s to render): losses "
              f"{[round(r['train/loss'], 5) for r in m]}, grad norms "
              f"{[round(r['train/grad_norm'], 4) for r in m]}; step 1 "
              f"{m[0]['train/secs_per_step']:.3f} s, steps 2-3 "
              f"{', '.join(f'{x:.3f}' for x in steady)} s/step, "
              f"{CLASSTRAIN_B / statistics.mean(steady):.1f} imgs/s; data wait "
              f"{[round(r['train/data_wait_ms'], 1) for r in m]} ms, VAE encode "
              f"{[round(r['train/vae_encode_ms'], 1) for r in m]} ms; peak memory {peak:.2f} GiB; "
              f"wall {wall:.1f} s incl. set-up and save; launches "
              f"{ {k: v for k, v in launches.items() if v} }; plain-version CUDA calls {plain}")
        require(all(math.isfinite(r["train/loss"]) for r in m) and len(m) == 3,
                "class trainer losses not finite")
        require(plain == 0, f"class trainer: plain versions ran {plain} times on CUDA")
        for name in ("online_lse", "bwd_fused"):
            require(launches[name] > 0, f"kernel {name} was not launched by the class trainer")

        state, wall2, resumed, plain, peak2 = _run_trainer(
            fa, argv + ["--max_steps", "4", "--auto_resume"], unfused_from=1)
        require(state.step == 4, f"resumed class trainer stopped at step {state.step}")
        del state
        torch.cuda.empty_cache()
        m = _class_metrics(results, model)
        require(len(m) == 4 and math.isfinite(m[-1]["train/loss"]), "resumed step not finite")
        require(plain == 0 and resumed["bwd_fused"] == 0, f"resumed step: {resumed}, {plain}")
        for name in ("online_lse", "bwd_dq", "bwd_dkv"):
            require(resumed[name] > 0, f"kernel {name} was not launched by the resumed step")
        phase("classtrain", f"--auto_resume from step 3 with LUMINA_FLASH_FUSED_BWD=0: step 4 "
              f"loss {m[-1]['train/loss']:.5f}, {m[-1]['train/secs_per_step']:.3f} s; peak memory "
              f"{peak2:.2f} GiB; wall {wall2:.1f} s incl. load and save; launches "
              f"{ {k: v for k, v in resumed.items() if v} }")

        ckpt = os.path.join(results, model, "checkpoints", "0000004")
        for solver in ("dopri5", "dopri8"):
            manifest, wall, secs, sl, plain = _sample_cli(
                fa, ["--ckpt", ckpt, "--labels", LABELS, "--resolution", "1:256x256",
                     "--num_sampling_steps", "30", "--solver", solver, "--cfg_scale", "4.0",
                     "--vae_ckpt", vae_path, "--image_save_path", os.path.join(tmp, solver)])
            pixels = _pngs(manifest, (256, 256, 3))
            require(len(pixels) == 4 and plain == 0 and sl["small_kv"] == 16 * manifest["nfe"],
                    f"{solver}: {len(pixels)} PNGs, launches {sl}, NFE {manifest['nfe']}")
            phase("classtrain", f"sample.main --ckpt <step 4> --solver {solver} (default "
                  f"tolerances: the class-conditional branch takes none) --labels {LABELS} "
                  f"256^2, CFG 4, --vae_ckpt: 4 PNGs; NFE {manifest['nfe']}, trajectory "
                  f"{manifest['seconds']:.2f} s, with decode {secs} s, wall {wall:.1f} s; K1 "
                  f"launches {sl['small_kv']}")
    torch.cuda.empty_cache()
    return {"online_lse_d48_600m": launches["online_lse"] + resumed["online_lse"],
            "bwd_fused_d48_600m": launches["bwd_fused"], "bwd_dq_d48_600m": resumed["bwd_dq"],
            "bwd_dkv_d48_600m": resumed["bwd_dkv"]}


def pixel_phase(fa):
    """The Small in pixel space through the trainer CLI: a shapes ImageFolder
    of 16 classes x 4 PNGs at 64^2, B=64, 5 steps, --pixel_space --qk_norm
    --checkpointing (1024 tokens of head_dim 48: K4 and K6). Returns its
    launch counts."""
    from lumina_t2x_tpu_torch.data.shapes import write_imagefolder

    model = "NextDiT_ImageNet_Small_patch2"
    with tempfile.TemporaryDirectory() as tmp:
        data, results = os.path.join(tmp, "shapes"), os.path.join(tmp, "run")
        write_imagefolder(data, 4, seed=1, size=64)
        state, wall, launches, plain, peak = _run_trainer(fa, [
            "--model", model, "--data_path", data, "--image_size", "64", "--pixel_space",
            "--num_classes", "16", "--global_batch_size", "64", "--lr", "5e-4", "--qk_norm",
            "--checkpointing", "--results_dir", results, "--log_every", "1", "--max_steps", "5",
            "--num_workers", "4", "--device", "cuda"])
        m = _class_metrics(results, model)
    require(state.step == 5 and all(math.isfinite(r["train/loss"]) for r in m),
            f"pixel-space trainer: step {state.step}, losses {[r['train/loss'] for r in m]}")
    require(plain == 0 and launches["online_lse"] > 0 and launches["bwd_fused"] > 0,
            f"pixel-space trainer: launches {launches}, plain calls {plain}")
    steady = [f"{1000 * r['train/secs_per_step']:.1f}" for r in m[1:]]
    phase("pixel", f"train.main {model} --pixel_space 64^2, B=64, --qk_norm --checkpointing, 5 "
          f"steps: losses {[round(r['train/loss'], 4) for r in m]}; steps 2-5 "
          f"{', '.join(steady)} ms/step; "
          f"peak memory {peak:.2f} GiB; wall {wall:.1f} s; launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    del state
    torch.cuda.empty_cache()
    return launches


def quality_phase(fa):
    """`exps/quality_flow.py` cut to fit: QUALITY_STEPS steps at B=64,
    QUALITY_FID_SAMPLES FID samples, QUALITY_PER_CLASS images per class. It
    shows that the flow runs on the card, not the quality. Returns its launch
    counts (K4 and K6 training, K1 sampling)."""
    from lumina_t2x_tpu_torch.exps import quality_flow

    fa.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        summary = quality_flow.main([
            "--steps", str(QUALITY_STEPS), "--batch", "64", "--fid_samples",
            str(QUALITY_FID_SAMPLES), "--n_per_class", str(QUALITY_PER_CLASS),
            "--out", os.path.join(tmp, "out"), "--work", os.path.join(tmp, "work"),
            "--device", "cuda"])
        wall = time.perf_counter() - t0
        grid = sorted(os.listdir(os.path.join(tmp, "out", "grid")))
    launches, plain = dict(fa.LAUNCHES), fa.PLAIN_CUDA_CALLS["count"]
    require(len(grid) == 16 and summary["train"]["steps"] == QUALITY_STEPS
            and math.isfinite(summary["train"]["loss_last"]), f"quality flow: {summary}, {grid}")
    require(plain == 0 and all(launches[k] > 0 for k in ("online_lse", "bwd_fused", "small_kv")),
            f"quality flow: launches {launches}, plain calls {plain}")
    phase("quality", f"quality_flow --steps {QUALITY_STEPS} --batch 64 --fid_samples "
          f"{QUALITY_FID_SAMPLES}: wall {wall:.1f} s; launches "
          f"{ {k: v for k, v in launches.items() if v} }; summary " + json.dumps(
              {"train": summary["train"], "faithfulness": {
                  k: summary["faithfulness"][k] for k in ("accuracy", "rejected_frac", "chance")},
               "pixel_fid": summary["pixel_fid"], "passed": summary["passed"]}))
    return launches


def t2i_vae_phase(fa, vae_path):
    """The text-to-image branch of `pipelines.sample.main` with --vae_ckpt:
    NextDiT_2B_patch2 --debug at 1024^2, 10 steps, one 1024x1024 PNG."""
    with tempfile.TemporaryDirectory() as out:
        manifest, wall, secs, launches, plain = _sample_cli(
            fa, ["--model", "NextDiT_2B_patch2", "--debug", "--resolution", "1:1024x1024",
                 "--num_sampling_steps", "10", "--time_shifting_factor", "4",
                 "--vae_ckpt", vae_path, "--image_save_path", out])
        pixels = _pngs(manifest, (1024, 1024, 3))
    require(len(pixels) == 1 and plain == 0, f"2B --vae_ckpt: {len(pixels)} PNGs, {plain} plain")
    require(launches["small_kv"] > 0 and launches["online"] > 0, f"2B launches {launches}")
    phase("t2i", f"sample.main NextDiT_2B_patch2 --debug 1024^2, 10 steps, --vae_ckpt: one PNG "
          f"1024x1024 (mean {pixels[0].mean():.1f}); trajectory and decode {secs} s, wall "
          f"{wall:.1f} s incl. set-up; launches { {k: v for k, v in launches.items() if v} }")
    torch.cuda.empty_cache()


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
    template, hopper = (dict(prof.GROUPS)[pat] for pat in ("flash_fwd_fp32", "flash_fwd_sm90"))
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


def trainer_phase(fa, then=None):
    """The trainer CLI at full width and depth: 3 steps and a checkpoint, then
    --auto_resume for a 4th step on the two-kernel backward. The CLI legs use
    bf16 Adafactor (7.4 GiB per checkpoint): the H100 test machines allow
    45 GiB of disk writes per run, and two fp32 AdamW checkpoints are 59 GiB.
    `then(argv, results, metrics)` runs last inside the results directory
    (the step-4 checkpoint still there). Returns the training launch counts
    and what `then` returned."""
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
        followed = then(argv, results, metrics) if then is not None else None
    require(len(metrics) == 4 and all(math.isfinite(m["train/loss"]) for m in metrics),
            "trainer losses not finite")
    require(bound is not None and math.isfinite(bound), "train calibration declined at 2B")
    for name in ("online_lse", "static_max_lse", "bwd_fused"):
        require(launches[name] > 0, f"kernel {name} was not launched by the trainer")
    for name in ("static_max_lse", "bwd_dq", "bwd_dkv"):
        require(resumed[name] > 0, f"kernel {name} was not launched by the resumed trainer")
    require(resumed["bwd_fused"] == 0, "the resumed step took the fused backward")
    require(plain_calls == 0, f"plain versions ran {plain_calls} times on CUDA")
    return {name: launches[name] + resumed[name] for name in TRAIN_KERNELS}, followed


def fp16_train_phase(fa):
    """The trainer CLI at its docstring's 2B recipe with `--precision fp16`
    (NextDiT_2B_patch2, synthetic 128 x 128 latents, B=2, fp32 gradients,
    qk-norm, --checkpointing, AdamW): 3 steps, the 3rd under
    LUMINA_FLASH_FUSED_BWD=0, no checkpoint written. fp16 attention takes the
    fp32 kernels (cast at the wrapper): the fp32 K4 forward
    (`csrc/flash_fwd_fp32_sm90.cu`) and K6, then K7 + K8
    (`csrc/flash_bwd_fp32_sm90.cu`). Returns the fp32 2B rows' launches."""
    with tempfile.TemporaryDirectory() as results:
        argv = ["--model", "NextDiT_2B_patch2", "--data_path", "synthetic://128x128",
                "--global_batch_size", str(B), "--precision", "fp16", "--grad_precision", "fp32",
                "--qk_norm", "--checkpointing", "--results_dir", results, "--log_every", "1",
                "--ckpt_every", "1000", "--max_steps", "3"]
        state, wall, launches, plain, peak = _run_trainer(fa, argv, save=False, unfused_from=3)
        dtype = next(state.model.parameters()).dtype
        del state
        gc.collect()
        torch.cuda.empty_cache()
        metrics = _train_metrics(results)
    launched = _launched(launches)
    phase("fp16train", f"trainer CLI, NextDiT_2B_patch2 --precision fp16 (parameters {dtype}), "
          f"1024^2 latents, B={B}, --checkpointing, AdamW, 3 steps (the 3rd with "
          f"LUMINA_FLASH_FUSED_BWD=0), no checkpoint: losses "
          f"{[round(m['train/loss'], 5) for m in metrics]}, grad norms "
          f"{[round(m['train/grad_norm'], 4) for m in metrics]}; s/step "
          f"{[round(m['train/secs_per_step'], 4) for m in metrics]}; peak memory {peak:.2f} GiB; "
          f"wall {wall:.1f} s; launches (fp16 q/k/v on the fp32 kernels) {launched}; "
          f"plain-version CUDA calls {plain}")
    require(len(metrics) == 3 and all(math.isfinite(m["train/loss"]) for m in metrics),
            f"fp16 trainer losses: {metrics}")
    require(plain == 0, f"fp16 trainer: plain versions ran {plain} times on CUDA")
    for name in ("online_lse", "bwd_fused", "bwd_dq", "bwd_dkv"):
        require(launched.get(name, 0) > 0, f"fp16 trainer: {name} was not launched")
    return {f"{name}_fp32_2b": launched[name]
            for name in ("online_lse", "bwd_fused", "bwd_dq", "bwd_dkv")}


# the multigpu phase: the torchrun trainer's losses and grad norms against the
# one-process trainer's of the same seed (relative). Step 1 starts from the
# same weights and draws, and so does the resumed step 5; after step 1, bf16
# parameters stochastically rounded from fp32 sums taken in another order may
# land an ulp apart
MULTIGPU_STEP1_RTOL, MULTIGPU_RTOL = 1e-5, 1e-3
# the ring fold against K2 over all keys and against the plain ring: bf16
# block outputs folded in fp32, then rounded to bf16. Max error within 4 bf16
# ulps of max|K2|, mean error within BF16_MEAN of max|K2|: a fold that weighed
# the blocks wrongly (equal weights, say) errs by about 1e-2 on outputs of
# about 0.03
RING_MAX_ULPS = 4


def _smi():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]


def _torchrun_trainer(argv, results, timeout=600):
    """This script's child mode under `torchrun --standalone --nproc_per_node
    1`: `pipelines.train.main(argv)` on rank 0 of a one-card NCCL world.
    Returns (wall seconds, the child's run_summary.json)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "1", os.path.join(ROOT, "chip_smoke.py"), "--multigpu-child", *argv]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stdout[-4000:], proc.stderr[-6000:], sep="\n", file=sys.stderr)
    require(proc.returncode == 0, f"the torchrun trainer exited {proc.returncode}")
    with open(os.path.join(results, "NextDiT_2B_patch2", "run_summary.json")) as f:
        return wall, json.load(f)


def _multigpu_child(argv):
    """Child mode: the trainer CLI's `main` under torchrun's environment,
    with its checkpoint write turned off (the call's disk writes)."""
    sys.path.insert(0, ROOT)
    from lumina_t2x_tpu_torch.pipelines import train as train_cli

    require(int(os.environ.get("WORLD_SIZE", "0")) >= 1, "child mode runs under torchrun")
    train_cli.save_checkpoint = lambda *args, **kwargs: "(not written)"
    state = train_cli.main(argv)
    print(json.dumps({"step": state.step}))


def _close(a, b, rtol):
    return abs(a - b) <= rtol * abs(b)


def multigpu_trainer_phase(fa, argv, results, trainer_metrics):
    """The trainer under torchrun at world size 1 over NCCL with the 2B at
    full width and depth (trainer_phase's argv, --data_parallel fsdp):
    3 fresh steps against trainer's, then trainer's one-process step-4
    checkpoint resumed for a 5th step by torchrun and by one process.
    Returns the children's launch counts."""
    fresh = os.path.join(results, "torchrun")
    i = argv.index("--results_dir")
    fresh_argv = argv[:i + 1] + [fresh] + argv[i + 2:] + ["--data_parallel", "fsdp",
                                                          "--max_steps", "3"]
    wall, summary = _torchrun_trainer(fresh_argv, fresh)
    got = _train_metrics(fresh)
    ref = trainer_metrics[:3]
    require(summary["world_size"] == 1 and summary["data_parallel"] == "fsdp",
            f"torchrun run summary {summary}")
    require(summary["plain_cuda_calls"] == 0,
            f"plain versions ran {summary['plain_cuda_calls']} times on CUDA")
    require(len(got) == 3 and all(math.isfinite(m["train/loss"]) and
                                  math.isfinite(m["train/grad_norm"]) for m in got),
            f"torchrun trainer metrics {got}")
    rel = [max(abs(a[key] - b[key]) / abs(b[key]) for key in ("train/loss", "train/grad_norm"))
           for a, b in zip(got, ref)]
    for k, (a, b) in enumerate(zip(got, ref)):
        rtol = MULTIGPU_STEP1_RTOL if k == 0 else MULTIGPU_RTOL
        for key in ("train/loss", "train/grad_norm"):
            require(_close(a[key], b[key], rtol),
                    f"torchrun step {k + 1} {key} {a[key]} vs one process {b[key]} (rtol {rtol})")
    steady = [m["train/secs_per_step"] for m in got[1:]]
    ref_steady = ", ".join(f"{1000 * m['train/secs_per_step']:.1f}" for m in ref[1:])
    phase("multigpu", f"{_smi()}; torchrun --standalone --nproc_per_node 1 (NCCL, mesh (data 1, "
          f"model 1), tensor parallel + FSDP2), NextDiT_2B_patch2 bf16 Adafactor, 1024^2 "
          f"latents, B={B}: losses {[m['train/loss'] for m in got]} vs one process "
          f"{[m['train/loss'] for m in ref]}, grad norms "
          f"{[m['train/grad_norm'] for m in got]} vs "
          f"{[m['train/grad_norm'] for m in ref]}, largest relative difference a step "
          f"{['%.3g' % r for r in rel]} (rtol {MULTIGPU_STEP1_RTOL} step 1, "
          f"{MULTIGPU_RTOL} after); step 1 {1000 * got[0]['train/secs_per_step']:.1f} ms "
          f"(calibration included), steps 2-3 {', '.join(f'{1000 * x:.1f}' for x in steady)} "
          f"ms/step against one process's {ref_steady}; peak memory "
          f"{summary['peak_memory_gib']:.2f} GiB; wall {wall:.1f} s incl. the process start; "
          f"launches {_launched(summary['launches'])}")
    launches = dict(summary["launches"])

    # across launch modes: trainer's one-process checkpoint (step 4), a 5th
    # step by torchrun and by one process, neither written
    resume_argv = argv + ["--max_steps", "5", "--auto_resume"]
    wall2, summary2 = _torchrun_trainer(resume_argv + ["--data_parallel", "fsdp"], results)
    by_torchrun = _train_metrics(results)[-1]
    state, wall3, one, plain, peak = _run_trainer(fa, resume_argv, save=False)
    require(state.step == 5 and plain == 0, f"one-process resume: step {state.step}, {plain} plain")
    del state
    torch.cuda.empty_cache()
    by_one = _train_metrics(results)[-1]
    require(by_torchrun["step"] == by_one["step"] == 5, "the resumed runs did not take step 5")
    for key in ("train/loss", "train/grad_norm"):
        require(_close(by_torchrun[key], by_one[key], MULTIGPU_STEP1_RTOL),
                f"step 5 from the one-process checkpoint: torchrun {key} {by_torchrun[key]} vs "
                f"one process {by_one[key]}")
    phase("multigpu", f"trainer's one-process step-4 checkpoint resumed for step 5: torchrun loss "
          f"{by_torchrun['train/loss']}, grad norm {by_torchrun['train/grad_norm']}, "
          f"{1000 * by_torchrun['train/secs_per_step']:.1f} ms (calibration included), peak "
          f"{summary2['peak_memory_gib']:.2f} GiB, wall {wall2:.1f} s; one process loss "
          f"{by_one['train/loss']}, grad norm {by_one['train/grad_norm']}, "
          f"{1000 * by_one['train/secs_per_step']:.1f} ms, wall {wall3:.1f} s (rtol "
          f"{MULTIGPU_STEP1_RTOL}); no checkpoint written")
    for name, n in summary2["launches"].items():
        launches[name] = launches.get(name, 0) + n
    for name in ("online_lse", "static_max_lse", "bwd_fused"):
        require(launches.get(name, 0) > 0, f"kernel {name} was not launched under torchrun")
    return {name: n for name, n in launches.items() if n}


def ring_fold_phase(fa):
    """Context-parallel attention's ring fold in one process at the 2B's
    self-attention (2, 4096, 32, 72) bf16: 4 key blocks of 1024 through K4
    (`flash_online_lse`) folded by `ops/context_parallel.ring_fold`, against
    K2 over all keys and against the same fold over the plain K4; again with
    the second block wholly masked. Returns the fold's K4 launches."""
    from lumina_t2x_tpu_torch.ops.context_parallel import ring_fold

    g = torch.Generator(device="cuda").manual_seed(11)
    q, k, v = (_rand(g, B, S, H, D, dtype=torch.bfloat16) for _ in range(3))
    scale = D ** -0.5
    n_blocks, blk = 4, S // 4
    launched = 0
    for label, masked in (("no mask", None), ("block 2 wholly masked", 1)):
        mask = torch.ones((B, S), dtype=torch.int32, device="cuda")
        if masked is not None:
            mask[:, masked * blk:(masked + 1) * blk] = 0
        blocks = [(k[:, i * blk:(i + 1) * blk], v[:, i * blk:(i + 1) * blk],
                   mask[:, i * blk:(i + 1) * blk]) for i in range(n_blocks)]
        fa.reset_launch_counts()
        got = ring_fold(q, blocks, scale)
        torch.cuda.synchronize()
        launched += fa.LAUNCHES["online_lse"]
        require(fa.LAUNCHES["online_lse"] == n_blocks and fa.PLAIN_CUDA_CALLS["count"] == 0,
                f"ring fold launches {dict(fa.LAUNCHES)}")
        k2 = fa.flash_online(q, k, v, mask, scale)
        plain = ring_fold(q, blocks, scale, block_fn=fa.flash_online_lse_plain)
        top = k2.float().abs().max().item()
        max_bar = RING_MAX_ULPS * 2.0 ** (math.floor(math.log2(top)) - 7)
        mean_bar = BF16_MEAN * top
        err_k2, err_plain = ((got.float() - ref.float()).abs() for ref in (k2, plain))
        (err_k2, mean_k2), (err_plain, mean_plain) = (
            (e.max().item(), e.mean().item()) for e in (err_k2, err_plain))
        require(torch.isfinite(got).all().item() and max(err_k2, err_plain) <= max_bar
                and max(mean_k2, mean_plain) <= mean_bar,
                f"ring fold ({label}): max / mean err {err_k2} / {mean_k2} vs K2, {err_plain} / "
                f"{mean_plain} vs the plain ring (bars {max_bar} / {mean_bar})")
        fold_ms = time_ms(lambda: ring_fold(q, blocks, scale))
        k2_ms = time_ms(lambda: fa.flash_online(q, k, v, mask, scale))
        phase("multigpu", f"ring fold ({label}), (2, 4096, 32, 72) bf16 in {n_blocks} key blocks "
              f"through K4: max / mean abs err {err_k2:.3g} / {mean_k2:.3g} vs K2 over all keys, "
              f"{err_plain:.3g} / {mean_plain:.3g} vs the plain ring (max|K2| {top:.4g}; bars "
              f"{max_bar:.3g} = {RING_MAX_ULPS} bf16 ulps / {mean_bar:.3g}); fold {fold_ms:.3f} "
              f"ms, K2 {k2_ms:.3f} ms; {n_blocks} K4 launches")
        del got, k2, plain
    return {"online_lse": launched}


def textenc_phase(fa):
    """Gemma-2B at its published widths (`GEMMA_2B`), random bf16 weights from
    seed 0, and the port's in-memory character-level tokenizer, saved to
    build/ and read back through `DecoderTextEncoder.from_pretrained`; its
    features must equal, bit for bit, the output of decoder layer L-2 taken
    by a forward hook. Times the encode of 2 prompts and 2 empty captions at
    up to 256 tokens. Returns the directory."""
    from transformers import GemmaConfig, GemmaModel

    from lumina_t2x_tpu_torch.codecs.text_encoders import DecoderTextEncoder, char_tokenizer

    path = os.path.join(ROOT, "build", "gemma_2b_random")
    fa.reset_launch_counts()
    torch.manual_seed(0)
    t0 = time.perf_counter()
    default_dtype = torch.get_default_dtype()
    torch.set_default_dtype(torch.bfloat16)
    try:
        with torch.device("cuda"):
            model = GemmaModel(GemmaConfig(**GEMMA_2B))
    finally:
        torch.set_default_dtype(default_dtype)
    n_params = sum(p.numel() for p in model.parameters())
    model.save_pretrained(path)
    char_tokenizer().save_pretrained(path)
    del model
    torch.cuda.empty_cache()
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    enc = DecoderTextEncoder.from_pretrained(path, dtype=torch.bfloat16, max_length=256,
                                             device="cuda")
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    prompts = [LONG_PROMPT, PROMPT, "", ""]
    taken = []
    layers = enc.model.layers
    hook = layers[len(layers) - 2].register_forward_hook(
        lambda mod, args, out: taken.append(out[0] if isinstance(out, tuple) else out))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats, mask = enc.encode(prompts)
    torch.cuda.synchronize()
    first_ms = 1e3 * (time.perf_counter() - t0)
    hook.remove()
    lengths = mask.sum(dim=1).tolist()
    require(feats.shape == (4, 256, 2048) and feats.dtype == torch.bfloat16,
            f"Gemma features {tuple(feats.shape)} {feats.dtype}")
    require(lengths == [256, len(PROMPT) + 1, 1, 1], f"caption lengths {lengths}")
    require(bool(torch.isfinite(feats).all()), "Gemma features not finite")
    require(len(taken) == 1 and torch.equal(feats, taken[0]),
            "hidden_states[-2] is not decoder layer L-2's output bit for bit")
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(lambda: enc.encode(prompts))
    peak = torch.cuda.max_memory_allocated() / 2**30
    # 2 FLOPs per weight per token over the decoder layers, plus QK^T and PV
    per_layer = sum(p.numel() for p in layers[0].parameters())
    tokens = feats.shape[0] * feats.shape[1]
    flops = 2 * per_layer * len(layers) * tokens \
        + 2 * 2 * len(layers) * feats.shape[0] * 256 * 256 * GEMMA_2B["num_attention_heads"] \
        * GEMMA_2B["head_dim"]
    bound = least_time(2 * (n_params - enc.model.embed_tokens.weight.numel()), flops,
                       torch.bfloat16)
    phase("textenc", f"GemmaModel at Gemma-2B's widths ({n_params / 1e9:.3f}B params, bf16, "
          f"random from seed 0) saved in {t_save:.1f} s, loaded by from_pretrained in "
          f"{t_load:.1f} s; char tokenizer; 2 prompts + 2 empty captions -> {tuple(feats.shape)}, "
          f"caption tokens {lengths}; equal to layer {len(layers) - 2}'s output by hook bit for "
          f"bit; encode {ms:.2f} ms (median of 7; the first call {first_ms:.1f} ms), "
          f"{flops / 1e12:.3f} TFLOP, bound "
          f"{bound['bound_ms']:.3f} ms ({bound['bound_by']}); peak memory {peak:.2f} GiB; "
          f"plain-version CUDA calls {fa.PLAIN_CUDA_CALLS['count']}")
    del enc, feats, taken
    torch.cuda.empty_cache()
    return path


def t2i_encoder_phase(fa, vae_path, gemma_path):
    """`pipelines.sample.main --text_encoder`: the prompt and one empty
    caption through the random Gemma-2B into NextDiT_2B_patch2 (qk-norm,
    random weights from --seed), 1024^2, 10 steps, --vae_ckpt: one PNG."""
    with tempfile.TemporaryDirectory() as out:
        prompts = os.path.join(out, "prompts.txt")
        with open(prompts, "w") as f:
            f.write(PROMPT + "\n")
        manifest, wall, secs, launches, plain = _sample_cli(
            fa, ["--model", "NextDiT_2B_patch2", "--qk_norm", "--text_encoder", gemma_path,
                 "--caption_path", prompts, "--resolution", "1:1024x1024",
                 "--num_sampling_steps", "10", "--time_shifting_factor", "4",
                 "--vae_ckpt", vae_path, "--image_save_path", os.path.join(out, "png")])
        pixels = _pngs(manifest, (1024, 1024, 3))
    require(len(pixels) == 1 and plain == 0, f"--text_encoder: {len(pixels)} PNGs, {plain} plain")
    require(manifest["args"]["cap_feat_dim"] == 2048, "cap_feat_dim is not Gemma's hidden size")
    require(manifest["caption_tokens"] == [len(PROMPT) + 1, 1],
            f"caption tokens {manifest['caption_tokens']}")
    require(launches["small_kv"] > 0, f"K1 not launched: {launches}")
    phase("t2i", f"sample.main NextDiT_2B_patch2 --qk_norm --text_encoder <Gemma-2B> 1024^2, 10 "
          f"steps, --vae_ckpt: one PNG 1024x1024 (mean {pixels[0].mean():.1f}); caption tokens "
          f"{manifest['caption_tokens']} (K1 at Sk=40); K1 launches {launches['small_kv']}; "
          f"trajectory and decode {secs} s, wall {wall:.1f} s incl. set-up and the encoder's "
          f"load; launches { {k: v for k, v in launches.items() if v} }; plain-version CUDA "
          f"calls {plain}")
    torch.cuda.empty_cache()


def _smoke_image(w, h, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255.0 / w, yy * 255.0 / h, np.full((h, w), 40.0 * seed)], -1)
    return np.clip(base + rng.normal(0, 8, base.shape), 0, 255).astype(np.uint8)


def t2idata_phase(fa, vae_path, gemma_path):
    """The trainer on a meta dataset: 8 PNGs (4 square, 4 at 2:1) in a
    block-YAML config at --image_size 1024, NextDiT_2B_patch2 for 3 steps,
    bf16, global batch 2, --checkpointing, bf16 Adafactor, the random
    Gemma-2B (--text_encoder) and the VAE (--vae_ckpt) in the loop, decoded
    by Pillow. Then encode_latents on 4 of the images."""
    from lumina_t2x_tpu_torch.pipelines import encode_latents
    from lumina_t2x_tpu_torch.utils import png_bytes

    captions = ["a lighthouse", PROMPT, LONG_PROMPT[:130], "a red fox in the snow at dusk",
                "", "two boats", LONG_PROMPT[:70], "macro photograph of a honey bee on a flower"]
    sizes = [(1024, 1024)] * 4 + [(1536, 768)] * 4
    with tempfile.TemporaryDirectory() as tmp:
        rows = []
        for i, ((w, h), cap) in enumerate(zip(sizes, captions)):
            with open(os.path.join(tmp, f"{i}.png"), "wb") as f:
                f.write(png_bytes(_smoke_image(w, h, i)))
            rows.append({"path": f"{i}.png", "caption": cap})
        with open(os.path.join(tmp, "ann.json"), "w") as f:
            json.dump(rows, f)
        cfg = os.path.join(tmp, "data.yaml")
        with open(cfg, "w") as f:
            f.write(f"META:\n  - path: {tmp}/ann.json\n    type: default\n    root: {tmp}\n")
        results = os.path.join(tmp, "results")
        # no checkpoint: the trainer phase writes and resumes the 2B's, and this
        # one's 7.4 GiB would take the call past its 45 GiB of disk writes
        state, wall, launches, plain, peak = _run_trainer(fa, [
            "--model", "NextDiT_2B_patch2", "--data_path", cfg, "--image_size", "1024",
            "--global_batch_size", str(B), "--precision", "bf16", "--grad_precision", "fp32",
            "--qk_norm", "--checkpointing", "--flash_static_max", "auto", "--optimizer",
            "adafactor", "--param_dtype", "bf16", "--text_encoder", gemma_path, "--vae_ckpt",
            vae_path, "--num_workers", "4", "--results_dir", results,
            "--max_steps", "3", "--log_every", "1", "--ckpt_every", "1000", "--device", "cuda"],
            save=False)
        require(state.step == 3, f"meta trainer stopped at step {state.step}")
        del state
        fa.set_flash_static_max_train(None)
        torch.cuda.empty_cache()
        metrics = _train_metrics(results)
        with open(os.path.join(results, "NextDiT_2B_patch2", "log.txt")) as f:
            said = [line for line in f if "image decoder" in line]
        buckets = [(int(m["train/bucket_w"]), int(m["train/bucket_h"])) for m in metrics]
        require(len(metrics) == 3 and all(math.isfinite(m["train/loss"]) for m in metrics),
                "meta trainer losses not finite")
        require(len(set(buckets)) >= 2, f"one bucket only: {buckets}")
        require(said and "image decoder pil" in said[0], f"decoder line {said}")
        require(plain == 0, f"meta trainer: plain versions ran {plain} times on CUDA")
        for name in ("online_lse", "static_max_lse", "bwd_fused"):
            require(launches[name] > 0, f"kernel {name} was not launched by the meta trainer")
        steady = metrics[1:]
        mean = lambda key: statistics.mean(m[key] for m in steady)
        phase("t2idata", f"train.main on a block-YAML meta dataset of 8 PNGs (1024x1024 and "
              f"1536x768) at --image_size 1024, NextDiT_2B_patch2, bf16 Adafactor, B={B}, dots "
              f"remat, Gemma-2B and the VAE in the loop; image decoder pil; buckets {buckets}; "
              f"losses {[round(m['train/loss'], 5) for m in metrics]}; "
              f"step 1 {metrics[0]['train/secs_per_step']:.3f} s (calibration included), steps "
              f"2-3 {mean('train/secs_per_step'):.3f} s/step; data wait "
              f"{[round(m['train/data_wait_ms'], 1) for m in metrics]} ms, text encode "
              f"{[round(m['train/text_encode_ms'], 2) for m in metrics]} ms, VAE encode "
              f"{[round(m['train/vae_encode_ms'], 1) for m in metrics]} ms; peak memory "
              f"{peak:.2f} GiB; wall {wall:.1f} s incl. set-up, no checkpoint written; launches "
              f"{launches}; plain-version CUDA calls {plain}")

        out = os.path.join(tmp, "encoded")
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        encode_latents.main(["--data_path", cfg, "--out", out, "--image_size", "1024",
                             "--vae_ckpt", vae_path, "--text_encoder", gemma_path, "--limit", "4",
                             "--device", "cuda"])
        wall = time.perf_counter() - t0
        with open(os.path.join(out, "index.json")) as f:
            index = json.load(f)
        shapes = [tuple(np.load(os.path.join(out, "latents", f"{i}.npy")).shape) for i in range(4)]
        caps = [np.load(os.path.join(out, "captions", f"{i}.npy")) for i in range(4)]
        require(len(index) == 4 and all(s[0] == 4 and s[1] * s[2] * 64 <= 1024 * 1024 * 1.01
                                        for s in shapes), f"latents {shapes}")
        require([c.shape for c in caps] == [(len(captions[i]) + 1, 2048) for i in range(4)]
                and all(np.isfinite(c).all() for c in caps), "caption features")
        phase("t2idata", f"encode_latents --limit 4 at 1024: latents {shapes}, caption features "
              f"{[c.shape for c in caps]}; wall {wall:.1f} s incl. the encoder's load; "
              f"plain-version CUDA calls {fa.PLAIN_CUDA_CALLS['count']}")
    torch.cuda.empty_cache()


# -- Flag-DiT, Next-DiT-MoE, compositional generation, img2img -------------------------


def _steady(metrics):
    """Mean seconds a step after the first (the first builds and warms up)."""
    rest = [r["train/secs_per_step"] for r in metrics[1:]] or [metrics[0]["train/secs_per_step"]]
    return statistics.mean(rest)


def _launched(launches):
    return {k: v for k, v in launches.items() if v}


def _write_llama(path):
    """A LlamaModel at LLaMA-2-7B's widths (`LLAMA_2_7B`), LLAMA_LAYERS
    decoder layers, bf16, random from seed 0, with the port's character-level
    tokenizer, saved for `--text_encoder`. Returns its parameter count."""
    from transformers import LlamaConfig, LlamaModel

    from lumina_t2x_tpu_torch.codecs.text_encoders import char_tokenizer

    torch.manual_seed(0)
    default_dtype = torch.get_default_dtype()
    torch.set_default_dtype(torch.bfloat16)
    try:
        with torch.device("cuda"):
            model = LlamaModel(LlamaConfig(num_hidden_layers=LLAMA_LAYERS, **LLAMA_2_7B))
    finally:
        torch.set_default_dtype(default_dtype)
    n = sum(p.numel() for p in model.parameters())
    model.save_pretrained(path)
    char_tokenizer().save_pretrained(path)
    del model
    torch.cuda.empty_cache()
    return n


def flag_dit_phase(fa, vae_path):
    """The Flag-DiT 5B (`DiT_Llama_5B_patch2` at its published widths, bf16
    parameters, qk-norm): one CFG forward at 1024^2 (zero-init tensors
    randomised) through the kernels, the plain versions and sdpa; then the
    sampler CLI with `--bf16_params --qk_norm`, 1024^2, CFG 4, t-shift 4, a
    10-point midpoint trajectory, random weights from --seed, the captions
    of a random LLaMA-2-7B-wide LM (`_write_llama`: 128 tokens) and
    `--vae_ckpt`; then FlagDiT_ImageNet_7B_patch2 --bf16_params, 4 labels at
    256^2, 10 points. Returns the launches of the head_dim-96 sampler rows
    and of K1 at head_dim 128."""
    from lumina_t2x_tpu_torch.models import get_model
    from lumina_t2x_tpu_torch.models.flag_dit import forward_with_cfg

    torch.manual_seed(0)
    model = get_model("DiT_Llama_5B_patch2", qk_norm=True, dtype=torch.bfloat16,
                      param_dtype=torch.bfloat16, device="cuda").eval()
    n = _randomise_zero_init(model, 5)
    params = sum(p.numel() for p in model.parameters())
    g = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn(1, 4, 128, 128, generator=g, device="cuda").repeat(2, 1, 1, 1)
    cap = torch.randn(2, 128, 4096, generator=g, device="cuda")
    cap_mask = torch.ones(2, 128, dtype=torch.int32, device="cuda")
    cap_mask[1, 1:] = 0  # the empty caption: <bos> only
    t = torch.zeros(2, device="cuda")
    outs = {}
    with torch.no_grad():
        for impl in ("flash", "plain", "xla"):
            model.set_attn_impl(impl)
            outs[impl] = forward_with_cfg(model, x, t, 4.0, cap_feats=cap, cap_mask=cap_mask)
    torch.cuda.synchronize()
    fast, ref = outs["flash"], outs["plain"]
    require(fast.shape == (2, 4, 128, 128) and bool(torch.isfinite(fast).all()),
            "5B forward: bad shape or non-finite output")
    rel = ((fast - ref).norm() / ref.norm()).item()
    floor = ((outs["xla"] - ref).norm() / ref.norm()).item()
    phase("flagdit", f"DiT_Llama_5B_patch2 ({params / 1e9:.3f}B params, {2 * params / 2**30:.2f} "
          f"GiB in bf16, {n} zero-init tensors randomised) CFG forward at 1024^2 (64 x 65 tokens "
          f"with [eol], head_dim 96), 128 caption tokens: rel L2 kernels vs plain {rel:.4g} "
          f"(sdpa vs plain {floor:.4g})")
    require(rel <= max(2e-2, GRAD_FLOOR_FACTOR * floor), f"5B forward rel L2 {rel}")
    del model, outs, fast, ref
    torch.cuda.empty_cache()

    llama = os.path.join(ROOT, "build", "llama_2_7b_cut")
    with tempfile.TemporaryDirectory() as out:
        n_llama = _write_llama(llama)
        prompts = os.path.join(out, "prompts.txt")
        with open(prompts, "w") as f:
            f.write((LONG_PROMPT * 2)[:FLAG_PROMPT_CHARS - 1] + ".\n")  # no trailing space
        torch.cuda.reset_peak_memory_stats()
        manifest, wall, secs, launches, plain = _sample_cli(
            fa, ["--model", "DiT_Llama_5B_patch2", "--bf16_params", "--qk_norm",
                 "--text_encoder", llama, "--caption_path", prompts, "--resolution",
                 "1:1024x1024", "--num_sampling_steps", "10", "--cfg_scale", "4.0",
                 "--time_shifting_factor", "4", "--seed", "0", "--vae_ckpt", vae_path,
                 "--image_save_path", os.path.join(out, "png")])
        peak = torch.cuda.max_memory_allocated() / 2**30
        pixels = _pngs(manifest, (1024, 1024, 3))
        shutil.rmtree(llama)
    bound = re.findall(r"static-max calibrated: ([0-9.]+)", manifest["stdout"])
    require(len(pixels) == 1 and plain == 0, f"5B sampler: {len(pixels)} PNGs, {plain} plain")
    require(manifest["args"]["cap_feat_dim"] == 4096 and manifest["caption_tokens"] == [128, 1],
            f"5B captions: {manifest['args']['cap_feat_dim']}, {manifest['caption_tokens']}")
    require(bool(bound), "the 5B sampler did not calibrate")
    for name in SAMPLER_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched by the 5B sampler")
    phase("flagdit", f"sample.main DiT_Llama_5B_patch2 --bf16_params --qk_norm --text_encoder "
          f"<LLaMA-2-7B widths, {LLAMA_LAYERS} layers, {n_llama / 1e9:.3f}B params> 1024^2, "
          f"10-point midpoint, CFG 4, t-shift 4, --vae_ckpt: one PNG 1024x1024 (mean "
          f"{pixels[0].mean():.1f}); caption tokens {manifest['caption_tokens']}; calibrated "
          f"bound {bound[0]}; trajectory and decode {secs} s, {manifest['seconds'] / 9:.3f} s a "
          f"midpoint step (2 CFG forwards); peak memory {peak:.2f} GiB; wall {wall:.1f} s incl. "
          f"set-up; launches {_launched(launches)}; plain-version CUDA calls {plain}")

    gc.collect()  # what the 5B sampler left to the cycle collector (its model)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out:
        torch.cuda.reset_peak_memory_stats()
        manifest7, wall7, secs7, launches7, plain7 = _sample_cli(
            fa, ["--model", "FlagDiT_ImageNet_7B_patch2", "--bf16_params", "--debug",
                 "--labels", LABELS, "--resolution", "1:256x256", "--num_sampling_steps", "10",
                 "--cfg_scale", "4.0", "--vae_ckpt", vae_path, "--image_save_path", out])
        peak7 = torch.cuda.max_memory_allocated() / 2**30
        pixels7 = _pngs(manifest7, (256, 256, 3))
    require(len(pixels7) == 4 and plain7 == 0 and launches7["small_kv"] == 32 * manifest7["nfe"],
            f"7B sampler: {len(pixels7)} PNGs, launches {launches7}, plain {plain7}")
    phase("flagdit", f"sample.main FlagDiT_ImageNet_7B_patch2 --bf16_params --debug --labels "
          f"{LABELS} 256^2, 10-point midpoint, CFG 4, --vae_ckpt: 4 PNGs; trajectory "
          f"{manifest7['seconds']:.2f} s, with decode {secs7} s; peak memory {peak7:.2f} GiB; "
          f"wall {wall7:.1f} s; launches {_launched(launches7)} (K1 at {D128_K1})")
    torch.cuda.empty_cache()
    return {**{f"{name}_d96_5b": launches[name] for name in SAMPLER_KERNELS},
            "small_kv_d128_7b": launches7["small_kv"]}


def flag_dit_train_phase(fa):
    """The 5B trainer on `synthetic://128x128` (1024^2 latents), B=2, bf16
    Adafactor, --param_dtype bf16, --checkpointing, --cap_feat_dim 4096,
    --qk_norm, --flash_static_max auto, 3 steps, the third under
    LUMINA_FLASH_FUSED_BWD=0, no checkpoint written (a 5B one is 19 GiB of
    the call's 45 GiB of writes); then FlagDiT_ImageNet_600M_patch2 through
    the class-conditional trainer at 256^2, B=256, 2 steps. Returns the
    launches of the head_dim-96 trainer rows and the 600M's."""
    with tempfile.TemporaryDirectory() as results:
        state, wall, launches, plain, peak = _run_trainer(fa, [
            "--model", "DiT_Llama_5B_patch2", "--data_path", "synthetic://128x128",
            "--global_batch_size", "2", "--max_steps", "3", "--precision", "bf16",
            "--optimizer", "adafactor", "--param_dtype", "bf16", "--checkpointing",
            "--cap_feat_dim", "4096", "--qk_norm", "--flash_static_max", "auto",
            "--results_dir", results, "--log_every", "1", "--device", "cuda"],
            save=False, unfused_from=3)
        m = _class_metrics(results, "DiT_Llama_5B_patch2")
    params = sum(p.numel() for p in state.model.parameters())
    require(state.step == 3 and len(m) == 3 and all(math.isfinite(r["train/loss"]) for r in m),
            f"5B trainer: step {state.step}, losses {[r['train/loss'] for r in m]}")
    require(plain == 0, f"5B trainer: plain versions ran {plain} times on CUDA")
    for name in TRAIN_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched by the 5B trainer")
    del state
    torch.cuda.empty_cache()
    phase("flagtrain", f"train.main DiT_Llama_5B_patch2 ({params / 1e9:.3f}B params) "
          f"synthetic 1024^2 latents, B=2, bf16 Adafactor, --checkpointing, --qk_norm "
          f"--flash_static_max auto, 3 steps (the third with LUMINA_FLASH_FUSED_BWD=0), no "
          f"checkpoint: losses {[round(r['train/loss'], 5) for r in m]}; s/step "
          f"{[round(r['train/secs_per_step'], 3) for r in m]}; peak memory {peak:.2f} GiB; wall "
          f"{wall:.1f} s; launches {_launched(launches)}")
    rows = {f"{name}_d96_5b": launches[name] for name in TRAIN_KERNELS}
    fa.set_flash_static_max_train(None)

    model = "FlagDiT_ImageNet_600M_patch2"
    with tempfile.TemporaryDirectory() as results:
        state, wall, l600, plain, peak = _run_trainer(fa, [
            "--model", model, "--data_path", "synthetic://32x32", "--global_batch_size", "256",
            "--max_steps", "2", "--precision", "bf16", "--optimizer", "adafactor",
            "--param_dtype", "bf16", "--checkpointing", "--qk_norm", "--results_dir", results,
            "--log_every", "1", "--device", "cuda"], save=False)
        m = _class_metrics(results, model)
    require(state.step == 2 and all(math.isfinite(r["train/loss"]) for r in m) and plain == 0
            and l600["online_lse"] > 0 and l600["bwd_fused"] > 0,
            f"{model}: step {state.step}, launches {l600}, plain {plain}")
    phase("flagtrain", f"train.main {model} synthetic 256^2 latents, B=256, bf16 Adafactor, "
          f"--checkpointing --qk_norm, 2 steps: losses {[round(r['train/loss'], 5) for r in m]}; "
          f"s/step {[round(r['train/secs_per_step'], 3) for r in m]} "
          f"({CLASSTRAIN_B / _steady(m):.1f} imgs/s after the first); peak memory {peak:.2f} GiB; "
          f"wall {wall:.1f} s; launches {_launched(l600)}")
    del state
    torch.cuda.empty_cache()
    return rows, l600


def moe_phase(fa):
    """Each Next-DiT-MoE 600M variant through the trainer on
    `synthetic://32x32` (256^2 latents), B=256, bf16 Adafactor,
    --checkpointing with `dots_slim` (`dots` would keep ~54 GB of matmul
    outputs for Time and Spatial, ~94 GB for Both: two top-2 FFNs), --qk_norm,
    2 steps; `Both` writes its step-2 checkpoint
    (the bytes reckoned first) and the sampler CLI loads it for 4 labels at
    256^2 (10 points); `Time` and `Spatial` write none and are sampled with
    --debug random weights. Returns the launches at the 600M's head_dim-48
    shapes."""
    from lumina_t2x_tpu_torch.models import get_model

    total = {}
    for model in MOE_MODELS:
        both = model.endswith("Both")
        n = sum(p.numel() for p in get_model(model, device="meta").parameters())
        with tempfile.TemporaryDirectory() as results:
            state, wall, launches, plain, peak = _run_trainer(fa, [
                "--model", model, "--data_path", "synthetic://32x32",
                "--global_batch_size", "256", "--max_steps", "2", "--precision", "bf16",
                "--optimizer", "adafactor", "--param_dtype", "bf16", "--checkpointing",
                "--remat_policy", "dots_slim", "--qk_norm", "--results_dir", results,
                "--log_every", "1", "--device", "cuda"], save=both)
            m = _class_metrics(results, model)
            require(state.step == 2 and all(math.isfinite(r["train/loss"]) for r in m)
                    and plain == 0 and launches["online_lse"] > 0 and launches["bwd_fused"] > 0,
                    f"{model}: step {state.step}, launches {launches}, plain {plain}")
            del state
            torch.cuda.empty_cache()
            written = ""
            argv = ["--debug", "--model", model]
            if both:
                ckpt = os.path.join(results, model, "checkpoints", "0000002")
                size = sum(os.path.getsize(os.path.join(d, f))
                           for d, _, files in os.walk(ckpt) for f in files)
                written = (f"; checkpoint {size / 2**30:.2f} GiB (reckoned: model and EMA "
                           f"{2 * 2 * n / 2**30:.2f} GiB in bf16 + Adafactor's factored stats)")
                argv = ["--ckpt", ckpt]
            manifest, swall, secs, sl, splain = _sample_cli(fa, argv + [
                "--labels", LABELS, "--resolution", "1:256x256", "--num_sampling_steps", "10",
                "--cfg_scale", "4.0", "--image_save_path", os.path.join(results, "samples")])
            samples = [np.load(item["path"]) for item in manifest["items"]]
        require(len(samples) == 4 and all(a.shape == (4, 32, 32) and np.isfinite(a).all()
                                          for a in samples) and splain == 0
                and sl["small_kv"] == 16 * manifest["nfe"],
                f"{model} samples: {[a.shape for a in samples]}, launches {sl}, plain {splain}")
        phase("moe", f"train.main {model} ({n / 1e9:.3f}B params) synthetic 256^2 latents, "
              f"B=256, bf16 Adafactor, --checkpointing --qk_norm, 2 steps: losses "
              f"{[round(r['train/loss'], 5) for r in m]}; s/step "
              f"{[round(r['train/secs_per_step'], 3) for r in m]}; peak memory {peak:.2f} GiB; "
              f"wall {wall:.1f} s{written}; launches {_launched(launches)}; sample.main "
              f"{'--ckpt <step 2>' if both else '--debug'} --labels {LABELS} 256^2, 10 points: "
              f"4 latents {samples[0].shape}, finite, std "
              f"{[round(float(a.std()), 3) for a in samples]}; trajectory "
              f"{manifest['seconds']:.2f} s; K1 launches {sl['small_kv']}")
        for key, value in {**launches, "small_kv": sl["small_kv"]}.items():
            total[key] = total.get(key, 0) + value
    torch.cuda.empty_cache()
    return total


def compositional_phase(fa, vae_path):
    """`pipelines.compositional_app.main` on NextDiT_2B_patch2_Compositional
    (random weights from --seed, hashed caption features) at 1024^2 with a
    1 x 4 region grid, 30 points, --vae_ckpt: seconds, K2's launches (the
    self-attention; the region cross-attention is plain, as in JAX) and the
    PNG. Returns its launches."""
    from lumina_t2x_tpu_torch.pipelines import compositional_app

    fa.reset_launch_counts()
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        manifest = compositional_app.main([
            "--region_prompts", "a red fox", "a snowy field", "a frozen lake", "a pine forest",
            "--global_prompt", "a winter landscape at dawn", "--h_split_num", "1",
            "--w_split_num", "4", "--resolution", "1024x1024", "--num_sampling_steps", "30",
            "--vae_ckpt", vae_path, "--image_save_path", out, "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with open(manifest["png"], "rb") as f:
            pixels = _png_pixels(f.read())
        latent = np.load(manifest["output"])
    launches, plain = dict(fa.LAUNCHES), fa.PLAIN_CUDA_CALLS["count"]
    require(pixels.shape == (1024, 1024, 3) and latent.shape == (1, 4, 128, 128)
            and np.isfinite(latent).all(), f"compositional: PNG {pixels.shape}, {latent.shape}")
    require(plain == 0 and launches["online"] == 24 * manifest["nfe"],
            f"compositional: launches {launches}, NFE {manifest['nfe']}, plain {plain}")
    phase("compositional", f"compositional_app NextDiT_2B_patch2_Compositional 1024^2, 1 x 4 "
          f"regions, 30-point midpoint, CFG 4, --vae_ckpt: PNG {pixels.shape} (mean "
          f"{pixels.mean():.1f}); trajectory {manifest['seconds']:.2f} s (NFE {manifest['nfe']}), "
          f"wall {wall:.1f} s incl. set-up and decode; K2 launches {launches['online']}; "
          f"launches {_launched(launches)}; plain-version CUDA calls {plain}")
    torch.cuda.empty_cache()
    return launches


def img2img_phase(fa, vae_path):
    """`pipelines.sample_img2img.main` on NextDiT_2B_patch2 (random weights
    from --seed, qk-norm) at --image_size 1024, strength 0.6, 30 points,
    --vae_ckpt, from a generated 1280x1024 PNG: the VAE-encode ms, the
    calibrated bound, the trajectory seconds and the PNG. Returns its
    launches."""
    from lumina_t2x_tpu_torch.pipelines import sample_img2img
    from lumina_t2x_tpu_torch.utils import png_bytes

    fa.reset_launch_counts()
    with tempfile.TemporaryDirectory() as out:
        image = os.path.join(out, "in.png")
        with open(image, "wb") as f:
            f.write(png_bytes(_smoke_image(1280, 1024, 9)))
        t0 = time.perf_counter()
        manifest = sample_img2img.main([
            "--image_path", image, "--caption", PROMPT, "--image_size", "1024",
            "--strength", "0.6", "--num_sampling_steps", "30", "--vae_ckpt", vae_path,
            "--image_save_path", os.path.join(out, "out"), "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with open(manifest["output"], "rb") as f:
            pixels = _png_pixels(f.read())
    launches, plain = dict(fa.LAUNCHES), fa.PLAIN_CUDA_CALLS["count"]
    require(pixels.shape == (1024, 1024, 3) and plain == 0 and manifest["static_max"] is not None,
            f"img2img: PNG {pixels.shape}, bound {manifest['static_max']}, plain {plain}")
    for name in SAMPLER_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched by img2img")
    phase("img2img", f"sample_img2img NextDiT_2B_patch2 --image_size 1024 --strength 0.6, "
          f"30 points, --vae_ckpt: VAE encode {manifest['encode_ms']:.1f} ms; calibrated bound "
          f"{manifest['static_max']:.4f}; trajectory {manifest['seconds']:.2f} s (NFE "
          f"{manifest['nfe']}); PNG {pixels.shape} (mean {pixels.mean():.1f}); wall {wall:.1f} s "
          f"incl. set-up; launches {_launched(launches)}; plain-version CUDA calls {plain}")
    torch.cuda.empty_cache()
    return launches


def _randomised(get_model):
    """`get_model` whose models have their zero-init tensors randomised (a
    fresh NextDiT or MMDiT outputs exactly 0), for a CLI's `--seed` weights."""
    def build(*args, **kwargs):
        model = get_model(*args, **kwargs)
        _randomise_zero_init(model, 21)
        return model
    return build


def anagram_phase(fa, vae_path):
    """`pipelines.anagrams_app.main` on NextDiT_2B_patch2 (qk-norm, full width
    and depth, weights from --seed with the zero-init tensors randomised), 2
    prompts and the views identity and rotate_180, 256^2 -> 1024^2 with the
    random SD-VAE: once at the app's 30 steps (phase 2 calibrated under the
    anagram scale: K2 and K4 in the probe, K3 on the trajectory), once at
    --kv_merge_ratio 2 and ANAGRAM_KV_STEPS steps (phase 2's self-attention
    on K1 over 1024 pooled keys; nothing streams, so no bound). Seconds per phase, the bound, 4 PNGs
    a run, launches, 0 plain-version calls. Returns (K2/K3 launches of the
    first run, K1 launches over the pooled keys)."""
    from PIL import Image

    from lumina_t2x_tpu_torch.pipelines import anagrams_app

    saved = (anagrams_app.get_model, anagrams_app.anagram_upscale_phase)
    phase2 = {}

    def upscale(*args, **kwargs):  # phase 2's own launches
        before = dict(fa.LAUNCHES)
        out = saved[1](*args, **kwargs)
        phase2.update({k: v - before[k] for k, v in fa.LAUNCHES.items()})
        return out

    anagrams_app.get_model = _randomised(saved[0])
    anagrams_app.anagram_upscale_phase = upscale
    runs = []
    try:
        for ratio, steps in ((1, ANAGRAM_STEPS), (2, ANAGRAM_KV_STEPS)):
            fa.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            with tempfile.TemporaryDirectory() as out:
                t0 = time.perf_counter()
                manifest = anagrams_app.main([
                    "--prompts", *ANAGRAM_PROMPTS, "--views", *ANAGRAM_VIEWS,
                    "--base_res", "256", "--resolution", "1024", "--num_inference_steps",
                    str(steps), "--kv_merge_ratio", str(ratio), "--vae_ckpt", vae_path,
                    "--save_dir", out, "--device", "cuda"])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                sizes = [Image.open(path).size for path in manifest["paths"]]
                lat = np.load(manifest["phase2_npy"])
            launches, plain = dict(fa.LAUNCHES), fa.PLAIN_CUDA_CALLS["count"]
            views = len(ANAGRAM_VIEWS)
            forwards = (steps - 1) * views * 2 * 24  # attention calls of one kind in a phase
            require(sizes == [(256, 256)] * views + [(1024, 1024)] * views
                    and lat.shape == (1, 4, 128, 128) and np.isfinite(lat).all() and plain == 0,
                    f"anagrams (ratio {ratio}): PNGs {sizes}, latent {lat.shape}, plain {plain}")
            if ratio == 1:
                require(manifest["static_max"] is not None and phase2["static_max"] == forwards
                        and phase2["small_kv"] == forwards and launches["online_lse"] > 0,
                        f"anagrams: bound {manifest['static_max']}, phase 2 {phase2}")
            else:  # self-attention on 1024 pooled keys and captions: both K1
                require(manifest["static_max"] is None and phase2["small_kv"] == 2 * forwards
                        and phase2["static_max"] == phase2["online"] == 0,
                        f"anagrams kv_merge: bound {manifest['static_max']}, phase 2 {phase2}")
            bound = manifest["static_max"]
            phase("anagrams", f"anagrams_app NextDiT_2B_patch2 --kv_merge_ratio {ratio}, "
                  f"{' / '.join(ANAGRAM_VIEWS)}, 256^2 -> 1024^2, {steps} steps, --vae_ckpt: "
                  f"phase 1 {manifest['phase1_seconds']:.2f} s, decode + bicubic + tiled "
                  f"re-encode + calibration {manifest['reencode_calibrate_seconds']:.2f} s, "
                  f"phase 2 {manifest['phase2_seconds']:.2f} s ("
                  f"{manifest['phase2_seconds'] / (forwards // 24):.4f} s a CFG forward); bound "
                  f"{'none' if bound is None else f'{bound:.4f}'}; 4 PNGs {sizes}; wall "
                  f"{wall:.1f} s; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
                  f"launches {_launched(launches)}, phase 2's {_launched(phase2)}; "
                  f"plain-version CUDA calls {plain}")
            runs.append((launches, dict(phase2)))
    finally:
        anagrams_app.get_model, anagrams_app.anagram_upscale_phase = saved
    torch.cuda.empty_cache()
    first = runs[0][0]
    return ({"online": first["online"], "static_max": first["static_max"]},
            runs[1][1]["small_kv"] // 2)


def _sd3_diffusers_state_dict(model):
    """The inverse of `codecs/mmdit_import.import_sd3_mmdit_weights`: the
    port's MMDiT as diffusers' `SD3Transformer2DModel` names (bf16 CPU
    tensors), with the persistent 192 x 192 position buffer."""
    from lumina_t2x_tpu_torch.models.mmdit import sincos_pos_embed_2d

    sd = {k: v.detach() for k, v in model.state_dict().items()}
    out = {}

    def lin(dst, src, swap=False):
        for leaf in ("weight", "bias"):
            if f"{src}.{leaf}" in sd:
                t = sd[f"{src}.{leaf}"]
                out[f"{dst}.{leaf}"] = torch.cat(t.chunk(2, dim=0)[::-1]) if swap else t

    w, p = sd["x_embedder.weight"], model.patch_size
    out["pos_embed.proj.weight"] = w.reshape(w.shape[0], model.in_channels, p, p)
    out["pos_embed.proj.bias"] = sd["x_embedder.bias"]
    out["pos_embed.pos_embed"] = sincos_pos_embed_2d(model.dim, 192, 192, 192, 64)[None]
    for dst, src in (("context_embedder", "context_embedder"),
                     ("time_text_embed.timestep_embedder.linear_1", "t_embedder.mlp.0"),
                     ("time_text_embed.timestep_embedder.linear_2", "t_embedder.mlp.2"),
                     ("time_text_embed.text_embedder.linear_1", "pooled_hidden"),
                     ("time_text_embed.text_embedder.linear_2", "pooled_in"),
                     ("proj_out", "final_linear")):
        lin(dst, src)
    lin("norm_out.linear", "final_adaLN", swap=True)
    for i, block in enumerate(model.blocks):
        pre, blk = f"transformer_blocks.{i}", f"blocks.{i}"
        lin(f"{pre}.norm1.linear", f"{blk}.x_adaLN")
        lin(f"{pre}.norm1_context.linear", f"{blk}.c_adaLN", swap=block.context_pre_only)
        for dst, src in (("attn.to_q", "x_q"), ("attn.to_k", "x_k"), ("attn.to_v", "x_v"),
                         ("attn.add_q_proj", "c_q"), ("attn.add_k_proj", "c_k"),
                         ("attn.add_v_proj", "c_v"), ("attn.to_out.0", "x_proj"),
                         ("ff.net.0.proj", "x_mlp_in"), ("ff.net.2", "x_mlp_out"),
                         ("attn.to_add_out", "c_proj"), ("ff_context.net.0.proj", "c_mlp_in"),
                         ("ff_context.net.2", "c_mlp_out")):
            lin(f"{pre}.{dst}", f"{blk}.{src}")
        for dst, src in (("norm_q", "x_q_norm"), ("norm_k", "x_k_norm"),
                         ("norm_added_q", "c_q_norm"), ("norm_added_k", "c_k_norm")):
            if f"{blk}.{src}" in sd:
                out[f"{pre}.attn.{dst}.weight"] = sd[f"{blk}.{src}"]
    return {k: v.to("cpu", torch.bfloat16).contiguous() for k, v in out.items()}


def _sd3_prompt_encoder(seed=30):
    """The SD3 triple encoder over CLIP-L and CLIP-G at their published
    widths (`CLIP_L_CONFIG`, `CLIP_G_CONFIG`), random from `seed`, fp32 on
    the card, with the hash tokenizer; T5 left out (diffusers' zeros)."""
    from lumina_t2x_tpu_torch.codecs.clip_text import (CLIP_G_CONFIG, CLIP_L_CONFIG,
                                                       CLIPTextTower, DebugHashTokenizer,
                                                       SD3PromptEncoder)

    towers = []
    for i, cfg in enumerate((CLIP_L_CONFIG, CLIP_G_CONFIG)):
        torch.manual_seed(seed + i)
        towers.append(CLIPTextTower(**cfg, device="cuda").eval())
    tok = DebugHashTokenizer()
    return SD3PromptEncoder(towers[0], tok, towers[1], tok)


def sd3_phase(fa, sd3_vae_path):
    """`pipelines.sample_sd3.main` on MMDiT_SD3_Medium at 1024^2, 28 Euler
    steps, CFG 7, shift 3, bf16: random weights (seed 31, zero-init tensors
    randomised) written in diffusers' layout as bf16 `.safetensors` and read
    back through the importer (`load_sd3_mmdit`: architecture and qk-norm
    off the file; every weight must come back equal), CLIP-L and CLIP-G at
    their published widths with random weights and the hash tokenizer (T5
    left out: diffusers' zeros), the random z=16 VAE to a PNG. Seconds a
    step, K2's launches (24 a forward, on the unmasked 4429-key joint
    sequence), the peak, and one forward through the kernels against the
    plain versions (relative L2, with sdpa's distance as the bf16 floor).
    Returns the K2 launches."""
    from lumina_t2x_tpu_torch.models import get_model
    from lumina_t2x_tpu_torch.pipelines import sample_sd3

    torch.manual_seed(31)
    model = get_model("MMDiT_SD3_Medium", device="cuda")
    n_random = _randomise_zero_init(model, 32)
    n_params = sum(p.numel() for p in model.parameters())
    diffusers_sd = _sd3_diffusers_state_dict(model)
    written = {k: v.detach().to("cpu", torch.bfloat16) for k, v in model.state_dict().items()}
    del model
    torch.cuda.empty_cache()
    encoder = _sd3_prompt_encoder()
    captured = {}
    saved = (sample_sd3.load_model, sample_sd3.build_prompt_encoder)
    sample_sd3.load_model = lambda *a: captured.setdefault("model", saved[0](*a))
    sample_sd3.build_prompt_encoder = lambda *a, **k: encoder
    try:
        with tempfile.TemporaryDirectory() as out:
            from lumina_t2x_tpu_torch.core.checkpoint import save_safetensors

            ckpt = os.path.join(out, "sd3_transformer.safetensors")
            t0 = time.perf_counter()
            save_safetensors(diffusers_sd, ckpt)
            size = os.path.getsize(ckpt)
            write_s = time.perf_counter() - t0
            captions = os.path.join(out, "captions.txt")
            with open(captions, "w") as f:
                f.write(PROMPT + "\n")
            fa.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            info = sample_sd3.main(["--ckpt", ckpt, "--vae_ckpt", sd3_vae_path, "--caption_path",
                                    captions, "--image_save_path", os.path.join(out, "samples"),
                                    "--device", "cuda"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2**30
            launches, plain = dict(fa.LAUNCHES), fa.PLAIN_CUDA_CALLS["count"]
            with open(info[0]["path"], "rb") as f:
                pixels = _png_pixels(f.read())
    finally:
        sample_sd3.load_model, sample_sd3.build_prompt_encoder = saved
    model = captured["model"]
    mismatched = [k for k, v in model.state_dict().items()
                  if not torch.equal(v.detach().to("cpu", torch.bfloat16), written[k])]
    del diffusers_sd, written
    evals = SD3_STEPS - 1
    require(pixels.shape == (1024, 1024, 3) and plain == 0 and not mismatched
            and model.qk_norm and launches["online"] == 24 * evals,
            f"sd3: PNG {pixels.shape}, plain {plain}, mismatched {mismatched[:4]}, launches "
            f"{launches}")
    # one forward through the kernels, the plain versions and sdpa
    g = torch.Generator(device="cuda").manual_seed(33)
    x = torch.randn(1, 16, 128, 128, generator=g, device="cuda").repeat(2, 1, 1, 1)
    context, pooled = encoder.encode_cfg_pair(PROMPT)
    t = torch.full((2,), 500.0, device="cuda")
    outs = {}
    with torch.no_grad():
        for impl in ("flash", "plain", "xla"):
            model.set_attn_impl(impl)
            outs[impl] = model(x, t, context, pooled)
    torch.cuda.synchronize()
    rel, floor = (((outs[impl] - outs["plain"]).norm() / outs["plain"].norm()).item()
                  for impl in ("flash", "xla"))
    require(bool(torch.isfinite(outs["flash"]).all()) and rel <= 2e-2,
            f"sd3 forward: rel L2 kernels vs plain {rel}")
    phase("sd3", f"sample_sd3.main MMDiT_SD3_Medium ({n_params / 1e9:.3f}B params, {n_random} "
          f"zero-init tensors randomised; diffusers-layout bf16 .safetensors "
          f"{size / 2**30:.2f} GiB written in {write_s:.1f} s, read back through the importer "
          f"with qk-norm off the file, every weight equal) 1024^2, {SD3_STEPS}-point Euler, CFG "
          f"7, shift 3, bf16, CLIP-L/G at published widths (random, hash tokenizer), T5 zeros, "
          f"z=16 VAE: PNG {pixels.shape} (mean {pixels.mean():.1f}); trajectory "
          f"{info[0]['seconds']:.2f} s = {info[0]['seconds'] / evals:.4f} s a step ({evals} "
          f"steps); wall {wall:.1f} s incl. load and encode; peak {peak:.2f} GiB; K2 launches "
          f"{launches['online']} (24 a forward); launches {_launched(launches)}; plain-version "
          f"CUDA calls {plain}; one CFG forward rel L2 kernels vs plain {rel:.4g} (sdpa vs plain "
          f"{floor:.4g})")
    del model, outs, captured, encoder
    gc.collect()
    torch.cuda.empty_cache()
    return launches["online"]


def _dreambooth_args(root, sd3):
    """The DreamBooth CLI's arguments on the script's instance and class PNGs."""
    return ["--instance_data_dir", os.path.join(root, "instance"), "--class_data_dir",
            os.path.join(root, "class"), "--instance_prompt", "a photo of sks dog",
            "--class_prompt", "a photo of a dog", "--with_prior_preservation",
            "--resolution", "256", "--model", "MMDiT_SD3_Medium" if sd3 else "NextDiT_2B_patch2"]


def _dreambooth_steps(fa, dreambooth, root, sd3, vae_path):
    """3 full-width steps of `make_dreambooth_step` (prior preservation at
    256^2, AdamW with its fp32 state, the third under
    LUMINA_FLASH_FUSED_BWD=0) on `dreambooth_batches` of the PNGs through
    the VAE; no checkpoint. Returns (seconds per step, peak GiB, launches,
    plain calls, losses)."""
    from lumina_t2x_tpu_torch.codecs.vae import load_vae
    from lumina_t2x_tpu_torch.models import get_model
    from lumina_t2x_tpu_torch.pipelines.train_lib import create_optimizer, create_train_state

    args = dreambooth.parse_args(_dreambooth_args(root, sd3))
    torch.manual_seed(40)
    kw = {} if sd3 else dict(cap_feat_dim=2048, qk_norm=True)
    model = get_model(args.model, dtype=torch.bfloat16, device="cuda", **kw).train()
    _randomise_zero_init(model, 41)
    encoder = _sd3_prompt_encoder() if sd3 else None
    vae = load_vae(vae_path, device="cuda")
    batches = dreambooth.dreambooth_batches(args, vae=vae, sd3_encoder=encoder,
                                            latent_channels=16 if sd3 else 4, device="cuda")
    opt = create_optimizer(1e-5)
    state = create_train_state(model, opt)
    step = dreambooth.make_dreambooth_step(model, opt, 1.0, True, sd3=sd3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    times, losses = [], []
    try:
        for i in range(3):
            batch = next(batches)
            if i == 2:
                os.environ["LUMINA_FLASH_FUSED_BWD"] = "0"
            t0 = time.perf_counter()
            state, m = step(state, batch, 40)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(m)
    finally:
        os.environ.pop("LUMINA_FLASH_FUSED_BWD", None)
    out = (times, torch.cuda.max_memory_allocated() / 2**30, dict(fa.LAUNCHES),
           fa.PLAIN_CUDA_CALLS["count"], losses, sum(p.numel() for p in model.parameters()))
    del state, model, encoder, vae, batches, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dreambooth_phase(fa, vae_path, sd3_vae_path):
    """DreamBooth: 4 instance and 4 class PNGs written by the script; per
    mode (NextDiT_2B_patch2 with hashed caption features; MMDiT_SD3_Medium
    with the published-width CLIP towers) 3 full-width steps with prior
    preservation at 256^2 (`_dreambooth_steps`; the 2B's launches are half
    self-attention, half caption cross-attention); then the CLI
    (`pipelines.dreambooth.main`) in both modes at a depth cut to one layer
    or block, 2 steps, with its final checkpoint. Returns the launches of
    the full-width steps at the rows' shapes."""
    from lumina_t2x_tpu_torch.core.checkpoint import find_auto_resume
    from lumina_t2x_tpu_torch.pipelines import dreambooth
    from lumina_t2x_tpu_torch.utils import png_bytes

    rows = {}
    with tempfile.TemporaryDirectory() as root:
        for kind, seed in (("instance", 50), ("class", 60)):
            os.makedirs(os.path.join(root, kind))
            for i in range(4):
                with open(os.path.join(root, kind, f"{i}.png"), "wb") as f:
                    f.write(png_bytes(_smoke_image(320, 288, seed + i)))
        for sd3, tag in ((False, "db_2b"), (True, "d64_sd3")):
            times, peak, launches, plain, metrics, n = _dreambooth_steps(
                fa, dreambooth, root, sd3, sd3_vae_path if sd3 else vae_path)
            sites = 24 if sd3 else 48  # attention calls a forward: joint, or self + caption
            require(plain == 0 and all(math.isfinite(m["loss"]) for m in metrics)
                    and launches["online_lse"] == 3 * sites
                    and launches["bwd_fused"] == 2 * sites
                    and launches["bwd_dq"] == launches["bwd_dkv"] == sites,
                    f"dreambooth {tag}: launches {launches}, plain {plain}, {metrics}")
            share = 1 if sd3 else 2
            for name in ("online_lse", "bwd_fused", "bwd_dq", "bwd_dkv"):
                rows[f"{name}_{tag}"] = launches[name] // share
            phase("dreambooth", f"make_dreambooth_step "
                  f"{'MMDiT_SD3_Medium' if sd3 else 'NextDiT_2B_patch2'} ({n / 1e9:.3f}B params, "
                  f"fp32 AdamW state, bf16 activations) 256^2, 1 instance + 1 class row, prior "
                  f"preservation, VAE-encoded PNGs, 3 steps (the third under "
                  f"LUMINA_FLASH_FUSED_BWD=0): s/step {[round(t, 3) for t in times]}; losses "
                  f"{[round(m['loss'], 4) for m in metrics]}; grad norms "
                  f"{[round(m['grad_norm'], 3) for m in metrics]}; peak {peak:.2f} GiB; "
                  f"launches {_launched(launches)}; plain-version CUDA calls {plain}")

        def cut(get_model):  # one layer (NextDiT) or the last block (MMDiT)
            def build(*args, **kwargs):
                model = get_model(*args, **kwargs)
                if hasattr(model, "blocks"):
                    model.blocks = torch.nn.ModuleList(list(model.blocks)[-1:])
                else:
                    model.layers = torch.nn.ModuleList(list(model.layers)[:1])
                return model
            return build

        saved = dreambooth.get_model
        dreambooth.get_model = cut(saved)
        try:
            for sd3 in (False, True):
                out = os.path.join(root, f"out_{int(sd3)}")
                fa.reset_launch_counts()
                t0 = time.perf_counter()
                state = dreambooth.main(_dreambooth_args(root, sd3) + [
                    "--max_train_steps", "2", "--vae_ckpt", sd3_vae_path if sd3 else vae_path,
                    "--output_dir", out, "--device", "cuda"])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                ckpt = find_auto_resume(out)
                size = sum(os.path.getsize(os.path.join(d, f))
                           for d, _, files in os.walk(ckpt) for f in files) if ckpt else 0
                n = sum(p.numel() for p in state.model.parameters())
                launches, plain = dict(fa.LAUNCHES), fa.PLAIN_CUDA_CALLS["count"]
                require(state.step == 2 and ckpt and plain == 0 and launches["bwd_fused"] > 0,
                        f"dreambooth CLI: step {state.step}, ckpt {ckpt}, launches {launches}")
                phase("dreambooth", f"dreambooth.main {_dreambooth_args(root, sd3)[-1]} cut to "
                      f"one {'block' if sd3 else 'layer'} ({n / 1e6:.1f}M params), 256^2, prior "
                      f"preservation, 2 steps, --vae_ckpt: wall {wall:.1f} s incl. set-up; "
                      f"checkpoint {size / 2**30:.2f} GiB (reckoned: model, EMA, Adam's mu and "
                      f"nu in fp32, {16 * n / 2**30:.2f} GiB); launches {_launched(launches)}; "
                      f"plain-version CUDA calls {plain}")
                del state
                shutil.rmtree(out)
                torch.cuda.empty_cache()
        finally:
            dreambooth.get_model = saved
    return rows


# -- the audio and music family ----------------------------------------------------------


def audio_kernel_phase(fa):
    """FlagDiT-1D's shapes (`shape_rows`, head_dim 72): K1 in fp32 (the fp32
    kernel, `csrc/flash_fwd_fp32_sm90.cu`: the served app is fp32) and in
    bf16 at the served request's self-attention AUDIO_SERVE over its 128 keys
    (the rows) and over the 16 caption keys; K4 and K6-K8 at the trainer's
    AUDIO_TRAIN over its 256 keys (the rows) and over the 77 caption keys, and
    K6-K8 there in fp32 (`csrc/flash_bwd_fp32_sm90.cu`, the trainer's
    `--precision fp32`).
    The caption cases are timed and printed, under row names the kernels line
    does not list. fp32 K1 is also split into its kernel's device time under
    `torch.profiler` and the wrapper's host time, beside sdpa's."""
    from lumina_t2x_tpu_torch.exps import device_ms

    g = torch.Generator(device="cuda").manual_seed(16)
    results = shape_rows(fa, g, 72, [
        ("small_kv_fp32_audio", "small_kv", AUDIO_SERVE, None, None, True),
        ("small_kv_fp32_audio_ctx", "small_kv", AUDIO_SERVE, AUDIO_CONTEXT, None, True)],
        dtype=torch.float32)
    b, s, h = AUDIO_SERVE
    scale = 72 ** -0.5
    for row, sk in (("small_kv_fp32_audio", s), ("small_kv_fp32_audio_ctx", AUDIO_CONTEXT)):
        q, k, v, _ = _shape_inputs(g, b, s, h, h, 72, False, sk, dtype=torch.float32)
        k1 = lambda: fa.flash_small_kv(q, k, v, None, scale)  # noqa: E731
        lib = lambda: _sdpa(q, k, v, None, scale)  # noqa: E731
        dev, lib_dev = device_ms(k1, "flash_fwd_fp32"), device_ms(lib, "")
        calls = 200
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            k1()
        host_ms = 1e3 * (time.perf_counter() - t0) / calls
        torch.cuda.synchronize()
        results[row].update(device_ms=dev, host_ms=host_ms)
        phase("kernels", f"small_kv fp32 {(b, s, h, 72)}, Sk={sk}: CUDA events "
              f"{results[row]['ms']:.4f} ms around the wrapper, "
              + (f"{dev:.4f} ms" if dev is not None else "not traced")
              + f" of its kernel's device time a call under torch.profiler, {host_ms:.4f} ms of "
              f"host time a call back to back ({calls} calls); sdpa {results[row]['library_ms']:.4f}"
              f" ms on CUDA events, " + (f"{lib_dev:.4f} ms" if lib_dev is not None
                                         else "not traced") + " of device time a call")
        del q, k, v
    results.update(shape_rows(fa, g, 72, [
        ("small_kv_audio", "small_kv", AUDIO_SERVE, None, None, True),
        ("small_kv_audio_ctx", "small_kv", AUDIO_SERVE, AUDIO_CONTEXT, None, True),
        ("online_lse_audio", "online_lse", AUDIO_TRAIN, None, None, True),
        ("online_lse_audio_ctx", "online_lse", AUDIO_TRAIN, AUDIO_TRAIN_CONTEXT, None, True),
        ("bwd_audio", "bwd", AUDIO_TRAIN, None, None, True),
        ("bwd_audio_ctx", "bwd", AUDIO_TRAIN, AUDIO_TRAIN_CONTEXT, None, True)]))
    results.update(shape_rows(fa, g, 72, [
        ("bwd_fp32_audio", "bwd", AUDIO_TRAIN, None, None, True),
        ("bwd_fp32_audio_ctx", "bwd", AUDIO_TRAIN, AUDIO_TRAIN_CONTEXT, None, True)],
        dtype=torch.float32))
    return results


def fp32_forward_phase(fa):
    """The fp32 streaming forwards (K2-K5 on `csrc/flash_fwd_fp32_sm90.cu`)
    at the 2B's (B, S, H, D), timed against their plain versions, their
    bound at the fp32 rate (PEAK_FP32) and one library call in fp32 (sdpa for
    K2/K3, aten's memory-efficient attention with its LSE for K4/K5), then
    with 4:1 GQA, a masked tail and a fully masked batch row (`shape_rows`).
    K4's row is on the kernels line with the fp16 trainer leg's launches
    (fp16 runs the fp32 kernels); the others are printed only: no main path
    runs them (the 2B runs bf16)."""
    g = torch.Generator(device="cuda").manual_seed(17)
    return shape_rows(fa, g, D, [(f"{entry}_fp32_2b", entry, (B, S, H), None, None, True)
                                 for entry in ("online", "static_max", "online_lse",
                                               "static_max_lse")], dtype=torch.float32)


def _wav_frames(data):
    """(frames, sample rate) of a mono 16-bit WAV's bytes."""
    import io
    import wave

    with wave.open(io.BytesIO(data), "rb") as f:
        require(f.getnchannels() == 1 and f.getsampwidth() == 2, "WAV not mono 16-bit")
        return f.getnframes(), f.getframerate()


def _write_audio_reference_files(root):
    """Random stand-ins for the real weight files, in the reference layouts:
    Make-An-Audio-2's mel VAE (ch 384) as a Lightning `maa2.ckpt`
    (`state_dict` of `first_stage_model.*` plus a loss entry) and BigVGAN
    (1536 wide) as `best_netG.pt` (`generator`, every convolution as
    weight_g / weight_v, the resamplers' filter buffers), both stored in
    bf16 for the call's disk writes. Returns the two paths and their bytes."""
    from lumina_t2x_tpu_torch.codecs.vae1d import make_an_audio_2_vae
    from lumina_t2x_tpu_torch.codecs.vocoder import BigVGAN

    torch.manual_seed(18)
    with torch.device("cuda"):
        vae, voc = make_an_audio_2_vae(), BigVGAN()
    sd = {f"first_stage_model.{k}": v.to(torch.bfloat16).cpu() for k, v in vae.state_dict().items()}
    sd["first_stage_model.loss.logvar"] = torch.zeros(())
    vae_path = os.path.join(root, "maa2.ckpt")
    torch.save({"state_dict": sd}, vae_path)
    wn = {}
    for key, w in voc.state_dict().items():
        w = w.to(torch.bfloat16).cpu()
        if key.endswith(".weight") and w.dim() == 3:
            name = key[: -len(".weight")]
            wn[f"{name}.weight_v"] = w
            wn[f"{name}.weight_g"] = w.float().pow(2).sum(dim=(1, 2), keepdim=True).sqrt().to(
                torch.bfloat16)
        else:
            wn[key] = w
    wn["resblocks.0.activations.0.upsample.filter"] = torch.ones(1, 1, 12)
    voc_path = os.path.join(root, "best_netG.pt")
    torch.save({"generator": wn}, voc_path)
    del vae, voc
    torch.cuda.empty_cache()
    return vae_path, voc_path, os.path.getsize(vae_path) + os.path.getsize(voc_path)


def _audio_cli(fa, argv, label, wav_path):
    """`audio_app.main(argv)` into a temporary directory: its WAV (65,536
    frames at 16 kHz), copied to `wav_path`, its K1 launches (exactly
    AUDIO_K1_LAUNCHES, nothing else) and no plain-version call."""
    from lumina_t2x_tpu_torch.pipelines import audio_app

    with tempfile.TemporaryDirectory() as out:
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        path = audio_app.main(argv + ["--output_dir", out, "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, plain = _launched(fa.LAUNCHES), fa.PLAIN_CUDA_CALLS["count"]
        with open(path, "rb") as f:
            data = f.read()
        shutil.copy(path, wav_path)
    frames = _wav_frames(data)
    require(frames == (256 * 256, 16000) and launches == {"small_kv": AUDIO_K1_LAUNCHES}
            and plain == 0, f"{label}: WAV {frames}, launches {launches}, plain {plain}")
    phase("audio", f"{label}: sample.wav {frames[0]} frames at {frames[1]} Hz; wall {wall:.1f} s "
          f"incl. set-up; launches {launches}; plain-version CUDA calls {plain}")
    gc.collect()  # the CLI's stack
    torch.cuda.empty_cache()
    return launches["small_kv"]


def audio_phase(fa, wav_dir):
    """The audio app at full width: `build_audio_stack(debug=False)`
    (FlagDiT-1D 1152 wide, 28 layers, fp32; the random VAE ch 128, (1, 2);
    BigVGAN 1536 wide), zero-init tensors randomised. One CFG forward through
    the kernels, the plain versions and sdpa in fp32 (the app's) and in bf16
    (the trainer's activations: the bf16 K1 row's main path); then the
    served path: `serve_audio.AudioDemoApp` behind `make_server`, a 25-point
    CFG-3 request over 128 latent frames -> 256 mel frames -> 65,536 samples
    (exactly AUDIO_K1_LAUNCHES fp32 K1 calls, no plain-version call), a bad
    request (400); the CUDA-event times of a CFG forward, the VAE decode and
    the vocoder; then `audio_app.main` twice, the second with `--vae_ckpt`
    and `--vocoder_ckpt` on random reference-layout files. The three WAVs go
    to `wav_dir`. Returns the K1 rows' launches."""
    from lumina_t2x_tpu_torch.pipelines import audio_app
    from lumina_t2x_tpu_torch.pipelines.serve import make_server
    from lumina_t2x_tpu_torch.pipelines.serve_audio import AudioDemoApp

    t0 = time.perf_counter()
    denoiser, vae_decode, vocode = audio_app.build_audio_stack(debug=False, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n = _randomise_zero_init(denoiser, 16)
    vae, voc = vae_decode.__self__, vocode.__self__.model
    count = lambda module: sum(p.numel() for p in module.parameters())  # noqa: E731
    phase("audio", f"build_audio_stack(debug=False) in {build_s:.1f} s: FlagDiT-1D "
          f"{count(denoiser) / 1e9:.4f}B params (1152 wide, 28 layers, 16 heads of 72, fp32; {n} "
          f"zero-init tensors randomised), 1-D VAE {count(vae) / 1e6:.2f}M (ch 128, (1, 2)), "
          f"BigVGAN {count(voc) / 1e6:.2f}M (1536 wide, rates (4, 4, 2, 2, 2, 2))")

    b, s, h = AUDIO_SERVE
    g = torch.Generator(device="cuda").manual_seed(17)
    x = torch.randn(1, 20, s, generator=g, device="cuda").repeat(2, 1, 1)
    t = torch.full((2,), 480.0, device="cuda")
    ctx = torch.cat([torch.randn(1, AUDIO_CONTEXT, 1024, generator=g, device="cuda"),
                     torch.zeros(1, AUDIO_CONTEXT, 1024, device="cuda")])
    bf16_k1 = 0
    for dtype in (torch.float32, torch.bfloat16):
        denoiser.dtype = denoiser.t_embedder.dtype = dtype  # activations; parameters stay fp32
        outs = {}
        with torch.no_grad():
            for impl in ("flash", "plain", "xla"):
                denoiser.set_attn_impl(impl)
                fa.reset_launch_counts()
                outs[impl] = denoiser(x, t, ctx)
                if impl == "flash":
                    launched = _launched(fa.LAUNCHES)
        torch.cuda.synchronize()
        fast, ref = outs["flash"], outs["plain"]
        require(fast.shape == (2, 20, s) and bool(torch.isfinite(fast).all())
                and launched == {"small_kv": 2 * AUDIO_LAYERS},
                f"FlagDiT-1D {dtype} forward: shape {tuple(fast.shape)}, launches {launched}")
        rel = ((fast - ref).norm() / ref.norm()).item()
        floor = ((outs["xla"] - ref).norm() / ref.norm()).item()
        phase("audio", f"FlagDiT-1D CFG forward, {str(dtype)[6:]} activations, {s} latent "
              f"frames, {AUDIO_CONTEXT} caption tokens: rel L2 kernels vs plain {rel:.4g} (sdpa "
              f"vs plain {floor:.4g}); launches {launched}")
        require(rel <= max(2e-2, GRAD_FLOOR_FACTOR * floor), f"FlagDiT-1D forward rel L2 {rel}")
        if dtype == torch.bfloat16:
            bf16_k1 = launched["small_kv"]
    denoiser.dtype = denoiser.t_embedder.dtype = torch.float32
    denoiser.set_attn_impl("auto")
    del outs, fast, ref

    worker = audio_app.AudioWorker(denoiser, vae_decode, vocode, task="music", latent_length=s,
                                   device="cuda")
    worker.generate(AUDIO_PROMPTS[0], num_steps=2)  # warm-up (cuDNN picks its algorithms)
    server = make_server(AudioDemoApp(worker, task="music"), port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/api/health", timeout=60) as resp:
            health = json.loads(resp.read())
        require(health == {"ok": True, "task": "music"}, f"audio health {health}")
        body = {"prompt": AUDIO_PROMPTS[0], "num_steps": AUDIO_POINTS, "guidance_scale": 3.0}
        req = urllib.request.Request(url + "/api/generate", data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        fa.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as resp:
            status, payload = resp.status, json.loads(resp.read())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        launches, plain = _launched(fa.LAUNCHES), fa.PLAIN_CUDA_CALLS["count"]
        bad = urllib.request.Request(url + "/api/generate", data=b'{"prompt": "x", "num_steps": 0}',
                                     headers={"Content-Type": "application/json"})
        try:
            urllib.request.urlopen(bad, timeout=60)
            bad_status = 200
        except urllib.error.HTTPError as e:
            bad_status = e.code
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    wav = base64.b64decode(payload["audio_wav_b64"])
    frames = _wav_frames(wav)
    with open(os.path.join(wav_dir, "1.wav"), "wb") as f:
        f.write(wav)
    require(status == 200 and frames == (256 * 256, 16000) and bad_status == 400,
            f"audio server: HTTP {status}, WAV {frames}, bad request HTTP {bad_status}")
    require(launches == {"small_kv": AUDIO_K1_LAUNCHES} and plain == 0,
            f"audio request: launches {launches}, plain {plain}")

    z = torch.randn(1, 20, s, generator=g, device="cuda")
    with torch.no_grad():
        forward_ms = time_ms(lambda: denoiser(x, t, ctx))
        mel = vae_decode(z)
        decode_ms = time_ms(lambda: vae_decode(z))
        vocoder_ms = time_ms(lambda: voc(mel))
    per_forward = (wall - (decode_ms + vocoder_ms) / 1e3) / (AUDIO_POINTS - 1)
    phase("audio", f"POST /api/generate {body}: HTTP 200 in {wall:.3f} s (server-side "
          f"{payload['metadata']['elapsed_s']} s), {AUDIO_POINTS} points (CFG 3, batch 2), {s} "
          f"latent frames -> {tuple(mel.shape)} mel -> WAV {frames[0]} frames at {frames[1]} Hz; "
          f"{per_forward:.4f} s a CFG forward in the request (wall less decode and vocoder, over "
          f"{AUDIO_POINTS - 1}); one CFG forward {forward_ms:.3f} ms, VAE decode {decode_ms:.3f} "
          f"ms, vocoder {vocoder_ms:.3f} ms (CUDA events, median of 7); peak memory {peak:.2f} "
          f"GiB; launches {launches}; plain-version CUDA calls {plain}; bad request HTTP "
          f"{bad_status}")
    del worker, denoiser, vae_decode, vocode, vae, voc, mel
    gc.collect()
    torch.cuda.empty_cache()

    fp32_k1 = launches["small_kv"]
    fp32_k1 += _audio_cli(fa, ["--prompt", AUDIO_PROMPTS[1], "--seed", "1"],
                          "audio_app.main --prompt <music>", os.path.join(wav_dir, "2.wav"))
    with tempfile.TemporaryDirectory() as root:
        vae_path, voc_path, nbytes = _write_audio_reference_files(root)
        phase("audio", f"random Make-An-Audio-2 VAE (ch 384) and BigVGAN (1536) files in the "
              f"reference layouts, bf16: {nbytes / 2**30:.3f} GiB")
        fp32_k1 += _audio_cli(fa, ["--task", "audio", "--struct_caption", "--prompt",
                                   AUDIO_PROMPTS[2], "--seed", "2", "--vae_ckpt", vae_path,
                                   "--vocoder_ckpt", voc_path],
                              "audio_app.main --task audio --struct_caption --vae_ckpt maa2.ckpt "
                              "--vocoder_ckpt best_netG.pt", os.path.join(wav_dir, "3.wav"))
    return {"small_kv_fp32_audio": fp32_k1, "small_kv_audio": bf16_k1}


def _audio_metrics(results_dir):
    with open(os.path.join(results_dir, "music", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def audio_train_phase(fa):
    """`train_audio.main` at the JAX trainer's defaults (FlagDiT-1D 1152 wide,
    28 layers; synthetic://, B=32, 256 latent frames, 77 caption tokens,
    bf16, AdamW): 3 steps with no checkpoint written (a full-depth one, fp32
    parameters, EMA and both moments, is 11 GiB, twice that with the resume,
    past what the call's 45 GiB of disk writes leave); then the same CLI cut
    to one layer: 3 steps and a checkpoint, and a 4th step by --auto_resume
    under LUMINA_FLASH_FUSED_BWD=0 (K7/K8); then the fp32 leg
    (`audio_train_fp32`). Returns the trainer rows' launches."""
    from lumina_t2x_tpu_torch.pipelines import train_audio

    fa.set_flash_static_max_train(None)  # K4 and K6-K8, no train bound
    b, s, _ = AUDIO_TRAIN
    base = ["--data_path", "synthetic://", "--global_batch_size", str(b), "--latent_length",
            str(s), "--context_len", str(AUDIO_TRAIN_CONTEXT), "--precision", "bf16",
            "--log_every", "1", "--ckpt_every", "1000", "--device", "cuda"]
    with tempfile.TemporaryDirectory() as results:
        state, wall, full, plain, peak = _run_trainer(
            fa, base + ["--results_dir", results, "--max_steps", "3"], save=False,
            cli="train_audio")
        full = _launched(full)
        params = sum(p.numel() for p in state.model.parameters())
        m = _audio_metrics(results)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    require(len(m) == 3 and all(math.isfinite(r["train/loss"]) for r in m) and plain == 0
            and full.get("online_lse", 0) > 0 and full.get("bwd_fused", 0) > 0,
            f"audio trainer: metrics {m}, launches {full}, plain {plain}")
    phase("audiotrain", f"train_audio.main FlagDiT-1D ({params / 1e9:.4f}B params) synthetic, "
          f"B={b}, {s} latent frames, {AUDIO_TRAIN_CONTEXT} caption tokens, bf16, AdamW, 3 steps, "
          f"no checkpoint: losses {[round(r['train/loss'], 5) for r in m]}; s/step "
          f"{[round(r['train/secs_per_step'], 4) for r in m]} ({b / _steady(m):.1f} items/s after "
          f"the first); peak memory {peak:.2f} GiB; wall {wall:.1f} s; launches {full}")

    with tempfile.TemporaryDirectory() as results:
        argv = base + ["--depth", "1", "--results_dir", results, "--keep_last", "1"]
        fa.reset_launch_counts()
        state = train_audio.main(argv + ["--max_steps", "3"])
        cut = _launched(fa.LAUNCHES)
        ckpt = os.path.join(results, "music", "checkpoints", "0000003")
        nbytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(ckpt)
                     for f in files)
        del state
        fa.reset_launch_counts()
        os.environ["LUMINA_FLASH_FUSED_BWD"] = "0"
        try:
            state = train_audio.main(argv + ["--max_steps", "4", "--auto_resume"])
        finally:
            os.environ.pop("LUMINA_FLASH_FUSED_BWD")
        resumed, plain = _launched(fa.LAUNCHES), fa.PLAIN_CUDA_CALLS["count"]
        m = _audio_metrics(results)
        ckpts = os.listdir(os.path.join(results, "music", "checkpoints"))
        step = state.step
        del state
    torch.cuda.empty_cache()
    require(step == 4 and ckpts == ["0000004"] and len(m) == 4 and plain == 0
            and all(math.isfinite(r["train/loss"]) for r in m) and resumed.get("bwd_dq", 0) > 0
            and resumed.get("bwd_dkv", 0) > 0 and "bwd_fused" not in resumed,
            f"audio trainer resume: step {step}, checkpoints {ckpts}, launches {resumed}")
    per_layer = nbytes / 2**30
    phase("audiotrain", f"the CLI cut to 1 layer: 3 steps and a checkpoint of {per_layer:.3f} GiB "
          f"(written twice: {2 * per_layer:.3f} GiB of the call's 45 GiB of disk writes; at full "
          f"depth {16 * params / 2**30:.2f} GiB each), then --auto_resume for step 4 with "
          f"LUMINA_FLASH_FUSED_BWD=0: losses {[round(r['train/loss'], 5) for r in m]}; launches "
          f"{cut}, resumed {resumed}")
    return {"online_lse_audio": full["online_lse"] + cut["online_lse"] + resumed["online_lse"],
            "bwd_fused_audio": full["bwd_fused"] + cut["bwd_fused"],
            "bwd_dq_audio": resumed["bwd_dq"], "bwd_dkv_audio": resumed["bwd_dkv"],
            **audio_train_fp32(fa, [a if a != "bf16" else "fp32" for a in base])}


def audio_train_fp32(fa, argv):
    """`train_audio.main` at full width and depth with `--precision fp32`
    (argv: the bf16 leg's with fp32): 3 steps through the fp32 backward's
    fused sweep (`csrc/flash_bwd_fp32_sm90.cu`, K6: 56 launches a step, 28
    layers of self- and cross-attention), then a 4th step under
    LUMINA_FLASH_FUSED_BWD=0 (K7 + K8), no checkpoint written (the call's 45
    GiB of disk writes). Prints losses, s/step, items/s, peak memory and the
    launches; returns the fp32 rows' launches."""
    b = AUDIO_TRAIN[0]
    fused_part = {}
    with tempfile.TemporaryDirectory() as results:
        state, wall, total, plain, peak = _run_trainer(
            fa, argv + ["--results_dir", results, "--max_steps", "4"], save=False, unfused_from=4,
            cli="train_audio", before=fused_part)
        m = _audio_metrics(results)
        params = next(state.model.parameters()).dtype
    del state
    gc.collect()
    torch.cuda.empty_cache()
    fused = _launched(fused_part)
    last = _launched({k: total[k] - fused_part.get(k, 0) for k in total})
    steady = [r["train/secs_per_step"] for r in m[1:3]]
    phase("audiotrain", f"train_audio.main --precision fp32 (parameters {params}), B={b}, "
          f"{AUDIO_TRAIN[1]} latent frames, {AUDIO_TRAIN_CONTEXT} caption tokens, AdamW, 3 steps "
          f"then a 4th with LUMINA_FLASH_FUSED_BWD=0, no checkpoint: losses "
          f"{[round(r['train/loss'], 5) for r in m]}; s/step "
          f"{[round(r['train/secs_per_step'], 4) for r in m]} ({b / statistics.mean(steady):.1f} "
          f"items/s at steps 2-3); peak memory {peak:.2f} GiB; wall {wall:.1f} s; launches "
          f"steps 1-3 {fused}, step 4 {last}; plain-version CUDA calls {plain}")
    require(len(m) == 4 and all(math.isfinite(r["train/loss"]) for r in m) and plain == 0
            and fused.get("bwd_fused", 0) > 0 and last.get("bwd_dq", 0) > 0
            and last.get("bwd_dkv", 0) > 0 and "bwd_fused" not in last,
            f"fp32 audio trainer: metrics {m}, launches {fused} / {last}, plain {plain}")
    return {"bwd_fused_fp32_audio": fused["bwd_fused"], "bwd_dq_fp32_audio": last["bwd_dq"],
            "bwd_dkv_fp32_audio": last["bwd_dkv"]}


def _random_clap_state_dict(g):
    """A CLAP 2022 checkpoint's audio branch at its published widths, random
    from `g`: `audio_encoder.base.*` (Cnn14: conv blocks CNN14_CHANNELS, batch
    norms with running statistics, fc1 2048, the AudioSet head) and
    `audio_encoder.projection.*` (2048 -> CLAP_PROJ)."""
    sd, cin = {}, 1

    def rand(*shape, std=1.0):
        return std * torch.randn(*shape, generator=g)

    def bn(prefix, n):
        sd.update({f"{prefix}.weight": 1 + 0.1 * rand(n), f"{prefix}.bias": 0.1 * rand(n),
                   f"{prefix}.running_mean": 0.1 * rand(n),
                   f"{prefix}.running_var": 1 + 0.1 * rand(n).abs()})

    bn("audio_encoder.base.bn0", 64)
    for i, c in enumerate(CNN14_CHANNELS, start=1):
        blk = f"audio_encoder.base.conv_block{i}"
        sd[f"{blk}.conv1.weight"] = rand(c, cin, 3, 3, std=(2 / (9 * cin)) ** 0.5)
        sd[f"{blk}.conv2.weight"] = rand(c, c, 3, 3, std=(2 / (9 * c)) ** 0.5)
        bn(f"{blk}.bn1", c)
        bn(f"{blk}.bn2", c)
        cin = c
    width = CNN14_CHANNELS[-1]
    sd.update({"audio_encoder.base.fc1.weight": rand(width, width, std=width ** -0.5),
               "audio_encoder.base.fc1.bias": torch.zeros(width),
               "audio_encoder.base.fc_audioset.weight": rand(CLAP_CLASSES, width, std=width ** -0.5),
               "audio_encoder.base.fc_audioset.bias": torch.zeros(CLAP_CLASSES),
               "audio_encoder.projection.linear1.weight": rand(CLAP_PROJ, width, std=width ** -0.5),
               "audio_encoder.projection.linear2.weight": rand(CLAP_PROJ, CLAP_PROJ,
                                                               std=CLAP_PROJ ** -0.5),
               "audio_encoder.projection.layer_norm.weight": torch.ones(CLAP_PROJ),
               "audio_encoder.projection.layer_norm.bias": torch.zeros(CLAP_PROJ),
               "logit_scale": torch.tensor(math.log(1 / 0.07))})
    return sd


def audio_judge_phase(fa, wav_dir):
    """The CLAP judge on the card over the WAVs of the audio phase: Cnn14 at
    its published widths (44.1 kHz, 1024 / 320 / 64 mels; random, through
    `import_clap_audio_weights`) and a BERT-base-wide caption tower (random
    transformers `BertModel`, 1024-wide projection, through
    `CLAPTextEncoder.from_clap_state_dict`) with the hash tokenizer (no BERT
    vocabulary here); `clap_eval_directory` resamples the 16 kHz clips to
    44.1 kHz and tiles them to 5 s. Then MPD and MRD (BigVGAN-base widths)
    forward and backward on the clips with the three GAN losses."""
    from transformers import BertConfig, BertModel

    from lumina_t2x_tpu_torch.codecs import vocoder_discriminators as vd
    from lumina_t2x_tpu_torch.codecs.clap_audio import CLAPAudioEncoder, import_clap_audio_weights
    from lumina_t2x_tpu_torch.codecs.text_encoders import BertHashTokenizer, CLAPTextEncoder
    from lumina_t2x_tpu_torch.eval.audio_eval import clap_eval_directory, read_wav

    g = torch.Generator().manual_seed(19)
    torch.manual_seed(19)
    bert = BertModel(BertConfig())  # bert-base-uncased's widths
    sd = _random_clap_state_dict(g)
    sd.update({f"caption_encoder.base.{k}": v for k, v in bert.state_dict().items()})
    width = bert.config.hidden_size
    sd.update({"caption_encoder.projection.linear1.weight": width ** -0.5 * torch.randn(
        CLAP_PROJ, width, generator=g),
        "caption_encoder.projection.linear2.weight": CLAP_PROJ ** -0.5 * torch.randn(
            CLAP_PROJ, CLAP_PROJ, generator=g),
        "caption_encoder.projection.layer_norm.weight": torch.ones(CLAP_PROJ),
        "caption_encoder.projection.layer_norm.bias": torch.zeros(CLAP_PROJ)})
    text_enc = CLAPTextEncoder.from_clap_state_dict(sd, BertModel(BertConfig()).cuda(),
                                                    BertHashTokenizer())
    audio_enc = CLAPAudioEncoder(import_clap_audio_weights(sd), device="cuda")
    n_text = sum(p.numel() for p in text_enc.model.parameters())

    def numel(tree):
        return (sum(numel(v) for v in tree.values()) if isinstance(tree, dict)
                else tree.numel())
    n_audio = numel(audio_enc.params["cnn14"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = clap_eval_directory(text_enc, audio_enc, wav_dir, list(AUDIO_PROMPTS))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    scores = list(report["per_file"].values())
    require(report["n"] == 3 and all(math.isfinite(x) and -1.0 <= x <= 1.0 for x in scores),
            f"CLAP report {report}")
    phase("judge", f"clap_eval_directory over {sorted(report['per_file'])} (16 kHz -> 44.1 kHz, "
          f"tiled to 5 s): Cnn14 {n_audio / 1e6:.1f}M params, BERT-base caption tower "
          f"{n_text / 1e6:.1f}M, both random; scores {[round(x, 4) for x in scores]}, mean "
          f"{report['mean_clap_score']:.4f}; {secs:.3f} s")
    del text_enc, audio_enc, bert

    waves = [torch.from_numpy(read_wav(os.path.join(wav_dir, f"{i}.wav"))[0]) for i in (1, 2, 3)]
    y = torch.stack(waves[:2]).cuda()
    y_hat = torch.stack(waves[1:]).cuda().requires_grad_()
    torch.cuda.reset_peak_memory_stats()
    for name, disc in (("MPD", vd.MultiPeriodDiscriminator()),
                       ("MRD", vd.MultiResolutionDiscriminator())):
        disc = disc.cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sr, sg, _, _ = disc(y, y_hat.detach())
        d_loss, _, _ = vd.discriminator_loss(sr, sg)
        d_loss.backward()
        torch.cuda.synchronize()
        d_secs = time.perf_counter() - t0
        d_grads = [p.grad for p in disc.parameters()]
        require(all(gr is not None and bool(torch.isfinite(gr).all()) for gr in d_grads),
                f"{name}: discriminator gradients")
        disc.zero_grad(set_to_none=True)
        t0 = time.perf_counter()
        _, sg, fr, fg = disc(y, y_hat)
        g_loss, _ = vd.generator_loss(sg)
        f_loss = vd.feature_loss(fr, fg)
        (g_loss + f_loss).backward()
        torch.cuda.synchronize()
        g_secs = time.perf_counter() - t0
        require(all(math.isfinite(float(v.detach())) for v in (d_loss, g_loss, f_loss))
                and bool(torch.isfinite(y_hat.grad).all()) and y_hat.grad.abs().sum() > 0,
                f"{name}: losses {d_loss}, {g_loss}, {f_loss}")
        phase("judge", f"{name} ({sum(p.numel() for p in disc.parameters()) / 1e6:.2f}M params) "
              f"on 2 x {y.shape[-1]} samples: discriminator loss {float(d_loss.detach()):.4f} "
              f"(forward + backward {1e3 * d_secs:.1f} ms, first call), generator loss "
              f"{float(g_loss.detach()):.4f}, feature loss {float(f_loss.detach()):.4f} "
              f"(forward + backward to the waveform {1e3 * g_secs:.1f} ms)")
        y_hat.grad = None
        del disc
    phase("judge", f"discriminators' peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB; plain-version CUDA calls {fa.PLAIN_CUDA_CALLS['count']}")
    torch.cuda.empty_cache()

def imgsizes_kernel_phase(fa):
    """K2, K3 and K4 at the img_sizes bucket's self-attention (2, 5120, 32,
    72) with each row's pad keys masked (4096 and 3840 valid), timed with
    bounds over the valid keys and sdpa on the same mask (`shape_rows`)."""
    g = torch.Generator(device="cuda").manual_seed(20)
    return shape_rows(fa, g, D, [(f"{entry}_imgsizes_2b", entry, IMGSIZES_SHAPE, None,
                                  IMGSIZES_VALID, True)
                                 for entry in ("online", "static_max", "online_lse")])


def _rel(got, ref):
    return ((got.float() - ref.float()).norm() / ref.float().norm()).item()


def imgsizes_phase(fa):
    """The 2B (full width, qk-norm, bf16, zero-init tensors randomised) on the
    `img_sizes` list path: a 1024 x 1280 bucket holding a 1024^2 item and a
    768 x 1280 one, 256 caption tokens. One forward with the LSE recorder
    (K2, and K4 in the probe), a bound from it (max LSE + the sampler's 6),
    one forward under it (K3); each item's region against the item alone on
    the uniform grid and the batch against `attn_impl="plain"` within 2e-2
    relative L2, zeros outside each item. Returns the rows' launches."""
    from lumina_t2x_tpu_torch.models import get_model

    os.environ.pop("LUMINA_FUSE_ROPE", None)
    torch.manual_seed(0)
    model = get_model("NextDiT_2B_patch2", qk_norm=True, cap_feat_dim=2048,
                      dtype=torch.bfloat16, device="cuda").eval()
    _randomise_zero_init(model, 1)
    g = torch.Generator(device="cuda").manual_seed(20)
    sizes = list(IMGSIZES_ITEMS)
    x = torch.randn(2, 4, *IMGSIZES_BUCKET, generator=g, device="cuda")
    for i, (hi, wi) in enumerate(sizes):
        x[i, :, hi:] = 0
        x[i, :, :, wi:] = 0
    t = torch.tensor([0.3, 0.7], device="cuda")
    cap = torch.randn(2, CAP, 2048, generator=g, device="cuda")
    cap_mask = torch.ones(2, CAP, dtype=torch.int32, device="cuda")
    fa.reset_launch_counts()
    plain_before = fa.PLAIN_CUDA_CALLS["count"]
    with torch.no_grad():
        recorder = []
        t0 = time.perf_counter()
        probe = model(x, t, cap, cap_mask, img_sizes=sizes, lse_recorder=recorder)
        torch.cuda.synchronize()
        probe_s = time.perf_counter() - t0
        bound = max(float(r[0]) for r in recorder) + 6.0
        with fa.flash_static_max_scope(bound):
            t0 = time.perf_counter()
            static = model(x, t, cap, cap_mask, img_sizes=sizes)
            torch.cuda.synchronize()
            static_s = time.perf_counter() - t0
        launches = _launched(fa.LAUNCHES)
        plain_calls = fa.PLAIN_CUDA_CALLS["count"] - plain_before
        model.set_attn_impl("plain")
        ref = model(x, t, cap, cap_mask, img_sizes=sizes)
        model.set_attn_impl("auto")
        alone = [model(x[i:i + 1, :, :hi, :wi], t[i:i + 1], cap[i:i + 1], cap_mask[i:i + 1])
                 for i, (hi, wi) in enumerate(sizes)]
    torch.cuda.synchronize()
    require(bool(torch.isfinite(probe).all()) and bool(torch.isfinite(static).all()),
            "img_sizes: non-finite output")
    rel_probe, rel_static = _rel(probe, ref), _rel(static, ref)
    items = []
    for i, (hi, wi) in enumerate(sizes):
        outside = torch.ones(IMGSIZES_BUCKET, dtype=torch.bool, device="cuda")
        outside[:hi, :wi] = False
        require(torch.count_nonzero(probe[i][:, outside]).item() == 0
                and torch.count_nonzero(static[i][:, outside]).item() == 0,
                f"img_sizes item {i}: output outside its {hi}x{wi} region is not 0")
        items.append(_rel(probe[i:i + 1, :, :hi, :wi], alone[i]))
    require(rel_probe <= 2e-2 and rel_static <= 2e-2 and max(items) <= 2e-2,
            f"img_sizes: rel L2 vs plain {rel_probe} (static {rel_static}), items vs alone "
            f"{items}: bar 2e-2")
    require(plain_calls == 0 and launches.get("online", 0) > 0
            and launches.get("static_max", 0) > 0 and launches.get("online_lse", 0) > 0,
            f"img_sizes: launches {launches}, plain-version CUDA calls {plain_calls}")
    phase("imgsizes", f"NextDiT_2B_patch2 bf16, img_sizes {sizes} in a {IMGSIZES_BUCKET} latent "
          f"bucket ({IMGSIZES_VALID} of {IMGSIZES_SHAPE[1]} tokens valid), {CAP} caption tokens: "
          f"probe forward {probe_s:.3f} s (K2 + K4), calibrated bound {bound:.3f}, forward "
          f"under it {static_s:.3f} s (K3); rel L2 vs attn_impl plain {rel_probe:.4g} / "
          f"{rel_static:.4g}, items vs alone on the uniform grid "
          f"{[round(r, 5) for r in items]}, zeros outside each item; launches {launches}, "
          f"plain-version CUDA calls {plain_calls}")
    del model, probe, static, ref, alone
    gc.collect()
    torch.cuda.empty_cache()
    return {"online_imgsizes_2b": launches["online"],
            "static_max_imgsizes_2b": launches["static_max"],
            "online_lse_imgsizes_2b": launches["online_lse"]}


def likelihood_phase(fa):
    """`Sampler.sample_ode_likelihood` on NextDiT_ImageNet_600M_patch2 at
    256^2 (32 x 32 latents), 4 labels, fp32, `attn_impl="xla"` (forward-mode
    derivatives through the plain sdpa): the freshly initialised model's
    zero velocity (zero-init final layer) gives `prior_logp(x)` within 1e-4
    relative; with the zero-init tensors randomised, euler over 8 points and
    dopri5 give finite logp (NFE and seconds printed); on the flash path the
    sampler raises the error that names attn_impl="xla"."""
    from lumina_t2x_tpu_torch.models import get_model
    from lumina_t2x_tpu_torch.transport import Sampler, create_transport

    torch.manual_seed(0)
    model = get_model("NextDiT_ImageNet_600M_patch2", qk_norm=True, attn_impl="xla",
                      device="cuda").eval()
    transport = create_transport()
    sampler = Sampler(transport)
    g = torch.Generator(device="cuda").manual_seed(21)
    x = torch.randn(4, 4, 32, 32, generator=g, device="cuda")
    y = torch.tensor([int(label) for label in LABELS.split(",")], device="cuda")

    def model_fn(xx, tt):
        return model(xx, tt, y)

    euler = sampler.sample_ode_likelihood(sampling_method="euler", num_steps=8)
    logp0, _ = euler(x, model_fn, generator=torch.Generator(device="cuda").manual_seed(22))
    prior = transport.prior_logp(x)
    rel0 = ((logp0 - prior).abs() / prior.abs()).max().item()
    require(rel0 <= 1e-4, f"likelihood: zero field logp {logp0.tolist()} vs prior "
            f"{prior.tolist()}: rel {rel0} > 1e-4")
    n = _randomise_zero_init(model, 1)
    dims = x[0].numel()
    parts = []
    for method in ("euler", "dopri5"):
        fn = sampler.sample_ode_likelihood(sampling_method=method,
                                           num_steps=8 if method == "euler" else 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logp, z = fn(x, model_fn, generator=torch.Generator(device="cuda").manual_seed(22))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        require(logp.shape == (4,) and bool(torch.isfinite(logp).all())
                and bool(torch.isfinite(z).all()), f"likelihood {method}: logp {logp.tolist()}")
        parts.append(f"{method}: logp {[round(v, 2) for v in logp.tolist()]} "
                     f"({-logp.mean().item() / dims / math.log(2):.4f} bits/dim), NFE {fn.nfe}, "
                     f"{secs:.2f} s")
    for layer in model.layers:
        layer.attention.attn_impl = "flash"
    try:
        euler(x, model_fn, eps=torch.ones_like(x))
    except RuntimeError as e:
        require('attn_impl="xla"' in str(e), f"likelihood on the flash path: {e}")
        refused = str(e)
    else:
        raise SystemExit("FAILED: the likelihood ran on the flash path")
    phase("likelihood", f"NextDiT_ImageNet_600M_patch2 fp32 256^2, labels {LABELS}, "
          f"attn_impl xla: zero field logp within {rel0:.2g} of prior_logp; {n} zero-init "
          f"tensors randomised: " + "; ".join(parts) + f"; flash path refused: {refused[:80]}...")
    del model
    gc.collect()
    torch.cuda.empty_cache()


def asyncsave_phase(fa):
    """`train_audio.main` cut to one layer (B=32, 256 frames, 77 caption
    tokens, bf16, AdamW), 4 steps with `--async_save` and a save at steps 2
    and 4. At each save the same state is first written by the synchronous
    `save_checkpoint` into a second directory (timed), then handed to the
    saver (its blocking seconds timed): the two checkpoints must be equal
    tensor for tensor. Then each resumes for step 5 (`--auto_resume`, its
    save turned off: the call's 45 GiB of disk writes): the same step-5
    loss. The checkpoints written: 4 x 0.47 GiB. Returns the audio rows'
    launches of the async run."""
    from lumina_t2x_tpu_torch.core import checkpoint as ckpt
    from lumina_t2x_tpu_torch.pipelines import train_audio

    fa.set_flash_static_max_train(None)
    b, s, _ = AUDIO_TRAIN
    base = ["--data_path", "synthetic://", "--global_batch_size", str(b), "--latent_length",
            str(s), "--context_len", str(AUDIO_TRAIN_CONTEXT), "--precision", "bf16",
            "--depth", "1", "--log_every", "1", "--ckpt_every", "2", "--device", "cuda"]
    blocked = {"async": [], "sync": []}
    real = train_audio.AsyncCheckpointSaver
    with tempfile.TemporaryDirectory() as root:
        async_dir, sync_dir = os.path.join(root, "async"), os.path.join(root, "sync")

        class TimedSaver(real):
            def save(self, results_dir, step, state, model_args=None):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ckpt.save_checkpoint(os.path.join(sync_dir, "music"), step, state,
                                     model_args=model_args)
                blocked["sync"].append(time.perf_counter() - t0)
                t0 = time.perf_counter()
                path = super().save(results_dir, step, state, model_args)
                blocked["async"].append(time.perf_counter() - t0)
                return path

        train_audio.AsyncCheckpointSaver = TimedSaver
        fa.reset_launch_counts()
        try:
            state = train_audio.main(base + ["--results_dir", async_dir, "--max_steps", "4",
                                             "--async_save"])
        finally:
            train_audio.AsyncCheckpointSaver = real
        launches = _launched(fa.LAUNCHES)
        del state
        compared = 0
        for step in (2, 4):
            a = ckpt.checkpoint_dir(os.path.join(async_dir, "music"), step)
            c = ckpt.checkpoint_dir(os.path.join(sync_dir, "music"), step)
            require(os.path.exists(os.path.join(a, "resume_step.txt")),
                    f"asyncsave: step {step} has no completion marker")
            for stream in ("model", "ema", "optimizer"):
                got, ref = _flat_tree(ckpt.load_stream(a, stream)), _flat_tree(
                    ckpt.load_stream(c, stream))
                require(sorted(got) == sorted(ref), f"asyncsave step {step} {stream}: keys")
                for key, value in ref.items():
                    same = (torch.equal(got[key], value) and got[key].dtype == value.dtype
                            if isinstance(value, torch.Tensor) else got[key] == value)
                    require(same, f"asyncsave step {step} {stream}/{key}: not equal")
                    compared += 1
        nbytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, files in
                     os.walk(ckpt.checkpoint_dir(os.path.join(sync_dir, "music"), 4))
                     for f in files)
        losses = {}
        for name in ("async", "sync"):
            state, *_ = _run_trainer(fa, base + ["--results_dir", os.path.join(root, name),
                                                 "--max_steps", "5", "--auto_resume"],
                                     save=False, cli="train_audio")
            require(state.step == 5, f"asyncsave: {name} resumed to step {state.step}")
            del state
            losses[name] = _audio_metrics(os.path.join(root, name))[-1]["train/loss"]
    torch.cuda.empty_cache()
    require(abs(losses["async"] - losses["sync"]) <= 1e-6 * abs(losses["sync"]),
            f"asyncsave: step-5 loss {losses['async']} (async) vs {losses['sync']} (sync)")
    phase("asyncsave", f"train_audio.main --depth 1 --async_save, B={b}: checkpoints at steps "
          f"2 and 4 ({nbytes / 2**30:.3f} GiB each) equal to save_checkpoint's of the same "
          f"state, {compared} entries; save() blocked {[round(v, 4) for v in blocked['async']]} "
          f"s against the synchronous save's {[round(v, 4) for v in blocked['sync']]} s; "
          f"resumed step-5 loss {losses['async']!r} (async) vs {losses['sync']!r} (sync"
          f"{', bit for bit' if losses['async'] == losses['sync'] else ''}); launches {launches}")
    return {"online_lse_audio": launches.get("online_lse", 0),
            "bwd_fused_audio": launches.get("bwd_fused", 0)}


def _flat_tree(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_tree(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def profile_phase(fa):
    """The trainer's `--profile_steps 2` on NextDiT_ImageNet_600M_patch2
    (synthetic 32 x 32 latents, B=64, qk-norm, bf16, 4 steps, no
    checkpoint): one trace under <results>/<model>/trace, of steps 2 and 3,
    whose CUDA timeline holds the hand-written kernels (the Hopper forward's
    `flash_fwd_sm90_kernel` and backward's `flash_bwd_sm90_kernel`); their
    share of the traced device time printed."""
    model = "NextDiT_ImageNet_600M_patch2"
    with tempfile.TemporaryDirectory() as results:
        argv = ["--model", model, "--data_path", "synthetic://32x32", "--global_batch_size",
                "64", "--max_steps", "4", "--log_every", "1", "--ckpt_every", "1000",
                "--qk_norm", "--precision", "bf16", "--profile_steps", "2", "--results_dir",
                results, "--device", "cuda"]
        state, wall, launches, plain, peak = _run_trainer(fa, argv, save=False)
        del state
        trace_dir = os.path.join(results, model, "trace")
        files = sorted(os.listdir(trace_dir)) if os.path.isdir(trace_dir) else []
        require(len(files) == 1 and files[0].endswith("_rank0.pt.trace.json"),
                f"profile: trace files {files}")
        size = os.path.getsize(os.path.join(trace_dir, files[0]))
        with open(os.path.join(trace_dir, files[0])) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    total = sum(e.get("dur", 0) for e in kernels)
    by_ours = {}
    for e in kernels:
        for symbol in ("flash_fwd_sm90_kernel", "flash_bwd_sm90_kernel"):
            if symbol in e.get("name", ""):
                n, dur = by_ours.get(symbol, (0, 0.0))
                by_ours[symbol] = (n + 1, dur + e.get("dur", 0))
    torch.cuda.empty_cache()
    require(set(by_ours) == {"flash_fwd_sm90_kernel", "flash_bwd_sm90_kernel"} and plain == 0,
            f"profile: hand-written kernels on the CUDA timeline {by_ours}, plain {plain}")
    phase("profile", f"train.main {model} --profile_steps 2, B=64, 4 steps in {wall:.1f} s: "
          f"{files[0]} ({size / 2**20:.1f} MiB, {len(events)} events, {len(kernels)} CUDA "
          f"kernels, {total / 1e3:.1f} ms of kernel time); on its CUDA timeline "
          + ", ".join(f"{k}: {n} launches, {d / 1e3:.2f} ms ({100 * d / max(total, 1):.1f}%)"
                      for k, (n, d) in sorted(by_ours.items()))
          + f"; launches {_launched(launches)}; peak {peak:.2f} GiB")


def longcontext_phase(fa):
    """`exps/longcontext_forward.py`'s forward: the 2B (bf16, zero-init
    tensors randomised) at 131072 image tokens (grid 512 x 256, latent 1024 x
    512) and 256 caption tokens, B=1, under LUMINA_FUSE_ROPE=1, one warm
    forward and one timed (`forward_stats`: ms, tokens/s, peak memory). Layer
    0's self-attention call (K9 `flash_rope` over 131072 keys) and
    cross-attention call (`flash_rope_q` over the caption) are kept: K9's
    output on LONG_SAMPLE_ROWS query rows (the first, the last and random
    ones) within 1e-2 of max(1, max|ref|) of the plain version on those rows
    over every key; then each timed beside its plain version (over all rows,
    in chunks), `flash_online` and sdpa on pre-rotated inputs, with its bound,
    and `rope_rotate` on layer 0's k against `apply_rope` bit for bit.
    Returns (rows, launches)."""
    from lumina_t2x_tpu_torch.exps import longcontext_forward as lc
    from lumina_t2x_tpu_torch.models import layers
    from lumina_t2x_tpu_torch.ops.rope import apply_rope

    model = lc.build_model("NextDiT_2B_patch2", device="cuda", seed=0)
    n = _randomise_zero_init(model, 1)
    kept = {}
    real = layers.flash_attention_rope

    def keep_first(q, k, v, angles, kv_mask=None, scale=None, rotate_k=True):
        out = real(q, k, v, angles, kv_mask=kv_mask, scale=scale, rotate_k=rotate_k)
        kept.setdefault("rope" if rotate_k else "rope_q", (q, k, v, angles, kv_mask, scale, out))
        return out

    layers.flash_attention_rope = keep_first
    os.environ["LUMINA_FUSE_ROPE"] = "1"
    fa.reset_launch_counts()
    plain_before = fa.PLAIN_CUDA_CALLS["count"]
    try:
        stats = lc.forward_stats(model, tokens=LONG_TOKENS, cap_len=CAP, steps=1)
    finally:
        layers.flash_attention_rope = real
        os.environ.pop("LUMINA_FUSE_ROPE")
    launches = _launched(fa.LAUNCHES)
    plain_calls = fa.PLAIN_CUDA_CALLS["count"] - plain_before
    forwards, depth = 2, model.n_layers
    require(stats["finite"] and plain_calls == 0
            and all(launches.get(k, 0) == forwards * depth for k in ROPE_KERNELS)
            and set(launches) == set(ROPE_KERNELS),
            f"longcontext: finite {stats['finite']}, launches {launches}, plain {plain_calls}")
    phase("longcontext", f"NextDiT_2B_patch2 ({stats['params_m'] / 1e3:.3f}B params, {n} zero-init "
          f"tensors randomised) bf16 forward at {LONG_TOKENS} image tokens (grid "
          f"{stats['grid']}, latent {stats['latent']}) + {CAP} caption tokens, "
          f"LUMINA_FUSE_ROPE=1: {stats['ms_per_forward']:.1f} ms a forward, "
          f"{stats['tokens_per_sec']:.0f} tokens/s, peak {stats['peak_gib']:.2f} GiB, finite; "
          f"launches {launches}; {json.dumps(stats)}")
    del model
    gc.collect()
    results = {}
    g = torch.Generator(device="cuda").manual_seed(22)
    for entry in ("rope", "rope_q"):
        q, k, v, angles, mask, scale, got = kept.pop(entry)
        scale = scale if scale is not None else D ** -0.5
        sq = q.shape[1]
        k_rot = apply_rope(k, angles) if entry == "rope" else k
        rows = torch.cat([torch.tensor([0, sq - 1], device="cuda"),
                          1 + torch.randperm(sq - 2, generator=g, device="cuda")
                          [:LONG_SAMPLE_ROWS - 2]]).sort().values
        ref = fa.flash_online_plain(apply_rope(q[:, rows], angles[rows]).float(),
                                    k_rot.float(), v.float(), mask, scale)
        err = (got[:, rows].float() - ref).abs().max().item()
        top = max(1.0, ref.abs().max().item())
        require(math.isfinite(err) and err <= BF16_MAX * top,
                f"longcontext {entry}: sampled rows' max abs err {err} > {BF16_MAX * top}")
        del ref
        kernel = getattr(fa, f"flash_{entry}")
        ms = time_ms(lambda: kernel(q, k, v, angles, mask, scale), reps=3)

        def plain_all():
            out = torch.empty_like(q)
            for r0 in range(0, sq, LONG_PLAIN_CHUNK):
                rr = slice(r0, r0 + LONG_PLAIN_CHUNK)
                out[:, rr] = fa.flash_online_plain(apply_rope(q[:, rr], angles[rr]), k_rot, v,
                                                   mask, scale)
            return out

        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        plain_out = plain_all()
        e1.record()
        torch.cuda.synchronize()
        plain_ms = e0.elapsed_time(e1)
        full_err = (got.float() - plain_out.float()).abs().max().item()
        require(math.isfinite(full_err) and full_err <= BF16_MAX * max(
            1.0, plain_out.float().abs().max().item()),
                f"longcontext {entry}: max abs err over every row {full_err}")
        del plain_out
        torch.cuda.empty_cache()
        q_rot = apply_rope(q, angles)
        unfused = "online" if entry == "rope" else "small_kv"
        unfused_ms = time_ms(lambda: getattr(fa, f"flash_{unfused}")(q_rot, k_rot, v, mask,
                                                                     scale), reps=3)
        sdpa_ms = time_ms(lambda: _sdpa(q_rot, k_rot, v, mask, scale), reps=3)
        del q_rot
        rotated = q.numel() + (k.numel() if entry == "rope" else 0)
        bound = least_time(_nbytes(q, k, v, mask, got) + 2 * sq * D * 4,
                           attention_ops(q, k, 2), torch.bfloat16, fp32_ops=3 * rotated)
        results[f"{entry}_128k"] = {"max_abs_err": max(err, full_err), "ms": ms,
                                    "plain_ms": plain_ms, "unfused_ms": unfused_ms,
                                    "sdpa_ms": sdpa_ms, **bound, "library_ms": None,
                                    "library_kernel": "none"}
        phase("longcontext", f"{entry} bf16 (1, {sq}, {H}, {D}) over {k.shape[1]} keys (layer "
              f"0's call): max abs err {err:.3g} on {LONG_SAMPLE_ROWS} sampled rows, "
              f"{full_err:.3g} over every row (bar {BF16_MAX * top:.3g}); kernel {ms:.3f} ms, "
              f"plain (chunks of {LONG_PLAIN_CHUNK} rows) {plain_ms:.1f} ms, flash_{unfused} "
              f"on rotated inputs {unfused_ms:.3f} ms, sdpa on rotated inputs {sdpa_ms:.3f} ms, "
              f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}), library none")
        if entry == "rope":  # rope_rotate on layer 0's k
            rotated_k = fa.rope_rotate(k, angles)
            require(torch.equal(rotated_k, k_rot), "longcontext rope_rotate: not apply_rope "
                    "bit for bit")
            rot_ms = time_ms(lambda: fa.rope_rotate(k, angles), reps=5)
            rot_plain = time_ms(lambda: apply_rope(k, angles), reps=3)
            rot_bound = least_time(2 * _nbytes(k) + 2 * sq * D * 4, 0, torch.bfloat16,
                                   fp32_ops=3 * k.numel())
            results["rope_rotate_128k"] = {"max_abs_err": 0.0, "ms": rot_ms,
                                           "plain_ms": rot_plain, **rot_bound,
                                           "library_ms": None, "library_kernel": "none"}
            phase("longcontext", f"rope_rotate bf16 (1, {sq}, {H}, {D}): equal to apply_rope; "
                  f"kernel {rot_ms:.3f} ms, plain {rot_plain:.3f} ms, bound "
                  f"{rot_bound['bound_ms']:.4f} ms ({rot_bound['bound_by']}), library none")
            del rotated_k
        del q, k, v, angles, mask, got, k_rot
        torch.cuda.empty_cache()
    return results, {f"{name}_128k": launches[name] for name in ROPE_KERNELS}


def main():
    device_phase()
    sys.path.insert(0, ROOT)
    from lumina_t2x_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_phase()
    results = kernel_phase(fa)
    caption_kernel_phase(fa, results)
    results.update(backward_kernel_phase(fa))
    results.update(rope_kernel_phase(fa))
    results.update(imagenet_kernel_phase(fa))
    results.update(d48_kernel_phase(fa))
    results.update(wide_head_kernel_phase(fa))
    results.update(anagram_sd3_kernel_phase(fa))
    results.update(audio_kernel_phase(fa))
    results.update(imgsizes_kernel_phase(fa))
    results.update(fp32_forward_phase(fa))
    exp_results, exp_launches = experiments_phase()
    results.update(exp_results)
    latent_1024 = slice_phase(fa, *forward_phase(fa))
    with tempfile.TemporaryDirectory() as vae_dir:
        vae_path, sd3_vae_path = vae_phase(latent_1024, vae_dir)
        imagenet_launches = classcond_phase(fa, vae_path)
        imagenet_launches.update(classtrain_phase(fa, vae_path))
        t2i_vae_phase(fa, vae_path)
        gemma_path = textenc_phase(fa)
        t2i_encoder_phase(fa, vae_path, gemma_path)
        t2idata_phase(fa, vae_path, gemma_path)
        shutil.rmtree(gemma_path)
        flag_launches = flag_dit_phase(fa, vae_path)
        composed = compositional_phase(fa, vae_path)
        edited = img2img_phase(fa, vae_path)
        anagram, kv1024 = anagram_phase(fa, vae_path)
        sd3_k2 = sd3_phase(fa, sd3_vae_path)
        dreambooth_rows = dreambooth_phase(fa, vae_path, sd3_vae_path)
    cli_phase(fa)
    launches = serving_phase(fa)
    # the 2B's other main paths at the rows' self-attention shape: the
    # compositional app (K2; its region cross-attention is plain), img2img
    # (K2/K3; its K1 runs against 32 stand-in caption keys, not the row's
    # Sk=256, and its K4 calibration is outside the trainer's K4 row) and the
    # anagram app (K2 in its phase-2 calibration probe, K3 on phase 2)
    for name in ("online", "static_max"):
        launches[name] += composed[name] + edited[name] + anagram[name]
    launches.update(imagenet_launches)
    gradient_phase(fa)
    recipe_phase(fa)
    # K4: the training path's count; the multigpu phase's torchrun children
    # (their own processes) and ring fold add theirs
    train_launches, multigpu = trainer_phase(fa, then=lambda *a: multigpu_trainer_phase(fa, *a))
    launches.update(train_launches)
    launches.update(fp16_train_phase(fa))
    for counts in (multigpu, ring_fold_phase(fa)):
        for name, n in counts.items():
            launches[name] += n
    small = pixel_phase(fa)
    quality = quality_phase(fa)
    flag_train, flag_600m = flag_dit_train_phase(fa)
    moe = moe_phase(fa)
    with tempfile.TemporaryDirectory() as wav_dir:
        audio = audio_phase(fa, wav_dir)
        audio.update(audio_train_phase(fa))
        audio_judge_phase(fa, wav_dir)
    # head_dim 96: the 5B sampler's and trainer's; the 600M shapes: the
    # Flag-DiT ImageNet and MoE trainers and the MoE samplers join classcond's and classtrain's
    flag_launches["online_lse_d96_5b"] += flag_train.pop("online_lse_d96_5b")
    launches.update(flag_launches)
    launches.update(flag_train)
    for name in ("online_lse", "bwd_fused"):
        launches[f"{name}_d48_600m"] += flag_600m[name] + moe[name]
    launches["small_kv_imagenet_600m"] += moe["small_kv"]
    launches.update({"online_lse_d48_small": small["online_lse"] + quality["online_lse"],
                     "bwd_fused_d48_small": small["bwd_fused"] + quality["bwd_fused"],
                     "small_kv_d48_small": quality["small_kv"]})
    launches.update(exp_launches)
    launches.update({"small_kv_kv1024": kv1024, "online_d64_sd3": sd3_k2, **dreambooth_rows})
    launches.update(audio)
    # the last slice: the img_sizes list path, the 128K-token forward, the
    # likelihood sampler, the async checkpoint writer and the trace capture
    launches.update(imgsizes_phase(fa))
    long_rows, long_launches = longcontext_phase(fa)
    results.update(long_rows)
    launches.update(long_launches)
    likelihood_phase(fa)
    for name, count in asyncsave_phase(fa).items():
        launches[name] += count
    profile_phase(fa)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[name], **{key: results[name][key] for key in keys}}
        for name, (source, replaces) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--multigpu-child":
        _multigpu_child(sys.argv[2:])
    else:
        main()

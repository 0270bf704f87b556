"""Audio / music trainer: CFM over FlagDiT-1D (counterpart of
`lumina_t2x_tpu/pipelines/train_audio.py`): the OT-CFM loss
(`transport/cfm.py`) on mel latents with AdamW, a global-norm clip and an
EMA, checkpoints in the trainer layout (`core/checkpoint.py`: `--keep_last`,
`--auto_resume`).

Data: `synthetic://` (random latents and caption features from
`--global_seed`, the JAX trainer's stream), or a directory of precomputed
`latents/<id>.npy` (C, T) and `captions/<id>.npy` (L, D) pairs. A resumed
run continues the data stream where the checkpoint left it, and each step's
draws come from (seed, step) (`train_lib.step_generator`), so
`--auto_resume` continues as an uninterrupted run would.

    python -m lumina_t2x_tpu_torch.pipelines.train_audio --hidden_size 64 --depth 2 \\
        --num_heads 4 --context_dim 32 --context_len 8 --latent_length 32 \\
        --global_batch_size 2 --max_steps 2 --log_every 1 --precision fp32 --device cpu

Several processes, as the image trainer (`pipelines/train.py`): under
torchrun or with `--model_parallel_size > 1` the model is sharded over the
(data, model) mesh (tensor parallelism, then FSDP2 over data, as the JAX
trainer always places its state with `fsdp=True`), each rank keeps its rows
of the global batch and of the step's draws, and rank 0 logs and writes the
checkpoints (gathered whole).
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..core.checkpoint import broadcast_state, find_auto_resume, load_checkpoint, save_checkpoint
from ..core.logging import MetricsWriter, Throughput, create_logger
from ..models.flag_dit_1d import FlagDiT1D
from ..parallel import mesh as pmesh
from ..parallel.sharding import parallelize
from ..transport.cfm import CFM
from .train_lib import TrainState, create_optimizer, create_train_state, make_step, place_state


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="lumina audio/music trainer")
    p.add_argument("--task", choices=["music", "audio"], default="music")
    p.add_argument("--data_path", type=str, default="synthetic://")
    p.add_argument("--results_dir", type=str, default="results/audio")
    p.add_argument("--latent_channels", type=int, default=20)
    p.add_argument("--latent_length", type=int, default=256)
    p.add_argument("--context_dim", type=int, default=1024)
    p.add_argument("--context_len", type=int, default=77)
    p.add_argument("--hidden_size", type=int, default=1152)
    p.add_argument("--depth", type=int, default=28)
    p.add_argument("--num_heads", type=int, default=16)
    p.add_argument("--global_batch_size", type=int, default=32)
    p.add_argument("--max_steps", type=int, default=100_000)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--wd", type=float, default=0.0)
    p.add_argument("--grad_clip", type=float, default=2.0)
    p.add_argument("--ema_decay", type=float, default=0.9999)
    p.add_argument("--precision", choices=["fp32", "bf16"], default="bf16")
    p.add_argument("--model_parallel_size", type=int, default=1)
    p.add_argument("--checkpointing", action="store_true")
    p.add_argument("--remat_policy", choices=["dots", "dots_slim", "full"], default="dots")
    p.add_argument("--auto_resume", action="store_true")
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--ckpt_every", type=int, default=10_000)
    p.add_argument("--keep_last", type=int, default=0,
                   help="prune all but the newest N complete checkpoints")
    p.add_argument("--async_save", action="store_true",
                   help="overlap checkpoint serialization with training")
    p.add_argument("--global_seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def synthetic_audio_batches(args, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Random (B, C, T) latents and (B, L, D) caption features from
    `--global_seed`, fast-forwarded past `start_step` batches."""
    rng = np.random.default_rng(args.global_seed)
    b = args.global_batch_size
    step = 0
    while True:
        batch = {"x": rng.standard_normal((b, args.latent_channels, args.latent_length),
                                          np.float32),
                 "context": rng.standard_normal((b, args.context_len, args.context_dim),
                                                np.float32)}
        if step >= start_step:
            yield batch
        step += 1


def npy_audio_batches(args, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """`<data_path>/{latents,captions}/<id>.npy` pairs drawn with replacement
    from `--global_seed`, cropped or zero-padded to `--latent_length` frames
    and `--context_len` tokens; fast-forwarded past `start_step` batches."""
    lat_dir = os.path.join(args.data_path, "latents")
    cap_dir = os.path.join(args.data_path, "captions")
    ids = sorted(os.path.splitext(f)[0] for f in os.listdir(lat_dir) if f.endswith(".npy"))
    rng = np.random.default_rng(args.global_seed)
    b = args.global_batch_size
    step = 0
    while True:
        pick = rng.choice(len(ids), b)
        if step >= start_step:
            xs, ctxs = [], []
            for i in pick:
                x = np.load(os.path.join(lat_dir, ids[i] + ".npy"))[:, : args.latent_length]
                xs.append(np.pad(x, ((0, 0), (0, args.latent_length - x.shape[1]))))
                c = np.load(os.path.join(cap_dir, ids[i] + ".npy"))[: args.context_len]
                ctxs.append(np.pad(c, ((0, args.context_len - c.shape[0]), (0, 0))))
            yield {"x": np.stack(xs).astype(np.float32),
                   "context": np.stack(ctxs).astype(np.float32)}
        step += 1


def make_cfm_train_step(model: FlagDiT1D, cfm: CFM, optimizer, grad_clip: float,
                        ema_decay: float, mesh=None):
    """`step(state, batch, seed, draws=None) -> (state, metrics)`: the CFM
    loss on batch {"x", "context"}, its gradient, the fp32 global norm, the
    clip scale min(1, clip / (norm + 1e-6)), the optimizer and the EMA
    (`train_lib.make_step`, no skip of a non-finite step, as in JAX). The
    step's t and noise come from (seed, step) (`CFM.draw`), or from `draws`
    = (t, noise). `mesh`: the model is sharded over it (FSDP2 over `data`)."""

    def draw(batch, generator, given=None):
        return tuple(given) if given is not None else cfm.draw(batch["x"], generator)

    def loss(batch, draw):
        t, noise = draw
        return cfm.p_losses(None, lambda x, tt: model(x, tt, batch["context"]), batch["x"],
                            t=t, noise=noise)["loss"]

    step = make_step(model, optimizer, (draw, loss), grad_clip=grad_clip, ema_decay=ema_decay,
                     mesh=mesh, skip_nonfinite=False)

    def cfm_step(state: TrainState, batch: Dict[str, torch.Tensor], seed: int,
                 draws: Optional[Sequence[torch.Tensor]] = None):
        return step(state, batch, seed, [draws] if draws is not None else None)

    return cfm_step


def main(argv=None):
    args = parse_args(argv)
    if args.async_save:
        raise NotImplementedError("--async_save is not ported yet (ROADMAP queue 1, item 7)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("error: --device cuda but torch.cuda.is_available() is false")
    started_group = not pmesh.is_distributed() and pmesh.distributed_init(device)
    mesh = None
    if pmesh.is_distributed() or args.model_parallel_size > 1:
        mesh = pmesh.create_mesh(args.model_parallel_size)
        device = pmesh.local_device(device)
    lead = pmesh.rank() == 0
    exp_dir = os.path.join(args.results_dir, args.task)
    logger = create_logger(exp_dir, is_lead=lead)
    metrics = MetricsWriter(exp_dir, is_lead=lead)
    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32

    resume = find_auto_resume(exp_dir) if args.auto_resume else None
    start_step = 0
    if resume:
        with open(os.path.join(resume, "resume_step.txt")) as f:
            start_step = int(f.read().strip())
    batches = (synthetic_audio_batches if args.data_path.startswith("synthetic://")
               else npy_audio_batches)(args, start_step)

    torch.manual_seed(args.global_seed)
    model = FlagDiT1D(in_channels=args.latent_channels, context_dim=args.context_dim,
                      hidden_size=args.hidden_size, depth=args.depth, num_heads=args.num_heads,
                      dtype=dtype, remat=args.checkpointing, remat_policy=args.remat_policy,
                      device=device)
    optimizer = create_optimizer(args.lr, args.wd)
    state = create_train_state(model, optimizer)
    n = sum(p.numel() for p in model.parameters())
    logger.info(f"FlagDiT1D params={n / 1e6:.1f}M task={args.task} device={device}")
    if resume:
        if lead:  # the other ranks take rank 0's state
            state = load_checkpoint(resume, state)
        logger.info(f"resumed from {resume}")

    if mesh is not None:
        broadcast_state(state)
        parallelize(model, mesh, fsdp=True)
        state = place_state(state)
    step_fn = make_cfm_train_step(model, CFM(), optimizer, args.grad_clip, args.ema_decay,
                                  mesh=mesh)
    meter = Throughput()
    meter.start()
    running: List[Dict[str, float]] = []
    for step in range(state.step, args.max_steps):
        batch = {k: torch.from_numpy(v).to(device) for k, v in next(batches).items()}
        state, m = step_fn(state, batch, args.global_seed)
        running.append(m)
        if (step + 1) % args.log_every == 0:
            tp = meter.step(len(running) * args.global_batch_size, device=device)
            secs_per_step = tp["secs_per_step"] / len(running)
            logger.info(f"(step={step + 1:07d}) Train Loss: {m['loss']:.4f}, "
                        f"Train Grad Norm: {m['grad_norm']:.4f}, "
                        f"items/sec: {tp['items_per_sec']:.1f}, secs/step: {secs_per_step:.3f}")
            metrics.write(step + 1, {"train/loss": m["loss"], "train/grad_norm": m["grad_norm"],
                                     "train/items_per_sec": tp["items_per_sec"],
                                     "train/secs_per_step": secs_per_step})
            running = []
        if (step + 1) % args.ckpt_every == 0 or (step + 1) == args.max_steps:
            path = save_checkpoint(exp_dir, step + 1, state, model_args=vars(args),
                                   keep_last=args.keep_last)
            logger.info(f"saved checkpoint to {path}")
            meter.start()  # the save is not step time
    metrics.close()
    if started_group:
        torch.distributed.destroy_process_group()
    return state


if __name__ == "__main__":
    main()

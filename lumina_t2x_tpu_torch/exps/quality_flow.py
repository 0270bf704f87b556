"""Generation-quality check of the port, end to end (the flow of the JAX
package's `exps/quality_demo.py`, through the port's trainer and sampler).

No pretrained weights exist here, so quality is shown from scratch on data
whose ground truth is known:

  1. render the procedural shapes dataset (`data/shapes.py`, 16 shape x
     color classes) as an ImageFolder tree, keyed on (n_per_class, size,
     seed);
  2. train `NextDiT_ImageNet_Small_patch2` in pixel space at 64^2 through
     the trainer CLI (`pipelines/train.py --pixel_space --qk_norm
     --checkpointing --auto_resume`), so that a run cut short resumes from
     its last checkpoint;
  3. sample through the sampler CLI (`pipelines/sample.py`, which reads the
     checkpoint's EMA stream) a per-class grid and an ADM-layout labeled FID
     npz over uniform random labels;
  4. judge the samples:
       - the weight-free classifier: class-faithfulness accuracy (chance
         1/16) and rejection rate;
       - pixel FID (16x16 average-pooled pixels) against a held-out real
         split, beside the real-vs-real FID of two held-out splits (the
         sample-noise floor); the real splits draw their labels as the FID
         sampler does, uniform at random;
       - optionally (`--inception_fid`) FID in the feature space of a
         random InceptionV3 from a seed (`eval/inception.py`), a relative
         metric with its own real-vs-real floor.
     The check passes when accuracy >= 0.8, rejections <= 0.1 and the
     generated FID is at most `FID_GATE_K` times the floor.

Writes summary.json, loss_curve.svg, grid/*.png (one sample per class) and
metrics.jsonl to `--out`; data, run and samples live under `--work`.

    python -m lumina_t2x_tpu_torch.exps.quality_flow --steps 2500 --batch 64 --tag 2500
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MODEL = "NextDiT_ImageNet_Small_patch2"
SIZE = 64
# the FID gate: generated-vs-real pixel FID at most this many times the
# real-vs-real floor (fixed before the first card run)
FID_GATE_K = 10.0
SEED = 0  # the data, the trainer and the sampler
CKPT_EVERY = 1000  # a run cut short resumes from its last checkpoint


def pixel_features(imgs: np.ndarray, out: int = 16) -> np.ndarray:
    """(N, H, W, 3) uint8 -> (N, out*out*3) float64 in [0, 1] by average
    pooling: the classic pixel-FID feature space."""
    n, h, w, c = imgs.shape
    f = imgs.reshape(n, out, h // out, out, w // out, c).astype(np.float64)
    return f.mean(axis=(2, 4)).reshape(n, -1) / 255.0


def render_batch(n: int, seed: int, size: int = SIZE):
    """n real images with i.i.d. uniform labels (the FID sampler's policy)."""
    from ..data.shapes import NUM_CLASSES, render

    rng = np.random.default_rng(seed)
    labels = rng.integers(0, NUM_CLASSES, n)
    return np.stack([render(int(c), rng, size) for c in labels]), labels


def fid_of_features(fa: np.ndarray, fb: np.ndarray) -> float:
    from ..eval.fid import compute_statistics, frechet_distance

    return frechet_distance(*compute_statistics(fa), *compute_statistics(fb))


@torch.no_grad()
def inception_features(imgs: np.ndarray, device, seed: int = 0, batch: int = 64) -> np.ndarray:
    """Pool3 features of a random InceptionV3 from `seed`, images resized
    bilinearly to 75^2 (its smallest input)."""
    from ..eval.inception import InceptionV3, random_fid_state_dict

    model = InceptionV3()
    model.load_fid_state_dict(random_fid_state_dict(seed))
    model = model.to(device)
    out = []
    for i in range(0, len(imgs), batch):
        x = torch.from_numpy(imgs[i:i + batch]).to(device).permute(0, 3, 1, 2).float() / 255.0
        x = torch.nn.functional.interpolate(x, size=(75, 75), mode="bilinear",
                                            align_corners=False)
        out.append(model(x).double().cpu().numpy())
    return np.concatenate(out)


def log_every_for(steps: int, most: int = 50) -> int:
    """The largest divisor of `steps` up to `most`: the final step is then
    always logged."""
    return max(d for d in range(1, min(steps, most) + 1) if steps % d == 0)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="shapes quality check of the port")
    p.add_argument("--steps", type=int, default=2500)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--n_per_class", type=int, default=400)
    p.add_argument("--fid_samples", type=int, default=1024)
    p.add_argument("--sampling_steps", type=int, default=30)
    p.add_argument("--cfg_scale", type=float, default=4.0)
    p.add_argument("--inception_fid", action="store_true")
    p.add_argument("--model", type=str, default=MODEL)
    p.add_argument("--size", type=int, default=SIZE)
    p.add_argument("--precision", choices=["fp32", "bf16"], default="bf16")
    p.add_argument("--tag", type=str, default="shapes")
    p.add_argument("--out", type=str, default=None,
                   help="artifacts directory (default lumina_t2x_tpu_torch/exps/artifacts/"
                        "quality_<tag>)")
    p.add_argument("--work", type=str, default=None,
                   help="data, run and samples (default build/quality_flow/<tag>)")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..data.shapes import CLASS_NAMES, faithfulness_report, write_imagefolder
    from ..core.loss_plot import read_metrics_jsonl, svg_line_plot
    from ..pipelines.sample import main as sample_main
    from ..pipelines.train import main as train_main

    out = args.out or os.path.join(REPO, "lumina_t2x_tpu_torch", "exps", "artifacts",
                                   f"quality_{args.tag}")
    work = args.work or os.path.join(REPO, "build", "quality_flow", args.tag)
    os.makedirs(out, exist_ok=True)
    data = os.path.join(work, f"shapes_n{args.n_per_class}_s{args.size}_seed{SEED}")
    run = os.path.join(work, "run")
    if not os.path.isdir(data):
        t0 = time.perf_counter()
        tmp = data + ".partial"
        shutil.rmtree(tmp, ignore_errors=True)
        n = write_imagefolder(tmp, n_per_class=args.n_per_class, seed=SEED, size=args.size)
        os.rename(tmp, data)
        print(f"[data] {n} images -> {data} ({time.perf_counter() - t0:.1f}s)")

    # -- train (resumes from the run's last checkpoint) ----------------------------------
    t0 = time.perf_counter()
    state = train_main([
        "--model", args.model, "--data_path", data, "--results_dir", run,
        "--image_size", str(args.size), "--pixel_space", "--num_classes", str(len(CLASS_NAMES)),
        "--qk_norm", "--checkpointing", "--auto_resume",
        "--global_batch_size", str(args.batch), "--lr", str(args.lr),
        "--max_steps", str(args.steps), "--log_every", str(log_every_for(args.steps)),
        "--ckpt_every", str(CKPT_EVERY), "--keep_last", "1", "--num_workers", "4",
        "--precision", args.precision, "--global_seed", str(SEED), "--device", args.device,
    ])
    train_s = time.perf_counter() - t0
    exp_dir = os.path.join(run, args.model)
    ckpt = os.path.join(exp_dir, "checkpoints", f"{int(state.step):07d}")
    steps, losses = read_metrics_jsonl(os.path.join(exp_dir, "metrics.jsonl"))
    _, step_s = read_metrics_jsonl(os.path.join(exp_dir, "metrics.jsonl"),
                                   key="train/secs_per_step")
    if not losses:
        raise SystemExit(f"no train/loss in {exp_dir}/metrics.jsonl")
    shutil.copy(os.path.join(exp_dir, "metrics.jsonl"), out)
    svg_line_plot(steps, losses, os.path.join(out, "loss_curve.svg"),
                  f"{args.model} pixel-space shapes: train/loss")
    print(f"[train] step {state.step} in {train_s:.1f}s this call; loss {losses[0]:.4f} "
          f"(step {steps[0]}) -> {losses[-1]:.4f} (step {steps[-1]})")

    # -- sample: the per-class grid and the labeled FID npz --------------------------------
    common = ["--ckpt", ckpt, "--resolution", f"1:{args.size}x{args.size}",
              "--num_sampling_steps", str(args.sampling_steps),
              "--cfg_scale", str(args.cfg_scale), "--train_res", str(args.size),
              "--precision", args.precision, "--device", args.device, "--seed", str(SEED)]
    grid_dir = os.path.join(out, "grid")
    shutil.rmtree(grid_dir, ignore_errors=True)
    sample_main(common + ["--labels", ",".join(str(i) for i in range(len(CLASS_NAMES))),
                          "--image_save_path", grid_dir])
    os.remove(os.path.join(grid_dir, "data.json"))  # holds the work paths
    fid_dir = os.path.join(work, "fid_samples")
    shutil.rmtree(fid_dir, ignore_errors=True)
    t0 = time.perf_counter()
    manifest = sample_main(common + ["--num_fid_samples", str(args.fid_samples),
                                     "--batch_size", str(min(64, args.fid_samples)),
                                     "--image_save_path", fid_dir])
    sample_s = time.perf_counter() - t0
    with np.load(manifest["items"][0]["fid_npz"]) as d:
        gen, gen_labels = d["arr_0"], d["arr_1"]
    print(f"[sample] {len(gen)} samples in {sample_s:.1f}s")

    # -- judge --------------------------------------------------------------------------
    rep = faithfulness_report(gen, gen_labels)
    real_a, _ = render_batch(args.fid_samples, seed=101, size=args.size)
    real_b, _ = render_batch(args.fid_samples, seed=202, size=args.size)
    fid_gen = fid_of_features(pixel_features(gen), pixel_features(real_a))
    fid_floor = fid_of_features(pixel_features(real_b), pixel_features(real_a))
    passed = bool(rep["accuracy"] >= 0.8 and rep["rejected_frac"] <= 0.1
                  and fid_gen <= FID_GATE_K * fid_floor)
    n_params = sum(p.numel() for p in state.model.parameters())
    summary = {
        "model": args.model, "params_m": round(n_params / 1e6, 2), "image_size": args.size,
        "pixel_space": True,
        "device": (torch.cuda.get_device_name(0) if torch.device(args.device).type == "cuda"
                   else "cpu"),
        "train": {"steps": int(state.step), "global_batch": args.batch, "lr": args.lr,
                  "seconds_this_call": round(train_s, 1),
                  "median_secs_per_step": float(np.median(step_s)) if step_s else None,
                  "loss_first": losses[0], "loss_first_step": steps[0],
                  "loss_last": losses[-1], "loss_last_step": steps[-1],
                  "ema_init_share": math.pow(0.9999, int(state.step))},
        "sample": {"n": int(len(gen)), "steps": args.sampling_steps,
                   "cfg_scale": args.cfg_scale, "seconds": round(sample_s, 1),
                   "stream": "ema"},
        "faithfulness": rep,
        "pixel_fid": {"gen_vs_real": fid_gen, "real_vs_real_floor": fid_floor,
                      "gate_k": FID_GATE_K},
        "passed": passed,
    }
    if args.inception_fid:
        fg, fa, fb = (inception_features(x, args.device, SEED) for x in (gen, real_a, real_b))
        summary["inception_fid_random_init"] = {"gen_vs_real": fid_of_features(fg, fa),
                                                "real_vs_real_floor": fid_of_features(fb, fa)}
    with open(os.path.join(out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print("QUALITY " + json.dumps({"steps": summary["train"]["steps"],
                                   "loss_last": losses[-1], "accuracy": rep["accuracy"],
                                   "rejected": rep["rejected_frac"], "fid_gen": fid_gen,
                                   "fid_floor": fid_floor, "passed": passed}))
    return summary


if __name__ == "__main__":
    main()

"""The `lumina` CLI of the port (counterpart of
`lumina_t2x_tpu/cli/entry_point.py`), on argparse:

    python -m lumina_t2x_tpu_torch.cli.entry_point "a prompt" out --debug
    python -m lumina_t2x_tpu_torch.cli.entry_point infer "a prompt" out --ckpt <dir>
    python -m lumina_t2x_tpu_torch.cli.entry_point convert model.safetensors <dir>
    python -m lumina_t2x_tpu_torch.cli.entry_point convert <dir> out.safetensors \\
        --direction to_safetensors

`infer` is the default subcommand. Its settings come from a YAML file
(`configs/infer/settings.yaml`: transport / ode / infer sections), read by the
port's reader of the YAML subset that file uses (`utils/yaml_subset.py`), so
no YAML package is needed. `convert` moves weights between reference `.pth` / `.safetensors`
state dicts and the port's checkpoint directory (`<dest>/ema` and
`model_args.json`, which `--ckpt <dest>` loads). Installed, `main` is the
`lumina_torch` script and `main_next` its `lumina_next_torch` alias
(`pyproject.toml`), beside the JAX package's `lumina` / `lumina_next`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..utils.yaml_subset import parse_yaml_subset

DEFAULT_SETTINGS = {
    "transport": {"path_type": "Linear", "prediction": "velocity", "loss_weight": None,
                  "sample_eps": None, "train_eps": None},
    "ode": {"atol": 1e-6, "rtol": 1e-3, "reverse": False, "likelihood": False},
    "infer": {"resolution": "1024x1024", "num_sampling_steps": 30, "cfg_scale": 4.0,
              "solver": "midpoint", "t_shift": 4, "seed": 0, "scaling_method": "Time-aware",
              "scaling_watershed": 0.3, "proportional_attn": True},
}


def load_settings(config_path):
    """The settings of `config_path` merged over `DEFAULT_SETTINGS` section by
    section (a missing, empty or comment-only file gives the defaults; the
    reference stores a one-element list)."""
    if config_path and not os.path.exists(config_path):
        print(f"note: config {config_path!r} not found; using built-in defaults", file=sys.stderr)
    if config_path and os.path.exists(config_path):
        with open(config_path) as f:
            loaded = parse_yaml_subset(f.read())
        if isinstance(loaded, list):
            loaded = loaded[0] if loaded else None
        if not isinstance(loaded, dict):
            return DEFAULT_SETTINGS
        return {k: {**DEFAULT_SETTINGS.get(k, {}), **(loaded.get(k) or {})}
                for k in set(DEFAULT_SETTINGS) | set(loaded)}
    return DEFAULT_SETTINGS


def infer(args):
    """Generate latents for TEXT into OUTPUT_PATH through the sampler CLI."""
    from ..pipelines.sample import main as sample_main

    s = load_settings(args.config)
    infer_cfg, ode_cfg = s["infer"], s["ode"]
    os.makedirs(args.output_path, exist_ok=True)
    prompt_file = os.path.join(args.output_path, "_prompt.txt")
    with open(prompt_file, "w") as f:
        f.write(args.text + "\n")
    # scaling_method "None": watershed 1.0, linear RoPE scaling throughout
    watershed = (infer_cfg["scaling_watershed"]
                 if infer_cfg.get("scaling_method", "Time-aware") == "Time-aware" else 1.0)
    argv = [
        "--model", args.model,
        "--image_save_path", args.output_path,
        "--caption_path", prompt_file,
        "--resolution", f"1:{infer_cfg['resolution']}",
        "--num_sampling_steps", str(infer_cfg["num_sampling_steps"]),
        "--solver", str(infer_cfg["solver"]),
        "--cfg_scale", str(infer_cfg["cfg_scale"]),
        "--time_shifting_factor", str(infer_cfg["t_shift"]),
        "--scaling_watershed", str(watershed),
        "--seed", str(infer_cfg["seed"]),
        "--atol", str(ode_cfg["atol"]),
        "--rtol", str(ode_cfg["rtol"]),
        "--device", args.device,
    ]
    if infer_cfg.get("proportional_attn"):
        argv.append("--proportional_attn")
    if args.ckpt:
        argv += ["--ckpt", args.ckpt]
    if args.debug:
        argv.append("--debug")
    manifest = sample_main(argv)
    print(f"saved to {args.output_path}")
    return manifest


def convert(args):
    """Reference `.pth` / `.safetensors` -> the port's checkpoint directory
    (`to_checkpoint`), or a checkpoint directory's `ema` (else `model`)
    stream -> `.safetensors` (`to_safetensors`)."""
    from ..core.checkpoint import load_stream, load_torch_state_dict, save_safetensors, save_weights
    from ..models import get_model

    if not os.path.exists(args.source):
        raise SystemExit(f"error: source not found: {args.source}")
    if args.direction == "to_checkpoint":
        sd = load_torch_state_dict(args.source)
        if "cap_embedder.0.weight" not in sd:
            raise SystemExit("error: not a NextDiT state dict (no cap_embedder.0.weight)")
        model_args = {"model": args.model,
                      "qk_norm": any(k.endswith("attention.q_norm.weight") for k in sd),
                      "cap_feat_dim": int(sd["cap_embedder.0.weight"].shape[0])}
        expected = get_model(args.model, qk_norm=model_args["qk_norm"],
                             cap_feat_dim=model_args["cap_feat_dim"], device="meta").state_dict()
        wrong = sorted(set(expected) ^ set(sd)) + sorted(
            k for k in set(expected) & set(sd) if tuple(expected[k].shape) != tuple(sd[k].shape))
        if wrong:
            raise SystemExit(f"error: {args.source} is not a {args.model} state dict: "
                             f"{len(wrong)} keys differ, e.g. {wrong[:4]}")
        save_weights(args.dest, sd, model_args)
        print(f"imported {len(sd)} tensors -> {args.dest}/ema")
    else:
        stream = next((s for s in ("ema", "model") if os.path.isdir(os.path.join(args.source, s))),
                      None)
        if stream is None:
            raise SystemExit(f"error: {args.source} holds no ema or model stream")
        sd = load_stream(args.source, stream)
        save_safetensors(sd, args.dest)
        print(f"exported {len(sd)} tensors -> {args.dest}")


_COMMANDS = ("infer", "convert")


def build_parser():
    p = argparse.ArgumentParser(prog="lumina", description="Lumina-T2X (PyTorch)")
    sub = p.add_subparsers(dest="command", required=True)
    pi = sub.add_parser("infer", help="generate latents for a prompt (the default command)")
    pi.add_argument("text", type=str)
    pi.add_argument("output_path", type=str, nargs="?", default="out")
    pi.add_argument("-c", "--config", type=str, default="configs/infer/settings.yaml")
    pi.add_argument("--ckpt", type=str, default=None)
    pi.add_argument("--model", type=str, default="NextDiT_2B_patch2")
    pi.add_argument("--device", type=str, default="cuda")
    pi.add_argument("--debug", action="store_true")
    pi.set_defaults(fn=infer)
    pc = sub.add_parser("convert", help="convert checkpoints")
    pc.add_argument("source", type=str)
    pc.add_argument("dest", type=str)
    pc.add_argument("--direction", choices=["to_checkpoint", "to_safetensors"],
                    default="to_checkpoint")
    pc.add_argument("--model", type=str, default="NextDiT_2B_patch2",
                    help="registry name recorded for a reference state dict (to_checkpoint)")
    pc.set_defaults(fn=convert)
    return p


def main(argv=None):
    """Run a subcommand; without one, `infer` (`lumina "a prompt" out`)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or (argv[0] not in _COMMANDS and argv[0] not in ("-h", "--help")):
        argv = ["infer", *argv]
    args = build_parser().parse_args(argv)
    return args.fn(args)


def main_next(argv=None):
    """The `lumina_next` alias of `main` (JAX's `main_next`)."""
    return main(argv)


if __name__ == "__main__":
    main()

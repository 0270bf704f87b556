"""The `lumina` CLI of the port (counterpart of
`lumina_t2x_tpu/cli/entry_point.py`), on argparse:

    python -m lumina_t2x_tpu_torch.cli.entry_point "a prompt" out --debug
    python -m lumina_t2x_tpu_torch.cli.entry_point infer "a prompt" out --ckpt <dir>
    python -m lumina_t2x_tpu_torch.cli.entry_point convert model.safetensors <dir>
    python -m lumina_t2x_tpu_torch.cli.entry_point convert <dir> out.safetensors \\
        --direction to_safetensors

`infer` is the default subcommand. Its settings come from a YAML file
(`configs/infer/settings.yaml`: transport / ode / infer sections), read by a
small reader of the YAML subset that file uses, so no YAML package is
needed. `convert` moves weights between reference `.pth` / `.safetensors`
state dicts and the port's checkpoint directory (`<dest>/ema` and
`model_args.json`, which `--ckpt <dest>` loads).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

DEFAULT_SETTINGS = {
    "transport": {"path_type": "Linear", "prediction": "velocity", "loss_weight": None,
                  "sample_eps": None, "train_eps": None},
    "ode": {"atol": 1e-6, "rtol": 1e-3, "reverse": False, "likelihood": False},
    "infer": {"resolution": "1024x1024", "num_sampling_steps": 30, "cfg_scale": 4.0,
              "solver": "midpoint", "t_shift": 4, "seed": 0, "scaling_method": "Time-aware",
              "scaling_watershed": 0.3, "proportional_attn": True},
}

# YAML 1.1 plain-scalar resolution, as PyYAML's SafeLoader does it
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")


def _scalar(text: str):
    """A YAML scalar: quoted string, null, bool, decimal int, float, else
    the plain string (flow collections are not read)."""
    if text[:1] in ("[", "{", "&", "*", "!", "|", ">"):
        raise ValueError(f"not in the YAML subset read here: {text!r}")
    if len(text) >= 2 and text[0] == text[-1] == "'":
        return text[1:-1].replace("''", "'")
    if len(text) >= 2 and text[0] == text[-1] == '"':
        return json.loads(text)  # JSON's escapes are a subset of YAML's
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        low = text.lower()
        if low.endswith(".inf"):
            return float("-inf") if low.startswith("-") else float("inf")
        if low == ".nan":
            return float("nan")
        return float(text.replace("_", ""))
    return text


def _strip_comment(line: str) -> str:
    """Drop a `#` comment (at the line start or after whitespace, outside
    quotes) and trailing whitespace."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def parse_yaml_subset(text: str):
    """The YAML subset of the settings files: nested block mappings of
    scalars, optionally inside a block sequence (`- key: value`), `#`
    comments. Returns None for an empty document. Raises ValueError on what
    it does not read."""
    lines = []
    for raw in text.splitlines():
        line = _strip_comment(raw)
        if line.strip() and line.strip() != "---":
            if "\t" in line[: len(line) - len(line.lstrip())]:
                raise ValueError(f"tabs in indentation: {raw!r}")
            lines.append(line)
    if not lines:
        return None
    pos = 0

    def block(indent):
        nonlocal pos
        first = lines[pos]
        if first.lstrip().startswith("- ") or first.strip() == "-":
            items = []
            while pos < len(lines):
                line = lines[pos]
                ind = len(line) - len(line.lstrip())
                if ind != indent or not line.lstrip().startswith("-"):
                    break
                rest = line.lstrip()[1:]
                if not rest.strip():
                    pos += 1
                    nested = pos < len(lines) and len(lines[pos]) - len(lines[pos].lstrip()) > indent
                    items.append(block(len(lines[pos]) - len(lines[pos].lstrip())) if nested else None)
                    continue
                if not re.search(r":(\s|$)", rest):  # "- scalar"
                    items.append(_scalar(rest.strip()))
                    pos += 1
                    continue
                # "- key: value": the item is a mapping whose keys sit at the
                # column after the dash
                item_indent = indent + 1 + (len(rest) - len(rest.lstrip()))
                lines[pos] = " " * item_indent + rest.lstrip()
                items.append(block(item_indent))
            return items
        mapping = {}
        while pos < len(lines):
            line = lines[pos]
            ind = len(line) - len(line.lstrip())
            if ind < indent:
                break
            if ind > indent:
                raise ValueError(f"unexpected indentation: {line!r}")
            key, sep, value = line.strip().partition(":")
            if not sep or (value and not value.startswith((" ", "\t"))):
                raise ValueError(f"expected 'key: value': {line!r}")
            key, value = key.strip(), value.strip()
            pos += 1
            if value:
                mapping[_scalar(key)] = _scalar(value)
            elif pos < len(lines) and len(lines[pos]) - len(lines[pos].lstrip()) > indent:
                mapping[_scalar(key)] = block(len(lines[pos]) - len(lines[pos].lstrip()))
            elif pos < len(lines) and lines[pos].lstrip().startswith("- ") \
                    and len(lines[pos]) - len(lines[pos].lstrip()) == indent:
                mapping[_scalar(key)] = block(indent)
            else:
                mapping[_scalar(key)] = None
        return mapping

    out = block(len(lines[0]) - len(lines[0].lstrip()))
    if pos != len(lines):
        raise ValueError(f"could not read the YAML from {lines[pos]!r} on")
    return out


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


if __name__ == "__main__":
    main()

"""Checkpoints and the weight bridge (counterpart of
`lumina_t2x_tpu/core/checkpoint.py`).

Trainer checkpoints keep the JAX package's directory layout:
`<results>/checkpoints/<step:07d>/{model,ema,optimizer}/state_dict.pt`,
`model_args.json`, and `resume_step.txt`, written last as the completion
marker that `find_auto_resume` keys on. The streams are torch files with
reference-layout names (the state-dict keys of the port's modules); the
optimizer file holds the optimizer's state dict (`pipelines/train_lib.py`).

`state_dict_from_jax_params` is the JAX-free mirror of the JAX package's
`export_next_dit_weights`: it turns a NextDiT flax parameter tree (nested
dicts of numpy arrays, transformer layers stacked under `layers/`, or per
layer under `blocks_<i>/`) into the reference-layout state dict that the
port's `NextDiT.load_state_dict(..., strict=True)` takes.
`train_state_from_jax` extends it to the EMA tree and the optimizer state.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

_STREAM_FILE = "state_dict.pt"


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict) or hasattr(value, "items"):
            flat.update(_flatten(dict(value.items()), path + "/"))
        else:
            flat[path] = np.asarray(value)
    return flat


def _torch_name(sub: str, layer: int) -> str:
    """'attention/wq/kernel' -> 'layers.<i>.attention.wq.weight'; the adaLN
    linear sits at index 1 of the reference's Sequential."""
    base, leaf = sub.rsplit("/", 1) if "/" in sub else ("", sub)
    name = f"layers.{layer}." + base.replace("/", ".") if base else f"layers.{layer}"
    if leaf in ("kernel", "bias") and name.endswith("adaLN_modulation"):
        name += ".1"
    leaf = {"kernel": "weight"}.get(leaf, leaf)
    return f"{name}.{leaf}"


def state_dict_from_jax_params(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax NextDiT params -> reference-layout state dict of fp32-or-stored
    dtype CPU tensors: each Dense `kernel` is transposed into a `weight`,
    stacked layers are unstacked into `layers.<i>.*`."""
    flat = _flatten(params)
    out: Dict[str, np.ndarray] = {}

    def put_linear(torch_name, base):
        out[f"{torch_name}.weight"] = flat[f"{base}/kernel"].T
        if f"{base}/bias" in flat:
            out[f"{torch_name}.bias"] = flat[f"{base}/bias"]

    put_linear("x_embedder", "x_embedder")
    out["pad_token"] = flat["pad_token"]
    put_linear("t_embedder.mlp.0", "t_embedder/mlp_0")
    put_linear("t_embedder.mlp.2", "t_embedder/mlp_2")
    out["cap_embedder.0.weight"] = flat["cap_embedder/norm/weight"]
    out["cap_embedder.0.bias"] = flat["cap_embedder/norm/bias"]
    put_linear("cap_embedder.1", "cap_embedder/proj")
    put_linear("final_layer.linear", "final_layer/linear")
    put_linear("final_layer.adaLN_modulation.1", "final_layer/adaLN_modulation")

    if any(k.startswith("layers/") for k in flat):
        stacked = {k[len("layers/"):]: v for k, v in flat.items() if k.startswith("layers/")}
        n_layers = stacked["adaLN_modulation/kernel"].shape[0]
        per_layer = [{sub: arr[i] for sub, arr in stacked.items()} for i in range(n_layers)]
    else:
        idxs = sorted({int(k.split("/", 1)[0][len("blocks_"):])
                       for k in flat if k.startswith("blocks_")})
        if not idxs:
            raise ValueError("no transformer layers found: expected a stacked "
                             "'layers/' subtree or per-layer 'blocks_<i>/' keys")
        per_layer = [{k[len(f"blocks_{i}/"):]: v for k, v in flat.items()
                      if k.startswith(f"blocks_{i}/")} for i in idxs]

    for i, items in enumerate(per_layer):
        for sub, arr in items.items():
            out[_torch_name(sub, i)] = arr.T if sub.endswith("kernel") else arr

    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}


def train_state_from_jax(params, ema, opt_state):
    """A JAX train state (flax params, EMA tree, optax/fused optimizer state)
    -> (model state dict, EMA state dict, optimizer state) in the port's
    layouts. The optimizer state may hold AdamW's `mu`/`nu`/`count` (optax
    chain or `FusedAdamWEMA`, plus a schedule count under warmup) or
    Adafactor's factored stats (`FusedAdafactorEMA`). Adafactor's row/column
    roles swap for square weights: the JAX rule factors the (in, out) kernel
    and the port the (out, in) weight, and a stable argsort breaks the tie
    on opposite axes."""
    state = {}
    parts = (list(opt_state) if isinstance(opt_state, tuple) and not hasattr(opt_state, "_fields")
             else [opt_state])
    count = lambda c: torch.tensor(np.asarray(c), dtype=torch.int32)
    n_layers = _flatten(params)["layers/adaLN_modulation/kernel"].shape[0] \
        if "layers" in params else None
    for part in parts:
        if hasattr(part, "mu"):
            state["count"] = count(part.count)
            state["mu"] = state_dict_from_jax_params(part.mu)
            state["nu"] = state_dict_from_jax_params(part.nu)
        elif hasattr(part, "v_row"):
            state["count"] = count(part.count)
            for slot in ("v_row", "v_col", "v"):
                state[slot] = state_dict_from_jax_params(
                    _unstackable(getattr(part, slot), n_layers))
            for name, w in state_dict_from_jax_params(params).items():
                if w.dim() == 2 and w.shape[0] == w.shape[1] and state["v_row"][name].shape != (1,):
                    state["v_row"][name], state["v_col"][name] = (state["v_col"][name],
                                                                  state["v_row"][name])
        elif "count" in getattr(part, "_fields", ()):  # optax's ScaleByScheduleState
            state["schedule_count"] = count(part.count)
    return state_dict_from_jax_params(params), state_dict_from_jax_params(ema), state


def _unstackable(tree, n_layers, stacked=False):
    """Adafactor keeps a (1,) placeholder per leaf, stacked leaves included:
    give the stacked ones (under `layers/`) a layer axis so that they
    unstack."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict) or hasattr(value, "items"):
            out[key] = _unstackable(dict(value.items()), n_layers, stacked or key == "layers")
        else:
            arr = np.asarray(value)
            out[key] = np.zeros((n_layers, 1), arr.dtype) if stacked and arr.shape == (1,) else arr
    return out


# -- trainer checkpoints ---------------------------------------------------------------


def checkpoint_dir(results_dir: str, step: int) -> str:
    return os.path.join(results_dir, "checkpoints", f"{step:07d}")


def save_checkpoint(results_dir: str, step: int, state, model_args: Optional[Dict] = None,
                    keep_last: int = 0) -> str:
    """Save model/EMA/optimizer + model_args + resume_step (written last).
    `keep_last` > 0 then prunes older complete checkpoints beyond the newest
    `keep_last`."""
    path = os.path.abspath(checkpoint_dir(results_dir, step))
    streams = {"model": state.model.state_dict(), "ema": state.ema, "optimizer": state.opt_state}
    for stream, payload in streams.items():
        os.makedirs(os.path.join(path, stream), exist_ok=True)
        torch.save(payload, os.path.join(path, stream, _STREAM_FILE))
    if model_args is not None:
        with open(os.path.join(path, "model_args.json"), "w") as f:
            json.dump(model_args, f, indent=2, default=str)
    with open(os.path.join(path, "resume_step.txt"), "w") as f:
        f.write(str(step))
    prune_checkpoints(results_dir, keep_last)
    return path


def _complete_steps(results_dir: str):
    base = os.path.join(results_dir, "checkpoints")
    if not os.path.isdir(base):
        return base, []
    return base, sorted((d for d in os.listdir(base) if re.fullmatch(r"\d{7}", d)
                         and os.path.exists(os.path.join(base, d, "resume_step.txt"))), key=int)


def prune_checkpoints(results_dir: str, keep_last: int) -> list:
    """Delete all but the newest `keep_last` complete checkpoint dirs (those
    with the `resume_step.txt` marker). No-op for keep_last <= 0. Returns
    the pruned paths."""
    if keep_last <= 0:
        return []
    base, complete = _complete_steps(results_dir)
    pruned = []
    for d in complete[:-keep_last]:
        target = os.path.join(base, d)
        try:
            shutil.rmtree(target)
        except OSError as e:  # report and go on: pruning must not stop training
            logging.getLogger(__name__).warning("prune failed for %s: %s", target, e)
            continue
        pruned.append(target)
    return pruned


def find_auto_resume(results_dir: str) -> Optional[str]:
    """The newest complete checkpoint dir, or None."""
    base, complete = _complete_steps(results_dir)
    return os.path.join(base, complete[-1]) if complete else None


def _load_stream(path: str, stream: str):
    return torch.load(os.path.join(path, stream, _STREAM_FILE), map_location="cpu",
                      mmap=True, weights_only=True)


def _copy_into(dst, src, where: str):
    """Copy a loaded (nested dict of) tensors into the live one in place;
    scalars (counts) are replaced."""
    if isinstance(dst, dict):
        if set(dst) != set(src):
            raise ValueError(f"checkpoint {where}: keys differ from the live state")
        for key in dst:
            if isinstance(dst[key], torch.Tensor) and dst[key].dim() == 0:
                dst[key] = src[key].to(dst[key].device, dst[key].dtype)
            else:
                _copy_into(dst[key], src[key], f"{where}/{key}")
        return
    if tuple(dst.shape) != tuple(src.shape):
        raise ValueError(f"checkpoint {where}: shape {tuple(src.shape)} != {tuple(dst.shape)}")
    dst.copy_(src)


def load_checkpoint(path: str, state):
    """Restore a train state saved by `save_checkpoint` into the live one,
    in place (no second copy of the state on the device)."""
    path = os.path.abspath(path)
    with torch.no_grad():
        state.model.load_state_dict(_load_stream(path, "model"), strict=True)
        _copy_into(state.ema, _load_stream(path, "ema"), "ema")
        _copy_into(state.opt_state, _load_stream(path, "optimizer"), "optimizer")
    with open(os.path.join(path, "resume_step.txt")) as f:
        state.step = int(f.read().strip())
    return state


def load_model_args(path: str) -> Dict:
    """Recorded model args of a checkpoint dir, or {} when absent."""
    args_path = os.path.join(path, "model_args.json")
    if not os.path.exists(args_path):
        return {}
    with open(args_path) as f:
        return json.load(f)


def init_from(path: str, model, stream: str = "ema") -> Dict[str, torch.Tensor]:
    """Weights-only partial load of one stream of a checkpoint dir into
    `model`: keys with another shape are dropped (kept as initialised).
    Returns the loaded state dict."""
    loaded = _load_stream(os.path.abspath(path), stream)
    current = model.state_dict()
    keep = {k: v for k, v in loaded.items() if k in current and current[k].shape == v.shape}
    dropped = [k for k in loaded if k in current and k not in keep]
    if dropped:
        print(f"init_from: dropped {len(dropped)} shape-mismatched keys: {dropped[:8]}...")
    model.load_state_dict(keep, strict=False)
    return keep

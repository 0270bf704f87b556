"""Weight bridge (counterpart of `lumina_t2x_tpu/core/checkpoint.py`).

`state_dict_from_jax_params` is the JAX-free mirror of the JAX package's
`export_next_dit_weights`: it turns a NextDiT flax parameter tree (nested
dicts of numpy arrays, transformer layers stacked under `layers/`, or per
layer under `blocks_<i>/`) into the reference-layout state dict that the
port's `NextDiT.load_state_dict(..., strict=True)` takes.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


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

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
`imagenet_state_dict_from_jax_params`, `flag_dit_state_dict_from_jax_params`
and `moe_state_dict_from_jax_params` do the same for NextDiT-ImageNet,
Flag-DiT and Next-DiT-MoE (the compositional model takes NextDiT's), and `vae_state_dict_from_jax` turns a JAX `AutoencoderKL` tree into the
diffusers layout of the port's VAE (`codecs/vae.py`).
`gemma_state_dict_from_flax` carries a Flax Gemma tree into transformers'
torch `GemmaModel` (the caption encoder, `codecs/text_encoders.py`);
`mmdit_state_dict_from_jax_params` a JAX MMDiT tree into the port's MMDiT
(`models/mmdit.py`) and `clip_text_state_dict_from_jax` a JAX CLIP text
tower into the port's, which has HF's names (`codecs/clip_text.py`).
The audio family's bridges: `flag_dit_1d_state_dict_from_jax_params`,
`vae1d_state_dict_from_jax` (KL and VQ), `bigvgan_state_dict_from_jax`,
`clap_audio_params_from_jax`, `clap_projection_from_jax` and
`discriminator_state_dict_from_jax`;
`import_flag_dit_1d_weights` reads a reference FlagDiT-1D file.

Reference release weights (`.pth` / `.safetensors` state dicts) load with
`load_torch_state_dict` and are written with `save_safetensors`: the
safetensors format is read and written here (an 8-byte little-endian header
length, a JSON header, then the raw little-endian tensor bytes), so neither
needs the `safetensors` package. The port's parameter names are the
reference keys, so no key mapping is needed. `save_weights` writes such a
state dict as a checkpoint directory whose `ema` stream `init_from` (and the
sampler's `--ckpt`) restores.

`AsyncCheckpointSaver` writes the trainer checkpoints of `--async_save` on a
background thread from a host copy of the state.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
import struct
import threading
from typing import Any, Dict, Optional, Sequence

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


def _put_linear(out, flat, torch_name, base):
    """A flax Dense `<base>/kernel` (and bias) as `<torch_name>.weight`."""
    out[f"{torch_name}.weight"] = flat[f"{base}/kernel"].T
    if f"{base}/bias" in flat:
        out[f"{torch_name}.bias"] = flat[f"{base}/bias"]


def _layer_items(flat, per_layer_prefix):
    """The transformer layers of a flat tree, one {sub-path: array} dict
    each: stacked under `layers/`, or one subtree per `<per_layer_prefix><i>/`."""
    if any(k.startswith("layers/") for k in flat):
        stacked = {k[len("layers/"):]: v for k, v in flat.items() if k.startswith("layers/")}
        n_layers = stacked["adaLN_modulation/kernel"].shape[0]
        return [{sub: arr[i] for sub, arr in stacked.items()} for i in range(n_layers)]
    pattern = re.compile(rf"{per_layer_prefix}(\d+)/")
    idxs = sorted({int(m.group(1)) for m in map(pattern.match, flat) if m})
    if not idxs:
        raise ValueError("no transformer layers found: expected a stacked 'layers/' subtree "
                         f"or per-layer '{per_layer_prefix}<i>/' keys")
    return [{k[len(f"{per_layer_prefix}{i}/"):]: v for k, v in flat.items()
             if k.startswith(f"{per_layer_prefix}{i}/")} for i in idxs]


_EXPERT_STACK = re.compile(r"(.+)/(w[123])")


def _with_layers(out, flat, per_layer_prefix):
    """`out` plus the layers of `flat` under `layers.<i>.*`, as CPU tensors
    that own their memory: the arrays may be read-only views of JAX buffers,
    and the port's optimizers update their state in place. A MoE layer's
    stacked (E, in, out) expert matrices `<ffn>/w{1,2,3}` become
    `layers.<i>.<ffn>.experts.<j>.w{1,2,3}.weight`."""
    for i, items in enumerate(_layer_items(flat, per_layer_prefix)):
        for sub, arr in items.items():
            experts = _EXPERT_STACK.fullmatch(sub)
            if experts:
                base = f"layers.{i}.{experts.group(1).replace('/', '.')}.experts"
                for j in range(arr.shape[0]):
                    out[f"{base}.{j}.{experts.group(2)}.weight"] = arr[j].T
            else:
                out[_torch_name(sub, i)] = arr.T if sub.endswith("kernel") else arr
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in out.items()}


def state_dict_from_jax_params(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax NextDiT params -> reference-layout state dict of fp32-or-stored
    dtype CPU tensors: each Dense `kernel` is transposed into a `weight`,
    stacked layers (or per-layer `blocks_<i>/` subtrees) are unstacked into
    `layers.<i>.*`."""
    flat = _flatten(params)
    out: Dict[str, np.ndarray] = {}
    _put_linear(out, flat, "x_embedder", "x_embedder")
    out["pad_token"] = flat["pad_token"]
    _put_linear(out, flat, "t_embedder.mlp.0", "t_embedder/mlp_0")
    _put_linear(out, flat, "t_embedder.mlp.2", "t_embedder/mlp_2")
    out["cap_embedder.0.weight"] = flat["cap_embedder/norm/weight"]
    out["cap_embedder.0.bias"] = flat["cap_embedder/norm/bias"]
    _put_linear(out, flat, "cap_embedder.1", "cap_embedder/proj")
    _put_linear(out, flat, "final_layer.linear", "final_layer/linear")
    _put_linear(out, flat, "final_layer.adaLN_modulation.1", "final_layer/adaLN_modulation")
    return _with_layers(out, flat, "blocks_")


def imagenet_state_dict_from_jax_params(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax NextDiTImageNet params (layers stacked under `layers/`, or per
    layer under `layers_<i>/`) -> the reference Next-DiT-ImageNet state dict
    that the port's `NextDiTImageNet` loads with `strict=True`: the inverse
    of the JAX package's `import_next_dit_imagenet_weights`."""
    flat = _flatten(params)
    out: Dict[str, np.ndarray] = {}
    _put_stem(out, flat)
    return _with_layers(out, flat, "layers_")


def _put_stem(out, flat):
    """The class-conditional and Flag-DiT stems: the patch embedding, the
    timestep MLP, the label table or the caption embedder, the [eol] token
    and the final layer, whichever the tree holds."""
    _put_linear(out, flat, "x_embedder", "x_embedder")
    _put_linear(out, flat, "t_embedder.mlp.0", "t_embedder/mlp_0")
    _put_linear(out, flat, "t_embedder.mlp.2", "t_embedder/mlp_2")
    if "y_embedder/embedding" in flat:
        out["y_embedder.embedding_table.weight"] = flat["y_embedder/embedding"]
    if "cap_embedder/proj/kernel" in flat:
        out["cap_embedder.0.weight"] = flat["cap_embedder/norm/weight"]
        out["cap_embedder.0.bias"] = flat["cap_embedder/norm/bias"]
        _put_linear(out, flat, "cap_embedder.1", "cap_embedder/proj")
    if "eol_token" in flat:
        out["eol_token"] = flat["eol_token"]
    _put_linear(out, flat, "final_layer.linear", "final_layer/linear")
    _put_linear(out, flat, "final_layer.adaLN_modulation.1", "final_layer/adaLN_modulation")


def flag_dit_state_dict_from_jax_params(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax FlagDiT params (text or class-conditional; layers stacked under
    `layers/`, or per layer under `layers_<i>/`) -> the reference `DiT_Llama`
    state dict that the port's `FlagDiT` loads with `strict=True`: the
    inverse of the JAX package's `import_flag_dit_weights`."""
    flat = _flatten(params)
    out: Dict[str, np.ndarray] = {}
    _put_stem(out, flat)
    return _with_layers(out, flat, "layers_")


def moe_state_dict_from_jax_params(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax NextDiTMoE params (any mode; layers stacked under `layers/`, or
    per layer under `layers_<i>/`) -> the reference Next-DiT-MoE state dict
    that the port's `NextDiTMoE` loads with `strict=True`: each stacked
    (E, in, out) expert matrix becomes E `experts.<j>.w*.weight`s, the gate
    kernel `gate.weight`; the inverse of the JAX package's
    `import_next_dit_moe_weights`. (AdamW moments map the same way; the
    (1,) placeholders of Adafactor's factored stats do not.)"""
    flat = _flatten(params)
    out: Dict[str, np.ndarray] = {}
    _put_stem(out, flat)
    return _with_layers(out, flat, "layers_")


_VAE_RENAMES = ((r"down_(\d+)_block_(\d+)", r"down_blocks.\1.resnets.\2"),
                (r"down_(\d+)_downsample", r"down_blocks.\1.downsamplers.0"),
                (r"mid_block_1", "mid_block.resnets.0"), (r"mid_block_2", "mid_block.resnets.1"),
                (r"mid_attn_1", "mid_block.attentions.0"), (r"\.to_out$", ".to_out.0"),
                (r"\.norm_out$", ".conv_norm_out"))


def vae_state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX `AutoencoderKL` param tree -> the diffusers-layout state dict
    (the inverse of the JAX package's `import_autoencoder_kl_weights`): conv
    kernels (kh, kw, I, O) -> (O, I, kh, kw), attention Dense kernels ->
    2-D linear weights, GroupNorm `scale` -> `weight`; the decoder's
    `up_<i>_*` (encoder level i) -> `up_blocks.<levels - 1 - i>` (deepest
    first)."""
    flat = _flatten(params)
    levels = 1 + max(int(m.group(1)) for m in
                     map(re.compile(r"encoder/down_(\d+)_").match, flat) if m)
    up_block = lambda m: f"up_blocks.{levels - 1 - int(m.group(1))}"
    out = {}
    for key, arr in flat.items():
        module, leaf = key.rsplit("/", 1)
        name = module.replace("/", ".")
        name = re.sub(r"up_(\d+)_block_(\d+)", lambda m: f"{up_block(m)}.resnets.{m.group(2)}",
                      name)
        name = re.sub(r"up_(\d+)_upsample", lambda m: f"{up_block(m)}.upsamplers.0", name)
        for pattern, repl in _VAE_RENAMES:
            name = re.sub(pattern, repl, name)
        if leaf == "kernel":
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
        out[f"{name}.{'bias' if leaf == 'bias' else 'weight'}"] = arr
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in out.items()}


def gemma_state_dict_from_flax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A Flax Gemma parameter tree (`FlaxGemmaModel.params`: `embed_tokens/
    embedding`, `layers/<i>/{self_attn,mlp}/<proj>/kernel`,
    `layers/<i>/*_layernorm/weight`, `norm/weight`; numpy arrays) -> the
    state dict of transformers' torch `GemmaModel`: Dense kernels (in, out)
    transposed to (out, in), the embedding and the RMSNorm weights as they
    are (both stacks apply a norm as `1 + weight`)."""
    out = {}
    for key, arr in _flatten(params).items():
        module, leaf = key.rsplit("/", 1)
        name = module.replace("/", ".")
        if leaf == "kernel":
            arr = arr.T
        out[f"{name}.weight"] = arr
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def mmdit_state_dict_from_jax_params(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX MMDiT param tree -> the port's MMDiT state dict: `blocks_<i>`
    -> `blocks.<i>`, `t_embedder/mlp_<j>` -> `t_embedder.mlp.<j>`, Dense
    kernels transposed into weights, the qk-norm gains as they are."""
    out = {}
    for key, arr in _flatten(params).items():
        module, leaf = key.rsplit("/", 1)
        module = re.sub(r"(blocks|mlp)_(\d+)", r"\1.\2", module).replace("/", ".")
        if leaf == "kernel":
            out[f"{module}.weight"] = arr.T
        else:  # a bias, or a qk-norm gain (`blocks_<i>/x_q_norm`)
            out[f"{module}.{leaf}"] = arr
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in out.items()}


_CLIP_LAYER_PARTS = {"ln1": "layer_norm1", "ln2": "layer_norm2", "q": "self_attn.q_proj",
                     "k": "self_attn.k_proj", "v": "self_attn.v_proj",
                     "out": "self_attn.out_proj", "fc1": "mlp.fc1", "fc2": "mlp.fc2"}


def clip_text_state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX `CLIPTextTower` param tree -> the port's tower state dict (HF's
    `CLIPTextModelWithProjection` names): `layers_<i>_<part>` ->
    `text_model.encoder.layers.<i>.<HF part>`, LayerNorm `scale` ->
    `weight`, Dense kernels transposed, the embedding tables as they are."""
    out = {}
    for key, arr in _flatten(params).items():
        module, leaf = key.rsplit("/", 1) if "/" in key else (key, "")
        m = re.fullmatch(r"layers_(\d+)_(\w+)", module)
        if m:
            name = f"text_model.encoder.layers.{m.group(1)}.{_CLIP_LAYER_PARTS[m.group(2)]}"
        else:
            name = {"token_embedding": "text_model.embeddings.token_embedding",
                    "position_embedding": "text_model.embeddings.position_embedding",
                    "final_ln": "text_model.final_layer_norm",
                    "text_projection": "text_projection"}[module]
        if leaf == "kernel":
            arr = arr.T
        out[f"{name}.{'bias' if leaf == 'bias' else 'weight'}"] = arr
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in out.items()}


# -- the audio family ----------------------------------------------------------------


def flag_dit_1d_state_dict_from_jax_params(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax FlagDiT1D params (blocks stacked under `blocks/`, or per block
    under `blocks_<i>/`) -> the reference music/audio FlagDiT state dict that
    the port's `FlagDiT1D` loads with `strict=True`: the inverse of the JAX
    package's `import_flag_dit_1d_weights`."""
    flat = {("layers/" + k[len("blocks/"):] if k.startswith("blocks/") else k): v
            for k, v in _flatten(params).items()}
    out: Dict[str, np.ndarray] = {}
    _put_linear(out, flat, "proj_in", "proj_in")
    _put_linear(out, flat, "t_embedder.mlp.0", "t_embedder/mlp_0")
    _put_linear(out, flat, "t_embedder.mlp.2", "t_embedder/mlp_2")
    out["cap_embedder.0.weight"] = flat["cap_embedder_norm/weight"]
    out["cap_embedder.0.bias"] = flat["cap_embedder_norm/bias"]
    _put_linear(out, flat, "cap_embedder.1", "cap_embedder_proj")
    _put_linear(out, flat, "final_layer.adaLN_modulation.1", "final_adaLN_modulation")
    _put_linear(out, flat, "final_layer.linear", "final_linear")
    sd = _with_layers(out, flat, "blocks_")
    return {re.sub(r"^layers\.", "blocks.", k): v for k, v in sd.items()}


_FLAG_DIT_1D_KEYS = re.compile(r"(proj_in|t_embedder|cap_embedder|blocks|final_layer)\.")


def import_flag_dit_1d_weights(state_dict: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A reference music/audio FlagDiT state dict (`.pth` / `.safetensors`,
    tensors or numpy arrays) -> the port's `FlagDiT1D` state dict: the keys
    are the same, so this keeps the model's entries (dropping buffers such
    as the RoPE table) as CPU tensors; `load_state_dict(..., strict=True)`
    checks the architecture."""
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
            for k, v in state_dict.items() if _FLAG_DIT_1D_KEYS.match(k)}


_VAE1D_RENAMES = ((r"(down|up)_(\d+)_(block|attn)_(\d+)", r"\1.\2.\3.\4"),
                  (r"(down|up)_(\d+)_(downsample|upsample)", r"\1.\2.\3"),
                  (r"mid_(block_1|block_2|attn_1)", r"mid.\1"))


def vae1d_state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX `AutoencoderKL1D` or `VQModel1D` tree -> the reference
    (CompVis) layout of the port's `codecs/vae1d.py`: the inverse of the JAX
    package's `import_autoencoder_kl_1d_weights` /
    `import_vq_model_1d_weights`. Conv kernels (k, I, O) -> (O, I, k),
    GroupNorm `scale` -> `weight`, the VQ codebook -> `quantize.embedding.weight`."""
    out = {}
    for key, arr in _flatten(params).items():
        module, leaf = key.rsplit("/", 1)
        name = module.replace("/", ".")
        for pattern, repl in _VAE1D_RENAMES:
            name = re.sub(pattern, repl, name)
        if leaf == "kernel":
            arr = arr.transpose(2, 1, 0)
        elif leaf == "embedding":
            name, leaf = f"{name}.embedding", "weight"
        out[f"{name}.{'bias' if leaf == 'bias' else 'weight'}"] = arr
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in out.items()}


def bigvgan_state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX `BigVGAN` tree -> the port's `codecs/vocoder.BigVGAN` state dict
    (the reference generator's names after weight-norm removal): conv
    kernels (k, I, O) -> (O, I, k); the transposed convolutions' (k, I, O)
    kernels, which the JAX importer stored time-flipped, flipped back into
    torch's (I, O, k); `resblocks_<i>_<j>` -> `resblocks.<i * n_kernels + j>`
    with its `act1_<d>` / `act2_<d>` as `activations.<2d>` / `<2d + 1>`."""
    flat = _flatten(params)
    n_kernels = 1 + max(int(m.group(1)) for m in
                        map(re.compile(r"resblocks_\d+_(\d+)/").match, flat) if m)
    out = {}
    for key, arr in flat.items():
        module, leaf = key.rsplit("/", 1)
        m = re.match(r"resblocks_(\d+)_(\d+)/(convs[12])_(\d+)$", module)
        if m:
            name = (f"resblocks.{int(m.group(1)) * n_kernels + int(m.group(2))}."
                    f"{m.group(3)}.{m.group(4)}")
        elif (m := re.match(r"resblocks_(\d+)_(\d+)/act([12])_(\d+)/snake$", module)):
            act = 2 * int(m.group(4)) + int(m.group(3)) - 1
            name = (f"resblocks.{int(m.group(1)) * n_kernels + int(m.group(2))}."
                    f"activations.{act}.act")
        elif module == "activation_post/snake":
            name = "activation_post.act"
        elif (m := re.match(r"ups_(\d+)$", module)):
            name = f"ups.{m.group(1)}.0"
            if leaf == "kernel":
                arr = arr[::-1].transpose(1, 2, 0)
        else:
            name = module
        if leaf == "kernel" and arr.ndim == 3 and not name.startswith("ups."):
            arr = arr.transpose(2, 1, 0)
        out[f"{name}.{'weight' if leaf == 'kernel' else leaf}"] = arr
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in out.items()}


def _clap_tree_from_jax(tree: Dict[str, Any], parent: str = "") -> Dict[str, Any]:
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out[key] = _clap_tree_from_jax(value, key)
            continue
        arr = np.asarray(value, np.float32)
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        elif key == "kernel":
            key, arr = "weight", arr.T
        elif key == "scale" and parent == "layer_norm":
            key = "weight"
        out[key] = torch.from_numpy(np.array(arr))
    return out


def clap_projection_from_jax(params: Dict[str, Any]) -> Dict[str, Any]:
    """A JAX CLAP projection head (`{"linear1": {"kernel"}, "linear2":
    {"kernel"}, "layer_norm": {"scale", "bias"}}`, as `CLAPTextEncoder` and
    the audio tower hold it) -> the port's `clap_projection` parameters:
    (out, in) `weight`s, the LayerNorm's `weight` and `bias`, tensors."""
    return _clap_tree_from_jax(params)


def clap_audio_params_from_jax(params: Dict[str, Any]) -> Dict[str, Any]:
    """The JAX CLAP audio tower's parameter dict (`import_clap_audio_weights`:
    folded batch norms, HWIO conv kernels, (in, out) linear kernels) -> the
    port's (`codecs/clap_audio.py`): the same nesting with conv kernels as
    torch's OIHW and the linears and the projection as in
    `clap_projection_from_jax`; the front-end geometry and the logit scale
    as they are."""
    return {"cnn14": _clap_tree_from_jax(params["cnn14"]),
            "projection": clap_projection_from_jax(params["projection"]),
            "frontend": dict(params["frontend"]),
            **({"logit_scale": params["logit_scale"]} if "logit_scale" in params else {})}


def discriminator_state_dict_from_jax(params: Dict[str, Any],
                                      names: Sequence[str]) -> Dict[str, torch.Tensor]:
    """A JAX `MultiPeriodDiscriminator` or `MultiResolutionDiscriminator`
    tree (`{"params": {"p<period>" | "r<n_fft>": {"conv<j>" | "conv_post":
    {v, g, bias}}}}`) -> the reference state dict the port's discriminators
    load: `discriminators.<i>.convs.<j>.weight_v` (OI[H]W), `.weight_g`
    (O, 1[, 1], 1), `.bias`, where sub-discriminator i is `names[i]`
    (`p2`, `p3`, ... or `r1024`, `r2048`, `r512`)."""
    tree = params.get("params", params)
    out = {}
    for i, sub_name in enumerate(names):
        for conv, leaves in tree[sub_name].items():
            name = f"discriminators.{i}." + (
                "conv_post" if conv == "conv_post" else f"convs.{conv[len('conv'):]}")
            v = np.asarray(leaves["v"], np.float32)
            v = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.transpose(2, 1, 0)
            out[f"{name}.weight_v"] = v
            out[f"{name}.weight_g"] = np.asarray(leaves["g"], np.float32).reshape(
                (-1,) + (1,) * (v.ndim - 1))
            out[f"{name}.bias"] = np.asarray(leaves["bias"], np.float32)
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def train_state_from_jax(params, ema, opt_state, state_dict_fn=None):
    """A JAX train state (flax params, EMA tree, optax/fused optimizer state)
    -> (model state dict, EMA state dict, optimizer state) in the port's
    layouts, each tree mapped by `state_dict_fn` (default: the NextDiT's
    `state_dict_from_jax_params`; `imagenet_state_dict_from_jax_params`,
    `flag_dit_state_dict_from_jax_params` or `moe_state_dict_from_jax_params`
    for the other families). The optimizer state may hold AdamW's
    `mu`/`nu`/`count` (optax chain or `FusedAdamWEMA`, plus a schedule count
    under warmup) or
    Adafactor's factored stats (`FusedAdafactorEMA`). Adafactor's row/column
    roles swap for square weights: the JAX rule factors the (in, out) kernel
    and the port the (out, in) weight, and a stable argsort breaks the tie
    on opposite axes."""
    to_sd = state_dict_fn or state_dict_from_jax_params
    state = {}
    parts = (list(opt_state) if isinstance(opt_state, tuple) and not hasattr(opt_state, "_fields")
             else [opt_state])
    count = lambda c: torch.tensor(np.asarray(c), dtype=torch.int32)
    n_layers = _flatten(params)["layers/adaLN_modulation/kernel"].shape[0] \
        if "layers" in params else None
    for part in parts:
        if hasattr(part, "mu"):
            state["count"] = count(part.count)
            state["mu"] = to_sd(part.mu)
            state["nu"] = to_sd(part.nu)
        elif hasattr(part, "v_row"):
            state["count"] = count(part.count)
            for slot in ("v_row", "v_col", "v"):
                state[slot] = to_sd(_unstackable(getattr(part, slot), n_layers))
            for name, w in to_sd(params).items():
                if w.dim() == 2 and w.shape[0] == w.shape[1] and state["v_row"][name].shape != (1,):
                    state["v_row"][name], state["v_col"][name] = (state["v_col"][name],
                                                                  state["v_row"][name])
        elif "count" in getattr(part, "_fields", ()):  # optax's ScaleByScheduleState
            state["schedule_count"] = count(part.count)
    return to_sd(params), to_sd(ema), state


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


# -- reference state dicts: .pth and .safetensors -------------------------------------

_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}
_SAFETENSORS_NAMES = {dtype: name for name, dtype in _SAFETENSORS_DTYPES.items()}


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Read a `.safetensors` file into CPU tensors of their stored dtypes."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 8:
        raise ValueError(f"{path}: not a safetensors file (shorter than its header length)")
    (n,) = struct.unpack("<Q", data[:8])
    if 8 + n > len(data):
        raise ValueError(f"{path}: header length {n} runs past the end of the file")
    header = json.loads(data[8:8 + n])
    buf = memoryview(data)[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {info['dtype']}")
        dtype = _SAFETENSORS_DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        count = int(np.prod(shape, dtype=np.int64))
        if end - begin != count * torch.empty((), dtype=dtype).element_size() or end > len(buf):
            raise ValueError(f"{path}: tensor {name!r} has inconsistent data offsets")
        flat = (torch.frombuffer(bytearray(buf[begin:end]), dtype=dtype) if count
                else torch.empty(0, dtype=dtype))
        out[name] = flat.reshape(shape)
    return out


def save_safetensors(state_dict: Dict[str, torch.Tensor], path: str):
    """Write a state dict of tensors (or numpy arrays) as `.safetensors`:
    tensors in name order, the header padded with spaces to 8 bytes."""
    header, blobs, offset = {"__metadata__": {"format": "pt"}}, [], 0
    for name in sorted(state_dict):
        t = torch.as_tensor(state_dict[name]).detach().cpu().contiguous()
        if t.dtype not in _SAFETENSORS_NAMES:
            raise ValueError(f"tensor {name!r}: dtype {t.dtype} has no safetensors name")
        blob = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": _SAFETENSORS_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for blob in blobs:
            f.write(blob)


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A reference checkpoint (`.safetensors`, or a `.pth` torch file, whose
    `state_dict` entry is taken when it has one) as CPU tensors of their
    stored dtypes (`load_state_dict` casts them to the model's)."""
    if path.endswith(".safetensors"):
        return load_safetensors(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return dict(sd)


def save_weights(path: str, state_dict: Dict[str, torch.Tensor], model_args: Dict,
                 stream: str = "ema") -> str:
    """Write a weights-only checkpoint directory: `<path>/<stream>/state_dict.pt`
    and `<path>/model_args.json`, which `init_from` and the sampler's
    `--ckpt` read."""
    path = os.path.abspath(path)
    os.makedirs(os.path.join(path, stream), exist_ok=True)
    torch.save({k: torch.as_tensor(v) for k, v in state_dict.items()},
               os.path.join(path, stream, _STREAM_FILE))
    with open(os.path.join(path, "model_args.json"), "w") as f:
        json.dump(model_args, f, indent=2, default=str)
    return path


# -- trainer checkpoints ---------------------------------------------------------------


def checkpoint_dir(results_dir: str, step: int) -> str:
    return os.path.join(results_dir, "checkpoints", f"{step:07d}")


def full_tree(tree, keep: bool = True, copy: bool = False):
    """A (nested dict of) tensors with every DTensor gathered whole, one at
    a time, and moved to the CPU at once: the device holds one gathered
    tensor at a time. A collective: every rank calls it in the same order;
    where `keep` is false (the ranks that do not write) the gathered tensors
    are dropped and None takes their place. `copy`: every tensor comes back
    as a CPU copy of its own, a snapshot that later in-place updates of the
    live state (the optimizer step) do not reach."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {k: full_tree(v, keep, copy) for k, v in tree.items()}
    if not keep:
        if isinstance(tree, DTensor):
            tree.full_tensor()
        return None
    if isinstance(tree, DTensor):
        tree = tree.full_tensor()
        return tree.to("cpu", copy=True) if copy else tree.cpu()
    if copy and isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def _is_lead() -> bool:
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _streams(state):
    """The three streams of a train state, each read when called."""
    return {"model": lambda: state.model.state_dict(), "ema": lambda: state.ema,
            "optimizer": lambda: state.opt_state}


def _write_stream(path: str, stream: str, tree) -> None:
    os.makedirs(os.path.join(path, stream), exist_ok=True)
    torch.save(tree, os.path.join(path, stream, _STREAM_FILE))


def _write_markers(path: str, step: int, model_args: Optional[Dict]) -> None:
    """`model_args.json`, then `resume_step.txt`: the completion marker."""
    if model_args is not None:
        with open(os.path.join(path, "model_args.json"), "w") as f:
            json.dump(model_args, f, indent=2, default=str)
    with open(os.path.join(path, "resume_step.txt"), "w") as f:
        f.write(str(step))


def save_checkpoint(results_dir: str, step: int, state, model_args: Optional[Dict] = None,
                    keep_last: int = 0) -> str:
    """Save model/EMA/optimizer + model_args + resume_step (written last).
    `keep_last` > 0 then prunes older complete checkpoints beyond the newest
    `keep_last`. A state sharded over several ranks (DTensors) is gathered
    whole one tensor at a time onto rank 0's CPU (`full_tree`), one stream
    at a time, and rank 0 writes it, in the one-process layout, so the
    checkpoint restores at any world size; every rank calls this."""
    import torch.distributed as dist

    path = os.path.abspath(checkpoint_dir(results_dir, step))
    lead = _is_lead()
    for stream, payload in _streams(state).items():
        full = full_tree(payload(), keep=lead)
        if lead:
            _write_stream(path, stream, full)
        del full
    if lead:
        _write_markers(path, step, model_args)
        prune_checkpoints(results_dir, keep_last)
    if dist.is_initialized():
        dist.barrier()
    return path


class AsyncCheckpointSaver:
    """`save_checkpoint` whose file writes overlap the next train steps
    (counterpart of JAX's `AsyncCheckpointSaver`; the trainers' `--async_save`).

    `save` first finalizes any pending save (`wait`), then takes a host copy
    of the model, EMA and optimizer streams before it returns: the optimizer
    updates the parameters in place, so a writer that read the live tensors
    later would mix two steps. Under a mesh the DTensors are gathered by
    `full_tree` in the calling thread, on every rank in the same order (its
    collectives stay out of the thread). Rank 0 then serializes the copy on
    a background thread, to the same files `save_checkpoint` writes.

    `model_args.json` and `resume_step.txt`, the completion marker
    `find_auto_resume` keys on, are written only by `wait()`, once the
    writer has finished, so a save in flight is never resumed from; then
    `keep_last` prunes complete checkpoints only. An exception in the writer
    is raised again by `wait()` / `close()` (and so by the next `save`).

        saver = AsyncCheckpointSaver(keep_last=2)
        saver.save(results_dir, step, state, model_args)   # returns after the copy
        ... more train steps ...
        saver.save(results_dir, step2, state, model_args)  # finishes the first save
        saver.close()                                      # finishes the last one
    """

    def __init__(self, keep_last: int = 0):
        self.keep_last = keep_last
        self._pending: Optional[tuple] = None

    def save(self, results_dir: str, step: int, state,
             model_args: Optional[Dict] = None) -> str:
        """Finalize the pending save, copy the state to the host and start
        writing it; returns the checkpoint path."""
        self.wait()
        path = os.path.abspath(checkpoint_dir(results_dir, step))
        lead = _is_lead()
        snapshot = {stream: full_tree(payload(), keep=lead, copy=True)
                    for stream, payload in _streams(state).items()}
        if lead:
            errors: list = []

            def write():
                try:
                    for stream, tree in snapshot.items():
                        _write_stream(path, stream, tree)
                except Exception as e:  # raised again by wait()
                    errors.append(e)

            writer = threading.Thread(target=write, name=f"checkpoint-{step}")
            writer.start()
            self._pending = (writer, errors, path, step, model_args)
        return path

    def wait(self) -> Optional[str]:
        """Block until the pending save's files are written, then write its
        markers and prune. Returns its path; None when no save is pending."""
        if self._pending is None:
            return None
        writer, errors, path, step, model_args = self._pending
        self._pending = None
        writer.join()
        if errors:
            raise errors[0]
        _write_markers(path, step, model_args)
        prune_checkpoints(os.path.dirname(os.path.dirname(path)), self.keep_last)
        return path

    def close(self) -> Optional[str]:
        """`wait()`, then a barrier when several ranks run: every rank
        returns once rank 0's last checkpoint is complete."""
        import torch.distributed as dist

        path = self.wait()
        if dist.is_initialized():
            dist.barrier()
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


def load_stream(path: str, stream: str):
    """One stream (`model`, `ema`, `optimizer`) of a checkpoint directory, on
    the CPU."""
    return torch.load(os.path.join(os.path.abspath(path), stream, _STREAM_FILE),
                      map_location="cpu", mmap=True, weights_only=True)


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
        state.model.load_state_dict(load_stream(path, "model"), strict=True)
        _copy_into(state.ema, load_stream(path, "ema"), "ema")
        _copy_into(state.opt_state, load_stream(path, "optimizer"), "optimizer")
    with open(os.path.join(path, "resume_step.txt")) as f:
        state.step = int(f.read().strip())
    return state


def broadcast_state(state) -> None:
    """Rank 0's whole train state (model, EMA, optimizer, step) to every
    rank, in place, before the state is sharded: the restore of a
    checkpoint that rank 0 alone has read. No-op on one rank."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    device = next(state.model.parameters()).device

    def tensors(tree, prefix=""):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from tensors(tree[k], f"{prefix}/{k}")
        elif isinstance(tree, torch.Tensor):
            yield prefix, tree

    trees = {"model": dict(state.model.state_dict()), "ema": state.ema,
             "optimizer": state.opt_state}
    with torch.no_grad():
        for _, t in tensors(trees):
            buf = t.detach().to(device)
            dist.broadcast(buf, src=0)
            t.copy_(buf)
    step = torch.tensor([state.step], dtype=torch.int64, device=device)
    dist.broadcast(step, src=0)
    state.step = int(step.item())


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
    loaded = load_stream(path, stream)
    current = model.state_dict()
    keep = {k: v for k, v in loaded.items() if k in current and current[k].shape == v.shape}
    dropped = [k for k in loaded if k in current and k not in keep]
    if dropped:
        print(f"init_from: dropped {len(dropped)} shape-mismatched keys: {dropped[:8]}...")
    model.load_state_dict(keep, strict=False)
    return keep

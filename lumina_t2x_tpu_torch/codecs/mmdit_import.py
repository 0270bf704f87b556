"""Weight importer: a diffusers `SD3Transformer2DModel` state dict -> the
port's MMDiT state dict (counterpart of `lumina_t2x_tpu/codecs/mmdit_import.py`).

diffusers' names (`pos_embed.proj`, `time_text_embed.*`, `context_embedder`,
`transformer_blocks.N.{norm1,norm1_context}.linear`, `attn.{to_q,to_k,to_v,
add_q_proj,add_k_proj,add_v_proj,norm_q,norm_k,norm_added_q,norm_added_k,
to_out.0,to_add_out}`, `ff.net.{0.proj,2}`, `ff_context.net.*`,
`norm_out.linear`, `proj_out`) map onto `models/mmdit.py`'s:

- the patch embedding is a Conv2d(p, stride p), which is a linear map on
  each flattened (C, ph, pw) patch: its (O, C, p, p) kernel reshapes to the
  (O, C*p*p) weight of `x_embedder`;
- the 6-chunk AdaLayerNormZero emits (shift, scale, gate) x 2 in the order
  the blocks split, so it copies as it is; the 2-chunk
  AdaLayerNormContinuous heads (`norm_out`, and the context-pre-only
  block's `norm1_context`) pack (scale, shift) where the port splits
  (shift, scale), so their output halves are swapped (`_swap_scale_shift`);
- the persistent `pos_embed.pos_embed` buffer, when present, is checked
  against the recomputed table rounded to the buffer's dtype (within one
  unit of it, 1e-4 at least), so a convention drift fails at import;
- the architecture is read off the file (`architecture`): widths, depth,
  the position table's size, and `qk_norm` (SD3-medium's release has no
  `norm_q`/`norm_k`, SD3.5's has them).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def architecture(sd: Dict, head_dim: int = 64) -> Dict:
    """`MMDiT`'s arguments read off a diffusers SD3 state dict: the patch
    embedding gives dim, channels and patch, the embedders the context and
    pooled widths, the block keys the depth, `norm_q` qk-norm and the head
    width (else `head_dim`, SD3's 64), the position buffer the table size
    (else SD3's 192); the base size is a third of it, SD3's ratio (the
    import checks the buffer against it)."""
    dim, in_channels, patch = (int(n) for n in sd["pos_embed.proj.weight"].shape[:3])
    qk = sd.get("transformer_blocks.0.attn.norm_q.weight")
    max_size = 192
    if "pos_embed.pos_embed" in sd:
        max_size = int(round(sd["pos_embed.pos_embed"].shape[1] ** 0.5))
    return dict(
        patch_size=patch, in_channels=in_channels, dim=dim,
        n_layers=1 + max(int(k.split(".")[1]) for k in sd if k.startswith("transformer_blocks.")),
        n_heads=dim // (int(qk.shape[0]) if qk is not None else head_dim),
        context_dim=int(sd["context_embedder.weight"].shape[1]),
        pooled_dim=int(sd["time_text_embed.text_embedder.linear_1.weight"].shape[1]),
        out_channels=int(sd["proj_out.weight"].shape[0]) // (patch * patch),
        qk_norm=qk is not None, pos_embed_max_size=max_size, pos_embed_base_size=max_size // 3)


def _f32(x) -> torch.Tensor:
    """An fp32 CPU tensor that owns its memory, from a tensor or an array."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32, copy=True)
    return torch.from_numpy(np.array(x, np.float32))


def _lin(sd, name):
    out = {"weight": _f32(sd[f"{name}.weight"])}
    if f"{name}.bias" in sd:
        out["bias"] = _f32(sd[f"{name}.bias"])
    return out


def _swap_scale_shift(lin: Dict) -> Dict:
    """(scale, shift) packed along the output dim -> (shift, scale)."""
    return {k: torch.cat(v.chunk(2, dim=0)[::-1], dim=0) for k, v in lin.items()}


def import_sd3_mmdit_weights(sd: Dict, n_layers: int, pos_embed_max_size: int = 192,
                             pos_embed_base_size: int = 64) -> Dict[str, torch.Tensor]:
    """diffusers SD3Transformer2DModel state dict (tensors or arrays) ->
    the port's MMDiT state dict of fp32 CPU tensors."""
    from ..models.mmdit import sincos_pos_embed_2d

    if "pos_embed.pos_embed" in sd:
        stored = torch.as_tensor(sd["pos_embed.pos_embed"])
        buf = _f32(stored).reshape(pos_embed_max_size ** 2, -1)
        ours = sincos_pos_embed_2d(buf.shape[-1], pos_embed_max_size, pos_embed_max_size,
                                   max_size=pos_embed_max_size, base_size=pos_embed_base_size)
        # held in the buffer's own precision: release files store it in fp16
        err = float((buf - ours.to(stored.dtype).float()).abs().max())
        if err > max(1e-4, torch.finfo(stored.dtype).eps):
            raise ValueError(
                f"checkpoint pos_embed buffer deviates from the computed sincos table (max abs "
                f"err {err:.2e}): positional-embedding convention mismatch; check "
                f"pos_embed_max_size/base_size ({pos_embed_max_size}/{pos_embed_base_size})")

    out: Dict[str, torch.Tensor] = {}

    def put(name, lin):
        for leaf, value in lin.items():
            out[f"{name}.{leaf}"] = value

    w = _f32(sd["pos_embed.proj.weight"])
    put("x_embedder", {"weight": w.reshape(w.shape[0], -1),
                       "bias": _f32(sd["pos_embed.proj.bias"])})
    put("context_embedder", _lin(sd, "context_embedder"))
    put("t_embedder.mlp.0", _lin(sd, "time_text_embed.timestep_embedder.linear_1"))
    put("t_embedder.mlp.2", _lin(sd, "time_text_embed.timestep_embedder.linear_2"))
    put("pooled_hidden", _lin(sd, "time_text_embed.text_embedder.linear_1"))
    put("pooled_in", _lin(sd, "time_text_embed.text_embedder.linear_2"))
    put("final_adaLN", _swap_scale_shift(_lin(sd, "norm_out.linear")))
    put("final_linear", _lin(sd, "proj_out"))

    for i in range(n_layers):
        pre, blk = f"transformer_blocks.{i}", f"blocks.{i}"
        pre_only = f"{pre}.attn.to_add_out.weight" not in sd  # the last block
        c_ada = _lin(sd, f"{pre}.norm1_context.linear")
        put(f"{blk}.x_adaLN", _lin(sd, f"{pre}.norm1.linear"))
        put(f"{blk}.c_adaLN", _swap_scale_shift(c_ada) if pre_only else c_ada)
        for dst, src in (("x_q", "to_q"), ("x_k", "to_k"), ("x_v", "to_v"),
                         ("c_q", "add_q_proj"), ("c_k", "add_k_proj"), ("c_v", "add_v_proj"),
                         ("x_proj", "to_out.0")):
            put(f"{blk}.{dst}", _lin(sd, f"{pre}.attn.{src}"))
        put(f"{blk}.x_mlp_in", _lin(sd, f"{pre}.ff.net.0.proj"))
        put(f"{blk}.x_mlp_out", _lin(sd, f"{pre}.ff.net.2"))
        for src, dst in (("norm_q", "x_q_norm"), ("norm_k", "x_k_norm"),
                         ("norm_added_q", "c_q_norm"), ("norm_added_k", "c_k_norm")):
            if f"{pre}.attn.{src}.weight" in sd:
                out[f"{blk}.{dst}"] = _f32(sd[f"{pre}.attn.{src}.weight"])
        if not pre_only:
            put(f"{blk}.c_proj", _lin(sd, f"{pre}.attn.to_add_out"))
            put(f"{blk}.c_mlp_in", _lin(sd, f"{pre}.ff_context.net.0.proj"))
            put(f"{blk}.c_mlp_out", _lin(sd, f"{pre}.ff_context.net.2"))
    return out


def load_sd3_mmdit(path: str, dtype=torch.float32, param_dtype=torch.float32, device=None,
                   head_dim: int = 64):
    """An `MMDiT` holding a diffusers-format transformer file (`.safetensors`
    or `.pth`), its architecture read off the file (`architecture`); every
    parameter must load."""
    from ..core.checkpoint import load_torch_state_dict
    from ..models.mmdit import MMDiT

    sd = load_torch_state_dict(path)
    arch = architecture(sd, head_dim)
    state = import_sd3_mmdit_weights(sd, arch["n_layers"], arch["pos_embed_max_size"],
                                     arch["pos_embed_base_size"])
    del sd
    model = MMDiT(**arch, dtype=dtype, param_dtype=param_dtype, device=device)
    model.load_state_dict(state, strict=True)
    return model

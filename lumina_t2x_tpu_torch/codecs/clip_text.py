"""CLIP text towers (L and G) and the SD3 triple prompt encoder (counterpart
of `lumina_t2x_tpu/codecs/clip_text.py`).

SD3 conditions on diffusers' `StableDiffusion3Pipeline.encode_prompt`:
CLIP-L's and CLIP-G's penultimate hidden states concatenated on the feature
dim, zero-padded to the T5 width and stacked with the T5 sequence (zeros of
the same shape when no T5 is mounted, as diffusers does), and the pooled
pair, the two projected EOS embeddings side by side.

`CLIPTextTower` is HF's `CLIPTextModelWithProjection` in plain torch, with
its parameter names (so a transformers state dict loads as it is): causal
mask only, pre-LN blocks, quick_gelu or gelu, EOS pooling (argmax of the
ids under the legacy `eos_token_id` 2, else the first explicit EOS), a
projection without bias. Its attention is causal and 77 tokens long, and
runs as a plain einsum with fp32 logits, as in JAX: no kernel of the repo
computes a causal mask.
"""

from __future__ import annotations

import json
import os
from types import SimpleNamespace
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import LayerNorm, Linear
from ..utils import stable_text_seed

# the published config subsets of the two SD3 towers
# (openai/clip-vit-large-patch14, laion/CLIP-ViT-bigG-14; both ship
# eos_token_id=2, which selects argmax pooling)
CLIP_L_CONFIG = dict(hidden=768, n_layers=12, n_heads=12, intermediate=3072,
                     projection_dim=768, hidden_act="quick_gelu")
CLIP_G_CONFIG = dict(hidden=1280, n_layers=32, n_heads=20, intermediate=5120,
                     projection_dim=1280, hidden_act="gelu")


def _act(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return lambda x: F.gelu(x)
    if name in ("gelu_new", "gelu_pytorch_tanh"):
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(f"unsupported CLIP hidden_act: {name}")


def _lin(i, o, bias=True, device=None):
    return Linear(i, o, bias=bias, device=device)


class _Attention(nn.Module):
    def __init__(self, hidden, device=None):
        super().__init__()
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, name, _lin(hidden, hidden, device=device))


class _MLP(nn.Module):
    def __init__(self, hidden, intermediate, device=None):
        super().__init__()
        self.fc1 = _lin(hidden, intermediate, device=device)
        self.fc2 = _lin(intermediate, hidden, device=device)


class _Layer(nn.Module):
    def __init__(self, hidden, intermediate, eps, device=None):
        super().__init__()
        self.layer_norm1 = LayerNorm(hidden, eps=eps, device=device)
        self.self_attn = _Attention(hidden, device)
        self.layer_norm2 = LayerNorm(hidden, eps=eps, device=device)
        self.mlp = _MLP(hidden, intermediate, device)


class _Embeddings(nn.Module):
    def __init__(self, vocab_size, hidden, max_positions, device=None):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, hidden, device=device)
        self.position_embedding = nn.Embedding(max_positions, hidden, device=device)


class _Encoder(nn.Module):
    def __init__(self, n_layers, hidden, intermediate, eps, device=None):
        super().__init__()
        self.layers = nn.ModuleList([_Layer(hidden, intermediate, eps, device)
                                     for _ in range(n_layers)])


class _TextModel(nn.Module):
    def __init__(self, vocab_size, hidden, n_layers, intermediate, max_positions, eps,
                 device=None):
        super().__init__()
        self.embeddings = _Embeddings(vocab_size, hidden, max_positions, device)
        self.encoder = _Encoder(n_layers, hidden, intermediate, eps, device)
        self.final_layer_norm = LayerNorm(hidden, eps=eps, device=device)


class CLIPTextTower(nn.Module):
    """HF `CLIPTextModelWithProjection` over token ids, parameters in fp32,
    activations in `dtype`. `forward(input_ids) -> dict`:
      - `penultimate`: hidden_states[-2], the input of the last block (what
        SD3 conditions on);
      - `last_hidden`: final_layer_norm(last block output);
      - `pooled`: `last_hidden` at the EOS position;
      - `projected`: `text_projection(pooled)`, SD3's pooled feature."""

    def __init__(self, vocab_size: int = 49408, hidden: int = 768, n_layers: int = 12,
                 n_heads: int = 12, intermediate: int = 3072, max_positions: int = 77,
                 projection_dim: int = 768, hidden_act: str = "quick_gelu",
                 eos_token_id: int = 2, layer_norm_eps: float = 1e-5, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.vocab_size, self.hidden, self.n_layers, self.n_heads = (vocab_size, hidden,
                                                                     n_layers, n_heads)
        self.eos_token_id, self.dtype = eos_token_id, dtype
        self.hidden_act, self.act = hidden_act, _act(hidden_act)
        self.text_model = _TextModel(vocab_size, hidden, n_layers, intermediate, max_positions,
                                     layer_norm_eps, device)
        self.text_projection = _lin(hidden, projection_dim, bias=False, device=device)

    @torch.no_grad()
    def forward(self, input_ids) -> Dict[str, torch.Tensor]:
        tm = self.text_model
        ids = torch.as_tensor(input_ids).to(tm.embeddings.token_embedding.weight.device).long()
        b, length = ids.shape
        dt = self.dtype
        x = (tm.embeddings.token_embedding(ids).to(dt)
             + tm.embeddings.position_embedding.weight[None, :length].to(dt))
        causal = torch.ones((length, length), dtype=torch.bool, device=ids.device).tril()
        head_dim = self.hidden // self.n_heads
        scale = head_dim ** -0.5
        penultimate = x
        for layer in tm.encoder.layers:
            penultimate = x  # hidden_states[-2] is the input of the last block
            h = layer.layer_norm1(x)
            attn = layer.self_attn
            q, k, v = (proj(h).reshape(b, length, self.n_heads, head_dim)
                       for proj in (attn.q_proj, attn.k_proj, attn.v_proj))
            logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
            logits = logits.masked_fill(~causal, torch.finfo(torch.float32).min)
            probs = torch.softmax(logits, dim=-1).to(dt)
            out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, length, self.hidden)
            x = x + attn.out_proj(out)
            x = x + layer.mlp.fc2(self.act(layer.mlp.fc1(layer.layer_norm2(x))))
        last_hidden = tm.final_layer_norm(x)
        if self.eos_token_id == 2:
            pool_idx = ids.argmax(dim=-1)
        else:
            pool_idx = (ids == self.eos_token_id).int().argmax(dim=-1)
        pooled = last_hidden[torch.arange(b, device=ids.device), pool_idx]
        return {"penultimate": penultimate, "last_hidden": last_hidden, "pooled": pooled,
                "projected": self.text_projection(pooled)}


def import_clip_text_weights(sd: Dict) -> Dict[str, torch.Tensor]:
    """An HF `CLIPTextModelWithProjection` state dict (or diffusers'
    `text_encoder`/`text_encoder_2` export, the same names) -> the tower's,
    fp32: the names are HF's, so only the position-id buffer is dropped."""
    return {k: torch.as_tensor(v).float() for k, v in sd.items()
            if k != "text_model.embeddings.position_ids"}


def load_clip_text_tower(path: str, dtype=torch.float32, device=None):
    """(tower, tokenizer) from a local HF model directory (config.json,
    model.safetensors or pytorch_model.bin, tokenizer files): the layout of
    SD3's `text_encoder` and `text_encoder_2` subfolders. The tokenizer is
    None when the directory has no tokenizer files (the caller then passes
    ids)."""
    from ..core.checkpoint import load_torch_state_dict

    with open(os.path.join(path, "config.json")) as f:
        cfg = json.load(f)
    tower = CLIPTextTower(
        vocab_size=cfg["vocab_size"], hidden=cfg["hidden_size"],
        n_layers=cfg["num_hidden_layers"], n_heads=cfg["num_attention_heads"],
        intermediate=cfg["intermediate_size"], max_positions=cfg["max_position_embeddings"],
        projection_dim=cfg.get("projection_dim", cfg["hidden_size"]),
        hidden_act=cfg.get("hidden_act", "quick_gelu"), eos_token_id=cfg.get("eos_token_id", 2),
        layer_norm_eps=cfg.get("layer_norm_eps", 1e-5), dtype=dtype, device=device)
    for cand in ("model.safetensors", "pytorch_model.bin", "model.fp16.safetensors"):
        fp = os.path.join(path, cand)
        if os.path.exists(fp):
            tower.load_state_dict(import_clip_text_weights(load_torch_state_dict(fp)),
                                  strict=True)
            break
    else:
        raise FileNotFoundError(f"no model weights found under {path}")
    tokenizer = None
    if any(os.path.exists(os.path.join(path, f)) for f in ("vocab.json", "tokenizer.json")):
        from transformers import CLIPTokenizer

        tokenizer = CLIPTokenizer.from_pretrained(path, local_files_only=True)
    return tower.eval(), tokenizer


class DebugHashTokenizer:
    """Deterministic prompt -> ids stand-in where no tokenizer files exist:
    CLIP-shaped output, BOS, one hashed id per word, then EOS (= vocab - 1,
    the largest id) padding, so the towers, the causal attention and the
    argmax EOS pooling all run on prompt-sensitive ids. The same in every
    process (`utils.stable_text_seed`)."""

    def __init__(self, vocab_size: int = 49408, max_length: int = 77):
        self.vocab_size, self.max_length = vocab_size, max_length

    def __call__(self, texts: Sequence[str], padding="max_length",
                 max_length: Optional[int] = None, truncation: bool = True,
                 return_tensors: str = "np"):
        length = max_length or self.max_length
        eos, bos = self.vocab_size - 1, self.vocab_size - 2
        ids = np.full((len(texts), length), eos, np.int32)
        for i, text in enumerate(texts):
            ids[i, 0] = bos
            for j, w in enumerate(text.split()[: length - 2]):
                ids[i, 1 + j] = 1 + stable_text_seed(w) % (self.vocab_size - 3)
        return SimpleNamespace(input_ids=ids)


class SD3PromptEncoder:
    """diffusers' `StableDiffusion3Pipeline.encode_prompt`:
      clip   = concat([CLIP_L.hidden[-2], CLIP_G.hidden[-2]], -1)
      clip   = zero-pad the last dim to the T5 width (joint_dim)
      seq    = concat([clip, T5.last_hidden or zeros (B, t5_max_len, joint_dim)], -2)
      pooled = concat([CLIP_L.projected, CLIP_G.projected], -1)
    Outputs lie on the towers' device, in their dtype."""

    def __init__(self, clip_l: CLIPTextTower, tokenizer_l, clip_g: CLIPTextTower, tokenizer_g,
                 t5_encoder=None, t5_max_len: int = 256, joint_dim: int = 4096,
                 clip_max_len: int = 77):
        self.clip_l, self.clip_g = clip_l, clip_g
        self.tok_l, self.tok_g = tokenizer_l, tokenizer_g
        self.t5 = t5_encoder
        self.t5_max_len, self.joint_dim, self.clip_max_len = t5_max_len, joint_dim, clip_max_len

    def _tokenize(self, tok, prompts: Sequence[str]) -> np.ndarray:
        return tok(list(prompts), padding="max_length", max_length=self.clip_max_len,
                   truncation=True, return_tensors="np").input_ids

    @torch.no_grad()
    def encode(self, prompts: Sequence[str], ids_l=None, ids_g=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (prompt_embeds (B, clip_max_len + t5_len, joint_dim), pooled
        (B, proj_l + proj_g))."""
        out_l = self.clip_l(self._tokenize(self.tok_l, prompts) if ids_l is None else ids_l)
        out_g = self.clip_g(self._tokenize(self.tok_g, prompts) if ids_g is None else ids_g)
        clip = torch.cat([out_l["penultimate"], out_g["penultimate"]], dim=-1)
        pooled = torch.cat([out_l["projected"], out_g["projected"]], dim=-1)
        if self.t5 is not None:
            t5_embeds = self.t5.encode(list(prompts))[0].to(clip.device, clip.dtype)
        else:
            t5_embeds = torch.zeros((clip.shape[0], self.t5_max_len, self.joint_dim),
                                    dtype=clip.dtype, device=clip.device)
        pad = t5_embeds.shape[-1] - clip.shape[-1]
        if pad < 0:
            raise ValueError("T5 width below CLIP concat width")
        return torch.cat([F.pad(clip, (0, pad)), t5_embeds], dim=-2), pooled

    def encode_cfg_pair(self, prompt: str, negative: str = ""):
        """The SD3 sampler's [uncond; cond] pair."""
        return self.encode([negative, prompt])


def build_sd3_prompt_encoder(clip_l: Optional[str] = None, clip_g: Optional[str] = None,
                             t5: Optional[str] = None, debug: bool = False,
                             dtype=torch.float32, device=None) -> SD3PromptEncoder:
    """The SD3 triple encoder for the pipelines: with both CLIP directories
    and not `debug`, the towers with their weights (and T5 when given);
    otherwise the same encoder over tiny random towers (hidden 64, 2
    layers, projection 1024 each, so the pooled pair is the real 2048;
    seeds 0 and 1) and the hash tokenizer."""
    if clip_l and clip_g and not debug:
        tower_l, tok_l = load_clip_text_tower(clip_l, dtype=dtype, device=device)
        tower_g, tok_g = load_clip_text_tower(clip_g, dtype=dtype, device=device)
        t5_enc = None
        if t5:
            from .text_encoders import T5TextEncoder

            t5_enc = T5TextEncoder.from_pretrained(t5, dtype=dtype, max_length=256,
                                                   device=device)
        return SD3PromptEncoder(tower_l, tok_l, tower_g, tok_g, t5_encoder=t5_enc)

    def tiny(seed, act):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            tower = CLIPTextTower(hidden=64, n_layers=2, n_heads=4, intermediate=128,
                                  projection_dim=1024, hidden_act=act, dtype=dtype)
        return tower.to(device).eval()

    tok = DebugHashTokenizer()
    return SD3PromptEncoder(tiny(0, "quick_gelu"), tok, tiny(1, "gelu"), tok, t5_encoder=None)

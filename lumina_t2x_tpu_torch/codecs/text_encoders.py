"""Frozen caption encoder (counterpart of `lumina_t2x_tpu/codecs/text_encoders.py`'s
`DecoderTextEncoder`, `tokenize_prompts` and `apply_empty_prompt_dropout`).

- caption features = `hidden_states[-2]` (the output of decoder layer L-2)
  of a decoder-only LM (Gemma-2B for NextDiT), through transformers' torch
  `AutoModel`, in the run's dtype on an explicit device;
- tokenization: right padding, pad to a multiple of 8, `max_length` 256,
  truncation;
- caption dropout replaces captions with "" before encoding (CFG training);
  its draws come from an explicit `random.Random`, in the JAX function's
  order (one `random()` per caption, one `choice` per list caption).

`T5TextEncoder` is the T5 encoder's `last_hidden_state` over `max_length`
padding (the SD3 prompt encoder's third tower and FLAN-T5 for music), on
transformers' torch `T5EncoderModel`. `CLAPTextEncoder` is CLAP's caption
tower: a transformers torch text model (BERT) followed by CLAP's projection
head (`clap_projection`), per token for conditioning (`encode`) and on the
CLS token, L2-normalised, for scoring (`embed`).
`char_tokenizer` builds an in-memory character-level tokenizer for runs
with random LM weights and no tokenizer files, `BertHashTokenizer` a
BERT-shaped hashing one.
"""

from __future__ import annotations

import random
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def apply_empty_prompt_dropout(prompts: Sequence, proportion_empty_prompts: float,
                               is_train: bool = True,
                               rng: Optional[random.Random] = None) -> List[str]:
    """Caption selection and empty-prompt CFG dropout. `rng` draws them; it
    may be None only when nothing is drawn (no dropout, no list captions)."""
    needs_draws = proportion_empty_prompts > 0 or (
        is_train and any(isinstance(c, (list, np.ndarray)) for c in prompts))
    if rng is None and needs_draws:
        raise ValueError("caption dropout and list captions need an explicit random.Random")
    captions = []
    for caption in prompts:
        if rng is not None and rng.random() < proportion_empty_prompts:
            captions.append("")
        elif isinstance(caption, str):
            captions.append(caption)
        elif isinstance(caption, (list, np.ndarray)):
            captions.append(rng.choice(list(caption)) if is_train else caption[0])
        else:
            # a silently dropped item would misalign captions with images
            raise ValueError(f"Caption column should contain either strings or lists of "
                             f"strings, got {type(caption)}")
    return captions


def tokenize_prompts(tokenizer, captions: Sequence[str], max_length: int = 256):
    """(input_ids, attention_mask) as int64 tensors: right padding to a
    multiple of 8, truncation at `max_length`."""
    out = tokenizer(list(captions), padding=True, pad_to_multiple_of=8, max_length=max_length,
                    truncation=True, return_tensors="np")
    return (torch.from_numpy(np.asarray(out.input_ids, np.int64)),
            torch.from_numpy(np.asarray(out.attention_mask, np.int64)))


class DecoderTextEncoder:
    """`hidden_states[-2]` features of a torch decoder LM."""

    def __init__(self, model, tokenizer, max_length: int = 256):
        self.model = model.eval().requires_grad_(False)
        self.tokenizer = tokenizer
        self.max_length = max_length
        if hasattr(tokenizer, "padding_side"):
            tokenizer.padding_side = "right"

    @classmethod
    def from_pretrained(cls, path: str, dtype=torch.bfloat16, max_length: int = 256,
                        device="cuda"):
        """Tokenizer and LM from a local directory (`save_pretrained`'s
        layout); nothing is downloaded."""
        from transformers import AutoModel, AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(path, local_files_only=True)
        model = AutoModel.from_pretrained(path, dtype=dtype, local_files_only=True)
        return cls(model.to(device), tokenizer, max_length)

    @property
    def hidden_size(self) -> int:
        return self.model.config.hidden_size

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @torch.no_grad()
    def encode(self, prompts: Sequence, proportion_empty_prompts: float = 0.0,
               is_train: bool = True,
               rng: Optional[random.Random] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (cap_feats (B, L, D) in the LM's dtype, cap_mask (B, L) int32),
        both on the LM's device."""
        captions = apply_empty_prompt_dropout(prompts, proportion_empty_prompts, is_train, rng)
        input_ids, attention_mask = tokenize_prompts(self.tokenizer, captions, self.max_length)
        device = self.device
        out = self.model(input_ids=input_ids.to(device), attention_mask=attention_mask.to(device),
                         output_hidden_states=True)
        return out.hidden_states[-2], attention_mask.to(device=device, dtype=torch.int32)


class T5TextEncoder:
    """T5 encoder features: `last_hidden_state` of prompts padded to
    `max_length`, with their attention mask."""

    def __init__(self, model, tokenizer, max_length: int = 77):
        self.model = model.eval().requires_grad_(False)
        self.tokenizer = tokenizer
        self.max_length = max_length

    @classmethod
    def from_pretrained(cls, path: str, dtype=torch.bfloat16, max_length: int = 77,
                        device="cuda"):
        """Tokenizer and encoder from a local directory (`save_pretrained`'s
        layout); nothing is downloaded."""
        from transformers import AutoTokenizer, T5EncoderModel

        tokenizer = AutoTokenizer.from_pretrained(path, local_files_only=True)
        model = T5EncoderModel.from_pretrained(path, dtype=dtype, local_files_only=True)
        return cls(model.to(device), tokenizer, max_length)

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @torch.no_grad()
    def encode(self, prompts: Sequence[str]) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (features (B, max_length, D) in the encoder's dtype, mask
        (B, max_length) int32), both on its device."""
        batch = self.tokenizer(list(prompts), truncation=True, max_length=self.max_length,
                               padding="max_length", return_tensors="np")
        device = self.device
        ids = torch.from_numpy(np.asarray(batch.input_ids, np.int64)).to(device)
        mask = torch.from_numpy(np.asarray(batch.attention_mask, np.int64)).to(device)
        out = self.model(input_ids=ids, attention_mask=mask)
        return out.last_hidden_state, mask.to(torch.int32)


def clap_projection(x: torch.Tensor, params: Dict, eps: float = 1e-5) -> torch.Tensor:
    """CLAP's projection head in eval mode: LayerNorm(e1 + linear2(gelu(e1)))
    with e1 = linear1(x); `params`: {"linear1": {"weight"}, "linear2":
    {"weight"}, "layer_norm": {"weight", "bias"}}, torch layouts. fp32 out."""
    e1 = F.linear(x, params["linear1"]["weight"].to(x.dtype))
    e2 = F.linear(F.gelu(e1), params["linear2"]["weight"].to(x.dtype))
    h = (e1 + e2).float()
    mu = h.mean(-1, keepdim=True)
    var = ((h - mu) ** 2).mean(-1, keepdim=True)
    normed = (h - mu) * torch.rsqrt(var + eps)
    return normed * params["layer_norm"]["weight"] + params["layer_norm"]["bias"]


def extract_clap_caption_weights(clap_state_dict) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """A CLAP checkpoint's `caption_encoder.*` tensors -> (the state dict of
    the transformers text model under `caption_encoder.base.`, the
    projection parameters of `clap_projection`), fp32 CPU tensors."""
    base, proj = {}, {}
    for key, val in clap_state_dict.items():
        if not key.startswith("caption_encoder."):
            continue
        sub = key[len("caption_encoder."):]
        t = torch.as_tensor(np.asarray(val) if not isinstance(val, torch.Tensor) else val)
        if sub.startswith("base."):
            base[sub[len("base."):]] = t
        elif sub.startswith("projection."):
            module, leaf = sub[len("projection."):].rsplit(".", 1)
            proj.setdefault(module, {})[leaf] = t.float()
    return base, proj


class CLAPTextEncoder:
    """CLAP's caption tower: a transformers torch text model (BERT for CLAP
    2022) and the projection head. `encode` gives the per-token conditioning
    features (`max_length` 77), `embed` the L2-normalised projection of the
    CLS token for scoring (`score_max_length` 100, the reference scorer's
    budget)."""

    def __init__(self, model, tokenizer, projection_params=None, max_length: int = 77,
                 score_max_length: int = 100):
        self.model = model.eval().requires_grad_(False)
        self.tokenizer = tokenizer
        self.projection_params = projection_params
        self.max_length = max_length
        self.score_max_length = score_max_length

    @classmethod
    def from_clap_checkpoint(cls, ckpt_path: str, text_model, tokenizer, max_length: int = 77):
        """The caption branch of a CLAP checkpoint file (its `model` entry
        when it has one), as `from_clap_state_dict`."""
        sd = torch.load(ckpt_path, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "model" in sd:
            sd = sd["model"]
        return cls.from_clap_state_dict(sd, text_model, tokenizer, max_length)

    @classmethod
    def from_clap_state_dict(cls, state_dict, text_model, tokenizer, max_length: int = 77):
        """The caption branch of a CLAP state dict: `text_model` is the
        architecture-matching transformers model that receives the base
        weights (a key it lacks is an error); the projection follows it to
        its device."""
        base, proj = extract_clap_caption_weights(state_dict)
        missing, _ = text_model.load_state_dict(base, strict=False)
        if missing:
            raise KeyError(f"the CLAP checkpoint lacks {len(missing)} text-model weights, "
                           f"e.g. {missing[:4]}")
        device = next(text_model.parameters()).device
        proj = {m: {k: v.to(device) for k, v in leaves.items()} for m, leaves in proj.items()}
        return cls(text_model, tokenizer, proj, max_length)

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _hidden(self, prompts: Sequence[str], max_length: int):
        batch = self.tokenizer(list(prompts), truncation=True, max_length=max_length,
                               padding="max_length", return_tensors="np")
        ids = torch.from_numpy(np.asarray(batch.input_ids, np.int64)).to(self.device)
        mask = torch.from_numpy(np.asarray(batch.attention_mask, np.int64)).to(self.device)
        return self.model(input_ids=ids, attention_mask=mask).last_hidden_state, mask

    @torch.no_grad()
    def encode(self, prompts: Sequence[str]) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (features (B, max_length, D), mask (B, max_length) int32)."""
        feats, mask = self._hidden(prompts, self.max_length)
        if self.projection_params is not None:
            feats = clap_projection(feats, self.projection_params)
        return feats, mask.to(torch.int32)

    @torch.no_grad()
    def embed(self, prompts: Sequence[str]) -> torch.Tensor:
        """Sentence-level embedding for scoring: the projection of the CLS
        token, L2-normalised. Pairs with `clap_audio.CLAPAudioEncoder.embed`."""
        if self.projection_params is None:
            raise ValueError("CLAP scoring needs the projection head "
                             "(load via from_clap_checkpoint)")
        hidden, _ = self._hidden(prompts, self.score_max_length)
        proj = clap_projection(hidden[:, 0, :], self.projection_params)
        return proj / proj.norm(dim=-1, keepdim=True)


class BertHashTokenizer:
    """BERT-shaped prompt -> ids stand-in where no vocabulary exists: [CLS]
    (101), one id per word hashed into [1000, vocab) by
    `utils.stable_text_seed`, [SEP] (102), then [PAD] (0), with the attention
    mask. The same in every process."""

    def __init__(self, vocab_size: int = 30522):
        self.vocab_size = vocab_size

    def __call__(self, texts: Sequence[str], truncation: bool = True, max_length: int = 77,
                 padding="max_length", return_tensors: str = "np"):
        from ..utils import stable_text_seed

        ids = np.zeros((len(texts), max_length), np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for i, text in enumerate(texts):
            words = [1000 + stable_text_seed(w) % (self.vocab_size - 1000)
                     for w in text.split()][: max_length - 2]
            row = [101, *words, 102]
            ids[i, :len(row)] = row
            mask[i, :len(row)] = 1
        return SimpleNamespace(input_ids=ids, attention_mask=mask)


def char_tokenizer(max_length: int = 256):
    """An in-memory character-level tokenizer with Gemma's special ids (pad 0,
    eos 1, bos 2, unk 3; printable ASCII from 4): `tokenizers`' WordLevel
    model, one token per character, `<bos>` prepended, wrapped as
    `PreTrainedTokenizerFast` (right padding). An empty caption is one
    token, `<bos>`."""
    from tokenizers import Regex, Tokenizer, models, pre_tokenizers, processors
    from transformers import PreTrainedTokenizerFast

    vocab = {"<pad>": 0, "<eos>": 1, "<bos>": 2, "<unk>": 3}
    for code in range(32, 127):
        vocab[chr(code)] = len(vocab)
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Split(Regex("(?m)."), behavior="isolated")
    tok.post_processor = processors.TemplateProcessing(single="<bos> $A",
                                                       special_tokens=[("<bos>", 2)])
    return PreTrainedTokenizerFast(tokenizer_object=tok, bos_token="<bos>", eos_token="<eos>",
                                   pad_token="<pad>", unk_token="<unk>", padding_side="right",
                                   model_max_length=max_length)


__all__ = ["BertHashTokenizer", "CLAPTextEncoder", "DecoderTextEncoder", "T5TextEncoder",
           "apply_empty_prompt_dropout", "char_tokenizer", "clap_projection",
           "extract_clap_caption_weights", "tokenize_prompts"]

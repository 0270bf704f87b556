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
transformers' torch `T5EncoderModel`. CLAP stays with the audio family.
`char_tokenizer` builds an in-memory character-level tokenizer for runs
with random LM weights and no tokenizer files.
"""

from __future__ import annotations

import random
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


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


__all__ = ["DecoderTextEncoder", "T5TextEncoder", "apply_empty_prompt_dropout",
           "char_tokenizer", "tokenize_prompts"]

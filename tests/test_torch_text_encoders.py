"""The port's caption encoder (`lumina_t2x_tpu_torch/codecs/text_encoders.py`)
and its weight bridge (`core/checkpoint.gemma_state_dict_from_flax`) against
the JAX package's `DecoderTextEncoder` (`lumina_t2x_tpu/codecs/text_encoders.py`).

One tiny random `FlaxGemmaModel` (vocab 256, hidden 32, 3 layers, 4 heads, 2
KV heads, head_dim 8; its RMSNorm weights perturbed so that the norms are not
identities) runs in JAX; transformers' torch `GemmaModel` gets the same
weights through `gemma_state_dict_from_flax`. Both tokenize with the offline
fake tokenizer of `tests/test_text_encoders.py` or the port's character-level
`char_tokenizer`. fp32 on the CPU; bar atol 2e-4 / rtol 2e-3.
"""

import functools
import random

import jax
import numpy as np
import pytest
import torch

from lumina_t2x_tpu.codecs import text_encoders as jte
from lumina_t2x_tpu_torch.codecs import text_encoders as tte
from lumina_t2x_tpu_torch.core.checkpoint import gemma_state_dict_from_flax

ATOL, RTOL = 2e-4, 2e-3
GEMMA_TINY = dict(vocab_size=256, hidden_size=32, intermediate_size=64, num_hidden_layers=3,
                  num_attention_heads=4, num_key_value_heads=2, head_dim=8,
                  max_position_embeddings=300)
PROMPTS = ["a corgi wearing sunglasses", "low-poly render of a lighthouse at dusk", "",
           "x" * 70]


class FakeTok:
    """The offline byte-level tokenizer of `tests/test_text_encoders.py`."""

    padding_side = "right"
    pad_token_id = 0

    def __call__(self, texts, padding=True, pad_to_multiple_of=8, max_length=256,
                 truncation=True, return_tensors="np"):
        ids = [[(ord(c) % 255) + 1 for c in t][:max_length] or [1] for t in texts]
        maxlen = max(len(i) for i in ids)
        if pad_to_multiple_of:
            maxlen = (maxlen + pad_to_multiple_of - 1) // pad_to_multiple_of * pad_to_multiple_of
        input_ids = np.zeros((len(ids), maxlen), np.int32)
        mask = np.zeros((len(ids), maxlen), np.int32)
        for r, seq in enumerate(ids):
            input_ids[r, : len(seq)] = seq
            mask[r, : len(seq)] = 1

        class Out:
            pass

        o = Out()
        o.input_ids = input_ids
        o.attention_mask = mask
        return o


def gemma_config():
    from transformers import GemmaConfig

    return GemmaConfig(**GEMMA_TINY)


@functools.lru_cache(maxsize=None)
def flax_gemma():
    """A tiny FlaxGemmaModel whose RMSNorm weights are perturbed."""
    from transformers import FlaxGemmaModel

    model = FlaxGemmaModel(gemma_config(), seed=0)
    rng = np.random.default_rng(1)
    model.params = jax.tree_util.tree_map_with_path(
        lambda path, a: (np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
                         if "layernorm" in jax.tree_util.keystr(path)
                         or "'norm'" in jax.tree_util.keystr(path) else np.asarray(a)),
        model.params)
    return model


def torch_gemma():
    """transformers' torch GemmaModel holding `flax_gemma()`'s weights."""
    from transformers import GemmaModel

    model = GemmaModel(gemma_config())
    model.load_state_dict(gemma_state_dict_from_flax(flax_gemma().params), strict=True)
    return model.eval()


def save_gemma_dir(path, flax_too=False):
    """A local directory `DecoderTextEncoder.from_pretrained` reads: the torch
    weights and the character-level tokenizer (and, with `flax_too`, the Flax
    weights that the JAX package's `from_pretrained` reads)."""
    torch_gemma().save_pretrained(str(path))
    tte.char_tokenizer().save_pretrained(str(path))
    if flax_too:
        flax_gemma().save_pretrained(str(path))
    return str(path)


def encoders(tokenizer="fake", max_length=64):
    tok = FakeTok() if tokenizer == "fake" else tte.char_tokenizer()
    return (jte.DecoderTextEncoder(flax_gemma(), tok, max_length),
            tte.DecoderTextEncoder(torch_gemma(), tok, max_length))


# -- caption dropout and tokenization -----------------------------------------------


@pytest.mark.parametrize("prob,is_train", [(0.0, True), (0.5, True), (0.5, False), (1.0, True)])
def test_dropout_matches_jax(prob, is_train):
    prompts = ["a", ["b1", "b2", "b3"], "c", np.array(["d1", "d2"]), "e", "f", "g", "h"]
    got = tte.apply_empty_prompt_dropout(prompts, prob, is_train, rng=random.Random(7))
    ref = jte.apply_empty_prompt_dropout(prompts, prob, is_train, rng=random.Random(7))
    assert got == ref
    if prob == 0.5:
        assert "" in got and any(c for c in got)


def test_dropout_needs_an_explicit_rng():
    assert tte.apply_empty_prompt_dropout(["a", "b"], 0.0) == ["a", "b"]
    assert tte.apply_empty_prompt_dropout([["x", "y"]], 0.0, is_train=False) == ["x"]
    with pytest.raises(ValueError, match="random.Random"):
        tte.apply_empty_prompt_dropout(["a"], 0.1)
    with pytest.raises(ValueError, match="random.Random"):
        tte.apply_empty_prompt_dropout([["x", "y"]], 0.0)
    with pytest.raises(ValueError, match="strings"):
        tte.apply_empty_prompt_dropout([3], 0.0)


@pytest.mark.parametrize("tokenizer", ["fake", "char"])
def test_tokenize_pads_to_a_multiple_of_8(tokenizer):
    tok = FakeTok() if tokenizer == "fake" else tte.char_tokenizer()
    ids, mask = tte.tokenize_prompts(tok, PROMPTS, max_length=64)
    ref_ids, ref_mask = jte.tokenize_prompts(tok, PROMPTS, max_length=64)
    np.testing.assert_array_equal(ids.numpy(), ref_ids)
    np.testing.assert_array_equal(mask.numpy(), ref_mask)
    assert ids.dtype == mask.dtype == torch.int64
    assert ids.shape == (4, 64) and mask[3].sum() == 64  # 70 characters truncated
    short_ids, short_mask = tte.tokenize_prompts(tok, ["abcdefghi", "a"], max_length=64)
    assert short_ids.shape == (2, 16)  # 10 tokens padded to 16
    assert short_mask.sum(dim=1).tolist() == ([9, 1] if tokenizer == "fake" else [10, 2])


def test_char_tokenizer_bos_and_empty_caption():
    tok = tte.char_tokenizer()
    ids, mask = tte.tokenize_prompts(tok, ["", "ab"], max_length=256)
    assert ids.tolist() == [[2, 0, 0, 0, 0, 0, 0, 0], [2, 69, 70, 0, 0, 0, 0, 0]]
    assert mask.sum(dim=1).tolist() == [1, 3]
    ids, _ = tte.tokenize_prompts(tok, ["y" * 400], max_length=256)
    assert ids.shape == (1, 256)


# -- the encoder ---------------------------------------------------------------------


def test_bridge_covers_gemma_model():
    from transformers import GemmaModel

    sd = gemma_state_dict_from_flax(flax_gemma().params)
    own = GemmaModel(gemma_config()).state_dict()
    assert sorted(sd) == sorted(own)
    for name, t in own.items():
        assert sd[name].shape == t.shape and sd[name].dtype == torch.float32, name


@pytest.mark.parametrize("tokenizer", ["fake", "char"])
def test_features_match_jax(tokenizer):
    jenc, tenc = encoders(tokenizer)
    ref, ref_mask = jenc.encode(PROMPTS)
    got, mask = tenc.encode(PROMPTS)
    assert tenc.hidden_size == 32 and got.dtype == torch.float32 and mask.dtype == torch.int32
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    # padded tokens too: both stacks mask keys alike, and every row keeps a key
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_every_hidden_state_matches_jax():
    """All L + 1 hidden states: the two stacks agree layer by layer, so
    hidden_states[-2] is the same layer's output in both."""
    tok = tte.char_tokenizer()
    ids, mask = tte.tokenize_prompts(tok, PROMPTS, max_length=64)
    ref = flax_gemma()(input_ids=ids.numpy(), attention_mask=mask.numpy(),
                       output_hidden_states=True).hidden_states
    with torch.no_grad():
        got = torch_gemma()(input_ids=ids, attention_mask=mask,
                            output_hidden_states=True).hidden_states
    assert len(got) == len(ref) == GEMMA_TINY["num_hidden_layers"] + 1
    for layer, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL, rtol=RTOL,
                                   err_msg=f"hidden state {layer}")


def test_dropout_in_encode_matches_jax():
    jenc, tenc = encoders("char")
    random.seed(3)  # JAX's encode draws from the global generator
    ref, ref_mask = jenc.encode(PROMPTS, proportion_empty_prompts=0.5)
    got, mask = tenc.encode(PROMPTS, proportion_empty_prompts=0.5, rng=random.Random(3))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    with pytest.raises(ValueError, match="random.Random"):
        tenc.encode(PROMPTS, proportion_empty_prompts=0.5)


def test_from_pretrained_reads_a_local_directory(tmp_path):
    """Weights and tokenizer saved with `save_pretrained` load back through
    `from_pretrained` (no download), and the features are the output of
    decoder layer L-2 taken by a forward hook, bit for bit."""
    path = save_gemma_dir(tmp_path / "gemma")
    enc = tte.DecoderTextEncoder.from_pretrained(path, dtype=torch.float32, max_length=256,
                                                 device="cpu")
    assert enc.hidden_size == 32 and enc.device == torch.device("cpu")
    assert enc.tokenizer.padding_side == "right"
    taken = []
    hook = enc.model.layers[-2].register_forward_hook(
        lambda mod, args, out: taken.append(out[0] if isinstance(out, tuple) else out))
    feats, mask = enc.encode(PROMPTS)
    hook.remove()
    assert torch.equal(feats, taken[0])
    _, tenc = encoders("char", max_length=256)
    ref, ref_mask = tenc.encode(PROMPTS)
    assert torch.equal(mask, ref_mask) and torch.equal(feats, ref)
    bf16 = tte.DecoderTextEncoder.from_pretrained(path, max_length=256, device="cpu")
    assert bf16.encode(["a"])[0].dtype == torch.bfloat16

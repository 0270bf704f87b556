"""The port's CLIP text towers and SD3 prompt encoder
(`lumina_t2x_tpu_torch/codecs/clip_text.py`) and its `T5TextEncoder`
(`codecs/text_encoders.py`) against the JAX package's: both towers
(quick_gelu and gelu) with weights carried by `core/checkpoint.
clip_text_state_dict_from_jax`, both poolings (argmax and an explicit EOS),
transformers' own `CLIPTextModelWithProjection` through a saved HF
directory (`load_clip_text_tower`), the hash tokenizer, the SD3 combination
with T5's zeros and with a T5 mounted, and the T5 encoder on a tiny random
`T5Config` (weights carried by transformers' flax -> torch loader).

Tiny towers (vocab 50, hidden 32, 3 layers, 4 heads, 16 positions), fp32 on
the CPU, ids from numpy. Bar: atol 2e-4 / rtol 2e-3.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from lumina_t2x_tpu.codecs import clip_text as j_clip
from lumina_t2x_tpu.codecs.text_encoders import T5TextEncoder as JT5
from lumina_t2x_tpu_torch.codecs import clip_text as t_clip
from lumina_t2x_tpu_torch.codecs.text_encoders import T5TextEncoder as TT5
from lumina_t2x_tpu_torch.core.checkpoint import clip_text_state_dict_from_jax

ATOL, RTOL = 2e-4, 2e-3
VOCAB, DIM, LAYERS, HEADS, INTER, MAXPOS, PROJ = 50, 32, 3, 4, 64, 16, 24
KEYS = ("penultimate", "last_hidden", "pooled", "projected")


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(ref, np.float32),
                               atol=ATOL, rtol=RTOL)


def _ids(b=3, length=12, seed=3, eos=VOCAB - 1):
    """Ids with an EOS (the largest id, as CLIP's EOT) and EOS padding after."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, VOCAB - 2, (b, length))
    for r, n in enumerate(rng.randint(3, length - 1, b)):
        ids[r, n:] = eos
    return ids.astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_tower(act="quick_gelu", eos=2, seed=0):
    kw = dict(vocab_size=VOCAB, hidden=DIM, n_layers=LAYERS, n_heads=HEADS, intermediate=INTER,
              max_positions=MAXPOS, projection_dim=PROJ, hidden_act=act, eos_token_id=eos)
    tower = j_clip.CLIPTextTower(**kw)
    variables = tower.init(jax.random.PRNGKey(seed), jnp.zeros((1, MAXPOS), jnp.int32))
    flat = traverse_util.flatten_dict(jax.tree.map(np.asarray, variables["params"]))
    rng = np.random.default_rng(seed)
    params = traverse_util.unflatten_dict(
        {k: (v + 0.05 * rng.standard_normal(v.shape)).astype(np.float32) for k, v in flat.items()})
    ported = t_clip.CLIPTextTower(**kw).eval()
    ported.load_state_dict(clip_text_state_dict_from_jax(params), strict=True)
    return tower, {"params": params}, ported


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_tower_matches_jax(act):
    tower, variables, ported = _jax_tower(act)
    ids = _ids()
    ref = tower.apply(variables, jnp.asarray(ids))
    got = ported(ids)
    for key in KEYS:
        _close(got[key], ref[key])


def test_explicit_eos_pooling_matches_jax():
    """eos_token_id != 2 pools at the first explicit EOS, not the argmax."""
    tower, variables, ported = _jax_tower(eos=7, seed=1)
    ids = np.random.RandomState(0).randint(10, VOCAB - 2, (2, 10))
    ids[0, 4], ids[1, 8] = 7, 7
    ref = tower.apply(variables, jnp.asarray(ids.astype(np.int32)))
    got = ported(ids)
    _close(got["projected"], ref["projected"])
    assert not torch.allclose(got["pooled"][0], got["last_hidden"][0, ids[0].argmax()])


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_load_hf_directory_matches_transformers(act, tmp_path):
    """transformers' own CLIPTextModelWithProjection, saved as a local HF
    directory and read back by `load_clip_text_tower` (no tokenizer files:
    the tokenizer is None)."""
    from transformers import CLIPTextConfig, CLIPTextModelWithProjection

    cfg = CLIPTextConfig(vocab_size=VOCAB, hidden_size=DIM, intermediate_size=INTER,
                         num_hidden_layers=LAYERS, num_attention_heads=HEADS,
                         max_position_embeddings=MAXPOS, projection_dim=PROJ, hidden_act=act,
                         eos_token_id=2)
    torch.manual_seed(0)
    hf = CLIPTextModelWithProjection(cfg).eval()
    hf.save_pretrained(str(tmp_path))
    tower, tok = t_clip.load_clip_text_tower(str(tmp_path))
    assert tok is None
    ids = _ids()
    with torch.no_grad():
        ref = hf(input_ids=torch.from_numpy(ids).long(), output_hidden_states=True)
    got = tower(ids)
    _close(got["penultimate"], ref.hidden_states[-2])
    _close(got["last_hidden"], ref.last_hidden_state)
    _close(got["projected"], ref.text_embeds)


def test_hash_tokenizer_matches_jax():
    texts = ["a photo of an astronaut riding a horse", "", "x " * 90]
    ref = j_clip.DebugHashTokenizer(vocab_size=VOCAB, max_length=MAXPOS)(texts).input_ids
    got = t_clip.DebugHashTokenizer(vocab_size=VOCAB, max_length=MAXPOS)(texts).input_ids
    np.testing.assert_array_equal(got, ref)
    assert got.shape == (3, MAXPOS) and (got[:, 0] == VOCAB - 2).all()


class FakeT5Tok:
    """Byte-level ids padded to max_length (pad 0, EOS 1), as T5's tokenizer
    shapes them."""

    def __call__(self, texts, truncation=True, max_length=8, padding="max_length",
                 return_tensors="np"):
        ids = np.zeros((len(texts), max_length), np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for r, t in enumerate(texts):
            seq = ([(ord(c) % 120) + 2 for c in t] + [1])[:max_length]
            ids[r, : len(seq)], mask[r, : len(seq)] = seq, 1

        class Out:
            pass

        o = Out()
        o.input_ids, o.attention_mask = ids, mask
        return o


@functools.lru_cache(maxsize=None)
def _t5_pair(d_model=96):
    from transformers import FlaxT5EncoderModel, T5Config, T5EncoderModel
    from transformers.modeling_flax_pytorch_utils import load_flax_weights_in_pytorch_model

    cfg = T5Config(vocab_size=128, d_model=d_model, d_kv=16, d_ff=64, num_layers=2, num_heads=4)
    flax_model = FlaxT5EncoderModel(cfg, seed=0)
    torch_model = T5EncoderModel(cfg)
    load_flax_weights_in_pytorch_model(torch_model, flax_model.params)
    return (JT5(flax_model, FakeT5Tok(), max_length=10),
            TT5(torch_model.float(), FakeT5Tok(), max_length=10))


def test_t5_encoder_matches_jax():
    j_enc, t_enc = _t5_pair()
    prompts = ["a corgi", "a lighthouse at dusk in the rain", ""]
    ref_feats, ref_mask = j_enc.encode(prompts)
    feats, mask = t_enc.encode(prompts)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    m = mask.numpy().astype(bool)
    assert feats.shape == (3, 10, 96) and mask.dtype == torch.int32
    _close(feats.numpy()[m], np.asarray(ref_feats)[m])


@pytest.mark.parametrize("with_t5", [False, True])
def test_sd3_prompt_encoder_matches_jax(with_t5):
    """L + G penultimate side by side, zero-padded to the T5 width, T5's
    features or zeros after them, and the pooled pair; [uncond; cond]."""
    (jl, vl, tl), (jg, vg, tg) = _jax_tower("quick_gelu", seed=0), _jax_tower("gelu", seed=2)
    tok = t_clip.DebugHashTokenizer(vocab_size=VOCAB, max_length=MAXPOS)
    j_t5, t_t5 = _t5_pair() if with_t5 else (None, None)
    kw = dict(t5_max_len=6, joint_dim=96, clip_max_len=MAXPOS)
    j_enc = j_clip.SD3PromptEncoder(jl, vl, tok, jg, vg, tok, t5_encoder=j_t5, **kw)
    t_enc = t_clip.SD3PromptEncoder(tl, tok, tg, tok, t5_encoder=t_t5, **kw)
    ref_ctx, ref_pooled = j_enc.encode_cfg_pair("a photo of a dog", "blurry")
    ctx, pooled = t_enc.encode_cfg_pair("a photo of a dog", "blurry")
    t5_len = 10 if with_t5 else 6
    assert ctx.shape == (2, MAXPOS + t5_len, 96) and pooled.shape == (2, 2 * PROJ)
    assert (ctx[:, :MAXPOS, 2 * DIM:] == 0).all()
    if not with_t5:
        assert (ctx[:, MAXPOS:] == 0).all()
    _close(ctx, ref_ctx)
    _close(pooled, ref_pooled)


def test_debug_prompt_encoder_shapes():
    enc = t_clip.build_sd3_prompt_encoder(debug=True)
    ctx, pooled = enc.encode_cfg_pair("a cat")
    assert ctx.shape == (2, 77 + 256, 4096) and pooled.shape == (2, 2048)
    assert torch.isfinite(ctx).all() and not torch.equal(ctx[0], ctx[1])
    again = t_clip.build_sd3_prompt_encoder(clip_l="ignored", clip_g="ignored", debug=True)
    np.testing.assert_allclose(again.encode(["a cat"])[1].numpy(), pooled[1:].numpy(), atol=1e-5)

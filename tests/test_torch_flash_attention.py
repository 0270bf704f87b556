"""The port's flash-attention entry points (`lumina_t2x_tpu_torch/ops/
flash_attention.py`) against the JAX package's Pallas kernels, run in
interpret mode on the CPU through their launchers:

  flash_small_kv   <- _flash_small_kv_impl (`_flash_small_kv_kernel`)
  flash_online     <- _flash_attention_fwd_impl, static_max=None
  flash_static_max <- _flash_attention_fwd_impl, static_max=bound
  flash_online_lse <- _flash_fwd_res_impl / flash_lse_range

On CPU tensors each entry point runs its plain PyTorch version. Inputs come
from numpy, fp32 on both sides; bar atol 2e-4 / rtol 2e-3. Fully masked
query rows are excluded from the comparison (the Pallas kernels disagree on
them) and checked separately: the port defines them as 0 with LSE -inf.
The `cuda`-marked tests compare each CUDA kernel with its plain version on
the card and skip without one.
"""

import importlib
import sys

import numpy as np
import pytest
import torch

from lumina_t2x_tpu_torch.ops import flash_attention as tfa

_JFA = "lumina_t2x_tpu.ops.flash_attention"


class _Lazy:
    """JAX is imported at first use, so that the `cuda` tests below also
    collect and run on a machine without JAX
    (`pytest --noconftest -m cuda`)."""

    def __init__(self, module):
        self._module = module

    def __getattr__(self, name):
        # `lumina_t2x_tpu.ops` re-exports the `flash_attention` function
        # under the submodule's name: import the module itself
        return getattr(importlib.import_module(self._module), name)


jfa = _Lazy(_JFA)
jnp = _Lazy("jax.numpy")

ATOL, RTOL = 2e-4, 2e-3


@pytest.fixture(autouse=True)
def _reset_bounds(monkeypatch):
    """The static-max bound is module state in both packages."""
    monkeypatch.delenv("LUMINA_FLASH_STATIC_MAX", raising=False)
    tfa.set_flash_static_max(None)
    if _JFA in sys.modules:
        jfa.set_flash_static_max(None)
    yield
    tfa.set_flash_static_max(None)
    if _JFA in sys.modules:
        jfa.set_flash_static_max(None)


def _inputs(seed, b=2, sq=40, sk=37, hq=4, hkv=2, d=16, masked=True):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    mask = np.ones((b, sk), np.int32)
    if masked:  # partial masks: every row keeps some valid keys
        mask[0, sk - sk // 4:] = 0
        mask[1, : sk // 3] = 0
    return q, k, v, mask


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, ref):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("hkv,masked,scale", [(2, True, 0.17), (4, False, None)])
def test_small_kv_matches_pallas(hkv, masked, scale):
    q, k, v, mask = _inputs(0, hkv=hkv, masked=masked)
    jscale = scale if scale is not None else 16 ** -0.5
    ref = jfa._flash_small_kv_impl(*_j(q, k, v, mask), jscale, 128)
    tq, tk, tv, tm = _t(q, k, v, mask)
    _close(tfa.flash_small_kv(tq, tk, tv, tm if masked else None, scale), ref)


@pytest.fixture(scope="module")
def long_kv():
    """Sk = 1100 over block_k = 512: three KV tiles, the last one ragged."""
    return _inputs(1, sq=48, sk=1100)


def test_online_matches_pallas(long_kv):
    q, k, v, mask = long_kv
    ref = jfa._flash_attention_fwd_impl(*_j(q, k, v, mask), 0.25, 128, 512)
    _close(tfa.flash_online(*_t(q, k, v, mask), 0.25), ref)


@pytest.mark.parametrize("offset", [6.0, -40.0])
def test_static_max_matches_pallas(long_kv, offset):
    """offset 6 is the calibration margin; -40 puts the bound far below the
    row maxima, so the exp clamp at 55 fires on some keys."""
    q, k, v, mask = long_kv
    lse_max = float(jfa.flash_lse_range(*_j(q, k, v, mask), 0.25)[0])
    bound = lse_max + offset
    ref = jfa._flash_attention_fwd_impl(*_j(q, k, v, mask), 0.25, 128, 512, static_max=bound)
    _close(tfa.flash_static_max(*_t(q, k, v, mask), 0.25, bound=bound), ref)


def test_online_lse_matches_pallas(long_kv):
    q, k, v, mask = long_kv
    ref_out, ref_lse = jfa._flash_fwd_res_impl(*_j(q, k, v, mask), 0.25, 128, 512)
    out, lse = tfa.flash_online_lse(*_t(q, k, v, mask), 0.25)
    _close(out, ref_out)
    assert lse.shape == (2, 4, 48) and lse.dtype == torch.float32
    _close(lse, np.asarray(ref_lse)[:, :, :48, 0])


def test_lse_range_matches_pallas(long_kv):
    q, k, v, mask = long_kv
    ref = jfa.flash_lse_range(*_j(q, k, v, mask), 0.3)
    _close(tfa.flash_lse_range(*_t(q, k, v, mask), 0.3), ref)


@pytest.mark.parametrize("sk,bound", [(40, None), (1100, None), (1100, 9.5)])
def test_dispatch_matches_jax_flash_attention(sk, bound):
    """`flash_attention` picks small-KV, online or static-max as the JAX
    package does, with the bound installed on both sides."""
    q, k, v, mask = _inputs(2, sq=24, sk=sk, hq=2, hkv=1)
    jfa.set_flash_static_max(bound)
    tfa.set_flash_static_max(bound)
    assert tfa.streams_kv(sk) == jfa.streams_kv(sk)
    ref = jfa.flash_attention(*_j(q, k, v, mask))
    _close(tfa.flash_attention(*_t(q, k, v, mask)), ref)


def test_env_pin_wins(monkeypatch):
    tfa.set_flash_static_max(3.0)
    monkeypatch.setenv("LUMINA_FLASH_STATIC_MAX", "12.5")
    assert tfa.get_flash_static_max() == 12.5
    monkeypatch.delenv("LUMINA_FLASH_STATIC_MAX")
    assert tfa.get_flash_static_max() == 3.0


@pytest.mark.parametrize("entry", ["small_kv", "online", "static_max", "online_lse"])
def test_fully_masked_rows_are_zero(entry):
    q, k, v, mask = _inputs(3, sk=70)
    mask[1] = 0  # batch row 1: no valid key
    tq, tk, tv, tm = _t(q, k, v, mask)
    if entry == "static_max":
        out = tfa.flash_static_max(tq, tk, tv, tm, bound=8.0)
    elif entry == "online_lse":
        out, lse = tfa.flash_online_lse(tq, tk, tv, tm)
        assert torch.isneginf(lse[1]).all() and torch.isfinite(lse[0]).all()
    else:
        out = getattr(tfa, f"flash_{entry}")(tq, tk, tv, tm)
    assert torch.equal(out[1], torch.zeros_like(out[1]))
    ref = tfa.flash_small_kv_plain(tq[:1], tk[:1], tv[:1], tm[:1], 0.25)
    if entry != "static_max":
        torch.testing.assert_close(out[:1], ref)


def test_cpu_calls_launch_no_kernel():
    tfa.reset_launch_counts()
    q, k, v, mask = _inputs(4, sk=50)
    tq, tk, tv, tm = _t(q, k, v, mask)
    tfa.flash_small_kv(tq, tk, tv, tm)
    tfa.flash_online(tq, tk, tv, tm)
    tfa.flash_static_max(tq, tk, tv, tm, bound=5.0)
    tfa.flash_online_lse(tq, tk, tv, tm)
    tfa.flash_lse_range(tq, tk, tv, tm)
    assert {"small_kv", "online", "static_max", "online_lse"} <= set(tfa.LAUNCHES)
    assert all(count == 0 for count in tfa.LAUNCHES.values())
    assert tfa.PLAIN_CUDA_CALLS["count"] == 0


def test_gqa_heads_must_divide():
    q, k, v, _ = _inputs(5, hq=3, hkv=2)
    with pytest.raises(ValueError):
        tfa.flash_attention(*_t(q, k, v))


# -- on the card: each CUDA kernel against its plain version ----------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _cuda_inputs(dtype, b=2, sq=200, sk=300, hq=4, hkv=2, d=72, seed=0):
    g = torch.Generator().manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g).to("cuda", dtype)
    mask = torch.ones(b, sk, dtype=torch.int32)
    mask[0, sk - 37:] = 0
    mask[1] = 0  # a fully masked batch row
    return mk(b, sq, hq, d), mk(b, sk, hkv, d), mk(b, sk, hkv, d), mask.cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("entry", ["small_kv", "online", "static_max", "online_lse"])
def test_kernel_matches_plain_on_card(cuda_device, dtype, entry):
    q, k, v, mask = _cuda_inputs(dtype)
    kw = {"bound": 9.0} if entry == "static_max" else {}
    before = tfa.LAUNCHES[entry]
    got = getattr(tfa, f"flash_{entry}")(q, k, v, mask, 0.2, **kw)
    ref = getattr(tfa, f"flash_{entry}_plain")(q, k, v, mask, 0.2, *kw.values())
    torch.cuda.synchronize()
    assert tfa.LAUNCHES[entry] == before + 1
    if entry == "online_lse":
        (got, lse), (ref, ref_lse) = got, ref
        torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)
    atol = 1e-2 if dtype == torch.bfloat16 else 2e-3
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 256, 32, 32), (4, 1024, 8, 8), (2, 256, 32, 8),
                                   (2, 1024, 8, 2)])
@pytest.mark.parametrize("entry", ["small_kv", "online_lse"])
def test_head_dim_48_matches_plain_on_card(cuda_device, entry, shape):
    """K1 (sampling) and K4 (the training forward) at the class-conditional
    models' head_dim 48: the 600M's (B, 256, 32, 48), the Small's
    (B, 1024, 8, 48) in pixel space, and both with GQA, a masked tail and a
    fully masked batch row. Bars: 1e-2 max and 1e-3 mean; LSE 1e-3."""
    b, s, hq, hkv = shape
    g = torch.Generator().manual_seed(s + hkv)
    mk = lambda *sh: torch.randn(*sh, generator=g).to("cuda", torch.bfloat16)
    q, k, v = mk(b, s, hq, 48), mk(b, s, hkv, 48), mk(b, s, hkv, 48)
    mask = torch.ones(b, s, dtype=torch.int32)
    if hkv < hq:
        mask[0, s - 37:] = 0
        mask[-1] = 0
    mask = mask.cuda()
    before = tfa.LAUNCHES[entry]
    got = getattr(tfa, f"flash_{entry}")(q, k, v, mask, 48 ** -0.5)
    ref = getattr(tfa, f"flash_{entry}_plain")(q, k, v, mask, 48 ** -0.5)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES[entry] == before + 1
    if entry == "online_lse":
        (got, lse), (ref, ref_lse) = got, ref
        live = mask.bool().any(dim=1)
        torch.testing.assert_close(lse[live], ref_lse[live], atol=1e-3, rtol=0)
    err = (got.float() - ref.float()).abs()
    assert err.max().item() <= 1e-2 and err.mean().item() <= 1e-3


# Flag-DiT's head_dims (the 128/128 instantiations): the 5B's 1024^2 CFG pair,
# 64 x 65 tokens with the [eol] column, against itself and its 128 caption keys
# (100 valid); the ImageNet 7B's 256^2 self-attention; (b, sq, sk, hq, hkv, d, valid)
FLAG_DIT_SHAPES = {"5b": (2, 4160, 4160, 32, 32, 96, None),
                   "5b_gqa_masked": (2, 4160, 4160, 32, 8, 96, None),
                   "5b_captions": (2, 4160, 128, 32, 32, 96, 100),
                   "7b": (8, 256, 256, 32, 32, 128, None)}


@pytest.mark.cuda
@pytest.mark.parametrize("entry,case", [
    *((entry, case) for entry in ("online", "static_max", "online_lse")
      for case in ("5b", "5b_gqa_masked")),
    ("small_kv", "5b_captions"), ("online_lse", "5b_captions"), ("small_kv", "7b")])
def test_flag_dit_head_dims_match_plain_on_card(cuda_device, entry, case):
    """K1-K4 at head_dim 96 and 128 on Flag-DiT's shapes (K2-K4 where the
    keys stream), the GQA case with a masked tail and a fully masked batch
    row. Bars: 1e-2 max and 1e-3 mean; LSE 1e-3."""
    b, sq, sk, hq, hkv, d, valid = FLAG_DIT_SHAPES[case]
    g = torch.Generator().manual_seed(sq + hkv + d)
    mk = lambda *sh: torch.randn(*sh, generator=g).to("cuda", torch.bfloat16)
    q, k, v = mk(b, sq, hq, d), mk(b, sk, hkv, d), mk(b, sk, hkv, d)
    mask = torch.ones(b, sk, dtype=torch.int32)
    mask[:, valid or sk:] = 0
    if hkv < hq:
        mask[0, sk - 37:] = 0
        mask[-1] = 0
    mask = mask.cuda()
    kw = {"bound": 12.0} if entry == "static_max" else {}
    before = tfa.LAUNCHES[entry]
    got = getattr(tfa, f"flash_{entry}")(q, k, v, mask, d ** -0.5, **kw)
    ref = getattr(tfa, f"flash_{entry}_plain")(q, k, v, mask, d ** -0.5, *kw.values())
    torch.cuda.synchronize()
    assert tfa.LAUNCHES[entry] == before + 1
    if entry == "online_lse":
        (got, lse), (ref, ref_lse) = got, ref
        live = mask.bool().any(dim=1)
        torch.testing.assert_close(lse[live], ref_lse[live], atol=1e-3, rtol=0)
    err = (got.float() - ref.float()).abs()
    assert err.max().item() <= 1e-2 and err.mean().item() <= 1e-3


# the anagram and SD3 paths: K1 behind phase 2's 4096 queries over kv_merge's
# 1024 pooled keys (head_dim 72); K2 on MMDiT-SD3-Medium's unmasked joint
# sequence at 1024^2 (333 context + 4096 image tokens, 24 heads of 64, no
# tile-aligned length) and K4 on DreamBooth's at 256^2 (333 + 256);
# (b, sq, sk, hq, hkv, d)
ANAGRAM_SD3_SHAPES = {"kv1024": (2, 4096, 1024, 32, 32, 72),
                      "sd3_joint": (2, 4429, 4429, 24, 24, 64),
                      "sd3_dreambooth": (2, 589, 589, 24, 24, 64)}


@pytest.mark.cuda
@pytest.mark.parametrize("entry,case", [("small_kv", "kv1024"), ("online", "sd3_joint"),
                                        ("online_lse", "sd3_dreambooth")])
def test_anagram_sd3_shapes_match_plain_on_card(cuda_device, entry, case):
    """K1, K2 and K4 at the anagram and SD3 paths' new shapes, with no key
    mask (the kernel masks the key tail past Sk itself). Bars: 1e-2 max and
    1e-3 mean; LSE 1e-3."""
    b, sq, sk, hq, hkv, d = ANAGRAM_SD3_SHAPES[case]
    g = torch.Generator().manual_seed(sq + sk + d)
    mk = lambda *sh: torch.randn(*sh, generator=g).to("cuda", torch.bfloat16)
    q, k, v = mk(b, sq, hq, d), mk(b, sk, hkv, d), mk(b, sk, hkv, d)
    before = tfa.LAUNCHES[entry]
    got = getattr(tfa, f"flash_{entry}")(q, k, v, None, d ** -0.5)
    ref = getattr(tfa, f"flash_{entry}_plain")(q, k, v, None, d ** -0.5)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES[entry] == before + 1
    if entry == "online_lse":
        (got, lse), (ref, ref_lse) = got, ref
        torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)
    err = (got.float() - ref.float()).abs()
    assert err.max().item() <= 1e-2 and err.mean().item() <= 1e-3


# FlagDiT-1D (the audio family, 16 heads of 72): the served request's CFG
# batch over 128 latent frames (self) and its 16 caption tokens (cross), in
# fp32 (the app's, the forward template) and bf16; the trainer's B=32 over
# 256 frames and its 77 caption tokens; (b, sq, sk, h)
AUDIO_SHAPES = {"serve_self": (2, 128, 128, 16), "serve_cross": (2, 128, 16, 16),
                "train_self": (32, 256, 256, 16), "train_cross": (32, 256, 77, 16)}


@pytest.mark.cuda
@pytest.mark.parametrize("entry,case,dtype", [
    ("small_kv", "serve_self", torch.float32), ("small_kv", "serve_cross", torch.float32),
    ("small_kv", "serve_self", torch.bfloat16), ("small_kv", "serve_cross", torch.bfloat16),
    ("online_lse", "train_self", torch.bfloat16), ("online_lse", "train_cross", torch.bfloat16)])
def test_audio_shapes_match_plain_on_card(cuda_device, entry, case, dtype):
    """K1 and K4 at FlagDiT-1D's shapes, every key valid. Bars: bf16 1e-2 max
    and 1e-3 mean, fp32 2e-3 max; LSE 1e-3."""
    b, sq, sk, h = AUDIO_SHAPES[case]
    g = torch.Generator().manual_seed(sq + sk)
    mk = lambda *sh: torch.randn(*sh, generator=g).to("cuda", dtype)  # noqa: E731
    q, k, v = mk(b, sq, h, 72), mk(b, sk, h, 72), mk(b, sk, h, 72)
    before = tfa.LAUNCHES[entry]
    got = getattr(tfa, f"flash_{entry}")(q, k, v, None, 72 ** -0.5)
    ref = getattr(tfa, f"flash_{entry}_plain")(q.float(), k.float(), v.float(), None, 72 ** -0.5)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES[entry] == before + 1
    if entry == "online_lse":
        (got, lse), (ref, ref_lse) = got, ref
        torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)
    err = (got.float() - ref.float()).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 2e-3
    else:
        assert err.max().item() <= 1e-2 and err.mean().item() <= 1e-3


# Gemma caption lengths: Sk a multiple of 8 up to 256, valid keys per batch
# row ending inside a 64-key tile, the CFG's empty caption one key (<bos>)
CAPTION_LENGTHS = {8: (1, 5), 40: (37, 21), 136: (130, 67)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sk", sorted(CAPTION_LENGTHS))
@pytest.mark.parametrize("entry", ["small_kv", "online_lse"])
def test_caption_lengths_match_plain_on_card(cuda_device, dtype, sk, entry):
    """K1 (the sampler's cross-attention) and K4 (the trainer's) at the 2B's
    head_dim over Gemma caption keys, every row keeping a key. The bf16 bar is
    chip_smoke's for K9 and these lengths, 1e-2 of max(1, max|ref|): a row
    with one valid key outputs that key's value, whose bf16 rounding reaches
    1.6e-2 in [4, 8)."""
    g = torch.Generator().manual_seed(sk)
    mk = lambda *s: torch.randn(*s, generator=g).to("cuda", dtype)
    q, k, v = mk(2, 300, 8, 72), mk(2, sk, 8, 72), mk(2, sk, 8, 72)
    mask = torch.zeros(2, sk, dtype=torch.int32)
    for row, n in enumerate(CAPTION_LENGTHS[sk]):
        mask[row, :n] = 1
    mask = mask.cuda()
    before = tfa.LAUNCHES[entry]
    got = getattr(tfa, f"flash_{entry}")(q, k, v, mask, 72 ** -0.5)
    ref = getattr(tfa, f"flash_{entry}_plain")(q, k, v, mask, 72 ** -0.5)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES[entry] == before + 1
    if entry == "online_lse":
        (got, lse), (ref, ref_lse) = got, ref
        assert bool(torch.isfinite(lse).all())
        torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)
    top = max(1.0, ref.float().abs().max().item())
    atol = 1e-2 * top if dtype == torch.bfloat16 else 2e-3
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=0)

"""The bf16 attention forward of `lumina_t2x_tpu_torch/csrc/flash_fwd_sm90.cu`
(K1 `flash_small_kv`, K2 `flash_online`, K3 `flash_static_max`, K4
`flash_online_lse`, K5 `flash_static_max_lse` on bf16 inputs; K1 is K2's
kernel over at most 1024 keys).

On the CPU: `emulate` repeats the kernel's arithmetic in fp32 torch -- 64-key
tiles, the exp2 domain with scale*log2(e), bound*log2(e) and the clamp
55*log2(e) folded on the host, K2's per-tile row max with the alpha rescale
and its -inf guard, P split into a bf16 hi + lo pair for PV, the
denominator summed from the fp32 p, one bf16 rounding of the output, and the
epilogue's row LSE (ln2 * (m + log2 l) from the log2-domain max, or from
bound*log2(e) for the static max; -inf where l = 0) -- and is held against the JAX
package's Pallas K1-K5 in interpret mode and against the port's plain
versions. Inputs are bf16-representable fp32 from numpy, so every side
multiplies the same operands. Bar: one bf16 rounding of the output (2^-8 of
|ref|) plus 2e-5 for fp32 sums in another order; the LSE to 1e-4 absolute
(the JAX LSE kernels' tests' bar). Fully masked rows are left out of the JAX
comparison (the Pallas kernels disagree on them) and checked to be 0, with
LSE -inf, against the port.

The `cuda`-marked tests run the kernel itself against its plain version on
the card (`python -m pytest --noconftest -m cuda tests/test_torch_flash_fwd_sm90.py`)
and skip without one.
"""

import importlib
import inspect
import itertools
import math
import re
import sys

import numpy as np
import pytest
import torch

from lumina_t2x_tpu_torch.ops import cuda_lib
from lumina_t2x_tpu_torch.ops import flash_attention as tfa

_JFA = "lumina_t2x_tpu.ops.flash_attention"
LOG2E = 1.4426950408889634
BK = 64  # keys per tile
RTOL, ATOL = 2.0 ** -8, 2e-5
LSE_ATOL = 1e-4


class _Lazy:
    """JAX is imported at first use, so that the `cuda` tests below also
    collect and run on a machine without JAX (`pytest --noconftest -m cuda`)."""

    def __init__(self, module):
        self._module = module

    def __getattr__(self, name):
        return getattr(importlib.import_module(self._module), name)


jfa = _Lazy(_JFA)
jnp = _Lazy("jax.numpy")


@pytest.fixture(autouse=True)
def _reset_bounds(monkeypatch):
    monkeypatch.delenv("LUMINA_FLASH_STATIC_MAX", raising=False)
    yield
    if _JFA in sys.modules:
        jfa.set_flash_static_max(None)


def _f32(x):
    return torch.tensor(x, dtype=torch.float32)


def _pow2(e):
    """2^e exactly as fp32, for an integer tensor e (clamped to [-126, 127])."""
    return ((e.to(torch.int32) + 127).clamp(1, 254) << 23).view(torch.float32)


def emulate(q, k, v, kv_mask, scale, bound=None, p_pair=True, round_out=True,
            dtype=torch.bfloat16, row_scale=True):
    """The kernel's arithmetic in fp32 torch on (B, S, H, D) fp32 tensors:
    K3/K5 with `bound`, K2/K4 without, for the operand type `dtype` (bf16 or
    fp16: the pair's and the output's type). Returns (out, lse): the output,
    rounded once to `dtype`, as fp32, and the (B, Hq, Sq) row LSE the
    epilogue writes for K4/K5. fp16's static max packs each row's p at its
    power-of-two scale sc (2^127 at first; when a tile's max p * sc reaches
    2^15, sc = 2^(14 - floor(log2 max p)) and o is scaled by the change) and
    divides by l * sc at the end. `p_pair=False` drops P's lo half,
    `round_out=False` the output rounding and `row_scale=False` the fp16 row
    scale (for the tests of the pair and the scale alone)."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    rep = hq // hkv
    # the host folds every constant of the logit chain into the exp2 domain (fp32)
    scale2 = _f32(scale) * _f32(LOG2E)
    bound2 = _f32(0.0 if bound is None else bound) * _f32(LOG2E)
    clamp2 = _f32(55.0) * _f32(LOG2E)
    qg = q.reshape(b, sq, hkv, rep, d)
    valid = torch.ones(b, sk, dtype=torch.bool) if kv_mask is None else kv_mask != 0
    o = torch.zeros(b, hkv, rep, sq, d)
    l = torch.zeros(b, hkv, rep, sq)
    m = torch.full((b, hkv, rep, sq), -math.inf)
    scaled = dtype == torch.float16 and bound is not None and row_scale
    sc = torch.full((b, hkv, rep, sq), 2.0 ** 127)
    for j0 in range(0, sk, BK):  # the last tile is ragged: keys past Sk add nothing
        kt, vt = k[:, j0:j0 + BK], v[:, j0:j0 + BK]
        ok = valid[:, None, None, None, j0:j0 + BK]
        s = torch.einsum("bqhrd,bkhd->bhrqk", qg, kt)
        if bound is None:
            x = torch.where(ok, s * scale2, torch.tensor(-math.inf))
            m_new = torch.maximum(m, x.amax(-1))
            none = m_new == -math.inf  # no valid key so far: m stays -inf, o = l = 0
            alpha = torch.where(none, torch.ones_like(m), torch.exp2(m - m_new))
            shift = torch.where(none, torch.zeros_like(m), m_new)
            p = torch.exp2(x - shift[..., None])
            o, l, m = o * alpha[..., None], l * alpha, m_new
        else:
            e = torch.exp2(torch.clamp(s * scale2 - bound2, max=clamp2))
            p = torch.where(ok, e, torch.zeros_like(e))
            if scaled:
                mx = p.amax(-1)
                # 2^(14 - floor(log2 mx)); floor(log2 mx) is frexp's exponent - 1
                top = _pow2(15 - torch.frexp(mx)[1])
                new = torch.where(mx * sc >= 2.0 ** 15, top, sc)
                o, sc = o * (new / sc)[..., None], new
        packed = p * sc[..., None] if scaled else p
        hi = packed.to(dtype).float()
        lo = (packed - hi).to(dtype).float() if p_pair else torch.zeros_like(p)
        o = o + torch.einsum("bhrqk,bkhd->bhrqd", hi, vt) + torch.einsum("bhrqk,bkhd->bhrqd", lo, vt)
        l = l + p.sum(-1)
    den = l * sc if scaled else l
    inv = torch.where(l > 0, 1.0 / den.clamp_min(1e-30), torch.zeros_like(l))
    out = (o * inv[..., None]).permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d)
    # the epilogue: ln2 * (base + log2 l), the base the log2-domain max or bound2
    base = m if bound is None else bound2
    lse = _f32(math.log(2)) * (base + torch.log2(l))
    lse = torch.where(l > 0, lse, torch.full_like(l, -math.inf)).reshape(b, hq, sq)
    return (out.to(dtype).float() if round_out else out), lse


def _inputs(seed, b, sq, sk, hq, hkv, d=16, tail=0, dead_row=False, dtype=torch.bfloat16):
    """`dtype`-representable (bf16 or fp16) fp32 numpy inputs and an int32
    mask: the last `tail` keys of batch row 0 masked, and with `dead_row`
    every key of the last batch row."""
    rng = np.random.default_rng(seed)
    bf = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(
        dtype).float().numpy()
    q, k, v = bf(b, sq, hq, d), bf(b, sk, hkv, d), bf(b, sk, hkv, d)
    mask = np.ones((b, sk), np.int32)
    if tail:
        mask[0, sk - tail:] = 0
    if dead_row:
        mask[-1] = 0
    return q, k, v, mask


# (b, sq, sk, hq, hkv, masked tail): GQA 4 and 8, Sk below one tile, ragged
# last tiles, masked tails
CASES = [(2, 40, 32, 8, 1, 5), (1, 70, 100, 4, 1, 0), (2, 33, 130, 8, 2, 17),
         (1, 65, 200, 8, 1, 64)]
# (..., head_dim): the 48/48 and 96/96 instantiations at the short sequences
# their blocks fit (Sq 256 and 200 not a multiple of 64, Sk 256 and 1024)
WIDE_CASES = [(1, 256, 256, 4, 1, 0, 48), (2, 200, 1024, 2, 1, 37, 48),
              (1, 256, 1024, 2, 2, 0, 96), (2, 200, 256, 4, 2, 19, 96)]


def _case(case):
    """(b, sq, sk, hq, hkv, tail, head_dim) of a CASES (head_dim 16) or WIDE_CASES entry."""
    return (*case, 16) if len(case) == 6 else case


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=RTOL, atol=ATOL)


def _bound(q, k, v, mask, scale, offset):
    """The calibrated bound: max row LSE + offset (6 is the margin; a negative
    offset puts the bound below the row maxima, where the clamp fires)."""
    lse = tfa.flash_online_lse_plain(*map(torch.from_numpy, (q, k, v, mask)), scale)[1]
    return float(lse[torch.isfinite(lse)].max()) + offset


def _pallas_forward(entry, q, k, v, mask, scale, bound):
    """The JAX package's Pallas forward of `entry` in interpret mode: K1's
    single-pass small-KV kernel, or the streaming K2/K3."""
    args = tuple(map(jnp.asarray, (q, k, v, mask)))
    if entry == "small_kv":
        return jfa._flash_small_kv_impl(*args, scale, 128)
    return jfa._flash_attention_fwd_impl(*args, scale, 128, 128, static_max=bound)


@pytest.mark.parametrize("case", CASES + WIDE_CASES)
@pytest.mark.parametrize("entry", ["small_kv", "online", "static_max"])
def test_emulation_matches_pallas(entry, case):
    """K1 is the online kernel over all keys: the same emulation holds the
    single-pass exact softmax of `_flash_small_kv_kernel`; at head_dim 48 and
    96 (WIDE_CASES) the arithmetic of the 48/48 and 96/96 instantiations,
    whose zero columns add exact zeros to each sum."""
    b, sq, sk, hq, hkv, tail, d = _case(case)
    q, k, v, mask = _inputs(1, b, sq, sk, hq, hkv, d=d, tail=tail)
    scale = 0.3
    bound = _bound(q, k, v, mask, scale, 6.0) if entry == "static_max" else None
    ref = _pallas_forward(entry, q, k, v, mask, scale, bound)
    got = emulate(*map(torch.from_numpy, (q, k, v, mask)), scale, bound)[0]
    _close(got, ref)


def test_small_kv_emulation_at_the_jax_limit():
    """K1 at Sk = 1024, the most keys the JAX package sends it (16 tiles of
    64 keys, the running max moving across them), against the Pallas kernel,
    which holds all 1024 in one block."""
    q, k, v, mask = _inputs(11, 1, 20, 1024, 2, 1, tail=100)
    k = k * np.linspace(0.3, 2.0, 1024, dtype=np.float32)[None, :, None, None]
    k = torch.from_numpy(k).to(torch.bfloat16).float().numpy()
    ref = _pallas_forward("small_kv", q, k, v, mask, 0.4, None)
    _close(emulate(*map(torch.from_numpy, (q, k, v, mask)), 0.4)[0], ref)


@pytest.mark.parametrize("case", CASES + WIDE_CASES)
@pytest.mark.parametrize("entry", ["online_lse", "static_max_lse"])
def test_lse_emulation_matches_pallas(entry, case):
    """K4/K5: the output and the epilogue's row LSE against the Pallas
    `_flash_fwd_res_impl` (whose LSE is lane-replicated to 128 and padded to
    its q block: sliced to (B, Hq, Sq)); at head_dim 48 and 96 as well."""
    b, sq, sk, hq, hkv, tail, d = _case(case)
    q, k, v, mask = _inputs(7, b, sq, sk, hq, hkv, d=d, tail=tail)
    scale = 0.3
    bound = _bound(q, k, v, mask, scale, 8.0) if entry == "static_max_lse" else None
    ref_out, ref_lse = jfa._flash_fwd_res_impl(*map(jnp.asarray, (q, k, v, mask)), scale, 128, 128,
                                               static_max=bound)
    out, lse = emulate(*map(torch.from_numpy, (q, k, v, mask)), scale, bound)
    _close(out, ref_out)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[:, :, :sq, 0], rtol=0,
                               atol=LSE_ATOL)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("entry", ["online_lse", "static_max_lse"])
def test_lse_emulation_matches_plain(entry, case):
    b, sq, sk, hq, hkv, tail = case
    q, k, v, mask = map(torch.from_numpy, _inputs(8, b, sq, sk, hq, hkv, tail=tail))
    scale = 0.25
    if entry == "static_max_lse":
        bound = _bound(*(t.numpy() for t in (q, k, v, mask)), scale, 8.0)
        ref_out, ref_lse = tfa.flash_static_max_lse_plain(q, k, v, mask, scale, bound)
    else:
        bound = None
        ref_out, ref_lse = tfa.flash_online_lse_plain(q, k, v, mask, scale)
    out, lse = emulate(q, k, v, mask, scale, bound)
    _close(out, ref_out)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=LSE_ATOL)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("entry", ["small_kv", "online", "static_max"])
def test_emulation_matches_plain(entry, case):
    b, sq, sk, hq, hkv, tail = case
    q, k, v, mask = map(torch.from_numpy, _inputs(2, b, sq, sk, hq, hkv, tail=tail))
    scale = 0.25
    if entry == "static_max":
        bound = _bound(*(t.numpy() for t in (q, k, v, mask)), scale, 6.0)
        ref = tfa.flash_static_max_plain(q, k, v, mask, scale, bound)
    else:
        bound, ref = None, getattr(tfa, f"flash_{entry}_plain")(q, k, v, mask, scale)
    _close(emulate(q, k, v, mask, scale, bound)[0], ref)


def test_clamp_in_log2_units_matches_pallas():
    """A bound 70 nats below the largest row LSE: the clamp at 55 nats fires
    on some keys, at 55*log2(e) in the exp2 domain."""
    q, k, v, mask = _inputs(3, 1, 24, 150, 4, 2, tail=9)
    q = q * 4  # logits up to ~100: exp(s - bound) reaches the clamp
    scale = 0.5
    bound = _bound(q, k, v, mask, scale, -70.0)
    s = np.einsum("bqhd,bkhd->bhqk", q[:, :, ::2], k) * scale
    assert (s - bound > 55).any()  # the clamp is exercised
    ref = jfa._flash_attention_fwd_impl(*map(jnp.asarray, (q, k, v, mask)), scale, 128, 128,
                                        static_max=bound)
    _close(emulate(*map(torch.from_numpy, (q, k, v, mask)), scale, bound)[0], ref)


@pytest.mark.parametrize("entry", ["online", "static_max"])
def test_fully_masked_row_is_zero(entry):
    """A batch row without a valid key outputs 0 (the -inf guard keeps K2's
    running max from producing NaN); the other rows match the port's plain
    version."""
    q, k, v, mask = map(torch.from_numpy, _inputs(4, 2, 20, 90, 4, 1, tail=11, dead_row=True))
    bound = 8.0 if entry == "static_max" else None
    got = emulate(q, k, v, mask, 0.3, bound)[0]
    assert torch.equal(got[1], torch.zeros_like(got[1]))
    ref = (tfa.flash_static_max_plain(q, k, v, mask, 0.3, bound) if bound is not None
           else tfa.flash_online_plain(q, k, v, mask, 0.3))
    assert torch.equal(ref[1], torch.zeros_like(ref[1]))
    _close(got[0], ref[0])


@pytest.mark.parametrize("entry", ["online_lse", "static_max_lse"])
def test_fully_masked_row_has_lse_minus_inf(entry):
    """K4/K5: a batch row without a valid key outputs 0 and has LSE -inf
    (l = 0 in the epilogue), the same rows as the plain version's; the other
    rows' LSE match it."""
    q, k, v, mask = map(torch.from_numpy, _inputs(9, 2, 20, 90, 4, 1, tail=11, dead_row=True))
    if entry == "static_max_lse":
        bound = 8.0
        ref_out, ref_lse = tfa.flash_static_max_lse_plain(q, k, v, mask, 0.3, bound)
    else:
        bound = None
        ref_out, ref_lse = tfa.flash_online_lse_plain(q, k, v, mask, 0.3)
    out, lse = emulate(q, k, v, mask, 0.3, bound)
    assert torch.equal(out[1], torch.zeros_like(out[1])) and torch.isneginf(lse[1]).all()
    assert torch.equal(torch.isfinite(lse), torch.isfinite(ref_lse))
    assert torch.isfinite(lse[0]).all()
    torch.testing.assert_close(lse[0], ref_lse[0], rtol=0, atol=LSE_ATOL)
    _close(out[0], ref_out[0])


def test_online_rescale_across_tiles():
    """Row maxima that grow from tile to tile (the alpha rescale runs on
    every tile) and a first tile whose keys are all masked (m stays -inf,
    alpha is guarded)."""
    q, k, v, mask = _inputs(5, 1, 16, 200, 2, 2)
    k = k * np.linspace(0.2, 3.0, 200, dtype=np.float32)[None, :, None, None]
    k = torch.from_numpy(k).to(torch.bfloat16).float().numpy()
    mask[0, :BK] = 0
    ref = jfa._flash_attention_fwd_impl(*map(jnp.asarray, (q, k, v, mask)), 0.5, 128, 128)
    _close(emulate(*map(torch.from_numpy, (q, k, v, mask)), 0.5)[0], ref)


def test_hi_lo_pair_keeps_p_to_fp32_precision():
    """Before the output rounding: P rounded once to bf16 (8 mantissa bits)
    moves the output by ~1e-4 of its size here; the hi + lo pair carries p to
    ~16 bits, which leaves the output within 2^-14 of the fp32 softmax."""
    q, k, v, mask = map(torch.from_numpy, _inputs(6, 1, 64, 256, 4, 4, d=32))
    ref = tfa.flash_online_plain(q, k, v, mask, 0.2)
    top = ref.abs().max()
    pair = (emulate(q, k, v, mask, 0.2, round_out=False)[0] - ref).abs().max()
    once = (emulate(q, k, v, mask, 0.2, p_pair=False, round_out=False)[0] - ref).abs().max()
    assert pair <= 2.0 ** -14 * top
    assert once > 8 * pair


# -- the instantiations: products' depth and width, block -----------------------------


# (largest head_dim, depth, width) of the forward's products
WIDTHS = ((48, 48, 48), (64, 64, 64), (72, 80, 72), (96, 96, 96), (128, 128, 128))


# the main paths' shapes (head_dim, Sq, Sk): the Small's and the 600M's
# samplers, the 600M's trainer, the ImageNet 7B, the Flag-DiT 5B's self-
# and caption attention, the 2B's self-attention and its sampler's and
# trainer's caption attention, the music trainer's self- and caption
# attention, the 2B's DreamBooth, FlagDiT-1D's served self- and caption
# attention and MMDiT-SD3-Medium's joint sequence at 1024^2
MAIN_SHAPES = {"small": (48, 1024, 1024), "600m": (48, 256, 256), "600m_train": (48, 256, 256),
               "7b": (128, 256, 256), "5b": (96, 4160, 4160), "5b_captions": (96, 4160, 128),
               "2b": (72, 4096, 4096), "2b_captions": (72, 4096, 256),
               "2b_train_captions": (72, 4096, 32), "music_train": (72, 256, 256),
               "music_captions": (72, 256, 77), "2b_db": (72, 256, 256), "audio": (72, 128, 128),
               "audio_captions": (72, 128, 16), "sd3": (64, 4429, 4429)}


@pytest.mark.parametrize("shape", [(d, sq, sk) for d in range(8, 129, 8)
                                   for sq, sk in ((256, 256), (4096, 256), (4096, 4096),
                                                  (128, 128), (256, 129), (4096, 1024),
                                                  (4096, 1025))]
                         + list(MAIN_SHAPES.values()))
def test_fwd_instantiation_by_head_dim_and_keys(shape):
    """`fwd_sm90_instantiation` names what `launch()` runs (the card's
    `test_kernel_resources` holds it against the compiled kernel): the
    products' depth and width by head_dim (48/48, 64/64, 80/72, 96/96,
    128/128); at 80/72 over at most 256 keys and at least 512 query rows
    the K/V-resident block (one an SM, its rows set at launch: 0); else
    64-row blocks, three an SM, up to 80/72 over at most 1024 keys, else 192
    rows, one an SM."""
    d, sq, sk = shape
    depth, width = next(row[1:] for row in WIDTHS if d <= row[0])
    resident = width == 72 and sk <= 256 and sq >= 512
    few = width <= 72 and sk <= tfa._SMALL_KV_MAX
    rows, blocks = (0, 1) if resident else (64, 3) if few else (192, 1)
    assert tfa.fwd_sm90_instantiation(d, sq, sk) == (depth, width, rows, blocks)
    assert depth >= d and depth % 16 == 0 and width >= d and width % 8 == 0


@pytest.mark.parametrize("name,expected", [
    ("small", (48, 48, 64, 3)), ("600m", (48, 48, 64, 3)), ("600m_train", (48, 48, 64, 3)),
    ("7b", (128, 128, 192, 1)), ("5b", (96, 96, 192, 1)), ("5b_captions", (96, 96, 192, 1)),
    ("2b", (80, 72, 192, 1)), ("2b_captions", (80, 72, 0, 1)),
    ("2b_train_captions", (80, 72, 0, 1)), ("music_train", (80, 72, 64, 3)),
    ("music_captions", (80, 72, 64, 3)), ("2b_db", (80, 72, 64, 3)), ("audio", (80, 72, 64, 3)),
    ("audio_captions", (80, 72, 64, 3)), ("sd3", (64, 64, 192, 1))])
def test_fwd_instantiation_at_the_main_paths(name, expected):
    """The main paths' instantiations: 48/48 and 96/96 where the widths are
    48 and 96; at head_dim 48 and 72 over few keys a block that fits 128,
    256 and 1024 query rows (no 64-row tile of a head left empty), three
    resident an SM (at 80/72: the music trainer's self- and caption
    attention, DreamBooth, FlagDiT-1D); the 2B's sampler and trainer
    captions (4096 query rows over 256 and 32 keys, B=2 under CFG, 32
    heads) in the K/V-resident block, 32 whole 64-row tiles a block, two a
    head (one wave of 128 blocks); the 2B's and SD3's self-attention over
    more than 1024 keys in 192 rows."""
    d, sq, sk = MAIN_SHAPES[name]
    got = tfa.fwd_sm90_instantiation(d, sq, sk)
    assert got == expected
    rows = got[2] or 64 * tfa.resident_split(2, sq, 32)[0]
    if got[2] == 0:
        assert tfa.resident_split(2, sq, 32) == (32, 2)
    if d in (48, 72) and sk <= tfa._SMALL_KV_MAX:
        assert -(-sq // rows) * rows == -(-sq // 64) * 64


def resident_work(b, sq, hq, hkv, sms=tfa.H100_SMS, consumers=2, stages=4):
    """The K/V-resident block's work, as `csrc/flash_fwd_sm90.cu` splits it:
    `resident_split`'s 64-row Q tiles a block, a block per (chunk of them,
    q head, batch row); in it the producer loads the kv head's K/V once,
    then its Q tiles up to Sq, rounded up to a whole round of the
    consumers, into a ring of `stages`; consumer c takes tiles c, c +
    consumers, ... Returns the K/V loads as (block, b, kv head), the Q
    tiles taken as (b, h, tile, consumer, ring stage, use of the stage), and
    the tiles written (those below Sq)."""
    loads, taken, written = [], [], []
    per_block, chunks = tfa.resident_split(b, sq, hq, sms)
    rows = 64 * per_block
    for bi, h, chunk in itertools.product(range(b), range(hq), range(chunks)):
        q0 = chunk * rows
        loads.append(((chunk, h, bi), bi, h // (hq // hkv)))
        tiles = min(per_block, -(-(sq - q0) // 64))
        rounds = -(-tiles // consumers)
        for t, c in itertools.product(range(rounds), range(consumers)):
            i = t * consumers + c
            tile = q0 // 64 + i
            taken.append((bi, h, tile, c, i % stages, i // stages))
            if 64 * tile < sq:
                written.append((bi, h, tile))
    return loads, taken, written


@pytest.mark.parametrize("b,sq,hq,hkv,sms", [(2, 4096, 32, 32, 132), (1, 1000, 8, 2, 132),
                                             (2, 4097, 8, 2, 132), (1, 512, 4, 1, 132),
                                             (3, 520, 4, 4, 132), (1, 131072, 32, 8, 132),
                                             (4, 4096, 64, 16, 132), (2, 4096, 32, 32, 114)])
def test_kv_resident_block_work_split(b, sq, hq, hkv, sms):
    """Every (batch row, q head, 64-row tile) below Sq is written exactly
    once, by the consumer whose turn it is; a block loads its K/V once, from
    its kv head (4:1 GQA: q head h reads kv head h // 4); the blocks fit one
    wave of the SMs where the heads allow (the 2B's captions: 128 blocks of
    32 tiles on 132 SMs) and take whole rounds of tiles; a consumer takes as
    many tiles as the other (their turns alternate), so a block's last round
    may hold a tile past Sq, which is computed and not written; each
    consumer keeps to its two ring stages and uses them in turn."""
    assert tfa.fwd_sm90_instantiation(72, sq, 256) == (80, 72, 0, 1)
    loads, taken, written = resident_work(b, sq, hq, hkv, sms)
    per_block, chunks = tfa.resident_split(b, sq, hq, sms)
    blocks = b * hq * chunks
    assert per_block % 2 == 0 and (blocks <= sms or chunks == 1)
    if (b, sq, hq, sms) == (2, 4096, 32, 132):
        assert (per_block, blocks) == (32, 128)
    assert len(loads) == len({blk for blk, *_ in loads}) == blocks
    assert all(kv == blk[1] // (hq // hkv) for blk, _, kv in loads)
    tiles = [(bi, h, t) for bi in range(b) for h in range(hq) for t in range(-(-sq // 64))]
    assert sorted(written) == tiles
    by_consumer = {c: [x for x in taken if x[3] == c] for c in (0, 1)}
    assert len(by_consumer[0]) == len(by_consumer[1])
    assert all(x[4] % 2 == x[3] for x in taken)  # consumer c: stages c and c + 2
    past = [x for x in taken if 64 * x[2] >= sq]
    assert len(past) == len(taken) - len(written) and len(past) <= b * hq * chunks


def test_kv_resident_emulation_matches_pallas():
    """K1 and K4 at a shape the K/V-resident block runs (head_dim 72, 520
    query rows, 136 keys: two blocks a head, the second with one row; 4:1
    GQA, a masked tail and a fully masked batch row) against the JAX
    package's Pallas K4 (`_flash_fwd_res_impl`) in interpret mode: the
    emulation (`emulate`), which every block repeats bit for bit, gives K1's
    output (K1 is K4's kernel without the LSE pointer) and K4's output and
    LSE; the dead row is 0 with LSE -inf, as the port's plain version."""
    b, sq, sk, hq, hkv, d = 2, 520, 136, 8, 2, 72
    assert tfa.fwd_sm90_instantiation(d, sq, sk) == (80, 72, 0, 1)
    q, k, v, mask = _inputs(31, b, sq, sk, hq, hkv, d=d, tail=29, dead_row=True)
    scale = d ** -0.5
    ref_out, ref_lse = jfa._flash_fwd_res_impl(*map(jnp.asarray, (q, k, v, mask)), scale, 128,
                                               128)
    tq, tk, tv, tm = map(torch.from_numpy, (q, k, v, mask))
    out, lse = emulate(tq, tk, tv, tm, scale)
    _close(out[0], np.asarray(ref_out)[0])
    np.testing.assert_allclose(lse[0].numpy(), np.asarray(ref_lse)[0, :, :sq, 0], rtol=0,
                               atol=LSE_ATOL)
    plain_out, plain_lse = tfa.flash_online_lse_plain(tq, tk, tv, tm, scale)
    assert torch.equal(out[1], torch.zeros_like(out[1])) and torch.isneginf(lse[1]).all()
    assert torch.equal(plain_out[1], out[1]) and torch.equal(plain_lse[1], lse[1])
    _close(out[0], plain_out[0])


def test_fwd_instantiation_rejects_what_no_kernel_takes():
    for d in (0, 136):
        with pytest.raises(ValueError, match="head_dim up to 128"):
            tfa.fwd_sm90_instantiation(d, 256, 256)


# -- fp16: the kernel's fp16 instantiation -------------------------------------------

F16 = torch.float16
RTOL16 = 2.0 ** -11  # one fp16 rounding of the output (11 significant bits)


def _close16(got, ref):
    """The fp16 bar against the port's plain version: one fp16 rounding of
    the output (2^-11 of |ref|) plus 2e-5 for fp32 sums in another order."""
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=RTOL16, atol=ATOL)


def _pallas16_bars(q, k, v, mask, scale, bound, ref):
    """Elementwise bars (output, LSE) between the emulation and the JAX
    package's fp16 Pallas kernels, which round p once to fp16
    (`p.astype(v.dtype)`, and the denominator from those p): their output
    moves by up to 2^-11 of sum_j p_j |v_j| / l (the relative error of a
    normal fp16 rounding), plus 2^-25 |v_j| / l for each p_j under fp16's
    smallest normal 2^-14 (half its subnormal step; p from the row's final
    max, which is no larger than its running max in the kernel), plus two
    output roundings (2^-10 of |ref|) and 2e-5 for fp32 sums; their LSE by
    the same weights' sum (|dl| / l), plus 1e-4."""
    tq, tk, tv, tm = map(torch.from_numpy, (q, k, v, mask))
    s, valid = tfa._logits(tq, tk, tm, scale)
    if bound is None:
        p = torch.exp(s - s.amax(-1, keepdim=True))
    else:
        p = torch.exp(torch.clamp(s - bound, max=55.0))
    p = torch.where(valid, p, torch.zeros_like(p))
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    weights = (2.0 ** -11 * p + 2.0 ** -25 * (p < 2.0 ** -14).float() * valid) / l
    b, sq, hq, d = tq.shape
    moved = torch.einsum("bhrqk,bkhd->bqhrd", weights, tv.abs()).reshape(b, sq, hq, d)
    lse_moved = weights.sum(-1).reshape(b, hq, sq)
    return (moved.numpy() + 2.0 ** -10 * np.abs(np.asarray(ref)) + ATOL,
            lse_moved.numpy() + LSE_ATOL)


def _pallas16(entry, q, k, v, mask, scale, bound):
    """`_pallas_forward` (or the LSE forward's output) on fp16 arrays, as fp32."""
    q, k, v = (a.astype(np.float16) for a in (q, k, v))
    if entry.endswith("_lse"):
        out, lse = jfa._flash_fwd_res_impl(*map(jnp.asarray, (q, k, v, mask)), scale, 128, 128,
                                           static_max=bound)
        return np.asarray(out, np.float32), np.asarray(lse)
    return np.asarray(_pallas_forward(entry, q, k, v, mask, scale, bound), np.float32), None


@pytest.mark.parametrize("case", CASES[1:3])
@pytest.mark.parametrize("entry", ["small_kv", "online", "static_max", "online_lse",
                                   "static_max_lse"])
def test_fp16_emulation_matches_pallas(entry, case):
    """The fp16 instantiation's arithmetic (the fp16 pair, fp16's row scale
    under a static max, one fp16 output rounding) against the JAX package's
    Pallas K1-K5 on fp16 inputs in interpret mode, within what their own
    rounding of p to fp16 moves (`_pallas16_bars`, for the output and the
    LSE)."""
    b, sq, sk, hq, hkv, tail = case
    q, k, v, mask = _inputs(21, b, sq, sk, hq, hkv, tail=tail, dtype=F16)
    scale = 0.3
    bound = (_bound(q, k, v, mask, scale, 8.0 if entry.endswith("_lse") else 6.0)
             if entry.startswith("static_max") else None)
    ref, ref_lse = _pallas16(entry, q, k, v, mask, scale, bound)
    out, lse = emulate(*map(torch.from_numpy, (q, k, v, mask)), scale, bound, dtype=F16)
    out_bar, lse_bar = _pallas16_bars(q, k, v, mask, scale, bound, ref)
    np.testing.assert_array_less(np.abs(out.numpy() - ref), out_bar)
    if ref_lse is not None:
        np.testing.assert_array_less(np.abs(lse.numpy() - ref_lse[:, :, :sq, 0]), lse_bar)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("entry", ["small_kv", "online", "static_max", "online_lse",
                                   "static_max_lse"])
def test_fp16_emulation_matches_plain(entry, case):
    """The fp16 arithmetic against the port's plain versions on the same
    fp16-representable inputs: one fp16 output rounding, the LSE to 1e-4."""
    b, sq, sk, hq, hkv, tail = case
    q, k, v, mask = map(torch.from_numpy, _inputs(22, b, sq, sk, hq, hkv, tail=tail, dtype=F16))
    scale = 0.25
    kw = {}
    if entry.startswith("static_max"):
        kw = {"bound": _bound(*(t.numpy() for t in (q, k, v, mask)), scale,
                              8.0 if entry.endswith("_lse") else 6.0)}
    ref = getattr(tfa, f"flash_{entry}_plain")(q, k, v, mask, scale, *kw.values())
    out, lse = emulate(q, k, v, mask, scale, kw.get("bound"), dtype=F16)
    if entry.endswith("_lse"):
        ref, ref_lse = ref
        torch.testing.assert_close(lse, ref_lse, rtol=0, atol=LSE_ATOL)
    _close16(out, ref)


def test_fp16_pair_and_row_scale_keep_p_to_fp32_precision():
    """Before the output rounding, fp16 P against the fp32 softmax: p near 1
    and tiny p (online, logits spread over ~60 nats), a bound 30 nats over
    the row maxima (every p under 2^-43, below fp16's subnormals) and one 15
    nats or more under them where the 55-nat clamp fires on some keys (p up
    to e^55, past fp16's 65504). The pair and fp16's row scale keep the
    output within 2^-14 of max|ref|; P rounded once moves it 8x further, and
    without the row scale the bound over the maxima flushes every p (0, not
    the softmax) and the clamp rows overflow (inf or NaN)."""
    q, k, v, mask = _inputs(23, 1, 64, 256, 4, 4, d=32, tail=19, dtype=F16)
    spread = torch.from_numpy(q) * 3  # logits over tens of nats
    q = spread.to(F16).float().numpy()
    scale = 0.3
    s = np.einsum("bqhd,bkhd->bhqk", q, k) * scale
    row_max = np.where(mask[:, None, None, :] != 0, s, -np.inf).max(-1)
    tq, tk, tv, tm = map(torch.from_numpy, (q, k, v, mask))
    clamped = min(float(row_max.min()) - 15.0, float(row_max.max()) - 60.0)
    for bound in (None, float(row_max.max()) + 30.0, clamped):
        if bound is None:
            ref = tfa.flash_online_plain(tq, tk, tv, tm, scale)
        else:
            ref = tfa.flash_static_max_plain(tq, tk, tv, tm, scale, bound)
        top = ref.abs().max()
        pair = emulate(tq, tk, tv, tm, scale, bound, round_out=False, dtype=F16)[0]
        once = emulate(tq, tk, tv, tm, scale, bound, p_pair=False, round_out=False, dtype=F16)[0]
        assert (pair - ref).abs().max() <= 2.0 ** -14 * top, bound
        assert (once - ref).abs().max() > 8 * (pair - ref).abs().max(), bound
        if bound is not None:
            bare = emulate(tq, tk, tv, tm, scale, bound, round_out=False, dtype=F16,
                           row_scale=False)[0]
            if bound > row_max.max():
                assert not bare.any()  # every p flushed: the output is 0
            else:
                assert (s - bound > 55).any()  # the clamp fires
                assert not torch.isfinite(bare).all()


def _entry_bodies():
    """{entry name: C source from its signature on} of flash_fwd.cu's
    extern "C" entry points."""
    src = (cuda_lib._CSRC / "flash_fwd.cu").read_text()
    return src, {e.split("(", 1)[0]: e.split("{", 1)[1]
                 for e in src.split('extern "C" {')[1].split("int lumina_flash_")[1:]}


def test_bf16_forwards_route_to_the_hopper_kernel():
    """bf16 and fp16 K1-K5 hand their inputs to `flash_fwd_sm90` with the
    fp16 flag from their dtype code (K4/K5 with their lse pointer, K1-K3
    with none, none with rotation tables), and so does K9 with the tables
    and no LSE (`rope_forward`); fp32 K1-K5 hand theirs to the fp32 kernel,
    `flash_fwd_fp32_sm90`, with the same (static max, LSE) flags and bound,
    and fp32 K9 to its online instantiation; another dtype code is refused.
    The entry points' file holds no kernel of its own and casts nothing."""
    src, bodies = _entry_bodies()
    for name, static_max, lse in (("small_kv", "false", "nullptr"), ("online", "false", "nullptr"),
                                  ("static_max", "true", "nullptr"),
                                  ("online_lse", "false", "lse"),
                                  ("static_max_lse", "true", "lse")):
        bound = "bound" if static_max == "true" else "0.f"
        assert re.search(rf"return forward\({static_max}, q, k, v, mask, out, {lse}, meta, scale, "
                         rf"{bound}, dtype, stream\);", bodies[name]), name
    forward = src[src.index("int forward("):src.index("int rope_forward(")]
    assert re.search(r"if \(dtype == kBf16 \|\| dtype == kFp16\)\s+return flash_fwd_sm90\(dtype == "
                     r"kFp16, static_max, q, k, v, mask, out, lse, nullptr, nullptr,\s+meta, scale, "
                     r"bound, stream\);", forward)
    assert "if (dtype != kFp32) return (int)cudaErrorInvalidValue;" in forward
    assert "return flash_fwd_fp32_sm90(static_max, q, k, v, mask, out, lse, meta, scale, bound, " \
        "stream);" in forward
    assert "constexpr int kFp32 = 0, kBf16 = 1, kFp16 = 2;" in src
    assert tfa._DTYPE_CODES == {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
    for name in ("rope", "rope_q"):
        assert "return rope_forward(q, k, v, mask, out, rope_cos, rope_sin, meta, scale, dtype," \
            in bodies[name]
    rope = src[src.index("int rope_forward("):src.index("}  // namespace")]
    assert re.search(r"if \(dtype == kBf16 \|\| dtype == kFp16\) \{.*return flash_fwd_sm90\(dtype == "
                     r"kFp16, false, q, k, v, mask, out, nullptr, rope_cos, rope_sin,\s+meta, scale, "
                     r"0.f, stream\);", rope, re.S)
    assert "return flash_fwd_fp32_sm90(false, q, k, v, mask, out, nullptr, meta, scale, 0.f, " \
        "stream);" in rope
    assert tfa._SM90_ENTRIES == ("small_kv", "online", "static_max", "online_lse",
                                 "static_max_lse")
    assert "__nv_bfloat16" not in src and "__half" not in src and "wmma" not in src
    assert "kRope" not in src and "launch<" not in src and "__global__" not in src


def test_breakdown_entry_matches_the_kernel_signature():
    """`exps/fwd_sm90_breakdown.py` compiles its own C entry around
    `flash_fwd_sm90`: it passes the header's parameters in their order, bf16
    with no LSE (it times K2/K3); the definition has the header's
    parameters."""
    from lumina_t2x_tpu_torch.exps import fwd_sm90_breakdown as bd

    def names(text, pattern):
        params = re.search(pattern, text, re.S).group(1)
        return [p.split()[-1].lstrip("*") for p in params.split(",")]

    header = names((cuda_lib._CSRC / "flash_fwd_sm90.cuh").read_text(),
                   r"int flash_fwd_sm90\((.*?)\);")
    assert header == ["f16", "static_max", "q", "k", "v", "mask", "out", "lse", "rope_cos",
                      "rope_sin", "meta", "scale", "bound", "stream"]
    assert names((cuda_lib._CSRC / "flash_fwd_sm90.cu").read_text(),
                 r"\nint flash_fwd_sm90\((.*?)\) \{") == header
    args = re.search(r"return flash_fwd_sm90\((.*?)\);", bd._ENTRY, re.S).group(1)
    assert [a.strip() for a in args.split(",")] == [
        "false", "static_max != 0", *header[2:7], "nullptr", "nullptr", "nullptr", *header[10:]]


def test_breakdown_variants_edit_the_kernel():
    """`exps/fwd_sm90_breakdown.py` times variants of the kernel's source with
    parts taken out; every edit applies to the source as it is (a changed
    kernel fails here instead of timing something else)."""
    from lumina_t2x_tpu_torch.exps import fwd_sm90_breakdown as bd

    source = bd.kernel_source()
    assert "struct KvRing" in source and "produce_kv<L>(" in source  # the header pasted in
    texts = {name: bd.variant_source(name, source) for name in bd._EDITS}
    assert texts["kernel"].startswith(source) and "breakdown_fwd" in texts["kernel"]
    assert len(set(texts.values())) == len(texts)
    # --blocks: launch() forced to each block of BLOCKS, every one a block
    # the port picks somewhere or one the choice was made against
    blocks = bd.blocks_source(source)
    assert "return by_block(p.D, p.Sq, p.Sk," in blocks and "breakdown_block" in blocks
    picked = {tfa.fwd_sm90_instantiation(d, sq, sk) for d in (48, 64, 72, 96, 128)
              for sq, sk in ((256, 256), (4096, 256), (4096, 4096))}
    assert picked <= {(a, b, 64 * t if t > 0 else 0 if t else 64 * c, n)
                      for a, b, c, n, t in bd.BLOCKS}


def test_breakdown_chain_variants_edit_the_kernel():
    """`--chain`'s variants of the online chain and the consumers' turns:
    every edit applies to the source as it is, each variant is its own
    source, and each exports the breakdown entry."""
    from lumina_t2x_tpu_torch.exps import fwd_sm90_breakdown as bd

    source = bd.kernel_source()
    texts = {name: bd.variant_source(name, source, bd._CHAIN) for name in bd._CHAIN}
    assert texts["kernel"].startswith(source)
    assert all("breakdown_fwd" in text for text in texts.values())
    assert len(set(texts.values())) == len(texts)


@pytest.mark.parametrize("module", ["lumina_t2x_tpu_torch.exps.fwd_sm90_breakdown",
                                    "lumina_t2x_tpu_torch.pipelines.profile_forward",
                                    "lumina_t2x_tpu_torch.exps.fp16_times",
                                    "lumina_t2x_tpu_torch.exps.fwd_head_dim_times"])
def test_measurement_scripts_need_the_card(monkeypatch, module):
    """The breakdown, the forward profile, the fp16-against-bf16 times and
    the head_dim times time the card: without a CUDA device they stop before
    building anything, with no CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = importlib.import_module(module).main
    with pytest.raises(SystemExit, match="CUDA device"):
        main([]) if "argv" in inspect.signature(main).parameters else main()


def test_breakdown_and_times_cover_the_main_shapes():
    """The breakdown and the head_dim times take the same named shapes, the
    main paths' (`MAIN_SHAPES`), each at its (B, Sq, H, D)."""
    from lumina_t2x_tpu_torch.exps import fwd_head_dim_times as times
    from lumina_t2x_tpu_torch.exps import fwd_sm90_breakdown as bd

    assert set(bd.SHAPES) == set(times.SHAPES)
    for name, (shape, sks) in bd.SHAPES.items():
        assert times.SHAPES[name][0] == shape
        d, sq = shape[3], shape[1]
        assert MAIN_SHAPES.get(name, (d, sq, sks[0]))[:2] == (d, sq)


# -- on the card: the kernel against its plain version ------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _cuda_inputs(b, sq, sk, hq, hkv, d=72, seed=0, dead_row=True):
    g = torch.Generator().manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g).to("cuda", torch.bfloat16)
    mask = torch.ones(b, sk, dtype=torch.int32)
    mask[0, sk - sk // 5:] = 0
    if dead_row:
        mask[-1] = 0
    return mk(b, sq, hq, d), mk(b, sk, hkv, d), mk(b, sk, hkv, d), mask.cuda()


ENTRIES = ["small_kv", "online", "static_max", "online_lse", "static_max_lse"]


def _call(entry, q, k, v, mask, scale=0.2, bound=9.0):
    """The kernel's and the plain version's output; for K4/K5 the LSE is
    checked here (1e-3 absolute, the same -inf rows) and the outputs
    returned."""
    kw = {"bound": bound} if entry.startswith("static_max") else {}
    got = getattr(tfa, f"flash_{entry}")(q, k, v, mask, scale, **kw)
    ref = getattr(tfa, f"flash_{entry}_plain")(q.float(), k.float(), v.float(), mask, scale,
                                               *kw.values())
    torch.cuda.synchronize()
    if entry.endswith("_lse"):
        (got, lse), (ref, ref_lse) = got, ref
        assert lse.dtype == torch.float32 and lse.shape == (q.shape[0], q.shape[2], q.shape[1])
        fin = torch.isfinite(ref_lse)
        assert torch.equal(torch.isfinite(lse), fin)
        assert torch.equal(torch.isneginf(lse), ~fin)
        if fin.any():
            assert (lse[fin] - ref_lse[fin]).abs().max().item() <= 1e-3
    return got, ref


# head_dim 48 and 96 at Sq 200 and 1000 (not multiples of 64), 4:1 GQA, over
# few keys (48/48's 64-row blocks) and over more than 1024 (192 rows)
WIDE_SHAPES = [(2, 200, 1000, 8, 2, 48), (1, 1000, 1000, 8, 2, 48), (1, 1000, 1200, 8, 2, 48),
               (2, 200, 1000, 8, 2, 96), (2, 1000, 300, 8, 2, 96), (1, 200, 1500, 8, 2, 96)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (2, 77, 33, 8, 1, 72), (2, 130, 257, 4, 2, 72), (1, 300, 1000, 8, 8, 72), (3, 1, 1, 2, 1, 72),
    (2, 200, 300, 4, 1, 48), (1, 70, 90, 4, 2, 16), (1, 129, 200, 8, 2, 64),
    (2, 65, 130, 4, 4, 96), (1, 193, 129, 4, 1, 128), *WIDE_SHAPES])
@pytest.mark.parametrize("entry", ENTRIES)
def test_kernel_matches_plain_on_card(cuda_device, entry, shape):
    """Odd Sq and Sk, GQA, a masked tail and a fully masked batch row, at
    head_dim 72 (the 2B) and in each of the kernel's other instantiations:
    48/48 (head_dim 48 of the 600M, 16 of the Tiny model), 64/64, 96/96 and
    128/128, each over few keys and over many (its two blocks); K1 at Sk <=
    1024 like every other entry, one partial tile to 16 tiles."""
    q, k, v, mask = _cuda_inputs(*shape)
    before = tfa.LAUNCHES[entry]
    got, ref = _call(entry, q, k, v, mask)
    assert tfa.LAUNCHES[entry] == before + 1  # one launch per call
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert torch.count_nonzero(got[-1]).item() == 0
    err = (got.float() - ref).abs()
    assert err.max().item() <= 1e-2 and err.mean().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 77, 33, 8, 1, 72), (1, 300, 1000, 8, 8, 72),
                                   (2, 200, 300, 4, 1, 48), (1, 193, 129, 4, 1, 128),
                                   *WIDE_SHAPES])
@pytest.mark.parametrize("entry", ENTRIES)
def test_fp16_kernel_matches_plain_on_card(cuda_device, entry, shape):
    """The fp16 instantiation at the 80/72, 48/48, 96/96 and 128/128 widths, GQA, a
    masked tail and a fully masked batch row; the static max with bounds 30
    nats over and 20 under the row maxima as well (fp16's row scale): one
    launch on fp16 operands, fp16 out within 1e-3 of max|ref| (one fp16
    rounding is 2^-11)."""
    q, k, v, mask = (t.half() if t.is_floating_point() else t for t in _cuda_inputs(*shape))
    bounds = [9.0]
    if entry.startswith("static_max"):
        row_max = tfa._logits(q, k, mask, 0.2)[0].amax(-1)
        live = row_max[row_max > -1e38]  # the rows with a valid key (none: one dead batch row)
        if live.numel():
            bounds += [float(live.max()) + 30.0, float(live.min()) - 20.0]
    for bound in bounds:
        before = tfa.DTYPE_LAUNCHES[f"{entry}_fp16"]
        got, ref = _call(entry, q, k, v, mask, bound=bound)
        assert tfa.DTYPE_LAUNCHES[f"{entry}_fp16"] == before + 1
        assert got.dtype == torch.float16 and torch.isfinite(got).all()
        assert torch.count_nonzero(got[-1]).item() == 0
        top = ref.abs().max().item()
        assert (got.float() - ref).abs().max().item() <= 1e-3 * top, bound


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ENTRIES)
def test_fused_qkv_views_read_in_place(cuda_device, entry):
    """q, k, v as strided views of one (B, S, 3, H, D) tensor: whole-chunk
    strides, so the kernel reads them in place."""
    g = torch.Generator().manual_seed(1)
    qkv = torch.randn(2, 190, 3, 4, 72, generator=g).to("cuda", torch.bfloat16)
    q, k, v = qkv.unbind(2)
    assert tfa._chunk_aligned(q) is q and tfa._chunk_aligned(k) is k
    got, ref = _call(entry, q, k, v, None)
    assert (got.float() - ref).abs().max().item() <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ENTRIES)
def test_misaligned_input_is_copied_and_odd_head_dim_raises(cuda_device, entry):
    """A base that is not on a 16-byte boundary is copied contiguous first
    (documented in `ops/flash_attention.py`); a head_dim that is not a
    multiple of 8 cannot be copied into whole chunks and raises."""
    q, k, v, mask = _cuda_inputs(1, 70, 90, 4, 2, dead_row=False)
    flat = torch.empty(q.numel() + 1, dtype=q.dtype, device="cuda")
    q_off = flat[1:].view(q.shape).copy_(q)  # base 2 bytes past the allocation
    assert q_off.data_ptr() % 16 != 0 and tfa._chunk_aligned(q_off) is not q_off
    got, ref = _call(entry, q_off, k, v, mask)
    assert (got.float() - ref).abs().max().item() <= 1e-2
    q, k, v, mask = _cuda_inputs(1, 70, 90, 4, 2, d=36, dead_row=False)
    kw = {"bound": 9.0} if entry.startswith("static_max") else {}
    before = tfa.LAUNCHES[entry]
    with pytest.raises(ValueError, match="multiple of 8"):
        getattr(tfa, f"flash_{entry}")(q, k, v, mask, 0.2, **kw)
    assert tfa.LAUNCHES[entry] == before


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ENTRIES)
def test_fp32_stays_on_the_first_template(cuda_device, entry):
    """fp32 inputs take the fp32 kernel of `csrc/flash_fwd_fp32_sm90.cu`
    (fp32 FFMA, exact to fp32; it replaced flash_fwd.cu's first template),
    K1's too; the Hopper kernel reads bf16 only, so fp32-level agreement
    shows the route."""
    q, k, v, mask = (t.float() if t.is_floating_point() else t
                     for t in _cuda_inputs(2, 100, 150, 4, 2))
    got, ref = _call(entry, q, k, v, mask)
    assert got.dtype == torch.float32
    assert (got - ref).abs().max().item() <= 1e-5


@pytest.mark.cuda
def test_rope_kernel_equals_the_first_template_online_forward(cuda_device):
    """fp32 K9 (`rope_rotate` on q and k, then the fp32 kernel's online
    instantiation, `csrc/flash_fwd_fp32_sm90.cu`) equals that kernel's
    `flash_online_lse(...)[0]` on `apply_rope`d inputs to one fp32 ulp."""
    from lumina_t2x_tpu_torch.ops.rope import apply_rope, rope_angles_2d

    q, k, v, mask = (t.float() if t.is_floating_point() else t
                     for t in _cuda_inputs(2, 256, 256, 4, 2, dead_row=False))
    angles = rope_angles_2d(72, 16, 16, device="cuda").reshape(256, 36)
    got = tfa.flash_rope(q, k, v, angles, mask, 0.2)
    ref = tfa.flash_online_lse(apply_rope(q, angles), apply_rope(k, angles), v, mask, 0.2)[0]
    torch.cuda.synchronize()
    assert got.dtype == ref.dtype == torch.float32
    ulp = 2.0 ** -23 * ref.abs().max().item()
    assert (got - ref).abs().max().item() <= ulp


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [48, 96])
@pytest.mark.parametrize("sq,sk", [(1000, 1000), (256, 256), (200, 2100), (300, 4429)])
@pytest.mark.parametrize("entry", ENTRIES)
def test_new_widths_equal_zero_padded_on_card(cuda_device, entry, sq, sk, d, dtype):
    """48/48 and 96/96 (each block: 48/48 over few keys in 64 rows; over
    more than 1024, and 96/96, in 192) equal, bit for bit, the 64/64 and 128/128 instantiations
    on the same q, k, v padded with zero columns, at the same scale: a zero
    column adds exact zeros to each fp32 sum, and the block does not change
    a row's arithmetic. The LSE too; 4:1 GQA, a masked tail, a fully masked
    batch row."""
    q, k, v, mask = (t.to(dtype) if t.is_floating_point() else t
                     for t in _cuda_inputs(2, sq, sk, 8, 2, d=d))
    padded = 64 if d == 48 else 128
    pad = lambda t: torch.nn.functional.pad(t, (0, padded - d))  # noqa: E731
    assert tfa.fwd_sm90_instantiation(d, sq, sk)[1] == d
    assert tfa.fwd_sm90_instantiation(padded, sq, sk)[1] == padded
    kw = {"bound": 9.0} if entry.startswith("static_max") else {}
    fn = getattr(tfa, f"flash_{entry}")
    got, ref = fn(q, k, v, mask, 0.2, **kw), fn(pad(q), pad(k), pad(v), mask, 0.2, **kw)
    torch.cuda.synchronize()
    if entry.endswith("_lse"):
        (got, lse), (ref, ref_lse) = got, ref
        assert torch.equal(lse, ref_lse)
    assert torch.equal(got, ref[..., :d])


# keys a call over at most 1024 is padded to, the padding masked, so that it
# runs the 192-row block
PAST_1024 = 1088


def _past_1024(k, v, mask):
    """k and v with zero keys appended up to PAST_1024, and the mask (all
    ones for None) with the appended keys masked."""
    b, sk, hkv, d = k.shape
    zeros = k.new_zeros(b, PAST_1024 - sk, hkv, d)
    base = torch.ones(b, sk, dtype=torch.int32, device=k.device) if mask is None else mask
    return (torch.cat([k, zeros], 1), torch.cat([v, zeros], 1),
            torch.cat([base, base.new_zeros(b, PAST_1024 - sk)], 1))


def _equal_past_1024(entry, q, k, v, mask, rows=64, **kw):
    """The call over Sk <= 1024 keys (80/72's 64-row block, three an SM, or
    with `rows` 512 its K/V-resident block) equals, bit for bit, the same
    call over its keys padded past 1024 and masked (the 192-row block): a
    masked key adds exact zeros, and the block does not change a row's
    arithmetic. The LSE too."""
    d, sq, sk = q.shape[-1], q.shape[1], k.shape[1]
    assert tfa.fwd_sm90_instantiation(d, sq, sk) == (80, 72, rows, 3 if rows == 64 else 1)
    assert tfa.fwd_sm90_instantiation(d, sq, PAST_1024) == (80, 72, 192, 1)
    fn = getattr(tfa, f"flash_{entry}")
    # K1 is K2's kernel; its entry takes at most 1024 keys
    wide = tfa.flash_online if entry == "small_kv" else fn
    got, ref = fn(q, k, v, mask, 0.2, **kw), wide(q, *_past_1024(k, v, mask), 0.2, **kw)
    torch.cuda.synchronize()
    if entry.endswith("_lse"):
        (got, lse), (ref, ref_lse) = got, ref
        assert torch.equal(lse, ref_lse)
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("sq", [1, 63, 64, 65, 128, 256, 4096])
@pytest.mark.parametrize("sk", [16, 32, 77, 128, 129, 256, 1024])
@pytest.mark.parametrize("entry", ENTRIES)
def test_short_key_block_equals_the_192_row_block_on_card(cuda_device, entry, sk, sq, dtype):
    """80/72 over at most 1024 keys (64-row blocks three an SM, Q's, K's
    and V's columns 64-79 in narrow atoms, PV as n64 and n16 products; at
    Sq 4096 over at most 256 keys the K/V-resident block) against the
    192-row block (whole 64-column atoms, PV n72), bit for bit, at every Sq
    and Sk of the short-key paths: 4:1 GQA, a masked tail, a fully masked
    batch row, the LSE, the static max, fp16."""
    q, k, v, mask = (t.to(dtype) if t.is_floating_point() else t
                     for t in _cuda_inputs(2, sq, sk, 8, 2))
    kw = {"bound": 9.0} if entry.startswith("static_max") else {}
    rows = tfa.fwd_sm90_instantiation(72, sq, sk)[2]
    _equal_past_1024(entry, q, k, v, mask, rows=rows, **kw)
    if sq == 256:  # no mask: every tile but a ragged last one takes the all-valid chain
        _equal_past_1024(entry, q, k, v, None, rows=rows, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("sq,sk", [(1, 16), (65, 77), (256, 256), (4096, 32), (128, 1024)])
def test_short_key_block_rotates_q_on_card(cuda_device, sq, sk, dtype):
    """The fused rotation on 80/72's short-key block (Q's columns 64-71 in
    a narrow, 32-byte-swizzled atom): `flash_rope_q` equals the 192-row
    block's call over keys padded past 1024 and masked, and, at Sq = Sk,
    `flash_rope` equals `flash_online` on `apply_rope`d q and k, bit for
    bit."""
    from lumina_t2x_tpu_torch.ops.rope import apply_rope

    q, k, v, mask = (t.to(dtype) if t.is_floating_point() else t
                     for t in _cuda_inputs(2, sq, sk, 8, 2))
    g = torch.Generator().manual_seed(sq + sk)
    angles = (3.0 * torch.randn(sq, 36, generator=g)).cuda()
    kp, vp, mp = _past_1024(k, v, mask)
    assert tfa.fwd_sm90_instantiation(72, sq, sk)[2] != 192
    got = tfa.flash_rope_q(q, k, v, angles, mask, 0.2)
    ref = tfa.flash_rope_q(q, kp, vp, angles, mp, 0.2)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    if sq == sk:
        angles = (3.0 * torch.randn(sk, 36, generator=g)).cuda()
        got = tfa.flash_rope(q, k, v, angles, mask, 0.2)
        ref = tfa.flash_online(apply_rope(q, angles), apply_rope(k, angles), v, mask, 0.2)
        torch.cuda.synchronize()
        assert torch.equal(got, ref)


# key lengths of the K/V-resident block's card tests: one key, a partial
# tile, a tile and one key, the music captions, a Gemma caption, the 2B's
# 256 less one, 256, and one past its reach (the 64-row block)
RESIDENT_SKS = [1, 32, 33, 77, 136, 255, 256, 257]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("sk", RESIDENT_SKS)
@pytest.mark.parametrize("entry", ENTRIES + ["rope_q"])
def test_kv_resident_block_on_card(cuda_device, entry, sk, dtype):
    """80/72's K/V-resident block (a (batch, q head)'s K/V tiles loaded once
    a block, two consumers taking its 64-row Q tiles in turn, 34 of them a
    block here) at the 2B's caption shape with Sq 4097 (the last block of a
    head holds a tile past Sq, computed and not stored), 4:1 GQA, a masked
    tail and a fully masked batch row: against the plain version (bf16: 1e-2 of
    max(1, max|ref|), as chip_smoke's caption rows), and bit for bit
    against the 192-row block's call over the keys padded past 1024 and
    masked, output and LSE; `rope_q` bit for bit against the 192-row block
    and against `flash_small_kv` on `apply_rope`d q. Sk 257 runs the 64-row
    block, held the same way."""
    from lumina_t2x_tpu_torch.ops.rope import apply_rope

    q, k, v, mask = (t.to(dtype) if t.is_floating_point() else t
                     for t in _cuda_inputs(2, 4097, sk, 32, 8))
    rows = 0 if sk <= 256 else 64  # 0: the K/V-resident block
    assert tfa.fwd_sm90_instantiation(72, 4097, sk)[2] == rows
    if entry == "rope_q":
        g = torch.Generator().manual_seed(sk)
        angles = (3.0 * torch.randn(4097, 36, generator=g)).cuda()
        kp, vp, mp = _past_1024(k, v, mask)
        got = tfa.flash_rope_q(q, k, v, angles, mask, 0.2)
        ref = tfa.flash_rope_q(q, kp, vp, angles, mp, 0.2)
        same = tfa.flash_small_kv(apply_rope(q, angles), k, v, mask, 0.2)
        torch.cuda.synchronize()
        assert torch.equal(got, ref) and torch.equal(got, same)
        return
    kw = {"bound": 9.0} if entry.startswith("static_max") else {}
    before = tfa.LAUNCHES[entry]
    got, ref = _call(entry, q, k, v, mask, **kw)
    assert tfa.LAUNCHES[entry] == before + 1
    assert got.dtype == dtype and torch.count_nonzero(got[-1]).item() == 0
    err, top = (got.float() - ref).abs(), ref.abs().max().item()
    if dtype == torch.bfloat16:  # outputs reach [4, 8), where half a bf16 ulp is 1.6e-2
        assert err.max().item() <= 1e-2 * max(1.0, top) and err.mean().item() <= 1e-3
    else:
        assert err.max().item() <= 1e-3 * top
    _equal_past_1024(entry, q, k, v, mask, rows=rows, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["online", "static_max", "online_lse"])
def test_sd3_joint_sequence_matches_plain_on_card(cuda_device, entry):
    """K2-K4 at 64/64 over MMDiT-SD3-Medium's 4429-key joint sequence (192
    rows; 70 key tiles, the last ragged) against the plain version, no mask,
    as the SD3 sampler calls it."""
    g = torch.Generator().manual_seed(64)
    q, k, v = (torch.randn(1, 4429, 24, 64, generator=g).to("cuda", torch.bfloat16)
               for _ in range(3))
    got, ref = _call(entry, q, k, v, None, scale=64 ** -0.5, bound=12.0)
    err = (got.float() - ref).abs()
    assert err.max().item() <= 1e-2 and err.mean().item() <= 1e-3


@pytest.mark.cuda
def test_kernel_resources(cuda_device):
    """Each instantiation and block (`fwd_sm90_instantiation`) as compiled:
    whole warpgroups (the producer's and one to three consumers'), as many
    blocks resident on an SM as the block is built for, the registers
    setmaxnreg hands out within the block's share of the SM's 65536, no
    local-memory spills, the products' depth and width and the block's rows
    as the port names them, in bf16 and fp16; the K/V-resident block (Sq
    4096 and 512 over 256 and 32 keys at 80/72) with two consumers, four K/V
    stages and two Q stages a consumer."""
    shapes = ((4096, 4096), (256, 256), (4096, 256), (4096, 32), (512, 256), (511, 256))
    for static_max, head_dim, (sq, sk), dtype in itertools.product(
            (False, True), (48, 64, 72, 96, 128), shapes, (torch.bfloat16, torch.float16)):
        info = tfa.sm90_attributes(static_max, head_dim, dtype, sq, sk)
        depth, width, rows, blocks = tfa.fwd_sm90_instantiation(head_dim, sq, sk)
        consumers = info["threads"] - 128
        assert info["threads"] % 128 == 0 and consumers == 128 * info["consumers"]
        if rows == 0:  # the K/V-resident block
            assert (width, info["consumers"], info["stages"], info["q_stages"]) == (72, 2, 4, 4)
        else:
            assert rows == 64 * info["consumers"] and info["q_stages"] == 0
        assert (info["depth"], info["width"], info["rows_per_block"], info["min_blocks"]) == \
            (depth, width, rows, blocks)
        assert info["blocks_per_sm"] >= blocks and info["stages"] >= 3
        assert 128 * info["producer_registers"] + consumers * info["consumer_registers"] <= \
            65536 // blocks
        assert info["registers"] * info["threads"] * blocks <= 65536
        assert info["local_bytes"] == 0

"""The bf16 flash-attention backward of `lumina_t2x_tpu_torch/csrc/
flash_bwd_sm90.cu` (K6 `flash_bwd_fused`, K8 `flash_bwd_dkv` and K7
`flash_bwd_dq` on bf16 inputs).

On the CPU: `emulate_bwd` repeats the kernel's arithmetic in fp32 torch --
the 64-key tiles of its consumer warpgroups; the exp2 domain with scale*log2(e) and
lse*log2(e) folded, the min(., 0) clamp and the lse = -inf guard (+inf in
the exp2 domain); P and dS split into bf16 hi + lo pairs for dV, dK and dQ;
dQ summed in fp32 a 64-key tile's share at a time (each consumer adds its
own); dK and dV summed over the GQA group, one bf16 rounding of each
output -- and is held against the JAX package's backward (`jax.vjp` of its
`flash_attention`, Pallas kernels in interpret mode, both routes by
LUMINA_FLASH_FUSED_BWD) and against the port's `flash_bwd_plain`.
`emulate_dq` repeats the dQ kernel's (K7): 64-key tiles in order, the same
exp2 domain and guard, the dS pair, dQ summed in fp32 across the tiles and
rounded once -- held against the JAX split route (LUMINA_FLASH_FUSED_BWD=0)
and `flash_bwd_plain`'s dq. Inputs are bf16-representable fp32 from numpy,
so every side multiplies the same operands. Bar: one bf16 rounding of max|ref| (2^-8) plus 2e-5 for fp32 sums
in another order. Fully masked rows are left out of the JAX comparison and
checked to be 0 against the port.

The `cuda`-marked tests run the kernel itself against its plain version on
the card (`python -m pytest --noconftest -m cuda tests/test_torch_flash_bwd_sm90.py`)
and skip without one.
"""

import importlib
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
HALF = 64  # keys per consumer warpgroup
BK = 64  # keys per tile of the dQ kernel's ring
REL, ATOL = 2.0 ** -8, 2e-5


class _Lazy:
    """JAX is imported at first use, so that the `cuda` tests below also
    collect and run on a machine without JAX (`pytest --noconftest -m cuda`)."""

    def __init__(self, module):
        self._module = module

    def __getattr__(self, name):
        return getattr(importlib.import_module(self._module), name)


jfa = _Lazy(_JFA)
jax = _Lazy("jax")
jnp = _Lazy("jax.numpy")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ("LUMINA_FLASH_STATIC_MAX", "LUMINA_FLASH_STATIC_MAX_TRAIN",
                "LUMINA_FLASH_FUSED_BWD", "LUMINA_FLASH_BWD_BQ", "LUMINA_FLASH_BWD_BK"):
        monkeypatch.delenv(var, raising=False)
    yield
    if _JFA in sys.modules:
        jfa.set_flash_static_max_train(None)


def _f32(x):
    return torch.tensor(x, dtype=torch.float32)


def _pair(x, pair, dtype=torch.bfloat16):
    hi = x.to(dtype).float()
    return hi, ((x - hi).to(dtype).float() if pair else torch.zeros_like(x))


def _ds_scales(dout, dtype, ds_scale):
    """fp16's dS scale pair (up, down) = (2^-e, 2^e), e = floor(log2
    max|dO|) (the kernels read max|dO| from the card); (1, 1) for bf16, for
    `ds_scale=False` and for dO = 0."""
    amax = dout.abs().max()
    if dtype != torch.float16 or not ds_scale or amax == 0:
        return _f32(1.0), _f32(1.0)
    e = int(torch.frexp(amax)[1]) - 1
    return _f32(2.0 ** -e), _f32(2.0 ** e)


def emulate_bwd(q, k, v, kv_mask, out, lse, dout, scale, pair=True, round_out=True,
                dtype=torch.bfloat16, ds_scale=True):
    """The kernel's arithmetic in fp32 torch on (B, S, H, D) fp32 tensors and
    the forward's (B, Hq, Sq) LSE, for the operand type `dtype` (bf16 or
    fp16: the pairs' and the outputs' type): (dq, dk, dv), dk and dv per kv
    head, each rounded once to `dtype` (as fp32). fp16 packs dS at 2^-e
    (`_ds_scales`: folded into the chain's scale) and multiplies dK and each
    dQ share by 2^e before they are stored. `pair=False` rounds P and dS
    once; `round_out=False` skips the output rounding; `ds_scale=False`
    drops fp16's dS scale."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    rep = hq // hkv
    scale2 = _f32(scale) * _f32(LOG2E)  # folded on the host
    up, down = _ds_scales(dout, dtype, ds_scale)
    ds_scale_f = _f32(scale) * up
    # the producer's per-row lse*log2(e): +inf for a row without a valid key
    lse2 = torch.where(lse == -math.inf, torch.tensor(math.inf), lse * _f32(LOG2E))
    lse2 = lse2.reshape(b, hkv, rep, sq)[..., None, :]  # (B, Hkv, rep, 1, Sq): keys x q rows
    delta = (dout * out).sum(-1).permute(0, 2, 1).reshape(b, hkv, rep, sq)[..., None, :]
    qg, dog = q.reshape(b, sq, hkv, rep, d), dout.reshape(b, sq, hkv, rep, d)
    valid = torch.ones(b, sk, dtype=torch.bool) if kv_mask is None else kv_mask != 0
    dq = torch.zeros(b, sq, hkv, rep, d)
    dk, dv = torch.zeros(b, sk, hkv, d), torch.zeros(b, sk, hkv, d)
    for c0 in range(0, sk, HALF):  # the last tile is ragged: keys past Sk add nothing
        kc, vc = k[:, c0:c0 + HALF], v[:, c0:c0 + HALF]
        ok = valid[:, None, None, c0:c0 + HALF, None]  # (B, 1, 1, keys, 1)
        st = torch.einsum("bkhd,bqhrd->bhrkq", kc, qg)  # S^T
        dpt = torch.einsum("bkhd,bqhrd->bhrkq", vc, dog)  # dP^T
        p = torch.exp2(torch.clamp(st * scale2 - lse2, max=0.0))
        p = torch.where(ok, p, torch.zeros_like(p))
        ds = p * (dpt - delta) * ds_scale_f
        p_hi, p_lo = _pair(p, pair, dtype)
        ds_hi, ds_lo = _pair(ds, pair, dtype)
        dv[:, c0:c0 + HALF] += (torch.einsum("bhrkq,bqhrd->bkhd", p_hi, dog)
                                + torch.einsum("bhrkq,bqhrd->bkhd", p_lo, dog))
        dk[:, c0:c0 + HALF] += (torch.einsum("bhrkq,bqhrd->bkhd", ds_hi, qg)
                                + torch.einsum("bhrkq,bqhrd->bkhd", ds_lo, qg))
        # the consumer's dQ share, added on its own
        dq += (torch.einsum("bhrkq,bkhd->bqhrd", ds_hi, kc)
               + torch.einsum("bhrkq,bkhd->bqhrd", ds_lo, kc)) * down
    dq = dq.reshape(b, sq, hq, d)
    rnd = (lambda t: t.to(dtype).float()) if round_out else (lambda t: t)
    return rnd(dq), rnd(dk * down), rnd(dv)


def emulate_dq(q, k, v, kv_mask, out, lse, dout, scale, pair=True, round_out=True,
               dtype=torch.bfloat16, ds_scale=True):
    """The dQ kernel's arithmetic in fp32 torch, per q row over 64-key tiles
    in order: p = exp2(min(s*scale2 - lse2, 0)) (lse2 = +inf for lse =
    -inf), 0 on an invalid key; ds = p (dp - delta) scale; dQ += (ds_hi +
    ds_lo) K in fp32; rounded once to `dtype` (as fp32; fp16 with dS at 2^-e
    and dQ times 2^e before the rounding, as `emulate_bwd`). `pair=False`
    rounds dS once; `round_out=False` skips the output rounding;
    `ds_scale=False` drops fp16's dS scale."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    rep = hq // hkv
    scale2 = _f32(scale) * _f32(LOG2E)
    up, down = _ds_scales(dout, dtype, ds_scale)
    ds_scale_f = _f32(scale) * up
    lse2 = torch.where(lse == -math.inf, torch.tensor(math.inf), lse * _f32(LOG2E))
    lse2 = lse2.reshape(b, hkv, rep, sq)[..., None]  # (B, Hkv, rep, Sq, 1): q rows x keys
    delta = (dout * out).sum(-1).permute(0, 2, 1).reshape(b, hkv, rep, sq)[..., None]
    qg, dog = q.reshape(b, sq, hkv, rep, d), dout.reshape(b, sq, hkv, rep, d)
    valid = torch.ones(b, sk, dtype=torch.bool) if kv_mask is None else kv_mask != 0
    dq = torch.zeros(b, hkv, rep, sq, d)
    for j0 in range(0, sk, BK):  # the last tile is ragged: keys past Sk add nothing
        kt, vt = k[:, j0:j0 + BK], v[:, j0:j0 + BK]
        ok = valid[:, None, None, None, j0:j0 + BK]  # (B, 1, 1, 1, keys)
        s = torch.einsum("bqhrd,bkhd->bhrqk", qg, kt)
        dp = torch.einsum("bqhrd,bkhd->bhrqk", dog, vt)
        p = torch.exp2(torch.clamp(s * scale2 - lse2, max=0.0))
        p = torch.where(ok, p, torch.zeros_like(p))
        ds_hi, ds_lo = _pair(p * (dp - delta) * ds_scale_f, pair, dtype)
        dq = dq + (torch.einsum("bhrqk,bkhd->bhrqd", ds_hi, kt)
                   + torch.einsum("bhrqk,bkhd->bhrqd", ds_lo, kt))
    dq = (dq * down).permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d)
    return dq.to(dtype).float() if round_out else dq


def _inputs(seed, b, sq, sk, hq, hkv, d=16, tail=0, dead_row=False, dtype=torch.bfloat16):
    """`dtype`-representable (bf16 or fp16) fp32 numpy q, k, v, dout and an
    int32 mask: the last `tail` keys of batch row 0 masked, and with
    `dead_row` every key of the last batch row."""
    rng = np.random.default_rng(seed)
    bf = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(
        dtype).float().numpy()
    q, k, v, dout = bf(b, sq, hq, d), bf(b, sk, hkv, d), bf(b, sk, hkv, d), bf(b, sq, hq, d)
    mask = np.ones((b, sk), np.int32)
    if tail:
        mask[0, sk - tail:] = 0
    if dead_row:
        mask[-1] = 0
    return q, k, v, dout, mask


def _emulate_np(q, k, v, dout, mask, scale, **kw):
    """emulate_bwd on numpy inputs, with out and LSE from the port's plain
    LSE forward (the forward whose saved tensors the backward reads)."""
    tq, tk, tv, tdo, tm = map(torch.from_numpy, (q, k, v, dout, mask))
    out, lse = tfa.flash_online_lse_plain(tq, tk, tv, tm, scale)
    return emulate_bwd(tq, tk, tv, tm, out, lse, tdo, scale, **kw), (tq, tk, tv, tm, out, lse, tdo)


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    bar = REL * np.abs(ref).max() + ATOL
    np.testing.assert_array_less(np.abs(got - ref), bar)


# (b, sq, sk, hq, hkv, masked tail, scale): GQA 4 and 8, Sk=32 (below one
# block), ragged Sq and Sk (the last block's second half empty or partial),
# masked tails, non-default scales
CASES = [(2, 40, 32, 8, 1, 5, None), (1, 70, 200, 8, 2, 0, 0.3), (2, 33, 130, 8, 2, 17, 0.25),
         (1, 65, 260, 4, 1, 64, None)]
# CASES at head_dim 16 (the 48/48 instantiation), then at the 48/48 and 96/96
# instantiations' own widths: GQA 4:1, a masked tail, ragged Sq and Sk
# (b, sq, sk, hq, hkv, masked tail, scale, head_dim)
WIDTH_CASES = [(*case, 16) for case in CASES] + [
    (1, 70, 200, 8, 2, 13, 0.3, 48), (2, 33, 97, 4, 1, 9, None, 48),
    (1, 70, 200, 8, 2, 13, 0.3, 96), (2, 33, 130, 4, 1, 17, None, 96)]


@pytest.mark.parametrize("fused", ["1", "0"])
@pytest.mark.parametrize("case", WIDTH_CASES)
def test_emulation_matches_jax(monkeypatch, fused, case):
    b, sq, sk, hq, hkv, tail, scale, d = case
    q, k, v, dout, mask = _inputs(sk + hq, b, sq, sk, hq, hkv, d=d, tail=tail)
    scale = d ** -0.5 if scale is None else scale
    monkeypatch.setenv("LUMINA_FLASH_FUSED_BWD", fused)
    _, vjp = jax.vjp(lambda q_, k_, v_: jfa.flash_attention(q_, k_, v_, jnp.asarray(mask), scale),
                     *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(dout))
    got, _ = _emulate_np(q, k, v, dout, mask, scale)
    for a, r in zip(got, ref):
        _close(a, r)


@pytest.mark.parametrize("case", WIDTH_CASES)
def test_emulation_matches_plain(case):
    b, sq, sk, hq, hkv, tail, scale, d = case
    q, k, v, dout, mask = _inputs(2 * sk + hq, b, sq, sk, hq, hkv, d=d, tail=tail)
    scale = d ** -0.5 if scale is None else scale
    got, args = _emulate_np(q, k, v, dout, mask, scale)
    tq, tk, tv, tm, out, lse, tdo = args
    ref = tfa.flash_bwd_plain(tq, tk, tv, tm, out, lse, tdo, scale)
    for a, r in zip(got, ref):
        _close(a, r)


def _emulate_dq_np(q, k, v, dout, mask, scale, **kw):
    """emulate_dq on numpy inputs, with out and LSE from the port's plain LSE
    forward."""
    tq, tk, tv, tdo, tm = map(torch.from_numpy, (q, k, v, dout, mask))
    out, lse = tfa.flash_online_lse_plain(tq, tk, tv, tm, scale)
    return emulate_dq(tq, tk, tv, tm, out, lse, tdo, scale, **kw), (tq, tk, tv, tm, out, lse, tdo)


@pytest.mark.parametrize("case", WIDTH_CASES)
def test_dq_emulation_matches_jax_split_route(monkeypatch, case):
    """K7's arithmetic against the dq of the JAX package's two-kernel
    backward (`_bwd_dq_kernel`, LUMINA_FLASH_FUSED_BWD=0, Pallas in
    interpret mode)."""
    b, sq, sk, hq, hkv, tail, scale, d = case
    q, k, v, dout, mask = _inputs(3 * sk + hq, b, sq, sk, hq, hkv, d=d, tail=tail)
    scale = d ** -0.5 if scale is None else scale
    monkeypatch.setenv("LUMINA_FLASH_FUSED_BWD", "0")
    _, vjp = jax.vjp(lambda q_, k_, v_: jfa.flash_attention(q_, k_, v_, jnp.asarray(mask), scale),
                     *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(dout))[0]
    got, _ = _emulate_dq_np(q, k, v, dout, mask, scale)
    _close(got, ref)


@pytest.mark.parametrize("case", WIDTH_CASES)
def test_dq_emulation_matches_plain(case):
    b, sq, sk, hq, hkv, tail, scale, d = case
    q, k, v, dout, mask = _inputs(4 * sk + hq, b, sq, sk, hq, hkv, d=d, tail=tail)
    scale = d ** -0.5 if scale is None else scale
    got, args = _emulate_dq_np(q, k, v, dout, mask, scale)
    _close(got, tfa.flash_bwd_plain(*args[:6], args[6], scale)[0])


@pytest.mark.parametrize("sk", [32, 200])
def test_dq_fully_masked_row_is_zero(sk):
    """K7: a batch row without a valid key (lse = -inf, +inf in the exp2
    domain) gets dq = 0 exactly; the other row matches the plain version."""
    q, k, v, dout, mask = _inputs(10, 2, 50, sk, 4, 2, tail=7, dead_row=True)
    got, args = _emulate_dq_np(q, k, v, dout, mask, 0.3)
    assert torch.isinf(args[5][1]).all()
    ref = tfa.flash_bwd_plain(*args[:6], args[6], 0.3)[0]
    assert torch.equal(got[1], torch.zeros_like(got[1])) and not ref[1].any()
    _close(got[0], ref[0])


@pytest.mark.parametrize("sk", [32, 200])
def test_fully_masked_row_is_zero(sk):
    """A batch row without a valid key (lse = -inf) gets dq = 0 and adds
    nothing to dk and dv: +inf in the exp2 domain gives p = 0, where the
    unguarded exp2(min(s*scale2 + inf, 0)) would give 1. The other row
    matches the port's plain version."""
    q, k, v, dout, mask = _inputs(9, 2, 50, sk, 4, 2, tail=7, dead_row=True)
    got, args = _emulate_np(q, k, v, dout, mask, 0.3)
    tq, tk, tv, tm, out, lse, tdo = args
    assert torch.isinf(lse[1]).all()
    ref = tfa.flash_bwd_plain(tq, tk, tv, tm, out, lse, tdo, 0.3)
    for a, r in zip(got, ref):
        assert torch.equal(a[1], torch.zeros_like(a[1])) and not r[1].any()
        _close(a[0], r[0])


def test_hi_lo_pair_keeps_p_and_ds_to_fp32_precision():
    """Before the output rounding: P and dS rounded once to bf16 move the
    gradients by ~1e-3 of their size here; the hi + lo pairs leave them
    within 2^-14 of the fp32 backward."""
    q, k, v, dout, mask = _inputs(6, 1, 64, 256, 4, 4, d=32)
    pair, args = _emulate_np(q, k, v, dout, mask, 0.2, round_out=False)
    once, _ = _emulate_np(q, k, v, dout, mask, 0.2, pair=False, round_out=False)
    tq, tk, tv, tm, out, lse, tdo = args
    ref = tfa.flash_bwd_plain(tq, tk, tv, tm, out, lse, tdo, 0.2)
    for a, o, r in zip(pair, once, ref):
        top = r.abs().max()
        assert (a - r).abs().max() <= 2.0 ** -14 * top
        assert (o - r).abs().max() > 8 * (a - r).abs().max()


# -- fp16: the kernels' fp16 instantiations ------------------------------------------

F16 = torch.float16
REL16 = 2.0 ** -11  # one fp16 rounding of max|ref| (11 significant bits)


def _close16(got, ref):
    """The fp16 bar against the port's plain version: one fp16 rounding of
    max|ref| plus 2e-5 for fp32 sums in another order."""
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_array_less(np.abs(got - ref), REL16 * np.abs(ref).max() + ATOL)


def _pallas16_bars(q, k, v, mask, out, lse, dout, scale, refs):
    """Elementwise bars (dq, dk, dv) between the emulation and the JAX
    package's fp16 backward, which rounds p and dS once to fp16 (dS from the
    rounded p, so twice p's relative error): a gradient moves by up to
    sum (2^-11 p + 2^-25 [p < 2^-14]) |dO| (dV), sum (2^-10 |dS| + 2^-25
    [|dS| < 2^-14]) |q| (dK) or |k| (dQ) -- a normal fp16 rounding's relative
    error, half the subnormal step under fp16's smallest normal -- plus two
    output roundings (2^-10 of |ref|) and 2e-5 for fp32 sums."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    rep = hq // hkv
    s, valid = tfa._logits(q, k, mask, scale)
    lse5 = lse.reshape(b, hkv, rep, sq, 1)
    live = torch.isfinite(lse5)
    p = torch.exp(torch.clamp(s - torch.where(live, lse5, torch.zeros_like(lse5)), max=0.0))
    p = torch.where(valid & live, p, torch.zeros_like(p))
    do = dout.reshape(b, sq, hkv, rep, d)
    delta = (do * out.reshape(b, sq, hkv, rep, d)).sum(-1).permute(0, 2, 3, 1)
    ds = p * (torch.einsum("bqhrd,bkhd->bhrqk", do, v) - delta[..., None]) * scale
    sub = lambda x: 2.0 ** -25 * ((x < 2.0 ** -14) & (p > 0)).float()  # noqa: E731
    wp, wds = 2.0 ** -11 * p + sub(p), 2.0 ** -10 * ds.abs() + sub(ds.abs())
    moved = (torch.einsum("bhrqk,bkhd->bqhrd", wds, k.abs()).reshape(b, sq, hq, d),
             torch.einsum("bhrqk,bqhrd->bkhd", wds, q.reshape(b, sq, hkv, rep, d).abs()),
             torch.einsum("bhrqk,bqhrd->bkhd", wp, do.abs()))
    return [m.numpy() + 2.0 ** -10 * np.abs(r) + ATOL for m, r in zip(moved, refs)]


def _jax16_grads(q, k, v, dout, mask, scale):
    """(dq, dk, dv) of the JAX `flash_attention` on fp16 arrays (`jax.vjp`,
    Pallas in interpret mode), as fp32 numpy."""
    _, vjp = jax.vjp(lambda q_, k_, v_: jfa.flash_attention(q_, k_, v_, jnp.asarray(mask), scale),
                     *(jnp.asarray(a.astype(np.float16)) for a in (q, k, v)))
    return [np.asarray(g, np.float32) for g in vjp(jnp.asarray(dout.astype(np.float16)))]


@pytest.mark.parametrize("fused", ["1", "0"])
@pytest.mark.parametrize("case", CASES[1:3])
def test_fp16_emulation_matches_jax(monkeypatch, fused, case):
    """The fp16 instantiations' arithmetic (the fp16 pairs, dS at 2^-e of
    max|dO|, one fp16 output rounding) against the JAX package's backward on
    fp16 inputs (`jax.vjp`, Pallas in interpret mode, both routes), within
    what its own rounding of p and dS to fp16 moves (`_pallas16_bars`)."""
    b, sq, sk, hq, hkv, tail, scale = case
    q, k, v, dout, mask = _inputs(5 * sk + hq, b, sq, sk, hq, hkv, tail=tail, dtype=F16)
    scale = 16 ** -0.5 if scale is None else scale
    monkeypatch.setenv("LUMINA_FLASH_FUSED_BWD", fused)
    ref = _jax16_grads(q, k, v, dout, mask, scale)
    tq, tk, tv, tdo, tm = map(torch.from_numpy, (q, k, v, dout, mask))
    out, lse = tfa.flash_online_lse_plain(tq, tk, tv, tm, scale)
    got = emulate_bwd(tq, tk, tv, tm, out, lse, tdo, scale, dtype=F16)
    if fused == "0":
        got = (emulate_dq(tq, tk, tv, tm, out, lse, tdo, scale, dtype=F16), *got[1:])
    bars = _pallas16_bars(tq, tk, tv, tm, out, lse, tdo, scale, ref)
    for a, r, bar in zip(got, ref, bars):
        np.testing.assert_array_less(np.abs(a.numpy() - r), bar)


@pytest.mark.parametrize("case", CASES)
def test_fp16_emulation_matches_plain(case):
    """K6/K8's and K7's fp16 arithmetic against `flash_bwd_plain` on the same
    fp16-representable inputs: one fp16 rounding of max|gradient|."""
    b, sq, sk, hq, hkv, tail, scale = case
    q, k, v, dout, mask = _inputs(6 * sk + hq, b, sq, sk, hq, hkv, tail=tail, dtype=F16)
    scale = 16 ** -0.5 if scale is None else scale
    tq, tk, tv, tdo, tm = map(torch.from_numpy, (q, k, v, dout, mask))
    out, lse = tfa.flash_online_lse_plain(tq, tk, tv, tm, scale)
    args = (tq, tk, tv, tm, out, lse, tdo, scale)
    ref = tfa.flash_bwd_plain(*args)
    for a, r in zip(emulate_bwd(*args, dtype=F16), ref):
        _close16(a, r)
    _close16(emulate_dq(*args, dtype=F16), ref[0])


@pytest.mark.parametrize("factor", [2.0 ** -20, 2.0 ** 8])
def test_fp16_pairs_and_ds_scale_keep_gradients_to_fp32_precision(factor):
    """Before the output rounding, fp16 gradients against the fp32 backward
    with dO scaled by 2^-20 (every dS far under fp16's smallest normal) and
    by 2^8: the pairs and dS at 2^-e of max|dO| keep them within 2^-14 of
    max|gradient| (K6/K8's and K7's); P and dS rounded once move them 8x
    further; without the dS scale, dO x 2^-20 leaves dS a few subnormal
    steps or 0 (dK and dQ off by tenths of their size)."""
    q, k, v, dout, mask = _inputs(7, 1, 64, 256, 4, 4, d=32, tail=9, dtype=F16)
    dout = (torch.from_numpy(dout) * factor).to(F16).float()
    tq, tk, tv, tm = map(torch.from_numpy, (q, k, v, mask))
    out, lse = tfa.flash_online_lse_plain(tq, tk, tv, tm, 0.2)
    args = (tq, tk, tv, tm, out, lse, dout, 0.2)
    ref = tfa.flash_bwd_plain(*args)
    pair = emulate_bwd(*args, round_out=False, dtype=F16)
    once = emulate_bwd(*args, pair=False, round_out=False, dtype=F16)
    bare = emulate_bwd(*args, round_out=False, dtype=F16, ds_scale=False)
    split = emulate_dq(*args, round_out=False, dtype=F16)
    for a, o, r in zip(pair, once, ref):
        top = r.abs().max()
        assert (a - r).abs().max() <= 2.0 ** -14 * top
        assert (o - r).abs().max() > 8 * (a - r).abs().max()
    assert (split - ref[0]).abs().max() <= 2.0 ** -14 * ref[0].abs().max()
    if factor < 1:
        for a, r in zip(bare[:2], ref[:2]):  # dq, dk
            assert (a - r).abs().max() > 0.1 * r.abs().max()


def test_bf16_fused_and_dkv_route_to_the_new_source():
    """bf16 and fp16 `bwd_fused` and `bwd_dkv` run `csrc/flash_bwd_sm90.cu`
    (their C entry points hand the Hopper dtype codes to `flash_bwd_sm90`
    with the fp16 flag and do_amax), and so does `bwd_dq` (to
    `flash_bwd_dq_sm90`, the dQ kernel); fp32 goes to `flash_bwd_fp32_sm90`
    (`csrc/flash_bwd_fp32_sm90.cu`) through `LUMINA_FLASH_BWD_CALL`, another
    code is refused. The new source is built into the flash library and
    holds no library kernel."""
    src = (cuda_lib._CSRC / "flash_bwd.cu").read_text()
    entries = src.split('extern "C" {')[1].split("int lumina_flash_")[1:]
    bodies = {e.split("(", 1)[0]: e.split("{", 1)[1] for e in entries}
    assert set(bodies) == {"bwd_fused", "bwd_dq", "bwd_dkv"}
    assert "bool hopper(int dtype) { return dtype == kBf16 || dtype == kFp16; }" in src
    for name, fused in (("bwd_fused", "true"), ("bwd_dkv", "false")):
        assert re.search(r"if \(hopper\(dtype\)\)\s+return flash_bwd_sm90\(dtype == kFp16, "
                         + fused + r", q, k, v, mask, dout, lse, delta, do_amax, dq, dk,", bodies[name])
        assert "LUMINA_FLASH_BWD_CALL" in bodies[name]  # fp32
    assert re.search(r"if \(hopper\(dtype\)\)\s+return flash_bwd_dq_sm90\(dtype == kFp16, q, k, v, "
                     r"mask, dout, lse, delta, do_amax, dq, meta,\s+scale, stream\);",
                     bodies["bwd_dq"])
    assert "LUMINA_FLASH_BWD_CALL(Which::kDq)" in bodies["bwd_dq"]  # fp32
    for body in bodies.values():
        assert "if (dtype != kFp32) return (int)cudaErrorInvalidValue;" in body
    assert "__nv_bfloat16" not in src and "__half" not in src and "wmma" not in src
    assert tfa._SM90_BWD_ENTRIES == ("bwd_fused", "bwd_dq", "bwd_dkv")
    sources, symbols = cuda_lib._DECLARED[tfa.LIBRARY]
    assert "flash_bwd_sm90.cu" in sources and "lumina_flash_bwd_sm90_attributes" in symbols
    new = (cuda_lib._CSRC / "flash_bwd_sm90.cu").read_text()
    assert "wgmma.mma_async" in (cuda_lib._CSRC / "sm90_common.cuh").read_text()
    assert not re.search(r"#include\s*[<\"](cublas|cudnn|cutlass|cute)", new)
    # profile_train_step groups the kernels by "flash_bwd_sm90"
    assert "flash_bwd_sm90_kernel" in new and "flash_bwd_sm90_dq_kernel" in new
    assert "produce_kv<L>(" in new and "using DqSmem = KvRing<" in new  # the forward's ring


def test_breakdown_variants_edit_the_kernel():
    """`exps/bwd_sm90_breakdown.py` times variants of the kernel's source with
    parts taken out; every edit applies to the source as it is (a changed
    kernel fails here instead of timing something else)."""
    from lumina_t2x_tpu_torch.exps import bwd_sm90_breakdown as bd

    source = bd.kernel_source()
    assert "void mma_pair(" in source  # the header pasted in
    texts = {name: bd.variant_source(name, source) for name in bd._EDITS}
    assert texts["kernel"].startswith(source) and "breakdown_bwd" in texts["kernel"]
    assert len(set(texts.values())) == len(texts)
    # the consumers of K6/K8's kernel (the dQ kernel follows them)
    consumers = lambda text: text.split("---- consumers")[1].split("-- the dQ kernel --")[0]
    assert "qk<" not in consumers(texts["loads only"])
    assert "tma_reduce_add(" not in consumers(texts["no dQ reduce"])


def test_bwd_attributes_name_the_kernel(monkeypatch):
    """`bwd_sm90_attributes` maps the kernel's name onto the C entry's
    `which` (0 dK/dV, 1 fused, 2 dQ), passes the operand dtype (bf16 by
    default, or fp16) and refuses another name before it builds anything."""
    calls = []
    monkeypatch.setattr(tfa, "_attributes", lambda *a: calls.append(a) or {})
    names = tfa._BWD_SM90_ATTRIBUTES
    for kernel in ("dkv", "fused", "dq"):
        tfa.bwd_sm90_attributes(kernel, 64)
    assert calls == [("lumina_flash_bwd_sm90_attributes", which, 64, torch.bfloat16, names)
                     for which in (0, 1, 2)]
    calls.clear()
    tfa.bwd_sm90_attributes("dq", 72, torch.float16)
    assert calls == [("lumina_flash_bwd_sm90_attributes", 2, 72, torch.float16, names)]
    with pytest.raises(ValueError, match="kernel must be one of"):
        tfa.bwd_sm90_attributes(True)
    assert names[-2:] == ("depth", "width")  # the compiled instantiation's, from the C entry


# (kernel, head_dim) -> (instantiation, consumer warpgroups): the dK/dV sweep
# (K6 fused, K8 dkv) 48/48 up to 48 with one consumer (two blocks an SM),
# 64/64, 80/72, 96/96, 128/128 with two; the dQ kernel (K7) 64/64, 80/72,
# 128/128
INSTANTIATIONS = {("fused", 48): ("48/48", 1), ("dkv", 48): ("48/48", 1),
                  ("fused", 16): ("48/48", 1), ("dkv", 40): ("48/48", 1),
                  ("fused", 96): ("96/96", 2), ("dkv", 96): ("96/96", 2),
                  ("fused", 88): ("96/96", 2), ("dkv", 56): ("64/64", 2),
                  ("fused", 72): ("80/72", 2), ("dkv", 128): ("128/128", 2),
                  ("dq", 48): ("64/64", 2), ("dq", 96): ("128/128", 2), ("dq", 72): ("80/72", 2)}


@pytest.mark.parametrize("kernel,head_dim", sorted(INSTANTIATIONS))
def test_bwd_attributes_name_the_instantiation(monkeypatch, kernel, head_dim):
    """`bwd_sm90_attributes` names the instantiation a head_dim runs: the
    48/48 and 96/96 sweeps at head_dim 48 and 96 (K6 and K8), K7 on its own
    (64/64, 80/72, 128/128); nothing is built (the C entry stood in for)."""
    monkeypatch.setattr(tfa, "_attributes", lambda *a: {"threads": 0})
    for dtype in (torch.bfloat16, torch.float16):
        info = tfa.bwd_sm90_attributes(kernel, head_dim, dtype)
        assert (info["instantiation"], info["consumers"]) == INSTANTIATIONS[kernel, head_dim]
    depth, width, consumers = tfa.bwd_sm90_instantiation(kernel, head_dim)
    assert depth >= head_dim and width >= head_dim and f"{depth}/{width}" == info["instantiation"]
    with pytest.raises(ValueError, match="up to 128"):
        tfa.bwd_sm90_instantiation(kernel, 136)


def test_breakdown_needs_the_card(monkeypatch):
    """The breakdown times the card: without a CUDA device it stops before
    building anything, with no CPU fallback."""
    from lumina_t2x_tpu_torch.exps import bwd_sm90_breakdown as bd

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA device"):
        bd.main()


# -- on the card: the kernel against its plain version ------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _cuda_inputs(b, sq, sk, hq, hkv, d=72, seed=0, dead_row=True, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g).to("cuda", dtype)
    mask = torch.ones(b, sk, dtype=torch.int32)
    mask[0, sk - sk // 5:] = 0
    if dead_row and b > 1:
        mask[-1] = 0
    q, k, v, dout = mk(b, sq, hq, d), mk(b, sk, hkv, d), mk(b, sk, hkv, d), mk(b, sq, hq, d)
    return q, k, v, mask.cuda(), dout


def _run(entry, q, k, v, mask, dout, scale=0.2):
    """(kernel grads, plain grads); out and LSE from the plain LSE forward."""
    out, lse = tfa.flash_online_lse_plain(q, k, v, mask, scale)
    args = (q, k, v, mask, out, lse, dout, scale)
    before = tfa.LAUNCHES[entry]
    got = getattr(tfa, f"flash_{entry}")(*args)
    ref = tfa.flash_bwd_plain(*args)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES[entry] == before + 1  # one launch per call
    if entry == "bwd_dq":
        return (got, None, None), ref
    return (got if entry == "bwd_fused" else (None, *got)), ref


def _assert_near(got, ref, rel):
    """Max error within `rel` of max|ref| and mean within a tenth of that,
    plus 1e-5 (1e-6 for the mean) for fp32 sums in another order: with one
    key (Sq = Sk = 1) ds = p * (dp - delta) cancels and dq, dk are
    rounding noise of ~1e-6."""
    for a, r in zip(got, ref):
        if a is None:
            continue
        assert a.dtype == r.dtype and a.shape == r.shape
        top = r.float().abs().max().item()
        err = (a.float() - r.float()).abs()
        assert err.max().item() <= rel * top + 1e-5
        assert err.mean().item() <= rel / 10 * top + 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (2, 77, 33, 8, 1, 72), (2, 200, 300, 4, 2, 72), (1, 300, 1000, 8, 8, 72), (3, 1, 1, 2, 1, 72),
    (2, 130, 257, 4, 4, 64), (1, 129, 200, 8, 2, 64), (2, 70, 200, 8, 1, 16),
    (1, 193, 129, 4, 1, 128), (2, 65, 130, 4, 2, 96), (2, 130, 257, 8, 2, 48),
    (1, 193, 129, 8, 2, 96), (3, 1, 1, 4, 1, 48), (2, 33, 700, 8, 2, 40)])
@pytest.mark.parametrize("entry", ["bwd_fused", "bwd_dkv", "bwd_dq"])
def test_kernel_matches_plain_on_card(cuda_device, entry, shape):
    """Odd Sq and Sk, GQA, a masked tail and a fully masked batch row, at
    head_dim 72 (the 2B) and in the kernel's other instantiations: 48/48
    (16, 40, 48), 64/64, 96/96 (96) and 128/128 (K7 at 96 too). Bar: one
    bf16 rounding of max|ref| (1e-2), mean 1e-3."""
    q, k, v, mask, dout = _cuda_inputs(*shape)
    got, ref = _run(entry, q, k, v, mask, dout)
    _assert_near(got, ref, 1e-2)
    if shape[0] > 1:
        assert not any(t[-1].any() for t in got if t is not None)


@pytest.mark.cuda
@pytest.mark.parametrize("factor", [1.0, 2.0 ** 8, 2.0 ** -8])
@pytest.mark.parametrize("shape", [(2, 77, 33, 8, 1, 72), (1, 300, 1000, 8, 8, 72),
                                   (2, 130, 257, 4, 4, 64), (1, 193, 129, 4, 1, 128),
                                   (2, 130, 257, 8, 2, 48), (1, 193, 129, 8, 2, 96)])
@pytest.mark.parametrize("entry", ["bwd_fused", "bwd_dkv", "bwd_dq"])
def test_fp16_kernel_matches_plain_on_card(cuda_device, entry, shape, factor):
    """The fp16 instantiations with dO scaled by 1, 2^8 and 2^-8 (dS at
    2^-e of max|dO|), GQA, a masked tail and a fully masked batch row, at
    the 80/72, 64/64, 128/128, 48/48 and 96/96 widths: one launch on fp16
    operands, fp16 gradients within 1e-3 of max|ref| (one fp16 rounding is
    2^-11), mean 1e-4."""
    q, k, v, mask, dout = _cuda_inputs(*shape, dtype=torch.float16)
    dout = (dout.float() * factor).half()
    before = tfa.DTYPE_LAUNCHES[f"{entry}_fp16"]
    got, ref = _run(entry, q, k, v, mask, dout)
    assert tfa.DTYPE_LAUNCHES[f"{entry}_fp16"] == before + 1
    _assert_near(got, ref, 1e-3)


def _fp16_step(x):
    """One fp16 rounding step at |x| (fp32 tensor): 2^-24 under fp16's
    smallest normal 2^-14, else 2^(floor(log2|x|) - 10)."""
    e = torch.frexp(x.abs().clamp_min(2.0 ** -14))[1] - 1
    return torch.ldexp(torch.ones_like(x), (e - 10).clamp_min(-24))


@pytest.mark.cuda
@pytest.mark.parametrize("factor", [2.0 ** 8, 2.0 ** -20])
@pytest.mark.parametrize("d", [48, 96])
@pytest.mark.parametrize("entry", ["bwd_fused", "bwd_dkv", "bwd_dq"])
def test_fp16_range_at_the_48_and_96_widths_on_card(cuda_device, entry, d, factor):
    """fp16 K6-K8 at the 48/48 and 96/96 widths (K7 on its 64/64 and
    128/128) with dO x 2^8 (within 1e-3 of max|ref|) and x 2^-20, where dS
    lies far under fp16's smallest normal without the 2^-e scale and the
    gradients themselves under it: finite and within one fp16 rounding step
    of plain, element by element (and K6's fp32 dQ before its cast within
    1e-3 of plain's fp32 dQ)."""
    q, k, v, mask, dout = _cuda_inputs(2, 130, 257, 8, 2, d=d, dtype=torch.float16)
    dout = (dout.float() * factor).half()
    got, ref = _run(entry, q, k, v, mask, dout)
    for a, r in zip(got, ref):
        if a is None:
            continue
        assert torch.isfinite(a).all()
        r = r.float()
        if r.abs().max() >= 2.0 ** -14:
            _assert_near((a,), (r.half(),), 1e-3)
        else:
            assert ((a.float() - r).abs() <= _fp16_step(r)).all()
    if entry == "bwd_fused" and factor < 1:
        out, lse = tfa.flash_online_lse_plain(q, k, v, mask, 0.2)
        dq32 = tfa._launch_bwd("bwd_fused", q, k, v, mask, out, lse, dout, 0.2)[0]
        ref32 = tfa.flash_bwd_plain(q.float(), k.float(), v.float(), mask, out.float(), lse,
                                    dout.float(), 0.2)[0]
        assert (dq32 - ref32).abs().max() <= 1e-3 * ref32.abs().max()


# the class-conditional models' head_dim 48 (the 48/48 instantiations of K6
# and K8, K7's 64/64): the 600M's (B, 256, 32, 48) at 256^2
# and the Small's (B, 1024, 8, 48) at 64^2 in pixel space; (b, sq, sk, hq, hkv)
CLASS_COND_SHAPES = {"600m": (8, 256, 256, 32, 32), "small": (4, 1024, 1024, 8, 8),
                     "600m_gqa_masked": (2, 256, 256, 32, 8), "small_gqa_masked": (2, 1024, 1024, 8, 2)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CLASS_COND_SHAPES))
@pytest.mark.parametrize("entry", ["bwd_fused", "bwd_dkv", "bwd_dq"])
def test_head_dim_48_matches_plain_on_card(cuda_device, entry, case):
    """K6-K8 at head_dim 48 on the class-conditional shapes, unmasked, and
    with GQA, a masked tail and a fully masked batch row. Bar: 1e-2 of
    max|ref|, mean 1e-3."""
    masked = case.endswith("masked")
    q, k, v, mask, dout = _cuda_inputs(*CLASS_COND_SHAPES[case], d=48, dead_row=masked)
    if not masked:
        mask.fill_(1)
    got, ref = _run(entry, q, k, v, mask, dout, scale=48 ** -0.5)
    _assert_near(got, ref, 1e-2)


# the Flag-DiT 5B's training attention at head_dim 96 (the 96/96
# instantiations of K6 and K8, K7's 128/128): 1024^2 latents, B=2, 64 x 65
# tokens with the [eol] column,
# and its cross-attention to 32 caption keys; (b, sq, sk, hq, hkv)
FLAG_DIT_5B_SHAPES = {"self": (2, 4160, 4160, 32, 32), "self_gqa_masked": (2, 4160, 4160, 32, 8),
                      "cross": (2, 4160, 32, 32, 32)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FLAG_DIT_5B_SHAPES))
@pytest.mark.parametrize("entry", ["bwd_fused", "bwd_dkv", "bwd_dq"])
def test_head_dim_96_matches_plain_on_card(cuda_device, entry, case):
    """K6-K8 at head_dim 96 on the Flag-DiT 5B trainer's shapes, unmasked,
    and with GQA, a masked tail and a fully masked batch row. Bar: 1e-2 of
    max|ref|, mean 1e-3."""
    masked = case.endswith("masked")
    q, k, v, mask, dout = _cuda_inputs(*FLAG_DIT_5B_SHAPES[case], d=96, dead_row=masked)
    if not masked:
        mask.fill_(1)
    got, ref = _run(entry, q, k, v, mask, dout, scale=96 ** -0.5)
    _assert_near(got, ref, 1e-2)


# DreamBooth's training attention at 256^2: MMDiT-SD3-Medium's joint
# sequence (333 context + 256 image tokens, head_dim 64) and the 2B's
# self-attention (head_dim 72); (b, sq, sk, hq, hkv, d)
DREAMBOOTH_SHAPES = {"sd3": (2, 589, 589, 24, 24, 64), "2b": (2, 256, 256, 32, 32, 72)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(DREAMBOOTH_SHAPES))
@pytest.mark.parametrize("entry", ["bwd_fused", "bwd_dkv", "bwd_dq"])
def test_dreambooth_shapes_match_plain_on_card(cuda_device, entry, case):
    """K6-K8 at DreamBooth's shapes with every key valid. Bar: 1e-2 of
    max|ref|, mean 1e-3."""
    *shape, d = DREAMBOOTH_SHAPES[case]
    q, k, v, mask, dout = _cuda_inputs(*shape, d=d)
    mask.fill_(1)
    got, ref = _run(entry, q, k, v, mask, dout, scale=d ** -0.5)
    _assert_near(got, ref, 1e-2)


# FlagDiT-1D's trainer: B=32 over 256 latent frames (self) and its 77
# caption tokens (cross), 16 heads of 72; (b, sq, sk, hq, hkv)
AUDIO_TRAIN_SHAPES = {"self": (32, 256, 256, 16, 16), "cross": (32, 256, 77, 16, 16)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(AUDIO_TRAIN_SHAPES))
@pytest.mark.parametrize("entry", ["bwd_fused", "bwd_dkv", "bwd_dq"])
def test_audio_train_shapes_match_plain_on_card(cuda_device, entry, case):
    """K6-K8 at the audio trainer's shapes with every key valid. Bar: 1e-2
    of max|ref|, mean 1e-3."""
    q, k, v, mask, dout = _cuda_inputs(*AUDIO_TRAIN_SHAPES[case])
    mask.fill_(1)
    got, ref = _run(entry, q, k, v, mask, dout, scale=72 ** -0.5)
    _assert_near(got, ref, 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("sk,lengths", [(8, (1, 5)), (40, (37, 21)), (136, (130, 67))])
@pytest.mark.parametrize("entry", ["bwd_fused", "bwd_dkv", "bwd_dq"])
def test_caption_lengths_match_plain_on_card(cuda_device, entry, sk, lengths):
    """The trainer's cross-attention over Gemma captions: Sk a multiple of 8,
    each row's valid keys ending inside a 64-key tile (the empty caption one
    key), head_dim 72, 8 q heads on 2 kv heads."""
    q, k, v, mask, dout = _cuda_inputs(2, 300, sk, 8, 2, dead_row=False)
    mask.zero_()
    for row, n in enumerate(lengths):
        mask[row, :n] = 1
    got, ref = _run(entry, q, k, v, mask, dout)
    _assert_near(got, ref, 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["bwd_fused", "bwd_dkv", "bwd_dq"])
def test_strided_dout_and_fused_qkv_views_read_in_place(cuda_device, entry):
    """q, k, v as views of one (B, S, 3, H, D) tensor and dout as a view of a
    wider tensor: whole-chunk strides, so the kernel reads them in place."""
    g = torch.Generator().manual_seed(1)
    qkv = torch.randn(2, 190, 3, 4, 72, generator=g).to("cuda", torch.bfloat16)
    q, k, v = qkv.unbind(2)
    dout = torch.randn(2, 190, 4, 80, generator=g).to("cuda", torch.bfloat16)[..., :72]
    assert all(tfa._chunk_aligned(t) is t for t in (q, k, v, dout))
    got, ref = _run(entry, q, k, v, None, dout)
    _assert_near(got, ref, 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["bwd_fused", "bwd_dq"])
def test_misaligned_input_is_copied_and_odd_head_dim_raises(cuda_device, entry):
    """A dout whose base is not on a 16-byte boundary is copied contiguous
    first; a head_dim that is not a multiple of 8 raises."""
    q, k, v, mask, dout = _cuda_inputs(1, 70, 90, 4, 2, dead_row=False)
    flat = torch.empty(dout.numel() + 1, dtype=dout.dtype, device="cuda")
    d_off = flat[1:].view(dout.shape).copy_(dout)
    assert d_off.data_ptr() % 16 != 0 and tfa._chunk_aligned(d_off) is not d_off
    got, ref = _run(entry, q, k, v, mask, d_off)
    _assert_near(got, ref, 1e-2)
    q, k, v, mask, dout = _cuda_inputs(1, 70, 90, 4, 2, d=36, dead_row=False)
    out, lse = tfa.flash_online_lse_plain(q, k, v, mask, 0.2)
    for fn in (tfa.flash_bwd_fused, tfa.flash_bwd_dkv, tfa.flash_bwd_dq):
        with pytest.raises(ValueError, match="multiple of 8"):
            fn(q, k, v, mask, out, lse, dout, 0.2)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["bwd_fused", "bwd_dkv", "bwd_dq"])
def test_fp32_stays_on_the_first_kernels(cuda_device, entry):
    """fp32 inputs take the fp32 kernels (`csrc/flash_bwd_fp32_sm90.cu`, fp32
    FFMA, exact to fp32), not this bf16 kernel: it reads bf16 only, so
    fp32-level agreement shows the route; so does a head_dim it refuses (36)."""
    for d in (72, 36):
        got, ref = _run(entry, *_cuda_inputs(2, 100, 150, 4, 2, d=d, dtype=torch.float32))
        _assert_near(got, ref, 1e-4)


@pytest.mark.cuda
def test_kernel_resources(cuda_device):
    """A block of whole warpgroups (the producer's and one or two
    consumers') resident on an SM, two at once for the 48/48 sweep, the
    registers setmaxnreg hands out within the block's share of the SM's
    65536, no local-memory spills, and the compiled instantiation the one
    `bwd_sm90_instantiation` names, at each instantiation's head_dim, in
    bf16 and fp16: the fused sweep (K6), dK/dV only (K8) and the dQ kernel
    (K7)."""
    for kernel, head_dim, dtype in itertools.product(
            ("fused", "dkv", "dq"), (48, 64, 72, 96, 128), (torch.bfloat16, torch.float16)):
        info = tfa.bwd_sm90_attributes(kernel, head_dim, dtype)
        depth, width, consumers = tfa.bwd_sm90_instantiation(kernel, head_dim)
        assert (info["depth"], info["width"]) == (depth, width)
        assert info["threads"] == 128 * (1 + consumers)
        blocks = 2 if consumers == 1 else 1
        assert info["blocks_per_sm"] >= blocks
        assert (128 * info["producer_registers"] + 128 * consumers * info["consumer_registers"]
                <= min(65536 // blocks, info["registers"] * info["threads"]))
        assert info["local_bytes"] == 0

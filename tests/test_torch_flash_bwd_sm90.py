"""The bf16 flash-attention backward of `lumina_t2x_tpu_torch/csrc/
flash_bwd_sm90.cu` (K6 `flash_bwd_fused`, K8 `flash_bwd_dkv` and K7
`flash_bwd_dq` on bf16 inputs).

On the CPU: `emulate_bwd` repeats the kernel's arithmetic in fp32 torch --
128-key blocks of two 64-key halves; the exp2 domain with scale*log2(e) and
lse*log2(e) folded, the min(., 0) clamp and the lse = -inf guard (+inf in
the exp2 domain); P and dS split into bf16 hi + lo pairs for dV, dK and dQ;
dQ summed block by block in fp32 (the second half's share, then the
first's); dK and dV summed over the GQA group, one bf16 rounding of each
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
BN, HALF = 128, 64  # keys per block, per consumer warpgroup
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


def _pair(x, pair):
    hi = x.to(torch.bfloat16).float()
    return hi, ((x - hi).to(torch.bfloat16).float() if pair else torch.zeros_like(x))


def emulate_bwd(q, k, v, kv_mask, out, lse, dout, scale, pair=True, round_out=True):
    """The kernel's arithmetic in fp32 torch on (B, S, H, D) fp32 tensors and
    the forward's (B, Hq, Sq) LSE: (dq, dk, dv), dk and dv per kv head, each
    rounded once to bf16 (as fp32). `pair=False` rounds P and dS once to
    bf16; `round_out=False` skips the output rounding."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    rep = hq // hkv
    scale2 = _f32(scale) * _f32(LOG2E)  # folded on the host
    # the producer's per-row lse*log2(e): +inf for a row without a valid key
    lse2 = torch.where(lse == -math.inf, torch.tensor(math.inf), lse * _f32(LOG2E))
    lse2 = lse2.reshape(b, hkv, rep, sq)[..., None, :]  # (B, Hkv, rep, 1, Sq): keys x q rows
    delta = (dout * out).sum(-1).permute(0, 2, 1).reshape(b, hkv, rep, sq)[..., None, :]
    qg, dog = q.reshape(b, sq, hkv, rep, d), dout.reshape(b, sq, hkv, rep, d)
    valid = torch.ones(b, sk, dtype=torch.bool) if kv_mask is None else kv_mask != 0
    dq = torch.zeros(b, sq, hkv, rep, d)
    dk, dv = torch.zeros(b, sk, hkv, d), torch.zeros(b, sk, hkv, d)
    for j0 in range(0, sk, BN):  # the last block is ragged: keys past Sk add nothing
        shares = []
        for c0 in (j0, j0 + HALF):
            kc, vc = k[:, c0:c0 + HALF], v[:, c0:c0 + HALF]
            if kc.shape[1] == 0:
                shares.append(torch.zeros_like(dq))
                continue
            ok = valid[:, None, None, c0:c0 + HALF, None]  # (B, 1, 1, keys, 1)
            st = torch.einsum("bkhd,bqhrd->bhrkq", kc, qg)  # S^T
            dpt = torch.einsum("bkhd,bqhrd->bhrkq", vc, dog)  # dP^T
            p = torch.exp2(torch.clamp(st * scale2 - lse2, max=0.0))
            p = torch.where(ok, p, torch.zeros_like(p))
            ds = p * (dpt - delta) * scale
            p_hi, p_lo = _pair(p, pair)
            ds_hi, ds_lo = _pair(ds, pair)
            dv[:, c0:c0 + HALF] += (torch.einsum("bhrkq,bqhrd->bkhd", p_hi, dog)
                                    + torch.einsum("bhrkq,bqhrd->bkhd", p_lo, dog))
            dk[:, c0:c0 + HALF] += (torch.einsum("bhrkq,bqhrd->bkhd", ds_hi, qg)
                                    + torch.einsum("bhrkq,bqhrd->bkhd", ds_lo, qg))
            shares.append(torch.einsum("bhrkq,bkhd->bqhrd", ds_hi, kc)
                          + torch.einsum("bhrkq,bkhd->bqhrd", ds_lo, kc))
        dq += shares[1] + shares[0]  # consumer 1's share, plus consumer 0's
    dq = dq.reshape(b, sq, hq, d)
    rnd = (lambda t: t.to(torch.bfloat16).float()) if round_out else (lambda t: t)
    return rnd(dq), rnd(dk), rnd(dv)


def emulate_dq(q, k, v, kv_mask, out, lse, dout, scale, pair=True, round_out=True):
    """The dQ kernel's arithmetic in fp32 torch, per q row over 64-key tiles
    in order: p = exp2(min(s*scale2 - lse2, 0)) (lse2 = +inf for lse =
    -inf), 0 on an invalid key; ds = p (dp - delta) scale; dQ += (ds_hi +
    ds_lo) K in fp32; rounded once to bf16 (as fp32). `pair=False` rounds
    dS once; `round_out=False` skips the output rounding."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    rep = hq // hkv
    scale2 = _f32(scale) * _f32(LOG2E)
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
        ds_hi, ds_lo = _pair(p * (dp - delta) * scale, pair)
        dq = dq + (torch.einsum("bhrqk,bkhd->bhrqd", ds_hi, kt)
                   + torch.einsum("bhrqk,bkhd->bhrqd", ds_lo, kt))
    dq = dq.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d)
    return dq.to(torch.bfloat16).float() if round_out else dq


def _inputs(seed, b, sq, sk, hq, hkv, d=16, tail=0, dead_row=False):
    """bf16-representable fp32 numpy q, k, v, dout and an int32 mask: the
    last `tail` keys of batch row 0 masked, and with `dead_row` every key of
    the last batch row."""
    rng = np.random.default_rng(seed)
    bf = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(
        torch.bfloat16).float().numpy()
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


@pytest.mark.parametrize("fused", ["1", "0"])
@pytest.mark.parametrize("case", CASES)
def test_emulation_matches_jax(monkeypatch, fused, case):
    b, sq, sk, hq, hkv, tail, scale = case
    q, k, v, dout, mask = _inputs(sk + hq, b, sq, sk, hq, hkv, tail=tail)
    scale = 16 ** -0.5 if scale is None else scale
    monkeypatch.setenv("LUMINA_FLASH_FUSED_BWD", fused)
    _, vjp = jax.vjp(lambda q_, k_, v_: jfa.flash_attention(q_, k_, v_, jnp.asarray(mask), scale),
                     *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(dout))
    got, _ = _emulate_np(q, k, v, dout, mask, scale)
    for a, r in zip(got, ref):
        _close(a, r)


@pytest.mark.parametrize("case", CASES)
def test_emulation_matches_plain(case):
    b, sq, sk, hq, hkv, tail, scale = case
    q, k, v, dout, mask = _inputs(2 * sk + hq, b, sq, sk, hq, hkv, tail=tail)
    scale = 16 ** -0.5 if scale is None else scale
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


@pytest.mark.parametrize("case", CASES)
def test_dq_emulation_matches_jax_split_route(monkeypatch, case):
    """K7's arithmetic against the dq of the JAX package's two-kernel
    backward (`_bwd_dq_kernel`, LUMINA_FLASH_FUSED_BWD=0, Pallas in
    interpret mode)."""
    b, sq, sk, hq, hkv, tail, scale = case
    q, k, v, dout, mask = _inputs(3 * sk + hq, b, sq, sk, hq, hkv, tail=tail)
    scale = 16 ** -0.5 if scale is None else scale
    monkeypatch.setenv("LUMINA_FLASH_FUSED_BWD", "0")
    _, vjp = jax.vjp(lambda q_, k_, v_: jfa.flash_attention(q_, k_, v_, jnp.asarray(mask), scale),
                     *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(dout))[0]
    got, _ = _emulate_dq_np(q, k, v, dout, mask, scale)
    _close(got, ref)


@pytest.mark.parametrize("case", CASES)
def test_dq_emulation_matches_plain(case):
    b, sq, sk, hq, hkv, tail, scale = case
    q, k, v, dout, mask = _inputs(4 * sk + hq, b, sq, sk, hq, hkv, tail=tail)
    scale = 16 ** -0.5 if scale is None else scale
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


def test_bf16_fused_and_dkv_route_to_the_new_source():
    """bf16 `bwd_fused` and `bwd_dkv` run `csrc/flash_bwd_sm90.cu` (their C
    entry points hand bf16 to `flash_bwd_sm90`), and so does bf16 `bwd_dq`
    (to `flash_bwd_dq_sm90`, the dQ kernel); fp32 stays on `flash_bwd.cu`'s
    kernels, which have no bf16 path left. The new source is built into the
    flash library and holds no library kernel."""
    src = (cuda_lib._CSRC / "flash_bwd.cu").read_text()
    entries = src.split('extern "C" {')[1].split("int lumina_flash_")[1:]
    bodies = {e.split("(", 1)[0]: e.split("{", 1)[1] for e in entries}
    assert set(bodies) == {"bwd_fused", "bwd_dq", "bwd_dkv"}
    for name, fused in (("bwd_fused", "true"), ("bwd_dkv", "false")):
        assert re.search(r"if \(is_bf16\)\s+return flash_bwd_sm90\(" + fused + ",", bodies[name])
        assert "LUMINA_FLASH_BWD_CALL" in bodies[name]  # fp32
    assert re.search(r"if \(is_bf16\)\s+return flash_bwd_dq_sm90\(q, k, v, mask, dout, lse, "
                     r"delta, dq, meta, scale, stream\);", bodies["bwd_dq"])
    assert "LUMINA_FLASH_BWD_CALL(Which::kDq)" in bodies["bwd_dq"]  # fp32
    assert "__nv_bfloat16" not in src and "wmma" not in src
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
    `which` (0 dK/dV, 1 fused, 2 dQ) and refuses another name before it
    builds anything."""
    calls = []
    monkeypatch.setattr(tfa, "_attributes", lambda *a: calls.append(a) or {})
    for kernel in ("dkv", "fused", "dq"):
        tfa.bwd_sm90_attributes(kernel, 64)
    assert calls == [("lumina_flash_bwd_sm90_attributes", which, 64) for which in (0, 1, 2)]
    with pytest.raises(ValueError, match="kernel must be one of"):
        tfa.bwd_sm90_attributes(True)


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
    (1, 193, 129, 4, 1, 128), (2, 65, 130, 4, 2, 96)])
@pytest.mark.parametrize("entry", ["bwd_fused", "bwd_dkv", "bwd_dq"])
def test_kernel_matches_plain_on_card(cuda_device, entry, shape):
    """Odd Sq and Sk, GQA, a masked tail and a fully masked batch row, at
    head_dim 72 (the 2B) and in the kernel's other instantiations: 64 (16,
    64) and 128 (96, 128). Bar: one bf16 rounding of max|ref| (1e-2), mean
    1e-3."""
    q, k, v, mask, dout = _cuda_inputs(*shape)
    got, ref = _run(entry, q, k, v, mask, dout)
    _assert_near(got, ref, 1e-2)
    if shape[0] > 1:
        assert not any(t[-1].any() for t in got if t is not None)


# the class-conditional models' head_dim 48 (the 64/64 instantiations, the
# product depth padded past column 48): the 600M's (B, 256, 32, 48) at 256^2
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


# the Flag-DiT 5B's training attention at head_dim 96 (the 128/128
# instantiations): 1024^2 latents, B=2, 64 x 65 tokens with the [eol] column,
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
    """fp32 inputs take flash_bwd.cu's kernels (fp32 FMA, exact to fp32): the
    Hopper kernel reads bf16 only, so fp32-level agreement shows the route;
    so does a head_dim the Hopper kernel refuses (36)."""
    for d in (72, 36):
        got, ref = _run(entry, *_cuda_inputs(2, 100, 150, 4, 2, d=d, dtype=torch.float32))
        _assert_near(got, ref, 1e-4)


@pytest.mark.cuda
def test_kernel_resources(cuda_device):
    """A block of whole warpgroups (the producer's and two consumers')
    resident on an SM, the registers setmaxnreg hands out within the SM's
    65536, no local-memory spills, at each instantiation's head_dim: the
    fused sweep (K6), dK/dV only (K8) and the dQ kernel (K7)."""
    for kernel, head_dim in itertools.product(("fused", "dkv", "dq"), (64, 72, 128)):
        info = tfa.bwd_sm90_attributes(kernel, head_dim)
        consumers = info["threads"] - 128
        assert info["threads"] == 384 and info["blocks_per_sm"] >= 1
        assert 128 * info["producer_registers"] + consumers * info["consumer_registers"] <= 65536
        assert info["local_bytes"] == 0

"""The fp32 attention forward of `lumina_t2x_tpu_torch/csrc/flash_fwd_fp32_sm90.cu`
(K1 `flash_small_kv`, K2 `flash_online`, K3 `flash_static_max`, K4
`flash_online_lse`, K5 `flash_static_max_lse` and the fp32 K9 forwards on
fp32 inputs).

On the CPU: `plan` repeats the host's choice of block (query rows per block
and key-split warps WK) and `emulate` the kernel's arithmetic in fp32 torch
-- 32-key sub-tiles, warp w of WK taking sub-tiles w, w + WK, ...; the exp2
domain with scale*log2(e), bound*log2(e) and the clamp 55*log2(e) folded on
the host; per sub-tile the row max with the alpha rescale and its -inf guard
(online) or the clamped exponent (static max); the WK partial (max, sum, O)
merged in warp order; O times 1/l; the row LSE ln2 * (m + log2 l) or ln2 *
(bound2 + log2 l), -inf where l = 0 -- and holds it, at each WK, to 1e-5
max abs against the JAX package's Pallas K1-K5 in interpret mode and
against the port's plain versions. Inputs are standard normal fp32 from
numpy. Fully masked rows are held against the plain version only (the
Pallas kernels disagree on them).

The `cuda`-marked tests run the kernel on the card against its plain version
and the emulation at FlagDiT-1D's served shapes, its plan and resources
against `plan` (`python -m pytest --noconftest -m cuda
tests/test_torch_flash_fwd_fp32.py`), and skip without one.
"""

import importlib
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
ATOL = 1e-5
SUB, ROWS, WARPS, P_PITCH, SMEM_MAX = 32, 32, 4, 36, 232448


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


def plan(b, sq, hq, d, sms=132):
    """(query rows per block, key-split warps WK, blocks) as the host picks
    them: 4 warps as (WR, WK) = (4, 1), (2, 2) or (1, 4) -- the first whose
    grid reaches `sms` blocks, else the last -- among those whose shared
    memory fits a block (Q, two K/V stages, the warps' P^T, the key flags and
    the stages' mbarriers)."""
    pitch = ((d + 7) & ~7) + 4
    best = None
    for wr in (4, 2, 1):
        wk = WARPS // wr
        floats = (ROWS * wr * pitch + 2 * 2 * SUB * wk * pitch + WARPS * SUB * P_PITCH
                  + 2 * SUB * wk + 2 * 2)
        if 4 * floats > SMEM_MAX:
            continue
        best = (ROWS * wr, wk, -(-sq // (ROWS * wr)) * hq * b)
        if best[2] >= sms:
            break
    return best


def emulate(q, k, v, kv_mask, scale, bound=None, wk=None):
    """The kernel's arithmetic in fp32 torch on (B, S, H, D) fp32 tensors:
    K3/K5 with `bound`, K1/K2/K4 without; `wk` key-split warps (by default
    the host's plan). Returns (out, lse (B, Hq, Sq))."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    rep = hq // hkv
    wk = wk or plan(b, sq, hq, d)[1]
    scale2 = _f32(scale) * _f32(LOG2E)
    bound2 = _f32(0.0 if bound is None else bound) * _f32(LOG2E)
    clamp2 = _f32(55.0) * _f32(LOG2E)
    qg = q.reshape(b, sq, hkv, rep, d)
    valid = torch.ones(b, sk, dtype=torch.bool) if kv_mask is None else kv_mask != 0
    streams = []
    for w in range(wk):  # warp w of the key split: sub-tiles w, w + wk, ...
        o = torch.zeros(b, hkv, rep, sq, d)
        l = torch.zeros(b, hkv, rep, sq)
        m = torch.full((b, hkv, rep, sq), -math.inf)
        for t0 in range(w * SUB, sk, wk * SUB):
            kt, vt = k[:, t0:t0 + SUB], v[:, t0:t0 + SUB]
            ok = valid[:, None, None, None, t0:t0 + SUB]
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
            o = o + torch.einsum("bhrqk,bkhd->bhrqd", p, vt)
            l = l + p.sum(-1)
        streams.append((o, l, m))
    o, l, m = streams[0]
    for ow, lw, mw in streams[1:]:  # the merge, in warp order
        if bound is None:
            m_new = torch.maximum(m, mw)
            none = m_new == -math.inf
            a = torch.where(none, torch.zeros_like(m), torch.exp2(m - m_new))
            aw = torch.where(none, torch.zeros_like(m), torch.exp2(mw - m_new))
            m = m_new
        else:
            a = aw = torch.ones_like(l)
        l = l * a + lw * aw
        o = o * a[..., None] + ow * aw[..., None]
    inv = torch.where(l > 0, 1.0 / l.clamp_min(1e-30), torch.zeros_like(l))
    out = (o * inv[..., None]).permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d)
    base = m if bound is None else bound2
    lse = _f32(math.log(2)) * (base + torch.log2(l))
    lse = torch.where(l > 0, lse, torch.full_like(l, -math.inf)).reshape(b, hq, sq)
    return out, lse


def _inputs(seed, b, sq, sk, hq, hkv, d, tail=0, dead_row=False):
    """fp32 numpy inputs and an int32 mask: the last `tail` keys of batch row
    0 masked, and with `dead_row` every key of the last batch row."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d)))
    mask = np.ones((b, sk), np.int32)
    if tail:
        mask[0, sk - tail:] = 0
    if dead_row:
        mask[-1] = 0
    return q, k, v, mask


# (b, sq, sk, hq, hkv, d, masked tail): FlagDiT-1D's head_dim 72 over 16
# caption keys (half a sub-tile) and 128 frames (one sub-tile per key-split
# warp), a ragged Sk with GQA 4 at a head_dim that is not a multiple of 4,
# and 7 sub-tiles with GQA 4 at head_dim 16
CASES = [(2, 40, 16, 4, 4, 72, 3), (1, 48, 128, 4, 2, 72, 0), (2, 33, 100, 8, 2, 30, 17),
         (1, 70, 200, 4, 1, 16, 64)]
WKS = (1, 2, 4)


def _bound(q, k, v, mask, scale, offset):
    """The calibrated bound: max row LSE + offset (a negative offset puts the
    bound below the row maxima, where the clamp fires)."""
    lse = tfa.flash_online_lse_plain(*map(torch.from_numpy, (q, k, v, mask)), scale)[1]
    return float(lse[torch.isfinite(lse)].max()) + offset


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0, atol=ATOL)


def _emulate_all(q, k, v, mask, scale, bound):
    """The emulation at each WKS (WK = 1 is one stream, like the (4, 1) plan)."""
    args = tuple(map(torch.from_numpy, (q, k, v, mask)))
    return {wk: emulate(*args, scale, bound, wk=wk) for wk in WKS}


def test_plan_fills_the_card_and_fits_a_block():
    """FlagDiT-1D's served (2, 128, 16, 72): 32 rows a block and the keys split
    over 4 warps, 128 blocks (the template ran 64); the 2B's (2, 4096, 32,
    72): 128 rows a block, 2048 blocks; head_dim 96 and 128 cannot hold two
    stages of 128 keys, so a small grid takes (2, 2)."""
    assert plan(2, 128, 16, 72) == (32, 4, 128)
    assert plan(2, 4096, 32, 72) == (128, 1, 2048)
    assert plan(32, 256, 16, 72) == (128, 1, 1024)
    assert plan(2, 128, 16, 128)[:2] == plan(2, 128, 16, 96)[:2] == (64, 2)
    assert plan(2, 128, 16, 80)[:2] == (32, 4)
    assert plan(2, 4096, 32, 72, sms=4096)[:2] == (64, 2)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("entry", ["small_kv", "online", "static_max"])
def test_emulation_matches_pallas(entry, case):
    """K1-K3 at every key split against the Pallas kernel (K1 the single-pass
    `_flash_small_kv_kernel`, K2/K3 the streaming kernel), within 1e-5."""
    b, sq, sk, hq, hkv, d, tail = case
    q, k, v, mask = _inputs(1, b, sq, sk, hq, hkv, d, tail=tail)
    scale = d ** -0.5
    bound = _bound(q, k, v, mask, scale, 6.0) if entry == "static_max" else None
    args = tuple(map(jnp.asarray, (q, k, v, mask)))
    if entry == "small_kv":
        ref = jfa._flash_small_kv_impl(*args, scale, 128)
    else:
        ref = jfa._flash_attention_fwd_impl(*args, scale, 128, 128, static_max=bound)
    for wk, (out, _) in _emulate_all(q, k, v, mask, scale, bound).items():
        _close(out, ref)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("entry", ["online_lse", "static_max_lse"])
def test_lse_emulation_matches_pallas(entry, case):
    """K4/K5: the output and the epilogue's row LSE against the Pallas
    `_flash_fwd_res_impl` (whose LSE is lane-replicated to 128 and padded to
    its q block: sliced to (B, Hq, Sq)), within 1e-5."""
    b, sq, sk, hq, hkv, d, tail = case
    q, k, v, mask = _inputs(7, b, sq, sk, hq, hkv, d, tail=tail)
    scale = 0.3
    bound = _bound(q, k, v, mask, scale, 8.0) if entry == "static_max_lse" else None
    ref_out, ref_lse = jfa._flash_fwd_res_impl(*map(jnp.asarray, (q, k, v, mask)), scale, 128,
                                               128, static_max=bound)
    ref_lse = np.asarray(ref_lse)[:, :, :sq, 0]
    for wk, (out, lse) in _emulate_all(q, k, v, mask, scale, bound).items():
        _close(out, ref_out)
        _close(lse, ref_lse)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("entry", tfa._FWD_ENTRIES)
def test_emulation_matches_plain(entry, case):
    """All five entries at every key split against the port's plain versions,
    a fully masked last batch row included where B > 1 (0, LSE -inf), within
    1e-5."""
    b, sq, sk, hq, hkv, d, tail = case
    q, k, v, mask = _inputs(2, b, sq, sk, hq, hkv, d, tail=tail, dead_row=b > 1)
    scale = 0.25
    bound = _bound(q, k, v, mask, scale, 6.0) if entry.startswith("static_max") else None
    args = tuple(map(torch.from_numpy, (q, k, v, mask)))
    if bound is None:
        ref_out, ref_lse = tfa.flash_online_lse_plain(*args, scale)
    else:
        ref_out, ref_lse = tfa.flash_static_max_lse_plain(*args, scale, bound)
    for wk, (out, lse) in _emulate_all(q, k, v, mask, scale, bound).items():
        if b > 1:
            assert torch.equal(out[-1], torch.zeros_like(out[-1]))
            assert torch.isneginf(lse[-1]).all()
        assert torch.equal(torch.isfinite(lse), torch.isfinite(ref_lse))
        _close(out, ref_out)
        if entry.endswith("_lse"):
            fin = torch.isfinite(ref_lse)
            _close(lse[fin], ref_lse[fin])


def test_clamp_in_log2_units_matches_pallas():
    """A bound 70 nats below the largest row LSE: the clamp at 55 nats fires
    on some keys, at 55*log2(e) in the exp2 domain. Outputs reach ~3, so
    the bar is relative: 1e-5 of max |ref|."""
    q, k, v, mask = _inputs(3, 1, 24, 150, 4, 2, 72, tail=9)
    q = q * 4  # logits up to ~100: exp(s - bound) reaches the clamp
    scale = 0.3
    bound = _bound(q, k, v, mask, scale, -70.0)
    s = np.einsum("bqhd,bkhd->bhqk", q[:, :, ::2], k) * scale
    assert (s - bound > 55).any()  # the clamp is exercised
    ref = jfa._flash_attention_fwd_impl(*map(jnp.asarray, (q, k, v, mask)), scale, 128, 128,
                                        static_max=bound)
    top = float(np.abs(np.asarray(ref)).max())
    for wk, (out, _) in _emulate_all(q, k, v, mask, scale, bound).items():
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=ATOL * top)


def test_online_rescale_across_sub_tiles():
    """Row maxima that grow from sub-tile to sub-tile (the alpha rescale runs
    on every one) and a first stage whose keys are all masked (m stays -inf
    in every warp of the split, alpha and the merge are guarded)."""
    q, k, v, mask = _inputs(5, 1, 16, 300, 2, 2, 72)
    k = k * np.linspace(0.2, 3.0, 300, dtype=np.float32)[None, :, None, None]
    mask[0, :4 * SUB] = 0
    ref = jfa._flash_attention_fwd_impl(*map(jnp.asarray, (q, k, v, mask)), 0.3, 128, 128)
    for wk, (out, _) in _emulate_all(q, k, v, mask, 0.3, None).items():
        _close(out, ref)


def _source(name):
    return (cuda_lib._CSRC / name).read_text()


def test_fp32_kernel_is_its_own_source_and_the_template_is_gone():
    """The fp32 forward lives in `flash_fwd_fp32_sm90.cu`, declared in the
    `flash` library; it multiplies with fp32 FFMA only (no tensor-core
    product, TF32 included) and copies with TMA bulk copies (`bulk_copy` of
    `sm90_common.cuh`, which it shares with the fp32 backward); `flash_fwd.cu` keeps the
    entry points and none of the first fp32 template (`Layout`, `load_tile`,
    `qk_tile`, `pv_tile`, `flash_fwd_kernel`, `launch`)."""
    assert "flash_fwd_fp32_sm90.cu" in cuda_lib._DECLARED[tfa.LIBRARY][0]
    assert "lumina_flash_fwd_fp32_attributes" in cuda_lib._DECLARED[tfa.LIBRARY][1]
    kernel = _source("flash_fwd_fp32_sm90.cu")
    code = "\n".join(line.split("//")[0] for line in kernel.splitlines())  # comments out
    assert "fmaf(" in code and "bulk_copy(" in code and '#include "sm90_common.cuh"' in code
    assert "cp.async.bulk.shared" in _source("sm90_common.cuh")
    assert not re.search(r"\bw?mma\b|mma\.sync|\btf32\b|__nv_bfloat16", code, re.I)
    assert "cudaFuncSetAttribute" in kernel and "static const cudaError_t" in kernel
    entries = _source("flash_fwd.cu")
    for gone in ("struct Layout", "load_tile", "qk_tile", "pv_tile", "flash_fwd_kernel",
                 "launch<", "cudaFuncSetAttribute", "__global__"):
        assert gone not in entries, gone


def test_times_script_needs_the_card(monkeypatch):
    """`exps/fp32_times.py` times the card: without a CUDA device it stops
    before importing or building anything, with no CPU fallback."""
    from lumina_t2x_tpu_torch.exps import fp32_times

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA device"):
        fp32_times.main(["--parts", "forward"])


# -- on the card: the kernel against its plain version and the emulation -------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


# FlagDiT-1D's served request: the CFG batch over 128 latent frames (self)
# and its 16 caption tokens (cross), 16 heads of 72
AUDIO = {"self": (2, 128, 128, 16), "cross": (2, 128, 16, 16)}


@pytest.mark.cuda
@pytest.mark.parametrize("entry", tfa._FWD_ENTRIES)
@pytest.mark.parametrize("case", sorted(AUDIO))
def test_audio_shapes_match_plain_and_emulation_on_card(cuda_device, entry, case):
    """Every entry at FlagDiT-1D's served shapes, every key valid, within
    1e-5 of the plain version on the card and of the emulation on the CPU;
    K4/K5's LSE too."""
    b, sq, sk, h = AUDIO[case]
    g = torch.Generator().manual_seed(sk)
    q, k, v = (torch.randn(*s, generator=g) for s in ((b, sq, h, 72), (b, sk, h, 72),
                                                     (b, sk, h, 72)))
    scale = 72 ** -0.5
    bound = {"bound": 8.0} if entry.startswith("static_max") else {}
    before = tfa.LAUNCHES[entry]
    got = getattr(tfa, f"flash_{entry}")(q.cuda(), k.cuda(), v.cuda(), None, scale, **bound)
    ref = getattr(tfa, f"flash_{entry}_plain")(q.cuda(), k.cuda(), v.cuda(), None, scale,
                                               *bound.values())
    torch.cuda.synchronize()
    assert tfa.LAUNCHES[entry] == before + 1
    emu_out, emu_lse = emulate(q, k, v, None, scale, bound.get("bound"))
    if entry.endswith("_lse"):
        (got, lse), (ref, ref_lse) = got, ref
        assert (lse - ref_lse).abs().max().item() <= ATOL
        assert (lse.cpu() - emu_lse).abs().max().item() <= ATOL
    assert got.dtype == torch.float32
    assert (got - ref).abs().max().item() <= ATOL
    assert (got.cpu() - emu_out).abs().max().item() <= ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 128, 128, 16, 16, 72), (2, 128, 16, 16, 16, 72),
                                   (2, 4096, 4096, 32, 32, 72), (32, 256, 256, 16, 16, 72),
                                   (2, 128, 128, 16, 16, 128), (2, 300, 77, 8, 2, 30),
                                   (1, 70, 200, 4, 1, 16)])
def test_plan_and_resources_on_card(cuda_device, shape):
    """The plan the C host code makes equals `plan` (with the card's SM
    count); the instantiation it launches has no local-memory spills and at
    least one block resident per SM, two at the 2B's (4, 1) plan."""
    b, sq, sk, hq, hkv, d = shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows, wk, blocks = plan(b, sq, hq, d, sms=sms)
    for static_max in (False, True):
        info = tfa.fp32_attributes(static_max, b, sq, sk, hq, hkv, d)
        got = (info["rows_per_block"], info["key_warps"], info["grid_blocks"])
        assert got == (rows, wk, blocks)
        assert info["local_bytes"] == 0 and info["threads"] == 128
        assert info["blocks_per_sm"] >= (2 if (rows, d) == (128, 72) else 1)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["small_kv", "online_lse"])
def test_unaligned_operands_are_read_in_place_on_card(cuda_device, entry):
    """An operand whose base is not on a 16-byte boundary, a strided view of
    a fused (B, S, 3, H, D) buffer and a head_dim that is not a multiple of 4
    take the kernel's 4-byte copies, not a host copy: the same output bit
    for bit as the aligned operands' 16-byte copies (the products are the
    same), and within 1e-5 of plain at head_dim 30."""
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 150, 4, 72, generator=g).cuda() for _ in range(3))
    mask = torch.ones(2, 150, dtype=torch.int32, device="cuda")
    mask[0, 120:] = 0
    call = getattr(tfa, f"flash_{entry}")
    base = call(q, k, v, mask, 0.2)
    flat = torch.empty(q.numel() + 1, device="cuda")
    q_off = flat[1:].view(q.shape).copy_(q)  # base 4 bytes past the allocation
    q71, k71, v71 = torch.randn(2, 150, 3, 4, 71, generator=g).cuda().unbind(2)  # fused views
    assert q_off.data_ptr() % 16 != 0 and q71.stride(2) == 71
    same = call(q_off, k, v, mask, 0.2)
    torch.cuda.synchronize()
    if entry.endswith("_lse"):
        (base, base_lse), (same, same_lse) = base, same
        assert torch.equal(base_lse, same_lse)
    assert torch.equal(base, same)
    got = call(q71, k71, v71, mask, 0.2)
    ref = getattr(tfa, f"flash_{entry}_plain")(q71, k71, v71, mask, 0.2)
    q30, k30, v30 = (t[..., :30] for t in (q, k, v))
    got30 = call(q30, k30, v30, mask, 0.2)
    ref30 = getattr(tfa, f"flash_{entry}_plain")(q30, k30, v30, mask, 0.2)
    torch.cuda.synchronize()
    if entry.endswith("_lse"):
        (got, _), (ref, _), (got30, _), (ref30, _) = got, ref, got30, ref30
    assert (got - ref).abs().max().item() <= ATOL
    assert (got30 - ref30).abs().max().item() <= ATOL

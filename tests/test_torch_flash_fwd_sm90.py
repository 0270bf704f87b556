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


def emulate(q, k, v, kv_mask, scale, bound=None, p_pair=True, round_out=True):
    """The kernel's arithmetic in fp32 torch on (B, S, H, D) fp32 tensors:
    K3/K5 with `bound`, K2/K4 without. Returns (out, lse): the output, rounded
    once to bf16, as fp32, and the (B, Hq, Sq) row LSE the epilogue writes
    for K4/K5. `p_pair=False` drops P's lo half and `round_out=False` the
    output rounding (for the test of the pair alone)."""
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
        hi = p.to(torch.bfloat16).float()
        lo = (p - hi).to(torch.bfloat16).float() if p_pair else torch.zeros_like(p)
        o = o + torch.einsum("bhrqk,bkhd->bhrqd", hi, vt) + torch.einsum("bhrqk,bkhd->bhrqd", lo, vt)
        l = l + p.sum(-1)
    inv = torch.where(l > 0, 1.0 / l.clamp_min(1e-30), torch.zeros_like(l))
    out = (o * inv[..., None]).permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d)
    # the epilogue: ln2 * (base + log2 l), the base the log2-domain max or bound2
    base = m if bound is None else bound2
    lse = _f32(math.log(2)) * (base + torch.log2(l))
    lse = torch.where(l > 0, lse, torch.full_like(l, -math.inf)).reshape(b, hq, sq)
    return (out.to(torch.bfloat16).float() if round_out else out), lse


def _inputs(seed, b, sq, sk, hq, hkv, d=16, tail=0, dead_row=False):
    """bf16-representable fp32 numpy inputs and an int32 mask: the last
    `tail` keys of batch row 0 masked, and with `dead_row` every key of the
    last batch row."""
    rng = np.random.default_rng(seed)
    bf = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(
        torch.bfloat16).float().numpy()
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


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("entry", ["small_kv", "online", "static_max"])
def test_emulation_matches_pallas(entry, case):
    """K1 is the online kernel over all keys: the same emulation holds the
    single-pass exact softmax of `_flash_small_kv_kernel`."""
    b, sq, sk, hq, hkv, tail = case
    q, k, v, mask = _inputs(1, b, sq, sk, hq, hkv, tail=tail)
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


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("entry", ["online_lse", "static_max_lse"])
def test_lse_emulation_matches_pallas(entry, case):
    """K4/K5: the output and the epilogue's row LSE against the Pallas
    `_flash_fwd_res_impl` (whose LSE is lane-replicated to 128 and padded to
    its q block: sliced to (B, Hq, Sq))."""
    b, sq, sk, hq, hkv, tail = case
    q, k, v, mask = _inputs(7, b, sq, sk, hq, hkv, tail=tail)
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


def _entry_bodies():
    """{entry name: C source from its signature on} of flash_fwd.cu's
    extern "C" entry points."""
    src = (cuda_lib._CSRC / "flash_fwd.cu").read_text()
    return src, {e.split("(", 1)[0]: e.split("{", 1)[1]
                 for e in src.split('extern "C" {')[1].split("int lumina_flash_")[1:]}


def test_bf16_forwards_route_to_the_hopper_kernel():
    """bf16 K1-K5 hand their inputs to `flash_fwd_sm90` (K4/K5 with their lse
    pointer, K1-K3 with none, none with rotation tables), and bf16 K9 with
    the tables and no LSE (`rope_forward`); fp32 stays on the template,
    which has no bf16 code left."""
    src, bodies = _entry_bodies()
    for name, static_max, lse in (("small_kv", "false", "nullptr"), ("online", "false", "nullptr"),
                                  ("static_max", "true", "nullptr"),
                                  ("online_lse", "false", "lse"),
                                  ("static_max_lse", "true", "lse")):
        assert re.search(rf"if \(is_bf16\)\s+return flash_fwd_sm90\({static_max}, q, k, v, mask, "
                         rf"out, {lse}, nullptr, nullptr, meta,", bodies[name]), name
        fp32 = re.search(r"return launch<(true|false), (true|false)>", bodies[name])
        assert fp32.groups() == (static_max, "true" if lse == "lse" else "false"), name
    for name in ("rope", "rope_q"):
        assert "return rope_forward(q, k, v, mask, out, rope_cos, rope_sin, meta," in bodies[name]
    rope = src[src.index("int rope_forward("):src.index("}  // namespace")]
    assert re.search(r"if \(is_bf16\) \{.*return flash_fwd_sm90\(false, q, k, v, mask, out, nullptr, "
                     r"rope_cos, rope_sin, meta,", rope, re.S)
    assert "return launch<false, false>(" in rope
    assert tfa._SM90_ENTRIES == ("small_kv", "online", "static_max", "online_lse",
                                 "static_max_lse")
    assert "__nv_bfloat16" not in src and "wmma" not in src and "kRope" not in src


def test_breakdown_entry_matches_the_kernel_signature():
    """`exps/fwd_sm90_breakdown.py` compiles its own C entry around
    `flash_fwd_sm90`: it passes the header's parameters in their order, with
    no LSE (it times K2/K3); the definition has the header's parameters."""
    from lumina_t2x_tpu_torch.exps import fwd_sm90_breakdown as bd

    def names(text, pattern):
        params = re.search(pattern, text, re.S).group(1)
        return [p.split()[-1].lstrip("*") for p in params.split(",")]

    header = names((cuda_lib._CSRC / "flash_fwd_sm90.cuh").read_text(),
                   r"int flash_fwd_sm90\((.*?)\);")
    assert header == ["static_max", "q", "k", "v", "mask", "out", "lse", "rope_cos", "rope_sin",
                      "meta", "scale", "bound", "stream"]
    assert names((cuda_lib._CSRC / "flash_fwd_sm90.cu").read_text(),
                 r"\nint flash_fwd_sm90\((.*?)\) \{") == header
    args = re.search(r"return flash_fwd_sm90\((.*?)\);", bd._ENTRY, re.S).group(1)
    assert [a.strip() for a in args.split(",")] == [
        "static_max != 0", *header[1:6], "nullptr", "nullptr", "nullptr", *header[9:]]


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


@pytest.mark.parametrize("module", ["lumina_t2x_tpu_torch.exps.fwd_sm90_breakdown",
                                    "lumina_t2x_tpu_torch.pipelines.profile_forward"])
def test_measurement_scripts_need_the_card(monkeypatch, module):
    """The breakdown and the forward profile time the card: without a CUDA
    device they stop before building anything, with no CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA device"):
        importlib.import_module(module).main()


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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (2, 77, 33, 8, 1, 72), (2, 130, 257, 4, 2, 72), (1, 300, 1000, 8, 8, 72), (3, 1, 1, 2, 1, 72),
    (2, 200, 300, 4, 1, 48), (1, 70, 90, 4, 2, 16), (1, 129, 200, 8, 2, 64),
    (2, 65, 130, 4, 4, 96), (1, 193, 129, 4, 1, 128)])
@pytest.mark.parametrize("entry", ENTRIES)
def test_kernel_matches_plain_on_card(cuda_device, entry, shape):
    """Odd Sq and Sk, GQA, a masked tail and a fully masked batch row, at
    head_dim 72 (the 2B) and in each of the kernel's other instantiations:
    depth and width 64 (head_dim 48 of the 600M, 16 of the Tiny model, 64)
    and 128 (96, 128); K1 at Sk <= 1024 like every other entry, one partial
    tile to 16 tiles."""
    q, k, v, mask = _cuda_inputs(*shape)
    before = tfa.LAUNCHES[entry]
    got, ref = _call(entry, q, k, v, mask)
    assert tfa.LAUNCHES[entry] == before + 1  # one launch per call
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert torch.count_nonzero(got[-1]).item() == 0
    err = (got.float() - ref).abs()
    assert err.max().item() <= 1e-2 and err.mean().item() <= 1e-3


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
    """fp32 inputs take flash_fwd.cu's template (fp32 FMA, exact to fp32),
    K1's too; the Hopper kernel reads bf16 only, so fp32-level agreement
    shows the route."""
    q, k, v, mask = (t.float() if t.is_floating_point() else t
                     for t in _cuda_inputs(2, 100, 150, 4, 2))
    got, ref = _call(entry, q, k, v, mask)
    assert got.dtype == torch.float32
    assert (got - ref).abs().max().item() <= 1e-5


@pytest.mark.cuda
def test_rope_kernel_equals_the_first_template_online_forward(cuda_device):
    """fp32 K9 (`rope_rotate` on q and k, then flash_fwd.cu's online
    template) equals that template's `flash_online_lse(...)[0]` on
    `apply_rope`d inputs to one fp32 ulp."""
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
def test_kernel_resources(cuda_device):
    """A block of whole warpgroups (the producer's and the consumers')
    resident on an SM, the registers setmaxnreg hands out within the SM's
    65536, no local-memory spills, at each instantiation's head_dim."""
    for static_max, head_dim in itertools.product((False, True), (64, 72, 128)):
        info = tfa.sm90_attributes(static_max, head_dim)
        consumers = info["threads"] - 128
        assert info["threads"] % 128 == 0 and consumers >= 256 and info["blocks_per_sm"] >= 1
        assert 128 * info["producer_registers"] + consumers * info["consumer_registers"] <= 65536
        assert info["local_bytes"] == 0


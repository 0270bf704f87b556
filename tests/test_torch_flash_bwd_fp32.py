"""The fp32 attention backward of `lumina_t2x_tpu_torch/csrc/flash_bwd_fp32_sm90.cu`
(K6 `flash_bwd_fused`, K8 `flash_bwd_dkv` and K7 `flash_bwd_dq` on fp32
inputs), and the route of each dtype to its kernels (fp16 and bf16 to the
Hopper kernels' instantiations, `csrc/flash_*_sm90.cu`).

On the CPU: `plan` repeats the host's plan (shared memory, rows per block
and per streamed tile, blocks in the grid) and `emulate_kv` / `emulate_dq`
the kernels' arithmetic in fp32 torch -- the dK/dV sweep over 64-key blocks,
the q heads of each kv head's group in order and 32-row q tiles of each;
the dQ kernel over 64-row q blocks and 32-key sub-tiles in order; the exp2
domain with scale*log2(e) and lse*log2(e), the min(., 0) clamp, and p and
dS set to 0 by a select on invalid keys, rows past Sq and rows with lse =
-inf; dV += P^T dO and dK += dS^T Q tile by tile; the fused sweep's dQ of
each (q tile, key block) summed over the block's four warps' 16 keys in
order and added into the fp32 buffer block by block -- and
holds them to 1e-5 max abs against the JAX package's `_flash_bwd_fused_impl`
(LUMINA_FLASH_FUSED_BWD=1) and `_flash_bwd_impl` (=0), Pallas kernels in
interpret mode through `jax.vjp`, and against the port's `flash_bwd_plain`.
Inputs are standard normal fp32 from numpy; out and the LSE come from the
port's plain LSE forward. Fully masked rows are held against the plain
version only (the Pallas kernels disagree on them). On the card the fused
sweep's dQ tiles land in an order that varies from run to run (fp32 adds in
L2); the K7 + K8 pair is repeatable bit for bit. Either way the order of
fp32 sums moves results by ~1e-7 here, far inside 1e-5, and the card's bar is
1e-4 of max|gradient| of the plain version.

The `cuda`-marked tests run each kernel on the card against its plain
version and the emulation at the music trainer's and the 2B's shapes, the
fp16 route (the Hopper kernels' fp16 instantiations) against the plain
version, and the plan and resources against
`plan` (`python -m pytest --noconftest -m cuda
tests/test_torch_flash_bwd_fp32.py`); they skip without one.
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
KEYS, QT, PDS_PITCH, ROWS_Q, SUB, DS_PITCH, WARPS, STAGES = 64, 32, 20, 64, 32, 40, 4, 2
SMEM_MAX, TWO_BLOCKS = 232448, 110 * 1024


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


def pitch(d):
    """Floats per row of Q, dO, K and V in shared memory."""
    return ((d + 7) & ~7) + 4


def plan(kernel, b, sq, sk, hq, hkv, d):
    """(shared bytes a block, rows per block, rows per streamed tile, blocks)
    as the host plans `kernel` ("fused", "dkv" or "dq"): a dK/dV block holds
    K and V (64 rows), two stages of Q and dO (32 rows) with lse and delta,
    each warp's P and dS buffers (32 q rows x 20 floats each), the fused
    sweep's 32 x D dQ staging tile (128-byte aligned) and two mbarriers; a dQ
    block Q and dO (64 rows), two stages of K and V (32 keys) with their key
    flags, each warp's dS buffer (16 q rows x 40 floats) and two
    mbarriers."""
    p = pitch(d)
    if kernel == "dq":
        floats = 2 * ROWS_Q * p + STAGES * (2 * SUB * p + SUB) + WARPS * 16 * DS_PITCH
        return 4 * (floats + 2 * STAGES), ROWS_Q, SUB, -(-sq // ROWS_Q) * hq * b
    buf = 2 * KEYS * p + STAGES * (2 * QT * p + 2 * QT)
    staging = (buf + WARPS * 2 * QT * PDS_PITCH + 31) & ~31
    bar = (staging + (QT * d if kernel == "fused" else 0) + 1) & ~1
    return 4 * (bar + 2 * STAGES), KEYS, QT, -(-sk // KEYS) * hkv * b


def _exp_domain(q, lse, out, dout, scale):
    """scale*log2(e) as the host folds it, lse*log2(e) per row, whether a row
    has a valid key, delta = rowsum(dO * O) as the wrapper computes it."""
    scale2 = _f32(scale) * _f32(LOG2E)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)  # (B, Hq, Sq)
    return scale2, lse * _f32(LOG2E), lse != -math.inf, delta


def emulate_kv(q, k, v, kv_mask, out, lse, dout, scale, fused=True):
    """The dK/dV kernel's arithmetic (K6 with `fused`, K8 without) in fp32
    torch on (B, S, H, D) fp32 tensors and the forward's (B, Hq, Sq) LSE:
    (dq or None, dk, dv), dk and dv per kv head."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    rep = hq // hkv
    scale2, lse2, row_ok, delta = _exp_domain(q, lse, out, dout, scale)
    lse2, row_ok, delta = (t.reshape(b, hkv, rep, sq) for t in (lse2, row_ok, delta))
    qg, og = q.reshape(b, sq, hkv, rep, d), dout.reshape(b, sq, hkv, rep, d)
    valid = torch.ones(b, sk, dtype=torch.bool) if kv_mask is None else kv_mask != 0
    dk, dv = torch.zeros(b, sk, hkv, d), torch.zeros(b, sk, hkv, d)
    dq = torch.zeros(b, sq, hkv, rep, d) if fused else None
    for j0 in range(0, sk, KEYS):  # a block; keys past Sk are not there
        kt, vt = k[:, j0:j0 + KEYS], v[:, j0:j0 + KEYS]
        key_ok = valid[:, None, j0:j0 + KEYS, None]  # (B, 1, keys, 1)
        dkb, dvb = torch.zeros_like(kt), torch.zeros_like(vt)
        for r in range(rep):  # the group's q heads, then the q tiles of each
            for q0 in range(0, sq, QT):
                qt, ot = qg[:, q0:q0 + QT, :, r], og[:, q0:q0 + QT, :, r]
                st = torch.einsum("bkhd,bqhd->bhkq", kt, qt)  # S^T
                dpt = torch.einsum("bkhd,bqhd->bhkq", vt, ot)  # dP^T
                ok = key_ok & row_ok[:, :, r, None, q0:q0 + QT]
                e = torch.exp2(torch.clamp(st * scale2 - lse2[:, :, r, None, q0:q0 + QT], max=0.0))
                p = torch.where(ok, e, torch.zeros_like(e))
                ds = p * (dpt - delta[:, :, r, None, q0:q0 + QT]) * _f32(scale)
                ds = torch.where(ok, ds, torch.zeros_like(ds))
                dvb += torch.einsum("bhkq,bqhd->bkhd", p, ot)
                dkb += torch.einsum("bhkq,bqhd->bkhd", ds, qt)
                if fused:  # the tile's dQ: the 4 warps' 16 keys in order, added as one tile
                    tile = torch.zeros_like(qt)
                    for w0 in range(0, kt.shape[1], KEYS // WARPS):
                        tile = tile + torch.einsum("bhkq,bkhd->bqhd", ds[:, :, w0:w0 + 16],
                                                   kt[:, w0:w0 + 16])
                    dq[:, q0:q0 + QT, :, r] += tile
        dk[:, j0:j0 + KEYS], dv[:, j0:j0 + KEYS] = dkb, dvb
    return (dq.reshape(b, sq, hq, d) if fused else None), dk, dv


def emulate_dq(q, k, v, kv_mask, out, lse, dout, scale):
    """The dQ kernel's (K7) arithmetic in fp32 torch: per q row, dQ += dS K
    over the 32-key sub-tiles in order, p and dS selected to 0 as in
    `emulate_kv`."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    rep = hq // hkv
    scale2, lse2, row_ok, delta = _exp_domain(q, lse, out, dout, scale)
    lse2, row_ok, delta = (t.reshape(b, hkv, rep, sq, 1) for t in (lse2, row_ok, delta))
    qg, og = q.reshape(b, sq, hkv, rep, d), dout.reshape(b, sq, hkv, rep, d)
    valid = torch.ones(b, sk, dtype=torch.bool) if kv_mask is None else kv_mask != 0
    dq = torch.zeros(b, hkv, rep, sq, d)
    for t0 in range(0, sk, SUB):
        kt, vt = k[:, t0:t0 + SUB], v[:, t0:t0 + SUB]
        ok = valid[:, None, None, None, t0:t0 + SUB] & row_ok
        s = torch.einsum("bqhrd,bkhd->bhrqk", qg, kt)
        dp = torch.einsum("bqhrd,bkhd->bhrqk", og, vt)
        e = torch.exp2(torch.clamp(s * scale2 - lse2, max=0.0))
        p = torch.where(ok, e, torch.zeros_like(e))
        ds = torch.where(ok, p * (dp - delta) * _f32(scale), torch.zeros_like(p))
        dq = dq + torch.einsum("bhrqk,bkhd->bhrqd", ds, kt)
    return dq.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d)


def _inputs(seed, b, sq, sk, hq, hkv, d, tail=0, dead_row=False):
    """fp32 numpy q, k, v, dout and an int32 mask: the last `tail` keys of
    batch row 0 masked, and with `dead_row` every key of the last row."""
    rng = np.random.default_rng(seed)
    q, k, v, dout = (rng.standard_normal(s).astype(np.float32)
                     for s in ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d), (b, sq, hq, d)))
    mask = np.ones((b, sk), np.int32)
    if tail:
        mask[0, sk - tail:] = 0
    if dead_row:
        mask[-1] = 0
    return q, k, v, dout, mask


def _port_args(q, k, v, dout, mask, scale):
    """Torch tensors of the inputs with out and LSE from the port's plain LSE
    forward: the arguments of the backward entry points."""
    tq, tk, tv, tdo, tm = map(torch.from_numpy, (q, k, v, dout, mask))
    out, lse = tfa.flash_online_lse_plain(tq, tk, tv, tm, scale)
    return tq, tk, tv, tm, out, lse, tdo, scale


def _emulate_all(args):
    """(fused dq, dk, dv), K8's (dk, dv) and K7's dq on the backward's args."""
    fused = emulate_kv(*args, fused=True)
    _, dk, dv = emulate_kv(*args, fused=False)
    return fused, (dk, dv), emulate_dq(*args)


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0, atol=ATOL)


# (b, sq, sk, hq, hkv, d, masked tail): GQA 2 below one key block (Sk 37 <
# 64) with a ragged q tile at head_dim 72; Sk 150 (two whole key blocks and
# 22 keys) and 70 q rows at head_dim 48; Sk 100 with GQA 2 at head_dim 96
CASES = [(2, 40, 37, 4, 2, 72, 5), (1, 70, 150, 2, 2, 48, 17), (2, 33, 100, 4, 2, 96, 0)]


def test_plan_fits_two_blocks_an_sm():
    """At head_dim 72 every kernel's block stays under 110 KB, so two share
    an SM (the template's fused sweep took ~199 KB, one a SM); head_dim 128
    still fits one block. The grids at the 2B's and the music trainer's
    shapes."""
    for kernel in ("fused", "dkv", "dq"):
        assert plan(kernel, 2, 4096, 4096, 32, 32, 72)[0] <= TWO_BLOCKS
        assert plan(kernel, 2, 4096, 4096, 32, 32, 128)[0] <= SMEM_MAX
    assert plan("fused", 2, 4096, 4096, 32, 32, 72) == (108048, 64, 32, 4096)
    assert plan("dkv", 2, 4096, 4096, 32, 32, 72) == (98832, 64, 32, 4096)
    assert plan("dq", 2, 4096, 4096, 32, 32, 72) == (88336, 64, 32, 4096)
    # the music trainer: 256 frames (4 key blocks) and 77 caption keys (2)
    assert plan("fused", 32, 256, 256, 16, 16, 72)[3] == 2048
    assert plan("fused", 32, 256, 77, 16, 16, 72)[3] == 1024
    assert plan("dq", 32, 256, 77, 16, 16, 72)[3] == 2048


@pytest.mark.parametrize("fused", ["1", "0"])
@pytest.mark.parametrize("case", CASES)
def test_emulation_matches_pallas(monkeypatch, fused, case):
    """K6 (LUMINA_FLASH_FUSED_BWD=1, `_flash_bwd_fused_impl`) and K7 + K8 (=0,
    `_flash_bwd_impl`) against `jax.vjp` of the JAX `flash_attention`, within
    1e-5."""
    b, sq, sk, hq, hkv, d, tail = case
    q, k, v, dout, mask = _inputs(sk + d, b, sq, sk, hq, hkv, d, tail=tail)
    scale = d ** -0.5
    monkeypatch.setenv("LUMINA_FLASH_FUSED_BWD", fused)
    _, vjp = jax.vjp(lambda q_, k_, v_: jfa.flash_attention(q_, k_, v_, jnp.asarray(mask), scale),
                     *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(dout))
    (fdq, fdk, fdv), (dk, dv), dq = _emulate_all(_port_args(q, k, v, dout, mask, scale))
    for got, r in zip((fdq, fdk, fdv) if fused == "1" else (dq, dk, dv), ref):
        _close(got, r)


@pytest.mark.parametrize("case", CASES + [(2, 45, 90, 4, 1, 30, 11)])
def test_emulation_matches_plain(case):
    """Every kernel against `flash_bwd_plain`, a fully masked last batch row
    included (dq = 0, nothing added to dk and dv), head_dim 30 with GQA 4
    too, within 1e-5."""
    b, sq, sk, hq, hkv, d, tail = case
    q, k, v, dout, mask = _inputs(2 * sk + d, b, sq, sk, hq, hkv, d, tail=tail, dead_row=b > 1)
    args = _port_args(q, k, v, dout, mask, 0.3)
    ref = tfa.flash_bwd_plain(*args)
    (fdq, fdk, fdv), (dk, dv), dq = _emulate_all(args)
    for got, r in zip((fdq, fdk, fdv, dq, dk, dv), ref + ref):
        if b > 1:
            assert torch.equal(got[-1], torch.zeros_like(got[-1])) and not r[-1].any()
        _close(got, r)


def _source(name):
    return (cuda_lib._CSRC / name).read_text()


def test_fp32_backward_is_its_own_source_and_the_template_is_gone():
    """fp32 K6-K8 live in `flash_bwd_fp32_sm90.cu`, declared in the `flash`
    library with its attributes entry; they multiply with fp32 FFMA only (no
    tensor-core product, TF32 included), copy with TMA bulk copies and add
    the fused sweep's dQ by TMA bulk reduce-adds. `flash_bwd.cu` keeps the
    three entry points and none of the first fp32 template (`Layout`, the scalar
    products, the per-element atomics)."""
    sources, symbols = cuda_lib._DECLARED[tfa.LIBRARY]
    assert "flash_bwd_fp32_sm90.cu" in sources and "lumina_flash_bwd_fp32_attributes" in symbols
    kernel = _source("flash_bwd_fp32_sm90.cu")
    code = "\n".join(line.split("//")[0] for line in kernel.splitlines())  # comments out
    assert "fmaf(" in code and "bulk_copy(" in code and "tma_reduce_add(" in code
    assert "flash_bwd_kv_kernel" in code and "flash_bwd_dq_kernel" in code
    assert not re.search(r"\bw?mma\b|mma\.sync|wgmma_|\btf32\b|__nv_bfloat16", code, re.I)
    assert not re.search(r"#include\s*[<\"](cublas|cudnn|cutlass|cute)", kernel)
    entries = _source("flash_bwd.cu")
    for gone in ("struct Layout", "mm_abt", "mm_atb", "mm_ab", "softmax_grad", "load_tile",
                 "atomicAdd", "__global__", "cudaFuncSetAttribute"):
        assert gone not in entries, gone
    assert entries.count("flash_bwd_fp32_sm90(") == 1  # the LUMINA_FLASH_BWD_CALL macro


class _OnCuda(torch.Tensor):
    is_cuda = True


def _dtype_check(dtype):
    """`_check_inputs` on (1, 4, 2, 16) tensors of `dtype` that report
    themselves on CUDA (its dtype rule runs before anything is built)."""
    t = torch.ones(1, 4, 2, 16, dtype=dtype).as_subclass(_OnCuda)
    return tfa._check_inputs(t, t, t, None)


class _RecordingLibrary:
    """Stands in for the built `flash` library: each C entry point records
    its arguments and returns 0 (success) without launching anything."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("lumina_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_each_dtype_reaches_its_kernels(monkeypatch, dtype):
    """The dtype route, through a forward (K2), the backward (its delta
    kernel, then K7) and `rope_rotate` with a stand-in library: bf16 and fp16
    reach the Hopper entries with their own dtype code (1, 2) and fp32 the
    fp32 kernels' (0), with q read in place (no cast, no copy); fp16's
    backward hands the kernels max|dO| (`_do_amax`), the others null; the
    launch counts split by dtype. Any other dtype raises before anything is
    built or launched."""
    assert tfa._KERNEL_DTYPES == (torch.bfloat16, torch.float16, torch.float32)
    lib = _RecordingLibrary()
    monkeypatch.setattr(cuda_lib, "build_library", lambda name: lib)
    monkeypatch.setattr(tfa, "_on_device", lambda t: tfa._SAME_DEVICE)
    monkeypatch.setattr(tfa, "_stream", lambda t: 0)
    tfa.reset_launch_counts()
    q, k, v, dout = _dtype_check(dtype)[:3] + (_dtype_check(dtype)[0] * -3,)
    out = tfa.flash_online(q, k, v, None, 0.25)
    lse = torch.zeros(1, 2, 4)
    tfa.flash_bwd_dq(q, k, v, None, out, lse, dout, 0.25)
    tfa.rope_rotate(torch.ones(1, 4, 2, 16, dtype=dtype).as_subclass(type(q)), torch.zeros(4, 8))
    code = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}[dtype]
    (fwd, fwd_args), (dlt, dlt_args), (bwd, bwd_args), (rot, rot_args) = lib.calls
    assert (fwd, dlt, bwd, rot) == ("lumina_flash_online", "lumina_bwd_delta",
                                    "lumina_flash_bwd_dq", "lumina_rope_rotate")
    assert fwd_args[0] == q.data_ptr() and bwd_args[0] == q.data_ptr()
    assert (fwd_args[9], dlt_args[4], bwd_args[13], rot_args[5]) == (code, code, code, code)
    assert bwd_args[6] == dlt_args[2]  # the backward reads the delta kernel's output
    assert (bwd_args[7] is not None) == (dtype == torch.float16)  # do_amax
    assert out.dtype == dtype
    tag = {torch.float32: "fp32", torch.bfloat16: "bf16", torch.float16: "fp16"}[dtype]
    assert {n: c for n, c in tfa.DTYPE_LAUNCHES.items() if c} == {
        f"online_{tag}": 1, f"bwd_delta_{tag}": 1, f"bwd_dq_{tag}": 1, f"rope_rotate_{tag}": 1}
    amax = tfa._do_amax(dout)
    assert amax.dtype == dout.dtype and amax.shape == (1,) and amax.item() == 3.0
    for bad in (torch.float64, torch.int32):
        with pytest.raises(TypeError, match="bf16, fp16 or fp32"):
            _dtype_check(bad)
    assert len(lib.calls) == 4


def test_fp16_cpu_training_attention_matches_fp32():
    """On the CPU fp16 tensors take the plain versions (autograd included),
    gradients in fp16 within fp16 rounding of the fp32 ones."""
    q, k, v, dout, mask = _inputs(4, 2, 24, 40, 4, 2, 16, tail=6)
    grads = {}
    for dtype in (torch.float16, torch.float32):
        leaves = [torch.from_numpy(t).to(dtype).requires_grad_() for t in (q, k, v)]
        out = tfa.flash_attention(*leaves, torch.from_numpy(mask), 0.25)
        out.backward(torch.from_numpy(dout).to(dtype))
        assert out.dtype == dtype and all(t.grad.dtype == dtype for t in leaves)
        grads[dtype] = [t.grad.float() for t in leaves]
    for a, r in zip(grads[torch.float16], grads[torch.float32]):
        assert (a - r).abs().max() <= 2e-2 * max(1.0, r.abs().max().item())


def test_times_script_needs_the_card(monkeypatch):
    """`exps/fp32_times.py` times the card: without a CUDA device it stops
    before importing or building anything, with no CPU fallback."""
    from lumina_t2x_tpu_torch.exps import fp32_times

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA device"):
        fp32_times.main(["--parts", "backward", "trainer"])


# -- on the card: each kernel against its plain version and the emulation ------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


# (b, sq, sk, h, masked tail): the music trainer's FlagDiT-1D (B=32, 256 latent
# frames, 16 heads of 72) over its frames and over its 77 caption keys; the
# 2B's (2, 4096, 32, 72) with a masked tail
SHAPES = {"music_self": (32, 256, 256, 16, 0), "music_cross": (32, 256, 77, 16, 0),
          "2b": (2, 4096, 4096, 32, 819)}


def _card_args(shape, dtype=torch.float32, seed=0):
    b, sq, sk, h, tail = SHAPES[shape]
    g = torch.Generator().manual_seed(seed)
    q, k, v, dout = (torch.randn(*s, generator=g) for s in ((b, sq, h, 72), (b, sk, h, 72),
                                                            (b, sk, h, 72), (b, sq, h, 72)))
    mask = torch.ones(b, sk, dtype=torch.int32)
    if tail:
        mask[-1, sk - tail:] = 0
    q, k, v, dout, mask = (t.cuda() for t in (q, k, v, dout, mask))
    scale = 72 ** -0.5
    out, lse = tfa.flash_online_lse_plain(q, k, v, mask, scale)
    return tuple(t.to(dtype) for t in (q, k, v)) + (mask, out.to(dtype), lse, dout.to(dtype),
                                                     scale)


def _assert_within(got, ref, rel=1e-4):
    top = ref.float().abs().max().item()
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= rel * top, (err, top)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_kernels_match_plain_and_emulation_on_card(cuda_device, shape):
    """K6, K7 and K8 within 1e-4 of max|gradient| of the plain version on the
    card (the card's bar), each launched once; at the music shapes also
    within 1e-5 of the emulation on the CPU."""
    args = _card_args(shape)
    before = dict(tfa.LAUNCHES)
    got = {"bwd_fused": tfa.flash_bwd_fused(*args), "bwd_dq": tfa.flash_bwd_dq(*args),
           "bwd_dkv": tfa.flash_bwd_dkv(*args)}
    ref = tfa.flash_bwd_plain(*args)
    torch.cuda.synchronize()
    for name in got:
        assert tfa.LAUNCHES[name] == before[name] + 1
    for a, r in zip((*got["bwd_fused"], got["bwd_dq"], *got["bwd_dkv"]), ref + ref):
        assert a.dtype == torch.float32
        _assert_within(a, r)
    if shape != "2b":
        cpu = tuple(t.cpu() if torch.is_tensor(t) else t for t in args)
        (fdq, fdk, fdv), (dk, dv), dq = _emulate_all(cpu)
        for a, e in zip((*got["bwd_fused"], got["bwd_dq"], *got["bwd_dkv"]),
                        (fdq, fdk, fdv, dq, dk, dv)):
            assert (a.cpu() - e).abs().max().item() <= ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 48, 64, 96, 100, 128])
def test_head_dims_match_plain_on_card(cuda_device, d):
    """Every PV width (NC = 1..8 with head_dim 30 and 72 above; 100 is not
    a multiple of 8) with GQA 2 and a masked tail: K6, K7 and K8 within 1e-4
    of max|gradient| of the plain version."""
    g = torch.Generator().manual_seed(d)
    q, dout = (torch.randn(2, 200, 4, d, generator=g).cuda() for _ in range(2))
    k, v = (torch.randn(2, 170, 2, d, generator=g).cuda() for _ in range(2))
    mask = torch.ones(2, 170, dtype=torch.int32, device="cuda")
    mask[1, 150:] = 0
    out, lse = tfa.flash_online_lse_plain(q, k, v, mask, d ** -0.5)
    args = (q, k, v, mask, out, lse, dout, d ** -0.5)
    got = (*tfa.flash_bwd_fused(*args), tfa.flash_bwd_dq(*args), *tfa.flash_bwd_dkv(*args))
    ref = tfa.flash_bwd_plain(*args)
    torch.cuda.synchronize()
    for a, r in zip(got, ref + ref):
        _assert_within(a, r)


@pytest.mark.cuda
def test_split_pair_is_repeatable_on_card(cuda_device):
    """K7 and K8 write each gradient once: two runs agree bit for bit. The
    fused sweep's dQ tiles land in any order: two runs agree within the
    fp32 sums' order."""
    args = _card_args("music_self")
    first = (tfa.flash_bwd_dq(*args), *tfa.flash_bwd_dkv(*args), tfa.flash_bwd_fused(*args)[0])
    second = (tfa.flash_bwd_dq(*args), *tfa.flash_bwd_dkv(*args), tfa.flash_bwd_fused(*args)[0])
    torch.cuda.synchronize()
    for a, b_ in zip(first[:3], second[:3]):
        assert torch.equal(a, b_)
    _assert_within(first[3], second[3], 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["bwd_fused", "bwd_dq", "bwd_dkv"])
def test_unaligned_and_odd_head_dims_on_card(cuda_device, entry):
    """Operands read in place by the kernels' 4-byte copies (a q whose base is
    not on a 16-byte boundary, head_dim 30, a strided view of a fused
    buffer), a dQ buffer not in whole chunks (atomics), GQA 4 and a fully
    masked batch row: within 1e-4 of max|gradient| of plain."""
    g = torch.Generator().manual_seed(5)
    for d in (72, 30):
        qkv = torch.randn(2, 150, 3, 8, d, generator=g).cuda()
        q, k, v = qkv[:, :, 0], qkv[:, :, 1, :2], qkv[:, :, 2, :2]
        if d == 72:
            flat = torch.empty(q.numel() + 1, device="cuda")
            q = flat[1:].view(q.shape).copy_(q)
            assert q.data_ptr() % 16 != 0
        dout = torch.randn(2, 150, 8, d, generator=g).cuda()
        mask = torch.ones(2, 150, dtype=torch.int32, device="cuda")
        mask[0, 111:] = 0
        mask[1] = 0
        out, lse = tfa.flash_online_lse_plain(q, k, v, mask, 0.2)
        args = (q, k, v, mask, out, lse, dout, 0.2)
        got = getattr(tfa, f"flash_{entry}")(*args)
        got = (got,) if entry == "bwd_dq" else got
        ref = tfa.flash_bwd_plain(*args)
        ref = {"bwd_fused": ref, "bwd_dq": ref[:1], "bwd_dkv": ref[1:]}[entry]
        torch.cuda.synchronize()
        for a, r in zip(got, ref):
            _assert_within(a, r)
            assert not a[1].any()


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["1", "0"])
def test_fp16_route_matches_plain_on_card(cuda_device, monkeypatch, route):
    """fp16 q/k/v through `flash_attention` under autograd: the fp16
    instantiations of the Hopper LSE forward and backward kernels launch
    (no cast to fp32), the output and the gradients come back fp16, within
    1e-3 of max|x| of the plain versions run on the same fp16 inputs (one
    fp16 rounding of each output), and no plain version runs on CUDA."""
    monkeypatch.setenv("LUMINA_FLASH_FUSED_BWD", route)
    q, k, v, mask, _, _, dout, scale = _card_args("music_cross", torch.float16)
    results = []
    for fn in (tfa.flash_attention, tfa.flash_attention_plain):
        tfa.reset_launch_counts()
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves, mask, scale)
        out.backward(dout)
        results.append((out, *(t.grad for t in leaves)))
        if fn is tfa.flash_attention:
            torch.cuda.synchronize()
            assert tfa.PLAIN_CUDA_CALLS["count"] == 0 and tfa.LAUNCHES["online_lse"] == 1
            launched = ("bwd_fused",) if route == "1" else ("bwd_dq", "bwd_dkv")
            assert all(tfa.LAUNCHES[name] == 1 for name in launched)
            assert all(tfa.DTYPE_LAUNCHES[f"{name}_fp16"] == 1
                       for name in ("online_lse", *launched))
    for a, r in zip(*results):
        assert a.dtype == torch.float16 and torch.isfinite(a).all()
        _assert_within(a, r, 1e-3)


@pytest.mark.cuda
def test_fp16_forwards_match_plain_on_card(cuda_device):
    """fp16 through the forward entry points (K1, K2, K4 and the fused-RoPE
    K9, on the Hopper kernels' fp16 instantiations): fp16 out, within 1e-3
    of max|out| of plain."""
    q, k, v, mask, _, _, _, scale = _card_args("music_cross", torch.float16)
    for name in ("small_kv", "online", "online_lse"):
        got = getattr(tfa, f"flash_{name}")(q, k, v, mask, scale)
        ref = getattr(tfa, f"flash_{name}_plain")(q, k, v, mask, scale)
        if name.endswith("_lse"):
            (got, lse), (ref, ref_lse) = got, ref
            assert lse.dtype == torch.float32
            _assert_within(lse, ref_lse, 1e-3)
        assert got.dtype == torch.float16
        _assert_within(got, ref, 1e-3)
    angles = torch.rand(q.shape[1], q.shape[3] // 2, device="cuda")
    got = tfa.flash_rope_q(q, k, v, angles, mask, scale)
    ref = tfa.flash_rope_q_plain(q, k, v, angles, mask, scale)
    assert got.dtype == torch.float16
    _assert_within(got, ref, 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 256, 256, 16, 16, 72), (32, 256, 77, 16, 16, 72),
                                   (2, 4096, 4096, 32, 32, 72), (2, 150, 150, 8, 2, 30),
                                   (2, 300, 300, 8, 8, 128)])
def test_plan_and_resources_on_card(cuda_device, shape):
    """The plan the C host code makes equals `plan`; each kernel has no
    local-memory spills, and two blocks share an SM at head_dim 72."""
    for kernel in ("fused", "dkv", "dq"):
        info = tfa.bwd_fp32_attributes(kernel, *shape)
        got = (info["shared_bytes"], info["rows_per_block"], info["rows_per_tile"],
               info["grid_blocks"])
        assert got == plan(kernel, *shape)
        assert info["local_bytes"] == 0 and info["threads"] == 128
        assert info["blocks_per_sm"] >= (2 if shape[-1] == 72 else 1)

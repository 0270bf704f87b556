"""The port's training attention (`lumina_t2x_tpu_torch/ops/flash_attention.py`:
`_FlashAttention`, `flash_static_max_lse`, the backward entry points and
`use_fused_bwd`) against the JAX package's custom_vjp `_flash_attention`,
whose Pallas kernels run in interpret mode on the CPU:

  flash_static_max_lse               <- _flash_fwd_res_impl, static_max=bound (K5)
  flash_bwd_fused                    <- _flash_bwd_fused_impl (K6)
  flash_bwd_dq + flash_bwd_dkv       <- _flash_bwd_impl (K7 + K8)

Gradients come from `jax.grad` through `lumina_t2x_tpu.ops.flash_attention.
flash_attention` and from `torch.autograd` through the port's
`flash_attention`, for the same numpy inputs and cotangent, fp32 on both
sides, bar atol 2e-4 / rtol 2e-3. Both backward routes are forced on both
sides with LUMINA_FLASH_FUSED_BWD. The `cuda`-marked tests hold each new
kernel against its plain version on the card and skip without one.
"""

import importlib
import sys

import numpy as np
import pytest
import torch

from lumina_t2x_tpu_torch.ops import flash_attention as tfa

_JFA = "lumina_t2x_tpu.ops.flash_attention"
ATOL, RTOL = 2e-4, 2e-3


class _Lazy:
    """JAX is imported at first use, so that the `cuda` tests below also run
    on a machine without JAX (`pytest --noconftest -m cuda`)."""

    def __init__(self, module):
        self._module = module

    def __getattr__(self, name):
        return getattr(importlib.import_module(self._module), name)


jfa = _Lazy(_JFA)
jax = _Lazy("jax")
jnp = _Lazy("jax.numpy")


@pytest.fixture(autouse=True)
def _reset_bounds(monkeypatch):
    """The static-max bounds are module state in both packages."""
    for var in ("LUMINA_FLASH_STATIC_MAX", "LUMINA_FLASH_STATIC_MAX_TRAIN",
                "LUMINA_FLASH_FUSED_BWD", "LUMINA_FLASH_BWD_BQ", "LUMINA_FLASH_BWD_BK"):
        # the JAX package reads the last two for its blocks; the routing test
        # compares with its defaults
        monkeypatch.delenv(var, raising=False)

    def clear():
        tfa.set_flash_static_max(None)
        tfa.set_flash_static_max_train(None)
        if _JFA in sys.modules:
            jfa.set_flash_static_max(None)
            jfa.set_flash_static_max_train(None)

    clear()
    yield
    clear()


def _inputs(seed, b=2, sq=40, sk=37, hq=4, hkv=2, d=16, masked=True):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    g = rng.standard_normal((b, sq, hq, d)).astype(np.float32)  # the cotangent
    mask = np.ones((b, sk), np.int32)
    if masked:  # partial masks: every row keeps some valid keys
        mask[0, sk - sk // 4:] = 0
        mask[1, : sk // 3] = 0
    return q, k, v, mask, g


def _jax_grads(q, k, v, mask, g, scale):
    def loss(q_, k_, v_):
        return jnp.sum(jfa.flash_attention(q_, k_, v_, jnp.asarray(mask), scale) * jnp.asarray(g))

    return [np.asarray(a) for a in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


def _port_grads(q, k, v, mask, g, scale, plain=False):
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    fn = tfa.flash_attention_plain if plain else tfa.flash_attention
    out = fn(tq, tk, tv, torch.from_numpy(mask), scale)
    (out * torch.from_numpy(g)).sum().backward()
    return [t.grad.numpy() for t in (tq, tk, tv)]


# (label, sk, hkv, train bound offset over max LSE or None, scale)
CASES = [
    ("cross-attention", 37, 4, None, None),
    ("cross-attention gqa 4:2", 37, 2, None, 0.31),
    ("streaming", 1040, 4, None, 0.2),
    ("streaming with train bound, gqa 4:2", 1040, 2, 8.0, None),
]


@pytest.mark.parametrize("fused", ["1", "0"])
@pytest.mark.parametrize("label,sk,hkv,offset,scale", CASES)
def test_gradients_match_jax(monkeypatch, fused, label, sk, hkv, offset, scale):
    q, k, v, mask, g = _inputs(sk + hkv, sk=sk, hkv=hkv)
    jscale = scale if scale is not None else 16 ** -0.5
    if offset is not None:
        lse_max = float(jfa.flash_lse_range(*(jnp.asarray(a) for a in (q, k, v, mask)), jscale)[0])
        jfa.set_flash_static_max_train(lse_max + offset)
        tfa.set_flash_static_max_train(lse_max + offset)
    monkeypatch.setenv("LUMINA_FLASH_FUSED_BWD", fused)
    ref = _jax_grads(q, k, v, mask, g, jscale)
    calls = {name: [] for name in ("flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv",
                                   "flash_static_max_lse_plain", "flash_online_lse_plain")}
    for name, record in calls.items():
        fn = getattr(tfa, name)
        monkeypatch.setattr(tfa, name, lambda *a, _fn=fn, _r=record, **kw: _r.append(1) or _fn(*a, **kw))
    got = _port_grads(q, k, v, mask, g, scale)
    for a, b_ in zip(got, ref):
        np.testing.assert_allclose(a, b_, atol=ATOL, rtol=RTOL)
    assert len(calls["flash_bwd_fused"]) == (fused == "1")
    assert len(calls["flash_bwd_dq"]) == len(calls["flash_bwd_dkv"]) == (fused == "0")
    assert len(calls["flash_static_max_lse_plain"]) == (offset is not None)
    assert len(calls["flash_online_lse_plain"]) == (offset is None)
    # masked keys get exactly zero dk and dv
    assert not got[1][0, sk - sk // 4:].any() and not got[2][1, : sk // 3].any()


def test_plain_impl_matches_kernel_route():
    q, k, v, mask, g = _inputs(7, sk=1040)
    for a, b_ in zip(_port_grads(q, k, v, mask, g, 0.25, plain=True),
                     _port_grads(q, k, v, mask, g, 0.25)):
        np.testing.assert_array_equal(a, b_)


@pytest.mark.parametrize("offset", [8.0, -40.0])
def test_static_max_lse_matches_pallas(offset):
    """offset 8 is the train calibration margin; -40 makes the exp clamp at
    55 fire, so the LSE is no longer exact (as in the Pallas kernel)."""
    q, k, v, mask, _ = _inputs(3, sq=48, sk=1100)
    jargs = [jnp.asarray(a) for a in (q, k, v, mask)]
    bound = float(jfa.flash_lse_range(*jargs, 0.25)[0]) + offset
    ref_out, ref_lse = jfa._flash_fwd_res_impl(*jargs, 0.25, 128, 512, static_max=bound)
    out, lse = tfa.flash_static_max_lse(*(torch.from_numpy(a) for a in (q, k, v, mask)), 0.25,
                                        bound=bound)
    assert lse.shape == (2, 4, 48) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[:, :, :48, 0], atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("b,sq,hq,d,sk", [
    (2, 4096, 32, 72, 4096), (8, 4096, 32, 72, 4096), (4, 4096, 24, 96, 4096),
    (2, 40, 4, 16, 37), (16, 1024, 32, 128, 32), (9, 4096, 32, 72, 4096)])
def test_backward_route_matches_jax(b, sq, hq, d, sk):
    bq, bk = jfa._pick_bwd_blocks(sq, sk, d)
    assert tfa.use_fused_bwd(b, sq, hq, d, sk) == jfa._use_fused_bwd(b, sq, hq, d, bq, bk, sk)


def test_backward_route_env_override(monkeypatch):
    assert tfa.use_fused_bwd(2, 4096, 32, 72, 4096)
    monkeypatch.setenv("LUMINA_FLASH_FUSED_BWD", "0")
    assert not tfa.use_fused_bwd(2, 4096, 32, 72, 4096)
    monkeypatch.setenv("LUMINA_FLASH_FUSED_BWD", "1")
    assert tfa.use_fused_bwd(64, 4096, 32, 72, 4096)


def test_no_grad_keeps_inference_route(monkeypatch):
    """Without autograd the inference entry points and the inference bound
    serve the call; with autograd the LSE forward and the train bound do. A
    bound in one slot never reaches the other path."""
    q, k, v, mask, _ = _inputs(4, sk=1100)
    tq, tk, tv, tm = (torch.from_numpy(a) for a in (q, k, v, mask))
    seen = []
    for name in ("flash_static_max_plain", "flash_online_plain", "flash_static_max_lse_plain",
                 "flash_online_lse_plain"):
        fn = getattr(tfa, name)
        monkeypatch.setattr(tfa, name, lambda *a, _fn=fn, _n=name, **kw: seen.append(_n) or _fn(*a, **kw))
    tfa.set_flash_static_max(9.0)
    with torch.no_grad():
        tfa.flash_attention(tq.requires_grad_(), tk, tv, tm)
    tfa.flash_attention(tq, tk, tv, tm)
    tfa.set_flash_static_max(None)
    tfa.set_flash_static_max_train(9.0)
    with torch.no_grad():
        tfa.flash_attention(tq, tk, tv, tm)
    tfa.flash_attention(tq, tk, tv, tm)
    assert seen == ["flash_static_max_plain", "flash_online_lse_plain", "flash_online_plain",
                    "flash_static_max_lse_plain"]


def test_train_bound_env_pin(monkeypatch):
    tfa.set_flash_static_max_train(3.0)
    monkeypatch.setenv("LUMINA_FLASH_STATIC_MAX_TRAIN", "11.5")
    assert tfa.get_flash_static_max(train=True) == 11.5
    assert tfa.get_flash_static_max() is None
    monkeypatch.delenv("LUMINA_FLASH_STATIC_MAX_TRAIN")
    assert tfa.get_flash_static_max(train=True) == 3.0


@pytest.mark.parametrize("fused", ["1", "0"])
def test_fully_masked_row_gets_zero_grads(monkeypatch, fused):
    monkeypatch.setenv("LUMINA_FLASH_FUSED_BWD", fused)
    q, k, v, mask, g = _inputs(5, sk=70)
    mask[1] = 0  # batch row 1: no valid key
    dq, dk, dv = _port_grads(q, k, v, mask, g, None)
    assert not dq[1].any() and not dk[1].any() and not dv[1].any()
    assert np.isfinite(dq).all() and np.abs(dq[0]).max() > 0
    ref = _port_grads(*(a[:1] for a in (q, k, v, mask, g)), None)
    for a, b_ in zip((dq, dk, dv), ref):
        np.testing.assert_allclose(a[:1], b_, atol=1e-6, rtol=1e-6)


def test_cpu_backward_launches_no_kernel():
    tfa.reset_launch_counts()
    _port_grads(*_inputs(6, sk=1100), None)
    assert all(n == 0 for n in tfa.LAUNCHES.values())
    assert tfa.PLAIN_CUDA_CALLS["count"] == 0


# -- on the card: each new CUDA kernel against its plain version -------------------


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
    mask[1, :5] = 0
    return mk(b, sq, hq, d), mk(b, sk, hkv, d), mk(b, sk, hkv, d), mask.cuda(), mk(b, sq, hq, d)


def _assert_near(got, ref, dtype):
    """bf16 outputs: one bf16 rounding of each (8 mantissa bits); fp32: the
    order of sums (atomics in the fused kernel)."""
    rel = 8e-3 if dtype == torch.bfloat16 else 1e-4
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= rel * max(1.0, ref.float().abs().max().item()), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_static_max_lse_matches_plain_on_card(cuda_device, dtype):
    q, k, v, mask, _ = _cuda_inputs(dtype)
    before = tfa.LAUNCHES["static_max_lse"]
    out, lse = tfa.flash_static_max_lse(q, k, v, mask, 0.2, bound=9.0)
    ref, ref_lse = tfa.flash_static_max_lse_plain(q, k, v, mask, 0.2, 9.0)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["static_max_lse"] == before + 1
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)
    _assert_near(out, ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("route", ["fused", "split"])
def test_backward_matches_plain_on_card(cuda_device, dtype, route):
    q, k, v, mask, dout = _cuda_inputs(dtype)
    mask[1] = 0  # a fully masked batch row
    out, lse = tfa.flash_online_lse(q, k, v, mask, 0.2)
    args = (q, k, v, mask, out, lse, dout, 0.2)
    if route == "fused":
        got = tfa.flash_bwd_fused(*args)
    else:
        got = (tfa.flash_bwd_dq(*args), *tfa.flash_bwd_dkv(*args))
    ref = tfa.flash_bwd_plain(*args)
    torch.cuda.synchronize()
    for a, r, t in zip(got, ref, (q, k, v)):
        assert a.dtype == t.dtype and a.shape == t.shape
        _assert_near(a, r, dtype)
    assert not got[0][1].any() and not got[1][1].any() and not got[2][1].any()


@pytest.mark.cuda
def test_function_launches_training_kernels_on_card(cuda_device, monkeypatch):
    tfa.reset_launch_counts()
    q, k, v, mask, dout = _cuda_inputs(torch.bfloat16, sq=1100, sk=1100)
    tfa.set_flash_static_max_train(12.0)
    for fused in ("1", "0"):
        monkeypatch.setenv("LUMINA_FLASH_FUSED_BWD", fused)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        tfa.flash_attention(*leaves, mask, 0.2).backward(dout)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["static_max_lse"] == 2
    assert tfa.LAUNCHES["bwd_fused"] == tfa.LAUNCHES["bwd_dq"] == tfa.LAUNCHES["bwd_dkv"] == 1
    assert tfa.PLAIN_CUDA_CALLS["count"] == 0

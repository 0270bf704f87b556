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

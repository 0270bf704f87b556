"""The port's fused-RoPE attention (`lumina_t2x_tpu_torch/ops/flash_attention.py`:
`flash_attention_rope`, `flash_rope`, `flash_rope_q`, `_FlashAttentionRope`)
and the `LUMINA_FUSE_ROPE=1` branch of `models/layers.Attention`, against
the JAX package's `flash_attention_rope`, whose Pallas kernels
(`_flash_rope_kernel`, `_flash_rope_q_kernel`; the backward's `_flash_bwd`)
run in interpret mode on the CPU.

Same numpy inputs on both sides, fp32, bar atol 2e-4 / rtol 2e-3 (the
port's torch-parity bar). The `cuda`-marked tests hold the CUDA kernels
against their plain versions and against K2 on rotated inputs on the card,
and skip without one.
"""

import importlib
import sys
import threading

import numpy as np
import pytest
import torch

from lumina_t2x_tpu_torch.ops import flash_attention as tfa
from lumina_t2x_tpu_torch.ops.rope import apply_rope, rot_tables

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
def _clean_state(monkeypatch):
    for var in ("LUMINA_FUSE_ROPE", "LUMINA_FLASH_STATIC_MAX", "LUMINA_FLASH_STATIC_MAX_TRAIN",
                "LUMINA_FLASH_FUSED_BWD", "LUMINA_FLASH_STATIC_MAX_AUTO", "LUMINA_FLASH_CALIBRATE"):
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


def _angles(sq, d, theta=10000.0):
    """Interleaved-pair angles (Sq, D/2), positions 0..Sq-1 scaled so that the
    later rows reach a few hundred radians (as extrapolated sizes do)."""
    freqs = theta ** (-np.arange(0, d, 2, dtype=np.float32) / d)
    return (np.arange(sq, dtype=np.float32)[:, None] * 7.0 * freqs[None]).astype(np.float32)


def _inputs(seed, b=2, sq=40, sk=40, hq=4, hkv=2, d=16, masked=True):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    g = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    mask = np.ones((b, sk), np.int32)
    if masked:  # partial masks: every row keeps some valid keys
        mask[0, sk - sk // 4:] = 0
        mask[1, : sk // 3] = 0
    return q, k, v, mask, g, _angles(sq, d)


# (label, sk, hkv, rotate_k, masked, scale)
CASES = [
    ("self", 40, 4, True, False, None),
    ("self gqa 4:2 masked tail", 40, 2, True, True, 0.3),
    ("cross", 37, 4, False, False, None),
    ("cross gqa 4:1 masked tail", 37, 1, False, True, None),
]


@pytest.mark.parametrize("label,sk,hkv,rotate_k,masked,scale", CASES)
def test_forward_matches_jax(label, sk, hkv, rotate_k, masked, scale):
    q, k, v, mask, _, angles = _inputs(sk + hkv, sk=sk, hkv=hkv, masked=masked)
    ref = jfa.flash_attention_rope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   jnp.asarray(angles), kv_mask=jnp.asarray(mask), scale=scale,
                                   rotate_k=rotate_k)
    got = tfa.flash_attention_rope(*(torch.from_numpy(a) for a in (q, k, v, angles)),
                                   kv_mask=torch.from_numpy(mask), scale=scale, rotate_k=rotate_k)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("fused", ["1", "0"])
@pytest.mark.parametrize("label,sk,hkv,rotate_k,masked,scale", CASES)
def test_gradients_match_jax(monkeypatch, fused, label, sk, hkv, rotate_k, masked, scale):
    q, k, v, mask, g, angles = _inputs(2 * sk + hkv, sk=sk, hkv=hkv, masked=masked)
    monkeypatch.setenv("LUMINA_FLASH_FUSED_BWD", fused)

    def loss(q_, k_, v_):
        out = jfa.flash_attention_rope(q_, k_, v_, jnp.asarray(angles), kv_mask=jnp.asarray(mask),
                                       scale=scale, rotate_k=rotate_k)
        return jnp.sum(out * jnp.asarray(g))

    ref = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    lse_calls = []
    fn = tfa.flash_online_lse_plain
    monkeypatch.setattr(tfa, "flash_online_lse_plain",
                        lambda *a, **kw: lse_calls.append(1) or fn(*a, **kw))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tfa.flash_attention_rope(*leaves, torch.from_numpy(angles), torch.from_numpy(mask),
                                   scale, rotate_k=rotate_k)
    (out * torch.from_numpy(g)).sum().backward()
    for t, r in zip(leaves, ref):
        assert t.grad.shape == t.shape
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), atol=ATOL, rtol=RTOL)
    assert len(lse_calls) == 1  # the backward's LSE forward (K4), once


def test_backward_takes_the_online_lse_forward_with_a_train_bound(monkeypatch):
    """As in JAX (`_rope_bwd`), the backward's forward is the online LSE one
    even when a train bound is installed."""
    q, k, v, mask, g, angles = _inputs(3)
    tfa.set_flash_static_max_train(5.0)
    seen = []
    for name in ("flash_online_lse_plain", "flash_static_max_lse_plain"):
        fn = getattr(tfa, name)
        monkeypatch.setattr(tfa, name, lambda *a, _fn=fn, _n=name, **kw: seen.append(_n) or _fn(*a, **kw))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tfa.flash_attention_rope(*leaves, torch.from_numpy(angles), torch.from_numpy(mask)).backward(
        torch.from_numpy(g))
    assert seen == ["flash_online_lse_plain"]


@pytest.mark.parametrize("rotate_k", [True, False])
def test_plain_version_is_rope_then_exact_softmax(rotate_k):
    """The plain versions are `apply_rope` then `flash_online_plain`, bit for
    bit (bf16 too: the rotation rounds to the operand dtype)."""
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, mask, _, angles = _inputs(5, sk=40 if rotate_k else 23)
        tq, tk, tv = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
        ta, tm = torch.from_numpy(angles), torch.from_numpy(mask)
        fn = tfa.flash_rope_plain if rotate_k else tfa.flash_rope_q_plain
        got = fn(tq, tk, tv, ta, tm, 0.25)
        ref = tfa.flash_online_plain(apply_rope(tq, ta), apply_rope(tk, ta) if rotate_k else tk,
                                     tv, tm, 0.25)
        assert got.dtype == dtype
        assert torch.equal(got, ref)
        entry = tfa.flash_rope if rotate_k else tfa.flash_rope_q
        assert torch.equal(entry(tq, tk, tv, ta, tm, 0.25), ref)


def test_rotate_k_needs_equal_lengths():
    q, k, v, mask, _, angles = _inputs(6, sk=37)
    with pytest.raises(ValueError, match="Sk 37 != Sq 40"):
        tfa.flash_attention_rope(*(torch.from_numpy(a) for a in (q, k, v, angles)))


def test_cpu_calls_launch_no_kernel():
    tfa.reset_launch_counts()
    q, k, v, mask, g, angles = _inputs(7)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tfa.flash_attention_rope(*leaves, torch.from_numpy(angles)).sum().backward()
    assert all(n == 0 for n in tfa.LAUNCHES.values())
    assert tfa.PLAIN_CUDA_CALLS["count"] == 0


def test_rotation_tables_are_built_once_per_angles_tensor():
    """The kernels' (Sq, D) tables equal `rot_tables`; the same, unmodified
    angles tensor reuses them (a forward hands it to every layer), a
    modified or another one rebuilds them."""
    angles = torch.from_numpy(_angles(40, 16))
    cos_full, sin_signed = tfa._rotation_tables(angles, 16)
    ref = rot_tables(angles, 16)
    assert cos_full.shape == (40, 16) and cos_full.is_contiguous() and sin_signed.is_contiguous()
    assert torch.equal(cos_full, ref[0]) and torch.equal(sin_signed, ref[1])
    again = tfa._rotation_tables(angles, 16)
    assert again[0] is cos_full and again[1] is sin_signed
    angles.mul_(0.5)
    halved = tfa._rotation_tables(angles, 16)
    assert halved[0] is not cos_full and torch.equal(halved[0], rot_tables(angles, 16)[0])
    assert tfa._rotation_tables(angles.clone(), 16)[0] is not halved[0]


# -- the model branch ------------------------------------------------------------------


def _model_inputs(seed, h, w):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 4, h, w)).astype(np.float32)
    t = rng.uniform(0, 1, 2).astype(np.float32)
    cap = rng.standard_normal((2, 9, 32)).astype(np.float32)
    mask = np.ones((2, 9), np.int32)
    mask[0, 6:] = 0
    return x, t, cap, mask


@pytest.mark.parametrize("hw,n_kv_heads", [((8, 8), None), ((16, 272), None), ((8, 8), 2)])
def test_fused_rope_nextdit_matches_jax(monkeypatch, hw, n_kv_heads):
    """Tiny NextDiT under LUMINA_FUSE_ROPE=1 in both packages (JAX with the
    flash impl, whose Pallas rope kernels run in interpret mode): 16 and
    1088 image tokens."""
    from test_torch_next_dit import _pair

    jmodel, params, tmodel = _pair(jax_impl="flash", n_kv_heads=n_kv_heads)
    x, t, cap, mask = _model_inputs(11, *hw)
    monkeypatch.setenv("LUMINA_FUSE_ROPE", "1")
    ref = jax.jit(jmodel.apply)({"params": params}, *map(jnp.asarray, (x, t, cap, mask)))
    calls = {name: [] for name in ("flash_rope_plain", "flash_rope_q_plain")}
    for name, record in calls.items():
        fn = getattr(tfa, name)
        monkeypatch.setattr(tfa, name, lambda *a, _fn=fn, _r=record, **kw: _r.append(1) or _fn(*a, **kw))
    with torch.no_grad():
        got = tmodel(*map(torch.from_numpy, (x, t, cap, mask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    assert len(calls["flash_rope_plain"]) == len(calls["flash_rope_q_plain"]) == tmodel.n_layers
    monkeypatch.delenv("LUMINA_FUSE_ROPE")
    with torch.no_grad():
        unfused = tmodel(*map(torch.from_numpy, (x, t, cap, mask)))
    np.testing.assert_allclose(got.numpy(), unfused.numpy(), atol=ATOL, rtol=RTOL)


def test_fused_rope_plain_impl_takes_the_branch(monkeypatch):
    """impl "plain" takes the fused branch over the plain versions; "xla"
    keeps the unfused sdpa path."""
    from test_torch_next_dit import _pair

    _, _, tmodel = _pair()
    x, t, cap, mask = (torch.from_numpy(a) for a in _model_inputs(12, 8, 8))
    monkeypatch.setenv("LUMINA_FUSE_ROPE", "1")
    calls = []
    fn = tfa._rope_call
    monkeypatch.setattr(tfa, "_rope_call", lambda *a, **kw: calls.append(a[-1]) or fn(*a, **kw))
    try:
        with torch.no_grad():
            for impl in ("plain", "xla", "flash"):
                tmodel.set_attn_impl(impl)
                tmodel(x, t, cap, mask)
    finally:
        tmodel.set_attn_impl("auto")
    n = 2 * tmodel.n_layers
    assert calls == [True] * n + [False] * n  # plain first, then flash; xla makes no call


def test_fused_rope_calibration_declines_in_both_packages(monkeypatch):
    """The fused branch records no LSE (JAX sows only in the unfused one), so
    both calibrations return None at a streaming size and no bound is
    installed."""
    from lumina_t2x_tpu.pipelines import sample_lib as j_sl
    from lumina_t2x_tpu_torch.pipelines import sample_lib as t_sl
    from test_torch_next_dit import _pair

    jmodel, params, tmodel = _pair(jax_impl="flash")
    _, _, cap, mask = _model_inputs(13, 8, 8)
    kw = dict(width=2176, height=128, cfg_scale=4.0, time_shifting_factor=4.0, num_probe_steps=1)
    monkeypatch.setenv("LUMINA_FUSE_ROPE", "1")
    assert j_sl.autocalibrate_flash_static_max(
        jmodel, {"params": params}, jnp.asarray(cap), jnp.asarray(mask), **kw) is None
    assert t_sl.autocalibrate_flash_static_max(
        tmodel, torch.from_numpy(cap), torch.from_numpy(mask), **kw) is None
    assert tfa.get_flash_static_max() is None and jfa.get_flash_static_max() is None


@pytest.mark.parametrize("remat", [False, True])
def test_fused_rope_gradient_through_the_model(monkeypatch, remat):
    """Under autograd the branch runs `_FlashAttentionRope` (with remat, the
    recompute runs its forward again); the parameter gradients equal the
    unfused model's."""
    from lumina_t2x_tpu_torch.models import next_dit as t_nd
    from test_torch_next_dit import TINY, _pair

    tmodel = t_nd.NextDiT(qk_norm=True, remat=remat, **TINY)
    tmodel.load_state_dict(_pair()[2].state_dict(), strict=True)
    x, t, cap, mask = (torch.from_numpy(a) for a in _model_inputs(14, 8, 8))
    grads = {}
    forwards = []
    fn = tfa.flash_rope_plain
    monkeypatch.setattr(tfa, "flash_rope_plain", lambda *a, **kw: forwards.append(1) or fn(*a, **kw))
    for fuse in ("1", "0"):
        monkeypatch.setenv("LUMINA_FUSE_ROPE", fuse)
        tmodel.zero_grad()
        tmodel(x, t, cap, mask, train=True).square().mean().backward()
        grads[fuse] = {n: p.grad.clone() for n, p in tmodel.named_parameters() if p.grad is not None}
    assert len(forwards) == (2 if remat else 1) * tmodel.n_layers
    assert grads["1"].keys() == grads["0"].keys()
    for name in grads["0"]:
        np.testing.assert_allclose(grads["1"][name].numpy(), grads["0"][name].numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=name)


# -- the per-thread inference bound ------------------------------------------------------


def test_static_max_scope_is_per_thread_and_restores():
    tfa.set_flash_static_max(7.0)
    seen = {}

    def other():
        seen["other"] = tfa.get_flash_static_max()

    with tfa.flash_static_max_scope(3.0):
        assert tfa.get_flash_static_max() == 3.0
        thread = threading.Thread(target=other)
        thread.start()
        thread.join(timeout=30)
        assert not thread.is_alive()
        with tfa.flash_static_max_scope(None):
            assert tfa.get_flash_static_max() is None
        assert tfa.get_flash_static_max() == 3.0
        assert tfa.get_flash_static_max(train=True) is None
    assert seen["other"] == 7.0
    assert tfa.get_flash_static_max() == 7.0


def test_env_pin_wins_over_the_scope(monkeypatch):
    monkeypatch.setenv("LUMINA_FLASH_STATIC_MAX", "11.5")
    with tfa.flash_static_max_scope(3.0):
        assert tfa.get_flash_static_max() == 11.5


# -- on the card ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("entry,sk,hkv", [("rope", 300, 2), ("rope_q", 37, 1), ("rope_q", 300, 4)])
def test_rope_kernels_match_plain_and_k2_on_card(cuda_device, dtype, entry, sk, hkv):
    g = torch.Generator().manual_seed(0)
    mk = lambda *s: torch.randn(*s, generator=g).to("cuda", dtype)
    sq = sk if entry == "rope" else 200
    q, k, v = mk(2, sq, 4, 72), mk(2, sk, hkv, 72), mk(2, sk, hkv, 72)
    mask = torch.ones(2, sk, dtype=torch.int32)
    mask[0, sk - 9:] = 0
    mask[1] = 0  # a fully masked batch row
    mask = mask.cuda()
    angles = torch.from_numpy(_angles(sq, 72)).cuda()
    before = tfa.LAUNCHES[entry]
    got = getattr(tfa, f"flash_{entry}")(q, k, v, angles, mask, 0.2)
    q_rot = apply_rope(q, angles)
    k_rot = apply_rope(k, angles) if entry == "rope" else k
    ref = tfa.flash_online_plain(q_rot.float(), k_rot.float(), v.float(), mask, 0.2)
    k2 = tfa.flash_online(q_rot, k_rot, v, mask, 0.2)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES[entry] == before + 1
    assert torch.equal(got, k2)  # the in-kernel rotation is apply_rope's, bit for bit
    rel = 8e-3 if dtype == torch.bfloat16 else 1e-5
    assert (got.float() - ref).abs().max().item() <= rel * max(1.0, ref.abs().max().item())
    assert not got[1].any()

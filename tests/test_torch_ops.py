"""The PyTorch port's ops (`lumina_t2x_tpu_torch/ops`) against the JAX
package's: norms, RoPE, the attention scale functions and the plain sdpa.

Inputs come from numpy (`default_rng`), both sides run fp32 on the CPU.
Bar: atol 2e-4 / rtol 2e-3 (the repo's torch-parity bar), tighter where the
op is elementwise.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumina_t2x_tpu.ops import norms as j_norms
from lumina_t2x_tpu.ops import rope as j_rope
from lumina_t2x_tpu_torch.ops import norms as t_norms
from lumina_t2x_tpu_torch.ops import rope as t_rope

# both `ops/__init__` re-export the `attention` function under the submodule's
# name: reach the modules themselves
j_attn = importlib.import_module("lumina_t2x_tpu.ops.attention")
t_attn = importlib.import_module("lumina_t2x_tpu_torch.ops.attention")

ATOL, RTOL = 2e-4, 2e-3


def _close(t_out, j_out, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out), atol=atol, rtol=rtol)


@pytest.mark.parametrize("with_weight", [True, False])
def test_rms_norm(with_weight):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 48)).astype(np.float32) * 3
    w = rng.standard_normal(48).astype(np.float32) if with_weight else None
    got = t_norms.rms_norm(torch.from_numpy(x), None if w is None else torch.from_numpy(w), 1e-5)
    _close(got, j_norms.rms_norm(jnp.asarray(x), None if w is None else jnp.asarray(w), 1e-5),
           atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("affine", [True, False])
def test_layer_norm(affine):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 40)).astype(np.float32) + 2
    w = rng.standard_normal(40).astype(np.float32) if affine else None
    b = rng.standard_normal(40).astype(np.float32) if affine else None
    tt = (lambda a: None if a is None else torch.from_numpy(a))
    jj = (lambda a: None if a is None else jnp.asarray(a))
    _close(t_norms.layer_norm(torch.from_numpy(x), tt(w), tt(b), 1e-6),
           j_norms.layer_norm(jnp.asarray(x), jj(w), jj(b), 1e-6), atol=1e-5, rtol=1e-5)


def test_norm_keeps_dtype():
    x = torch.randn(2, 3, 16, dtype=torch.bfloat16)
    assert t_norms.rms_norm(x).dtype == torch.bfloat16
    assert t_norms.layer_norm(x).dtype == torch.bfloat16


@pytest.mark.parametrize("linear,ntk", [(1.0, 1.0), (2.0, 1.0), (1.0, 3.0)])
def test_rope_angles_1d(linear, ntk):
    pos = np.arange(11, dtype=np.float32)
    _close(t_rope.rope_angles_1d(24, pos, 10000.0, linear, ntk),
           j_rope.rope_angles_1d(24, pos, 10000.0, linear, ntk), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("linear,ntk", [(1.0, 1.0), (1.5, 2.0)])
def test_rope_angles_2d(linear, ntk):
    _close(t_rope.rope_angles_2d(16, 5, 7, 10000.0, linear, ntk),
           j_rope.rope_angles_2d(16, 5, 7, 10000.0, linear, ntk), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("timestep", [0.1, 0.3, 0.9])
@pytest.mark.parametrize("scale_factor", [1.0, 2.0])
def test_rope_angles_2d_timeaware(timestep, scale_factor):
    kw = dict(scale_factor=scale_factor, scale_watershed=0.3, timestep=timestep)
    _close(t_rope.rope_angles_2d_timeaware(16, 6, 4, **kw),
           j_rope.rope_angles_2d_timeaware(16, 6, 4, **kw), atol=1e-4, rtol=1e-5)


def test_rot_tables():
    ang = np.random.default_rng(2).standard_normal((9, 8)).astype(np.float32)
    t_cos, t_sin = t_rope.rot_tables(torch.from_numpy(ang), 16)
    j_cos, j_sin = j_rope.rot_tables(jnp.asarray(ang), 16)
    _close(t_cos, j_cos, atol=1e-6, rtol=1e-6)
    _close(t_sin, j_sin, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("per_item", [False, True])
def test_apply_rope(per_item):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 12, 3, 16)).astype(np.float32)
    shape = (2, 12, 8) if per_item else (12, 8)
    ang = rng.uniform(-4, 4, shape).astype(np.float32)
    _close(t_rope.apply_rope(torch.from_numpy(x), torch.from_numpy(ang)),
           j_rope.apply_rope(jnp.asarray(x), jnp.asarray(ang)), atol=1e-5, rtol=1e-5)


def test_scale_functions():
    for fn in ("proportional_attn_scale", "anagram_attn_scale"):
        assert getattr(t_attn, fn)(4096, 1024, 72) == pytest.approx(
            getattr(j_attn, fn)(4096, 1024, 72), rel=1e-12)
    assert t_attn.default_attn_scale(72) == pytest.approx(j_attn.default_attn_scale(72))


@pytest.mark.parametrize("hq,hkv,masked,scale", [
    (4, 4, False, None), (4, 2, True, None), (4, 1, True, 0.3)])
def test_sdpa(hq, hkv, masked, scale):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 9, hq, 16)).astype(np.float32)
    k = rng.standard_normal((2, 13, hkv, 16)).astype(np.float32)
    v = rng.standard_normal((2, 13, hkv, 16)).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((2, 13), np.int32)
        mask[0, 10:] = 0
        mask[1, :4] = 0
    got = t_attn.sdpa(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                      None if mask is None else torch.from_numpy(mask), scale)
    ref = j_attn.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      None if mask is None else jnp.asarray(mask), scale)
    _close(got, ref)


def test_attention_dispatch():
    assert t_attn.resolve_impl("auto") == "flash"
    assert t_attn.resolve_impl("xla") == "xla"
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 6, 2, 8)).astype(np.float32))
               for _ in range(3))
    torch.testing.assert_close(t_attn.attention(q, k, v, impl="xla"), t_attn.sdpa(q, k, v))
    # the flash path on CPU tensors is its plain version: same function
    torch.testing.assert_close(t_attn.attention(q, k, v, impl="auto"), t_attn.sdpa(q, k, v),
                               atol=1e-6, rtol=1e-5)
    with pytest.raises(ValueError):
        t_attn.attention(q, k, v, impl="nosuch")

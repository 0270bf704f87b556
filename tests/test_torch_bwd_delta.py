"""The attention backward's delta = rowsum(dO * O) (`bwd_delta`: the kernel of
`lumina_t2x_tpu_torch/csrc/bwd_delta.cu`, and its plain version
`bwd_delta_plain`), which every backward entry point reads.

On the CPU: `bwd_delta_plain` against the JAX package's delta (the fp32 einsum
of `_bwd_prepare`, taken unpadded) on bf16, fp16 and fp32 inputs made with
numpy from a seed, out from the port's plain LSE forward with a fully masked
batch row (out 0 there, so delta 0); the wrapper's route (the plain version
for CPU tensors; for CUDA tensors the C entry with the tensors' strides and
dtype code, one launch counted) through a stand-in library. Bar: both sum
fp32 products in another order, so each row within 2^-20 of sum |dO * O| over
the row.

The `cuda`-marked tests hold the kernel against its plain version on the
card (`python -m pytest --noconftest -m cuda tests/test_torch_bwd_delta.py`)
and skip without one.
"""

import importlib

import numpy as np
import pytest
import torch

from lumina_t2x_tpu_torch.ops import cuda_lib
from lumina_t2x_tpu_torch.ops import flash_attention as tfa


class _Lazy:
    """JAX is imported at first use, so that the `cuda` tests below also
    collect and run on a machine without JAX (`pytest --noconftest -m cuda`)."""

    def __init__(self, module):
        self._module = module

    def __getattr__(self, name):
        return getattr(importlib.import_module(self._module), name)


jfa = _Lazy("lumina_t2x_tpu.ops.flash_attention")
jnp = _Lazy("jax.numpy")

DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16, "fp32": torch.float32}
REL = 2.0 ** -20  # of each row's sum |dO * O|: fp32 sums in another order


def _inputs(seed, b, s, h, d, dtype):
    """`dtype`-representable fp32 numpy q, k, v, dout and a mask whose last
    batch row has no valid key."""
    rng = np.random.default_rng(seed)
    rnd = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(  # noqa: E731
        dtype).float().numpy()
    q, k, v, dout = (rnd(b, s, h, d) for _ in range(4))
    mask = np.ones((b, s), np.int32)
    mask[0, s - 5:] = 0
    mask[-1] = 0
    return q, k, v, dout, mask


def _assert_rows_close(got, ref, dout, out):
    """Each (b, h, s) within REL of its row's sum |dO * O|."""
    scale = (dout.float() * out.float()).abs().sum(-1).transpose(1, 2)
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert ((got - ref).abs() <= REL * scale).all()


@pytest.mark.parametrize("tag", sorted(DTYPES))
@pytest.mark.parametrize("d", [48, 72, 96])
def test_plain_matches_jax_delta(tag, d):
    """`bwd_delta_plain` against `_bwd_prepare`'s delta (unpadded, one lane
    of its lane-replicated layout) on the same inputs in `tag`; the fully
    masked batch row (out 0) gets delta 0 on both."""
    dtype = DTYPES[tag]
    b, s, h = 2, 37, 4
    q, k, v, dout, mask = _inputs(d + len(tag), b, s, h, d, dtype)
    tq, tk, tv, tdo, tm = map(torch.from_numpy, (q, k, v, dout, mask))
    out = tfa.flash_online_lse_plain(tq, tk, tv, tm, d ** -0.5)[0].to(dtype)
    tdo = tdo.to(dtype)
    got = tfa.bwd_delta_plain(out, tdo)
    jdt = {"bf16": jnp.bfloat16, "fp16": jnp.float16, "fp32": jnp.float32}[tag]
    ja = lambda t: jnp.asarray(t.float().numpy()).astype(jdt)  # noqa: E731
    prep = jfa._bwd_prepare(ja(tq), ja(tk), ja(tv), jnp.asarray(mask), ja(out), ja(tdo), 128, 128)
    ref = torch.from_numpy(np.array(prep[5][:, :, :s, 0], np.float32))
    _assert_rows_close(got, ref, tdo, out)
    assert not got[-1].any() and not ref[-1].any()


def test_cpu_tensors_take_the_plain_version():
    """On the CPU `bwd_delta` is `bwd_delta_plain` bit for bit, with no
    launch counted."""
    tfa.reset_launch_counts()
    g = torch.Generator().manual_seed(3)
    out, dout = (torch.randn(2, 9, 3, 16, generator=g).to(torch.bfloat16) for _ in range(2))
    assert torch.equal(tfa.bwd_delta(out, dout), tfa.bwd_delta_plain(out, dout))
    assert tfa.LAUNCHES["bwd_delta"] == 0


class _OnCuda(torch.Tensor):
    is_cuda = True


class _RecordingLibrary:
    """Stands in for the built `flash` library: each C entry point records
    its arguments and returns 0 (success) without launching anything."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("lumina_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.mark.parametrize("tag", sorted(DTYPES))
def test_cuda_tensors_reach_the_kernel(monkeypatch, tag):
    """For CUDA tensors `bwd_delta` calls `lumina_bwd_delta` once with both
    tensors in place (a strided dO view is not copied), meta (B, S, H, D, out
    strides, dO strides), the dtype code and a (B, H, S) fp32 output, and
    counts one launch of `tag`; mismatched shapes or dtypes raise before
    anything is built."""
    dtype = DTYPES[tag]
    lib = _RecordingLibrary()
    monkeypatch.setattr(cuda_lib, "build_library", lambda name: lib)
    monkeypatch.setattr(tfa, "_on_device", lambda t: tfa._SAME_DEVICE)
    monkeypatch.setattr(tfa, "_stream", lambda t: 0)
    tfa.reset_launch_counts()
    out = torch.ones(2, 5, 3, 16, dtype=dtype).as_subclass(_OnCuda)
    dout = torch.ones(2, 5, 3, 24, dtype=dtype)[..., :16].as_subclass(_OnCuda)
    delta = tfa.bwd_delta(out, dout)
    ((name, args),) = lib.calls
    assert name == "lumina_bwd_delta"
    assert args[0] == out.data_ptr() and args[1] == dout.data_ptr()
    assert args[2] == delta.data_ptr() and delta.shape == (2, 3, 5)
    assert delta.dtype == torch.float32
    assert list(args[3][:10]) == [2, 5, 3, 16, 240, 48, 16, 360, 72, 24]
    assert args[4] == {"fp32": 0, "bf16": 1, "fp16": 2}[tag]
    assert {n: c for n, c in tfa.DTYPE_LAUNCHES.items() if c} == {f"bwd_delta_{tag}": 1}
    with pytest.raises(ValueError, match="one dtype"):
        tfa.bwd_delta(out, out.to(torch.float64).as_subclass(_OnCuda))
    with pytest.raises(ValueError, match="one dtype"):
        tfa.bwd_delta(out, out[:, :4])
    assert len(lib.calls) == 1


# -- on the card: the kernel against its plain version ------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


# (B, S, H, D): the ImageNet 600M's, the Small's, the Flag-DiT 5B's and the 2B's
# training self-attention, and a ragged one with head_dim 40
SHAPES = {"600m": (256, 256, 32, 48), "small": (64, 1024, 8, 48), "5b": (2, 4160, 32, 96),
          "2b": (2, 4096, 32, 72), "ragged": (3, 77, 5, 40)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("tag", sorted(DTYPES))
def test_kernel_matches_plain_on_card(cuda_device, tag, shape):
    """One launch, each row within REL of its sum |dO * O| of the plain
    version, at the training shapes and a ragged one; in vectors (contiguous
    inputs) and element by element (dO a view with a 3-element pad)."""
    dtype = DTYPES[tag]
    b, s, h, d = SHAPES[shape]
    g = torch.Generator(device="cuda").manual_seed(d)
    out = torch.randn(b, s, h, d, generator=g, device="cuda").to(dtype)
    wide = torch.randn(b, s, h, d + 3, generator=g, device="cuda").to(dtype)
    for dout in (wide[..., :d].contiguous(), wide[..., :d]):
        before = tfa.LAUNCHES["bwd_delta"]
        got = tfa.bwd_delta(out, dout)
        ref = tfa.bwd_delta_plain(out, dout)
        torch.cuda.synchronize()
        assert tfa.LAUNCHES["bwd_delta"] == before + 1
        _assert_rows_close(got, ref, dout, out)

"""The port's static-max variants (`lumina_t2x_tpu_torch/exps/
vpu_op_reduction.py`, K10 and K11) against the JAX experiment's Pallas
kernels, run in interpret mode on the CPU:

  static_max_v0..v3 <- _kernel_v0.._kernel_v3 (exps/vpu_op_reduction.py)
  static_max_v4     <- _kernel_v4

The JAX script's launchers (`_loop`, `_loop_v4`) hard-code 1024 x 2048
blocks, pass no `interpret=` and return a scalar sum, so the tests wrap the
module's own kernel bodies in `pl.pallas_call(..., interpret=True)` with the
launchers' specs (the ones column of v included) and small blocks. Inputs
come from numpy with a seed, rounded to bf16, the same values on both
sides. Bar: bf16 outputs within max abs 8e-3 and mean abs 5e-4 (one bf16
rounding of the output; fp32 sums in another order). On CPU tensors each
wrapper runs its plain version; the `cuda`-marked tests compare each kernel
(the instantiations of `csrc/static_max_sm90.cu`) with its plain version,
and v4 with v1 bit for bit, on the card and skip without one.
"""

import functools
import importlib
import importlib.util
import math
import os
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from lumina_t2x_tpu_torch.exps import vpu_op_reduction as vpu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_ABS, MEAN_ABS = 8e-3, 5e-4


class _Lazy:
    """JAX is imported at first use, so that the `cuda` tests below also
    collect and run on a machine without JAX (`pytest --noconftest -m cuda`)."""

    def __init__(self, module):
        self._module = module

    def __getattr__(self, name):
        return getattr(importlib.import_module(self._module), name)


jax = _Lazy("jax")
jnp = _Lazy("jax.numpy")
pl = _Lazy("jax.experimental.pallas")
pltpu = _Lazy("jax.experimental.pallas.tpu")


def load_jax_experiment(name):
    """The JAX package's `exps/<name>.py` as a module. `exps/` is no package;
    loading it runs `enable_compile_cache()`, which would switch the
    process's JAX compilation cache to the repository's `.jax_cache`, so it
    is a no-op while the module loads."""
    import lumina_t2x_tpu.core.logging as jlog

    spec = importlib.util.spec_from_file_location(f"jax_exps_{name}",
                                                  os.path.join(ROOT, "exps", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    with mock.patch.object(jlog, "enable_compile_cache", lambda *a, **k: None):
        spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jvpu():
    return load_jax_experiment("vpu_op_reduction")


def _jax_static_max(jvpu, variant, q, k, v, mask, block_q, block_k):
    """The JAX kernel body of `variant` through `pallas_call` in interpret
    mode, with `_loop`'s (or `_loop_v4`'s) specs at the given blocks; (B, S,
    H, D) in and out."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    nk = sk // block_k
    kw = dict(scale=1.0 / (d ** 0.5), d=d, bound=vpu.BOUND)
    qt, kt = q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3)
    vt = jnp.concatenate([v.transpose(0, 2, 1, 3), jnp.ones((b, h, sk, 1), v.dtype)], axis=-1)
    vmem = pltpu.VMEM
    q_spec = pl.BlockSpec((1, 1, block_q, d), lambda bi, hi, qi, ki: (bi, hi, qi, 0),
                          memory_space=vmem)
    if variant == "v4":
        kern = functools.partial(jvpu._kernel_v4, **kw)
        grid = (b, h, sq // block_q, nk + 1)
        in_specs = [
            pl.BlockSpec((1, 1, block_k), lambda bi, hi, qi, ki: (bi, 0, jnp.maximum(ki - 1, 0)),
                         memory_space=vmem),
            q_spec,
            pl.BlockSpec((1, 1, block_k, d),
                         lambda bi, hi, qi, ki: (bi, hi, jnp.minimum(ki, nk - 1), 0),
                         memory_space=vmem),
            pl.BlockSpec((1, 1, block_k, d + 1),
                         lambda bi, hi, qi, ki: (bi, hi, jnp.maximum(ki - 1, 0), 0),
                         memory_space=vmem),
        ]
        scratch = [vmem((block_q, block_k), jnp.float32), vmem((block_q, block_k), jnp.float32),
                   vmem((block_q, d + 1), jnp.float32)]
    else:
        kern = functools.partial(jvpu.KERNELS[variant], **kw)
        grid = (b, h, sq // block_q, nk)
        in_specs = [
            pl.BlockSpec((1, 1, block_k), lambda bi, hi, qi, ki: (bi, 0, ki), memory_space=vmem),
            q_spec,
            pl.BlockSpec((1, 1, block_k, d), lambda bi, hi, qi, ki: (bi, hi, ki, 0),
                         memory_space=vmem),
            pl.BlockSpec((1, 1, block_k, d + 1), lambda bi, hi, qi, ki: (bi, hi, ki, 0),
                         memory_space=vmem),
        ]
        scratch = [vmem((block_q, d + 1), jnp.float32)]
    out = pl.pallas_call(
        kern, grid=grid, in_specs=in_specs,
        out_specs=pl.BlockSpec((1, 1, block_q, d), lambda bi, hi, qi, ki: (bi, hi, qi, 0),
                               memory_space=vmem),
        out_shape=jax.ShapeDtypeStruct((b, h, sq, d), q.dtype),
        scratch_shapes=scratch, interpret=True,
    )(mask[:, None, :], qt, kt, vt)
    return out.transpose(0, 2, 1, 3)


def _inputs(seed, b=1, s=256, h=2, d=8, masked_tail=37):
    """bf16-representable fp32 q, k, v (B, S, H, D) and an int32 mask with the
    last `masked_tail` keys of every row masked."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(np.float32))
               .to(torch.bfloat16).float().numpy() for _ in range(3))
    mask = np.ones((b, s), np.int32)
    if masked_tail:
        mask[:, s - masked_tail:] = 0
    return q, k, v, mask


def _torch(q, k, v, mask):
    return [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)] + [torch.from_numpy(mask)]


def _jax(q, k, v, mask):
    return [jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)] + [jnp.asarray(mask)]


def _assert_close(got, ref):
    err = np.abs(got.float().numpy() - np.asarray(ref.astype(jnp.float32)))
    assert err.max() <= MAX_ABS and err.mean() <= MEAN_ABS, (err.max(), err.mean())


@pytest.mark.parametrize("variant", vpu.VARIANTS)
@pytest.mark.parametrize("d,s,blocks", [(8, 256, (64, 128)), (72, 128, (64, 64))])
def test_variant_matches_pallas(jvpu, variant, d, s, blocks):
    """Each variant against its JAX kernel with a masked tail of 37 keys (v3
    ignores the mask on both sides)."""
    q, k, v, mask = _inputs(d, s=s, d=d)
    ref = _jax_static_max(jvpu, variant, *_jax(q, k, v, mask), *blocks)
    tq, tk, tv, tm = _torch(q, k, v, mask)
    got = vpu.ENTRIES[variant](tq, tk, tv, tm, 1.0 / math.sqrt(d), vpu.BOUND)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    _assert_close(got, ref)


def test_unmasked_variants_agree_with_v3(jvpu):
    """With every key valid, v2 and v3 compute one function: both sides."""
    q, k, v, mask = _inputs(1, masked_tail=0)
    ref = _jax_static_max(jvpu, "v3", *_jax(q, k, v, mask), 64, 128)
    tq, tk, tv, tm = _torch(q, k, v, mask)
    for variant in ("v2", "v3"):
        _assert_close(vpu.ENTRIES[variant](tq, tk, tv, tm, 8 ** -0.5, vpu.BOUND), ref)


def test_v4_equals_v1():
    tq, tk, tv, tm = _torch(*_inputs(2, d=72, s=96))
    assert torch.equal(vpu.static_max_v4(tq, tk, tv, tm, 72 ** -0.5, vpu.BOUND),
                       vpu.static_max_v1(tq, tk, tv, tm, 72 ** -0.5, vpu.BOUND))


def test_plain_matches_float64_softmax():
    """Far from the clamp, each variant is the masked softmax (v3: unmasked)
    up to the bf16 rounding of P and of the output."""
    q, k, v, mask = _inputs(3, s=128, h=3, d=16)
    tq, tk, tv, tm = _torch(q, k, v, mask)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), k.astype(np.float64)) / 4.0
    for variant in vpu.VARIANTS:
        logits = s if variant == "v3" else np.where(mask[:, None, None, :] != 0, s, -np.inf)
        p = np.exp(logits - logits.max(-1, keepdims=True))
        ref = np.einsum("bhqk,bkhd->bqhd", p / p.sum(-1, keepdims=True), v.astype(np.float64))
        got = vpu.ENTRIES[variant](tq, tk, tv, tm, 0.25, vpu.BOUND).double().numpy()
        assert np.abs(got - ref).max() < 1.5e-2, variant


def test_clamp_bound_and_scale_are_runtime_arguments():
    """Clamp, bound and scale are arguments: a clamp of 1 above a bound of 0
    fires on the logits above 1 (about a sixth of them here), and each of the
    three changes the result."""
    tq, tk, tv, tm = _torch(*_inputs(4, s=64, d=16))
    a = vpu.static_max_v1(tq, tk, tv, tm, 0.25, 0.0, clamp=1.0)
    assert torch.isfinite(a.float()).all()
    assert not torch.equal(a, vpu.static_max_v1(tq, tk, tv, tm, 0.25, 0.0))
    assert not torch.equal(a, vpu.static_max_v1(tq, tk, tv, tm, 0.5, 0.0, clamp=1.0))
    assert not torch.equal(a, vpu.static_max_v1(tq, tk, tv, tm, 0.25, 0.5, clamp=1.0))


def test_cpu_calls_launch_no_kernel():
    vpu.reset_launch_counts()
    tq, tk, tv, tm = _torch(*_inputs(5, s=64))
    for variant in vpu.VARIANTS:
        vpu.ENTRIES[variant](tq, tk, tv, tm, 0.3, vpu.BOUND)
    assert set(vpu.LAUNCHES) == {f"static_max_{variant}" for variant in vpu.VARIANTS}
    assert all(count == 0 for count in vpu.LAUNCHES.values())


@pytest.mark.parametrize("variant", ["v0", "v4"])
def test_fp32_inputs_raise(variant):
    tq, tk, tv, tm = _torch(*_inputs(6, s=64))
    with pytest.raises(TypeError):
        vpu.ENTRIES[variant](tq.float(), tk.float(), tv.float(), tm, 0.3, vpu.BOUND)


@pytest.mark.parametrize("variant", ["v1", "v3"])
def test_gqa_heads_raise(variant):
    tq, tk, tv, tm = _torch(*_inputs(7, s=64, h=4))
    with pytest.raises(ValueError):
        vpu.ENTRIES[variant](tq, tk[:, :, :2], tv[:, :, :2], tm, 0.3, vpu.BOUND)


def test_bad_head_dim_and_mask_raise():
    tq, tk, tv, tm = _torch(*_inputs(8, s=64, d=12))
    with pytest.raises(ValueError):
        vpu.static_max_v1(tq, tk, tv, tm, 0.3, vpu.BOUND)
    tq, tk, tv, tm = _torch(*_inputs(8, s=64))
    with pytest.raises(ValueError):
        vpu.static_max_v1(tq, tk, tv, tm[:, :32], 0.3, vpu.BOUND)


def test_measure_and_main_run_on_cpu(capsys, monkeypatch):
    ms = vpu.measure("v2", b=1, s=64, h=2, d=8, device="cpu")
    assert ms > 0
    for name, value in (("B", 1), ("S", 64), ("H", 2), ("D", 8)):  # main's shape, made tiny
        monkeypatch.setattr(vpu, name, value)
    times = vpu.main(["--device", "cpu"])
    assert set(times) == set(vpu.VARIANTS)
    out = capsys.readouterr().out
    assert "vs v0" in out and "TF/s useful" in out and "bit for bit: True" in out
    assert "B1/S64/H2/D8" in out
    assert "cpu" in out
    assert all(count == 0 for count in vpu.LAUNCHES.values())


def test_check_v4_on_cpu():
    """On the CPU every wrapper runs its plain version: v4 equals v1, and
    each variant is 0 from its plain version."""
    res = vpu.check_v4(b=1, s=64, h=2, d=8, device="cpu")
    assert res["v4_equals_v1"] and set(res["errors"]) == set(vpu.VARIANTS)
    assert all(err == (0.0, 0.0) for err in res["errors"].values())


# mangled names as cuobjdump prints them from the card build (anonymous
# namespaces, template arguments: chain, pipelined, QK^T depth, PV width),
# and names the counts must skip
_SM90 = "_ZN51_GLOBAL__N__b0a6ce65_18_static_max_sm90_cu_9355b6aa22static_max_sm90_kernel"
_SM90_ARGS = "EEvNS_6ParamsE14CUtensorMap_stS2_S2_"
_NAMES = {
    _SM90 + "ILi2ELb0ELi80ELi72" + _SM90_ARGS: ("v2", 80),
    _SM90 + "ILi0ELb0ELi64ELi64" + _SM90_ARGS: ("v0", 64),
    _SM90 + "ILi3ELb0ELi128ELi128" + _SM90_ARGS: ("v3", 128),
    _SM90 + "ILi1ELb0ELi80ELi72" + _SM90_ARGS: ("v1", 80),
    _SM90 + "ILi1ELb1ELi80ELi72" + _SM90_ARGS: ("v4", 80),
    "_ZN45_GLOBAL__N__0aa1b2c3_15_mma_probe_cu_55aa66bb16mma_chain_kernelILi256EEEvPK13__nv_bfloat16S3_Pfiiiii":
        None,
    "_ZN40_GLOBAL__N__1a2b3c4d_18_flash_fwd_sm90_cu_9e8f7a6b21flash_fwd_sm90_kernelILb1ELi80ELi72EEEvNS_6ParamsE":
        None,
    "_ZN45_GLOBAL__N__fa29f68e_12_flash_fwd_cu_e8e9a6ed16flash_fwd_kernelILb0ELb0EEEvNS_6ParamsE": None,
    "_ZN47_GLOBAL__N__7d48e218_14_rope_rotate_cu_6f646e8118rope_rotate_kernelI13__nv_bfloat16Li8EEEvNS_6ParamsEi":
        None,
}


@pytest.mark.parametrize("name", sorted(_NAMES))
def test_sass_kernel_names(name):
    assert vpu.sass_kernel(name) == _NAMES[name]


def test_experiment_modules_import_no_jax():
    """Neither experiment module of the port, nor chip_smoke.py, imports JAX
    or the JAX package."""
    code = ("import sys\n"
            "import chip_smoke\n"
            "import lumina_t2x_tpu_torch.exps.vpu_op_reduction\n"
            "import lumina_t2x_tpu_torch.exps.mxu_k_quantum\n"
            "bad = [m for m in sys.modules if m in ('jax', 'jaxlib', 'lumina_t2x_tpu') or "
            "m.startswith(('jax.', 'jaxlib.', 'lumina_t2x_tpu.'))]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# -- on the card: each kernel against its plain version ---------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _cuda_inputs(b, s, h, d, masked_tail, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, s, h, d, generator=g).to("cuda", torch.bfloat16) for _ in range(3))
    mask = torch.ones(b, s, dtype=torch.int32)
    if masked_tail:
        mask[-1, s - masked_tail:] = 0
    return q, k, v, mask.cuda()


# ragged q and key tiles, a masked tail, D 8 / 72 / 128
_CARD_CASES = [(2, 1000, 4, 72, 200), (1, 256, 2, 8, 0), (1, 130, 2, 128, 17)]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", vpu.VARIANTS)
@pytest.mark.parametrize("b,s,h,d,tail", _CARD_CASES)
def test_kernel_matches_plain_on_card(cuda_device, variant, b, s, h, d, tail):
    """Ragged q and key tiles (S=1000, 130), a masked tail, D 8/72/128."""
    q, k, v, mask = _cuda_inputs(b, s, h, d, tail)
    before = vpu.LAUNCHES[f"static_max_{variant}"]
    got = vpu.ENTRIES[variant](q, k, v, mask, d ** -0.5, vpu.BOUND)
    ref = vpu.PLAIN[variant](q, k, v, mask, d ** -0.5, vpu.BOUND)
    torch.cuda.synchronize()
    assert vpu.LAUNCHES[f"static_max_{variant}"] == before + 1
    err = (got.float() - ref.float()).abs()
    assert err.max().item() <= 1e-2 and err.mean().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d,tail", _CARD_CASES)
def test_v4_equals_serial_on_card(cuda_device, b, s, h, d, tail):
    """v4 and v1, its serial anchor (one kernel, issued in two orders), sum
    the same products in the same order: equal bit for bit."""
    q, k, v, mask = _cuda_inputs(b, s, h, d, tail)
    assert torch.equal(vpu.static_max_v4(q, k, v, mask, d ** -0.5, vpu.BOUND),
                       vpu.static_max_v1(q, k, v, mask, d ** -0.5, vpu.BOUND))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", vpu.VARIANTS)
@pytest.mark.parametrize("d", [8, 72, 128])
def test_v4_resources_on_card(cuda_device, variant, d):
    """Every variant's instantiation: no spills, one 384-thread block per
    SM, 24 / 240 registers after setmaxnreg."""
    info = vpu.sm90_attributes(variant, d)
    assert info["local_bytes"] == 0 and info["blocks_per_sm"] == 1 and info["threads"] == 384
    assert (info["producer_registers"], info["consumer_registers"]) == (24, 240)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["v2", "v4"])
def test_strided_inputs_on_card(cuda_device, variant):
    """q, k, v read in place from a (B, S, 3, H, D) buffer, as a fused QKV
    projection lays them out."""
    g = torch.Generator().manual_seed(1)
    qkv = torch.randn(2, 300, 3, 4, 72, generator=g).to("cuda", torch.bfloat16)
    q, k, v = qkv.unbind(2)
    got = vpu.ENTRIES[variant](q, k, v, None, 72 ** -0.5, vpu.BOUND)
    ref = vpu.PLAIN[variant](q, k, v, None, 72 ** -0.5, vpu.BOUND)
    torch.cuda.synchronize()
    assert (got.float() - ref.float()).abs().max().item() <= 1e-2

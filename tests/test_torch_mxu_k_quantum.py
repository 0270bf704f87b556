"""The port's tensor-core probe (`lumina_t2x_tpu_torch/exps/mxu_k_quantum.py`,
K12) against the JAX experiment's Pallas kernel, run in interpret mode on
the CPU:

  mma_chain <- _kernel (exps/mxu_k_quantum.py)

The JAX launcher `_run` returns the output's sum, so the tests wrap the
module's kernel body in `pl.pallas_call(..., interpret=True)` with `_run`'s
specs and read the (M, N) output. Inputs come from numpy with a seed, bf16
on both sides; a is scaled by 1e-3 in one case so that the perturbation
j*1e-6 moves the result. Bar: max abs 1e-5 of max|ref| (fp32 sums in
another order only). The `cuda`-marked tests compare the kernel with its
plain version on the card and skip without one.
"""

import functools

import numpy as np
import pytest
import torch

from lumina_t2x_tpu_torch.exps import mxu_k_quantum as mxu
from test_torch_vpu_op_reduction import _Lazy, load_jax_experiment

REL = 1e-5

jax = _Lazy("jax")
jnp = _Lazy("jax.numpy")
pl = _Lazy("jax.experimental.pallas")
pltpu = _Lazy("jax.experimental.pallas.tpu")


@pytest.fixture(scope="module")
def jmxu():
    return load_jax_experiment("mxu_k_quantum")


def _jax_chain(jmxu, a, w, iters):
    """`_run`'s pallas_call in interpret mode, returning the (M, N) output."""
    vmem = pltpu.VMEM
    return pl.pallas_call(
        functools.partial(jmxu._kernel, iters=iters),
        in_specs=[pl.BlockSpec(memory_space=vmem), pl.BlockSpec(memory_space=vmem)],
        out_specs=pl.BlockSpec(memory_space=vmem),
        out_shape=jax.ShapeDtypeStruct((a.shape[0], w.shape[1]), jnp.float32),
        interpret=True,
    )(a, w)


def _inputs(seed, m, k, n, a_scale=1.0):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy((a_scale * rng.standard_normal((m, k))).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)).to(torch.bfloat16)
    return a, w


def _to_jax(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


@pytest.mark.parametrize("m,k,n,iters,a_scale", [(64, 72, 40, 16, 1e-3), (32, 8, 72, 9, 1.0),
                                                 (48, 80, 16, 5, 1.0), (16, 130, 24, 3, 1e-2)])
def test_chain_matches_pallas(jmxu, m, k, n, iters, a_scale):
    a, w = _inputs(k + n, m, k, n, a_scale)
    ref = np.asarray(_jax_chain(jmxu, _to_jax(a), _to_jax(w), iters))
    got = mxu.mma_chain(a, w, iters)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    top = np.abs(ref).max()
    assert np.abs(got.numpy() - ref).max() <= REL * top


def test_perturbation_changes_the_result(jmxu):
    """At |a| ~ 1e-3 the perturbation j*1e-6 moves the result by ~5e-3 of its
    size: a chain that ignored it would miss the JAX output by far more than
    the bar, which the port meets."""
    a, w = _inputs(0, 64, 72, 40, 1e-3)
    iters = 16
    ref = np.asarray(_jax_chain(jmxu, _to_jax(a), _to_jax(w), iters))
    top = np.abs(ref).max()
    unperturbed = iters * (a.float() @ w.float()).numpy()
    assert np.abs(unperturbed - ref).max() > 100 * REL * top
    assert np.abs(mxu.mma_chain(a, w, iters).numpy() - ref).max() <= REL * top


def test_cpu_calls_launch_no_kernel():
    mxu.reset_launch_counts()
    a, w = _inputs(1, 16, 8, 8)
    mxu.mma_chain(a, w, 2)
    assert mxu.LAUNCHES == {"mma_chain": 0}


def test_bad_inputs_raise():
    a, w = _inputs(2, 16, 8, 8)
    with pytest.raises(TypeError):
        mxu.mma_chain(a.float(), w.float(), 2)
    with pytest.raises(ValueError):
        mxu.mma_chain(a, w[:4], 2)
    big_a, big_w = _inputs(2, 4, 1032, 8)
    with pytest.raises(ValueError):
        mxu.mma_chain(big_a, big_w, 1)


def test_blocks():
    assert mxu.blocks(1024, 8) == 16
    assert mxu.blocks(1024, 72) == 48
    assert mxu.blocks(1024, 1024) == 512
    assert mxu.blocks(100, 33) == 4


def test_sweep_and_main_run_on_cpu(capsys, monkeypatch):
    monkeypatch.setattr(mxu, "M", 16)  # the sweeps' rows and products, made tiny
    monkeypatch.setattr(mxu, "ITERS", 2)
    rows = mxu.sweep("tiny", [(8, 16), (72, 8)], device="cpu")
    assert [(r["K"], r["N"], r["blocks"]) for r in rows] == [(8, 16, 1), (72, 8, 1)]
    assert all(r["us_per_dot"] > 0 and r["tflops"] > 0 for r in rows)
    out = mxu.main(["--device", "cpu"])
    assert [r["K"] for r in out["K"]] == [k for k, _ in mxu.K_SWEEP]
    assert [r["N"] for r in out["N"]] == [n for _, n in mxu.N_SWEEP]
    text = capsys.readouterr().out
    assert "us/dot" in text and "blocks" in text and "cpu" in text
    assert "M=16, 2 chained" in text
    assert mxu.LAUNCHES == {"mma_chain": 0}


# -- on the card: the kernel against its plain version ----------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1024, 8, 1024), (1024, 72, 1024), (1024, 80, 72),
                                   (1024, 1024, 72), (100, 40, 20), (64, 1024, 8)])
def test_kernel_matches_plain_on_card(cuda_device, m, k, n):
    g = torch.Generator().manual_seed(k + n)
    a = (1e-2 * torch.randn(m, k, generator=g)).to("cuda", torch.bfloat16)
    w = torch.randn(k, n, generator=g).to("cuda", torch.bfloat16)
    before = mxu.LAUNCHES["mma_chain"]
    got = mxu.mma_chain(a, w, 8)
    ref = mxu.mma_chain_plain(a, w, 8)
    torch.cuda.synchronize()
    assert mxu.LAUNCHES["mma_chain"] == before + 1
    top = ref.abs().max().item()
    assert (got - ref).abs().max().item() <= 1e-4 * top

"""The port's context-parallel attention (`ops/context_parallel.py`) on gloo
CPU worlds of 4 and 2 ranks against the JAX package's on its 8-device CPU
mesh, with the cases of `tests/test_context_parallel.py` (mask, GQA, custom
scale). The mask keeps keys 16-55 of 64, so at 4 ranks the first key block
is wholly masked (the ring fold's -inf case). Each world starts once per
module (a module fixture runs every case); fp32, atol 1e-5 as the JAX
tests use. Also the one-process fold of key blocks (`ring_fold`) against
the plain attention, a wholly masked block included."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumina_t2x_tpu.ops.attention import sdpa as j_sdpa
from lumina_t2x_tpu.ops.context_parallel import (allgather_context_attention as j_allgather,
                                                 ring_context_attention as j_ring)
from lumina_t2x_tpu.parallel import create_mesh as j_create_mesh
from lumina_t2x_tpu_torch.ops import context_parallel as t_cp
from lumina_t2x_tpu_torch.ops import flash_attention as t_fa
from lumina_t2x_tpu_torch.parallel import gloo_world

ATOL = 1e-5
CASE = "lumina_t2x_tpu_torch.parallel.gloo_cases:context_attention"


def _qkv(b=2, s=64, hq=4, hkv=4, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d)))


def _mask(lo, hi):
    m = np.zeros((2, 64), np.int32)
    m[:, lo:hi] = 1
    return m


CASES = {
    "allgather": ("allgather", _qkv(), None, None),
    "allgather_mask": ("allgather", _qkv(), _mask(0, 40), None),
    "ring": ("ring", _qkv(), None, None),
    "ring_gqa": ("ring", _qkv(hq=8, hkv=2), None, None),
    "ring_mask": ("ring", _qkv(), _mask(16, 56), None),
    "ring_scale": ("ring", _qkv(), None, 0.25),
    "allgather_gqa_scale": ("allgather", _qkv(hq=8, hkv=2, seed=3), _mask(16, 56), 0.25),
}
WORLDS = {4: list(CASES), 2: ["ring_mask", "allgather_mask"]}


def _jax_refs():
    """name -> (JAX's context-parallel output, JAX's sdpa), every case in
    one jitted program (one compile)."""
    mesh = j_create_mesh(model_parallel_size=1)
    names = sorted(CASES)

    def all_cases():
        outs = []
        for name in names:
            kind, (q, k, v), mask, scale = CASES[name]
            fn = j_allgather if kind == "allgather" else j_ring
            args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
            m = None if mask is None else jnp.asarray(mask)
            outs.append((fn(*args, mesh, kv_mask=m, scale=scale), j_sdpa(*args, kv_mask=m,
                                                                         scale=scale)))
        return outs

    return dict(zip(names, jax.tree.map(np.asarray, jax.jit(all_cases)())))


@pytest.fixture(scope="module")
def runs():
    """(the worlds' results, the JAX references): the worlds run while JAX
    compiles."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(1) as pool:
        worlds = pool.submit(_worlds)
        refs = _jax_refs()
        return worlds.result(), refs


def _worlds():
    calls = {world: (world, [(CASE, dict(kind=CASES[n][0], q=CASES[n][1][0], k=CASES[n][1][1],
                                         v=CASES[n][1][2], mask=CASES[n][2], scale=CASES[n][3]))
                             for n in names])
             for world, names in WORLDS.items()}
    ranks = gloo_world.run_worlds(calls)
    # this rank's tokens, rank after rank
    return {(world, name): np.concatenate([r[i] for r in ranks[world]], axis=1)
            for world, names in WORLDS.items() for i, name in enumerate(names)}


@pytest.mark.parametrize("world,name", [(w, n) for w, names in WORLDS.items() for n in names])
def test_matches_jax(runs, world, name):
    worlds, jax_refs = runs
    got = worlds[(world, name)]
    jax_out, jax_sdpa = jax_refs[name]
    np.testing.assert_allclose(got, jax_out, atol=ATOL)
    np.testing.assert_allclose(got, jax_sdpa, atol=ATOL)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("masked_block", [None, 0, 2])
def test_ring_fold_of_blocks_matches_plain_attention(masked_block):
    """The chip phase's one-process fold: 4 key blocks through the plain
    K4, one block wholly masked or none."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(hq=8, hkv=2, seed=5))
    mask = torch.ones((2, 64), dtype=torch.int32)
    if masked_block is not None:
        mask[:, 16 * masked_block:16 * (masked_block + 1)] = 0
    blocks = [(k[:, i:i + 16], v[:, i:i + 16], mask[:, i:i + 16]) for i in range(0, 64, 16)]
    got = t_cp.ring_fold(q, blocks, 0.3, block_fn=t_fa.flash_online_lse_plain)
    ref = t_fa.flash_online_plain(q, k, v, mask, 0.3)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL)


def test_fold_keeps_rows_with_no_valid_key_at_zero():
    q, k, v = (torch.from_numpy(a) for a in _qkv(seed=6))
    mask = torch.zeros((2, 64), dtype=torch.int32)
    mask[1, 40:] = 1  # item 0 has no valid key at all
    blocks = [(k[:, i:i + 32], v[:, i:i + 32], mask[:, i:i + 32]) for i in (0, 32)]
    got = t_cp.ring_fold(q, blocks, None, block_fn=t_fa.flash_online_lse_plain)
    assert torch.isfinite(got).all() and float(got[0].abs().max()) == 0.0
    ref = t_fa.flash_online_plain(q, k, v, mask, 0.25)
    np.testing.assert_allclose(got[1].numpy(), ref[1].numpy(), atol=ATOL)

"""The port's GPipe (`parallel/pipeline.py`) on gloo CPU worlds of 2 and 4
ranks against the JAX package's `gpipe_spmd`, with the cases of
`tests/test_pipeline.py`: the toy stack y = tanh(x @ w + b) (8 layers),
(stages, microbatches) (2, 4), (4, 8), (4, 1), broadcast and
per-microbatch conditioning, and the gradients of sum(ys ** 2) with respect
to every stage's parameters. Each world starts once per module; fp32,
atol 1e-5 (gradients 1e-4, as the JAX test holds them)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from lumina_t2x_tpu.parallel.pipeline import gpipe_spmd as j_gpipe
from lumina_t2x_tpu.parallel.pipeline import merge_stages as j_merge
from lumina_t2x_tpu.parallel.pipeline import split_stages as j_split
from lumina_t2x_tpu_torch.parallel import gloo_world
from lumina_t2x_tpu_torch.parallel import pipeline as t_pipe

CASE = "lumina_t2x_tpu_torch.parallel.gloo_cases:gpipe"


def _stack(n_layers, d, seed):
    rng = np.random.default_rng(seed)
    return {"w": (0.5 * rng.standard_normal((n_layers, d, d))).astype(np.float32),
            "b": (0.01 * rng.standard_normal((n_layers, d))).astype(np.float32)}


def _xs(m, d, seed=1):
    return np.random.default_rng(seed).standard_normal((m, 2, d)).astype(np.float32)


# name -> (stages, kwargs of the case)
CASES = {
    "s2_m4": (2, dict(params=_stack(8, 8, 0), xs=_xs(4, 8))),
    "s4_m8": (4, dict(params=_stack(8, 8, 0), xs=_xs(8, 8))),
    "s4_m1": (4, dict(params=_stack(8, 8, 0), xs=_xs(1, 8))),
    "grads_s2": (2, dict(params=_stack(4, 4, 0), xs=_xs(4, 4), grads=True)),
    "grads_s4": (4, dict(params=_stack(8, 4, 2), xs=_xs(8, 4, 3), grads=True)),
    "broadcast_s4": (4, dict(params=_stack(8, 8, 0), xs=_xs(4, 8),
                             broadcast=np.random.default_rng(2).standard_normal(8)
                             .astype(np.float32))),
    "per_mb_s4": (4, dict(params=_stack(8, 8, 0), xs=_xs(8, 8),
                          per_mb=np.random.default_rng(2).standard_normal((8, 8))
                          .astype(np.float32))),
}


def _j_stage(stage_params, x, *cond):
    def body(h, p):
        h = jnp.tanh(h @ p["w"] + p["b"])
        return (h + cond[0] if cond else h), None

    return jax.lax.scan(body, x, stage_params)[0]


def _jax_refs():
    """name -> (JAX's pipelined ys, its staged grads or None): the cases of
    one stage count in one jitted program."""
    out = {}
    for n in (2, 4):
        names = [name for name, (stages, _) in CASES.items() if stages == n]
        mesh = Mesh(np.array(jax.devices()[:n]), ("pipe",))
        apply = j_gpipe(_j_stage, mesh)

        def all_cases():
            res = []
            for name in names:
                kw = CASES[name][1]
                staged = j_split(jax.tree.map(jnp.asarray, kw["params"]), n)
                per_mb = () if kw.get("per_mb") is None else (jnp.asarray(kw["per_mb"]),)
                bcast = () if kw.get("broadcast") is None else (jnp.asarray(kw["broadcast"]),)
                xs = jnp.asarray(kw["xs"])
                ys = apply(staged, xs, per_mb=per_mb, broadcast=bcast)
                grads = (jax.grad(lambda p: jnp.sum(apply(p, xs) ** 2))(staged)
                         if kw.get("grads") else None)
                res.append((ys, grads))
            return res

        with jax.set_mesh(mesh):
            got = jax.tree.map(np.asarray, jax.jit(all_cases)())
        out.update(zip(names, got))
    return out


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
    names = {w: [name for name, (n, _) in CASES.items() if n == w] for w in (2, 4)}
    ranks = gloo_world.run_worlds({w: (w, [(CASE, CASES[name][1]) for name in names[w]])
                                   for w in names})
    return {name: [r[i] for r in ranks[w]] for w in names for i, name in enumerate(names[w])}


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax(runs, name):
    worlds, jax_refs = runs
    ys, grads = jax_refs[name]
    for rank_out in worlds[name]:  # the outputs reach every rank
        np.testing.assert_allclose(rank_out["ys"], ys, atol=1e-5)
    if grads is not None:
        for k in ("w", "b"):
            got = np.concatenate([r["grads"][k] for r in worlds[name]])  # stage after stage
            np.testing.assert_allclose(got, np.asarray(grads[k]), atol=1e-4, err_msg=k)
            assert np.abs(got).max() > 0


def test_split_merge_roundtrip():
    p = {k: torch.from_numpy(v) for k, v in _stack(8, 4, 0).items()}
    staged = t_pipe.split_stages(p, 4)
    assert staged["w"].shape == (4, 2, 4, 4)
    assert torch.equal(t_pipe.merge_stages(staged)["w"], p["w"])
    with pytest.raises(AssertionError):
        t_pipe.split_stages({k: v[:6] for k, v in p.items()}, 4)
    # the JAX package's split of the same stack
    np.testing.assert_array_equal(staged["b"].numpy(), np.asarray(j_split(
        {"b": jnp.asarray(_stack(8, 4, 0)["b"])}, 4)["b"]))
    np.testing.assert_array_equal(t_pipe.merge_stages(staged)["b"].numpy(), np.asarray(
        j_merge(j_split({"b": jnp.asarray(_stack(8, 4, 0)["b"])}, 4))["b"]))

"""The port's multi-GPU layer (`lumina_t2x_tpu_torch/parallel`) against the
JAX package's:

- the sharding rules over every parameter of the 2B tree (`spec_for_param`
  with and without FSDP, `model_parallel_dim_dict`), given the (in, out) ->
  (out, in) transpose of a kernel and the layer axis JAX stacks;
- on gloo CPU worlds (each started once per module, the worlds together):
  a TP2 (world 2) and a TP2 x FSDP2 (world 4, 2 x 2) forward of the tiny
  NextDiT with qk-norm and GQA, a sequence-sharded forward (world 4), an
  expert-parallel `SpaceMoEFFN` (world 2, tokens replicated and tokens
  sharded, with and without capacity drops; its output and its gradients),
  and the class-conditional
  sampler with its model sharded over 2 model ranks, each held against the
  JAX unsharded model on the same numpy inputs (JAX's slow sharding tests
  hold that equal to its sharded one).

fp32 on the CPU; bar atol 2e-5 (2e-5 rtol) as the port's other tests, 1e-4
for the sampler's 3-step trajectory (three model calls compound the
reduction-order differences of the model-parallel sums)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from lumina_t2x_tpu.models import moe as j_moe
from lumina_t2x_tpu.models import next_dit as j_nd
from lumina_t2x_tpu.models import next_dit_imagenet as j_ni
from lumina_t2x_tpu.parallel import sharding as j_sharding
from lumina_t2x_tpu.pipelines import sample_lib as j_sl
from lumina_t2x_tpu_torch.core.checkpoint import (imagenet_state_dict_from_jax_params,
                                                  state_dict_from_jax_params)
from lumina_t2x_tpu_torch.models import next_dit as t_nd
from lumina_t2x_tpu_torch.parallel import gloo_world, mesh as t_mesh, sharding as t_sharding

ATOL, RTOL = 2e-5, 2e-5
CASES = "lumina_t2x_tpu_torch.parallel.gloo_cases"
TINY = dict(patch_size=2, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, multiple_of=16,
            cap_feat_dim=32, qk_norm=True)


def _perturbed(params, seed):
    flat = traverse_util.flatten_dict(jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(seed)
    return traverse_util.unflatten_dict({k: (v + 0.02 * rng.standard_normal(v.shape))
                                         .astype(np.float32) for k, v in flat.items()})


def _next_dit():
    jmodel = j_nd.NextDiT(attn_impl="xla", **TINY)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(2), jnp.zeros((2, 4, 8, 8)),
                                     jnp.zeros((2,)), jnp.zeros((2, 9, 32)),
                                     jnp.ones((2, 9), jnp.int32))
    params = _perturbed(variables["params"], 2)
    rng = np.random.default_rng(7)
    mask = np.ones((2, 9), np.int32)
    mask[0, 6:] = 0
    args = (rng.standard_normal((2, 4, 8, 8)).astype(np.float32),
            rng.uniform(0, 1, 2).astype(np.float32),
            rng.standard_normal((2, 9, 32)).astype(np.float32), mask)
    ref = lambda: np.asarray(jax.jit(lambda p, *a: jmodel.apply({"params": p}, *a))(
        params, *map(jnp.asarray, args)))
    sd = {k: v.numpy() for k, v in state_dict_from_jax_params(params).items()}
    return sd, args, ref


def _moe_layer(capacity_factor):
    kw = dict(dim=16, multiple_of=8, num_experts=4, num_experts_per_tok=2,
              capacity_factor=capacity_factor)
    layer = j_moe.SpaceMoEFFN(**kw)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (2, 8, 16)))
    params = _perturbed(layer.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"], 3)
    ref = lambda: np.asarray(layer.apply({"params": params}, jnp.asarray(x)))
    sd = {"gate.weight": params["gate"]["kernel"].T}
    for j in range(4):
        for w in ("w1", "w2", "w3"):
            sd[f"experts.{j}.{w}.weight"] = np.ascontiguousarray(params[w][j].T)
    t_kw = dict(dim=16, gate_in=16, multiple_of=8, ffn_dim_multiplier=None, num_experts=4,
                num_experts_per_tok=2, capacity_factor=capacity_factor)
    cotangent = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)

    def grad_ref():
        """The gradients of sum(out * cotangent), by the port's names."""
        loss = lambda p, x_: jnp.sum(layer.apply({"params": p}, x_) * cotangent)
        gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(x))
        grads = {"x": np.asarray(gx), "gate": np.asarray(gp["gate"]["kernel"]).T}
        for j in range(4):
            for w in ("w1", "w2", "w3"):
                grads[f"experts.{j}.{w}"] = np.asarray(gp[w][j]).T
        return grads

    return t_kw, sd, x, ref, cotangent, grad_ref


def _sampler():
    kw = dict(patch_size=2, dim=64, n_layers=2, n_heads=4, multiple_of=16, qk_norm=True)
    jmodel = j_ni.NextDiTImageNet(attn_impl="xla", **kw)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(2), jnp.zeros((1, 4, 8, 8)),
                                     jnp.zeros((1,)), jnp.zeros((1,), jnp.int32))
    params = _perturbed(variables["params"], 2)
    labels = np.array([5, 42], np.int32)
    rng = jax.random.PRNGKey(7)
    skw = dict(num_steps=3, solver="midpoint", cfg_scale=4.0, latent_size=8, in_channels=4)
    ref = lambda: np.asarray(jax.jit(j_sl.build_class_cond_sample_fn(jmodel, **skw))(
        {"params": params}, rng, jnp.asarray(labels)))
    z = np.array(jax.random.normal(rng, (2, 4, 8, 8)))
    sd = {k: v.numpy() for k, v in imagenet_state_dict_from_jax_params(params).items()}
    return dict(kwargs=kw, state_dict=sd, z=z, labels=labels, mp=2, sample_kwargs=skw), ref


# `param_shardings` at (data 1, model 2): 13 rows do not split over 2 ranks
PLACED = {"layers.0.attention.wq.weight": (12, 6), "layers.0.attention.wo.weight": (6, 12),
          "layers.0.attention.wk.weight": (13, 6), "layers.0.attention_norm1.weight": (6,)}


@pytest.fixture(scope="module")
def runs():
    """name -> (per-rank results, the JAX reference). The worlds start as
    soon as their inputs exist and run while the JAX references compile."""
    from concurrent.futures import ThreadPoolExecutor

    sd, args, ref = _next_dit()
    model = dict(ctor="next_dit:NextDiT", kwargs=TINY, state_dict=sd, args=args)
    moe = {cf: _moe_layer(cf) for cf in (4.0, 1.0)}
    sampler_kw, sampler_ref = _sampler()
    calls = {
        2: [("tp2", f"{CASES}:model_forward", dict(model, mp=2), ref),
            *((f"ep_{tokens}_cf{cf}", f"{CASES}:ep_forward",
               dict(kwargs=moe[cf][0], state_dict=moe[cf][1], x=moe[cf][2], tokens=tokens),
               moe[cf][3]) for cf in moe for tokens in ("replicated", "sharded")),
            *((f"ep_grad_{tokens}_cf{cf}", f"{CASES}:ep_forward",
               dict(kwargs=moe[cf][0], state_dict=moe[cf][1], x=moe[cf][2], tokens=tokens,
                    cotangent=moe[cf][4]), moe[cf][5])
              for cf in moe for tokens in ("replicated", "sharded")),
            ("sampler_tp2", f"{CASES}:class_cond_sample", sampler_kw, sampler_ref),
            ("placements", f"{CASES}:placements",
             dict(shapes=PLACED, mp=2), lambda: None)],
        4: [("tp2_fsdp", f"{CASES}:model_forward", dict(model, mp=2, fsdp=True), ref),
            ("fsdp4", f"{CASES}:model_forward", dict(model, mp=1, fsdp=True), ref),
            ("seq4", f"{CASES}:seq_forward", model, ref)],
    }
    with ThreadPoolExecutor(1) as pool:
        worlds = pool.submit(gloo_world.run_worlds, {w: (w, [(t, kw) for _, t, kw, _ in c])
                                                     for w, c in calls.items()})
        refs = {name: ref() for c in calls.values() for name, _, _, ref in c}
        results = worlds.result()
    return {name: ([r[i] for r in results[w]], refs[name])
            for w, c in calls.items() for i, (name, _, _, _) in enumerate(c)}


@pytest.mark.parametrize("name", ["tp2", "tp2_fsdp", "fsdp4", "seq4"])
def test_sharded_next_dit_forward_matches_jax(runs, name):
    ranks, ref = runs[name]
    for out in ranks:  # every rank returns the whole output
        np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("tokens", ["replicated", "sharded"])
@pytest.mark.parametrize("cf", [4.0, 1.0])
def test_expert_parallel_space_moe_matches_jax(runs, tokens, cf):
    ranks, ref = runs[f"ep_{tokens}_cf{cf}"]
    got = ranks if tokens == "replicated" else [np.concatenate(ranks)]
    for out in got:
        np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("tokens", ["replicated", "sharded"])
@pytest.mark.parametrize("cf", [4.0, 1.0])
def test_expert_parallel_space_moe_gradients_match_jax(runs, tokens, cf):
    """The gradients of sum(out * cotangent) against JAX's unsharded layer:
    each rank's experts whole; x and the gate whole on every rank with the
    tokens replicated; with the tokens sharded, x by rows and the gate as
    the sum of the ranks' shares."""
    ranks, ref = runs[f"ep_grad_{tokens}_cf{cf}"]
    grads = [g for _, g in ranks]
    if tokens == "sharded":
        got = {"x": np.concatenate([g["x"] for g in grads]),
               "gate": sum(g["gate"] for g in grads)}
    else:
        got = grads[0]
        for g in grads[1:]:
            for name in ("x", "gate"):
                np.testing.assert_allclose(g[name], ref[name], atol=ATOL, rtol=RTOL,
                                           err_msg=name)
    experts = {k: v for g in grads for k, v in g.items() if k.startswith("experts.")}
    assert sorted(experts) == sorted(k for k in ref if k.startswith("experts."))
    for name, r in ref.items():
        np.testing.assert_allclose({**got, **experts}[name], r, atol=ATOL, rtol=RTOL,
                                   err_msg=name)


def test_param_shardings_place_and_skip_indivisible(runs):
    """The JAX test's indivisible case (`test_param_shardings_skip_indivisible`)
    and the column / row rules as DTensor placements, on a world of 2."""
    ranks, _ = runs["placements"]
    for shardings, local in ranks:
        # per mesh dim (data, model): the tensor dim it shards, None: replicated
        assert shardings == {"layers.0.attention.wq.weight": [None, 0],
                             "layers.0.attention.wo.weight": [None, 1],
                             "layers.0.attention.wk.weight": [None, None],
                             "layers.0.attention_norm1.weight": [None, None]}
        assert local == {"layers.0.attention.wq.weight": (6, 6),
                         "layers.0.attention.wo.weight": (6, 6),
                         "layers.0.attention.wk.weight": (13, 6),
                         "layers.0.attention_norm1.weight": (6,)}


def test_grad_norm_utilities_match_jax():
    """`parallel.grad_norm` on plain tensors in one process against the JAX
    package's functions on the same arrays."""
    from lumina_t2x_tpu.parallel import grad_norm as j_gn
    from lumina_t2x_tpu_torch.parallel import grad_norm as t_gn

    rng = np.random.default_rng(0)
    arrays = {"a": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    ref = float(j_gn.calculate_l2_grad_norm({k: jnp.asarray(v) for k, v in arrays.items()}))
    grads = {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}
    np.testing.assert_allclose(float(t_gn.calculate_l2_grad_norm(grads)), ref, rtol=1e-6)
    j_clipped, j_norm = j_gn.clip_grad_norm({k: jnp.asarray(v) for k, v in arrays.items()}, 0.5)
    clipped, norm = t_gn.clip_grad_norm(grads, 0.5)
    np.testing.assert_allclose(float(norm), float(j_norm), rtol=1e-6)
    for k in arrays:
        np.testing.assert_allclose(clipped[k].numpy(), np.asarray(j_clipped[k]), rtol=1e-6,
                                   atol=1e-7)


def test_class_cond_sampler_under_model_parallel_matches_jax(runs):
    ranks, ref = runs["sampler_tp2"]
    for out in ranks:
        np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


# -- the rules, over the 2B tree ------------------------------------------------------


def _jax_name_map():
    """port parameter name (layers as `layers.0.`) -> (JAX path, stacked?,
    kernel?), read off the weight bridge on a tiny tree of the 2B's
    structure whose leaves hold their own index."""
    jmodel = j_nd.NextDiT(**dict(TINY, n_kv_heads=None))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 4, 8, 8)),
                            jnp.zeros((1,)), jnp.zeros((1, 4, 32)), jnp.ones((1, 4), jnp.int32))
    flat = traverse_util.flatten_dict(shapes["params"], sep="/")
    paths = sorted(flat)
    tree = {p: np.full(flat[p].shape, i, np.float32) for i, p in enumerate(paths)}
    sd = state_dict_from_jax_params(traverse_util.unflatten_dict(tree, sep="/"))
    out = {}
    for name, t in sd.items():
        path = paths[int(t.reshape(-1)[0])]
        out[name] = (path, path.startswith("layers/"), path.endswith("kernel"))
    return out


@pytest.mark.parametrize("fsdp", [False, True])
def test_rules_match_jax_over_the_2b_tree(fsdp):
    names = _jax_name_map()
    tmodel = t_nd.NextDiT_2B_patch2(qk_norm=True, cap_feat_dim=2048, device="meta")
    params = dict(tmodel.named_parameters())
    jdims = j_sharding.model_parallel_dim_dict(traverse_util.unflatten_dict(
        {path: np.zeros((2,) * (2 + stacked if kernel else 1 + stacked))
         for path, stacked, kernel in names.values()}, sep="/"))
    for name, p in params.items():
        key = name if not name.startswith("layers.") else "layers.0." + name.split(".", 2)[2]
        path, stacked, kernel = names[key]
        j_spec = tuple(j_sharding.spec_for_param(path, p.dim() + stacked, fsdp=fsdp))
        j_spec = (j_spec + (None,) * (p.dim() + stacked))[:p.dim() + stacked][stacked:]
        if kernel:
            j_spec = j_spec[::-1]
        assert t_sharding.spec_for_param(name, p.dim(), fsdp=fsdp) == j_spec, name
        if not fsdp:
            jd = jdims[path]
            jd = None if jd is None else jd - stacked
            if kernel and jd is not None:
                jd = 1 - jd
            assert t_sharding.model_parallel_dim_dict({name: p})[name] == jd, name


def test_rules_cases_of_the_jax_tests():
    assert t_sharding.spec_for_param("layers.0.attention.wq.weight", 2) == ("model", None)
    assert t_sharding.spec_for_param("layers.0.attention.wo.weight", 2) == (None, "model")
    assert t_sharding.spec_for_param("layers.0.attention.wq.weight", 2, fsdp=True) == \
        ("model", "data")
    assert t_sharding.spec_for_param("layers.0.attention.wo.weight", 2, fsdp=True) == \
        ("data", "model")
    assert t_sharding.spec_for_param("layers.0.attention_norm1.weight", 1) == (None,)
    assert t_sharding.spec_for_param("y_embedder.embedding_table.weight", 2) == (None, "model")
    assert t_sharding.spec_for_param("layers.0.feed_forward.experts.1.w1.weight", 2) == \
        (None, None)


def test_shard_rows_takes_each_ranks_part_of_every_micro_batch():
    x = torch.arange(16).reshape(16, 1)
    assert t_mesh.shard_rows(x, 1, 4).reshape(-1).tolist() == [4, 5, 6, 7]
    assert t_mesh.shard_rows(x, 1, 2, micro_batches=2).reshape(-1).tolist() == \
        [4, 5, 6, 7, 12, 13, 14, 15]
    with pytest.raises(ValueError):
        t_mesh.shard_rows(x, 0, 3)


def test_one_process_mesh_and_env_contract(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert t_mesh.distributed_init("cpu") is False  # no torchrun env: no-op
    with pytest.raises(AssertionError, match="not divisible"):
        t_mesh.create_mesh(model_parallel_size=3)
    with pytest.raises(RuntimeError, match="process group"):
        t_mesh.create_mesh(model_parallel_size=1)


def test_sampler_cli_model_parallel_in_one_process_raises_the_mesh_error(tmp_path):
    """`--model_parallel_size 2` runs under torchrun (the sharded sampler
    above); one process has a world of 1, which the mesh rejects as JAX's
    `create_mesh` does."""
    from lumina_t2x_tpu_torch.pipelines import sample as t_sample

    with pytest.raises(AssertionError, match="not divisible by model_parallel_size=2"):
        t_sample.main(["--model", "NextDiT_ImageNet_Tiny_patch2", "--debug", "--device", "cpu",
                       "--precision", "fp32", "--num_sampling_steps", "2", "--labels", "1",
                       "--image_save_path", str(tmp_path), "--model_parallel_size", "2"])

"""Functions the port's multi-rank tests run on a gloo world
(`parallel/gloo_world.run`): each takes numpy inputs and returns numpy
results of this rank, so that the test process can hold them against the
JAX package. They import torch and the port only."""

from __future__ import annotations

import importlib
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from .mesh import create_mesh
from .sharding import parallelize


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return t.detach().float().cpu().numpy() if t.dtype == torch.bfloat16 else \
        t.detach().cpu().numpy()


def _state_dict(sd):
    return {k: _t(v) for k, v in sd.items()}


def _build(ctor: str, kwargs: Dict, state_dict=None):
    """`ctor` "module:Class" under `lumina_t2x_tpu_torch.models`."""
    module, name = ctor.split(":")
    cls = getattr(importlib.import_module(f"lumina_t2x_tpu_torch.models.{module}"), name)
    torch.manual_seed(0)
    model = cls(**kwargs)
    if state_dict is not None:
        model.load_state_dict(_state_dict(state_dict), strict=True)
    return model


def model_forward(ctor, kwargs, state_dict, args, mp=1, fsdp=False, call_kwargs=None):
    """The model sharded over a (data, model) mesh with `mp` model ranks
    (FSDP2 over data under `fsdp`), run on the same inputs on every rank."""
    model = _build(ctor, kwargs, state_dict).eval()
    parallelize(model, create_mesh(mp), fsdp=fsdp)
    with torch.no_grad():
        out = model(*[_t(a) for a in args], **(call_kwargs or {}))
    return _np(out)


def seq_forward(ctor, kwargs, state_dict, args, call_kwargs=None):
    """The model with its image tokens split over the world."""
    model = _build(ctor, dict(kwargs, seq_shard_axis="data"), state_dict).eval()
    with torch.no_grad():
        out = model(*[_t(a) for a in args], **(call_kwargs or {}))
    return _np(out)


def ep_forward(kwargs, state_dict, x, tokens="replicated", cotangent=None):
    """SpaceMoEFFN with its experts split over the world; under "sharded"
    each rank runs its rows of x (split along the batch). With a
    `cotangent` (the output's shape), also the gradients of
    sum(out * cotangent) over the rank's rows: (out, {"x": ..., "gate": ...,
    "experts.<j>.<w>": ... for the rank's experts j})."""
    from ..models.moe import SpaceMoEFFN

    torch.manual_seed(0)
    layer = SpaceMoEFFN(**kwargs)
    layer.load_state_dict(_state_dict(state_dict), strict=True)
    layer.shard_experts(dist.group.WORLD, tokens)
    assert len(layer.experts) == layer.num_experts // dist.get_world_size()
    rows = (lambda a: _t(a).chunk(dist.get_world_size())[dist.get_rank()]) \
        if tokens == "sharded" else _t
    xt = rows(x)
    if cotangent is None:
        with torch.no_grad():
            return _np(layer(xt))
    xt.requires_grad_(True)
    out = layer(xt)
    (out * rows(cotangent)).sum().backward()
    grads = {"x": _np(xt.grad), "gate": _np(layer.gate.weight.grad)}
    for j, expert in layer.experts.items():
        for w in ("w1", "w2", "w3"):
            grads[f"experts.{j}.{w}"] = _np(getattr(expert, w).weight.grad)
    return _np(out), grads


def class_cond_sample(kwargs, state_dict, z, labels, mp, sample_kwargs):
    """`build_class_cond_sample_fn` on a NextDiT-ImageNet sharded for
    sampling over `mp` model ranks (`pipelines/sample.shard_for_sampling`)."""
    from ..pipelines.sample import shard_for_sampling
    from ..pipelines.sample_lib import build_class_cond_sample_fn

    model = _build("next_dit_imagenet:NextDiTImageNet", kwargs, state_dict).eval()
    shard_for_sampling(model, mp)
    fn = build_class_cond_sample_fn(model, **sample_kwargs)
    return _np(fn(_t(z), _t(labels).long()))


def context_attention(kind, q, k, v, mask=None, scale=None):
    """This rank's output of `allgather_context_attention` or
    `ring_context_attention` on its slice of the token axis."""
    from ..ops.context_parallel import allgather_context_attention, ring_context_attention

    n, r = dist.get_world_size(), dist.get_rank()
    part = lambda a: _t(a).chunk(n, dim=1)[r].contiguous()
    mask_l = None if mask is None else part(mask)
    if kind == "allgather":
        out = allgather_context_attention(part(q), part(k), part(v), kv_mask=mask_l, scale=scale,
                                          impl="plain")
    else:
        out = ring_context_attention(part(q), part(k), part(v), kv_mask=mask_l, scale=scale)
    return _np(out)


def _toy_stage(params, x, *cond):
    """L // S layers of y = tanh(x @ w + b) (+ the conditioning)."""
    for i in range(params["w"].shape[0]):
        x = torch.tanh(x @ params["w"][i] + params["b"][i])
        if cond:
            x = x + cond[0]
    return x


def gpipe(params, xs, per_mb=None, broadcast=None, grads=False):
    """`gpipe_spmd` over the world on the toy stack: (ys, this rank's stage
    gradients of sum(ys ** 2) or None)."""
    from .pipeline import gpipe_spmd, split_stages, stage_shardings

    n = dist.get_world_size()
    local = stage_shardings(split_stages({k: _t(v) for k, v in params.items()}, n))
    local = {k: v.clone().requires_grad_(grads) for k, v in local.items()}
    apply = gpipe_spmd(_toy_stage)
    ys = apply(local, _t(xs), per_mb=() if per_mb is None else (_t(per_mb),),
               broadcast=() if broadcast is None else (_t(broadcast),))
    out = {"ys": _np(ys)}
    if grads:
        (ys ** 2).sum().backward()
        out["grads"] = {k: _np(v.grad) for k, v in local.items()}
    return out


def _optimizer(kind, kwargs):
    from ..pipelines import train_lib

    return {"adamw": train_lib.create_optimizer, "fused_adamw": train_lib.FusedAdamWEMA,
            "adafactor": train_lib.FusedAdafactorEMA}[kind](**kwargs)


def sharded_train_step(kwargs, model_sd, ema_sd, opt_sd, optimizer, batch, draws, mp=1,
                       fsdp=True, grad_clip=2.0, micro_batches=1, grad_dtype=None,
                       snr_type="uniform"):
    """One `make_train_step` step of a NextDiT sharded over a (data, model)
    mesh with `mp` model ranks, from a full state, with the step's global
    draws handed in; returns (metrics, the state after the step gathered
    whole) on rank 0 (None elsewhere). `grad_dtype`: "bf16" or None."""
    from ..core.checkpoint import full_tree
    from ..models.next_dit import NextDiT
    from ..pipelines import train_lib
    from ..transport import create_transport

    model = NextDiT(**kwargs)
    model.load_state_dict(_state_dict(model_sd), strict=True)

    def tree(x):
        return {k: tree(v) for k, v in x.items()} if isinstance(x, dict) else \
            (_t(x) if isinstance(x, np.ndarray) else x)

    opt = _optimizer(*optimizer)
    state = train_lib.TrainState(step=0, model=model, ema=tree(ema_sd), opt_state=tree(opt_sd))
    mesh = create_mesh(mp)
    parallelize(model, mesh, fsdp=fsdp)
    state = train_lib.place_state(state)
    transport = create_transport("Linear", "velocity", snr_type=snr_type)
    cond = lambda b: {"cap_feats": b["cap_feats"], "cap_mask": b["cap_mask"]}
    step = train_lib.make_train_step(
        model, transport, opt, cond, grad_clip=grad_clip, micro_batches=micro_batches,
        grad_dtype={None: None, "bf16": torch.bfloat16}[grad_dtype], mesh=mesh, fsdp=fsdp)
    state, metrics = step(state, tree(batch), 0, draws=[tuple(_t(a) for a in d) for d in draws])
    full = full_tree({"model": dict(model.state_dict()), "ema": state.ema,
                      "optimizer": state.opt_state}, keep=dist.get_rank() == 0)
    if dist.get_rank():
        return None
    as_np = lambda x: {k: as_np(v) for k, v in x.items()} if isinstance(x, dict) else _np(x)
    return metrics, as_np(full)


def trainer(argv, env: Optional[Dict[str, str]] = None):
    """`pipelines.train.main(argv)` on this rank; returns its final step."""
    import os

    from ..pipelines.train import main

    os.environ.update(env or {})
    return main(list(argv)).step


def audio_trainer(argv):
    """`pipelines.train_audio.main(argv)` on this rank; returns its final step."""
    from ..pipelines.train_audio import main

    return main(list(argv)).step


def placements(shapes, mp, fsdp=False):
    """`param_shardings` of parameters of these shapes on a (data, model)
    mesh with `mp` model ranks (per mesh dim the sharded tensor dim, None
    where replicated), and the local shapes `shard_params` gives."""
    from .sharding import param_shardings, shard_params

    params = {name: torch.arange(float(np.prod(s))).reshape(s) for name, s in shapes.items()}
    mesh = create_mesh(mp)
    placed = shard_params(mesh, params, fsdp=fsdp)
    return ({name: [p.dim if p.is_shard() else None for p in pl]
             for name, pl in param_shardings(mesh, params, fsdp).items()},
            {name: tuple(t.to_local().shape) for name, t in placed.items()})

"""Parameter sharding rules and their application: tensor parallelism over
the `model` axis, FSDP2 over `data` (counterpart of
`lumina_t2x_tpu/parallel/sharding.py`).

The rules are the JAX package's, over the port's state-dict names. A torch
`Linear.weight` is (out, in) where a JAX kernel is (in, out), so a spec here
is the JAX spec transposed:

- column-parallel weights (wq, wk, wv, wk_y, wv_y, w1, w3) shard dim 0 (out)
  over `model`; row-parallel ones (wo, w2) dim 1 (in);
- `x_embedder`, `adaLN_modulation` and `final_layer.linear` are column
  layers whose output is gathered; `y_embedder`'s table shards its feature
  dim;
- under `fsdp` the other dim of those goes over `data`, and every other
  weight of two or more dims shards dim 0 over `data` (the JAX rule's
  trailing kernel dim), as does every vector of a transformer block (JAX
  stacks the blocks, so its rule sees them as (layers, n) and shards n);
- everything else replicates, and so does any dim the axis does not divide.

`spec_for_param` gives a spec as a tuple of axis names per dim (None:
replicated), `param_shardings` the DTensor placements per mesh dim and
`shard_params` distributes a state dict by them.

Training applies the layout with torch's own machinery (`parallelize`):
`parallelize_module` with `ColwiseParallel` / `RowwiseParallel` over
`mesh["model"]` on the layers the rules name (a column layer's bias shards
with its output, as fairscale's `ColumnParallelLinear` keeps it), then
FSDP2's `fully_shard` per block and at the root over `mesh["data"]`, which
shards dim 0 of every parameter over the data ranks. Activations stay plain
tensors (`use_local_output`), so no DTensor reaches a kernel. The attention
modules get the model group: they run their heads' share
(`models/layers.Attention`).

`ShardLayout` records where each rank's piece of a parameter lies in the
global tensor, for the optimizer's reductions and its stochastic rounding.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from .mesh import AXIS_DATA, AXIS_MODEL, world_size

_COLUMN = ("wq", "wk", "wv", "wk_y", "wv_y", "w1", "w3")
_ROW = ("wo", "w2")
_GATHERED = (r"x_embedder", r"adaLN_modulation\.\d+", r"final_layer\.linear")

# (name regex, spec of a 2-D weight in torch's (out, in) order)
_RULES = [
    (rf"(^|\.)({'|'.join(_COLUMN)})\.weight$", (AXIS_MODEL, "fsdp")),
    (rf"(^|\.)({'|'.join(_ROW)})\.weight$", ("fsdp", AXIS_MODEL)),
    (rf"(^|\.)({'|'.join(_GATHERED)})\.weight$", (AXIS_MODEL, "fsdp")),
    (r"(^|\.)y_embedder\.embedding_table\.weight$", (None, AXIS_MODEL)),
]


def spec_for_param(name: str, ndim: int, fsdp: bool = False) -> Tuple[Optional[str], ...]:
    """Axis name (or None) for each dim of the parameter `name`."""
    for pattern, spec in _RULES:
        # expert weights stay replicated, as the JAX rules leave them
        if ndim == len(spec) and re.search(pattern, name) and ".experts." not in name:
            return tuple((AXIS_DATA if fsdp else None) if a == "fsdp" else a for a in spec)
    if fsdp and (ndim >= 2 or (ndim == 1 and name.startswith("layers."))):
        return (AXIS_DATA,) + (None,) * (ndim - 1)
    return (None,) * ndim


def _placements(spec, shape, mesh):
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for axis in mesh.mesh_dim_names:
        dims = [i for i, a in enumerate(spec) if a == axis]
        size = mesh[axis].size()
        out.append(Shard(dims[0]) if dims and shape[dims[0]] % size == 0 else Replicate())
    return out


def param_shardings(mesh, params: Dict[str, torch.Tensor], fsdp: bool = False) -> Dict:
    """name -> DTensor placements (one per mesh dim) by the rules; an axis
    that does not divide its dim is dropped (replicated)."""
    return {name: _placements(spec_for_param(name, p.dim(), fsdp), tuple(p.shape), mesh)
            for name, p in params.items()}


def shard_params(mesh, params: Dict[str, torch.Tensor], fsdp: bool = False) -> Dict:
    """The state dict `params` (the same values on every rank) as DTensors
    placed by `param_shardings`."""
    from torch.distributed.tensor import distribute_tensor

    shardings = param_shardings(mesh, params, fsdp)
    return {name: distribute_tensor(p.detach(), mesh, shardings[name])
            for name, p in params.items()}


def model_parallel_dim_dict(params: Dict[str, torch.Tensor]) -> Dict[str, Optional[int]]:
    """name -> the dim sharded over `model` (None if replicated)."""
    out = {}
    for name, p in params.items():
        spec = spec_for_param(name, p.dim())
        out[name] = spec.index(AXIS_MODEL) if AXIS_MODEL in spec else None
    return out


# -- applying the layout to a module -------------------------------------------------


def _tp_styles(model: nn.Module, n: int) -> Dict:
    """The `parallelize_module` plan of `model` over a model axis of n ranks."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.parallel import ColwiseParallel, RowwiseParallel

    plan = {}
    for name, mod in model.named_modules():
        if ".experts." in f".{name}.":  # the JAX rules leave expert weights replicated
            continue
        leaf = name.rsplit(".", 1)[-1]
        if hasattr(mod, "w1") and hasattr(mod, "w2") and hasattr(mod, "w3"):  # SwiGLU FFN
            if mod.w1.out_features % n == 0:
                plan.update({f"{name}.w1": ColwiseParallel(), f"{name}.w3": ColwiseParallel(),
                             f"{name}.w2": RowwiseParallel()})
        elif hasattr(mod, "wq") and hasattr(mod, "wo") and hasattr(mod, "tp_group"):
            heads, kv_heads = mod.n_heads, mod.n_kv_heads
            if heads % n or kv_heads % n:
                raise ValueError(f"{name}: {heads} query and {kv_heads} kv heads do not split "
                                 f"over {n} tensor-parallel ranks")
            for lin in ("wq", "wk", "wv", "wk_y", "wv_y"):
                if hasattr(mod, lin):
                    plan[f"{name}.{lin}"] = ColwiseParallel()
            plan[f"{name}.wo"] = RowwiseParallel()
        elif isinstance(mod, nn.Linear) and any(re.fullmatch(rf"(.*\.)?{g}", name)
                                                for g in _GATHERED):
            if mod.out_features % n == 0:
                plan[name] = ColwiseParallel(output_layouts=Replicate())
        elif isinstance(mod, nn.Embedding) and leaf == "embedding_table" \
                and name.endswith("y_embedder.embedding_table"):
            if mod.embedding_dim % n == 0:
                plan[name] = ColwiseParallel(output_layouts=Replicate())
    return plan


def tensor_parallel(model: nn.Module, mesh) -> nn.Module:
    """Shard `model` over `mesh["model"]` by the rules, in place."""
    from torch.distributed.tensor.parallel import parallelize_module

    tp = mesh[AXIS_MODEL]
    group = tp.get_group()
    for mod in model.modules():
        if hasattr(mod, "tp_group"):
            mod.tp_group = group if tp.size() > 1 else None
    plan = _tp_styles(model, tp.size())
    if plan:
        parallelize_module(model, tp, plan)
    return model


def blocks_of(model: nn.Module):
    """The transformer blocks: FSDP2 shards and gathers one at a time."""
    for attr in ("layers", "blocks"):
        blocks = getattr(model, attr, None)
        if isinstance(blocks, nn.ModuleList):
            return list(blocks)
    return []


def parallelize(model: nn.Module, mesh, fsdp: bool = True,
                reduce_dtype: torch.dtype = torch.float32) -> nn.Module:
    """Tensor parallelism over `model`, then (under `fsdp`) FSDP2 over
    `data`: each block, then the root. The gradients reduce-scatter in
    `reduce_dtype` (fp32: a bf16 wire is the `sdp` mode's).

    FSDP2 takes one parameter dtype a unit. At `param_dtype` bf16 the norm
    weights and gates stay fp32 (as in JAX); FSDP2 then leaves the
    parameters of the minority dtype alone (`ignored_params`): they stay
    replicated over `data`, and `needs_data_reduce` tells the train step to
    all-reduce their gradients itself."""
    tensor_parallel(model, mesh)
    if fsdp:
        from torch.distributed.fsdp import MixedPrecisionPolicy, fully_shard

        sizes: Dict[torch.dtype, int] = {}
        for p in model.parameters():
            sizes[p.dtype] = sizes.get(p.dtype, 0) + p.numel()
        main = max(sizes, key=sizes.get)
        ignored = {p for p in model.parameters() if p.dtype != main}
        policy = MixedPrecisionPolicy(reduce_dtype=reduce_dtype)
        dp = mesh[AXIS_DATA]
        for module in blocks_of(model) + [model]:
            fully_shard(module, mesh=dp, mp_policy=policy,
                        ignored_params=ignored & set(module.parameters()) or None)
    return model


def needs_data_reduce(p, fsdp: bool) -> bool:
    """Whether the train step all-reduces `p`'s gradient over `data` itself:
    every parameter without FSDP, else those FSDP2 does not shard over
    `data` (`parallelize`'s ignored minority dtype)."""
    from torch.distributed.tensor import DTensor

    return not (fsdp and isinstance(p, DTensor) and AXIS_DATA in p.device_mesh.mesh_dim_names)


# -- where a rank's piece lies ----------------------------------------------------------


def local_block(t: torch.Tensor):
    """(global shape, offset, local shape, replicas) of a DTensor's local
    piece; a plain tensor is whole on every rank. `replicas` counts the
    ranks that hold the same piece."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

        shape, offset = compute_local_shape_and_global_offset(t.shape, t.device_mesh,
                                                              t.placements)
        # Shard and FSDP2's _StridedShard (which is no Shard) split the tensor
        shards = math.prod(t.device_mesh.size(i) for i, p in enumerate(t.placements)
                           if not (p.is_replicate() or p.is_partial()))
        return tuple(t.shape), tuple(offset), tuple(shape), world_size() // shards
    return tuple(t.shape), (0,) * t.dim(), tuple(t.shape), world_size()


def to_local(t):
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def from_full(full: torch.Tensor, like) -> torch.Tensor:
    """`full` (the global tensor, on every rank) placed as `like` is: a
    DTensor holding this rank's piece, or `full` itself when `like` is
    plain."""
    from torch.distributed.tensor import DTensor

    if not isinstance(like, DTensor):
        return full
    _, offset, shape, _ = local_block(like)
    piece = full[tuple(slice(o, o + s) for o, s in zip(offset, shape))]
    local = piece.to(like.dtype).clone().contiguous()
    return DTensor.from_local(local, like.device_mesh, like.placements, run_check=False,
                              shape=like.shape, stride=like.stride())


class ShardLayout:
    """The local pieces of a set of parameters: global sums and means taken
    from the pieces, the piece of a replicated reduced tensor, and the
    global flat index of each local element."""

    def __init__(self, params: Dict[str, torch.Tensor]):
        self.blocks = {name: local_block(p) for name, p in params.items()}

    def shape(self, name):
        return self.blocks[name][0]

    def once(self, name, local_sum):
        """A local sum weighted so that a sum over all ranks counts each
        global element once."""
        return local_sum / self.blocks[name][3]

    @staticmethod
    def all_reduce(x: torch.Tensor) -> torch.Tensor:
        if world_size() > 1:
            x = x.clone()
            dist.all_reduce(x)
        return x

    def full_sum(self, name, local, dim: int) -> torch.Tensor:
        """The global tensor's sum over `dim`, replicated on every rank,
        from this rank's piece."""
        shape, offset, lshape, replicas = self.blocks[name]
        keep = [i for i in range(len(shape)) if i != dim]
        out = torch.zeros([shape[i] for i in keep], dtype=local.dtype, device=local.device)
        part = local.sum(dim=dim)
        out[tuple(slice(offset[i], offset[i] + lshape[i]) for i in keep)] = part
        return self.all_reduce(out) / replicas

    def piece(self, name, full_reduced: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's piece of a replicated tensor of the parameter's shape
        without `dim`."""
        shape, offset, lshape, _ = self.blocks[name]
        keep = [i for i in range(len(shape)) if i != dim]
        return full_reduced[tuple(slice(offset[i], offset[i] + lshape[i]) for i in keep)]

    def flat_index(self, name, device) -> torch.Tensor:
        """int64 global row-major index of each element of the local piece."""
        shape, offset, lshape, _ = self.blocks[name]
        index = torch.zeros((), dtype=torch.int64, device=device)
        stride = 1
        for i in reversed(range(len(shape))):
            ax = torch.arange(offset[i], offset[i] + lshape[i], dtype=torch.int64, device=device)
            index = index + (ax * stride).reshape((-1,) + (1,) * (len(shape) - 1 - i))
            stride *= shape[i]
        return index.expand(lshape) if lshape else index

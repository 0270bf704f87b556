"""Process bootstrap and the (data, model) device mesh (counterpart of
`lumina_t2x_tpu/parallel/mesh.py`).

`distributed_init` reads torchrun's environment (`RANK`, `WORLD_SIZE`,
`LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`) and starts the default process
group: NCCL for a `cuda` device, gloo for `cpu`. Without that environment it
does nothing, as the JAX function does without a coordinator address.

`create_mesh` builds a `DeviceMesh` with the `data` and `model` axes, the
model axis innermost: the ranks of one tensor-parallel group are adjacent
(one host's NVLink peers under torchrun's rank order).

Batches: every rank reads the global batch of a step and keeps its own rows
(`shard_batch`), so a run at any world size takes the steps a one-process run
takes, up to the order of the reductions. `form_global_batch` wraps the
rows a rank holds as a `DTensor` of the global batch, for code that wants the
global view.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch
import torch.distributed as dist

AXIS_DATA = "data"
AXIS_MODEL = "model"


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def distributed_init(device="cuda") -> bool:
    """Start the default process group from torchrun's environment; True
    when a group exists afterwards. A `cuda` device gets NCCL and its rank's
    card (`LOCAL_RANK`), a `cpu` device gloo. No environment: no-op (False)."""
    if is_distributed():
        return True
    if not all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")):
        return False
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("error: --device cuda but torch.cuda.is_available() is false")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for device {device}")
    dist.init_process_group(backend, rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return True


def local_device(device="cuda") -> torch.device:
    """This rank's device: its card (`LOCAL_RANK`) for `cuda`, else `device`."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return device


def create_mesh(model_parallel_size: int = 1):
    """The (data, model) `DeviceMesh` over every rank of the default group,
    `world / model_parallel_size` by `model_parallel_size`."""
    n = world_size()
    assert n % model_parallel_size == 0, (
        f"{n} devices not divisible by model_parallel_size={model_parallel_size}")
    if not is_distributed():
        raise RuntimeError("create_mesh needs a process group: launch with torchrun "
                           "(or call distributed_init with its environment set)")
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n // model_parallel_size, model_parallel_size),
                            mesh_dim_names=(AXIS_DATA, AXIS_MODEL))


def axis_group(mesh, axis: Optional[str]):
    """The process group of one mesh axis; the whole world without a mesh."""
    if mesh is None:
        if not is_distributed():
            raise RuntimeError("sharding over ranks needs a process group: launch with "
                               "torchrun (or call distributed_init with its environment set)")
        return dist.group.WORLD
    return mesh.get_group(axis) if axis is not None else mesh.get_group()


def axis_rank(mesh, axis: str) -> int:
    return mesh.get_local_rank(axis) if mesh is not None else rank()


def axis_size(mesh, axis: str) -> int:
    return mesh[axis].size() if mesh is not None else world_size()


def batch_sharding(mesh):
    """Placements of a batch: leading dim over `data`, replicated over `model`."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if name == AXIS_DATA else Replicate() for name in mesh.mesh_dim_names]


def replicated_sharding(mesh):
    from torch.distributed.tensor import Replicate

    return [Replicate() for _ in mesh.mesh_dim_names]


def shard_rows(x: torch.Tensor, index: int, count: int, micro_batches: int = 1) -> torch.Tensor:
    """Rank `index` of `count`'s rows of a global batch. Each of the
    `micro_batches` consecutive row blocks is split into `count` parts and
    the rank keeps part `index` of each, so that its micro-batch i holds its
    part of global micro-batch i; with one micro-batch these are rows
    index*b ... (index+1)*b - 1, b = rows / count."""
    rows = x.shape[0]
    if rows % (count * micro_batches):
        raise ValueError(f"a batch of {rows} rows does not split into {micro_batches} "
                         f"micro-batches over {count} data ranks")
    return x.reshape(micro_batches, count, rows // (count * micro_batches),
                     *x.shape[1:])[:, index].reshape(-1, *x.shape[1:])


def shard_batch(batch: Dict[str, torch.Tensor], mesh, micro_batches: int = 1) -> Dict:
    """This rank's rows (`shard_rows` over the data axis) of every tensor of
    a global batch; other values pass through."""
    index, count = axis_rank(mesh, AXIS_DATA), axis_size(mesh, AXIS_DATA)
    return {k: shard_rows(v, index, count, micro_batches) if isinstance(v, torch.Tensor) else v
            for k, v in batch.items()}


def form_global_batch(mesh, local_batch: Dict[str, torch.Tensor]) -> Dict:
    """The DTensor view of the global batch whose rows this rank holds in
    `local_batch` (rows over `data`, replicated over `model`); no copy."""
    from torch.distributed.tensor import DTensor

    placements = batch_sharding(mesh)
    n = axis_size(mesh, AXIS_DATA)
    return {k: DTensor.from_local(v, mesh, placements, run_check=False,
                                  shape=(v.shape[0] * n, *v.shape[1:]),
                                  stride=v.contiguous().stride())
            for k, v in local_batch.items()}

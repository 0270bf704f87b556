"""Two real processes through the port's multi-GPU path, on gloo CPU ranks
(counterpart of `exps/multiprocess_dryrun.py` of the JAX package):

  - torchrun's environment starts the process group (`parallel.distributed_init`);
  - each rank reads the global batch and keeps its rows (`parallel.mesh.shard_batch`,
    `form_global_batch` gives the global view);
  - ONE sharded train step: the Tiny NextDiT-ImageNet sharded TP2 x FSDP2 over a
    (data 1, model 2) mesh, grad clip, AdamW, EMA (`train_lib.make_train_step` over the mesh);
  - a collective checkpoint save (gathered whole, rank 0 writes the
    one-process layout) and a restore into a fresh sharded state (rank 0
    reads, `broadcast_state`, then sharded again);
  - a second step from the restored state.

Both ranks must report the same losses and grad norms (the metrics are
reduced over the world), and the restored parameters must equal the saved
ones. Prints one JSON line.

    python -m lumina_t2x_tpu_torch.exps.multiprocess_dryrun
"""

from __future__ import annotations

import json
import sys
import tempfile

import torch


def _state(device):
    from ..models.next_dit_imagenet import NextDiT_ImageNet_Tiny_patch2
    from ..pipelines.train_lib import create_optimizer, create_train_state

    torch.manual_seed(0)
    model = NextDiT_ImageNet_Tiny_patch2(num_classes=8, device=device)
    optimizer = create_optimizer(1e-3, 0.01)
    return model, optimizer, create_train_state(model, optimizer)


def worker(results_dir: str):
    """One rank: step, save, restore, step. Returns its metrics."""
    import torch.distributed as dist

    from ..core.checkpoint import (broadcast_state, find_auto_resume, full_tree, load_checkpoint,
                                   save_checkpoint)
    from ..parallel.mesh import create_mesh, form_global_batch, shard_batch
    from ..parallel.sharding import parallelize
    from ..pipelines.train_lib import make_train_step, place_state
    from ..transport import create_transport

    mesh = create_mesh(model_parallel_size=2)
    transport = create_transport("Linear", "velocity", snr_type="lognorm")
    g = torch.Generator().manual_seed(42)
    batch = {"x": torch.randn((8, 4, 16, 16), generator=g), "y": torch.arange(8) % 8}
    local = shard_batch(batch, mesh)
    assert tuple(form_global_batch(mesh, local)["x"].shape) == (8, 4, 16, 16)

    def sharded(state, model, optimizer):
        broadcast_state(state)
        parallelize(model, mesh, fsdp=True)
        state = place_state(state)
        step = make_train_step(model, transport, optimizer, lambda b: {"y": b["y"]},
                               grad_clip=2.0, mesh=mesh, fsdp=True)
        return state, step

    model, optimizer, state = _state("cpu")
    state, step = sharded(state, model, optimizer)
    state, m1 = step(state, batch, 0)
    save_checkpoint(results_dir, state.step, state)
    saved = full_tree(dict(model.state_dict()))

    model2, optimizer2, state2 = _state("cpu")
    path = find_auto_resume(results_dir)
    if dist.get_rank() == 0:
        state2 = load_checkpoint(path, state2)
    state2, step2 = sharded(state2, model2, optimizer2)
    restored = full_tree(dict(model2.state_dict()))
    exact = all(torch.equal(saved[k], restored[k]) for k in saved)
    state2, m2 = step2(state2, batch, 0)
    return {"rank": dist.get_rank(), "losses": [m1["loss"], m2["loss"]],
            "grad_norms": [m1["grad_norm"], m2["grad_norm"]], "restore_exact": exact,
            "step": state2.step}


def main(argv=None):
    from ..parallel import gloo_world

    with tempfile.TemporaryDirectory() as results:
        ranks = gloo_world.run(2, [("lumina_t2x_tpu_torch.exps.multiprocess_dryrun:worker",
                                    dict(results_dir=results))])
    per_rank = [r[0] for r in ranks]
    ok = (all(r["restore_exact"] and r["step"] == 2 for r in per_rank)
          and per_rank[0]["losses"] == per_rank[1]["losses"]
          and per_rank[0]["grad_norms"] == per_rank[1]["grad_norms"])
    print(json.dumps({"ok": ok, "ranks": per_rank}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

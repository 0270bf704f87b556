"""Run functions of the port on a world of gloo CPU ranks: each rank is a
process of its own (`python -m lumina_t2x_tpu_torch.parallel.gloo_world`)
with torchrun's environment, one thread, a free localhost port, and no
TensorBoard.

`run(world, calls)` starts the world once for a list of calls, each
("module:function", kwargs), runs them in order on every rank (all ranks
must call the same collectives) and returns, per rank, the list of what the
functions returned. Arguments and results travel in `torch.save` files, so
they hold tensors, numpy arrays and plain Python values. The functions the
port's multi-rank tests call live in `parallel/gloo_cases.py`.
"""

from __future__ import annotations

import argparse
import importlib
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Sequence, Tuple

import torch

_REPO = Path(__file__).resolve().parents[2]


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run(world: int, calls: Sequence[Tuple[str, Dict[str, Any]]],
        timeout: float = 300.0) -> List[List[Any]]:
    """Per rank, the results of `calls` run on a gloo world of `world` ranks.
    A rank that fails ends the world at once (the others would wait for it
    in a collective), and so does the timeout."""
    with tempfile.TemporaryDirectory() as io_dir:
        torch.save(list(calls), os.path.join(io_dir, "calls.pt"))
        port = str(free_port())
        procs, logs = [], []
        for r in range(world):
            env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                       LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost", MASTER_PORT=port,
                       OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                       PYTHONPATH=os.pathsep.join([str(_REPO), os.environ.get("PYTHONPATH", "")]))
            logs.append(open(os.path.join(io_dir, f"rank{r}.log"), "wb"))
            procs.append(subprocess.Popen([sys.executable, "-m", __name__, io_dir], env=env,
                                          cwd=str(_REPO), stdout=logs[-1],
                                          stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in procs):
                if any(p.returncode for p in procs) or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        if failed:
            r = next((r for r in failed if procs[r].returncode > 0), failed[0])
            with open(os.path.join(io_dir, f"rank{r}.log"), errors="replace") as f:
                tail = f.read()[-6000:]
            raise RuntimeError(f"gloo rank {r} of {world} exited {procs[r].returncode}:\n" + tail)
        return [torch.load(os.path.join(io_dir, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]


def run_worlds(jobs: Dict[Any, Tuple[int, Sequence]], timeout: float = 300.0) -> Dict:
    """`run` for several worlds at once: key -> (world, calls) gives key ->
    per-rank results; the worlds start together."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {key: pool.submit(run, world, calls, timeout)
                   for key, (world, calls) in jobs.items()}
        return {key: f.result() for key, f in futures.items()}


def _call(target: str, kwargs):
    module, name = target.split(":")
    return getattr(importlib.import_module(module), name)(**kwargs)


def main(argv=None):
    p = argparse.ArgumentParser(description="one gloo rank of parallel.gloo_world.run")
    p.add_argument("io_dir")
    args = p.parse_args(argv)
    torch.set_num_threads(1)
    # the ranks write metrics without TensorBoard (`core.logging.MetricsWriter`
    # makes it optional): importing it loads TensorFlow, ~20 s a rank
    sys.modules["torch.utils.tensorboard"] = None
    import torch.distributed as dist

    from .mesh import distributed_init

    distributed_init("cpu")
    calls = torch.load(os.path.join(args.io_dir, "calls.pt"), weights_only=False)
    results = []
    for target, kwargs in calls:
        results.append(_call(target, kwargs))
        dist.barrier()
    torch.save(results, os.path.join(args.io_dir, f"rank{dist.get_rank()}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()

"""GPipe pipeline parallelism over a process group (counterpart of
`lumina_t2x_tpu/parallel/pipeline.py`).

The layer-stacked parameters split into S contiguous stages, one per rank of
the group (`split_stages`; `stage_shardings` keeps rank s's slice). Every
rank runs the same schedule of M + S - 1 ticks: at tick t it runs microbatch
t - stage (a bubble tick runs a clamped microbatch whose output is masked
out), then the activations move stage -> stage + 1 by `batch_isend_irecv`
on a ring. After the last tick the last stage holds the M outputs, which a
sum over the group hands to every rank.

P2P has no autograd, so the ring shift is an `autograd.Function` whose
backward sends the gradient the other way; the final hand-out is a sum
whose backward is the identity (every rank's loss is the same replicated
function of the outputs). Gradients therefore reach every stage's
parameters on its own rank.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from .comm import sum_replicated


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def split_stages(stacked_params, n_stages: int):
    """Reshape layer-stacked tensors (L, ...) -> (S, L // S, ...)."""

    def f(x):
        layers = x.shape[0]
        assert layers % n_stages == 0, f"{layers} layers not divisible by {n_stages} stages"
        return x.reshape(n_stages, layers // n_stages, *x.shape[1:])

    return _map(f, stacked_params)


def merge_stages(staged_params):
    """Inverse of split_stages: (S, L // S, ...) -> (L, ...)."""
    return _map(lambda x: x.reshape(x.shape[0] * x.shape[1], *x.shape[2:]), staged_params)


def stage_shardings(staged_params, group=None):
    """Each rank's stage slice (1, L // S, ...) of the staged tensors: the
    placement `gpipe_spmd`'s apply takes."""
    r = dist.get_rank(group)
    return _map(lambda x: x[r:r + 1], staged_params)


def _shift(x, group, step: int):
    """Send x to the rank `step` places on in the ring; receive from `step`
    places back."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    out = torch.empty_like(x)
    to = dist.get_global_rank(group, (r + step) % n) if group is not None else (r + step) % n
    frm = dist.get_global_rank(group, (r - step) % n) if group is not None else (r - step) % n
    ops = [dist.P2POp(dist.isend, x.contiguous(), to, group),
           dist.P2POp(dist.irecv, out, frm, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingShift(torch.autograd.Function):
    """Forward: stage -> stage + 1. Backward: the gradient stage + 1 -> stage."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.group, -1), None


def gpipe_spmd(stage_fn: Callable, group=None):
    """Build a pipelined apply over `group` (one stage per rank).

    stage_fn(stage_params, x, *per_mb, *broadcast) -> y runs one stage (its
    L // S layers) on one microbatch.

    Returns apply(stage_params, xs, per_mb=(), broadcast=()) -> ys where
    stage_params is this rank's slice with a leading stage axis of 1
    (`stage_shardings`), xs (M, mb, ...) the microbatches (the same on every
    rank), per_mb tensors with a leading (M, ...) axis, each stage seeing the
    slice of the microbatch it runs, and broadcast tensors every stage sees
    whole. ys has xs's layout and is the same on every rank."""

    def apply(stage_params, xs, per_mb=(), broadcast=()):
        group_ = group if group is not None else dist.group.WORLD
        n = dist.get_world_size(group)
        stage = dist.get_rank(group)
        params = _map(lambda x: x[0], stage_params)
        m = xs.shape[0]
        ticks = m + n - 1
        state = torch.zeros_like(xs[0])
        outs = [None] * m
        for t in range(ticks):
            # stage 0 reads microbatch t; `0 * state` keeps the received
            # tensor in its graph, so every rank runs every shift's backward
            # in the same order
            inp = xs[min(t, m - 1)] + 0 * state if stage == 0 else state
            mb = min(max(t - stage, 0), m - 1)
            args = tuple(_map(lambda a: a[mb], p) for p in per_mb)
            y = stage_fn(params, inp, *args, *broadcast)
            out_idx = t - (n - 1)
            if stage == n - 1 and out_idx >= 0:
                outs[out_idx] = y
            if t < ticks - 1:
                state = _RingShift.apply(y, group) if n > 1 else y
        # the last stage hands its outputs to every rank; elsewhere the last
        # tick's output joins with weight 0, so the backward reaches this
        # rank's stage
        ys = torch.stack(outs) if stage == n - 1 else torch.zeros_like(xs) + 0 * y
        return sum_replicated(ys, group_)

    return apply

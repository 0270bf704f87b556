"""Training-step machinery (counterpart of
`lumina_t2x_tpu/pipelines/train_lib.py`): the train state, AdamW with optax's
math and order, the fused AdamW+EMA and Adafactor+EMA passes with stochastic
rounding, the trainer-side static-max calibration and the train step (loss,
backward, fp32 grad norm and clip, non-finite skip, micro-batch accumulation
in `grad_dtype`, optimizer, EMA).

Parameters live in the `nn.Module`; the EMA and the optimizer state are
dicts keyed by the parameter names (the reference state-dict keys). Every
update runs in place under `torch.no_grad()`, one tensor at a time, so the
same code runs on the CPU and on the card (no fused CUDA optimizer).

Random draws: a step's training times and noise come from a
`torch.Generator` seeded from (seed, step), or are handed in as tensors
(`draws`), which is how the tests give the port the JAX step's draws.
"""

from __future__ import annotations

import math
import os
import re
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.attention import resolve_impl
from ..ops.flash_attention import set_flash_static_max_train, streams_kv
from ..transport.transport import Transport

_M32 = 0xFFFFFFFF


@dataclass
class TrainState:
    step: int
    model: nn.Module
    ema: Dict[str, torch.Tensor]
    opt_state: Dict[str, Any]


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _count_tensor(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


def _adam_moments(params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    device = next(iter(params.values())).device
    return {"count": _count_tensor(device),
            "mu": {n: torch.zeros_like(p) for n, p in params.items()},
            "nu": {n: torch.zeros_like(p) for n, p in params.items()}}


class AdamW:
    """`optax.adamw(lr, b1=0.9, b2=0.999, weight_decay=wd)` with an optional
    `optax.linear_schedule(0, lr, warmup_steps)`, in optax's order: clip
    scale on the grads, Adam moments with bias correction, decoupled weight
    decay, learning-rate scale, `apply_updates`, then the EMA (the JAX train
    step's non-fused branch). The reference's `torch.optim.AdamW(lr, wd)`."""

    def __init__(self, lr: float = 1e-4, weight_decay: float = 0.0, warmup_steps: int = 0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.weight_decay, self.warmup_steps = lr, weight_decay, warmup_steps
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params):
        state = _adam_moments(params)
        if self.warmup_steps > 0:  # optax's ScaleByScheduleState
            state["schedule_count"] = _count_tensor(state["count"].device)
        return state

    def _lr(self, state):
        if self.warmup_steps <= 0:
            return _f32(self.lr)
        # polynomial_schedule(power=1): (init - end) * (1 - frac) + end
        count = state["schedule_count"].float().cpu().clamp(0, self.warmup_steps)
        frac = 1.0 - count / self.warmup_steps
        return _f32(-self.lr) * frac + self.lr

    @torch.no_grad()
    def step(self, grads, params, state, ema, ema_decay: float, scale, grad_dtype=None,
             generator=None):
        del generator
        count = state["count"] + 1
        dev = count.device
        b1c = (1.0 - _f32(self.b1) ** count.cpu().float()).to(dev)
        b2c = (1.0 - _f32(self.b2) ** count.cpu().float()).to(dev)
        neg_lr = (-self._lr(state)).to(dev)
        for name, p in params.items():
            g = grads[name]
            g = (g.float() * scale).to(g.dtype)
            if grad_dtype is not None:  # optimizer math stays in param precision
                g = g.to(p.dtype)
            mu, nu = state["mu"][name], state["nu"][name]
            mu.copy_((1.0 - self.b1) * g + self.b1 * mu)
            nu.copy_((1.0 - self.b2) * (g * g) + self.b2 * nu)
            update = (mu / b1c) / (torch.sqrt(nu / b2c) + self.eps)
            update = update + self.weight_decay * p
            p.copy_(p + neg_lr * update)
            e = ema[name]
            e.copy_(e * ema_decay + (1.0 - ema_decay) * p)
        state["count"] = count
        if "schedule_count" in state:
            state["schedule_count"] = state["schedule_count"] + 1


def create_optimizer(lr: float = 1e-4, weight_decay: float = 0.0, warmup_steps: int = 0):
    """AdamW matching the reference's `torch.optim.AdamW(lr, wd)`, with
    optional linear warmup (the JAX package's `create_optimizer`)."""
    return AdamW(lr, weight_decay, warmup_steps)


class FusedAdamWEMA:
    """Single-pass AdamW + EMA: one read-modify-write per parameter tensor
    (reads g, m, v, p, ema; writes m, v, p, ema) with the grad-clip scale
    folded in. Same math as `AdamW`; warmup as `lr * min(1, (count - 1) /
    warmup_steps)`. The state has `AdamW`'s layout without warmup."""

    def __init__(self, lr: float = 1e-4, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0, warmup_steps: int = 0):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.weight_decay, self.warmup_steps = weight_decay, warmup_steps

    def init(self, params):
        return _adam_moments(params)

    @torch.no_grad()
    def step(self, grads, params, state, ema, ema_decay: float, scale, grad_dtype=None,
             generator=None):
        del grad_dtype, generator
        count = state["count"] + 1
        countf, dev = count.cpu().float(), count.device
        lr = _f32(self.lr)
        if self.warmup_steps > 0:
            lr = self.lr * torch.clamp((countf - 1) / self.warmup_steps, max=1.0)
        lr = lr.to(dev)
        b1c = (1.0 - _f32(self.b1) ** countf).to(dev)
        b2c = (1.0 - _f32(self.b2) ** countf).to(dev)
        for name, p in params.items():
            m, v, e = state["mu"][name], state["nu"][name], ema[name]
            g32 = grads[name].float() * scale
            m2 = self.b1 * m + (1.0 - self.b1) * g32
            v2 = self.b2 * v + (1.0 - self.b2) * g32 * g32
            step_dir = (m2 / b1c) / (torch.sqrt(v2 / b2c) + self.eps)
            p2 = p - lr * (step_dir + self.weight_decay * p)
            e.copy_(e * ema_decay + (1.0 - ema_decay) * p2)
            p.copy_(p2)
            m.copy_(m2)
            v.copy_(v2)
        state["count"] = count


# -- stochastic rounding -----------------------------------------------------------


def _sr_noise_bits(key: Sequence[int], shape, device=None) -> torch.Tensor:
    """uint32 noise (held in int64) for stochastic rounding: the murmur3
    fmix32 hash of (element index ^ key[0]), xor key[-1] (the JAX package's
    `_sr_noise_bits` in `hash` mode, bit for bit, for the same two key
    words). Computed in int64 masked to 32 bits: torch's uint32 lacks the
    arithmetic."""
    first, last = int(key[0]) & _M32, int(key[-1]) & _M32
    n = math.prod(int(s) for s in shape)
    h = torch.arange(max(n, 1), dtype=torch.int64, device=device) ^ first
    h = ((h ^ (h >> 16)) * 0x85EBCA6B) & _M32
    h = ((h ^ (h >> 13)) * 0xC2B2AE35) & _M32
    h = h ^ (h >> 16) ^ last
    return h[:n].reshape(tuple(shape))


def _stochastic_round_bf16(x32: torch.Tensor, key: Sequence[int]) -> torch.Tensor:
    """Unbiased fp32 -> bf16 rounding: add uniform noise in [0, 1 ulp) to the
    low 16 mantissa bits, then truncate. E[result] == x32, so sub-ulp updates
    survive in a bf16 accumulator in expectation."""
    bits = x32.float().contiguous().view(torch.int32).to(torch.int64) & _M32
    noise = _sr_noise_bits(key, x32.shape, x32.device) & 0xFFFF
    hi = ((bits + noise) & _M32) >> 16
    hi = torch.where(hi >= 0x8000, hi - 0x10000, hi)
    return hi.to(torch.int16).view(torch.bfloat16)


# -- Adafactor ---------------------------------------------------------------------

_LAYER = re.compile(r"^layers\.\d+\.")


def _leaf_groups(names: Sequence[str]) -> List[List[str]]:
    """Parameter names grouped as the JAX package's leaves: `layers.<i>.X`
    for every i is one (stacked) leaf, every other name its own."""
    groups: Dict[str, List[str]] = {}
    for name in names:
        groups.setdefault(_LAYER.sub("layers.*.", name), []).append(name)
    return list(groups.values())


class FusedAdafactorEMA:
    """Single-pass Adafactor (+EMA): factored second moments (sublinear
    memory), the math of `optax.adafactor(learning_rate=lr,
    min_dim_size_to_factor, decay_rate=0.8, multiply_by_parameter_scale=True,
    clipping_threshold=1.0, momentum=None, weight_decay_rate=wd or None)` as
    the JAX package's `FusedAdafactorEMA` computes it: stats always fp32, and
    bf16 params/EMA written back with stochastic rounding.

    The JAX model stacks its layers, so there a leaf is (L, ...) and the
    update-clip RMS and the parameter scale are taken over all layers of a
    parameter together. The port keeps that: `layers.<i>.X` over i is one
    leaf for those two statistics, while the factored row/column statistics
    are per layer, over each torch weight's own two largest axes (the axes
    the JAX rule picks too while the layer count is below
    `min_dim_size_to_factor`; a square weight swaps the row/column roles,
    which `core.checkpoint.train_state_from_jax` undoes)."""

    def __init__(self, lr: float = 1e-4, decay_rate: float = 0.8,
                 clipping_threshold: float = 1.0, min_dim_size_to_factor: int = 128,
                 multiply_by_parameter_scale: bool = True, eps: float = 1e-30,
                 weight_decay: float = 0.0, warmup_steps: int = 0,
                 stochastic_rounding: bool = True):
        self.lr, self.decay_rate = lr, decay_rate
        self.clipping_threshold = clipping_threshold
        self.min_dim_size_to_factor = min_dim_size_to_factor
        self.multiply_by_parameter_scale = multiply_by_parameter_scale
        self.eps, self.weight_decay = eps, weight_decay
        self.warmup_steps = warmup_steps
        self.stochastic_rounding = stochastic_rounding

    def factored_dims(self, shape) -> Optional[Tuple[int, int]]:
        """(d1, d0): the two largest axes, both >= min_dim_size_to_factor,
        else None (stable argsort, as optax's `_factored_dims`)."""
        if len(shape) < 2:
            return None
        order = np.argsort(shape, kind="stable")
        if shape[order[-2]] < self.min_dim_size_to_factor:
            return None
        return int(order[-2]), int(order[-1])

    def init(self, params):
        device = next(iter(params.values())).device
        z1 = lambda: torch.zeros((1,), dtype=torch.float32, device=device)
        state = {"count": _count_tensor(device), "v_row": {}, "v_col": {}, "v": {}}
        for group in _leaf_groups(list(params)):
            if len(group) > 1 and len(group) >= self.min_dim_size_to_factor:
                raise ValueError(f"{len(group)} layers >= min_dim_size_to_factor "
                                 f"{self.min_dim_size_to_factor}: the JAX rule would factor "
                                 "over the layer axis")
            for name in group:
                shape = tuple(params[name].shape)
                fd = self.factored_dims(shape)
                f32 = dict(dtype=torch.float32, device=device)
                if fd is None:
                    state["v_row"][name], state["v_col"][name] = z1(), z1()
                    state["v"][name] = torch.zeros(shape, **f32)
                else:
                    d1, d0 = fd
                    state["v_row"][name] = torch.zeros(
                        tuple(s for i, s in enumerate(shape) if i != d0), **f32)
                    state["v_col"][name] = torch.zeros(
                        tuple(s for i, s in enumerate(shape) if i != d1), **f32)
                    state["v"][name] = z1()
        return state

    @torch.no_grad()
    def step(self, grads, params, state, ema, ema_decay: float, scale, grad_dtype=None,
             generator=None):
        """In-place update of params, stats and EMA. `generator` (CPU) draws
        the stochastic-rounding key words of bf16 stores; without one they
        round to nearest."""
        del grad_dtype
        count = state["count"] + 1
        countf, dev = count.cpu().float(), count.device
        dec = (1.0 - countf ** (-self.decay_rate)).to(dev)
        lr = _f32(self.lr)
        if self.warmup_steps > 0:
            lr = self.lr * torch.clamp((countf - 1) / self.warmup_steps, max=1.0)
        lr = lr.to(dev)
        for group in _leaf_groups(list(params)):
            updates = {}
            for name in group:
                g32 = grads[name].float() * scale
                gsq = g32 * g32 + self.eps
                fd = self.factored_dims(tuple(params[name].shape))
                if fd is not None:
                    d1, d0 = fd
                    vr, vc = state["v_row"][name], state["v_col"][name]
                    vr.copy_(dec * vr + (1.0 - dec) * gsq.mean(dim=d0))
                    vc.copy_(dec * vc + (1.0 - dec) * gsq.mean(dim=d1))
                    reduced_d1 = d1 - 1 if d1 > d0 else d1
                    row_factor = (vr / vr.mean(dim=reduced_d1, keepdim=True)) ** -0.5
                    col_factor = vc ** -0.5
                    updates[name] = g32 * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
                else:
                    v = state["v"][name]
                    v.copy_(dec * v + (1.0 - dec) * gsq)
                    updates[name] = g32 * v ** -0.5
            n = sum(params[name].numel() for name in group)
            if self.clipping_threshold is not None:
                rms = torch.sqrt(sum((u * u).sum() for u in updates.values()) / n)
                clip_denom = torch.clamp(rms / self.clipping_threshold, min=1.0)
            if self.multiply_by_parameter_scale:
                p_rms = torch.sqrt(sum((params[name].float() ** 2).sum() for name in group) / n)
                p_scale = torch.clamp(p_rms, min=1e-3)
            for name in group:
                p, e = params[name], ema[name]
                p32 = p.float()
                u = updates.pop(name)
                if self.clipping_threshold is not None:
                    u = u / clip_denom
                u = u * lr
                if self.multiply_by_parameter_scale:
                    u = u * p_scale
                if self.weight_decay:
                    u = u + self.weight_decay * p32
                p2 = p32 - u
                e2 = e.float() * ema_decay + (1.0 - ema_decay) * p2
                p.copy_(self._store(p2, p, generator))
                e.copy_(self._store(e2, e, generator))
        state["count"] = count

    def _store(self, x32, like, generator):
        if like.dtype == torch.bfloat16 and self.stochastic_rounding and generator is not None:
            key = torch.randint(0, 1 << 32, (2,), generator=generator, dtype=torch.int64)
            return _stochastic_round_bf16(x32, key.tolist())
        return x32.to(like.dtype)


# -- calibration ---------------------------------------------------------------------


@torch.no_grad()
def autocalibrate_flash_static_max_train(
    model, batch: Dict[str, torch.Tensor], cond_kwargs_fn: Callable[[Dict], Dict],
    probe_ts=(0.02, 0.25, 0.5, 0.75, 0.98), margin: float = 8.0, spread_limit: float = 60.0,
    x0: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None,
    path_sampler=None,
) -> Optional[float]:
    """Trainer-side static-max calibration: probe the model at the first
    batch's shapes across the t range the samplers cover, with the
    transport's interpolant between the noise `x0` (drawn from `generator`
    when None) and the batch, read each streaming self-attention site's
    (max, min) row LSE through the model's `lse_recorder`, and install
    `bound = max(lse) + margin` in the train slot (`set_flash_static_max_train`),
    which both the forward and the remat recompute of a train step read.
    Returns None, leaving the online-max LSE forward in place, when the
    `LUMINA_FLASH_STATIC_MAX_TRAIN` env var pins a bound,
    `LUMINA_FLASH_STATIC_MAX_AUTO=0`, the model has no qk-norm or does not
    use the flash impl, the self-attention does not stream (<= 1024 tokens),
    or the measured spread exceeds `spread_limit`."""
    if os.environ.get("LUMINA_FLASH_STATIC_MAX_TRAIN", ""):
        return None
    if os.environ.get("LUMINA_FLASH_STATIC_MAX_AUTO", "1") == "0":
        return None
    set_flash_static_max_train(None)
    if not getattr(model, "qk_norm", False):
        return None
    if resolve_impl(getattr(model, "attn_impl", "auto")) != "flash":
        return None
    x1 = batch["x"]
    if not streams_kv((x1.shape[-2] // model.patch_size) * (x1.shape[-1] // model.patch_size)):
        return None
    if x0 is None:
        x0 = torch.randn(x1.shape, generator=generator, device=x1.device)
    gmax, gmin = -math.inf, math.inf
    for t_scalar in probe_ts:
        t = torch.full((x1.shape[0],), float(t_scalar), dtype=torch.float32, device=x1.device)
        if path_sampler is not None:
            xt, _ = path_sampler.interpolant(t, x0, x1)
        else:
            texp = t.reshape((-1,) + (1,) * (x1.dim() - 1))
            xt = texp * x1 + (1.0 - texp) * x0
        recorder: List[torch.Tensor] = []
        model(xt, t, train=True, lse_recorder=recorder, **cond_kwargs_fn(batch))
        if not recorder:
            return None
        ranges = torch.stack(recorder)
        gmax = max(gmax, float(ranges[:, 0].max()))
        gmin = min(gmin, float(ranges[:, 1].min()))
    if not math.isfinite(gmax) or not math.isfinite(gmin) or gmax - gmin > spread_limit:
        return None
    bound = gmax + margin
    set_flash_static_max_train(bound)
    return bound


# -- state and step --------------------------------------------------------------------


def create_train_state(model: nn.Module, optimizer) -> TrainState:
    """Step 0, the model's parameters, an EMA copy and the optimizer state."""
    params = dict(model.named_parameters())
    return TrainState(step=0, model=model,
                      ema={n: p.detach().clone() for n, p in params.items()},
                      opt_state=optimizer.init({n: p.detach() for n, p in params.items()}))


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one train step's draws, from (seed, step): a resumed
    run draws what an uninterrupted one would."""
    return torch.Generator(device=device).manual_seed((int(seed) << 32) + int(step))


def make_train_step(
    model: nn.Module,
    transport: Transport,
    optimizer,
    cond_kwargs_fn: Callable[[Dict], Dict],
    grad_clip: float = 2.0,
    ema_decay: float = 0.9999,
    micro_batches: int = 1,
    loss_mask_fn: Optional[Callable[[Dict], Any]] = None,
    grad_dtype: Optional[torch.dtype] = None,
):
    """Build `train_step(state, batch, seed, draws=None) -> (state, metrics)`.

    cond_kwargs_fn(batch) -> model keywords beyond (x, t), e.g.
    {"cap_feats": ..., "cap_mask": ...}. Gradients are cast to `grad_dtype`
    right after each backward, and micro-batch accumulation runs in it; the
    grad norm, the clip and the optimizer run in fp32. A step whose loss or
    grad norm is not finite leaves params, optimizer state (count included)
    and EMA untouched and reports `skipped` = 1; the step counter advances
    either way. `draws`: optional list, one (t, x0) pair per micro-batch,
    replacing the generator's draws."""
    params = dict(model.named_parameters())
    names, leaves = list(params), list(params.values())

    def compute_grads(batch, generator, draw):
        def model_fn(xt, t):
            return model(xt, t, train=True, **cond_kwargs_fn(batch))

        t, x0 = draw if draw is not None else (None, None)
        loss_mask = loss_mask_fn(batch) if loss_mask_fn else None
        terms = transport.training_losses(model_fn, batch["x"], loss_mask=loss_mask,
                                          generator=generator, t=t, x0=x0)
        loss = terms["loss"].mean()
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]
        if grad_dtype is not None:
            grads = [g.to(grad_dtype) for g in grads]
        return loss.detach(), grads

    def local_grads(batch, generator, draws):
        if micro_batches == 1:
            return compute_grads(batch, generator, draws[0] if draws else None)
        acc, loss_sum = None, 0.0
        for i in range(micro_batches):
            mb = {k: v.reshape(micro_batches, -1, *v.shape[1:])[i] for k, v in batch.items()}
            loss, grads = compute_grads(mb, generator, draws[i] if draws else None)
            acc = grads if acc is None else [a + g for a, g in zip(acc, grads)]
            loss_sum = loss_sum + loss
        return loss_sum / micro_batches, [a / micro_batches for a in acc]

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor], seed: int,
                   draws: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None):
        device = batch["x"].device
        generator = step_generator(seed, state.step, device)
        loss, grads = local_grads(batch, generator, draws)
        # fp32 norm and clip at any grad_dtype
        grad_norm = torch.sqrt(torch.stack([g.float().pow(2).sum() for g in grads]).sum())
        if grad_clip is not None and grad_clip > 0:
            scale = torch.clamp(grad_clip / (grad_norm + 1e-6), max=1.0)
        else:
            scale = torch.ones((), device=device)
        skipped = not (bool(torch.isfinite(grad_norm)) and bool(torch.isfinite(loss)))
        if not skipped:
            sr_generator = step_generator(seed, state.step, "cpu")
            optimizer.step(dict(zip(names, grads)), params, state.opt_state, state.ema,
                           ema_decay, scale, grad_dtype=grad_dtype, generator=sr_generator)
        state.step += 1
        return state, {"loss": float(loss), "grad_norm": float(grad_norm),
                       "skipped": int(skipped)}

    return train_step

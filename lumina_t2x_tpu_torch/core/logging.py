"""Logging and metrics (counterpart of `lumina_t2x_tpu/core/logging.py`):
a stdout + `log.txt` logger, a `metrics.jsonl` scalar stream (TensorBoard too
when importable) and a throughput meter that waits for the device."""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional

import torch


def create_logger(logging_dir: Optional[str] = None, is_lead: bool = True) -> logging.Logger:
    """stdout + log.txt logger on the lead process."""
    logger = logging.getLogger("lumina")
    logger.handlers.clear()
    if is_lead:
        logger.setLevel(logging.INFO)
        fmt = logging.Formatter("[%(asctime)s] %(message)s", datefmt="%Y-%m-%d %H:%M:%S")
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        if logging_dir:
            os.makedirs(logging_dir, exist_ok=True)
            fh = logging.FileHandler(os.path.join(logging_dir, "log.txt"))
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    else:
        logger.setLevel(logging.ERROR)
    return logger


class MetricsWriter:
    """Scalar stream -> metrics.jsonl (+ TensorBoard if importable)."""

    def __init__(self, logdir: str, is_lead: bool = True):
        self.is_lead = is_lead
        self._jsonl = None
        self._tb = None
        if is_lead:
            os.makedirs(logdir, exist_ok=True)
            self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:  # tensorboard is optional
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(logdir)

    def write(self, step: int, scalars: Dict[str, float]):
        if not self.is_lead:
            return
        rec = {"step": int(step), **{k: float(v) for k, v in scalars.items()}}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), int(step))

    def close(self):
        if self._jsonl:
            self._jsonl.close()
        if self._tb:
            self._tb.close()


class Throughput:
    """secs/step + items/sec meter; `step(..., device=...)` first waits for
    the CUDA device (`torch.cuda.synchronize`), where the JAX meter blocks on
    an array."""

    def __init__(self):
        self._t0 = time.perf_counter()

    def start(self):
        self._t0 = time.perf_counter()

    def step(self, n_items: int, device: Optional[torch.device] = None) -> Dict[str, float]:
        if device is not None and device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - self._t0
        out = {"secs_per_step": dt, "items_per_sec": n_items / dt if dt > 0 else 0.0}
        self._t0 = time.perf_counter()
        return out

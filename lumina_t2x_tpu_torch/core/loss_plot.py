"""Training-log loss curves (counterpart of `lumina_t2x_tpu/core/loss_plot.py`
plus the SVG plot of `exps/soak_train.py`): `scrape_log` parses the
trainer's `"(step=N) Train Loss: X"` lines, `read_metrics_jsonl` its
metrics.jsonl, `compare_runs` reads several runs, and `svg_line_plot` draws
a dependency-free SVG polyline (no matplotlib on the card machine).
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Tuple

_LINE_RE = re.compile(r"\(step=(\d+)\) Train Loss: ([0-9.eE+-]+)")


def scrape_log(path: str) -> Tuple[List[int], List[float]]:
    """Parse (steps, losses) from a trainer log.txt (`init_loss.py:7-52`)."""
    steps, losses = [], []
    with open(path) as f:
        for line in f:
            m = _LINE_RE.search(line)
            if m:
                steps.append(int(m.group(1)))
                losses.append(float(m.group(2)))
    return steps, losses


def read_metrics_jsonl(path: str, key: str = "train/loss") -> Tuple[List[int], List[float]]:
    steps, vals = [], []
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if key in rec:
                steps.append(rec["step"])
                vals.append(rec[key])
    return steps, vals


def compare_runs(run_dirs: Dict[str, str], key: str = "train/loss") -> Dict[str, Tuple]:
    """name -> (steps, losses) across experiment dirs, preferring jsonl."""
    out = {}
    for name, d in run_dirs.items():
        jsonl = os.path.join(d, "metrics.jsonl")
        log = os.path.join(d, "log.txt")
        if os.path.exists(jsonl):
            out[name] = read_metrics_jsonl(jsonl, key)
        elif os.path.exists(log):
            out[name] = scrape_log(log)
    return out


def svg_line_plot(xs, ys, path, title, w=720, h=300, pad=42):
    """A dependency-free SVG polyline of ys over xs with min/mid/max ticks."""
    if not xs:
        return
    x0, x1 = min(xs), max(xs) or 1
    y0, y1 = min(ys), max(ys)
    if y1 - y0 < 1e-12:
        y1 = y0 + 1.0
    sx = lambda x: pad + (x - x0) / max(x1 - x0, 1e-12) * (w - 2 * pad)
    sy = lambda y: h - pad - (y - y0) / (y1 - y0) * (h - 2 * pad)
    pts = " ".join(f"{sx(x):.1f},{sy(y):.1f}" for x, y in zip(xs, ys))
    ticks = []
    for fy in (y0, (y0 + y1) / 2, y1):
        ticks.append(f'<text x="4" y="{sy(fy):.0f}" font-size="11" '
                     f'fill="#555">{fy:.3f}</text>')
    for fx in (x0, (x0 + x1) / 2, x1):
        ticks.append(f'<text x="{sx(fx):.0f}" y="{h - 8}" font-size="11" '
                     f'fill="#555" text-anchor="middle">{int(fx)}</text>')
    with open(path, "w") as f:
        f.write(
            f'<svg xmlns="http://www.w3.org/2000/svg" width="{w}" height="{h}">'
            f'<rect width="{w}" height="{h}" fill="white"/>'
            f'<text x="{w // 2}" y="18" font-size="13" text-anchor="middle">{title}</text>'
            f'<polyline points="{pts}" fill="none" stroke="#1a6fb4" stroke-width="1.5"/>'
            + "".join(ticks) + "</svg>")

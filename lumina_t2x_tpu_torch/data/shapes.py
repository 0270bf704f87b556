"""Procedural shapes dataset and its programmatic faithfulness verifier (the
port's copy of `lumina_t2x_tpu/data/shapes.py`).

A class-conditional dataset (shape x color classes rendered with numpy)
whose ground truth is known, so that a model trained on it can be judged
without pretrained weights by

  1. a weight-free programmatic classifier (`classify`) measuring the
     class-faithfulness of generated images, and
  2. FID between generated and held-out real images (`eval/fid.py`).

Rendered images are 3-channel uint8 HWC, shapes axis-aligned with randomized
center, radius and color jitter on a noisy dark background. Used by
`exps/quality_flow.py` and the class-conditional trainer tests.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

SHAPES = ("circle", "square", "triangle", "cross")
# prototype RGB per color name; rendering jitters around these, the
# classifier snaps foreground means back to the nearest prototype
COLORS = (
    ("red", (220, 45, 45)),
    ("green", (45, 200, 70)),
    ("blue", (55, 85, 230)),
    ("yellow", (235, 220, 55)),
)
# class id = shape_idx * len(COLORS) + color_idx
CLASS_NAMES: List[str] = [f"{s}_{c}" for s in SHAPES for c, _ in COLORS]
NUM_CLASSES = len(CLASS_NAMES)


def shape_mask(shape: str, size: int, cx: float, cy: float, r: float) -> np.ndarray:
    """Boolean (size, size) mask of an axis-aligned shape."""
    y, x = np.mgrid[0:size, 0:size].astype(np.float32)
    if shape == "circle":
        return (x - cx) ** 2 + (y - cy) ** 2 <= r * r
    if shape == "square":
        return np.maximum(np.abs(x - cx), np.abs(y - cy)) <= r
    if shape == "triangle":
        # apex at (cx, cy - r), base at y = cy + r with half-width r
        t = (y - (cy - r)) / (2 * r)  # 0 at apex, 1 at base
        return (t >= 0) & (t <= 1) & (np.abs(x - cx) <= t * r)
    if shape == "cross":
        arm = r / 3.0
        return ((np.abs(x - cx) <= arm) & (np.abs(y - cy) <= r)) | (
            (np.abs(y - cy) <= arm) & (np.abs(x - cx) <= r)
        )
    raise ValueError(f"unknown shape {shape!r}")


def render(class_id: int, rng: np.random.Generator, size: int = 64) -> np.ndarray:
    """One uint8 HWC image of the class: jittered geometry + color on a
    noisy dark background."""
    shape = SHAPES[class_id // len(COLORS)]
    _, proto = COLORS[class_id % len(COLORS)]
    r = float(rng.uniform(size * 0.16, size * 0.30))
    cx = float(rng.uniform(r + 2, size - r - 2))
    cy = float(rng.uniform(r + 2, size - r - 2))
    mask = shape_mask(shape, size, cx, cy, r)
    img = rng.normal(25.0, 8.0, (size, size, 3)).astype(np.float32)
    color = np.asarray(proto, np.float32) + rng.uniform(-18, 18, (3,))
    img[mask] = color + rng.normal(0.0, 4.0, (int(mask.sum()), 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def write_imagefolder(root: str, n_per_class: int, seed: int = 0,
                      size: int = 64) -> int:
    """Write an ImageFolder tree root/<class_name>/<i>.png; returns total."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    total = 0
    for cid, name in enumerate(CLASS_NAMES):
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        for i in range(n_per_class):
            Image.fromarray(render(cid, rng, size)).save(os.path.join(d, f"{i:05d}.png"))
            total += 1
    return total


# ---------------------------------------------------------------------------
# programmatic verifier


def _resize_mask(mask: np.ndarray, out: int = 32) -> np.ndarray:
    """Nearest-neighbor boolean resize (no PIL dependency in the hot path)."""
    h, w = mask.shape
    yi = np.clip((np.arange(out) + 0.5) * h / out, 0, h - 1).astype(np.int64)
    xi = np.clip((np.arange(out) + 0.5) * w / out, 0, w - 1).astype(np.int64)
    return mask[yi][:, xi]


def _templates(size: int = 64) -> Dict[str, np.ndarray]:
    out = {}
    for s in SHAPES:
        m = shape_mask(s, size, size / 2, size / 2, size * 0.3)
        ys, xs = np.nonzero(m)
        crop = m[ys.min():ys.max() + 1, xs.min():xs.max() + 1]
        out[s] = _resize_mask(crop)
    return out


_TEMPLATES = _templates()
_COLOR_PROTOS = np.asarray([rgb for _, rgb in COLORS], np.float32)


def classify(img: np.ndarray) -> Tuple[Optional[int], Dict]:
    """(class_id | None, details) for a uint8/float HWC image.

    Foreground = pixels well above the dark background; color = nearest
    prototype of the foreground mean; shape = best mask-IoU against the
    canonical templates after bbox-normalization. Returns None when no
    coherent foreground exists (e.g. noise images)."""
    arr = np.asarray(img, np.float32)
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected HWC RGB, got {arr.shape}")
    lum = arr.mean(axis=2)
    fg = lum > 80.0
    detail: Dict = {"fg_pixels": int(fg.sum())}
    if fg.sum() < 16:
        return None, detail
    mean_rgb = arr[fg].mean(axis=0)
    # chroma-normalized match: robust to the generator's brightness jitter
    p = _COLOR_PROTOS / np.linalg.norm(_COLOR_PROTOS, axis=1, keepdims=True)
    v = mean_rgb / (np.linalg.norm(mean_rgb) + 1e-6)
    color_idx = int(np.argmax(p @ v))
    ys, xs = np.nonzero(fg)
    crop = fg[ys.min():ys.max() + 1, xs.min():xs.max() + 1]
    norm = _resize_mask(crop)
    ious = {}
    for s, tpl in _TEMPLATES.items():
        inter = (norm & tpl).sum()
        union = (norm | tpl).sum()
        ious[s] = float(inter) / max(int(union), 1)
    shape_name = max(ious, key=ious.get)
    detail.update(color=COLORS[color_idx][0], shape=shape_name, ious=ious,
                  mean_rgb=[float(c) for c in mean_rgb])
    if ious[shape_name] < 0.45:
        return None, detail  # blobby / incoherent foreground
    return SHAPES.index(shape_name) * len(COLORS) + color_idx, detail


def faithfulness_report(images: np.ndarray, labels: np.ndarray) -> Dict:
    """Accuracy + per-class breakdown of `classify` over (N, H, W, 3) uint8
    images vs intended class labels."""
    n = len(images)
    per_class = {name: {"n": 0, "correct": 0} for name in CLASS_NAMES}
    correct = rejected = 0
    for img, lab in zip(images, labels):
        pred, _ = classify(img)
        name = CLASS_NAMES[int(lab)]
        per_class[name]["n"] += 1
        if pred is None:
            rejected += 1
        elif int(pred) == int(lab):
            correct += 1
            per_class[name]["correct"] += 1
    return {
        "n": n,
        "accuracy": correct / max(n, 1),
        "rejected_frac": rejected / max(n, 1),
        "per_class": {k: (v["correct"] / v["n"] if v["n"] else None)
                      for k, v in per_class.items()},
        "chance": 1.0 / NUM_CLASSES,
    }

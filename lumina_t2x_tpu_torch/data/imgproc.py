"""Image preprocessing (counterpart of `lumina_t2x_tpu/data/imgproc.py`):
aspect-ratio buckets and crops, with the reference's crop geometry, bucket
set and order of random draws (`lumina_next_t2i/imgproc.py:1-58`).

The bucket arithmetic is pure Python and equal to the JAX package's. Pillow
is imported inside the functions that resize, so the module imports without
it. Random crops draw from an explicit `random.Random`.
"""

from __future__ import annotations

import random
from typing import List, Tuple

import numpy as np


def _shrink_by_halves(img, min_w: int, min_h: int):
    """Repeated 2x box downsampling while another halving keeps both sides at
    or above (min_w, min_h): the antialiasing pre-pass of the ADM
    preprocessing."""
    from PIL import Image

    w, h = img.size
    while w // 2 >= min_w and h // 2 >= min_h:
        w, h = w // 2, h // 2
        img = img.resize((w, h), resample=Image.BOX)
    return img


def center_crop_arr(pil_image, image_size: int):
    """ADM square center crop: halve to near the target, bicubic-scale the
    short side to `image_size`, crop the middle."""
    from PIL import Image

    img = _shrink_by_halves(pil_image, image_size, image_size)
    w, h = img.size
    s = image_size / min(w, h)
    img = img.resize((round(w * s), round(h * s)), resample=Image.BICUBIC)
    w, h = img.size
    left, top = (w - image_size) // 2, (h - image_size) // 2
    return img.crop((left, top, left + image_size, top + image_size))


def center_crop(pil_image, crop_size: Tuple[int, int], rng: random.Random):
    """Scale to cover, then crop at a uniformly random position drawn from
    `rng` (left, then top; despite the name the position is random: the
    reference's crop augmentation)."""
    from PIL import Image

    cw, ch = crop_size
    img = _shrink_by_halves(pil_image, cw, ch)
    w, h = img.size
    s = max(cw / w, ch / h)
    img = img.resize((round(w * s), round(h * s)), resample=Image.BICUBIC)
    w, h = img.size
    left = rng.randint(0, w - cw)
    top = rng.randint(0, h - ch)
    return img.crop((left, top, left + cw, top + ch))


def _aspect_fit(img_w: int, img_h: int, bucket: Tuple[int, int]) -> float:
    """The fraction of the image kept after scale-to-cover and crop into
    `bucket`, in (0, 1]; 1 is an exact aspect match."""
    sw, sh = bucket[0] / img_w, bucket[1] / img_h
    return min(sw, sh) / max(sw, sh)


def _ranked(width: int, height: int, crop_size_list):
    """Buckets by fit, best first; equal fits rank by larger (w, h)."""
    return sorted(crop_size_list, key=lambda c: (_aspect_fit(width, height, c), c), reverse=True)


def var_center_crop(pil_image, crop_size_list: List[Tuple[int, int]], rng: random.Random,
                    random_top_k: int = 4):
    """Crop to one of the `random_top_k` best-fitting buckets, chosen with
    `rng`, then `center_crop` with the same `rng`."""
    w, h = pil_image.size
    return center_crop(pil_image, rng.choice(_ranked(w, h, crop_size_list)[:random_top_k]), rng)


def match_bucket(width: int, height: int, crop_size_list: List[Tuple[int, int]]) -> Tuple[int, int]:
    """The best bucket for (width, height), deterministic (larger bucket wins
    on equal fit)."""
    return max(crop_size_list, key=lambda c: (_aspect_fit(width, height, c), c))


def choose_bucket(width: int, height: int, crop_size_list: List[Tuple[int, int]],
                  *, seed: int, index: int, random_top_k: int = 4) -> Tuple[int, int]:
    """`var_center_crop`'s top-k bucket draw, seeded by (seed, index): every
    rank computes the same bucket for a dataset item from its metadata alone,
    and the bucket still varies across items and seeds."""
    ranked = _ranked(width, height, crop_size_list)
    return random.Random((seed << 32) ^ index).choice(ranked[:random_top_k])


def generate_crop_size_list(num_patches: int, patch_size: int, max_ratio: float = 4.0):
    """All pixel sizes (w, h) = (wp, hp) * patch_size on the staircase
    boundary of {wp * hp <= num_patches}, aspect at most max_ratio: for each
    width wp (descending) the heights from just past the previous column's
    tallest up to floor(num_patches / wp)."""
    assert max_ratio >= 1.0
    sizes: List[Tuple[int, int]] = []
    prev_tallest = 1
    for wp in range(num_patches, 0, -1):
        tallest = num_patches // wp
        for hp in range(prev_tallest, tallest + 1):
            if max(wp, hp) <= max_ratio * min(wp, hp):
                sizes.append((wp * patch_size, hp * patch_size))
        prev_tallest = tallest
    return sizes


def to_latent_input(pil_image) -> np.ndarray:
    """A Pillow image -> CHW float32 in [-1, 1]."""
    arr = np.asarray(pil_image.convert("RGB"), np.float32) / 255.0
    return ((arr - 0.5) / 0.5).transpose(2, 0, 1)


def crop_origin(width: int, height: int, crop_size: Tuple[int, int], rng: random.Random):
    """A random crop origin over the image scaled to cover `crop_size`, with
    the native decoder's scaled-size arithmetic (`native/image_loader.cpp`
    `resize_crop_normalize`), so that the draw spans exactly its valid
    range."""
    cw, ch = crop_size
    scale = max(cw / width, ch / height)
    sw = max(int(width * scale + 0.5), cw)
    sh = max(int(height * scale + 0.5), ch)
    return rng.randint(0, sw - cw), rng.randint(0, sh - ch)

"""ctypes binding of the port's native image decoder (`native/image_loader.cpp`,
counterpart of `lumina_t2x_tpu/data/native_loader.py`).

The library is built with g++ at first use into
`build/native/<hash of the source>/_image_loader.so` (gitignored; it needs
libjpeg's and libpng's headers) and exposes:

- `decode_to_tensor(bytes, (w, h), crop_xy)` -> (3, h, w) float32 in
  [-1, 1]: JPEG/PNG decode, bilinear scale-to-cover, crop and normalize in
  one native pass;
- `probe_size(bytes)` -> (w, h) from the header;
- `NativeImageProcessor`: JAX's bucketed transform (top-k bucket pick,
  probe, decode + crop + normalize in one native call), its random draws
  from a `random.Random` the caller seeds.

A build that fails, or a library that does not load, raises (with g++'s or
the loader's message): a caller that chose this decoder does not fall back
to another one. `native_status()` says whether it builds, and why not: the
trainer takes it whenever it does, as JAX's does, and logs its choice.
ctypes releases the GIL during a call, so a thread pool decodes in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import random
import threading
from pathlib import Path
from typing import List, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parents[1] / "native" / "image_loader.cpp"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
_LOCK = threading.Lock()
_LIB = None


def library_path() -> Path:
    """Where the library of the current source is built."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _BUILD_ROOT / digest / "_image_loader.so"


def _build(so: Path) -> None:
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(_SRC), "-o", str(tmp),
           "-ljpeg", "-lpng", "-lz"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError("the native image decoder needs g++") from e
    if proc.returncode != 0:
        raise RuntimeError(f"building the native image decoder failed ({' '.join(cmd)}):\n"
                           f"{proc.stderr.strip()}")
    tmp.replace(so)


def get_lib() -> ctypes.CDLL:
    """The loaded library, built on first use; raises if it cannot be built."""
    global _LIB
    if _LIB is not None:  # lock-free fast path: called per image by the decode threads
        return _LIB
    with _LOCK:
        if _LIB is None:
            so = library_path()
            if not so.exists():
                _build(so)
            try:
                lib = ctypes.CDLL(str(so))
            except OSError as e:  # e.g. built where libjpeg exists, loaded where it does not
                raise RuntimeError(f"the native image decoder {so} does not load: {e}") from e
            lib.decode_to_tensor.restype = ctypes.c_int
            lib.decode_to_tensor.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float)]
            lib.probe_size.restype = ctypes.c_int
            lib.probe_size.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                       ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
            _LIB = lib
    return _LIB


def native_status() -> Tuple[bool, str]:
    """(True, the library's path) when the decoder builds and loads, else
    (False, the build's or the loader's message)."""
    try:
        get_lib()
    except RuntimeError as e:
        return False, str(e)
    return True, str(library_path())


def probe_size(data: bytes) -> Tuple[int, int]:
    """(width, height) of a JPEG or PNG; ValueError if it cannot be read."""
    w, h = ctypes.c_int(), ctypes.c_int()
    if get_lib().probe_size(data, len(data), ctypes.byref(w), ctypes.byref(h)) != 0:
        raise ValueError("cannot probe image")
    return w.value, h.value


def decode_to_tensor(data: bytes, crop_size: Tuple[int, int],
                     crop_xy: Tuple[int, int] = (-1, -1)) -> np.ndarray:
    """bytes -> (3, crop_h, crop_w) float32 in [-1, 1]; `crop_xy` is the
    origin in the scaled image, (-1, -1) for the center. ValueError if the
    bytes are neither JPEG nor PNG, or corrupt."""
    cw, ch = crop_size
    out = np.empty((3, ch, cw), np.float32)
    rc = get_lib().decode_to_tensor(data, len(data), cw, ch, crop_xy[0], crop_xy[1],
                                    out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise ValueError("cannot decode image")
    return out


class NativeImageProcessor:
    """Bucketed native decode (counterpart of JAX's `NativeImageProcessor`):
    probe the size, pick one of the `random_top_k` best-fitting buckets of
    `crop_size_list` (`imgproc.var_center_crop`'s ranking), then decode,
    scale to cover, crop and normalize in one native call, at a random crop
    origin (`random_crop`, `imgproc.crop_origin`) or at the center.

    JAX draws the bucket and the origin from the unseeded global `random`;
    here they come from `rng` (a `random.Random` the caller seeds, for
    example by seed and stream position), in JAX's order: the bucket, then
    the origin's x and y. There is no Pillow fallback: the library must
    build (`native_status`); `imgproc.var_center_crop` is the Pillow path."""

    def __init__(self, crop_size_list: List[Tuple[int, int]], random_top_k: int = 4,
                 random_crop: bool = True):
        self.crop_size_list = crop_size_list
        self.random_top_k = random_top_k
        self.random_crop = random_crop

    def pick_bucket(self, w: int, h: int, rng: random.Random) -> Tuple[int, int]:
        from .imgproc import _ranked

        return rng.choice(_ranked(w, h, self.crop_size_list)[: self.random_top_k])

    def __call__(self, path: str, rng: random.Random) -> Tuple[np.ndarray, Tuple[int, int]]:
        """(3, h, w) float32 in [-1, 1] and the (w, h) bucket of the image
        file at `path`."""
        from .imgproc import crop_origin

        with open(path, "rb") as f:
            data = f.read()
        w, h = probe_size(data)
        bucket = self.pick_bucket(w, h, rng)
        origin = crop_origin(w, h, bucket, rng) if self.random_crop else (-1, -1)
        return decode_to_tensor(data, bucket, origin), bucket

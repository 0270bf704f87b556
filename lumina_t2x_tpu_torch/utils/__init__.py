"""Small helpers of the port (counterpart of `lumina_t2x_tpu/utils`)."""

import struct
import zlib

import numpy as np


def stable_text_seed(text: str) -> int:
    """Deterministic 31-bit seed for a string: Python's builtin `hash` is
    salted per interpreter, crc32 is the same in every process and on every
    platform (the hashed pseudo caption features key on it)."""
    return zlib.crc32(text.encode("utf-8")) & 0x7FFFFFFF


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def png_bytes(img_hwc: np.ndarray) -> bytes:
    """HWC uint8 RGB -> PNG bytes: 8-bit RGB, one IDAT of filter-0 rows,
    written with `zlib` and `struct` (no imaging package needed)."""
    img = np.ascontiguousarray(img_hwc, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an HWC RGB image, got shape {img.shape}")
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + _png_chunk(b"IEND", b""))


__all__ = ["png_bytes", "stable_text_seed"]

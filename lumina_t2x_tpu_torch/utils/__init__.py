"""Small helpers of the port (counterpart of `lumina_t2x_tpu/utils`)."""

import zlib


def stable_text_seed(text: str) -> int:
    """Deterministic 31-bit seed for a string: Python's builtin `hash` is
    salted per interpreter, crc32 is the same in every process and on every
    platform (the hashed pseudo caption features key on it)."""
    return zlib.crc32(text.encode("utf-8")) & 0x7FFFFFFF


__all__ = ["stable_text_seed"]

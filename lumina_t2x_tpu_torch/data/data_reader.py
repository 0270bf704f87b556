"""General path reader (counterpart of `lumina_t2x_tpu/data/data_reader.py`;
the reference's `lumina_next_t2i/data/data_reader.py:12-33`).

The reference reads items from local disk or an s3/ceph bucket via a petrel
client. Here: local paths and file:// always work; s3:// / cluster paths go
through a pluggable client hook (register one with `set_client`) since this
environment has no object-store access.
"""

from __future__ import annotations

import io
from typing import Callable, Optional

_CLIENT: Optional[Callable[[str], bytes]] = None


def set_client(reader: Callable[[str], bytes]):
    """Register a bytes-reader for non-local URLs (petrel/s3/gcs...)."""
    global _CLIENT
    _CLIENT = reader


def read_general(path: str) -> io.BytesIO:
    """Return a binary stream for `path` (`data_reader.py:12-33`)."""
    if "://" in path and not path.startswith("file://"):
        if _CLIENT is None:
            raise RuntimeError(
                f"no object-store client registered for {path!r}; call "
                "data_reader.set_client(reader) first"
            )
        return io.BytesIO(_CLIENT(path))
    if path.startswith("file://"):
        path = path[len("file://"):]
    with open(path, "rb") as f:
        return io.BytesIO(f.read())

"""Batch assembly (counterpart of `lumina_t2x_tpu/data/loader.py`): threaded
prefetch and bucket batching.

A thread pool decodes items into numpy batches in place of the reference's
torch DataLoader worker processes (`train.py:496-520`). Variable-aspect
training (`var_center_crop` and the crop-size list) batches per bucket, so
each batch has one (H, W): the model sees whole batches of one shape instead
of the reference's pad-to-max and unpad.
"""

from __future__ import annotations

import collections
import concurrent.futures as futures
import os
from typing import Callable, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np


def threaded_prefetch(item_iter: Iterator, fetch: Callable, num_workers: int = 8,
                      prefetch: int = 32):
    """Map `fetch` over an index stream with a bounded thread pool, yielding
    results in order."""
    with futures.ThreadPoolExecutor(num_workers) as pool:
        pending = collections.deque()
        for idx in item_iter:
            pending.append(pool.submit(fetch, idx))
            if len(pending) >= prefetch:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()


def batched(iterable: Iterable, batch_size: int, collate: Callable):
    buf = []
    for item in iterable:
        buf.append(item)
        if len(buf) == batch_size:
            yield collate(buf)
            buf = []


def bucket_batched(
    iterable: Iterable[Tuple[Tuple[int, int], object]],
    batch_size: int,
    collate: Callable,
    max_open_buckets: int = 64,
):
    """Group (bucket_key, item) pairs into same-bucket batches.

    Items accumulate per bucket; a batch is emitted when a bucket fills. This
    gives every emitted batch a single (H, W).

    SINGLE-PROCESS tool: per-process streams diverge in bucket order across
    hosts — multi-host training must use `bucket_batched_global`. The
    max_open_buckets flush can emit a PARTIAL batch (smaller leading dim);
    callers relying on a fixed batch size should size max_open_buckets above
    their bucket universe (it exists only to bound decoded-item memory).
    """
    buckets: dict = collections.defaultdict(list)
    for key, item in iterable:
        buckets[key].append(item)
        if len(buckets[key]) == batch_size:
            yield key, collate(buckets.pop(key))
        elif len(buckets) > max_open_buckets:
            # flush the fullest bucket to bound memory
            fullest = max(buckets, key=lambda k: len(buckets[k]))
            items = buckets.pop(fullest)
            yield fullest, collate(items)


def bucket_batched_global(
    index_iter: Iterator[int],
    bucket_of: Callable[[int], Tuple[int, int]],
    global_batch_size: int,
    *,
    rank: int = 0,
    world_size: int = 1,
    fetch: Callable[[int, Tuple[int, int]], object],
    collate: Callable,
    num_workers: int = 8,
    prefetch_batches: int = 2,
    skip_batches: int = 0,
):
    """Cross-rank-consistent bucket batching for multi-host training.

    Every rank walks the SAME global index stream (`index_iter` must be
    identical on all ranks — the epoch-seeded permutation, unstrided) and
    groups INDICES per bucket using `bucket_of`, which must be deterministic
    and rank-independent (derive the bucket from annotation metadata + a
    per-index seeded draw, never from decoded pixels or a shared RNG
    stream). When a bucket accumulates `global_batch_size` indices, that IS
    the next global batch on every rank: rank r decodes the bucket's
    `indices[r::world_size]` via `fetch(idx, key)` and yields
    `(key, collate(items))`. Bucket keys and batch order are therefore
    bit-identical across ranks, so the ranks' shards form one global batch.

    Buckets hold the stream's items (ints, or any value `bucket_of` and
    `fetch` take), so there is no memory flush and no partial
    batch: every yielded batch has exactly global_batch_size/world_size
    items. `skip_batches` fast-forwards whole emitted batches without
    decoding (resume: restores the stream position in O(metadata)).

    Pipelining: a FEEDER thread walks the index stream, submits decode work,
    and chains a collate task per batch, so decode + collate happen while
    the consumer is inside its train step. (An earlier in-generator design
    only submitted work during `next()` — decode then overlapped *collate*
    on the consumer thread instead of the step, measured as a 28% step-time
    tax on a 1-core host; the feeder form cuts it to 7.5%, the residue
    being GIL sharing on that single core.) Up to
    `prefetch_batches` collated batches + one in assembly are in flight;
    the bounded queue gives backpressure. Worker/feeder exceptions
    propagate to the consumer at the matching `next()`.
    """
    import queue
    import threading

    stop = threading.Event()
    ready: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch_batches))
    _END = object()

    pool = futures.ThreadPoolExecutor(num_workers, thread_name_prefix="lumina-decode")
    collator = futures.ThreadPoolExecutor(1, thread_name_prefix="lumina-collate")

    def _assemble(key, futs):
        return key, collate([f.result() for f in futs])

    def _put(item) -> bool:
        """Blocking put that aborts when the consumer has closed."""
        while not stop.is_set():
            try:
                ready.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _feeder():
        try:
            skip = skip_batches
            buckets: dict = collections.defaultdict(list)
            for idx in index_iter:
                if stop.is_set():
                    return
                key = bucket_of(idx)
                buckets[key].append(idx)
                if len(buckets[key]) == global_batch_size:
                    mine = buckets.pop(key)[rank::world_size]
                    if skip > 0:
                        skip -= 1
                        continue
                    futs = [pool.submit(fetch, i, key) for i in mine]
                    if not _put(collator.submit(_assemble, key, futs)):
                        return
            _put(_END)
        except BaseException as exc:  # surface in the consumer
            _put(exc)

    feeder = threading.Thread(target=_feeder, daemon=True, name="lumina-feeder")
    feeder.start()
    try:
        while True:
            item = ready.get()
            if item is _END:
                break
            if isinstance(item, BaseException):
                raise item
            yield item.result()
    finally:
        stop.set()
        while True:  # unblock a feeder stuck on a full queue
            try:
                ready.get_nowait()
            except queue.Empty:
                break
        pool.shutdown(wait=False, cancel_futures=True)
        collator.shutdown(wait=False, cancel_futures=True)


def list_imagenet_folder(root: str) -> Tuple[List[Tuple[str, int]], List[str]]:
    """(path, class_index) list over an ImageFolder layout
    (`Next-DiT-ImageNet/train.py:109`)."""
    classes = sorted(
        d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
    )
    class_to_idx = {c: i for i, c in enumerate(classes)}
    samples = []
    for c in classes:
        cdir = os.path.join(root, c)
        for fname in sorted(os.listdir(cdir)):
            if fname.lower().endswith((".jpg", ".jpeg", ".png", ".webp", ".bmp")):
                samples.append((os.path.join(cdir, fname), class_to_idx[c]))
    return samples, classes


def collate_image_label(items: Sequence[Tuple[np.ndarray, int]]):
    xs = np.stack([np.asarray(x, np.float32) for x, _ in items])
    ys = np.asarray([y for _, y in items], np.int32)
    return {"x": xs, "y": ys}

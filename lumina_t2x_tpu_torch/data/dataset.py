"""Dataset layer (counterpart of `lumina_t2x_tpu/data/dataset.py`): meta
datasets, item processors and the resumable sampler, with the reference's
on-disk contracts (`lumina_next_t2i/data/dataset.py:20-189`,
`train.py:61-104`):

- the config schema ``META: [{path, type, root, ratio}]`` over json/jsonl
  annotation lists; items concatenated per ``type`` group, groups in
  first-appearance order. The config is read with `json` when it parses as
  JSON, else with the port's block-YAML reader (`utils/yaml_subset.py`), so
  PyYAML is not needed;
- ``ratio`` subsampling seeded with 0, so every process and run selects the
  same subset;
- the h5 disk cache ``accessory_data_cache/<sanitized-config-path>/data.h5``
  (an ``ann`` vlen-str dataset and a json ``group_indice_range``) completed
  by a ``ready`` sentinel the lead process writes and followers poll; h5py
  is imported only when the cache is used (`--cache_data_on_disk`);
- a failing item is replaced by its left neighbour within its meta group,
  wrapping to the group's last index at the group start;
- `resumable_sampler_indices`: an infinite shuffled index stream strided by
  rank, seeded per epoch, fast-forwarded on resume.

Pillow is imported inside the functions that decode; random draws come from
explicit `random.Random` objects.
"""

from __future__ import annotations

import copy
import json
import logging
import os
import random
import time
import traceback
from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Dict, Iterator, List, Tuple

import numpy as np

from ..utils.yaml_subset import parse_yaml_subset

logger = logging.getLogger(__name__)


class DataBriefReportException(Exception):
    """An expected per-item failure worth one log line, not a traceback."""

    def __init__(self, message=None):
        self.message = message

    def __str__(self):
        return f"{self.__class__}: {self.message}"


class ItemProcessor(ABC):
    @abstractmethod
    def process_item(self, data_item, training_mode=False):
        raise NotImplementedError


class T2IItemProcessor(ItemProcessor):
    """Decode (image, caption) pairs (`train.py:61-77`): image path via
    'path'/'image_url'/'image', caption from 'conversations' or
    'prompt'/'caption'."""

    def __init__(self, transform=None):
        self.transform = transform

    def process_item(self, data_item, training_mode=False):
        from PIL import Image

        from .data_reader import read_general

        for key in ("path", "image_url", "image"):
            if key in data_item:
                image = Image.open(read_general(data_item[key])).convert("RGB")
                break
        else:
            raise DataBriefReportException(f"no image path in item: {list(data_item)}")
        if "conversations" in data_item:
            text = data_item["conversations"][-1]["value"]
        else:
            text = data_item.get("prompt", data_item.get("caption", ""))
        if self.transform is not None:
            image = self.transform(image)
        return image, text


class TokenizedT2IItemProcessor(ItemProcessor):
    """Dataset-side tokenization (the lumina_t2i 5B pattern,
    `lumina_t2i/train.py:56-93`): caption -> (image, token_ids, token_mask)
    with bos/eos, fixed max_words (default 128), zero-padded (padded tokens
    are masked out downstream), and text dropout applied before tokenizing,
    drawn from `rng` (needed when `text_dropout_prob` > 0).
    """

    def __init__(self, transform, tokenizer, text_dropout_prob: float = 0.0,
                 max_words: int = 128, rng: random.Random = None):
        self.transform = transform
        self.tokenizer = tokenizer
        self.text_dropout_prob = text_dropout_prob
        self.max_words = max_words
        self.rng = rng

    def process_item(self, data_item, training_mode=False):
        from PIL import Image

        from .data_reader import read_general

        if "conversations" in data_item:
            image = Image.open(read_general(data_item["image"])).convert("RGB")
            text = data_item["conversations"][-1]["value"]
        else:
            image = Image.open(read_general(data_item["path"])).convert("RGB")
            text = data_item.get("prompt", data_item.get("caption", ""))
        if self.transform is not None:
            image = self.transform(image)
        if training_mode and self.text_dropout_prob > 0 \
                and self.rng.uniform(0.0, 1.0) < self.text_dropout_prob:
            text = ""
        ids = self.tokenizer.encode(text, truncation=False)
        token_mask = (np.arange(self.max_words) < len(ids)).astype(np.int32)
        if len(ids) < self.max_words:
            ids = ids + [0] * (self.max_words - len(ids))
        else:
            ids = ids[: self.max_words]
        return image, np.asarray(ids, np.int32), token_mask


# -- annotation loading ------------------------------------------------------


def _read_annotation_file(path: str) -> List[dict]:
    """One meta file -> list of annotation dicts. ``.json`` is a single list;
    ``.jsonl`` is one record per line (bad lines are fatal, with a located
    error message)."""
    ext = os.path.splitext(path)[-1]
    if ext == ".json":
        with open(path) as f:
            return json.load(f)
    if ext == ".jsonl":
        records = []
        with open(path) as f:
            for lineno, line in enumerate(f):
                try:
                    records.append(json.loads(line))
                except json.decoder.JSONDecodeError:
                    logger.error(f"bad jsonl record at {path}:{lineno}: {line.rstrip()}")
                    raise
        return records
    raise NotImplementedError(f'Unknown meta file extension: "{ext}"')


def _apply_meta_options(records: List[dict], meta: dict) -> List[dict]:
    """Per-META-entry options: seeded ``ratio`` subsampling (seed 0 — every
    process must select the identical subset) and ``root`` path prefixing."""
    if "ratio" in meta:
        records = random.Random(0).sample(records, int(len(records) * meta["ratio"]))
    root = meta.get("root")
    if root is not None:
        for rec in records:
            for key in ("path", "image_url", "image"):
                if key in rec:
                    rec[key] = os.path.join(root, rec[key])
    return records


def _load_meta_config(config: dict) -> Tuple[List[dict], Dict[str, List[int]]]:
    """Flatten a META config into (all annotations, {group: [start, stop]}).
    Items of the same ``type`` are contiguous; group order is first
    appearance in the config."""
    by_group: Dict[str, List[dict]] = {}
    for meta in config["META"]:
        records = _apply_meta_options(_read_annotation_file(meta["path"]), meta)
        by_group.setdefault(meta.get("type", "default"), []).extend(records)

    flat: List[dict] = []
    ranges: Dict[str, List[int]] = {}
    for name, records in by_group.items():
        ranges[name] = [len(flat), len(flat) + len(records)]
        flat.extend(records)
    return flat, ranges


# -- h5 disk cache -----------------------------------------------------------

_CACHE_ROOT = "./accessory_data_cache"
_READY_SENTINEL = "ready"


def _cache_dir_for(config_path: str) -> str:
    """Config path -> cache dir, path separators and punctuation mapped to
    '-' (the reference's directory-name convention, `dataset.py:137-144`)."""
    safe = "".join("-" if ch in '/\\.?!' else ch for ch in config_path)
    return os.path.join(_CACHE_ROOT, safe)


def _build_disk_cache(cache_dir: str, flat: List[dict], ranges: Dict[str, List[int]]) -> None:
    """Lead-process cache build: annotations as one vlen-str h5 dataset plus
    the group ranges as json, then the ``ready`` sentinel last (followers key
    on the sentinel, so a crashed build is never mistaken for a finished
    one)."""
    import h5py

    os.makedirs(cache_dir, exist_ok=True)
    with h5py.File(os.path.join(cache_dir, "data.h5"), "w") as f:
        ann = f.create_dataset("ann", (len(flat),), dtype=h5py.vlen_dtype(str))
        ann[:] = [json.dumps(rec) for rec in flat]
        f.create_dataset("group_indice_range", data=json.dumps(ranges))
    with open(os.path.join(cache_dir, _READY_SENTINEL), "w") as f:
        f.write(_READY_SENTINEL)


def _open_disk_cache(cache_dir: str, is_lead: bool,
                     timeout_s: float = float(os.environ.get(
                         "LUMINA_DATA_CACHE_TIMEOUT", "1800"))):
    """Open the h5 cache, polling for the lead's sentinel first. The h5 file
    stays open for the dataset's lifetime (annotations are read lazily per
    item — the point of the cache is NOT materializing them in every
    process). The poll is BOUNDED: if the lead process crashed during the
    cache build, followers raise instead of hanging the cluster forever
    (LUMINA_DATA_CACHE_TIMEOUT seconds, default 30 min)."""
    import h5py

    deadline = time.monotonic() + timeout_s
    while not os.path.exists(os.path.join(cache_dir, _READY_SENTINEL)):
        assert not is_lead, "lead process must have built the cache before opening"
        if time.monotonic() > deadline:
            raise RuntimeError(
                f"data cache {cache_dir!r} not ready after {timeout_s:.0f}s — "
                "the lead process likely failed during the cache build; check "
                "its logs (raise LUMINA_DATA_CACHE_TIMEOUT for very large "
                "annotation sets)")
        time.sleep(1)
    f = h5py.File(os.path.join(cache_dir, "data.h5"), "r")
    return f["ann"], json.loads(f["group_indice_range"].asstr()[()])


@dataclass(frozen=True)
class _Group:
    name: str
    start: int
    stop: int  # exclusive


def read_meta_config(config_path: str) -> dict:
    """The META config: JSON when the file parses as JSON, else block YAML."""
    with open(config_path) as f:
        text = f.read()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        return parse_yaml_subset(text)


class MetaDataset:
    """Meta dataset (`dataset.py:34-189`)."""

    def __init__(self, config_path, item_processor: ItemProcessor, cache_on_disk=False,
                 rank: int = 0):
        self.config = read_meta_config(config_path)
        self.cache_on_disk = cache_on_disk
        if cache_on_disk:
            cache_dir = _cache_dir_for(config_path)
            cached = (os.path.exists(os.path.join(cache_dir, "data.h5"))
                      and os.path.exists(os.path.join(cache_dir, _READY_SENTINEL)))
            if rank == 0 and not cached:
                flat, ranges = _load_meta_config(self.config)
                _build_disk_cache(cache_dir, flat, ranges)
            elif cached:
                logger.warning(f"using existing h5 data cache: {cache_dir} "
                               "(delete it if the underlying data changed)")
            self.ann, ranges = _open_disk_cache(cache_dir, is_lead=(rank == 0))
        else:
            self.ann, ranges = _load_meta_config(self.config)
        self._groups = [_Group(name, lo, hi) for name, (lo, hi) in ranges.items()]
        self.item_processor = item_processor
        self._size_cache: Dict[int, Tuple[int, int]] = {}

    def __len__(self):
        return len(self.ann)

    def _decode(self, index: int) -> dict:
        raw = self.ann[index]
        # h5-cached rows are json strings; in-memory rows are shared dicts
        # the processor may mutate, hence the copy.
        return json.loads(raw) if self.cache_on_disk else copy.deepcopy(raw)

    def annotation(self, index: int) -> dict:
        """Raw annotation dict for `index` (no image decode) — metadata-only
        consumers (cross-rank bucket assignment) read sizes from here."""
        return self._decode(index)

    def image_size(self, index: int) -> Tuple[int, int]:
        """(width, height) for `index` WITHOUT a full decode: annotation
        width/height-style keys when present, else a lazy PIL header read
        (PIL parses dimensions from the header only — cheap). Memoized."""
        cached = self._size_cache.get(index)
        if cached is not None:
            return cached
        ann = self._decode(index)
        wh = None
        for wk, hk in (("width", "height"), ("w", "h"),
                       ("image_width", "image_height")):
            if wk in ann and hk in ann:
                wh = (int(ann[wk]), int(ann[hk]))
                break
        if wh is None and isinstance(ann.get("resolution"), str) and "x" in ann["resolution"]:
            a, b = ann["resolution"].lower().split("x")[:2]
            wh = (int(a), int(b))
        if wh is None:
            from PIL import Image

            from .data_reader import read_general

            for key in ("path", "image_url", "image"):
                if key in ann:
                    with Image.open(read_general(ann[key])) as im:
                        wh = im.size
                    break
        if wh is None:
            raise KeyError(f"item {index}: no image path or size metadata in "
                           f"annotation keys {sorted(ann)}")
        self._size_cache[index] = wh
        return wh

    def get_item_func(self, index):
        return self.item_processor.process_item(self._decode(index), training_mode=True)

    def raw_image_item(self, index) -> Tuple[bytes, str]:
        """(raw image bytes, caption) WITHOUT decoding — the native C++
        decode path consumes bytes directly
        (`data/native_loader.decode_to_tensor`). Caption keys mirror
        `T2IItemProcessor.process_item`; error retry mirrors `__getitem__`
        (substitute a neighbor within the same meta group)."""
        try:
            ann = self._decode(index)
            from .data_reader import read_general

            for key in ("path", "image_url", "image"):
                if key in ann:
                    data = read_general(ann[key]).getvalue()
                    break
            else:
                raise DataBriefReportException(
                    f"no image path in item: {sorted(ann)}")
            if "conversations" in ann:
                caption = ann["conversations"][-1]["value"]
            else:
                caption = ann.get("prompt", ann.get("caption", ""))
            return data, caption
        except DataBriefReportException as e:
            logger.info(str(e))
        except Exception:
            logger.info(f"Item {index} raw read errored, annotation:\n"
                        f"{self.ann[index]}\nError:\n{traceback.format_exc()}")
        return self.raw_image_item(self._fallback_index(index))

    def _fallback_index(self, index: int) -> int:
        """Replacement for a failed item: the previous index, staying inside
        the same meta group (wrap to the group's last item at the group
        start)."""
        for g in self._groups:
            if g.start <= index < g.stop:
                return g.stop - 1 if index == g.start else index - 1
        raise RuntimeError(f"index {index} outside every group")

    def __getitem__(self, index):
        try:
            return self.get_item_func(index)
        except DataBriefReportException as e:
            logger.info(str(e))
        except Exception:
            logger.info(f"Item {index} errored, annotation:\n{self.ann[index]}\n"
                        f"Error:\n{traceback.format_exc()}")
        return self[self._fallback_index(index)]

    def groups(self) -> List[List[int]]:
        """Per-group index lists (the sampler's group-aware batching hook)."""
        return [list(range(g.start, g.stop)) for g in self._groups]


def resumable_sampler_indices(
    dataset_len: int,
    global_batch_size: int,
    rank: int,
    world_size: int,
    seed: int = 0,
    start_step: int = 0,
) -> Iterator[int]:
    """Deterministic resumable infinite index stream (`train.py:91-104`):
    epoch-seeded shuffles, strided by dp-rank, fast-forwarded by
    `start_step * global_batch_size / world_size` items on resume."""
    per_rank = global_batch_size // world_size
    skip = start_step * per_rank
    epoch = 0
    epoch_len = dataset_len - dataset_len % global_batch_size  # drop ragged tail
    if epoch_len == 0:
        raise ValueError(
            f"dataset has {dataset_len} items < global_batch_size "
            f"{global_batch_size}: every epoch would be empty (the sampler "
            "would spin forever yielding nothing)")
    while True:
        g = np.random.default_rng(seed + epoch)
        perm = g.permutation(dataset_len)[:epoch_len]
        local = perm[rank::world_size]
        for idx in local:
            if skip > 0:
                skip -= 1
                continue
            yield int(idx)
        epoch += 1

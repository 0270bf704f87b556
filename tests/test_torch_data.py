"""The port's data layer (`lumina_t2x_tpu_torch/data/`) against the JAX
package's (`lumina_t2x_tpu/data/`): the bucket arithmetic and the crops, the
meta dataset (JSON and block-YAML configs, neighbour retries, the h5 cache),
the resumable sampler, cross-rank bucket batching, and the native decoder
(the port's own copy of `native/image_loader.cpp`, built into `build/native`)
and its `NativeImageProcessor` against JAX's on PNG and JPEG. Where JAX
draws from the global `random`, it is seeded as the port's `random.Random`
is, and the results are equal.
"""

import io
import json
import os
import random

import numpy as np
import pytest
from PIL import Image

from lumina_t2x_tpu.data import dataset as jds
from lumina_t2x_tpu.data import imgproc as jip
from lumina_t2x_tpu.data import loader as jld
from lumina_t2x_tpu.data import native_loader as jnl
from lumina_t2x_tpu_torch.data import data_reader as tdr
from lumina_t2x_tpu_torch.data import dataset as tds
from lumina_t2x_tpu_torch.data import imgproc as tip
from lumina_t2x_tpu_torch.data import loader as tld
from lumina_t2x_tpu_torch.data import native_loader as tnl

SIZES = [(300, 200), (200, 300), (1024, 1024), (2048, 512), (97, 1301), (640, 480), (33, 34)]


def _image(w, h, seed=0):
    """A smooth RGB test image with some noise (so crops and resizes differ)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 / max(w - 1, 1), yy * 255 / max(h - 1, 1),
                     (xx + yy) * 127 / max(w + h - 2, 1)], -1)
    return Image.fromarray(np.clip(base + rng.normal(0, 12, base.shape), 0, 255).astype(np.uint8))


def _encoded(img, fmt, **kw):
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()


# -- buckets and crops -----------------------------------------------------------------


@pytest.mark.parametrize("num_patches,patch", [(4, 2), (16, 16), (64, 16), (256, 16),
                                               (1024, 16), (4096, 16), (777, 8)])
def test_crop_size_lists_equal_jax(num_patches, patch):
    for ratio in (1.0, 2.0, 4.0):
        assert (tip.generate_crop_size_list(num_patches, patch, ratio)
                == jip.generate_crop_size_list(num_patches, patch, ratio))


def test_bucket_choice_equals_jax():
    crops = jip.generate_crop_size_list(4096, 16)
    for w, h in SIZES:
        assert tip.match_bucket(w, h, crops) == jip.match_bucket(w, h, crops)
        for seed in (0, 1, 12345):
            for index in range(40):
                assert (tip.choose_bucket(w, h, crops, seed=seed, index=index)
                        == jip.choose_bucket(w, h, crops, seed=seed, index=index))


def test_crops_equal_jax_with_the_same_draws():
    crops = jip.generate_crop_size_list(64, 16)
    for i, (w, h) in enumerate(SIZES):
        img = _image(w, h, i)
        random.seed(i)
        ref = jip.var_center_crop(img, crops)
        got = tip.var_center_crop(img, crops, random.Random(i))
        assert got.size == ref.size and np.array_equal(np.asarray(got), np.asarray(ref))
        np.testing.assert_array_equal(tip.to_latent_input(got), jip.to_latent_input(ref))
        np.testing.assert_array_equal(np.asarray(tip.center_crop_arr(img, 64)),
                                      np.asarray(jip.center_crop_arr(img, 64)))


# -- the native decoder -----------------------------------------------------------------


def test_native_library_builds_under_build_dir():
    path = tnl.library_path()
    tnl.get_lib()
    assert path.exists() and path.parent.parent.name == "native"
    assert path.parents[2].name == "build"


def test_native_library_that_does_not_build_or_load_raises(tmp_path, monkeypatch):
    """No fallback: a library that will not load (built where libjpeg exists,
    copied where it does not) or a source that will not compile raises."""
    monkeypatch.setattr(tnl, "_LIB", None)
    bad = tmp_path / "a" / "_image_loader.so"
    bad.parent.mkdir()
    bad.write_bytes(b"not a shared library")
    monkeypatch.setattr(tnl, "library_path", lambda: bad)
    with pytest.raises(RuntimeError, match="does not load"):
        tnl.get_lib()
    src = tmp_path / "broken.cpp"
    src.write_text("#include <no_such_header.h>\n")
    monkeypatch.setattr(tnl, "_SRC", src)
    monkeypatch.setattr(tnl, "library_path", lambda: tmp_path / "b" / "_image_loader.so")
    with pytest.raises(RuntimeError, match="no_such_header.h"):
        tnl.get_lib()
    assert tnl._LIB is None


@pytest.mark.parametrize("fmt", ["PNG", "JPEG"])
def test_native_decode_equals_jax(fmt):
    """The same C++ source built twice: equal tensors for centre crops and
    for drawn crop origins, equal header sizes; undecodable bytes raise."""
    crops = jip.generate_crop_size_list(64, 16)
    for i, (w, h) in enumerate(SIZES[:5]):
        data = _encoded(_image(w, h, i), fmt, **({"quality": 90} if fmt == "JPEG" else {}))
        assert tnl.probe_size(data) == jnl.probe_size(data) == (w, h)
        bucket = jip.match_bucket(w, h, crops)
        np.testing.assert_array_equal(tnl.decode_to_tensor(data, bucket),
                                      jnl.decode_to_tensor(data, bucket))
        origin = tip.crop_origin(w, h, bucket, random.Random(i))
        got = tnl.decode_to_tensor(data, bucket, origin)
        assert got.shape == (3, bucket[1], bucket[0]) and got.min() >= -1 and got.max() <= 1
        np.testing.assert_array_equal(got, jnl.decode_to_tensor(data, bucket, origin))
    with pytest.raises(ValueError):
        tnl.decode_to_tensor(b"not an image", (16, 16))
    with pytest.raises(ValueError):
        tnl.probe_size(b"GIF89a")


@pytest.mark.parametrize("fmt", ["PNG", "JPEG"])
@pytest.mark.parametrize("random_crop", [True, False])
def test_native_image_processor_equals_jax(tmp_path, fmt, random_crop):
    """`NativeImageProcessor` against JAX's on the same file: the port's
    `random.Random` seeded as JAX's global `random` gives the same bucket
    and crop origin, so equal buckets and equal arrays."""
    crops = jip.generate_crop_size_list(64, 16)
    jproc = jnl.NativeImageProcessor(crops, random_top_k=4, random_crop=random_crop)
    tproc = tnl.NativeImageProcessor(crops, random_top_k=4, random_crop=random_crop)
    for i, (w, h) in enumerate(SIZES[:4]):
        path = tmp_path / f"{i}.{fmt.lower()}"
        path.write_bytes(_encoded(_image(w, h, i), fmt, **({"quality": 90} if fmt == "JPEG"
                                                            else {})))
        random.seed(100 + i)
        ref, ref_bucket = jproc(str(path))
        got, bucket = tproc(str(path), random.Random(100 + i))
        assert bucket == tuple(ref_bucket) and got.shape == (3, bucket[1], bucket[0])
        np.testing.assert_array_equal(got, ref)


def test_crop_origin_spans_the_native_range():
    """The drawn origin reaches both ends of the valid range (the C++ clamps
    anything beyond it)."""
    rng = random.Random(0)
    xs = {tip.crop_origin(300, 200, (128, 128), rng)[0] for _ in range(4000)}
    assert min(xs) == 0 and max(xs) == 192 - 128


# -- the meta dataset -------------------------------------------------------------------


class _IndexProcessor(tds.ItemProcessor):
    def __init__(self, fail=()):
        self.fail = set(fail)

    def process_item(self, item, training_mode=False):
        if item["id"] in self.fail:
            raise tds.DataBriefReportException(f"fail {item['id']}")
        return item["id"]


def _write_config(tmp_path, kind, n=10):
    a = tmp_path / "a.json"
    a.write_text(json.dumps([{"id": i} for i in range(n)]))
    b = tmp_path / "b.jsonl"
    b.write_text("\n".join(json.dumps({"id": 100 + i, "path": f"im{i}.png"}) for i in range(n)))
    cfg = tmp_path / f"data_{kind}.yaml"
    if kind == "json":
        cfg.write_text(json.dumps({"META": [{"path": str(a), "type": "g1"},
                                            {"path": str(b), "type": "g2", "ratio": 0.7,
                                             "root": "/imgs"}]}))
    else:
        cfg.write_text(f"# a block-YAML manifest\nMETA:\n  - path: {a}\n    type: g1\n"
                       f"  - path: {b}\n    type: g2\n    ratio: 0.7\n    root: /imgs\n")
    return str(cfg)


@pytest.mark.parametrize("kind", ["json", "yaml"])
def test_meta_dataset_equals_jax(tmp_path, kind):
    cfg = _write_config(tmp_path, kind)
    got = tds.MetaDataset(cfg, _IndexProcessor(fail={3, 100 + 0, 105}))
    ref = jds.MetaDataset(cfg, _IndexProcessor(fail={3, 100 + 0, 105}))
    assert got.config == ref.config
    assert len(got) == len(ref) == 17 and got.groups() == ref.groups()
    assert [got.annotation(i) for i in range(17)] == [ref.annotation(i) for i in range(17)]
    assert got.annotation(12)["path"].startswith("/imgs/")
    # failures fall back to the left neighbour within the group, wrapping
    assert [got[i] for i in range(17)] == [ref[i] for i in range(17)]
    assert got[3] == 2


def test_h5_cache_equals_jax(tmp_path, monkeypatch):
    pytest.importorskip("h5py")
    monkeypatch.chdir(tmp_path)
    cfg = _write_config(tmp_path, "yaml")
    lead = tds.MetaDataset(cfg, _IndexProcessor(), cache_on_disk=True, rank=0)
    assert os.path.exists(os.path.join(tds._cache_dir_for(cfg), "ready"))
    follower = tds.MetaDataset(cfg, _IndexProcessor(), cache_on_disk=True, rank=1)
    ref = jds.MetaDataset(cfg, _IndexProcessor(), cache_on_disk=True, rank=1)
    assert [lead[i] for i in range(17)] == [follower[i] for i in range(17)] \
        == [ref[i] for i in range(17)]
    assert follower.groups() == ref.groups()


def test_t2i_items_and_sizes_equal_jax(tmp_path):
    rows = []
    for i, (w, h) in enumerate(SIZES[:4]):
        _image(w, h, i).save(tmp_path / f"{i}.png")
        rows.append({"path": f"{i}.png", "caption": f"image {i}"})
    rows.append({"image": "0.png", "conversations": [{"value": "q"}, {"value": "answer"}],
                 "width": 5, "height": 7})
    rows.append({"path": "missing.png", "prompt": "gone"})
    (tmp_path / "ann.json").write_text(json.dumps(rows))
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(f"META:\n  - path: {tmp_path / 'ann.json'}\n    root: {tmp_path}\n")
    got = tds.MetaDataset(str(cfg), tds.T2IItemProcessor(None))
    ref = jds.MetaDataset(str(cfg), jds.T2IItemProcessor(None))
    for i in range(len(rows)):
        (gi, gc), (ri, rc) = got[i], ref[i]
        assert gc == rc and np.array_equal(np.asarray(gi), np.asarray(ri))
        assert got.raw_image_item(i) == ref.raw_image_item(i)
        if i < 5:
            assert got.image_size(i) == ref.image_size(i)
    assert got[5][1] == "answer"  # the missing file falls back to its neighbour
    assert got.image_size(4) == (5, 7)


def test_tokenized_items_equal_jax(tmp_path):
    class Tok:
        def encode(self, text, truncation=False):
            return [ord(c) for c in text]

    _image(16, 16).save(tmp_path / "a.png")
    item = {"path": str(tmp_path / "a.png"), "caption": "hello"}
    random.seed(5)
    refs = [jds.TokenizedT2IItemProcessor(None, Tok(), 0.5, 8).process_item(item, True)
            for _ in range(12)]
    proc = tds.TokenizedT2IItemProcessor(None, Tok(), 0.5, 8, rng=random.Random(5))
    for ref in refs:
        got = proc.process_item(item, True)
        np.testing.assert_array_equal(got[1], ref[1])
        np.testing.assert_array_equal(got[2], ref[2])
    assert any(r[2].sum() == 0 for r in refs) and any(r[2].sum() == 5 for r in refs)


# -- sampling and batching ---------------------------------------------------------------


def test_resumable_sampler_equals_jax():
    for seed, rank, world, start in ((0, 0, 1, 0), (1, 1, 2, 0), (3, 2, 4, 5), (7, 0, 2, 11)):
        got = tds.resumable_sampler_indices(50, 8, rank, world, seed=seed, start_step=start)
        ref = jds.resumable_sampler_indices(50, 8, rank, world, seed=seed, start_step=start)
        assert [next(got) for _ in range(60)] == [next(ref) for _ in range(60)]
    with pytest.raises(ValueError):
        next(tds.resumable_sampler_indices(3, 8, 0, 1))


@pytest.mark.parametrize("world", [1, 2])
def test_bucket_batched_global_equals_jax(world):
    """The same global stream, buckets from (seed, index) draws, per rank."""
    crops = jip.generate_crop_size_list(256, 16)
    sizes = [SIZES[i % len(SIZES)] for i in range(40)]

    def run(ds, ld, ip, rank, skip):
        indices = ds.resumable_sampler_indices(40, 4, rank=0, world_size=1, seed=3)
        gen = ld.bucket_batched_global(
            indices, lambda i: ip.choose_bucket(*sizes[i], crops, seed=3, index=i), 4,
            rank=rank, world_size=world, fetch=lambda i, key: (i, key), collate=list,
            num_workers=2, skip_batches=skip)
        out = [next(gen) for _ in range(6)]
        gen.close()
        return out

    for rank in range(world):
        got = run(tds, tld, tip, rank, 2)
        assert got == run(jds, jld, jip, rank, 2)
        assert all(len(items) == 4 // world for _, items in got)
        assert len({key for key, _ in got}) >= 2


def test_loader_helpers_equal_jax(tmp_path):
    assert list(tld.threaded_prefetch(iter(range(20)), lambda i: i * i, 3, 4)) \
        == list(jld.threaded_prefetch(iter(range(20)), lambda i: i * i, 3, 4))
    pairs = [((i % 3, 1), i) for i in range(20)]
    assert list(tld.bucket_batched(iter(pairs), 3, list)) \
        == list(jld.bucket_batched(iter(pairs), 3, list))
    assert list(tld.batched(range(7), 2, tuple)) == list(jld.batched(range(7), 2, tuple))
    for c, n in (("cat", 2), ("dog", 1)):
        os.makedirs(tmp_path / c)
        for i in range(n):
            _image(8, 8).save(tmp_path / c / f"{i}.png")
    assert tld.list_imagenet_folder(str(tmp_path)) == jld.list_imagenet_folder(str(tmp_path))
    items = [(np.ones((3, 2, 2)), 1), (np.zeros((3, 2, 2)), 4)]
    got, ref = tld.collate_image_label(items), jld.collate_image_label(items)
    assert got["y"].tolist() == ref["y"].tolist() == [1, 4]
    np.testing.assert_array_equal(got["x"], ref["x"])


def test_data_reader_paths_and_client(tmp_path):
    (tmp_path / "f.bin").write_bytes(b"abc")
    assert tdr.read_general(str(tmp_path / "f.bin")).getvalue() == b"abc"
    assert tdr.read_general(f"file://{tmp_path / 'f.bin'}").getvalue() == b"abc"
    old = tdr._CLIENT
    try:
        tdr._CLIENT = None
        with pytest.raises(RuntimeError, match="set_client"):
            tdr.read_general("s3://bucket/key")
        tdr.set_client(lambda url: url.encode())
        assert tdr.read_general("s3://bucket/key").getvalue() == b"s3://bucket/key"
    finally:
        tdr._CLIENT = old


def test_data_modules_import_without_pil_yaml_or_h5py():
    import subprocess
    import sys

    code = ("import sys; sys.modules.update(PIL=None, yaml=None, h5py=None); "
            "import lumina_t2x_tpu_torch.data, lumina_t2x_tpu_torch.pipelines.train, "
            "lumina_t2x_tpu_torch.pipelines.encode_latents; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.stdout.strip() == "ok", out.stderr

"""The port's quality-check pieces against the JAX package's: the shapes
dataset and its classifier (`data/shapes.py`), the FID statistics and the
other metrics (`eval/fid.py`), the InceptionV3 pool3 features
(`eval/inception.py`) from one random torchvision-layout state dict, and the
loss-curve readers and plot (`core/loss_plot.py`).

fp32 on the CPU, inputs from numpy seeds. The numpy metrics and the
renderer are exact copies, so they are held to equality (FID to 1e-12
relative); Inception features to atol 2e-4 / rtol 2e-3 of their scale.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumina_t2x_tpu.core import loss_plot as j_lp
from lumina_t2x_tpu.data import shapes as j_shapes
from lumina_t2x_tpu.eval import fid as j_fid
from lumina_t2x_tpu.eval import inception as j_inc
from lumina_t2x_tpu_torch.core import loss_plot as t_lp
from lumina_t2x_tpu_torch.data import shapes as t_shapes
from lumina_t2x_tpu_torch.eval import fid as t_fid
from lumina_t2x_tpu_torch.eval import inception as t_inc

ATOL, RTOL = 2e-4, 2e-3


def test_render_classify_and_report_match_jax(tmp_path):
    """Every class renders to the same pixels from the same generator state,
    the classifier gives the same class and details on real images and on
    noise, and the report agrees on a mislabeled mix."""
    imgs, labels = [], []
    for cid in range(t_shapes.NUM_CLASSES):
        a = t_shapes.render(cid, np.random.default_rng(cid), 48)
        np.testing.assert_array_equal(a, j_shapes.render(cid, np.random.default_rng(cid), 48))
        assert t_shapes.classify(a) == j_shapes.classify(a)
        assert t_shapes.classify(a)[0] == cid
        imgs.append(a)
        labels.append((cid * 5) % t_shapes.NUM_CLASSES)
    noise = np.random.default_rng(0).integers(0, 255, (48, 48, 3)).astype(np.uint8)
    assert t_shapes.classify(noise) == j_shapes.classify(noise)
    imgs.append(noise)
    labels.append(3)
    assert t_shapes.faithfulness_report(np.stack(imgs), np.array(labels)) == \
        j_shapes.faithfulness_report(np.stack(imgs), np.array(labels))
    assert t_shapes.CLASS_NAMES == j_shapes.CLASS_NAMES
    n = t_shapes.write_imagefolder(str(tmp_path / "a"), 1, seed=3, size=16)
    j_shapes.write_imagefolder(str(tmp_path / "b"), 1, seed=3, size=16)
    assert n == 16
    for name in t_shapes.CLASS_NAMES:
        assert (tmp_path / "a" / name / "00000.png").read_bytes() == \
            (tmp_path / "b" / name / "00000.png").read_bytes()


def test_fid_statistics_and_metrics_match_jax():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((64, 12))
    b = rng.standard_normal((48, 12)) * 1.3 + 0.2
    for x in (a, b):
        for g, r in zip(t_fid.compute_statistics(x), j_fid.compute_statistics(x)):
            np.testing.assert_array_equal(g, r)
    got = t_fid.frechet_distance(*t_fid.compute_statistics(a), *t_fid.compute_statistics(b))
    ref = j_fid.frechet_distance(*j_fid.compute_statistics(a), *j_fid.compute_statistics(b))
    np.testing.assert_allclose(got, ref, rtol=1e-12)
    assert got > 0.1
    batches = lambda x: [x[i:i + 16] for i in range(0, len(x), 16)]
    np.testing.assert_allclose(t_fid.fid_from_feature_batches(batches(a), batches(b)),
                               j_fid.fid_from_feature_batches(batches(a), batches(b)), rtol=1e-12)
    with pytest.raises(ValueError):
        t_fid.fid_from_feature_batches([a[:1]], [b])
    probs = rng.dirichlet(np.ones(10), 40)
    assert t_fid.inception_score(probs, 4) == j_fid.inception_score(probs, 4)
    assert t_fid.precision_recall(a, b, 3) == j_fid.precision_recall(a, b, 3)


def test_inception_features_match_jax():
    """One random torchvision-layout state dict: loaded by the port directly
    and by the JAX package through `import_fid_inception_weights`; pool3
    features of two 75^2 images agree."""
    sd = t_inc.random_fid_state_dict(seed=3)
    sd["fc.weight"] = torch.zeros(1000, 2048)  # a head the extractor ignores
    model = t_inc.InceptionV3()
    assert model.load_fid_state_dict(sd) == ["fc.weight"]
    x = np.random.default_rng(2).uniform(0, 1, (2, 3, 75, 75)).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    params = j_inc.import_fid_inception_weights({k: v.numpy() for k, v in sd.items()})
    ref = np.asarray(jax.jit(j_inc.InceptionV3().apply)({"params": params}, jnp.asarray(x)))
    assert got.shape == ref.shape == (2, 2048)
    scale = float(np.abs(ref).max())
    assert scale > 1e-3  # the random features keep their scale
    np.testing.assert_allclose(got, ref, atol=ATOL * scale, rtol=RTOL)
    with pytest.raises(KeyError):
        t_inc.InceptionV3().load_fid_state_dict({"fc.weight": sd["fc.weight"]})


def test_loss_plot_readers_match_jax(tmp_path):
    run = tmp_path / "run"
    run.mkdir()
    with open(run / "metrics.jsonl", "w") as f:
        for step, loss in ((10, 0.5), (20, 0.25), (30, 0.125)):
            f.write(json.dumps({"step": step, "train/loss": loss, "train/lr": 1e-4}) + "\n")
    log = tmp_path / "log.txt"
    log.write_text("(step=0000010) Train Loss: 0.5000, x\n(step=0000020) Train Loss: 0.2500\n")
    assert t_lp.read_metrics_jsonl(str(run / "metrics.jsonl")) == \
        j_lp.read_metrics_jsonl(str(run / "metrics.jsonl")) == ([10, 20, 30], [0.5, 0.25, 0.125])
    assert t_lp.scrape_log(str(log)) == j_lp.scrape_log(str(log))
    assert t_lp.compare_runs({"a": str(run)}) == j_lp.compare_runs({"a": str(run)})
    t_lp.svg_line_plot([10, 20, 30], [0.5, 0.25, 0.125], str(tmp_path / "a.svg"), "loss")
    svg = (tmp_path / "a.svg").read_text()
    assert svg.startswith("<svg") and "<polyline" in svg and "loss" in svg
    t_lp.svg_line_plot([], [], str(tmp_path / "b.svg"), "empty")
    assert not (tmp_path / "b.svg").exists()

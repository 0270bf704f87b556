"""The port's shapes quality flow (`lumina_t2x_tpu_torch/exps/quality_flow.py`)
end to end on the CPU: the Tiny NextDiT-ImageNet at 16^2 in pixel space,
three trainer steps through the trainer CLI, a resumed fourth, the per-class
grid and an 8-image FID npz through the sampler CLI, and the judgement. The
summary's keys, its gate and its artifacts are checked, and the pixel-FID
pieces against the JAX script's (`exps/quality_demo.py`)."""

import importlib.util
import json
import os

import numpy as np
import pytest

from lumina_t2x_tpu_torch.exps import quality_flow as qf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_demo():
    spec = importlib.util.spec_from_file_location(
        "quality_demo", os.path.join(REPO, "exps", "quality_demo.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(tmp_path, steps, *extra):
    return qf.main(["--model", "NextDiT_ImageNet_Tiny_patch2", "--size", "16",
                    "--steps", str(steps), "--batch", "4", "--n_per_class", "1",
                    "--fid_samples", "8", "--sampling_steps", "3",
                    "--precision", "fp32", "--device", "cpu",
                    "--out", str(tmp_path / "out"), "--work", str(tmp_path / "work"), *extra])


def test_quality_flow_end_to_end(tmp_path):
    first = _run(tmp_path, 3)
    assert first["train"]["steps"] == 3 and first["train"]["loss_last_step"] == 3
    summary = _run(tmp_path, 4, "--inception_fid")  # resumes from step 3
    out = tmp_path / "out"
    assert summary == json.loads((out / "summary.json").read_text())
    assert summary["train"]["steps"] == 4 and summary["train"]["loss_last_step"] == 4
    # one log line a call: at step 3 (log_every 3), then at step 4 (log_every 4)
    assert summary["train"]["loss_first_step"] == 3 and np.isfinite(summary["train"]["loss_last"])
    assert sorted(summary) == ["device", "faithfulness", "image_size", "inception_fid_random_init",
                               "model", "params_m", "passed", "pixel_fid", "pixel_space",
                               "sample", "train"]
    assert summary["sample"] == {"n": 8, "steps": 3, "cfg_scale": 4.0,
                                 "seconds": summary["sample"]["seconds"], "stream": "ema"}
    fid, rep = summary["pixel_fid"], summary["faithfulness"]
    assert fid["gate_k"] == qf.FID_GATE_K and fid["real_vs_real_floor"] > 0
    assert summary["passed"] == (rep["accuracy"] >= 0.8 and rep["rejected_frac"] <= 0.1
                                 and fid["gen_vs_real"] <= qf.FID_GATE_K
                                 * fid["real_vs_real_floor"])
    assert not summary["passed"]  # four steps learn nothing
    assert rep["n"] == 8 and rep["chance"] == 1 / 16
    assert np.isfinite(list(summary["inception_fid_random_init"].values())).all()
    assert sorted(os.listdir(out / "grid")) == sorted(f"{i}_.png" for i in range(16))
    assert (out / "loss_curve.svg").read_text().startswith("<svg")
    assert len((out / "metrics.jsonl").read_text().splitlines()) == 2
    data = [d for d in os.listdir(tmp_path / "work") if d.startswith("shapes")]
    assert data == ["shapes_n1_s16_seed0"]


def test_pixel_fid_pieces_match_the_jax_script():
    demo = _jax_demo()
    imgs = np.random.default_rng(0).integers(0, 255, (6, 32, 32, 3)).astype(np.uint8)
    np.testing.assert_array_equal(qf.pixel_features(imgs), demo.pixel_features(imgs))
    got, labels = qf.render_batch(20, seed=5, size=64)
    ref, ref_labels = demo.render_batch(20, seed=5, balanced=False)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(labels, ref_labels)


@pytest.mark.parametrize("steps,every", [(2500, 50), (25000, 50), (7, 7), (120, 40), (3, 3)])
def test_log_every_divides_the_steps(steps, every):
    assert qf.log_every_for(steps) == every

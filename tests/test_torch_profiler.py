"""The port's trace capture (`lumina_t2x_tpu_torch/core/logging.ProfilerSession`,
over `torch.profiler`) and the trainer's `--profile_steps`, with JAX's step
logic (`lumina_t2x_tpu/pipelines/train.py`): the first step of a run is never
traced; N steps are traced from the second, ending at the last step; with
fewer than 2 steps left the trainer warns and writes no trace. Tiny model,
CPU (CPU activity only: no CUDA here).
"""

import json
import os
import sys

import pytest

from lumina_t2x_tpu_torch.core.logging import ProfilerSession
from lumina_t2x_tpu_torch.pipelines import train as t_train

CLI = ["--model", "NextDiT_Tiny_patch2", "--data_path", "synthetic://8x8",
       "--global_batch_size", "2", "--log_every", "1", "--ckpt_every", "100", "--qk_norm",
       "--precision", "fp32", "--cap_feat_dim", "32", "--device", "cpu"]


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    # the trainer writes TensorBoard when it imports; its import takes seconds
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def _run(tmp_path, *extra):
    t_train.main(CLI + ["--results_dir", str(tmp_path), *extra])
    exp = tmp_path / "NextDiT_Tiny_patch2"
    with open(exp / "log.txt") as f:
        return exp, f.read()


def _events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_profile_steps_writes_a_trace_of_steps_after_the_first(tmp_path):
    exp, log = _run(tmp_path, "--max_steps", "4", "--profile_steps", "2")
    traces = sorted(os.listdir(exp / "trace"))
    assert len(traces) == 1 and traces[0].endswith("_rank0.pt.trace.json")
    assert "profiler: tracing 2 steps" in log and "profiler: trace written to" in log
    names = {e.get("name") for e in _events(exp / "trace" / traces[0])}
    # the traced steps ran the model: its matmuls and the optimizer are there
    assert any(n and n.startswith("aten::") for n in names)
    assert "aten::linear" in names or "aten::addmm" in names


@pytest.mark.parametrize("extra", [["--max_steps", "1"],
                                   ["--max_steps", "3", "--auto_resume"]])
def test_profile_steps_warns_and_skips_when_fewer_than_two_steps_remain(tmp_path, extra):
    if "--auto_resume" in extra:  # 2 steps and their checkpoint first: 1 step remains
        t_train.main(CLI + ["--results_dir", str(tmp_path), "--max_steps", "2"])
    exp, log = _run(tmp_path, "--profile_steps", "2", *extra)
    assert "profiler: fewer than 2 steps remain; skipping the trace" in log
    assert not (exp / "trace").exists()


def test_profiler_session_is_a_no_op_unless_enabled(tmp_path):
    with ProfilerSession(str(tmp_path / "off")) as off:
        sum(range(10))
    assert off.stop() is None and not (tmp_path / "off").exists()
    session = ProfilerSession(str(tmp_path / "on"), enabled=True)
    with session:
        sum(range(10))
    assert os.listdir(tmp_path / "on")[0].endswith("_rank0.pt.trace.json")
    assert session.stop() is None  # stopped once, by the context

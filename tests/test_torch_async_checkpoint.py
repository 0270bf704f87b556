"""The port's asynchronous checkpoint writer
(`lumina_t2x_tpu_torch/core/checkpoint.AsyncCheckpointSaver`) and the
trainers' `--async_save`.

JAX's two saver tests (`tests/test_checkpoint.py::TestAsyncSaver`:
the completion marker waits for `wait()`, pruning keeps complete checkpoints
only) restated for the port; an in-place optimizer step right after `save`
leaves the saved tensors as they were; the files equal those of the
synchronous `save_checkpoint` tensor for tensor; an exception in the writer
thread surfaces at `close()`; and the image and music trainers with
`--async_save` write the checkpoints of a synchronous run and resume to the
same steps. Tiny models, fp32 on the CPU.
"""

import json
import os
import signal
import sys

import pytest
import torch

from lumina_t2x_tpu_torch.core import checkpoint as ckpt
from lumina_t2x_tpu_torch.core.checkpoint import (AsyncCheckpointSaver, find_auto_resume,
                                                  load_checkpoint, load_stream, save_checkpoint)
from lumina_t2x_tpu_torch.models.next_dit import NextDiT
from lumina_t2x_tpu_torch.pipelines import train as t_train
from lumina_t2x_tpu_torch.pipelines import train_audio as t_train_audio
from lumina_t2x_tpu_torch.pipelines import train_lib
from lumina_t2x_tpu_torch.transport import create_transport

TINY = dict(patch_size=2, dim=64, n_layers=2, n_heads=4, multiple_of=16, cap_feat_dim=32)
STREAMS = ("model", "ema", "optimizer")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _assert_same_tree(a, b, what):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb), what
    for key in fa:
        if isinstance(fa[key], torch.Tensor):
            assert fa[key].dtype == fb[key].dtype and torch.equal(fa[key], fb[key]), (what, key)
        else:
            assert fa[key] == fb[key], (what, key)


def _assert_same_checkpoint(a, b):
    for stream in STREAMS:
        _assert_same_tree(load_stream(a, stream), load_stream(b, stream), stream)
    for name in ("resume_step.txt",):
        with open(os.path.join(a, name)) as fa, open(os.path.join(b, name)) as fb:
            assert fa.read() == fb.read()


def _live_tree(state):
    return {"model": {k: v.clone() for k, v in state.model.state_dict().items()},
            "ema": {k: v.clone() for k, v in state.ema.items()},
            "optimizer": _flat(state.opt_state)}


def _state_and_step():
    torch.manual_seed(0)
    model = NextDiT(qk_norm=True, **TINY)
    optimizer = train_lib.create_optimizer(1e-3, 0.01)
    state = train_lib.create_train_state(model, optimizer)
    step_fn = train_lib.make_train_step(model, create_transport(), optimizer,
                                        lambda b: {"cap_feats": b["cap_feats"],
                                                   "cap_mask": b["cap_mask"]})
    g = torch.Generator().manual_seed(1)
    batch = {"x": torch.randn(2, 4, 8, 8, generator=g),
             "cap_feats": torch.randn(2, 5, 32, generator=g),
             "cap_mask": torch.ones(2, 5, dtype=torch.int32)}
    return state, lambda s: step_fn(s, batch, 0)[0]


def test_marker_waits_for_wait_and_the_files_are_the_synchronous_ones(tmp_path):
    """JAX's round trip: until wait() the checkpoint is invisible to
    auto-resume; a step right after save (in place) leaves the saved tensors
    as they were when save returned; the next save finalizes the first; the
    files equal `save_checkpoint`'s."""
    state, step = _state_and_step()
    state = step(state)
    saver = AsyncCheckpointSaver()
    path = saver.save(str(tmp_path / "a"), 1, state, model_args={"dim": 64})
    assert not os.path.exists(os.path.join(path, "resume_step.txt"))
    assert find_auto_resume(str(tmp_path / "a")) is None
    before = _live_tree(state)
    sync_path = save_checkpoint(str(tmp_path / "s"), 1, state, model_args={"dim": 64})
    state = step(state)  # the optimizer updates the parameters in place
    assert not torch.equal(before["model"]["x_embedder.weight"],
                           state.model.state_dict()["x_embedder.weight"])
    saver.save(str(tmp_path / "a"), 2, state, model_args={"dim": 64})
    assert os.path.exists(os.path.join(path, "resume_step.txt"))
    _assert_same_checkpoint(path, sync_path)
    for stream in ("model", "ema"):
        _assert_same_tree(load_stream(path, stream), before[stream], stream)
    with open(os.path.join(path, "model_args.json")) as f:
        assert json.load(f) == {"dim": 64}
    assert saver.close().endswith("0000002")
    assert find_auto_resume(str(tmp_path / "a")).endswith("0000002")
    fresh, _ = _state_and_step()
    assert load_checkpoint(find_auto_resume(str(tmp_path / "a")), fresh).step == 2
    _assert_same_tree(_live_tree(fresh)["model"], _live_tree(state)["model"], "restored")


def test_prunes_only_complete_checkpoints(tmp_path):
    """JAX's: a pending save has no marker, so keep_last never prunes it."""
    state, _ = _state_and_step()
    saver = AsyncCheckpointSaver(keep_last=1)
    saver.save(str(tmp_path), 1, state)
    saver.save(str(tmp_path), 2, state)  # finalizes #1; #2 is pending
    base = tmp_path / "checkpoints"
    assert (base / "0000001" / "resume_step.txt").exists()
    assert not (base / "0000002" / "resume_step.txt").exists()
    saver.close()  # finalizes #2, prunes #1
    assert sorted(os.listdir(base)) == ["0000002"]
    fresh, _ = _state_and_step()
    assert load_checkpoint(find_auto_resume(str(tmp_path)), fresh).step == 2


def test_writer_exception_surfaces_at_close(tmp_path, monkeypatch):
    state, _ = _state_and_step()

    def broken(path, stream, tree):
        raise OSError(f"disk full writing {stream}")

    monkeypatch.setattr(ckpt, "_write_stream", broken)
    saver = AsyncCheckpointSaver()
    path = saver.save(str(tmp_path), 1, state)
    with pytest.raises(OSError, match="disk full"):
        saver.close()
    assert not os.path.exists(os.path.join(path, "resume_step.txt"))
    assert find_auto_resume(str(tmp_path)) is None
    assert saver.close() is None  # the failed save is not retried


IMAGE_CLI = ["--model", "NextDiT_Tiny_patch2", "--data_path", "synthetic://8x8",
             "--global_batch_size", "2", "--log_every", "1", "--ckpt_every", "1", "--qk_norm",
             "--precision", "fp32", "--cap_feat_dim", "32", "--device", "cpu"]
AUDIO_CLI = ["--latent_channels", "4", "--latent_length", "16", "--context_dim", "32",
             "--context_len", "8", "--hidden_size", "64", "--depth", "2", "--num_heads", "4",
             "--global_batch_size", "2", "--log_every", "1", "--ckpt_every", "1",
             "--precision", "fp32", "--device", "cpu"]


@pytest.mark.parametrize("trainer", ["image", "audio"])
def test_trainer_async_save_equals_the_synchronous_run_and_resumes(tmp_path, monkeypatch,
                                                                    trainer):
    """2 steps saving at each, with and without --async_save: the same
    checkpoints tensor for tensor; the async run resumed to a 3rd step
    equals the synchronous run taken to 3. (TensorBoard, which the trainers
    write to when it imports, is held out: its import takes seconds.)"""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    main, cli, sub = ((t_train.main, IMAGE_CLI, "NextDiT_Tiny_patch2") if trainer == "image"
                      else (t_train_audio.main, AUDIO_CLI, "music"))

    def run(name, steps, *extra):
        return main(cli + ["--results_dir", str(tmp_path / name), "--max_steps", str(steps),
                           *extra])

    run("async", 2, "--async_save")
    run("sync", 3)
    for step in (1, 2):
        name = f"{step:07d}"
        _assert_same_checkpoint(str(tmp_path / "async" / sub / "checkpoints" / name),
                                str(tmp_path / "sync" / sub / "checkpoints" / name))
    resumed = run("async", 3, "--async_save", "--auto_resume")
    assert resumed.step == 3
    _assert_same_checkpoint(str(tmp_path / "async" / sub / "checkpoints" / "0000003"),
                            str(tmp_path / "sync" / sub / "checkpoints" / "0000003"))


def test_sigterm_saves_and_closes_before_exiting(tmp_path, monkeypatch):
    """JAX's SIGTERM path under --async_save: the step boundary after the
    signal saves through the saver and closes it, so the checkpoint is
    complete when the trainer returns."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    make_step = t_train.make_train_step

    def signalling(*args, **kwargs):
        step_fn = make_step(*args, **kwargs)

        def step(*a, **k):
            out = step_fn(*a, **k)
            os.kill(os.getpid(), signal.SIGTERM)
            return out

        return step

    monkeypatch.setattr(t_train, "make_train_step", signalling)
    state = t_train.main(IMAGE_CLI + ["--results_dir", str(tmp_path), "--max_steps", "5",
                                      "--ckpt_every", "100", "--async_save"])
    assert state.step == 1
    path = find_auto_resume(str(tmp_path / "NextDiT_Tiny_patch2"))
    assert path.endswith("0000001")
    fresh, _ = _state_and_step()
    assert load_checkpoint(path, fresh).step == 1

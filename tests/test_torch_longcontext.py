"""The port's 128K-token forward script
(`lumina_t2x_tpu_torch/exps/longcontext_forward.py`) at a tiny size on the
CPU: its token grid against the JAX script's `grid_for_tokens`, one warm and
one timed forward of the Tiny NextDiT through `forward_stats`, and `main`'s
JSON line. The 131072-token run itself is the card's (`chip_smoke.py`)."""

import functools
import importlib.util
import json
import os

import pytest
import torch

from lumina_t2x_tpu_torch.exps import longcontext_forward as lc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@functools.lru_cache(maxsize=None)
def _jax_script():
    """The repository's JAX script, loaded with its compile cache stubbed
    out (it turns on a persistent XLA cache when imported)."""
    import lumina_t2x_tpu.core.logging as jlog

    real = jlog.enable_compile_cache
    jlog.enable_compile_cache = lambda *a, **k: None
    try:
        spec = importlib.util.spec_from_file_location(
            "jax_longcontext_forward", os.path.join(REPO, "exps", "longcontext_forward.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        jlog.enable_compile_cache = real
    return module


@pytest.mark.parametrize("tokens", [1, 2, 64, 128, 4096, 131072, 1 << 20])
def test_grid_for_tokens_matches_jax(tokens):
    assert lc.grid_for_tokens(tokens) == _jax_script().grid_for_tokens(tokens)
    gh, gw = lc.grid_for_tokens(tokens)
    assert gh * gw == tokens
    assert lc.grid_for_tokens(131072) == (512, 256)
    with pytest.raises(ValueError):
        lc.grid_for_tokens(3000)


def test_forward_stats_of_a_tiny_model(capsys):
    model = lc.build_model("NextDiT_Tiny_patch2", device="cpu", dtype=torch.float32,
                           param_dtype=torch.float32)
    stats = lc.forward_stats(model, tokens=64, cap_len=8, steps=1)
    assert stats["grid"] == [8, 8] and stats["latent"] == [16, 16]
    assert stats["finite"] and len(stats["ms_all"]) == 1 and stats["tokens_per_sec"] > 0
    assert stats["peak_gib"] is None and stats["device"] == "cpu"
    printed = lc.main(["--model", "NextDiT_Tiny_patch2", "--tokens", "32", "--cap_len", "4",
                       "--steps", "1", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == printed and line["tokens"] == 32 and line["grid"] == [8, 4]
    assert line["model"] == "NextDiT_Tiny_patch2" and line["finite"]

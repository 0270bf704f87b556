"""The port's kernel build (`lumina_t2x_tpu_torch/ops/cuda_lib.py`): one
library per module that owns kernels, keyed by a hash of its own sources and
the local headers they include. Nothing here compiles: there is no nvcc on
the CPU test machines."""

import shutil

import pytest

from lumina_t2x_tpu_torch.exps import mxu_k_quantum as mxu
from lumina_t2x_tpu_torch.exps import vpu_op_reduction as vpu
from lumina_t2x_tpu_torch.ops import cuda_lib
from lumina_t2x_tpu_torch.ops import flash_attention as fa


@pytest.mark.parametrize("module,sources,symbol", [
    (fa, ["flash_fwd.cu", "flash_bwd.cu", "flash_fwd_sm90.cu", "flash_bwd_sm90.cu",
          "rope_rotate.cu"], "lumina_rope_rotate"),
    (vpu, ["static_max_sm90.cu"], "lumina_static_max_v3"),
    (mxu, ["mma_probe.cu"], "lumina_mma_chain"),
])
def test_each_module_declares_its_library(module, sources, symbol):
    declared_sources, symbols = cuda_lib._DECLARED[module.LIBRARY]
    assert declared_sources == sources and symbol in symbols
    assert cuda_lib.BUILD_INFO[module.LIBRARY]["path"] is None  # nothing built on import


def test_hash_inputs_follow_local_includes():
    assert cuda_lib._inputs(["static_max_sm90.cu"]) == ["static_max_sm90.cu", "sm90_common.cuh"]
    assert cuda_lib._inputs(["mma_probe.cu"]) == ["mma_probe.cu", "mma_probe_wgmma.cuh",
                                                  "sm90_common.cuh", "warp_mma.cuh"]
    assert cuda_lib._inputs(["flash_fwd.cu", "flash_bwd.cu", "flash_fwd_sm90.cu",
                             "flash_bwd_sm90.cu", "rope_rotate.cu"]) == [
        "flash_fwd.cu", "flash_bwd.cu", "flash_fwd_sm90.cu", "flash_bwd_sm90.cu",
        "rope_rotate.cu", "flash_fwd_sm90.cuh", "flash_bwd_sm90.cuh", "sm90_common.cuh"]


def test_an_experiment_edit_leaves_the_flash_library(tmp_path, monkeypatch):
    """Editing an experiment source or the header only the probe includes
    changes that library's path alone, never K1-K9's."""
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_lib._CSRC, csrc)
    monkeypatch.setattr(cuda_lib, "_CSRC", csrc)
    before = {name: cuda_lib._lib_path(name) for name in (fa.LIBRARY, vpu.LIBRARY, mxu.LIBRARY)}
    (csrc / "mma_probe.cu").write_text((csrc / "mma_probe.cu").read_text() + "\n// edit\n")
    after = {name: cuda_lib._lib_path(name) for name in before}
    assert after[fa.LIBRARY] == before[fa.LIBRARY] and after[vpu.LIBRARY] == before[vpu.LIBRARY]
    assert after[mxu.LIBRARY] != before[mxu.LIBRARY]
    (csrc / "warp_mma.cuh").write_text((csrc / "warp_mma.cuh").read_text() + "\n// edit\n")
    again = {name: cuda_lib._lib_path(name) for name in before}
    assert again[fa.LIBRARY] == before[fa.LIBRARY] and again[vpu.LIBRARY] == before[vpu.LIBRARY]
    assert again[mxu.LIBRARY] != after[mxu.LIBRARY]
    (csrc / "static_max_sm90.cu").write_text(
        (csrc / "static_max_sm90.cu").read_text() + "\n// edit\n")
    third = {name: cuda_lib._lib_path(name) for name in before}
    assert third[fa.LIBRARY] == before[fa.LIBRARY] and third[mxu.LIBRARY] == again[mxu.LIBRARY]
    assert third[vpu.LIBRARY] != before[vpu.LIBRARY]
    assert after[fa.LIBRARY].name == "libflash.so"


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_lib, "_BUILD_ROOT", tmp_path / "kernels")
    monkeypatch.setattr(cuda_lib.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(cuda_lib, "_LIBS", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_lib.build_library(mxu.LIBRARY)
    assert cuda_lib._LIBS == {}

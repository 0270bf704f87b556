"""Build and load the port's CUDA kernels.

Each module that owns kernels declares a library with `declare`: a name,
its sources in `lumina_t2x_tpu_torch/csrc/` and its C entry points with
their argument types. At first use `build_library(name)` compiles those
sources with `nvcc` for sm_90a into `build/kernels/<hash>/lib<name>.so` at
the repository root, one nvcc process per source, all started together,
loads the library with ctypes and binds its entry points. The hash covers
the flags, the sources and the local headers they include, so a changed
source rebuilds only its own library: the model paths never compile the
experiment kernels. Nothing here runs when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_NVCC_FLAGS = [*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# per library: seconds of its build_library call, its path, whether this
# process compiled it, and what `-Xptxas -v` printed (registers, spills)
BUILD_INFO: dict[str, dict] = {}
_DECLARED: dict[str, tuple[list[str], dict]] = {}  # name -> (sources, entry point -> argtypes)
_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def declare(name: str, sources: list[str], symbols: dict[str, list]) -> None:
    """Record library `name`: its sources (file names in csrc/) and its C
    entry points (name -> argtypes; each returns a cudaError_t as int)."""
    _DECLARED[name] = (list(sources), dict(symbols))
    BUILD_INFO[name] = {"seconds": None, "path": None, "compiled": False, "ptxas": ""}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not default.exists():
        raise RuntimeError("nvcc not found: the kernels are built from "
                           "lumina_t2x_tpu_torch/csrc with the CUDA toolkit")
    return str(default)


def dump_sass(lib_path) -> dict:
    """{mangled kernel name: [SASS mnemonics in order]} of a built library,
    from `cuobjdump --dump-sass` (the CUDA toolkit's, beside nvcc)."""
    tool = Path(nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "--dump-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    kernels, current = {}, None
    for line in text.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            current = kernels.setdefault(head.group(1), [])
            continue
        op = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if op and current is not None:
            current.append(op.group(1))
    return kernels


def _inputs(sources):
    """The sources and the local headers they include, transitively."""
    seen, todo = [], list(sources)
    while todo:
        name = todo.pop(0)
        if name in seen:
            continue
        seen.append(name)
        todo += re.findall(r'#include\s+"([^"]+)"', (_CSRC / name).read_text())
    return seen


def _lib_path(name):
    sources = _DECLARED[name][0]
    digest = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for src in _inputs(sources):
        digest.update(src.encode())
        digest.update((_CSRC / src).read_bytes())
    return _BUILD_ROOT / digest.hexdigest()[:16] / f"lib{name}.so"


def build_libraries(names=None) -> dict:
    """Build (once per source version), load and bind the named libraries,
    every declared one by default; the nvcc processes of all of them start
    together. Returns {name: ctypes.CDLL}."""
    names = list(_DECLARED) if names is None else list(names)
    with _LOCK:
        todo = [name for name in names if name not in _LIBS]
        t0 = time.perf_counter()
        paths = {name: _lib_path(name) for name in todo}
        compiler, pid = None, os.getpid()
        jobs = []  # (library, source, object, process)
        for name in todo:
            if paths[name].exists():
                continue
            compiler = compiler or nvcc()
            paths[name].parent.mkdir(parents=True, exist_ok=True)
            for src in _DECLARED[name][0]:
                obj = paths[name].parent / f"{Path(src).stem}.{pid}.o"
                jobs.append((name, src, obj, subprocess.Popen(
                    [compiler, *_NVCC_FLAGS, "-c", str(_CSRC / src), "-o", str(obj)],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        logs = [proc.communicate() for *_, proc in jobs]
        for (_, src, _, proc), (out, err) in zip(jobs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src} ({proc.returncode}):\n{out}\n{err}")
        for name in dict.fromkeys(job[0] for job in jobs):
            objs = [obj for lib, _, obj, _ in jobs if lib == name]
            tmp = paths[name].with_suffix(f".{pid}.so")
            proc = subprocess.run([compiler, *_ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc link of {name} failed ({proc.returncode}):\n"
                                   f"{proc.stdout}\n{proc.stderr}")
            BUILD_INFO[name]["ptxas"] = "".join(
                err for (lib, *_), (_, err) in zip(jobs, logs) if lib == name)
            BUILD_INFO[name]["compiled"] = True
            os.replace(tmp, paths[name])
            for obj in objs:
                obj.unlink()
        for name in todo:
            lib = ctypes.CDLL(str(paths[name]))
            for symbol, argtypes in _DECLARED[name][1].items():
                fn = getattr(lib, symbol)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            BUILD_INFO[name]["seconds"] = time.perf_counter() - t0
            BUILD_INFO[name]["path"] = str(paths[name])
            _LIBS[name] = lib
        return {name: _LIBS[name] for name in names}


def build_library(name: str) -> ctypes.CDLL:
    """Library `name`, built, loaded and bound at its first call."""
    lib = _LIBS.get(name)
    return lib if lib is not None else build_libraries([name])[name]

"""Builds the port's CUDA kernels with ``nvcc`` at first use and loads them
with ``ctypes``.

Each ``csrc/<name>.cu`` becomes ``build/repro_torch_kernels/<hash>/lib<name>.so``
under the repository root, where ``<hash>`` covers every source under
``csrc/`` and the compiler flags, so an edited source builds anew and an
unchanged one is loaded from disk. The entry points are plain C functions
(no PyTorch headers), which keeps a build to seconds. Nothing is built or
loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["CSRC", "NVCC_FLAGS", "build_dir", "library", "nvcc_command", "time_builds"]

CSRC = Path(__file__).resolve().parent / "csrc"
# The repository root: src/repro_torch/kernels/build.py -> parents[3].
_ROOT = Path(__file__).resolve().parents[3]

# No --use_fast_math: it turns on flush-to-zero and would break bit-identity
# with the IEEE float32 oracle. -Xptxas -v reports registers and spills in
# the build log.
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; cannot build the CUDA kernels")


def build_dir() -> Path:
    """``build/repro_torch_kernels/<hash of csrc sources and flags>``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _ROOT / "build" / "repro_torch_kernels" / h.hexdigest()[:16]


def nvcc_command(name: str, out: Path) -> list[str]:
    """The nvcc command line that builds ``csrc/<name>.cu`` into ``out``."""
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def _build(names, out_dir: Path):
    """Builds ``csrc/<name>.cu`` into ``out_dir/lib<name>.so`` for each of
    ``names``, one nvcc process each, all started together. Each library is
    built under a temporary name and renamed into place, so a concurrent
    build never loads a half-written one; each log goes to ``<name>.log``.
    Raises after every build has ended if any failed."""
    _nvcc()  # raises before a temporary file is made
    out_dir.mkdir(parents=True, exist_ok=True)
    started = []
    for name in names:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        proc = subprocess.Popen(nvcc_command(name, Path(tmp)), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started.append((name, tmp, proc))
    errors = []
    for name, tmp, proc in started:
        log, _ = proc.communicate()
        (out_dir / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed building {name}.cu:\n{log}")
        else:
            os.replace(tmp, out_dir / f"lib{name}.so")
    if errors:
        raise RuntimeError("\n".join(errors))


def _sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library(name: str) -> ctypes.CDLL:
    """The loaded ``lib<name>.so``. If it is not on disk yet, every source
    whose library is missing from the build directory is built, in parallel:
    the directory's hash covers all of them, so an edit to any source leaves
    every library to build anew."""
    if name in _loaded:
        return _loaded[name]
    out_dir = build_dir()
    lib_path = out_dir / f"lib{name}.so"
    if not lib_path.is_file():
        _build([n for n in _sources() if not (out_dir / f"lib{n}.so").is_file()], out_dir)
    lib = ctypes.CDLL(str(lib_path))
    _loaded[name] = lib
    return lib


def time_builds() -> dict:
    """Seconds to build every source one after another and all together,
    each into a fresh directory under ``build/`` that is removed afterwards."""
    root = _ROOT / "build" / "repro_torch_kernels" / "timing"
    shutil.rmtree(root, ignore_errors=True)
    names = _sources()
    try:
        t0 = time.perf_counter()
        for name in names:
            _build([name], root / "serial")
        serial = time.perf_counter() - t0
        t0 = time.perf_counter()
        _build(names, root / "parallel")
        parallel = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"sources": names, "serial_s": serial, "parallel_s": parallel}


if __name__ == "__main__":  # python -m repro_torch.kernels.build: serial vs parallel build time
    import json

    print(json.dumps(time_builds()))

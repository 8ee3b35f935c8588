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
from pathlib import Path

__all__ = ["CSRC", "NVCC_FLAGS", "build_dir", "library", "nvcc_command"]

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


def library(name: str) -> ctypes.CDLL:
    """The loaded ``lib<name>.so``, built from ``csrc/<name>.cu`` if it is not
    on disk yet. The compiler's output goes to ``<build dir>/<name>.log``."""
    if name in _loaded:
        return _loaded[name]
    out_dir = build_dir()
    lib_path = out_dir / f"lib{name}.so"
    if not lib_path.is_file():
        out_dir.mkdir(parents=True, exist_ok=True)
        # build under a temporary name, then rename: a concurrent build
        # never loads a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        proc = subprocess.run(nvcc_command(name, Path(tmp)), capture_output=True, text=True)
        (out_dir / f"{name}.log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed building {name}.cu:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    _loaded[name] = lib
    return lib

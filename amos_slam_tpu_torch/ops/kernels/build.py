"""Build the port's CUDA sources with nvcc and load them through ctypes.

Each ``csrc/<name>.cu`` exports plain C functions and is compiled on its own
into ``build/kernels/<name>-<hash>.so`` beside the package, the hash taken
over the source and the flags, so an edited source is rebuilt and an
unchanged one is reused. Nothing here runs at import: a library is built the
first time a wrapper launches its kernel (or when :func:`build` is called).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Iterable

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME or put nvcc on PATH)")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


def source_path(name: str) -> Path:
    return CSRC_DIR / f"{name}.cu"


def library_path(name: str) -> Path:
    digest = hashlib.sha256(
        source_path(name).read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def log_path(name: str) -> Path:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills)."""
    return library_path(name).with_suffix(".log")


def build(names: Iterable[str]) -> None:
    """Compile every named source that is not built yet, one nvcc process
    per source, all started together. Raises if any compile fails."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    try:
        for name in todo:
            out = library_path(name)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            with open(log_path(name), "w") as log:
                p = subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source_path(name))],
                    stdout=log, stderr=subprocess.STDOUT,
                )
            procs.append((name, p, tmp, out))
        failed = []
        for name, p, tmp, out in procs:
            if p.wait() != 0:
                failed.append(name)
            else:
                os.replace(tmp, out)
    finally:
        for _, p, _, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        logs = "\n".join(log_path(n).read_text() for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it if needed."""
    if name not in _loaded:
        build([name])
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]

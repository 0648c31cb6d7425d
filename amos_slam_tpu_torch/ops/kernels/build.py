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
from typing import Dict, Iterable, List, Sequence, Tuple

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


def _library_path(source: Path, flags: Sequence[str]) -> Path:
    digest = hashlib.sha256(source.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}-{digest}.so"


def library_path(name: str) -> Path:
    return _library_path(source_path(name), NVCC_FLAGS)


def log_path(name: str) -> Path:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills)."""
    return library_path(name).with_suffix(".log")


def _compile(jobs: Sequence[Tuple[Path, Sequence[str]]]) -> List[Path]:
    """Compile each (source, flags) job that is not built yet, one nvcc
    process per job, all started together. Returns the libraries' paths;
    raises if any compile fails."""
    outs = [_library_path(src, flags) for src, flags in jobs]
    todo = [(src, flags, out) for (src, flags), out in zip(jobs, outs) if not out.exists()]
    if not todo:
        return outs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    try:
        for src, flags, out in todo:
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            with open(out.with_suffix(".log"), "w") as log:
                p = subprocess.Popen([nvcc, *flags, "-o", str(tmp), str(src)],
                                     stdout=log, stderr=subprocess.STDOUT)
            procs.append((src, p, tmp, out))
        failed = []
        for src, p, tmp, out in procs:
            if p.wait() != 0:
                failed.append((src, out))
            else:
                os.replace(tmp, out)
    finally:
        for _, p, _, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        logs = "\n".join(out.with_suffix(".log").read_text() for _, out in failed)
        raise RuntimeError(f"nvcc failed for {[str(s) for s, _ in failed]}:\n{logs}")
    return outs


def build(names: Iterable[str]) -> None:
    """Compile every named ``csrc/`` source that is not built yet, all
    together. Raises if any compile fails."""
    _compile([(source_path(n), NVCC_FLAGS) for n in names])


def build_sources(jobs: Sequence[Tuple[Path, Sequence[str]]]) -> List[Path]:
    """Compile any sources, each with NVCC_FLAGS plus its own extra flags
    (``-D`` switches, say), all together, into ``build/kernels/``; for
    timing variants of a kernel. Returns the libraries' paths."""
    return _compile([(Path(src), (*NVCC_FLAGS, *extra)) for src, extra in jobs])


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it if needed."""
    if name not in _loaded:
        build([name])
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]

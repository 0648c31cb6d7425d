"""ctypes bindings for the native C++ dataset loader (port of
io/native_loader.py, onto ``native/loader.cc``).

The reference's host runtime is C++ (its dataset mains decode with OpenCV,
Examples/RGB-D/rgbd_tum.cc); this is the framework's native equivalent: PNG
decode + luma/metric-depth conversion + multi-threaded prefetch, so the
Python host loop never blocks on IO.

The library is built at first use from ``native/loader.cc`` with the flags
of ``native/build.sh`` into ``build/native/`` beside the package (keyed by
a hash of the source and the flags; ``native/`` itself is never written).
When it cannot be built, every entry point raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "loader.cc"
BUILD_DIR = ROOT / "build" / "native"
# native/build.sh's flags
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")
LIBS = ("-lz", "-lpthread")

_LIB = None


def library_path() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXX_FLAGS + LIBS + (platform.machine(),)).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"libaslloader-{digest}.so"


def build() -> Path:
    """Compile ``native/loader.cc`` unless it is built; raise RuntimeError
    when it cannot be."""
    if not SOURCE.exists():
        raise RuntimeError(f"native loader source missing: {SOURCE}")
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("native loader not built: no C++ compiler (g++) found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        res = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp), *LIBS],
                             capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native loader build failed: {e}") from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native loader build failed:\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    try:
        lib = ctypes.CDLL(str(build()))
    except OSError as e:
        raise RuntimeError(f"native loader does not load: {e}") from e
    lib.asl_decode_png.restype = ctypes.c_int64
    lib.asl_decode_png.argtypes = [ctypes.c_char_p, ctypes.c_float, ctypes.c_int]
    lib.asl_loader_create.restype = ctypes.c_int64
    lib.asl_loader_create.argtypes = [ctypes.c_float, ctypes.c_int, ctypes.c_int]
    lib.asl_loader_add.argtypes = [ctypes.c_int64, ctypes.c_char_p, ctypes.c_char_p]
    lib.asl_loader_get.restype = ctypes.c_int64
    lib.asl_loader_get.argtypes = [ctypes.c_int64, ctypes.c_int64]
    lib.asl_loader_destroy.argtypes = [ctypes.c_int64]
    for name in ("width", "height", "has_depth", "has_rgb"):
        fn = getattr(lib, f"asl_frame_{name}")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int64]
    lib.asl_frame_copy_gray.argtypes = [ctypes.c_int64, ctypes.POINTER(ctypes.c_float)]
    lib.asl_frame_copy_depth.argtypes = [ctypes.c_int64, ctypes.POINTER(ctypes.c_float)]
    lib.asl_frame_copy_rgb.argtypes = [ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8)]
    lib.asl_frame_release.argtypes = [ctypes.c_int64]
    _LIB = lib
    return lib


def available() -> bool:
    try:
        _load()
        return True
    except RuntimeError:
        return False


def _frame_to_arrays(lib, handle, has_gray: bool = True):
    w = lib.asl_frame_width(handle)
    h = lib.asl_frame_height(handle)
    gray = None
    if has_gray:
        gray = np.empty((h, w), np.float32)
        lib.asl_frame_copy_gray(
            handle, gray.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        )
    depth = None
    if lib.asl_frame_has_depth(handle):
        depth = np.empty((h, w), np.float32)
        lib.asl_frame_copy_depth(
            handle, depth.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        )
    rgb = None
    if lib.asl_frame_has_rgb(handle):
        rgb = np.empty((h, w, 3), np.uint8)
        lib.asl_frame_copy_rgb(
            handle, rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        )
    lib.asl_frame_release(handle)
    return gray, depth, rgb


def decode_png(path: str, depth_factor: float = 5000.0, is_depth: bool = False):
    """Decode one PNG natively -> (gray, depth, rgb) (unused slots None).

    A depth decode holds no grey plane, so its ``gray`` is None (the JAX
    package's binding copies one out of the empty buffer there)."""
    lib = _load()
    handle = lib.asl_decode_png(path.encode(), depth_factor, int(is_depth))
    if handle == 0:
        raise RuntimeError(f"native decode failed: {path}")
    return _frame_to_arrays(lib, handle, has_gray=not is_depth)


class NativePrefetchLoader:
    """Prefetching RGB-D sequence loader backed by the C++ thread pool.

    The pool hands each index out once (a second request would wait for
    ever, in the JAX package's binding too); an index read again is decoded
    anew with :func:`decode_png`, to the same arrays."""

    def __init__(
        self,
        items: List[Tuple[float, str, Optional[str]]],  # (t, rgb, depth|None)
        depth_factor: float = 5000.0,
        n_workers: int = 4,
        ahead: int = 8,
    ):
        self.handle = 0
        self.lib = _load()
        self.items = list(items)
        self.depth_factor = depth_factor
        self._served = set()
        self.timestamps = [t for (t, _, _) in items]
        self.handle = self.lib.asl_loader_create(depth_factor, n_workers, ahead)
        for (_, rgb, dep) in items:
            self.lib.asl_loader_add(
                self.handle, rgb.encode(), dep.encode() if dep else None
            )

    def __len__(self):
        return len(self.timestamps)

    def __getitem__(self, i: int):
        if i in self._served:
            _, rgb_path, depth_path = self.items[i]
            gray, _, rgb = decode_png(rgb_path)
            depth = None
            if depth_path:
                depth = decode_png(depth_path, self.depth_factor, is_depth=True)[1]
            return gray, depth, rgb, self.timestamps[i]
        fh = self.lib.asl_loader_get(self.handle, i)
        if fh == 0:
            raise RuntimeError(f"native loader failed at index {i}")
        self._served.add(i)
        gray, depth, rgb = _frame_to_arrays(self.lib, fh)
        return gray, depth, rgb, self.timestamps[i]

    def close(self):
        if self.handle:
            self.lib.asl_loader_destroy(self.handle)
            self.handle = 0

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

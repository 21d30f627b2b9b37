"""Native (C++) data-loader bindings.

The reference implements its IO layer natively (Rust: ``helper.rs:13-36``
u16-PNG decode, the ``image`` crate's ``to_luma`` at ``vors_track.rs:143``);
this package binds the C++ equivalent (``native/vors_io.cpp``: libpng decode
plus a multi-threaded prefetching frame loader) via ctypes.

The library is compiled with ``g++`` against libpng on first use, and again
whenever ``native/vors_io.cpp`` is newer than it, so it is only ever built
from the committed source; it is cached next to this file.  Every entry
point degrades gracefully: ``available()`` is False when the toolchain or
libpng is missing, and callers (``dataset``) fall back to the numpy PNG
codec (``dataset.png``) with identical numerics.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, os.pardir, os.pardir, "native", "vors_io.cpp")
_SO = os.path.join(_HERE, "libvors_io.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _compile() -> bool:
    src = os.path.abspath(_SRC)
    if not os.path.exists(src):
        return False
    cmd = [
        os.environ.get("CXX", "g++"),
        "-O3", "-std=c++17", "-fPIC", "-shared", "-Wall",
        src, "-lpng", "-lz", "-lpthread", "-o", _SO,
    ]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return False
    return proc.returncode == 0 and os.path.exists(_SO)


def _stale() -> bool:
    """True when the shared object is missing or older than its source."""
    if not os.path.exists(_SO):
        return True
    src = os.path.abspath(_SRC)
    return os.path.exists(src) and os.path.getmtime(src) > os.path.getmtime(_SO)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        if _stale() and not _compile():
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            _load_failed = True
            return None
        lib.vors_last_error.restype = ctypes.c_char_p
        lib.vors_png_dims.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.vors_read_png16.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint16),
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.vors_read_gray.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.vors_loader_create.restype = ctypes.c_void_p
        lib.vors_loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.vors_loader_next.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint16),
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.vors_loader_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    """True when the native library is loadable (compiling it if needed)."""
    return _load() is not None


def _last_error(lib: ctypes.CDLL) -> str:
    msg = lib.vors_last_error()
    return msg.decode() if msg else "unknown native IO error"


def png_dims(path: str) -> Tuple[int, int]:
    """(height, width) of a PNG file."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native IO library unavailable")
    h = ctypes.c_int()
    w = ctypes.c_int()
    if lib.vors_png_dims(path.encode(), ctypes.byref(h), ctypes.byref(w)) != 0:
        raise IOError(_last_error(lib))
    return h.value, w.value


def read_png_16bits(path: str) -> np.ndarray:
    """u16 depth PNG → (H, W) uint16 (native analog of helper.rs:13-36)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native IO library unavailable")
    h, w = png_dims(path)
    out = np.empty((h, w), dtype=np.uint16)
    rc = lib.vors_read_png16(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), h, w
    )
    if rc != 0:
        raise IOError(_last_error(lib))
    return out


def read_gray(path: str) -> np.ndarray:
    """Color/gray PNG → (H, W) uint8 BT.601 luma (image::to_luma parity)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native IO library unavailable")
    h, w = png_dims(path)
    out = np.empty((h, w), dtype=np.uint8)
    rc = lib.vors_read_gray(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w
    )
    if rc != 0:
        raise IOError(_last_error(lib))
    return out


class PrefetchLoader:
    """Multi-threaded in-order (depth u16, gray u8) frame loader.

    The native worker pool decodes up to ``max_ahead`` frames ahead of the
    consumer so PNG decode overlaps device compute — the green-field upgrade
    over the reference's decode-on-the-tracking-thread loop
    (vors_track.rs:49-64, 140-145).  Usable as a context manager and as an
    iterator over (depth, gray) pairs.
    """

    def __init__(
        self,
        depth_paths: Sequence[str],
        color_paths: Sequence[str],
        height: int,
        width: int,
        num_threads: int = 4,
        max_ahead: int = 8,
    ):
        if len(depth_paths) != len(color_paths):
            raise ValueError("depth/color path lists must be the same length")
        lib = _load()
        if lib is None:
            raise RuntimeError("native IO library unavailable")
        self._lib = lib
        self._n = len(depth_paths)
        self._height = height
        self._width = width
        d = (ctypes.c_char_p * self._n)(*[p.encode() for p in depth_paths])
        c = (ctypes.c_char_p * self._n)(*[p.encode() for p in color_paths])
        self._handle = lib.vors_loader_create(
            d, c, self._n, height, width, num_threads, max_ahead
        )
        if not self._handle:
            raise RuntimeError("failed to create native loader")

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        return self

    def __next__(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._handle is None:
            raise StopIteration
        depth = np.empty((self._height, self._width), dtype=np.uint16)
        gray = np.empty((self._height, self._width), dtype=np.uint8)
        rc = self._lib.vors_loader_next(
            self._handle,
            depth.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            gray.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        if rc == -1:
            raise StopIteration
        if rc != 0:
            raise IOError(_last_error(self._lib))
        return depth, gray

    def close(self) -> None:
        if self._handle is not None:
            self._lib.vors_loader_destroy(self._handle)
            self._handle = None

    def __enter__(self) -> "PrefetchLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass

"""ctypes bindings for the native shard reader / writer (``shardio.cpp``).

At first use the library is compiled from ``shardio.cpp`` with ``g++ -O3
-fPIC -std=c++17 -shared`` into ``build/torch_shardio/`` at the root of the
checkout (git-ignored), under a file name that carries a hash of the source
and flags, so an edited source is never served by a stale build. A build
writes a temporary file and renames it into place, so processes that build
at once each end with a whole library. ``available()`` gates every use:
without g++, or after a failed build, ``shard_format.py`` keeps its numpy
path.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

SRC = Path(__file__).resolve().parent / "shardio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_shardio"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_P8 = ctypes.POINTER(ctypes.c_uint8)
_lock = threading.Lock()
_lib = None
_tried = False


def library_path(build_dir=BUILD_DIR) -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SRC.read_bytes()).hexdigest()[:16]
    return Path(build_dir) / f"libvitorch_shardio_{h}.so"


def build_library(build_dir=BUILD_DIR) -> Path:
    """Compile shardio.cpp into ``build_dir`` (a no-op when the hashed
    library is there) and return the library's path."""
    out = library_path(build_dir)
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=out.parent, prefix=out.name + ".", suffix=".tmp")
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(SRC)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, out)  # atomic: a concurrent build sees all or none
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(build_library()))
        except (OSError, subprocess.SubprocessError):
            return None
        lib.vix_write_file.argtypes = [ctypes.c_char_p, _P8, ctypes.c_uint64]
        lib.vix_write_file.restype = ctypes.c_int
        lib.vix_file_size.argtypes = [ctypes.c_char_p]
        lib.vix_file_size.restype = ctypes.c_int64
        lib.vix_read_file.argtypes = [ctypes.c_char_p, _P8, ctypes.c_uint64, ctypes.c_uint64]
        lib.vix_read_file.restype = ctypes.c_int64
        lib.vix_mmap_open.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64)]
        lib.vix_mmap_open.restype = ctypes.c_void_p
        lib.vix_mmap_close.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.vix_mmap_close.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def write_file(path: str, data: bytes) -> None:
    """Write ``data`` to ``path`` (truncating) and fsync it."""
    lib = _load()
    rc = lib.vix_write_file(path.encode(), ctypes.cast(data, _P8), len(data))
    if rc != 0:
        raise OSError(-rc, os.strerror(-rc), path)


def read_file(path: str, offset: int = 0, size: Optional[int] = None) -> bytes:
    """Up to ``size`` bytes of ``path`` from ``offset`` (to the end when
    ``size`` is None); fewer at the end of the file."""
    lib = _load()
    if size is None:
        total = lib.vix_file_size(path.encode())
        if total < 0:
            raise OSError(-total, os.strerror(-total), path)
        size = max(int(total) - offset, 0)
    buf = bytearray(size)
    got = lib.vix_read_file(path.encode(), (ctypes.c_uint8 * size).from_buffer(buf),
                            offset, size)
    if got < 0:
        raise OSError(-got, os.strerror(-got), path)
    return bytes(memoryview(buf)[:got])


@contextlib.contextmanager
def mmap_view(path: str):
    """Zero-copy read-only view of a file (MADV_SEQUENTIAL | WILLNEED).

    Yields a read-only memoryview over the mapping. The mapping is released
    on exit, so callers copy anything they keep (the shard parsers copy
    every array they return). An empty or unmappable file raises OSError."""
    lib = _load()
    size = ctypes.c_uint64(0)
    addr = lib.vix_mmap_open(path.encode(), ctypes.byref(size))
    if not addr:
        raise OSError(f"mmap failed: {path}")
    try:
        arr = (ctypes.c_uint8 * size.value).from_address(addr)
        yield memoryview(arr).toreadonly()
    finally:
        lib.vix_mmap_close(addr, size)

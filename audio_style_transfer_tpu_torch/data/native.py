"""ctypes binding of the repository's multithreaded C++ TFRecord reader
(counterpart of audio_style_transfer_tpu/data/native.py).

The reader's source is ``csrc/tfrecord_reader.cc`` at the repository root,
shared with the JAX package and only read here. ``g++`` compiles it at first
use into ``build/tfrecord/`` (listed in .gitignore), named by a hash of the
source and flags, so an edited source is rebuilt. Without ``g++`` or the
source the library is unavailable and ``data/nsynth.py`` reads with the
pure-Python reader of data/tfrecord.py: the same framing and records, on one
thread.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Iterator

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "csrc" / "tfrecord_reader.cc"
BUILD_DIR = _ROOT / "build" / "tfrecord"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libtfrec_{h.hexdigest()[:16]}.so"


def _build_library() -> Path | None:
    """Compile the reader unless this source's library exists; None when it
    cannot be built (no source, no g++, a compile error)."""
    if not SOURCE.exists():
        return None
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        tmp = os.path.join(tmpdir, out.name)
        try:
            subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(SOURCE)], check=True,
                           capture_output=True)
        except (subprocess.CalledProcessError, FileNotFoundError):
            return None
        os.replace(tmp, out)
    return out


def load_library():
    """Load (building if necessary) the native reader. None if unavailable."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = _build_library()
        if path is None:
            return None
        lib = ctypes.CDLL(str(path))
        lib.tfrec_open.restype = ctypes.c_void_p
        lib.tfrec_open.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.tfrec_next.restype = ctypes.c_int64
        lib.tfrec_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ]
        lib.tfrec_close.argtypes = [ctypes.c_void_p]
        lib.tfrec_masked_crc32c.restype = ctypes.c_uint32
        lib.tfrec_masked_crc32c.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ]
        _lib = lib
    return lib


def native_available() -> bool:
    return load_library() is not None


class NativeTFRecordReader:
    """Iterator over record payloads, decoded by the C++ thread pool. With
    one file and no repeat one worker reads it, so records come in file
    order; with several files or ``repeat`` the workers interleave."""

    def __init__(
        self,
        paths: list[str] | str,
        num_threads: int = 4,
        capacity: int = 512,
        verify_crc: bool = False,
        repeat: bool = False,
    ):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native TFRecord reader unavailable (no g++ or no csrc/)")
        if isinstance(paths, str):
            paths = [paths]
        self._lib = lib
        arr = (ctypes.c_char_p * len(paths))(*[p.encode("utf-8") for p in paths])
        self._handle = lib.tfrec_open(
            arr, len(paths), num_threads, capacity, int(verify_crc), int(repeat)
        )
        self._buf = (ctypes.c_uint8 * (1 << 20))()

    def __iter__(self) -> Iterator[bytes]:
        return self

    def __next__(self) -> bytes:
        n = self._lib.tfrec_next(self._handle, self._buf, len(self._buf))
        if n == 0:
            raise StopIteration
        if n == -2:
            # A zero-length record: valid framing, an empty payload, not the
            # end of the data (which would drop every record after it).
            return b""
        if n < 0:
            needed = -n
            if needed > len(self._buf):  # grow and retry
                self._buf = (ctypes.c_uint8 * (2 * needed))()
                return self.__next__()
            raise IOError("native TFRecord reader error")
        return ctypes.string_at(self._buf, n)

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.tfrec_close(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover
        self.close()

"""ctypes binding for the native host data path (``native/tabhost.cc``),
the JAX package's ``data/native_loader.py``.

WAV decode, window framing and a threaded shuffling batch loader in C++,
so the host feeds card-sized batches without Python in the per-sample
loop.  :func:`ensure_built` compiles ``native/tabhost.cc`` on demand with
``native/Makefile``'s flags into the port's ``_build/`` (gitignored); it
never writes into ``native/``.  The library is compiled under a temporary
name and moved into place, so processes that build it at once each end
with a whole library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Sequence

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG_DIR), "native", "tabhost.cc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
# native/Makefile's CXXFLAGS and LDFLAGS
FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-shared", "-pthread")
_lib = None


def library_path() -> str:
    """The library's path, named by a hash of the source and the flags."""
    tag = hashlib.sha256(" ".join(FLAGS).encode())
    with open(SOURCE, "rb") as f:
        tag.update(f.read())
    return os.path.join(BUILD_DIR, f"libtabhost_{tag.hexdigest()[:16]}.so")


def ensure_built() -> bool:
    """Build the library if it is missing.  Returns ``False`` when there is
    no ``g++`` (or no source); a source that fails to compile raises with
    the compiler's output."""
    if not os.path.exists(SOURCE):
        return False
    path = library_path()
    if os.path.exists(path):
        return True
    cxx = shutil.which("g++")
    if cxx is None:
        return False
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *FLAGS, SOURCE, "-o", tmp], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"g++ failed on {os.path.basename(SOURCE)} with code {proc.returncode}:\n"
            f"{proc.stderr}"
        )
    os.replace(tmp, path)
    return True


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not ensure_built():
        raise RuntimeError("libtabhost unavailable (no g++ or no native/tabhost.cc)")
    lib = ctypes.CDLL(library_path())
    lib.tabhost_wav_read.restype = ctypes.c_int64
    lib.tabhost_wav_read.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.tabhost_frame_windows.restype = ctypes.c_int64
    lib.tabhost_frame_windows.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
    ]
    lib.tabhost_loader_create.restype = ctypes.c_void_p
    lib.tabhost_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_uint64, ctypes.c_int32,
    ]
    lib.tabhost_loader_num_windows.restype = ctypes.c_int64
    lib.tabhost_loader_num_windows.argtypes = [ctypes.c_void_p]
    lib.tabhost_loader_next.restype = ctypes.c_int32
    lib.tabhost_loader_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.tabhost_loader_destroy.restype = None
    lib.tabhost_loader_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def wav_read(path: str) -> tuple[np.ndarray, int]:
    """Native WAV decode -> (mono float32, sample_rate)."""
    lib = _load()
    sr = ctypes.c_int32(0)
    n = lib.tabhost_wav_read(path.encode(), None, 0, ctypes.byref(sr))
    if n < 0:
        raise IOError(f"tabhost: cannot read {path!r} ({n})")
    out = np.empty(n, dtype=np.float32)
    got = lib.tabhost_wav_read(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, ctypes.byref(sr),
    )
    if got != n:
        raise IOError(f"tabhost: short read on {path!r}")
    return out, int(sr.value)


def frame_windows(samples: np.ndarray, window: int, hop: int) -> np.ndarray:
    """Native sliding-window extraction -> [num, window] float32."""
    lib = _load()
    samples = np.ascontiguousarray(samples, dtype=np.float32)
    n = samples.shape[0]
    num = 0 if n < window else (n - window) // hop + 1
    out = np.empty((num, window), dtype=np.float32)
    got = lib.tabhost_frame_windows(
        samples.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, window,
        hop, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), num,
    )
    return out[:got]


class NativeWindowLoader:
    """Threaded shuffling window loader over many WAV tracks.

    Yields ([B, window] float32 audio, [B] track ids, [B] start offsets)
    forever, reshuffling deterministically each epoch.
    """

    def __init__(
        self,
        paths: Sequence[str],
        *,
        window_samples: int,
        hop_samples: int,
        batch_size: int,
        seed: int = 0,
        num_threads: int = 4,
    ):
        lib = _load()
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        self._lib = lib
        self._handle = lib.tabhost_loader_create(
            arr, len(paths), window_samples, hop_samples, batch_size,
            seed, num_threads,
        )
        if not self._handle:
            raise IOError(f"tabhost: failed to open tracks {paths[:3]}...")
        self.batch_size = batch_size
        self.window_samples = window_samples

    def __len__(self) -> int:
        return int(self._lib.tabhost_loader_num_windows(self._handle))

    def next_batch(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        audio = np.empty((self.batch_size, self.window_samples), np.float32)
        tracks = np.empty(self.batch_size, np.int32)
        starts = np.empty(self.batch_size, np.int64)
        got = self._lib.tabhost_loader_next(
            self._handle,
            audio.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            tracks.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        return audio[:got], tracks[:got], starts[:got]

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.tabhost_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()

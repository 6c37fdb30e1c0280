"""ctypes bindings to the native C++ frontend (cpp/ltefrontend.cc).

Auto-builds the shared library on first use (g++ via the Makefile) and falls
back to pure-numpy equivalents when no toolchain is available, so the
framework never hard-depends on the native path — it's a throughput
optimization for the host side (deinterleave, host-side decimation before
PCIe, SPSC ring for live sources).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_CPP_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__),
                                        os.pardir, os.pardir, "cpp"))
_SO_PATH = os.path.join(_CPP_DIR, "build", "libltefrontend.so")

_lib = None
_lib_lock = threading.Lock()


def _build() -> bool:
    try:
        subprocess.run(["make", "-C", _CPP_DIR], check=True,
                       capture_output=True, timeout=120)
        return os.path.exists(_SO_PATH)
    except Exception:
        return False


def load() -> Optional[ctypes.CDLL]:
    """The shared library, building it if needed; None if unavailable."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_SO_PATH) and not _build():
            return None
        lib = ctypes.CDLL(_SO_PATH)
        f32p = ctypes.POINTER(ctypes.c_float)
        i64 = ctypes.c_int64
        lib.lf_deinterleave.argtypes = [f32p, i64, f32p, f32p]
        lib.lf_decimator_create.restype = ctypes.c_void_p
        lib.lf_decimator_create.argtypes = [ctypes.c_int, f32p, ctypes.c_int]
        lib.lf_decimator_destroy.argtypes = [ctypes.c_void_p]
        lib.lf_decimate.restype = i64
        lib.lf_decimate.argtypes = [ctypes.c_void_p, f32p, i64, f32p]
        lib.lf_ring_create.restype = ctypes.c_void_p
        lib.lf_ring_create.argtypes = [i64]
        lib.lf_ring_destroy.argtypes = [ctypes.c_void_p]
        lib.lf_ring_available.restype = i64
        lib.lf_ring_available.argtypes = [ctypes.c_void_p]
        lib.lf_ring_write.restype = i64
        lib.lf_ring_write.argtypes = [ctypes.c_void_p, f32p, i64]
        lib.lf_ring_read.restype = i64
        lib.lf_ring_read.argtypes = [ctypes.c_void_p, f32p, i64]
        lib.lf_filesource_open.restype = ctypes.c_void_p
        lib.lf_filesource_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.lf_filesource_close.argtypes = [ctypes.c_void_p]
        lib.lf_filesource_len.restype = i64
        lib.lf_filesource_len.argtypes = [ctypes.c_void_p]
        lib.lf_filesource_read.restype = i64
        lib.lf_filesource_read.argtypes = [ctypes.c_void_p, f32p, i64]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def deinterleave(x: np.ndarray):
    """complex64 [n] -> (re float32 [n], im float32 [n])."""
    x = np.ascontiguousarray(x, dtype=np.complex64)
    lib = load()
    if lib is None:
        return (np.ascontiguousarray(x.real),
                np.ascontiguousarray(x.imag))
    n = x.size
    re = np.empty(n, dtype=np.float32)
    im = np.empty(n, dtype=np.float32)
    lib.lf_deinterleave(_fptr(x.view(np.float32)), n, _fptr(re), _fptr(im))
    return re, im


class Decimator:
    """Host-side integer decimator (same taps/alignment as ops.resample)."""

    def __init__(self, ratio: int):
        from ..ltecore.refrx import design_lowpass
        self.ratio = ratio
        self._taps = design_lowpass(ratio).astype(np.float32)
        self._lib = load()
        self._handle = None
        if self._lib is not None and ratio > 1:
            self._handle = self._lib.lf_decimator_create(
                ratio, _fptr(self._taps), len(self._taps))

    def __del__(self):
        if getattr(self, "_handle", None) and self._lib is not None:
            self._lib.lf_decimator_destroy(self._handle)
            self._handle = None

    def __call__(self, x: np.ndarray) -> np.ndarray:
        """complex64 [n] -> complex64 [ceil(n/ratio)] (one-shot)."""
        if self.ratio == 1:
            return np.ascontiguousarray(x, dtype=np.complex64)
        x = np.ascontiguousarray(x, dtype=np.complex64)
        if self._handle is None:
            from ..ltecore import refrx
            return refrx.decimate(x.astype(np.complex128),
                                  self.ratio).astype(np.complex64)
        n_out = (x.size + self.ratio - 1) // self.ratio
        out = np.empty(n_out, dtype=np.complex64)
        got = self._lib.lf_decimate(self._handle, _fptr(x.view(np.float32)),
                                    x.size, _fptr(out.view(np.float32)))
        return out[:got]


class RingBuffer:
    """SPSC ring of complex64 samples (native when available)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._lib = load()
        if self._lib is not None:
            self._handle = self._lib.lf_ring_create(capacity)
            self._np = None
        else:
            self._handle = None
            self._np = np.zeros(capacity, dtype=np.complex64)
            self._head = 0
            self._tail = 0
            self._lock = threading.Lock()

    def __del__(self):
        if getattr(self, "_handle", None) and self._lib is not None:
            self._lib.lf_ring_destroy(self._handle)
            self._handle = None

    def available(self) -> int:
        if self._handle is not None:
            return self._lib.lf_ring_available(self._handle)
        with self._lock:
            return self._head - self._tail

    def write(self, x: np.ndarray) -> int:
        x = np.ascontiguousarray(x, dtype=np.complex64)
        if self._handle is not None:
            return self._lib.lf_ring_write(self._handle,
                                           _fptr(x.view(np.float32)), x.size)
        with self._lock:
            space = self.capacity - (self._head - self._tail)
            n = min(space, x.size)
            idx = (self._head + np.arange(n)) % self.capacity
            self._np[idx] = x[:n]
            self._head += n
            return n

    def read(self, n: int) -> np.ndarray:
        if self._handle is not None:
            out = np.empty(n, dtype=np.complex64)
            got = self._lib.lf_ring_read(self._handle,
                                         _fptr(out.view(np.float32)), n)
            return out[:got]
        with self._lock:
            avail = self._head - self._tail
            n = min(n, avail)
            idx = (self._tail + np.arange(n)) % self.capacity
            out = self._np[idx].copy()
            self._tail += n
            return out


class FileSource:
    """Raw complex64 capture reader with optional looping (native mmap-load
    when available) — the file_source/head pair of the reference CLI."""

    def __init__(self, path: str, repeat: bool = False):
        self.path = path
        self.repeat = repeat
        self._lib = load()
        if self._lib is not None:
            self._handle = self._lib.lf_filesource_open(
                path.encode(), 1 if repeat else 0)
            if not self._handle:
                raise FileNotFoundError(path)
            self.n_samples = self._lib.lf_filesource_len(self._handle)
        else:
            self._handle = None
            self._data = np.fromfile(path, dtype=np.complex64)
            self.n_samples = self._data.size
            self._pos = 0

    def __del__(self):
        if getattr(self, "_handle", None) and self._lib is not None:
            self._lib.lf_filesource_close(self._handle)
            self._handle = None

    def read(self, n: int) -> np.ndarray:
        if self._handle is not None:
            out = np.empty(n, dtype=np.complex64)
            got = self._lib.lf_filesource_read(
                self._handle, _fptr(out.view(np.float32)), n)
            return out[:got]
        out = []
        need = n
        while need > 0:
            if self._pos >= self.n_samples:
                if not self.repeat:
                    break
                self._pos = 0
            chunk = min(need, self.n_samples - self._pos)
            out.append(self._data[self._pos:self._pos + chunk])
            self._pos += chunk
            need -= chunk
        if not out:
            return np.empty(0, dtype=np.complex64)
        return np.concatenate(out)

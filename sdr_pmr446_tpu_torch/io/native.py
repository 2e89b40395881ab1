"""ctypes bindings for the native IO engine (native/sdrio.cpp).

The port's own copy of sdr_pmr446_tpu/io/native.py (the port imports nothing
of the JAX package); tests/test_torch_copies.py holds it equal to the
original.

Native equivalents of the reference's ring buffers and sample plane
(liquid cbufferf/cbuffercf, src/sdr_pmr446.c:467-471,797-816,903-906;
SoapySDR CF32 reads, src/shared.c:62-88).
Loads libsdrio.so when present (``make -C native``), with transparent
NumPy fallbacks so the framework works without the native build.  The native
paths matter on the host side of a TPU pipeline: IQ format conversion and
ring buffering at multi-GB/s without holding the GIL in Python loops.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native", "libsdrio.so")

_FMT_CODES = {"cf32": 0, "fc32": 0, "cs16": 1, "sc16": 1, "cu8": 2,
              "rtlsdr": 2, "cs8": 3}


def _try_load() -> Optional[ctypes.CDLL]:
    path = _LIB_PATH
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.sdrio_ring_create.restype = ctypes.c_void_p
    lib.sdrio_ring_create.argtypes = [ctypes.c_size_t]
    lib.sdrio_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.sdrio_ring_size.restype = ctypes.c_size_t
    lib.sdrio_ring_size.argtypes = [ctypes.c_void_p]
    lib.sdrio_ring_space.restype = ctypes.c_size_t
    lib.sdrio_ring_space.argtypes = [ctypes.c_void_p]
    lib.sdrio_ring_write.restype = ctypes.c_size_t
    lib.sdrio_ring_write.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_size_t]
    lib.sdrio_ring_read.restype = ctypes.c_size_t
    lib.sdrio_ring_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_size_t, ctypes.c_int]
    for name in ("sdrio_convert_cu8", "sdrio_convert_cs8",
                 "sdrio_convert_cs16"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
    lib.sdrio_convert_f32_to_s16.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_float]
    lib.sdrio_reader_open.restype = ctypes.c_void_p
    lib.sdrio_reader_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.sdrio_reader_read.restype = ctypes.c_size_t
    lib.sdrio_reader_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_size_t]
    lib.sdrio_reader_close.argtypes = [ctypes.c_void_p]
    lib.sdrio_wav_open.restype = ctypes.c_void_p
    lib.sdrio_wav_open.argtypes = [ctypes.c_char_p, ctypes.c_uint32,
                                   ctypes.c_int]
    lib.sdrio_wav_write.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_size_t]
    lib.sdrio_wav_close.argtypes = [ctypes.c_void_p]
    return lib


def build_native(quiet: bool = True) -> bool:
    """Compile libsdrio.so in-place; returns True on success."""
    d = os.path.dirname(_LIB_PATH)
    try:
        subprocess.run(["make", "-C", d],
                       capture_output=quiet, check=True)
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False
    global _lib
    _lib = _try_load()
    return _lib is not None


_lib = _try_load()


def have_native() -> bool:
    return _lib is not None


class RingBuffer:
    """SPSC float ring buffer (liquid cbufferf equivalent).

    Complex streams interleave I/Q as 2 floats per sample.
    """

    def __init__(self, capacity: int):
        self.capacity = capacity
        if _lib is not None:
            self._h = _lib.sdrio_ring_create(capacity)
            if not self._h:
                raise MemoryError(
                    f"sdrio_ring_create({capacity}) failed")
            self._np = None
        else:
            self._h = None
            self._np = np.zeros(capacity, np.float32)
            self._head = 0
            self._tail = 0

    def __del__(self):
        if getattr(self, "_h", None) is not None and _lib is not None:
            _lib.sdrio_ring_destroy(self._h)
            self._h = None

    def size(self) -> int:
        if self._h is not None:
            return _lib.sdrio_ring_size(self._h)
        return self._head - self._tail

    def space(self) -> int:
        return self.capacity - self.size()

    def write(self, x: np.ndarray) -> int:
        x = np.ascontiguousarray(x, dtype=np.float32)
        if self._h is not None:
            return _lib.sdrio_ring_write(
                self._h, x.ctypes.data_as(ctypes.c_void_p), x.size)
        n = min(x.size, self.space())
        pos = self._head % self.capacity
        first = min(self.capacity - pos, n)
        self._np[pos:pos + first] = x[:first]
        self._np[: n - first] = x[first:n]
        self._head += n
        return n

    def read(self, n: int, zero_fill: bool = True) -> np.ndarray:
        out = np.empty(n, np.float32)
        if self._h is not None:
            _lib.sdrio_ring_read(self._h,
                                 out.ctypes.data_as(ctypes.c_void_p), n,
                                 1 if zero_fill else 0)
            return out
        take = min(n, self.size())
        pos = self._tail % self.capacity
        first = min(self.capacity - pos, take)
        out[:first] = self._np[pos:pos + first]
        out[first:take] = self._np[: take - first]
        if zero_fill:
            out[take:] = 0.0
        self._tail += take
        return out


def convert_iq(raw: np.ndarray, fmt: str) -> np.ndarray:
    """Interleaved raw IQ -> complex64 (native fast path when available).

    A trailing odd element (file truncated mid-sample) is dropped, matching
    the native reader's got_floats/2 behavior.
    """
    code = _FMT_CODES[fmt]
    expected = {0: np.float32, 1: np.int16, 2: np.uint8, 3: np.int8}[code]
    raw = np.asarray(raw)
    if raw.dtype != expected:
        # a uint8 buffer is raw WIRE BYTES: reinterpret (the frombuffer
        # pattern); anything else is a value cast.  Without this the
        # native converters would read raw.size elements of the WRONG
        # width — an out-of-bounds read for e.g. uint8 data + fmt cs16.
        if raw.dtype == np.uint8 and expected is not np.uint8:
            raw = np.frombuffer(raw.tobytes(), dtype=expected)
        else:
            raw = raw.astype(expected)
    raw = raw[: raw.size // 2 * 2]
    if code == 0:
        f = np.ascontiguousarray(raw, dtype=np.float32)
    elif _lib is not None:
        raw = np.ascontiguousarray(raw)
        f = np.empty(raw.size, np.float32)
        fn = {1: _lib.sdrio_convert_cs16, 2: _lib.sdrio_convert_cu8,
              3: _lib.sdrio_convert_cs8}[code]
        fn(raw.ctypes.data_as(ctypes.c_void_p),
           f.ctypes.data_as(ctypes.c_void_p), raw.size)
    else:
        if code == 1:
            f = raw.astype(np.float32) / 32768.0
        elif code == 2:
            f = (raw.astype(np.float32) - 127.5) / 127.5
        else:
            f = raw.astype(np.float32) / 128.0
    return (f[0::2] + 1j * f[1::2]).astype(np.complex64)


class CaptureReader:
    """Chunked cf32 block reader with zero-padded tail (native when built)."""

    def __init__(self, path: str, fmt: str = "cf32"):
        self.fmt = fmt
        self._code = _FMT_CODES[fmt]
        if _lib is not None:
            self._h = _lib.sdrio_reader_open(path.encode(), self._code)
            if not self._h:
                raise FileNotFoundError(path)
            self._f = None
        else:
            self._h = None
            self._f = open(path, "rb")

    def read_block(self, n_samples: int) -> tuple[np.ndarray, int]:
        """Returns (block[n_samples] complex64, n_valid)."""
        if self._h is not None:
            buf = np.empty(2 * n_samples, np.float32)
            got = _lib.sdrio_reader_read(
                self._h, buf.ctypes.data_as(ctypes.c_void_p), n_samples)
            return (buf[0::2] + 1j * buf[1::2]).astype(np.complex64), got
        elem = {0: np.float32, 1: np.int16, 2: np.uint8, 3: np.int8}[
            self._code]
        raw = np.fromfile(self._f, dtype=elem, count=2 * n_samples)
        x = convert_iq(raw, self.fmt)
        out = np.zeros(n_samples, np.complex64)
        out[: len(x)] = x
        return out, len(x)

    def close(self):
        if self._h is not None and _lib is not None:
            _lib.sdrio_reader_close(self._h)
            self._h = None
        if self._f is not None:
            self._f.close()
            self._f = None


class WavWriter:
    """Streaming mono WAV writer (native when built)."""

    def __init__(self, path: str, sample_rate: int, s16: bool = False):
        self.path = path
        self.sample_rate = sample_rate
        self.s16 = s16
        if _lib is not None:
            self._h = _lib.sdrio_wav_open(path.encode(), sample_rate,
                                          1 if s16 else 0)
            if not self._h:
                raise OSError(f"cannot open WAV for writing: {path}")
            self._buf = None
        else:
            self._h = None
            self._buf = []

    def write(self, samples: np.ndarray):
        samples = np.ascontiguousarray(samples, dtype=np.float32)
        if self._h is not None:
            _lib.sdrio_wav_write(
                self._h, samples.ctypes.data_as(ctypes.c_void_p),
                samples.size)
        else:
            self._buf.append(samples.copy())

    def close(self):
        if self._h is not None and _lib is not None:
            _lib.sdrio_wav_close(self._h)
            self._h = None
        elif self._buf is not None:
            from sdr_pmr446_tpu_torch.io import wav as wav_io
            audio = (np.concatenate(self._buf) if self._buf
                     else np.zeros(0, np.float32))
            wav_io.write_wav(self.path, audio, self.sample_rate,
                             dtype="int16" if self.s16 else "float32")
            self._buf = None


class BatchReader:
    """Multi-stream batch reader: S captures -> [S, block] complex64 blocks.

    The host data-loader for data-parallel stream batches (BASELINE config
    5): worker threads convert formats concurrently in the native engine.
    Falls back to sequential CaptureReaders without the native build.
    """

    def __init__(self, paths, fmts=None):
        n = len(paths)
        fmts = fmts or ["cf32"] * n
        self.n_streams = n
        if _lib is not None and not hasattr(_lib, "_batch_checked"):
            for name, res in (("sdrio_batch_open", ctypes.c_void_p),
                              ("sdrio_batch_read", ctypes.c_size_t)):
                fn = getattr(_lib, name, None)
                if fn is not None:
                    fn.restype = res
            if hasattr(_lib, "sdrio_batch_open"):
                _lib.sdrio_batch_open.argtypes = [
                    ctypes.POINTER(ctypes.c_char_p),
                    ctypes.POINTER(ctypes.c_int), ctypes.c_size_t]
                _lib.sdrio_batch_read.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
                _lib.sdrio_batch_close.argtypes = [ctypes.c_void_p]
            _lib._batch_checked = True
        if _lib is not None and hasattr(_lib, "sdrio_batch_open"):
            arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
            farr = (ctypes.c_int * n)(*[_FMT_CODES[f] for f in fmts])
            self._h = _lib.sdrio_batch_open(arr, farr, n)
            if not self._h:
                raise FileNotFoundError(str(paths))
            self._readers = None
        else:
            self._h = None
            self._readers = [CaptureReader(p, f) for p, f in zip(paths, fmts)]

    def read_block(self, n_samples: int):
        """Returns (blocks [S, n_samples] complex64, max_valid)."""
        if self._h is not None:
            buf = np.empty((self.n_streams, 2 * n_samples), np.float32)
            got = _lib.sdrio_batch_read(
                self._h, buf.ctypes.data_as(ctypes.c_void_p), n_samples)
            blocks = (buf[:, 0::2] + 1j * buf[:, 1::2]).astype(np.complex64)
            return blocks, got
        out = np.zeros((self.n_streams, n_samples), np.complex64)
        mx = 0
        for i, r in enumerate(self._readers):
            b, g = r.read_block(n_samples)
            out[i] = b
            mx = max(mx, g)
        return out, mx

    def skip_blocks(self, n_blocks: int, n_samples: int) -> None:
        """Advance past n_blocks already-processed blocks (checkpoint
        resume).  The native handle exposes no seek, so skipping is a
        read-and-discard sweep — bounded by the capture sizes and only
        paid once at resume."""
        for _ in range(n_blocks):
            self.read_block(n_samples)

    def close(self):
        if self._h is not None and _lib is not None:
            _lib.sdrio_batch_close(self._h)
            self._h = None
        if self._readers:
            for r in self._readers:
                r.close()
            self._readers = None

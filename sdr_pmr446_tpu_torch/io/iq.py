"""IQ sources: raw capture files and synthetic streams.

The port's own copy of sdr_pmr446_tpu/io/iq.py (the port imports nothing
of the JAX package); tests/test_torch_copies.py holds it equal to the
original.

Replaces the reference's SoapySDR hardware source (src/shared.c:11-88) for
TPU hosts, which have no USB SDR: the framework is file/array driven
(SURVEY.md §7 design stance).  Supported formats cover the RTL-SDR world:

  - cf32 / fc32:   interleaved float32 I/Q (SoapySDR CF32)
  - cs16 / sc16:   interleaved int16 I/Q (scaled to +-1.0)
  - cu8  / rtlsdr: interleaved uint8 I/Q, 127.5-centered (rtl_sdr captures)
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np

_FORMATS = {
    "cf32": (np.float32, None),
    "fc32": (np.float32, None),
    "cs16": (np.int16, 32768.0),
    "sc16": (np.int16, 32768.0),
    "cs8": (np.int8, 128.0),
    "cu8": (np.uint8, None),
    "rtlsdr": (np.uint8, None),
}


def detect_format(path: str) -> str:
    ext = os.path.splitext(path)[1].lstrip(".").lower()
    return ext if ext in _FORMATS else "cf32"


def read_iq(path: str, fmt: str | None = None,
            count: int | None = None) -> np.ndarray:
    """Read an entire IQ capture into a complex64 array."""
    fmt = fmt or detect_format(path)
    dtype, scale = _FORMATS[fmt]
    raw = np.fromfile(path, dtype=dtype,
                      count=-1 if count is None else 2 * count)
    raw = raw[: (len(raw) // 2) * 2]
    if dtype == np.uint8:
        # multiply by the f32 reciprocal (not divide): the exact arithmetic
        # the native converter (native/sdrio.cpp) and the on-device decoder
        # (ops/decode.py) use, and the one formulation XLA never rewrites —
        # keeps host read == device decode bit-for-bit
        x = (raw.astype(np.float32) - 127.5) * np.float32(1.0 / 127.5)
    elif scale is not None:
        x = raw.astype(np.float32) / scale
    else:
        x = raw.astype(np.float32)
    return (x[0::2] + 1j * x[1::2]).astype(np.complex64)


def write_iq(path: str, iq: np.ndarray, fmt: str = "cf32") -> None:
    dtype, scale = _FORMATS[fmt]
    iq = np.asarray(iq)
    inter = np.empty(2 * len(iq), dtype=np.float32)
    inter[0::2] = iq.real
    inter[1::2] = iq.imag
    if dtype == np.uint8:
        out = np.clip(inter * 127.5 + 127.5, 0, 255).astype(np.uint8)
    elif scale is not None:
        out = np.clip(inter * scale, -scale, scale - 1).astype(dtype)
    else:
        out = inter
    out.tofile(path)


def block_stream(iq: np.ndarray, block_len: int,
                 pad: bool = True) -> Iterator[np.ndarray]:
    """Yield fixed-size blocks (zero-padding the tail if ``pad``)."""
    n_full = len(iq) // block_len
    for i in range(n_full):
        yield iq[i * block_len:(i + 1) * block_len]
    rem = len(iq) - n_full * block_len
    if rem and pad:
        tail = np.zeros(block_len, dtype=iq.dtype)
        tail[:rem] = iq[n_full * block_len:]
        yield tail

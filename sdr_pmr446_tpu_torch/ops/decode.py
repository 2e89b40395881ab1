"""Wire-format decoding: raw capture bytes -> f32 I/Q planes.

Counterpart of sdr_pmr446_tpu/ops/decode.py.  The JAX package ships the
capture's bytes inside f32 "transport words" (a workaround for its TPU
transfer path); the port takes the raw bytes as a ``torch.uint8`` tensor
instead, byte-identical to ``words.view(np.uint8)``.

Scales match io/iq.py exactly, so decode is bit-exact against both the
host reader and the JAX decoder: cs16 /32768, cu8 (u - 127.5) * f32(1/127.5),
cs8 /128; cf32 is the interleaved f32 capture itself.
"""

from __future__ import annotations

import numpy as np
import torch

#: wire bytes per complex sample
BYTES_PER_SAMPLE = {"cu8": 2, "cs8": 2, "cs16": 4, "cf32": 8}

#: raw element dtype of each format on the wire (interleaved I, Q)
WIRE_DTYPE = {"cu8": np.uint8, "cs8": np.int8, "cs16": np.int16,
              "cf32": np.float32}

#: per-element fill for short tails: the wire value nearest 0.0 after
#: decode (cu8 is biased — zero bytes would decode to -1-1j)
WIRE_FILL = {"cu8": 128, "cs8": 0, "cs16": 0, "cf32": 0}

#: capture-file format names (io/iq.py) -> wire format
FORMAT_ALIASES = {"fc32": "cf32", "sc16": "cs16", "rtlsdr": "cu8"}

# f32 reciprocal: the exact multiplier io/iq.py and the JAX decoder use
_INV_CU8 = float(np.float32(1.0 / 127.5))


def wire_format(fmt: str) -> str:
    """Canonical wire format name for a capture format (raises if unknown)."""
    fmt = FORMAT_ALIASES.get(fmt, fmt)
    if fmt not in BYTES_PER_SAMPLE:
        raise ValueError(f"unsupported input format: {fmt!r}")
    return fmt


def quantize_iq(iq: np.ndarray, fmt: str) -> np.ndarray:
    """Quantize complex IQ to ``fmt`` wire bytes (uint8, little-endian).

    Re-derives sdr_pmr446_tpu.ops.decode.pack_iq: the bytes equal
    ``pack_iq(iq, fmt).view(np.uint8)`` (cf32 == the JAX "cf32w")."""
    inter = np.empty(2 * len(iq), dtype=np.float32)
    inter[0::2] = np.real(iq)
    inter[1::2] = np.imag(iq)
    if fmt == "cf32":
        raw = inter
    elif fmt == "cs16":
        raw = np.clip(inter * 32768.0, -32768, 32767).astype(np.int16)
    elif fmt == "cu8":
        raw = np.clip(inter * 127.5 + 127.5, 0, 255).astype(np.uint8)
    elif fmt == "cs8":
        raw = np.clip(inter * 128.0, -128, 127).astype(np.int8)
    else:
        raise ValueError(f"unsupported wire format: {fmt!r}")
    return raw.view(np.uint8)


def decode_planes(wire: torch.Tensor, fmt: str):
    """uint8 wire bytes [n * BYTES_PER_SAMPLE[fmt]] -> (xr, xi) f32 [n]."""
    if wire.dtype != torch.uint8 or wire.dim() != 1:
        raise ValueError("wire must be a 1-D torch.uint8 tensor")
    if wire.numel() % BYTES_PER_SAMPLE[fmt]:
        raise ValueError(f"{wire.numel()} bytes is not whole {fmt} samples")
    if fmt == "cu8":
        x = (wire.to(torch.float32) - 127.5) * _INV_CU8
    elif fmt == "cs8":
        x = wire.view(torch.int8).to(torch.float32) * (1.0 / 128.0)
    elif fmt == "cs16":
        x = wire.view(torch.int16).to(torch.float32) * (1.0 / 32768.0)
    elif fmt == "cf32":
        x = wire.view(torch.float32)
    else:
        raise ValueError(f"unsupported wire format: {fmt!r}")
    return x[0::2], x[1::2]


def decode_complex(wire: torch.Tensor, fmt: str) -> torch.Tensor:
    """uint8 wire bytes -> complex64 samples."""
    xr, xi = decode_planes(wire, fmt)
    return torch.complex(xr, xi)

"""WAV sinks/sources (the RtAudio replacement's file side).

The port's own copy of sdr_pmr446_tpu/io/wav.py (the port imports nothing
of the JAX package); tests/test_torch_copies.py holds it equal to the
original.

The reference plays audio live via RtAudio (src/sdr_pmr446.c:520-603); on a
TPU host the correctness target is sample-exact files (SURVEY.md §2b), so the
primary sink is WAV (float32 or s16), with streaming append support.
"""

from __future__ import annotations

import struct
import wave

import numpy as np


_RIFF_MAX_DATA = 0xFFFFFFFF - 36    # data chunk cap: RIFF sizes are uint32


def write_wav(path: str, audio: np.ndarray, sample_rate: int,
              dtype: str = "float32") -> None:
    audio = np.asarray(audio)
    sampwidth_b = 2 if dtype == "int16" else 4
    if audio.size * sampwidth_b > _RIFF_MAX_DATA:
        raise ValueError(
            f"audio exceeds the WAV RIFF 4 GiB limit "
            f"({audio.size * sampwidth_b} data bytes); split into files")
    if dtype == "int16":
        data = np.clip(audio * 32767.0, -32768, 32767).astype("<i2").tobytes()
        sampwidth, fmt_tag = 2, 1
    else:
        data = audio.astype("<f4").tobytes()
        sampwidth, fmt_tag = 4, 3
    if fmt_tag == 1:
        with wave.open(path, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(sampwidth)
            w.setframerate(sample_rate)
            w.writeframes(data)
        return
    # float32 WAV (WAVE_FORMAT_IEEE_FLOAT) — write the header by hand
    byte_rate = sample_rate * sampwidth
    hdr = b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVEfmt "
    hdr += struct.pack("<IHHIIHH", 16, 3, 1, sample_rate, byte_rate,
                       sampwidth, 8 * sampwidth)
    hdr += b"data" + struct.pack("<I", len(data))
    with open(path, "wb") as f:
        f.write(hdr + data)


def read_wav(path: str) -> tuple[np.ndarray, int]:
    with open(path, "rb") as f:
        blob = f.read()
    assert blob[:4] == b"RIFF" and blob[8:12] == b"WAVE"
    pos = 12
    fmt = None
    data = None
    while pos + 8 <= len(blob):
        cid = blob[pos:pos + 4]
        size = struct.unpack("<I", blob[pos + 4:pos + 8])[0]
        body = blob[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            data = body
        pos += 8 + size + (size & 1)
    assert fmt is not None and data is not None
    tag, channels, rate, _, _, bits = fmt
    if tag == 3 and bits == 32:
        x = np.frombuffer(data, dtype="<f4").astype(np.float32)
    elif tag == 1 and bits == 16:
        x = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
    else:
        raise ValueError(f"unsupported wav format {tag}/{bits}")
    if channels > 1:
        x = x.reshape(-1, channels).mean(axis=1)
    return x, rate

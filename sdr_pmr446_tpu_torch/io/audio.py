"""Optional live audio sink (RtAudio-role, host side).

The port's own copy of sdr_pmr446_tpu/io/audio.py (the port imports nothing
of the JAX package); tests/test_torch_copies.py holds it equal to the
original.

The reference plays audio via RtAudio (src/sdr_pmr446.c:520-603).  On a TPU
host there is usually no audio server; when one exists this sink pipes mono
float32/s16 PCM into ``aplay`` (ALSA) or ``pacat`` (PulseAudio), whichever
is available — the same role the reference's README fills with ``play``.
Falls back cleanly (``available()`` False) so file sinks remain the default.
"""

from __future__ import annotations

import shutil
import subprocess
from typing import List, Optional

import numpy as np

# The "compiled-in" audio API set — the analog of RtAudio's compiled API
# enum that the reference validates -b against (src/sdr_pmr446.c:234-257):
#   alsa  -> aplay      pulse -> pacat      wav -> file sink (always)
#   dummy -> discard (RtAudio's DUMMY api)
COMPILED_APIS = ("unspecified", "alsa", "pulse", "wav", "dummy")
_API_EXES = {"alsa": "aplay", "pulse": "pacat"}


def list_apis() -> List[str]:
    """APIs usable on THIS host (the device-enumeration analog of
    src/sdr_pmr446.c:552-577's RtAudio device listing)."""
    avail = ["wav", "dummy"]
    for api, exe in _API_EXES.items():
        if shutil.which(exe):
            avail.append(api)
    return avail


def _backend(api: str = "unspecified") -> Optional[list]:
    use_alsa = shutil.which("aplay") and api in ("unspecified", "alsa")
    use_pulse = shutil.which("pacat") and api in ("unspecified", "pulse")
    if use_alsa:
        return ["aplay", "-q", "-f", "FLOAT_LE", "-c", "1", "-r"]
    if use_pulse:
        return ["pacat", "--format=float32le", "--channels=1", "--rate"]
    return None


def available(api: str = "unspecified") -> bool:
    return _backend(api) is not None


class AudioSink:
    """Streams float32 mono PCM to the system audio player through the
    reference's ring semantics (src/sdr_pmr446.c:470, 520-544).

    The reference decouples the DSP thread from the real-time audio
    callback with a bounded Fs/3-sample ring: the callback drains
    1250-frame buffers and ZERO-FILLS underruns, and a stalled consumer
    can never stall the scan loop.  Same architecture here: write() is
    non-blocking (pushes into the native SPSC ring, io/native.py,
    dropping what a full ring cannot take — the stalled-player case),
    while a pump thread plays the RtAudio-callback role, draining one
    ``buffer_frames`` buffer per period with zero-fill and feeding the
    (possibly blocking) player pipe.
    """

    def __init__(self, sample_rate: int, api: str = "unspecified",
                 buffer_frames: int = 1250, _argv: Optional[list] = None):
        import threading
        if _argv is not None:
            argv = _argv                 # test hook: a fake player
        else:
            cmd = _backend(api)
            if cmd is None:
                raise RuntimeError(
                    f"no live audio backend for API '{api}' (available: "
                    f"{', '.join(list_apis())})")
            if cmd[0] == "aplay":
                argv = cmd + [str(sample_rate)]
            else:
                argv = cmd[:-1] + [f"{cmd[-1]}={sample_rate}"]
        self.proc = subprocess.Popen(argv, stdin=subprocess.PIPE)
        from sdr_pmr446_tpu_torch.io.native import RingBuffer
        # ring capacity Fs/3 like the reference (4166 samples at 12.5 kHz)
        self.ring = RingBuffer(max(sample_rate // 3, buffer_frames))
        self.buffer_frames = buffer_frames
        self._period = buffer_frames / float(sample_rate)
        self.dropped = 0                 # producer-side overflow samples
        self.underruns = 0               # zero-filled pump buffers
        self._stalled = False
        self._stall_timeout = 0.5
        self._closing = threading.Event()
        self._pump_thread = threading.Thread(target=self._pump, daemon=True)
        self._pump_thread.start()

    def _pump(self) -> None:
        """RtAudio-callback analog: one buffer per period, zero-filled on
        underrun (src/sdr_pmr446.c:529-538); pipe backpressure re-syncs
        the clock when the player stalls — only THIS thread blocks."""
        import time
        next_t = time.monotonic() + self._period
        while not self._closing.is_set():
            delay = next_t - time.monotonic()
            if delay > 0:
                if self._closing.wait(delay):
                    break
            else:
                next_t = time.monotonic()    # stalled player: resync
            next_t += self._period
            if self.ring.size() < self.buffer_frames:
                self.underruns += 1
            buf = self.ring.read(self.buffer_frames, zero_fill=True)
            try:
                self.proc.stdin.write(buf.tobytes())
                self.proc.stdin.flush()
            except (BrokenPipeError, ValueError, OSError):
                break                        # player gone: drain to nowhere

    def write(self, samples: np.ndarray) -> None:
        """Bounded-wait enqueue into the ring.

        A live player consumes at exactly real time, so a file-driven
        producer (much faster than real time) is paced here by ring
        backpressure — the role the blocking SDR read plays in the
        reference.  But the wait is BOUNDED: if the pump makes no
        progress for ``_stall_timeout`` (player stalled, e.g. a hung
        pacat), the remainder is dropped and counted instead of stalling
        the scan loop; later writes retry with a short probe and resume
        cleanly once the player recovers."""
        import time
        x = np.ascontiguousarray(samples, np.float32)
        off = self.ring.write(x)
        if off >= x.size:
            self._stalled = False
            return
        if self._stalled:
            # known-stalled player: zero-wait — drop immediately; the
            # single attempt above doubles as the recovery probe (any
            # drained byte clears the flag)
            self.dropped += x.size - off
            return
        deadline = time.monotonic() + self._stall_timeout
        while off < x.size and not self._closing.is_set():
            if time.monotonic() > deadline:
                self._stalled = True
                self.dropped += x.size - off
                return
            time.sleep(0.005)
            n = self.ring.write(x[off:])
            off += n
            if n > 0:                    # pump is draining: reset the clock
                deadline = time.monotonic() + self._stall_timeout

    def close(self) -> None:
        import subprocess as sp
        import time
        # give the pump a bounded chance to drain what's enqueued
        deadline = time.monotonic() + 2.0
        while (self.ring.size() > 0 and self._pump_thread.is_alive()
               and time.monotonic() < deadline):
            time.sleep(0.01)
        self._closing.set()
        self._pump_thread.join(timeout=1.0)
        if self._pump_thread.is_alive():
            # pump wedged in a write against a full pipe: a graceful
            # stdin.close() would block in flush until the player dies —
            # kill it first (it stopped consuming; nothing to preserve)
            self.proc.kill()
        try:
            if self.proc.stdin:
                self.proc.stdin.close()
        except (BrokenPipeError, OSError):
            pass
        self._pump_thread.join(timeout=2.0)
        try:
            self.proc.wait(timeout=5)
        except sp.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=5)

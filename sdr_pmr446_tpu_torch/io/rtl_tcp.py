"""rtl_tcp network IQ source — the framework's live RF ingestion path.

The port's own copy of sdr_pmr446_tpu/io/rtl_tcp.py (the port imports
nothing of the JAX package); tests/test_torch_copies.py holds it equal
to the original.

The reference is a live receiver: SoapySDR enumerates a local USB SDR and
blocking-reads CF32 samples (src/shared.c:11-88, src/sdr_pmr446.c:788-794).
TPU hosts have no USB radios, so the live path here is the rtl_tcp wire
protocol instead: any machine with an RTL-SDR runs ``rtl_tcp -a 0.0.0.0``
and this client streams its cu8 IQ over the network, applying the same
tuning parameters init_soapy would set (sample rate, center frequency,
gain).

Protocol (rtl_tcp.c, rtl-sdr project — public wire format):
  server -> client: 12-byte header  = magic "RTL0" | u32be tuner type
                    | u32be tuner gain count, then an endless stream of
                    interleaved u8 I/Q pairs (offset-127.5 unsigned).
  client -> server: 5-byte commands = u8 opcode | u32be argument:
                    0x01 frequency Hz, 0x02 sample rate Hz, 0x03 gain mode
                    (1=manual), 0x04 tuner gain (tenths of dB), 0x08 AGC.

Samples convert cu8 -> cf32 through the native engine's converters
(io/native.convert_iq) exactly like file captures.
"""

from __future__ import annotations

import socket
import struct
from typing import Optional, Tuple

import numpy as np

from sdr_pmr446_tpu_torch import config as C
from sdr_pmr446_tpu_torch.io import native

CMD_SET_FREQ = 0x01
CMD_SET_SAMPLE_RATE = 0x02
CMD_SET_GAIN_MODE = 0x03
CMD_SET_GAIN = 0x04
CMD_SET_AGC_MODE = 0x08

MAGIC = b"RTL0"

TUNER_NAMES = {0: "UNKNOWN", 1: "E4000", 2: "FC0012", 3: "FC0013",
               4: "FC2580", 5: "R820T", 6: "R828D"}


def parse_url(url: str) -> Tuple[str, int]:
    """'rtl_tcp://host:port' (port defaults to rtl_tcp's 1234)."""
    assert url.startswith("rtl_tcp://"), url
    rest = url[len("rtl_tcp://"):]
    if ":" in rest:
        host, port = rest.rsplit(":", 1)
        return host, int(port)
    return rest, 1234


class RtlTcpClient:
    """Blocking rtl_tcp client with the CaptureReader read_block interface,
    so StreamingSource can pump it exactly like a capture file."""

    def __init__(self, host: str, port: int = 1234,
                 sample_rate: int = C.SDR_SAMPLERATE,
                 frequency: float = C.SDR_FREQUENCY,
                 gain_db: Optional[float] = C.SDR_DEFAULT_GAIN,
                 timeout: float = 10.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.settimeout(timeout)
        try:
            hdr = self._recv_exact(12, retry_on_timeout=False)
            if len(hdr) < 12 or hdr[:4] != MAGIC:
                raise RuntimeError(
                    f"not an rtl_tcp server (header {hdr[:4]!r})")
            self.tuner_type, self.gain_count = struct.unpack(">II", hdr[4:])
        except Exception:
            self.sock.close()           # no leaked connection on bad hosts
            raise
        self.tuner_name = TUNER_NAMES.get(self.tuner_type, "UNKNOWN")
        # same setup order as init_soapy (src/shared.c:44-61):
        # rate -> frequency -> gain
        self.command(CMD_SET_SAMPLE_RATE, int(sample_rate))
        self.command(CMD_SET_FREQ, int(frequency))
        if gain_db is None:
            self.command(CMD_SET_AGC_MODE, 1)
        else:
            self.command(CMD_SET_GAIN_MODE, 1)
            self.command(CMD_SET_GAIN, int(round(gain_db * 10.0)))

    def command(self, opcode: int, arg: int) -> None:
        self.sock.sendall(struct.pack(">BI", opcode, arg & 0xFFFFFFFF))

    def _recv_exact(self, n: int, retry_on_timeout: bool = True) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            try:
                chunk = self.sock.recv(n - len(buf))
            except socket.timeout:
                if not retry_on_timeout:
                    raise
                # transient stall: log and keep waiting, like the
                # reference's read<0 -> log & continue loop
                # (src/sdr_pmr446.c:791-794); a CLOSED connection still
                # ends the stream via the empty-recv path below
                import logging
                logging.getLogger("rtl_tcp").warning(
                    "rtl_tcp read timeout; retrying")
                continue
            if not chunk:
                break
            buf.extend(chunk)
        return bytes(buf)

    def read_block(self, n_samples: int) -> tuple[np.ndarray, int]:
        """Read n_samples cu8 IQ pairs -> (complex64 [n_samples], got)."""
        raw = self._recv_exact(2 * n_samples)
        got = len(raw) // 2
        x = native.convert_iq(np.frombuffer(raw[:2 * got], np.uint8), "cu8")
        if got < n_samples:
            x = np.concatenate(
                [x, np.zeros(n_samples - got, np.complex64)])
        return x, got

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class RtlTcpSource:
    """Background-threaded block source over an rtl_tcp connection.

    Same shape as runtime.stream.StreamingSource (reader thread -> native
    SPSC ring -> fixed blocks), but the producer is the network socket: the
    ring absorbs network jitter the way the reference's cbuffercf absorbs
    resampler-yield jitter.
    """

    def __init__(self, url: str, block_len: int,
                 sample_rate: int = C.SDR_SAMPLERATE,
                 frequency: float = C.SDR_FREQUENCY,
                 gain_db: Optional[float] = C.SDR_DEFAULT_GAIN,
                 ring_blocks: int = 4, read_chunk: int = 1 << 16,
                 max_samples: Optional[int] = None):
        from sdr_pmr446_tpu_torch.runtime.stream import StreamingSource
        host, port = parse_url(url)
        self.client = RtlTcpClient(host, port, sample_rate=sample_rate,
                                   frequency=frequency, gain_db=gain_db)
        self.max_samples = max_samples
        self._source = StreamingSource.__new__(StreamingSource)
        StreamingSource._init_with_reader(
            self._source, self._limited_reader(), block_len,
            ring_blocks=ring_blocks, read_chunk=read_chunk)

    def _limited_reader(self):
        if self.max_samples is None:
            return self.client
        outer = self

        class _Limited:
            def __init__(self):
                self.remaining = outer.max_samples

            def read_block(self, n):
                n_eff = min(n, self.remaining)
                if n_eff == 0:
                    return np.zeros(n, np.complex64), 0
                x, got = outer.client.read_block(n_eff)
                got = min(got, n_eff)
                self.remaining -= got
                if x.shape[0] < n:
                    x = np.concatenate(
                        [x, np.zeros(n - x.shape[0], np.complex64)])
                return x, got

            def close(self):
                outer.client.close()

        return _Limited()

    def blocks(self):
        return self._source.blocks()

    def close(self) -> None:
        self._source.close()

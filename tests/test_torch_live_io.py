"""The port's live I/O: rtl_tcp, the native I/O engine, the stream reader
and the audio sink, against the JAX package's.

Mirrors tests/test_rtl_tcp.py:68-207 with its local fake server (a
``FakeRtlTcpServer`` on 127.0.0.1): the client's tuning commands and
cu8 conversion, the threaded source, a bad header, a transient stall, and
both CLIs end to end over ``rtl_tcp://`` with ``--device cpu``, each
against the JAX app fed the same bytes by its own server (scanner: events
equal and audio > 40 dB; dsd_in on an FM tone: PCM within 2 LSB, 99.9 %
within 1, tests/test_torch_dsd_app.py's app gate).  Mirrors
tests/test_native.py:22-150 in both I/O modes (libsdrio.so, and its NumPy
fallbacks by monkeypatch), each result equal to the JAX module's, with
StreamingSource driving the port's ScannerDriver; and tests/test_misc.py:
192 (the audio sink's availability probe), with a fake player fed through
``AudioSink(_argv=)``.
"""

import logging

import numpy as np
import pytest
import torch

from sdr_pmr446_tpu import config as C
from sdr_pmr446_tpu.io import iq as jiq, native as jnative, synth
from sdr_pmr446_tpu_torch.io import native, rtl_tcp
from test_rtl_tcp import FakeRtlTcpServer

torch.set_num_threads(2)


# ------------------------------------------------------------------ rtl_tcp
def test_rtl_tcp_url_parse():
    for url in ("rtl_tcp://radio.lan:2345", "rtl_tcp://10.0.0.7"):
        from sdr_pmr446_tpu.io.rtl_tcp import parse_url
        assert rtl_tcp.parse_url(url) == parse_url(url)
    assert rtl_tcp.parse_url("rtl_tcp://10.0.0.7") == ("10.0.0.7", 1234)


def test_rtl_tcp_client_reads_and_configures():
    n = 5000
    srv = FakeRtlTcpServer(n)
    cli = rtl_tcp.RtlTcpClient("127.0.0.1", srv.port, sample_rate=1_024_000,
                               frequency=446_100_000, gain_db=42.0)
    assert (cli.tuner_name, cli.gain_count) == ("R820T", 29)
    x1, got1 = cli.read_block(3000)
    x2, got2 = cli.read_block(3000)           # short: only 2000 remain
    cli.close()
    srv.thread.join(timeout=5)
    assert (got1, got2) == (3000, 2000)
    expect = jnative.convert_iq(np.frombuffer(srv.payload, np.uint8), "cu8")
    np.testing.assert_array_equal(x1, expect[:3000])
    np.testing.assert_array_equal(x2[:2000], expect[3000:5000])
    np.testing.assert_array_equal(x2[2000:], 0)
    assert srv.commands[:4] == [(rtl_tcp.CMD_SET_SAMPLE_RATE, 1_024_000),
                                (rtl_tcp.CMD_SET_FREQ, 446_100_000),
                                (rtl_tcp.CMD_SET_GAIN_MODE, 1),
                                (rtl_tcp.CMD_SET_GAIN, 420)]


def test_rtl_tcp_source_blocks():
    n = 4 * 2048
    srv = FakeRtlTcpServer(n)
    src = rtl_tcp.RtlTcpSource(f"rtl_tcp://127.0.0.1:{srv.port}",
                               block_len=2048, max_samples=3 * 2048)
    blocks = list(src.blocks())
    src.close()
    expect = jnative.convert_iq(np.frombuffer(srv.payload, np.uint8), "cu8")
    assert len(blocks) == 3
    np.testing.assert_array_equal(np.concatenate(blocks), expect[:3 * 2048])


def test_rtl_tcp_rejects_bad_magic():
    import socket
    import threading
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    sock.listen(1)
    port = sock.getsockname()[1]

    def serve():
        conn, _ = sock.accept()
        conn.sendall(b"HTTP" + b"\x00" * 8)
        conn.close()
        sock.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    with pytest.raises(RuntimeError, match="not an rtl_tcp server"):
        rtl_tcp.RtlTcpClient("127.0.0.1", port)
    t.join(timeout=5)


def test_rtl_tcp_client_rides_out_transient_stalls():
    """A stall longer than the socket timeout does not end the stream;
    a closed connection does (tests/test_rtl_tcp.py:141)."""
    import socket
    import struct
    import threading
    import time
    n = 2000
    payload = np.random.default_rng(7).integers(
        0, 256, 2 * n, dtype=np.uint8).tobytes()
    half = len(payload) // 2
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    port = srv.getsockname()[1]

    def serve():
        conn, _ = srv.accept()
        conn.sendall(rtl_tcp.MAGIC + struct.pack(">II", 5, 29))
        conn.recv(4 * 5)
        conn.sendall(payload[:half])
        time.sleep(0.7)
        conn.sendall(payload[half:])
        conn.shutdown(socket.SHUT_WR)
        try:
            while conn.recv(4096):
                pass
        except OSError:
            pass
        conn.close()
        srv.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    cli = rtl_tcp.RtlTcpClient("127.0.0.1", port, timeout=0.2)
    x, got = cli.read_block(n)
    assert got == n
    np.testing.assert_array_equal(x, jnative.convert_iq(
        np.frombuffer(payload, np.uint8), "cu8"))
    assert cli.read_block(100)[1] == 0
    cli.close()
    t.join(timeout=5)


def cu8_payload(n):
    """tests/test_rtl_tcp.py:122's capture as an rtl_sdr would send it."""
    iq = 0.6 * synth.make_scanner_iq(n, channel=5, ctcss_code=12)
    inter = np.empty(2 * n, np.float32)
    inter[0::2], inter[1::2] = iq.real, iq.imag
    return np.clip(np.round(inter * 127.5 + 127.5), 0, 255).astype(
        np.uint8).tobytes()


def test_scanner_app_rtl_tcp_matches_jax(tmp_path, caplog):
    """Both scanner CLIs over rtl_tcp:// on the same bytes (K = 5, one
    block): the port's events equal the JAX app's, its audio > 40 dB
    against JAX's and its 1 kHz tone > 25 dB."""
    from sdr_pmr446_tpu.apps import sdr_pmr446 as jax_app
    from sdr_pmr446_tpu_torch.apps import sdr_pmr446 as app
    from sdr_pmr446_tpu_torch.io import wav
    n = 5 * C.SUBCHUNK_IN
    payload = cu8_payload(n)
    outs = {}
    for name, main, extra in (("jax", jax_app.main, []),
                              ("port", app.main, ["--device", "cpu"])):
        srv = FakeRtlTcpServer(n, payload=payload)
        outp = str(tmp_path / f"{name}.wav")
        caplog.clear()
        with caplog.at_level(logging.INFO):
            assert main(["--input", f"rtl_tcp://127.0.0.1:{srv.port}",
                         "--output", outp, "--subchunks-per-step", "5",
                         "-p", "max", "--seconds",
                         str(n / C.SDR_SAMPLERATE)] + extra) == 0
        srv.thread.join(timeout=5)
        events = [r.getMessage() for r in caplog.records
                  if r.getMessage().startswith(("Tuned", "Detuned",
                                                "Acquired", "Changed"))]
        outs[name] = (wav.read_wav(outp)[0], events, srv.commands)
    (a_j, ev_j, cmd_j), (a_p, ev_p, cmd_p) = outs["jax"], outs["port"]
    assert ev_p == ev_j and any(e.startswith("Tuned to channel 5")
                                for e in ev_p)
    assert cmd_p == cmd_j
    assert len(a_p) == len(a_j) > 0
    err = np.mean((a_p.astype(np.float64) - a_j) ** 2)
    assert 10 * np.log10(np.mean(a_j.astype(np.float64) ** 2) / err) > 40
    assert synth.tone_snr_db(a_p[2 * 1225:], 1000.0) > 25.0


def test_dsd_in_app_live_rtl_tcp_matches_jax(tmp_path):
    """dsd_in over rtl_tcp:// tunes to -f and writes one block of 48 kHz
    s16 (tests/test_rtl_tcp.py:190); on an FM tone 2.5 kHz off centre
    (tests/test_torch_dsd_app.py's capture, as cu8) within 2 LSB of the
    JAX app's, 99.9 % within 1."""
    from sdr_pmr446_tpu.apps import dsd_in as jax_app
    from sdr_pmr446_tpu_torch.apps import dsd_in as app
    from test_rtl_tcp import CMD_SET_FREQ
    n = C.SUBCHUNK_IN
    t = np.arange(n) / C.SDR_SAMPLERATE
    msg = 0.5 * np.sin(2 * np.pi * 1000.0 * t)
    iq = 0.8 * np.exp(1j * 2 * np.pi * (2000 * np.cumsum(msg)
                                        + 2500 * np.arange(n))
                      / C.SDR_SAMPLERATE)
    inter = np.empty(2 * n, np.float32)
    inter[0::2], inter[1::2] = iq.real, iq.imag
    payload = np.clip(np.round(inter * 127.5 + 127.5), 0, 255).astype(
        np.uint8).tobytes()
    pcm = {}
    for name, main, extra in (("jax", jax_app.main, []),
                              ("port", app.main, ["--device", "cpu"])):
        srv = FakeRtlTcpServer(n, payload=payload)
        outp = str(tmp_path / f"{name}.s16")
        assert main(["--input", f"rtl_tcp://127.0.0.1:{srv.port}",
                     "--output", outp, "--subchunks-per-step", "1",
                     "--seconds", "0.098", "-f", "160000000"] + extra) == 0
        srv.thread.join(timeout=5)
        assert (CMD_SET_FREQ, 160_000_000) in srv.commands
        pcm[name] = np.fromfile(outp, np.int16).astype(np.int32)
    assert len(pcm["port"]) == len(pcm["jax"]) == n * 3 // 64
    d = np.abs(pcm["port"] - pcm["jax"])
    assert d.max() <= 2 and np.mean(d <= 1) >= 0.999
    assert np.abs(pcm["port"]).max() > 1000          # the tone came out
    assert app.main(["--input", "rtl_tcp://127.0.0.1:1", "--device-decode",
                     "--output", str(tmp_path / "x")]) == 1


# ------------------------------------------------------------- native I/O
@pytest.fixture(params=["native", "fallback"])
def io_mode(request, monkeypatch):
    """tests/test_native.py:12: libsdrio.so, or the NumPy fallbacks of
    both packages' modules."""
    if request.param == "native":
        if not native.have_native():
            pytest.skip("native build unavailable")
    else:
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(jnative, "_lib", None)
    return request.param


def test_ring_buffer(io_mode):
    r = native.RingBuffer(16)
    assert r.write(np.arange(10, dtype=np.float32)) == 10 and r.size() == 10
    np.testing.assert_array_equal(r.read(6), np.arange(6, dtype=np.float32))
    assert r.write(np.arange(10, 20, dtype=np.float32)) == 10   # wraps
    np.testing.assert_array_equal(r.read(14),
                                  np.arange(6, 20, dtype=np.float32))
    r = native.RingBuffer(8)
    assert r.write(np.ones(12, np.float32)) == 8
    out = r.read(10, zero_fill=True)
    np.testing.assert_array_equal(out, np.r_[np.ones(8), np.zeros(2)])


@pytest.mark.parametrize("fmt,dtype", [("cs16", np.int16), ("cu8", np.uint8),
                                       ("cs8", np.int8)])
def test_convert_iq_equals_jax(io_mode, fmt, dtype):
    rng = np.random.default_rng(0)
    info = np.iinfo(dtype)
    raw = rng.integers(info.min, info.max, 2048, dtype=dtype)
    x = native.convert_iq(raw, fmt)
    assert x.dtype == np.complex64 and len(x) == 1024
    np.testing.assert_array_equal(x, jnative.convert_iq(raw, fmt))
    # raw wire bytes are reinterpreted, never cast
    np.testing.assert_array_equal(
        native.convert_iq(raw.view(np.uint8), fmt), x)


def test_capture_reader_and_wav_writer(io_mode, tmp_path):
    iq = (0.2 * (np.random.default_rng(1).standard_normal(2500)
                 + 1j * np.random.default_rng(2).standard_normal(2500))
          ).astype(np.complex64)
    p = str(tmp_path / "cap.cs16")
    jiq.write_iq(p, iq, "cs16")
    rd = native.CaptureReader(p, "cs16")
    blocks = [rd.read_block(1000) for _ in range(3)]
    rd.close()
    assert [g for _, g in blocks] == [1000, 1000, 500]
    got = np.concatenate([b for b, _ in blocks])
    np.testing.assert_allclose(got[:2500], iq, atol=2e-4)
    np.testing.assert_array_equal(got[2500:], 0)
    from sdr_pmr446_tpu_torch.io import wav
    x = np.sin(np.linspace(0, 30, 5000)).astype(np.float32) * 0.8
    for s16 in (False, True):
        path = str(tmp_path / f"out_{s16}.wav")
        w = native.WavWriter(path, 12500, s16=s16)
        w.write(x[:2000])
        w.write(x[2000:])
        w.close()
        y, rate = wav.read_wav(path)
        assert rate == 12500
        np.testing.assert_allclose(y, x, atol=1e-4 if s16 else 1e-7)


def test_streaming_source_threads(io_mode, tmp_path):
    from sdr_pmr446_tpu_torch.runtime.stream import StreamingSource
    n = 25000
    iq = (0.1 * (np.random.default_rng(5).standard_normal(n)
                 + 1j * np.random.default_rng(6).standard_normal(n))
          ).astype(np.complex64)
    p = str(tmp_path / "cap.cf32")
    jiq.write_iq(p, iq)
    src = StreamingSource(p, block_len=8192, read_chunk=1000)
    got = np.concatenate(list(src.blocks()))
    src.close()
    assert len(got) % 8192 == 0 and len(got) >= n
    np.testing.assert_array_equal(got[:n], iq)
    np.testing.assert_array_equal(got[n:], 0)


def test_streaming_source_drives_the_port_scanner(io_mode, tmp_path):
    """tests/test_native.py:104: StreamingSource's complex64 blocks, as
    the cf32 wire, through the port's ScannerDriver: channel 5 tuned, the
    events and audio equal to the same capture decoded whole."""
    from sdr_pmr446_tpu_torch.runtime.driver import ScannerDriver
    from sdr_pmr446_tpu_torch.runtime.stream import StreamingSource
    iq = synth.make_scanner_iq(10 * C.SUBCHUNK_IN, channel=5, ctcss_code=12)
    p = str(tmp_path / "cap.cs16")
    jiq.write_iq(p, 0.5 * iq, "cs16")
    drv = ScannerDriver(subchunks_per_step=5, input_format="cf32",
                        device="cpu")
    src = StreamingSource(p, block_len=drv.chain.block.input_len,
                          fmt="cs16")
    res = drv.run(src.blocks())
    src.close()
    assert any(e.startswith("Tuned to channel 5") for e in res.events)
    whole = ScannerDriver(subchunks_per_step=5, input_format="cf32",
                          device="cpu")
    x = native.convert_iq(np.fromfile(p, np.int16), "cs16")
    ref = whole.run(x[i:i + 5 * C.SUBCHUNK_IN] for i in range(
        0, len(x), 5 * C.SUBCHUNK_IN))
    assert res.events == ref.events
    np.testing.assert_array_equal(res.audio, ref.audio)


def test_batch_reader_equals_jax(io_mode, tmp_path):
    rng = np.random.default_rng(11)
    paths, data = [], []
    for s in range(3):
        x = (0.2 * (rng.standard_normal(5000) + 1j * rng.standard_normal(
            5000))).astype(np.complex64)
        p = str(tmp_path / f"s{s}.cs16")
        jiq.write_iq(p, x, "cs16")
        paths.append(p)
        data.append(x)
    br, jbr = (native.BatchReader(paths, ["cs16"] * 3),
               jnative.BatchReader(paths, ["cs16"] * 3))
    for want_got in (3000, 2000, 0):
        (b, g), (jb, jg) = br.read_block(3000), jbr.read_block(3000)
        assert g == jg == want_got
        np.testing.assert_array_equal(b, jb)
        if want_got == 3000:
            first = b
    br.close()
    jbr.close()
    for s in range(3):
        np.testing.assert_allclose(first[s], data[s][:3000], atol=2e-4)


# -------------------------------------------------------------- audio sink
def test_audio_sink_gating():
    """tests/test_misc.py:192: the availability probe, the API lists."""
    from sdr_pmr446_tpu.io import audio as jaudio
    from sdr_pmr446_tpu_torch.io import audio
    assert isinstance(audio.available(), bool)
    assert audio.available() == jaudio.available()
    assert audio.list_apis() == jaudio.list_apis()
    assert audio.COMPILED_APIS == jaudio.COMPILED_APIS


def test_audio_sink_fake_player_gets_everything(tmp_path):
    """A consuming fake player (``_argv``): nothing dropped, every sample
    written reaches it in order (zero-filled underruns around them)."""
    from sdr_pmr446_tpu_torch.io import audio
    out = tmp_path / "played.f32"
    sink = audio.AudioSink(C.AUDIO_SAMPLERATE,
                           _argv=["/bin/sh", "-c", f"cat > {out}"])
    x = (0.5 * np.sin(np.arange(5 * 1225) * 0.3)).astype(np.float32)
    try:
        for i in range(5):
            sink.write(x[i * 1225:(i + 1) * 1225])
        assert sink.dropped == 0
    finally:
        sink.close()
    played = np.fromfile(out, np.float32)
    start = int(np.flatnonzero(played)[0]) - 1      # x[0] is 0
    np.testing.assert_array_equal(played[start:start + len(x)], x)


def test_scanner_cli_output_live_needs_a_live_api(tmp_path):
    """-b is checked against the compiled and available APIs, and
    --output live refuses the file-only ones, as in JAX."""
    from sdr_pmr446_tpu_torch.apps import sdr_pmr446 as app
    base = ["--seconds", "0.2", "--device", "cpu"]
    assert app.main(base + ["-b", "nosuch"]) == 1
    assert app.main(base + ["--output", "live", "-b", "wav"]) == 1
    assert app.main(base + ["--output", "live", "-b", "dummy"]) == 1

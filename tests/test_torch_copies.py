"""The port's copies of the JAX-free modules equal their originals.

The port imports nothing of the JAX package; it keeps its own copies of
``config``, ``taps/design``, ``io/iq``, ``io/synth``, ``io/wav``,
``oracle/chain``, ``ui/waterfall``, ``io/native``, ``runtime/stream``,
``io/rtl_tcp``, ``io/audio``, ``apps/filter_des`` and ``taps/pll_des``.
Each case here holds one piece of a copy bit-equal to the
original (one parametrised test, a case per piece), so a copy that drifts
fails.
"""

import contextlib
import dataclasses
import importlib
import io
from types import SimpleNamespace

import numpy as np
import pytest


def assert_same(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def modules(pkg: str) -> SimpleNamespace:
    """The copied modules of ``pkg`` (the JAX package or the port)."""
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")
    return SimpleNamespace(C=mod("config"), D=mod("taps.design"),
                           iq=mod("io.iq"), synth=mod("io.synth"),
                           wav=mod("io.wav"), oracle=mod("oracle.chain"),
                           wf=mod("ui.waterfall"), native=mod("io.native"),
                           stream=mod("runtime.stream"),
                           rtl=mod("io.rtl_tcp"), audio=mod("io.audio"),
                           filter_des=mod("apps.filter_des"),
                           pll=mod("taps.pll_des"))


PORT, JAX = modules("sdr_pmr446_tpu_torch"), modules("sdr_pmr446_tpu")


def config_constants(m, tmp):
    return tuple((n, getattr(m.C, n)) for n in sorted(vars(m.C))
                 if n.isupper())


def config_dataclasses(m, tmp):
    return tuple(tuple(sorted(dataclasses.asdict(getattr(m.C, c)()).items()))
                 for c in ("ScannerArgs", "DsdInArgs", "BlockConfig"))


def config_channel_mask(m, tmp):
    out = [m.C.parse_channel_mask(s) for s in ("1", "1,2,8-16", "3-5,64")]
    for spec in ("0", "65", "3-70"):
        with pytest.raises(ValueError):
            m.C.parse_channel_mask(spec)
    return tuple(out)


#: every design function of taps/design.py, called as the chains, the
#: oracle and the tools call it
DESIGNS = {
    "kaiser_beta": lambda D: D.kaiser_beta(60.0),
    "resampler_taps": lambda D: D.resampler_taps(),
    "resampler_taps_dsd_stage2": lambda D: D.resampler_taps(
        L=1, M=16, att_db=60.0, fs_in=200000.0, passband_hz=5200.0,
        stopband_hz=6900.0),
    "resampler_taps_dsd_up": lambda D: D.resampler_taps(
        L=96, M=25, att_db=60.0, fs_in=12500.0, passband_hz=5000.0,
        stopband_hz=6200.0),
    "resampler_taps_single": lambda D: D.resampler_taps(
        L=1, M=16, att_db=80.0, fs_in=200000.0, passband_hz=5600.0,
        stopband_hz=6900.0),
    "pfb_prototype": lambda D: D.pfb_prototype(),
    "ctcss_hp_taps": lambda D: D.ctcss_hp_taps(),
    "audio_lp_taps": lambda D: D.audio_lp_taps(),
    "deemph_iir_coeffs": lambda D: D.deemph_iir_coeffs(),
    "deemph_fir_equiv": lambda D: D.deemph_fir_equiv(),
    "deemph_fir_taps": lambda D: D.deemph_fir_taps(),
    "ctcss_goertzel_coeffs": lambda D: D.ctcss_goertzel_coeffs(),
    "dc_blocker_coeffs": lambda D: D.dc_blocker_coeffs(),
    "resampler_print": lambda D: D.resampler_print(),
    "deemph_reson_lp": lambda D: D.deemph_reson_lp(),
    "deemph_butter_lp": lambda D: D.deemph_butter_lp(),
}


def design_names(m, tmp):
    """Every public function of the module has a case in DESIGNS."""
    names = {n for n, v in vars(m.D).items()
             if callable(v) and not n.startswith("_")
             and getattr(v, "__module__", "") == m.D.__name__}
    assert names <= {n.split("_dsd")[0].split("_single")[0]
                     for n in DESIGNS}
    return tuple(sorted(names))


def synth(m, tmp):
    x = np.sin(np.arange(5000) * 0.5) + 0.01 * np.cos(np.arange(5000))
    return (m.synth.make_scanner_iq(20_000, channel=5, ctcss_code=12,
                                    seed=3, start_sample=777),
            m.synth.tone_snr_db(x, 1000.0))


def iq_files(m, tmp):
    """Bytes written, the format detected, samples and blocks read back."""
    iq = 0.5 * JAX.synth.make_scanner_iq(4096, channel=3, seed=1)
    out = []
    for fmt in ("cf32", "cs16", "cs8", "cu8"):
        path = str(tmp / f"x.{fmt}")
        m.iq.write_iq(path, iq, fmt)
        x = m.iq.read_iq(path)
        out += [np.fromfile(path, np.uint8), m.iq.detect_format(path), x,
                tuple(m.iq.block_stream(x, 1000))]
    return tuple(out)


def wav_file(m, tmp):
    audio = (0.3 * np.sin(np.arange(3000) * 0.1)).astype(np.float32)
    path = str(tmp / "a.wav")
    m.wav.write_wav(path, audio, 12500)
    return (np.fromfile(path, np.uint8),) + tuple(m.wav.read_wav(path))


def scanner_oracle(m, tmp):
    iq = JAX.synth.make_scanner_iq(3 * JAX.C.SUBCHUNK_IN, channel=5,
                                   ctcss_code=12)
    ora = m.oracle.ScannerOracle(m.C.ScannerArgs())
    ora.process(iq)
    return (tuple(ora.active_trace),
            tuple(tuple(sorted(dataclasses.asdict(e).items()))
                  for e in ora.events),
            np.stack(ora.rssi_trace), np.concatenate(ora.audio))


def dsd_oracle(m, tmp):
    """The port's copy takes its taps from the port's scanner/dsd_in.py."""
    iq = JAX.synth.make_scanner_iq(4 * 2048, channel=9, seed=2)
    return m.oracle.DsdInOracle().process(iq)


def chain_taps(m, tmp):
    """The dsd and single chains' taps, which the port re-derives from its
    design copy (and the DsdInOracle copy reads from scanner/dsd_in.py)."""
    pkg = m.C.__name__.rsplit(".", 1)[0]
    dsd = importlib.import_module(f"{pkg}.scanner.dsd_in")
    single = importlib.import_module(f"{pkg}.scanner.single")
    return tuple(np.asarray(t) for t in (dsd.stage2_taps(), dsd.up_taps(),
                                         single.channel_filter_taps()))


def waterfall_ui(m, tmp):
    """The ASCII waterfall line and the channel footer."""
    rng = np.random.default_rng(4)
    row = rng.uniform(-60.0, 0.0, 64).astype(np.float32)
    return (m.wf.CHARSET, m.wf.DB_REF, m.wf.DB_DIV, m.wf.render_row(row),
            m.wf.render_waterfall_line(row, 12.5),
            m.wf.render_footer(64, 0xFFFB, 4, True, 12, 100.0),
            m.wf.render_footer(120, 0xFFFF, -1, False, 1, 67.0),
            m.wf.render_footer(80, 0x00FF, 9, False, 3, 71.9))


def native_io(m, tmp, fallback=False):
    """The converters, the ring buffer, the capture and batch readers and
    the WAV writer, through libsdrio.so or the NumPy fallbacks."""
    lib = m.native._lib
    if fallback:
        m.native._lib = None
    try:
        rng = np.random.default_rng(9)
        out = [tuple(sorted(m.native._FMT_CODES.items()))]
        for fmt, dt in (("cs16", np.int16), ("cu8", np.uint8),
                        ("cs8", np.int8), ("cf32", np.float32)):
            raw = (rng.integers(np.iinfo(dt).min, np.iinfo(dt).max, 801,
                                dtype=dt) if dt != np.float32
                   else rng.standard_normal(801).astype(dt))
            out += [m.native.convert_iq(raw, fmt),
                    m.native.convert_iq(raw.view(np.uint8), fmt)]
        ring = m.native.RingBuffer(10)
        out += [ring.write(np.arange(7, dtype=np.float32)), ring.read(4),
                ring.write(np.arange(9, dtype=np.float32)), ring.size(),
                ring.read(12, zero_fill=True)]
        iq = 0.3 * JAX.synth.make_scanner_iq(3000, channel=2, seed=4)
        paths = []
        for s, fmt in enumerate(("cs16", "cu8")):
            paths.append(str(tmp / f"b{s}.{fmt}"))
            JAX.iq.write_iq(paths[-1], iq[s * 500:], fmt)
        rd = m.native.CaptureReader(paths[0], "cs16")
        out += [rd.read_block(1700), rd.read_block(1700)]
        rd.close()
        br = m.native.BatchReader(paths, ["cs16", "cu8"])
        out += [br.read_block(1000), br.read_block(2000)]
        br.close()
        w = m.native.WavWriter(str(tmp / "w.wav"), 12500, s16=True)
        w.write(np.sin(np.arange(900) * 0.2).astype(np.float32))
        w.close()
        out.append(np.fromfile(str(tmp / "w.wav"), np.uint8))
        return tuple(out)
    finally:
        m.native._lib = lib


def native_fallback(m, tmp):
    return native_io(m, tmp, fallback=True)


def stream_source(m, tmp):
    """StreamingSource's blocks over a cf32 capture (short reads, a
    zero-padded tail)."""
    iq = 0.2 * JAX.synth.make_scanner_iq(7000, channel=6, seed=5)
    path = str(tmp / "s.cf32")
    JAX.iq.write_iq(path, iq)
    src = m.stream.StreamingSource(path, block_len=2048, read_chunk=900)
    blocks = tuple(src.blocks())
    src.close()
    return blocks


def rtl_tcp_protocol(m, tmp):
    r = m.rtl
    return (r.MAGIC, r.CMD_SET_FREQ, r.CMD_SET_SAMPLE_RATE,
            r.CMD_SET_GAIN_MODE, r.CMD_SET_GAIN, r.CMD_SET_AGC_MODE,
            tuple(sorted(r.TUNER_NAMES.items())),
            r.parse_url("rtl_tcp://radio.lan:2345"),
            r.parse_url("rtl_tcp://10.0.0.7"))


def audio_apis(m, tmp):
    a = m.audio
    return (a.COMPILED_APIS, tuple(sorted(a._API_EXES.items())),
            tuple(a.list_apis()), a.available(), a.available("alsa"),
            str(a._backend("unspecified")), str(a._backend("pulse")))


def filter_des_files(m, tmp):
    """Every file filter_des writes (with the exploration designs), byte
    for byte, and what it prints."""
    out = tmp / "designs"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = m.filter_des.main(["--outdir", str(out), "--explore",
                                "--points", "256"])
    printed = buf.getvalue().replace(str(out), "<outdir>")
    return (rc, printed) + tuple((f.name, f.read_bytes())
                                 for f in sorted(out.iterdir()))


def pll_design(m, tmp):
    """The PLL's lock on a tone and on noise, and its biquad."""
    res = m.pll.evaluate_on_tone(code=12, amp=0.15, noise=0.02,
                                 seconds=0.5)
    noise = 0.15 * np.random.default_rng(0).standard_normal(3000)
    res2 = m.pll.CtcssPLL(94.8).run(noise)
    bq = m.pll.Biquad.lowpass(2.0, 12500.0)
    return (res.freq_track, res.lock, res.locked_fraction, res2.freq_track,
            res2.lock, res2.locked_fraction, bq.b, bq.a,
            bq.process(noise[:500]))


CASES = {f.__name__: f for f in (config_constants, config_dataclasses,
                                 config_channel_mask, design_names, synth,
                                 iq_files, wav_file, scanner_oracle,
                                 dsd_oracle, chain_taps, waterfall_ui,
                                 native_io, native_fallback, stream_source,
                                 rtl_tcp_protocol, audio_apis,
                                 filter_des_files, pll_design)}
CASES.update({f"design_{name}": (lambda fn: lambda m, tmp: fn(m.D))(fn)
              for name, fn in DESIGNS.items()})


@pytest.mark.parametrize("case", sorted(CASES))
def test_copy_equals_original(case, tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    assert_same(CASES[case](PORT, tmp_path / "port"),
                CASES[case](JAX, tmp_path / "jax"))

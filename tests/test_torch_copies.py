"""The port's copies of the JAX-free modules equal their originals.

The port imports nothing of the JAX package; it keeps its own copies of
``config``, ``taps/design``, ``io/iq``, ``io/synth``, ``io/wav``,
``oracle/chain`` and ``ui/waterfall``.  Each case here holds one piece of a copy bit-equal to the
original (one parametrised test, a case per piece), so a copy that drifts
fails.
"""

import dataclasses
import importlib
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
                           wf=mod("ui.waterfall"))


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


CASES = {f.__name__: f for f in (config_constants, config_dataclasses,
                                 config_channel_mask, design_names, synth,
                                 iq_files, wav_file, scanner_oracle,
                                 dsd_oracle, chain_taps, waterfall_ui)}
CASES.update({f"design_{name}": (lambda fn: lambda m, tmp: fn(m.D))(fn)
              for name, fn in DESIGNS.items()})


@pytest.mark.parametrize("case", sorted(CASES))
def test_copy_equals_original(case, tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    assert_same(CASES[case](PORT, tmp_path / "port"),
                CASES[case](JAX, tmp_path / "jax"))

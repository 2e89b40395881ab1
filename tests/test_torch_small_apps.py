"""The port's small apps: record, filter_des and the CTCSS PLL design.

Mirrors of tests/test_misc.py on the port (on the CPU):

  - :16 and :27, the PLL (taps/pll_des.py) locks on a CTCSS tone, tracks
    its frequency, and does not lock on noise;
  - :50, record (apps/record.py) writes one timestamped WAV for one tuned
    segment (channel 5, then receiver noise), one block or two to a
    dispatch; its audio is the driver's audio of that segment;
  - :70, filter_des (apps/filter_des.py) writes the response and tap CSVs.
"""

import os

import numpy as np
import pytest
import torch

from sdr_pmr446_tpu_torch import config as C
from sdr_pmr446_tpu_torch.io import iq as iq_io
from sdr_pmr446_tpu_torch.io import synth, wav

torch.set_num_threads(2)


def test_pll_locks_on_tone():
    from sdr_pmr446_tpu_torch.taps.pll_des import evaluate_on_tone
    res = evaluate_on_tone(code=12, amp=0.15, noise=0.02, seconds=1.0)
    assert res.locked_fraction > 0.9
    tail = res.freq_track[-2000:]
    assert abs(np.mean(tail) - C.CTCSS_FREQS[11]) < 2.0


def test_pll_no_lock_on_noise():
    from sdr_pmr446_tpu_torch.taps.pll_des import CtcssPLL
    x = 0.15 * np.random.default_rng(0).standard_normal(12500)
    assert CtcssPLL(94.8).run(x).locked_fraction < 0.5


@pytest.mark.parametrize("steps_per_dispatch", [1, 2])
def test_record_app(tmp_path, steps_per_dispatch):
    from sdr_pmr446_tpu_torch.apps import record as app
    from sdr_pmr446_tpu_torch.runtime.driver import ScannerDriver, wire_blocks
    # signal for the first half only -> one tuned segment
    n = 10 * C.SUBCHUNK_IN
    sig1 = synth.make_scanner_iq(n, channel=5, ctcss_code=None)
    rng = np.random.default_rng(0)
    noise = 1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    iqp = str(tmp_path / "cap.cf32")
    iq_io.write_iq(iqp, np.concatenate([sig1, noise]))
    rc = app.main(["--input", iqp, "--outdir", str(tmp_path / "rec"),
                   "--subchunks-per-step", "5", "--device", "cpu",
                   "--steps-per-dispatch", str(steps_per_dispatch)])
    assert rc == 0
    wavs = sorted((tmp_path / "rec").glob("pmr446_*.wav"))
    assert len(wavs) == 1
    audio, rate = wav.read_wav(str(wavs[0]))
    assert rate == C.AUDIO_SAMPLERATE and len(audio) > 0
    drv = ScannerDriver(C.ScannerArgs(), subchunks_per_step=5,
                        input_format="cf32", device="cpu")
    res = drv.run(wire_blocks(np.fromfile(iqp, np.uint8), "cf32",
                              drv.feed_len))
    wav.write_wav(str(tmp_path / "driver.wav"), res.audio,
                  C.AUDIO_SAMPLERATE)
    want, _ = wav.read_wav(str(tmp_path / "driver.wav"))
    np.testing.assert_array_equal(audio, want)


def test_record_app_rejects_a_bad_device(tmp_path):
    from sdr_pmr446_tpu_torch.apps import record as app
    iqp = str(tmp_path / "cap.cf32")
    iq_io.write_iq(iqp, np.zeros(C.SUBCHUNK_IN, np.complex64))
    assert app.main(["--input", iqp, "--device", "meta"]) == 1


def test_filter_des_app(tmp_path):
    from sdr_pmr446_tpu_torch.apps import filter_des as app
    assert app.main(["--outdir", str(tmp_path / "d")]) == 0
    files = os.listdir(tmp_path / "d")
    assert "ctcss_hp_response.csv" in files
    assert "deemph_iir_taps.csv" in files

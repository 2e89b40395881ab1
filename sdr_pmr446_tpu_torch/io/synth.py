"""Synthetic PMR446 signal generators (golden-IQ test fixtures).

The port's own copy of sdr_pmr446_tpu/io/synth.py (the port imports nothing
of the JAX package); tests/test_torch_copies.py holds it equal to the
original.

The reference is verified only by listening to live RF (SURVEY.md §4); the
TPU framework is file/array-driven, so ground-truth IQ is generated here:
NBFM voice + CTCSS sub-audible tone on chosen channels, with AWGN.
"""

from __future__ import annotations

import math

import numpy as np

from sdr_pmr446_tpu_torch import config as C


def channel_center_hz(channel: int) -> float:
    """PMR channel n (1..16) center frequency: 446.00625 MHz + (n-1)*12.5 kHz."""
    return C.BAND_START_HZ + C.CHANNEL_WIDTH_HZ / 2 + (channel - 1) * C.CHANNEL_WIDTH_HZ


def nbfm_baseband(message: np.ndarray, fs: float, deviation_hz: float,
                  amplitude: float = 1.0) -> np.ndarray:
    """FM-modulate a [-1,1] message: x[n] = A*exp(j*2*pi*dev/fs*cumsum(m))."""
    phase = 2.0 * np.pi * deviation_hz / fs * np.cumsum(message)
    return (amplitude * np.exp(1j * phase)).astype(np.complex128)


def make_scanner_iq(
    n_samples: int,
    channel: int,
    tone_hz: float = 1000.0,
    tone_amp: float = 0.7,
    ctcss_code: int | None = None,
    ctcss_amp: float = 0.15,
    deviation_hz: float = 2500.0,
    amplitude: float = 1.0,
    noise_db: float = -60.0,
    fs: float = float(C.SDR_SAMPLERATE),
    center_hz: float = C.SDR_FREQUENCY,
    seed: int = 0,
    start_sample: int = 0,
) -> np.ndarray:
    """IQ at ``fs`` centered on ``center_hz`` carrying one NBFM channel.

    The message is an audio tone (+ optional CTCSS tone, code 1..38) FM
    modulated with ``deviation_hz`` onto PMR channel ``channel`` (1..16).
    """
    rng = np.random.default_rng(seed)
    t = (start_sample + np.arange(n_samples)) / fs
    # FM phase via the ANALYTIC integral of the sinusoidal message
    # (integral of A sin(2 pi f t) = -A cos(2 pi f t)/(2 pi f)): exactly
    # phase-continuous across segments generated with consecutive
    # start_sample values (a cumsum restarting at zero per call is not)
    def _integ(amp, f_hz):
        return -amp * np.cos(2 * np.pi * f_hz * t) / (2 * np.pi * f_hz)

    msg_int = _integ(tone_amp, tone_hz)
    if ctcss_code is not None:
        msg_int = msg_int + _integ(ctcss_amp,
                                   C.CTCSS_FREQS[ctcss_code - 1])
    phase = 2.0 * np.pi * deviation_hz * msg_int
    f_off = channel_center_hz(channel) - center_hz
    carrier = 2.0 * np.pi * f_off * t
    x = amplitude * np.exp(1j * (carrier + phase))
    noise_amp = 10 ** (noise_db / 20.0)
    x = x + noise_amp * (rng.standard_normal(n_samples)
                         + 1j * rng.standard_normal(n_samples)) / math.sqrt(2)
    return x.astype(np.complex128)


def expected_audio_tone(n_samples: int, tone_hz: float, tone_amp: float,
                        deviation_hz: float = 2500.0,
                        fs: float = float(C.AUDIO_SAMPLERATE)) -> np.ndarray:
    """The discriminator-output amplitude for a tone message.

    freqdem(kf) output = f_inst/(kf*fs_audio); with kf=0.5 a deviation of
    dev*tone_amp gives amplitude 2*dev*tone_amp/fs.
    """
    t = np.arange(n_samples) / fs
    amp = 2.0 * deviation_hz * tone_amp / fs
    return amp * np.sin(2 * np.pi * tone_hz * t)


def tone_snr_db(x: np.ndarray, tone_hz: float,
                fs: float = float(C.AUDIO_SAMPLERATE)) -> float:
    """SNR of a real signal against its best-fit sinusoid at tone_hz."""
    x = np.asarray(x, dtype=np.float64)
    x = x - x.mean()
    t = np.arange(len(x)) / fs
    c = np.cos(2 * np.pi * tone_hz * t)
    s = np.sin(2 * np.pi * tone_hz * t)
    a = 2 * np.mean(x * c)
    b = 2 * np.mean(x * s)
    fit = a * c + b * s
    num = np.mean(fit ** 2)
    den = np.mean((x - fit) ** 2)
    return 10 * np.log10(max(num, 1e-30) / max(den, 1e-30))

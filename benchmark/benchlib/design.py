"""The scanner's filter designs and radio constants, frozen for the reference.

A copy of the designs the scanner is specified by (the upstream app
mryndzionek/sdr_pmr446, src/sdr_pmr446.c:18-46 and :420-465): the 25/128
resampler prototype, the 16-channel PFB prototype, the 377-tap CTCSS-removal
highpass and the 50 us de-emphasis.  The reference recomputes every table
from these specs; it reads nothing that the program under test made.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import scipy.signal as sig

SAMPLE_RATE = 1_024_000             # input IQ rate [Hz]
CHANNEL_HZ = 12_500                 # PMR446 channel spacing [Hz]
NUM_CHANNELS = 16
BAND_START_HZ = 446.0e6
CENTER_HZ = BAND_START_HZ + (NUM_CHANNELS // 2) * CHANNEL_HZ   # 446.1 MHz
AUDIO_RATE = CHANNEL_HZ             # 12.5 kHz per channel
RESAMP_L, RESAMP_M = 25, 128        # 1.024 MHz -> 200 kHz
#: the mixer that puts PFB bin 0 on channel 1: exp(+j w n), w = 15/16 pi
MIX_OMEGA = 0.5 * (NUM_CHANNELS - 1) / NUM_CHANNELS * 2.0 * math.pi
SUBCHUNK_IN = 49 * RESAMP_M * NUM_CHANNELS          # 100352 samples (98 ms)
SUBCHUNK_AUDIO = SUBCHUNK_IN * RESAMP_L // RESAMP_M // NUM_CHANNELS  # 1225
DC_ALPHA = 0.0005                   # IQ and lp-branch DC blockers
HP_TAPS = 377
CTCSS_DELAY = (HP_TAPS - 1) // 2    # 188
FM_KF = 0.5
HYSTERESIS_DB = 5.0
CTCSS_BLOCK = 2441                  # Goertzel window [audio samples]
CTCSS_AVG_THRESH = 120.0
CTCSS_RATIO_THRESH = 10.0
CTCSS_FREQS = (
    67.0, 71.9, 74.4, 77.0, 79.7, 82.5, 85.4, 88.5, 91.5, 94.8, 97.4, 100.0,
    103.5, 107.2, 110.9, 114.8, 118.8, 123.0, 127.3, 131.8, 136.5, 141.3,
    146.2, 151.4, 156.7, 162.2, 167.9, 173.8, 179.9, 186.2, 192.8, 203.5,
    210.7, 218.1, 225.7, 233.6, 241.8, 250.3,
)


@functools.lru_cache(maxsize=None)
def resampler_taps() -> np.ndarray:
    """Kaiser-windowed lowpass at fs * L, 60 dB (+6 dB margin) stopband,
    passband 94 kHz, stopband 106 kHz, length a multiple of L, gain L."""
    fs_up = float(SAMPLE_RATE) * RESAMP_L
    width = 106_000.0 - 94_000.0
    cutoff = 94_000.0 + 0.42 * width
    numtaps, beta = sig.kaiserord(60.0 + 6.0, width / (0.5 * fs_up))
    numtaps = int(math.ceil(numtaps / RESAMP_L) * RESAMP_L)
    h = sig.firwin(numtaps, cutoff, window=("kaiser", beta), fs=fs_up)
    return (h * RESAMP_L).astype(np.float64)


@functools.lru_cache(maxsize=None)
def pfb_prototype() -> np.ndarray:
    """Kaiser prototype of firpfbch_crcf_create_kaiser(ANALYZER, 16, 13,
    80): 2 * 16 * 13 taps, cutoff half a channel, unity DC gain."""
    n = 2 * NUM_CHANNELS * 13
    h = sig.firwin(n + 1, 1.0 / NUM_CHANNELS,
                   window=("kaiser", sig.kaiser_beta(80.0)))[:n]
    return (h / np.sum(h)).astype(np.float64)


@functools.lru_cache(maxsize=None)
def ctcss_hp_taps() -> np.ndarray:
    """Equiripple highpass: stop 0-300 Hz (weight 10), pass 400 Hz up."""
    h = sig.remez(HP_TAPS, bands=[0.0, 300.0, 400.0, AUDIO_RATE / 2],
                  desired=[0.0, 1.0], weight=[10.0, 1.0], fs=float(AUDIO_RATE))
    return h.astype(np.float64)


def deemph_coeffs() -> tuple:
    """The 50 us one-pole de-emphasis by the bilinear transform: b, a."""
    w_c = 1.0 / 50e-6
    w_ca = 2.0 * AUDIO_RATE * math.tan(w_c / (2.0 * AUDIO_RATE))
    k = -w_ca / (2.0 * AUDIO_RATE)
    p1 = (1.0 + k) / (1.0 - k)
    b0 = -k / (1.0 - k)
    return np.array([b0, b0]), np.array([1.0, -p1])


def dc_coeffs() -> tuple:
    """The DC blocker g (1 - z^-1) / (1 - p z^-1), p = 1 - alpha: b, a."""
    p = 1.0 - DC_ALPHA
    g = (1.0 + p) / 2.0
    return np.array([g, -g]), np.array([1.0, -p])


@functools.lru_cache(maxsize=None)
def resampler_matrix() -> np.ndarray:
    """[L, W] polyphase matrix: output j = f L + p of frame f is
    sum_w xe[f M + w] K[p, w] over xe = (P - 1 zeros of history, x), i.e.
    y[j] = sum_{i<P} x[q - i] h[i L + r], q = floor(j M / L), r = j M mod L."""
    h = resampler_taps()
    p_len = h.shape[0] // RESAMP_L
    offsets = [(p * RESAMP_M) // RESAMP_L for p in range(RESAMP_L)]
    width = p_len + max(offsets)
    k = np.zeros((RESAMP_L, width))
    for p in range(RESAMP_L):
        r = (p * RESAMP_M) % RESAMP_L
        for i in range(p_len):
            k[p, offsets[p] + p_len - 1 - i] = h[i * RESAMP_L + r]
    return k

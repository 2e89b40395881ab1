"""Filter design module (host-side NumPy/SciPy).

The port's own copy of sdr_pmr446_tpu/taps/design.py (the port imports nothing
of the JAX package); tests/test_torch_copies.py holds it equal to the
original.

Fills the role of the reference's offline design stage (scripts/filter_des.py)
plus the designs liquid-dsp performs at init time (src/sdr_pmr446.c:420-465):
every filter in the chain is designed here from its *spec* rather than
hardcoded.  Designs are matched to the reference's specs:

- rational resampler 25/128, 60 dB stopband        (msresamp_crcf, :425-428)
- 16-channel PFB kaiser prototype, m=13, 80 dB      (firpfbch_crcf, :436-438)
- 377-tap CTCSS-removal highpass                    (hp_audio_taps, :56-104)
- 103-tap 4.5 kHz audio lowpass                     (lp_audio_taps, :106-119)
- 50 us de-emphasis IIR (bilinear), b/a reproduce the constants at :460-463
- 101-tap FIR de-emphasis variant                   (deemph_taps, :121-136)

All functions are pure and cached; they return float64 NumPy arrays (cast to
f32 at the JAX boundary).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import scipy.signal as sig

from sdr_pmr446_tpu_torch import config as C


def kaiser_beta(att_db: float) -> float:
    return sig.kaiser_beta(att_db)


@functools.lru_cache(maxsize=None)
def resampler_taps(
    L: int = C.RESAMP_L,
    M: int = C.RESAMP_M,
    att_db: float = C.RESAMP_ATT_DB,
    fs_in: float = float(C.SDR_SAMPLERATE),
    passband_hz: float = 94_000.0,
    stopband_hz: float = 106_000.0,
) -> np.ndarray:
    """Anti-alias prototype for the L/M polyphase rational resampler.

    Designed in the upsampled domain (fs_in * L) as a kaiser-windowed lowpass
    with the transition band straddling the output Nyquist (100 kHz for the
    scanner).  Length is padded to a multiple of L; gain is scaled by L so the
    polyphase resampler has unity passband gain.
    """
    fs_up = fs_in * L
    width = stopband_hz - passband_hz
    cutoff = passband_hz + 0.42 * (stopband_hz - passband_hz)
    # +6 dB design margin: kaiserord's transition estimate is optimistic at
    # the stopband edge; the spec (att_db at stopband_hz) is test-enforced.
    numtaps, beta = sig.kaiserord(att_db + 6.0, width / (0.5 * fs_up))
    numtaps = int(math.ceil(numtaps / L) * L)
    # Even lengths are fine (type-II linear phase lowpass).
    h = sig.firwin(numtaps, cutoff, window=("kaiser", beta), fs=fs_up)
    return (h * L).astype(np.float64)


@functools.lru_cache(maxsize=None)
def pfb_prototype(
    num_channels: int = C.NUM_CHANNELS,
    m: int = C.PFB_SEMILENGTH,
    att_db: float = C.PFB_ATT_DB,
) -> np.ndarray:
    """Kaiser prototype lowpass for the critically-sampled analysis PFB.

    Mirrors the spec of liquid's firpfbch_crcf_create_kaiser(LIQUID_ANALYZER,
    16, 13, 80): length 2*num_channels*m taps, cutoff at half the channel
    spacing (0.5/num_channels cycles/sample).
    """
    n = 2 * num_channels * m
    beta = sig.kaiser_beta(att_db)
    # cutoff in units of Nyquist: (0.5/num_channels) / 0.5
    h = sig.firwin(n + 1, 1.0 / num_channels, window=("kaiser", beta))
    # Drop the trailing tap to get an even length divisible by num_channels
    # (type-I design truncated by one sample; negligible at -80 dB edges).
    h = h[:n]
    # Normalize passband (DC) gain of each channel to unity.
    h = h / np.sum(h)
    return h.astype(np.float64)


@functools.lru_cache(maxsize=None)
def ctcss_hp_taps(
    numtaps: int = C.HP_AUDIO_FILT_TAPS,
    stop_hz: float = 300.0,
    pass_hz: float = 400.0,
    fs: float = float(C.AUDIO_SAMPLERATE),
    stop_weight: float = 10.0,
) -> np.ndarray:
    """CTCSS-removal highpass: pass voice (>400 Hz), stop 67-300 Hz tones.

    The reference's 377-tap table (src/sdr_pmr446.c:56-104) is an equiripple
    linear-phase highpass with ~80 dB stopband up to 300 Hz and passband from
    ~400 Hz; we design to the same spec with Parks-McClellan (remez).
    """
    h = sig.remez(
        numtaps,
        bands=[0.0, stop_hz, pass_hz, fs / 2],
        desired=[0.0, 1.0],
        weight=[stop_weight, 1.0],
        fs=fs,
    )
    return h.astype(np.float64)


@functools.lru_cache(maxsize=None)
def audio_lp_taps(
    numtaps: int = C.LP_AUDIO_FILT_TAPS,
    cutoff_hz: float = 4500.0,
    fs: float = float(C.AUDIO_SAMPLERATE),
) -> np.ndarray:
    """Optional 4.5 kHz audio lowpass (reference lp_audio_taps, -l flag)."""
    h = sig.firwin(numtaps, cutoff_hz, fs=fs)
    return h.astype(np.float64)


def deemph_iir_coeffs(
    tau: float = C.DEEMPH_TAU, fs: float = float(C.AUDIO_SAMPLERATE)
) -> tuple[np.ndarray, np.ndarray]:
    """Standard FM de-emphasis one-pole IIR via the bilinear transform.

    Textbook design (identical formula to scripts/filter_des.py:31-44 /
    GNU Radio fm_deemph): for tau=50us, fs=12500 this reproduces the constants
    hardcoded at src/sdr_pmr446.c:461-463:
      b = [0.507301437, 0.507301437], a = [1.0, 0.014602874]
    """
    w_c = 1.0 / tau
    w_ca = 2.0 * fs * math.tan(w_c / (2.0 * fs))
    k = -w_ca / (2.0 * fs)
    z1 = -1.0
    p1 = (1.0 + k) / (1.0 - k)
    b0 = -k / (1.0 - k)
    b = np.array([b0, -b0 * z1], dtype=np.float64)
    a = np.array([1.0, -p1], dtype=np.float64)
    return b, a


@functools.lru_cache(maxsize=None)
def deemph_fir_equiv(n_taps: int = 32) -> np.ndarray:
    """Exact-to-f32 FIR expansion of the de-emphasis one-pole IIR.

    The pole is at -a1 = -0.0146..., so the impulse response decays below
    f32 epsilon within ~10 taps; a 32-tap truncation is bit-exact in f32.
    This is the TPU-native execution form (a conv instead of a recurrence);
    the reference itself sanctions a FIR de-emphasis (APP_FIR_DEEMPH,
    src/sdr_pmr446.c:42-44).
    """
    b, a = deemph_iir_coeffs()
    imp = np.zeros(n_taps)
    imp[0] = 1.0
    h = sig.lfilter(b, a, imp)
    return h.astype(np.float64)


@functools.lru_cache(maxsize=None)
def deemph_fir_taps(
    numtaps: int = C.DEEMPH_FIR_TAPS, fs: float = float(C.AUDIO_SAMPLERATE)
) -> np.ndarray:
    """101-tap linear-phase FIR de-emphasis (reference deemph_taps variant).

    Designed from the same gain-vs-frequency spec curve as
    scripts/filter_des.py:11-28 (fir_deemph_spec) via firwin2.
    """

    def rolloff(f: float) -> float:
        return (math.log10(f) - 3.0) * -20.0

    pts = [(10.0, -5.0), (30.0, 4.0), (100.0, 7.0), (200.0, 12.0),
           (250.0, 11.5)]
    for f in np.linspace(300, fs / 2 - 50.0, 200):
        pts.append((float(f), rolloff(float(f))))
    freqs = [0.0] + [f for f, _ in pts] + [fs / 2]
    gains_db = [pts[0][1]] + [g for _, g in pts] + [pts[-1][1]]
    gains = [10.0 ** (g / 20.0) for g in gains_db]
    h = sig.firwin2(numtaps, freqs, gains, fs=fs)
    return h.astype(np.float64)


def ctcss_goertzel_coeffs(
    fs: float = float(C.AUDIO_SAMPLERATE),
) -> np.ndarray:
    """Goertzel recurrence coefficients 2*cos(2*pi*f/fs) for the 38 tones.

    (reference: src/sdr_pmr446.c:357-362)
    """
    freqs = np.asarray(C.CTCSS_FREQS, dtype=np.float64)
    return 2.0 * np.cos(2.0 * np.pi * freqs / fs)


def dc_blocker_coeffs(
    alpha: float = C.DC_BLOCK_ALPHA,
) -> tuple[np.ndarray, np.ndarray]:
    """One-pole DC blocker H(z) = g*(1 - z^-1)/(1 - p*z^-1), p = 1-alpha.

    Spec-equivalent to liquid's iirfilt_*_create_dc_blocker(0.0005)
    (src/sdr_pmr446.c:422,450): a zero at DC with a pole at 1-alpha giving a
    ~alpha*fs/(2*pi) Hz cutoff.  g normalizes passband gain to 1.
    """
    p = 1.0 - alpha
    g = (1.0 + p) / 2.0
    b = np.array([g, -g], dtype=np.float64)
    a = np.array([1.0, -p], dtype=np.float64)
    return b, a


def resampler_print(L: int = C.RESAMP_L, M: int = C.RESAMP_M) -> str:
    """One-line resampler design diagnostic (the ``msresamp_crcf_print``
    init log of the reference, src/sdr_pmr446.c:428): rate, polyphase
    geometry, tap count, group delay, stopband spec."""
    h = resampler_taps(L, M)
    n = h.shape[0]
    delay_in = (n - 1) / 2.0 / L          # group delay in INPUT samples
    return (f"resampler: rational {L}/{M} polyphase "
            f"(rate {L / M:.6f}, {C.SDR_SAMPLERATE} -> "
            f"{C.SDR_RESAMPLERATE} Hz), {n} taps "
            f"({n // L} per phase), delay {delay_in:.1f} input samples, "
            f">= {C.RESAMP_ATT_DB:.0f} dB stopband")


def deemph_reson_lp(reson_freq: float = 250.0, q: float = 2.0,
                    fs: float = float(C.AUDIO_SAMPLERATE)):
    """Resonant-lowpass de-emphasis CANDIDATE from the reference's design
    exploration (scripts/filter_des.py:47-60): a +4 dB resonance at
    ``reson_freq`` bilinear-transformed to fs.  Exploration-only — the
    shipped chain uses the 50 us bilinear one-pole (deemph_iir_coeffs);
    kept so apps/filter_des.py --explore reproduces the study."""
    gain = 10.0 ** (4.0 / 20.0)
    wc = 2.0 * math.pi * reson_freq
    b, a = sig.bilinear([0.0, 0.0, gain], [1.0, 1.0 / q, 1.0],
                        fs=fs / wc)
    return np.asarray(b, np.float64), np.asarray(a, np.float64)


def deemph_butter_lp(cutoff_hz: float = 5000.0, order: int = 3,
                     fs: float = float(C.AUDIO_SAMPLERATE)):
    """Butterworth-lowpass de-emphasis CANDIDATE from the reference's
    exploration (scripts/filter_des.py:66-69, the 'deemph coefs' print):
    analog butterworth bilinear-transformed to fs.  Exploration-only."""
    b, a = sig.butter(order, cutoff_hz, "low", analog=True)
    b, a = sig.bilinear(b, a, fs=fs)
    return np.asarray(b, np.float64), np.asarray(a, np.float64)

"""Exploratory CTCSS PLL detector design (offline tool).

Parity with scripts/pll_des.py in the reference: an *alternative* CTCSS
tone-detector design (a phase-locked loop with a lock detector) that was
evaluated and NOT chosen for the main app (the Goertzel bank won; SURVEY.md
§2a).  Kept here as the same kind of design-exploration artifact, with an
evaluation entry point on synthetic chirp + tone signals instead of plots.

Pure NumPy; not part of the runtime path.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from sdr_pmr446_tpu_torch import config as C


@dataclasses.dataclass
class Biquad:
    """Direct-form-I biquad (the SimpleBiquad of the reference script)."""
    b: np.ndarray
    a: np.ndarray

    @classmethod
    def lowpass(cls, fc: float, fs: float, q: float = 0.7071):
        w0 = 2 * math.pi * fc / fs
        alpha = math.sin(w0) / (2 * q)
        cw = math.cos(w0)
        b0 = (1 - cw) / 2
        b = np.array([b0, 1 - cw, b0])
        a = np.array([1 + alpha, -2 * cw, 1 - alpha])
        return cls(b / a[0], a / a[0])

    def process(self, x: np.ndarray) -> np.ndarray:
        import scipy.signal as sig
        return sig.lfilter(self.b, self.a, x)


@dataclasses.dataclass
class PLLResult:
    freq_track: np.ndarray    # instantaneous NCO frequency estimate [Hz]
    lock: np.ndarray          # lock-detector output (0..1-ish)
    locked_fraction: float


class CtcssPLL:
    """Sine-reference PLL tone tracker for one CTCSS tone.

    Phase detector: x[n] * -sin(phi); loop filter: proportional-integral;
    lock detector: lowpassed x[n] * cos(phi) (in-phase product).
    """

    def __init__(self, f0: float, fs: float = float(C.AUDIO_SAMPLERATE),
                 loop_bw: float = 3.0, lock_fc: float = 2.0):
        self.f0 = f0
        self.fs = fs
        wn = 2 * math.pi * loop_bw / fs
        zeta = 0.7071
        self.kp = 2 * zeta * wn
        self.ki = wn * wn
        self.lock_filt = Biquad.lowpass(lock_fc, fs)

    def run(self, x: np.ndarray, lock_thresh: float = 0.05) -> PLLResult:
        n = len(x)
        phi = 0.0
        integ = 0.0
        w0 = 2 * math.pi * self.f0 / self.fs
        freq = np.empty(n)
        inphase = np.empty(n)
        for i in range(n):
            err = x[i] * -math.sin(phi)
            integ += self.ki * err
            w = w0 + self.kp * err + integ
            inphase[i] = x[i] * math.cos(phi)
            phi = (phi + w) % (2 * math.pi)
            freq[i] = w * self.fs / (2 * math.pi)
        lock = self.lock_filt.process(inphase)
        locked = lock > lock_thresh
        return PLLResult(freq, lock, float(np.mean(locked[n // 4:])))


def evaluate_on_tone(code: int = 12, amp: float = 0.15,
                     noise: float = 0.05, seconds: float = 2.0,
                     seed: int = 0) -> PLLResult:
    """The chirp/recording evaluation of pll_des.py, on a synthetic tone."""
    fs = float(C.AUDIO_SAMPLERATE)
    f0 = C.CTCSS_FREQS[code - 1]
    n = int(seconds * fs)
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    x = amp * np.sin(2 * np.pi * f0 * t) + noise * rng.standard_normal(n)
    # locked in-phase product averages amp/2; threshold at 60% of that
    return CtcssPLL(f0).run(x, lock_thresh=0.3 * amp)

"""Operations and bytes of the scanner's kernels, from the configuration's
sizes, and the card's peaks: a frozen copy of chip_smoke.py's ``bound``,
``front_work``, ``pfb_work``, ``duo_work`` and ``audio_bank_work``.

Counts: an f32 multiply-add is 2 operations, a complex product 6, an atan2
or sincos ``ATAN2_OPS``; each input byte is read once and each output byte
written once.
"""

from __future__ import annotations

#: NVIDIA H100 SXM: HBM3 bytes/s and f32 operations/s outside the tensor
#: cores (data sheet, 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
ATAN2_OPS = 20
FFT16_OPS = 5 * 16 * 4              # one 16-point complex FFT, 5 N log2 N


def bound_ms(nbytes: float, ops: float,
             ops_per_s: float = PEAK_F32_OPS_PER_S) -> float:
    """The least time the card could take: bytes over the memory rate or
    operations over their peak rate, whichever is larger."""
    return max(nbytes / PEAK_BYTES_PER_S, ops / ops_per_s) * 1e3


def front_work(n: int, bps: int, hist: int, res_taps: int):
    """The front end for n samples: the wire and the history read, the DC
    blocker (4 a plane and sample) and the resampler's P = taps / 25 taps
    an output on 2 planes (multiply-add = 2)."""
    p = res_taps // 25
    nb = n * 25 // 128
    nbytes = n * bps + 2 * 8 * hist + 4 * (25 * p + 64)
    return nbytes, 8 * n + nb * p * 4


def pfb_work(k: int, f: int, pfb_taps: int):
    """The PFB and discriminator: per frame the 16-branch filterbank (real
    taps on complex samples, 4 operations a tap), the mixer (a complex
    product a branch) and one 16-point FFT; per channel sample the
    discriminator (a complex product and an atan2) and |y|; demod and the
    |y| sums written, the history and the taps read."""
    hist = pfb_taps - 16
    nbytes = 16 * f * 4 + k * 16 * 4 + 2 * 8 * hist + 2 * pfb_taps * 16 * 4
    ops = f * (pfb_taps * 4 + 16 * 6 + FFT16_OPS)
    ops += f * 16 * (6 + ATAN2_OPS + 1 + ATAN2_OPS)
    return nbytes, ops


def duo_work(n: int, bps: int, k: int, f: int, hist: int, res_taps: int,
             pfb_taps: int):
    """K1: the front end, then the PFB part."""
    nbytes, ops = front_work(n, bps, hist, res_taps)
    pb, po = pfb_work(k, f, pfb_taps)
    return nbytes + pb, ops + po


def audio_bank_work(k: int, f: int, ns: int, hist: int, la: int, ll: int,
                    tones: int):
    """K2: the audio (la taps) and lp (ll taps) FIRs over 16 channels, the
    lp DC blocker and the selected channel's CTCSS sums (a sincos and a
    complex multiply-add each); demod and audio [16, F], history, sums."""
    nbytes = (2 * 16 * f * 4 + 2 * 16 * hist * 4 + 2 * k * tones * 8
              + 4 * (la + ll))
    ops = 16 * f * ((la + ll) * 2 + 4) + k * ns * tones * (ATAN2_OPS + 4)
    return nbytes, ops


def k1_bound_ms(cfg: dict) -> float:
    """K1's bound a call (one stream-block) at the configuration's sizes."""
    k = cfg["subchunks_per_step"]
    n = k * cfg["subchunk_samples"]
    f = k * cfg["subchunk_audio"]
    return bound_ms(*duo_work(n, cfg["wire_bytes_per_sample"], k, f,
                              cfg["resampler_taps"] // 25 - 1,
                              cfg["resampler_taps"], cfg["pfb_taps"]))


def k2_bound_ms(cfg: dict) -> float:
    """K2's bound a call: the audio FIR is the highpass composed with the
    de-emphasis, the lp FIR the highpass; the history is the audio FIR's
    rounded up to 128."""
    k = cfg["subchunks_per_step"]
    f = k * cfg["subchunk_audio"]
    la = cfg["hp_taps"] + cfg["deemph_taps"] - 1
    hist = -(-(la - 1) // 128) * 128
    return bound_ms(*audio_bank_work(k, f, cfg["subchunk_audio"], hist, la,
                                     cfg["hp_taps"], cfg["ctcss_tones"]))

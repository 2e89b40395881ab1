"""filter_des — inspect/export the chain's filter designs.

Parity with scripts/filter_des.py in the reference (which plots de-emphasis
and lowpass response curves): dumps every designed filter's frequency
response as CSV (and optionally PNG when matplotlib is available), plus the
coefficient tables themselves.  The designs are the live ones used by the
chain (sdr_pmr446_tpu/taps/design.py), not copies.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import scipy.signal as sig

from sdr_pmr446_tpu_torch import config as C
from sdr_pmr446_tpu_torch.taps import design as D


def _designs():
    b_d, a_d = D.deemph_iir_coeffs()
    return {
        "resampler": (D.resampler_taps(), [1.0], C.SDR_SAMPLERATE * C.RESAMP_L),
        "pfb_prototype": (D.pfb_prototype(), [1.0], C.SDR_RESAMPLERATE),
        "ctcss_hp": (D.ctcss_hp_taps(), [1.0], C.AUDIO_SAMPLERATE),
        "audio_lp": (D.audio_lp_taps(), [1.0], C.AUDIO_SAMPLERATE),
        "deemph_iir": (b_d, a_d, C.AUDIO_SAMPLERATE),
        "deemph_fir": (D.deemph_fir_taps(), [1.0], C.AUDIO_SAMPLERATE),
        "dc_blocker": (*D.dc_blocker_coeffs(), C.AUDIO_SAMPLERATE),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="filter_des")
    p.add_argument("--outdir", type=str, default="filter_designs")
    p.add_argument("--plot", action="store_true",
                   help="also write PNG response plots (needs matplotlib)")
    p.add_argument("--points", type=int, default=2048)
    p.add_argument("--explore", action="store_true",
                   help="also dump the reference's de-emphasis design "
                        "EXPLORATION candidates (scripts/filter_des.py:"
                        "47-69): the 250 Hz reson_lp and the 3rd-order "
                        "5 kHz butterworth, alongside the shipped 50 us "
                        "one-pole for comparison")
    ns = p.parse_args(argv)
    os.makedirs(ns.outdir, exist_ok=True)

    designs = _designs()
    if ns.explore:
        br, ar = D.deemph_reson_lp()
        bb, ab = D.deemph_butter_lp()
        designs["explore_deemph_reson"] = (br, ar, C.AUDIO_SAMPLERATE)
        designs["explore_deemph_butter"] = (bb, ab, C.AUDIO_SAMPLERATE)
    print(D.resampler_print())
    for name, (b, a, fs) in designs.items():
        w, h = sig.freqz(b, a, worN=ns.points, fs=fs)
        db = 20 * np.log10(np.maximum(np.abs(h), 1e-12))
        csv = os.path.join(ns.outdir, f"{name}_response.csv")
        np.savetxt(csv, np.column_stack([w, db]), delimiter=",",
                   header="freq_hz,mag_db", comments="")
        np.savetxt(os.path.join(ns.outdir, f"{name}_taps.csv"),
                   np.asarray(b), delimiter=",")
        print(f"{name}: {len(np.atleast_1d(b))} taps, fs={fs} -> {csv}")
        if ns.plot:
            try:
                import matplotlib
                matplotlib.use("Agg")
                import matplotlib.pyplot as plt
                plt.figure(figsize=(8, 4))
                plt.semilogx(np.maximum(w, 1.0), db)
                plt.grid(True, which="both")
                plt.xlabel("Hz")
                plt.ylabel("dB")
                plt.title(name)
                plt.savefig(os.path.join(ns.outdir, f"{name}.png"), dpi=100)
                plt.close()
            except ImportError:
                print("matplotlib unavailable; skipping plots")
    return 0


if __name__ == "__main__":
    sys.exit(main())

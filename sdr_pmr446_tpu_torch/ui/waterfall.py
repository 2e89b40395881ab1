"""ASCII waterfall + footer renderer (host side).

The port's own copy of sdr_pmr446_tpu/ui/waterfall.py (the port imports
nothing of the JAX package); tests/test_torch_copies.py holds it equal to
the original.

Replicates the reference's terminal UI: the asgramcf ASCII spectrogram row
(src/sdr_pmr446.c:910-919) with scale -40 dB offset / 2 dB per character, and
the channel-strip footer (refresh_footer, src/sdr_pmr446.c:630-666):
channels shown as "NN", "--" when masked, "^^" when active; then
"%8.3f MHz [ch] [CTCSS: code (freq)]".
"""

from __future__ import annotations

import numpy as np

from sdr_pmr446_tpu_torch import config as C

# liquid asgram's default 10-level display charset (asgramcf_create installs
# " .,-+*&NM#" via asgram_set_display; the reference never overrides it) with
# floor quantization of (psd - ref) / div clamped into [0, 9]
CHARSET = " .,-+*&NM#"
DB_REF = -40.0
DB_DIV = 2.0
FOOTER_TAIL_LEN = 64


def render_row(spectrum_db: np.ndarray, ref: float = DB_REF,
               div: float = DB_DIV) -> str:
    """One waterfall line from a dB spectrum row (already fftshifted)."""
    idx = np.clip(((spectrum_db - ref) / div).astype(int), 0,
                  len(CHARSET) - 1)
    return "".join(CHARSET[i] for i in idx)


def render_waterfall_line(spectrum_db: np.ndarray, rel_rssi: float) -> str:
    """Full ' > %s < pk..dB [..] [max SNR: ..dB]' line (src/sdr_pmr446.c:914)."""
    pk = int(np.argmax(spectrum_db))
    maxval = float(spectrum_db[pk])
    maxfreq = (pk - len(spectrum_db) / 2) / len(spectrum_db)
    row = render_row(spectrum_db)
    return (f" > {row} < pk{maxval:5.1f}dB [{maxfreq:5.2f}] "
            f"[max SNR: {rel_rssi:5.1f}dB]        ")


def render_footer(width: int, channel_mask: int, active_chan: int,
                  ctcss_detected: bool, ctcss_code: int,
                  ctcss_freq: float,
                  center_hz: float = C.SDR_FREQUENCY) -> str:
    """Channel-strip footer string (refresh_footer equivalent)."""
    footer = [" "] * (width + FOOTER_TAIL_LEN)
    footer[1] = "["
    if width + 4 < len(footer):
        footer[width + 4] = "]"
    ch_width = width / C.NUM_CHANNELS
    for i in range(C.NUM_CHANNELS):
        rpos = int(round(i * ch_width + ch_width / 2 + 2))
        if active_chan == i:
            s = "^^"
        elif (channel_mask >> i) & 1:
            s = f"{i + 1:02d}"
        else:
            s = "--"
        for j, c in enumerate(s):
            if rpos + j < len(footer):
                footer[rpos + j] = c
    if active_chan >= 0:
        if ctcss_detected:
            tail = (f"{center_hz * 1e-6:8.3f} MHz [{active_chan + 1}]  "
                    f"[CTCSS:  {ctcss_code:02d} ({ctcss_freq:3.2f}Hz)]")
        else:
            tail = f"{center_hz * 1e-6:8.3f} MHz [{active_chan + 1}]"
    else:
        tail = f"{center_hz * 1e-6:8.3f} MHz"
    pos = width + 6
    for j, c in enumerate(tail):
        if pos + j < len(footer):
            footer[pos + j] = c
    return "".join(footer).rstrip()

"""record on the PyTorch port — scanner audio into timestamped WAV files.

Counterpart of sdr_pmr446_tpu/apps/record.py (the reference's
scripts/record.py records the app's live PulseAudio output to a
timestamped WAV and drops all-zero chunks).  The scanner is file-driven
here, so recording is exact: each contiguous tuned segment (tune ->
detune) becomes its own timestamped WAV, and the zero-dropping falls out
because audio exists only while tuned.  The capture's raw wire bytes go
through runtime/driver.py's ``wire_blocks`` to the port's ScannerDriver.

Flags: the JAX app's (--input, --input-format, --outdir, -s/--squelch,
--subchunks-per-step, --steps-per-dispatch) and --device (cuda, the
default: the kernels; cpu: their plain versions).

    python -m sdr_pmr446_tpu_torch.apps.record --input cap.cu8 --outdir rec/
"""

from __future__ import annotations

import argparse
import datetime
import logging
import os
import sys

import numpy as np

from sdr_pmr446_tpu_torch import config as C
from sdr_pmr446_tpu_torch.io import iq as iq_io
from sdr_pmr446_tpu_torch.io import wav
from sdr_pmr446_tpu_torch.ops import decode
from sdr_pmr446_tpu_torch.runtime.driver import ScannerDriver, wire_blocks


def segments(subchunks: np.ndarray) -> list:
    """(start, end) indices into the audio blocks of each run of
    consecutive sub-chunks."""
    starts = [0] + [i for i in range(1, len(subchunks))
                    if subchunks[i] != subchunks[i - 1] + 1]
    return list(zip(starts, starts[1:] + [len(subchunks)]))


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    p = argparse.ArgumentParser(
        prog="record", description="record tuned segments to WAV files "
                                   "(PyTorch + CUDA port)")
    p.add_argument("--input", type=str, required=True)
    p.add_argument("--input-format", type=str, default=None)
    p.add_argument("--outdir", type=str, default=".")
    p.add_argument("-s", "--squelch", type=float,
                   default=C.SDR_DEFAULT_SQUELCH_LEVEL)
    p.add_argument("--subchunks-per-step", type=int, default=10)
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="blocks fused into one dispatch (a CUDA graph of "
                        "that many steps on the card)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: 'cuda' runs the CUDA kernels, 'cpu' "
                        "their plain PyTorch versions (default: cuda)")
    ns = p.parse_args(argv)

    try:
        fmt = decode.wire_format(ns.input_format
                                 or iq_io.detect_format(ns.input))
        drv = ScannerDriver(C.ScannerArgs(squelch_level=ns.squelch),
                            subchunks_per_step=ns.subchunks_per_step,
                            input_format=fmt, device=ns.device,
                            steps_per_dispatch=ns.steps_per_dispatch)
    except (ValueError, RuntimeError) as e:
        logging.error("%s", e)
        return 1
    raw = np.fromfile(ns.input, dtype=np.uint8)
    bps = decode.BYTES_PER_SAMPLE[fmt]
    raw = raw[:len(raw) // bps * bps]
    logging.info("read %d IQ samples from %s (%s); device %s",
                 len(raw) // bps, ns.input, fmt, drv.device)
    res = drv.run(wire_blocks(raw, fmt, drv.feed_len))
    if len(res.audio) == 0:
        logging.info("no tuned segments")
        return 0

    os.makedirs(ns.outdir, exist_ok=True)
    stamp = datetime.datetime.now().strftime("%d_%m_%Y_%H_%M_%S")
    subs, n_audio = res.audio_subchunks, C.SUBCHUNK_AUDIO
    written = []
    for k, (a, b) in enumerate(segments(subs)):
        seg = res.audio[a * n_audio:b * n_audio]
        path = os.path.join(ns.outdir, f"pmr446_{stamp}_{k:03d}.wav")
        wav.write_wav(path, seg, C.AUDIO_SAMPLERATE)
        written.append(path)
        logging.info("wrote %s (%.2f s, sub-chunks %d..%d)", path,
                     len(seg) / C.AUDIO_SAMPLERATE, subs[a], subs[b - 1])
    print("\n".join(written))
    return 0


if __name__ == "__main__":
    sys.exit(main())

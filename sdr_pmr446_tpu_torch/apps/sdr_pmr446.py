"""sdr_pmr446 CLI on the PyTorch port — PMR446 band scanner (file/synthetic).

Counterpart of sdr_pmr446_tpu/apps/sdr_pmr446.py with the flags of the
ported slice: -g/--gain, -s/--squelch, -w/--waterfall, -l/--lowpass,
-m/--mask, -a/--audio-gain, -p/--lock-mode, --fir-deemph, --input,
--input-format, --device-decode, --output (WAV), --seconds,
--subchunks-per-step and --device (cuda: the kernels, cpu: their plain
versions).  With -w W each sub-chunk prints its ASCII waterfall line and
the channel footer (the reference's terminal UI) on stdout.  SIGTERM and
SIGQUIT stop the scan at the next block boundary and the partial WAV is
written (exit 0); SIGUSR1 does nothing; an interrupt (SIGINT) exits 130.
Flags of parts not yet ported (-b, --faithful, --steps-per-dispatch,
--checkpoint*, --resume, rtl_tcp:// inputs, --output live) exit with a
"not yet ported" error instead of being ignored.

    python -m sdr_pmr446_tpu_torch.apps.sdr_pmr446 --input cap.cu8 -w 120
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys

import numpy as np

from sdr_pmr446_tpu_torch import config as C
from sdr_pmr446_tpu_torch.io import iq as iq_io
from sdr_pmr446_tpu_torch.io import synth, wav
from sdr_pmr446_tpu_torch.ops import decode, spectrogram
from sdr_pmr446_tpu_torch.runtime.driver import ScannerDriver, wire_blocks
from sdr_pmr446_tpu_torch.ui import waterfall as wf_ui

FORMATS = "cf32 fc32 cs16 sc16 cs8 cu8 rtlsdr".split()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sdr_pmr446",
        description="sdr_pmr446 -- a PMR446 band scanner/receiver "
                    "(PyTorch + CUDA port)")
    p.add_argument("-g", "--gain", type=float, default=C.SDR_DEFAULT_GAIN,
                   help="SDR receiver gain in dB (unused for file sources)")
    p.add_argument("-s", "--squelch", type=float,
                   default=C.SDR_DEFAULT_SQUELCH_LEVEL,
                   help="relative squelch level in dB "
                        f"(default: {C.SDR_DEFAULT_SQUELCH_LEVEL})")
    p.add_argument("-w", "--waterfall", type=int, default=0,
                   help="ASCII waterfall width: a multiple of 4, >= 8 "
                        "(0 = off)")
    p.add_argument("-l", "--lowpass", action="store_true",
                   help="turn on 4.5kHz lowpass audio filter")
    p.add_argument("-m", "--mask", type=str, default="",
                   help="channel mask e.g. 1,2,8-16 (listed channels are "
                        "disabled)")
    p.add_argument("-a", "--audio-gain", type=float,
                   default=C.SDR_DEFAULT_AUDIO_GAIN,
                   help=f"audio gain (default: {C.SDR_DEFAULT_AUDIO_GAIN})")
    p.add_argument("-p", "--lock-mode", choices=["start", "max"],
                   default="start", help="channel lock mode")
    p.add_argument("--fir-deemph", action="store_true",
                   help="use the FIR de-emphasis variant")
    p.add_argument("--input", type=str, default=None,
                   help="IQ capture file (cf32/cs16/cs8/cu8; 1.024 Msps at "
                        "446.1 MHz); default: synthetic demo signal")
    p.add_argument("--input-format", type=str, default=None, choices=FORMATS)
    p.add_argument("--device-decode", action="store_true",
                   help="accepted as in the JAX CLI; the port always ships "
                        "the capture's raw wire bytes and decodes them on "
                        "the device (needs a capture file)")
    p.add_argument("--output", type=str, default="audio.wav",
                   help="output WAV for the demodulated audio")
    p.add_argument("--seconds", type=float, default=5.0,
                   help="synthetic source duration")
    p.add_argument("--subchunks-per-step", type=int, default=10)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: 'cuda' runs the CUDA kernels, 'cpu' "
                        "their plain PyTorch versions (default: cuda; "
                        "without a CUDA device the run exits 1)")
    # parts of the JAX app that this package does not have yet
    p.add_argument("-b", "--audio-api", type=str, default=None)
    p.add_argument("--faithful", action="store_true")
    p.add_argument("--steps-per-dispatch", type=int, default=1)
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--checkpoint-every", type=int, default=None)
    p.add_argument("--checkpoint-backend", type=str, default=None)
    p.add_argument("--resume", action="store_true")
    return p


def _unported(ns) -> list[str]:
    """Flags given that the port does not implement yet."""
    found = []
    if ns.audio_api is not None:
        found.append("-b/--audio-api")
    if ns.faithful:
        found.append("--faithful")
    if ns.steps_per_dispatch != 1:
        found.append("--steps-per-dispatch")
    for flag in ("checkpoint", "checkpoint_every", "checkpoint_backend"):
        if getattr(ns, flag) is not None:
            found.append("--" + flag.replace("_", "-"))
    if ns.resume:
        found.append("--resume")
    if ns.input and ns.input.startswith("rtl_tcp://"):
        found.append("rtl_tcp:// input")
    if ns.output == "live":
        found.append("--output live")
    return found


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="[%(asctime)s %(name)s] %(message)s",
                        stream=sys.stderr)
    ns = build_parser().parse_args(argv)
    unported = _unported(ns)
    if unported:
        logging.error("not yet ported to sdr_pmr446_tpu_torch: %s "
                      "(use python -m sdr_pmr446_tpu.apps.sdr_pmr446)",
                      ", ".join(unported))
        return 2
    try:
        mask = (C.parse_channel_mask(ns.mask) if ns.mask
                else (1 << C.MAX_CHANNELS) - 1)
    except ValueError as e:
        logging.error("%s", e)
        return 1
    if mask == 0:
        logging.error("No channels enabled in channel mask !")
        return 1
    try:
        spectrogram.validate_width(ns.waterfall)
    except ValueError as e:
        logging.error("%s", e)
        return 1
    args = C.ScannerArgs(
        gain=ns.gain, audio_gain=ns.audio_gain, squelch_level=ns.squelch,
        waterfall=ns.waterfall, lowpass=ns.lowpass, channel_mask=mask,
        lock_mode=ns.lock_mode, fir_deemph=ns.fir_deemph)
    log = logging.getLogger("sdr_pmr446")
    log.info("gain: %5.2f dB, audio_gain: %5.2f, relative squelch level: "
             "%5.2f dB, waterfall: %d", args.gain, args.audio_gain,
             args.squelch_level, args.waterfall)
    log.info("audio lowpass: %s, channel mask: 0x%04X",
             "enabled" if args.lowpass else "disabled", args.channel_mask)

    if ns.device_decode and not ns.input:
        logging.error("--device-decode needs a capture FILE (synthetic "
                      "inputs have no wire bytes to ship)")
        return 1
    if ns.input:
        fmt = decode.wire_format(ns.input_format
                                 or iq_io.detect_format(ns.input))
        raw = np.fromfile(ns.input, dtype=np.uint8)
        bps = decode.BYTES_PER_SAMPLE[fmt]
        raw = raw[:len(raw) // bps * bps]
        log.info("read %d IQ samples (%.2f s) from %s (%s)", len(raw) // bps,
                 len(raw) / bps / C.SDR_SAMPLERATE, ns.input, fmt)
    else:
        fmt = "cf32"
        n = int(ns.seconds * C.SDR_SAMPLERATE)
        n -= n % (ns.subchunks_per_step * C.SUBCHUNK_IN)
        raw = decode.quantize_iq(
            synth.make_scanner_iq(n, channel=5, ctcss_code=12), fmt)
        log.info("using synthetic NBFM demo signal on channel 5, CTCSS 12")

    def on_subchunk(sub, o):
        print(wf_ui.render_waterfall_line(o["waterfall"],
                                          float(o["rel_rssi"])))
        print(wf_ui.render_footer(
            args.waterfall, args.channel_mask, int(o["active_chan"]),
            bool(o["ct_detected"]), int(o["ct_max_idx"]) + 1,
            float(o["ct_freq"])), end="\r")
        sys.stdout.flush()

    try:
        driver = ScannerDriver(
            args, subchunks_per_step=ns.subchunks_per_step, input_format=fmt,
            device=ns.device,
            on_subchunk=on_subchunk if args.waterfall > 0 else None)
    except (ValueError, RuntimeError) as e:
        logging.error("%s", e)
        return 1
    log.info("device: %s", driver.device)

    # the reference's signal set (src/sdr_pmr446.c:779-786, 190-199): TERM
    # and QUIT stop at the next block boundary, USR1 is a no-op wake
    def _sig_stop(signum, frame):
        log.info("Signal caught, exiting!")
        driver.request_stop()

    for name, handler in (("SIGTERM", _sig_stop), ("SIGQUIT", _sig_stop),
                          ("SIGUSR1", lambda *_: None)):
        if hasattr(signal, name):
            try:
                signal.signal(getattr(signal, name), handler)
            except (ValueError, OSError):
                pass                    # not the main thread / unsupported
    try:
        result = driver.run(wire_blocks(raw, fmt, driver.feed_len))
    except KeyboardInterrupt:
        log.info("Signal caught, exiting!")
        return 130
    wav.write_wav(ns.output, result.audio, C.AUDIO_SAMPLERATE)
    log.info("wrote %d audio samples (%.2f s) to %s", len(result.audio),
             len(result.audio) / C.AUDIO_SAMPLERATE, ns.output)
    log.info("Exiting")
    return 0


if __name__ == "__main__":
    sys.exit(main())

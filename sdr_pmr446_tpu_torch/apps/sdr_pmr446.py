"""sdr_pmr446 CLI on the PyTorch port — PMR446 band scanner (file/synthetic).

Counterpart of sdr_pmr446_tpu/apps/sdr_pmr446.py with the flags of the
ported slice: -g/--gain, -s/--squelch, -w/--waterfall, -l/--lowpass,
-m/--mask, -a/--audio-gain, -p/--lock-mode, --fir-deemph, --input
(a capture file, or rtl_tcp://host:port for a live network SDR:
io/rtl_tcp.py), --input-format, --device-decode, --output (a WAV, or
``live``: the audio player of -b/--audio-api, io/audio.py), --seconds,
--subchunks-per-step, --steps-per-dispatch (S blocks a dispatch through the
driver: a CUDA graph of S steps on the card, captured at the first
megastep; ignored with --faithful, as in JAX), --faithful, --checkpoint,
--checkpoint-every, --checkpoint-backend (npz, the default, one file in the
format both packages read; orbax, a torch.distributed.checkpoint directory:
JAX's name, not JAX's orbax files), --resume, --device (cuda: the kernels,
cpu: their plain versions) and --engine (kernel, the default: the
hand-written kernels; op: the JAX op engine's plain ops and its state
layout, so a checkpoint the JAX CLI wrote off a TPU resumes with --engine
op).  With -w W each sub-chunk prints its ASCII waterfall line and the
channel footer (the reference's terminal UI) on stdout.  SIGTERM and
SIGQUIT stop the scan at the next block boundary, flush a final checkpoint
(with --checkpoint) and write the partial WAV (exit 0); SIGUSR1 does
nothing; an interrupt (SIGINT) exits 130.  --faithful runs the validation
chain (scanner/faithful.py) on the capture decoded to complex64; with
--device-decode it exits 1, as in JAX.  --resume without --checkpoint, or
from a missing or unreadable checkpoint (under orbax also a directory that
is no DCP checkpoint, such as one JAX's orbax wrote), exits 1.  -b names
the audio API as in JAX (unspecified, alsa, pulse, wav, dummy; an unknown
or unavailable one exits 1); --output live needs a live one.  An rtl_tcp://
input streams --seconds of radio (cu8 over the network, converted on the
host as a cf32 capture is, then the cf32 wire); it exits 1 with --faithful
or --device-decode.  --trace DIR profiles the scan with the span recorder
on: DIR/trace.json is torch.profiler's Chrome trace with the program's
spans on the same timeline, DIR/counters.json the counters
(utils/profiling.py).

    python -m sdr_pmr446_tpu_torch.apps.sdr_pmr446 --input cap.cu8 -w 120
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import signal
import sys
import zipfile

import numpy as np
import torch

from sdr_pmr446_tpu_torch import config as C
from sdr_pmr446_tpu_torch.io import audio as audio_io
from sdr_pmr446_tpu_torch.io import iq as iq_io
from sdr_pmr446_tpu_torch.io import synth, wav
from sdr_pmr446_tpu_torch.io.rtl_tcp import RtlTcpSource
from sdr_pmr446_tpu_torch.ops import decode, spectrogram
from sdr_pmr446_tpu_torch.runtime.driver import ScannerDriver, wire_blocks
from sdr_pmr446_tpu_torch.scanner.chain import make_runtime_params
from sdr_pmr446_tpu_torch.scanner.faithful import FaithfulScannerChain
from sdr_pmr446_tpu_torch.ui import waterfall as wf_ui
from sdr_pmr446_tpu_torch.utils import profiling

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
    p.add_argument("-b", "--audio-api", type=str, default="unspecified",
                   help="audio API of --output live (unspecified, alsa, "
                        "pulse; wav and dummy are not live)")
    p.add_argument("--input", type=str, default=None,
                   help="IQ capture file (cf32/cs16/cs8/cu8; 1.024 Msps at "
                        "446.1 MHz) or rtl_tcp://host[:port] for a live "
                        "network SDR; default: synthetic demo signal")
    p.add_argument("--input-format", type=str, default=None, choices=FORMATS)
    p.add_argument("--device-decode", action="store_true",
                   help="accepted as in the JAX CLI; the port always ships "
                        "the capture's raw wire bytes and decodes them on "
                        "the device (needs a capture file)")
    p.add_argument("--output", type=str, default="audio.wav",
                   help="output WAV for the demodulated audio, or 'live' "
                        "for the audio player of -b")
    p.add_argument("--seconds", type=float, default=5.0,
                   help="synthetic source / live rtl_tcp duration")
    p.add_argument("--subchunks-per-step", type=int, default=10)
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="blocks fused into one dispatch (a CUDA graph of "
                        "that many steps on the card; decisions and audio "
                        "equal to 1)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: 'cuda' runs the CUDA kernels, 'cpu' "
                        "their plain PyTorch versions (default: cuda; "
                        "without a CUDA device the run exits 1)")
    p.add_argument("--engine", choices=["kernel", "op"], default="kernel",
                   help="kernel: the CUDA kernels (JAX's pallas engine); "
                        "op: plain PyTorch ops with the JAX op engine's "
                        "state layout (JAX's xla engine, its default off a "
                        "TPU); a checkpoint resumes only on its own engine")
    p.add_argument("--faithful", action="store_true",
                   help="the faithful gated audio path (validation mode, "
                        "exact reference semantics through transitions)")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="checkpoint path (a .npz file, or a directory with "
                        "--checkpoint-backend orbax): periodically persist "
                        "(block index, state) for --resume")
    p.add_argument("--checkpoint-every", type=int, default=1,
                   help="blocks between checkpoints (with --checkpoint)")
    p.add_argument("--checkpoint-backend", choices=["npz", "orbax"],
                   default="npz",
                   help="npz: one file in the format both packages read; "
                        "orbax: a directory (torch.distributed.checkpoint "
                        "here, not JAX's orbax files)")
    p.add_argument("--resume", action="store_true",
                   help="restore --checkpoint and continue mid-capture")
    p.add_argument("--trace", type=str, default=None, metavar="DIR",
                   help="profile the driver's scan (not --faithful): "
                        "DIR/trace.json (the profiler's Chrome trace with "
                        "the program's spans) and DIR/counters.json")
    return p


def _live_sink(ns):
    """(exit code or None, the live AudioSink of --output live or None),
    -b checked against the compiled and available APIs as the reference
    does (src/sdr_pmr446.c:234-257)."""
    avail = audio_io.list_apis()
    if ns.audio_api not in audio_io.COMPILED_APIS:
        logging.error("Audio API '%s' not recognized (compiled APIs: %s)",
                      ns.audio_api, ", ".join(audio_io.COMPILED_APIS[1:]))
        return 1, None
    if ns.audio_api != "unspecified" and ns.audio_api not in avail:
        logging.error("Audio API '%s' not available on this host "
                      "(available: %s)", ns.audio_api, ", ".join(avail))
        return 1, None
    if ns.output != "live":
        return None, None
    if ns.audio_api in ("wav", "dummy"):
        logging.error("--output live needs a live API (-b alsa|pulse|"
                      "unspecified), not '%s'", ns.audio_api)
        return 1, None
    if not audio_io.available(ns.audio_api):
        logging.error("no live audio backend available (have: %s)",
                      ", ".join(avail))
        return 1, None
    return None, audio_io.AudioSink(C.AUDIO_SAMPLERATE, api=ns.audio_api)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="[%(asctime)s %(name)s] %(message)s",
                        stream=sys.stderr)
    ns = build_parser().parse_args(argv)
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
    live = bool(ns.input and ns.input.startswith("rtl_tcp://"))
    if live and ns.faithful:
        logging.error("--faithful is offline-only (file/synthetic input), "
                      "not usable with rtl_tcp")
        return 1
    if ns.device_decode and (not ns.input or live):
        logging.error("--device-decode needs a capture FILE (synthetic/"
                      "rtl_tcp inputs have no wire bytes to ship)")
        return 1
    code, live_sink = _live_sink(ns)
    if code is not None:
        return code
    try:
        return _scan(ns, mask, live, live_sink)
    finally:
        if live_sink is not None:
            live_sink.close()


def _scan(ns, mask: int, live: bool, live_sink) -> int:
    """The scan after the flags' checks; writes the WAV or feeds
    ``live_sink``."""
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
    log.info("audio sinks available: %s (using: %s)",
             ", ".join(audio_io.list_apis()),
             ns.audio_api if live_sink is not None else "wav file")

    if ns.device_decode and ns.faithful:
        logging.error("--device-decode is not available with --faithful "
                      "(the validation chain takes complex64 input)")
        return 1
    if ns.resume and not ns.checkpoint:
        logging.error("--resume needs --checkpoint")
        return 1
    raw = None
    if live:
        fmt = "cf32"       # the rtl_tcp source converts cu8 on the host
    elif ns.input:
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

    if ns.faithful:
        return _run_faithful(ns, args, raw, fmt, log, live_sink)

    def on_subchunk(sub, o):
        if live_sink is not None and o["audio_valid"]:
            live_sink.write(o["audio"])
        if args.waterfall <= 0:
            return
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
            on_subchunk=(on_subchunk if args.waterfall > 0
                         or live_sink is not None else None),
            checkpoint_path=ns.checkpoint,
            checkpoint_every=ns.checkpoint_every,
            checkpoint_backend=ns.checkpoint_backend,
            steps_per_dispatch=ns.steps_per_dispatch, engine=ns.engine)
    except (ValueError, RuntimeError) as e:
        logging.error("%s", e)
        return 1
    log.info("device: %s, %s engine", driver.device, driver.engine)
    if ns.resume:
        try:
            driver.restore()
        except (OSError, ValueError, KeyError, EOFError,
                zipfile.BadZipFile) as e:   # missing, corrupt, wrong layout
            logging.error("cannot restore checkpoint '%s': %s",
                          ns.checkpoint, e)
            return 1

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
    live_source = None
    if live:
        block_len = driver.chain.block.input_len
        n_blocks = max(1, int(ns.seconds * C.SDR_SAMPLERATE) // block_len)
        try:
            live_source = RtlTcpSource(ns.input, block_len, gain_db=ns.gain,
                                       max_samples=n_blocks * block_len)
        except (OSError, RuntimeError) as e:
            logging.error("cannot stream from %s: %s", ns.input, e)
            return 1
        log.info("streaming live from %s (tuner: %s, %.1f MHz, %.0f s)",
                 ns.input, live_source.client.tuner_name,
                 C.SDR_FREQUENCY / 1e6, ns.seconds)
        blocks = live_source.blocks()
    else:
        blocks = wire_blocks(raw, fmt, driver.feed_len)
    try:
        with _traced(ns.trace):
            result = driver.run(blocks)
    except KeyboardInterrupt:
        log.info("Signal caught, exiting!")
        driver.checkpoint_now()
        return 130
    finally:
        # release the rtl_tcp socket also on a reader or driver error
        if live_source is not None:
            live_source.close()
    n = len(result.audio)
    if live_sink is not None:
        log.info("streamed %d audio samples (%.2f s) live", n,
                 n / C.AUDIO_SAMPLERATE)
    else:
        wav.write_wav(ns.output, result.audio, C.AUDIO_SAMPLERATE)
        log.info("wrote %d audio samples (%.2f s) to %s", n,
                 n / C.AUDIO_SAMPLERATE, ns.output)
    log.info("Exiting")
    return 0


@contextlib.contextmanager
def _traced(log_dir):
    """With a ``--trace`` DIR, the body under the profiler with the span
    recorder on; else nothing."""
    if log_dir is None:
        yield
        return
    with profiling.recording(), profiling.trace(log_dir):
        yield
    logging.getLogger("sdr_pmr446").info("trace and counters written to %s",
                                         log_dir)


def _run_faithful(ns, args, raw: np.ndarray, fmt: str, log,
                  live_sink=None) -> int:
    """--faithful: the validation chain over the whole blocks of the
    capture (a short tail is dropped, as in JAX), decoded to complex64 on
    the device; writes the valid sub-chunks' audio (or streams it to
    ``live_sink``)."""
    try:
        chain = FaithfulScannerChain(ns.subchunks_per_step, args.lowpass,
                                     device=ns.device)
    except (ValueError, RuntimeError) as e:
        logging.error("%s", e)
        return 1
    log.info("device: %s (faithful mode)", chain.device)
    params = make_runtime_params(args, chain.device)
    block = chain.input_len * decode.BYTES_PER_SAMPLE[fmt]
    st = chain.init_state()
    audio = []
    for i in range(len(raw) // block):
        wire = torch.from_numpy(raw[i * block:(i + 1) * block])
        st, o = chain.step(st, decode.decode_complex(
            wire.to(chain.device), fmt), params)
        audio.append(o.audio[o.audio_valid].reshape(-1).cpu().numpy())
        if live_sink is not None:
            live_sink.write(audio[-1])
    out = np.concatenate(audio) if audio else np.zeros(0, np.float32)
    if live_sink is not None:
        log.info("streamed %d audio samples (faithful mode) live", len(out))
    else:
        wav.write_wav(ns.output, out, C.AUDIO_SAMPLERATE)
        log.info("wrote %d audio samples (faithful mode) to %s", len(out),
                 ns.output)
    log.info("Exiting")
    return 0


if __name__ == "__main__":
    sys.exit(main())

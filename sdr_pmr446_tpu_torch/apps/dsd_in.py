"""dsd_in CLI on the PyTorch port — DSD signal pre-processor (file driven).

Counterpart of sdr_pmr446_tpu/apps/dsd_in.py (the reference's
src/dsd_in.c:40-48): reads an IQ capture at 1.024 Msps and writes 48 kHz
s16le mono to stdout (pipe it into ``dsd -i -`` or ``play``) or to a file.
Flags: -g/--gain, -f/--frequency, --input, --input-format, --output,
--subchunks-per-step, --steps-per-dispatch (S blocks a dispatch: a CUDA
graph of S steps on the card, captured at the first megastep; the output
is the same bytes), --device (cuda: the CUDA kernel, cpu: its plain
version), --engine (kernel, the default; op: the JAX op engine's plain
ops, every K) and --device-decode (accepted; the port always ships the
raw wire bytes to the device and decodes there).  An
rtl_tcp://host[:port] input streams --seconds of live radio tuned to -f
(io/rtl_tcp.py: cu8 over the network, converted on the host, then the cf32
wire), as the reference's dsd_in reads its SDR (src/dsd_in.c:151);
--device-decode with it exits 1.

    python -m sdr_pmr446_tpu_torch.apps.dsd_in --input cap.cu8 --output - | dsd -i -
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys

import numpy as np
import torch

from sdr_pmr446_tpu_torch import config as C
from sdr_pmr446_tpu_torch.io import iq as iq_io
from sdr_pmr446_tpu_torch.io.rtl_tcp import RtlTcpSource
from sdr_pmr446_tpu_torch.ops import decode
from sdr_pmr446_tpu_torch.runtime.driver import wire_blocks
from sdr_pmr446_tpu_torch.scanner.dsd_in import DsdInChain

FORMATS = "cf32 fc32 cs16 sc16 cs8 cu8 rtlsdr".split()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dsd_in", description="dsd_feeder -- DSD signal pre-processor "
                                   "(PyTorch + CUDA port)")
    p.add_argument("-g", "--gain", type=float, default=25.0,
                   help="SDR receiver gain in dB (unused for file sources)")
    p.add_argument("-f", "--frequency", type=float, default=160.0e6,
                   help="receive frequency (metadata for file sources)")
    p.add_argument("--input", type=str, required=True,
                   help="IQ capture file at 1.024 Msps (cf32/cs16/cs8/cu8) "
                        "or rtl_tcp://host[:port] for a live network SDR")
    p.add_argument("--seconds", type=float, default=10.0,
                   help="live capture duration (rtl_tcp inputs; unused for "
                        "files)")
    p.add_argument("--input-format", type=str, default=None, choices=FORMATS)
    p.add_argument("--output", type=str, default="-",
                   help="output path for 48 kHz s16le audio ('-' = stdout)")
    p.add_argument("--subchunks-per-step", type=int, default=10)
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="blocks fused into one dispatch (a CUDA graph of "
                        "that many steps on the card; the output is the "
                        "same bytes)")
    p.add_argument("--device-decode", action="store_true",
                   help="accepted for compatibility and does nothing: the "
                        "port always ships the raw wire bytes to the device "
                        "and decodes there")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: 'cuda' runs the CUDA kernel, 'cpu' its "
                        "plain PyTorch version (default: cuda; without a "
                        "CUDA device the run exits 1)")
    p.add_argument("--engine", choices=["kernel", "op"], default="kernel",
                   help="kernel: the mono CUDA kernel (JAX's pallas "
                        "engine); op: plain PyTorch ops (JAX's xla engine)")
    return p


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    ns = build_parser().parse_args(argv)
    live = ns.input.startswith("rtl_tcp://")
    if live and ns.device_decode:
        logging.error("--device-decode needs a capture file, not a live "
                      "rtl_tcp stream")
        return 1
    try:
        # the rtl_tcp source converts its cu8 on the host: the cf32 wire
        fmt = "cf32" if live else decode.wire_format(
            ns.input_format or iq_io.detect_format(ns.input))
        chain = DsdInChain(ns.subchunks_per_step, input_format=fmt,
                           device=ns.device, engine=ns.engine)
    except (ValueError, RuntimeError) as e:
        logging.error("%s", e)
        return 1
    live_source = None
    if live:
        n = chain.input_len
        n_blocks = max(1, int(ns.seconds * C.SDR_SAMPLERATE) // n)
        try:
            live_source = RtlTcpSource(ns.input, n, frequency=ns.frequency,
                                       gain_db=ns.gain,
                                       max_samples=n_blocks * n)
        except (OSError, RuntimeError) as e:
            logging.error("cannot stream from %s: %s", ns.input, e)
            return 1
        logging.info("streaming live from %s (tuner: %s, %.3f MHz, %.0f s)"
                     "; device %s, %s engine", ns.input,
                     live_source.client.tuner_name, ns.frequency / 1e6,
                     ns.seconds, chain.device, chain.engine)
        blocks = (np.ascontiguousarray(b).view(np.uint8)
                  for b in live_source.blocks())
    else:
        raw = np.fromfile(ns.input, dtype=np.uint8)
        bps = decode.BYTES_PER_SAMPLE[fmt]
        raw = raw[:len(raw) // bps * bps]
        logging.info("read %d IQ samples from %s (%s); device %s, %s engine",
                     len(raw) // bps, ns.input, fmt, chain.device,
                     chain.engine)
        blocks = wire_blocks(raw, fmt, chain.step_arg_len)
    out = sys.stdout.buffer if ns.output == "-" else open(ns.output, "wb")
    # TERM/QUIT end the loop at the next block boundary with the output
    # flushed (the reference's signal set, src/sdr_pmr446.c:779-786)
    stop = {"flag": False}

    def _sig_stop(signum, frame):
        logging.info("Signal caught, exiting!")
        stop["flag"] = True

    for name in ("SIGTERM", "SIGQUIT"):
        if hasattr(signal, name):
            try:
                signal.signal(getattr(signal, name), _sig_stop)
            except (ValueError, OSError):
                pass
    state = chain.init_state()
    pending = None
    n_fuse = max(1, ns.steps_per_dispatch)

    def drain(pcm):
        out.write(pcm.cpu().numpy().astype("<i2").tobytes())
        out.flush()

    def dispatch(wires):
        nonlocal state, pending
        if len(wires) == 1:
            state, pcm = chain.step(state, wires[0])
        else:
            state, pcm = chain.multi_step(state, torch.stack(wires))
        if pending is not None:
            drain(pending)
        pending = pcm

    try:
        # the JAX app's grouping loop (n_fuse blocks a dispatch, the tail
        # singly); dispatch i+1 is queued on the device before dispatch
        # i's PCM is read
        group = []
        for blk in blocks:
            if stop["flag"]:
                break
            group.append(torch.from_numpy(blk).to(chain.device))
            if len(group) == n_fuse:
                dispatch(group)
                group = []
        for wire in (() if stop["flag"] else group):
            dispatch([wire])
        if pending is not None:
            drain(pending)
    except BrokenPipeError:
        # the downstream consumer (dsd/play) closed its end: exit quietly,
        # like the reference's ignored SIGPIPE (src/sdr_pmr446.c:190-199)
        logging.info("downstream pipe closed, exiting")
        try:
            fd = os.open(os.devnull, os.O_WRONLY)
            os.dup2(fd, sys.stdout.fileno())
            os.close(fd)
        except OSError:
            pass
        return 0
    finally:
        if live_source is not None:
            live_source.close()
        if out is not sys.stdout.buffer:
            out.close()
    logging.info("Exiting")
    return 0


if __name__ == "__main__":
    sys.exit(main())

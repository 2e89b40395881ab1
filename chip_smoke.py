#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (sdr_pmr446_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (nvcc) and the repository checkout;
imports nothing of JAX.  It fails (non-zero exit, no result line) when no
CUDA device is available or the package is missing.  Phases, each printed
on its own lines; any failure raises and ends the run:

  1. the card (nvidia-smi name and power limit) and the kernel build from
     sdr_pmr446_tpu_torch/csrc/*.cu;
  2. K1 (duo) and K2 (audio bank) against their plain PyTorch versions on
     the card, at K = 40 (cu8) and K = 10 (cs16), with their times;
  3. the scanner through ScannerDriver on a synthetic cu8 capture at K = 10
     (~3 s): active-channel trace exact and audio SNR > 40 dB against the
     float64 reference oracle (the port's copy, oracle/chain.py), tune and
     CTCSS events present;
  4. the scanner at the bench geometry K = 40 for four distinct blocks:
     throughput, decisions equal to the port's CPU run (plain versions),
     one step with host reads made errors (set_sync_debug_mode), and one
     step under torch.profiler (device busy share, device time by part);
  5. the kernels' launch counts over the runs of phases 3 and 4;
  6. K4 (the dsd_in / single mono chain) against its plain version on the
     card in both modes, two consecutive blocks each at K = 16 (cu8), 15
     (cs16, an odd number of group rows) and 10 (cu8, the app's K), with
     its times;
  7. dsd_in end to end through its CLI (apps/dsd_in.main, --device cuda)
     on a synthetic cu8 FM capture at the app's K = 10: SNR > 50 dB
     against the float64 DsdInOracle, within 1 LSB of the port's CPU run,
     and K4's launch count over that run;
  8. the single-channel chain end to end, channel 5 at K = 16: audio SNR
     > 100 dB against the CPU run, 1 kHz tone SNR > 35 dB, K4's launch
     count over that run;
  9. each chain at K = 16 cu8 over four distinct blocks: throughput, one
     step with host reads made errors, and one step under torch.profiler
     (device busy share, device time by part and by device function);
 10. the waterfall: K3 against its plain version on the card, on K1's band
     of two consecutive cu8 blocks from a random history and counter, at
     K = 40 with w = 80, 120, 840 and at K = 10 with w = 64, with its times
     beside torch.stft's (the library yardstick, never called by the port);
     the scanner with -w 120 through ScannerDriver at K = 10 over 3 steps,
     each row within 1e-2 dB of the float64 asgramcf oracle fed the
     oracle's band, decisions equal to the same run with the waterfall off;
     then BASELINE config 4 at full width (K = 40, cu8, -w 80) over four
     distinct blocks: throughput in turns with the waterfall-off run, one
     step with host reads made errors, one step under torch.profiler.

Each path (the scanner in phases 3-4, dsd_in in 7, single in 8, the -w
scanner in 10) runs with the launch counts set to 0 just before it and read
just after.  Each kernel's bound is the larger of its bytes (inputs read
once, outputs written once) over 3.35 TB/s and its f32 operations over 67
TFLOP/s (the H100 SXM's HBM3 rate and f32 rate outside the tensor cores).
The last two lines of standard output are the kernel table
``{"kernels": [...]}`` and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np

NS = 1225                      # audio samples per sub-chunk (config.SUBCHUNK_AUDIO)
REPS = 7                       # timed runs per version (median reported)
# on-card tolerances of each kernel against its plain version
TOL_SNR_DB = 100.0             # demod / band: the JAX kernel gate (front_end.py:63-66)
TOL_MAG_RTOL = 1e-5            # per-sub-chunk |y| sums
TOL_CARRY_REL = 5e-5           # carried state, relative to its peak: f32
#                                rounding through a 4M-sample recurrence and
#                                346/416-tap sums taken in another order
TOL_AUDIO_ATOL = 1e-5          # audio
TOL_TONE_REL = 3e-5            # CTCSS tone sums, relative to their peak
TOL_PCM_LSB = 1                # dsd PCM after the int16 truncation: a value
#                                near a whole number may truncate either way
TOL_DSD_ORACLE_DB = 50.0       # dsd_in vs the float64 oracle (tests/test_dsd_in.py:33-56)
TOL_TONE_DB = 35.0             # single-channel 1 kHz tone (tests/test_misc.py:80-97)
TOL_WF_DB = 2e-3               # K3 rows vs its plain version (tests/test_scanner.py:341-378)
TOL_WF_ORACLE_DB = 1e-2        # -w rows vs the float64 oracle (tests/test_driver_apps.py:140-173)
PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
PEAK_F32_OPS_PER_S = 67e12     # H100 SXM f32 outside the tensor cores
ATAN2_OPS = 20                 # operations counted for one atan2f / sincos
FFT16_OPS = 5 * 16 * 4         # one 16-point complex FFT (5 N log2 N)


def log(msg: str) -> None:
    print(msg, flush=True)


def snr_db(ref: np.ndarray, got: np.ndarray) -> float:
    ref = np.asarray(ref, np.float64)
    err = np.asarray(got, np.float64) - ref
    return float(10 * np.log10(np.sum(ref ** 2) / max(np.sum(err ** 2), 1e-300)))


def as_np(t) -> np.ndarray:
    import torch
    t = t.detach().cpu()
    return (torch.view_as_real(t) if t.is_complex() else t).numpy()


def max_err(a, b) -> float:
    a, b = as_np(a), as_np(b)
    return float(np.max(np.abs(a.astype(np.float64) - b))) if a.size else 0.0


def peak(a) -> float:
    a = as_np(a)
    return float(np.max(np.abs(a))) if a.size else 0.0


def cuda_timer(fn, args_list) -> float:
    """Median milliseconds of fn(*args) over args_list, CUDA events."""
    import torch
    times = []
    for args in args_list:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def occupied_band(n: int) -> np.ndarray:
    """All 16 channels carrying NBFM tones (no discriminator branch cuts
    from noise-only channels), channel 5 with CTCSS 12."""
    from sdr_pmr446_tpu_torch.io import synth
    return sum(synth.make_scanner_iq(
        n, channel=ch, amplitude=0.6 if ch == 5 else 0.2,
        tone_hz=300.0 + 97 * ch, ctcss_code=12 if ch == 5 else None,
        seed=ch) for ch in range(1, 17)) / 2.0


def random_duo_state(duo, rng, dev):
    import torch
    c = lambda *s: torch.as_tensor(np.asarray(
        rng.standard_normal(s) + 1j * rng.standard_normal(s), np.complex64),
        device=dev)
    return (0.1 * c(), 0.01 * c(), 0.01 * c(duo.front_hist_len),
            0.1 * c(duo.pfb.hist_len),
            torch.tensor(1, dtype=torch.int32, device=dev), 0.1 * c(16))


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the f32 rate, whichever is larger."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def front_work(n: int, bps: int, hist: int):
    """(bytes, f32 operations) of the shared front end for n samples: the
    wire and the carried history read, the DC blocker (4 per plane and
    sample) and the 346-tap resampler (2 planes, multiply-add = 2)."""
    nb = n * 25 // 128
    nbytes = n * bps + 2 * 8 * hist + 4 * (25 * 346 + 64)
    return nbytes, 8 * n + nb * 346 * 4


def duo_work(n: int, bps: int, k: int, f: int, hist: int):
    """K1: the front end; per frame the 16-branch polyphase filterbank (416
    real taps on complex samples, 4 operations a tap), the mixer on its 16
    branch outputs (a complex product each) and one 16-point FFT; per
    channel sample the discriminator (a complex product and an atan2) and
    the |y| sums; demod [16, F] and |y| sums [K, 16] written."""
    nbytes, ops = front_work(n, bps, hist)
    nbytes += 16 * f * 4 + k * 16 * 4 + 2 * 8 * 400 + 2 * 416 * 16 * 4
    ops += f * (416 * 4 + 16 * 6 + FFT16_OPS)
    ops += f * 16 * (6 + ATAN2_OPS + 1 + ATAN2_OPS)
    return nbytes, ops


def audio_bank_work(k: int, f: int, hist: int, la: int, ll: int):
    """K2: the audio and lp FIRs over 16 channels, the lp DC blocker and
    the selected channel's 38 CTCSS sums (a sincos and a complex
    multiply-add each); demod and audio [16, F], history and sums."""
    nbytes = (2 * 16 * f * 4 + 2 * 16 * hist * 4 + 2 * k * 38 * 8
              + 4 * (la + ll))
    ops = 16 * f * ((la + ll) * 2 + 4) + k * NS * 38 * (ATAN2_OPS + 4)
    return nbytes, ops


def mono_work(mono, n: int, bps: int):
    """K4: the front end, the single chain's mixer (a complex product a
    band sample), the 16x decimator (real taps on 2 planes), the
    discriminator and the post-FIR (96/25 upsampler, 43 taps an output, or
    the 408-tap audio FIR)."""
    nb = n * 25 // 128
    f, g = nb // 16, nb // 400
    nbytes, ops = front_work(n, bps, mono.front.hist_len)
    taps = mono.decim.P
    single = mono.mode == "single"
    ops += f * taps * 4 + f * (6 + ATAN2_OPS + 1)
    if single:
        ops += nb * 6 + f * mono.post_taps.shape[0] * 2
        nbytes += f * 4
    else:
        ops += g * 96 * mono.post_taps.shape[1] * 2
        nbytes += g * 96 * 4
    nbytes += (2 * 8 * mono.hb * 400 + 2 * 4 * mono.dh * 25
               + 4 * (taps + mono.post_taps.numel()))
    return nbytes, ops


def phase_kernels(dev, fmt: str, k: int, timer, reps: int = REPS):
    """K1 and K2 vs their plain versions on ``dev``; returns the K1/K2 rows."""
    import torch
    from sdr_pmr446_tpu_torch import config as C
    from sdr_pmr446_tpu_torch.kernels.audio_bank import AudioBank
    from sdr_pmr446_tpu_torch.kernels.duo import ScannerDuo
    from sdr_pmr446_tpu_torch.ops import decode
    rng = np.random.default_rng(k)
    duo = ScannerDuo(fmt, device=dev)
    n = k * C.SUBCHUNK_IN
    band = occupied_band(n)
    # a fresh input per timed run: the same band turned by another phase
    wires = [torch.as_tensor(decode.quantize_iq(band * np.exp(0.37j * s), fmt),
                             device=dev) for s in range(reps)]
    state = random_duo_state(duo, rng, dev)
    ref = duo.plain(wires[0], *state, ns=NS)
    got = duo.kernel(wires[0], *state, ns=NS)
    torch.cuda.synchronize(dev)
    d_snr = snr_db(as_np(ref.demod), as_np(got.demod))
    b_snr = snr_db(as_np(ref.pfb_hist), as_np(got.pfb_hist))
    mag_rel = max_err(ref.mag_sums, got.mag_sums) / peak(ref.mag_sums)
    log(f"  K1 {fmt} K={k}: demod SNR {d_snr:.1f} dB, band (last 400) SNR "
        f"{b_snr:.1f} dB, demod max|err| {max_err(ref.demod, got.demod):.3g}, "
        f"mag_sums rel {mag_rel:.3g}")
    check(d_snr > TOL_SNR_DB and b_snr > TOL_SNR_DB, "K1 demod/band SNR")
    check(mag_rel < TOL_MAG_RTOL, "K1 mag_sums")
    for name in ("dc_x", "dc_y", "front_hist", "pfb_hist", "prev"):
        rel = max_err(getattr(ref, name), getattr(got, name)) / max(
            peak(getattr(ref, name)), 1e-30)
        log(f"    carry {name}: rel err {rel:.3g}")
        check(rel < TOL_CARRY_REL, f"K1 carry {name}")
    check(int(ref.parity) == int(got.parity), "K1 parity")

    bank = AudioBank(device=dev)
    hist = torch.as_tensor(0.1 * rng.standard_normal((16, bank.hist)),
                           dtype=torch.float32, device=dev)
    dcx = torch.as_tensor(0.01 * rng.standard_normal(16), dtype=torch.float32,
                          device=dev)
    dcy = torch.as_tensor(0.01 * rng.standard_normal(16), dtype=torch.float32,
                          device=dev)
    gain = torch.tensor(C.SDR_DEFAULT_AUDIO_GAIN, dtype=torch.float32,
                        device=dev)
    b_arr = torch.as_tensor(rng.integers(0, C.CTCSS_BLOCK_SIZE, k),
                            dtype=torch.int32, device=dev)
    b_arr[0] = NS - 1
    sel = torch.as_tensor(rng.integers(0, 16, k), dtype=torch.int32,
                          device=dev)
    demods = [duo.plain(w, *state, ns=NS).demod for w in wires]
    aref = bank.plain(hist, dcx, dcy, demods[0], gain, b_arr, sel, NS)
    agot = bank.kernel(hist, dcx, dcy, demods[0], gain, b_arr, sel, NS)
    a_err = max_err(aref.audio, agot.audio)
    tone = max(max_err(aref.raw_pre, agot.raw_pre),
               max_err(aref.raw_mem, agot.raw_mem)) / peak(aref.raw_mem)
    log(f"  K2 K={k}: audio max|err| {a_err:.3g} (peak {peak(aref.audio):.3g}),"
        f" tone sums rel {tone:.3g}")
    check(a_err < TOL_AUDIO_ATOL, "K2 audio")
    check(tone < TOL_TONE_REL, "K2 tone sums")
    check(max_err(aref.hist, agot.hist) == 0.0, "K2 history")
    for name in ("dc_x", "dc_y"):
        rel = max_err(getattr(aref, name), getattr(agot, name)) / max(
            peak(getattr(aref, name)), 1e-30)
        log(f"    carry {name}: rel err {rel:.3g}")
        check(rel < TOL_CARRY_REL, f"K2 carry {name}")

    def t(fn, inputs):
        fn(*inputs[0])                                  # warm-up
        return timer(fn, inputs)
    duo_in = [(w,) + state for w in wires]
    bank_in = [(hist, dcx, dcy, dm, gain, b_arr, sel, NS) for dm in demods]
    times = {
        "duo_plain": t(lambda *a: duo.plain(*a, ns=NS), duo_in),
        "duo": t(lambda *a: duo.kernel(*a, ns=NS), duo_in),
        "bank": t(bank.kernel, bank_in),
        "bank_plain": t(bank.plain, bank_in),
    }
    log(f"  times K={k} {fmt} (median of {len(wires)}, ms): " + ", ".join(
        f"{key} {val:.3f}" for key, val in times.items()))
    f = k * NS
    return [
        {"name": "duo", "route": "cuda",
         "source": "sdr_pmr446_tpu_torch/csrc/duo.cu",
         "replaces": "sdr_pmr446_tpu/kernels/duo.py:374",
         "max_abs_err": max_err(ref.demod, got.demod),
         "ms": times["duo"], "plain_ms": times["duo_plain"],
         **bound(*duo_work(n, decode.BYTES_PER_SAMPLE[fmt], k, f,
                           duo.front_hist_len)),
         "library_ms": None},
        {"name": "audio_bank", "route": "cuda",
         "source": "sdr_pmr446_tpu_torch/csrc/audio_bank.cu",
         "replaces": "sdr_pmr446_tpu/kernels/audio_bank.py:545",
         "max_abs_err": a_err,
         "ms": times["bank"], "plain_ms": times["bank_plain"],
         **bound(*audio_bank_work(k, f, bank.hist,
                                  bank.taps_audio.shape[0],
                                  bank.taps_lp.shape[0])),
         "library_ms": None},
    ]


def fm_capture(n: int, start: int = 0) -> np.ndarray:
    """Samples [start, start + n) of the dsd_in fixture of
    tests/test_dsd_in.py:25-30: a 1 kHz tone at 2 kHz deviation, 300 Hz off
    the centre."""
    from sdr_pmr446_tpu_torch import config as C
    idx = np.arange(start + n)
    msg = 0.5 * np.sin(2 * np.pi * 1000.0 * idx / C.SDR_SAMPLERATE)
    return 0.9 * np.exp(2j * np.pi * (2000.0 * np.cumsum(msg) + 300.0 * idx)
                        / C.SDR_SAMPLERATE)[start:]


def mono_signal(mode: str, n: int, step: int) -> np.ndarray:
    """Block ``step`` of each chain's capture: the FM tone for dsd, channel
    5 with a 1 kHz tone for single."""
    from sdr_pmr446_tpu_torch.io import synth
    if mode == "dsd":
        return fm_capture(n, step * n)
    return synth.make_scanner_iq(n, channel=5, seed=step,
                                 start_sample=step * n)


def random_mono_state(mono, rng, dev):
    """A carried state with every field non-zero (single: mixer phase 7)."""
    import torch
    c = lambda *s: torch.as_tensor(np.asarray(
        rng.standard_normal(s) + 1j * rng.standard_normal(s), np.complex64),
        device=dev)
    st = [0.1 * c(), 0.01 * c(), 0.01 * c(mono.front.hist_len),
          0.1 * c(mono.hb * 400), 0.5 * c(),
          torch.as_tensor(0.1 * rng.standard_normal(mono.dh * 25),
                          dtype=torch.float32, device=dev)]
    n0 = (torch.tensor(7, dtype=torch.int32, device=dev)
          if mono.mode == "single" else None)
    return st, n0


def phase_mono(dev, fmt: str, k: int, timer, reps: int = REPS):
    """K4 vs its plain version in both modes over two consecutive blocks;
    returns the two K4 rows (times: median of ``reps`` fresh inputs)."""
    import torch
    from sdr_pmr446_tpu_torch import config as C
    from sdr_pmr446_tpu_torch.kernels.chan_tail import MonoChain
    from sdr_pmr446_tpu_torch.ops import decode
    n = k * C.SUBCHUNK_IN
    rows = []
    for mode in ("dsd", "single"):
        mono = MonoChain(mode, fmt, channel=5,
                         audio_gain=C.SDR_DEFAULT_AUDIO_GAIN, device=dev)
        rng = np.random.default_rng(k)
        ref, n0_ref = random_mono_state(mono, rng, dev)
        got, n0_got = list(ref), n0_ref
        errs = []
        for step in range(2):
            wire = torch.as_tensor(decode.quantize_iq(
                mono_signal(mode, n, step), fmt), device=dev)
            r = mono.plain(wire, *ref, n0=n0_ref)
            g = mono.kernel(wire, *got, n0=n0_got)
            torch.cuda.synchronize(dev)
            errs.append(max_err(r.out, g.out))
            if mode == "dsd":
                lsb = int((g.out.to(torch.int16).int()
                           - r.out.to(torch.int16).int()).abs().max())
                what = f"PCM max {lsb} LSB (f32 max|err| {errs[-1]:.3g})"
                check(lsb <= TOL_PCM_LSB, f"K4 dsd {fmt} K={k} PCM")
            else:
                snr = snr_db(as_np(r.out), as_np(g.out))
                what = f"audio SNR {snr:.1f} dB, max|err| {errs[-1]:.3g}"
                check(snr > TOL_SNR_DB, f"K4 single {fmt} K={k} audio SNR")
            carries = []
            for name in ("dc_x", "dc_y", "front_hist", "band_hist",
                         "sig_prev", "demod_hist"):
                rel = max_err(getattr(r, name), getattr(g, name)) / max(
                    peak(getattr(r, name)), 1e-30)
                carries.append(rel)
                check(rel < TOL_CARRY_REL, f"K4 {mode} carry {name}")
            if mode == "single":
                check(int(r.n0) == int(g.n0), "K4 single mixer phase")
            log(f"  K4 {mode} {fmt} K={k} block {step}: {what}; carries "
                f"rel <= {max(carries):.3g}")
            ref, n0_ref = list(r[:6]), r.n0
            got, n0_got = list(g[:6]), g.n0

        base = mono_signal(mode, n, 0)
        wires = [torch.as_tensor(decode.quantize_iq(
            base * np.exp(0.37j * s), fmt), device=dev) for s in range(reps)]
        state, n0 = random_mono_state(mono, rng, dev)
        inputs = [(w, *state) for w in wires]
        plain = lambda *a: mono.plain(*a, n0=n0)
        kernel = lambda *a: mono.kernel(*a, n0=n0)
        plain(*inputs[0])
        kernel(*inputs[0])
        t_plain = timer(plain, inputs)
        t_kernel = timer(kernel, inputs)
        b = bound(*mono_work(mono, n, decode.BYTES_PER_SAMPLE[fmt]))
        log(f"  K4 {mode} {fmt} K={k} times (median of {reps}, ms): kernel "
            f"{t_kernel:.3f}, plain {t_plain:.3f}, bound {b['bound_ms']:.4f} "
            f"({b['bound_by']})")
        rows.append({"name": f"mono_{mode}", "route": "cuda",
                     "source": "sdr_pmr446_tpu_torch/csrc/chan_tail.cu",
                     "replaces": "sdr_pmr446_tpu/kernels/chan_tail.py:600",
                     "max_abs_err": max(errs), "ms": t_kernel,
                     "plain_ms": t_plain, **b, "library_ms": None})
    return rows


def phase_dsd_app(dev, k: int, n_blocks: int):
    """dsd_in through its CLI on the card vs the float64 oracle and the
    port's CPU run; returns the blocks it ran."""
    import os
    import tempfile
    from sdr_pmr446_tpu_torch import config as C
    from sdr_pmr446_tpu_torch.apps import dsd_in as app
    from sdr_pmr446_tpu_torch.io import synth
    from sdr_pmr446_tpu_torch.oracle.chain import DsdInOracle
    from sdr_pmr446_tpu_torch.ops import decode
    n = n_blocks * k * C.SUBCHUNK_IN
    raw = decode.quantize_iq(fm_capture(n), "cu8")
    with tempfile.TemporaryDirectory() as tmp:
        cap = os.path.join(tmp, "cap.cu8")
        raw.tofile(cap)
        outs = {}
        for device in (str(dev), "cpu"):
            path = os.path.join(tmp, f"{device.replace(':', '_')}.raw")
            t0 = time.perf_counter()
            rc = app.main(["--input", cap, "--output", path,
                           "--subchunks-per-step", str(k), "--device", device])
            check(rc == 0, f"dsd_in --device {device} exit {rc}")
            log(f"  dsd_in --device {device}: {time.perf_counter() - t0:.2f} s")
            outs[device] = np.fromfile(path, dtype="<i2").astype(np.float64)
    got, cpu = outs[str(dev)], outs["cpu"]
    host_iq = ((raw.astype(np.float64) - 127.5) / 127.5).view(np.complex128)
    ref = DsdInOracle().process(host_iq)
    check(len(got) == len(cpu) == len(ref) == n * 3 // 64, "dsd_in length")
    snr = snr_db(ref, got)
    lsb = float(np.max(np.abs(got - cpu)))
    tone = synth.tone_snr_db(got[12000:] / 32767.0, 1000.0, fs=48000.0)
    log(f"  dsd_in K={k}, {n_blocks} blocks: SNR vs oracle {snr:.1f} dB, "
        f"max |card - CPU| {lsb:.0f} LSB, 1 kHz tone SNR {tone:.1f} dB")
    check(snr > TOL_DSD_ORACLE_DB, "dsd_in SNR vs oracle")
    check(lsb <= TOL_PCM_LSB, "dsd_in card vs CPU")
    return n_blocks


def chain_blocks(mode: str, k: int, n_blocks: int, fmt: str = "cu8"):
    from sdr_pmr446_tpu_torch import config as C
    from sdr_pmr446_tpu_torch.ops import decode
    n = k * C.SUBCHUNK_IN
    return [decode.quantize_iq(mono_signal(mode, n, i), fmt)
            for i in range(n_blocks)]


def make_chain(mode: str, k: int, device):
    from sdr_pmr446_tpu_torch.scanner.dsd_in import DsdInChain
    from sdr_pmr446_tpu_torch.scanner.single import SingleChannelChain
    if mode == "dsd":
        return DsdInChain(k, input_format="cu8", device=device)
    return SingleChannelChain(5, k, input_format="cu8", device=device)


def run_chain(chain, blocks):
    import torch
    st = chain.init_state()
    outs = []
    for blk in blocks:
        st, o = chain.step(st, torch.from_numpy(blk).to(chain.device))
        outs.append(o)
    return np.concatenate([as_np(o) for o in outs])


def phase_single(dev, k: int, n_blocks: int):
    """The single-channel chain on the card vs its CPU run; returns the
    blocks it ran."""
    from sdr_pmr446_tpu_torch.io import synth
    blocks = chain_blocks("single", k, n_blocks)
    got = run_chain(make_chain("single", k, dev), blocks)
    cpu = run_chain(make_chain("single", k, "cpu"), blocks)
    snr = snr_db(cpu, got)
    tone = synth.tone_snr_db(got[4000:], 1000.0)
    log(f"  single channel 5, K={k}, {n_blocks} blocks: audio SNR vs CPU "
        f"{snr:.1f} dB, 1 kHz tone SNR {tone:.1f} dB")
    check(snr > TOL_SNR_DB, "single audio SNR vs CPU")
    check(tone > TOL_TONE_DB, "single tone SNR")
    return n_blocks


def phase_chain_throughput(dev, mode: str, k: int, n_blocks: int, sync):
    """Msamples/s of one chain over distinct blocks (host clock, ending in
    a synchronize; the wire upload and the output drain inside), then one
    step under set_sync_debug_mode("error")."""
    import torch
    from sdr_pmr446_tpu_torch import config as C
    blocks = chain_blocks(mode, k, n_blocks + 1)
    chain = make_chain(mode, k, dev)
    st, _ = chain.step(chain.init_state(),
                       torch.from_numpy(blocks[0]).to(dev))
    sync()
    t0 = time.perf_counter()
    outs = []
    for blk in blocks[1:]:
        st, o = chain.step(st, torch.from_numpy(blk).to(dev))
        outs.append(o.cpu())
    sync()
    sec = time.perf_counter() - t0
    n_samp = n_blocks * k * C.SUBCHUNK_IN
    msps = n_samp / sec / 1e6
    rt = n_samp / C.SDR_SAMPLERATE / sec
    log(f"  {mode} K={k}, {n_blocks} blocks ({n_samp / C.SDR_SAMPLERATE:.2f}"
        f" s of radio): {sec * 1e3:.1f} ms, {msps:.1f} Msamples/s, "
        f"{rt:.1f}x real time")
    wire = torch.from_numpy(blocks[1]).to(dev)
    sync()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st, _ = chain.step(st, wire)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sync()
    log(f"  {mode} K={k} step under set_sync_debug_mode('error'): no host "
        f"reads")
    return {"msamples_per_s": msps, "realtime_x": rt, "seconds": sec}


def phase_oracle(dev, k: int, n_sub: int):
    """The driver on a synthetic cu8 capture vs the float64 oracle."""
    from sdr_pmr446_tpu_torch import config as C
    from sdr_pmr446_tpu_torch.io import synth
    from sdr_pmr446_tpu_torch.oracle.chain import ScannerOracle
    from sdr_pmr446_tpu_torch.ops import decode
    from sdr_pmr446_tpu_torch.runtime.driver import ScannerDriver, wire_blocks
    iq = synth.make_scanner_iq(n_sub * C.SUBCHUNK_IN, channel=5, ctcss_code=12)
    raw = decode.quantize_iq(iq, "cu8")
    host_iq = ((raw.astype(np.float64) - 127.5) / 127.5).view(np.complex128)
    ora = ScannerOracle()
    ora.process(host_iq)
    drv = ScannerDriver(subchunks_per_step=k, input_format="cu8", device=dev)
    res = drv.run(wire_blocks(raw, "cu8", drv.feed_len))
    check(np.array_equal(res.active_trace, np.asarray(ora.active_trace)),
          f"active trace {res.active_trace} vs oracle {ora.active_trace}")
    got = res.audio.reshape(-1, NS)[2:].ravel()
    want = np.stack(ora.audio)[2:].ravel()
    snr = snr_db(want, got)
    log(f"  {n_sub} sub-chunks at K={k}: active trace == oracle, audio SNR "
        f"{snr:.1f} dB; events: {res.events}")
    check(snr > 40.0, "audio SNR vs oracle")
    check(any(e.startswith("Tuned to channel 5") for e in res.events),
          "tune event")
    check(any(e.startswith("Acquired CTCSS code: 12") for e in res.events),
          "CTCSS event")
    return drv.block_index


def bench_blocks(k: int, n_blocks: int) -> list:
    """Distinct cu8 blocks: channel 5 + CTCSS 12, again with other noise,
    silence, channel 9 + CTCSS 3, ..."""
    from sdr_pmr446_tpu_torch import config as C
    from sdr_pmr446_tpu_torch.io import synth
    from sdr_pmr446_tpu_torch.ops import decode
    n = k * C.SUBCHUNK_IN
    plan = [(5, 12), (5, 12), None, (9, 3)]
    out = []
    for i in range(n_blocks):
        p = plan[i % len(plan)]
        if p is None:
            rng = np.random.default_rng(100 + i)
            iq = 1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
        else:
            iq = synth.make_scanner_iq(n, channel=p[0], ctcss_code=p[1],
                                       seed=100 + i, start_sample=i * n)
        out.append(decode.quantize_iq(iq, "cu8"))
    return out


def phase_bench(dev, k: int, n_blocks: int, sync):
    """The driver at the bench geometry: throughput and CPU equality."""
    from sdr_pmr446_tpu_torch import config as C
    from sdr_pmr446_tpu_torch.runtime.driver import ScannerDriver
    blocks = bench_blocks(k, n_blocks)
    warm = ScannerDriver(subchunks_per_step=k, input_format="cu8", device=dev)
    warm.run(blocks[:1])
    sync()
    drv = ScannerDriver(subchunks_per_step=k, input_format="cu8", device=dev)
    t0 = time.perf_counter()
    res = drv.run(blocks)
    sync()
    sec = time.perf_counter() - t0
    n_samp = n_blocks * k * C.SUBCHUNK_IN
    msps = n_samp / sec / 1e6
    rt = n_samp / C.SDR_SAMPLERATE / sec
    log(f"  K={k}, {n_blocks} blocks ({n_samp} samples, "
        f"{n_samp / C.SDR_SAMPLERATE:.2f} s of radio): {sec * 1e3:.1f} ms, "
        f"{msps:.1f} Msamples/s, {rt:.1f}x real time; events: {res.events}")
    cpu = ScannerDriver(subchunks_per_step=k, input_format="cu8",
                        device="cpu")
    t0 = time.perf_counter()
    ref = cpu.run(blocks)
    log(f"  CPU plain run: {time.perf_counter() - t0:.1f} s")
    for name in ("active_trace", "ct_detected"):
        check(np.array_equal(getattr(res, name), getattr(ref, name)),
              f"{name} GPU {getattr(res, name)} vs CPU {getattr(ref, name)}")
    # the tone index is a decision once a code is detected; before that it
    # is the argmax of noise-level tone powers, which f32 rounding may flip
    # between neighbouring tones in a transition window
    det = ref.ct_detected
    check(np.array_equal(res.ct_max_idx[det], ref.ct_max_idx[det]),
          f"detected CTCSS codes {res.ct_max_idx} vs {ref.ct_max_idx}")
    check(res.events == ref.events, f"events {res.events} vs {ref.events}")
    log(f"  decisions and events == the CPU run; rssi max|diff| "
        f"{np.max(np.abs(res.rssi_trace - ref.rssi_trace)):.3g} dB; "
        f"undetected tone-index mismatches "
        f"{int(np.sum(res.ct_max_idx != ref.ct_max_idx))}")
    return warm.block_index + drv.block_index, {"scanner": {
        "msamples_per_s": msps, "realtime_x": rt, "seconds": sec}}


#: the parts of a scanner step, by the name prefixes of their device events
SCANNER_PARTS = (("K1 duo", ("duo_", "fe_")), ("K2 audio bank", ("ab_",)),
                 ("DC carry scan (K1 and K2)", ("dc_carry",)),
                 ("K3 waterfall", ("wf_",)),
                 ("copies", ("Memcpy", "Memset")))
#: the parts of a dsd_in / single step
CHAIN_PARTS = (("K4 mono chain (7 kernels)", ("fe_", "dc_carry", "mono_")),
               ("copies", ("Memcpy", "Memset")))


def kernel_name(name: str) -> str:
    """A device event's function name, template arguments kept."""
    return name.removeprefix("void ").split("(")[0]


def device_group(name: str, parts) -> str:
    """The part of the step a device event belongs to, by its name."""
    fn = kernel_name(name).split("<")[0]
    for label, prefixes in parts:
        if fn.startswith(prefixes):
            return label
    return "other"


def phase_no_host_reads(dev, k: int, sync, waterfall: int = 0):
    """One warmed-up chain step under set_sync_debug_mode("error"): the
    step (FSM and waterfall included) makes no host read, so steps queue
    without waiting for the device.  Returns the steps it ran (2)."""
    import torch
    from sdr_pmr446_tpu_torch import config as C
    from sdr_pmr446_tpu_torch.scanner.chain import (ScannerChain,
                                                    make_runtime_params)
    chain = ScannerChain(C.BlockConfig(k), input_format="cu8", device=dev,
                         waterfall=waterfall)
    params = make_runtime_params(C.ScannerArgs(waterfall=waterfall), dev)
    wires = [torch.as_tensor(b, device=dev) for b in bench_blocks(k, 2)]
    state, _ = chain.step(chain.init_state(), wires[0], params)
    sync()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, _ = chain.step(state, wires[1], params)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sync()
    log(f"  K={k} -w {waterfall} step under set_sync_debug_mode('error'): "
        f"no host reads")
    return 2


def phase_profile(dev, k: int, sync, waterfall: int = 0):
    """One scanner K-block step under torch.profiler (profile_step), after
    a warm-up step; returns the steps it ran (2)."""
    from sdr_pmr446_tpu_torch import config as C
    from sdr_pmr446_tpu_torch.runtime.driver import ScannerDriver
    blocks = bench_blocks(k, 2)
    drv = ScannerDriver(C.ScannerArgs(waterfall=waterfall),
                        subchunks_per_step=k, input_format="cu8", device=dev)
    drv.run(blocks[:1])
    sync()
    profile_step(lambda: drv.run(blocks[1:]), sync, SCANNER_PARTS,
                 "other (FSM, RSSI, select)", by_kernel=waterfall > 0)
    return drv.block_index


def phase_profile_chain(dev, mode: str, k: int, sync):
    """One dsd_in / single K-block step, wire upload and output drain
    included, under torch.profiler (profile_step)."""
    import torch
    blocks = chain_blocks(mode, k, 2)
    chain = make_chain(mode, k, dev)
    st, _ = chain.step(chain.init_state(),
                       torch.from_numpy(blocks[0]).to(dev))
    sync()

    def step():
        _, out = chain.step(st, torch.from_numpy(blocks[1]).to(dev))
        out.cpu()
    profile_step(step, sync, CHAIN_PARTS, "other (int16 cast, small ops)",
                 by_kernel=True)


def wf_work(k: int, w: int, hops: int):
    """K3: the band planes and the history read, the rows and the new
    history written; as an FFT, 5 w log2(w) operations a hop, plus the
    window (a real by complex product, 2 a sample) and |S|^2 (3 a bin)."""
    nb, wl = k * 19600, w // 2
    nbytes = 8 * nb + 2 * 8 * wl + 4 * k * w + 8
    return nbytes, hops * (5 * w * math.log2(w) + 2 * wl + 3 * w)


def stft_rows(dev, w: int, k: int, cnt: int):
    """The library yardstick: torch.stft (cuFFT) over the same hops, then
    |S|^2 and the per-row sums.  Returns (inputs(hist, band) -> x, the
    timed call(x) -> row sums [k, w], the hops' row counts [k])."""
    import torch
    wl, delay, nb = w // 2, w // 4, k * 19600
    u0 = delay - cnt
    hops = (nb - u0) // delay + 1
    u = u0 + delay * torch.arange(hops, device=dev)
    row = (u - 1) // 19600
    counts = torch.bincount(row, minlength=k).float()
    win = torch.hamming_window(wl, periodic=True, dtype=torch.float64,
                               device=dev)
    win = (win / win.sum()).float()

    def inputs(hist, band):
        # torch.stft centres a w/2 window in each w-sample frame: frame i
        # starts w/4 before hop i's window, xe[u0 + i w/4 .. + w/2)
        xe = torch.cat([torch.zeros(delay, dtype=torch.complex64, device=dev),
                        hist[hist.shape[0] - wl:],
                        torch.complex(band[0], band[1]),
                        torch.zeros(w, dtype=torch.complex64, device=dev)])
        return xe[u0:u0 + (hops - 1) * delay + w].contiguous()

    def call(x):
        spec = torch.stft(x, n_fft=w, hop_length=delay, win_length=wl,
                          window=win, center=False, return_complex=True)
        p = spec.real ** 2 + spec.imag ** 2                 # [w, hops]
        return torch.zeros(k, w, device=dev).index_add_(0, row, p.T)
    return inputs, call, counts, hops


def waterfall_case(dev, k: int, w: int, timer, reps: int = REPS):
    """K3 vs its plain version on K1's band of two consecutive cu8 blocks,
    from a random history (the PFB history's tail for w <= 800, else a
    carried wf_hist) and counter; then the times of the kernel, the plain
    version and torch.stft on ``reps`` fresh inputs.  Returns its row."""
    import torch
    from sdr_pmr446_tpu_torch.kernels.duo import ScannerDuo
    from sdr_pmr446_tpu_torch.kernels.waterfall import Waterfall
    from sdr_pmr446_tpu_torch.ops import spectrogram
    rng = np.random.default_rng(w + k)
    duo = ScannerDuo("cu8", device=dev)
    wf = Waterfall(w, device=dev)
    wl = w // 2
    dstate = random_duo_state(duo, rng, dev)
    cnt0 = int(rng.integers(1, w // 4))
    cnt = torch.tensor(cnt0, dtype=torch.int32, device=dev)
    own = torch.as_tensor(np.asarray(0.1 * (rng.standard_normal(wl) + 1j
                                            * rng.standard_normal(wl)),
                                     np.complex64), device=dev)
    ref_h = got_h = own
    ref_c = got_c = cnt
    errs = []
    for step, blk in enumerate(bench_blocks(k, 2)):
        d = duo.kernel(torch.as_tensor(blk, device=dev), *dstate, ns=NS)
        hist_r, hist_g = ((dstate[3], dstate[3]) if wl <= 400
                          else (ref_h, got_h))
        r = wf.plain(d.band, hist_r, ref_c)
        g = wf.kernel(d.band, hist_g, got_c)
        torch.cuda.synchronize(dev)
        errs.append(max_err(r.rows, g.rows))
        h_rel = max_err(r.hist, g.hist) / max(peak(r.hist), 1e-30)
        log(f"  K3 w={w} K={k} block {step}: rows max|err| {errs[-1]:.3g} dB, "
            f"hist rel {h_rel:.3g}, cnt {int(r.cnt)} / {int(g.cnt)}")
        check(errs[-1] < TOL_WF_DB, f"K3 w={w} K={k} rows")
        check(h_rel < TOL_CARRY_REL, f"K3 w={w} K={k} history")
        check(int(r.cnt) == int(g.cnt), f"K3 w={w} K={k} counter")
        check(bool(torch.isfinite(g.rows).all()), f"K3 w={w} rows finite")
        dstate = (d.dc_x, d.dc_y, d.front_hist, d.pfb_hist, d.parity, d.prev)
        ref_h, ref_c, got_h, got_c = r.hist, r.cnt, g.hist, g.cnt

    # timing: block 0's band turned by another phase for each run
    d = duo.kernel(torch.as_tensor(bench_blocks(k, 1)[0], device=dev),
                   *random_duo_state(duo, rng, dev), ns=NS)
    hist = d.pfb_hist if wl <= 400 else own
    bands = []
    for s_ in range(reps):
        c, si = math.cos(0.37 * s_), math.sin(0.37 * s_)
        bands.append(torch.stack([c * d.band[0] - si * d.band[1],
                                  si * d.band[0] + c * d.band[1]]))
    inputs = [(b, hist, cnt) for b in bands]
    wf.kernel(*inputs[0])
    wf.plain(*inputs[0])
    t_kernel = timer(wf.kernel, inputs)
    t_plain = timer(wf.plain, inputs)
    prep, call, counts, hops = stft_rows(dev, w, k, cnt0)
    xs = [(prep(hist, b),) for b in bands]
    lib_sums = call(*xs[0])
    t_lib = timer(call, xs)
    lib_rows = spectrogram.rows_from_psd_sums(lib_sums, w, counts=counts)
    lib_err = max_err(lib_rows, wf.kernel(*inputs[0]).rows)
    check(lib_err < TOL_WF_ORACLE_DB, f"K3 w={w}: torch.stft rows differ "
          f"by {lib_err:.3g} dB")
    b = bound(*wf_work(k, w, hops))
    log(f"  K3 w={w} K={k} ({hops} hops) times (median of {reps}, ms): "
        f"kernel {t_kernel:.4f}, plain {t_plain:.4f}, torch.stft "
        f"{t_lib:.4f}, bound {b['bound_ms']:.5f} ({b['bound_by']}); "
        f"torch.stft rows within {lib_err:.3g} dB of the kernel's")
    return {"name": f"waterfall_w{w}_k{k}", "route": "cuda",
            "source": "sdr_pmr446_tpu_torch/csrc/waterfall.cu",
            "replaces": "sdr_pmr446_tpu/kernels/duo.py:101",
            "max_abs_err": max(errs), "ms": t_kernel, "plain_ms": t_plain,
            **b, "library_ms": t_lib}


def phase_waterfall_oracle(dev, k: int, n_sub: int, w: int):
    """The driver with -w on a synthetic cu8 capture: every row within
    1e-2 dB of the float64 asgramcf oracle fed the oracle's band, the
    decisions equal to the same run with the waterfall off, and K3
    launched once a step of the -w run."""
    from sdr_pmr446_tpu_torch import config as C
    from sdr_pmr446_tpu_torch.io import synth
    from sdr_pmr446_tpu_torch.kernels import waterfall
    from sdr_pmr446_tpu_torch.oracle.chain import (AsgramStream,
                                                   PolyResamplerStream,
                                                   dc_blocker_stream)
    from sdr_pmr446_tpu_torch.ops import decode
    from sdr_pmr446_tpu_torch.runtime.driver import ScannerDriver, wire_blocks
    from sdr_pmr446_tpu_torch.taps import design as D
    iq = synth.make_scanner_iq(n_sub * C.SUBCHUNK_IN, channel=5, ctcss_code=12)
    raw = decode.quantize_iq(iq, "cu8")
    off = ScannerDriver(subchunks_per_step=k, input_format="cu8", device=dev)
    ref = off.run(wire_blocks(raw, "cu8", off.feed_len))
    before = waterfall.LAUNCHES
    drv = ScannerDriver(C.ScannerArgs(waterfall=w), subchunks_per_step=k,
                        input_format="cu8", device=dev)
    res = drv.run(wire_blocks(raw, "cu8", drv.feed_len))
    launches = waterfall.LAUNCHES - before
    host_iq = ((raw.astype(np.float64) - 127.5) / 127.5).view(np.complex128)
    band = PolyResamplerStream(D.resampler_taps(), C.RESAMP_L,
                               C.RESAMP_M).process(
        dc_blocker_stream().process(host_iq))
    asg = AsgramStream(w)
    check(res.waterfall.shape == (n_sub, w), f"rows {res.waterfall.shape}")
    err = 0.0
    for r in range(n_sub):
        asg.write(band[r * C.SUBCHUNK_RESAMP:(r + 1) * C.SUBCHUNK_RESAMP])
        err = max(err, float(np.max(np.abs(res.waterfall[r] - asg.execute()))))
    log(f"  -w {w}, {n_sub} sub-chunks at K={k} ({drv.block_index} steps, "
        f"hop counter {int(drv.state.wf_cnt)} after them): rows within "
        f"{err:.3g} dB of the oracle; K3 launched {launches} times")
    check(err < TOL_WF_ORACLE_DB, "-w rows vs the oracle")
    check(launches == drv.block_index, "K3 launches vs steps")
    for name in ("active_trace", "ct_detected", "ct_max_idx"):
        check(np.array_equal(getattr(res, name), getattr(ref, name)),
              f"-w {w} {name} vs the waterfall-off run")
    check(res.events == ref.events, "-w events vs the waterfall-off run")
    check(ref.waterfall is None, "waterfall-off rows")
    log(f"  decisions and events == the waterfall-off run: {res.events}")


def phase_bench_waterfall(dev, k: int, n_blocks: int, w: int, sync):
    """BASELINE config 4 at full width: the driver with -w over distinct
    blocks, in turns with the waterfall-off run (off, on, on, off).
    Returns the steps it ran with the waterfall on and off (warm-ups
    included) and the throughputs."""
    from sdr_pmr446_tpu_torch import config as C
    from sdr_pmr446_tpu_torch.runtime.driver import ScannerDriver
    blocks = bench_blocks(k, n_blocks)
    args = {0: C.ScannerArgs(), w: C.ScannerArgs(waterfall=w)}
    steps = {0: 0, w: 0}
    for ww in (0, w):
        warm = ScannerDriver(args[ww], subchunks_per_step=k,
                             input_format="cu8", device=dev)
        warm.run(blocks[:1])
        steps[ww] += warm.block_index
    sync()
    n_samp = n_blocks * k * C.SUBCHUNK_IN
    out, results = {0: [], w: []}, {}
    for ww in (0, w, w, 0):
        drv = ScannerDriver(args[ww], subchunks_per_step=k,
                            input_format="cu8", device=dev)
        t0 = time.perf_counter()
        results[ww] = drv.run(blocks)
        sync()
        sec = time.perf_counter() - t0
        out[ww].append(n_samp / sec / 1e6)
        steps[ww] += drv.block_index
        log(f"  K={k} -w {ww}, {n_blocks} blocks: {sec * 1e3:.1f} ms, "
            f"{out[ww][-1]:.1f} Msamples/s, "
            f"{n_samp / C.SDR_SAMPLERATE / sec:.1f}x real time")
    on, off = results[w], results[0]
    check(on.waterfall.shape == (n_blocks * k, w)
          and bool(np.isfinite(on.waterfall).all()), "config 4 rows")
    for name in ("active_trace", "ct_detected"):
        check(np.array_equal(getattr(on, name), getattr(off, name)),
              f"config 4 {name} vs the waterfall-off run")
    check(on.events == off.events, "config 4 events")
    return steps[w], steps[0], {
        f"scanner_w{w}": {"msamples_per_s": out[w]},
        "scanner_w0_same_call": {"msamples_per_s": out[0]}}


def profile_step(run, sync, parts, other: str, by_kernel: bool = False):
    """``run()`` under torch.profiler: the device's busy share (the union
    of its events' intervals) and its time by part of the step (profiling
    adds host overhead to the wall time); with ``by_kernel``, also by
    device function.

    A small device op and a synchronize come first: the device's first
    activity in a profiler session is sometimes not recorded (a step's
    3.2 MB upload went missing so), and only device events that start
    inside the step's own record_function range are counted."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device="cuda").add_(1)
        sync()
        with record_function("chip_smoke step"):
            t0 = time.perf_counter()
            run()
            sync()
            wall_ms = (time.perf_counter() - t0) * 1e3
    step_start = next(e.time_range.start for e in prof.events()
                      if e.name == "chip_smoke step")
    # the range itself shows up on the device too, as a user annotation
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and e.time_range.start >= step_start
           and e.name != "chip_smoke step"]
    check(len(evs) > 0, "the profiler recorded no device events")
    busy_us, end = 0.0, -float("inf")
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in evs):
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
    groups: dict = {}
    for e in evs:
        label = device_group(e.name, parts)
        g = groups.setdefault(other if label == "other" else label, [0.0, 0])
        g[0] += e.time_range.elapsed_us()
        g[1] += 1
    log(f"  profiled step: wall {wall_ms:.1f} ms, device busy "
        f"{busy_us / 1e3:.3f} ms ({100 * busy_us / 1e3 / wall_ms:.1f}%), "
        f"{len(evs)} device events")
    for name, (us, n) in sorted(groups.items(), key=lambda g: -g[1][0]):
        log(f"    {us / 1e3:8.3f} ms  x{n:<5d} {name}")
    if by_kernel:
        fns: dict = {}
        for e in evs:
            fns[kernel_name(e.name)] = (fns.get(kernel_name(e.name), 0.0)
                                        + e.time_range.elapsed_us())
        for name, us in sorted(fns.items(), key=lambda f: -f[1]):
            log(f"      {us / 1e3:8.4f} ms  {name}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from sdr_pmr446_tpu_torch.kernels import (audio_bank, build, chan_tail,
                                              duo, waterfall)
    dev = torch.device("cuda", 0)
    sync = lambda: torch.cuda.synchronize(dev)

    log("phase 1: card and build")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    lib = build.build(verbose=True)
    build.library()
    log(f"  built and loaded {lib} in {time.perf_counter() - t0:.1f} s")

    log("phase 2: kernels vs plain versions on the card")
    rows = phase_kernels(dev, "cu8", 40, cuda_timer)
    phase_kernels(dev, "cs16", 10, cuda_timer)

    duo.LAUNCHES = 0
    audio_bank.LAUNCHES = 0
    log("phase 3: scanner vs the oracle (ScannerDriver, cu8, K=10)")
    steps = phase_oracle(dev, 10, 30)
    log("phase 4: scanner at the bench geometry (K=40)")
    bench_steps, bench = phase_bench(dev, 40, 4, sync)
    steps += bench_steps
    steps += phase_no_host_reads(dev, 40, sync)
    steps += phase_profile(dev, 40, sync)
    launches = {"duo": duo.LAUNCHES, "audio_bank": audio_bank.LAUNCHES}

    log(f"phase 5: launches over {steps} main-path steps: {launches}")
    for row in rows:
        row["launches"] = launches[row["name"]]
        check(row["launches"] == steps, f"{row['name']} launched "
              f"{row['launches']} times for {steps} steps")

    log("phase 6: K4 (mono chain) vs its plain version on the card")
    mono_rows = phase_mono(dev, "cu8", 16, cuda_timer)
    phase_mono(dev, "cs16", 15, cuda_timer)
    phase_mono(dev, "cu8", 10, cuda_timer)

    log("phase 7: dsd_in end to end (apps.dsd_in --device cuda, cu8, K=10)")
    chan_tail.LAUNCHES = 0
    dsd_steps = phase_dsd_app(dev, 10, 3)
    mono_launches = {"mono_dsd": chan_tail.LAUNCHES}
    log("phase 8: single channel end to end (channel 5, cu8, K=16)")
    chan_tail.LAUNCHES = 0
    single_steps = phase_single(dev, 16, 2)
    mono_launches["mono_single"] = chan_tail.LAUNCHES
    log(f"  K4 launches: dsd_in {mono_launches['mono_dsd']} for {dsd_steps} "
        f"steps, single {mono_launches['mono_single']} for {single_steps}")
    for row, want in zip(mono_rows, (dsd_steps, single_steps)):
        row["launches"] = mono_launches[row["name"]]
        check(row["launches"] == want, f"{row['name']} launched "
              f"{row['launches']} times for {want} steps")
    rows += mono_rows

    log("phase 9: each chain at K=16 (cu8), four distinct blocks")
    for mode in ("dsd", "single"):
        bench[mode] = phase_chain_throughput(dev, mode, 16, 4, sync)
        phase_profile_chain(dev, mode, 16, sync)

    log("phase 10: the waterfall (K3) on the card")
    wf_rows = [waterfall_case(dev, k, w, cuda_timer)
               for k, w in ((40, 80), (40, 120), (40, 840), (10, 64),
                            (10, 4096))]
    log("  the scanner with -w 120 vs the oracle (ScannerDriver, cu8, K=10)")
    phase_waterfall_oracle(dev, 10, 30, 120)
    log("  BASELINE config 4: the scanner with -w 80 at K=40 (cu8)")
    duo.LAUNCHES = audio_bank.LAUNCHES = waterfall.LAUNCHES = 0
    on, off, wf_bench = phase_bench_waterfall(dev, 40, 4, 80, sync)
    on += phase_no_host_reads(dev, 40, sync, waterfall=80)
    on += phase_profile(dev, 40, sync, waterfall=80)
    wf_launches = {"duo": duo.LAUNCHES, "audio_bank": audio_bank.LAUNCHES,
                   "waterfall": waterfall.LAUNCHES}
    bench.update(wf_bench)
    log(f"  launches over config 4 ({on} steps with the waterfall on, {off} "
        f"off): {wf_launches}")
    check(wf_launches["waterfall"] == on, "K3 launches on config 4")
    for name in ("duo", "audio_bank"):
        check(wf_launches[name] == on + off, f"{name} launches on config 4")
    for row in wf_rows:
        row["launches"] = wf_launches["waterfall"]
    rows += wf_rows
    log(smi)
    log(json.dumps({"bench": bench, "card": smi}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

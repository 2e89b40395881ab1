#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA scanner (sdr_pmr446_tpu_torch) on one GPU.

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
     float64 reference oracle (sdr_pmr446_tpu.oracle), tune and CTCSS
     events present;
  4. the scanner at the bench geometry K = 40 for four distinct blocks:
     throughput, decisions equal to the port's CPU run (plain versions),
     one step with host reads made errors (set_sync_debug_mode), and one
     step under torch.profiler (device busy share, device time by part);
  5. the kernels' launch counts over the runs of phases 3 and 4.

The last two lines of standard output are the kernel table
``{"kernels": [...]}`` and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
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
    from sdr_pmr446_tpu.io import synth
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


def phase_kernels(dev, fmt: str, k: int, timer, reps: int = REPS):
    """K1 and K2 vs their plain versions on ``dev``; returns the K1/K2 rows."""
    import torch
    from sdr_pmr446_tpu import config as C
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
    return [
        {"name": "duo", "route": "cuda",
         "source": "sdr_pmr446_tpu_torch/csrc/duo.cu",
         "replaces": "sdr_pmr446_tpu/kernels/duo.py:374",
         "max_abs_err": max_err(ref.demod, got.demod),
         "ms": times["duo"], "plain_ms": times["duo_plain"]},
        {"name": "audio_bank", "route": "cuda",
         "source": "sdr_pmr446_tpu_torch/csrc/audio_bank.cu",
         "replaces": "sdr_pmr446_tpu/kernels/audio_bank.py:545",
         "max_abs_err": a_err,
         "ms": times["bank"], "plain_ms": times["bank_plain"]},
    ]


def phase_oracle(dev, k: int, n_sub: int):
    """The driver on a synthetic cu8 capture vs the float64 oracle."""
    from sdr_pmr446_tpu import config as C
    from sdr_pmr446_tpu.io import synth
    from sdr_pmr446_tpu.oracle.chain import ScannerOracle
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
    from sdr_pmr446_tpu import config as C
    from sdr_pmr446_tpu.io import synth
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
    from sdr_pmr446_tpu import config as C
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
    return drv.block_index, {"msamples_per_s": msps, "realtime_x": rt,
                             "seconds": sec}


def device_group(name: str) -> str:
    """The part of the step a device event belongs to, by its name."""
    fn = name.removeprefix("void ").split("(")[0].split("<")[0]
    if fn.startswith("duo_"):
        return "K1 duo"
    if fn.startswith("ab_"):
        return "K2 audio bank"
    if fn.startswith("dc_carry"):
        return "DC carry scan (K1 and K2)"
    if fn.startswith(("Memcpy", "Memset")):
        return "copies"
    return "other (FSM, RSSI, select)"


def phase_no_host_reads(dev, k: int, sync):
    """One warmed-up chain step under set_sync_debug_mode("error"): the
    step (FSM included) makes no host read, so steps queue without
    waiting for the device."""
    import torch
    from sdr_pmr446_tpu import config as C
    from sdr_pmr446_tpu_torch.scanner.chain import (ScannerChain,
                                                    make_runtime_params)
    chain = ScannerChain(C.BlockConfig(k), input_format="cu8", device=dev)
    params = make_runtime_params(C.ScannerArgs(), dev)
    wires = [torch.as_tensor(b, device=dev) for b in bench_blocks(k, 2)]
    state, _ = chain.step(chain.init_state(), wires[0], params)
    sync()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, _ = chain.step(state, wires[1], params)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sync()
    log(f"  K={k} step under set_sync_debug_mode('error'): no host reads")
    return 2


def phase_profile(dev, k: int, sync):
    """One K-block step under torch.profiler: the device's busy share (the
    union of its events' intervals) and its time by part of the step
    (profiling adds host overhead to the wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from sdr_pmr446_tpu_torch.runtime.driver import ScannerDriver
    blocks = bench_blocks(k, 2)
    drv = ScannerDriver(subchunks_per_step=k, input_format="cu8", device=dev)
    drv.run(blocks[:1])
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        drv.run(blocks[1:])
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # CUPTI's own "Activity Buffer Request" events are not device work
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and not e.name.startswith("Activity Buffer")]
    check(len(evs) > 0, "the profiler recorded no device events")
    busy_us, end = 0.0, -float("inf")
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in evs):
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
    groups: dict = {}
    for e in evs:
        g = groups.setdefault(device_group(e.name), [0.0, 0])
        g[0] += e.time_range.elapsed_us()
        g[1] += 1
    log(f"  profiled step: wall {wall_ms:.1f} ms, device busy "
        f"{busy_us / 1e3:.3f} ms ({100 * busy_us / 1e3 / wall_ms:.1f}%), "
        f"{len(evs)} device events")
    for name, (us, n) in sorted(groups.items(), key=lambda g: -g[1][0]):
        log(f"    {us / 1e3:8.3f} ms  x{n:<5d} {name}")
    return 1


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from sdr_pmr446_tpu_torch.kernels import audio_bank, build, duo
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
        check(row["launches"] >= steps, f"{row['name']} launched "
              f"{row['launches']} times for {steps} steps")
    log(json.dumps({"bench": bench, "card": smi}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

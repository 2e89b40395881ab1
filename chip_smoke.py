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
     the card, at K = 40 (cu8) and K = 10 (cs16), a second K1 call equal
     to the first bit for bit; K2 in each of its four tap configurations
     (lowpass, fir_deemph), a second call equal to the first and K8
     apply's and apply_dc's audio equal to K2's, bit for bit; with their
     times (CUDA events and device time under torch.profiler, K2's by
     CUDA kernel);
  3. the scanner through ScannerDriver on a synthetic cu8 capture at K = 10
     (~3 s): active-channel trace exact and audio SNR > 40 dB against the
     float64 reference oracle (the port's copy, oracle/chain.py), tune and
     CTCSS events present;
  4. the scanner at the bench geometry K = 40 for four distinct blocks:
     throughput, decisions equal to the port's CPU run (plain versions),
     one step with host reads made errors (set_sync_debug_mode), and one
     step under torch.profiler (device busy share, device time by part and
     by device function: K1's six CUDA kernels apart);
  5. the kernels' launch counts over the runs of phases 3 and 4;
  6. K4 (the dsd_in / single mono chain) against its plain version on the
     card in both modes, two consecutive blocks each at K = 16 (cu8), 15
     (cs16, an odd number of group rows) and 10 (cu8, the app's K), with
     its times (events, and device time by CUDA kernel: the front end's
     three and the tail's two, and the span of a call on the device);
  7. dsd_in end to end through its CLI (apps/dsd_in.main, --device cuda)
     on a synthetic cu8 FM capture at the app's K = 10: SNR > 50 dB
     against the float64 DsdInOracle, within 1 LSB of the port's CPU run,
     and K4's launch count over that run;
  8. the single-channel chain end to end, channel 5 at K = 16: audio SNR
     > 100 dB against the CPU run, 1 kHz tone SNR > 35 dB, K4's launch
     count over that run;
  9. each chain at K = 16 cu8 over four distinct blocks: throughput, one
     step with host reads made errors, and one step under torch.profiler
     (device busy share, device time by part and by device function; K4
     five CUDA kernels a step, none of the retired tail kernels);
 10. the waterfall: K3 against its plain version on the card, on K1's band
     of two consecutive cu8 blocks from a random history and counter, each
     call repeated bit for bit, at K = 40 with w = 80, 120, 840 and at K =
     10 with w = 64, 132, 4096, 8192 and 16384 (from 4096 also, with the
     plain version, against the float64 asgramcf oracle), and at K = 2 with
     w = 78400 against the oracle alone (the plain version's [w, 2w] table
     does not fit; its row is logged, not listed), each Waterfall built in
     under a second, with its times (CUDA events around the call, and
     device time under torch.profiler) beside torch.stft's (the library
     yardstick, never called by the port);
     the scanner with -w 120 through ScannerDriver at K = 10 over 3 steps,
     each row within 1e-2 dB of the float64 asgramcf oracle fed the
     oracle's band, decisions equal to the same run with the waterfall off;
     then BASELINE config 4 at full width (K = 40, cu8, -w 80) over four
     distinct blocks: throughput in turns with the waterfall-off run, one
     step with host reads made errors, one step under torch.profiler.
 11. the split-kernel engines: (a) K6 (front end) at K = 40 cu8 and
     K = 10 cs16, K7 (PFB + discriminator) on K6's band in both |y| forms,
     K9 (resampler) at K = 40 and 10, each call repeated bit for bit, with
     F.conv1d's event and device times beside its own (the library
     yardstick, never called by the port), K5 (channel tail) in both modes
     on K6's band at K = 16 cu8 and K = 15 cs16, each against its plain
     version with its times (K6, K7 and K9 also on the device; K5 on the
     device by CUDA kernel, beside F.conv1d's: the dsd decimator, stride
     16, and the single audio FIR, its yardsticks); (b) the
     scanner's trio (fuse_band=False: K6 -> K7) and fuse_dc=False (plain
     DC blocker -> K9 -> K7) engines against the oracle at K = 10
     (decisions also equal to phase 3's run), then at K = 40 in turns
     with the duo (duo, trio, fuse_dc_off, fuse_dc_off, trio, duo), one
     step each with host reads made errors, one profiled trio step; (c)
     dsd_in and single on the two-kernel engine (mono=False: K6 -> K5) at
     K = 16 against the mono engine on the same bytes, throughput in turns
     (mono, two, two, mono), a step with host reads made errors, one
     profiled step (K5 two CUDA kernels, K6 four; in phase 9's, K4 five).
 12. the scanner's op-path switches: (a) K8 (the audio bank without its
     CTCSS epilogue: apply and apply_dc) against its plain versions at
     K = 40 and 10 on the demod of K6 -> K7, in each of the four tap
     configurations, over two calls from a random state, each call
     repeated and its audio equal to K2's, bit for bit, with its times
     and, for apply, F.conv1d's (the library yardstick, never called by
     the port), by event and on the device by CUDA kernel;
     (b) the fuse_ctcss=False, fuse_lp_dc=False and fuse_rssi=False engines
     through ScannerDriver against the oracle at K = 10 (decisions also
     equal to phase 3's run), then at K = 40 in turns with the trio (trio,
     ctcss_off, lp_dc_off, rssi_off, rssi_off, lp_dc_off, ctcss_off, trio):
     decisions, events and audio (bit for bit) equal to the trio's, one
     step each with host reads made errors, one profiled fuse_lp_dc=False
     step; (c) the launch counts of K8 (apply, apply_dc), K2, K6 and K7.
 13. the time-sharded chains on a one-card (stream x time) mesh, BASELINE
     config 5: (a) K10 (the pre-pass's wire-direct DC summary) against its
     plain version over one config-5 step's wire (4 streams x K = 40, one
     launch) in each format, w within 1e-5 of its peak, xl exact, with its
     times: by event, and on the device with L2 cold (7 fresh wires, 225
     MB) and in the path's order (right after the wire's upload); (b) K11
     (the halo of a time shard in one launch, straight from the planes)
     against its plain version (torch.complex of the tails, then the
     collective's shift) on the planes the plane path's two halos got in
     one step, bit for bit, with both times by event and on the device,
     the ring shift alone against torch.roll on the same tails, and the
     two halos of a step profiled: their CUDA kernels and device time, K11
     (one launch a halo) beside the earlier composition (torch.complex,
     the ring shift, the carry copy); (c) the sharded
     duo at (4, 5), K = 40, cu8, over 4 captures of 4 occupied blocks and
     a hang block (the transmission ends half-way, receiver noise
     follows), against 4
     unsharded ScannerChains on the same bytes with JAX's sharded gates
     (decisions and events exact, RSSI within 5e-3 dB, audio within 1e-4),
     throughput in turns (sharded, unsharded, unsharded, sharded), one step
     with host reads made errors, one profiled step; (d) the plane path at
     (4, 4), K = 40, with halo_dma=True equal to halo_dma=False field for
     field and to ScannerChain(fuse_dc=False) per stream under the same
     gates, throughput in turns with (c)'s duo over the same 4 blocks; (e)
     the sharded dsd / single mono chains at (2, 2), K = 16, against the
     unsharded mono chains (PCM within 1 LSB and > 60 dB, audio > 60 dB);
     (f) the duo on an (S, 1) mesh (bench.py's batch8: 8 streams, K = 8,
     no pre-pass) and (g) the sharded trio (fuse_band=False) at (4, 5), K =
     40, each against unsharded chains under the same gates.  The launch
     counts of K10, K11, K1, K2, K4, K6, K7, K8 and K9 over each of (c)-(g)
     are set to 0 just before and checked == just after; then every kernel
     of the path is held against its plain version on the inputs one step
     of the path gave it (every shard: K_local = 8 for K1, K2, K4, K6 and
     K7 sums, 10 for K9, K7 plane and K8), field by field (PATH_GATES).
 14. K12, the probes: (a) the two probe tools through their entry points
     (tools/probe_precision.py, tools/probe_layout.py: main()), with the
     launch counts set to 0 just before and read just after (each mode
     and each move once); (b) the precision readings: the kernel's ffma =
     3xtf32 = 256.0625 and tf32 = 256.0 exactly, torch.matmul and F.conv1d
     under the TF32-off policy 256.0625 exactly, their TF32-on readings
     printed, both switches restored; (c) K12b's three modes against their
     plain versions on seeded random [128, 256] x [256, 128] inputs (within
     1e-5 of the output's peak), with their times beside torch.matmul's
     (the library yardstick, never called by a mode), by event and on the
     device, and the built library's SASS (cuobjdump -sass) holding HGMMA
     in both tensor-core kernels (probe_wgmma); (d) K12a's eight moves bit
     for bit against their plain versions, with their times and their
     library moves' (each held bit for bit to the plain version too), by
     event and on the device, each bound by the bytes the move must move
     (probe_layout.min_bytes).
 15. faithful mode (scanner/faithful.py, no kernel of its own: plain ops on
     the card) at K = 10 on tests/test_faithful.py's busy scenario (tune,
     a lock_mode max switch, a detune, CTCSS): against the float64 oracle
     through every transition (active trace exact, audio SNR > 60 dB, peak
     error < 2e-2, the detector's final state), decisions equal to the
     port's CPU run, one step with host reads made errors, throughput in
     Msamples/s, one step under torch.profiler; no kernel launches.
 16. the driver on the card at K = 40, cu8, over 4 distinct blocks: an
     uninterrupted run with metrics (one JSONL record a sub-chunk, the JAX
     keys), a run with a checkpoint every block stopped by request_stop()
     after 2 blocks (the final flush), and a restore from that checkpoint
     that runs the rest: decisions, events and audio of the two parts
     equal to the uninterrupted run's bit for bit; K1 and K2 launched once
     a step.
 17. multi-block dispatch (runtime/fuse.py: S steps captured once into a
     CUDA graph, replayed a megastep), the launch counts set to 0 before
     each part and checked after: (a) on the duo, the trio and -w 80
     scanners at K = 40, fuse_ctcss=False at K = 10, dsd_in and single
     (mono and two-kernel) at K = 16, faithful mode at K = 10, the sharded
     duo at (4, 5) and the plane path with halo_dma at (4, 4), K = 40,
     and the sharded dsd at (2, 2), K = 16: multi_step at S = 4 from a
     carried state equal to 4 step() calls bit for bit, every output and
     state field, then again from the returned state, the states held
     unchanged, each kernel's launches = per-step x (steps + replays x
     S); (b) the driver at K = 40 over 10 blocks: S = 4 (two megasteps, a
     2-block tail) equal to S = 1 bit for bit with prefetch_depth 1 and
     3, and a run with a checkpoint every 4 blocks stopped after its first
     megastep and restored equal to the uninterrupted run; (c) on each
     path a megastep under set_sync_debug_mode("error") and its launches
     = per-step x S; on the duo scanner, dsd_in mono, faithful and the
     sharded duo, one replay under torch.profiler holding each device
     function S times its count in one eager step, the device-busy share
     of a megastep and its host ms; (d) on those four, Msamples/s at S =
     1, 4 and 8 in turns (median of 3 runs, 2 for the sharded duo), with
     each graph's capture ms and memory, and the graphs each chain (and
     the driver at S = 4 and 8) holds after each timed run (one more is a
     recapture).
 18. the batch server and live input: (a) apps/scan_batch.main on 8
     synthetic captures (4 cu8, 2 cs16, 2 cf32; 4 blocks of K = 40, 15.68 s
     of radio each) at --mesh 8,1, -w 80, --steps-per-dispatch 4, through
     the default reader (io/native.BatchReader): each capture's events
     equal to the unsharded ScannerChain's on the same host-decoded wire,
     its WAV within 1e-4 and its rows (read where the CLI renders them)
     within 2e-3 dB, capture 0 > 40 dB against the float64 oracle; (b)
     --device-decode on the four cu8 captures at --mesh 4,5 (the duo with
     K10's pre-pass) and 4,2 (the plane path), each against its unsharded
     counterpart; (c) --stop-after 1 at S = 2, then --resume, every output
     file equal to (a)'s byte for byte; the Msamples/s of capture at S =
     1 and 4 (the default reader, and --device-decode over 12 blocks),
     and one (8, 1) megastep profiled; (d) the sharded waterfall at (4,
     5), w = 80, 120, 78400 and at (1, 2), K = 2, w = 78400 (a window
     wider than a shard): rows equal to K3 over the shards' own bands
     and within the unsharded chain's by ROW_GATES_DB (2e-3 dB within 60
     dB of their peak, 0.5 within 80, 6 within 100), which a planted
     carry fault fails; (e) ShardedFaithfulChain against the unsharded
     faithful chain (JAX's scenario and gates at (2, 4), the busy
     scenario at (2, 2) with its audio within 1e-4 of its peak, which
     planted carry faults fail, its multi_step graph bit for bit); (f)
     the scanner CLI over a localhost
     rtl_tcp server against the oracle.  Launch counts == per part, the
     graphs each run captured reported.
 19. the op engines (engine="op", the JAX op engine's plain ops and state
     layout; no kernel but K3), each part with the launch counts set to 0
     just before it and checked == just after (none; K3 once a step under
     -w; the duo's K1 / K2 in (a)'s turns and in (g)): (a) ScannerDriver(engine="op")
     at K = 10 on phase 3's capture against the float64 oracle (decisions
     exact, audio SNR > 40 dB) and decisions equal to phase 3's duo run;
     at K = 40 cu8 (config 2) Msamples/s in turns (duo, op, op, duo) with
     decisions equal to the duo's, a step under
     set_sync_debug_mode("error"), one profiled step; (b) -w 80 on the op
     engine at K = 10, rows within 1e-2 dB of the asgramcf oracle; (c)
     dsd_in --engine op through its CLI at K = 10 (> 50 dB against the
     DsdInOracle, within 1 LSB of the CPU op run) and the single op chain
     at K = 16 on the cf32 wire (> 100 dB against the CPU op run, 1 kHz
     tone > 35 dB); (d) the sharded op scanner at (4, 5), K = 40, against 4
     unsharded op chains under JAX's sharded gates, the sharded dsd / single
     op chains at (2, 2), K = 12 (K_local = 6), against the unsharded op
     chains (PCM within 1 LSB and > 60 dB, audio > 60 dB); (e) multi_step at
     S = 4 bit for bit on each of the six op chains (17(a)'s checks; the
     sharded ones at (2, 2), K = 12), the op scanner's replay profiled and
     its Msamples/s at S = 1 and 4 over 8 blocks; (f)
     the op driver at K = 40: metrics, stop, checkpoint, restore bit-equal
     to the uninterrupted run, the kernel driver refusing the checkpoint;
     (g) apps/record.main on its default (kernel) engine: one WAV, the
     driver's audio, K1 and K2 one launch a block.
 20. AOT export (apps/export_chain.py, torch.export; K1-K4 the custom ops
     sdr_pmr446::duo / audio_bank / waterfall / mono): (a) BASELINE
     configs 2 (scanner, cu8, K = 40), 4 (the same with -w 80), 3 (dsd,
     K = 16, the cf32 wire JAX's cu8 mapping gives) and 1 (single, channel
     5, K = 16) and the op scanner at K = 40, each exported through
     export_chain.main with --device at its default and saved, then loaded
     in one fresh process (``chip_smoke.py --export-child``) that imports
     export_chain and nothing else of the package: over 4 distinct blocks
     from the live chain's state after a first block, outputs and state
     bit-equal to the live chain's, the kernels one launch a step (K1, K2;
     K3 under -w; K4; none on the op engine), no weights_only fallback of
     torch.export.load, no module of JAX, TF32 off; export time, bytes,
     load time, and Msamples/s at S = 1 in turns with the live chain
     (loaded, live, live, loaded); (b) the config 2 and op scanners at K
     = 4 exported before their first step step bit for bit as chains
     never exported; (c) the host microseconds a call through each op takes
     beside a direct call of its CUDA implementation, in turns, their
     outputs bit-equal.
 21. multi-process execution (parallel/distributed.py: gloo over
     localhost, the halos staged through the host): two rank processes of
     this script (``chip_smoke.py --dist-child``), both on cuda:0, each
     with a time limit, (a) config 5 through apps/scan_batch.main
     (--mesh 4,5, K = 40, the four cu8 captures of 18(b), --device-decode,
     --coordinator / --num-processes 2 / --process-id: a stream split, each
     rank 2 captures x 5 time shards): rank 0's WAVs byte-equal and its
     event logs equal to the one-process run's on the card, rank 1 writing
     nothing; (b) the duo at (1, 4), K = 32 and (c) the plane path with
     halo_dma at (1, 4), K = 40, split in time (each rank 1 stream x 2
     time shards: K10's fold, the halos and K11's shard 0 across the
     ranks), their outputs and state gathered by rank 0 against the
     one-process chain on the same mesh: decisions and events exact, RSSI
     and audio under JAX's sharded gates, and whether bit-equal; (d) each
     rank's launches of K1, K2, K10 (a), (b) and of K7, K8, K9, K11 (c),
     set to 0 just before and read just after, equal to the per-step
     count of its block x steps; (e) ms a block and Msamples/s of (a), (b)
     and (c) beside the one-process run's on the same card, the
     host-staged collectives a step and their share of a rank's step
     (host clock around synchronized runs, CUDA events beside): the two
     ranks time-share one card, so no scaling figure; (f) why a time split
     is bit-equal on the CPU but not on the card: the DC blockers' matmul
     scan of a rank's shards alone against the same shards in the whole
     batch, and the resampler's conv1d likewise (logged).

Each path (the scanner in phases 3-4, dsd_in in 7, single in 8, the -w
scanner in 10, the engines of 11(b), each two-kernel chain in 11(c), the
switched engines of 12(b), each sharded path of 13, the probe tools of
14, faithful mode in 15, the driver's runs in 16, each path and the
driver in 17, each scan_batch run and sharded path in 18, each op path
in 19, each export in 20, each case of 21 in each rank) runs with
the launch counts set to 0 just before it and read just after.  Each
kernel's bound is the larger of its bytes (inputs read once, outputs
written once) over 3.35 TB/s and its f32 operations over 67 TFLOP/s (the
H100 SXM's HBM3 rate and f32 rate outside the tensor cores).  The
synthetic captures and the scanner oracle's run are made once a run and
shared by the phases that read them.
The last two lines of standard output are the kernel table
``{"kernels": [...]}`` and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import functools
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
TOL_NOISE_TURNS = 1e-3         # demod of a noise-only channel: median |err|
#                                in turns (its discriminator is f32 rounding
#                                over |y|, unbounded as |y| nears 0)
TOL_PCM_LSB = 1                # dsd PCM after the int16 truncation: a value
#                                near a whole number may truncate either way
TOL_DSD_ORACLE_DB = 50.0       # dsd_in vs the float64 oracle (tests/test_dsd_in.py:33-56)
TOL_TONE_DB = 35.0             # single-channel 1 kHz tone (tests/test_misc.py:80-97)
TOL_WF_DB = 2e-3               # K3 rows vs its plain version (tests/test_scanner.py:341-378)
TOL_WF_ORACLE_DB = 1e-2        # -w rows vs the float64 oracle (tests/test_driver_apps.py:140-173)
WIDE_WF = 4096                 # K3 widths also held to the float64 oracle
PLAIN_WF = 16384               # widest K3 width held to the plain version,
#                                whose [w, 2w] table takes 4.3 GB there
PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
PEAK_F32_OPS_PER_S = 67e12     # H100 SXM f32 outside the tensor cores
PEAK_TF32_OPS_PER_S = 495e12   # H100 SXM TF32 tensor cores, dense
TOL_PROBE_REL = 1e-5           # K12b modes vs their plain versions, of the
#                                output's peak: f32 sums in another order
TOL_FAITHFUL_DB = 60.0         # faithful audio vs the oracle (tests/test_faithful.py:50-72)
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


def timed(timer, fn, inputs) -> float:
    """The median time of fn over inputs, after one warm-up call."""
    fn(*inputs[0])
    return timer(fn, inputs)


@functools.lru_cache(maxsize=None)
def occupied_band(n: int) -> np.ndarray:
    """All 16 channels carrying NBFM tones (no discriminator branch cuts
    from noise-only channels), channel 5 with CTCSS 12."""
    from sdr_pmr446_tpu_torch.io import synth
    return sum(synth.make_scanner_iq(
        n, channel=ch, amplitude=0.6 if ch == 5 else 0.2,
        tone_hz=300.0 + 97 * ch, ctcss_code=12 if ch == 5 else None,
        seed=ch) for ch in range(1, 17)) / 2.0


def random_c64(rng, dev, *shape, scale=1.0):
    import torch
    return torch.as_tensor(np.asarray(scale * (
        rng.standard_normal(shape) + 1j * rng.standard_normal(shape)),
        np.complex64), device=dev)


def random_duo_state(duo, rng, dev):
    import torch
    c = lambda *s: random_c64(rng, dev, *s)
    return (0.1 * c(), 0.01 * c(), 0.01 * c(duo.front_hist_len),
            0.1 * c(duo.pfb.hist_len),
            torch.tensor(1, dtype=torch.int32, device=dev), 0.1 * c(16))


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def bound(nbytes: float, ops: float,
          ops_per_s: float = PEAK_F32_OPS_PER_S) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over their peak rate (f32 unless given), whichever is
    larger."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def front_work(n: int, bps: int, hist: int):
    """(bytes, f32 operations) of the shared front end for n samples: the
    wire and the carried history read, the DC blocker (4 per plane and
    sample) and the 346-tap resampler (2 planes, multiply-add = 2)."""
    nb = n * 25 // 128
    nbytes = n * bps + 2 * 8 * hist + 4 * (25 * 346 + 64)
    return nbytes, 8 * n + nb * 346 * 4


def pfb_work(k: int, f: int, plane: bool = False):
    """The PFB part of K1, which is K7: per frame the 16-branch polyphase
    filterbank (416 real taps on complex samples, 4 operations a tap), the
    mixer on its 16 branch outputs (a complex product each) and one
    16-point FFT; per channel sample the discriminator (a complex product
    and an atan2) and |y|; demod [16, F] and the |y| sums [K, 16] (or the
    plane [16, F]) written, the history and the taps read."""
    nbytes = (16 * f * 4 + (16 * f * 4 if plane else k * 16 * 4)
              + 2 * 8 * 400 + 2 * 416 * 16 * 4)
    ops = f * (416 * 4 + 16 * 6 + FFT16_OPS)
    ops += f * 16 * (6 + ATAN2_OPS + 1 + ATAN2_OPS)
    return nbytes, ops


def duo_work(n: int, bps: int, k: int, f: int, hist: int):
    """K1: the front end, then the PFB part (pfb_work)."""
    nbytes, ops = front_work(n, bps, hist)
    pb, po = pfb_work(k, f)
    return nbytes + pb, ops + po


def audio_bank_work(k: int, f: int, hist: int, la: int, ll: int):
    """K2: the audio and lp FIRs over 16 channels, the lp DC blocker and
    the selected channel's 38 CTCSS sums (a sincos and a complex
    multiply-add each); demod and audio [16, F], history and sums."""
    nbytes = (2 * 16 * f * 4 + 2 * 16 * hist * 4 + 2 * k * 38 * 8
              + 4 * (la + ll))
    ops = 16 * f * ((la + ll) * 2 + 4) + k * NS * 38 * (ATAN2_OPS + 4)
    return nbytes, ops


def tail_work(tail, nb: int):
    """The tail of K4, which is K5: the single chain's mixer (a complex
    product a band sample), the 16x decimator (real taps on 2 planes), the
    discriminator and the post-FIR (96/25 upsampler, 43 taps an output, or
    the 408-tap audio FIR); the histories and taps read, the output
    written."""
    f, g = nb // 16, nb // 400
    taps = tail.decim.P
    ops = f * taps * 4 + f * (6 + ATAN2_OPS + 1)
    if tail.mode == "single":
        ops += nb * 6 + f * tail.post_taps.shape[0] * 2
        nbytes = f * 4
    else:
        ops += g * 96 * tail.post_taps.shape[1] * 2
        nbytes = g * 96 * 4
    nbytes += (2 * 8 * tail.hb * 400 + 2 * 4 * tail.dh * 25
               + 4 * (taps + tail.post_taps.numel()))
    return nbytes, ops


def mono_work(mono, n: int, bps: int):
    """K4: the front end, then the tail (tail_work)."""
    nbytes, ops = front_work(n, bps, mono.front.hist_len)
    tb, to = tail_work(mono.tail, n * 25 // 128)
    return nbytes + tb, ops + to


def resample_work(n: int):
    """K9: the input planes and the history read, the band written, the
    346-tap resampler on 2 planes (multiply-add = 2)."""
    nb = n * 25 // 128
    return 8 * n + 2 * 8 * 345 + 8 * nb + 4 * 25 * 346, nb * 346 * 4


#: the audio bank's four tap configurations, (lowpass, fir_deemph): the
#: composed audio FIR of 408, 477, 510 and 579 taps (history 512, 512,
#: 512, 640), the lp FIR of 377 in each
TAP_CONFIGS = ((False, False), (False, True), (True, False), (True, True))


def bank_state(bank, rng, k: int):
    """A random non-zero K2 state and FSM schedule on the bank's device:
    (hist, dc_x, dc_y, gain, b_arr, sel), b_arr[0] the whole sub-chunk."""
    import torch
    from sdr_pmr446_tpu_torch import config as C
    dev = bank.taps_audio.device
    f32 = dict(dtype=torch.float32, device=dev)
    hist = torch.as_tensor(0.1 * rng.standard_normal((16, bank.hist)), **f32)
    dcx = torch.as_tensor(0.01 * rng.standard_normal(16), **f32)
    dcy = torch.as_tensor(0.01 * rng.standard_normal(16), **f32)
    gain = torch.tensor(C.SDR_DEFAULT_AUDIO_GAIN, **f32)
    b_arr = torch.as_tensor(rng.integers(0, C.CTCSS_BLOCK_SIZE, k),
                            dtype=torch.int32, device=dev)
    b_arr[0] = NS - 1
    sel = torch.as_tensor(rng.integers(0, 16, k), dtype=torch.int32,
                          device=dev)
    return hist, dcx, dcy, gain, b_arr, sel


def bank_case(dev, case, rng, k: int, demod) -> float:
    """K2 in one tap configuration against its plain version on ``demod``
    from a random state: audio within TOL_AUDIO_ATOL, tone sums within
    TOL_TONE_REL of their peak, history exact, carries within
    TOL_CARRY_REL; a second call equal to the first bit for bit, and K8
    apply's and apply_dc's audio equal to K2's bit for bit (one FIR
    device function).  Returns the audio's max |err|."""
    import torch
    from sdr_pmr446_tpu_torch.kernels.audio_bank import AudioBank
    bank = AudioBank(*case, device=dev)
    hist, dcx, dcy, gain, b_arr, sel = bank_state(bank, rng, k)
    args = (hist, dcx, dcy, demod, gain, b_arr, sel, NS)
    ref = bank.plain(*args)
    got = bank.kernel(*args)
    again = bank.kernel(*args)
    k8a = bank.apply_kernel(hist, demod, gain)
    k8d = bank.apply_dc_kernel(hist, dcx, dcy, demod, gain)
    torch.cuda.synchronize(dev)
    what = (f"K2 K={k} lowpass={int(case[0])} fir_deemph={int(case[1])} "
            f"(La {bank.taps_audio.shape[0]}, H {bank.hist})")
    a_err = max_err(ref.audio, got.audio)
    tone = max(max_err(ref.raw_pre, got.raw_pre),
               max_err(ref.raw_mem, got.raw_mem)) / peak(ref.raw_mem)
    carries = {name: max_err(getattr(ref, name), getattr(got, name)) / max(
        peak(getattr(ref, name)), 1e-30) for name in ("dc_x", "dc_y")}
    log(f"  {what}: audio max|err| {a_err:.3g} (peak {peak(ref.audio):.3g}),"
        f" tone sums rel {tone:.3g}, carries rel "
        + ", ".join(f"{nm} {v:.3g}" for nm, v in carries.items()))
    check(a_err < TOL_AUDIO_ATOL, f"{what} audio")
    check(tone < TOL_TONE_REL, f"{what} tone sums")
    check(max_err(ref.hist, got.hist) == 0.0, f"{what} history")
    for name, val in carries.items():
        check(val < TOL_CARRY_REL, f"{what} carry {name}")
    check(all(torch.equal(a, b) for a, b in zip(again, got)),
          f"{what}: a second call differs from the first")
    check(torch.equal(k8a.audio, got.audio)
          and torch.equal(k8d.audio, got.audio),
          f"{what}: K8's audio differs from K2's")
    log(f"  {what}: a second call equal to the first, K8 apply's and "
        "apply_dc's audio equal to K2's, bit for bit")
    return a_err


def k8_conv(bank, hist, gain, demods):
    """K8 apply's library yardstick, never called by the port: one F.conv1d
    (cuDNN, f32, TF32 off) of [hist | demod] against the two composed FIRs,
    the gain folded into the audio row.  Returns (fn, inputs), one input a
    demod; fn(x)[:, 0] is the audio, [:, 1] the lp branch."""
    import torch
    la, ll = bank.taps_audio.shape[0], bank.taps_lp.shape[0]
    n_taps = max(la, ll)
    w = torch.zeros((2, 1, n_taps), dtype=torch.float32, device=hist.device)
    w[0, 0, n_taps - la:] = torch.flip(bank.taps_audio, [0]) * gain
    w[1, 0, n_taps - ll:] = torch.flip(bank.taps_lp, [0])
    xs = [(torch.cat([hist[:, bank.hist - (n_taps - 1):], dm], dim=-1)
           .reshape(16, 1, -1).contiguous(),) for dm in demods]
    return (lambda x: torch.nn.functional.conv1d(x, w)), xs


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
    again = duo.kernel(wires[0], *state, ns=NS)
    check(all(torch.equal(a, b) for a, b in zip(again, got)),
          "K1: a second call differs from the first")
    log("  K1: a second call equal to the first bit for bit")

    demods = [duo.plain(w, *state, ns=NS).demod for w in wires]
    a_err = max(bank_case(dev, case, rng, k, demods[0])
                for case in TAP_CONFIGS)
    bank = AudioBank(device=dev)
    hist, dcx, dcy, gain, b_arr, sel = bank_state(bank, rng, k)
    bank_in = [(hist, dcx, dcy, dm, gain, b_arr, sel, NS) for dm in demods]
    duo_in = [(w,) + state for w in wires]
    times = {
        "duo_plain": timed(timer, lambda *a: duo.plain(*a, ns=NS), duo_in),
        "duo": timed(timer, lambda *a: duo.kernel(*a, ns=NS), duo_in),
        "bank": timed(timer, bank.kernel, bank_in),
        "bank_plain": timed(timer, bank.plain, bank_in),
    }
    log(f"  times K={k} {fmt} (median of {len(wires)}, ms): " + ", ".join(
        f"{key} {val:.3f}" for key, val in times.items()))
    sync = lambda: torch.cuda.synchronize(dev)
    log(f"  device ms K={k} {fmt}: duo "
        f"{device_ms(lambda *a: duo.kernel(*a, ns=NS), duo_in, sync)}, bank "
        f"{device_ms(bank.kernel, bank_in, sync)}: "
        f"{split_str(device_split(bank.kernel, bank_in, sync))}")
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


@functools.lru_cache(maxsize=None)
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
    c = lambda *s: random_c64(rng, dev, *s)
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
        split, span, _ = device_profile(kernel, inputs,
                                        torch.cuda.synchronize)
        log(f"  K4 {mode} {fmt} K={k} times (median of {reps}, ms): kernel "
            f"{t_kernel:.3f}, plain {t_plain:.3f}, bound {b['bound_ms']:.4f} "
            f"({b['bound_by']}); device {sum(split.values()):.4f}, span "
            f"{span_str(span)}: {split_str(split)}")
        rows.append({"name": f"mono_{mode}", "route": "cuda",
                     "source": "sdr_pmr446_tpu_torch/csrc/chan_tail.cu",
                     "replaces": "sdr_pmr446_tpu/kernels/chan_tail.py:600",
                     "max_abs_err": max(errs), "ms": t_kernel,
                     "plain_ms": t_plain, **b, "library_ms": None})
    return rows


def phase_dsd_app(dev, k: int, n_blocks: int, engine: str = "kernel"):
    """dsd_in through its CLI (``--engine engine``) on the card vs the
    float64 oracle and the port's CPU run on the same engine; returns the
    blocks it ran."""
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
                           "--subchunks-per-step", str(k), "--device", device,
                           "--engine", engine])
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
    log(f"  dsd_in --engine {engine} K={k}, {n_blocks} blocks: SNR vs "
        f"oracle {snr:.1f} dB, "
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


def make_chain(mode: str, k: int, device, mono: bool = True,
               engine: str = "kernel", fmt: str = "cu8"):
    from sdr_pmr446_tpu_torch.scanner.dsd_in import DsdInChain
    from sdr_pmr446_tpu_torch.scanner.single import SingleChannelChain
    if mode == "dsd":
        return DsdInChain(k, input_format=fmt, device=device, mono=mono,
                          engine=engine)
    return SingleChannelChain(5, k, input_format=fmt, device=device,
                              mono=mono, engine=engine)


def run_chain(chain, blocks):
    import torch
    st = chain.init_state()
    outs = []
    for blk in blocks:
        st, o = chain.step(st, torch.from_numpy(blk).to(chain.device))
        outs.append(o)
    return np.concatenate([as_np(o) for o in outs])


def phase_single(dev, k: int, n_blocks: int, engine: str = "kernel",
                 fmt: str = "cu8"):
    """The single-channel chain on the card vs its CPU run, on ``engine``
    with the ``fmt`` wire; returns the blocks it ran."""
    from sdr_pmr446_tpu_torch.io import synth
    blocks = chain_blocks("single", k, n_blocks, fmt)
    got = run_chain(make_chain("single", k, dev, engine=engine, fmt=fmt),
                    blocks)
    cpu = run_chain(make_chain("single", k, "cpu", engine=engine, fmt=fmt),
                    blocks)
    snr = snr_db(cpu, got)
    tone = synth.tone_snr_db(got[4000:], 1000.0)
    log(f"  single channel 5 ({engine} engine, {fmt}), K={k}, {n_blocks} "
        f"blocks: audio SNR vs CPU "
        f"{snr:.1f} dB, 1 kHz tone SNR {tone:.1f} dB")
    check(snr > TOL_SNR_DB, "single audio SNR vs CPU")
    check(tone > TOL_TONE_DB, "single tone SNR")
    return n_blocks


def phase_chain_throughput(dev, mode: str, k: int, n_blocks: int, sync,
                           mono: bool = True):
    """Msamples/s of one chain over distinct blocks (host clock, ending in
    a synchronize; the wire upload and the output drain inside), then one
    step under set_sync_debug_mode("error").  ``mono=False``: the
    two-kernel engine.  Runs n_blocks + 2 steps."""
    import torch
    from sdr_pmr446_tpu_torch import config as C
    blocks = chain_blocks(mode, k, n_blocks + 1)
    chain = make_chain(mode, k, dev, mono)
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
    engine = "" if mono else " (two-kernel)"
    log(f"  {mode}{engine} K={k}, {n_blocks} blocks "
        f"({n_samp / C.SDR_SAMPLERATE:.2f} s of radio): {sec * 1e3:.1f} ms, "
        f"{msps:.1f} Msamples/s, {rt:.1f}x real time")
    wire = torch.from_numpy(blocks[1]).to(dev)
    sync()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st, _ = chain.step(st, wire)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sync()
    log(f"  {mode}{engine} K={k} step under set_sync_debug_mode('error'): "
        f"no host reads")
    return {"msamples_per_s": msps, "realtime_x": rt, "seconds": sec}


@functools.lru_cache(maxsize=None)
def oracle_capture(n_sub: int):
    """A synthetic cu8 capture of ``n_sub`` sub-chunks (channel 5, CTCSS
    12) and the float64 oracle's active-channel trace and audio on it."""
    from sdr_pmr446_tpu_torch import config as C
    from sdr_pmr446_tpu_torch.io import synth
    from sdr_pmr446_tpu_torch.oracle.chain import ScannerOracle
    from sdr_pmr446_tpu_torch.ops import decode
    iq = synth.make_scanner_iq(n_sub * C.SUBCHUNK_IN, channel=5, ctcss_code=12)
    raw = decode.quantize_iq(iq, "cu8")
    host_iq = ((raw.astype(np.float64) - 127.5) / 127.5).view(np.complex128)
    ora = ScannerOracle()
    ora.process(host_iq)
    return raw, np.asarray(ora.active_trace), np.stack(ora.audio)


def phase_oracle(dev, k: int, n_sub: int, **switches):
    """The driver on a synthetic cu8 capture vs the float64 oracle, on the
    engine the chain switches choose.  Returns the steps and the result."""
    from sdr_pmr446_tpu_torch.runtime.driver import ScannerDriver, wire_blocks
    raw, trace, audio = oracle_capture(n_sub)
    drv = ScannerDriver(subchunks_per_step=k, input_format="cu8", device=dev,
                        **switches)
    res = drv.run(wire_blocks(raw, "cu8", drv.feed_len))
    check(np.array_equal(res.active_trace, trace),
          f"active trace {res.active_trace} vs oracle {trace}")
    got = res.audio.reshape(-1, NS)[2:].ravel()
    want = audio[2:].ravel()
    snr = snr_db(want, got)
    log(f"  {n_sub} sub-chunks at K={k} {switches or ''}: active trace == "
        f"oracle, audio SNR {snr:.1f} dB; events: {res.events}")
    check(snr > 40.0, "audio SNR vs oracle")
    check(any(e.startswith("Tuned to channel 5") for e in res.events),
          "tune event")
    check(any(e.startswith("Acquired CTCSS code: 12") for e in res.events),
          "CTCSS event")
    return drv.block_index, res


@functools.lru_cache(maxsize=None)
def bench_block(k: int, i: int) -> np.ndarray:
    """Block ``i`` of bench_blocks."""
    from sdr_pmr446_tpu_torch import config as C
    from sdr_pmr446_tpu_torch.io import synth
    from sdr_pmr446_tpu_torch.ops import decode
    n = k * C.SUBCHUNK_IN
    p = [(5, 12), (5, 12), None, (9, 3)][i % 4]
    if p is None:
        rng = np.random.default_rng(100 + i)
        iq = 1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    else:
        iq = synth.make_scanner_iq(n, channel=p[0], ctcss_code=p[1],
                                   seed=100 + i, start_sample=i * n)
    return decode.quantize_iq(iq, "cu8")


def bench_blocks(k: int, n_blocks: int) -> list:
    """Distinct cu8 blocks: channel 5 + CTCSS 12, again with other noise,
    silence, channel 9 + CTCSS 3, ..."""
    return [bench_block(k, i) for i in range(n_blocks)]


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
SCANNER_PARTS = (("K1 duo", ("duo_", "fe_", "pfb_")),
                 ("K2 audio bank", ("ab_",)),
                 ("DC carry scan (K1 and K2)", ("dc_carry",)),
                 ("K3 waterfall", ("wf_",)),
                 ("copies", ("Memcpy", "Memset")))
#: the parts of a trio scanner step (fuse_band=False or fuse_dc=False)
TRIO_PARTS = (("K6 front end", ("fe_",)), ("K9 resampler", ("rs_",)),
              ("K7 PFB demod", ("pfb_",)), ("K2 audio bank", ("ab_",)),
              ("DC carry scan (K6 and K2)", ("dc_carry",)),
              ("copies", ("Memcpy", "Memset")))
#: the parts of a dsd_in / single step
CHAIN_PARTS = (("K4 mono chain (5 kernels)", ("fe_", "dc_carry", "tail_")),
               ("copies", ("Memcpy", "Memset")))
#: ... and of one on the two-kernel engine
TWO_KERNEL_PARTS = (("K6 front end (4 kernels)", ("fe_", "dc_carry")),
                    ("K5 chan tail (2 kernels)", ("tail_",)),
                    ("copies", ("Memcpy", "Memset")))
#: CUDA kernels a step of each part, checked in the profiled step
CHAIN_LAUNCHES = {"K4 mono chain (5 kernels)": 5}
TWO_KERNEL_LAUNCHES = {"K6 front end (4 kernels)": 4,
                       "K5 chan tail (2 kernels)": 2}


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


def phase_no_host_reads(dev, k: int, sync, waterfall: int = 0,
                        **switches):
    """One warmed-up chain step under set_sync_debug_mode("error"): the
    step (FSM and waterfall included) makes no host read, so steps queue
    without waiting for the device.  Returns the steps it ran (2)."""
    import torch
    from sdr_pmr446_tpu_torch import config as C
    from sdr_pmr446_tpu_torch.scanner.chain import (ScannerChain,
                                                    make_runtime_params)
    chain = ScannerChain(C.BlockConfig(k), input_format="cu8", device=dev,
                         waterfall=waterfall, **switches)
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
    log(f"  K={k} -w {waterfall} {switches or ''} step under "
        f"set_sync_debug_mode('error'): no host reads")
    return 2


def phase_profile(dev, k: int, sync, waterfall: int = 0,
                  parts=None, **switches):
    """One scanner K-block step under torch.profiler (profile_step), after
    a warm-up step, on the engine the chain switches choose; returns the
    steps it ran (the warm-up and profile_step's)."""
    from sdr_pmr446_tpu_torch import config as C
    from sdr_pmr446_tpu_torch.runtime.driver import ScannerDriver
    blocks = bench_blocks(k, 2)
    drv = ScannerDriver(C.ScannerArgs(waterfall=waterfall),
                        subchunks_per_step=k, input_format="cu8", device=dev,
                        **switches)
    drv.run(blocks[:1])
    sync()
    profile_step(lambda: drv.run(blocks[1:]), sync, parts or SCANNER_PARTS,
                 "other (FSM, RSSI, select)", by_kernel=True)
    return drv.block_index


def phase_profile_chain(dev, mode: str, k: int, sync, mono: bool = True):
    """One dsd_in / single K-block step, wire upload and output drain
    included, under torch.profiler (profile_step), after a warm-up step;
    returns the steps it ran."""
    import torch
    blocks = chain_blocks(mode, k, 2)
    chain = make_chain(mode, k, dev, mono)
    st, _ = chain.step(chain.init_state(),
                       torch.from_numpy(blocks[0]).to(dev))
    sync()

    def step():
        _, out = chain.step(st, torch.from_numpy(blocks[1]).to(dev))
        out.cpu()
    return 1 + profile_step(step, sync,
                            CHAIN_PARTS if mono else TWO_KERNEL_PARTS,
                            "other (int16 cast, small ops)", by_kernel=True,
                            launches=CHAIN_LAUNCHES if mono
                            else TWO_KERNEL_LAUNCHES)


def wf_work(k: int, w: int, hops: int):
    """K3: the band planes and the history read, the rows and the new
    history written; as an FFT, 5 w log2(w) operations a hop, plus the
    window (a real by complex product, 2 a sample) and |S|^2 (3 a bin)."""
    nb, wl = k * 19600, w // 2
    nbytes = 8 * nb + 2 * 8 * wl + 4 * k * w + 8
    return nbytes, hops * (5 * w * math.log2(w) + 2 * wl + 3 * w)


def stft_rows(dev, w: int, k: int, cnt: int, double: bool = False):
    """The library yardstick: torch.stft (cuFFT, f32 unless ``double``)
    over the same hops, then |S|^2 and the per-row sums.  Returns
    (inputs(hist, band) -> x, the timed call(x) -> row sums [k, w], the
    hops' row counts [k])."""
    import torch
    real = torch.float64 if double else torch.float32
    cplx = torch.complex128 if double else torch.complex64
    wl, delay, nb = w // 2, w // 4, k * 19600
    u0 = delay - cnt
    hops = (nb - u0) // delay + 1
    u = u0 + delay * torch.arange(hops, device=dev)
    row = (u - 1) // 19600
    counts = torch.bincount(row, minlength=k).float()
    win = torch.hamming_window(wl, periodic=True, dtype=torch.float64,
                               device=dev)
    win = (win / win.sum()).to(real)

    def inputs(hist, band):
        # torch.stft centres a w/2 window in each w-sample frame: frame i
        # starts w/4 before hop i's window, xe[u0 + i w/4 .. + w/2)
        xe = torch.cat([torch.zeros(delay, dtype=cplx, device=dev),
                        hist[hist.shape[0] - wl:].to(cplx),
                        torch.complex(band[0], band[1]).to(cplx),
                        torch.zeros(w, dtype=cplx, device=dev)])
        return xe[u0:u0 + (hops - 1) * delay + w].contiguous()

    def call(x):
        spec = torch.stft(x, n_fft=w, hop_length=delay, win_length=wl,
                          window=win, center=False, return_complex=True)
        p = spec.real ** 2 + spec.imag ** 2                 # [w, hops]
        return torch.zeros(k, w, dtype=real, device=dev).index_add_(
            0, row, p.T)
    return inputs, call, counts, hops


def device_ms(fn, inputs, sync) -> str:
    """Device time of one fn(*args) call, averaged over ``inputs``: the sum
    of the device events' durations in a profiled run of all of them
    (profile_session), in ms, with the events counted; a session that
    recorded no device event is made again, up to PROFILE_ATTEMPTS."""
    for _ in range(PROFILE_ATTEMPTS):
        evs, _, _, _ = profile_session(lambda: [fn(*a) for a in inputs],
                                       sync)
        if evs:
            ms = sum(e.time_range.end - e.time_range.start
                     for e in evs) / 1e3 / len(inputs)
            return f"{ms:.4f} ({len(evs)} events for {len(inputs)} calls)"
    return f"not recorded ({PROFILE_ATTEMPTS} profiler sessions)"


#: device gap (us) that separates two calls' events in device_profile:
#: a call's launches queue back to back, the wrapper's host work between
#: calls takes tens of microseconds
SPAN_GAP_US = 10.0


def device_profile(fn, inputs, sync):
    """(device ms of one fn(*args) call over ``inputs`` by CUDA kernel name
    (template arguments dropped), the median span of a call: its first
    device event's start to its last one's end, in ms, and the device
    events a call) from a profiled run of all of them.  A call's events
    are those that start within SPAN_GAP_US of the call's latest end; the
    span is None when that does not give one group a call."""
    for _ in range(PROFILE_ATTEMPTS):
        evs, _, _, _ = profile_session(lambda: [fn(*a) for a in inputs],
                                       sync)
        if evs:
            break
    by: dict = {}
    for e in evs:
        name = kernel_name(e.name).split("<")[0]
        by[name] = by.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    groups = []
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in evs):
        if groups and s - groups[-1][1] < SPAN_GAP_US:
            groups[-1][1] = max(groups[-1][1], e)
        else:
            groups.append([s, e])
    span = (statistics.median(e - s for s, e in groups) / 1e3
            if len(groups) == len(inputs) else None)
    return ({name: ms / len(inputs) for name, ms in by.items()}, span,
            len(evs) / len(inputs))


def device_split(fn, inputs, sync) -> dict:
    """Device ms of one fn(*args) call over ``inputs``, by CUDA kernel name
    (device_profile)."""
    return device_profile(fn, inputs, sync)[0]


def span_str(span) -> str:
    return "not separable" if span is None else f"{span:.4f}"


def split_str(split: dict) -> str:
    return ", ".join(f"{name} {ms:.4f}" for name, ms in sorted(
        split.items(), key=lambda kv: -kv[1])) or "no device event recorded"


def waterfall_case(dev, k: int, w: int, timer, reps: int = REPS):
    """K3 vs its plain version on K1's band of two consecutive cu8 blocks,
    from a random history (the PFB history's tail for w <= 800, else a
    carried wf_hist) and counter, each call repeated bit for bit, and from
    w = WIDE_WF both also against the float64 asgramcf oracle
    (AsgramStream) started from the same history and counter; above
    PLAIN_WF the kernel against the oracle alone.  Then the times of the
    kernel, the plain version and torch.stft on ``reps`` fresh inputs.
    Returns its row (plain_ms None above PLAIN_WF)."""
    import torch
    from sdr_pmr446_tpu_torch.kernels.duo import ScannerDuo
    from sdr_pmr446_tpu_torch.kernels.waterfall import Waterfall
    from sdr_pmr446_tpu_torch.ops import spectrogram
    rng = np.random.default_rng(w + k)
    duo = ScannerDuo("cu8", device=dev)
    t0 = time.perf_counter()
    wf = Waterfall(w, device=dev)
    torch.cuda.synchronize(dev)
    t_build = time.perf_counter() - t0
    n_tab = sum(b.numel() * b.element_size() for b in wf.buffers())
    p = wf.plan
    kind = "Bluestein" if p.filt is not None else "direct"
    split = (f"four-step {p.m1} x {p.m // p.m1}" if p.m1
             else f"{p.nt} a block")
    log(f"  K3 w={w}: Waterfall built in {t_build:.3f} s, M = {p.m} "
        f"({kind}, {split}), tables {n_tab / 1e6:.3f} MB")
    check(t_build < 1.0, f"K3 w={w}: Waterfall took {t_build:.3f} s to build")
    with_plain = w <= PLAIN_WF
    if not with_plain:
        log(f"    no plain version above w = {PLAIN_WF}: its [w, 2w] float64 "
            f"table would take {16 * w * w / 1e9:.1f} GB; the kernel is held "
            f"to the float64 oracle alone")
    wl = w // 2
    dstate = random_duo_state(duo, rng, dev)
    cnt0 = int(rng.integers(1, w // 4))
    cnt = torch.tensor(cnt0, dtype=torch.int32, device=dev)
    own = torch.as_tensor(np.asarray(0.1 * (rng.standard_normal(wl) + 1j
                                            * rng.standard_normal(wl)),
                                     np.complex64), device=dev)
    ref_h = got_h = own
    ref_c = got_c = cnt
    asg = asg32 = None
    if w >= WIDE_WF:
        from sdr_pmr446_tpu_torch.oracle.chain import AsgramStream
        asg = AsgramStream(w)
        asg.buf = own.cpu().numpy().astype(np.complex128)
        asg.counter = cnt0
    if not with_plain:
        # the oracle again with the window rounded to f32 (the plain
        # version's), to show what that rounding alone costs at this width
        asg32 = AsgramStream(w)
        asg32.win = spectrogram._window(w).astype(np.float64)
        asg32.buf, asg32.counter = asg.buf.copy(), cnt0
    errs = []
    for step, blk in enumerate(bench_blocks(k, 2)):
        d = duo.kernel(torch.as_tensor(blk, device=dev), *dstate, ns=NS)
        hist_r, hist_g = ((dstate[3], dstate[3]) if wl <= 400
                          else (ref_h, got_h))
        g = wf.kernel(d.band, hist_g, got_c)
        again = wf.kernel(d.band, hist_g, got_c)
        r = wf.plain(d.band, hist_r, ref_c) if with_plain else g
        torch.cuda.synchronize(dev)
        check(all(torch.equal(a, b) for a, b in zip(again, g)),
              f"K3 w={w} K={k}: a second call differs")
        errs.append(max_err(r.rows, g.rows))
        h_rel = max_err(r.hist, g.hist) / max(peak(r.hist), 1e-30)
        log(f"  K3 w={w} K={k} block {step}: rows max|err| {errs[-1]:.3g} dB, "
            f"hist rel {h_rel:.3g}, cnt {int(r.cnt)} / {int(g.cnt)}; a "
            f"second call bit-equal")
        if asg is not None:
            band = as_np(d.band).astype(np.float64)
            band = band[0] + 1j * band[1]
            sub = band.shape[0] // k
            rows, rows32 = [], []
            for i in range(k):
                asg.write(band[i * sub:(i + 1) * sub])
                rows.append(asg.execute())
                if asg32 is not None:
                    asg32.write(band[i * sub:(i + 1) * sub])
                    rows32.append(asg32.execute())
            if rows32:
                log(f"    an f32-rounded window alone moves the oracle's rows "
                    f"by {np.max(np.abs(np.stack(rows32) - np.stack(rows))):.3g}"
                    f" dB (rows from {np.min(rows):.1f} to {np.max(rows):.1f}"
                    f" dB)")
            o_k = float(np.max(np.abs(as_np(g.rows) - np.stack(rows))))
            o_p = float(np.max(np.abs(as_np(r.rows) - np.stack(rows))))
            log(f"    vs the float64 asgramcf oracle: kernel {o_k:.3g} dB, "
                f"plain {o_p:.3g} dB" if with_plain else
                f"    vs the float64 asgramcf oracle: kernel {o_k:.3g} dB; "
                f"its counter {asg.counter}")
            check(asg.counter == int(g.cnt), f"K3 w={w} counter vs the oracle")
            check(max(o_k, o_p) < TOL_WF_ORACLE_DB,
                  f"K3 w={w} K={k} rows vs the oracle")
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
    t_kernel = timer(wf.kernel, inputs)
    t_plain = None
    if with_plain:
        wf.plain(*inputs[0])
        t_plain = timer(wf.plain, inputs)
    prep, call, counts, hops = stft_rows(dev, w, k, cnt0)
    xs = [(prep(hist, b),) for b in bands]
    lib_sums = call(*xs[0])
    t_lib = timer(call, xs)
    lib_rows = spectrogram.rows_from_psd_sums(lib_sums, w, counts=counts)
    lib_err = max_err(lib_rows, wf.kernel(*inputs[0]).rows)
    if not with_plain:
        # one hop a row at K = 2: the f32 transform moves the deepest bins
        # (136 dB below the peak) by more than the gate; hold the f64 call
        # to it instead
        log(f"    f32 torch.stft rows within {lib_err:.3g} dB of the kernel's")
        prep64, call64, _, _ = stft_rows(dev, w, k, cnt0, double=True)
        lib_rows = spectrogram.rows_from_psd_sums(
            call64(prep64(hist, bands[0])), w, counts=counts)
        lib_err = max_err(lib_rows, wf.kernel(*inputs[0]).rows)
    check(lib_err < TOL_WF_ORACLE_DB, f"K3 w={w}: torch.stft rows differ "
          f"by {lib_err:.3g} dB")
    b = bound(*wf_work(k, w, hops))
    sync = lambda: torch.cuda.synchronize(dev)
    log(f"  K3 w={w} K={k} device time a call (torch.profiler, ms): kernel "
        f"{device_ms(wf.kernel, inputs, sync)}, torch.stft "
        f"{device_ms(call, xs, sync)}")
    plain = f"{t_plain:.4f}" if with_plain else "not run"
    log(f"  K3 w={w} K={k} ({hops} hops) times (median of {reps}, ms): "
        f"kernel {t_kernel:.4f}, plain {plain}, torch.stft "
        f"{t_lib:.4f}, bound {b['bound_ms']:.5f} ({b['bound_by']}); "
        f"torch.stft{'' if with_plain else ' (f64)'} rows within "
        f"{lib_err:.3g} dB of the kernel's")
    return {"name": f"waterfall_w{w}_k{k}", "route": "cuda",
            "source": "sdr_pmr446_tpu_torch/csrc/waterfall.cu",
            "replaces": "sdr_pmr446_tpu/kernels/duo.py:101",
            "max_abs_err": max(errs), "ms": t_kernel, "plain_ms": t_plain,
            **b, "library_ms": t_lib}


def phase_waterfall_oracle(dev, k: int, n_sub: int, w: int, **switches):
    """The driver with -w on a synthetic cu8 capture, on the engine the
    chain switches choose: every row within 1e-2 dB of the float64
    asgramcf oracle fed the oracle's band, the decisions equal to the same
    run with the waterfall off, and K3 launched once a step of the -w
    run."""
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
    off = ScannerDriver(subchunks_per_step=k, input_format="cu8", device=dev,
                        **switches)
    ref = off.run(wire_blocks(raw, "cu8", off.feed_len))
    before = waterfall.LAUNCHES
    drv = ScannerDriver(C.ScannerArgs(waterfall=w), subchunks_per_step=k,
                        input_format="cu8", device=dev, **switches)
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
    log(f"  -w {w} {switches or ''}, {n_sub} sub-chunks at K={k} "
        f"({drv.block_index} steps, "
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


def rel(ref, got) -> float:
    return max_err(ref, got) / max(peak(ref), 1e-30)


def front_end_case(dev, fmt: str, k: int, timer, reps: int = REPS):
    """K6 vs its plain version over two consecutive blocks from a random
    state, then its times on ``reps`` fresh inputs.  Returns its row and
    the band planes of those inputs (K7's)."""
    import torch
    from sdr_pmr446_tpu_torch import config as C
    from sdr_pmr446_tpu_torch.kernels.front_end import FrontEnd
    from sdr_pmr446_tpu_torch.ops import decode
    rng = np.random.default_rng(k)
    fe = FrontEnd(fmt, device=dev)
    n = k * C.SUBCHUNK_IN
    band = occupied_band(n)
    wires = [torch.as_tensor(decode.quantize_iq(band * np.exp(0.37j * s), fmt),
                             device=dev) for s in range(reps)]
    state = (random_c64(rng, dev, scale=0.1), random_c64(rng, dev, scale=0.01),
             random_c64(rng, dev, fe.hist_len, scale=0.01))
    ref = got = state
    snrs, errs = [], []
    for step in range(2):
        r = fe.plain(wires[step], *ref)
        g = fe.kernel(wires[step], *got)
        torch.cuda.synchronize(dev)
        snrs.append(snr_db(as_np(r.band), as_np(g.band)))
        errs.append(max_err(r.band, g.band))
        carries = {name: rel(getattr(r, name), getattr(g, name))
                   for name in ("dc_y", "front_hist")}
        log(f"  K6 {fmt} K={k} block {step}: band SNR {snrs[-1]:.1f} dB, "
            f"max|err| {errs[-1]:.3g}; carries rel " + ", ".join(
                f"{key} {val:.3g}" for key, val in carries.items()))
        check(snrs[-1] > TOL_SNR_DB, f"K6 {fmt} K={k} band SNR")
        check(max_err(r.dc_x, g.dc_x) == 0.0, f"K6 {fmt} dc_x")
        for name, val in carries.items():
            check(val < TOL_CARRY_REL, f"K6 {fmt} carry {name}")
        ref, got = r[:3], g[:3]
    inputs = [(w,) + state for w in wires]
    t_kernel = timed(timer, fe.kernel, inputs)
    t_plain = timed(timer, fe.plain, inputs)
    nbytes, ops = front_work(n, decode.BYTES_PER_SAMPLE[fmt], fe.hist_len)
    b = bound(nbytes + 8 * (n * 25 // 128), ops)
    log(f"  K6 {fmt} K={k} times (median of {reps}, ms): kernel "
        f"{t_kernel:.4f}, plain {t_plain:.4f}, bound {b['bound_ms']:.5f} "
        f"({b['bound_by']}); device "
        f"{device_ms(fe.kernel, inputs, lambda: torch.cuda.synchronize(dev))}")
    bands = [fe.kernel(*a).band for a in inputs]
    return {"name": "front_end", "route": "cuda",
            "source": "sdr_pmr446_tpu_torch/csrc/front_end.cu",
            "replaces": "sdr_pmr446_tpu/kernels/front_end.py:822",
            "max_abs_err": max(errs), "ms": t_kernel, "plain_ms": t_plain,
            **b, "library_ms": None}, bands


def pfb_case(dev, bands, k: int, mag: str, timer):
    """K7 vs its plain version over two consecutive bands (K6's) from a
    random state, then its times on every band.  Returns its row."""
    import torch
    from sdr_pmr446_tpu_torch.kernels.pfb_demod import PfbDemod
    rng = np.random.default_rng(k + 1)
    pd = PfbDemod(device=dev)
    state = (random_c64(rng, dev, 400, scale=0.1),
             torch.tensor(1, dtype=torch.int32, device=dev),
             random_c64(rng, dev, 16, scale=0.1))
    ref = got = state
    errs = []
    for step in range(2):
        r = pd.plain(bands[step], *ref, ns=NS, mag=mag)
        g = pd.kernel(bands[step], *got, ns=NS, mag=mag)
        torch.cuda.synchronize(dev)
        d_snr = snr_db(as_np(r.demod), as_np(g.demod))
        m_rel = rel(r.mag, g.mag)
        errs.append(max_err(r.demod, g.demod))
        carries = {name: rel(getattr(r, name), getattr(g, name))
                   for name in ("pfb_hist", "prev")}
        log(f"  K7 mag={mag} K={k} block {step}: demod SNR {d_snr:.1f} dB, "
            f"max|err| {errs[-1]:.3g}, |y| rel {m_rel:.3g}; carries rel "
            + ", ".join(f"{key} {val:.3g}" for key, val in carries.items()))
        check(d_snr > TOL_SNR_DB, f"K7 {mag} K={k} demod SNR")
        check(m_rel < TOL_MAG_RTOL, f"K7 {mag} K={k} |y|")
        check(int(r.parity) == int(g.parity), "K7 parity")
        for name, val in carries.items():
            check(val < TOL_CARRY_REL, f"K7 carry {name}")
        ref, got = r[2:], g[2:]
    inputs = [(b,) + state for b in bands]
    t_kernel = timed(timer, lambda *a: pd.kernel(*a, ns=NS, mag=mag), inputs)
    t_plain = timed(timer, lambda *a: pd.plain(*a, ns=NS, mag=mag), inputs)
    f = bands[0].shape[1] // 16
    b = bound(*[x + y for x, y in zip(pfb_work(k, f, plane=mag == "plane"),
                                      (8 * bands[0].shape[1], 0))])
    dev_k = device_ms(lambda *a: pd.kernel(*a, ns=NS, mag=mag), inputs,
                      lambda: torch.cuda.synchronize(dev))
    log(f"  K7 mag={mag} K={k} times (median of {len(inputs)}, ms): kernel "
        f"{t_kernel:.4f}, plain {t_plain:.4f}, bound {b['bound_ms']:.5f} "
        f"({b['bound_by']}); device {dev_k}")
    return {"name": "pfb_demod", "route": "cuda",
            "source": "sdr_pmr446_tpu_torch/csrc/pfb_demod.cu",
            "replaces": "sdr_pmr446_tpu/kernels/pfb_demod.py:674",
            "max_abs_err": max(errs), "ms": t_kernel, "plain_ms": t_plain,
            **b, "library_ms": None}


def resample_case(dev, k: int, timer, reps: int = REPS):
    """K9 vs its plain version over two consecutive blocks of DC-blocked
    planes from a random history, then its times, its plain version's and
    F.conv1d's (the plain version's one library call, alone) on ``reps``
    fresh inputs.  Returns its row."""
    import torch
    from sdr_pmr446_tpu_torch import config as C
    from sdr_pmr446_tpu_torch.kernels.resample_kernel import Resampler
    from sdr_pmr446_tpu_torch.ops import decode, iir
    rng = np.random.default_rng(k + 2)
    rs = Resampler(device=dev)
    n = k * C.SUBCHUNK_IN
    band = occupied_band(n)
    planes = []
    for s_ in range(reps):
        x = torch.as_tensor(decode.quantize_iq(band * np.exp(0.37j * s_),
                                               "cf32"), device=dev)
        xr, xi = decode.decode_planes(x, "cf32")
        z = torch.zeros(2, device=dev)
        planes.append(iir.dc_blocker_apply((z, z), torch.stack([xr, xi]),
                                           C.DC_BLOCK_ALPHA)[1])
    hist = random_c64(rng, dev, rs.hist_len, scale=0.1)
    ref_h = got_h = hist
    errs = []
    for step in range(2):
        rh, rb = rs.plain(ref_h, planes[step][0], planes[step][1])
        gh, gb = rs.kernel(got_h, planes[step][0], planes[step][1])
        torch.cuda.synchronize(dev)
        snr = snr_db(as_np(rb), as_np(gb))
        errs.append(max_err(rb, gb))
        log(f"  K9 K={k} block {step}: band SNR {snr:.1f} dB, max|err| "
            f"{errs[-1]:.3g}, history max|err| {max_err(rh, gh):.3g}")
        check(snr > TOL_SNR_DB, f"K9 K={k} band SNR")
        check(max_err(rh, gh) == 0.0, f"K9 K={k} history")
        check(torch.equal(rs.kernel(got_h, planes[step][0],
                                    planes[step][1])[1], gb),
              f"K9 K={k}: a second call differs from the first")
        ref_h, got_h = rh, gh
    inputs = [(hist, p[0], p[1]) for p in planes]
    t_kernel = timed(timer, rs.kernel, inputs)
    t_plain = timed(timer, rs.plain, inputs)
    op = rs.op
    need = (n // op.M - 1) * op.M + op.W
    lhs = [(torch.cat([torch.view_as_real(hist).T, p], dim=-1)[:, :need]
            .reshape(2, 1, need).contiguous(),) for p in planes]
    conv = lambda x: torch.nn.functional.conv1d(x, op.weight, stride=op.M)
    t_lib = timed(timer, conv, lhs)
    lib_err = max_err(conv(*lhs[0]).transpose(1, 2).reshape(2, -1),
                      rs.kernel(*inputs[0])[1])
    check(lib_err < 1e-3 * peak(rs.plain(*inputs[0])[1]),
          f"K9: F.conv1d differs by {lib_err:.3g}")
    b = bound(*resample_work(n))
    sync = lambda: torch.cuda.synchronize(dev)
    log(f"  K9 K={k} times (median of {reps}, ms): kernel {t_kernel:.4f}, "
        f"plain {t_plain:.4f}, F.conv1d {t_lib:.4f}, bound "
        f"{b['bound_ms']:.5f} ({b['bound_by']}); F.conv1d within "
        f"{lib_err:.3g} of the kernel; a second call equal bit for bit")
    log(f"  K9 K={k} device ms: kernel {device_ms(rs.kernel, inputs, sync)}, "
        f"F.conv1d {device_ms(conv, lhs, sync)}")
    return {"name": "resampler", "route": "cuda",
            "source": "sdr_pmr446_tpu_torch/csrc/resample_kernel.cu",
            "replaces": "sdr_pmr446_tpu/kernels/resample_kernel.py:88",
            "max_abs_err": max(errs), "ms": t_kernel, "plain_ms": t_plain,
            **b, "library_ms": t_lib}


def chan_tail_case(dev, fmt: str, k: int, timer, reps: int = REPS):
    """K5 vs its plain version in both modes on K6's band of two
    consecutive blocks, from a random state (single: mixer phase 7); then
    its times on ``reps`` fresh bands.  Returns the two K5 rows."""
    import torch
    from sdr_pmr446_tpu_torch import config as C
    from sdr_pmr446_tpu_torch.kernels.chan_tail import MonoChain
    from sdr_pmr446_tpu_torch.ops import decode
    n = k * C.SUBCHUNK_IN
    rows = []
    for mode in ("dsd", "single"):
        mono = MonoChain(mode, fmt, channel=5,
                         audio_gain=C.SDR_DEFAULT_AUDIO_GAIN, device=dev)
        tail = mono.tail
        rng = np.random.default_rng(k)
        st, n0 = random_mono_state(mono, rng, dev)
        fe_st, ref, got, n0_ref, n0_got = st[:3], st[3:], st[3:], n0, n0
        errs = []
        for step in range(2):
            wire = torch.as_tensor(decode.quantize_iq(
                mono_signal(mode, n, step), fmt), device=dev)
            fe = mono.front.kernel(wire, *fe_st)
            r = tail.plain(fe.band, *ref, n0=n0_ref)
            g = tail.kernel(fe.band, *got, n0=n0_got)
            torch.cuda.synchronize(dev)
            errs.append(max_err(r.out, g.out))
            if mode == "dsd":
                lsb = int((g.out.to(torch.int16).int()
                           - r.out.to(torch.int16).int()).abs().max())
                what = f"PCM max {lsb} LSB"
                check(lsb <= TOL_PCM_LSB, f"K5 dsd {fmt} K={k} PCM")
            else:
                snr = snr_db(as_np(r.out), as_np(g.out))
                what = f"audio SNR {snr:.1f} dB"
                check(snr > TOL_SNR_DB, f"K5 single {fmt} K={k} audio SNR")
                check(int(r.n0) == int(g.n0), "K5 mixer phase")
            carries = [rel(getattr(r, name), getattr(g, name))
                       for name in ("band_hist", "sig_prev", "demod_hist")]
            check(max(carries) < TOL_CARRY_REL, f"K5 {mode} carries")
            log(f"  K5 {mode} {fmt} K={k} block {step}: {what}, max|err| "
                f"{errs[-1]:.3g}; carries rel <= {max(carries):.3g}")
            fe_st, ref, n0_ref, got, n0_got = fe[:3], r[:3], r.n0, g[:3], g.n0
        base = mono_signal(mode, n, 0)
        bands = [mono.front.kernel(torch.as_tensor(decode.quantize_iq(
            base * np.exp(0.37j * s_), fmt), device=dev), *st[:3]).band
            for s_ in range(reps)]
        inputs = [(b_,) + tuple(st[3:]) for b_ in bands]
        kernel = lambda *a: tail.kernel(*a, n0=n0)
        t_kernel = timed(timer, kernel, inputs)
        t_plain = timed(timer, lambda *a: tail.plain(*a, n0=n0), inputs)
        conv, xs = tail_conv(tail, st[3:], n0, bands)
        t_lib = timed(timer, conv, xs)
        nb = n * 25 // 128
        tb, to = tail_work(tail, nb)
        b = bound(tb + 8 * nb, to)
        split, span, _ = device_profile(kernel, inputs,
                                        torch.cuda.synchronize)
        lib_split = device_split(conv, xs, torch.cuda.synchronize)
        what = "decimator" if mode == "dsd" else "audio FIR"
        log(f"  K5 {mode} {fmt} K={k} times (median of {reps}, ms): kernel "
            f"{t_kernel:.4f}, plain {t_plain:.4f}, F.conv1d ({what}) "
            f"{t_lib:.4f}, bound {b['bound_ms']:.5f} ({b['bound_by']}); "
            f"device {sum(split.values()):.4f}, span {span_str(span)}: "
            f"{split_str(split)}; F.conv1d device "
            f"{sum(lib_split.values()):.4f}")
        rows.append({"name": f"chan_tail_{mode}", "route": "cuda",
                     "source": "sdr_pmr446_tpu_torch/csrc/chan_tail.cu",
                     "replaces": "sdr_pmr446_tpu/kernels/chan_tail.py:308",
                     "max_abs_err": max(errs), "ms": t_kernel,
                     "plain_ms": t_plain, **b, "library_ms": t_lib})
    return rows


def tail_demod(tail, band, band_hist, sig_prev, n0):
    """The demod [F] that K5's plain version computes on the way (its
    steps 1-3: the mixer for single, the decimator, the discriminator)."""
    import torch
    from sdr_pmr446_tpu_torch.kernels.chan_tail import PHASE_PERIOD
    from sdr_pmr446_tpu_torch.ops import fm
    hb, nb = band_hist.shape[0], band.shape[1]
    be = torch.cat([torch.view_as_real(band_hist).T, band], dim=-1)
    if tail.mode == "single":
        i = torch.arange(-hb, nb, device=be.device)
        be = torch.view_as_real(torch.complex(be[0], be[1]) * tail.tab[
            torch.remainder(i + n0, PHASE_PERIOD)]).T
    _, y = tail.decim(be[:, :hb], be[:, hb:])
    return fm.fm_demod(sig_prev, torch.complex(y[0], y[1]))[1]


def tail_conv(tail, state, n0, bands):
    """K5's library yardstick, never called by the port: one F.conv1d
    (cuDNN, f32, TF32 off) for its heaviest filter.  dsd: the 477-tap
    decimator, stride 16, on the two band planes (with the band history);
    single: the 408-tap audio FIR on [demod_hist | demod], the demod of
    each band as the plain version makes it.  ``state`` is (band_hist,
    sig_prev, demod_hist).  Returns (fn, inputs), one input a band."""
    import torch
    conv = torch.nn.functional.conv1d
    band_hist, sig_prev, demod_hist = state
    if tail.mode == "dsd":
        dec, hb = tail.decim, band_hist.shape[0]
        xs = []
        for band in bands:
            need = (band.shape[1] // dec.M - 1) * dec.M + dec.W
            be = torch.cat([torch.view_as_real(band_hist).T, band], dim=-1)
            xs.append((be[:, hb - dec.hist_len:][:, :need]
                       .reshape(2, 1, need).contiguous(),))
        return (lambda x, w=dec.weight, m=dec.M: conv(x, w, stride=m)), xs
    w = torch.flip(tail.post_taps, [0]).reshape(1, 1, -1)
    nt = w.shape[-1]
    xs = []
    for band in bands:
        dem = tail_demod(tail, band, band_hist, sig_prev, n0)
        de = torch.cat([demod_hist, dem])
        xs.append((de[de.shape[0] - dem.shape[0] - (nt - 1):]
                   .reshape(1, 1, -1).contiguous(),))
    return (lambda x: conv(x, w)), xs


def phase_new_kernels(dev, timer):
    """Phase 11(a): K6, K7, K9 and K5 against their plain versions on the
    card, with their times; returns their rows (K6 and K7 at K = 40 cu8,
    K9 at K = 40, K5 at K = 16 cu8)."""
    fe_row, bands = front_end_case(dev, "cu8", 40, timer)
    _, bands10 = front_end_case(dev, "cs16", 10, timer)
    pfb_row = pfb_case(dev, bands, 40, "sums", timer)
    pfb_case(dev, bands10, 10, "sums", timer)
    pfb_case(dev, bands10, 10, "plane", timer)
    rs_row = resample_case(dev, 40, timer)
    resample_case(dev, 10, timer)
    tail_rows = chan_tail_case(dev, "cu8", 16, timer)
    chan_tail_case(dev, "cs16", 15, timer)
    return [fe_row, pfb_row, rs_row] + tail_rows


#: the scanner's engines, by their chain switches
ENGINES = {"duo": {}, "trio": {"fuse_band": False},
           "fuse_dc_off": {"fuse_dc": False}}


def phase_engines_bench(dev, k: int, n_blocks: int, sync, engines: dict,
                        order: tuple):
    """Scanner engines (``engines``: name -> chain switches) through
    ScannerDriver over the same distinct blocks, one warm-up block each,
    then in the turns ``order``.  Returns the steps of each engine, each
    one's last result and the throughputs."""
    from sdr_pmr446_tpu_torch import config as C
    from sdr_pmr446_tpu_torch.runtime.driver import ScannerDriver
    blocks = bench_blocks(k, n_blocks)
    steps = {e: 0 for e in engines}
    for name, sw in engines.items():
        warm = ScannerDriver(subchunks_per_step=k, input_format="cu8",
                             device=dev, **sw)
        warm.run(blocks[:1])
        steps[name] += warm.block_index
    sync()
    n_samp = n_blocks * k * C.SUBCHUNK_IN
    out, results = {e: [] for e in engines}, {}
    for name in order:
        drv = ScannerDriver(subchunks_per_step=k, input_format="cu8",
                            device=dev, **engines[name])
        t0 = time.perf_counter()
        results[name] = drv.run(blocks)
        sync()
        sec = time.perf_counter() - t0
        out[name].append(n_samp / sec / 1e6)
        steps[name] += drv.block_index
        log(f"  K={k} {name}, {n_blocks} blocks: {sec * 1e3:.1f} ms, "
            f"{out[name][-1]:.1f} Msamples/s, "
            f"{n_samp / C.SDR_SAMPLERATE / sec:.1f}x real time")
    return steps, results, {f"scanner_{e}": {"msamples_per_s": v}
                            for e, v in out.items()}


def check_decisions(got, ref, what: str) -> None:
    """Decisions and events of one driver run equal another's."""
    for field in ("active_trace", "ct_detected"):
        check(np.array_equal(getattr(got, field), getattr(ref, field)),
              f"{what} {field}")
    check(got.events == ref.events, f"{what} events")


def phase_trio(dev, oracle_run, sync):
    """Phase 11(b): the trio (fuse_band=False) and fuse_dc=False scanners
    against the oracle at K = 10 (decisions also equal to phase 3's duo
    run), at K = 40 in turns with the duo, one step each with host reads
    made errors, one profiled trio step.  Returns the steps of each engine
    and the throughputs."""
    steps = {e: 0 for e in ENGINES}
    k = 40
    for name in ("trio", "fuse_dc_off"):
        n, res = phase_oracle(dev, 10, 30, **ENGINES[name])
        steps[name] += n
        check_decisions(res, oracle_run, f"{name} vs the duo at K = 10")
    bench_steps, results, bench = phase_engines_bench(
        dev, k, 4, sync, ENGINES,
        ("duo", "trio", "fuse_dc_off", "fuse_dc_off", "trio", "duo"))
    for name in ENGINES:
        steps[name] += bench_steps[name]
    for name in ("trio", "fuse_dc_off"):
        check_decisions(results[name], results["duo"], f"{name} vs the duo")
        got, ref = results[name], results["duo"]
        diff = float(np.max(np.abs(got.audio - ref.audio)))
        # blocks 0-1 carry channel 5 (after two settling sub-chunks); the
        # rest is the hang through the silent block, demodulated noise
        sig = (ref.audio_subchunks >= 2) & (ref.audio_subchunks < 2 * k)
        snr = snr_db(ref.audio.reshape(-1, NS)[sig],
                     got.audio.reshape(-1, NS)[sig])
        log(f"  {name}: decisions and events == the duo's; audio max|diff| "
            f"{diff:.3g}, on channel 5's blocks SNR {snr:.1f} dB")
        if name == "trio":
            # K6 and K7 run K1's device code: the trio/duo gate
            check(diff < 1e-4, "trio audio vs the duo")
        else:
            # an f32 DC blocker (plain ops, as JAX's XLA one) against K1's
            # double scan: noise demodulated in the hang may take other
            # atan2 branches, the signal stays within the oracle gate
            check(snr > 40.0, "fuse_dc_off audio vs the duo")
    for name in ("trio", "fuse_dc_off"):
        steps[name] += phase_no_host_reads(dev, k, sync, **ENGINES[name])
    steps["trio"] += phase_profile(dev, k, sync, parts=TRIO_PARTS,
                                   **ENGINES["trio"])
    return steps, bench


def k8_work(f: int, hist: int, la: int, ll: int, dc: bool):
    """K8: the audio and lp FIRs over 16 channels (multiply-add = 2), with
    ``dc`` the lp DC blocker (4 a sample); demod read, audio and lp (or
    lp_dcb) written, the history read and written, the taps, the carries."""
    nbytes = 3 * 16 * f * 4 + 2 * 16 * hist * 4 + 4 * (la + ll)
    if dc:
        nbytes += 4 * 16 * 4
    return nbytes, 16 * f * ((la + ll) * 2 + (4 if dc else 0))


def k8_case(dev, k: int, timer, reps: int = REPS):
    """K8 apply and apply_dc vs their plain versions in each tap
    configuration over two consecutive calls from a random non-zero state,
    on the demod of K6 -> K7 of two consecutive bench blocks; each call
    repeated bit for bit, and K8's audio equal bit for bit to K2's on the
    same input (one FIR device function); then, in the default
    configuration, the times of each kernel, its plain version and, for
    apply, F.conv1d (k8_conv), by event and on the device by CUDA kernel,
    on ``reps`` fresh inputs.  Returns the two K8 rows."""
    import torch
    from sdr_pmr446_tpu_torch.kernels.audio_bank import AudioBank
    from sdr_pmr446_tpu_torch.kernels.front_end import FrontEnd
    from sdr_pmr446_tpu_torch.kernels.pfb_demod import PfbDemod
    rng = np.random.default_rng(k + 3)
    fe, pd = FrontEnd("cu8", device=dev), PfbDemod(device=dev)
    fst = (random_c64(rng, dev, scale=0.1), random_c64(rng, dev, scale=0.01),
           random_c64(rng, dev, fe.hist_len, scale=0.01))
    pst = (random_c64(rng, dev, 400, scale=0.1),
           torch.tensor(1, dtype=torch.int32, device=dev),
           random_c64(rng, dev, 16, scale=0.1))
    demods = []
    for blk in bench_blocks(k, 2):
        fo = fe.kernel(torch.as_tensor(blk, device=dev), *fst)
        po = pd.kernel(fo.band, *pst, ns=NS)
        demods.append(po.demod)
        fst, pst = fo[:3], po[2:]
    errs = {"apply": [], "apply_dc": []}
    for case in TAP_CONFIGS:
        bank = AudioBank(*case, device=dev)
        what = (f"K8 K={k} lowpass={int(case[0])} fir_deemph={int(case[1])}")
        hist, dcx, dcy, gain, _, _ = bank_state(bank, rng, k)
        b_arr = torch.full((k,), NS - 1, dtype=torch.int32, device=dev)
        sel = torch.zeros(k, dtype=torch.int32, device=dev)
        ref_a = got_a = hist
        ref_d = got_d = (hist, dcx, dcy)
        for step, dm in enumerate(demods):
            ra = bank.apply_plain(ref_a, dm, gain)
            ga = bank.apply_kernel(got_a, dm, gain)
            rd = bank.apply_dc_plain(*ref_d, dm, gain)
            gd = bank.apply_dc_kernel(*got_d, dm, gain)
            again = (bank.apply_kernel(got_a, dm, gain),
                     bank.apply_dc_kernel(*got_d, dm, gain))
            k2 = bank.kernel(*got_d, dm, gain, b_arr, sel, NS)
            torch.cuda.synchronize(dev)
            # the bench block's noise channels demodulate to +-1 and their
            # audio peaks near 6, where f32 rounding of the ~600-tap sums
            # alone reaches 7e-6 against float64: the audio gate scales with
            # the peak
            a_tol = TOL_AUDIO_ATOL * max(1.0, peak(ra.audio))
            res = {name: (r, g, plane, max_err(r.audio, g.audio),
                          rel(getattr(r, plane), getattr(g, plane)))
                   for name, r, g, plane in (("apply", ra, ga, "lp"),
                                             ("apply_dc", rd, gd, "lp_dcb"))}
            carries = {nm: rel(getattr(rd, nm), getattr(gd, nm))
                       for nm in ("dc_x", "dc_y")}
            log(f"  {what} block {step}: "
                + "; ".join(f"{name} audio max|err| {a_err:.3g}, {plane} rel "
                            f"{p_rel:.3g}" for name, (_, _, plane, a_err,
                                                      p_rel) in res.items())
                + f" (audio peak {peak(ra.audio):.3g}, gate {a_tol:.3g}); "
                "carries rel "
                + ", ".join(f"{nm} {val:.3g}" for nm, val in carries.items()))
            for (name, (r, g, plane, a_err, p_rel)), g2 in zip(res.items(),
                                                                again):
                errs[name].append(a_err)
                check(max_err(r.hist, g.hist) == 0.0,
                      f"{what} {name} history")
                check(a_err < a_tol, f"{what} {name} audio")
                check(p_rel < TOL_CARRY_REL, f"{what} {name} {plane}")
                check(all(torch.equal(x, y) for x, y in zip(g2, g)),
                      f"{what} {name}: a second call differs from the first")
                check(torch.equal(g.audio, k2.audio),
                      f"{what} {name} audio vs K2's")
            for nm, val in carries.items():
                check(val < TOL_CARRY_REL, f"{what} apply_dc carry {nm}")
            log(f"  {what} block {step}: within the gates; a second call "
                "equal to the first and audio == K2's, bit for bit")
            ref_a, got_a, ref_d, got_d = ra.hist, ga.hist, rd[:3], gd[:3]
    bank = AudioBank(device=dev)
    hist, dcx, dcy, gain, _, _ = bank_state(bank, rng, k)
    dms = [torch.roll(demods[0], 97 * s_, dims=1).contiguous()
           for s_ in range(reps)]
    ins_a = [(hist, dm, gain) for dm in dms]
    ins_d = [(hist, dcx, dcy, dm, gain) for dm in dms]
    t = {"apply": timed(timer, bank.apply_kernel, ins_a),
         "apply_plain": timed(timer, bank.apply_plain, ins_a),
         "apply_dc": timed(timer, bank.apply_dc_kernel, ins_d),
         "apply_dc_plain": timed(timer, bank.apply_dc_plain, ins_d)}
    conv, xs = k8_conv(bank, hist, gain, dms)
    t_lib = timed(timer, conv, xs)
    lib, ga = conv(*xs[0]), bank.apply_kernel(*ins_a[0])
    lib_err = max(rel(ga.audio, lib[:, 0]), rel(ga.lp, lib[:, 1]))
    check(lib_err < 1e-4, f"K8: F.conv1d differs by {lib_err:.3g} of the peak")
    la, ll = bank.taps_audio.shape[0], bank.taps_lp.shape[0]
    f = k * NS
    b_a = bound(*k8_work(f, bank.hist, la, ll, dc=False))
    b_d = bound(*k8_work(f, bank.hist, la, ll, dc=True))
    log(f"  K8 K={k} times (median of {reps}, ms): apply {t['apply']:.4f}, "
        f"plain {t['apply_plain']:.4f}, F.conv1d {t_lib:.4f}, bound "
        f"{b_a['bound_ms']:.5f} ({b_a['bound_by']}); apply_dc "
        f"{t['apply_dc']:.4f}, plain {t['apply_dc_plain']:.4f}, bound "
        f"{b_d['bound_ms']:.5f} ({b_d['bound_by']}); F.conv1d within "
        f"{lib_err:.3g} of the kernel's peak")
    sync = lambda: torch.cuda.synchronize(dev)
    for name, fn, ins in (("apply", bank.apply_kernel, ins_a),
                          ("apply_dc", bank.apply_dc_kernel, ins_d),
                          ("F.conv1d", conv, xs)):
        log(f"  K8 K={k} device ms, {name}: "
            f"{split_str(device_split(fn, ins, sync))}")
    src = dict(route="cuda", source="sdr_pmr446_tpu_torch/csrc/audio_bank.cu")
    return [{"name": "audio_bank_apply", **src,
             "replaces": "sdr_pmr446_tpu/kernels/audio_bank.py:390",
             "max_abs_err": max(errs["apply"]), "ms": t["apply"],
             "plain_ms": t["apply_plain"], **b_a, "library_ms": t_lib},
            {"name": "audio_bank_apply_dc", **src,
             "replaces": "sdr_pmr446_tpu/kernels/audio_bank.py:452",
             "max_abs_err": max(errs["apply_dc"]), "ms": t["apply_dc"],
             "plain_ms": t["apply_dc_plain"], **b_d, "library_ms": None}]


#: the scanner's op-path switches, by their chain switches
SWITCHED = {"ctcss_off": {"fuse_ctcss": False},
            "lp_dc_off": {"fuse_lp_dc": False},
            "rssi_off": {"fuse_rssi": False}}
#: the parts of a switched scanner step
SWITCH_PARTS = (("K6 front end", ("fe_",)), ("K7 PFB demod", ("pfb_",)),
                ("K8 audio bank", ("ab_",)),
                ("DC carry scan (K6)", ("dc_carry",)),
                ("copies", ("Memcpy", "Memset")))


def phase_switches(dev, oracle_run, sync):
    """Phase 12(b): the three switched engines against the oracle at K = 10
    (decisions also equal to phase 3's run), then at K = 40 in turns with
    the trio (decisions, events and audio equal to the trio's: the audio
    depends only on K6/K7's demod and ab_fir), one step each with host reads
    made errors, one profiled fuse_lp_dc=False step.  Returns the steps of
    each engine and the throughputs."""
    k = 40
    engines = {"trio": ENGINES["trio"], **SWITCHED}
    steps = {e: 0 for e in engines}
    for name, sw in SWITCHED.items():
        n, res = phase_oracle(dev, 10, 30, **sw)
        steps[name] += n
        check_decisions(res, oracle_run, f"{name} vs the duo at K = 10")
    bench_steps, results, bench = phase_engines_bench(
        dev, k, 4, sync, engines,
        ("trio", "ctcss_off", "lp_dc_off", "rssi_off", "rssi_off",
         "lp_dc_off", "ctcss_off", "trio"))
    for name in engines:
        steps[name] += bench_steps[name]
    ref = results["trio"]
    for name in SWITCHED:
        got = results[name]
        check_decisions(got, ref, f"{name} vs the trio")
        check(np.array_equal(got.audio_subchunks, ref.audio_subchunks)
              and np.array_equal(got.audio, ref.audio),
              f"{name} audio vs the trio's")
        log(f"  {name}: decisions, events and audio == the trio's (audio bit "
            f"for bit, {len(got.audio)} samples)")
    for name, sw in SWITCHED.items():
        steps[name] += phase_no_host_reads(dev, k, sync, **sw)
    steps["lp_dc_off"] += phase_profile(dev, k, sync, parts=SWITCH_PARTS,
                                        **SWITCHED["lp_dc_off"])
    return steps, bench


def phase_two_kernel(dev, mode: str, k: int, n_blocks: int, sync):
    """Phase 11(c) for one chain: dsd_in or single on the two-kernel
    engine (K6 -> K5) against the mono engine (K4) on the same bytes,
    throughput in turns (mono, two-kernel, two-kernel, mono), one step with
    host reads made errors, one profiled two-kernel step.  Returns the
    steps of each engine and the throughputs."""
    from sdr_pmr446_tpu_torch.io import synth
    steps = {"mono": n_blocks, "two": n_blocks}
    blocks = chain_blocks(mode, k, n_blocks)
    one = run_chain(make_chain(mode, k, dev), blocks)
    two = run_chain(make_chain(mode, k, dev, mono=False), blocks)
    if mode == "dsd":
        lsb = float(np.max(np.abs(one.astype(np.int32) - two.astype(np.int32))))
        log(f"  dsd K={k}, {n_blocks} blocks: two-kernel PCM within "
            f"{lsb:.0f} LSB of the mono engine's")
        check(lsb <= TOL_PCM_LSB, "dsd two-kernel vs mono")
    else:
        snr = snr_db(one, two)
        tone = synth.tone_snr_db(two[4000:], 1000.0)
        log(f"  single K={k}, {n_blocks} blocks: two-kernel audio SNR "
            f"{snr:.1f} dB against the mono engine, 1 kHz tone SNR "
            f"{tone:.1f} dB")
        check(snr > TOL_SNR_DB, "single two-kernel vs mono")
        check(tone > TOL_TONE_DB, "single two-kernel tone SNR")
    runs = {"mono": [], "two": []}
    for mono in (True, False, False, True):
        key = "mono" if mono else "two"
        r = phase_chain_throughput(dev, mode, k, n_blocks, sync, mono)
        runs[key].append(r["msamples_per_s"])
        steps[key] += n_blocks + 2
    steps["two"] += phase_profile_chain(dev, mode, k, sync, mono=False)
    return steps, {f"{mode}_mono": {"msamples_per_s": runs["mono"]},
                   f"{mode}_two_kernel": {"msamples_per_s": runs["two"]}}


PROFILE_ATTEMPTS = 3           # profiler sessions tried for one step


def profile_session(run, sync):
    """One torch.profiler session: a small device op, run(), a synchronize,
    then inside a record_function range a marker kernel (torch.cuda._sleep,
    ``spin_kernel``) and run() again.  Returns the device events that
    start after the marker (the range's own device-side annotation left
    out), the last three device events before it as (us before its end,
    name), the session's device events in all, and the range's wall time
    in ms.  The marker puts the step's start on the device's clock: the
    host-side range start alone once lay 1-3 ms after every device event of
    a 1 ms dsd step, as if the two clocks were that far apart."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device="cuda").add_(1)
        sync()
        run()
        sync()
        with record_function("chip_smoke step"):
            t0 = time.perf_counter()
            torch.cuda._sleep(100)
            run()
            sync()
            wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and e.name != "chip_smoke step"]
    marks = [e.time_range.end for e in device if "spin_kernel" in e.name]
    # the host-side range is the fallback if the marker went unrecorded
    step_start = marks[-1] if marks else next(
        e.time_range.start for e in events
        if e.name == "chip_smoke step" and e.device_type == DeviceType.CPU)
    device = [e for e in device if "spin_kernel" not in e.name]
    evs = [e for e in device if e.time_range.start >= step_start]
    before = sorted((e.time_range.start - step_start, kernel_name(e.name))
                    for e in device if e.time_range.start < step_start)[-3:]
    return evs, before, len(device), wall_ms


def busy_ms(evs) -> float:
    """The union of the events' device intervals, ms."""
    busy, end = 0.0, -float("inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in evs):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy / 1e3


def profile_step(run, sync, parts, other: str, by_kernel: bool = False,
                 launches: dict | None = None):
    """``run()`` under torch.profiler: the device's busy share (the union
    of its events' intervals) and its time by part of the step (profiling
    adds host overhead to the wall time); with ``by_kernel``, also by
    device function; ``launches`` maps a part's label to the device events
    it must have in the step.  Returns how many times it called ``run()``.

    A small device op, one run() and a synchronize come first: the
    device's first activities in a profiler session are sometimes not
    recorded (a step's 3.2 MB upload, and once an upload and three kernels,
    went missing so), and only device events that start after the second
    run's marker kernel are counted (profile_session).  The last device
    events before the marker are logged with their offsets, to show none
    of the step's fell outside it.  A session that recorded no device event
    in the step (seen in 1 ms dsd steps) is logged and made again, up to
    PROFILE_ATTEMPTS sessions."""
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        evs, before, n_device, wall_ms = profile_session(run, sync)
        log("  last device events before the step (us from its start): "
            + ", ".join(f"{name[:24]} {dt:.0f}" for dt, name in before))
        if evs:
            break
        log(f"  profiler session {attempt}: no device event in the step's "
            f"range ({n_device} device events in the session)")
    check(len(evs) > 0, "the profiler recorded no device events")
    busy_us = busy_ms(evs) * 1e3
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
    for label, n in (launches or {}).items():
        got = groups.get(label, [0.0, 0])[1]
        check(got == n, f"{label}: {got} device events in the profiled "
              f"step, expected {n}")
    if by_kernel:
        fns: dict = {}
        for e in evs:
            fns[kernel_name(e.name)] = (fns.get(kernel_name(e.name), 0.0)
                                        + e.time_range.elapsed_us())
        for name, us in sorted(fns.items(), key=lambda f: -f[1]):
            log(f"      {us / 1e3:8.4f} ms  {name}")
    return 2 * attempt


#: BASELINE.json config 5 on one card: the (streams, time shards) mesh and
#: K of each sharded path of phase 13
CONFIG5 = {"duo": ((4, 5), 40), "plane": ((4, 4), 40), "mono": ((2, 2), 16),
           "serve": ((8, 1), 8), "trio": ((4, 5), 40)}
#: (channel, CTCSS code) of each config-5 stream
STREAM_CODES = ((5, 12), (9, 3), (2, 7), (14, 20), (3, 4), (7, 15), (11, 25),
                (16, 33))
#: the hang block's receiver noise, per plane: 2.5 LSB of cu8 (below half
#: an LSB the wire is near constant, the DC-blocked band ~1e-6, and the
#: discriminator demodulates rounding: audio no two implementations share,
#: tests/test_torch_sharded.py::test_noise_hang_in_both_packages)
HANG_NOISE = 0.02
TOL_SUMMARY_REL = 1e-5         # K10 w: 128-term f32 sums in another order
#: the parts of a sharded duo step
SHARDED_PARTS = (("K10 zero summary", ("zs_",)),
                 ("K1 duo", ("duo_", "fe_", "pfb_")),
                 ("K2 audio bank", ("ab_",)),
                 ("DC carry scan (K1 and K2)", ("dc_carry",)),
                 ("copies", ("Memcpy", "Memset")))
SHARDED_DECISIONS = ("active_chan", "ct_detected", "ct_max_idx", "ev_tuned",
                     "ev_detuned", "ev_changed", "ev_prev_chan",
                     "ev_new_chan", "ev_ct_acquired", "ev_ct_changed",
                     "ev_ct_lost", "audio_valid")


@functools.lru_cache(maxsize=None)
def config5_streams(n_streams: int, k: int, n_blocks: int,
                    hang: bool = False) -> tuple:
    """The capture batch of config 5: stream s carries its own channel and
    CTCSS code (STREAM_CODES) throughout ``n_blocks`` cu8 blocks, block i
    turned by e^{0.37 j i} so that no two blocks share their bytes.  With
    ``hang``, one block more in which the transmission ends half-way and
    receiver noise follows (HANG_NOISE): the FSM's hang and detune, the
    discriminator on noise across shard starts."""
    from sdr_pmr446_tpu_torch import config as C
    from sdr_pmr446_tpu_torch.io import synth
    from sdr_pmr446_tpu_torch.ops import decode
    n = k * C.SUBCHUNK_IN
    out = []
    for s in range(n_streams):
        ch, code = STREAM_CODES[s]
        iq = synth.make_scanner_iq(n, channel=ch, ctcss_code=code,
                                   seed=200 + s)
        blocks = [iq * np.exp(0.37j * i) for i in range(n_blocks)]
        if hang:
            rng = np.random.default_rng(300 + s)
            end = k // 2 * C.SUBCHUNK_IN
            blk = iq * np.exp(0.37j * n_blocks)
            blk[end:] = HANG_NOISE * (rng.standard_normal(n - end)
                                      + 1j * rng.standard_normal(n - end))
            blocks.append(blk)
        out.append(tuple(decode.quantize_iq(b, "cu8") for b in blocks))
    return tuple(out)


def step_wires(streams, dev):
    """The [S, bytes] wire of each step, uploaded."""
    import torch
    return [torch.as_tensor(np.stack(blk), device=dev)
            for blk in zip(*streams)]


def summary_work(n: int, bps: int):
    """K10: the wire read once, v read, w and xl written (16 B a 128-sample
    row); a multiply-add per plane and sample (4 operations)."""
    return n * bps + 4 * 128 + 16 * (n // 128), 4 * n


def summary_case(dev, timer, blocks, reps: int = REPS):
    """Phase 13(a): K10 against its plain version on the wire of one
    config-5 step (every stream and shard in one launch), in each format;
    its times at cu8 on ``reps`` fresh inputs.  Returns its row."""
    import torch
    from sdr_pmr446_tpu_torch.kernels import summary
    from sdr_pmr446_tpu_torch.ops import decode
    cu8 = np.concatenate(blocks)
    x = ((cu8.astype(np.float64) - 127.5) / 127.5).view(np.complex128)
    n = x.shape[0]
    errs = []
    for fmt in ("cu8", "cs8", "cs16", "cf32"):
        wire = torch.as_tensor(cu8 if fmt == "cu8"
                               else decode.quantize_iq(x, fmt), device=dev)
        w, xl = summary.zero_summary_kernel(wire, fmt)
        wr, xr = summary.zero_summary_plain(wire, fmt)
        torch.cuda.synchronize(dev)
        err, pk = max_err(w, wr), peak(wr)
        errs.append(err)
        log(f"  K10 {fmt}, {n} samples ({wire.numel() / 1e6:.1f} MB, "
            f"{n // 128} rows): w max|err| {err:.3g} (peak {pk:.3g}), xl "
            f"{'exact' if torch.equal(xl, xr) else 'DIFFERS'}")
        check(err <= TOL_SUMMARY_REL * pk, f"K10 {fmt} w")
        check(torch.equal(xl, xr), f"K10 {fmt} xl")
    # fresh inputs: the cu8 bytes rolled by whole samples; together (225
    # MB) they exceed the 50 MB L2, so each call finds its wire cold
    wires = [(torch.roll(torch.as_tensor(cu8, device=dev), 2 * 977 * r),)
             for r in range(reps)]
    kernel = lambda w: summary.zero_summary_kernel(w, "cu8")  # noqa: E731
    t_k = timed(timer, kernel, wires)
    t_p = timed(timer, lambda w: summary.zero_summary_plain(w, "cu8"), wires)
    b = bound(*summary_work(n, 2))
    sync = lambda: torch.cuda.synchronize(dev)  # noqa: E731
    zs_ms = lambda split: sum(  # noqa: E731  (K10's own kernel, no copy)
        ms for name, ms in split.items() if name.startswith("zs_"))
    cold = zs_ms(device_split(kernel, wires, sync))
    # the sharded path's order: the step's wire uploaded, then K10 (L2 may
    # still hold part of it: a time below the bound is L2, not the kernel)
    warm = zs_ms(device_split(lambda h: kernel(torch.as_tensor(h, device=dev)),
                              [(cu8,)] * reps, sync))
    log(f"  K10 cu8 times (median of {reps}, ms): kernel {t_k:.4f}, plain "
        f"{t_p:.4f}, bound {b['bound_ms']:.5f} ({b['bound_by']}); device ms "
        f"a call: L2 cold {cold:.4f}, right after the wire's upload "
        f"{warm:.4f}; library call: none (the decode and the [R, 128] x "
        "[128] product are two calls, and the decoded planes would cost 8 B "
        "a sample more)")
    return {"name": "zero_summary", "route": "cuda",
            "source": "sdr_pmr446_tpu_torch/csrc/summary.cu",
            "replaces": "sdr_pmr446_tpu/kernels/summary.py:97",
            "max_abs_err": max(errs), "ms": t_k, "plain_ms": t_p, **b,
            "library_ms": None}


def capture_halo_planes(chain, wire, params):
    """One step of a halo_dma=True plane-path chain from its zero state,
    recording the (carried, planes, h) its two halos hand K11."""
    from sdr_pmr446_tpu_torch.kernels import halo_dma
    calls, orig = [], halo_dma.shard_hist_planes

    def record(carried, planes, h):
        calls.append((carried.clone(), planes.clone(), h))
        return orig(carried, planes, h)
    halo_dma.shard_hist_planes = record
    try:
        chain.step(chain.init_state(), wire, params)
    finally:
        halo_dma.shard_hist_planes = orig
    return calls


def halo_composition(carried, planes, h):
    """The plane path's halo before K11 took the planes: torch.complex of
    the tails, the ring shift, the carry copy (three CUDA launches)."""
    import torch
    from sdr_pmr446_tpu_torch.parallel import halo
    t = planes.shape[-1]
    return halo.shard_hist(carried, torch.complex(
        planes[..., 0, t - h:], planes[..., 1, t - h:]), h, dma=True)


def halo_case(dev, timer, calls, reps: int = REPS):
    """Phase 13(b): K11 against its plain version on the planes the plane
    path's two halos got, bit for bit, with both times; the ring shift
    alone against torch.roll on the same tails; the two halos profiled
    as a step runs them (K11, then the earlier composition).  Returns
    K11's row (timed on the resampler history)."""
    import torch
    from sdr_pmr446_tpu_torch.kernels import halo_dma
    bits = lambda t: torch.view_as_real(t).view(torch.int32)  # noqa: E731
    sync = lambda: torch.cuda.synchronize(dev)  # noqa: E731
    check(len(calls) == 2, f"the plane path's step called K11 {len(calls)} "
          "times, expected 2")
    rows = []
    for name, (carried, planes, h) in zip(("resampler history", "PFB tail"),
                                          calls):
        got = halo_dma.shard_hist_planes_kernel(carried, planes, h)
        want = halo_dma.shard_hist_planes_plain(carried, planes, h)
        sync()
        for a, b, what in zip(got, want, ("hist", "carry")):
            check(torch.equal(bits(a), bits(b)), f"K11 {name} {what}")
        t_ = planes.shape[-1]
        tail = torch.complex(planes[..., 0, t_ - h:], planes[..., 1, t_ - h:])
        check(torch.equal(halo_dma.ring_shift_kernel(tail),
                          torch.roll(tail, 1, dims=1)),
              f"K11 ring shift {name}")
        ins = [(carried, planes, h)] * reps
        t_k = timed(timer, halo_dma.shard_hist_planes_kernel, ins)
        t_p = timed(timer, halo_dma.shard_hist_planes_plain, ins)
        n_s, n_t = planes.shape[:2]
        # the D tails read, the carry read, hist and the carry written
        nbytes = 8 * h * (n_s * n_t + n_s + n_s * n_t + n_s)
        b = bound(nbytes, 0)
        roll_ins = [(tail,)] * reps
        log(f"  K11 {name} planes {tuple(planes.shape)}, h = {h}: == plain "
            f"bit for bit, the ring shift == torch.roll; times (ms) kernel "
            f"{t_k:.4f}, plain {t_p:.4f}, bound {b['bound_ms']:.6f} "
            f"({b['bound_by']}, {nbytes} B); device ms kernel "
            f"{device_ms(halo_dma.shard_hist_planes_kernel, ins, sync)}, "
            f"plain {device_ms(halo_dma.shard_hist_planes_plain, ins, sync)}"
            f", the ring shift alone "
            f"{device_ms(halo_dma.ring_shift_kernel, roll_ins, sync)}, "
            "torch.roll of the complex tail "
            f"{device_ms(lambda x: torch.roll(x, 1, dims=1), roll_ins, sync)}"
            "; library call: none (a complex tail, a shift and a carry)")
        rows.append({"name": "shard_hist_planes", "route": "cuda",
                     "source": "sdr_pmr446_tpu_torch/csrc/halo_dma.cu",
                     "replaces": "sdr_pmr446_tpu/kernels/halo_dma.py:64",
                     "max_abs_err": max(max_err(a, b_)
                                        for a, b_ in zip(got, want)),
                     "ms": t_k, "plain_ms": t_p, **b, "library_ms": None})
    for what, fn in (("K11", halo_dma.shard_hist_planes_kernel),
                     ("the earlier composition", halo_composition)):
        pair = lambda fn=fn: [fn(*c) for c in calls]  # noqa: E731
        split, span, per_call = device_profile(pair, [()] * reps, sync)
        log(f"  the two halos of a halo_dma step, {what}: {per_call:g} CUDA "
            f"kernels, device {sum(split.values()):.4f} ms, span "
            f"{span_str(span)} ms: {split_str(split)}")
        if what == "K11":
            check(per_call == 2, f"K11's halos ran {per_call} CUDA kernels "
                  "a step, expected 2")
    return rows[0]


def run_sharded(chain, wires, *params):
    """Steps of a sharded chain from its zero state (``params``: the
    scanner's runtime parameters); returns (state, per-step outputs)."""
    st = chain.init_state()
    outs = []
    for w in wires:
        st, o = chain.step(st, w, *params)
        outs.append(o)
    return st, outs


def run_streams(chains, wires, params):
    """The unsharded chains, one a stream, over the same [S, bytes] wires;
    returns per step the outputs stacked over the streams."""
    import torch
    from sdr_pmr446_tpu_torch.scanner.chain import StepOutputs
    states = [c.init_state() for c in chains]
    outs = []
    for w in wires:
        step = []
        for s, c in enumerate(chains):
            states[s], o = c.step(states[s], w[s], params)
            step.append(o)
        outs.append(StepOutputs(*(torch.stack(v) for v in zip(*step))))
    return outs


def check_sharded(got, want, what: str) -> str:
    """JAX's sharded == unsharded gate (tests/test_sharding.py:494-513) on
    [S, K, ...] outputs: decisions and events exact, RSSI within 5e-3 dB,
    audio within 1e-4.  Returns a summary."""
    from sdr_pmr446_tpu_torch.scanner.chain import outputs_to_numpy
    rssi = audio = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = outputs_to_numpy(g), outputs_to_numpy(w)
        for f in SHARDED_DECISIONS:
            check(np.array_equal(g[f], w[f]), f"{what} step {i} {f}")
        rssi = max(rssi, float(np.max(np.abs(g["rssi_db"] - w["rssi_db"]))))
        audio = max(audio, float(np.max(np.abs(g["audio"] - w["audio"]))))
    check(rssi <= 5e-3, f"{what} RSSI {rssi:.3g} dB")
    check(audio < 1e-4, f"{what} audio {audio:.3g}")
    return (f"decisions and events exact, RSSI max|diff| {rssi:.3g} dB, "
            f"audio max|diff| {audio:.3g}")


def turns(dev, runners: dict, streams, order, k: int, sync):
    """Throughput of each runner (name -> fn(wires) -> (state, per-step
    outputs [S, K, ...])) in turns (``order``), each turn from the zero
    state over the same blocks, uploads and drains inside.  Returns (the
    last turn's result of each, Msamples/s of each)."""
    import torch
    from sdr_pmr446_tpu_torch import config as C
    from sdr_pmr446_tpu_torch.scanner.chain import outputs_to_numpy
    n_s, n_blocks = len(streams), len(streams[0])
    n_samp = n_s * n_blocks * k * C.SUBCHUNK_IN
    last, rates = {}, {name: [] for name in runners}
    for turn in order:
        t0 = time.perf_counter()
        wires = [torch.from_numpy(np.stack(blk)).to(dev)
                 for blk in zip(*streams)]
        last[turn] = runners[turn](wires)
        drained = [outputs_to_numpy(o) for o in last[turn][1]]
        sync()
        sec = time.perf_counter() - t0
        rates[turn].append(n_samp / sec / 1e6)
        log(f"  {turn}: {n_blocks} blocks x {n_s} streams "
            f"({n_samp / C.SDR_SAMPLERATE:.2f} s of radio) in "
            f"{sec * 1e3:.1f} ms, {rates[turn][-1]:.1f} Msamples/s "
            f"({len(drained)} steps drained)")
    return last, rates


def no_host_reads(chain, state, wire, params, sync, what: str):
    """One step of a warmed-up chain under set_sync_debug_mode("error")."""
    import torch
    sync()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, _ = chain.step(state, wire, params)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sync()
    log(f"  {what} step under set_sync_debug_mode('error'): no host reads")
    return state


#: the kernel and plain version behind each recorded wrapper method
KERNEL_OF = {"forward": ("kernel", "plain"),
             "apply": ("apply_kernel", "apply_plain")}
#: each kernel against its plain version on a sharded path's own inputs,
#: output field by field, with the gates of phases 2, 6, 11 and 12:
#: "snr" > TOL_SNR_DB; "turns" a demod [16, F] (turns_readings: the
#: channels carrying a signal by "snr", the noise-only ones by their median
#: error, the error taken modulo one turn); "mag", "carry", "tone" relative to
#: the field's peak within TOL_MAG_RTOL, TOL_CARRY_REL, TOL_TONE_REL;
#: "audio" within TOL_AUDIO_ATOL per unit of its peak (K8's gate: noise
#: channels demodulate to +-1); "pcm" within TOL_PCM_LSB; "exact"
_CARRIES = {"dc_x": "carry", "dc_y": "carry", "front_hist": "carry"}
_MONO = {**_CARRIES, "band_hist": "carry", "sig_prev": "carry",
         "demod_hist": "carry"}
PATH_GATES = {
    "K1": {"demod": "turns", "pfb_hist": "snr", "mag_sums": "mag",
           "prev": "carry", "parity": "exact", **_CARRIES},
    "K2": {"audio": "audio", "raw_pre": "tone", "raw_mem": "tone",
           "hist": "exact", "dc_x": "carry", "dc_y": "carry"},
    "K4 dsd": {"out": "pcm", **_MONO},
    "K4 single": {"out": "snr", "n0": "exact", **_MONO},
    "K6": {"band": "snr", "dc_x": "exact", "dc_y": "carry",
           "front_hist": "carry"},
    "K7": {"demod": "turns", "mag": "mag", "pfb_hist": "carry",
           "prev": "carry", "parity": "exact"},
    "K8 apply": {"hist": "exact", "audio": "audio", "lp": "carry"},
    "K9": {0: "exact", 1: "snr"},
}


@contextlib.contextmanager
def recording(**methods):
    """Records the arguments of every call of each wrapper method (name =
    module.method, a name of PATH_GATES) made inside; yields {name:
    (method, [(args, kwargs), ...])}."""
    calls = {}
    for name, meth in methods.items():
        calls[name] = (meth, [])

        def rec(*args, _meth=meth, _calls=calls[name][1], **kw):
            _calls.append((args, kw))
            return _meth(*args, **kw)
        setattr(meth.__self__, meth.__name__, rec)
    try:
        yield calls
    finally:
        for meth, _ in calls.values():
            delattr(meth.__self__, meth.__name__)


def turns_readings(out, g) -> list:
    """The "turns" gate of a demod [16, F] (``out`` the plain version's
    output, ``g`` the kernel's demod), the error taken modulo one turn of
    the discriminator (atan2 / (2 pi kf) over 2 pi), as [(name, reading,
    within the gate)]: the SNR over the channels that carry a signal (mean
    |y| at least a tenth of the strongest's, from the output's |y| sums
    [K, 16] or plane [16, F]) > TOL_SNR_DB, and the median |err| in turns
    over the noise-only ones < TOL_NOISE_TURNS.  On noise the
    discriminator's error is f32 rounding over |y|, unbounded where |y|
    nears 0, so there an SNR says nothing of the kernel (57.5 dB over all
    16 channels of a config-5 block, where K1 holds > 110 dB on 16
    occupied ones)."""
    from sdr_pmr446_tpu_torch import config as C
    turn = 1.0 / C.FM_KF
    ref = as_np(out.demod).astype(np.float64)
    err = np.remainder(as_np(g) - ref + turn / 2, turn) - turn / 2
    mag = as_np(out.mag_sums if hasattr(out, "mag_sums") else out.mag)
    level = mag.mean(axis=1 if mag.shape == ref.shape else 0)
    sig = level >= 0.1 * level.max()
    snr = float(10 * np.log10(np.sum(ref[sig] ** 2)
                              / max(np.sum(err[sig] ** 2), 1e-300)))
    noise = float(np.median(np.abs(err[~sig]))) / turn if (~sig).any() else 0.
    return [(f"snr on {int(sig.sum())} signal channels", snr,
             snr > TOL_SNR_DB),
            ("noise channels' median turns", noise, noise < TOL_NOISE_TURNS)]


def gate_reading(kind: str, r, g):
    """(the reading, whether it is within the gate) of one output field
    against its plain version's (PATH_GATES; "turns" in turns_readings)."""
    import torch
    if kind == "snr":
        val = snr_db(as_np(r), as_np(g))
        return val, val > TOL_SNR_DB
    if kind == "pcm":
        val = int((g.to(torch.int16).int() - r.to(torch.int16).int())
                  .abs().max())
        return val, val <= TOL_PCM_LSB
    if kind == "exact":
        val = max_err(r, g)
        return val, val == 0.0
    if kind == "audio":
        val = max_err(r, g)
        return val, val < TOL_AUDIO_ATOL * max(1.0, peak(r))
    val = rel(r, g)
    return val, val < {"mag": TOL_MAG_RTOL, "carry": TOL_CARRY_REL,
                       "tone": TOL_TONE_REL}[kind]


def hold_recorded(calls: dict, last: int, what: str) -> None:
    """The ``last`` recorded calls of each kernel's wrapper (one step's
    shards) again through the kernel and through its plain version on the
    same inputs, held field by field to PATH_GATES; logs the worst reading
    of each field.  Run outside the launch-count windows."""
    import torch
    for name, (meth, args_list) in calls.items():
        mod = meth.__self__
        kern, plain = (getattr(mod, a) for a in KERNEL_OF[meth.__name__])
        gates = PATH_GATES[name]
        worst = {}
        for args, kw in args_list[-last:]:
            r, g = plain(*args, **kw), kern(*args, **kw)
            torch.cuda.synchronize()
            for field, kind in gates.items():
                rv, gv = ((getattr(r, field), getattr(g, field))
                          if isinstance(field, str) else (r[field], g[field]))
                readings = (turns_readings(r, gv) if kind == "turns" else
                            [(kind, *gate_reading(kind, rv, gv))])
                for label, val, ok in readings:
                    key = f"{field} {label}"
                    check(ok, f"{name} on {what}: {key} {val:.3g}")
                    low = label.startswith("snr")
                    prev = worst.get(key, val)
                    worst[key] = min(prev, val) if low else max(prev, val)
        check(len(args_list) >= last, f"{name} on {what}: "
              f"{len(args_list)} calls recorded for {last}")
        log(f"  {name} vs its plain version on {what}'s own inputs ({last} "
            "calls, one step): " + ", ".join(
                f"{key} {v:.3g}" for key, v in worst.items()))


def phase_config5_duo(dev, sync):
    """Phase 13(c): BASELINE config 5 on one card, the fused duo at (4, 5),
    K = 40 (K_local = 8), cu8: the sharded chain against 4 unsharded
    ScannerChains on the same bytes (4 occupied blocks and the hang block),
    throughput in turns, one step with host reads made errors (its K1 and
    K2 calls recorded), one profiled step.  Returns (the sharded steps, the
    unsharded steps, the throughputs, the chain, a function that holds the
    recorded calls)."""
    from sdr_pmr446_tpu_torch import config as C
    from sdr_pmr446_tpu_torch.parallel.scanner_sharded import (
        ShardedScannerChain, make_mesh)
    from sdr_pmr446_tpu_torch.scanner.chain import (ScannerChain,
                                                    make_runtime_params)
    (n_s, n_t), k = CONFIG5["duo"]
    streams = config5_streams(n_s, k, 4, hang=True)
    n_blocks = len(streams[0])
    params = make_runtime_params(C.ScannerArgs(), dev)
    chain = ShardedScannerChain(make_mesh(n_s, n_t), C.BlockConfig(k))
    check(chain.fused_duo, "config 5 runs the sharded duo")
    chains = [ScannerChain(C.BlockConfig(k), device=dev) for _ in range(n_s)]
    wires = step_wires(streams, dev)
    st, _ = run_sharded(chain, wires[:1], params)          # warm-up
    run_streams(chains, wires[:1], params)
    sync()
    runners = {"sharded": lambda w: run_sharded(chain, w, params),
               "unsharded": lambda w: (None, run_streams(chains, w, params))}
    last, rates = turns(dev, runners, streams, ("sharded", "unsharded",
                                                "unsharded", "sharded"),
                        k, sync)
    steps = {"sharded": 1 + 2 * n_blocks,
             "unsharded": n_s * (1 + 2 * n_blocks)}
    log(f"  sharded vs unsharded over {n_blocks} blocks (the last the hang "
        f"block, noise from sub-chunk {k // 2}): " + check_sharded(
            last["sharded"][1], last["unsharded"][1], "config 5 duo"))
    with recording(K1=chain.duo.forward,
                   K2=chain.audio_bank.forward) as calls:
        st = no_host_reads(chain, st, wires[1], params, sync,
                           f"sharded duo ({n_s}, {n_t}) K={k}")
    steps["sharded"] += 1
    holder = {"st": st}

    def one_step():
        holder["st"], _ = chain.step(holder["st"], wires[2], params)
    steps["sharded"] += profile_step(one_step, sync, SHARDED_PARTS,
                                     "other (FSM, halos, pre-pass fold)",
                                     by_kernel=True)
    hold = lambda: hold_recorded(  # noqa: E731
        calls, n_s * n_t, f"the sharded duo ({n_s}, {n_t}) K={k}")
    return steps, {"config5_duo_sharded": {"msamples_per_s":
                                           rates["sharded"]},
                   "config5_duo_unsharded": {"msamples_per_s":
                                             rates["unsharded"]}}, chain, hold


def phase_config5_plane(dev, sync, timer):
    """Phase 13(b) and (d): the plane path at (4, 4), K = 40 (K_local =
    10): K11 on the planes of one warm-up step; then, with the counts reset
    by the caller, the chain with halo_dma=True and with halo_dma=False in
    turns with the (4, 5) duo of (c) over the same 4 blocks (each warmed
    up), the two plane chains equal field for field and held against
    ScannerChain(fuse_dc=False) per stream, one step with host reads made
    errors (its K9, K7 and K8 calls recorded).  Returns (K11's row, a
    function of the duo chain that runs the counted path and returns its
    steps, its throughputs and a function that holds the recorded
    calls)."""
    import torch
    from sdr_pmr446_tpu_torch import config as C
    from sdr_pmr446_tpu_torch.parallel.scanner_sharded import (
        ShardedScannerChain, make_mesh)
    from sdr_pmr446_tpu_torch.runtime.state import state_to_numpy
    from sdr_pmr446_tpu_torch.scanner.chain import (ScannerChain,
                                                    make_runtime_params)
    (n_s, n_t), k = CONFIG5["plane"]
    streams = config5_streams(n_s, k, 4)
    wires = step_wires(streams, dev)
    params = make_runtime_params(C.ScannerArgs(), dev)
    mesh = make_mesh(n_s, n_t)
    chain = {dma: ShardedScannerChain(mesh, C.BlockConfig(k), halo_dma=dma)
             for dma in (True, False)}
    check(not chain[True].fused, "config 5 plane path")
    row = halo_case(dev, timer, capture_halo_planes(chain[True], wires[0],
                                                    params))
    run_sharded(chain[False], wires[:1], params)           # warm-up
    sync()

    def counted(duo):
        names = {True: "plane path, K11", False: "plane path, collectives"}
        runners = {names[dma]: (lambda w, c=chain[dma]:
                                run_sharded(c, w, params))
                   for dma in (True, False)}
        runners["duo"] = lambda w: run_sharded(duo, w, params)
        order = (names[True], names[False], "duo", "duo", names[False],
                 names[True])
        last, rates = turns(dev, runners, streams, order, k, sync)
        res = {dma: last[names[dma]] for dma in (True, False)}
        ref = run_streams([ScannerChain(C.BlockConfig(k), device=dev,
                                        fuse_dc=False) for _ in range(n_s)],
                          wires, params)
        sync()
        for a, b in zip(res[True][1], res[False][1]):
            for f, x, y in zip(a._fields, a, b):
                check(torch.equal(x, y), f"plane path halo_dma field {f}")
        for x, y in zip(state_to_numpy(res[True][0]),
                        state_to_numpy(res[False][0])):
            check(np.array_equal(x, y), "plane path halo_dma state")
        log(f"  plane path ({n_s}, {n_t}) K={k}: halo_dma=True == False "
            f"field for field over {len(wires)} steps; vs fuse_dc=False "
            "per stream: " + check_sharded(res[True][1], ref,
                                          "config 5 plane path"))
        pc = chain[True]
        with recording(K9=pc.resampler.forward, K7=pc.pfb.forward,
                       **{"K8 apply": pc.audio_bank.apply}) as calls:
            no_host_reads(pc, res[True][0], wires[0], params, sync,
                          f"plane path ({n_s}, {n_t}) K={k} halo_dma=True")
        hold = lambda: hold_recorded(  # noqa: E731
            calls, n_s * n_t, f"the plane path ({n_s}, {n_t}) K={k}")
        n = len(wires)
        bench = {"config5_plane_k11": {"msamples_per_s": rates[names[True]]},
                 "config5_plane_collectives": {
                     "msamples_per_s": rates[names[False]]},
                 "config5_duo_in_plane_turns": {
                     "msamples_per_s": rates["duo"]}}
        return ({"dma": 2 * n + 1, "collective": 2 * n, "duo": 2 * n,
                 "unsharded": n_s * n}, bench, hold)
    return row, counted


def phase_config5_mono(dev, sync):
    """Phase 13(e): the sharded dsd / single mono chains at (2, 2), K = 16,
    cu8, against the unsharded mono chains on the card, their K4 calls
    recorded.  Returns a function that runs the counted path and returns
    the sharded steps (the unsharded ones run before the caller's count
    window) and a function that holds the recorded calls."""
    import torch
    from sdr_pmr446_tpu_torch.parallel.dsd_sharded import ShardedDsdInChain
    from sdr_pmr446_tpu_torch.parallel.scanner_sharded import make_mesh
    from sdr_pmr446_tpu_torch.parallel.single_sharded import (
        ShardedSingleChain)
    (n_s, n_t), k = CONFIG5["mono"]
    n_steps = 2
    refs, plan = {}, {}
    for mode in ("dsd", "single"):
        blocks = chain_blocks(mode, k, n_steps + n_s - 1)
        streams = [blocks[s:s + n_steps] for s in range(n_s)]
        wires = step_wires(streams, dev)
        outs = []
        for s in range(n_s):
            ch = make_chain(mode, k, dev)
            st = ch.init_state()
            got = []
            for w in wires:
                st, o = ch.step(st, w[s])
                got.append(o)
            outs.append(torch.cat(got))
        refs[mode] = torch.stack(outs)
        plan[mode] = wires
    sync()

    def counted():
        mesh = make_mesh(n_s, n_t)
        calls = {}
        for mode, wires in plan.items():
            chain = (ShardedDsdInChain(mesh, k) if mode == "dsd"
                     else ShardedSingleChain(mesh, 5, k))
            with recording(**{f"K4 {mode}": chain.mono.forward}) as rec:
                _, outs = run_sharded(chain, wires)
            calls.update(rec)
            got = torch.cat(outs, dim=1)
            ref = refs[mode]
            for s in range(n_s):
                g, r = as_np(got[s]).astype(np.float64), as_np(ref[s])
                snr = snr_db(r.astype(np.float64), g)
                if mode == "dsd":
                    lsb = float(np.max(np.abs(g - r)))
                    check(lsb <= TOL_PCM_LSB and snr > 60.0,
                          f"sharded dsd stream {s}")
                    what = f"PCM within {lsb:.0f} LSB, SNR {snr:.1f} dB"
                else:
                    check(snr > 60.0, f"sharded single stream {s}")
                    what = f"audio SNR {snr:.1f} dB"
                log(f"  sharded {mode} ({n_s}, {n_t}) K={k} stream {s}: "
                    f"{what} against the unsharded mono chain")
        hold = lambda: hold_recorded(  # noqa: E731
            calls, n_s * n_t, f"the sharded mono chains ({n_s}, {n_t}) K={k}")
        return n_steps * len(plan), hold
    return counted


def phase_config5_engine(dev, sync, name: str, **switches):
    """Phase 13(f) and (g): one more sharded engine (CONFIG5[name]) over 2
    blocks against unsharded ScannerChains with the same switches on the
    same bytes, by check_sharded, the kernel calls of its second step
    recorded: "serve" the duo on an (S, 1) mesh (bench.py's batch8 geometry:
    8 streams at K = 8; no pre-pass, K1 keeps its carries), "trio" the
    fused trio (``fuse_band=False``).  Returns (the sharded steps, the
    unsharded steps, a function that holds the recorded calls)."""
    from sdr_pmr446_tpu_torch import config as C
    from sdr_pmr446_tpu_torch.parallel.scanner_sharded import (
        ShardedScannerChain, make_mesh)
    from sdr_pmr446_tpu_torch.scanner.chain import (ScannerChain,
                                                    make_runtime_params)
    (n_s, n_t), k = CONFIG5[name]
    wires = step_wires(config5_streams(n_s, k, 2), dev)
    params = make_runtime_params(C.ScannerArgs(), dev)
    chain = ShardedScannerChain(make_mesh(n_s, n_t), C.BlockConfig(k),
                                **switches)
    if name == "trio":
        check(chain.fused and not chain.fused_duo, "the sharded trio")
        methods = dict(K6=chain.front.forward, K7=chain.pfb.forward,
                       K2=chain.audio_bank.forward)
    else:
        check(chain.fused_duo, "the (S, 1) duo")
        methods = dict(K1=chain.duo.forward, K2=chain.audio_bank.forward)
    t0 = time.perf_counter()
    st, outs = run_sharded(chain, wires[:1], params)
    with recording(**methods) as calls:
        st, o = chain.step(st, wires[1], params)
    sync()
    ms = (time.perf_counter() - t0) * 1e3
    ref = run_streams([ScannerChain(C.BlockConfig(k), device=dev, **switches)
                       for _ in range(n_s)], wires, params)
    log(f"  {name} ({n_s}, {n_t}) K={k}: 2 steps in {ms:.1f} ms; vs "
        f"{n_s} unsharded chains: " + check_sharded(
            outs + [o], ref, f"config 5 {name}"))
    hold = lambda: hold_recorded(  # noqa: E731
        calls, n_s * n_t, f"the sharded {name} ({n_s}, {n_t}) K={k}")
    return 2, 2 * n_s, hold


def phase_sharded(dev, sync, timer):
    """Phase 13: K10 and K11 against their plain versions, then config 5's
    sharded paths with the launch counts set to 0 just before each and
    read just after; after each count, every kernel of the path against
    its plain version on the inputs the path gave it.  Returns (the K10
    and K11 rows, throughputs)."""
    from sdr_pmr446_tpu_torch.kernels import (audio_bank, chan_tail, duo,
                                              front_end, halo_dma, pfb_demod,
                                              resample_kernel, summary)
    mods = (summary, halo_dma, duo, audio_bank, front_end, pfb_demod,
            resample_kernel, chan_tail)

    def reset():
        for m in mods:
            m.LAUNCHES = 0
        audio_bank.APPLY_LAUNCHES = audio_bank.APPLY_DC_LAUNCHES = 0

    def counts():
        return {"K10": summary.LAUNCHES, "K11": halo_dma.LAUNCHES,
                "K1": duo.LAUNCHES, "K2": audio_bank.LAUNCHES,
                "K6": front_end.LAUNCHES, "K7": pfb_demod.LAUNCHES,
                "K8 apply": audio_bank.APPLY_LAUNCHES,
                "K9": resample_kernel.LAUNCHES, "K4": chan_tail.LAUNCHES}

    def expect(want, what):
        got = counts()
        log(f"  {what} launches: {got}")
        for name, n in got.items():
            check(n == want.get(name, 0), f"{what}: {name} launched {n} "
                  f"times for {want.get(name, 0)}")
        return got

    t0 = time.perf_counter()
    log("  (a) K10 (zero summary) vs its plain version")
    (n_s, n_t), k = CONFIG5["duo"]
    k10_row = summary_case(dev, timer, [s[0] for s in config5_streams(
        n_s, k, 4)])
    t_a = time.perf_counter()
    log("  (b) K11 (the halo from the planes) vs its plain version on the "
        "plane path's planes")
    k11_row, plane_counted = phase_config5_plane(dev, sync, timer)
    t_b = time.perf_counter()
    log(f"  (c) config 5: the sharded duo at {CONFIG5['duo'][0]}, K={k}, cu8")
    reset()
    steps, bench, duo_chain, hold = phase_config5_duo(dev, sync)
    sh = n_s * n_t * steps["sharded"] + steps["unsharded"]
    k10 = expect({"K10": steps["sharded"], "K1": sh, "K2": sh},
                 f"(c) over {steps}")["K10"]
    hold()
    t_c = time.perf_counter()
    (n_s, n_t), k = CONFIG5["plane"]
    log(f"  (d) the plane path at ({n_s}, {n_t}), K={k}: halo_dma on / off, "
        "in turns with the duo of (c)")
    reset()
    psteps, pbench, hold = plane_counted(duo_chain)
    bench.update(pbench)
    sh = n_s * n_t * (psteps["dma"] + psteps["collective"])
    dsh = math.prod(CONFIG5["duo"][0]) * psteps["duo"]
    c = expect({"K11": 2 * psteps["dma"], "K9": sh + psteps["unsharded"],
                "K7": sh + psteps["unsharded"], "K8 apply": sh,
                "K2": psteps["unsharded"] + dsh, "K1": dsh,
                "K10": psteps["duo"]}, f"(d) over {psteps}")
    k11_row["launches"] = c["K11"]
    k10 += c["K10"]
    hold()
    t_d = time.perf_counter()
    (n_s, n_t), k = CONFIG5["mono"]
    log(f"  (e) the sharded dsd / single mono chains at ({n_s}, {n_t}), K={k}")
    mono_counted = phase_config5_mono(dev, sync)
    reset()
    msteps, hold = mono_counted()
    c = expect({"K10": msteps, "K4": n_s * n_t * msteps},
               f"(e) over {msteps} steps")
    k10 += c["K10"]
    hold()
    t_e = time.perf_counter()
    for sub, name, sw in (("f", "serve", {}),
                          ("g", "trio", {"fuse_band": False})):
        (n_s, n_t), k = CONFIG5[name]
        log(f"  ({sub}) the sharded {name} at ({n_s}, {n_t}), K={k}, cu8")
        reset()
        n_sh, n_un, hold = phase_config5_engine(dev, sync, name, **sw)
        sh = n_s * n_t * n_sh + n_un
        kernels = ("K6", "K7", "K2") if name == "trio" else ("K1", "K2")
        expect({kn: sh for kn in kernels}, f"({sub}) over {n_sh} sharded, "
               f"{n_un} unsharded steps")
        hold()
    k10_row["launches"] = k10
    t_g = time.perf_counter()
    log(f"  phase 13 took {t_g - t0:.1f} s ((a) {t_a - t0:.1f}, (b) "
        f"{t_b - t_a:.1f}, (c) {t_c - t_b:.1f}, (d) {t_d - t_c:.1f}, (e) "
        f"{t_e - t_d:.1f}, (f) and (g) {t_g - t_e:.1f})")
    return [k10_row, k11_row], bench


def phase_probes(dev, timer, reps: int = REPS):
    """Phase 14: the probe tools through their entry points (launch counts
    0 before, read after), the readings, then K12b's modes and K12a's
    moves against their plain versions with their times.  Returns the
    K12 rows."""
    import torch
    from sdr_pmr446_tpu_torch import precision
    from sdr_pmr446_tpu_torch.kernels import build
    from sdr_pmr446_tpu_torch.kernels import probe_layout as K12a
    from sdr_pmr446_tpu_torch.kernels import probe_precision as K12b
    from sdr_pmr446_tpu_torch.tools import probe_layout as layout_tool
    from sdr_pmr446_tpu_torch.tools import probe_precision as precision_tool

    log("  (a) the probe tools (main(), the K12 path)")
    for counts in (K12b.LAUNCHES, K12a.LAUNCHES):
        for name in counts:
            counts[name] = 0
    rc_p = precision_tool.main([])
    rc_l = layout_tool.main([])
    launches = {**K12b.LAUNCHES, **K12a.LAUNCHES}
    log(f"  tools exited {rc_p} and {rc_l}; launches {launches}")
    check(rc_p == 0 and rc_l == 0, "probe tools exit 0")
    for name, n in launches.items():
        check(n == 1, f"K12 {name} launched {n} times by its tool")

    log("  (b) the precision readings")
    want = {("kernel", "ffma"): K12b.EXACT, ("kernel", "tf32"): K12b.ROUNDED,
            ("kernel", "3xtf32"): K12b.EXACT,
            ("matmul", "policy"): K12b.EXACT, ("conv1d", "policy"): K12b.EXACT}
    readings = precision_tool.readings(dev)
    for r in readings:
        log(f"  {r.path} {r.mode}: {r.value!r} -> {r.verdict}")
        if (r.path, r.mode) in want:
            check(r.value == want[(r.path, r.mode)],
                  f"{r.path} {r.mode} read {r.value!r}")
    precision.check()          # both TF32 switches restored (off)

    log("  (c) K12b's modes vs their plain versions, random inputs")
    rng = np.random.default_rng(14)
    ins = [tuple(torch.as_tensor(rng.standard_normal(shape).astype(
        np.float32), device=dev) for shape in ((128, 256), (256, 128)))
        for _ in range(reps)]
    m, k = ins[0][0].shape
    n = ins[0][1].shape[1]
    nbytes = 4 * (m * k + k * n + m * n)
    flops = 2 * m * n * k
    rows = []
    for mode in K12b.MODES:
        a, b = ins[0]
        got = K12b.probe_dot_kernel(a, b, mode)
        plain = K12b.probe_dot_plain(a, b, mode)
        torch.cuda.synchronize(dev)
        err = max_err(got, plain)
        rel_err = err / peak(plain)
        check(rel_err < TOL_PROBE_REL, f"K12b {mode} rel err {rel_err:.3g}")
        t_k = timed(timer, lambda x, y: K12b.probe_dot_kernel(x, y, mode),
                    ins)
        t_p = timed(timer, lambda x, y: K12b.probe_dot_plain(x, y, mode),
                    ins)
        sync = lambda: torch.cuda.synchronize(dev)  # noqa: E731
        dev_k = device_ms(lambda x, y: K12b.probe_dot_kernel(x, y, mode),
                          ins, sync)
        with precision.tf32_switches(False, False):
            t_lib = timed(timer, torch.matmul, ins)
            dev_lib = device_ms(torch.matmul, ins, sync)
        b_ = (bound(nbytes, flops) if mode == "ffma" else bound(
            nbytes, flops * (1 if mode == "tf32" else 3),
            PEAK_TF32_OPS_PER_S))
        log(f"  K12b {mode}: max|err| {err:.3g} ({rel_err:.3g} of the peak); "
            f"times (ms) kernel {t_k:.4f}, plain {t_p:.4f}, torch.matmul "
            f"{t_lib:.4f}, bound {b_['bound_ms']:.6f} ({b_['bound_by']}); "
            f"device ms kernel {dev_k}, torch.matmul (TF32 off) {dev_lib}")
        rows.append({"name": f"probe_dot_{mode}", "route": "cuda",
                     "source": "sdr_pmr446_tpu_torch/csrc/probe_precision.cu",
                     "replaces": "tools/probe_precision.py:37",
                     "launches": launches[mode], "max_abs_err": err,
                     "ms": t_k, "plain_ms": t_p, **b_, "library_ms": t_lib})
    # the tensor-core modes must run on wgmma: a compiler that lowered them
    # to anything else would still pass the checks above
    tc = {name: text for name, text in build.sass_by_function().items()
          if "probe_wgmma" in name}
    check(len(tc) == 2, f"{len(tc)} tensor-core probe kernels (probe_wgmma) "
          "in the SASS, expected 2")
    for name, text in sorted(tc.items()):
        hgmma = [ln.split(";")[0].split("*/")[-1].strip()
                 for ln in text.splitlines() if "HGMMA" in ln]
        log(f"  SASS of {name}: {len(hgmma)} HGMMA"
            + (f" ({hgmma[0]}, ...)" if hgmma else ""))
        check(len(hgmma) > 0, f"{name}: no HGMMA in its SASS")

    log("  (d) K12a's moves vs their plain versions, bit for bit")
    library = {"scratch_store_off16": lambda x: torch.cat(
                   (x[:, :16], x[:, :16], x[:, 32:128]), 1),
               "scratch_read_off16": lambda x: x[:, 16:144].contiguous(),
               "scratch_read_narrow": lambda x: x[:, 16:32].contiguous(),
               "value_lane_off16": lambda x: x[:, 16:144].contiguous(),
               "value_stride_sub": lambda x: x[0::16, :].contiguous(),
               "reshape_rows_wide": lambda x: torch.reshape(x, (8, 2048)),
               "reshape_25_16": lambda x: torch.reshape(x, (200, 16)),
               "transpose_16": lambda x: x.T.contiguous()}
    for move, (shape_in, _) in K12a.MOVES.items():
        ins = [(torch.as_tensor(rng.standard_normal(shape_in).astype(
            np.float32), device=dev),) for _ in range(reps)]
        got = K12a.probe_move_kernel(ins[0][0], move)
        plain = K12a.probe_move_plain(ins[0][0], move)
        torch.cuda.synchronize(dev)
        check(layout_tool.bits_equal(got, plain), f"K12a {move} bit for bit")
        check(layout_tool.bits_equal(library[move](ins[0][0]), plain),
              f"K12a {move}'s library call computes the move")
        t_k = timed(timer, lambda x: K12a.probe_move_kernel(x, move), ins)
        t_p = timed(timer, lambda x: K12a.probe_move_plain(x, move), ins)
        t_lib = timed(timer, library[move], ins)
        b_ = bound(K12a.min_bytes(move), 0)
        sync = lambda: torch.cuda.synchronize(dev)  # noqa: E731
        if library[move](ins[0][0]).data_ptr() == ins[0][0].data_ptr():
            dev_lib = "a view, no device work"
        else:
            dev_lib = device_ms(library[move], ins, sync)
        dev_k = device_ms(lambda x: K12a.probe_move_kernel(x, move), ins,
                          sync)
        log(f"  K12a {move}: == plain bit for bit; times (ms) kernel "
            f"{t_k:.4f}, plain {t_p:.4f}, library {t_lib:.4f}, bound "
            f"{b_['bound_ms']:.7f} ({b_['bound_by']}); device ms kernel "
            f"{dev_k}, library {dev_lib}")
        rows.append({"name": f"probe_layout_{move}", "route": "cuda",
                     "source": "sdr_pmr446_tpu_torch/csrc/probe_layout.cu",
                     "replaces": "tools/probe_layout.py:48",
                     "launches": launches[move], "max_abs_err": 0.0,
                     "ms": t_k, "plain_ms": t_p, **b_, "library_ms": t_lib})
    return rows


@functools.lru_cache(maxsize=None)
def busy_scenario() -> np.ndarray:
    """tests/test_faithful.py::_busy_scenario: ch3 with CTCSS 20 tunes, a
    stronger ch7 appears (lock_mode max switches), silence detunes, ch5
    with CTCSS 12; 60 sub-chunks, complex128."""
    from sdr_pmr446_tpu_torch import config as C
    from sdr_pmr446_tpu_torch.io import synth
    n1 = 15 * C.SUBCHUNK_IN
    seg1 = synth.make_scanner_iq(n1, channel=3, ctcss_code=20, seed=1)
    seg2a = synth.make_scanner_iq(n1, channel=3, amplitude=0.4,
                                  ctcss_code=20, seed=2, start_sample=n1)
    seg2b = synth.make_scanner_iq(n1, channel=7, amplitude=1.0,
                                  tone_hz=700.0, seed=3, start_sample=n1)
    rng = np.random.default_rng(4)
    seg3 = 1e-3 * (rng.standard_normal(n1) + 1j * rng.standard_normal(n1))
    seg4 = synth.make_scanner_iq(n1, channel=5, ctcss_code=12, seed=5,
                                 start_sample=3 * n1)
    return np.concatenate([seg1, seg2a + seg2b, seg3, seg4])


def run_faithful(chain, params, blocks, sync_debug_step: int = -1):
    """Every block through the faithful chain; the outputs on the host.
    Block ``sync_debug_step`` runs under set_sync_debug_mode("error")."""
    import torch
    st, outs = chain.init_state(), []
    for i, blk in enumerate(blocks):
        iq = torch.from_numpy(blk).to(chain.device)
        if i == sync_debug_step:
            torch.cuda.synchronize(chain.device)
            torch.cuda.set_sync_debug_mode("error")
        try:
            st, o = chain.step(st, iq, params)
        finally:
            if i == sync_debug_step:
                torch.cuda.set_sync_debug_mode("default")
        outs.append(o)
    return {f: np.concatenate([as_np(getattr(o, f)) for o in outs])
            for f in outs[0]._fields}


def phase_faithful(dev, k: int, sync):
    """Phase 15: faithful mode on the card vs the float64 oracle and the
    CPU run, throughput.  Returns the throughput record."""
    import torch
    from sdr_pmr446_tpu_torch import config as C
    from sdr_pmr446_tpu_torch.oracle.chain import ScannerOracle
    from sdr_pmr446_tpu_torch.scanner.chain import make_runtime_params
    from sdr_pmr446_tpu_torch.scanner.faithful import FaithfulScannerChain
    iq = busy_scenario()
    args = C.ScannerArgs(lock_mode="max")
    chain = FaithfulScannerChain(k, device=dev)
    n_blocks = len(iq) // chain.input_len
    blocks = [iq[i * chain.input_len:(i + 1) * chain.input_len].astype(
        np.complex64) for i in range(n_blocks)]
    params = make_runtime_params(args, dev)
    run_faithful(chain, params, blocks[:1])           # warm-up
    sync()
    t0 = time.perf_counter()
    got = run_faithful(chain, params, blocks)
    sync()
    sec = time.perf_counter() - t0
    n_samp = n_blocks * chain.input_len
    msps = n_samp / sec / 1e6
    rt = n_samp / C.SDR_SAMPLERATE / sec
    log(f"  faithful K={k}, {n_blocks} blocks ({n_samp / C.SDR_SAMPLERATE:.2f}"
        f" s of radio): {sec * 1e3:.1f} ms, {msps:.2f} Msamples/s, {rt:.1f}x "
        f"real time")
    ora = ScannerOracle(args)
    ora.process(iq)
    check(np.array_equal(got["active_chan"], np.asarray(ora.active_trace)),
          f"faithful active trace {got['active_chan']} vs the oracle's")
    kinds = [e.kind for e in ora.events]
    check("tuned" in kinds and "changed" in kinds and "detuned" in kinds,
          f"the busy scenario's events {kinds}")
    valid = got["audio_valid"]
    audio = got["audio"][valid].ravel()
    ora_audio = np.concatenate(ora.audio)
    check(audio.shape == ora_audio.shape, "faithful audio length")
    snr = snr_db(ora_audio, audio)
    err = float(np.max(np.abs(audio - ora_audio)))
    check(snr > TOL_FAITHFUL_DB and err < 2e-2,
          f"faithful audio vs oracle {snr:.1f} dB, max|err| {err:.3g}")
    check(bool(ora.goertzel.tone_detected) == bool(got["ct_detected"][-1])
          and ora.goertzel.max_power_index == got["ct_max_idx"][-1],
          "faithful detector state vs the oracle's")
    cpu = run_faithful(FaithfulScannerChain(k, device="cpu"),
                       make_runtime_params(args, "cpu"), blocks)
    for f in ("active_chan", "audio_valid", "ct_detected", "ct_max_idx"):
        check(np.array_equal(got[f], cpu[f]), f"faithful {f} vs the CPU run")
    cpu_snr = snr_db(cpu["audio"][valid].ravel(), audio)
    run_faithful(chain, params, blocks[:2], sync_debug_step=1)
    log(f"  vs the oracle: active trace exact, events {kinds}, audio SNR "
        f"{snr:.1f} dB, max|err| {err:.3g}; decisions == the CPU run, audio "
        f"SNR vs CPU {cpu_snr:.1f} dB; a step under set_sync_debug_mode("
        f"'error'): no host reads")
    st, _ = chain.step(chain.init_state(), torch.from_numpy(blocks[0]).to(
        dev), params)
    sync()

    def step():
        _, o = chain.step(st, torch.from_numpy(blocks[1]).to(dev), params)
        o.audio.cpu()
    profile_step(step, sync, (("copies", ("Memcpy", "Memset")),),
                 "ops (front end, per-sub-chunk loop)", by_kernel=True)
    return {"faithful": {"msamples_per_s": msps, "realtime_x": rt,
                         "seconds": sec}}


def phase_driver_checkpoint(dev, k: int, n_blocks: int, **switches):
    """Phase 16: ScannerDriver with metrics, a stopped run with a
    checkpoint every block, and its resume, against the uninterrupted run,
    on the engine the chain switches choose; with ``engine="op"`` the
    kernel engine's driver refuses the checkpoint.  Returns the steps
    run."""
    import os
    import tempfile
    from sdr_pmr446_tpu_torch import config as C
    from sdr_pmr446_tpu_torch.runtime.driver import ScannerDriver
    blocks = bench_blocks(k, n_blocks)
    make = lambda **kw: ScannerDriver(subchunks_per_step=k,
                                      input_format="cu8", device=dev,
                                      **switches, **kw)
    with tempfile.TemporaryDirectory() as tmp:
        metrics = os.path.join(tmp, "metrics.jsonl")
        full = make(metrics_path=metrics).run(blocks)
        with open(metrics) as f:
            recs = [json.loads(line) for line in f]
        keys = {"subchunk", "active_chan", "rel_rssi", "rssi_db",
                "ctcss_detected", "ctcss_code", "events"}
        check(len(recs) == n_blocks * k, f"{len(recs)} metrics records")
        check(all(set(r) == keys for r in recs), "metrics keys")
        check([r["subchunk"] for r in recs] == list(range(n_blocks * k)),
              "metrics sub-chunk indices")
        check(sum((r["events"] for r in recs), []) == full.events,
              "metrics events")
        ckpt = os.path.join(tmp, "state.npz")
        stop_at = n_blocks // 2
        first = make(checkpoint_path=ckpt, checkpoint_every=1)
        # block j drains after block j + 1 is dispatched: a stop asked in
        # block stop_at - 2's drain ends the run after block stop_at - 1
        first.on_subchunk = (lambda sub, o: first.request_stop()
                             if sub == (stop_at - 1) * k - 1 else None)
        part1 = first.run(blocks)
        check(first.stopped and first.block_index == stop_at,
              f"stopped at block {first.block_index}, wanted {stop_at}")
        second = make(checkpoint_path=ckpt)
        check(second.restore() == stop_at, "restored block index")
        part2 = second.run(blocks)
        if switches.get("engine") == "op":
            try:
                ScannerDriver(subchunks_per_step=k, input_format="cu8",
                              device=dev).restore(ckpt)
                refused = ""
            except ValueError as e:
                refused = str(e)
            check("--engine op" in refused, "the kernel driver refuses the "
                  f"op engine's checkpoint: {refused!r}")
            log(f"  the kernel engine's driver refuses it: {refused}")
    for name in ("active_trace", "ct_detected", "ct_max_idx", "audio",
                 "audio_subchunks", "rssi_trace", "rel_rssi"):
        got = np.concatenate([getattr(part1, name), getattr(part2, name)])
        want = getattr(full, name)
        check(got.shape == want.shape, f"stop + resume {name} shape "
              f"{got.shape} vs {want.shape}")
        diff = (np.abs(got.astype(np.float64) - want).max() if got.size
                else 0.0)
        check(np.array_equal(got, want), f"stop + resume {name} vs the "
              f"uninterrupted run: max|diff| {diff:.3g}")
    check(part1.events + part2.events == full.events, "stop + resume events")
    log(f"  K={k} {switches or ''}, {n_blocks} blocks: {len(recs)} metrics "
        f"records with the "
        f"JAX keys; stopped after block {stop_at} (final flush), resumed: "
        f"decisions, events, RSSI and audio == the uninterrupted run bit for "
        f"bit; events {full.events}")
    return n_blocks + stop_at + (n_blocks - stop_at)


# ------------------------------------------------------- phase 17: megasteps
#: S of phase 17(a)-(c), and the S timed in (d)
MEGA_S = 4
MEGA_TIMED_S = (1, 4, 8)
#: K of phase 17's unsharded paths (the sharded ones: CONFIG5)
MEGA_K = {"scanner": 40, "ctcss_off": 10, "mono": 16, "faithful": 10}
#: short names of the kernel modules' launch counters (runtime/fuse.py)
COUNTER_PREFIX = "sdr_pmr446_tpu_torch.kernels."


def counter_name(key) -> str:
    mod, attr = key
    short = mod.removeprefix(COUNTER_PREFIX)
    return short if attr == "LAUNCHES" else f"{short}.{attr}"


def launches_now() -> dict:
    """Every kernel's launch count, by short name."""
    from sdr_pmr446_tpu_torch.runtime import fuse
    return {counter_name(k): v for k, v in fuse.launch_counts().items()}


def settled_reserved() -> int:
    """Device memory the allocator holds once garbage (an earlier path's
    chains and graphs, which hold their own pools) is collected and its
    free cache returned: a graph's memory is the rise of this across its
    capture."""
    import gc
    import torch
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved()


def reset_launches() -> None:
    from sdr_pmr446_tpu_torch.runtime import fuse
    fuse.set_launch_counts({k: 0 for k in fuse.launch_counts()})


def bits(t):
    """A tensor's bits, comparable with torch.equal (NaN == NaN)."""
    import torch
    if t.is_complex():
        t = torch.view_as_real(t)
    if t.dtype.is_floating_point:
        t = t.contiguous().view({2: torch.int16, 4: torch.int32,
                                 8: torch.int64}[t.element_size()])
    return t


def tree_leaves(tree) -> list:
    return list(tree) if isinstance(tree, tuple) else [tree]


def check_bits(got, want, what: str) -> None:
    """Every leaf of ``got`` equal to ``want``'s bit for bit."""
    import torch
    names = getattr(want, "_fields", None)
    for i, (g, w) in enumerate(zip(tree_leaves(got), tree_leaves(want))):
        name = names[i] if names else str(i)
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"{what} {name}: {g.dtype} {tuple(g.shape)} vs {w.dtype} "
              f"{tuple(w.shape)}")
        check(torch.equal(bits(g), bits(w)), f"{what} {name} differs")


class MegaPath:
    """One path of phase 17: a chain on the card, the extra step arguments
    (runtime params or none), its host blocks (one array a step: [bytes],
    [S, bytes] for a sharded chain, c64 [T] in faithful mode), the dim its
    megastep concatenates along, the launch counters a step must move, the
    parts of its profile and the input samples a block."""

    def __init__(self, name, chain, args, blocks, dim, kernels, parts,
                 samples):
        import torch
        self.name, self.chain, self.args = name, chain, args
        self.host = blocks
        self.dev = [torch.as_tensor(b, device=chain.device) for b in blocks]
        self.dim, self.kernels, self.parts = dim, kernels, parts
        self.samples = samples

    def xs(self, i: int, n: int):
        import torch
        return torch.stack(self.dev[i:i + n])

    def steps(self, state, i: int, n: int):
        """n eager steps from ``state`` on blocks i..; outputs concatenated
        as the megastep's."""
        from sdr_pmr446_tpu_torch.runtime import fuse
        outs = []
        for x in self.dev[i:i + n]:
            state, o = self.chain.step(state, x, *self.args)
            outs.append(o)
        return state, fuse._concat(outs, self.dim)

    def mega(self, state, i: int, n: int):
        return self.chain.multi_step(state, self.xs(i, n), *self.args)


def faithful_blocks(k: int, n_blocks: int) -> list:
    """The busy scenario's blocks, then channel 5 with CTCSS 12, c64."""
    from sdr_pmr446_tpu_torch import config as C
    from sdr_pmr446_tpu_torch.io import synth
    n = k * C.SUBCHUNK_IN
    iq = busy_scenario()
    blocks = [iq[i * n:(i + 1) * n] for i in range(len(iq) // n)]
    need = n_blocks - len(blocks)
    if need > 0:
        more = synth.make_scanner_iq(need * n, channel=5, ctcss_code=12,
                                     seed=9, start_sample=len(iq))
        blocks += [more[i * n:(i + 1) * n] for i in range(need)]
    return [b.astype(np.complex64) for b in blocks[:n_blocks]]


def mega_paths(dev, n_blocks: int) -> dict:
    """Phase 17's paths, each over ``n_blocks`` distinct blocks: name ->
    a function that builds its MegaPath."""
    from sdr_pmr446_tpu_torch import config as C
    from sdr_pmr446_tpu_torch.parallel.dsd_sharded import ShardedDsdInChain
    from sdr_pmr446_tpu_torch.parallel.scanner_sharded import (
        ShardedScannerChain, make_mesh)
    from sdr_pmr446_tpu_torch.scanner.chain import (ScannerChain,
                                                    make_runtime_params)
    from sdr_pmr446_tpu_torch.scanner.faithful import FaithfulScannerChain
    scan = lambda k: k * C.SUBCHUNK_IN  # noqa: E731

    def scanner(name, k, kernels, parts, waterfall=0, **kw):
        return lambda: MegaPath(
            name, ScannerChain(C.BlockConfig(k), device=dev,
                               waterfall=waterfall, **kw),
            (make_runtime_params(C.ScannerArgs(waterfall=waterfall), dev),),
            bench_blocks(k, n_blocks), 0, kernels, parts, scan(k))

    def mono(mode, two):
        k = MEGA_K["mono"]
        return lambda: MegaPath(
            f"{mode}{' two-kernel' if two else ' mono'} K={k}",
            make_chain(mode, k, dev, mono=not two), (),
            chain_blocks(mode, k, n_blocks), 0,
            {"front_end", "chan_tail.TAIL_LAUNCHES"} if two else
            {"chan_tail"}, TWO_KERNEL_PARTS if two else CHAIN_PARTS,
            scan(k))

    def sharded(name, key, kernels, **kw):
        (n_s, n_t), k = CONFIG5[key]
        streams = config5_streams(n_s, k, n_blocks - 1, hang=True)
        return lambda: MegaPath(
            name, ShardedScannerChain(make_mesh(n_s, n_t),
                                      C.BlockConfig(k), **kw),
            (make_runtime_params(C.ScannerArgs(), dev),),
            [np.stack(b) for b in zip(*streams)], 1, kernels,
            SHARDED_PARTS, n_s * scan(k))

    def sharded_dsd():
        (n_s, n_t), k = CONFIG5["mono"]
        blocks = chain_blocks("dsd", k, n_blocks + n_s - 1)
        return MegaPath(
            f"sharded dsd ({n_s}, {n_t}) K={k}",
            ShardedDsdInChain(make_mesh(n_s, n_t), k), (),
            [np.stack([blocks[i + s] for s in range(n_s)])
             for i in range(n_blocks)], 1, {"summary", "chan_tail"},
            CHAIN_PARTS, n_s * scan(k))

    def faithful():
        k = MEGA_K["faithful"]
        return MegaPath(
            f"faithful K={k}", FaithfulScannerChain(k, device=dev),
            (make_runtime_params(C.ScannerArgs(lock_mode="max"), dev),),
            faithful_blocks(k, n_blocks), 0, set(),
            (("copies", ("Memcpy", "Memset")),), scan(k))

    k, k10 = MEGA_K["scanner"], MEGA_K["ctcss_off"]
    return {
        "duo": scanner(f"duo K={k}", k, {"duo", "audio_bank"},
                       SCANNER_PARTS),
        "trio": scanner(f"trio K={k}", k,
                        {"front_end", "pfb_demod", "audio_bank"},
                        TRIO_PARTS, fuse_band=False),
        "ctcss_off": scanner(f"fuse_ctcss=False K={k10}", k10,
                             {"front_end", "pfb_demod",
                              "audio_bank.APPLY_DC_LAUNCHES"},
                             TRIO_PARTS, fuse_ctcss=False),
        "wf": scanner(f"-w 80 K={k}", k, {"duo", "audio_bank", "waterfall"},
                      SCANNER_PARTS, waterfall=80),
        "dsd": mono("dsd", False), "dsd_two": mono("dsd", True),
        "single": mono("single", False), "single_two": mono("single", True),
        "faithful": faithful,
        "sharded": sharded("sharded duo {} K={}".format(*CONFIG5["duo"]),
                           "duo", {"summary", "duo", "audio_bank"}),
        "plane": sharded("plane path {} K={} halo_dma".format(
                             *CONFIG5["plane"]), "plane",
                         {"resample_kernel", "pfb_demod",
                          "audio_bank.APPLY_LAUNCHES", "halo_dma"},
                         halo_dma=True),
        "sharded_dsd": sharded_dsd,
    }


def megastep_equals_steps(p: MegaPath, sync) -> dict:
    """17(a): from a carried state (one step on block 0), multi_step at
    MEGA_S on blocks 1.. equals MEGA_S steps bit for bit, every output and
    state field; a second call from the returned state equals the steps
    that continue from theirs; the state the first call returned, and the
    one it was given, are unchanged after it.  The launch counts, reset
    before, equal the per-step counts x (steps + replays x S) after.
    Returns (the first call's state, the per-step counts, the graph's
    capture record)."""
    s = MEGA_S
    reset_launches()
    st0, _ = p.chain.step(p.chain.init_state(), p.dev[0], *p.args)
    per_step = {n: v for n, v in launches_now().items() if v}
    check(set(per_step) == p.kernels, f"{p.name}: kernels a step "
          f"{per_step}, expected {sorted(p.kernels)}")
    held0 = [t.clone() for t in tree_leaves(st0)]
    st_a, want = p.steps(st0, 1, s)
    reserved = settled_reserved()
    st_b, got = p.mega(st0, 1, s)
    pool = settled_reserved() - reserved
    graph = graph_of(p, s)
    check_bits(got, want, f"{p.name} megastep outputs")
    check_bits(st_b, st_a, f"{p.name} megastep state")
    held = [t.clone() for t in tree_leaves(st_b)]
    st_a2, want2 = p.steps(st_a, 1 + s, s)
    st_b2, got2 = p.mega(st_b, 1 + s, s)
    check_bits(got2, want2, f"{p.name} second megastep outputs")
    check_bits(st_b2, st_a2, f"{p.name} second megastep state")
    check_bits(st_b, type(st_b)(*held) if isinstance(st_b, tuple)
               else held[0], f"{p.name} held state")
    check_bits(st0, type(st0)(*held0) if isinstance(st0, tuple)
               else held0[0], f"{p.name} state given")
    n_steps = 1 + 2 * s + 2 * s
    got_l = {n: v for n, v in launches_now().items() if v}
    want_l = {n: v * n_steps for n, v in per_step.items()}
    check(got_l == want_l, f"{p.name}: launches {got_l}, expected {want_l} "
          f"({n_steps} steps, {2 * s} of them in 2 replays)")
    rec = {"warmup_ms": graph.warmup_ms, "capture_ms": graph.capture_ms,
           "pool_mb": pool / 2 ** 20}
    log(f"  (a) {p.name}: multi_step S={s} == {s} steps bit for bit, twice "
        f"from a carried state, held states unchanged; launches {got_l} "
        f"for {n_steps} steps; first call: warm-up {rec['warmup_ms']:.1f} "
        f"ms, capture {rec['capture_ms']:.1f} ms, graph memory "
        f"{rec['pool_mb']:.1f} MB")
    return st_b, per_step, rec


def device_family(name: str) -> str:
    """A device function's name without template arguments, PyTorch's
    vectorized and unrolled elementwise kernels as one (which of the two
    runs depends on the operands' alignment: a graph's first step reads
    its static buffers, a chained step the views its predecessor made)."""
    fn = kernel_name(name).split("<")[0]
    return ("elementwise_kernel" if fn.endswith("elementwise_kernel")
            else fn)


def graph_of(p: MegaPath, s: int):
    """The chain's captured graph (runtime/fuse.py) of S = s."""
    return next(g for g in p.chain.megastep.graphs.values()
                if g.xs.shape[0] == s)


def replay_ms(graph, sync, reps: int = 5) -> float:
    """Device ms of one replay of a captured graph (CUDA events, median)."""
    import torch
    raw = graph.graph.recorder.graph
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        sync()
        a.record()
        raw.replay()
        b.record()
        sync()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def replay_checks(p: MegaPath, state, per_step: dict, sync,
                  profile: bool) -> dict:
    """17(c): one multi_step under set_sync_debug_mode("error") (no host
    read in the copies in, the replay or the copies out), its launch
    counts == per step x S; with ``profile``, the graph's replay alone
    under torch.profiler: each device function S times its count in one
    eager step (device_family), the replay's device-busy share by part,
    and the host ms of a whole megastep.  Returns the readings."""
    import collections
    import torch
    s = MEGA_S
    xs = p.xs(1, s)
    sync()
    reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        p.chain.multi_step(state, xs, *p.args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sync()
    got_l = {n: v for n, v in launches_now().items() if v}
    want_l = {n: v * s for n, v in per_step.items()}
    check(got_l == want_l, f"{p.name} one replay: launches {got_l}, "
          f"expected {want_l}")
    log(f"  (c) {p.name}: a megastep under set_sync_debug_mode('error'): no "
        f"host reads; launches {got_l} == per step x {s}")
    if not profile:
        return {}
    graph = graph_of(p, s)
    evs, _, _, wall = profile_session(graph.graph.recorder.graph.replay,
                                      sync)
    step_evs = profile_session(
        lambda: p.chain.step(state, p.dev[1], *p.args), sync)[0]
    count = lambda es: collections.Counter(  # noqa: E731
        device_family(e.name) for e in es)
    replay, step = count(evs), count(step_evs)
    bad = {n: (replay.get(n, 0), step.get(n, 0))
           for n in set(replay) | set(step)
           if replay.get(n, 0) != s * step.get(n, 0)}
    check(not bad, f"{p.name} replay vs {s} x step, by device function "
          f"(replay, step): {bad}")
    parts: dict = {}
    for e in evs:
        label = device_group(e.name, p.parts)
        parts[label] = parts.get(label, 0.0) + e.time_range.elapsed_us()
    busy = busy_ms(evs)
    span = replay_ms(graph, sync)
    log(f"  (c) {p.name}: one replay (S={s}) under torch.profiler: "
        f"{len(evs)} device events in {len(replay)} device functions, each "
        f"{s} x its count in one eager step ({len(step_evs)} events); "
        f"device busy {busy:.3f} ms, {100 * busy / wall:.1f} % of the "
        f"profiled wall {wall:.3f} ms, {100 * busy / span:.1f} % of a "
        f"replay's {span:.3f} ms unprofiled (CUDA events); by part (ms): "
        + ", ".join(f"{k} {v / 1e3:.3f}" for k, v in sorted(
            parts.items(), key=lambda kv: -kv[1])))
    host = []
    for _ in range(5):
        sync()
        t0 = time.perf_counter()
        p.chain.multi_step(state, xs, *p.args)
        host.append((time.perf_counter() - t0) * 1e3)
    sync()
    h = statistics.median(host)
    log(f"  (c) {p.name}: host ms a megastep (copies in, replay, copies "
        f"out; median of 5) {h:.3f}")
    return {"replay_busy_ms": busy, "replay_profiled_wall_ms": wall,
            "replay_ms": span, "host_ms_megastep": h}


def megastep_rates(p: MegaPath, n_timed: int, rounds: int, sync,
                   timed_s: tuple = MEGA_TIMED_S) -> dict:
    """17(d): Msamples/s at each S of ``timed_s`` in turns (1, 4, 8, 8, 4,
    1, ...), ``rounds`` runs each, over ``n_timed`` blocks (blocks 1..
    again as needed): host wall around work that ends in a synchronize,
    the uploads inside (the driver's pinned ring, runtime/driver.py
    device_prefetch), each dispatch's outputs read back after the next is
    queued, a warm dispatch first.  S = 1 is step().  Also each graph's
    replay on the device (CUDA events) a block, and the graphs the chain
    holds after each timed run (one more is a recapture).  Returns the
    medians and each S's graph record."""
    import torch
    from sdr_pmr446_tpu_torch.runtime.driver import device_prefetch
    blocks = [p.host[1 + i % (len(p.host) - 1)] for i in range(n_timed)]
    shape, dtype = p.dev[0].shape, p.dev[0].dtype
    st0, _ = p.chain.step(p.chain.init_state(), p.dev[0], *p.args)
    graphs = {}

    def run(s):
        st, pending, group = st0, None, []
        for wire in device_prefetch(blocks, p.chain.device, 2):
            group.append(wire.view(dtype).reshape(shape))
            if len(group) < s:
                continue
            if s == 1:
                st, out = p.chain.step(st, group[0], *p.args)
            else:
                st, out = p.chain.multi_step(st, torch.stack(group),
                                             *p.args)
            group = []
            if pending is not None:
                [t.cpu() for t in tree_leaves(pending)]
            pending = out
        [t.cpu() for t in tree_leaves(pending)]
        sync()

    for s in timed_s:                   # warm: S = 1's tables, the graphs
        reserved = settled_reserved()
        run(s)
        if s > 1:
            g = graph_of(p, s)
            graphs[s] = {"capture_ms": g.capture_ms,
                         "warmup_ms": g.warmup_ms,
                         "replay_ms_per_block": replay_ms(g, sync) / s}
            if s != MEGA_S:             # captured here, not in (a)
                graphs[s]["pool_mb"] = (settled_reserved() - reserved
                                        ) / 2 ** 20
    order = []
    for r in range(rounds):
        order += list(timed_s if r % 2 == 0 else timed_s[::-1])
    rates = {s: [] for s in timed_s}
    held = []
    for s in order:
        sync()
        t0 = time.perf_counter()
        run(s)
        rates[s].append(n_timed * p.samples / (time.perf_counter() - t0)
                        / 1e6)
        held.append(len(p.chain.megastep.graphs))
    med = {s: statistics.median(v) for s, v in rates.items()}
    log(f"  (d) {p.name}, {n_timed} blocks, turns {order}: Msamples/s "
        + ", ".join(f"S={s} {med[s]:.2f} (" + ", ".join(
            f"{x:.2f}" for x in rates[s]) + ")" for s in timed_s)
        + f"; graphs held after each run {held}"
        + "; graphs: " + ", ".join(
            f"S={s} warm-up {g['warmup_ms']:.1f} ms, capture "
            f"{g['capture_ms']:.1f} ms, a replay {g['replay_ms_per_block']:.3f}"
            f" device ms a block" + (f", {g['pool_mb']:.1f} MB" if "pool_mb"
                                     in g else "")
            for s, g in graphs.items()))
    return {"msamples_per_s": {str(s): med[s] for s in timed_s},
            "runs": {str(s): rates[s] for s in timed_s},
            "graphs": {str(s): g for s, g in graphs.items()},
            "graphs_held": held}


def megastep_driver(dev, k: int, n_blocks: int) -> int:
    """17(b): ScannerDriver over n_blocks at K = k: S = 4 (two megasteps
    and a 2-block tail) equal to S = 1 bit for bit with prefetch_depth 1
    and 3; then a run with a checkpoint every 4 blocks stopped after its
    first megastep and a restore that runs the rest, equal to the
    uninterrupted run.  Returns the blocks run."""
    import os
    import tempfile
    from sdr_pmr446_tpu_torch.runtime.driver import ScannerDriver
    blocks = bench_blocks(k, n_blocks)
    make = lambda **kw: ScannerDriver(subchunks_per_step=k,  # noqa: E731
                                      device=dev, **kw)
    names = ("active_trace", "rssi_trace", "rel_rssi", "ct_detected",
             "ct_max_idx", "audio", "audio_subchunks")

    def same(got, want, what):
        for name in names:
            check(np.array_equal(getattr(got, name), getattr(want, name)),
                  f"{what}: {name} differs from S = 1")
        check(got.events == want.events, f"{what}: events")

    ref = make().run(blocks)
    run = n_blocks
    for depth in (1, 3):
        drv = make(steps_per_dispatch=MEGA_S, prefetch_depth=depth)
        same(drv.run(blocks), ref, f"S={MEGA_S}, prefetch_depth {depth}")
        check(drv.block_index == n_blocks, "block index")
        run += n_blocks
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "state.npz")
        first = make(steps_per_dispatch=MEGA_S, checkpoint_path=ckpt,
                     checkpoint_every=MEGA_S)

        def stopping(blocks):
            for i, b in enumerate(blocks):
                if i == MEGA_S - 1:     # the first megastep's last block
                    first.request_stop()
                yield b
        part1 = first.run(stopping(blocks))
        check(first.stopped and first.block_index == MEGA_S,
              f"stopped at block {first.block_index}, wanted {MEGA_S}")
        second = make(steps_per_dispatch=MEGA_S, checkpoint_path=ckpt)
        check(second.restore() == MEGA_S, "restored block index")
        part2 = second.run(blocks)
        check(second.block_index == n_blocks, "resumed block index")
    for name in names:
        got = np.concatenate([getattr(part1, name), getattr(part2, name)])
        check(np.array_equal(got, getattr(ref, name)),
              f"stop + resume at S={MEGA_S}: {name}")
    check(part1.events + part2.events == ref.events, "stop + resume events")
    log(f"  (b) the driver, K={k}, {n_blocks} blocks: S={MEGA_S} (two "
        f"megasteps, a 2-block tail) == S=1 bit for bit with prefetch_depth "
        f"1 and 3; a checkpoint every {MEGA_S} blocks, stopped after the "
        f"first megastep and restored == the uninterrupted run; events "
        f"{ref.events}")
    return run + n_blocks


def driver_rates(dev, k: int, n_timed: int, rounds: int, sync) -> dict:
    """17(d): ScannerDriver.run (its pinned uploads, drains and event
    lines inside) at each S of MEGA_TIMED_S in turns over ``n_timed``
    distinct blocks, one driver an S, warmed up by a first run (which
    captures its graph).  Returns the medians."""
    from sdr_pmr446_tpu_torch import config as C
    from sdr_pmr446_tpu_torch.runtime.driver import ScannerDriver
    blocks = bench_blocks(k, n_timed)
    drivers = {s: ScannerDriver(subchunks_per_step=k, device=dev,
                                steps_per_dispatch=s)
               for s in MEGA_TIMED_S}
    for drv in drivers.values():
        drv.run(blocks)
    order = []
    for r in range(rounds):
        order += list(MEGA_TIMED_S if r % 2 == 0 else MEGA_TIMED_S[::-1])
    rates = {s: [] for s in MEGA_TIMED_S}
    graphs = {s: [] for s in MEGA_TIMED_S}
    for s in order:
        sync()
        t0 = time.perf_counter()
        drivers[s].run(blocks)
        sync()
        rates[s].append(n_timed * k * C.SUBCHUNK_IN
                        / (time.perf_counter() - t0) / 1e6)
        graphs[s].append(len(drivers[s].chain.megastep.graphs))
    med = {s: statistics.median(v) for s, v in rates.items()}
    log(f"  (d) ScannerDriver K={k}, {n_timed} blocks, turns {order}: "
        "Msamples/s " + ", ".join(f"S={s} {med[s]:.2f} (" + ", ".join(
            f"{x:.2f}" for x in rates[s]) + ")" for s in MEGA_TIMED_S))
    log(f"  (d) ScannerDriver graphs held after each run (one more than the "
        f"first run's is a recapture): " + ", ".join(
            f"S={s} {graphs[s]}" for s in MEGA_TIMED_S if s > 1))
    return {"msamples_per_s": {str(s): med[s] for s in MEGA_TIMED_S},
            "runs": {str(s): rates[s] for s in MEGA_TIMED_S},
            "graphs_held": {str(s): graphs[s] for s in MEGA_TIMED_S}}


def phase_megastep(dev, sync) -> dict:
    """Phase 17: multi-block dispatch (runtime/fuse.py's CUDA graphs) on
    every chain.  Returns the timings for the bench record."""
    from sdr_pmr446_tpu_torch.kernels import audio_bank, duo
    t0 = time.perf_counter()
    n_blocks = 1 + 2 * MEGA_S
    paths = mega_paths(dev, n_blocks)
    timed = {"duo": (16, 3), "dsd": (16, 3), "faithful": (16, 3),
             "sharded": (8, 2)}
    bench = {}
    for key, build in paths.items():
        t_p = time.perf_counter()
        p = build()
        st, per_step, rec = megastep_equals_steps(p, sync)
        rec.update(replay_checks(p, st, per_step, sync,
                                 profile=key in timed))
        if key in timed:
            rec.update(megastep_rates(p, *timed[key], sync))
            bench[f"megastep_{key}"] = rec
        log(f"  {p.name} took {time.perf_counter() - t_p:.1f} s")
        del p
    t_b = time.perf_counter()
    reset_launches()
    n = megastep_driver(dev, MEGA_K["scanner"], 10)
    dl = {"K1": duo.LAUNCHES, "K2": audio_bank.LAUNCHES}
    log(f"  (b) launches over the driver's {n} blocks: {dl}")
    check(dl["K1"] == dl["K2"] == n, "K1 / K2 launches in phase 17(b)")
    bench["megastep_driver"] = driver_rates(dev, MEGA_K["scanner"], 16, 3,
                                            sync)
    log(f"  phase 17 took {time.perf_counter() - t0:.1f} s ((b) "
        f"{time.perf_counter() - t_b:.1f})")
    return bench


# ------------------------------------------------ phase 18: the batch server
#: scan_batch's geometry in 18(a)-(c): K, blocks a capture (~15.7 s of
#: radio), the captures' formats (the first four cu8: (b)'s), -w, S
BATCH_K = 40
BATCH_BLOCKS = 4
BATCH_FORMATS = ("cu8", "cu8", "cu8", "cu8", "cs16", "cs16", "cf32", "cf32")
BATCH_WF = 80
BATCH_S = 4
#: 18(d)'s ((streams, time shards), K, w): the widest width -w accepts
#: at (4, 5), then at K_local = 1, where w/2 spans two shards' bands
SHARDED_WF = (((4, 5), 40, 80), ((4, 5), 40, 120), ((4, 5), 40, 78400),
              ((1, 2), 2, 78400))


def batch_captures(d: str) -> list:
    """The 8 captures of 18(a): capture s on STREAM_CODES[s] for
    BATCH_BLOCKS blocks, block i turned by e^{0.37 j i} (as
    config5_streams), quantized to BATCH_FORMATS[s]; returns the paths."""
    import os
    from sdr_pmr446_tpu_torch import config as C
    from sdr_pmr446_tpu_torch.io import synth
    from sdr_pmr446_tpu_torch.ops import decode
    n = BATCH_K * C.SUBCHUNK_IN
    paths = []
    for s, fmt in enumerate(BATCH_FORMATS):
        ch, code = STREAM_CODES[s]
        iq = synth.make_scanner_iq(n, channel=ch, ctcss_code=code,
                                   seed=200 + s)
        paths.append(os.path.join(d, f"cap{s}.{fmt}"))
        with open(paths[-1], "wb") as f:
            for i in range(BATCH_BLOCKS):
                f.write(decode.quantize_iq(iq * np.exp(0.37j * i),
                                           fmt).tobytes())
    return paths


def batch_reference(dev, paths, w: int, **switches) -> list:
    """Each capture through the unsharded ScannerChain (with ``switches``)
    on the card (the host decode's cf32 wire, io/native.convert_iq, as
    scan_batch's default reader gives it): per capture (event lines in
    scan_batch's format, the valid audio, the waterfall rows)."""
    import os
    import torch
    from sdr_pmr446_tpu_torch import config as C
    from sdr_pmr446_tpu_torch.apps import scan_batch
    from sdr_pmr446_tpu_torch.io import native
    from sdr_pmr446_tpu_torch.ops import decode
    from sdr_pmr446_tpu_torch.scanner.chain import (ScannerChain,
                                                    make_runtime_params,
                                                    outputs_to_numpy)
    chain = ScannerChain(C.BlockConfig(BATCH_K), input_format="cf32",
                         device=dev, waterfall=w, **switches)
    params = make_runtime_params(C.ScannerArgs(), dev)
    refs = []
    for path in paths:
        fmt = os.path.splitext(path)[1][1:]
        x = native.convert_iq(np.fromfile(path, decode.WIRE_DTYPE[fmt]),
                              fmt)
        wire = torch.from_numpy(x.view(np.uint8)).to(dev)
        st, events, audio, rows, sub = chain.init_state(), [], [], [], 0
        for blk in wire.reshape(-1, chain.step_arg_len):
            st, o = chain.step(st, blk, params)
            h = outputs_to_numpy(o)
            one = {f: v[None] for f, v in h.items()}
            for i in range(len(h["active_chan"])):
                events += scan_batch._event_lines(one, 0, i, sub + i)
            sub += len(h["active_chan"])
            audio.append(h["audio"][h["audio_valid"]].reshape(-1))
            rows.append(h["waterfall"])
        refs.append((events, np.concatenate(audio), np.concatenate(rows)))
    return refs


def run_scan_batch(dev, argv: list):
    """scan_batch.main(argv) on ``dev`` with every launch count set to 0
    just before it; returns (the launches it made, the numeric rows it
    rendered, in order, the run's stats)."""
    from sdr_pmr446_tpu_torch.apps import scan_batch
    from sdr_pmr446_tpu_torch.ui import waterfall as wf_ui
    render = wf_ui.render_waterfall_line
    rows, stats = [], {}

    def recording(row, rel):
        rows.append(np.array(row))
        return render(row, rel)

    wf_ui.render_waterfall_line = recording
    reset_launches()
    try:
        rc = scan_batch.main(argv + ["--device", str(dev)], stats)
    finally:
        wf_ui.render_waterfall_line = render
    check(rc == 0, f"scan_batch {' '.join(argv[-8:])} exited {rc}")
    return launches_now(), rows, stats


def check_batch_outputs(outd, stems, refs, rows, what: str) -> str:
    """Each capture's events log equal to the unsharded chain's, its WAV
    within 1e-4 of its audio and its rendered rows within TOL_WF_DB dB of
    its rows (JAX's sharded gates, tests/test_sharding.py:494-513)."""
    import os
    from sdr_pmr446_tpu_torch.io import wav
    n_rows = len(rows) // max(1, len(stems))
    audio_err = row_err = 0.0
    for s, (stem, (events, audio, ref_rows)) in enumerate(zip(stems, refs)):
        got_ev = open(os.path.join(outd, f"{stem}.events.log")).read()
        check(got_ev.splitlines() == events, f"{what} {stem}: events "
              f"{got_ev.splitlines()} vs {events}")
        a, _ = wav.read_wav(os.path.join(outd, f"{stem}.wav"))
        check(len(a) == len(audio), f"{what} {stem}: {len(a)} audio "
              f"samples, wanted {len(audio)}")
        audio_err = max(audio_err, float(np.max(np.abs(a - audio))))
        if rows:
            got = np.stack(rows[s * n_rows:(s + 1) * n_rows])
            check(got.shape == ref_rows.shape, f"{what} {stem} rows "
                  f"{got.shape} vs {ref_rows.shape}")
            row_err = max(row_err, float(np.max(np.abs(got - ref_rows))))
            lines = open(os.path.join(outd, f"{stem}.waterfall.log")).read()
            check(len(lines.splitlines()) == len(ref_rows),
                  f"{what} {stem}: waterfall log lines")
    check(audio_err < 1e-4, f"{what}: audio max|diff| {audio_err:.3g}")
    check(row_err < TOL_WF_DB, f"{what}: rows max|diff| {row_err:.3g} dB")
    return (f"events == the unsharded chain's, audio max|diff| "
            f"{audio_err:.3g}, rows max|diff| {row_err:.3g} dB")


def check_counts(got: dict, want: dict, what: str) -> None:
    """Each named launch count == its wanted value; every other kernel 0."""
    for name, n in got.items():
        check(n == want.get(name, 0), f"{what}: {name} launched {n} times, "
              f"wanted {want.get(name, 0)}")


class FakeRtlTcp:
    """A localhost rtl_tcp server: the 12-byte header, the client's four
    tuning commands read, ``payload`` (cu8 bytes), then a clean close."""

    def __init__(self, payload: bytes):
        import socket
        import threading
        self.payload, self.commands = payload, []
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(1)
        self.port = self.sock.getsockname()[1]
        self.thread = threading.Thread(target=self.serve, daemon=True)
        self.thread.start()

    def serve(self):
        import socket
        import struct
        conn, _ = self.sock.accept()
        try:
            conn.settimeout(30.0)
            conn.sendall(b"RTL0" + struct.pack(">II", 5, 29))
            buf = b""
            while len(buf) < 20:
                chunk = conn.recv(20 - len(buf))
                if not chunk:
                    break
                buf += chunk
            self.commands = [struct.unpack(">BI", buf[i:i + 5])
                             for i in range(0, len(buf) - 4, 5)]
            conn.sendall(self.payload)
            conn.shutdown(socket.SHUT_WR)
            while conn.recv(4096):
                pass
        except OSError:
            pass
        finally:
            conn.close()
            self.sock.close()


def capture_wires(dev, paths, k: int, n_blocks: int) -> list:
    """The first ``n_blocks`` blocks of K = k of the cu8 captures
    ``paths``, as [S, bytes] wires on the card."""
    import torch
    from sdr_pmr446_tpu_torch import config as C
    n = 2 * k * C.SUBCHUNK_IN
    raw = np.stack([np.fromfile(p, np.uint8, count=n * n_blocks)
                    for p in paths])
    return [torch.as_tensor(raw[:, i * n:(i + 1) * n], device=dev)
            for i in range(n_blocks)]


#: 18(d)'s row gates against the unsharded chain, (depth, limit): over the
#: bins within ``depth`` dB of their row's peak the rows differ by at most
#: ``limit`` dB.  The chains' bands differ by the rounding of the composed
#: DC carries, which bins read the louder the deeper they lie (at w = 78400
#: rows span 160 dB, to the f32 floor); each limit lies between the sound
#: runs' reading and that of a carry fault of CARRY_FAULT (PERF.md §6), and
#: the error at every depth of ROW_DEPTHS_DB is logged
ROW_GATES_DB = ((60.0, TOL_WF_DB), (80.0, 0.5), (100.0, 6.0))
ROW_DEPTHS_DB = (60.0, 80.0, 100.0, 120.0, 140.0)
#: the planted fault (carry_fault) that 18(d)'s row gates and 18(e)'s
#: gates must catch: the DC blocker's y carried into every time shard
#: d >= 1 off by this share; and the larger one that 18(e)'s audio gate,
#: BUSY_AUDIO_REL of the audio's peak, must catch alone
CARRY_FAULT = 1e-3
AUDIO_FAULT = 1e-2
BUSY_AUDIO_REL = 1e-4


@contextlib.contextmanager
def carry_fault(rel: float):
    """Plant a fault in the sharded chains' composed DC-blocker carries:
    the y carried into every time shard d >= 1 off by a share ``rel`` --
    the duo's pre-pass (fused_halo.exact_dc_state) scaled, the plane and
    faithful paths' shard_dc_blocker given rel * y_end[d-1] * p^(n+1)."""
    import torch
    from sdr_pmr446_tpu_torch.parallel import fused_halo, halo
    sound_dc, sound_pre = halo.shard_dc_blocker, fused_halo.exact_dc_state

    def dc(state, x, alpha, *tg):
        st, y = sound_dc(state, x, alpha, *tg)
        n = y.shape[-1]
        decay = torch.as_tensor(((1.0 - alpha) ** (np.arange(n) + 1.0))
                                .astype(np.float32), device=y.device)
        err = torch.zeros_like(y)
        err[:, 1:] = rel * y[:, :-1, ..., -1:] * decay
        return st, y + err

    def pre(*args):
        x_in, y_in, *rest = sound_pre(*args)
        return (x_in, torch.cat([y_in[:, :1], y_in[:, 1:] * (1.0 + rel)],
                                dim=1), *rest)

    halo.shard_dc_blocker, fused_halo.exact_dc_state = dc, pre
    try:
        yield
    finally:
        halo.shard_dc_blocker, fused_halo.exact_dc_state = sound_dc, sound_pre


def row_errors(rows, want) -> dict:
    """The largest |rows - want| (dB) over the bins within each depth of
    ROW_DEPTHS_DB of their row's peak in ``want``, and over all bins."""
    diff = (rows - want).abs()
    depth = want.amax(-1, keepdim=True) - want
    out = {d: float(diff[depth <= d].max()) for d in ROW_DEPTHS_DB}
    out["all"] = float(diff.max())
    return out


def rows_held(errs: dict) -> bool:
    """Whether row_errors' readings meet every gate of ROW_GATES_DB."""
    return all(errs[d] < limit for d, limit in ROW_GATES_DB)


def fmt_depths(errs: dict) -> str:
    """row_errors' readings as one log phrase."""
    return ", ".join(f"{d if d == 'all' else f'{d:g} dB'}: {v:.3g}"
                     for d, v in errs.items())


def phase_sharded_waterfall(dev, paths) -> dict:
    """18(d): the sharded waterfall at (4, 5), K = 40, w = SHARDED_WF, on
    18(a)'s four cu8 captures, and at (1, 2), K = 2, w = 78400 (a shard's
    band, 19,600 samples, shorter than the w/2 history: it reaches back
    over both neighbours and the carry), each over two blocks: (1) the
    halos and hop counters: the rows equal, within TOL_WF_DB in every bin,
    K3 run once over each stream's bands as the shards got them,
    concatenated; (2) against the unsharded chain per stream: decisions
    exact, rows within ROW_GATES_DB (the largest difference at each depth
    logged), and the same run with carry_fault(CARRY_FAULT) failing those
    gates; K3 and the path's kernels S x D a step, K10 one
    (SHARDED_WF)."""
    import torch
    from sdr_pmr446_tpu_torch import config as C
    from sdr_pmr446_tpu_torch.kernels.waterfall import Waterfall
    from sdr_pmr446_tpu_torch.parallel.scanner_sharded import (
        ShardedScannerChain, make_mesh)
    from sdr_pmr446_tpu_torch.scanner.chain import (ScannerChain,
                                                    make_runtime_params)
    params = make_runtime_params(C.ScannerArgs(), dev)
    counts = {}
    for (n_s, n_t), k, w in SHARDED_WF:
        wires = capture_wires(dev, paths[:n_s], k, 2)
        chain = ShardedScannerChain(make_mesh(n_s, n_t, dev),
                                    C.BlockConfig(k), waterfall=w,
                                    device=dev)
        k3, bands = chain.wf, []

        class Recording:
            """K3, keeping each shard's band (in call order: step,
            stream, shard)."""
            wl = k3.wl

            def __call__(self, band, hist, cnt):
                bands.append(band)
                return k3(band, hist, cnt)

        chain.wf = Recording()
        reset_launches()
        _, got = run_sharded(chain, wires, params)
        got_l = launches_now()
        rows = torch.cat([o.waterfall for o in got], dim=1)   # [S, 2K, w]
        per = [bands[i::n_s * n_t] for i in range(n_s * n_t)]
        halo_err = 0.0
        for s in range(n_s):
            seq = torch.cat([b for step in zip(*per[s * n_t:(s + 1) * n_t])
                             for b in step], dim=1)
            one = Waterfall(w, device=dev)(
                seq, torch.zeros(w // 2, dtype=torch.complex64, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
            halo_err = max(halo_err, float((rows[s] - one.rows).abs().max()))
        check(halo_err < TOL_WF_DB, f"(d) ({n_s}, {n_t}) w={w}: rows vs K3 "
              f"over the shards' bands {halo_err:.3g} dB")
        ref = run_streams([ScannerChain(C.BlockConfig(k), device=dev,
                                        waterfall=w) for _ in range(n_s)],
                          wires, params)
        summary = check_sharded(got, ref, f"(d) ({n_s}, {n_t}) w={w}")
        want_rows = torch.cat([r.waterfall for r in ref], dim=1)
        errs = row_errors(rows, want_rows)
        check(rows_held(errs), f"(d) ({n_s}, {n_t}) w={w}: rows by depth "
              f"{fmt_depths(errs)}, gates {ROW_GATES_DB}")
        with carry_fault(CARRY_FAULT):
            _, bad = run_sharded(chain, wires, params)
        bad_errs = row_errors(torch.cat([o.waterfall for o in bad], dim=1),
                              want_rows)
        check(not rows_held(bad_errs), f"(d) ({n_s}, {n_t}) w={w}: a carry "
              f"fault of {CARRY_FAULT:g} passed the row gates "
              f"({fmt_depths(bad_errs)})")
        want = n_s * n_t * len(wires)
        if chain.fused_duo:
            per_path = {"duo": want, "audio_bank": want}
            if n_t > 1:
                per_path["summary"] = len(wires)      # K10: one a step
        else:                                         # K_local % 8 != 0
            per_path = {"resample_kernel": want, "pfb_demod": want,
                        "audio_bank.APPLY_LAUNCHES": want}
        check_counts(got_l, {**per_path, "waterfall": want},
                     f"(d) ({n_s}, {n_t}) w={w}")
        counts[f"({n_s},{n_t}) w={w}"] = got_l["waterfall"]
        log(f"  (d) ({n_s}, {n_t}) K={k} w={w} (w/2 = {w // 2}, a shard's "
            f"band {k // n_t * C.SUBCHUNK_RESAMP}): rows vs K3 over the "
            f"shards' bands {halo_err:.3g} dB; vs the unsharded chain by "
            f"depth below the row's peak {fmt_depths(errs)} (rows from "
            f"{float((want_rows - want_rows.amax(-1, keepdim=True)).min()):.1f}"
            f" dB; gates {ROW_GATES_DB}); a carry fault of "
            f"{CARRY_FAULT:g}: {fmt_depths(bad_errs)}; {summary}; launches "
            f"{ {n: v for n, v in got_l.items() if v} }")
    return counts


def faithful_pair(dev, mesh, k: int, streams: np.ndarray):
    """ShardedFaithfulChain on ``mesh`` and the unsharded faithful chain
    per stream over ``streams`` (c64 [S, n]) in blocks of K = k, lock_mode
    max: (the sharded chain, its blocks on the card, its state and
    outputs, the first decision that differs or None, the largest
    rel_rssi and audio differences, the audio's peak)."""
    import torch
    from sdr_pmr446_tpu_torch import config as C
    from sdr_pmr446_tpu_torch.parallel.faithful_sharded import (
        ShardedFaithfulChain)
    from sdr_pmr446_tpu_torch.parallel.scanner_sharded import make_mesh
    from sdr_pmr446_tpu_torch.scanner.chain import make_runtime_params
    from sdr_pmr446_tpu_torch.scanner.faithful import FaithfulScannerChain
    n = k * C.SUBCHUNK_IN
    blocks = [torch.from_numpy(streams[:, i * n:(i + 1) * n].copy()).to(dev)
              for i in range(streams.shape[1] // n)]
    params = make_runtime_params(C.ScannerArgs(lock_mode="max"), dev)
    chain = ShardedFaithfulChain(make_mesh(*mesh, dev), k, device=dev)
    st, got = run_sharded(chain, blocks, params)
    ref = FaithfulScannerChain(k, device=dev)
    differs, rel, audio, peak = None, 0.0, 0.0, 0.0
    for s in range(len(streams)):
        rs = ref.init_state()
        for i, blk in enumerate(blocks):
            rs, o = ref.step(rs, blk[s], params)
            for f in ("active_chan", "audio_valid", "ct_detected",
                      "ct_max_idx"):
                if differs is None and not torch.equal(
                        getattr(got[i], f)[s], getattr(o, f)):
                    differs = f"{mesh} stream {s} block {i} {f}"
            rel = max(rel, float((got[i].rel_rssi[s] - o.rel_rssi).abs()
                                 .max()))
            audio = max(audio, float((got[i].audio[s] - o.audio).abs()
                                     .max()))
            peak = max(peak, float(o.audio.abs().max()))
    return chain, blocks, params, st, got, differs, rel, audio, peak


def faithful_reading(differs, rel: float, audio: float, peak: float) -> str:
    """faithful_pair's readings as one log phrase."""
    return (f"decisions {'differ at ' + differs if differs else 'exact'}, "
            f"rel_rssi max|diff| {rel:.3g} dB, audio max|diff| {audio:.3g} "
            f"(peak {peak:.3g}, {audio / peak:.3g} of it)")


def phase_faithful_sharded(dev, sync) -> None:
    """18(e): ShardedFaithfulChain against the unsharded faithful chain per
    stream: (1) tests/test_sharding.py:323's scenario and geometry, a
    transmission on channel 5 with CTCSS 12 for two blocks, then receiver
    noise, at (1, 4), K = 4, two streams (the second a block behind), with
    JAX's gates (decisions exact, rel_rssi within 5e-3 dB, audio within
    1e-4); (2) the busy scenario (a lock_mode max switch between two
    channels, a detune, a retune) at (2, 2), K = 10: decisions exact,
    rel_rssi within 5e-3 dB, audio within BUSY_AUDIO_REL of its peak (the
    gated discriminator and IIRs carry the composed DC carries' rounding;
    JAX gates no such scenario), the same run with
    carry_fault(CARRY_FAULT) failing those gates and with
    carry_fault(AUDIO_FAULT) failing the audio gate; its multi_step over the 6
    blocks (a CUDA graph) equal to the steps bit for bit; no kernel
    launched."""
    import torch
    from sdr_pmr446_tpu_torch import config as C
    from sdr_pmr446_tpu_torch.io import synth
    from sdr_pmr446_tpu_torch.runtime import fuse
    reset_launches()
    step = 4 * C.SUBCHUNK_IN
    sig = synth.make_scanner_iq(2 * step, channel=5, ctcss_code=12)
    rng = np.random.default_rng(2)
    iq = np.concatenate([sig, 1e-3 * (rng.standard_normal(step)
                                      + 1j * rng.standard_normal(step))])
    iq = iq.astype(np.complex64)
    two = np.stack([iq, np.concatenate([np.zeros(step, np.complex64),
                                        iq[:-step]])])
    *_, differs, rel, audio, peak = faithful_pair(dev, (2, 4), 4, two)
    check(differs is None and rel <= 5e-3 and audio < 1e-4, f"(e) JAX's "
          f"scenario: {faithful_reading(differs, rel, audio, peak)}")
    log(f"  (e) ShardedFaithfulChain (2, 4) K=4 on tests/test_sharding.py"
        f":323's scenario: {faithful_reading(differs, rel, audio, peak)} "
        f"(JAX's gates: audio < 1e-4)")
    k = 10
    busy = busy_scenario().astype(np.complex64)
    n = k * C.SUBCHUNK_IN
    streams = np.stack([busy, np.concatenate([np.zeros(n, np.complex64),
                                              busy[:-n]])])

    def held(differs, rel, audio, peak) -> bool:
        return (differs is None and rel <= 5e-3
                and audio <= BUSY_AUDIO_REL * peak)

    chain, blocks, params, st, got, *sound = faithful_pair(
        dev, (2, 2), k, streams)
    check(held(*sound), f"(e) busy scenario: {faithful_reading(*sound)}")
    st_m, o_m = chain.multi_step(chain.init_state(), torch.stack(blocks),
                                 params)
    check_bits(st_m, st, "(e) multi_step state")
    check_bits(o_m, fuse._concat(got, 1), "(e) multi_step outputs")
    counts = {n_: v for n_, v in launches_now().items() if v}
    check(not counts, f"(e) faithful mode launched kernels: {counts}")
    faults = []
    for rel_f, audio_only in ((CARRY_FAULT, False), (AUDIO_FAULT, True)):
        with carry_fault(rel_f):
            *_, differs, rel, audio, peak = faithful_pair(dev, (2, 2), k,
                                                          streams)
        faults.append(f"a carry fault of {rel_f:g}: "
                      f"{faithful_reading(differs, rel, audio, peak)}")
        caught = (audio > BUSY_AUDIO_REL * peak if audio_only
                  else not held(differs, rel, audio, peak))
        check(caught, f"(e) {faults[-1]} passed the busy scenario's "
              f"{'audio gate' if audio_only else 'gates'}")
    log(f"  (e) ShardedFaithfulChain (2, 2) K={k}, {len(blocks)} blocks of "
        f"the busy scenario: {faithful_reading(*sound)} (gates: decisions "
        f"exact, rel_rssi <= 5e-3 dB, audio <= {BUSY_AUDIO_REL:g} of the "
        f"peak); {'; '.join(faults)}; multi_step == the steps bit for bit "
        f"({len(chain.megastep.graphs)} graph); no kernel launched")


def phase_rtl_tcp(dev) -> None:
    """18(f): the scanner CLI (--device cuda) over rtl_tcp://127.0.0.1 on
    phase 3's 30-sub-chunk cu8 capture at K = 10: tune and CTCSS events,
    the tuning commands, audio SNR > 40 dB against the float64 oracle, K1
    and K2 one launch a block."""
    import logging
    import os
    import tempfile
    from sdr_pmr446_tpu_torch import config as C
    from sdr_pmr446_tpu_torch.apps import sdr_pmr446 as app
    from sdr_pmr446_tpu_torch.io import wav
    raw, trace, audio = oracle_capture(30)
    srv = FakeRtlTcp(raw.tobytes())
    lines = []

    class Lines(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    handler = Lines()
    logging.getLogger("sdr_pmr446").addHandler(handler)
    reset_launches()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "live.wav")
            rc = app.main(["--input", f"rtl_tcp://127.0.0.1:{srv.port}",
                           "--output", out, "--subchunks-per-step", "10",
                           "--seconds", str(len(raw) // 2
                                            / C.SDR_SAMPLERATE),
                           "--device", str(dev)])
            got = wav.read_wav(out)[0] if rc == 0 else None
    finally:
        logging.getLogger("sdr_pmr446").removeHandler(handler)
    srv.thread.join(timeout=30)
    counts = launches_now()
    check(rc == 0, f"(f) the rtl_tcp scan exited {rc}")
    check(srv.commands[:2] == [(0x02, C.SDR_SAMPLERATE),
                               (0x01, int(C.SDR_FREQUENCY))],
          f"(f) tuning commands {srv.commands}")
    events = [m for m in lines if m.startswith(("Tuned", "Acquired"))]
    check(any(e.startswith("Tuned to channel 5") for e in events)
          and any(e.startswith("Acquired CTCSS code: 12") for e in events),
          f"(f) events {events}")
    snr = snr_db(audio[2:].ravel(), got.reshape(-1, NS)[2:].ravel())
    check(snr > 40.0, f"(f) audio SNR {snr:.1f} dB vs the oracle")
    check_counts(counts, {"duo": 3, "audio_bank": 3}, "(f)")
    log(f"  (f) the scanner CLI over rtl_tcp://127.0.0.1:{srv.port} (cu8, "
        f"30 sub-chunks, K=10): events {events}, audio SNR {snr:.1f} dB vs "
        f"the oracle, launches {counts['duo']} K1 / {counts['audio_bank']} "
        f"K2")


def phase_batch(dev, sync) -> dict:
    """Phase 18: the batch server (apps/scan_batch.py), the sharded
    waterfall, the sharded faithful chain and live input, on the card.
    Returns the timings for the bench record."""
    import os
    import tempfile
    from sdr_pmr446_tpu_torch import config as C
    from sdr_pmr446_tpu_torch.apps import scan_batch
    t0 = time.perf_counter()
    bench = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths = batch_captures(tmp)
        stems = scan_batch.unique_stems(paths)
        refs = batch_reference(dev, paths, BATCH_WF)
        # the plane path's unsharded counterpart (its resampler K9)
        refs_plane = batch_reference(dev, paths[:4], BATCH_WF, fuse_dc=False)
        t_a = time.perf_counter()
        steps = BATCH_BLOCKS
        base = ["--subchunks-per-step", str(BATCH_K), "-w", str(BATCH_WF)]
        outd = os.path.join(tmp, "a")
        got_l, rows, run = run_scan_batch(dev, paths + base + [
            "--mesh", "8,1", "--steps-per-dispatch", str(BATCH_S),
            "--out-dir", outd])
        summary = check_batch_outputs(outd, stems, refs, rows, "(a)")
        n8 = len(paths) * steps
        check_counts(got_l, {"duo": n8, "audio_bank": n8, "waterfall": n8},
                     "(a)")
        check(run["graphs"] == 1, f"(a) {run['graphs']} graphs captured")
        log(f"  (a) scan_batch, 8 captures ({', '.join(BATCH_FORMATS)}; "
            f"{BATCH_BLOCKS} blocks of K={BATCH_K}, "
            f"{BATCH_BLOCKS * BATCH_K * C.SUBCHUNK_IN / C.SDR_SAMPLERATE:.2f}"
            f" s of radio each), --mesh 8,1, S={BATCH_S}, -w {BATCH_WF}, "
            f"reader {run['reader']}, {run['engine']}: {summary}; launches "
            f"{ {n: v for n, v in got_l.items() if v} }; graphs "
            f"{run['graphs']}; {run['wall_s']:.3f} s")
        # capture 0 (cu8, channel 5 CTCSS 12) against the float64 oracle
        from sdr_pmr446_tpu_torch.io import native, wav
        from sdr_pmr446_tpu_torch.oracle.chain import ScannerOracle
        x = native.convert_iq(np.fromfile(paths[0], np.uint8), "cu8")
        ora = ScannerOracle()
        ora.process(x[:BATCH_K * C.SUBCHUNK_IN].astype(np.complex128))
        a0, _ = wav.read_wav(os.path.join(outd, f"{stems[0]}.wav"))
        want = np.stack(ora.audio)[2:]
        snr = snr_db(want.ravel(), a0.reshape(-1, NS)[2:len(ora.audio)]
                     .ravel())
        check(snr > 40.0, f"(a) capture 0 vs the oracle: {snr:.1f} dB")
        log(f"  (a) capture 0's first block vs the float64 oracle: audio "
            f"SNR {snr:.1f} dB")

        t_b = time.perf_counter()
        for mesh, kind in (("4,5", "K10 pre-pass"), ("4,2", "plane path")):
            outd = os.path.join(tmp, f"b{mesh[-1]}")
            got_l, rows, run = run_scan_batch(dev, paths[:4] + base + [
                "--mesh", mesh, "--device-decode", "--steps-per-dispatch",
                str(BATCH_S), "--out-dir", outd])
            summary = check_batch_outputs(
                outd, stems[:4], refs[:4] if mesh == "4,5" else refs_plane,
                rows, f"(b) {mesh}")
            d = int(mesh[-1])
            n4 = 4 * d * steps
            want = ({"duo": n4, "audio_bank": n4, "summary": steps}
                    if d == 5 else {"resample_kernel": n4, "pfb_demod": n4,
                                    "audio_bank.APPLY_LAUNCHES": n4})
            check_counts(got_l, {**want, "waterfall": n4}, f"(b) {mesh}")
            check(run["graphs"] == 1, f"(b) {run['graphs']} graphs")
            log(f"  (b) --device-decode cu8, --mesh {mesh} ({kind}, "
                f"{run['engine']}): {summary}; launches "
                f"{ {n: v for n, v in got_l.items() if v} }; graphs "
                f"{run['graphs']}")

        t_c = time.perf_counter()
        ckpt = os.path.join(tmp, "ck.npz")
        outs = [os.path.join(tmp, f"c{i}") for i in range(2)]
        part = paths + base + ["--mesh", "8,1", "--steps-per-dispatch", "2",
                               "--checkpoint", ckpt]
        l1, _, r1 = run_scan_batch(dev, part + ["--stop-after", "1",
                                                "--out-dir", outs[0]])
        l2, _, r2 = run_scan_batch(dev, part + ["--resume", "--out-dir",
                                                outs[1]])
        for stem in stems:
            for ext in ("wav", "events.log", "waterfall.log"):
                got = open(os.path.join(outs[1], f"{stem}.{ext}"),
                           "rb").read()
                want = open(os.path.join(tmp, "a", f"{stem}.{ext}"),
                            "rb").read()
                check(got == want, f"(c) resumed {stem}.{ext} differs")
        for counts, run, done in ((l1, r1, 2), (l2, r2, 4)):
            check(run["blocks"] == done, f"(c) {run['blocks']} blocks done "
                  f"after a part, wanted {done}")
            check_counts(counts, {"duo": 16, "audio_bank": 16,
                                  "waterfall": 16}, "(c)")
        log(f"  (c) --stop-after 1 at S=2 (2 blocks, graphs "
            f"{r1['graphs']}), then --resume (2 blocks, graphs "
            f"{r2['graphs']}): every WAV, events and waterfall log == (a)'s "
            f"byte for byte")

        t_g = time.perf_counter()
        bench.update(batch_rates(dev, tmp, paths))
        t_p = time.perf_counter()
        bench["scan_batch_megastep"] = profile_batch_megastep(dev, sync,
                                                              paths)
        t_d = time.perf_counter()
        bench["sharded_wf_k3_launches"] = phase_sharded_waterfall(dev,
                                                                  paths)
    t_e = time.perf_counter()
    phase_faithful_sharded(dev, sync)
    t_f = time.perf_counter()
    phase_rtl_tcp(dev)
    log(f"  phase 18 took {time.perf_counter() - t0:.1f} s (captures and "
        f"references {t_a - t0:.1f}, (a) {t_b - t_a:.1f}, (b) "
        f"{t_c - t_b:.1f}, (c) {t_g - t_c:.1f}, rates {t_p - t_g:.1f}, "
        f"profile {t_d - t_p:.1f}, (d) {t_e - t_d:.1f}, (e) "
        f"{t_f - t_e:.1f}, (f) {time.perf_counter() - t_f:.1f})")
    return bench


def batch_rates(dev, tmp: str, paths) -> dict:
    """scan_batch's Msamples/s of capture (samples over the run's wall,
    readers, uploads, drains and any graph capture inside) at S = 1 and
    BATCH_S, --mesh 8,1, no -w: (1) 18(a)'s 8 captures through the default
    reader (host conversion, the cf32 wire); (2) 8 cu8 captures of 3 x
    BATCH_BLOCKS blocks (18(a)'s four, each written three times, twice
    over) with --device-decode, where the run outlasts its first group."""
    import os
    tiled = []
    for s in range(8):
        tiled.append(os.path.join(tmp, f"tiled{s}.cu8"))
        data = open(paths[s % 4], "rb").read()
        with open(tiled[-1], "wb") as f:
            f.write(data * 3)
    bench = {}
    for name, caps, extra in (("default", paths, []),
                              ("device_decode", tiled, ["--device-decode"])):
        for s_disp in (1, BATCH_S):
            _, _, run = run_scan_batch(dev, caps + extra + [
                "--subchunks-per-step", str(BATCH_K), "--mesh", "8,1",
                "--steps-per-dispatch", str(s_disp), "--out-dir",
                os.path.join(tmp, f"rate_{name}_{s_disp}")])
            msps = run["samples"] / run["wall_s"] / 1e6
            rest = (run["samples"] * (1 - s_disp / run["blocks"])
                    / max(run["wall_s"] - run["first_s"], 1e-9) / 1e6
                    if s_disp < run["blocks"] else None)
            bench[f"scan_batch_{name}_S{s_disp}"] = {
                "msamples_per_s": msps, "after_first_group": rest,
                "wall_s": run["wall_s"], "first_group_s": run["first_s"],
                "reader": run["reader"], "graphs": run["graphs"]}
            log(f"  scan_batch S={s_disp}, 8 captures x {run['blocks']} "
                f"blocks, --mesh 8,1, no -w, reader {run['reader']}: "
                f"{msps:.1f} Msamples/s of capture ({run['samples']} "
                f"samples in {run['wall_s']:.3f} s; first group "
                f"{run['first_s']:.3f} s"
                + (f", after it {rest:.1f} Msamples/s" if rest else "")
                + f"); graphs {run['graphs']}")
    return bench


def profile_batch_megastep(dev, sync, paths) -> dict:
    """One scan_batch megastep (the (8, 1) duo, K = 40, -w 80, S = 4, a
    replay of its graph) on 18(a)'s captures as its default reader gives
    them (the cf32 wire) under torch.profiler: the device's busy share and
    its time by part."""
    import os
    import torch
    from sdr_pmr446_tpu_torch import config as C
    from sdr_pmr446_tpu_torch.io import native
    from sdr_pmr446_tpu_torch.ops import decode
    from sdr_pmr446_tpu_torch.parallel.scanner_sharded import (
        ShardedScannerChain, make_mesh)
    from sdr_pmr446_tpu_torch.scanner.chain import make_runtime_params
    chain = ShardedScannerChain(make_mesh(8, 1, dev), C.BlockConfig(BATCH_K),
                                waterfall=BATCH_WF, input_format="cf32",
                                device=dev)
    caps = []
    for p in paths:
        fmt = os.path.splitext(p)[1][1:]
        caps.append(native.convert_iq(np.fromfile(
            p, decode.WIRE_DTYPE[fmt]), fmt).view(np.uint8))
    wires = torch.as_tensor(np.stack(caps).reshape(
        len(paths), BATCH_S, -1).transpose(1, 0, 2).copy(), device=dev)
    params = make_runtime_params(C.ScannerArgs(), dev)
    st = chain.init_state()
    chain.multi_step(st, wires, params)          # the capture
    sync()
    t0 = time.perf_counter()
    chain.multi_step(st, wires, params)
    sync()
    replay_ms = (time.perf_counter() - t0) * 1e3
    parts = SHARDED_PARTS + (("K3 waterfall", ("wf_",)),)
    profile_step(lambda: chain.multi_step(st, wires, params), sync, parts,
                 "other (FSMs, halo ops, graph copies)")
    log(f"  the (8, 1) megastep, S={BATCH_S}: one replay {replay_ms:.1f} ms "
        f"(CUDA graph of {BATCH_S} steps, {len(chain.megastep.graphs)} "
        f"graph)")
    return {"replay_ms": replay_ms, "graphs": len(chain.megastep.graphs)}


# ------------------------------------------------ phase 19: the op engines
#: the parts of an op-engine scanner step, by device function name
OP_PARTS = (("convolutions (resampler, PFB, FIRs)",
             ("implicit_convolve", "cudnn", "conv", "xmma_fprop",
              "sm90_xmma_fprop", "sm80_xmma_fprop", "fft")),
            ("matmuls (IIR scans, tone DFT)", ("gemm", "sm90_xmma_gemm",
                                               "sm80_xmma_gemm", "cutlass",
                                               "ampere", "gemv", "dot")),
            ("K3 waterfall", ("wf_",)),
            ("copies", ("Memcpy", "Memset")))
#: (mesh, K) of the sharded op dsd / single chains in 19(d) and of every
#: sharded op chain in (e): K_local = 6, which the kernel engine refuses
OP_MONO = ((2, 2), 12)
OP = {"engine": "op"}


def check_launches(want: dict, what: str) -> dict:
    """The launch counts since reset_launches() equal ``want`` (counter
    name -> launches; every other counter 0)."""
    got = {n: v for n, v in launches_now().items() if v}
    check(got == want, f"{what}: launches {got}, expected {want}")
    log(f"  launches over {what}: {got or 'none'}")
    return got


def op_sharded_scanner(dev, sync) -> None:
    """19(d): the sharded op scanner at config 5's (4, 5), K = 40, cu8,
    over 4 occupied blocks and the hang block, against 4 unsharded op
    chains on the same bytes under JAX's sharded gates."""
    from sdr_pmr446_tpu_torch import config as C
    from sdr_pmr446_tpu_torch.parallel.scanner_sharded import (
        ShardedScannerChain, make_mesh)
    from sdr_pmr446_tpu_torch.scanner.chain import (ScannerChain,
                                                    make_runtime_params)
    (n_s, n_t), k = CONFIG5["duo"]
    streams = config5_streams(n_s, k, 4, hang=True)
    params = make_runtime_params(C.ScannerArgs(), dev)
    chain = ShardedScannerChain(make_mesh(n_s, n_t), C.BlockConfig(k), **OP)
    check(chain.engine_label == "op", "the sharded op engine")
    chains = [ScannerChain(C.BlockConfig(k), device=dev, **OP)
              for _ in range(n_s)]
    wires = step_wires(streams, dev)
    t0 = time.perf_counter()
    _, got = run_sharded(chain, wires, params)
    sync()
    t1 = time.perf_counter()
    want = run_streams(chains, wires, params)
    sync()
    log(f"  (d) the sharded op scanner ({n_s}, {n_t}) K={k}, {len(wires)} "
        f"blocks (the last the hang block) in {(t1 - t0) * 1e3:.1f} ms (its "
        f"first call included), 4 unsharded op chains in "
        f"{(time.perf_counter() - t1) * 1e3:.1f} ms: "
        + check_sharded(got, want, "the sharded op scanner"))


def op_sharded_mono(dev) -> int:
    """19(d): the sharded dsd / single op chains at OP_MONO against the
    unsharded op chains per stream (dsd cu8, single cf32).  Returns the
    sharded steps."""
    import torch
    from sdr_pmr446_tpu_torch.parallel.dsd_sharded import ShardedDsdInChain
    from sdr_pmr446_tpu_torch.parallel.scanner_sharded import make_mesh
    from sdr_pmr446_tpu_torch.parallel.single_sharded import (
        ShardedSingleChain)
    (n_s, n_t), k = OP_MONO
    n_steps = 2
    for mode, fmt in (("dsd", "cu8"), ("single", "cf32")):
        blocks = chain_blocks(mode, k, n_steps + n_s - 1, fmt)
        wires = step_wires([blocks[s:s + n_steps] for s in range(n_s)], dev)
        chain = (ShardedDsdInChain(make_mesh(n_s, n_t), k, **OP) if mode ==
                 "dsd" else ShardedSingleChain(make_mesh(n_s, n_t), 5, k,
                                               input_format=fmt, **OP))
        check(chain.k_local == k // n_t, "K_local")
        got = torch.cat(run_sharded(chain, wires)[1], dim=1)
        ref = make_chain(mode, k, dev, engine="op", fmt=fmt)
        for s in range(n_s):
            st, outs = ref.init_state(), []
            for w in wires:
                st, o = ref.step(st, w[s])
                outs.append(o)
            r = as_np(torch.cat(outs)).astype(np.float64)
            g = as_np(got[s]).astype(np.float64)
            snr = snr_db(r, g)
            if mode == "dsd":
                lsb = float(np.max(np.abs(g - r)))
                check(lsb <= TOL_PCM_LSB and snr > 60.0,
                      f"sharded dsd op stream {s}")
                what = f"PCM within {lsb:.0f} LSB, SNR {snr:.1f} dB"
            else:
                check(snr > 60.0, f"sharded single op stream {s}")
                what = f"audio SNR {snr:.1f} dB"
            log(f"  (d) sharded {mode} op ({n_s}, {n_t}) K={k} (K_local "
                f"{chain.k_local}), stream {s}: {what} against the "
                f"unsharded op chain")
    return 2 * n_steps


def op_mega_paths(dev, n_blocks: int) -> dict:
    """19(e)'s paths, each over ``n_blocks`` distinct blocks: name -> a
    function that builds its MegaPath (no kernel launches a step)."""
    from sdr_pmr446_tpu_torch import config as C
    from sdr_pmr446_tpu_torch.parallel.dsd_sharded import ShardedDsdInChain
    from sdr_pmr446_tpu_torch.parallel.scanner_sharded import (
        ShardedScannerChain, make_mesh)
    from sdr_pmr446_tpu_torch.parallel.single_sharded import (
        ShardedSingleChain)
    from sdr_pmr446_tpu_torch.scanner.chain import (ScannerChain,
                                                    make_runtime_params)
    scan = lambda k: k * C.SUBCHUNK_IN  # noqa: E731
    copies = (("copies", ("Memcpy", "Memset")),)
    k = MEGA_K["scanner"]
    (m_s, m_t), km = OP_MONO
    km1 = MEGA_K["mono"]

    def mono(mode, fmt):
        return lambda: MegaPath(
            f"{mode} op K={km1} {fmt}",
            make_chain(mode, km1, dev, engine="op", fmt=fmt), (),
            chain_blocks(mode, km1, n_blocks, fmt), 0, set(), copies,
            scan(km1))

    def sharded_mono(mode, fmt):
        blocks = chain_blocks(mode, km, n_blocks + m_s - 1, fmt)
        mesh = make_mesh(m_s, m_t)
        return lambda: MegaPath(
            f"sharded {mode} op ({m_s}, {m_t}) K={km}",
            ShardedDsdInChain(mesh, km, **OP) if mode == "dsd" else
            ShardedSingleChain(mesh, 5, km, input_format=fmt, **OP), (),
            [np.stack([blocks[i + s] for s in range(m_s)])
             for i in range(n_blocks)], 1, set(), copies, m_s * scan(km))

    def sharded():
        streams = config5_streams(m_s, km, n_blocks - 1, hang=True)
        return MegaPath(
            f"sharded op scanner ({m_s}, {m_t}) K={km}",
            ShardedScannerChain(make_mesh(m_s, m_t), C.BlockConfig(km),
                                **OP),
            (make_runtime_params(C.ScannerArgs(), dev),),
            [np.stack(b) for b in zip(*streams)], 1, set(), OP_PARTS,
            m_s * scan(km))

    return {
        "scanner": lambda: MegaPath(
            f"op scanner K={k}", ScannerChain(C.BlockConfig(k), device=dev,
                                              **OP),
            (make_runtime_params(C.ScannerArgs(), dev),),
            bench_blocks(k, n_blocks), 0, set(), OP_PARTS, scan(k)),
        "dsd": mono("dsd", "cu8"), "single": mono("single", "cf32"),
        "sharded": sharded, "sharded_dsd": sharded_mono("dsd", "cu8"),
        "sharded_single": sharded_mono("single", "cf32"),
    }


def record_app(dev) -> None:
    """19(g): apps/record.main on a synthetic cu8 capture (channel 5, then
    receiver noise) on the driver's default engine: one WAV, its audio the
    driver's, K1 and K2 one launch a block of record's run."""
    import os
    import tempfile
    from sdr_pmr446_tpu_torch import config as C
    from sdr_pmr446_tpu_torch.apps import record
    from sdr_pmr446_tpu_torch.io import synth, wav
    from sdr_pmr446_tpu_torch.ops import decode
    from sdr_pmr446_tpu_torch.runtime.driver import ScannerDriver, wire_blocks
    k = 10
    n = 2 * k * C.SUBCHUNK_IN
    rng = np.random.default_rng(7)
    iq = np.concatenate([
        synth.make_scanner_iq(n, channel=5, ctcss_code=None),
        HANG_NOISE * (rng.standard_normal(n) + 1j * rng.standard_normal(n))])
    raw = decode.quantize_iq(iq, "cu8")
    with tempfile.TemporaryDirectory() as tmp:
        cap = os.path.join(tmp, "cap.cu8")
        raw.tofile(cap)
        outd = os.path.join(tmp, "rec")
        reset_launches()
        rc = record.main(["--input", cap, "--outdir", outd,
                          "--subchunks-per-step", str(k)])
        check(rc == 0, f"record exit {rc}")
        blocks = 2 * n // (k * C.SUBCHUNK_IN)
        check_launches({"duo": blocks, "audio_bank": blocks},
                       f"record's {blocks} blocks")
        wavs = sorted(f for f in os.listdir(outd) if f.endswith(".wav"))
        check(len(wavs) == 1, f"record wrote {wavs}")
        got, rate = wav.read_wav(os.path.join(outd, wavs[0]))
        drv = ScannerDriver(subchunks_per_step=k, input_format="cu8",
                            device=dev)
        res = drv.run(wire_blocks(raw, "cu8", drv.feed_len))
        ref = os.path.join(tmp, "driver.wav")
        wav.write_wav(ref, res.audio, C.AUDIO_SAMPLERATE)
        want, _ = wav.read_wav(ref)
    check(rate == C.AUDIO_SAMPLERATE and len(got) > 0, "record's WAV")
    check(np.array_equal(got, want), "record's WAV == the driver's audio")
    log(f"  (g) apps/record.main: one WAV {wavs[0]}, "
        f"{len(got) / C.AUDIO_SAMPLERATE:.2f} s, equal to the driver's "
        f"audio; events {res.events}")


def phase_op_engines(dev, sync, oracle_run) -> dict:
    """Phase 19: the op engines (engine="op", the JAX op engine's plain
    ops) on the card, each part with the launch counts set to 0 just
    before it and checked == just after: no kernel launches on an op path
    but K3, once a step under -w; record (g) runs its default engine.
    Returns the timings."""
    bench = {}
    t0 = time.perf_counter()
    log("  (a) the op scanner (ScannerDriver(engine='op'), cu8)")
    reset_launches()
    _, op_run = phase_oracle(dev, 10, 30, **OP)
    check_decisions(op_run, oracle_run, "op engine vs phase 3's duo run")
    log("  decisions and events == phase 3's duo run")
    check_launches({}, "the op scanner vs the oracle")
    reset_launches()
    steps, results, rates = phase_engines_bench(
        dev, 40, 4, sync, {"duo": {}, "op": OP}, ("duo", "op", "op", "duo"))
    check_decisions(results["op"], results["duo"], "op vs duo at K=40")
    log("  K=40: the op engine's decisions and events == the duo's")
    check_launches({"duo": steps["duo"], "audio_bank": steps["duo"]},
                   "config 2 in turns (the duo's steps)")
    bench.update({f"op_{k}": v for k, v in rates.items()})
    reset_launches()
    phase_no_host_reads(dev, 40, sync, **OP)
    phase_profile(dev, 40, sync, parts=OP_PARTS, **OP)
    check_launches({}, "the op scanner's sync-debug and profiled steps")
    t_b = time.perf_counter()
    log("  (b) -w 80 on the op engine (K=10)")
    reset_launches()
    phase_waterfall_oracle(dev, 10, 30, 80, **OP)
    check_launches({"waterfall": 3}, "the -w 80 op scanner (3 steps)")
    t_c = time.perf_counter()
    log("  (c) dsd_in --engine op (K=10, cu8) and the single op chain "
        "(K=16, cf32)")
    reset_launches()
    phase_dsd_app(dev, 10, 3, engine="op")
    phase_single(dev, 16, 2, engine="op", fmt="cf32")
    check_launches({}, "dsd_in and single on the op engine")
    t_d = time.perf_counter()
    log("  (d) the sharded op chains")
    reset_launches()
    op_sharded_scanner(dev, sync)
    op_sharded_mono(dev)
    check_launches({}, "the sharded op chains")
    t_e = time.perf_counter()
    log(f"  (e) multi_step on every op chain (S={MEGA_S})")
    for key, build in op_mega_paths(dev, 1 + 2 * MEGA_S).items():
        p = build()
        st, per_step, rec = megastep_equals_steps(p, sync)
        rec.update(replay_checks(p, st, per_step, sync,
                                 profile=key == "scanner"))
        if key == "scanner":
            rec.update(megastep_rates(p, 8, 3, sync, timed_s=(1, MEGA_S)))
            bench["megastep_op_scanner"] = rec
        del p
    t_f = time.perf_counter()
    log("  (f) the driver on the op engine: checkpoint, stop, resume (K=40)")
    reset_launches()
    phase_driver_checkpoint(dev, 40, 4, **OP)
    check_launches({}, "the op driver")
    log("  (g) apps/record on its default engine")
    record_app(dev)
    log(f"  phase 19 took {time.perf_counter() - t0:.1f} s ((a) "
        f"{t_b - t0:.1f}, (b) {t_c - t_b:.1f}, (c) {t_d - t_c:.1f}, (d) "
        f"{t_e - t_d:.1f}, (e) {t_f - t_e:.1f}, (f)-(g) "
        f"{time.perf_counter() - t_f:.1f})")
    return bench


# --------------------------------------------------- phase 20: the export
#: (name, export_chain argv, the launches one step of its artifact makes)
#: of each artifact of phase 20: BASELINE configs 2, 4, 3 (dsd on the
#: cf32 wire that JAX's cu8 mapping gives) and 1, and the op scanner
EXPORTS = (
    ("config 2", ["--config", "scanner", "-k", "40", "--input-format",
                  "cu8"], {"duo": 1, "audio_bank": 1}),
    ("config 4", ["--config", "scanner", "-k", "40", "--input-format", "cu8",
                  "-w", "80"], {"duo": 1, "audio_bank": 1, "waterfall": 1}),
    ("config 3", ["--config", "dsd", "-k", "16", "--input-format", "cu8"],
     {"chan_tail": 1}),
    ("config 1", ["--config", "single", "-k", "16", "--channel", "5"],
     {"chan_tail": 1}),
    ("op scanner", ["--config", "scanner", "-k", "40", "--input-format",
                    "cu8", "--engine", "op"], {}),
)
#: blocks each artifact runs from the live chain's state after block 0
EXPORT_BLOCKS = 4
#: K of 20(b)'s chains exported before their first step
EXPORT_BEFORE_K = 4
#: calls a timed batch of phase 20's host-cost measure makes, and batches
EXPORT_CALLS, EXPORT_BATCHES = 50, 7


def export_blocks(ns) -> list:
    """1 + EXPORT_BLOCKS distinct blocks of an artifact's config: phase 4's
    cu8 blocks (scanner), the FM tone (dsd) or channel 5 (single) on the
    cf32 wire."""
    k = ns.subchunks_per_step
    if ns.config == "scanner":
        return bench_blocks(k, 1 + EXPORT_BLOCKS)
    return chain_blocks(ns.config, k, 1 + EXPORT_BLOCKS, "cf32")


def step_leaves(step, state, blocks, rest) -> list:
    """(state, outputs) leaves of ``step`` over ``blocks`` from ``state``,
    one list a block, on the host."""
    import torch.utils._pytree as pytree
    out = []
    for blk in blocks:
        state, o = step(state, blk, *rest)
        out.append([t.cpu() for t in pytree.tree_leaves((state, o))])
    return out


def export_child(spec_path: str) -> int:
    """Phase 20's fresh process: imports sdr_pmr446_tpu_torch.apps.
    export_chain and nothing else of the package, loads each artifact,
    runs it over its blocks from the given state (launch counts read),
    then times it at S = 1 in turns with the live chain that
    export_chain.build_chain builds (loaded, live, live, loaded).  Prints
    one JSON report; fails on a weights_only fallback of torch.export.load
    or a module of JAX or of the JAX package."""
    import logging
    import torch
    fallbacks = []

    class Keep(logging.Handler):
        def emit(self, record):
            if "weights_only" in str(record.msg):
                fallbacks.append(str(record.msg))

    logging.getLogger("torch._export.serde.serialize").addHandler(Keep())
    t0 = time.perf_counter()
    from sdr_pmr446_tpu_torch.apps import export_chain as E
    report = {"import_s": time.perf_counter() - t0, "cases": {}}
    kernels = [m for n, m in sys.modules.items()
               if n.startswith("sdr_pmr446_tpu_torch.kernels.")]
    with open(spec_path) as f:
        spec = json.load(f)
    dev = torch.device("cuda", 0)
    for case in spec:
        t = time.perf_counter()
        step = E.load(case["path"])
        torch.cuda.synchronize(dev)
        load_s = time.perf_counter() - t
        ns = E.build_parser().parse_args(case["argv"] + ["--out", "-"])
        chain, args = E.build_chain(ns)
        inp = torch.load(case["inputs"])
        state0 = type(args[0])(*(v.to(dev) for v in inp["state"]))
        blocks = [b.to(dev) for b in inp["blocks"]]
        rest = args[2:]
        chain.step(state0, blocks[0], *rest)        # the live chain warm
        for mod in kernels:
            for name in vars(mod):
                if name.endswith("LAUNCHES"):
                    setattr(mod, name, 0)
        leaves = step_leaves(step, state0, blocks, rest)
        torch.cuda.synchronize(dev)
        launches = {f"{m.__name__.split('.')[-1]}"
                    + ("" if name == "LAUNCHES" else f".{name}"): v
                    for m in kernels for name, v in vars(m).items()
                    if name.endswith("LAUNCHES") and v}
        torch.save(leaves, case["outputs"])
        n_samp = len(blocks) * ns.subchunks_per_step * E.C.SUBCHUNK_IN
        rates = {"loaded": [], "live": []}
        for who in ("loaded", "live", "live", "loaded"):
            fn = step if who == "loaded" else chain.step
            st = state0
            torch.cuda.synchronize(dev)
            t = time.perf_counter()
            for blk in blocks:
                st, _ = fn(st, blk, *rest)
            torch.cuda.synchronize(dev)
            rates[who].append(n_samp / (time.perf_counter() - t) / 1e6)
        report["cases"][case["name"]] = {
            "load_s": load_s, "launches": launches, "msamples_per_s": rates,
            "nodes": sum(n.op == "call_function" for n in step.graph.nodes)}
    report["fallbacks"] = fallbacks
    report["foreign"] = sorted(
        n for n in sys.modules if n in ("jax", "sdr_pmr446_tpu")
        or n.startswith(("jax.", "sdr_pmr446_tpu.")))
    report["tf32"] = [torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32]
    print(json.dumps(report))
    return 0 if not (fallbacks or report["foreign"]
                     or any(report["tf32"])) else 1


def op_call_args(dev) -> dict:
    """{kernel: (custom op, its registered CUDA implementation, arguments)}
    at the main paths' shapes: K1 and K2 at K = 40 on phase 4's block, K3
    at w = 80 on K1's band, K4 (dsd) at K = 16 on the cf32 wire."""
    import torch
    from sdr_pmr446_tpu_torch import config as C
    from sdr_pmr446_tpu_torch.kernels import (audio_bank, chan_tail, duo,
                                              waterfall)
    from sdr_pmr446_tpu_torch.scanner.chain import ScannerChain
    from sdr_pmr446_tpu_torch.scanner.dsd_in import DsdInChain
    chain = ScannerChain(C.BlockConfig(40), device=dev, waterfall=80)
    st = chain.init_state()
    wire = torch.from_numpy(bench_block(40, 0)).to(dev)
    d, b = chain.duo, chain.audio_bank
    duo_args = (wire, st.dc_x, st.dc_y, st.resamp_hist, st.pfb_hist,
                st.frame_parity, st.demod_prev, d.front.kt, d.front.pj,
                d.pfb.pfb_g, d.pfb.pfb_c, d.pfb.pfb_w, "cu8", NS)
    o = d(*duo_args[:7], ns=NS)
    k = 40
    sel = torch.full((k,), 4, dtype=torch.int32, device=dev)
    b_arr = torch.full((k,), NS - 1, dtype=torch.int32, device=dev)
    bank_args = (st.audio_hist, st.lp_dc_x, st.lp_dc_y, o.demod,
                 torch.tensor(1.0, device=dev), b_arr, sel, b.taps_staged,
                 b.taps_audio, b.taps_lp, b.pj, b.f10, NS)
    p = chain.wf.plan
    wf_args = (o.band, st.pfb_hist, st.wf_cnt, chain.wf.pre, chain.wf.filt,
               chain.wf.tw, p.w, p.m, p.m1, p.nt)
    dsd = DsdInChain(16, input_format="cf32", device=dev)
    m, ds = dsd.kernels, dsd.init_state()
    mono_args = (torch.from_numpy(chain_blocks("dsd", 16, 1, "cf32")[0]).to(
        dev), *ds, None, m.front.kt, m.front.pj, m.tail.kd_staged, None,
        m.tail.post_staged, "cf32", "dsd", 0, 1.0)
    return {"duo": (duo.duo_op, duo._duo_cuda, duo_args),
            "audio_bank": (audio_bank.audio_bank_op,
                           audio_bank._audio_bank_cuda, bank_args),
            "waterfall": (waterfall.waterfall_op, waterfall._waterfall_cuda,
                          wf_args),
            "chan_tail": (chan_tail.mono_op, chan_tail._mono_cuda,
                          mono_args)}


def host_us(fn, args, sync) -> float:
    """Median host microseconds a call of ``fn`` takes to return, over
    EXPORT_BATCHES batches of EXPORT_CALLS calls (the card drained between
    batches, not inside one)."""
    per = []
    for _ in range(EXPORT_BATCHES):
        sync()
        t = time.perf_counter()
        for _ in range(EXPORT_CALLS):
            fn(*args)
        per.append((time.perf_counter() - t) / EXPORT_CALLS * 1e6)
    sync()
    return statistics.median(per)


def op_overhead(dev, sync) -> dict:
    """20(c): the host microseconds a call through each custom op takes
    beside a direct call of its CUDA implementation (the ctypes launch),
    in turns (op, direct, direct, op); outputs equal bit for bit."""
    out = {}
    for name, (op, direct, args) in op_call_args(dev).items():
        check_bits(op(*args), direct(*args), f"20(c) {name} op vs direct")
        t = {"op": [], "direct": []}
        for who in ("op", "direct", "direct", "op"):
            t[who].append(host_us(op if who == "op" else direct, args, sync))
        op_us, direct_us = min(t["op"]), min(t["direct"])
        out[name] = {"op_us": t["op"], "direct_us": t["direct"],
                     "added_us": op_us - direct_us}
        log(f"  (c) {name}: a call through the op {t['op'][0]:.1f} / "
            f"{t['op'][1]:.1f} us of host, the direct launch "
            f"{t['direct'][0]:.1f} / {t['direct'][1]:.1f} us: the op adds "
            f"{op_us - direct_us:.1f} us (best of each)")
    return out


def phase_export(dev, sync, smi: str) -> dict:
    """Phase 20: apps/export_chain on the card.  Each artifact of EXPORTS
    is exported through export_chain.main (--device at its default),
    saved, then loaded and run in a fresh process (export_child) over
    EXPORT_BLOCKS distinct blocks from the live chain's state after block
    0: outputs and state bit-equal to the live chain's, its kernels one
    launch a step (K1 and K2; K3 under -w; K4 for dsd and single; none on
    the op engine), no weights_only fallback, no JAX, TF32 off; its
    Msamples/s at S = 1 in turns with the live chain's.  (b) a chain
    exported before any live step steps as one never exported (the
    kernel and the op scanner at K = EXPORT_BEFORE_K).  (c) the host
    cost of the custom ops."""
    import os
    import tempfile
    import torch
    from sdr_pmr446_tpu_torch.apps import export_chain as E
    t_start = time.perf_counter()
    bench = {}
    with tempfile.TemporaryDirectory() as tmp:
        spec, wants = [], {}
        for i, (name, argv, per_step) in enumerate(EXPORTS):
            path = os.path.join(tmp, f"a{i}.pt2")
            ns = E.build_parser().parse_args(argv + ["--out", path])
            reset_launches()
            t = time.perf_counter()
            rc = E.main(argv + ["--out", path])
            export_s = time.perf_counter() - t
            check(rc == 0, f"20 {name}: export_chain exit {rc}")
            check_launches({}, f"20 {name}'s export")
            ref, args = E.build_chain(ns)
            blocks = [torch.from_numpy(b).to(dev) for b in export_blocks(ns)]
            state0, _ = ref.step(args[0], blocks[0], *args[2:])
            wants[name] = step_leaves(ref.step, state0, blocks[1:], args[2:])
            if name in ("config 2", "op scanner"):
                # (b) exported before it ever stepped, at a small K (a K =
                # 40 scanner's trace takes 10-30 s)
                small = E.build_parser().parse_args(
                    argv + ["-k", str(EXPORT_BEFORE_K), "--out", path])
                fresh, fresh_args = E.build_chain(small)
                E.export_step(fresh, fresh_args)
                never, never_args = E.build_chain(small)
                blk = [torch.from_numpy(export_blocks(small)[0]).to(dev)]
                check_bits(tuple(step_leaves(fresh.step, fresh_args[0], blk,
                                             fresh_args[2:])[0]),
                           tuple(step_leaves(never.step, never_args[0], blk,
                                             never_args[2:])[0]),
                           f"20(b) {name} exported before its first step")
                log(f"  (b) {name} at K = {EXPORT_BEFORE_K}: a chain exported "
                    f"before its first step steps bit for bit as one never "
                    f"exported")
            inputs = os.path.join(tmp, f"in{i}.pt")
            torch.save({"state": [v.cpu() for v in state0],
                        "blocks": [b.cpu() for b in blocks[1:]]}, inputs)
            spec.append({"name": name, "argv": argv, "path": path,
                         "inputs": inputs,
                         "outputs": os.path.join(tmp, f"out{i}.pt"),
                         "per_step": per_step})
            bench[name] = {"export_s": export_s,
                           "bytes": os.path.getsize(path)}
            log(f"  (a) {name}: exported in {export_s:.2f} s, "
                f"{bench[name]['bytes']} bytes")
            del ref, args, blocks, state0
        spec_path = os.path.join(tmp, "spec.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        t = time.perf_counter()
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--export-child", spec_path],
                             capture_output=True, text=True, timeout=600)
        child_s = time.perf_counter() - t
        if res.returncode != 0:
            log(res.stdout[-4000:])
            log(res.stderr[-4000:])
        check(res.returncode == 0, f"20 the fresh process exit "
              f"{res.returncode}")
        report = json.loads(res.stdout.strip().splitlines()[-1])
        log(f"  (a) the fresh process: {child_s:.1f} s, export_chain "
            f"imported in {report['import_s']:.2f} s, no weights_only "
            f"fallback, no JAX module, TF32 off ({report['tf32']})")
        for case in spec:
            name = case["name"]
            got = torch.load(case["outputs"])
            for b, (g, w) in enumerate(zip(got, wants[name])):
                check(len(g) == len(w), f"20 {name} block {b} leaves")
                for j, (gl, wl) in enumerate(zip(g, w)):
                    check(gl.shape == wl.shape and gl.dtype == wl.dtype
                          and torch.equal(bits(gl), bits(wl)),
                          f"20 {name} block {b} leaf {j} differs")
            r = report["cases"][name]
            want = {k: n * EXPORT_BLOCKS for k, n in case["per_step"].items()}
            check(r["launches"] == want, f"20 {name}: the loaded program "
                  f"launched {r['launches']}, expected {want}")
            rates = r["msamples_per_s"]
            bench[name].update(load_s=r["load_s"], launches=r["launches"],
                               msamples_per_s=rates, nodes=r["nodes"])
            log(f"  (a) {name}: loaded in {r['load_s']:.2f} s, {len(got)} "
                f"blocks bit-equal to the live chain, launches "
                f"{r['launches'] or 'none'}, {r['nodes']} graph calls a "
                f"step; Msamples/s at S = 1 loaded "
                f"{rates['loaded'][0]:.1f} / {rates['loaded'][1]:.1f}, live "
                f"{rates['live'][0]:.1f} / {rates['live'][1]:.1f}")
    log(f"  {smi}")
    reset_launches()
    bench["op_overhead"] = op_overhead(dev, sync)
    reset_launches()
    log(f"  phase 20 took {time.perf_counter() - t_start:.1f} s")
    return bench


# ------------------------------------------- phase 21: two ranks on one card
#: 21(b) and (c): (mesh, K, constructor keywords) of the chains that two
#: ranks split in time (each rank 1 stream x 2 time shards): the duo at K
#: = 32 (K_local = 8, K10's fold across the ranks) and the plane path with
#: K11 at K = 40 (K_local = 10)
DIST_CHAINS = {"duo": ((1, 4), 32, {}),
               "plane": ((1, 4), 40, {"halo_dma": True})}
#: blocks each case steps (config5_streams' stream 0), and timed repeats
DIST_BLOCKS, DIST_REPS = 4, 2
#: the launches one step of a rank's block makes on each case
DIST_PER_STEP = {"duo": {"duo": 2, "audio_bank": 2, "summary": 1},
                 "plane": {"resample_kernel": 2, "pfb_demod": 2,
                           "audio_bank.APPLY_LAUNCHES": 2, "halo_dma": 2}}
#: seconds a rank process may take, and its process group's timeout
DIST_CHILD_S, DIST_GROUP_S = 600, 180


def dist_batch_argv(paths) -> list:
    """21(a): config 5 through scan_batch: 4 cu8 captures, --mesh 4,5, K =
    40, --device-decode, one block a dispatch (its wall is then steps,
    reads, uploads and drains, with no graph capture)."""
    return paths + ["--subchunks-per-step", str(BATCH_K), "--mesh", "4,5",
                    "--device-decode"]


def dist_wires(k: int) -> list:
    """The [1, bytes] cu8 blocks of 21(b) / (c) on the host."""
    return [np.stack(blk) for blk in zip(*config5_streams(1, k,
                                                          DIST_BLOCKS))]


def timed_steps(chain, wires, params, sync) -> dict:
    """DIST_REPS runs of ``chain`` over ``wires`` (on the device) from its
    zero state: host ms a block of each (synchronized around the run),
    the CUDA events' ms, and the host seconds of the host-staged
    collectives (parallel/distributed.py STATS) in each."""
    import torch
    from sdr_pmr446_tpu_torch.parallel import distributed
    out = {"ms_a_block": [], "event_ms_a_block": [], "stage_s": [],
           "collective_s": [], "collectives": []}
    for _ in range(DIST_REPS):
        st = chain.init_state()
        distributed.sync("timed")
        sync()
        distributed.reset_stats()
        ev0, ev1 = torch.cuda.Event(True), torch.cuda.Event(True)
        t0 = time.perf_counter()
        ev0.record()
        for w in wires:
            st, o = chain.step(st, w, params)
        ev1.record()
        sync()
        wall = time.perf_counter() - t0
        out["ms_a_block"].append(wall * 1e3 / len(wires))
        out["event_ms_a_block"].append(ev0.elapsed_time(ev1) / len(wires))
        out["stage_s"].append(distributed.STATS["stage_s"])
        out["collective_s"].append(distributed.STATS["collective_s"])
        out["collectives"].append(distributed.STATS["calls"])
        out.setdefault("wall_s", []).append(wall)
    return out


def dist_child(spec_path: str, rank: int) -> int:
    """Phase 21's rank process (``chip_smoke.py --dist-child SPEC RANK``):
    joins the two-rank gloo group on cuda:0, runs 21(a) through
    scan_batch.main, then 21(b) and (c) on its block of the global mesh
    (launch counts set to 0 just before each and read just after), saves
    rank 0's gathered outputs and state, and times its block.  Prints one
    JSON report."""
    import torch
    from sdr_pmr446_tpu_torch import config as C
    from sdr_pmr446_tpu_torch.apps import scan_batch
    from sdr_pmr446_tpu_torch.parallel import distributed
    from sdr_pmr446_tpu_torch.parallel.scanner_sharded import (
        ShardedScannerChain)
    from sdr_pmr446_tpu_torch.scanner.chain import make_runtime_params
    with open(spec_path) as f:
        spec = json.load(f)
    t0 = time.perf_counter()
    distributed.initialize(spec["addr"], 2, rank, timeout_s=DIST_GROUP_S)
    report = {"rank": rank, "join_s": time.perf_counter() - t0, "cases": {}}

    def batch(out_dir: str):
        stats = {}
        rc = scan_batch.main(spec["batch_argv"] + [
            "--out-dir", out_dir, "--coordinator", spec["addr"],
            "--num-processes", "2", "--process-id", str(rank), "--device",
            "cuda"], stats)
        torch.cuda.synchronize()
        return rc, stats

    reset_launches()
    distributed.reset_stats()
    rc, stats = batch(spec["out"][rank])
    report["batch"] = {"rc": rc, "stats": stats, "launches": {
        n: v for n, v in launches_now().items() if v},
        "collectives": dict(distributed.STATS)}
    # timed runs, the process warm (the first run above holds its first
    # CUDA work: library and handle set-up)
    timed = [batch(f"{spec['out'][rank]}_t{i}") for i in range(DIST_REPS)]
    report["batch"]["timed_rcs"] = [rc for rc, _ in timed]
    report["batch"]["walls"] = [st["wall_s"] for _, st in timed]
    sync = torch.cuda.synchronize
    for name, (mesh, k, kw) in DIST_CHAINS.items():
        gm = distributed.global_mesh(*mesh, "cuda")
        chain = ShardedScannerChain(gm, C.BlockConfig(k), device=gm.device,
                                    **kw)
        params = make_runtime_params(C.ScannerArgs(), gm.device)
        wires = [distributed.make_global_array(gm, w, sharded_time=True)
                 for w in dist_wires(k)]
        chain.step(chain.init_state(), wires[0], params)   # tables, warm
        sync()
        reset_launches()
        st, outs = chain.init_state(), []
        for w in wires:
            st, o = chain.step(st, w, params)
            outs.append(o)
        sync()
        launches = {n: v for n, v in launches_now().items() if v}
        gathered = [[t.cpu() for t in distributed.process_allgather(
            list(o), gm, time_axis=1)] for o in outs]
        state = [t.cpu() for t in distributed.gather_state(gm, st)]
        if rank == 0:
            torch.save({"outs": gathered, "state": state},
                       spec["chains"][name])
        report["cases"][name] = {
            "block": [gm.stream0, gm.n_stream, gm.time0, gm.n_time],
            "device": str(gm.device), "engine": chain.engine_label,
            "launches": launches,
            "timing": timed_steps(chain, wires, params, sync)}
    distributed.sync("end")
    distributed.shutdown()
    print(json.dumps(report))
    return 0


def phase_distributed(dev, sync, smi: str) -> dict:
    """Phase 21: two rank processes on the one card (gloo over localhost,
    the halos staged through the host).  (a) config 5 through scan_batch
    (a stream split: each rank 2 captures x 5 time shards) against the
    one-process run on the card: rank 0's WAVs byte-equal, its event logs
    equal, rank 1 writing nothing; (b) the duo and (c) the plane path with
    K11 split in time over the ranks against the one-process chain on the
    same mesh; (d) each rank's launches = per-step x steps of its block;
    (e) ms a block and Msamples/s beside the one-process run's, with the
    share of the host-staged collectives."""
    import os
    import tempfile
    import torch
    from sdr_pmr446_tpu_torch import config as C
    from sdr_pmr446_tpu_torch.parallel.scanner_sharded import (
        ShardedScannerChain, make_mesh)
    from sdr_pmr446_tpu_torch.scanner.chain import (StepOutputs,
                                                    make_runtime_params)
    t_start = time.perf_counter()
    bench = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths = batch_captures(tmp)[:4]
        one = os.path.join(tmp, "one")
        argv = dist_batch_argv(paths)
        l_one, _, run_one = run_scan_batch(dev, argv + ["--out-dir", one])
        one_walls = [run_scan_batch(dev, argv + ["--out-dir", f"{one}_t{i}"])
                     [2]["wall_s"] for i in range(DIST_REPS)]
        params = make_runtime_params(C.ScannerArgs(), dev)
        refs = {}
        for name, (mesh, k, kw) in DIST_CHAINS.items():
            chain = ShardedScannerChain(make_mesh(*mesh, dev),
                                        C.BlockConfig(k), device=dev, **kw)
            wires = [torch.as_tensor(w, device=dev) for w in dist_wires(k)]
            st, outs = run_sharded(chain, wires, params)
            refs[name] = ([[t.cpu() for t in o] for o in outs],
                          [t.cpu() for t in st],
                          timed_steps(chain, wires, params, sync))
            del chain
        spec = {"addr": free_address(), "batch_argv": argv,
                "out": [os.path.join(tmp, f"rank{r}") for r in range(2)],
                "chains": {n: os.path.join(tmp, f"{n}.pt")
                           for n in DIST_CHAINS}}
        spec_path = os.path.join(tmp, "dist.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        t = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dist-child",
             spec_path, str(r)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=DIST_CHILD_S))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        child_s = time.perf_counter() - t
        for r, (p, (out, err)) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                log(out[-3000:])
                log(err[-6000:])
            check(p.returncode == 0, f"21 rank {r} exited {p.returncode}")
        reports = [json.loads(out.strip().splitlines()[-1])
                   for out, _ in logs]
        log(f"  two rank processes on {torch.cuda.get_device_name(0)} "
            f"(both on cuda:0), {child_s:.1f} s; joined in "
            f"{reports[0]['join_s']:.2f} / {reports[1]['join_s']:.2f} s")
        for err in (logs[0][1], logs[1][1]):
            for line in err.splitlines():
                if "shared with process" in line or "as a loop" in line:
                    log(f"    {line.split('] ')[-1]}")

        # (a) config 5 through scan_batch
        for r, rep in enumerate(reports):
            rcs = [rep["batch"]["rc"]] + rep["batch"]["timed_rcs"]
            check(rcs == [0] * len(rcs), f"21(a) rank {r} scan_batch exits "
                  f"{rcs}")
        stems = [os.path.splitext(os.path.basename(p))[0] for p in paths]
        for stem in stems:
            for ext in ("wav", "events.log"):
                got = open(os.path.join(spec["out"][0], f"{stem}.{ext}"),
                           "rb").read()
                want = open(os.path.join(one, f"{stem}.{ext}"), "rb").read()
                check(got == want, f"21(a) rank 0's {stem}.{ext} differs "
                      f"from the one-process run's")
        check(os.listdir(spec["out"][1]) == [], "21(a) rank 1 wrote files")
        steps = BATCH_BLOCKS
        want_a = {"duo": 2 * 5 * steps, "audio_bank": 2 * 5 * steps,
                  "summary": steps}
        for r, rep in enumerate(reports):
            check(rep["batch"]["launches"] == want_a, f"21(d) rank {r} (a) "
                  f"launched {rep['batch']['launches']}, expected {want_a}")
        check(l_one == {**{n: 0 for n in l_one}, "duo": 4 * 5 * steps,
                        "audio_bank": 4 * 5 * steps, "summary": steps},
              f"21(a) one-process launches {l_one}")
        samples = 4 * steps * BATCH_K * C.SUBCHUNK_IN
        walls = [rep["batch"]["walls"] for rep in reports]
        firsts = [rep["batch"]["stats"]["wall_s"] for rep in reports]
        bench["a"] = {"one_process_wall_s": one_walls,
                      "one_process_first_wall_s": run_one["wall_s"],
                      "rank_wall_s": walls, "rank_first_wall_s": firsts,
                      "rank_collectives": [rep["batch"]["collectives"]
                                           for rep in reports],
                      "graphs": [rep["batch"]["stats"]["graphs"]
                                 for rep in reports]}
        log(f"  (a) config 5 through scan_batch (--mesh 4,5, K = {BATCH_K}, "
            f"cu8 --device-decode, S = 1, {steps} blocks of 4 "
            f"captures): rank 0's WAVs byte-equal and events equal to the "
            f"one-process run's, rank 1 wrote nothing; launches a rank "
            f"{want_a}, graphs {bench['a']['graphs']}")
        ms = lambda w: " / ".join(f"{v * 1e3 / steps:.2f}" for v in w)  # noqa
        slow = [max(a, b) for a, b in zip(*walls)]
        log(f"  (e) (a), the wall of a run with reads, uploads and drains (a "
            f"rank's: process_allgather of the outputs), {DIST_REPS} runs: "
            f"one process {ms(one_walls)} ms a block "
            f"({samples / min(one_walls) / 1e6:.1f} Msamples/s at best), two "
            f"ranks {ms(walls[0])} and {ms(walls[1])} ms a block "
            f"({samples / min(slow) / 1e6:.1f} Msamples/s at best over the "
            f"slower rank); the first run of each process, not timed above: "
            f"one process {ms([run_one['wall_s']])} (its chain new, the "
            f"process warm), ranks {ms(firsts)} (the first CUDA work of the "
            f"process inside)")

        # (b), (c): the time splits against the one-process chain
        for name, (mesh, k, kw) in DIST_CHAINS.items():
            got = torch.load(spec["chains"][name])
            want_outs, want_state, one_t = refs[name]
            exact = True
            for g, w in zip(got["outs"], want_outs):
                exact &= all(torch.equal(bits(a), bits(b))
                             for a, b in zip(g, w))
            state_exact = all(torch.equal(bits(a), bits(b))
                              for a, b in zip(got["state"], want_state))
            summary = check_sharded(
                [StepOutputs(*g) for g in got["outs"]],
                [StepOutputs(*w) for w in want_outs], f"21 {name}")
            case = "b" if name == "duo" else "c"
            log(f"  ({case}) the {reports[0]['cases'][name]['engine']} at "
                f"{mesh}, K = {k}{', halo_dma' if kw else ''}, over two "
                f"ranks (blocks {reports[0]['cases'][name]['block']} / "
                f"{reports[1]['cases'][name]['block']}): "
                f"{'outputs bit-equal' if exact else summary}, state "
                f"{'bit-equal' if state_exact else 'not bit-equal'} to the "
                f"one-process chain's")
            per = DIST_PER_STEP[name]
            want = {n: v * DIST_BLOCKS for n, v in per.items()}
            for r, rep in enumerate(reports):
                got_l = rep["cases"][name]["launches"]
                check(got_l == want, f"21(d) rank {r} {name} launched "
                      f"{got_l}, expected {want}")
            log(f"  (d) ({case}) launches a rank over {DIST_BLOCKS} steps: "
                f"{want}")
            n = DIST_BLOCKS * k * C.SUBCHUNK_IN
            tim = [rep["cases"][name]["timing"] for rep in reports]
            rank_ms = [max(a, b) for a, b in zip(tim[0]["ms_a_block"],
                                                 tim[1]["ms_a_block"])]
            share = [(t["collective_s"][-1] / t["wall_s"][-1],
                      t["stage_s"][-1] / t["wall_s"][-1]) for t in tim]
            bench[name] = {"exact": exact, "state_exact": state_exact,
                           "one_process": one_t, "ranks": tim}
            log(f"  (e) ({case}): one process "
                f"{' / '.join(f'{v:.2f}' for v in one_t['ms_a_block'])} ms a "
                f"block ({n / DIST_BLOCKS / min(one_t['ms_a_block']) / 1e3:.1f}"
                f" Msamples/s), two ranks "
                f"{' / '.join(f'{v:.2f}' for v in rank_ms)} ms a block "
                f"({n / DIST_BLOCKS / min(rank_ms) / 1e3:.1f} Msamples/s; "
                f"CUDA events "
                f"{tim[0]['event_ms_a_block'][-1]:.2f} / "
                f"{tim[1]['event_ms_a_block'][-1]:.2f}); "
                f"{tim[0]['collectives'][-1] // DIST_BLOCKS} host-staged "
                f"collectives a step, their gloo calls and copies back "
                f"{100 * share[0][0]:.1f} / {100 * share[1][0]:.1f} % of a "
                f"rank's step, the copies to the host (with the wait for the "
                f"device) {100 * share[0][1]:.1f} / {100 * share[1][1]:.1f} %")
        bench["scan_batch_dependence"] = scan_batch_dependence(dev)
        log("  (e) the two ranks time-share one card: these are no scaling "
            "figures; a distributed step reads the host in its host-staged "
            "collectives, so the no-host-reads checks of phases 4-19 do not "
            "apply to it")
        log(f"  {smi}")
    reset_launches()
    log(f"  phase 21 took {time.perf_counter() - t_start:.1f} s")
    return bench


def scan_batch_dependence(dev) -> dict:
    """21(f): why a time split is not bit-equal on the card: the matmul
    scan (ops/iir.first_order_scan, the DC blockers' chunked scan through
    cuBLAS) of shards 2-3 of a [1, 4, 2, T] batch alone (a rank's block)
    against the same shards in the whole batch, and the plain resampler
    (cuDNN F.conv1d) likewise; logged, not gated."""
    import torch
    from sdr_pmr446_tpu_torch import config as C
    from sdr_pmr446_tpu_torch.ops import iir
    from sdr_pmr446_tpu_torch.ops.resample import PolyResampler
    from sdr_pmr446_tpu_torch.taps import design as D
    g = torch.Generator().manual_seed(21)
    out = {}
    for t in (2560, 401408):
        x = torch.randn(1, 4, 2, t, generator=g).to(dev)
        whole = iir.first_order_scan(x, 0.9995, x.new_zeros(1, 4, 2))
        part = iir.first_order_scan(x[:, 2:], 0.9995, x.new_zeros(1, 2, 2))
        out[f"scan_{t}"] = float((whole[:, 2:] - part).abs().max())
    res = PolyResampler(D.resampler_taps(), C.RESAMP_L, C.RESAMP_M,
                        device=dev)
    x = torch.randn(1, 4, 2, 2560 - 384 + res.hist_len, generator=g).to(dev)
    _, whole = res(x[..., :res.hist_len], x[..., res.hist_len:])
    _, part = res(x[:, 2:, :, :res.hist_len], x[:, 2:, :, res.hist_len:])
    out["resampler"] = float((whole[:, 2:] - part).abs().max())
    log(f"  (f) a rank's shards alone vs in the one-process batch, max|diff| "
        f"of unit-variance noise: the matmul scan {out['scan_2560']:.3g} "
        f"(T = 2560) / {out['scan_401408']:.3g} (T = 401408), the "
        f"resampler's conv1d {out['resampler']:.3g}")
    return out


def free_address() -> str:
    """A localhost address with a free port (the coordinator's)."""
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{sk.getsockname()[1]}"


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--export-child"]:
        return export_child(sys.argv[2])
    if sys.argv[1:2] == ["--dist-child"]:
        return dist_child(sys.argv[2], int(sys.argv[3]))
    from sdr_pmr446_tpu_torch.kernels import (audio_bank, build, chan_tail,
                                              duo, front_end, pfb_demod,
                                              resample_kernel, waterfall)
    dev = torch.device("cuda", 0)
    sync = lambda: torch.cuda.synchronize(dev)
    t_run = time.perf_counter()

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
    steps, oracle_run = phase_oracle(dev, 10, 30)
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
                            (10, 132), (10, 4096), (10, 8192), (10, 16384),
                            (2, 78400))]
    # the widest width has no plain version to time: logged, not listed
    wf_rows = [row for row in wf_rows if row["plain_ms"] is not None]
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

    t11 = time.perf_counter()
    log("phase 11: K6, K7, K9 and K5 on the card, and their paths")
    log("  (a) each kernel vs its plain version")
    new_rows = {row["name"]: row for row in phase_new_kernels(dev,
                                                              cuda_timer)}
    t11b = time.perf_counter()
    log("  (b) the trio (fuse_band=False) and fuse_dc=False scanners")
    kernel_mods = (duo, audio_bank, front_end, pfb_demod, resample_kernel)
    for mod in kernel_mods:
        mod.LAUNCHES = 0
    esteps, ebench = phase_trio(dev, oracle_run, sync)
    bench.update(ebench)
    elaunch = {mod.__name__.split(".")[-1]: mod.LAUNCHES
               for mod in kernel_mods}
    log(f"  launches over the engines' steps {esteps}: {elaunch}")
    want = {"duo": esteps["duo"], "audio_bank": sum(esteps.values()),
            "front_end": esteps["trio"],
            "pfb_demod": esteps["trio"] + esteps["fuse_dc_off"],
            "resample_kernel": esteps["fuse_dc_off"]}
    for name, n in want.items():
        check(elaunch[name] == n, f"{name} launched {elaunch[name]} times "
              f"for {n} steps")
    new_rows["front_end"]["launches"] = elaunch["front_end"]
    new_rows["pfb_demod"]["launches"] = elaunch["pfb_demod"]
    new_rows["resampler"]["launches"] = elaunch["resample_kernel"]
    t11c = time.perf_counter()
    log("  (c) dsd_in and single on the two-kernel engine (mono=False), "
        "K=16 cu8")
    for mode in ("dsd", "single"):
        chan_tail.LAUNCHES = chan_tail.TAIL_LAUNCHES = front_end.LAUNCHES = 0
        tsteps, tbench = phase_two_kernel(dev, mode, 16, 4, sync)
        bench.update(tbench)
        tl = {"K4": chan_tail.LAUNCHES, "K5": chan_tail.TAIL_LAUNCHES,
              "K6": front_end.LAUNCHES}
        log(f"  {mode} launches over {tsteps} steps: {tl}")
        check(tl["K4"] == tsteps["mono"], f"K4 launches ({mode})")
        check(tl["K5"] == tl["K6"] == tsteps["two"],
              f"K5 / K6 launches ({mode})")
        new_rows[f"chan_tail_{mode}"]["launches"] = tl["K5"]
    rows += list(new_rows.values())
    t12 = time.perf_counter()
    log(f"  phase 11 took {t12 - t11:.1f} s ((a) {t11b - t11:.1f}, (b) "
        f"{t11c - t11b:.1f}, (c) {t12 - t11c:.1f})")

    log("phase 12: K8 and the scanner's op-path switches")
    log("  (a) K8 (apply, apply_dc) vs its plain versions")
    k8_rows = k8_case(dev, 40, cuda_timer)
    k8_case(dev, 10, cuda_timer)
    t12b = time.perf_counter()
    log("  (b) the switched engines (fuse_ctcss / fuse_lp_dc / fuse_rssi "
        "= False)")
    for mod in kernel_mods:
        mod.LAUNCHES = 0
    audio_bank.APPLY_LAUNCHES = audio_bank.APPLY_DC_LAUNCHES = 0
    ssteps, sbench = phase_switches(dev, oracle_run, sync)
    bench.update(sbench)
    sl = {"K1": duo.LAUNCHES, "K2": audio_bank.LAUNCHES,
          "K8 apply": audio_bank.APPLY_LAUNCHES,
          "K8 apply_dc": audio_bank.APPLY_DC_LAUNCHES,
          "K6": front_end.LAUNCHES, "K7": pfb_demod.LAUNCHES,
          "K9": resample_kernel.LAUNCHES}
    log(f"  (c) launches over the engines' steps {ssteps}: {sl}")
    want = {"K1": 0, "K2": ssteps["trio"], "K8 apply": ssteps["lp_dc_off"],
            "K8 apply_dc": ssteps["ctcss_off"] + ssteps["rssi_off"],
            "K6": sum(ssteps.values()), "K7": sum(ssteps.values()), "K9": 0}
    for name, n in want.items():
        check(sl[name] == n, f"{name} launched {sl[name]} times for {n} "
              f"steps")
    k8_rows[0]["launches"] = sl["K8 apply"]
    k8_rows[1]["launches"] = sl["K8 apply_dc"]
    # K6 and K7 run on both paths: phase 11(b)'s launches and these
    new_rows["front_end"]["launches"] += sl["K6"]
    new_rows["pfb_demod"]["launches"] += sl["K7"]
    rows += k8_rows
    t13 = time.perf_counter()
    log(f"  phase 12 took {t13 - t12:.1f} s ((a) {t12b - t12:.1f}, (b) "
        f"and (c) {t13 - t12b:.1f})")

    log("phase 13: the time-sharded chains on a one-card mesh (K10, K11)")
    sharded_rows, sbench = phase_sharded(dev, sync, cuda_timer)
    bench.update(sbench)
    rows += sharded_rows

    t14 = time.perf_counter()
    log("phase 14: K12, the layout and f32-contraction probes")
    rows += phase_probes(dev, cuda_timer)
    t15 = time.perf_counter()
    from sdr_pmr446_tpu_torch.kernels import halo_dma, summary
    kernel_mods = (duo, audio_bank, front_end, pfb_demod, resample_kernel,
                   chan_tail, waterfall, summary, halo_dma)
    for mod in kernel_mods:
        mod.LAUNCHES = 0
    log("phase 15: faithful mode (K=10) vs the oracle and the CPU run")
    bench.update(phase_faithful(dev, 10, sync))
    fl = {mod.__name__.split(".")[-1]: mod.LAUNCHES for mod in kernel_mods}
    log(f"  kernel launches over faithful mode: {fl}")
    check(not any(fl.values()), "faithful mode launched a kernel")
    t16 = time.perf_counter()
    log("phase 16: the driver's metrics, checkpoint, stop and resume "
        "(K=40, cu8)")
    duo.LAUNCHES = audio_bank.LAUNCHES = 0
    dsteps = phase_driver_checkpoint(dev, 40, 4)
    dl = {"K1": duo.LAUNCHES, "K2": audio_bank.LAUNCHES}
    log(f"  launches over the driver's {dsteps} steps: {dl}")
    check(dl["K1"] == dl["K2"] == dsteps, "K1 / K2 launches in phase 16")
    log(f"  phases 14-16 took {time.perf_counter() - t14:.1f} s (14 "
        f"{t15 - t14:.1f}, 15 {t16 - t15:.1f}, 16 "
        f"{time.perf_counter() - t16:.1f})")
    log("phase 17: multi-block dispatch (runtime/fuse.py, CUDA graphs) on "
        "every chain")
    log(smi)
    bench.update(phase_megastep(dev, sync))
    log("phase 18: the batch server (apps/scan_batch.py), the sharded "
        "waterfall and faithful chain, live input")
    bench.update(phase_batch(dev, sync))
    log("phase 19: the op engines (engine='op') on the card")
    log(smi)
    bench.update(phase_op_engines(dev, sync, oracle_run))
    log("phase 20: AOT export (apps/export_chain.py) on the card")
    log(smi)
    bench["export"] = phase_export(dev, sync, smi)
    log("phase 21: two rank processes on the card (parallel/distributed.py, "
        "gloo, host-staged halos)")
    log(smi)
    bench["distributed"] = phase_distributed(dev, sync, smi)
    log(f"  the run {time.perf_counter() - t_run:.1f} s")
    log(smi)
    log(json.dumps({"bench": bench, "card": smi}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

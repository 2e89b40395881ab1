"""The traffic generator: a busy PMR446 band as continuous cu8 captures.

One general generator, driven by a traffic file (benchmark/traffic/*.json)
and the configuration's block geometry.  Each capture is one stretch of
radio of ``pool_blocks`` blocks of ``subchunks_per_step`` sub-chunks,
planned from ``SeedSequence([seed, capture])`` over its whole timeline,
with no regard to where blocks or dispatches begin:

  - receiver noise, complex Gaussian of ``noise_rms`` a plane (full scale 1);
  - quiet gaps: about every ``gap_every_s`` seconds (a jittered grid, give
    or take ``gap_jitter_s``) the whole band carries noise alone for
    ``gap_s`` seconds, a pause long enough for the scanner to detune;
  - ``bursts_per_s`` talk bursts a second, each on a channel drawn from
    1-16, at a level drawn from ``level_dbfs``, ``burst_s`` long, starting
    anywhere outside a gap and cut short where the next gap begins; bursts
    on one channel or on several overlap freely, and run across block and
    dispatch boundaries;
  - each burst NBFM at ``deviation_hz`` peak: ``voice_tones`` tones drawn
    from ``voice_hz`` sharing ``voice_peak`` of the deviation, plus a CTCSS
    tone of ``ctcss_amp`` drawn from the 38 (EIA/TIA-603), except in a
    share ``no_tone_share`` of the bursts.

The timeline is circular: a burst or a gap that runs past the capture's
end goes on at its start, so a capture offered again from its start after
its end has no seam.  The samples are made on the device, a block at a
time, in float64 (the carrier's phase exactly, from integer sample
indices; a burst's message from its own time), and quantized like an
RTL-SDR's 8-bit converter.  ``make_pool`` keeps every capture in host
memory, as the captures a user hands in.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from benchlib import design as D

#: a gap's first whole sub-chunk starts this long after the gap, past the
#: front end's filters' reach (the resampler and the PFB span ~2.4 ms)
QUIET_MARGIN_S = 0.005


@dataclasses.dataclass
class Plan:
    """One capture's timeline, in samples on a circle of ``n`` samples."""
    n: int
    gaps: list          # (start, length), sorted by start
    bursts: list        # (channel, start, length, amplitude, code, voice)

    def quiet_subchunks(self) -> np.ndarray:
        """Sorted indices of the sub-chunks (of the capture's n / SUBCHUNK_IN)
        that lie inside a gap, one for each gap: its first whole sub-chunk
        past the margin.  Every channel carries noise alone there."""
        sub, p = D.SUBCHUNK_IN, self.n // D.SUBCHUNK_IN
        margin = int(QUIET_MARGIN_S * D.SAMPLE_RATE)
        out = []
        for start, length in self.gaps:
            q = -(-(start + margin) // sub)
            if (q + 1) * sub > start + length:
                raise ValueError(f"gap of {length} samples holds no whole "
                                 "sub-chunk")
            out.append(q % p)
        return np.asarray(sorted(out), np.int64)


def plan(band: dict, seed: int, capture: int, n: int) -> Plan:
    """The gaps and bursts of one capture of ``n`` samples."""
    fs = D.SAMPLE_RATE
    rng = np.random.default_rng(np.random.SeedSequence([int(seed),
                                                        int(capture)]))
    n_gaps = max(1, round(n / (band["gap_every_s"] * fs)))
    grid, jit = n / n_gaps, band["gap_jitter_s"] * fs
    if 2 * jit + band["gap_s"][1] * fs >= grid:
        raise ValueError("gaps so jittered that two could overlap")
    gaps = sorted((int(i * grid + rng.uniform(-jit, jit)) % n,
                   int(rng.uniform(*band["gap_s"]) * fs))
                  for i in range(n_gaps))
    g0 = np.asarray([g[0] for g in gaps], np.int64)
    g1 = g0 + np.asarray([g[1] for g in gaps], np.int64)
    starts = np.concatenate([g0 - n, g0, g0 + n])
    ends = np.concatenate([g1 - n, g1, g1 + n])
    bursts = []
    for _ in range(round(band["bursts_per_s"] * n / fs)):
        ch = int(rng.integers(1, D.NUM_CHANNELS + 1))
        start = int(rng.integers(0, n))
        length = int(rng.uniform(*band["burst_s"]) * fs)
        amp = 10.0 ** (rng.uniform(*band["level_dbfs"]) / 20.0)
        code = (0 if rng.random() < band["no_tone_share"]
                else int(rng.integers(1, len(D.CTCSS_FREQS) + 1)))
        n_v = int(band["voice_tones"])
        voice = [(float(rng.uniform(*band["voice_hz"])),
                  band["voice_peak"] / n_v,
                  float(rng.uniform(0, 2 * math.pi))) for _ in range(n_v)]
        j = int(np.searchsorted(starts, start, "right")) - 1
        start = max(start, int(ends[j]))          # not inside a gap
        nxt = int(starts[np.searchsorted(starts, start, "right")])
        length = min(length, nxt - start)         # cut where a gap begins
        bursts.append((ch, start % n, length, amp, code, voice))
    return Plan(n, gaps, bursts)


def _noise_seed(seed: int, capture: int, block: int) -> int:
    s = np.random.SeedSequence([int(seed), int(capture), 1, int(block)])
    hi, lo = (int(v) for v in s.generate_state(2, np.uint32))
    return ((hi & 0x7FFFFFFF) << 32) | lo


def by_block(p: Plan, n_blk: int) -> list:
    """The bursts that reach into each block of ``n_blk`` samples."""
    blocks = p.n // n_blk
    out: list = [[] for _ in range(blocks)]
    for burst in p.bursts:
        start, length = burst[1], burst[2]
        for j in range(start // n_blk, (start + length - 1) // n_blk + 1):
            out[j % blocks].append(burst)
    return out


def make_block(band: dict, p: Plan, bursts: list, seed: int, capture: int,
               block: int, n_blk: int, device) -> torch.Tensor:
    """Samples [block n_blk, (block + 1) n_blk) of the capture planned by
    ``p``, as cu8 bytes, uint8 [2 n_blk] on ``device``; ``bursts``: the
    plan's bursts, or those of them that reach into the block
    (``by_block``)."""
    a, b = block * n_blk, (block + 1) * n_blk
    gen = torch.Generator(device=device)
    gen.manual_seed(_noise_seed(seed, capture, block))
    x = torch.randn(2, n_blk, generator=gen, device=device,
                    dtype=torch.float64)
    x *= band["noise_rms"]
    fs, dev = float(D.SAMPLE_RATE), band["deviation_hz"]
    for ch, start, length, amp, code, voice in bursts:
        # the burst on the circle's unwrapped line: [start, start + length);
        # its part past n is the block's [a + n, b + n)
        for shift in (0, p.n):
            lo, hi = max(start, a + shift), min(start + length, b + shift)
            if lo >= hi:
                continue
            idx = torch.arange(lo, hi, device=device)
            # carrier offset (2 ch - 17) 6250 Hz = (2 ch - 17) 25 / 4096
            # cycles a sample: the phase exact modulo 2 pi
            cyc = (idx * ((2 * ch - 17) * 25)) % 4096
            phase = cyc.to(torch.float64) * (2 * math.pi / 4096)
            t = (idx - start).to(torch.float64) / fs
            msg = torch.zeros_like(t)
            tones = list(voice)
            if code:
                tones.append((D.CTCSS_FREQS[code - 1], band["ctcss_amp"],
                              0.0))
            for f, amp_f, ph in tones:
                # the integral of amp_f sin(2 pi f t + ph)
                msg -= amp_f * torch.cos(2 * math.pi * f * t + ph) / (
                    2 * math.pi * f)
            phase += 2 * math.pi * dev * msg
            at = slice(lo - shift - a, hi - shift - a)
            x[0, at] += amp * torch.cos(phase)
            x[1, at] += amp * torch.sin(phase)
    q = torch.clamp(torch.round(x * 127.5 + 127.5), 0, 255).to(torch.uint8)
    return q.T.contiguous().reshape(-1)


def make_pool(band: dict, seed: int, captures: int, pool_blocks: int,
              n_sub: int, device) -> tuple:
    """(uint8 [pool_blocks, captures, 2 n] in host memory, [Plan] a
    capture): step j of every capture is one contiguous row, as a batch
    reader hands it over."""
    n_blk = n_sub * D.SUBCHUNK_IN
    plans = [plan(band, seed, c, pool_blocks * n_blk)
             for c in range(captures)]
    index = [by_block(p, n_blk) for p in plans]
    pool = np.empty((pool_blocks, captures, 2 * n_blk), np.uint8)
    host = torch.from_numpy(pool)
    for j in range(pool_blocks):
        for c in range(captures):
            host[j, c].copy_(make_block(band, plans[c], index[c][j], seed,
                                        c, j, n_blk, device))
    return pool, plans

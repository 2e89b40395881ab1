"""The traffic generator: deterministic per seed, one continuous capture
across its blocks and round its end, quiet gaps of noise alone at random
points, and the spans a check covers."""

import _paths  # noqa: F401

import numpy as np
import pytest

from benchlib import design as D
from benchlib import spec, traffic
from benchlib import window as W

K = 4
N_BLK = K * D.SUBCHUNK_IN
#: gaps that fit a pool of 3 blocks of 4 sub-chunks (1.18 s)
SMALL = {"gap_every_s": 0.5, "gap_jitter_s": 0.1, "gap_s": [0.25, 0.3]}


def band(**kw):
    return dict(spec.traffic("archive_s8")["band"], **dict(SMALL, **kw))


def iq(raw):
    u = raw.astype(np.float64)
    return (u[0::2] - 127.5) / 127.5 + 1j * (u[1::2] - 127.5) / 127.5


def test_same_seed_same_bytes_other_seed_other_bytes():
    a, pa = traffic.make_pool(band(), 2 ** 31 + 11, 2, 3, K, "cpu")
    b, pb = traffic.make_pool(band(), 2 ** 31 + 11, 2, 3, K, "cpu")
    c, _ = traffic.make_pool(band(), 2 ** 31 + 12, 2, 3, K, "cpu")
    assert a.shape == (3, 2, 2 * N_BLK)
    assert np.array_equal(a, b) and pa == pb
    assert not np.array_equal(a, c)
    # every capture its own draw
    assert not np.array_equal(a[:, 0], a[:, 1])
    assert pa[0].bursts != pa[1].bursts


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 4])
def test_the_plan_is_the_cell_s_busy_band(seed):
    """At the cell's sizes: gaps on a jittered grid, never tied to the
    blocks; bursts outside the gaps, many across a block's boundary, and
    none longer than the traffic file allows."""
    mix = spec.traffic("archive_s8")
    n = mix["pool_blocks"] * 40 * D.SUBCHUNK_IN
    b = mix["band"]
    p = traffic.plan(b, seed, 0, n)
    fs = D.SAMPLE_RATE
    starts = np.asarray([g[0] for g in p.gaps])
    assert len(p.gaps) == round(n / (b["gap_every_s"] * fs))
    d = np.diff(np.concatenate([starts, starts[:1] + n])) / fs
    assert d.max() <= b["gap_every_s"] * 1.01 + 2 * b["gap_jitter_s"]
    assert len({int(s) % (40 * D.SUBCHUNK_IN) for s in starts}) == len(starts)
    assert len(p.bursts) == round(b["bursts_per_s"] * n / fs)
    crossing = 0
    for ch, start, length, *_ in p.bursts:
        assert 1 <= ch <= 16 and 0 < length <= b["burst_s"][1] * fs
        for g0, gl in p.gaps:
            for shift in (-n, 0, n):
                lo = g0 + shift
                assert start + length <= lo or start >= lo + gl
        crossing += (start // N_BLK) != ((start + length - 1) // N_BLK)
    assert crossing > len(p.bursts) // 10


def test_gaps_carry_noise_alone():
    b = band()
    pool, (p,) = traffic.make_pool(b, 5, 1, 3, K, "cpu")
    x = iq(pool[:, 0].reshape(-1))
    for g0, gl in p.gaps:
        seg = np.take(x, np.arange(g0, g0 + gl), mode="wrap")
        assert abs(np.sqrt(np.mean(seg.real ** 2)) / b["noise_rms"] - 1) < 0.05
    in_gap = np.zeros(p.n, bool)
    for g0, gl in p.gaps:
        in_gap[np.arange(g0, g0 + gl) % p.n] = True
    for q in p.quiet_subchunks():
        assert in_gap[q * D.SUBCHUNK_IN:(q + 1) * D.SUBCHUNK_IN].all()
    assert np.sqrt(np.mean(np.abs(x[~in_gap]) ** 2)) > np.sqrt(2) * b[
        "noise_rms"]


@pytest.mark.parametrize("start", [N_BLK - 5000, 3 * N_BLK - 5000],
                         ids=["across_a_block", "round_the_end"])
def test_a_burst_is_continuous_nbfm_across_blocks(start):
    """One burst without noise across a block's boundary, or round the
    capture's end: constant envelope, and the instantaneous frequency
    within the deviation of its channel's offset throughout, with no jump
    where the blocks meet."""
    b = band(noise_rms=0.0)
    n = 3 * N_BLK
    ch, length, amp = 3, 20000, 10 ** (-6 / 20)
    voice = [(700.0, 0.3, 0.1), (1100.0, 0.3, 0.2), (2300.0, 0.25, 0.3)]
    p = traffic.Plan(n, [(n // 2, 1000)], [(ch, start, length, amp, 12,
                                            voice)])
    x = iq(np.concatenate([traffic.make_block(b, p, p.bursts, 9, 0, j,
                                              N_BLK, "cpu").numpy()
                           for j in range(3)]))
    seg = np.take(x, np.arange(start + 1, start + length - 1), mode="wrap")
    assert np.all(np.abs(np.abs(seg) - amp) < 0.02)
    step = np.angle(seg[1:] * np.conj(seg[:-1]))
    f = np.convolve(step, np.ones(64) / 64, "valid") * D.SAMPLE_RATE / (
        2 * np.pi)
    off = 6250.0 * (2 * ch - 17)
    assert np.all(np.abs(f - off) < b["deviation_hz"] + 300)
    # the same burst made in one piece: the blocks meet without a seam
    whole = traffic.Plan(8 * N_BLK, [(6 * N_BLK, 1000)],
                         [(ch, start, length, amp, 12, voice)])
    one = traffic.make_block(b, whole, whole.bursts, 9, 0, 0, 4 * N_BLK,
                             "cpu").numpy()
    pieces = np.concatenate([traffic.make_block(b, p, blk, 9, 0, j, N_BLK,
                                                "cpu").numpy()
                             for j, blk in enumerate(traffic.by_block(
                                 p, N_BLK))])
    at = np.arange(2 * start, 2 * (start + length))
    assert np.array_equal(np.take(pieces, at, mode="wrap"), one[at])
    rest = np.ones(n, bool)
    rest[np.arange(start, start + length) % n] = False
    assert np.all(np.abs(x[rest]) < 0.01)


def test_span_runs_from_the_last_quiet_subchunk_before_the_block():
    quiet = np.asarray([5, 30, 70])
    period, k, warm = 80, 10, 8
    # block 4 (sub-chunks 40-49): the last quiet one before it is 30
    assert W.span(4, k, quiet, period, warm) == (23, 31)
    # block 3 (30-39): 30 is in the block, so 5
    assert W.span(3, k, quiet, period, warm) == (0, 6)
    # round the capture: block 8 (80-89) goes back to 70
    assert W.span(8, k, quiet, period, warm) == (63, 71)
    # block 10 (100-109): 85 (5 + 80)
    assert W.span(10, k, quiet, period, warm) == (78, 86)
    # before the first gap: from the capture's start
    assert W.span(0, k, quiet, period, warm) == (0, 0)
    assert W.span(1, k, quiet, period, warm) == (0, 6)
    assert W.max_back(quiet, period, k) == 5


def test_wire_span_goes_round_the_capture():
    flat = np.arange(12, dtype=np.uint8)
    assert W.wire_span(flat, 1, 3, 2).tolist() == [2, 3, 4, 5]
    assert W.wire_span(flat, 5, 8, 2).tolist() == [10, 11, 0, 1, 2, 3]
    assert W.wire_span(flat, 7, 8, 2).tolist() == [2, 3]

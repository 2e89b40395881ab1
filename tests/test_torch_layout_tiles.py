"""K12a's staging plans and index maps (csrc/probe_layout.cu), on the CPU.

Each CUDA layout move puts only what its output reads into shared memory
(bulk copies of contiguous 16-byte runs on one mbarrier; the transpose by
16-byte ``cp.async`` into a swizzled tile) and writes float4s from there;
``value_lane_off16`` shifts float4s between lanes.  The CUDA code has no
CPU mode, so these tests replay each move's plan in NumPy on a scratch
filled with NaN, with the index maps parsed from the source (the stores
after the barrier wait, ``tr_slot``, the lane shift):

  - every copy starts on 16 bytes at both ends and is whole 16 bytes, the
    barrier's expected bytes are the copies' sum, and no block's scratch
    exceeds 48 KB (the source's ``pl_smem_floats``);
  - the emitted output reads no unstaged (NaN) word and equals the plain
    version bit for bit, block by block;
  - the transpose's slot map is one to one and puts each quarter-warp's
    eight 16-byte reads in eight distinct bank groups;
  - ``min_bytes``, the bytes a move must move (its bound), counts only
    the input words the output reads.
"""

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from sdr_pmr446_tpu_torch.kernels import probe_layout as K12a

torch.set_num_threads(2)

SOURCE = (Path(K12a.__file__).resolve().parent.parent / "csrc"
          / "probe_layout.cu")
THREADS = 256


def smem_floats() -> dict:
    """Move -> shared floats, from the source's pl_smem_floats."""
    body = SOURCE.read_text().split("pl_smem_floats(int move) {")[1]
    body = body.split("}")[0]
    return {int(m[1]): eval(m[2]) for m in re.finditer(
        r"move == (\d) \? ([\d *]+)", body)}


def c_expr(expr: str) -> str:
    """A C integer expression of the source as Python (non-negative ints:
    ``/`` truncates as ``//`` does)."""
    return expr.replace("/", "//")


@functools.lru_cache(maxsize=None)
def tr_slot_expr() -> str:
    body = SOURCE.read_text().split("tr_slot(int r, int q) {")[1]
    return c_expr(re.match(r"\s*return ([^;]+);", body)[1])


def tr_slot(r, q):
    return eval(tr_slot_expr(), {}, {"r": r, "q": q})


@functools.lru_cache(maxsize=None)
def emit_statements() -> dict:
    """Move -> [(threads, output float4, scratch float4)]: the float4
    stores after the barrier wait in layout_probe, parsed from the source;
    a store under ``if (t < n)`` runs on threads 0..n-1, the grid-stride
    loop of move 6 on one index a thread.  Move 0's scalar store first, as
    (threads, scratch word, input word)."""
    src = SOURCE.read_text()
    tail = src.split("mbar_wait(&bar, 0);")[1].split("template <int MOVE>")[0]
    parts = re.split(r"(?:if constexpr \(MOVE == (\d)\)|\} else) \{", tail)
    out = {}
    for code, body in zip(parts[1::2], parts[2::2]):
        move = 6 if code is None else int(code)
        out[move] = [(int(n) if n else THREADS, c_expr(o), c_expr(i))
                     for n, o, i in re.findall(
                         r"(?:if \(t < (\d+)\) )?out4\[([^\]]+)\] = "
                         r"s4\[([^\]]+)\];", body) if o != "i"]
        for n, o, i in re.findall(
                r"for \(int i = t; i < ([^;]+); i \+= PL_THREADS\) "
                r"out4\[(i)\] = s4\[(i)\];", body):
            out[move].append((eval(c_expr(n)), "t", "t"))
    n, dst = re.search(r"if \(t < (\d+)\) s\[([^\]]+)\] = v0;", tail).groups()
    v0 = re.search(r"MOVE == 0 && t < (\d+)\) v0 = x\[([^\]]+)\];", src)
    assert v0[1] == n
    out["store"] = (int(n), c_expr(dst), c_expr(v0[2]))
    return out


#: move -> (blocks, scratch floats, copies(block) -> [(dst, src, floats)])
PLANS = {
    "scratch_store_off16": (1, 8 * 128, lambda b: [
        (r * 128, r * 256, 128) for r in range(8)]),
    "scratch_read_off16": (1, 8 * 144, lambda b: [
        (r * 144 + 16, r * 256 + 16, 128) for r in range(8)]),
    "scratch_read_narrow": (1, 8 * 32, lambda b: [
        (r * 32 + 16, r * 256 + 16, 16) for r in range(8)]),
    "value_stride_sub": (8, 256, lambda b: [(0, 16 * b * 256, 256)]),
    "reshape_rows_wide": (8, 2048, lambda b: [(0, b * 2048, 2048)]),
    "reshape_25_16": (1, 128 * 25, lambda b: [(0, 0, 128 * 25)]),
}


def emit(move, s, x, b, out):
    """Block b's stores after the wait, all threads at once, from scratch
    s (emit_statements)."""
    s4, o4 = s.reshape(-1, 4), out.reshape(-1, 4)
    code = K12a.MOVE_CODE[move]
    if code == 0:
        n, dst, src = emit_statements()["store"]
        t = np.arange(n)
        s[eval(dst)] = x[eval(src)]
    for n, dst, src in emit_statements()[code]:
        t = np.arange(n)
        o4[eval(dst, {}, {"t": t, "b": b})] = s4[eval(src, {}, {"t": t})]


def random_input(move, seed=0):
    shape = K12a.MOVES[move][0]
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def plain(move, x):
    return K12a.probe_move_plain(torch.from_numpy(x), move).numpy()


def assert_bits(got, want):
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("move", list(PLANS))
def test_bulk_plan_emits_the_plain_move(move):
    blocks, floats, copies = PLANS[move]
    assert smem_floats()[K12a.MOVE_CODE[move]] == floats
    assert floats * 4 <= 48 * 1024
    x = random_input(move).reshape(-1)
    out = np.full(K12a.MOVES[move][1], np.nan, np.float32).reshape(-1)
    for b in range(blocks):
        s = np.full(floats, np.nan, np.float32)
        expect = 0
        for dst, src, n in copies(b):
            assert dst % 4 == 0 and src % 4 == 0 and n % 4 == 0   # 16 B
            assert np.all(np.isnan(s[dst:dst + n]))               # no overlap
            s[dst:dst + n] = x[src:src + n]
            expect += 4 * n
        assert expect <= (1 << 20) - 1                            # tx count
        emit(move, s, x, b, out)
    assert not np.any(np.isnan(out)), "an output word read unstaged scratch"
    assert_bits(out.reshape(K12a.MOVES[move][1]), plain(move, x.reshape(
        K12a.MOVES[move][0])))


def test_value_stride_sub_stages_only_what_it_reads():
    blocks, _, copies = PLANS["value_stride_sub"]
    staged = sum(n for b in range(blocks) for _, _, n in copies(b))
    assert 4 * staged == 8 * 1024                   # 8 KB of the 128 KB


@pytest.mark.parametrize("move, nbytes", [
    ("scratch_store_off16", 4 * 8 * (112 + 128)),  # columns 0:16, 32:128
    ("scratch_read_off16", 4 * 8 * (128 + 128)),
    ("scratch_read_narrow", 4 * 8 * (16 + 16)),
    ("value_lane_off16", 4 * 8 * (128 + 128)),
    ("value_stride_sub", 4 * 2 * 8 * 256),         # 8 of the 128 rows
    ("reshape_rows_wide", 4 * 2 * 128 * 128),
    ("reshape_25_16", 4 * 2 * 128 * 25),
    ("transpose_16", 4 * 2 * 128 * 16)])
def test_min_bytes_counts_only_the_words_the_output_reads(move, nbytes):
    assert K12a.min_bytes(move) == nbytes


def test_transpose_plan_emits_the_plain_move():
    move = "transpose_16"
    floats = smem_floats()[K12a.MOVE_CODE[move]]
    x = random_input(move)
    s4 = np.full((floats // 4, 4), np.nan, np.float32)
    for c in range(128 * 4):                        # cp.async, 16 B each
        s4[tr_slot(c >> 2, c & 3)] = x.reshape(-1, 4)[c]
    out = np.full((16, 128), np.nan, np.float32)
    o4 = out.reshape(-1, 4)
    for t in range(128):
        c4, q = t >> 5, t & 31
        a = np.stack([s4[tr_slot(4 * q + m, c4)] for m in range(4)])
        for k in range(4):
            o4[(4 * c4 + k) * 32 + q] = a[:, k]
    assert_bits(out, plain(move, x))


def test_transpose_slots_are_one_to_one_and_conflict_free():
    slots = [tr_slot(r, q) for r in range(128) for q in range(4)]
    assert sorted(slots) == list(range(512))
    # a quarter-warp (8 lanes q0..q0+7) reads piece c4 of rows 4q + m
    for c4 in range(4):
        for m in range(4):
            for q0 in range(0, 32, 8):
                groups = {tr_slot(4 * q + m, c4) % 8
                          for q in range(q0, q0 + 8)}
                assert len(groups) == 8, (c4, m, q0)


def test_lane_offset_shuffle_emits_the_plain_move():
    move = "value_lane_off16"
    x = random_input(move)
    x4 = x.reshape(8, 64, 4)
    out = np.empty((8, 32, 4), np.float32)
    body = SOURCE.read_text().split("void lane_off16(")[1]
    src_expr = re.search(r"const int src = ([^;]+);", body)[1]
    split = int(re.search(r"lane < (\d+) \? lo : hi", body)[1])
    for r in range(8):                               # warp r, lane l
        a, b = x4[r, :32], x4[r, 32:]
        for lane in range(32):
            src = eval(c_expr(src_expr), {}, {"lane": lane})
            out[r, lane] = a[src] if lane < split else b[src]
    assert_bits(out.reshape(8, 128), plain(move, x))

"""K10's lane layout and summation order (csrc/summary.cu), on the CPU.

The CUDA zero summary reads a 128-sample row in 16-byte pieces, 16 lanes a
row for cu8 / cs8 (8 samples a lane), 32 for cs16 (4) and 32 for cf32 (two
pieces of 2 samples a lane), and sums in a fixed order the plain version
does not share: each lane an ``fmaf`` chain over its samples in ascending
order from 0, then a shuffle-down tree over the row's lanes.  The CUDA code
has no CPU mode, so these tests hold a NumPy float32 emulation of that
order to the plain version and to the JAX kernel:

  - each format's lanes cover every sample of a row once, each lane's
    pieces are 16 contiguous bytes, a warp's load is one contiguous run,
    and the row's last lane holds sample 127 last (its ``xl``);
  - the emulated ``w`` is within 1e-5 of its peak of
    ``summary.zero_summary_plain`` on seeded random wires with a ragged row
    count, and of JAX's ``kernels/summary.py::zero_summary_wire`` in
    interpret mode (computed once a format for the module); the emulated
    ``xl`` is bit-equal to both;
  - the worst case, full-scale rows of alternating sign (cu8 and cs16),
    holds the same bound;
  - ``build.check_aligned`` (the wrapper's 16-byte check of the wire)
    raises on an unaligned address.

The geometry (``ZsGeom``), each lane's weight positions, the pieces it
loads, the shuffle tree's first offset and the ``xl`` lane are parsed
from the source, so the emulation follows the code.
"""

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from sdr_pmr446_tpu_torch.kernels import build, summary
from sdr_pmr446_tpu_torch.ops import decode
from sdr_pmr446_tpu_torch.parallel.fused_halo import dc_row_weights

torch.set_num_threads(2)

SOURCE = (Path(summary.__file__).resolve().parent.parent / "csrc"
          / "summary.cu")
FORMATS = ["cu8", "cs8", "cs16", "cf32"]
TOL = 1e-5                 # chip_smoke.py TOL_SUMMARY_REL
ROW = summary.ROW


def defines() -> dict:
    return {m[1]: int(m[2]) for m in re.finditer(
        r"^#define (\w+) (\d+)\b", SOURCE.read_text(), re.M)}


def c_expr(expr: str) -> str:
    """A C integer expression of the source as Python: ``a ? b : c`` (an
    else branch may nest) as a conditional, ``/`` as ``//`` (non-negative
    ints), ``G::`` dropped."""
    expr = expr.strip().replace("G::", "")
    if "?" not in expr:
        return expr.replace("/", "//")
    cond, rest = expr.split("?", 1)
    then, other = rest.split(":", 1)
    return f"({c_expr(then)} if {c_expr(cond)} else {c_expr(other)})"


@functools.lru_cache(maxsize=None)
def zs_geom(fmt) -> dict:
    """ZsGeom<FMT>'s members for ``fmt``, evaluated from the source."""
    body = SOURCE.read_text().split("struct ZsGeom {")[1].split("};")[0]
    env = {**defines(), "FMT": fmt, **{f"FMT_{f.upper()}": f
                                       for f in FORMATS}}
    for name, expr in re.findall(r"static constexpr int (\w+) = ([^;]+);",
                                 body):
        env[name] = eval(c_expr(expr), {}, env)
    return env


def kernel_expr(pattern: str) -> str:
    """The first group of ``pattern`` in zs_rows' source, as Python."""
    body = SOURCE.read_text().split("zs_rows(")[1]
    return c_expr(re.search(pattern, body)[1])


def geometry(fmt):
    """(samples a 16-byte piece, lanes a row, pieces a lane a row), the
    source's SPL, LPR, LDS."""
    g = zs_geom(fmt)
    return g["SPL"], g["LPR"], g["LDS"]


def lane_samples(fmt) -> np.ndarray:
    """[lanes, samples a lane]: lane li's samples in its summation order
    (pieces j, then samples k in turn): the positions of the weights the
    source gives it (``wv[j][k] = v[...]``)."""
    spl, lanes, lds = geometry(fmt)
    j, k = np.meshgrid(np.arange(lds), np.arange(spl), indexing="ij")
    env = {"j": j.reshape(-1), "k": k.reshape(-1),
           "li": np.arange(lanes)[:, None], "LPR": lanes, "SPL": spl}
    return eval(kernel_expr(r"wv\[j\]\[k\] = v\[([^;]+)\];"), {},
                env).astype(int)


def decode_rows(wire: np.ndarray, fmt: str) -> np.ndarray:
    """[R, 128, 2] f32: the kernel's decode (front_end.cuh dec_*)."""
    if fmt == "cu8":
        x = (wire.astype(np.float32) - np.float32(127.5)) \
            * np.float32(1.0 / 127.5)
    elif fmt == "cs8":
        x = wire.view(np.int8).astype(np.float32) * np.float32(1.0 / 128.0)
    elif fmt == "cs16":
        x = wire.view(np.int16).astype(np.float32) \
            * np.float32(1.0 / 32768.0)
    else:
        x = wire.view(np.float32)
    return x.reshape(-1, ROW, 2)


def emulate(wire: np.ndarray, fmt: str):
    """(w [2, R], xl [2, R]) f32 in csrc/summary.cu's order: per lane an
    fmaf chain (a float64 product and sum rounded once to f32), then the
    shuffle-down tree (lane li adds lane li + off) to lane 0."""
    x = decode_rows(wire, fmt)
    v = dc_row_weights()
    pos = lane_samples(fmt)
    acc = np.zeros((x.shape[0], pos.shape[0], 2), np.float32)
    for step in range(pos.shape[1]):
        j = pos[:, step]
        acc = (v[j].astype(np.float64)[None, :, None] * x[:, j, :]
               + acc).astype(np.float32)
    off = eval(kernel_expr(r"for \(int off = ([^;]+);"), {},
               {"LPR": pos.shape[0]})
    while off:
        acc = acc[:, :off] + acc[:, off:2 * off]
        off //= 2
    return acc[:, 0, :].T.copy(), x[:, ROW - 1, :].T.copy()


def random_wire(fmt, rows, seed):
    rng = np.random.default_rng(seed)
    n = rows * ROW
    x = 0.4 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return decode.quantize_iq(x, fmt)


def alternating_wire(fmt, rows):
    """Full-scale samples of alternating sign in both planes."""
    n = rows * ROW
    sign = np.where(np.arange(2 * n) % 2 == (np.arange(2 * n) // 2) % 2,
                    1, -1)
    if fmt == "cu8":
        return np.where(sign > 0, 255, 0).astype(np.uint8)
    return np.where(sign > 0, 32767, -32768).astype(np.int16).view(np.uint8)


def within(got, want, tol=TOL):
    peak = float(np.max(np.abs(want)))
    return float(np.max(np.abs(got.astype(np.float64) - want))) <= tol * peak


@pytest.mark.parametrize("fmt", FORMATS)
def test_lanes_cover_each_row_sample_once(fmt):
    spl, lanes, lds = geometry(fmt)
    pos = lane_samples(fmt)
    assert sorted(pos.reshape(-1)) == list(range(ROW))
    xl_lane = eval(kernel_expr(r"if \(li == ([^)]+)\) \{  // its last"),
                   {}, {"LPR": lanes})
    assert pos[xl_lane, -1] == ROW - 1             # the xl lane's last sample
    bps = decode.BYTES_PER_SAMPLE[fmt]
    assert zs_geom(fmt)["BPS"] == bps
    # the loads: lane li's piece j is the one its weights are for
    piece = kernel_expr(r"__ldcs\(row \+ ([^)]+)\)")
    for j in range(lds):
        for li in range(lanes):
            p = eval(piece, {}, {"j": j, "li": li, "LPR": lanes})
            assert list(pos[li, j * spl:(j + 1) * spl]) == list(
                range(p * spl, (p + 1) * spl))
    # a piece: 16 contiguous bytes; one warp load: 512 contiguous bytes
    pieces = pos.reshape(lanes, lds, spl)
    assert np.all(np.diff(pieces, axis=-1) == 1) and spl * bps == 16
    rows_a_load = 32 // lanes
    for j in range(lds):
        start = np.sort(np.concatenate([
            r * ROW * bps + pieces[:, j, 0] * bps
            for r in range(rows_a_load)]))
        assert np.array_equal(start, start[0] + 16 * np.arange(32))


@pytest.mark.parametrize("fmt", FORMATS)
def test_emulated_order_matches_plain(fmt):
    rows = 7 * 64 + 3                              # ragged against a block
    wire = random_wire(fmt, rows, seed=11)
    w, xl = emulate(wire, fmt)
    wp, xp = (t.numpy() for t in summary.zero_summary_plain(
        torch.from_numpy(wire), fmt))
    assert w.shape == xl.shape == (2, rows)
    assert within(w, wp)
    np.testing.assert_array_equal(xl.view(np.int32), xp.view(np.int32))


@functools.lru_cache(maxsize=None)
def jax_summary(fmt):
    """(wire, JAX w, JAX xl) at 8 * 2048 samples, in interpret mode."""
    import jax.numpy as jnp
    from sdr_pmr446_tpu.kernels.summary import zero_summary_wire
    from sdr_pmr446_tpu.ops import decode as jdecode
    rng = np.random.default_rng(17)
    t = 8 * 2048
    x = 0.3 * (rng.standard_normal(t) + 1j * rng.standard_normal(t))
    if fmt == "cf32":
        jw = np.empty(2 * t, np.float32)
        jw[0::2], jw[1::2] = x.real, x.imag
        jw, jfmt = jw.reshape(t // 128, 256), "cf32w"
    else:
        spw = 128 if fmt == "cs16" else 256
        jw, jfmt = jdecode.pack_iq(x, fmt).reshape(t // spw, -1), fmt
    w, xl = zero_summary_wire(jnp.asarray(jw), jfmt, interpret=True)
    return decode.quantize_iq(x, fmt), np.asarray(w), np.asarray(xl)


@pytest.mark.parametrize("fmt", FORMATS)
def test_emulated_order_matches_jax(fmt):
    wire, jw, jxl = jax_summary(fmt)
    w, xl = emulate(wire, fmt)
    assert within(w, jw)
    np.testing.assert_array_equal(xl, jxl)


@pytest.mark.parametrize("fmt", ["cu8", "cs16"])
def test_full_scale_alternating_rows(fmt):
    """The largest |x| everywhere and the most cancellation in the small
    weights: the emulation stays within 1e-5 of the peak of the plain
    version and of a float64 sum."""
    wire = alternating_wire(fmt, 40)
    w, xl = emulate(wire, fmt)
    wp, xp = (t.numpy() for t in summary.zero_summary_plain(
        torch.from_numpy(wire), fmt))
    x = decode_rows(wire, fmt).astype(np.float64)
    w64 = np.einsum("rjp,j->pr", x, dc_row_weights().astype(np.float64))
    assert np.max(np.abs(x)) >= 1.0 - 1e-2
    assert within(w, wp) and within(w, w64)
    assert np.array_equal(xl, xp)


def byte_perm(x: np.ndarray, y: int, sel: int) -> np.ndarray:
    """CUDA's __byte_perm: result byte i is byte (sel >> 4 i) & 7 of the
    eight bytes of (x, y), x's first."""
    src = np.stack([(x.astype(np.uint64) >> (8 * i)) & 0xFF for i in range(4)]
                   + [np.full_like(x, (y >> (8 * i)) & 0xFF, np.uint64)
                      for i in range(4)])
    return sum(src[(sel >> (4 * i)) & 7] << (8 * i)
               for i in range(4)).astype(np.uint32)


def int_bits_as_float(w, sel, bias):
    return byte_perm(w, 0x4B000000, sel).view(np.float32) - np.float32(bias)


def test_byte_perm_decode_is_exact():
    """Every byte and short value through int_bits_as_float (the source's
    selectors and biases) gives its integer exactly, so the decode that
    follows is load_iq's, bit for bit."""
    b = np.arange(256, dtype=np.uint32)
    for k in range(4):                             # cu8: byte k of a word
        w = b << (8 * k) | (0x5A5A5A5A & ~(0xFF << (8 * k)))
        assert np.array_equal(int_bits_as_float(w, 0x7440 | k, 2.0 ** 23),
                              b.astype(np.float32))
        s = (b.astype(np.int32) - 256 * (b >= 128)).astype(np.float32)
        got = int_bits_as_float(w ^ 0x80808080, 0x7440 | k, 2.0 ** 23 + 128)
        assert np.array_equal(got, s)              # cs8
    h = np.arange(65536, dtype=np.uint32)
    s16 = (h.astype(np.int64) - 65536 * (h >= 32768)).astype(np.float32)
    for sel, shift in ((0x7410, 0), (0x7432, 16)):
        w = (h << shift) | (0x1234 << (16 - shift))
        got = int_bits_as_float(w ^ 0x80008000, sel, 2.0 ** 23 + 32768)
        assert np.array_equal(got, s16)
    src = SOURCE.read_text()
    for lit in ("0x7440", "0x7443", "0x7410", "0x7432", "0x80808080u",
                "0x80008000u", "8388608.0f + 128.0f", "8388608.0f + 32768.0f"):
        assert lit in src, lit


def test_check_aligned_raises_on_an_unaligned_address():
    build.check_aligned(0x7F00_0000_0200, "wire")
    build.check_aligned(16 * 12345, "wire")
    for off in (1, 2, 4, 8, 12):
        with pytest.raises(ValueError, match="wire: .* not 16-byte aligned"):
            build.check_aligned(0x7F00_0000_0200 + off, "wire")
    wire = torch.zeros(4 * ROW * 2 + 1, dtype=torch.uint8)
    with pytest.raises(ValueError, match="not 16-byte aligned"):
        build.check_aligned(wire[1:].data_ptr(), "wire")


def test_source_constants_are_the_emulated_ones():
    d = defines()
    assert d["ZS_ROW"] == ROW
    assert d["ZS_THREADS"] % 32 == 0
    # every lane keeps ZS_LOADS pieces in flight: whole rows a lane
    for fmt in FORMATS:
        assert d["ZS_LOADS"] % geometry(fmt)[2] == 0, fmt
    src = SOURCE.read_text()
    assert "__shfl_down_sync" in src
    assert not re.search(r"\batomic\w*\(", src)     # a fixed order

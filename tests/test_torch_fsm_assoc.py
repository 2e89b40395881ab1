"""The port's associative control layer (scanner/fsm.py v3) vs the JAX package.

  - ``_associative_scan`` against ``jax.lax.associative_scan`` bit for bit,
    along K behind a stream axis and along K alone, for K in {1, 2, 3, 5,
    8, 40, 41}: the detector count's affine maps mod 2441
    (``cnt_combine``), a non-commutative map (the composition of
    permutations of 5 values, the gather form of ``fsm_combine``) and the
    Goertzel carry's complex affine maps (``cc_combine``, its coefficient
    in {0, 1} as in phase C: runs of complex additions, whose rounding
    shows the association order);
  - phases A and C (v3) against JAX's jitted ``fsm_phase_a`` /
    ``fsm_phase_c`` and against the port's loops (v2) on the busy traces of
    tests/test_torch_fsm.py over three streamed blocks, lock_max off and
    on, a masked channel, K in {1, 2, 3, 5, 8, 9, 40, 41}: every field
    bit for bit, the tone carry included (phase C of both packages on the
    same tone sums); the whole ``fsm_ctcss_scan_v3`` against JAX's at K =
    40 (decisions exact, the tone carry within 1e-5 of its peak: its tone
    sums are two matmuls, summed in another order by each library; K = 9
    on the same traces is tests/test_torch_fsm.py's);
  - S = 3 streams in one call equal to three single-stream calls: phases A
    and C bit for bit on the same tone sums; ``raw_sums_to_ctcss`` (the
    default engine's form) within 1e-6 relative (the CPU's vectorized
    complex product rounds otherwise than its scalar tail, and where an
    element falls depends on the batch); the whole scan with its tone-sum
    matmuls decisions exact and the carry within 1e-5 of its peak (BLAS
    rounds a product of S x K rows otherwise than one of K rows);
  - v3 on the meta device: no host read and no data-dependent shape (what
    a CUDA graph capture and torch.export need);
  - the op count of phases A + C (aten ops, views left out): at most 800
    at K = 40 (the loops take ~2,300) and growing at most 1.5x to K = 160.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from sdr_pmr446_tpu import config as C
from sdr_pmr446_tpu.scanner import fsm as jfsm
from sdr_pmr446_tpu_torch.scanner import fsm as tfsm
from test_torch_fsm import _jax_carry0, scan_inputs

torch.set_num_threads(2)

NS = C.SUBCHUNK_AUDIO
N_WIN = C.CTCSS_BLOCK_SIZE
SCAN_KS = (1, 2, 3, 5, 8, 40, 41)

JAX_A = jax.jit(jfsm.fsm_phase_a, static_argnums=5)
JAX_C = jax.jit(jfsm.fsm_phase_c)
JAX_V3 = jax.jit(jfsm.fsm_ctcss_scan_v3)


def _carry0():
    return tfsm.FsmCarry(*(torch.from_numpy(np.array(x))
                           for x in _jax_carry0()))


def _bits(a: np.ndarray) -> np.ndarray:
    """An array's bits (floats and complex as integers of their width)."""
    a = np.ascontiguousarray(a)
    if a.dtype.kind in "fc":
        return a.view({4: np.int32, 8: np.int64}[a.dtype.itemsize // (
            2 if a.dtype.kind == "c" else 1)])
    return a


def assert_bits(got, want, what):
    """Port tensors vs JAX / port arrays: dtype, shape and bits equal."""
    names = getattr(want, "_fields", None) or range(len(want))
    for name, g, w in zip(names, got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        w = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        assert (g.dtype, g.shape) == (w.dtype, w.shape), f"{what} {name}"
        np.testing.assert_array_equal(_bits(g), _bits(w),
                                      err_msg=f"{what} {name}")


# ------------------------------------------------------ (a) the scan itself
def _cnt(jnp_or_torch):
    def combine(f, g):
        return f[0] * g[0], (g[0] * f[1] + g[1]) % N_WIN
    return combine


def _perm_torch(f, g):                       # g applied after f: g[f[i]]
    return (torch.gather(g[0], -1, f[0]),)


def _perm_jax(f, g):
    return (jnp.take_along_axis(g[0], f[0], axis=-1),)


def _cc_torch(f, g):
    return f[0] * g[0], g[0][..., None] * f[1] + g[1]


def _cc_jax(f, g):
    return f[0] * g[0], g[0][..., None] * f[1] + g[1]


def _scan_elems(rng, k, kind):
    """Inputs of each combine, [2, k, ...] (two streams)."""
    if kind == "cnt":
        return (rng.integers(0, 2, (2, k)).astype(np.int32),
                rng.integers(0, N_WIN, (2, k)).astype(np.int32))
    if kind == "perm":
        return (np.stack([np.stack([rng.permutation(5) for _ in range(k)])
                          for _ in range(2)]).astype(np.int64),)
    # A in {0, 1} as the carry's (mostly 1: long runs of additions, whose
    # rounding shows the association order); its products are then exact
    # in any complex-multiply formula (XLA's and PyTorch's differ)
    b = (rng.standard_normal((2, k, 38))
         + 1j * rng.standard_normal((2, k, 38))).astype(np.complex64)
    return (rng.random((2, k)) < 0.8).astype(np.complex64), b


COMBINES = {"cnt": (_cnt(torch), _cnt(jnp)), "perm": (_perm_torch, _perm_jax),
            "cc": (_cc_torch, _cc_jax)}


@pytest.mark.parametrize("kind", list(COMBINES))
def test_associative_scan_matches_jax(kind):
    """Bit for bit with jax.lax.associative_scan, along K alone (axis 0)
    and behind a stream axis (axis 1), and its first element unchanged."""
    rng = np.random.default_rng({"cnt": 1, "perm": 2, "cc": 3}[kind])
    tcomb, jcomb = COMBINES[kind]
    for k in SCAN_KS:
        elems = _scan_elems(rng, k, kind)
        # torch gathers at int64 indices, JAX (32-bit) at int32 ones
        wide = lambda g: tuple(  # noqa: E731
            x.to(torch.int32) if x.dtype == torch.int64 else x for x in g)
        want = jax.jit(lambda *e: jax.lax.associative_scan(
            jcomb, e, axis=1))(*(jnp.asarray(e) for e in elems))
        got = tfsm._associative_scan(
            tcomb, tuple(torch.from_numpy(e) for e in elems), 1)
        assert_bits(wide(got), want, f"{kind} K={k} axis 1")
        got0 = tfsm._associative_scan(
            tcomb, tuple(torch.from_numpy(e[1]) for e in elems), 0)
        assert_bits(wide(got0), tuple(w[1] for w in want),
                    f"{kind} K={k} axis 0")
        for g, e in zip(got, elems):
            np.testing.assert_array_equal(g[:, 0].numpy(), e[:, 0])


# ------------------------------------------- (b), (c) v3 vs JAX's v3 and v2
def _block_args(rssi, mask, lock):
    return (torch.from_numpy(rssi), torch.from_numpy(mask),
            torch.tensor(np.float32(18.0)), torch.tensor(lock))


@pytest.mark.parametrize("k", [1, 2, 3, 5, 8, 9, 40, 41])
def test_v3_phases_match_jax_and_v2(k):
    """Phases A and C of v3 against JAX's and against the port's loops
    (v2), every field bit for bit, over three streamed blocks with
    lock_max off (and channel 5 masked) and on; at K = 40 also the whole
    scan against JAX's v3 (at K = 9: tests/test_torch_fsm.py)."""
    events = dict.fromkeys(("ev_tuned", "ev_detuned", "ev_ct_acquired"), 0)
    for trial in (0, 1):
        rng = np.random.default_rng(17 + trial)
        lock = trial == 1
        mask = np.ones(16, bool)
        mask[5] = trial == 0
        jc, c3, c2, j3, f3 = (_jax_carry0(), _carry0(), _carry0(),
                              _jax_carry0(), _carry0())
        for blk in range(3):
            rssi, lp = scan_inputs(rng, k, trial, blk, mask)
            args = _block_args(rssi, mask, lock)
            js = JAX_A(jc, jnp.asarray(rssi), jnp.asarray(mask),
                       jnp.float32(18.0), jnp.asarray(lock), NS)
            s3 = tfsm.fsm_phase_a(c3, *args, NS)
            s2 = tfsm.fsm_phase_a_v2(c2, *args, NS)
            what = f"K={k} trial {trial} block {blk}"
            assert_bits(s3, js, f"{what} phase A vs JAX")
            assert_bits(s3, s2, f"{what} phase A vs v2")
            # phase C of both on the same tone sums
            tsp, tss = tfsm.fsm_tone_sums(s3, torch.from_numpy(lp), None, NS)
            sp, ss = jnp.asarray(tsp.numpy()), jnp.asarray(tss.numpy())
            jc, jo = JAX_C(jc, js, sp, ss)
            c3, o3 = tfsm.fsm_phase_c(c3, s3, tsp, tss)
            c2, o2 = tfsm.fsm_phase_c_v2(c2, s2, tsp, tss)
            assert_bits(tuple(o3) + tuple(c3), tuple(jo) + tuple(jc),
                        f"{what} phase C vs JAX")
            assert_bits(tuple(o3) + tuple(c3), tuple(o2) + tuple(c2),
                        f"{what} phase C vs v2")
            for name in events:
                events[name] += int(getattr(o3, name).sum())
            if k == 40:
                j3, jo3 = JAX_V3(j3, jnp.asarray(rssi), jnp.asarray(lp),
                                 jnp.asarray(mask), jnp.float32(18.0),
                                 jnp.asarray(lock))
                f3, fo3 = tfsm.fsm_ctcss_scan_v3(f3, args[0],
                                                 torch.from_numpy(lp),
                                                 *args[1:])
                _assert_decisions(tuple(fo3) + tuple(f3),
                                  tuple(jo3) + tuple(j3), jo3._fields
                                  + j3._fields, f"{what} v3 scan vs JAX")
    assert events["ev_tuned"] >= 1 and events["ev_detuned"] >= 1
    if k >= 9:
        assert events["ev_ct_acquired"] >= 1


def _assert_decisions(got, want, names, what):
    """Ints and bools exact, floats within 1e-5 (dB, Hz), the complex tone
    carry within 1e-5 of its peak (tests/test_torch_fsm.py's gate)."""
    for name, g, w in zip(names, got, want):
        g, w = g.numpy(), np.asarray(w)
        assert (g.dtype, g.shape) == (w.dtype, w.shape), f"{what} {name}"
        if w.dtype.kind == "c":
            assert np.max(np.abs(g - w)) <= 1e-5 * max(np.max(np.abs(w)),
                                                        1.0), f"{what} {name}"
        elif w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5,
                                       err_msg=f"{what} {name}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {name}")


# ----------------------------------------------- (d) S streams in one call
@pytest.mark.parametrize("k", [9, 40])
def test_streams_in_one_call_equal_single_calls(k):
    """S = 3 streams (each its own trace, carry and tone sums) in one call
    of phases A and C equal three single-stream calls bit for bit over two
    blocks; raw_sums_to_ctcss over the streams within 1e-6 of its single
    calls; the whole v3 scan with its matmul tone sums equal in its
    decisions."""
    rng = np.random.default_rng(40 + k)
    mask = np.ones(16, bool)
    mask[13] = False
    rest = (torch.from_numpy(mask), torch.tensor(np.float32(18.0)),
            torch.tensor(True))
    ones = [_carry0() for _ in range(3)]
    many = tfsm.FsmCarry(*(torch.stack(v) for v in zip(*ones)))
    scan_one = [_carry0() for _ in range(3)]
    scan_many = many
    for blk in range(2):
        ins = [scan_inputs(rng, k, s, blk, mask) for s in range(3)]
        rssi = torch.from_numpy(np.stack([r for r, _ in ins]))
        lp = torch.from_numpy(np.stack([x for _, x in ins]))
        raw = [torch.from_numpy((rng.standard_normal((3, k, 38)) + 1j
                                 * rng.standard_normal((3, k, 38))).astype(
                                     np.complex64) * 50) for _ in range(2)]
        sched = tfsm.fsm_phase_a(many, rssi, *rest, NS)
        sums = tfsm.raw_sums_to_ctcss(sched, raw[0], raw[1], NS)
        single = [tfsm.raw_sums_to_ctcss(
            tfsm.FsmSchedule(*(v[s] for v in sched)), raw[0][s], raw[1][s],
            NS) for s in range(3)]
        for s, sm in enumerate(single):
            for a, b in zip(sm, sums):
                np.testing.assert_allclose(a.numpy(), b[s].numpy(),
                                           rtol=1e-6, atol=0)
        many, outs = tfsm.fsm_phase_c(
            many, sched, *(torch.stack(v) for v in zip(*single)))
        scan_many, sc_outs = tfsm.fsm_ctcss_scan_v3(scan_many, rssi, lp,
                                                    *rest)
        for s in range(3):
            sch = tfsm.fsm_phase_a(ones[s], rssi[s], *rest, NS)
            assert_bits(tuple(sch), tuple(v[s] for v in sched),
                        f"K={k} block {blk} stream {s} phase A")
            ones[s], o = tfsm.fsm_phase_c(ones[s], sch, *single[s])
            assert_bits(tuple(o) + tuple(ones[s]),
                        tuple(v[s] for v in tuple(outs) + tuple(many)),
                        f"K={k} block {blk} stream {s} phase C")
            scan_one[s], so = tfsm.fsm_ctcss_scan_v3(scan_one[s], rssi[s],
                                                     lp[s], *rest)
            _assert_decisions(
                tuple(v[s] for v in tuple(sc_outs) + tuple(scan_many)),
                tuple(so) + tuple(scan_one[s]), so._fields
                + scan_one[s]._fields, f"K={k} stream {s} whole scan")


# ------------------------------------------------- graph / export friendly
def test_v3_runs_on_meta_tensors():
    """v3 over [2, 9] on the meta device (no data: any host read or
    data-dependent shape would raise), with the output shapes and dtypes
    of the CPU run."""
    k, ns = 9, NS
    carry = tfsm.FsmCarry(*(torch.stack([v, v]) for v in _carry0()))
    rssi = torch.randn(2, k, 16)
    lp_cm = torch.randn(2, 16, k, ns)
    rest = (torch.ones(16, dtype=torch.bool), torch.tensor(18.0),
            torch.tensor(True))
    tables = tfsm.CtcssTables(ns, "meta")
    meta = lambda t: t.to("meta")  # noqa: E731
    got = tfsm.fsm_ctcss_scan_v3(tfsm.FsmCarry(*map(meta, carry)),
                                 meta(rssi), None, *map(meta, rest),
                                 lp_cm=meta(lp_cm), tables=tables)
    want = tfsm.fsm_ctcss_scan_v3(carry, rssi, None, *rest, lp_cm=lp_cm)
    for g, w in zip(tuple(got[0]) + tuple(got[1]),
                    tuple(want[0]) + tuple(want[1])):
        assert g.is_meta and (g.dtype, g.shape) == (w.dtype, w.shape)


# ------------------------------------------------------------ (e) op count
class _OpCount(TorchDispatchMode):
    """Counts the aten ops dispatched, views left out."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += not func.is_view
        return func(*args, **(kwargs or {}))


def _phase_ops(k: int, phase_a, phase_c) -> int:
    rng = np.random.default_rng(k)
    rssi, _ = scan_inputs(rng, k, 0, 0, np.ones(16, bool))
    args = _block_args(rssi, np.ones(16, bool), True)
    s_pre, s_suf = (torch.from_numpy((rng.standard_normal((k, 38)) + 1j
                                      * rng.standard_normal((k, 38))
                                      ).astype(np.complex64))
                    for _ in range(2))
    carry = _carry0()
    tables = tfsm.shared_tables(NS, "cpu")
    with _OpCount() as count:
        sched = phase_a(carry, *args, NS)
        phase_c(carry, sched, s_pre, s_suf, tables)
    return count.n


def test_op_count():
    """Phases A + C of v3 take at most 800 aten ops at K = 40 (the loops
    of v2 several times that) and at most 1.5x as many at K = 160."""
    v3 = {k: _phase_ops(k, tfsm.fsm_phase_a, tfsm.fsm_phase_c)
          for k in (40, 160)}
    v2 = _phase_ops(40, tfsm.fsm_phase_a_v2, tfsm.fsm_phase_c_v2)
    assert v3[40] <= 800, v3
    assert v3[160] <= 1.5 * v3[40], v3
    assert v2 > 4 * v3[40], (v2, v3)

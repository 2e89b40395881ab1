"""The port's one-card mesh collectives, K10 and K11 vs the JAX package.

The JAX collectives (sdr_pmr446_tpu/parallel/halo.py, fused_halo.py) run
under ``jax.shard_map`` on the 8-device virtual CPU mesh (tests/conftest.py),
with a (stream, time) mesh of 2 x 4; the port's run on one tensor with the
leading dims [S, D] (sdr_pmr446_tpu_torch/parallel/halo.py).  On the same
numpy inputs:

  - halo moves and carries bit-equal; shard_biquad1 within 2e-4 (JAX's own
    gate, tests/test_sharding.py:160); compose_dc_chain within 1e-6 of the
    peak (a fold of f32 complex products);
  - K10's plain version (``front_zero_summary_wire``) against JAX's
    wire-direct pre-pass in interpret mode for cu8, cs8, cs16 and cf32
    (JAX's cf32w) at t = 8 * 2048, tail 2560: y00 and y_pre within 1e-6, the
    samples and the raw tail exact (tests/test_fused_halo.py:137-165);
  - K11's plain ``ring_shift_right`` and ``halo.shard_hist(dma=True)``
    (JAX's ``shard_hist_dma``) against JAX's
    remote-DMA ring shift in interpret mode on (1, 4) and (2, 4) meshes, bit
    for bit (tests/test_halo_dma.py:28,48); K11's plain halo from the
    planes (``shard_hist_planes``, with and without ``dma``, on contiguous
    and sliced planes) against JAX's ``shard_hist_dma`` on the complex of
    the same planes, bit for bit, launching nothing on the CPU;
  - the host constants bit-equal to JAX's, the last-frame dot within 1e-6
    of its peak, and the FSM's tone-sum ``period`` against JAX's.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from sdr_pmr446_tpu import config as C
from sdr_pmr446_tpu.parallel import fused_halo as JFH
from sdr_pmr446_tpu.parallel import halo as jhalo
from sdr_pmr446_tpu_torch.kernels import halo_dma, summary
from sdr_pmr446_tpu_torch.ops import decode
from sdr_pmr446_tpu_torch.parallel import fused_halo as FH
from sdr_pmr446_tpu_torch.parallel import halo

torch.set_num_threads(2)

S, D = 2, 4


def jax_mesh(n_s=S, n_t=D):
    devs = np.asarray(jax.devices()[:n_s * n_t]).reshape(n_s, n_t)
    return Mesh(devs, ("stream", "time"))


def sharded(fn, in_specs, out_specs, mesh=None):
    return jax.jit(jax.shard_map(fn, mesh=mesh or jax_mesh(),
                                 in_specs=in_specs, out_specs=out_specs,
                                 check_vma=False))


def cplx(rng, *shape, scale=1.0):
    return (scale * (rng.standard_normal(shape)
                     + 1j * rng.standard_normal(shape))).astype(np.complex64)


SD, ST = P("stream", "time"), P("stream")


def test_shard_hist_and_scalar_prev_match_jax():
    rng = np.random.default_rng(0)
    t, h = 256, 16
    x = rng.standard_normal((S, D * t)).astype(np.float32)
    carried = rng.standard_normal((S, h)).astype(np.float32)

    def body(c, xs):
        hist, new_c = jhalo.shard_hist(c, xs, h, "time")
        prev, new_p = jhalo.shard_scalar_prev(c[:, 0], xs, "time")
        return hist, new_c, prev[:, None], new_p

    jh, jc, jp, jpc = (np.asarray(a) for a in sharded(
        body, (ST, SD), (SD, ST, SD, ST))(carried, x))
    x3 = torch.from_numpy(x).reshape(S, D, t)
    hist, new_c = halo.shard_hist(torch.from_numpy(carried), x3, h)
    prev, new_p = halo.shard_scalar_prev(torch.from_numpy(carried[:, 0]), x3)
    np.testing.assert_array_equal(hist.numpy(), jh.reshape(S, D, h))
    np.testing.assert_array_equal(new_c.numpy(), jc)
    np.testing.assert_array_equal(prev.numpy(), jp.reshape(S, D))
    np.testing.assert_array_equal(new_p.numpy(), jpc)


def test_shard_pass_right_matches_jax():
    rng = np.random.default_rng(1)
    h = 400
    val = cplx(rng, S, D * h)
    carried = cplx(rng, S, h)
    jr, jc = (np.asarray(a) for a in sharded(
        lambda c, v: JFH.shard_pass_right(c, v, "time"), (ST, SD),
        (SD, ST))(carried, val))
    got, new_c = FH.shard_pass_right(torch.from_numpy(carried),
                                     torch.from_numpy(val).reshape(S, D, h))
    np.testing.assert_array_equal(got.numpy(), jr.reshape(S, D, h))
    np.testing.assert_array_equal(new_c.numpy(), jc)
    np.testing.assert_array_equal(FH.last_shard(got).numpy(),
                                  jr.reshape(S, D, h)[:, -1])


def test_shard_dc_blocker_matches_jax_and_the_sequential_scan():
    """halo.shard_biquad1 (as the DC blocker) vs JAX's under shard_map and
    vs the unsharded scan (ops/iir.py), within JAX's 2e-4."""
    from sdr_pmr446_tpu_torch.ops import iir
    rng = np.random.default_rng(2)
    t = 2048
    x = (0.3 * rng.standard_normal((S, D * t))).astype(np.float32)
    xp = rng.standard_normal(S).astype(np.float32)
    yp = rng.standard_normal(S).astype(np.float32)

    def body(a, b, xs):
        (nx, ny), y = jhalo.shard_dc_blocker((a, b), xs, C.DC_BLOCK_ALPHA,
                                             "time")
        return nx, ny, y

    jx, jy, jout = (np.asarray(a) for a in sharded(
        body, (ST, ST, SD), (ST, ST, SD))(xp, yp, x))
    (nx, ny), y = halo.shard_dc_blocker(
        (torch.from_numpy(xp), torch.from_numpy(yp)),
        torch.from_numpy(x).reshape(S, D, t), C.DC_BLOCK_ALPHA)
    (sx, sy), ref = iir.dc_blocker_apply(
        (torch.from_numpy(xp), torch.from_numpy(yp)), torch.from_numpy(x),
        C.DC_BLOCK_ALPHA)
    for want in (jout, ref.numpy()):
        np.testing.assert_allclose(y.reshape(S, -1).numpy(), want, rtol=0,
                                   atol=2e-4)
    np.testing.assert_array_equal(nx.numpy(), jx)
    np.testing.assert_array_equal(nx.numpy(), sx.numpy())
    np.testing.assert_allclose(ny.numpy(), jy, rtol=0, atol=2e-4)
    np.testing.assert_allclose(ny.numpy(), sy.numpy(), rtol=0, atol=2e-4)


@pytest.mark.parametrize("dtype,g", [(np.complex64, float(JFH._G)),
                                     (np.float32, 0.0)])
def test_compose_dc_chain_matches_jax(dtype, g):
    rng = np.random.default_rng(3)
    mk = ((lambda *s: cplx(rng, *s)) if dtype == np.complex64
          else (lambda *s: rng.standard_normal(s).astype(np.float32)))
    y0, xl = mk(S, D), mk(S, D)
    cy, cx = mk(S, 1), mk(S, 1)
    p_t1 = float(np.float64(JFH._P) ** (2048 - 1))

    def body(ye, xs, a, b):
        return JFH.compose_dc_chain(ye, xs, a, b, p_t1, g, "time")

    want = [np.asarray(a) for a in sharded(
        body, (SD, SD, ST, ST), (SD, SD, ST, ST))(y0, xl, cy, cx)]
    got = FH.compose_dc_chain(
        torch.from_numpy(y0)[..., None], torch.from_numpy(xl)[..., None],
        torch.from_numpy(cy), torch.from_numpy(cx), p_t1, g)
    for name, a, b in zip(("y_in", "delta", "new_y", "new_x"), got, want):
        a = a.numpy().reshape(b.shape)
        assert a.dtype == b.dtype, name
        peak = float(np.max(np.abs(b)))
        assert float(np.max(np.abs(a - b))) <= 1e-6 * peak, name


def jax_wire(x, fmt):
    """JAX's transport rows of the same samples (cf32 is JAX's cf32w)."""
    from sdr_pmr446_tpu.ops import decode as jdecode
    t = x.shape[0]
    if fmt == "cf32":
        w = np.empty(2 * t, np.float32)
        w[0::2], w[1::2] = x.real, x.imag
        return jnp.asarray(w.reshape(t // 128, 256)), "cf32w"
    spw = 128 if fmt == "cs16" else 256
    return jnp.asarray(jdecode.pack_iq(x, fmt).reshape(t // spw, -1)), fmt


@pytest.mark.parametrize("fmt", ["cu8", "cs8", "cs16", "cf32"])
def test_zero_summary_wire_matches_jax(fmt):
    """K10's plain version and the fold against JAX's wire-direct
    pre-pass (kernels/summary.py in interpret mode)."""
    from sdr_pmr446_tpu.kernels.summary import zero_summary_wire
    rng = np.random.default_rng(7)
    t, tail = 8 * 2048, 2560
    x = (rng.standard_normal(t) + 1j * rng.standard_normal(t)) * 0.2
    wire = torch.from_numpy(decode.quantize_iq(x, fmt))
    jw, jfmt = jax_wire(x, fmt)
    jw_sum, jxl = (np.asarray(a) for a in zero_summary_wire(
        jw, jfmt, interpret=True))
    w, xl = summary.zero_summary_wire(wire, fmt)
    assert summary.LAUNCHES == 0
    np.testing.assert_allclose(w.numpy(), jw_sum, rtol=0,
                               atol=1e-6 * float(np.max(np.abs(jw_sum))))
    np.testing.assert_array_equal(xl.numpy(), jxl)

    want = JFH.front_zero_summary_wire(jw, jfmt, t, tail, interpret=True)
    got = FH.front_zero_summary_wire(wire.reshape(1, 1, -1), fmt, t, tail)
    got = [v.reshape(v.shape[2:]).numpy() for v in got]
    np.testing.assert_allclose(got[0], complex(want[0]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[1], complex(want[1]), rtol=0, atol=1e-6)
    assert complex(got[2]) == complex(want[2])              # x_pre
    assert complex(got[3]) == complex(want[3])              # xlast
    np.testing.assert_array_equal(got[4], np.asarray(want[4]))


def test_dc_tail_exact_matches_jax():
    rng = np.random.default_rng(8)
    t, tail = 8 * 2048, 2560
    x = (rng.standard_normal(t) + 1j * rng.standard_normal(t)) * 0.2
    wire = torch.from_numpy(decode.quantize_iq(x, "cs16")).reshape(1, 1, -1)
    _, y_pre, x_pre, _, tail_x = FH.front_zero_summary_wire(wire, "cs16", t,
                                                            tail)
    delta = np.complex64(0.03 - 0.02j)
    got = FH.dc_tail_exact(tail_x, y_pre, x_pre,
                           torch.tensor([[delta]]), t)[0, 0].numpy()
    want = np.asarray(JFH.dc_tail_exact(
        jnp.asarray(tail_x[0, 0].numpy()), jnp.complex64(complex(y_pre)),
        jnp.complex64(complex(x_pre)), jnp.complex64(delta), t))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("n_s", [1, 2])
@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
def test_ring_shift_matches_jax_remote_dma(n_s, dtype):
    """K11's plain version vs JAX's ring shift (remote DMA, interpreted)
    on a (n_s, 4) mesh; shard_hist with dma vs JAX's shard_hist_dma and
    vs shard_hist without."""
    from sdr_pmr446_tpu.kernels import halo_dma as jdma
    rng = np.random.default_rng(9)
    n = 8
    x = (rng.standard_normal((n_s, D * n)) if dtype == np.float32
         else cplx(rng, n_s, D * n)).astype(dtype)
    mesh = jax_mesh(n_s, D)
    want = np.asarray(sharded(
        lambda xs: jdma.ring_shift_right(xs, "time", interpret=True),
        SD, SD, mesh)(x))
    x3 = torch.from_numpy(x).reshape(n_s, D, n)
    got = halo_dma.ring_shift_right(x3)
    np.testing.assert_array_equal(got.reshape(n_s, -1).numpy(), want)

    h = 5
    carried = x[:, :h] * 2
    jh, jc = (np.asarray(a) for a in sharded(
        functools.partial(jdma.shard_hist_dma, hist_len=h, axis="time",
                          interpret=True), (ST, SD), (SD, ST), mesh)(
        carried, x))
    hist, new_c = halo.shard_hist(torch.from_numpy(carried), x3, h, dma=True)
    np.testing.assert_array_equal(hist.numpy(), jh.reshape(n_s, D, h))
    np.testing.assert_array_equal(new_c.numpy(), jc)
    ref = halo.shard_hist(torch.from_numpy(carried), x3, h)
    for a, b in zip((hist, new_c), ref):
        assert torch.equal(a, b)
    assert halo_dma.LAUNCHES == 0


def test_one_time_shard_moves_nothing():
    x = torch.arange(12.0).reshape(2, 1, 6)
    carried = -torch.ones(2, 3)
    for dma in (False, True):
        hist, new_c = halo.shard_hist(carried, x, 3, dma)
        assert torch.equal(hist, carried[:, None])
        assert torch.equal(new_c, x[:, 0, -3:])
    # the halo from the planes [S, 1, 2, T], also by K11's own entry
    planes = torch.arange(24.0).reshape(2, 1, 2, 6)
    carried = carried.to(torch.complex64)
    tail = torch.complex(planes[:, 0, 0, -3:], planes[:, 0, 1, -3:])
    for hist, new_c in (halo.shard_hist_planes(carried, planes, 3, False),
                        halo.shard_hist_planes(carried, planes, 3, True),
                        halo_dma.shard_hist_planes(carried, planes, 3)):
        assert torch.equal(hist, carried[:, None])
        assert torch.equal(new_c, tail)


@pytest.mark.parametrize("n_s", [1, 2])
def test_shard_hist_planes_matches_jax_shard_hist_dma(n_s):
    """K11's halo from the planes [S, D, 2, T] vs JAX's shard_hist_dma
    (remote DMA, interpreted) on the complex of the same planes, on a
    (n_s, 4) mesh, bit for bit: the kernel module's entry and
    halo.shard_hist_planes with dma and without, on contiguous planes and
    on planes sliced out of longer ones; nothing launches on the CPU."""
    from sdr_pmr446_tpu.kernels import halo_dma as jdma
    rng = np.random.default_rng(11)
    t, h = 12, 5
    longer = rng.standard_normal((n_s, D, 3, t + 7)).astype(np.float32)
    planes = np.ascontiguousarray(longer[:, :, 1:, 3:3 + t])
    carried = cplx(rng, n_s, h)
    x = (planes[:, :, 0] + 1j * planes[:, :, 1]).astype(np.complex64)
    jh, jc = (np.asarray(a) for a in sharded(
        functools.partial(jdma.shard_hist_dma, hist_len=h, axis="time",
                          interpret=True), (ST, SD), (SD, ST),
        jax_mesh(n_s, D))(carried, x.reshape(n_s, D * t)))
    launches = halo_dma.LAUNCHES
    ct = torch.from_numpy(carried)
    for pt in (torch.from_numpy(planes),
               torch.from_numpy(longer)[:, :, 1:, 3:3 + t]):
        for hist, new_c in (halo_dma.shard_hist_planes(ct, pt, h),
                            halo.shard_hist_planes(ct, pt, h, dma=True),
                            halo.shard_hist_planes(ct, pt, h)):
            np.testing.assert_array_equal(hist.numpy(),
                                          jh.reshape(n_s, D, h))
            np.testing.assert_array_equal(new_c.numpy(), jc)
    assert halo_dma.LAUNCHES == launches == 0


@pytest.mark.parametrize("t_local,hist_len", [(8 * 2048, 384),
                                              (8 * C.SUBCHUNK_IN, 512)])
def test_front_end_consts_bit_equal(t_local, hist_len):
    got = FH.front_end_consts(t_local, hist_len)
    want = JFH.front_end_consts(t_local, hist_len)
    assert got.keys() == want.keys()
    for name in got:
        np.testing.assert_array_equal(np.asarray(got[name]),
                                      np.asarray(want[name]), err_msg=name)


def test_pre_pass_and_ctcss_consts_bit_equal():
    np.testing.assert_array_equal(FH.dc_row_weights(), JFH.dc_row_weights())
    for key in ((8 * C.SUBCHUNK_IN, 2560), (16 * 2048, 7040)):
        got, want = FH._zero_summary_consts(*key), JFH._zero_summary_consts(*key)
        assert got.keys() == want.keys()
        for name in got:
            np.testing.assert_array_equal(np.asarray(got[name]),
                                          np.asarray(want[name]))
    for key in ((8, C.SUBCHUNK_AUDIO), (10, C.SUBCHUNK_AUDIO)):
        got, want = FH.ctcss_corr_consts(*key), JFH.ctcss_corr_consts(*key)
        for name in got:
            np.testing.assert_array_equal(np.asarray(got[name]),
                                          np.asarray(want[name]))


def test_correct_raw_sums_and_band_match_jax():
    rng = np.random.default_rng(10)
    kl, ns = 8, C.SUBCHUNK_AUDIO
    pre, mem = cplx(rng, kl, 38), cplx(rng, kl, 38)
    delta = rng.standard_normal(kl).astype(np.float32)
    b = rng.integers(-3, ns + 5, kl).astype(np.int32)
    want = JFH.correct_raw_sums(jnp.asarray(pre), jnp.asarray(mem),
                                jnp.asarray(delta), jnp.asarray(b),
                                JFH.ctcss_corr_consts(kl, ns), ns)
    got = FH.correct_raw_sums(torch.from_numpy(pre), torch.from_numpy(mem),
                              torch.from_numpy(delta), torch.from_numpy(b),
                              kl, ns)
    for a, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(a.numpy(), w, rtol=0,
                                   atol=1e-6 * float(np.max(np.abs(w))))
    t_local, h = 8 * 2048, 384
    g = t_local // 2048
    bw = rng.standard_normal((g, 400)).astype(np.float32)
    hist = rng.standard_normal(h).astype(np.float32)
    want = np.asarray(JFH.correct_band(jnp.asarray(bw), jnp.float32(0.3),
                                       jnp.asarray(hist),
                                       JFH.front_end_consts(t_local, h)))
    got = FH.correct_band(torch.from_numpy(bw), torch.tensor(0.3),
                          torch.from_numpy(hist), t_local, h).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_last_frame_output_matches_jax():
    from sdr_pmr446_tpu.kernels.pfb_demod import last_frame_output as jlfo
    from sdr_pmr446_tpu_torch.kernels.pfb_demod import last_frame_output
    rng = np.random.default_rng(11)
    tr, ti = (rng.standard_normal((2, 416)).astype(np.float32)
              for _ in range(2))
    sign = np.asarray([1.0, -1.0], np.float32)
    got = last_frame_output(torch.from_numpy(tr), torch.from_numpy(ti),
                            torch.from_numpy(sign)).numpy()
    for i in range(2):
        want = np.asarray(jlfo(jnp.asarray(tr[i]), jnp.asarray(ti[i]),
                               jnp.float32(sign[i])))
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got[i], want, rtol=0,
                                   atol=1e-6 * float(np.max(np.abs(want))))


def test_raw_sums_to_ctcss_period_matches_jax():
    """fsm.raw_sums_to_ctcss(period=K_local) against JAX's at k = 16,
    period = 8; period=None is bit-equal to the table without a period."""
    from sdr_pmr446_tpu.scanner import fsm as jfsm
    from sdr_pmr446_tpu_torch.scanner import fsm as tfsm
    rng = np.random.default_rng(12)
    k, ns = 16, C.SUBCHUNK_AUDIO
    np.testing.assert_array_equal(tfsm._window_corr_table(k, ns, 8),
                                  jfsm._window_corr_table(k, ns, 8))
    np.testing.assert_array_equal(tfsm._window_corr_table(k, ns, None),
                                  tfsm._window_corr_table(k, ns))
    np.testing.assert_array_equal(tfsm._window_corr_table(k, ns, k),
                                  jfsm._window_corr_table(k, ns))
    rssi = (rng.standard_normal((k, 16)) * 5 - 60).astype(np.float32)
    rssi[:, 4] += 40.0
    jcarry = jfsm.FsmCarry(jnp.int32(0), jnp.int32(-1), jnp.float32(0.0),
                           jnp.int32(0), jnp.zeros(38, jnp.complex64),
                           jnp.bool_(False), jnp.int32(0), jnp.float32(-1.0))
    tcarry = tfsm.FsmCarry(*(torch.from_numpy(np.array(v)) for v in jcarry))
    args = (C.ScannerArgs().squelch_level, True)
    js = jfsm.fsm_phase_a(jcarry, jnp.asarray(rssi), jnp.ones(16, bool),
                          jnp.float32(args[0]), jnp.asarray(args[1]), ns)
    ts = tfsm.fsm_phase_a(tcarry, torch.from_numpy(rssi),
                          torch.ones(16, dtype=torch.bool),
                          torch.tensor(args[0], dtype=torch.float32),
                          torch.tensor(args[1]), ns)
    raw_pre, raw_mem = cplx(rng, k, 38), cplx(rng, k, 38)
    want = jfsm.raw_sums_to_ctcss(js, jnp.asarray(raw_pre),
                                  jnp.asarray(raw_mem), ns, period=8)
    got = tfsm.raw_sums_to_ctcss(ts, torch.from_numpy(raw_pre),
                                 torch.from_numpy(raw_mem), ns, period=8)
    for a, w in zip(got, want):      # test_torch_fsm.py's gate
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-4)
    none = tfsm.raw_sums_to_ctcss(ts, torch.from_numpy(raw_pre),
                                  torch.from_numpy(raw_mem), ns)
    full = tfsm.raw_sums_to_ctcss(ts, torch.from_numpy(raw_pre),
                                  torch.from_numpy(raw_mem), ns, period=k)
    for a, b in zip(none, full):
        assert torch.equal(a, b)


def test_k10_k11_wrappers_reject_bad_inputs():
    with pytest.raises(ValueError, match="whole 128-sample rows"):
        summary.zero_summary_wire(torch.zeros(3, dtype=torch.uint8), "cu8")
    with pytest.raises(ValueError, match="unsupported"):
        summary.zero_summary_wire(torch.zeros(512, dtype=torch.uint8), "u16")
    with pytest.raises(ValueError, match="no zero-summary implementation"):
        summary.zero_summary_wire(
            torch.zeros(512, dtype=torch.uint8, device="meta"), "cu8")
    with pytest.raises(ValueError, match=r"\[S, D, \.\.\.\]"):
        halo_dma.ring_shift_right(torch.zeros(5))
    with pytest.raises(ValueError, match="no ring shift"):
        halo_dma.ring_shift_right(torch.zeros(2, 2, device="meta"))
    c = torch.zeros(2, 3, dtype=torch.complex64)
    for planes, h in ((torch.zeros(2, 2, 3, 4), 3),     # 3 planes
                      (torch.zeros(2, 2, 2, 2), 3),     # T < h
                      (torch.zeros(2, 2, 2, 4, dtype=torch.float64), 3)):
        with pytest.raises(ValueError, match=r"f32 \[S, D, 2, T\]"):
            halo_dma.shard_hist_planes(c, planes, h)
    with pytest.raises(ValueError, match=r"carried must be c64 \[2, 3\]"):
        halo_dma.shard_hist_planes(c[:1], torch.zeros(2, 2, 2, 4), 3)
    with pytest.raises(ValueError, match="no halo for device"):
        halo_dma.shard_hist_planes(c.to("meta"),
                                   torch.zeros(2, 2, 2, 4, device="meta"), 3)
    with pytest.raises(ValueError, match="must be contiguous"):
        halo_dma.shard_hist_planes_kernel(
            c, torch.zeros(2, 2, 4, 2).transpose(2, 3), 3)
    with pytest.raises(ValueError, match="a shard is"):
        FH.front_zero_summary_wire(torch.zeros(1, 2, 300, dtype=torch.uint8),
                                   "cu8", 128, 128)

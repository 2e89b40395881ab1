"""The port's waterfall (ops/spectrogram, K3, the -w scanner) vs the JAX package.

On the CPU the K3 wrapper (kernels/waterfall.py) takes its plain version,
ops/spectrogram.py::asgram_rows_any_p; it is held to the JAX spectrogram
ops, to the float64 per-sample asgramcf oracle, and, inside the scanner
chain, to the JAX duo engine whose kernel computes the waterfall in-kernel
(run in interpret mode).  Rows are compared in dB: atol 2e-3 against the
JAX package (the waterfall gate of tests/test_scanner.py:341-378) and 1e-2
against the oracle (tests/test_driver_apps.py:140-173).  The ``cuda`` tests
hold the CUDA kernel to its plain version on the card and skip here:

    python -m pytest tests/test_torch_waterfall.py -m cuda --noconftest -q
"""

import re

import numpy as np
import pytest
import torch

from sdr_pmr446_tpu_torch import config as C
from sdr_pmr446_tpu_torch.io import synth
from sdr_pmr446_tpu_torch.kernels import duo
from sdr_pmr446_tpu_torch.kernels import waterfall as kwf
from sdr_pmr446_tpu_torch.ops import decode, spectrogram
from sdr_pmr446_tpu_torch.oracle.chain import AsgramStream
from sdr_pmr446_tpu_torch.runtime import state as tstate
from sdr_pmr446_tpu_torch.scanner.chain import (ScannerChain,
                                                make_runtime_params,
                                                outputs_to_numpy)

torch.set_num_threads(2)

SUB = C.SUBCHUNK_RESAMP
TOL_JAX_DB = 2e-3
TOL_ORACLE_DB = 1e-2


def cplx(rng, *shape, scale):
    return np.asarray(scale * (rng.standard_normal(shape)
                               + 1j * rng.standard_normal(shape)),
                      np.complex64)


def band_planes(rng, k, step):
    """Band planes f32 [2, k*SUB]: two tones and noise, continuing across
    steps."""
    n = k * SUB
    t = np.arange(n) + step * n
    x = (0.5 * np.exp(2j * np.pi * 0.0123 * t) + 0.2 * np.exp(
        -2j * np.pi * 0.31 * t) + cplx(rng, n, scale=0.05))
    return np.stack([x.real, x.imag]).astype(np.float32)


# ---------------------------------------------------------------- (a) ops
@pytest.mark.parametrize("w", [-4, 0, 6, 7, 8, 64, 120, 840, 78400, 78404])
def test_validate_width_matches_jax(w):
    """Same widths accepted, same errors raised."""
    from sdr_pmr446_tpu.ops import spectrogram as js
    try:
        js.validate_width(w)
        want = None
    except ValueError as e:
        want = str(e)
    if want is None:
        spectrogram.validate_width(w)
    else:
        with pytest.raises(ValueError, match=re.escape(want)):
            spectrogram.validate_width(w)


@pytest.mark.parametrize("w", [8, 64, 80, 120, 840])
def test_numpy_constants_bit_equal(w):
    """The NumPy constants re-derived in the port equal JAX's."""
    from sdr_pmr446_tpu.ops import spectrogram as js
    for name in ("_window", "_dft_win_packed"):
        got, want = getattr(spectrogram, name)(w), getattr(js, name)(w)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=name)
    for k in (1, 2, 8, 40):
        np.testing.assert_array_equal(spectrogram.wf_row_counts(w, k),
                                      js.wf_row_counts(w, k))
    assert spectrogram.uses_fast_path(w) == js.uses_fast_path(w)
    assert spectrogram.hist_len(w) == js.hist_len(w)


def test_rows_from_psd_sums_matches_jax():
    import jax.numpy as jnp
    from sdr_pmr446_tpu.ops import spectrogram as js
    rng = np.random.default_rng(2)
    sums = rng.uniform(0.0, 3.0, (3, 120)).astype(np.float32)
    sums[1, 7] = 0.0
    counts = spectrogram.wf_row_counts(120, 3)
    got = spectrogram.rows_from_psd_sums(torch.from_numpy(sums), 120,
                                         counts=torch.from_numpy(counts))
    want = js.rows_from_psd_sums(jnp.asarray(sums), 120, counts=counts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    got = spectrogram.rows_from_psd_sums(torch.from_numpy(sums[:, :64]), 64)
    want = js.rows_from_psd_sums(jnp.asarray(sums[:, :64]), 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


# ------------------------------------------------ K3's FFT plan, in NumPy
# the R-point DFTs of the kernel's butterflies (csrc/waterfall.cu dft)
BUTTERFLY = {r: np.exp(-2j * np.pi * np.outer(np.arange(r), np.arange(r)) / r)
             for r in (2, 3, 4, 5, 7, 8, 16)}


def stockham(x, stw):
    """The kernel's Stockham stages (csrc/waterfall.cu fft_stage, the
    same index arithmetic) on the rows of x [..., L], in float64; ``stw``
    the plan's L - 1 stage twiddles of that length."""
    length = x.shape[-1]
    assert stw.shape == (length - 1,)
    ns, off = 1, 0
    for r_ in kwf.radices(length):
        q = length // r_
        j = np.arange(q)
        k = j % ns
        v = [x[..., j + r * q] * (stw[off + (r - 1) * ns + k] if r else 1)
             for r in range(r_)]
        out = np.empty_like(x)
        base = (j - k) * r_ + k
        for s in range(r_):
            out[..., base + s * ns] = sum(BUTTERFLY[r_][s, r] * v[r]
                                          for r in range(r_))
        x, off, ns = out, off + (r_ - 1) * ns, ns * r_
    return x


def prime_factors(n):
    """The prime factors of n, with repeats."""
    out, p = [], 2
    while n > 1:
        while n % p == 0:
            out.append(p)
            n //= p
        p += 1
    return out


def run_plan(plan, xw):
    """What the kernel's passes leave at points f < w for one window of
    w/2 samples ``xw``: S_f for a power of two, conj(S_f / c_f) through
    Bluestein; each pass with the kernel's layout (wf_hops, or wf_cols
    then wf_rowfft's MID and FINAL modes) and twiddle offsets."""
    w, m, m1 = plan.w, plan.m, plan.m1
    a = np.zeros(m, np.complex128)
    a[:w // 2] = plan.pre * xw
    if not m1:
        y = stockham(a, plan.tw)
        if plan.filt is not None:
            y = stockham(np.conj(y * plan.filt), plan.tw)
        return y[:w]
    m2 = m // m1
    st1, st2 = plan.tw[:m1 - 1], plan.tw[m1 - 1:m1 + m2 - 2]
    wm = plan.tw[m1 + m2 - 2:]
    assert wm.shape == (m,)
    # wf_cols: columns n2 of x[m2 n1 + n2], m1-point FFTs, W_m^(n2 k1)
    y = stockham(a.reshape(m1, m2).T, st1)                 # [n2, k1]
    t_rows = (y * wm[np.arange(m2)[:, None] * np.arange(m1)]).T  # [k1, n2]
    # wf_rowfft: m2-point row FFTs; point i of row rho is rho + m1 i
    y = stockham(t_rows, st2)                              # [k1, k2]
    if plan.filt is None:
        return y.T.reshape(-1)[:w]
    rho, i = np.arange(m1)[:, None], np.arange(m2)[None, :]
    z = stockham(np.conj(y * plan.filt[rho + m1 * i]), st2)
    y = stockham((z * wm[rho * i]).T, st1)                 # [k1', k2']
    return y.T.reshape(-1)[:w]                             # k1' + m2 k2'


@pytest.mark.parametrize("w", [8, 64, 80, 120, 132, 840, 4096, 8192, 16384,
                               78400])
def test_fft_plan_matches_numpy_fft(w):
    """K3's host-side plan (radices, Bluestein's m and chirp, the
    four-step split), run stage by stage in float64 NumPy with the
    kernel's index arithmetic: within 1e-12 of the peak of np.fft.fft of
    the windowed, zero-padded window; the tables O(w), not O(w^2)."""
    plan = kwf.make_plan(w)
    wl = w // 2
    odd = w >> ((w & -w).bit_length() - 1)
    direct = odd == 1 or (w <= kwf.CAP and all(
        p in (3, 5, 7) for p in prime_factors(odd)))
    blue = not direct
    m = 1 << int(np.ceil(np.log2(wl + w - 1))) if blue else w
    assert plan.m == m and (plan.filt is not None) == blue
    assert int(np.prod(kwf.radices(m))) == m
    if m <= kwf.CAP:
        assert plan.m1 == 0 and 1 <= plan.nt and plan.nt * m <= kwf.CAP
    else:
        m2 = m // plan.m1
        assert plan.m1 * m2 == m and plan.m1 <= m2 <= kwf.BATCH
    mod = kwf.Waterfall(w, device="cpu")
    n_tw = m - 1 if m <= kwf.CAP else plan.m1 + m // plan.m1 - 2 + m
    assert sum(b.numel() for b in mod.buffers()) == wl + m * blue + n_tw
    rng = np.random.default_rng(w)
    xw = cplx(rng, wl, scale=1.0).astype(np.complex128)
    win = np.hamming(wl + 1)[:wl]
    want = np.fft.fft(win / win.sum() * xw, n=w)
    got = run_plan(plan, xw)
    if blue:
        got = kwf.chirp(w, np.arange(w)) * np.conj(got)
    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert err <= 1e-12, err


# ------------------------------------------------------ (b) K3 plain vs JAX
@pytest.mark.parametrize("w", [64, 80, 96, 120, 840])
def test_plain_matches_jax_spectrogram(w):
    """Two consecutive K = 2 calls from a non-zero history (and counter,
    for the widths whose hop does not divide the sub-chunk: K * 19600 is
    not a multiple of the hop there, so the counter moves): rows within
    2e-3 dB, history and counter exact.  The module's launch count stays."""
    import jax.numpy as jnp
    from sdr_pmr446_tpu.ops import spectrogram as js
    k = 2
    rng = np.random.default_rng(w)
    wl, delay = w // 2, w // 4
    fast = js.uses_fast_path(w)
    hist = cplx(rng, wl, scale=0.1)
    cnt = 0 if fast else int(rng.integers(1, delay))
    jh, jc = jnp.asarray(hist), jnp.asarray(np.int32(cnt))
    th = torch.from_numpy(hist.copy())
    tc = torch.tensor(cnt, dtype=torch.int32)
    mod = kwf.Waterfall(w, device="cpu")
    launches = kwf.LAUNCHES
    for step in range(2):
        band = band_planes(rng, k, step)
        jb = [jnp.asarray(band[0]), jnp.asarray(band[1])]
        if fast:
            jh, jr = js.asgram_rows_p(jh, *jb, k, w)
            ph, pr = spectrogram.asgram_rows_p(th, *torch.from_numpy(band),
                                               k, w)
            np.testing.assert_allclose(pr.numpy(), np.asarray(jr), rtol=0,
                                       atol=TOL_JAX_DB)
            np.testing.assert_array_equal(ph.numpy(), np.asarray(jh))
        else:
            jh, jc, jr = js.asgram_rows_any_p(jh, jc, *jb, k, w)
        out = mod(torch.from_numpy(band), th, tc)
        assert out.rows.shape == (k, w) and out.rows.dtype == torch.float32
        np.testing.assert_allclose(out.rows.numpy(), np.asarray(jr), rtol=0,
                                   atol=TOL_JAX_DB, err_msg=f"step {step}")
        np.testing.assert_array_equal(out.hist.numpy(), np.asarray(jh))
        assert out.cnt.dtype == torch.int32 and int(out.cnt) == int(jc)
        th, tc = out.hist, out.cnt
    assert fast or int(tc) != cnt
    assert kwf.LAUNCHES == launches


def test_module_rejects_bad_inputs():
    mod = kwf.Waterfall(64, device="cpu")
    zero = torch.zeros((), dtype=torch.int32)
    with pytest.raises(ValueError, match="band must be"):
        mod(torch.zeros(2, SUB + 1), torch.zeros(32, dtype=torch.complex64),
            zero)
    with pytest.raises(ValueError, match="hist needs"):
        mod(torch.zeros(2, SUB), torch.zeros(31, dtype=torch.complex64),
            zero)
    with pytest.raises(ValueError, match="no waterfall implementation"):
        mod(torch.zeros(2, SUB, device="meta"), None, None)
    for w in (0, 6):
        with pytest.raises(ValueError):
            kwf.Waterfall(w, device="cpu")
    # a counter out of [0, w/4) (a loaded state) is taken modulo the hop
    band = torch.from_numpy(band_planes(np.random.default_rng(1), 1, 0))
    hist = torch.zeros(32, dtype=torch.complex64)
    outs = [mod(band, hist, torch.tensor(c, dtype=torch.int32))
            for c in (7, 23, -9)]
    for o in outs[1:]:
        assert torch.equal(o.rows, outs[0].rows)
        assert int(o.cnt) == int(outs[0].cnt) == 7


# ------------------------------------------------ (c) K3 plain vs the oracle
def duo_bands(wires, fmt="cu8"):
    """The port's band planes of consecutive wire blocks (K1's plain
    version, carried state from zero)."""
    d = duo.ScannerDuo(fmt, device="cpu")
    c = torch.zeros((), dtype=torch.complex64)
    st = [c, c, torch.zeros(d.front_hist_len, dtype=torch.complex64),
          torch.zeros(400, dtype=torch.complex64),
          torch.zeros((), dtype=torch.int32),
          torch.zeros(16, dtype=torch.complex64)]
    out = []
    for wire in wires:
        o = d(torch.from_numpy(wire), *st)
        st = [o.dc_x, o.dc_y, o.front_hist, o.pfb_hist, o.parity, o.prev]
        out.append(o.band)
    return out


@pytest.mark.parametrize("w", [64, 120])
def test_plain_matches_asgram_oracle(w):
    """K3's plain version on the port's band (two K = 2 blocks of a cu8
    capture) vs the float64 per-sample asgramcf emulation fed the same
    band, window and counter continuity across the blocks included."""
    k = 2
    iq = synth.make_scanner_iq(2 * k * C.SUBCHUNK_IN, channel=5,
                               ctcss_code=12)
    raw = decode.quantize_iq(iq, "cu8")
    step = k * C.SUBCHUNK_IN * 2
    bands = duo_bands([raw[i * step:(i + 1) * step] for i in range(2)])
    mod = kwf.Waterfall(w, device="cpu")
    hist = torch.zeros(w // 2, dtype=torch.complex64)
    cnt = torch.zeros((), dtype=torch.int32)
    asg = AsgramStream(w)
    for band in bands:
        hist, cnt, rows = mod(band, hist, cnt)
        z = band[0].double().numpy() + 1j * band[1].double().numpy()
        for r in range(k):
            asg.write(z[r * SUB:(r + 1) * SUB])
            np.testing.assert_allclose(rows[r].numpy(), asg.execute(),
                                       rtol=0, atol=TOL_ORACLE_DB)
    assert int(cnt) == asg.counter


@pytest.mark.parametrize("w", [64, 840])
def test_chain_reads_the_right_history(w):
    """Two K = 1 chain steps give the rows of one K = 2 call on the same
    band: the window history crosses the step boundary — from the PFB
    history's tail for w <= 800, from the carried wf_hist beyond."""
    iq = synth.make_scanner_iq(2 * C.SUBCHUNK_IN, channel=5, ctcss_code=12)
    raw = decode.quantize_iq(iq, "cu8")
    chain = ScannerChain(C.BlockConfig(1), input_format="cu8", device="cpu",
                         waterfall=w)
    params = make_runtime_params(C.ScannerArgs(), "cpu")
    st = chain.init_state()
    assert st.wf_hist.shape == (w // 2,)
    rows = []
    step = chain.step_arg_len
    for i in range(2):
        st, o = chain.step(st, torch.from_numpy(raw[i * step:(i + 1) * step]),
                           params)
        rows.append(o.waterfall)
    bands = duo_bands([raw[:step], raw[step:]])
    ref = kwf.Waterfall(w, device="cpu").plain(
        torch.cat(bands, dim=1), torch.zeros(w // 2, dtype=torch.complex64),
        torch.zeros((), dtype=torch.int32))
    np.testing.assert_allclose(torch.cat(rows).numpy(), ref.rows.numpy(),
                               rtol=0, atol=1e-3)
    np.testing.assert_array_equal(st.wf_hist.numpy(), ref.hist.numpy())
    assert int(st.wf_cnt) == int(ref.cnt)


# ------------------------------------------- (d) the slice vs the JAX duo
K = 8
W = 64


@pytest.fixture(scope="module")
def jax_wf_run():
    """Two K = 8 steps of the JAX duo engine with the waterfall computed
    in-kernel (w = 64), on a cu8 capture: wire bytes, outputs, states."""
    import jax.numpy as jnp
    from sdr_pmr446_tpu.io import synth as jsynth
    from sdr_pmr446_tpu.ops import decode as jdecode
    from sdr_pmr446_tpu.ops import spectrogram as js
    from sdr_pmr446_tpu.scanner.chain import ScannerChain as JaxChain
    from sdr_pmr446_tpu.scanner.chain import make_runtime_params as jparams
    from sdr_pmr446_tpu import config as JC
    assert js.kernel_wf_supported(W, k=K)
    iq = jsynth.make_scanner_iq(2 * K * JC.SUBCHUNK_IN, channel=5,
                                ctcss_code=12)
    words = jdecode.pack_iq(iq, "cu8")
    chain = JaxChain(JC.BlockConfig(K), use_pallas=True, pallas_interpret=True,
                     input_format="cu8", waterfall=W)
    assert chain.fuse_band
    params = jparams(JC.ScannerArgs(waterfall=W))
    st = chain.init_state()
    states, outs, wires = [[np.asarray(v) for v in st]], [], []
    wl = chain.step_arg_len
    for i in range(2):
        w = words[i * wl:(i + 1) * wl]
        st, o = chain.step(st, jnp.asarray(w).reshape(chain.step_arg_shape),
                           params)
        outs.append({f: np.asarray(v) for f, v in zip(o._fields, o)})
        states.append([np.asarray(v) for v in st])
        wires.append(w.view(np.uint8).copy())
    return dict(wires=wires, outs=outs, states=states)


def assert_step_matches(port: dict, ref: dict, what: str):
    from test_torch_chain import assert_outputs_match
    assert_outputs_match(port, ref, what)
    assert port["waterfall"].shape == ref["waterfall"].shape == (K, W)
    np.testing.assert_allclose(port["waterfall"], ref["waterfall"], rtol=0,
                               atol=TOL_JAX_DB, err_msg=what)


def wf_chain():
    return ScannerChain(C.BlockConfig(K), input_format="cu8", device="cpu",
                        waterfall=W)


def assert_same_layout(state, reference):
    for name, cur, ref in zip(tstate.ScannerState._fields, state, reference):
        assert (tuple(cur.shape), cur.dtype) == (ref.shape, ref.dtype), name


def test_slice_with_waterfall_matches_jax_duo(jax_wf_run):
    """Decisions and events exact, the other floats as the waterfall-off
    slice test, rows within 2e-3 dB; the state has the JAX layout."""
    chain = wf_chain()
    st = chain.init_state()
    assert_same_layout(tstate.state_to_numpy(st), jax_wf_run["states"][0])
    params = make_runtime_params(C.ScannerArgs(waterfall=W), "cpu")
    for i in range(2):
        st, o = chain.step(st, torch.from_numpy(jax_wf_run["wires"][i]),
                           params)
        assert_step_matches(outputs_to_numpy(o), jax_wf_run["outs"][i],
                            f"step {i}")
        back = tstate.state_to_numpy(st)
        assert_same_layout(back, jax_wf_run["states"][i + 1])
        # the port writes the history the JAX in-kernel engine leaves
        # stale: the last w/2 band samples, which end the PFB history
        np.testing.assert_array_equal(back[-2], back[3][-W // 2:])
        assert int(st.wf_cnt) == 0


def test_waterfall_state_handoff_from_jax(jax_wf_run):
    """The JAX state after step 1 (wf_hist left zero by its in-kernel
    waterfall) loads into the port, whose step 2 gives JAX's step 2."""
    chain = wf_chain()
    st = tstate.state_from_numpy(jax_wf_run["states"][1], "cpu")
    assert_same_layout(tstate.state_to_numpy(st), jax_wf_run["states"][1])
    assert not np.any(jax_wf_run["states"][1][-2])
    _, o = chain.step(st, torch.from_numpy(jax_wf_run["wires"][1]),
                      make_runtime_params(C.ScannerArgs(waterfall=W), "cpu"))
    assert_step_matches(outputs_to_numpy(o), jax_wf_run["outs"][1], "resumed")


# ------------------------------------------------ (e) the driver, (f) CLI
def test_driver_waterfall_matches_jax_driver(tmp_path, caplog):
    """ScannerDriver(waterfall=120) on the CPU: rows [n_sub, 120] within
    1e-2 dB of the JAX driver's (its op path, cs16) on the same capture,
    the same events, returned but not logged."""
    import logging
    from sdr_pmr446_tpu.io import iq as iq_io
    from sdr_pmr446_tpu.ops import decode as jdecode
    from sdr_pmr446_tpu.runtime.driver import ScannerDriver as JaxDriver
    from sdr_pmr446_tpu import config as JC
    from sdr_pmr446_tpu_torch.runtime.driver import ScannerDriver, wire_blocks
    path = tmp_path / "cap.cs16"
    iq_io.write_iq(str(path), 0.7 * synth.make_scanner_iq(
        10 * C.SUBCHUNK_IN, channel=5, ctcss_code=12), "cs16")
    raw = np.fromfile(path, dtype=np.uint8)
    jd = JaxDriver(JC.ScannerArgs(waterfall=120), subchunks_per_step=5,
                   input_format="cs16", engine="xla")
    jres = jd.run(iq_io.block_stream(jdecode.pack_bytes(
        raw.view(np.int16), "cs16"), jd.feed_len))
    seen = []
    td = ScannerDriver(C.ScannerArgs(waterfall=120), subchunks_per_step=5,
                       input_format="cs16", device="cpu",
                       on_subchunk=lambda sub, o: seen.append(
                           (sub, o["waterfall"].shape)))
    with caplog.at_level(logging.INFO, logger="sdr_pmr446"):
        tres = td.run(wire_blocks(raw, "cs16", td.feed_len))
    assert tres.waterfall.shape == (10, 120) == jres.waterfall.shape
    np.testing.assert_allclose(tres.waterfall, jres.waterfall, rtol=0,
                               atol=TOL_ORACLE_DB)
    assert tres.events == jres.events
    assert any(e.startswith("Tuned to channel 5") for e in tres.events)
    assert not any(r.getMessage() in tres.events for r in caplog.records)
    assert seen == [(i, (120,)) for i in range(10)]


def test_app_prints_waterfall_on_cpu(tmp_path, capsys):
    """The CLI with -w 64 --device cpu: one waterfall line and one footer
    per sub-chunk (three of the 0.3 s synthetic signal), exit 0."""
    from sdr_pmr446_tpu_torch.apps import sdr_pmr446 as app
    out = tmp_path / "a.wav"
    rc = app.main(["-w", "64", "--device", "cpu", "--seconds", "0.3",
                   "--subchunks-per-step", "1", "--output", str(out)])
    assert rc == 0 and out.exists()
    text = capsys.readouterr().out
    lines = re.findall(r" > (.{64}) < pk *-?\d+\.\ddB \[ *-?\d\.\d\d\] "
                       r"\[max SNR: *-?\d+\.\ddB\]", text)
    assert len(lines) == 3, text
    assert text.count("446.100 MHz") == 3
    assert "[CTCSS:  12 (100.00Hz)]" in text


# -------------------------------------------------------- (g) on the card
def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("w,k", [(80, 40), (120, 40), (132, 10), (840, 40),
                                 (64, 10), (8192, 10), (16384, 10)])
def test_waterfall_kernel_matches_plain_on_card(w, k):
    """The CUDA kernel vs its plain version over two consecutive blocks
    from a non-zero history and counter: rows within 2e-3 dB, history to
    5e-5 of its peak, counter exact, one launch a call, and a second call
    on the same inputs bit-equal to the first."""
    dev = _cuda_or_skip()
    rng = np.random.default_rng(w + k)
    mod = kwf.Waterfall(w, device=dev)
    pfb_hist = torch.as_tensor(cplx(rng, 400, scale=0.1), device=dev)
    hist = pfb_hist if w <= 800 else torch.as_tensor(
        cplx(rng, w // 2, scale=0.1), device=dev)
    cnt = torch.tensor(int(rng.integers(0, w // 4)), dtype=torch.int32,
                       device=dev)
    ref_h, ref_c, got_h, got_c = hist, cnt, hist, cnt
    for step in range(2):
        band = torch.as_tensor(band_planes(rng, k, step), device=dev)
        launches = kwf.LAUNCHES
        ref = mod.plain(band, ref_h, ref_c)
        got = mod(band, got_h, got_c)
        torch.cuda.synchronize(dev)
        assert kwf.LAUNCHES == launches + 1
        np.testing.assert_allclose(got.rows.cpu().numpy(),
                                   ref.rows.cpu().numpy(), rtol=0,
                                   atol=TOL_JAX_DB)
        scale = ref.hist.abs().max().item()
        assert (got.hist - ref.hist).abs().max().item() <= 5e-5 * scale
        assert int(got.cnt) == int(ref.cnt)
        again = mod(band, got_h, got_c)
        for a, b in zip(again, got):
            assert torch.equal(a, b)
        ref_h, ref_c, got_h, got_c = ref.hist, ref.cnt, got.hist, got.cnt


@pytest.mark.cuda
def test_waterfall_chain_step_makes_no_host_reads_on_card():
    """A warmed-up -w 80 chain step on the card runs under
    torch.cuda.set_sync_debug_mode("error"), K3 launched once."""
    dev = _cuda_or_skip()
    k = 10
    chain = ScannerChain(C.BlockConfig(k), input_format="cu8", device=dev,
                         waterfall=80)
    params = make_runtime_params(C.ScannerArgs(waterfall=80), dev)
    iq = synth.make_scanner_iq(2 * k * C.SUBCHUNK_IN, channel=5,
                               ctcss_code=12)
    raw = decode.quantize_iq(iq, "cu8")
    n = chain.step_arg_len
    wires = [torch.as_tensor(raw[i * n:(i + 1) * n], device=dev)
             for i in range(2)]
    state, _ = chain.step(chain.init_state(), wires[0], params)
    torch.cuda.synchronize(dev)
    launches = kwf.LAUNCHES
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, out = chain.step(state, wires[1], params)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize(dev)
    assert kwf.LAUNCHES == launches + 1
    assert out.waterfall.shape == (k, 80)
    assert torch.isfinite(out.waterfall).all()

"""The port's dsd_in and single-channel chains (K4; K6 -> K5) vs JAX.

On the CPU the chains run the kernels' plain PyTorch versions: K4's on the
default ``mono=True`` engine, K6's then K5's with ``mono=False``.  They are
held to

  - the JAX mono engine (``use_pallas=True, pallas_interpret=True``, the
    one-kernel PallasMonoChain) at K = 8 on the same wire bytes, two
    streamed steps: dsd PCM within 1 LSB (the mono-vs-two-kernel gate,
    tests/test_dsd_in.py:165-184), single audio SNR > 100 dB
    (tests/test_misc.py:128-154), every state field at f32 rounding;
  - the JAX op path at K = 5 (G = 245 group rows, odd: the mixer phase
    carry): dsd SNR > 60 dB and max error <= 2 LSB (tests/test_dsd_in.py:
    120-140), single SNR > 60 dB and a 1 kHz tone SNR > 35 dB
    (tests/test_misc.py:80-97);
  - the port's copy of the float64 DsdInOracle: SNR > 50 dB, tone SNR
    > 17 dB (tests/test_dsd_in.py:33-56).

The two-kernel engine (``mono=False``) is held to

  - the JAX two-kernel engine (``mono=False``: PallasFrontEnd ->
    PallasChanTail) at K = 8, under the mono engine's gates above;
  - K5 alone against PallasChanTail at K = 8 on the same band planes, from
    a non-zero state and mixer phase 7: dsd PCM within 1 LSB, single audio
    SNR > 100 dB (tests/test_dsd_in.py:165-184, tests/test_misc.py:128-154);
  - the port's ``mono=True`` chain at K = 10 (cu8) and 15 (cs16, an odd
    number of group rows): the same output and state;
  - the JAX op path at K = 5, under the op-path gates above.

States pass from the JAX package to the port and back, on both engines.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sdr_pmr446_tpu import config as C
from sdr_pmr446_tpu.io import synth
from sdr_pmr446_tpu.ops import decode as jdecode
from sdr_pmr446_tpu.scanner.dsd_in import DsdInChain as JaxDsd
from sdr_pmr446_tpu.scanner.dsd_in import PallasDsdState
from sdr_pmr446_tpu.scanner.single import PallasSingleState
from sdr_pmr446_tpu.scanner.single import SingleChannelChain as JaxSingle
from sdr_pmr446_tpu_torch.kernels import chan_tail
from sdr_pmr446_tpu_torch.ops import decode
from sdr_pmr446_tpu_torch.runtime import state as tstate
from sdr_pmr446_tpu_torch.scanner.dsd_in import DsdInChain
from sdr_pmr446_tpu_torch.scanner.single import SingleChannelChain

torch.set_num_threads(2)

K_KERNEL = 8                # the JAX mono engine needs K % 8 == 0
K_ODD = 5                   # G = 49 K group rows: odd
#: wire format of each chain's JAX-kernel comparison
FMT = {"dsd": "cu8", "single": "cs16"}
FROM_NUMPY = {"dsd": tstate.dsd_state_from_numpy,
              "single": tstate.single_state_from_numpy}
TO_NUMPY = {"dsd": tstate.dsd_state_to_numpy,
            "single": tstate.single_state_to_numpy}
JAX_STATE = {"dsd": PallasDsdState, "single": PallasSingleState}


def fm_capture(n, tone_hz=1000.0, dev=2000.0, amp=0.5, offset_hz=300.0):
    """tests/test_dsd_in.py::_mk_iq: a tone-modulated FM carrier 300 Hz off
    the tuned centre."""
    fs = C.SDR_SAMPLERATE
    t = np.arange(n) / fs
    msg = amp * np.sin(2 * np.pi * tone_hz * t)
    return np.exp(1j * 2 * np.pi
                  * (dev * np.cumsum(msg) + offset_hz * np.arange(n)) / fs)


def capture(mode, n):
    if mode == "dsd":
        return 0.9 * fm_capture(n)
    return synth.make_scanner_iq(n, channel=5, ctcss_code=12)


def jax_chain(mode, k, **kw):
    if mode == "dsd":
        return JaxDsd(k, **kw)
    return JaxSingle(5, k, **kw)


def port_chain(mode, k, fmt, mono=True):
    if mode == "dsd":
        return DsdInChain(k, input_format=fmt, device="cpu", mono=mono)
    return SingleChannelChain(5, k, input_format=fmt, device="cpu", mono=mono)


def output(mode, o):
    return np.asarray(o.pcm if mode == "dsd" else o)


def snr_db(want, got):
    want = np.asarray(want, np.float64)
    err = np.asarray(got, np.float64) - want
    return 10 * (np.log10(np.sum(want ** 2))
                 - np.log10(max(np.sum(err ** 2), 1e-300)))


def assert_states_close(port_state, jax_values, what):
    """Every field at f32 rounding (1e-5 of its peak: sums of 346-838 taps
    in another order), dc_x and n0 exact."""
    for name, got, want in zip(port_state._fields,
                               tstate.state_to_numpy(port_state), jax_values):
        want = np.asarray(want)
        assert (got.shape, got.dtype) == (want.shape, want.dtype), name
        if name in ("dc_x", "n0"):
            np.testing.assert_array_equal(got, want, err_msg=f"{what} {name}")
            continue
        peak = max(float(np.max(np.abs(want))), 1e-30)
        assert float(np.max(np.abs(got - want))) < 1e-5 * peak, \
            f"{what} {name}"


def assert_outputs_close(mode, port_out, jax_out, what):
    if mode == "dsd":
        d = np.abs(port_out.astype(np.int32) - jax_out.astype(np.int32))
        assert d.max() <= 1, f"{what}: {d.max()} LSB"
    else:
        snr = snr_db(jax_out, port_out)
        assert snr > 100.0, f"{what}: {snr:.1f} dB"


def jax_kernel_runs(mono):
    """Two K=8 steps of each JAX kernel engine: wire bytes, outputs and the
    state before and after each step."""
    runs = {}
    for mode, fmt in FMT.items():
        chain = jax_chain(mode, K_KERNEL, input_format=fmt, use_pallas=True,
                          pallas_interpret=True, mono=mono)
        assert chain.mono == mono
        n = chain.input_len
        words = jdecode.pack_iq(capture(mode, 2 * n), fmt)
        wl = words.size // 2
        st = chain.init_state()
        run = dict(chain=chain, wires=[], outs=[],
                   states=[[np.asarray(v) for v in st]])
        for i in range(2):
            w = words[i * wl:(i + 1) * wl]
            st, o = chain.step(st, jnp.asarray(w).reshape(
                chain.step_arg_shape))
            run["wires"].append(w.view(np.uint8).copy())
            run["outs"].append(output(mode, o))
            run["states"].append([np.asarray(v) for v in st])
        runs[mode] = run
    return runs


@pytest.fixture(scope="module")
def kernel_runs():
    """The JAX mono engine's runs (jax_kernel_runs)."""
    return jax_kernel_runs(mono=True)


@pytest.mark.parametrize("mode", ["dsd", "single"])
def test_chain_matches_jax_mono_engine(kernel_runs, mode):
    run = kernel_runs[mode]
    chain = port_chain(mode, K_KERNEL, FMT[mode])
    st = chain.init_state()
    launches = chan_tail.LAUNCHES
    for i in range(2):
        st, out = chain.step(st, torch.from_numpy(run["wires"][i]))
        assert out.shape == (chain.output_len,)
        assert out.dtype == (torch.int16 if mode == "dsd" else torch.float32)
        assert_outputs_close(mode, out.numpy(), run["outs"][i], f"step {i}")
        assert_states_close(st, run["states"][i + 1], f"step {i}")
    assert chan_tail.LAUNCHES == launches     # the plain version never counts


@pytest.mark.parametrize("mode", ["dsd", "single"])
def test_state_from_jax_resumes_in_port(kernel_runs, mode):
    """The JAX state after step 1 loads into the port unchanged, and the
    port's step 2 gives the JAX step 2 output."""
    run = kernel_runs[mode]
    st = FROM_NUMPY[mode](run["states"][1], "cpu")
    for a, b in zip(TO_NUMPY[mode](st), run["states"][1]):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    _, out = port_chain(mode, K_KERNEL, FMT[mode]).step(
        st, torch.from_numpy(run["wires"][1]))
    assert_outputs_close(mode, out.numpy(), run["outs"][1], "resumed")


@pytest.mark.parametrize("mode", ["dsd", "single"])
def test_state_from_port_resumes_in_jax(kernel_runs, mode):
    """The port's state after step 1 loads into the JAX mono engine, whose
    step 2 then gives its own step 2 output."""
    run = kernel_runs[mode]
    chain = port_chain(mode, K_KERNEL, FMT[mode])
    st, _ = chain.step(chain.init_state(), torch.from_numpy(run["wires"][0]))
    jst = JAX_STATE[mode](*(jnp.asarray(v) for v in TO_NUMPY[mode](st)))
    jchain = run["chain"]
    _, o = jchain.step(jst, jnp.asarray(run["wires"][1].view(np.float32))
                       .reshape(jchain.step_arg_shape))
    assert_outputs_close(mode, output(mode, o), run["outs"][1], "handed back")


@pytest.mark.parametrize("mode", ["dsd", "single"])
@pytest.mark.parametrize("fmt", ["cu8", "cs8", "cs16", "cf32"])
def test_init_state_layout_matches_jax(mode, fmt):
    """Field order, shapes and dtypes equal the JAX mono engine's for every
    wire format (cf32 is the JAX package's cf32w)."""
    jfmt = "cf32w" if fmt == "cf32" else fmt
    want = jax_chain(mode, K_KERNEL, input_format=jfmt, use_pallas=True,
                     pallas_interpret=True).init_state()
    got = port_chain(mode, K_KERNEL, fmt).init_state()
    assert got._fields == want._fields
    for name, a, b in zip(got._fields, tstate.state_to_numpy(got), want):
        b = np.asarray(b)
        assert (a.shape, a.dtype) == (b.shape, b.dtype), name


@pytest.fixture(scope="module")
def op_runs():
    """Two K=5 steps of each JAX op path on complex64 samples."""
    runs = {}
    for mode in ("dsd", "single"):
        chain = jax_chain(mode, K_ODD)
        n = chain.input_len
        iq = (0.9 * fm_capture(2 * n) if mode == "dsd" else
              synth.make_scanner_iq(2 * n, channel=5, ctcss_code=None))
        iq = iq.astype(np.complex64)
        st = chain.init_state()
        outs = []
        for i in range(2):
            st, o = chain.step(st, jnp.asarray(iq[i * n:(i + 1) * n]))
            outs.append(output(mode, o))
        runs[mode] = dict(iq=iq, outs=outs)
    return runs


def run_port(mode, k, iq, mono=True):
    chain = port_chain(mode, k, "cf32", mono)
    n = chain.input_len
    states, outs = [chain.init_state()], []
    for i in range(len(iq) // n):
        st, o = chain.step(states[-1], torch.from_numpy(
            decode.quantize_iq(iq[i * n:(i + 1) * n], "cf32")))
        states.append(st)
        outs.append(o.numpy())
    return states, outs


def test_dsd_matches_jax_op_path_at_odd_k(op_runs):
    run = op_runs["dsd"]
    _, outs = run_port("dsd", K_ODD, run["iq"])
    for i, (got, want) in enumerate(zip(outs, run["outs"])):
        assert got.shape == want.shape
        assert snr_db(want, got) > 60.0, f"step {i}"
        err = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert err.max() <= 2, f"step {i}: {err.max()} LSB"


def test_single_matches_jax_op_path_at_odd_k(op_runs):
    """G = 245 group rows per step: the mixer phase is carried through n0
    (16 after the first step), which the JAX kernel's (-1)^(g+u) constant
    could not do."""
    run = op_runs["single"]
    states, outs = run_port("single", K_ODD, run["iq"])
    assert [int(s.n0) for s in states] == [0, 16, 0]
    for i, (got, want) in enumerate(zip(outs, run["outs"])):
        assert got.shape == want.shape
        snr = snr_db(want, got)
        assert snr > 60.0, f"step {i}: {snr:.1f} dB"
    audio = np.concatenate(outs)
    assert len(audio) == len(run["iq"]) * 25 // 2048
    assert synth.tone_snr_db(audio[4000:], 1000.0) > 35.0


def test_dsd_matches_port_oracle():
    """The port's float64 DsdInOracle copy (taps from the port's
    scanner/dsd_in.py), K = 5 over two steps."""
    from sdr_pmr446_tpu_torch.oracle.chain import DsdInOracle
    n = K_ODD * C.SUBCHUNK_IN
    iq = fm_capture(2 * n).astype(np.complex64)
    ref = DsdInOracle().process(iq)
    _, outs = run_port("dsd", K_ODD, iq)
    pcm = np.concatenate(outs).astype(np.float64)
    assert len(pcm) == len(ref) == 2 * n * 3 // 64
    assert snr_db(ref, pcm) > 50.0
    assert synth.tone_snr_db(pcm[12000:] / 32767.0, 1000.0, fs=48000.0) > 17.0


def test_mono_chain_rejects_bad_inputs():
    """The mixer phase is the single chain's alone; an unknown mode, an
    unknown device and a short wire raise instead of falling back."""
    with pytest.raises(ValueError, match="unknown mode"):
        chan_tail.MonoChain("stereo", "cu8", device="cpu")
    with pytest.raises(ValueError, match="channel"):
        chan_tail.MonoChain("single", "cu8", channel=17, device="cpu")
    mono = chan_tail.MonoChain("dsd", "cu8", device="cpu")
    st = mono.init_state("cpu")
    wire = torch.full((2 * C.SUBCHUNK_IN,), 128, dtype=torch.uint8)
    with pytest.raises(ValueError, match="n0"):
        mono(wire, *st, n0=torch.zeros((), dtype=torch.int32))
    with pytest.raises(ValueError, match="multiple of 2048"):
        mono(wire[:2000], *st)
    with pytest.raises(ValueError, match="no mono-chain implementation"):
        mono(wire.to("meta"), *st)
    chain = DsdInChain(1, input_format="cu8", device="cpu")
    with pytest.raises(ValueError, match="expected"):
        chain.step(chain.init_state(), wire[:-2])


# --------------------------------------------------- the two-kernel engine
@pytest.fixture(scope="module")
def two_kernel_runs():
    """The JAX two-kernel engine's runs (jax_kernel_runs)."""
    return jax_kernel_runs(mono=False)


@pytest.mark.parametrize("mode", ["dsd", "single"])
def test_two_kernel_chain_matches_jax_two_kernel_engine(two_kernel_runs,
                                                        mode):
    from sdr_pmr446_tpu_torch.kernels import front_end
    run = two_kernel_runs[mode]
    chain = port_chain(mode, K_KERNEL, FMT[mode], mono=False)
    assert not chain.mono
    st = chain.init_state()
    launches = (front_end.LAUNCHES, chan_tail.TAIL_LAUNCHES)
    for i in range(2):
        st, out = chain.step(st, torch.from_numpy(run["wires"][i]))
        assert out.shape == (chain.output_len,)
        assert_outputs_close(mode, out.numpy(), run["outs"][i], f"step {i}")
        assert_states_close(st, run["states"][i + 1], f"step {i}")
    # the plain versions never count
    assert (front_end.LAUNCHES, chan_tail.TAIL_LAUNCHES) == launches


@pytest.mark.parametrize("mode", ["dsd", "single"])
def test_two_kernel_states_pass_both_ways(two_kernel_runs, mode):
    """The JAX two-kernel state after step 1 resumes in the port's
    two-kernel chain, and the port's resumes in the JAX one: each step 2
    gives the JAX step 2 output."""
    run = two_kernel_runs[mode]
    chain = port_chain(mode, K_KERNEL, FMT[mode], mono=False)
    _, out = chain.step(FROM_NUMPY[mode](run["states"][1], "cpu"),
                        torch.from_numpy(run["wires"][1]))
    assert_outputs_close(mode, out.numpy(), run["outs"][1], "resumed")
    st, _ = chain.step(chain.init_state(), torch.from_numpy(run["wires"][0]))
    jst = JAX_STATE[mode](*(jnp.asarray(v) for v in TO_NUMPY[mode](st)))
    jchain = run["chain"]
    _, o = jchain.step(jst, jnp.asarray(run["wires"][1].view(np.float32))
                       .reshape(jchain.step_arg_shape))
    assert_outputs_close(mode, output(mode, o), run["outs"][1], "handed back")


@pytest.mark.parametrize("mode", ["dsd", "single"])
def test_chan_tail_plain_matches_jax_kernel(mode):
    """K5 alone: two streamed K = 8 steps of PallasChanTail on the same
    band planes from a non-zero state (single: mixer phase 7, the JAX
    kernel's rotation e^{-j w n0}), outputs under the gates above, every
    carry within 1e-5 of its peak."""
    from sdr_pmr446_tpu.kernels.chan_tail import PallasChanTail
    from sdr_pmr446_tpu_torch.kernels.front_end import FrontEnd
    single = mode == "single"
    rng = np.random.default_rng(17)
    jt = PallasChanTail(mode, channel=5, audio_gain=2.0, interpret=True)
    tail = chan_tail.ChanTail(mode, 5, 2.0, device="cpu")
    fe = FrontEnd("cu8", device="cpu")
    st = [np.asarray(0.1 * (rng.standard_normal(tail.hb * 400)
                            + 1j * rng.standard_normal(tail.hb * 400)),
                     np.complex64),
          np.complex64(0.3 - 0.2j),
          (0.1 * rng.standard_normal(tail.dh * 25)).astype(np.float32)]
    tab = chan_tail.mixer_table(5)
    n0 = 7
    jst = [jnp.asarray(v) for v in st]
    tst = [torch.from_numpy(np.array(v)) for v in st]
    tn0 = torch.tensor(n0, dtype=torch.int32) if single else None
    fst = [torch.zeros((), dtype=torch.complex64)] * 2 + [
        torch.zeros(fe.hist_len, dtype=torch.complex64)]
    n = K_KERNEL * C.SUBCHUNK_IN
    iq = capture(mode, 2 * n)
    launches = chan_tail.TAIL_LAUNCHES
    for i in range(2):
        f = fe(torch.from_numpy(decode.quantize_iq(iq[i * n:(i + 1) * n],
                                                   "cu8")), *fst)
        band = f.band.numpy()
        jo = [np.asarray(v) for v in jt.apply(
            *jst, jnp.asarray(band[0].reshape(-1, 400)),
            jnp.asarray(band[1].reshape(-1, 400)),
            rot=jnp.asarray(tab[n0]) if single else None)]
        to = tail(f.band, *tst, n0=tn0)
        assert_outputs_close(mode, to.out.numpy(), jo[3], f"step {i}")
        for name, got, want in zip(("band_hist", "sig_prev", "demod_hist"),
                                   to[:3], jo[:3]):
            peak = max(float(np.max(np.abs(want))), 1e-30)
            assert float(np.max(np.abs(got.numpy() - want))) < 1e-5 * peak, \
                f"step {i} {name}"
        if single:
            n0 = (n0 + band.shape[1]) % 32
            assert int(to.n0) == n0
        jst = [jnp.asarray(v) for v in jo[:3]]
        tst, tn0, fst = list(to[:3]), to.n0, list(f[:3])
    assert chan_tail.TAIL_LAUNCHES == launches


@pytest.mark.parametrize("mode", ["dsd", "single"])
@pytest.mark.parametrize("k,fmt", [(10, "cu8"), (15, "cs16")])
def test_two_kernel_chain_matches_mono_chain(mode, k, fmt):
    """The port's two engines on the same bytes, K = 10 and K = 15 (an odd
    number of group rows): the same output and state over two steps."""
    chains = [port_chain(mode, k, fmt, mono) for mono in (True, False)]
    n = k * C.SUBCHUNK_IN
    iq = capture(mode, 2 * n)
    sts = [c.init_state() for c in chains]
    for i in range(2):
        wire = torch.from_numpy(decode.quantize_iq(iq[i * n:(i + 1) * n], fmt))
        (sa, a), (sb, b) = (c.step(s, wire) for c, s in zip(chains, sts))
        torch.testing.assert_close(b, a, rtol=0, atol=0)
        for x, y in zip(sa, sb):
            torch.testing.assert_close(y, x, rtol=0, atol=0)
        sts = [sa, sb]


def test_two_kernel_dsd_matches_jax_op_path_at_odd_k(op_runs):
    run = op_runs["dsd"]
    _, outs = run_port("dsd", K_ODD, run["iq"], mono=False)
    for i, (got, want) in enumerate(zip(outs, run["outs"])):
        assert snr_db(want, got) > 60.0, f"step {i}"
        err = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert err.max() <= 2, f"step {i}: {err.max()} LSB"


def test_two_kernel_single_matches_jax_op_path_at_odd_k(op_runs):
    run = op_runs["single"]
    states, outs = run_port("single", K_ODD, run["iq"], mono=False)
    assert [int(s.n0) for s in states] == [0, 16, 0]
    for i, (got, want) in enumerate(zip(outs, run["outs"])):
        snr = snr_db(want, got)
        assert snr > 60.0, f"step {i}: {snr:.1f} dB"

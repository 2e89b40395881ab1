"""The port's scanner op engine (engine="op") on the CPU vs the JAX op engine.

The JAX side runs ScannerChain(use_pallas=False), the JAX driver's default
off a TPU, on the same capture bytes (channel 5 with CTCSS 12; cu8, cf32
with lowpass and fir_deemph, cu8 with -w 80; K = 4), three blocks from
the zero state.  The port runs the first two blocks from its own carried
state, and the gates are:

  - decisions and events exact, ct_freq exact;
  - rssi_db within 1e-3 dB on the channels that carry a signal (within 40
    dB of the strongest) and within 5e-3 dB (the kernel engines' gate,
    tests/test_torch_chain.py) on the rest; rel_rssi within 1e-3 dB;
  - audio within 1e-4 of its peak; waterfall rows within 2e-3 dB;
  - every carried state field within 1e-5 of its peak over the run (JAX's
    three blocks: a carry such as ``ct_carry``, the tone sums of the
    window so far, is far below its full-window size after a few
    samples), the FSM's integer and boolean fields exact.  On a channel
    that carries no signal the discriminator's output is f32 rounding
    over |y| (unbounded as |y| nears 0: chip_smoke.py TOL_NOISE_TURNS), so
    there every element of the audio-path histories is held within its own
    bound, scaled to that channel's |y| sample by sample (noise_bounds):
    the channel output's error taken as KAPPA f32 rounding steps of the
    block's largest |y|, the discriminator's as that over |y| of the two
    samples it reads (or a whole turn where the phase step lies that near
    to +-pi, where atan2 wraps), and each FIR or DC blocker passing it on
    with the sum of its |taps| or |impulse response|.

Readings behind the noise-channel gates (this file on the CPU, K = 4,
blocks 0-1; test_noise_gates_catch_faults plants each fault and requires
it to fail the gate named):
  - RSSI on noise channels, gate 5e-3 dB: the sound chain reads 1.16e-3
    dB (cu8) and 2.52e-3 dB (cf32), f32 rounding of a channel 70-80 dB
    under the strongest; a resampler history carried 2e-3 off into block
    1 reads 1.08e-2 dB (1e-3 off: 4.7e-3 dB, under the gate; its signal
    channel reads 3e-5 dB, under the 1e-3 dB gate there);
  - the histories, each element within its bound: the sound chain's
    largest error is 0.27 (cu8) and 0.29 (cf32) of its bound at KAPPA =
    128 (0.54 and 0.47 at 64); a PFB that swaps two noise-only channels
    reads 131 of the bound (and 0.66 dB on their RSSI), a frequency step of
    1e-2 discriminator units a sample on one noise-only channel 1.44.

States pass both ways: the JAX state after two blocks runs the third in
the port, the port's in JAX, each equal under the same gates to JAX's
uninterrupted third block.  multi_step at S = 3 equals three steps bit
for bit; every wire format runs; the layout checks refuse the other
engine's state.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy.signal import lfilter

from sdr_pmr446_tpu import config as C
from sdr_pmr446_tpu.io import synth
from sdr_pmr446_tpu.ops import decode as jdecode
from sdr_pmr446_tpu_torch.runtime import state as tstate
from sdr_pmr446_tpu_torch.scanner.chain import (ScannerChain,
                                                make_runtime_params,
                                                outputs_to_numpy)

torch.set_num_threads(2)

K = 4
N_BLOCKS = 3
CASES = {"cu8": ("cu8", {}),
         "cf32_lp_fir": ("cf32", dict(lowpass=True, fir_deemph=True)),
         "cu8_w80": ("cu8", dict(waterfall=80))}
#: per-channel fields of the audio path that noise_bounds holds on
#: noise-only channels (leading dim 16)
NOISE_FIELDS = ("hp_hist", "delay_hist", "lp_dc_x", "lp_dc_y",
                "deemph_hist", "audio_lp_hist")
#: f32 rounding steps of the block's largest |y| taken as the error of the
#: channel output y (module docstring's readings)
KAPPA = 128
EXACT_STATE = ("frame_parity", "fsm_state", "active_chan", "ct_count",
               "ct_detected", "ct_max_idx", "ct_freq", "wf_cnt")


def scanner_args(kw) -> C.ScannerArgs:
    return C.ScannerArgs(lowpass=kw.get("lowpass", False),
                         fir_deemph=kw.get("fir_deemph", False),
                         waterfall=kw.get("waterfall", 0))


def capture_blocks(fmt: str, n_blocks: int, k: int = K):
    """(port wire bytes of each block, the JAX op engine's step inputs)."""
    iq = synth.make_scanner_iq(n_blocks * k * C.SUBCHUNK_IN, channel=5,
                               ctcss_code=12)
    if fmt == "cf32":
        x = iq.astype(np.complex64).reshape(n_blocks, -1)
        return [b.view(np.uint8).copy() for b in x], [jnp.asarray(b)
                                                       for b in x]
    words = jdecode.pack_iq(iq, fmt).reshape(n_blocks, -1)
    return ([w.view(np.uint8).copy() for w in words],
            [jnp.asarray(w) for w in words])


def run_jax(fmt: str, kw: dict, state=None, blocks=range(N_BLOCKS)):
    """The JAX op engine over ``blocks`` from ``state`` (numpy fields, or
    the zero state): (outputs of each block, numpy state after each)."""
    from sdr_pmr446_tpu.runtime.state import ScannerState as JaxState
    from sdr_pmr446_tpu.scanner.chain import ScannerChain as JaxChain
    from sdr_pmr446_tpu.scanner.chain import make_runtime_params as jparams
    chain = JaxChain(C.BlockConfig(K), input_format=fmt, **kw)
    _, jin = capture_blocks(fmt, N_BLOCKS)
    st = (chain.init_state() if state is None
          else JaxState(*(jnp.asarray(v) for v in state)))
    params = jparams(scanner_args(kw))
    outs, states = [], []
    for i in blocks:
        st, o = chain.step(st, jin[i], params)
        outs.append({f: np.asarray(v) for f, v in zip(o._fields, o)})
        states.append([np.asarray(v) for v in st])
    return outs, states


@pytest.fixture(scope="module")
def jax_runs():
    return {name: run_jax(fmt, kw) for name, (fmt, kw) in CASES.items()}


def channel_output(fmt: str, kw: dict) -> np.ndarray:
    """c64 [16, N_BLOCKS * T / 128]: the port op chain's channel output y
    (its PFB's) over the capture, from the zero state."""
    chain = port_chain(fmt, kw)
    ys = []
    hook = chain.front.register_forward_hook(
        lambda mod, args, out: ys.append(out.chan.numpy().copy()))
    wires, _ = capture_blocks(fmt, N_BLOCKS)
    port_steps(chain, chain.init_state(), wires, kw)
    hook.remove()
    return np.concatenate(ys, axis=1)


@pytest.fixture(scope="module")
def port_y():
    return {name: channel_output(fmt, kw)
            for name, (fmt, kw) in CASES.items()}


def noise_bounds(y: np.ndarray, kw: dict) -> dict:
    """Each NOISE_FIELDS field's error bound (module docstring) after the
    channel output ``y`` c64 [16, n] from the zero state: field -> (bound
    [16, history] or [16], None), for the two histories of raw
    discriminator samples (bound without a wrap, bool where a wrap may
    fall)."""
    chain = port_chain("cu8", kw)
    y = y.astype(np.complex128)
    inv = 1.0 / np.maximum(np.abs(y), 1e-300)
    rad = KAPPA * 2.0 ** -24 * np.abs(y).max() * (
        inv + np.pad(inv[:, :-1], ((0, 0), (1, 0))))
    step = np.angle(y * np.conj(np.pad(y[:, :-1], ((0, 0), (1, 0)))))
    wrap = np.pi - np.abs(step) <= rad
    turn = 1.0 / C.FM_KF                      # the discriminator's 2 pi
    raw = np.minimum(rad / (2 * np.pi * C.FM_KF), turn)
    demod = np.where(wrap, turn, raw)
    taps = {n: np.abs(getattr(chain, n).numpy().astype(np.float64))
            for n in ("hp_taps", "deemph_taps", "lp_taps")}
    gain = float(make_runtime_params(scanner_args(kw), "cpu").audio_gain)
    hp = lfilter(taps["hp_taps"], [1.0], demod, axis=1)
    delay = C.CTCSS_DELAY
    lp_in = hp + np.pad(demod[:, :-delay], ((0, 0), (delay, 0)))
    # the DC blocker's impulse response g, -g (1-p) p^(k-1): |.| sums to 2g
    p = 1.0 - C.DC_BLOCK_ALPHA
    g = (1.0 + p) / 2.0
    dcb = g * lp_in + lfilter([0.0, g * (1.0 - p)], [1.0, -p], lp_in, axis=1)
    audio = lfilter(taps["deemph_taps"], [1.0], gain * hp, axis=1)
    tail = lambda x, name: x[:, x.shape[1] + 1 - len(taps[name]):]  # noqa
    out = {"hp_hist": (tail(raw, "hp_taps"), tail(wrap, "hp_taps")),
           "delay_hist": (raw[:, -delay:], wrap[:, -delay:]),
           "lp_dc_x": (lp_in[:, -1], None), "lp_dc_y": (dcb[:, -1], None),
           "deemph_hist": (tail(gain * hp, "deemph_taps"), None),
           # without the lowpass its history stays zero: held exact
           "audio_lp_hist": (tail(audio if kw.get("lowpass") else 0 * audio,
                                  "lp_taps"), None)}
    return out


def block_bounds(y: np.ndarray, kw: dict, i: int) -> dict:
    """noise_bounds at the end of block ``i``."""
    return noise_bounds(y[:, :(i + 1) * y.shape[1] // N_BLOCKS], kw)


def signal_channels(rssi_db: np.ndarray) -> np.ndarray:
    """bool [16]: the channels whose mean RSSI is within 40 dB of the
    strongest's."""
    mean = rssi_db.mean(axis=0)
    return mean > mean.max() - 40.0


def assert_op_outputs(got: dict, want: dict, what: str) -> None:
    for f, ref in want.items():
        if ref.dtype.kind in "biu":
            np.testing.assert_array_equal(got[f], ref, err_msg=f"{what}: {f}")
    np.testing.assert_array_equal(got["ct_freq"], want["ct_freq"])
    sig = signal_channels(want["rssi_db"])
    err = np.abs(got["rssi_db"] - want["rssi_db"])
    assert err[:, sig].max() < 1e-3, (what, "rssi_db on signal channels",
                                      err[:, sig].max())
    assert err.max() < 5e-3, (what, "rssi_db on noise channels", err.max())
    assert np.abs(got["rel_rssi"] - want["rel_rssi"]).max() < 1e-3, what
    peak = max(np.abs(want["audio"]).max(), 1e-30)
    assert np.abs(got["audio"] - want["audio"]).max() < 1e-4 * peak, what
    if want["waterfall"].size:
        np.testing.assert_allclose(got["waterfall"], want["waterfall"],
                                   rtol=0, atol=2e-3, err_msg=what)


def run_peaks(states: list) -> list:
    """Each state field's peak |value| over a run's states."""
    return [max(float(np.abs(v).max()) if v.size else 0.0 for v in vals)
            for vals in zip(*states)]


def assert_op_state(got: list, want: list, sig: np.ndarray, what: str,
                    peaks: list, bounds: dict | None = None) -> None:
    """``got`` and ``want`` numpy ScannerState fields (module docstring's
    state gates); ``sig`` bool [16] the signal channels, ``peaks`` each
    field's peak over the run (run_peaks), ``bounds`` the noise-only
    channels' (block_bounds; unused where every channel is in ``sig``)."""
    for name, a, b, pk in zip(tstate.ScannerState._fields, got, want, peaks):
        a, b = np.asarray(a), np.asarray(b)
        assert (a.shape, a.dtype) == (b.shape, b.dtype), (what, name)
        if name in EXACT_STATE or b.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=f"{what}: {name}")
            continue
        if not b.size:
            continue
        peak = max(pk, 1e-30)
        err = np.abs(a - b)
        if name in NOISE_FIELDS and (~sig).any():
            assert err[sig].max() <= 1e-5 * peak, (what, name,
                                                   err[sig].max() / peak)
            bound, wrap = (None if v is None else v.reshape(err.shape)[~sig]
                           for v in bounds[name])
            diff = (a - b)[~sig]
            if wrap is not None:
                # a whole turn only where a wrap may fall, and within the
                # bound modulo a turn everywhere
                turn = 1.0 / C.FM_KF
                held = (np.abs(diff) <= bound) | wrap
                diff = np.remainder(diff + turn / 2, turn) - turn / 2
                assert held.all(), (what, name, "a wrap where none may fall")
            assert (np.abs(diff) <= bound).all(), (
                what, name, float((np.abs(diff) / bound).max()))
        else:
            assert err.max() <= 1e-5 * peak, (what, name, err.max() / peak)


def port_chain(fmt: str, kw: dict, k: int = K) -> ScannerChain:
    return ScannerChain(C.BlockConfig(k), input_format=fmt, device="cpu",
                        engine="op", **kw)


def port_steps(chain, state, wires, kw):
    params = make_runtime_params(scanner_args(kw), "cpu")
    outs, states = [], []
    for w in wires:
        state, o = chain.step(state, torch.from_numpy(w), params)
        outs.append(outputs_to_numpy(o))
        states.append(tstate.state_to_numpy(state))
    return outs, states


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_chain_matches_jax_op_engine(case, jax_runs, port_y):
    fmt, kw = CASES[case]
    chain = port_chain(fmt, kw)
    st = chain.init_state()
    jouts, jstates = jax_runs[case]
    zero = [np.asarray(v) for v in run_jax_init(fmt, kw)]
    assert_op_state(tstate.state_to_numpy(st), zero, np.ones(16, bool),
                    "init", run_peaks([zero]))
    wires, _ = capture_blocks(fmt, N_BLOCKS)
    outs, states = port_steps(chain, st, wires[:2], kw)
    sig = signal_channels(jouts[0]["rssi_db"])
    for i in range(2):
        assert_op_outputs(outs[i], jouts[i], f"{case} block {i}")
        assert_op_state(states[i], jstates[i], sig, f"{case} block {i}",
                        run_peaks(jstates), block_bounds(port_y[case], kw, i))
    assert int(states[-1][tstate.ScannerState._fields.index(
        "active_chan")]) == 4
    assert outs[1]["ct_max_idx"][-1] == 11
    assert any(o["ev_ct_acquired"].any() for o in outs)


def swap_channels(a: int, b: int):
    """A front-end hook: a PFB that hands out channels ``a`` and ``b``
    swapped."""
    def hook(mod, args, out):
        perm = list(range(16))
        perm[a], perm[b] = b, a
        return out._replace(chan=out.chan[perm])
    return hook


def frequency_step(ch: int, step: float):
    """A front-end hook: channel ``ch`` mixed ``step`` discriminator units a
    sample off frequency, its phase carried across blocks."""
    n0 = [0]

    def hook(mod, args, out):
        chan = out.chan.clone()
        n = torch.arange(n0[0], n0[0] + chan.shape[1], dtype=torch.float64)
        chan[ch] *= torch.exp(1j * (2 * np.pi * C.FM_KF * step) * n).to(
            chan.dtype)
        n0[0] += chan.shape[1]
        return out._replace(chan=chan)
    return hook


#: fault -> (front-end hook, share the resampler history carried into
#: block 1 is off by, the gate that must fail); module docstring readings
FAULTS = {"swapped noise channels": (swap_channels(1, 2), 0.0,
                                     "rssi_db on noise channels"),
          "frequency step": (frequency_step(0, 1e-2), 0.0, "hp_hist"),
          "resampler carry": (None, 2e-3, "rssi_db on noise channels")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_noise_gates_catch_faults(fault, jax_runs, port_y):
    """Each planted fault on the noise-only channels fails the gate the
    module docstring names for it; a PFB that swaps two of them fails the
    history gate as well."""
    hook, carry, gate = FAULTS[fault]
    fmt, kw = CASES["cu8"]
    jouts, jstates = jax_runs["cu8"]
    chain = port_chain(fmt, kw)
    if hook is not None:
        chain.front.register_forward_hook(hook)
    wires, _ = capture_blocks(fmt, N_BLOCKS)
    params = make_runtime_params(scanner_args(kw), "cpu")
    st = chain.init_state()
    st, _ = chain.step(st, torch.from_numpy(wires[0]), params)
    st = st._replace(resamp_hist=st.resamp_hist * (1.0 + carry))
    st, o = chain.step(st, torch.from_numpy(wires[1]), params)
    got, want = outputs_to_numpy(o), jouts[1]
    sig = signal_channels(jouts[0]["rssi_db"])
    state = (tstate.state_to_numpy(st), jstates[1], sig, fault,
             run_peaks(jstates), block_bounds(port_y["cu8"], kw, 1))
    if gate.startswith("rssi_db"):
        with pytest.raises(AssertionError, match=gate):
            assert_op_outputs(got, want, fault)
    else:
        assert_op_outputs(got, want, fault)
        with pytest.raises(AssertionError, match=gate):
            assert_op_state(*state)
    if fault == "swapped noise channels":
        with pytest.raises(AssertionError):
            assert_op_state(*state)


def run_jax_init(fmt, kw):
    from sdr_pmr446_tpu.scanner.chain import ScannerChain as JaxChain
    return JaxChain(C.BlockConfig(K), input_format=fmt, **kw).init_state()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_state_passes_both_ways(direction, jax_runs, port_y):
    """Two blocks in one package, the third in the other from the first's
    state: equal to JAX's uninterrupted third block."""
    fmt, kw = CASES["cu8_w80"]
    jouts, jstates = jax_runs["cu8_w80"]
    wires, _ = capture_blocks(fmt, N_BLOCKS)
    sig = signal_channels(jouts[0]["rssi_db"])
    if direction == "jax_to_port":
        st = tstate.state_from_numpy(jstates[1], "cpu")
        back = tstate.state_to_numpy(st)
        for a, b in zip(back, jstates[1]):
            np.testing.assert_array_equal(a, b)
        outs, states = port_steps(port_chain(fmt, kw), st, wires[2:], kw)
    else:
        chain = port_chain(fmt, kw)
        _, pst = port_steps(chain, chain.init_state(), wires[:2], kw)
        outs, states = run_jax(fmt, kw, state=pst[1], blocks=[2])
    assert_op_outputs(outs[0], jouts[2], direction)
    assert_op_state(states[0], jstates[2], sig, direction,
                    run_peaks(jstates), block_bounds(port_y["cu8_w80"], kw, 2))


def test_multi_step_equals_steps():
    fmt, kw = CASES["cu8_w80"]
    chain = port_chain(fmt, kw, k=1)
    wires = torch.stack([torch.from_numpy(w)
                         for w in capture_blocks(fmt, 3, k=1)[0]])
    params = make_runtime_params(scanner_args(kw), "cpu")
    st_m, fused = chain.multi_step(chain.init_state(), wires, params)
    st, outs = chain.init_state(), []
    for w in wires:
        st, o = chain.step(st, w, params)
        outs.append(o)
    for f, got, *each in zip(fused._fields, fused, *outs):
        assert torch.equal(got, torch.cat(each)), f
    for f, a, b in zip(st._fields, st_m, st):
        assert torch.equal(a, b), f


def test_every_wire_format_runs():
    """The op engine decodes each wire format the JAX op engine takes; the
    same signal gives the same decisions in each."""
    iq = synth.make_scanner_iq(C.SUBCHUNK_IN, channel=9, ctcss_code=3)
    params = make_runtime_params(C.ScannerArgs(), "cpu")
    from sdr_pmr446_tpu_torch.ops import decode
    for fmt in ("cu8", "cs8", "cs16", "cf32"):
        chain = port_chain(fmt, {}, k=1)
        _, o = chain.step(chain.init_state(), torch.from_numpy(
            decode.quantize_iq(0.8 * iq, fmt)), params)
        assert int(o.active_chan[0]) == 8, fmt
        assert float(o.rssi_db[0, 8]) > float(o.rssi_db[0, 0]) + 40.0, fmt


def test_layout_check_refuses_the_other_engine(jax_runs):
    op_state = tstate.state_from_numpy(jax_runs["cu8"][1][1], "cpu")
    tstate.check_layout(op_state, "op")
    with pytest.raises(ValueError, match="--engine op"):
        tstate.check_layout(op_state, "kernel")
    kchain = ScannerChain(C.BlockConfig(K), input_format="cu8",
                          device="cpu")
    wires, _ = capture_blocks("cu8", 1)
    kst, _ = kchain.step(kchain.init_state(), torch.from_numpy(wires[0]),
                         make_runtime_params(C.ScannerArgs(), "cpu"))
    tstate.check_layout(kst, "kernel")
    with pytest.raises(ValueError, match="--engine kernel"):
        tstate.check_layout(kst, "op")
    with pytest.raises(ValueError, match="engine 'xla'"):
        ScannerChain(C.BlockConfig(K), device="cpu", engine="xla")

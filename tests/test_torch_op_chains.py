"""The port's dsd_in and single-channel op engines (engine="op") vs JAX's.

The JAX side runs DsdInChain / SingleChannelChain with ``use_pallas=False``
(the JAX op engine, its default off a TPU) over three blocks from the zero
state, once per module; the port runs the same bytes on the CPU:

  - dsd_in, cu8, K = 3, an FM tone at the band centre
    (tests/test_dsd_in.py's capture): PCM within 1 LSB of JAX's;
  - single, cf32, K = 3, channel 5: audio SNR > 100 dB against JAX's;
  - states both ways: JAX's state after two blocks loads into the port
    (DsdOpState / SingleOpState, the JAX field order, unchanged) and runs
    the third block, and the port's state after two blocks runs the third
    in JAX, each under the same gate against JAX's uninterrupted third
    block;
  - multi_step at S = 3 equal to three steps bit for bit; the op engine's
    refusal of a wire format JAX's op single chain refuses.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sdr_pmr446_tpu import config as C
from sdr_pmr446_tpu.io import synth
from sdr_pmr446_tpu.ops import decode as jdecode
from sdr_pmr446_tpu_torch.runtime import state as tstate
from sdr_pmr446_tpu_torch.scanner.dsd_in import DsdInChain, DsdOpState
from sdr_pmr446_tpu_torch.scanner.single import (SingleChannelChain,
                                                 SingleOpState)

torch.set_num_threads(2)

K = 3
N_BLOCKS = 3
FMT = {"dsd": "cu8", "single": "cf32"}
FROM_NUMPY = {"dsd": tstate.dsd_state_from_numpy,
              "single": tstate.single_state_from_numpy}
TO_NUMPY = {"dsd": tstate.dsd_state_to_numpy,
            "single": tstate.single_state_to_numpy}


def fm_capture(n):
    """tests/test_dsd_in.py::_mk_iq: a 1 kHz tone FM carrier 300 Hz off the
    tuned centre."""
    t = np.arange(n) / C.SDR_SAMPLERATE
    msg = 0.5 * np.sin(2 * np.pi * 1000.0 * t)
    return 0.9 * np.exp(1j * 2 * np.pi * (2000.0 * np.cumsum(msg)
                                          / C.SDR_SAMPLERATE + 300.0 * t))


def blocks(mode: str):
    """(the port's wire bytes of each block, JAX's step inputs)."""
    n = N_BLOCKS * K * C.SUBCHUNK_IN
    if mode == "dsd":
        words = jdecode.pack_iq(fm_capture(n), "cu8").reshape(N_BLOCKS, -1)
        return ([w.view(np.uint8).copy() for w in words],
                [jnp.asarray(w) for w in words])
    iq = synth.make_scanner_iq(n, channel=5, ctcss_code=12).astype(
        np.complex64).reshape(N_BLOCKS, -1)
    return [b.view(np.uint8).copy() for b in iq], [jnp.asarray(b)
                                                   for b in iq]


def jax_chain(mode: str):
    from sdr_pmr446_tpu.scanner.dsd_in import DsdInChain as JaxDsd
    from sdr_pmr446_tpu.scanner.single import SingleChannelChain as JaxSingle
    if mode == "dsd":
        return JaxDsd(subchunks_per_step=K, input_format="cu8")
    return JaxSingle(channel=5, subchunks_per_step=K)


def run_jax(mode: str, state=None, which=range(N_BLOCKS)):
    """JAX's op chain over blocks ``which`` from ``state`` (numpy fields,
    or zero): (outputs, numpy states)."""
    chain = jax_chain(mode)
    st = (chain.init_state() if state is None else
          type(chain.init_state())(*(jnp.asarray(v) for v in state)))
    _, jin = blocks(mode)
    outs, states = [], []
    for i in which:
        st, o = chain.step(st, jin[i])
        outs.append(np.asarray(o.pcm if mode == "dsd" else o))
        states.append([np.asarray(v) for v in st])
    return outs, states


@pytest.fixture(scope="module")
def jax_runs():
    return {mode: run_jax(mode) for mode in FMT}


def port_chain(mode: str):
    if mode == "dsd":
        return DsdInChain(K, "cu8", device="cpu", engine="op")
    return SingleChannelChain(5, K, device="cpu", engine="op")


def port_run(mode: str, state, which):
    chain = port_chain(mode)
    wires, _ = blocks(mode)
    outs, states = [], []
    for i in which:
        state, o = chain.step(state, torch.from_numpy(wires[i]))
        outs.append(o.numpy())
        states.append(TO_NUMPY[mode](state))
    return outs, states


def assert_gate(mode: str, got, want, what: str) -> None:
    if mode == "dsd":
        assert got.dtype == np.int16 and got.shape == want.shape
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1, (what, diff.max())
        return
    ref = want.astype(np.float64)
    err = got.astype(np.float64) - ref
    snr = 10 * np.log10(np.sum(ref ** 2) / max(np.sum(err ** 2), 1e-300))
    assert snr > 100.0, (what, snr)


@pytest.mark.parametrize("mode", sorted(FMT))
def test_op_chain_matches_jax(mode, jax_runs):
    chain = port_chain(mode)
    st = chain.init_state()
    assert isinstance(st, DsdOpState if mode == "dsd" else SingleOpState)
    jouts, jstates = jax_runs[mode]
    zero = [np.asarray(v) for v in jax_chain(mode).init_state()]
    for name, a, b in zip(st._fields, TO_NUMPY[mode](st), zero):
        assert (a.shape, a.dtype) == (b.shape, b.dtype), name
    outs, _ = port_run(mode, st, range(N_BLOCKS))
    for i in range(N_BLOCKS):
        assert_gate(mode, outs[i], jouts[i], f"{mode} block {i}")
    if mode == "single":
        tone = synth.tone_snr_db(np.concatenate(outs)[2000:], 1000.0)
        assert tone > 35.0, tone


@pytest.mark.parametrize("mode", sorted(FMT))
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_state_passes_both_ways(mode, direction, jax_runs):
    jouts, jstates = jax_runs[mode]
    if direction == "jax_to_port":
        st = FROM_NUMPY[mode](jstates[1], "cpu", engine="op")
        for a, b in zip(TO_NUMPY[mode](st), jstates[1]):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
        outs, _ = port_run(mode, st, [2])
    else:
        _, pst = port_run(mode, port_chain(mode).init_state(), range(2))
        outs, _ = run_jax(mode, state=pst[1], which=[2])
    assert_gate(mode, outs[0], jouts[2], f"{mode} {direction}")


@pytest.mark.parametrize("mode", sorted(FMT))
def test_multi_step_equals_steps(mode):
    chain = port_chain(mode)
    wires = torch.stack([torch.from_numpy(w) for w in blocks(mode)[0]])
    st_m, fused = chain.multi_step(chain.init_state(), wires)
    st, outs = chain.init_state(), []
    for w in wires:
        st, o = chain.step(st, w)
        outs.append(o)
    assert torch.equal(fused, torch.cat(outs))
    for f, a, b in zip(st._fields, st_m, st):
        assert torch.equal(a, b), f


def test_single_op_takes_the_cf32_wire_only():
    with pytest.raises(ValueError, match="cf32 wire only"):
        SingleChannelChain(5, K, input_format="cu8", device="cpu",
                           engine="op")
    # the kernel engine decodes every format
    SingleChannelChain(5, K, input_format="cu8", device="cpu")

"""The port's trio scanner engines (K6 -> K7, and K9 -> K7) vs the JAX package.

``ScannerChain(fuse_band=False)`` runs K6 (front end) -> K7 (PFB +
discriminator) -> FSM A -> K2 -> FSM C; ``fuse_dc=False`` decodes to planes,
runs the DC blocker as plain ops and K9 (resampler) -> K7 -> ...  On the CPU
each is held, on the same cu8 bytes over two streamed steps, to the JAX
chain with the same switches (``use_pallas=True, pallas_interpret=True``):

  - the group trio at K = 8 (JAX ``call_group``), the row trio at K = 10
    (JAX ``call_planes_rssi``: the JAX scanner app's default K) and
    ``fuse_dc=False`` at K = 10;
  - decisions and events exact, rssi_db within 5e-3 dB, audio within 1e-4
    (the trio/duo gate of tests/test_scanner.py:318-337, the
    ``assert_outputs_match`` of tests/test_torch_chain.py); every state
    field of the JAX layout, its front-end and PFB fields within 1e-5 of
    their peak (f32 sums in another order) and its integer and boolean
    fields exact.  The audio-rate fields carry the demod, whose native atan2
    and the JAX kernels' polynomial differ by up to 1e-4, amplified by the
    lp DC blocker's 2,000-sample memory: step 2's outputs hold them to the
    gate instead.

The trio also matches the port's default engine under the same gate (with
the waterfall on too), and states pass between the port and JAX in both
directions, ``fuse_dc=False``'s 345-sample resampler history included.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sdr_pmr446_tpu import config as C
from sdr_pmr446_tpu.io import synth
from sdr_pmr446_tpu.ops import decode as jdecode
from sdr_pmr446_tpu_torch.kernels import front_end, pfb_demod, resample_kernel
from sdr_pmr446_tpu_torch.ops import decode
from sdr_pmr446_tpu_torch.runtime import state as tstate
from sdr_pmr446_tpu_torch.scanner.chain import (ScannerChain,
                                                make_runtime_params,
                                                outputs_to_numpy)
from test_torch_chain import assert_outputs_match

torch.set_num_threads(2)

#: engine -> (K, ScannerChain switches, in both packages)
ENGINES = {"group_trio": (8, dict(fuse_band=False)),
           "row_trio": (10, dict(fuse_band=False)),
           "fuse_dc_off": (10, dict(fuse_dc=False))}


def capture(k):
    """Two blocks: channel 5 with CTCSS 12, a weaker channel 9 beside it."""
    n = 2 * k * C.SUBCHUNK_IN
    return (synth.make_scanner_iq(n, channel=5, ctcss_code=12)
            + synth.make_scanner_iq(n, channel=9, amplitude=0.2, seed=9)) / 1.2


@pytest.fixture(scope="module")
def jax_runs():
    """Per engine: the JAX chain, the wire bytes, each step's outputs and
    the state before and after each step."""
    from sdr_pmr446_tpu.scanner.chain import ScannerChain as JaxChain
    from sdr_pmr446_tpu.scanner.chain import make_runtime_params as jparams
    runs = {}
    for name, (k, kw) in ENGINES.items():
        chain = JaxChain(C.BlockConfig(k), use_pallas=True,
                         pallas_interpret=True, input_format="cu8", **kw)
        assert not chain.fuse_band
        assert chain.fuse_group == (name == "group_trio")
        words = jdecode.pack_iq(capture(k), "cu8")
        params = jparams(C.ScannerArgs())
        st = chain.init_state()
        run = dict(chain=chain, params=params, wires=[], outs=[],
                   states=[[np.asarray(v) for v in st]])
        wl = chain.step_arg_len
        for i in range(2):
            w = words[i * wl:(i + 1) * wl]
            st, o = chain.step(st, jnp.asarray(w).reshape(
                chain.step_arg_shape), params)
            run["outs"].append({f: np.asarray(v)
                                for f, v in zip(o._fields, o)})
            run["states"].append([np.asarray(v) for v in st])
            run["wires"].append(w.view(np.uint8).copy())
        runs[name] = run
    return runs


def port_chain(name, **kw):
    k, switches = ENGINES[name]
    return ScannerChain(C.BlockConfig(k), input_format="cu8", device="cpu",
                        **switches, **kw)


#: the state fields upstream of the demod
BAND_FIELDS = ("dc_x", "dc_y", "resamp_hist", "pfb_hist", "demod_prev")


def assert_states_close(port_state, jax_values, what):
    for name, got, want in zip(tstate.ScannerState._fields,
                               tstate.state_to_numpy(port_state), jax_values):
        want = np.asarray(want)
        assert (got.shape, got.dtype) == (want.shape, want.dtype), name
        if got.dtype.kind in "biu":
            np.testing.assert_array_equal(got, want, err_msg=f"{what} {name}")
            continue
        if name in BAND_FIELDS:
            peak = max(float(np.max(np.abs(want))), 1e-30)
            assert float(np.max(np.abs(got - want))) < 1e-5 * peak, \
                f"{what} {name}"


@pytest.mark.parametrize("name", list(ENGINES))
def test_trio_matches_jax_trio(jax_runs, name):
    run = jax_runs[name]
    chain = port_chain(name)
    assert not chain.fuse_band
    st = chain.init_state()
    assert_states_close(st, run["states"][0], "init")
    params = make_runtime_params(C.ScannerArgs(), "cpu")
    launches = (front_end.LAUNCHES, pfb_demod.LAUNCHES,
                resample_kernel.LAUNCHES)
    for i in range(2):
        st, o = chain.step(st, torch.from_numpy(run["wires"][i]), params)
        assert_outputs_match(outputs_to_numpy(o), run["outs"][i],
                             f"{name} step {i}")
        assert_states_close(st, run["states"][i + 1], f"{name} step {i}")
    assert int(st.active_chan) == 4 and int(st.ct_max_idx) == 11
    # the plain versions never count
    assert (front_end.LAUNCHES, pfb_demod.LAUNCHES,
            resample_kernel.LAUNCHES) == launches


@pytest.mark.parametrize("name", ["row_trio", "fuse_dc_off"])
def test_trio_state_from_jax_resumes_in_port(jax_runs, name):
    """The JAX state after step 1 loads into the port unchanged, and the
    port's step 2 gives the JAX step 2 results."""
    run = jax_runs[name]
    st = tstate.state_from_numpy(run["states"][1], "cpu")
    for a, b in zip(tstate.state_to_numpy(st), run["states"][1]):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    _, o = port_chain(name).step(st, torch.from_numpy(run["wires"][1]),
                                 make_runtime_params(C.ScannerArgs(), "cpu"))
    assert_outputs_match(outputs_to_numpy(o), run["outs"][1], "resumed")


@pytest.mark.parametrize("name", ["row_trio", "fuse_dc_off"])
def test_trio_state_from_port_resumes_in_jax(jax_runs, name):
    """The port's state after step 1 loads into the JAX chain, whose step 2
    then gives its own step 2 results."""
    from sdr_pmr446_tpu.runtime import state as jstate
    run = jax_runs[name]
    chain = port_chain(name)
    st, _ = chain.step(chain.init_state(), torch.from_numpy(run["wires"][0]),
                       make_runtime_params(C.ScannerArgs(), "cpu"))
    jst = jstate.ScannerState(*(jnp.asarray(v)
                                for v in tstate.state_to_numpy(st)))
    jchain = run["chain"]
    _, o = jchain.step(jst, jnp.asarray(run["wires"][1].view(np.float32))
                       .reshape(jchain.step_arg_shape), run["params"])
    assert_outputs_match({f: np.asarray(v) for f, v in zip(o._fields, o)},
                         run["outs"][1], "handed back")


@pytest.mark.parametrize("switches", [dict(fuse_band=False),
                                      dict(fuse_dc=False),
                                      dict(fuse_band=True, fuse_dc=False)])
def test_trio_matches_port_default_engine(switches):
    """K = 3 over two steps with the waterfall on (-w 64, K3 on the
    engine's band planes): decisions, events and waterfall rows of the trio
    engines equal the default engine's under the trio/duo gate;
    ``fuse_dc=False`` implies the trio, as in JAX."""
    k = 3
    raw = decode.quantize_iq(capture(k), "cu8")
    params = make_runtime_params(C.ScannerArgs(waterfall=64), "cpu")
    outs = {}
    for name, kw in (("duo", {}), ("trio", switches)):
        chain = ScannerChain(C.BlockConfig(k), input_format="cu8",
                             device="cpu", waterfall=64, **kw)
        assert chain.fuse_band == (name == "duo")
        st, res = chain.init_state(), []
        wl = chain.step_arg_len
        for i in range(2):
            st, o = chain.step(st, torch.from_numpy(raw[i * wl:(i + 1) * wl]),
                               params)
            res.append(outputs_to_numpy(o))
        outs[name] = res
    for a, b in zip(outs["trio"], outs["duo"]):
        assert_outputs_match(a, b, f"{switches}")
        np.testing.assert_allclose(a["waterfall"], b["waterfall"], rtol=0,
                                   atol=2e-3)

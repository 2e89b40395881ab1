"""The scanner's op-path switches (K8 + the FSM's CTCSS scan) vs the JAX package.

``ScannerChain(fuse_ctcss=False)`` runs K8 ``apply_dc`` and
``fsm_ctcss_scan_v3``; ``fuse_lp_dc=False`` K8 ``apply``, the plain lp DC
blocker and v3; ``fuse_rssi=False`` K7's |y| plane (RSSI from its
per-sub-chunk mean), K8 ``apply_dc`` and v3.  Each turns the duo off, so
steps 1-2 are the trio's K6 -> K7.  On the CPU each is held, on the same cu8
bytes over two streamed K = 3 steps, to the JAX chain with the same switch
(``use_pallas=True, pallas_interpret=True``; its group path needs K % 8 ==
0 and is off on all three), under ``assert_outputs_match`` of
tests/test_torch_chain.py: decisions and events exact, rssi_db within 5e-3
dB, audio within 1e-4.  States pass both ways: the JAX state after step 1
gives the JAX step 2 in the port, the port's in JAX.  Each switched engine
also makes the port's default engine's decisions (as JAX
tests/test_scanner.py:301-315).

The ``cuda`` test runs each switched engine's step on the card under
``set_sync_debug_mode("error")`` and holds its decisions to the CPU run;
JAX is imported inside the tests that compare with it, so it also runs
where JAX is not installed:

    python -m pytest tests/test_torch_switches.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from sdr_pmr446_tpu import config as C
from sdr_pmr446_tpu.io import synth
from sdr_pmr446_tpu_torch.kernels import audio_bank
from sdr_pmr446_tpu_torch.ops import decode
from sdr_pmr446_tpu_torch.runtime import state as tstate
from sdr_pmr446_tpu_torch.scanner.chain import (ScannerChain,
                                                make_runtime_params,
                                                outputs_to_numpy)

torch.set_num_threads(2)

K = 3
#: engine -> the switch that is off, in both packages
SWITCHES = {"ctcss_off": dict(fuse_ctcss=False),
            "lp_dc_off": dict(fuse_lp_dc=False),
            "rssi_off": dict(fuse_rssi=False)}
DECISIONS = ("active_chan", "audio_valid", "ev_tuned", "ev_detuned",
             "ev_changed", "ct_detected", "ct_max_idx", "ev_ct_acquired",
             "ev_ct_changed", "ev_ct_lost")


def assert_outputs_match(port, ref, what):
    """tests/test_torch_chain.py's gate (imported here, since that module
    imports JAX at the top and the ``cuda`` test runs without it)."""
    from test_torch_chain import assert_outputs_match as gate
    gate(port, ref, what)


def capture_bytes(k):
    """Two cu8 blocks: channel 5 with CTCSS 12, a weaker channel 9."""
    n = 2 * k * C.SUBCHUNK_IN
    iq = (synth.make_scanner_iq(n, channel=5, ctcss_code=12)
          + synth.make_scanner_iq(n, channel=9, amplitude=0.2, seed=9)) / 1.2
    return decode.quantize_iq(iq, "cu8")


@pytest.fixture(scope="module")
def jax_runs():
    """Per switch: the JAX chain, its params, each step's outputs and the
    state before and after each step."""
    import jax.numpy as jnp
    from sdr_pmr446_tpu.scanner.chain import ScannerChain as JaxChain
    from sdr_pmr446_tpu.scanner.chain import make_runtime_params as jparams
    raw = capture_bytes(K)
    runs = {}
    for name, kw in SWITCHES.items():
        chain = JaxChain(C.BlockConfig(K), use_pallas=True,
                         pallas_interpret=True, input_format="cu8", **kw)
        assert not (chain.fuse_band or chain.fuse_ctcss or chain.fuse_group)
        params = jparams(C.ScannerArgs())
        st = chain.init_state()
        run = dict(chain=chain, params=params, outs=[],
                   states=[[np.asarray(v) for v in st]])
        n = K * C.SUBCHUNK_IN * 2
        for i in range(2):
            w = raw[i * n:(i + 1) * n].view(np.float32)
            st, o = chain.step(st, jnp.asarray(w).reshape(
                chain.step_arg_shape), params)
            run["outs"].append({f: np.asarray(v)
                                for f, v in zip(o._fields, o)})
            run["states"].append([np.asarray(v) for v in st])
        runs[name] = run
    return runs


def wires(k):
    raw = capture_bytes(k)
    n = k * C.SUBCHUNK_IN * 2
    return [torch.from_numpy(raw[i * n:(i + 1) * n].copy()) for i in range(2)]


def port_chain(name, device="cpu", k=K):
    return ScannerChain(C.BlockConfig(k), input_format="cu8", device=device,
                        **SWITCHES[name])


@pytest.mark.parametrize("name", list(SWITCHES))
def test_switch_matches_jax(jax_runs, name):
    run = jax_runs[name]
    chain = port_chain(name)
    assert not (chain.fuse_band or chain.fuse_ctcss)
    st = chain.init_state()
    for cur, ref in zip(tstate.state_to_numpy(st), run["states"][0]):
        assert (cur.shape, cur.dtype) == (ref.shape, ref.dtype)
    params = make_runtime_params(C.ScannerArgs(), "cpu")
    launches = (audio_bank.LAUNCHES, audio_bank.APPLY_LAUNCHES,
                audio_bank.APPLY_DC_LAUNCHES)
    for i, wire in enumerate(wires(K)):
        st, o = chain.step(st, wire, params)
        assert_outputs_match(outputs_to_numpy(o), run["outs"][i],
                             f"{name} step {i}")
    assert int(st.active_chan) == 4 and int(st.ct_max_idx) == 11
    # the plain versions never count
    assert (audio_bank.LAUNCHES, audio_bank.APPLY_LAUNCHES,
            audio_bank.APPLY_DC_LAUNCHES) == launches


@pytest.mark.parametrize("name", list(SWITCHES))
def test_switch_states_pass_both_ways(jax_runs, name):
    """The JAX state after step 1 gives the JAX step 2 in the port, and the
    port's state after step 1 gives it in the JAX chain."""
    import jax.numpy as jnp
    from sdr_pmr446_tpu.runtime import state as jstate
    run = jax_runs[name]
    params = make_runtime_params(C.ScannerArgs(), "cpu")
    w0, w1 = wires(K)
    chain = port_chain(name)
    _, o = chain.step(tstate.state_from_numpy(run["states"][1], "cpu"), w1,
                      params)
    assert_outputs_match(outputs_to_numpy(o), run["outs"][1], "from JAX")
    st, _ = chain.step(chain.init_state(), w0, params)
    jst = jstate.ScannerState(*(jnp.asarray(v)
                                for v in tstate.state_to_numpy(st)))
    jchain = run["chain"]
    _, jo = jchain.step(jst, jnp.asarray(w1.numpy().view(np.float32))
                        .reshape(jchain.step_arg_shape), run["params"])
    assert_outputs_match({f: np.asarray(v) for f, v in zip(jo._fields, jo)},
                         run["outs"][1], "to JAX")


def run_port(device, k, switches, args=None):
    params = make_runtime_params(args or C.ScannerArgs(), device)
    chain = ScannerChain(C.BlockConfig(k), input_format="cu8", device=device,
                         **switches)
    st, outs = chain.init_state(), []
    for wire in wires(k):
        st, o = chain.step(st, wire.to(device), params)
        outs.append(outputs_to_numpy(o))
    return outs


@pytest.mark.parametrize("switches", [dict(fuse_ctcss=False),
                                      dict(fuse_lp_dc=False),
                                      dict(fuse_rssi=False),
                                      dict(fuse_rssi=False, fuse_lp_dc=False,
                                           fuse_dc=False)])
def test_switch_matches_port_default_engine(switches):
    """K = 2 under lock_mode=max: each switched engine (and the three
    composed with K9, ``fuse_dc=False``) makes the default engine's
    decisions and events, its audio and RSSI within the trio/duo gate."""
    args = C.ScannerArgs(lock_mode="max")
    duo = run_port("cpu", 2, {}, args)
    for a, b in zip(run_port("cpu", 2, switches, args), duo):
        assert_outputs_match(a, b, f"{switches}")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SWITCHES))
def test_switch_step_on_card(name):
    """Each switched engine on the card: a warm step then one under
    set_sync_debug_mode("error") (no host read), K8 launched once a step
    where it runs, decisions equal to the CPU run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda", 0)
    k = 10
    chain = port_chain(name, dev, k)
    params = make_runtime_params(C.ScannerArgs(), dev)
    w0, w1 = (w.to(dev) for w in wires(k))
    st, o0 = chain.step(chain.init_state(), w0, params)
    torch.cuda.synchronize(dev)
    counts = (audio_bank.APPLY_LAUNCHES, audio_bank.APPLY_DC_LAUNCHES)
    torch.cuda.set_sync_debug_mode("error")
    try:
        st, o1 = chain.step(st, w1, params)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize(dev)
    apply_dc = name != "lp_dc_off"
    assert (audio_bank.APPLY_LAUNCHES, audio_bank.APPLY_DC_LAUNCHES) == (
        counts[0] + (not apply_dc), counts[1] + apply_dc)
    cpu = run_port("cpu", k, SWITCHES[name])
    for got, want in zip((outputs_to_numpy(o0), outputs_to_numpy(o1)), cpu):
        for f in DECISIONS:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        assert np.max(np.abs(got["audio"] - want["audio"])) < 1e-4

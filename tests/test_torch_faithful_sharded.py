"""The port's time-sharded faithful chain (parallel/faithful_sharded.py).

Mirrors tests/test_sharding.py:323 (``test_sharded_faithful_equals_
unsharded_faithful``): mesh (1, 4), K = 4, three steps of a transmission
on channel 5 with CTCSS 12 then receiver noise (a tune, then a detune),
lock_mode max.  The port's ShardedFaithfulChain on the CPU against the
port's unsharded FaithfulScannerChain and against JAX's
ShardedFaithfulChain (run once for the module on the 4-device virtual
mesh): the active channel, audio_valid and the detector's decisions
exact, the relative RSSI within 5e-3 dB and the audio within 1e-4 (JAX's
gates).  Also ``multi_step`` equal to the steps, two streams, and the
constructor's errors.
"""

import numpy as np
import pytest
import torch

from sdr_pmr446_tpu import config as C
from sdr_pmr446_tpu.io import synth
from sdr_pmr446_tpu_torch.parallel.faithful_sharded import (
    ShardedFaithfulChain)
from sdr_pmr446_tpu_torch.parallel.scanner_sharded import make_mesh
from sdr_pmr446_tpu_torch.scanner.chain import make_runtime_params
from sdr_pmr446_tpu_torch.scanner.faithful import FaithfulScannerChain

torch.set_num_threads(2)

K = 4
STEP = K * C.SUBCHUNK_IN
ARGS = C.ScannerArgs(lock_mode="max")
DECISIONS = ("active_chan", "audio_valid", "ct_detected", "ct_max_idx")


def busy_then_quiet(seed=2) -> np.ndarray:
    """tests/test_sharding.py:333's three steps."""
    sig = synth.make_scanner_iq(2 * STEP, channel=5, ctcss_code=12)
    rng = np.random.default_rng(seed)
    quiet = 1e-3 * (rng.standard_normal(STEP) + 1j * rng.standard_normal(
        STEP))
    return np.concatenate([sig[:2 * STEP], quiet]).astype(np.complex64)


def assert_gates(got: dict, want: dict, what: str) -> None:
    for f in DECISIONS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f"{what} {f}")
    np.testing.assert_allclose(got["rel_rssi"], want["rel_rssi"], rtol=0,
                               atol=5e-3, err_msg=f"{what} rel_rssi")
    np.testing.assert_allclose(got["audio"], want["audio"], rtol=0,
                               atol=1e-4, err_msg=f"{what} audio")


def numpy_of(o, stream=None) -> dict:
    return {f: (np.asarray(v) if stream is None else np.asarray(v)[stream])
            for f, v in zip(o._fields, o)}


def port_sharded(iq, n_streams=1):
    chain = ShardedFaithfulChain(make_mesh(n_streams, 4, "cpu"), K,
                                 device="cpu")
    params = make_runtime_params(ARGS, "cpu")
    st, outs = chain.init_state(), []
    for i in range(3):
        x = torch.from_numpy(np.ascontiguousarray(iq[..., i * STEP:
                                                     (i + 1) * STEP]))
        st, o = chain.step(st, x.reshape(n_streams, -1), params)
        outs.append(o)
    return chain, st, outs


@pytest.fixture(scope="module")
def jax_sharded():
    """JAX ShardedFaithfulChain's outputs a step on the same IQ."""
    import jax
    import jax.numpy as jnp
    from sdr_pmr446_tpu.parallel.faithful_sharded import (
        ShardedFaithfulChain as JaxSharded)
    from sdr_pmr446_tpu.parallel.scanner_sharded import (
        make_mesh as jax_mesh)
    from sdr_pmr446_tpu.scanner.chain import make_runtime_params as jparams
    iq = busy_then_quiet()
    chain = JaxSharded(jax_mesh(1, 4), subchunks_per_step=K)
    st, outs = chain.init_state(1), []
    for i in range(3):
        st, o = chain.step(st, jnp.asarray(iq[None, i * STEP:(i + 1) * STEP]),
                           jparams(ARGS))
        outs.append(jax.tree.map(np.asarray, o))
    return iq, outs


def test_sharded_faithful_equals_unsharded_port():
    iq = busy_then_quiet()
    ref = FaithfulScannerChain(K, device="cpu")
    params = make_runtime_params(ARGS, "cpu")
    st = ref.init_state()
    _, _, outs = port_sharded(iq)
    for i in range(3):
        st, o = ref.step(st, torch.from_numpy(iq[i * STEP:(i + 1) * STEP]),
                         params)
        assert_gates(numpy_of(outs[i], 0), numpy_of(o), f"step {i}")
    assert int(outs[0].active_chan[0, -1]) == 4      # channel 5, tuned
    assert int(outs[2].active_chan[0, -1]) == -1     # detuned in the noise


def test_sharded_faithful_matches_jax(jax_sharded):
    iq, want = jax_sharded
    _, _, outs = port_sharded(iq)
    for i in range(3):
        assert_gates(numpy_of(outs[i], 0), numpy_of(want[i], 0),
                     f"step {i}")


def test_sharded_faithful_two_streams_and_multi_step():
    """Two streams (the second the first delayed by a step) each equal
    the one-stream run; multi_step of the three blocks == the steps bit
    for bit (the loop on the CPU, a CUDA graph on the card)."""
    iq = busy_then_quiet()
    two = np.stack([iq, np.concatenate([np.zeros(STEP, np.complex64),
                                        iq[:2 * STEP]])])
    chain, st, outs = port_sharded(two, n_streams=2)
    _, _, one = port_sharded(iq)
    for i in range(3):
        for f in DECISIONS + ("audio", "rel_rssi"):
            np.testing.assert_array_equal(getattr(outs[i], f)[0],
                                          getattr(one[i], f)[0])
    params = make_runtime_params(ARGS, "cpu")
    xs = torch.from_numpy(two).reshape(2, 3, STEP).transpose(0, 1)
    st_m, o_m = chain.multi_step(chain.init_state(), xs.contiguous(), params)
    for f in o_m._fields:
        np.testing.assert_array_equal(
            getattr(o_m, f).numpy(),
            torch.cat([getattr(o, f) for o in outs], dim=1).numpy())
    for a, b in zip(st_m, st):
        assert torch.equal(a, b)


def test_sharded_faithful_constructor_errors():
    with pytest.raises(ValueError, match="divide"):
        ShardedFaithfulChain(make_mesh(1, 3, "cpu"), 4, device="cpu")
    chain = ShardedFaithfulChain(make_mesh(1, 2, "cpu"), 4, device="cpu")
    with pytest.raises(ValueError, match="complex64"):
        chain.step(chain.init_state(), torch.zeros((1, STEP)),
                   make_runtime_params(ARGS, "cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ShardedFaithfulChain(make_mesh(1, 2, "cpu"), 4)

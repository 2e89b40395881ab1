"""The port's time-sharded op engines (engine="op") on the one-card mesh.

  - The scanner at (2, 2), K = 4, cu8, -w 80, two streams (channel 5 with
    CTCSS 12, channel 9 with CTCSS 3), two steps, against JAX's sharded op
    engine (ShardedScannerChain(use_pallas=False)) on the virtual CPU mesh
    (tests/conftest.py) under JAX's sharded gates (tests/test_sharding.py:
    494-513): decisions and events exact, RSSI within 5e-3 dB, audio within
    1e-4; the waterfall rows within 2e-3 dB.
  - dsd_in and the single-channel monitor at (2, 2), K = 6 (K_local = 3,
    which the kernel engine refuses), two steps, against JAX's sharded op
    engines (ShardedDsdInChain / ShardedSingleChain, use_pallas=False) on
    the virtual CPU mesh on the same bytes, and against the unsharded port
    op chain per stream: PCM within 1 LSB and SNR > 60 dB, audio SNR > 60
    dB (tests/test_sharding.py:550-586, 712-751).  Against JAX the stacked
    state is held too: equal to JAX's init_state(2) at the start, and after
    each step its integer fields and the DC blocker's last input exact, every
    other field within 1e-4 of its peak (the DC blockers' noise gain 1 /
    DC_BLOCK_ALPHA = 2000 on f32 rounding is 1.2e-4; 1.5e-5 measured).
  - multi_step at S = 3 equal to three steps bit for bit on each sharded
    op chain.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sdr_pmr446_tpu import config as C
from sdr_pmr446_tpu.io import synth
from sdr_pmr446_tpu.ops import decode as jdecode
from sdr_pmr446_tpu_torch.ops import decode
from sdr_pmr446_tpu_torch.parallel.dsd_sharded import ShardedDsdInChain
from sdr_pmr446_tpu_torch.parallel.scanner_sharded import (ShardedScannerChain,
                                                           make_mesh)
from sdr_pmr446_tpu_torch.parallel.single_sharded import ShardedSingleChain
from sdr_pmr446_tpu_torch.scanner.chain import (make_runtime_params,
                                                outputs_to_numpy)
from sdr_pmr446_tpu_torch.scanner.dsd_in import DsdInChain
from sdr_pmr446_tpu_torch.scanner.single import SingleChannelChain

torch.set_num_threads(2)

DECISIONS = ("active_chan", "ct_detected", "ct_max_idx", "ev_tuned",
             "ev_detuned", "ev_changed", "ev_prev_chan", "ev_new_chan",
             "ev_ct_acquired", "ev_ct_changed", "ev_ct_lost", "audio_valid")
K_SCAN, K_MONO, STEPS, W = 4, 6, 2, 80
STREAMS = ((5, 12), (9, 3))


def stream_iq(n: int):
    return [synth.make_scanner_iq(n, channel=ch, ctcss_code=code, seed=s)
            for s, (ch, code) in enumerate(STREAMS)]


def snr_db(ref, got) -> float:
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return 10 * np.log10(np.sum(ref ** 2) / max(np.sum((got - ref) ** 2),
                                                 1e-300))


@pytest.fixture(scope="module")
def jax_sharded():
    """JAX's sharded op scanner over STEPS blocks: (port wires [step][S,
    bytes], outputs of each step)."""
    from sdr_pmr446_tpu.parallel.scanner_sharded import (
        ShardedScannerChain as JaxSharded, make_mesh as jax_mesh)
    from sdr_pmr446_tpu.scanner.chain import make_runtime_params as jparams
    chain = JaxSharded(jax_mesh(2, 2), C.BlockConfig(K_SCAN),
                       input_format="cu8", waterfall=W)
    assert not chain.use_pallas
    words = np.stack([jdecode.pack_iq(iq, "cu8") for iq in
                      stream_iq(STEPS * K_SCAN * C.SUBCHUNK_IN)])
    per = words.shape[1] // STEPS
    st = chain.init_state(2)
    params = jparams(C.ScannerArgs(waterfall=W))
    wires, outs = [], []
    for i in range(STEPS):
        w = words[:, i * per:(i + 1) * per]
        st, o = chain.step(st, jnp.asarray(w), params)
        outs.append({f: np.asarray(v) for f, v in zip(o._fields, o)})
        wires.append(np.ascontiguousarray(w).view(np.uint8))
    return wires, outs


def test_sharded_op_scanner_matches_jax(jax_sharded):
    wires, jouts = jax_sharded
    chain = ShardedScannerChain(make_mesh(2, 2, "cpu"),
                                C.BlockConfig(K_SCAN), input_format="cu8",
                                waterfall=W, device="cpu", engine="op")
    assert chain.engine_label == "op" and chain.k_local == 2
    params = make_runtime_params(C.ScannerArgs(waterfall=W), "cpu")
    st = chain.init_state()
    for i, w in enumerate(wires):
        st, o = chain.step(st, torch.from_numpy(w.copy()), params)
        got, want = outputs_to_numpy(o), jouts[i]
        for f in DECISIONS:
            np.testing.assert_array_equal(got[f], want[f],
                                          err_msg=f"step {i} {f}")
        np.testing.assert_allclose(got["rssi_db"], want["rssi_db"], rtol=0,
                                   atol=5e-3, err_msg=f"step {i} rssi")
        assert np.max(np.abs(got["audio"] - want["audio"])) < 1e-4, i
        np.testing.assert_allclose(got["waterfall"], want["waterfall"],
                                   rtol=0, atol=2e-3, err_msg=f"step {i}")
    assert [int(v) for v in st.active_chan] == [4, 8]


def fm_iq(n: int, tone_hz: float):
    """tests/test_dsd_in.py::_mk_iq: a tone-modulated FM carrier 300 Hz off
    the tuned centre (dsd_in demodulates the band centre)."""
    t = np.arange(n) / C.SDR_SAMPLERATE
    msg = 0.5 * np.sin(2 * np.pi * tone_hz * t)
    phase = 2 * np.pi * (300.0 * t + 2000.0 * np.cumsum(msg)
                         / C.SDR_SAMPLERATE)
    return 0.5 * np.exp(1j * phase)


def mono_wires(mode: str, n_steps: int, k: int):
    """[step] uint8 [S, bytes] of the two streams: FM tones at the band
    centre for dsd_in (cu8), channel 5 for the single-channel monitor
    (cf32) and the scanner (cu8)."""
    n = n_steps * k * C.SUBCHUNK_IN
    if mode == "dsd":
        iqs = [fm_iq(n, 1000.0), fm_iq(n, 700.0)]
    else:
        iqs = [0.7 * synth.make_scanner_iq(n, channel=5, ctcss_code=c,
                                           seed=s)
               for s, c in enumerate((12, 3))]
    fmt = "cf32" if mode == "single" else "cu8"
    raw = np.stack([decode.quantize_iq(iq, fmt) for iq in iqs])
    return np.split(raw, n_steps, axis=1)


#: mode -> (its sharded op chain on a mesh, its unsharded op chain)
MONO = {"dsd": (lambda mesh: ShardedDsdInChain(
                    mesh, K_MONO, input_format="cu8", device="cpu",
                    engine="op"),
                lambda: DsdInChain(K_MONO, "cu8", device="cpu", engine="op")),
        "single": (lambda mesh: ShardedSingleChain(
                       mesh, 5, K_MONO, input_format="cf32", device="cpu",
                       engine="op"),
                   lambda: SingleChannelChain(5, K_MONO, device="cpu",
                                              engine="op"))}


def jax_mono_chain(mode: str):
    """JAX's sharded op chain of ``mode`` on the virtual (2, 2) CPU mesh."""
    from sdr_pmr446_tpu.parallel.dsd_sharded import (
        ShardedDsdInChain as JaxDsd)
    from sdr_pmr446_tpu.parallel.scanner_sharded import make_mesh as jax_mesh
    from sdr_pmr446_tpu.parallel.single_sharded import (
        ShardedSingleChain as JaxSingle)
    if mode == "dsd":
        return JaxDsd(jax_mesh(2, 2), K_MONO, input_format="cu8")
    return JaxSingle(jax_mesh(2, 2), 5, K_MONO)


def assert_mono_state(got, want, what: str) -> None:
    """The module docstring's state gate: ``got`` the port's stacked state,
    ``want`` JAX's."""
    assert tuple(got._fields) == tuple(want._fields), what
    for f, a, b in zip(got._fields, got, want):
        a, b = a.numpy(), np.asarray(b)
        assert (a.shape, a.dtype) == (b.shape, b.dtype), (what, f)
        if b.dtype.kind in "biu" or f == "dc_x":
            np.testing.assert_array_equal(a, b, err_msg=f"{what}: {f}")
            continue
        peak = max(float(np.abs(b).max()), 1e-30)
        assert np.abs(a - b).max() <= 1e-4 * peak, (
            what, f, np.abs(a - b).max() / peak)


@pytest.mark.parametrize("mode", sorted(MONO))
def test_sharded_op_mono_matches_jax(mode):
    jchain = jax_mono_chain(mode)
    assert not jchain.mono
    chain = MONO[mode][0](make_mesh(2, 2, "cpu"))
    st, jst = chain.init_state(), jchain.init_state(2)
    assert_mono_state(st, jst, f"{mode} init")
    word = np.float32 if mode == "dsd" else np.complex64
    for i, wire in enumerate(mono_wires(mode, STEPS, K_MONO)):
        jst, jo = jchain.step(jst, jnp.asarray(wire.view(word)))
        want = np.asarray(jo.pcm if mode == "dsd" else jo)
        st, out = chain.step(st, torch.from_numpy(wire.copy()))
        got = out.numpy()
        assert (got.shape, got.dtype) == (want.shape, want.dtype), mode
        for s in range(2):
            if mode == "dsd":
                diff = np.abs(got[s].astype(np.int32) - want[s])
                assert diff.max() <= 1, (i, s, diff.max())
            assert snr_db(want[s], got[s]) > 60.0, (
                mode, i, s, snr_db(want[s], got[s]))
        assert_mono_state(st, jst, f"{mode} step {i}")


@pytest.mark.parametrize("mode", sorted(MONO))
def test_sharded_op_mono_matches_unsharded(mode):
    sharded, unsharded = MONO[mode]
    chain = sharded(make_mesh(2, 2, "cpu"))
    assert chain.k_local == 3
    ref = unsharded()
    st, refs = chain.init_state(), [ref.init_state(), ref.init_state()]
    for wire in mono_wires(mode, STEPS, K_MONO):
        st, out = chain.step(st, torch.from_numpy(wire.copy()))
        for s in range(2):
            refs[s], want = ref.step(refs[s], torch.from_numpy(wire[s].copy()))
            got, want = out[s].numpy(), want.numpy()
            if mode == "dsd":
                diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
                assert diff.max() <= 1, (s, diff.max())
            assert snr_db(want, got) > 60.0, (mode, s, snr_db(want, got))
    for f, a, *b in zip(st._fields, st, *refs):
        assert a.shape[1:] == b[0].shape, f


SHARDED = {"scanner": lambda: ShardedScannerChain(
               make_mesh(2, 2, "cpu"), C.BlockConfig(2), input_format="cu8",
               device="cpu", engine="op"),
           "dsd": lambda: MONO["dsd"][0](make_mesh(2, 2, "cpu")),
           "single": lambda: MONO["single"][0](make_mesh(2, 2, "cpu"))}


@pytest.mark.parametrize("name", sorted(SHARDED))
def test_sharded_op_multi_step_equals_steps(name):
    chain = SHARDED[name]()
    k = chain.block.subchunks_per_step if name == "scanner" else K_MONO
    wires = torch.stack([torch.from_numpy(w.copy())
                         for w in mono_wires(name, 3, k)])
    args = ((make_runtime_params(C.ScannerArgs(), "cpu"),)
            if name == "scanner" else ())
    st_m, fused = chain.multi_step(chain.init_state(), wires, *args)
    st, outs = chain.init_state(), []
    for w in wires:
        st, o = chain.step(st, w, *args)
        outs.append(o)
    if name == "scanner":
        for f, got, *each in zip(fused._fields, fused, *outs):
            assert torch.equal(got, torch.cat(each, dim=1)), f
    else:
        assert torch.equal(fused, torch.cat(outs, dim=1))
    for f, a, b in zip(st._fields, st_m, st):
        assert torch.equal(a, b), f

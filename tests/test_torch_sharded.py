"""The port's time-sharded chains (sdr_pmr446_tpu_torch/parallel/) vs JAX's.

Each JAX chain (sdr_pmr446_tpu/parallel/, ``use_pallas=True,
pallas_interpret=True``) runs once per module on the 8-device virtual CPU
mesh (tests/conftest.py); the port's runs on the CPU with its one-card mesh
(``make_mesh(S, D, "cpu")``) and the plain versions of its kernels, on the
same bytes.  The gates are JAX's sharded == unsharded gates:

  - the scanner (tests/test_sharding.py:494-513): the 12 decision and event
    fields exact, RSSI within 5e-3 dB, audio within 1e-4;
  - dsd_in PCM within 1 LSB and SNR > 60 dB, single-channel audio SNR >
    60 dB (tests/test_sharding.py:550-586, 712-751).

Engines: the duo at (1, 2), K = 16, cu8, two steps (K10's pre-pass); the
trio at (1, 2), K = 16, cf32, one step; the plane path at (1, 4), K = 4,
cu8, with the halos moved by K11 (``halo_dma=True``) and without, equal to
each other field for field; the sharded dsd / single mono chains at (1, 2),
K = 16.  Also the port's sharded duo against its own unsharded chain at
(2, 2) and (2, 1), and each package's sharded duo against its own
unsharded chain in the noise after a transmission; sharded states passed
both ways, and the constructor's errors.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sdr_pmr446_tpu import config as C
from sdr_pmr446_tpu.io import synth
from sdr_pmr446_tpu.ops import decode as jdecode
from sdr_pmr446_tpu_torch.kernels import halo_dma, summary
from sdr_pmr446_tpu_torch.ops import decode as tdecode
from sdr_pmr446_tpu_torch.parallel.dsd_sharded import ShardedDsdInChain
from sdr_pmr446_tpu_torch.parallel.scanner_sharded import (ShardedScannerChain,
                                                           make_mesh)
from sdr_pmr446_tpu_torch.parallel.single_sharded import ShardedSingleChain
from sdr_pmr446_tpu_torch.runtime import state as tstate
from sdr_pmr446_tpu_torch.scanner.chain import (ScannerChain,
                                                make_runtime_params,
                                                outputs_to_numpy)

torch.set_num_threads(2)

DECISIONS = ("active_chan", "ct_detected", "ct_max_idx", "ev_tuned",
             "ev_detuned", "ev_changed", "ev_prev_chan", "ev_new_chan",
             "ev_ct_acquired", "ev_ct_changed", "ev_ct_lost", "audio_valid")
#: engine -> (mesh, K, JAX wire format, steps, JAX chain switches)
SCANNERS = {"duo": ((1, 2), 16, "cu8", 2, {}),
            "trio": ((1, 2), 16, "cf32w", 1, dict(fuse_band=False)),
            "plane": ((1, 4), 4, "cu8", 2, {})}
PORT_FMT = {"cu8": "cu8", "cf32w": "cf32"}


def scanner_wire(k, n_steps, fmt):
    """(JAX transport words per step, the port's bytes per step) of the
    JAX sharded tests' capture (tests/test_sharding.py:452)."""
    step_len = k * C.SUBCHUNK_IN
    iq = synth.make_scanner_iq(n_steps * step_len, channel=5, ctcss_code=12)
    if fmt == "cf32w":
        words = np.empty(2 * len(iq), np.float32)
        words[0::2], words[1::2] = iq.real, iq.imag
    else:
        words = jdecode.pack_iq(np.asarray(iq), fmt)
    per = words.shape[0] // n_steps
    steps = [words[i * per:(i + 1) * per] for i in range(n_steps)]
    return steps, [w.view(np.uint8).copy() for w in steps]


def jax_outputs(o):
    return {f: np.asarray(v) for f, v in zip(o._fields, o)}


@pytest.fixture(scope="module")
def jax_scanners():
    """Per engine: the JAX chain, its params, the port's wire bytes, each
    step's outputs and the state before and after each step."""
    from sdr_pmr446_tpu.parallel.scanner_sharded import (
        ShardedScannerChain as JaxSharded, make_mesh as jax_mesh)
    from sdr_pmr446_tpu.scanner.chain import make_runtime_params as jparams
    runs = {}
    for name, ((n_s, n_t), k, fmt, n_steps, kw) in SCANNERS.items():
        chain = JaxSharded(jax_mesh(n_s, n_t), C.BlockConfig(k),
                           use_pallas=True, pallas_interpret=True,
                           input_format=fmt, **kw)
        assert chain.fused == (name != "plane")
        assert chain.fused_duo == (name == "duo")
        words, wires = scanner_wire(k, n_steps, fmt)
        params = jparams(C.ScannerArgs())
        st = chain.init_state(n_s)
        run = dict(chain=chain, params=params, words=words, wires=wires,
                   outs=[], states=[[np.asarray(v) for v in st]])
        for w in words:
            st, o = chain.step(st, jnp.asarray(w)[None], params)
            run["outs"].append(jax_outputs(o))
            run["states"].append([np.asarray(v) for v in st])
        runs[name] = run
    return runs


def assert_sharded_equal(got, want, what):
    """tests/test_sharding.py::_assert_fused_equal on [S, K, ...] leaves."""
    for f in DECISIONS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f"{what} {f}")
    np.testing.assert_allclose(got["rssi_db"], want["rssi_db"], rtol=0,
                               atol=5e-3, err_msg=f"{what} rssi")
    assert np.max(np.abs(got["audio"] - want["audio"])) < 1e-4, what


def port_scanner(name, **kw):
    (n_s, n_t), k, fmt, _, sw = SCANNERS[name]
    return ShardedScannerChain(make_mesh(n_s, n_t, "cpu"), C.BlockConfig(k),
                               input_format=PORT_FMT[fmt], device="cpu",
                               **sw, **kw)


def run_port(chain, wires, state=None):
    params = make_runtime_params(C.ScannerArgs(), "cpu")
    st = chain.init_state() if state is None else state
    outs = []
    for w in wires:
        st, o = chain.step(st, torch.from_numpy(w).reshape(
            chain.n_stream, -1), params)
        outs.append(outputs_to_numpy(o))
    return st, outs


def assert_state_layout(port_state, jax_values):
    """The same fields, shapes and dtypes; the integer fields exact."""
    for name, got, want in zip(tstate.ScannerState._fields,
                               tstate.state_to_numpy(port_state), jax_values):
        assert (got.shape, got.dtype) == (want.shape, want.dtype), name
        if got.dtype.kind in "biu":
            np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("name", list(SCANNERS))
def test_sharded_scanner_matches_jax(jax_scanners, name):
    run = jax_scanners[name]
    chain = port_scanner(name)
    assert (chain.fused, chain.fused_duo) == (name != "plane", name == "duo")
    assert_state_layout(chain.init_state(), run["states"][0])
    launches = (summary.LAUNCHES, halo_dma.LAUNCHES)
    st, outs = run_port(chain, run["wires"])
    for i, (got, want) in enumerate(zip(outs, run["outs"])):
        assert_sharded_equal(got, want, f"{name} step {i}")
    assert_state_layout(st, run["states"][-1])
    assert int(st.active_chan[0]) == 4
    assert (summary.LAUNCHES, halo_dma.LAUNCHES) == launches


def test_plane_path_halo_dma_equals_collective(jax_scanners):
    """The plane path with its two front-end halos moved by K11's ring
    shift equals the collective version field for field (and so JAX's,
    by the test above)."""
    run = jax_scanners["plane"]
    res = {dma: run_port(port_scanner("plane", halo_dma=dma), run["wires"])
           for dma in (False, True)}
    for a, b in zip(res[False][1], res[True][1]):
        for f in a:
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    for a, b in zip(tstate.state_to_numpy(res[False][0]),
                    tstate.state_to_numpy(res[True][0])):
        np.testing.assert_array_equal(a, b)


def test_sharded_state_from_jax_resumes_in_port(jax_scanners):
    """JAX's sharded state after step 1 loads into the port unchanged, and
    the port's step 2 meets the gate against JAX's step 2."""
    run = jax_scanners["duo"]
    st = tstate.state_from_numpy(run["states"][1], "cpu")
    for a, b in zip(tstate.state_to_numpy(st), run["states"][1]):
        np.testing.assert_array_equal(a, b)
    _, outs = run_port(port_scanner("duo"), run["wires"][1:], st)
    assert_sharded_equal(outs[0], run["outs"][1], "resumed in the port")


def test_sharded_state_from_port_resumes_in_jax(jax_scanners):
    """The port's sharded state after step 1 loads into the JAX chain,
    whose step 2 then meets the gate against its own step 2."""
    from sdr_pmr446_tpu.runtime import state as jstate
    run = jax_scanners["duo"]
    st, _ = run_port(port_scanner("duo"), run["wires"][:1])
    jst = jstate.ScannerState(*(jnp.asarray(v)
                                for v in tstate.state_to_numpy(st)))
    _, o = run["chain"].step(jst, jnp.asarray(run["words"][1])[None],
                             run["params"])
    assert_sharded_equal(jax_outputs(o), run["outs"][1], "resumed in JAX")


def two_stream_wires(k, n_steps=2):
    """Two distinct cu8 streams, as bytes [2 * wire bytes] a step."""
    n = k * C.SUBCHUNK_IN
    raws = [jdecode.pack_iq(np.asarray(synth.make_scanner_iq(
        n_steps * n, channel=5 + 4 * s, ctcss_code=12 - 7 * s, seed=s)),
        "cu8").view(np.uint8) for s in range(2)]
    wl = 2 * n
    return raws, [np.concatenate([r[i * wl:(i + 1) * wl] for r in raws])
                  for i in range(n_steps)]


@pytest.mark.parametrize("mesh_shape,k", [((2, 2), 16), ((2, 1), 8)])
def test_sharded_duo_matches_unsharded_port(mesh_shape, k):
    """Each stream of the port's sharded duo against the port's unsharded
    ScannerChain on the same bytes.  (S, 1) skips the pre-pass and K1
    keeps its carries, but is not bit-equal: K2 still runs from a zero
    lp-DC state and its tone sums are corrected."""
    raws, wires = two_stream_wires(k)
    chain = ShardedScannerChain(make_mesh(*mesh_shape, "cpu"),
                                C.BlockConfig(k), device="cpu")
    assert chain.fused_duo
    _, outs = run_port(chain, wires)
    params = make_runtime_params(C.ScannerArgs(), "cpu")
    ref = ScannerChain(C.BlockConfig(k), device="cpu")
    wl = ref.step_arg_len
    for s, raw in enumerate(raws):
        st = ref.init_state()
        for i in range(2):
            st, o = ref.step(st, torch.from_numpy(raw[i * wl:(i + 1) * wl]),
                             params)
            want = outputs_to_numpy(o)
            got = {f: v[s] for f, v in outs[i].items()}
            assert_sharded_equal(got, want, f"{mesh_shape} stream {s}")
        assert int(st.active_chan) == 4 + 4 * s


def hang_wire(k, end_subchunk, level):
    """Two cu8 steps of channel 5 + CTCSS 12 whose transmission ends at
    sub-chunk ``end_subchunk`` of step 2, noise of ``level`` per plane
    after it (chip_smoke.py's config-5 hang block): JAX transport words and
    the port's bytes a step."""
    n = k * C.SUBCHUNK_IN
    iq = synth.make_scanner_iq(2 * n, channel=5, ctcss_code=12, seed=200)
    end = n + end_subchunk * C.SUBCHUNK_IN
    rng = np.random.default_rng(300)
    iq[end:] = level * (rng.standard_normal(2 * n - end)
                        + 1j * rng.standard_normal(2 * n - end))
    words = jdecode.pack_iq(iq, "cu8")
    steps = np.split(words, 2)
    return steps, [w.view(np.uint8).copy() for w in steps]


@pytest.mark.parametrize("level", [0.02, 1e-3])
def test_noise_hang_in_both_packages(level):
    """Each package's sharded duo at (1, 2), K = 16, against its own
    unsharded chain on a capture whose transmission ends at sub-chunk 4
    of step 2, so that shard 1 starts in the noise after it.  Decisions
    and events exact and RSSI within 5e-3 dB throughout, in JAX as in the
    port.  Receiver noise (0.02, 2.5 LSB of cu8): the audio within 1e-4
    throughout.  Sub-LSB noise (1e-3): the wire is near constant, the
    DC-blocked band ~1e-6 and its demodulation rounding, so the audio is
    held only while the transmission is on; the departures after it are
    printed (``pytest -s``) for both packages, and between them."""
    from sdr_pmr446_tpu.parallel.scanner_sharded import (
        ShardedScannerChain as JaxSharded, make_mesh as jax_mesh)
    from sdr_pmr446_tpu.scanner.chain import ScannerChain as JaxChain
    from sdr_pmr446_tpu.scanner.chain import make_runtime_params as jparams
    k, end = 16, 4
    words, wires = hang_wire(k, end, level)
    jp = jparams(C.ScannerArgs())
    pair = {"jax": [], "port": []}
    ref = JaxChain(C.BlockConfig(k), use_pallas=True, pallas_interpret=True,
                   input_format="cu8")
    sh = JaxSharded(jax_mesh(1, 2), C.BlockConfig(k), use_pallas=True,
                    pallas_interpret=True, input_format="cu8")
    assert sh.fused_duo
    st1, st2 = ref.init_state(), sh.init_state(1)
    for w in words:
        st1, o1 = ref.step(st1, jnp.asarray(w).reshape(ref.step_arg_shape),
                           jp)
        st2, o2 = sh.step(st2, jnp.asarray(w)[None], jp)
        pair["jax"].append(({f: v[0] for f, v in jax_outputs(o2).items()},
                            jax_outputs(o1)))
    _, outs = run_port(ShardedScannerChain(make_mesh(1, 2, "cpu"),
                                           C.BlockConfig(k), device="cpu"),
                       wires)
    port = ScannerChain(C.BlockConfig(k), device="cpu")
    params = make_runtime_params(C.ScannerArgs(), "cpu")
    st = port.init_state()
    for w, got in zip(wires, outs):
        st, o = port.step(st, torch.from_numpy(w), params)
        pair["port"].append(({f: v[0] for f, v in got.items()},
                             outputs_to_numpy(o)))
    on = slice(None) if level > 0.01 else slice(0, end)
    for who, steps in pair.items():
        for i, (got, want) in enumerate(steps):
            sub = slice(None) if i == 0 else on
            assert_sharded_equal({**got, "audio": got["audio"][sub]},
                                 {**want, "audio": want["audio"][sub]},
                                 f"{who} step {i}")
        got, want = steps[1]
        assert not want["audio_valid"][end + 1:].any(), f"{who}: no detune"
        print(f"noise {level}, {who}: sharded vs unsharded audio after the "
              "transmission, max|diff| per sub-chunk", np.max(np.abs(
                  got["audio"][end:] - want["audio"][end:]), axis=-1))
    print(f"noise {level}: the port's unsharded audio vs JAX's after the "
          "transmission, max|diff|", np.max(np.abs(
              pair["port"][1][1]["audio"][end:]
              - pair["jax"][1][1]["audio"][end:])))


def fm_wire(k):
    """The JAX sharded dsd tests' FM capture (tests/test_sharding.py:560),
    cu8 words."""
    n = k * C.SUBCHUNK_IN
    t = np.arange(2 * n) / C.SDR_SAMPLERATE
    msg = 0.5 * np.sin(2 * np.pi * 1000.0 * t)
    iq = np.exp(1j * 2 * np.pi * (2000.0 * np.cumsum(msg)
                                  + 300.0 * np.arange(2 * n))
                / C.SDR_SAMPLERATE)
    return jdecode.pack_iq(iq, "cu8")


def snr_db(ref, got):
    err = got - ref
    return 10 * np.log10(max(np.mean(ref ** 2), 1e-30)
                         / max(np.mean(err ** 2), 1e-30))


@pytest.mark.parametrize("mode", ["dsd", "single"])
def test_sharded_mono_matches_jax(mode):
    from sdr_pmr446_tpu.parallel.scanner_sharded import make_mesh as jax_mesh
    k, chan = 16, 7
    if mode == "dsd":
        from sdr_pmr446_tpu.parallel.dsd_sharded import ShardedDsdInChain as J
        words = fm_wire(k)
        jch = J(jax_mesh(1, 2), k, use_pallas=True, pallas_interpret=True,
                input_format="cu8")
        port = ShardedDsdInChain(make_mesh(1, 2, "cpu"), k, device="cpu")
    else:
        from sdr_pmr446_tpu.parallel.single_sharded import (
            ShardedSingleChain as J)
        words = jdecode.pack_iq(np.asarray(synth.make_scanner_iq(
            2 * k * C.SUBCHUNK_IN, channel=chan, ctcss_code=6, seed=4)),
            "cu8")
        jch = J(jax_mesh(1, 2), channel=chan, subchunks_per_step=k,
                use_pallas=True, pallas_interpret=True, input_format="cu8")
        port = ShardedSingleChain(make_mesh(1, 2, "cpu"), chan, k,
                                  device="cpu")
    assert jch.mono
    jst, st = jch.init_state(1), port.init_state()
    assert [(np.asarray(a).shape, np.asarray(a).dtype) for a in jst] == \
        [(a.shape, a.dtype) for a in tstate.state_to_numpy(st)]
    wl = words.shape[0] // 2
    launches = (summary.LAUNCHES, halo_dma.LAUNCHES)
    for i in range(2):
        w = words[i * wl:(i + 1) * wl]
        jst, jo = jch.step(jst, jnp.asarray(w)[None])
        st, o = port.step(st, torch.from_numpy(w.view(np.uint8).copy())
                          .reshape(1, -1))
        want = np.asarray(jo.pcm if mode == "dsd" else jo, np.float64)[0]
        got = o.numpy().astype(np.float64)[0]
        assert got.shape == want.shape
        assert snr_db(want, got) > 60.0, (i, snr_db(want, got))
        if mode == "dsd":
            assert o.dtype == torch.int16
            assert np.max(np.abs(got - want)) <= 1.0, i
    if mode == "single":
        assert int(st.n0[0]) == int(np.asarray(jst.n0)[0])
    assert (summary.LAUNCHES, halo_dma.LAUNCHES) == launches


def test_constructors_reject_what_is_not_ported():
    """The constructors' errors; the waterfall is ported (an invalid
    width is an error, as in the unsharded chain)."""
    mesh = make_mesh(1, 4, "cpu")
    with pytest.raises(ValueError, match="divide"):
        ShardedScannerChain(mesh, C.BlockConfig(6), device="cpu")
    with pytest.raises(ValueError, match="multiple of 4"):
        ShardedScannerChain(mesh, C.BlockConfig(8), waterfall=6,
                            device="cpu")
    assert ShardedScannerChain(mesh, C.BlockConfig(8), waterfall=64,
                               device="cpu").wf.w == 64   # ported now
    chain = ShardedScannerChain(mesh, C.BlockConfig(4), device="cpu")
    wire = torch.full((2, 1, chain.step_arg_len), 127, dtype=torch.uint8)
    _, out = chain.multi_step(chain.init_state(), wire,
                              make_runtime_params(C.ScannerArgs(), "cpu"))
    assert out.active_chan.shape == (1, 8)           # multi_step now runs
    for cls, args in ((ShardedDsdInChain, ()), (ShardedSingleChain, (5,))):
        with pytest.raises(ValueError, match="divide"):
            cls(mesh, *args, 6, device="cpu")
        with pytest.raises(ValueError, match='engine="op"'):
            cls(mesh, *args, 16, device="cpu")          # K_local = 4
        op = cls(mesh, *args, 16, input_format="cf32", device="cpu",
                 engine="op")                           # K_local = 4 runs
        st, out = op.step(op.init_state(), torch.zeros(
            (1, op.step_arg_len), dtype=torch.uint8))
        assert op.k_local == 4 and out.shape == (1, op.output_len)
    with pytest.raises(ValueError, match="runs on 'cuda'"):
        ShardedScannerChain(mesh, C.BlockConfig(4), device="meta")
    with pytest.raises(ValueError, match="wire must be uint8"):
        chain.step(chain.init_state(), torch.zeros(3, dtype=torch.uint8),
                   make_runtime_params(C.ScannerArgs(), "cpu"))


def test_entry_points_default_to_the_card():
    """make_mesh and every sharded chain default to cuda, which raises on
    a host without a CUDA device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(1, 2)
    mesh = make_mesh(1, 2, "cpu")
    for make in (lambda: ShardedScannerChain(mesh, C.BlockConfig(16)),
                 lambda: ShardedDsdInChain(mesh, 16),
                 lambda: ShardedSingleChain(mesh, 5, 16)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


# ------------------------------------------------------ the sharded waterfall
def wf_wires(k, n_steps, fmt):
    """One stream of tests/test_sharding.py:452's capture, as the port's
    ``fmt`` wire bytes a step."""
    step_len = k * C.SUBCHUNK_IN
    iq = synth.make_scanner_iq(n_steps * step_len, channel=5, ctcss_code=12)
    raw = tdecode.quantize_iq(np.asarray(iq), fmt)
    per = raw.shape[0] // n_steps
    return iq, [raw[i * per:(i + 1) * per] for i in range(n_steps)]


def wf_pair(k, n_t, w, n_steps=1, fmt="cf32", **sw):
    """(the unsharded port chain's rows and carries, the (1, n_t) sharded
    chain's), step by step, on the same bytes."""
    params = make_runtime_params(C.ScannerArgs(), "cpu")
    ref = ScannerChain(C.BlockConfig(k), input_format=fmt, device="cpu",
                       waterfall=w, **sw)
    chain = ShardedScannerChain(make_mesh(1, n_t, "cpu"), C.BlockConfig(k),
                                input_format=fmt, device="cpu", waterfall=w,
                                **sw)
    _, wires = wf_wires(k, n_steps, fmt)
    st1, st2, pairs = ref.init_state(), chain.init_state(), []
    for wire in wires:
        x = torch.from_numpy(wire)
        st1, o1 = ref.step(st1, x, params)
        st2, o2 = chain.step(st2, x[None], params)
        pairs.append((o1, st1, o2, st2))
    return chain, pairs


def assert_rows(pairs, what):
    """JAX's sharded waterfall gate tightened to the port's 2e-3 dB, the
    hop counter exact, the carried history to f32 rounding."""
    for i, (o1, st1, o2, st2) in enumerate(pairs):
        assert o2.waterfall.shape == (1,) + tuple(o1.waterfall.shape)
        np.testing.assert_allclose(o2.waterfall[0].numpy(),
                                   o1.waterfall.numpy(), rtol=0, atol=2e-3,
                                   err_msg=f"{what} step {i}")
        np.testing.assert_array_equal(o2.active_chan[0], o1.active_chan)
        assert int(st2.wf_cnt[0]) == int(st1.wf_cnt)
        np.testing.assert_allclose(st2.wf_hist[0].numpy(),
                                   st1.wf_hist.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("w", [64, 120])
def test_sharded_waterfall_equals_unsharded(w):
    """tests/test_sharding.py:367 at (1, 4), K = 4 (the plane path, K9's
    bands), two steps: w = 120 is the general width, its per-shard hop
    counter analytic from the carried one."""
    chain, pairs = wf_pair(4, 4, w, n_steps=2)
    assert not chain.fused
    assert_rows(pairs, f"plane path w={w}")


@pytest.mark.parametrize("name,k,n_t,w,sw", [
    ("four_shards", 32, 4, 64, {}),              # tests/test_sharding.py:543
    ("general_width", 32, 2, 128, {}),           # :814
    ("trio", 16, 2, 120, dict(fuse_band=False))])
def test_sharded_fused_waterfall(name, k, n_t, w, sw):
    """The duo's K1 bands after the exact-state pre-pass, and the trio's
    corrected planes, each shard's rows by K3."""
    chain, pairs = wf_pair(k, n_t, w, **sw)
    assert chain.fused and chain.fused_duo == (name != "trio")
    assert_rows(pairs, name)


def test_sharded_waterfall_matches_jax():
    """Against JAX's sharded chain (its op engine on the 4-device virtual
    mesh) at (1, 4), K = 4, w = 120, cf32, two steps: rows within 2e-3 dB,
    the hop counter exact."""
    from sdr_pmr446_tpu.parallel.scanner_sharded import (
        ShardedScannerChain as JaxSharded, make_mesh as jax_mesh)
    from sdr_pmr446_tpu.scanner.chain import make_runtime_params as jparams
    k, w = 4, 120
    jchain = JaxSharded(jax_mesh(1, 4), C.BlockConfig(k), waterfall=w)
    chain = ShardedScannerChain(make_mesh(1, 4, "cpu"), C.BlockConfig(k),
                                input_format="cf32", device="cpu",
                                waterfall=w)
    iq, wires = wf_wires(k, 2, "cf32")
    n = k * C.SUBCHUNK_IN
    jst, st = jchain.init_state(1), chain.init_state()
    params = make_runtime_params(C.ScannerArgs(), "cpu")
    for i, wire in enumerate(wires):
        jst, jo = jchain.step(jst, jnp.asarray(
            iq[None, i * n:(i + 1) * n], jnp.complex64),
            jparams(C.ScannerArgs()))
        st, o = chain.step(st, torch.from_numpy(wire)[None], params)
        np.testing.assert_allclose(o.waterfall.numpy(),
                                   np.asarray(jo.waterfall), rtol=0,
                                   atol=2e-3, err_msg=f"step {i}")
        np.testing.assert_array_equal(st.wf_cnt.numpy(),
                                      np.asarray(jst.wf_cnt))


def test_sharded_waterfall_multi_step():
    """multi_step (the CUDA graph's steps; on the CPU the loop) of two
    blocks with the waterfall on == the two steps, rows and carries."""
    k, w = 16, 120
    chain = ShardedScannerChain(make_mesh(1, 2, "cpu"), C.BlockConfig(k),
                                device="cpu", waterfall=w)
    _, wires = wf_wires(k, 2, "cu8")
    _, outs = run_port(chain, wires)
    params = make_runtime_params(C.ScannerArgs(), "cpu")
    st, o = chain.multi_step(chain.init_state(), torch.stack(
        [torch.from_numpy(x)[None] for x in wires]), params)
    assert o.waterfall.shape == (1, 2 * k, w)
    np.testing.assert_array_equal(o.waterfall[0].numpy(), np.concatenate(
        [out["waterfall"][0] for out in outs]))


def test_shard_hist_reach_spans_shards():
    """The history of a shard when w/2 exceeds a shard's band: the
    hist_len samples of [carried | shard 0 | ... | shard D-1] before its
    first, and the carry their last hist_len (JAX's shard_hist takes one
    neighbour's tail only); at hist_len <= T, shard_hist_planes'
    values bit for bit."""
    from sdr_pmr446_tpu_torch.parallel import halo
    rng = np.random.default_rng(3)
    n_s, n_t, t = 2, 3, 5
    planes = torch.from_numpy(rng.standard_normal(
        (n_s, n_t, 2, t)).astype(np.float32))
    for hist_len in (4, 5, 7, 12):
        carried = torch.from_numpy((rng.standard_normal((n_s, hist_len))
                                    + 1j * rng.standard_normal(
                                        (n_s, hist_len))).astype(np.complex64))
        hist, carry = halo.shard_hist_reach(carried, planes, hist_len)
        sig = torch.complex(planes[:, :, 0], planes[:, :, 1]).reshape(n_s, -1)
        seq = torch.cat([carried, sig], dim=-1)
        for d in range(n_t):
            assert torch.equal(hist[:, d], seq[:, d * t:d * t + hist_len])
            assert hist[1, d].is_contiguous()
        assert torch.equal(carry, seq[:, -hist_len:])
        if hist_len <= t:
            want = halo.shard_hist_planes(carried, planes, hist_len)
            assert torch.equal(hist, want[0]) and torch.equal(carry, want[1])


def test_sharded_waterfall_wider_than_a_shard():
    """w = 78400 at K_local = 1: each shard's w/2 = 39200-sample history
    is its two left neighbours' bands (or the carried history), so the
    rows equal the unsharded chain's.  K3 is replaced by a recorder (its
    plain version's [w, 2w] table does not fit): the history each shard
    got is the window of the band sequence before it, across both steps,
    and the carries are the last shard's."""
    from sdr_pmr446_tpu_torch.kernels.waterfall import WfOut
    k, n_t, w = 2, 2, 78400
    chain = ShardedScannerChain(make_mesh(1, n_t, "cpu"), C.BlockConfig(k),
                                device="cpu", waterfall=w)
    wl, hop = w // 2, w // 4
    calls = []

    class Recorder:
        """K3's interface: WfOut(the last w/2 of [hist | band], the
        counter moved on, zero rows)."""
        wl = chain.wf.wl

        def __call__(self, band, hist, cnt):
            calls.append((band.clone(), hist.clone(), int(cnt)))
            seq = torch.cat([hist, torch.complex(band[0], band[1])])
            return WfOut(seq[-wl:], (cnt + band.shape[1]) % hop,
                         torch.zeros((band.shape[1] // C.SUBCHUNK_RESAMP, w)))

    chain.wf = Recorder()
    _, wires = wf_wires(k, 2, "cu8")
    _, outs = run_port(chain, wires)
    assert len(calls) == 2 * n_t and outs[1]["waterfall"].shape == (1, k, w)
    seq = torch.cat([torch.zeros(wl, dtype=torch.complex64)] + [
        torch.complex(b[0], b[1]) for b, _, _ in calls])
    nb = calls[0][0].shape[1]
    for i, (_, hist, cnt) in enumerate(calls):
        assert hist.shape == (wl,) and wl > nb
        assert torch.equal(hist, seq[i * nb:i * nb + wl]), i
        assert cnt == (i * nb) % hop

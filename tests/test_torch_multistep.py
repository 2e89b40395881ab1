"""The port's multi-block dispatch (runtime/fuse.py, ``multi_step``, the
driver's ``steps_per_dispatch`` / ``prefetch_depth``) on the CPU.

Counterparts of tests/test_multistep.py's eight tests (:50-239), on
``device="cpu"``, where a megastep is the loop of its S steps and so must
equal them bit for bit (JAX's lax.scan body recompiles and agrees to f32
rounding only): every output field, every state field, a continuation
from the returned state, and a held state that a later call must leave
unchanged.  Against the JAX package on the same seeded capture bytes,
each JAX run once a module: the port's ScannerDriver(steps_per_dispatch=3)
against JAX's (its CPU engine) over 7 blocks at K = 2, and
ScannerChain.multi_step against JAX's at test_torch_chain.py's engine and
K (the duo under the Pallas interpreter, K = 8, cu8), S = 3: events and
the active trace exact, RSSI within 5e-3 dB, audio within 1e-4 (the gate
of tests/test_torch_chain.py:32-44).  Also: the launch counts under a
capture and its replays (a recorder that emulates a graph), the loop only
on the CPU, and the ``cuda`` tests (a megastep on the card equal to its
steps bit for bit, the driver's S = 3 equal to S = 1, its S = 2 read-back
through reused pinned staging buffers equal to S = 1 with what
``on_subchunk`` received left unchanged), which skip without a card.  The JAX package is imported only inside the fixtures that run it,
so the ``cuda`` tests run on a card's host without JAX (``--noconftest``).
"""

import numpy as np
import pytest
import torch

from sdr_pmr446_tpu_torch import config as TC
from sdr_pmr446_tpu_torch.io import synth
from sdr_pmr446_tpu_torch.kernels import audio_bank, duo
from sdr_pmr446_tpu_torch.ops import decode
from sdr_pmr446_tpu_torch.parallel.dsd_sharded import ShardedDsdInChain
from sdr_pmr446_tpu_torch.parallel.scanner_sharded import (ShardedScannerChain,
                                                           make_mesh)
from sdr_pmr446_tpu_torch.parallel.single_sharded import ShardedSingleChain
from sdr_pmr446_tpu_torch.runtime import fuse
from sdr_pmr446_tpu_torch.runtime.driver import ScannerDriver, wire_blocks
from sdr_pmr446_tpu_torch.scanner.chain import (ScannerChain,
                                                make_runtime_params,
                                                outputs_to_numpy)
from sdr_pmr446_tpu_torch.scanner.dsd_in import DsdInChain
from sdr_pmr446_tpu_torch.scanner.faithful import FaithfulScannerChain
from sdr_pmr446_tpu_torch.scanner.single import SingleChannelChain

torch.set_num_threads(2)

FLOAT_FIELDS = ("audio", "rel_rssi", "rssi_db", "ct_freq", "waterfall")


def scanner_iq(n_blocks, k, seed=0):
    """tests/test_multistep.py::_blocks as one capture."""
    return synth.make_scanner_iq(n_blocks * k * TC.SUBCHUNK_IN, channel=5,
                                 ctcss_code=12, seed=seed)


def wires(iq, fmt, n_blocks):
    """The capture's wire bytes, uint8 [n_blocks, bytes a block]."""
    raw = decode.quantize_iq(np.asarray(iq), fmt)
    return torch.from_numpy(raw.copy()).reshape(n_blocks, -1)


def fm_iq(n):
    """tests/test_multistep.py's dsd fixture: a strong FM carrier."""
    fs = TC.SDR_SAMPLERATE
    t = np.arange(n) / fs
    msg = 0.5 * np.sin(2 * np.pi * 1000.0 * t)
    return np.exp(1j * 2 * np.pi * (2000.0 * np.cumsum(msg)
                                    + 300.0 * np.arange(n)) / fs)


def leaves(tree):
    return list(tree) if isinstance(tree, tuple) else [tree]


def assert_tree_equal(got, want, what):
    for i, (g, w) in enumerate(zip(leaves(got), leaves(want))):
        assert g.shape == w.shape and g.dtype == w.dtype, (what, i)
        assert torch.equal(g, w), (what, i)


def steps(chain, state, xs, *args):
    """S single steps; their outputs concatenated as multi_step's."""
    outs = []
    for x in xs:
        state, o = chain.step(state, x, *args)
        outs.append(o)
    return state, outs


def check_megastep(chain, state, xs, *args, dim=0):
    """multi_step from ``state`` equals the steps bit for bit, twice in a
    row (the second from the returned state), and leaves the state it
    returned first unchanged."""
    held = None
    for half in torch.chunk(xs, 2, dim=0):
        st_a, outs = steps(chain, state, half, *args)
        st_b, fused = chain.multi_step(state, half, *args)
        want = fuse._concat(outs, dim)
        assert_tree_equal(fused, want, "outputs")
        assert_tree_equal(st_b, st_a, "state")
        if held is None:
            held = (st_b, [t.clone() for t in st_b])
        state = st_b
    assert_tree_equal(held[0], type(held[0])(*held[1]), "held state")
    return fused


# ---------------------------------------- tests/test_multistep.py, ported
def test_multi_step_equals_steps():
    k, s = 2, 3
    chain = ScannerChain(TC.BlockConfig(k), input_format="cf32",
                         device="cpu", waterfall=64)
    params = make_runtime_params(TC.ScannerArgs(waterfall=64), "cpu")
    xs = wires(scanner_iq(2 * s, k), "cf32", 2 * s)
    fused = check_megastep(chain, chain.init_state(), xs, params)
    assert fused.audio.shape == (s * k, TC.SUBCHUNK_AUDIO)
    assert fused.waterfall.shape == (s * k, 64)
    assert (fused.active_chan == 4).any()


def test_driver_steps_per_dispatch_equivalence():
    """7 blocks at S = 3: two megasteps and a 1-block tail."""
    k, n_blocks = 2, 7
    raw = decode.quantize_iq(scanner_iq(n_blocks, k), "cs16")
    runs = {}
    for s in (1, 3):
        drv = ScannerDriver(subchunks_per_step=k, input_format="cs16",
                            device="cpu", steps_per_dispatch=s)
        runs[s] = drv.run(wire_blocks(raw, "cs16", drv.feed_len))
        assert drv.block_index == n_blocks
    r1, r3 = runs[1], runs[3]
    assert r1.events == r3.events and r1.events
    for name in ("audio", "audio_subchunks", "active_trace", "rssi_trace",
                 "rel_rssi", "ct_detected", "ct_max_idx"):
        np.testing.assert_array_equal(getattr(r3, name), getattr(r1, name),
                                      err_msg=name)


@pytest.mark.parametrize("engine", ["plane", "duo"])
def test_sharded_multi_step_equals_steps(engine):
    """The plane path at (2, 2), K = 2, and the duo (K10's pre-pass) at
    (1, 2), K = 16: outputs stream-major [S, S_steps * K, ...]."""
    (n_s, n_t), k, s = {"plane": ((2, 2), 2, 2), "duo": ((1, 2), 16, 1)}[
        engine]
    chain = ShardedScannerChain(make_mesh(n_s, n_t, "cpu"),
                                TC.BlockConfig(k), device="cpu")
    assert chain.fused_duo == (engine == "duo")
    params = make_runtime_params(TC.ScannerArgs(), "cpu")
    xs = torch.stack([wires(scanner_iq(2 * s, k, seed=7 + i), "cu8", 2 * s)
                      for i in range(n_s)], dim=1)   # [2s, n_s, bytes]
    fused = check_megastep(chain, chain.init_state(), xs, params, dim=1)
    assert fused.active_chan.shape == (n_s, s * k)


@pytest.mark.parametrize("mono", [True, False])
def test_single_and_dsd_multi_step(mono):
    k, s = 1, 3
    xs = wires(scanner_iq(2 * s, k, seed=11), "cf32", 2 * s)
    sc = SingleChannelChain(5, k, input_format="cf32", device="cpu",
                            mono=mono)
    check_megastep(sc, sc.init_state(), xs)
    dc = DsdInChain(k, input_format="cf32", device="cpu", mono=mono)
    fm = wires(fm_iq(2 * s * dc.input_len), "cf32", 2 * s)
    pcm = check_megastep(dc, dc.init_state(), fm)
    assert pcm.dtype == torch.int16 and pcm.shape == (s * dc.output_len,)


def test_faithful_multi_step():
    k, s = 2, 2
    chain = FaithfulScannerChain(k, device="cpu")
    params = make_runtime_params(TC.ScannerArgs(), "cpu")
    iq = scanner_iq(2 * s, k, seed=21).astype(np.complex64)
    xs = torch.from_numpy(iq).reshape(2 * s, -1)
    fused = check_megastep(chain, chain.init_state(), xs, params)
    assert fused.audio.shape == (s * k, TC.SUBCHUNK_AUDIO)


def test_driver_prefetch_depth_equivalence():
    k = 2
    raw = decode.quantize_iq(scanner_iq(4, k), "cu8")
    runs = []
    for depth in (1, 4):
        drv = ScannerDriver(subchunks_per_step=k, device="cpu",
                            prefetch_depth=depth)
        assert drv.prefetch_depth == depth
        runs.append(drv.run(wire_blocks(raw, "cu8", drv.feed_len)))
    assert runs[0].events == runs[1].events
    np.testing.assert_array_equal(runs[0].active_trace, runs[1].active_trace)
    np.testing.assert_array_equal(runs[0].audio, runs[1].audio)


@pytest.mark.parametrize("mode", ["dsd", "single"])
def test_dsd_sharded_multi_step(mode):
    """The sharded mono chains at (2, 2), K = 16 (K_local = 8)."""
    k, s = 16, 1
    mesh = make_mesh(2, 2, "cpu")
    chain = (ShardedDsdInChain(mesh, k, device="cpu") if mode == "dsd" else
             ShardedSingleChain(mesh, 5, k, device="cpu"))
    one = wires(fm_iq(2 * s * chain.input_len), "cu8", 2 * s)
    xs = torch.stack([one, one.flip(0)], dim=1)      # [2s, 2, bytes]
    out = check_megastep(chain, chain.init_state(), xs, dim=1)
    assert out.shape == (2, s * chain.output_len)


def test_multi_step_packed_input():
    """A megastep over raw cs16 wire bytes decodes each block as a step."""
    k, s = 1, 2
    chain = ScannerChain(TC.BlockConfig(k), input_format="cs16",
                         device="cpu")
    params = make_runtime_params(TC.ScannerArgs(), "cpu")
    xs = wires(scanner_iq(2 * s, k, seed=3), "cs16", 2 * s)
    assert xs.shape[1] == chain.step_arg_len
    check_megastep(chain, chain.init_state(), xs, params)
    with pytest.raises(ValueError, match="expected"):
        chain.multi_step(chain.init_state(), xs[:, 1:], params)


# ------------------------------------------------------ against the JAX one
DRIVER_K, DRIVER_BLOCKS = 2, 7


@pytest.fixture(scope="module")
def driver_capture():
    """cs16: channel 5 with CTCSS 12 for 10 sub-chunks, then silence."""
    n1 = 10 * TC.SUBCHUNK_IN
    n2 = DRIVER_BLOCKS * DRIVER_K * TC.SUBCHUNK_IN - n1
    rng = np.random.default_rng(5)
    iq = np.concatenate([
        0.7 * synth.make_scanner_iq(n1, channel=5, ctcss_code=12),
        1e-3 * (rng.standard_normal(n2) + 1j * rng.standard_normal(n2))])
    return decode.quantize_iq(iq, "cs16")


@pytest.fixture(scope="module")
def jax_driver_run(driver_capture):
    from sdr_pmr446_tpu import config as C
    from sdr_pmr446_tpu.io import iq as iq_io
    from sdr_pmr446_tpu.ops import decode as jdecode
    from sdr_pmr446_tpu.runtime.driver import ScannerDriver as JaxDriver
    jd = JaxDriver(C.ScannerArgs(), subchunks_per_step=DRIVER_K,
                   input_format="cs16", engine="xla", steps_per_dispatch=3)
    return jd.run(iq_io.block_stream(jdecode.pack_bytes(
        driver_capture.view(np.int16), "cs16"), jd.feed_len))


def test_driver_steps_per_dispatch_matches_jax(driver_capture,
                                               jax_driver_run):
    want = jax_driver_run
    drv = ScannerDriver(subchunks_per_step=DRIVER_K, input_format="cs16",
                        device="cpu", steps_per_dispatch=3)
    got = drv.run(wire_blocks(driver_capture, "cs16", drv.feed_len))
    assert drv.block_index == DRIVER_BLOCKS
    assert got.events == want.events
    assert any(e.startswith("Tuned to channel 5") for e in got.events)
    assert any(e.startswith("Detuned") for e in got.events)
    np.testing.assert_array_equal(got.active_trace, want.active_trace)
    np.testing.assert_array_equal(got.audio_subchunks, want.audio_subchunks)
    np.testing.assert_allclose(got.rssi_trace, want.rssi_trace, rtol=0,
                               atol=5e-3)
    np.testing.assert_allclose(got.rel_rssi, want.rel_rssi, rtol=0,
                               atol=5e-3)
    assert got.audio.shape == want.audio.shape
    assert np.max(np.abs(got.audio - want.audio)) < 1e-4


CHAIN_K, CHAIN_S = 8, 3


@pytest.fixture(scope="module")
def jax_chain_megastep():
    """JAX ScannerChain.multi_step on test_torch_chain.py's engine (the
    duo under the Pallas interpreter, K = 8, cu8), S = 3, from the zero
    state: (the wire bytes [S, bytes], its outputs)."""
    import jax.numpy as jnp
    from sdr_pmr446_tpu import config as C
    from sdr_pmr446_tpu.io import synth as jsynth
    from sdr_pmr446_tpu.ops import decode as jdecode
    from sdr_pmr446_tpu.scanner.chain import ScannerChain as JaxChain
    from sdr_pmr446_tpu.scanner.chain import make_runtime_params as jparams
    iq = jsynth.make_scanner_iq(CHAIN_S * CHAIN_K * C.SUBCHUNK_IN,
                                channel=5, ctcss_code=12)
    words = jdecode.pack_iq(iq, "cu8")
    chain = JaxChain(C.BlockConfig(CHAIN_K), use_pallas=True,
                     pallas_interpret=True, input_format="cu8")
    xs = jnp.asarray(words).reshape((CHAIN_S,) + chain.step_arg_shape)
    _, o = chain.multi_step(chain.init_state(), xs, jparams(C.ScannerArgs()))
    return (words.view(np.uint8).reshape(CHAIN_S, -1).copy(),
            {f: np.asarray(v) for f, v in zip(o._fields, o)})


def test_chain_multi_step_matches_jax(jax_chain_megastep):
    raw, want = jax_chain_megastep
    chain = ScannerChain(TC.BlockConfig(CHAIN_K), input_format="cu8",
                         device="cpu")
    _, o = chain.multi_step(chain.init_state(), torch.from_numpy(raw),
                            make_runtime_params(TC.ScannerArgs(), "cpu"))
    got = outputs_to_numpy(o)
    assert got.keys() == want.keys()
    for f, w in want.items():
        assert got[f].shape == w.shape, f
        if f not in FLOAT_FIELDS:
            np.testing.assert_array_equal(got[f], w, err_msg=f)
    for f in ("rssi_db", "rel_rssi"):
        np.testing.assert_allclose(got[f], want[f], rtol=0, atol=5e-3)
    np.testing.assert_array_equal(got["ct_freq"], want["ct_freq"])
    assert np.max(np.abs(got["audio"] - want["audio"])) < 1e-4
    assert (got["active_chan"] == 4).any() and got["ct_detected"].any()


# --------------------------------------------- launch counts, the CPU loop
class FakeRecorder:
    """Stands in for a CUDA graph: a capture runs the function once (as a
    capture records it), a replay runs nothing on the host."""

    def __init__(self):
        self.replays = 0

    def capture(self, fn):
        return fn()

    def replay(self):
        self.replays += 1


def test_capture_counts_nothing_and_each_replay_adds_its_launches():
    saved = fuse.launch_counts()
    assert ("sdr_pmr446_tpu_torch.kernels.duo", "LAUNCHES") in saved
    assert ("sdr_pmr446_tpu_torch.kernels.audio_bank",
            "APPLY_DC_LAUNCHES") in saved

    def step():                      # one step: K1 once, K8 apply_dc twice
        duo.LAUNCHES += 1
        audio_bank.APPLY_DC_LAUNCHES += 2
        return "captured"

    def warmup():                    # runs, delivers nothing: not counted
        for _ in range(3):
            step()

    try:
        duo.LAUNCHES, audio_bank.APPLY_DC_LAUNCHES = 5, 0
        rec = FakeRecorder()
        graph = fuse.CountedGraph(rec)
        assert graph.capture(lambda: [step() for _ in range(4)],
                             warmup) == ["captured"] * 4
        assert (duo.LAUNCHES, audio_bank.APPLY_DC_LAUNCHES) == (5, 0)
        assert graph.delta == {
            ("sdr_pmr446_tpu_torch.kernels.duo", "LAUNCHES"): 4,
            ("sdr_pmr446_tpu_torch.kernels.audio_bank",
             "APPLY_DC_LAUNCHES"): 8}
        for n in range(1, 4):
            graph.replay()
            assert rec.replays == n
            assert (duo.LAUNCHES, audio_bank.APPLY_DC_LAUNCHES) == (
                5 + 4 * n, 8 * n)
        # a capture that fails takes its counts back too
        with pytest.raises(RuntimeError, match="refused"):
            fuse.CountedGraph(rec).capture(
                lambda: (step(), (_ for _ in ()).throw(
                    RuntimeError("refused"))))
        assert duo.LAUNCHES == 17
    finally:
        fuse.set_launch_counts(saved)


def test_a_kernel_module_first_imported_in_the_warm_up_counts_no_warm_up():
    """A kernel module whose first import is in the warm-up (a lazy import
    inside a step, as fused_halo's of kernels/summary.py) counts only the
    replays, like every other."""
    import sys
    import types
    name = "sdr_pmr446_tpu_torch.kernels._lazy_for_test"
    key = (name, "LAUNCHES")

    def step():
        mod = sys.modules.get(name)
        if mod is None:
            mod = sys.modules[name] = types.ModuleType(name)
            mod.LAUNCHES = 0
        mod.LAUNCHES += 1

    try:
        graph = fuse.CountedGraph(FakeRecorder())
        graph.capture(lambda: [step() for _ in range(4)],
                      lambda: [step() for _ in range(4)])
        assert sys.modules[name].LAUNCHES == 0
        assert graph.delta[key] == 4
        graph.replay()
        assert sys.modules[name].LAUNCHES == 4
    finally:
        sys.modules.pop(name, None)


def test_capture_collects_dead_cycles_first_and_none_during(monkeypatch):
    """A dead reference cycle (a chain and its megastep) is collected
    before a capture begins, and the collector does not run inside it: a
    graph freed there resets during the capture and voids it."""
    import contextlib
    import gc
    seen = {}

    @contextlib.contextmanager
    def graph(cuda_graph, stream=None):
        seen["gc inside"] = gc.isenabled()
        yield

    class Dead:
        def __del__(self):
            seen["freed before"] = "gc inside" not in seen

    monkeypatch.setattr(torch.cuda, "graph", graph)
    rec = fuse.CudaGraphRecorder.__new__(fuse.CudaGraphRecorder)
    rec.graph, rec.stream = object(), None
    dead = Dead()
    dead.cycle = dead
    del dead
    assert rec.capture(lambda: 7) == 7
    assert seen == {"freed before": True, "gc inside": False}
    assert gc.isenabled()


class CudaLike:
    """The attributes of a CUDA tensor that a megastep reads first."""
    device = torch.device("cuda", 0)
    shape = (2, 4)
    dtype = torch.uint8

    def dim(self):
        return 2


def test_megastep_loops_only_on_the_cpu(monkeypatch):
    """The loop runs for CPU tensors alone: any other device raises, and a
    CUDA input goes to a captured graph whose failure raises, never to
    the loop."""
    calls = []

    def step(state, x, gain):
        calls.append(x)
        return state + x.sum(), (x * gain)[None]

    mega = fuse.fused_steps(step)
    xs = torch.arange(8.0).reshape(2, 4)
    st, out = mega(torch.zeros(()), xs, torch.tensor(2.0))
    assert len(calls) == 2 and not mega.graphs
    assert float(st) == 28.0 and torch.equal(out, 2 * xs)
    with pytest.raises(ValueError, match="no megastep for device meta"):
        mega(torch.zeros(()), xs.to("meta"), torch.tensor(2.0))

    def refused(*args):
        raise RuntimeError("capture refused")
    monkeypatch.setattr(fuse, "_Captured", refused)
    with pytest.raises(RuntimeError, match="capture refused"):
        mega(torch.zeros(()), CudaLike(), torch.tensor(2.0))
    assert len(calls) == 2 and not mega.graphs
    sharded = fuse.fused_sharded_steps(step)
    _, out = sharded(torch.zeros(()), xs[:, None], torch.tensor(1.0))
    assert out.shape == (1, 2, 4)


class EmulatedGraph:
    """A CUDA graph emulated on the CPU: a capture runs the function and
    keeps its outputs, a replay runs it again and copies the results into
    those same tensors, as a graph rewrites its fixed output buffers."""

    def __init__(self, stream):
        self.graph = self

    @staticmethod
    def _flat(result):
        state, outs = result
        return [t for tree in [state, *outs] for t in leaves(tree)]

    def capture(self, fn):
        self.fn, self.result = fn, fn()
        return self.result

    def replay(self):
        for dst, src in zip(self._flat(self.result), self._flat(self.fn())):
            dst.copy_(src)


class NoStream:
    def wait_stream(self, other):
        pass

    def synchronize(self):
        pass


@pytest.mark.parametrize("chain", ["scanner", "dsd"])
def test_graph_path_static_buffers(chain, monkeypatch):
    """The CUDA path of a megastep (fuse._Captured: the caller's state,
    wires and params copied into static buffers, a replay, fresh copies of
    the new state and outputs) with the graph emulated on the CPU: equal
    to the steps bit for bit, call after call, with state fields that pass
    through the step unwritten (wf_hist and wf_cnt with the waterfall off)
    and states held from earlier calls unchanged."""
    import contextlib
    monkeypatch.setattr(fuse, "CudaGraphRecorder", EmulatedGraph)
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a, **k: NoStream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a, **k: NoStream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    k, s = 2, 2
    if chain == "scanner":
        ch = ScannerChain(TC.BlockConfig(k), input_format="cs16",
                          device="cpu")
        args = (make_runtime_params(TC.ScannerArgs(), "cpu"),)
    else:
        ch = DsdInChain(k, input_format="cs16", device="cpu")
        args = ()
    xs = wires(scanner_iq(3 * s, k, seed=4), "cs16", 3 * s)
    graph = None
    state, held = ch.init_state(), []
    for i in range(3):
        half = xs[i * s:(i + 1) * s]
        st_a, outs = steps(ch, state, half, *args)
        if graph is None:
            graph = fuse._Captured(ch.step, 0, state, half, args)
        st_b, fused = graph(state, half, args)
        assert_tree_equal(fused, fuse._concat(outs, 0), f"outputs {i}")
        assert_tree_equal(st_b, st_a, f"state {i}")
        held.append((st_b, [t.clone() for t in leaves(st_b)]))
        state = st_b
    for st, values in held:
        assert_tree_equal(st, type(st)(*values), "held state")
    if chain == "scanner":
        assert graph.new_state.wf_hist is graph.state[-2]


# ------------------------------------------------------------- on the card
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_scanner_megastep_on_card_equals_steps():
    """The duo at K = 8 and the fused_dc=False engine, S = 2: a replayed
    graph equals the eager steps bit for bit, with no host read, and the
    launch counts count replays."""
    dev = card()
    xs = wires(scanner_iq(4, 8), "cu8", 4).to(dev)
    params = make_runtime_params(TC.ScannerArgs(), dev)
    for kw in ({}, {"fuse_dc": False}):
        chain = ScannerChain(TC.BlockConfig(8), device=dev, **kw)
        check_megastep(chain, chain.init_state(), xs, params)
        chain.multi_step(chain.init_state(), xs[:2], params)
        duo.LAUNCHES = audio_bank.LAUNCHES = 0
        torch.cuda.synchronize(dev)
        torch.cuda.set_sync_debug_mode("error")
        try:
            chain.multi_step(chain.init_state(), xs[:2], params)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert audio_bank.LAUNCHES == 2
        assert duo.LAUNCHES == (0 if kw else 2)


@pytest.mark.cuda
def test_driver_steps_per_dispatch_on_card():
    dev = card()
    k, n_blocks = 8, 5
    raw = decode.quantize_iq(scanner_iq(n_blocks, k), "cu8")
    runs = []
    for s, depth in ((1, 1), (3, 1), (3, 3)):
        drv = ScannerDriver(subchunks_per_step=k, device=dev,
                            steps_per_dispatch=s, prefetch_depth=depth)
        runs.append(drv.run(wire_blocks(raw, "cu8", drv.feed_len)))
    for r in runs[1:]:
        assert r.events == runs[0].events
        for name in ("audio", "active_trace", "rssi_trace", "ct_max_idx"):
            np.testing.assert_array_equal(getattr(r, name),
                                          getattr(runs[0], name))


@pytest.mark.cuda
def test_driver_read_back_on_card_equals_one_step_a_dispatch():
    """S = 2 over 5 megasteps and a tail block, each dispatch's outputs
    read back behind its own event into reused pinned staging buffers:
    the ScanResult equals the S = 1 driver's bit for bit, what on_subchunk
    received in the first drain is unchanged at the end (no view aliases a
    staging buffer), the pinned memory is two buffers, and no more drains
    waited than ran."""
    import copy

    from sdr_pmr446_tpu_torch.utils import profiling
    dev = card()
    k, n_blocks = 8, 11
    raw = decode.quantize_iq(scanner_iq(n_blocks, k, seed=6), "cu8")
    first, copies = [], []

    def keep_first_drain(sub, o):
        if sub < 2 * k:
            first.append(o)
            copies.append(copy.deepcopy(o))

    runs = []
    for s, cb in ((1, None), (2, keep_first_drain)):
        drv = ScannerDriver(subchunks_per_step=k, device=dev,
                            steps_per_dispatch=s, on_subchunk=cb)
        before = profiling.COUNTS["drain.waits_blocked"]
        runs.append(drv.run(wire_blocks(raw, "cu8", drv.feed_len)))
        blocked = profiling.COUNTS["drain.waits_blocked"] - before
    want, got = runs
    assert got.events == want.events and got.events
    for name in ("audio", "audio_subchunks", "active_trace", "rssi_trace",
                 "rel_rssi", "ct_detected", "ct_max_idx"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got.waterfall is None and want.waterfall is None
    assert len(first) == 2 * k
    for o, c in zip(first, copies):
        assert list(o) == list(c)
        for f in c:
            np.testing.assert_array_equal(o[f], c[f], err_msg=f)
    staging = [b for b in drv._read_back.slots if b is not None]
    assert len(staging) == 2 and all(b.is_pinned() for b in staging)
    assert 0 <= blocked <= n_blocks // 2 + 1

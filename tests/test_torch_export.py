"""AOT export of the port (apps/export_chain.py): .pt2 artifact == live chain.

Counterpart of tests/test_export.py.  On the CPU, at K = 2:

  - ``export_chain.main([..., "--device", "cpu"])`` returns 0 for the
    scanner (kernel engine, ``-w 64``, ``--engine op``), dsd and single;
    each loaded artifact, run over two consecutive blocks from the zero
    state, gives outputs and state ``torch.equal`` to the live chain's;
  - exporting a chain before any live step leaves its next live step
    equal to a chain never exported (the per-device table caches once
    kept a fake tensor from the trace), and the shared caches refuse to
    build under ``torch.export``;
  - the port's ``--engine op`` scanner and dsd artifacts against JAX's own
    artifacts (jax.export, use_pallas=False) on the same bytes, the JAX
    state after block 0 carried into the port by runtime/state.py's
    ``*_from_numpy`` for block 1; the kernel-engine artifacts against the
    same JAX artifacts from the zero state.  Gates (ROADMAP): decisions
    and events exact, audio SNR > 40 dB, RSSI within 5e-3 dB (the kernel
    engines' gate, tests/test_torch_chain.py), dsd PCM within 1 LSB;
  - ``torch.library.opcheck`` of the four custom ops (K1-K4) on the CPU,
    and their registrations: CPU and CUDA kernels, no default kernel;
  - one load in a fresh process that imports only the port's export_chain:
    the outputs equal the live chain's, no ``jax`` module is loaded,
    ``torch.export.load`` takes no ``weights_only=False`` fallback and TF32
    is off.

The JAX package is imported inside the fixtures only, so the ``cuda`` test
(bit-equal round trips of K1, K2 and K4 on the card, their launches
counted) runs on a card's host without JAX (``--noconftest``).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from sdr_pmr446_tpu_torch import config as TC
from sdr_pmr446_tpu_torch.apps import export_chain
from sdr_pmr446_tpu_torch.io import synth
from sdr_pmr446_tpu_torch.kernels import audio_bank, chan_tail, duo, waterfall
from sdr_pmr446_tpu_torch.ops import decode, iir
from sdr_pmr446_tpu_torch.runtime import state as tstate
from sdr_pmr446_tpu_torch.scanner import fsm

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 2
N_BLOCKS = 2
SEED = 5
#: argv of each CPU round trip (--out and --device are added)
CASES = {
    "scanner": ["--config", "scanner", "--input-format", "cu8"],
    "scanner_w64": ["--config", "scanner", "--input-format", "cu8", "-w",
                    "64"],
    "scanner_op": ["--config", "scanner", "--input-format", "cu8",
                   "--engine", "op"],
    "dsd": ["--config", "dsd", "--input-format", "cs16"],
    "single": ["--config", "single", "--channel", "5"],
}
#: StepOutputs fields the gates hold exact
DECISIONS = ("audio_valid", "active_chan", "ev_tuned", "ev_detuned",
             "ev_changed", "ev_prev_chan", "ev_new_chan", "ct_detected",
             "ct_max_idx", "ct_freq", "ev_ct_acquired", "ev_ct_changed",
             "ev_ct_lost")


def argv_of(case: str, out: str, device: str = "cpu") -> list:
    return CASES[case] + ["-k", str(K), "--out", out, "--device", device]


def wire_blocks(fmt: str, config: str, n_blocks: int = N_BLOCKS,
                k: int = K) -> list:
    """Seeded numpy capture bytes, one array a block, under receiver
    noise: channel 5 with CTCSS 12 (scanner), a 1 kHz tone in channel 5
    (single), or FM at the tuned centre (dsd: tests/test_dsd_in.py's
    1 kHz tone carrier 300 Hz off it)."""
    n = n_blocks * k * TC.SUBCHUNK_IN
    rng = np.random.default_rng(SEED)
    if config == "dsd":
        t = np.arange(n) / TC.SDR_SAMPLERATE
        msg = 0.5 * np.sin(2 * np.pi * 1000.0 * t)
        iq = 0.9 * np.exp(1j * 2 * np.pi * (2000.0 * np.cumsum(msg)
                                            / TC.SDR_SAMPLERATE + 300.0 * t))
    else:
        iq = synth.make_scanner_iq(n, channel=5, ctcss_code=(
            12 if config == "scanner" else None), seed=SEED)
    iq = iq + 1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    raw = decode.quantize_iq(iq, fmt)
    return list(raw.reshape(n_blocks, -1))


def run(step, args, blocks, device="cpu") -> list:
    """The state and outputs of ``step`` over ``blocks`` from ``args``'s
    state, as flat lists of tensors, one a block."""
    state, rest = args[0], args[2:]
    leaves = []
    for blk in blocks:
        state, out = step(state, torch.as_tensor(blk, device=device), *rest)
        leaves.append(pytree.tree_leaves((state, out)))
    return leaves


def assert_leaves_equal(got, want, what: str) -> None:
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, f"{what} leaf {i}"
        assert torch.equal(g, w), f"{what} leaf {i}"


def exported(case: str, tmp_path, device: str = "cpu"):
    """(the loaded artifact, a freshly built chain of the same argv and its
    example args, the capture blocks)."""
    out = str(tmp_path / f"{case}.pt2")
    assert export_chain.main(argv_of(case, out, device)) == 0
    ns = export_chain.build_parser().parse_args(argv_of(case, out, device))
    chain, args = export_chain.build_chain(ns)
    blocks = wire_blocks(chain.input_format, ns.config)
    return export_chain.load(out), chain, args, blocks, out


@pytest.mark.parametrize("case", list(CASES))
def test_export_round_trip_equals_live(case, tmp_path):
    step, chain, args, blocks, _ = exported(case, tmp_path)
    got = run(step, args, blocks)
    want = run(chain.step, args, blocks)
    for b, (g, w) in enumerate(zip(got, want)):
        assert_leaves_equal(g, w, f"{case} block {b}")
    state, _ = step(args[0], torch.as_tensor(blocks[0]), *args[2:])
    assert type(state) is type(args[0])


@pytest.mark.parametrize("engine", ["kernel", "op"])
def test_export_before_any_live_step(engine):
    """A chain exported before it ever stepped steps as one never
    exported; the trace builds nothing in the shared table caches (which
    the live steps' plain kernels on the CPU then fill)."""
    iir._cached_tables.cache_clear()
    fsm._cached_tables.cache_clear()
    ns = export_chain.build_parser().parse_args(
        CASES["scanner"] + ["-k", str(K), "--out", "x", "--device", "cpu",
                            "--engine", engine])
    chain, args = export_chain.build_chain(ns)
    export_chain.export_step(chain, args)
    for cache in (iir._cached_tables, fsm._cached_tables):
        assert cache.cache_info().currsize == 0
    fresh, _ = export_chain.build_chain(ns)
    blocks = wire_blocks("cu8", "scanner")
    assert_leaves_equal(run(chain.step, args, blocks)[-1],
                        run(fresh.step, args, blocks)[-1], engine)


class _Scan(torch.nn.Module):
    def __init__(self, tables):
        super().__init__()
        self.tables = tables

    def forward(self, z):
        return iir.first_order_scan(z, 0.5, z[..., 0], tables=self.tables)


def test_shared_tables_refuse_export():
    """Under torch.export the shared caches raise; tables built with the
    module export and run as the eager scan."""
    class Scan(torch.nn.Module):
        def forward(self, z):
            return iir.first_order_scan(z, 0.5, z[..., 0])

    class Ctcss(torch.nn.Module):
        def forward(self, x):
            return fsm.ctcss_tables(TC.SUBCHUNK_AUDIO, x.device)[0] * x

    for mod, x in ((Scan(), torch.ones(2, 8)), (Ctcss(), torch.ones(()))):
        with pytest.raises(RuntimeError, match="exported step"):
            torch.export.export(mod, (x,), strict=False)
    tables = iir.ScanTables(0.5, "cpu")
    z = torch.ones(2, 300)
    torch.testing.assert_close(
        torch.export.export(_Scan(tables), (z,), strict=False).module()(z),
        iir.first_order_scan(z, 0.5, z[..., 0], tables=tables), rtol=0,
        atol=0)


# ---------------------------------------------------------------- JAX
def jax_artifact(tmp_dir, argv):
    """JAX's export_chain.main artifact, deserialized."""
    import jax
    from sdr_pmr446_tpu.apps import export_chain as jexport
    out = os.path.join(tmp_dir, "jax.jaxexport")
    assert jexport.main(argv + ["--out", out]) == 0
    with open(out, "rb") as f:
        return jax.export.deserialize(f.read())


def jax_wire(blk: np.ndarray, fmt: str):
    """The JAX step's input for the port's bytes of one block: complex64
    for cf32, else the bytes packed as f32 words."""
    import jax.numpy as jnp
    return jnp.asarray(blk.view(np.complex64 if fmt == "cf32"
                                else np.float32))


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """JAX's scanner (cu8) and dsd (cs16) artifacts at K = 2 over the two
    blocks from the zero state: {config: (outputs of each block as numpy
    dicts or pcm, numpy state after block 0)}."""
    import jax.numpy as jnp
    from sdr_pmr446_tpu import config as JC
    from sdr_pmr446_tpu.scanner.chain import ScannerChain as JChain
    from sdr_pmr446_tpu.scanner.chain import make_runtime_params as jparams
    from sdr_pmr446_tpu.scanner.dsd_in import DsdInChain as JDsd
    tmp = str(tmp_path_factory.mktemp("jax_export"))
    runs = {}
    exp = jax_artifact(tmp, ["--config", "scanner", "-k", str(K),
                             "--input-format", "cu8"])
    st = JChain(JC.BlockConfig(K), input_format="cu8").init_state()
    params = jparams(JC.ScannerArgs())
    outs, states = [], []
    for blk in wire_blocks("cu8", "scanner"):
        st, o = exp.call(st, jax_wire(blk, "cu8"), params)
        outs.append({f: np.asarray(v) for f, v in zip(o._fields, o)})
        states.append([np.asarray(v) for v in st])
    runs["scanner"] = (outs, states[0])
    exp = jax_artifact(tmp, ["--config", "dsd", "-k", str(K),
                             "--input-format", "cs16"])
    st = JDsd(K, input_format="cs16").init_state()
    outs, states = [], []
    for blk in wire_blocks("cs16", "dsd"):
        st, o = exp.call(st, jax_wire(blk, "cs16"))
        outs.append(np.asarray(o.pcm))
        states.append([np.asarray(v) for v in st])
    runs["dsd"] = (outs, states[0])
    del jnp
    return runs


def snr_db(ref: np.ndarray, got: np.ndarray) -> float:
    ref = ref.astype(np.float64)
    err = np.sum((got.astype(np.float64) - ref) ** 2)
    return float(10 * np.log10(np.sum(ref ** 2) / max(err, 1e-300)))


def check_scanner(got, want: dict, what: str) -> None:
    got = {f: np.asarray(v) for f, v in zip(got._fields, got)}
    for name in DECISIONS:
        np.testing.assert_array_equal(got[name], want[name],
                                      err_msg=f"{what} {name}")
    np.testing.assert_allclose(got["rssi_db"], want["rssi_db"], rtol=0,
                               atol=5e-3, err_msg=f"{what} rssi_db")
    np.testing.assert_allclose(got["rel_rssi"], want["rel_rssi"], rtol=0,
                               atol=5e-3, err_msg=f"{what} rel_rssi")
    if np.any(want["audio"]):
        assert snr_db(want["audio"], got["audio"]) > 40.0, what


def check_pcm(got, want: np.ndarray, what: str) -> None:
    got = np.asarray(got).astype(np.int32)
    assert np.max(np.abs(got - want.astype(np.int32))) <= 1, what
    assert snr_db(want, got) > 40.0, what


@pytest.mark.parametrize("engine", ["op", "kernel"])
def test_scanner_artifact_matches_jax_artifact(engine, jax_runs, tmp_path):
    outs, jstate0 = jax_runs["scanner"]
    argv = CASES["scanner"] + ["--engine", engine]
    out = str(tmp_path / "s.pt2")
    assert export_chain.main(argv + ["-k", str(K), "--out", out,
                                     "--device", "cpu"]) == 0
    step = export_chain.load(out)
    ns = export_chain.build_parser().parse_args(argv + ["--out", out,
                                                        "-k", str(K),
                                                        "--device", "cpu"])
    _, (state, _, params) = export_chain.build_chain(ns)
    blocks = wire_blocks("cu8", "scanner")
    assert any(o["ev_tuned"].any() for o in outs)
    for b, blk in enumerate(blocks):
        if engine == "op" and b == 1:
            # block 1 from JAX's state after block 0
            state = tstate.state_from_numpy(jstate0, "cpu")
        state, o = step(state, torch.from_numpy(blk), params)
        check_scanner(o, outs[b], f"{engine} block {b}")


@pytest.mark.parametrize("engine", ["op", "kernel"])
def test_dsd_artifact_matches_jax_artifact(engine, jax_runs, tmp_path):
    outs, jstate0 = jax_runs["dsd"]
    argv = ["--config", "dsd", "--input-format", "cs16", "--engine", engine,
            "-k", str(K), "--device", "cpu"]
    out = str(tmp_path / "d.pt2")
    assert export_chain.main(argv + ["--out", out]) == 0
    step = export_chain.load(out)
    _, (state, _) = export_chain.build_chain(
        export_chain.build_parser().parse_args(argv + ["--out", out]))
    for b, blk in enumerate(wire_blocks("cs16", "dsd")):
        if engine == "op" and b == 1:
            state = tstate.dsd_state_from_numpy(jstate0, "cpu", "op")
        state, pcm = step(state, torch.from_numpy(blk))
        check_pcm(pcm, outs[b], f"{engine} block {b}")


# ---------------------------------------------------------- the ops
def op_inputs(dev="cpu"):
    """Inputs of each custom op at K = 1 from a seeded random state: {op:
    (op, args)}."""
    rng = np.random.default_rng(SEED)

    def c64(*shape):
        return torch.from_numpy(np.asarray(
            rng.standard_normal(shape) + 1j * rng.standard_normal(shape),
            np.complex64)).to(dev)

    def f32(*shape):
        return torch.from_numpy(np.asarray(rng.standard_normal(shape),
                                           np.float32)).to(dev)

    wire = torch.from_numpy(wire_blocks("cu8", "scanner", 1, 1)[0]).to(dev)
    d = duo.ScannerDuo("cu8", device=dev)
    duo_args = (wire, c64(), c64(), c64(d.front_hist_len), c64(400),
                torch.tensor(1, dtype=torch.int32, device=dev), c64(16),
                d.front.kt, d.front.pj, d.pfb.pfb_g, d.pfb.pfb_c,
                d.pfb.pfb_w, "cu8", TC.SUBCHUNK_AUDIO)
    bank = audio_bank.AudioBank(device=dev)
    f = TC.SUBCHUNK_AUDIO
    bank_args = (f32(16, bank.hist), f32(16), f32(16), f32(16, f),
                 torch.tensor(2.0, device=dev),
                 torch.tensor([700], dtype=torch.int32, device=dev),
                 torch.tensor([4], dtype=torch.int32, device=dev),
                 bank.taps_staged, bank.taps_audio, bank.taps_lp, bank.pj,
                 bank.f10, TC.SUBCHUNK_AUDIO)
    wf = waterfall.Waterfall(64, device=dev)
    band = f32(2, TC.SUBCHUNK_RESAMP)
    wf_args = (band, c64(400), torch.tensor(3, dtype=torch.int32,
                                            device=dev),
               wf.pre, wf.filt, wf.tw, 64, wf.plan.m, wf.plan.m1,
               wf.plan.nt)
    mono = chan_tail.MonoChain("single", "cu8", channel=5, audio_gain=2.0,
                               device=dev)
    t = mono.tail
    mono_args = (wire, c64(), c64(), c64(mono.front.hist_len),
                 c64(t.hb * chan_tail.GL), c64(), f32(t.dh * chan_tail.DPS),
                 torch.tensor(7, dtype=torch.int32, device=dev),
                 mono.front.kt, mono.front.pj, t.kd_staged, t.tab,
                 t.post_staged, "cu8", "single", 5, 2.0)
    dsd = chan_tail.MonoChain("dsd", "cu8", device=dev)
    dsd_args = (wire, c64(), c64(), c64(dsd.front.hist_len),
                c64(dsd.tail.hb * chan_tail.GL), c64(),
                f32(dsd.tail.dh * chan_tail.DPS), None, dsd.front.kt,
                dsd.front.pj, dsd.tail.kd_staged, None,
                dsd.tail.post_staged, "cu8", "dsd", 0, 1.0)
    return {"duo": (duo.duo_op, duo_args),
            "audio_bank": (audio_bank.audio_bank_op, bank_args),
            "waterfall": (waterfall.waterfall_op, wf_args),
            "mono_single": (chan_tail.mono_op, mono_args),
            "mono_dsd": (chan_tail.mono_op, dsd_args)}


@pytest.mark.parametrize("name", ["duo", "audio_bank", "waterfall",
                                  "mono_single", "mono_dsd"])
def test_custom_op_opcheck(name):
    op, args = op_inputs()[name]
    torch.library.opcheck(op, args, test_utils=(
        "test_schema", "test_autograd_registration", "test_faketensor"))


@pytest.mark.parametrize("op", ["duo", "audio_bank", "waterfall", "mono"])
def test_custom_op_registrations(op):
    """A CPU kernel (the plain version), a CUDA kernel (the launch) and no
    kernel that another device, or the card, would fall back to."""
    name = f"sdr_pmr446::{op}"
    has = torch._C._dispatch_has_kernel_for_dispatch_key
    assert has(name, "CPU") and has(name, "CUDA")
    for key in ("CompositeExplicitAutograd", "CompositeImplicitAutograd",
                "XPU"):
        assert not has(name, key), key


FRESH = r"""
import json, logging, sys
import torch
records = []

class Keep(logging.Handler):
    def emit(self, record):
        records.append(str(record.msg))

logging.getLogger("torch._export.serde.serialize").addHandler(Keep())
from sdr_pmr446_tpu_torch.apps import export_chain
path, inputs, outputs = sys.argv[1:4]
step = export_chain.load(path)
state, wire, params = torch.load(inputs)
state, out = step(export_chain.ScannerState(*state), wire,
                  export_chain.RuntimeParams(*params))
torch.save([t for t in (*state, *out)], outputs)
print(json.dumps({
    "fallback": [r for r in records if "weights_only" in r],
    "jax": sorted(m for m in sys.modules
                  if m == "jax" or m.startswith(("jax.", "sdr_pmr446_tpu."))),
    "tf32": [torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32]}))
"""


def test_load_in_a_fresh_process(tmp_path):
    step, chain, args, blocks, out = exported("scanner", tmp_path)
    state, wire, params = args[0], torch.from_numpy(blocks[0]), args[2]
    inputs, outputs = str(tmp_path / "in.pt"), str(tmp_path / "out.pt")
    # plain lists: the fresh process rebuilds the NamedTuples
    torch.save((list(state), wire, list(params)), inputs)
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", FRESH, out, inputs, outputs],
                         capture_output=True, text=True, timeout=300,
                         env=env, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr[-3000:]
    report = json.loads(res.stdout.strip().splitlines()[-1])
    assert report == {"fallback": [], "jax": [], "tf32": [False, False]}, \
        report
    want = pytree.tree_leaves(chain.step(state, wire, params))
    assert_leaves_equal(torch.load(outputs), want, "fresh process")


# ---------------------------------------------------------- on the card
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["scanner", "dsd", "single"])
def test_round_trip_on_card(case, tmp_path):
    """K1 and K2 (scanner), K4 (dsd, single): the artifact exported on the
    card equals the live chain bit for bit over two blocks, and runs one
    kernel launch a step."""
    dev = card()
    step, chain, args, blocks, _ = exported(case, tmp_path, str(dev))
    want = run(chain.step, args, blocks, dev)
    mods = (duo, audio_bank) if case == "scanner" else (chan_tail,)
    for mod in mods:
        mod.LAUNCHES = 0
    got = run(step, args, blocks, dev)
    torch.cuda.synchronize(dev)
    for mod in mods:
        assert mod.LAUNCHES == len(blocks), mod.__name__
    for b, (g, w) in enumerate(zip(got, want)):
        assert_leaves_equal(g, w, f"{case} block {b}")

"""K12: the precision probe (K12b) and the layout probes (K12a) on the CPU.

  - each plain mode's reading on the probe input (A = 1 + 2^-12, B = 1) is
    exactly 256.0625 (ffma), 256.0 (tf32) and 256.0625 (3xtf32);
  - the JAX tool's ``_probe_one("xla", ...)`` reading at default and
    HIGHEST precision on the CPU (tools/probe_precision.py loaded by path,
    its stdout captured; the Pallas path needs a TPU) equals the plain
    ffma value exactly;
  - on seeded random inputs: ffma within 1e-6 of float64, 3xtf32 within
    1e-5, tf32 equal to the float64 product of TF32-rounded inputs to f32
    rounding (1e-6), each relative to the output's peak; ``tf32_round``
    bit-equal to an independent float64 rounding (11 significant bits, ties
    away from zero);
  - each layout move's plain version bit-equal to the jnp expression the
    JAX tool's kernel body applies (the bodies are closures in its main(),
    so each expression is restated here);
  - the two tools on the CPU print their lines and exit 0, and exit 1
    without a CUDA device by default;
  - ``cuda``: every kernel mode and move against its plain version.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from sdr_pmr446_tpu_torch.kernels import probe_layout as K12a
from sdr_pmr446_tpu_torch.kernels import probe_precision as K12b
from sdr_pmr446_tpu_torch.tools import probe_layout as layout_tool
from sdr_pmr446_tpu_torch.tools import probe_precision as precision_tool

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WANT = {"ffma": K12b.EXACT, "tf32": K12b.ROUNDED, "3xtf32": K12b.EXACT}
#: error of each mode against float64, relative to the output's peak
TOL_F64 = {"ffma": 1e-6, "3xtf32": 1e-5}
TOL_KERNEL = 1e-5          # kernel vs plain on the card: f32 sums in
#                            another order (and tensor-core accumulation)


def random_ab(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((128, 256)).astype(np.float32),
            rng.standard_normal((256, 128)).astype(np.float32))


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def tf32_ref(x: np.ndarray) -> np.ndarray:
    """Round to 11 significant bits, ties away from zero, in float64."""
    m, e = np.frexp(x.astype(np.float64))          # |m| in [0.5, 1)
    r = np.sign(m) * np.floor(np.abs(m) * 2.0 ** 11 + 0.5)
    return np.ldexp(r, e - 11)


@pytest.mark.parametrize("mode", K12b.MODES)
def test_plain_probe_readings_are_exact(mode):
    a, b = K12b.probe_inputs("cpu")
    out = K12b.probe_dot(a, b, mode)
    assert out.shape == (128, 128)
    assert torch.all(out == WANT[mode])
    assert K12b.verdict(float(out[0, 0])) == K12b.EXPECTED[mode]


def test_jax_xla_probe_equals_plain_ffma(capsys, monkeypatch):
    import jax
    spec = importlib.util.spec_from_file_location(
        "jax_probe_precision", os.path.join(ROOT, "tools",
                                            "probe_precision.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    update = jax.config.update
    # the tool points JAX's compilation cache at a directory outside the
    # checkout; keep the test from writing there
    monkeypatch.setattr(jax.config, "update", lambda name, value: None
                        if name == "jax_compilation_cache_dir"
                        else update(name, value))
    a, b = K12b.probe_inputs("cpu")
    ffma = float(K12b.probe_dot(a, b, "ffma")[0, 0])
    for prec in ("highest", "default"):
        tool._probe_one("xla", prec)
        line = capsys.readouterr().out.strip().splitlines()[-1]
        value = float(line.split(":")[1].split("->")[0])
        assert value == ffma == K12b.EXACT, line
        assert line.endswith("f32-contract"), line


@pytest.mark.parametrize("mode", K12b.MODES)
def test_plain_modes_on_random_inputs(mode):
    a, b = random_ab()
    out = K12b.probe_dot(torch.from_numpy(a), torch.from_numpy(b),
                         mode).numpy()
    if mode == "tf32":
        want = tf32_ref(a) @ tf32_ref(b)
        assert rel_err(out, want) < 1e-6
        assert rel_err(out, a.astype(np.float64) @ b) > 1e-5  # one pass
    else:
        assert rel_err(out, a.astype(np.float64) @ b) < TOL_F64[mode]


def test_tf32_round_matches_float64_rounding():
    rng = np.random.default_rng(1)
    edges = np.float32([1.0 + 2.0 ** -12, -(1.0 + 2.0 ** -11),
                        1.0 + 3 * 2.0 ** -12, 2.0 ** -12, 0.0])
    x = np.concatenate([rng.standard_normal(4096).astype(np.float32), edges])
    got = K12b.tf32_round(torch.from_numpy(x)).numpy()
    want = tf32_ref(x).astype(np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(got[-5:], [1.0, -(1.0 + 2.0 ** -10),
                                             1.0 + 2.0 ** -10, 2.0 ** -12, 0])
    special = torch.tensor([float("inf"), -float("inf"), float("nan")])
    out = K12b.tf32_round(special)
    assert torch.equal(out[:2], special[:2]) and torch.isnan(out[2])


def jax_layout_exprs():
    """The JAX tool's kernel bodies (tools/probe_layout.py:65-108) as jnp
    expressions on the input value."""
    def store16(x):
        s = x.at[:, 16:32].set(x[:, 0:16])
        return s[:, 0:128]
    return {
        "scratch_store_off16": store16,
        "scratch_read_off16": lambda x: x[:, 16:144],
        "scratch_read_narrow": lambda x: x[:, 16:32],
        "value_lane_off16": lambda x: x[:, 16:144],
        "value_stride_sub": lambda x: x[0::16, :],
        "reshape_rows_wide": lambda x: x.reshape(8, 2048),
        "reshape_25_16": lambda x: x.reshape(200, 16),
        "transpose_16": lambda x: x.T,
    }


def test_layout_plain_moves_equal_jax_bodies():
    import jax.numpy as jnp
    rng = np.random.default_rng(3)
    exprs = jax_layout_exprs()
    assert list(exprs) == list(K12a.MOVES)
    for move, (shape_in, shape_out) in K12a.MOVES.items():
        x = rng.standard_normal(shape_in).astype(np.float32)
        got = K12a.probe_move(torch.from_numpy(x), move).numpy()
        want = np.asarray(exprs[move](jnp.asarray(x)))
        assert got.shape == shape_out == want.shape, move
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32), err_msg=move)


def test_tools_on_cpu(capsys):
    assert precision_tool.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 7
    assert lines[0].startswith("kernel  ffma    : 256.0625  -> f32-contract")
    assert lines[1].startswith("kernel  tf32    : 256.0  -> tf32-contract")
    assert all(ln.endswith("(not gated)") for ln in lines[5:])
    assert layout_tool.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines == [f"{m}: PASS" for m in K12a.MOVES]
    if not torch.cuda.is_available():
        assert precision_tool.main([]) == 1
        assert layout_tool.main([]) == 1


def test_wrappers_reject_bad_inputs():
    a, b = K12b.probe_inputs("cpu")
    with pytest.raises(ValueError, match="mode"):
        K12b.probe_dot(a, b, "bf16")
    with pytest.raises(ValueError, match="contract"):
        K12b.probe_dot(a, a, "ffma")
    # the kernel's tiles and its 16-byte staging, refused before any launch
    for mode, (m, n, k) in (("tf32", (100, 128, 256)),
                            ("3xtf32", (128, 120, 256)),
                            ("ffma", (8, 128, 256)),
                            ("ffma", (128, 128, 1024)),
                            ("tf32", (128, 128, 72))):
        with pytest.raises(ValueError, match=f"mode {mode}: needs"):
            K12b.probe_dot_kernel(torch.zeros(m, k), torch.zeros(k, n), mode)
    flat = torch.zeros(128 * 256 + 1)
    with pytest.raises(ValueError, match="16-byte aligned"):
        K12b.probe_dot_kernel(flat[1:].view(128, 256), b, "tf32")
    with pytest.raises(ValueError, match="transpose_16"):
        K12a.probe_move(torch.zeros(16, 128), "transpose_16")
    with pytest.raises(ValueError, match="unknown move"):
        K12a.probe_move(torch.zeros(8, 256), "gather")


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda", 0)
    a, b = (torch.from_numpy(v).to(dev) for v in random_ab(7))
    for mode in K12b.MODES:
        got = K12b.probe_dot_kernel(a, b, mode)
        want = K12b.probe_dot_plain(a, b, mode)
        torch.cuda.synchronize(dev)
        assert rel_err(got.cpu().numpy(), want.cpu().double().numpy()) \
            < TOL_KERNEL, mode
        pa, pb = K12b.probe_inputs(dev)
        assert torch.all(K12b.probe_dot_kernel(pa, pb, mode) == WANT[mode])
    for move, passed, reason in layout_tool.run(dev, seed=5):
        assert passed, (move, reason)

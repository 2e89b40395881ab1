"""K8: the port's audio bank without its CTCSS epilogue vs the JAX kernel.

``AudioBank.apply`` and ``apply_dc`` take their plain versions for CPU
tensors; these are held, over two calls that carry the state (F = 1225,
then 2450: not whole 128-lane rows), to JAX ``PallasAudioBank.apply`` /
``apply_dc`` in interpret mode and to ``reference_impl`` (the op chain), at
the gates of tests/test_kernels.py:147-230: history exact, audio within
1e-4, lp within 1e-5, lp_dcb and the DC carries within 2e-4.  Both flag
cases: (lowpass, fir_deemph) = (False, False) with the 512-sample history,
(True, True) with the 640-sample one.  The CUDA kernels are held to these
plain versions on the card by tests/test_torch_kernels.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from sdr_pmr446_tpu import config as C
from sdr_pmr446_tpu_torch.kernels import audio_bank

torch.set_num_threads(2)

CASES = [(False, False), (True, True)]
SIZES = (C.SUBCHUNK_AUDIO, 2 * C.SUBCHUNK_AUDIO)


@pytest.fixture(scope="module")
def jax_k8():
    """Per flag case: the inputs and the outputs of JAX apply, apply_dc and
    reference_impl over the two calls, each carrying its own state."""
    import jax.numpy as jnp
    from sdr_pmr446_tpu.kernels.audio_bank import (PallasAudioBank,
                                                   reference_impl)
    runs = {}
    for lowpass, fir_deemph in CASES:
        rng = np.random.default_rng(21 + lowpass)
        jb = PallasAudioBank(lowpass=lowpass, fir_deemph=fir_deemph, tile_r=8,
                             interpret=True)
        hist = (0.1 * rng.standard_normal((16, jb.hist))).astype(np.float32)
        dcx = (0.01 * rng.standard_normal(16)).astype(np.float32)
        dcy = (0.01 * rng.standard_normal(16)).astype(np.float32)
        demods = [(0.5 * rng.standard_normal((16, f))).astype(np.float32)
                  for f in SIZES]
        gain = jnp.float32(4.0)
        run = dict(hist=hist, dcx=dcx, dcy=dcy, demods=demods, apply=[],
                   apply_dc=[], ref=[])
        ha, hr, dc = jnp.asarray(hist), jnp.asarray(hist), (
            jnp.asarray(hist), jnp.asarray(dcx), jnp.asarray(dcy))
        for d in demods:
            o = jb.apply(ha, jnp.asarray(d), gain)
            run["apply"].append([np.asarray(v) for v in o])
            ha = o[0]
            o = reference_impl(hr, jnp.asarray(d), gain, lowpass=lowpass,
                               fir_deemph=fir_deemph)
            run["ref"].append([np.asarray(v) for v in o])
            hr = o[0]
            o = jb.apply_dc(*dc, jnp.asarray(d), gain)
            run["apply_dc"].append([np.asarray(v) for v in o])
            dc = o[:3]
        runs[(lowpass, fir_deemph)] = run
    return runs


def bank_for(case):
    bank = audio_bank.AudioBank(*case, device="cpu")
    assert bank.hist == (640 if case == (True, True) else 512)
    return bank


GAIN = torch.tensor(4.0)


@pytest.mark.parametrize("case", CASES)
def test_apply_matches_jax(jax_k8, case):
    run = jax_k8[case]
    bank = bank_for(case)
    hist = torch.from_numpy(run["hist"])
    launches = audio_bank.APPLY_LAUNCHES
    for i, d in enumerate(run["demods"]):
        o = bank.apply(hist, torch.from_numpy(d), GAIN)
        assert isinstance(o, audio_bank.BankOut)
        for want in (run["apply"][i], run["ref"][i]):
            np.testing.assert_array_equal(o.hist.numpy(), want[0])
            np.testing.assert_allclose(o.audio.numpy(), want[1], rtol=0,
                                       atol=1e-4)
            np.testing.assert_allclose(o.lp.numpy(), want[2], rtol=0,
                                       atol=1e-5)
        hist = o.hist
    assert audio_bank.APPLY_LAUNCHES == launches


@pytest.mark.parametrize("case", CASES)
def test_apply_dc_matches_jax(jax_k8, case):
    run = jax_k8[case]
    bank = bank_for(case)
    st = [torch.from_numpy(run[k]) for k in ("hist", "dcx", "dcy")]
    launches = audio_bank.APPLY_DC_LAUNCHES
    for i, d in enumerate(run["demods"]):
        o = bank.apply_dc(*st, torch.from_numpy(d), GAIN)
        want = run["apply_dc"][i]
        np.testing.assert_array_equal(o.hist.numpy(), want[0])
        np.testing.assert_allclose(o.audio.numpy(), want[3], rtol=0,
                                   atol=1e-4)
        for got, ref in ((o.dc_x, want[1]), (o.dc_y, want[2]),
                         (o.lp_dcb, want[4])):
            np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-4)
        st = list(o[:3])
    assert audio_bank.APPLY_DC_LAUNCHES == launches


def test_k2_and_k8_share_the_plain_version():
    """K2's plain version is K8 apply_dc's plus the tone sums: its history,
    carries and audio are K8's exactly, and apply_dc's audio is apply's."""
    rng = np.random.default_rng(4)
    k, ns = 2, C.SUBCHUNK_AUDIO
    bank = audio_bank.AudioBank(device="cpu")
    f32 = lambda a: torch.from_numpy(a.astype(np.float32))
    hist = f32(0.1 * rng.standard_normal((16, bank.hist)))
    dcx, dcy = f32(0.01 * rng.standard_normal(16)), f32(
        0.01 * rng.standard_normal(16))
    demod = f32(0.3 * rng.standard_normal((16, k * ns)))
    b = torch.tensor([ns - 1, 2000], dtype=torch.int32)
    sel = torch.tensor([3, 9], dtype=torch.int32)
    k2 = bank(hist, dcx, dcy, demod, GAIN, b, sel, ns)
    k8 = bank.apply_dc(hist, dcx, dcy, demod, GAIN)
    for a, b_ in ((k2.hist, k8.hist), (k2.dc_x, k8.dc_x), (k2.dc_y, k8.dc_y),
                  (k2.audio, k8.audio),
                  (bank.apply(hist, demod, GAIN).audio, k8.audio)):
        assert torch.equal(a, b_)


def test_k8_rejects_bad_inputs():
    bank = audio_bank.AudioBank(device="cpu")
    hist = torch.zeros(16, bank.hist)
    with pytest.raises(ValueError, match=r"demod must be \[16, F\]"):
        bank.apply(hist, torch.zeros(15, 100), GAIN)
    with pytest.raises(ValueError, match="no audio bank"):
        bank.apply_dc(hist, torch.zeros(16), torch.zeros(16),
                      torch.zeros(16, 100, device="meta"), GAIN)

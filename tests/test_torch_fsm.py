"""The port's squelch FSM + CTCSS detector vs the JAX phases A and C.

RSSI traces with tune, a stronger second channel (changes under
lock_mode=max, ignored under start), detune and re-tune, plus tone sums
that acquire, change and lose a CTCSS code; two calls carry the state.
Decisions and events must be exact.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sdr_pmr446_tpu import config as C
from sdr_pmr446_tpu.scanner import fsm as jfsm
from sdr_pmr446_tpu_torch.scanner import fsm as tfsm

torch.set_num_threads(2)

NS = C.SUBCHUNK_AUDIO
K = 24


def rssi_trace(rng, call):
    """[K, 16] dB: noise, ch 5 up (tune), ch 9 stronger, silence (detune),
    ch 2 up; the second call shifts the pattern."""
    r = 10.0 + 0.5 * rng.standard_normal((K, 16))
    plan = [(range(4, 18), 4, 40.0), (range(12, 16), 8, 50.0),
            (range(20, 24), 1, 35.0)]
    if call == 1:
        plan = [(range(0, 6), 1, 36.0), (range(6, 10), 1, 20.0),
                (range(14, 24), 15, 45.0)]
    for ks, ch, level in plan:
        for k in ks:
            r[k, ch] = level + 0.2 * rng.standard_normal()
    return r.astype(np.float32)


def tone_sums(rng, call):
    """raw_pre/raw_mem [K, 38] c64: a dominant tone that changes index and
    then vanishes, over a noise floor."""
    noise = lambda: 5.0 * (rng.standard_normal((K, 38))
                           + 1j * rng.standard_normal((K, 38)))
    pre, mem = noise(), noise()
    for k in range(K):
        tone = 11 if k < 12 else (4 if k < 18 else None)
        if call == 1:
            tone = 20 if 8 <= k < 18 else None
        if tone is not None:
            pre[k, tone] += 150.0 * np.exp(0.3j * k)
            mem[k, tone] += 300.0 * np.exp(0.3j * k)
    return pre.astype(np.complex64), mem.astype(np.complex64)


@pytest.mark.parametrize("lock_mode", ["start", "max"])
def test_fsm_phases_match_jax(lock_mode):
    rng = np.random.default_rng(3 if lock_mode == "start" else 4)
    mask = np.ones(16, bool)
    mask[13] = False
    squelch, lock_max = np.float32(18.0), lock_mode == "max"
    jcarry = jfsm.FsmCarry(jnp.int32(0), jnp.int32(-1), jnp.float32(0.0),
                           jnp.int32(0), jnp.zeros(38, jnp.complex64),
                           jnp.bool_(False), jnp.int32(0), jnp.float32(-1.0))
    tcarry = tfsm.FsmCarry(*(torch.from_numpy(np.array(v)) for v in jcarry))
    tmask = torch.from_numpy(mask)
    events = {}
    for call in range(2):
        rssi = rssi_trace(rng, call)
        raw_pre, raw_mem = tone_sums(rng, call)
        js = jfsm.fsm_phase_a(jcarry, jnp.asarray(rssi), jnp.asarray(mask),
                              jnp.float32(squelch), jnp.bool_(lock_max), NS)
        ts = tfsm.fsm_phase_a(tcarry, torch.from_numpy(rssi), tmask,
                              torch.tensor(squelch), torch.tensor(lock_max),
                              NS)
        for name, a, b in zip(js._fields, js, ts):
            if name == "rel":       # dB; f32 sums over 15 channels
                np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                           rtol=0, atol=1e-5)
            else:
                np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                              err_msg=name)
        jsp, jss = jfsm.raw_sums_to_ctcss(js, jnp.asarray(raw_pre),
                                          jnp.asarray(raw_mem), NS)
        tsp, tss = tfsm.raw_sums_to_ctcss(ts, torch.from_numpy(raw_pre),
                                          torch.from_numpy(raw_mem), NS)
        np.testing.assert_allclose(tsp.numpy(), np.asarray(jsp), rtol=1e-6,
                                   atol=1e-4)
        np.testing.assert_allclose(tss.numpy(), np.asarray(jss), rtol=1e-6,
                                   atol=1e-4)
        # phase C on identical tone sums: decisions exact
        jcarry, jo = jfsm.fsm_phase_c(jcarry, js, jsp, jss)
        tcarry, to = tfsm.fsm_phase_c(tcarry, ts, torch.from_numpy(
            np.array(jsp)), torch.from_numpy(np.array(jss)))
        for name, a, b in zip(jo._fields, jo, to):
            if name == "rel_rssi":
                np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                           rtol=0, atol=1e-5)
            else:
                np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                              err_msg=name)
        for name, a, b in zip(jcarry._fields, jcarry, tcarry):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                       atol=1e-5, err_msg=name)
        for name in ("ev_tuned", "ev_detuned", "ev_changed",
                     "ev_ct_acquired", "ev_ct_changed", "ev_ct_lost"):
            events[name] = events.get(name, 0) + int(getattr(to, name).sum())
    # the traces exercise every transition
    assert events["ev_tuned"] >= 3 and events["ev_detuned"] >= 2
    assert events["ev_ct_acquired"] >= 1 and events["ev_ct_lost"] >= 1
    assert events["ev_ct_changed"] >= 1
    assert (events["ev_changed"] > 0) == (lock_mode == "max")

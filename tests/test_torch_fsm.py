"""The port's squelch FSM + CTCSS detector vs the JAX package.

Phases A and C: RSSI traces with tune, a stronger second channel (changes
under lock_mode=max, ignored under start), detune and re-tune, plus tone
sums that acquire, change and lose a CTCSS code; two calls carry the state.
Decisions and events must be exact.

The CTCSS scans of the op-path switches (v1, v2, v3) are held to JAX's v1,
v2 and v3 on the randomized busy traces of tests/test_fsm_unit.py:173-213
(decisions and events exact, the tone carry within 1e-5 of its peak), to
each other, and v3's channel-major ``lp_cm`` form to its ``lp`` form; the
building blocks (``ctcss_tables``, ``ctcss_subchunk_sums``,
``ctcss_detect``) to JAX's.
"""

import numpy as np
import jax
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


# ---------------------------------------------- the FSM's CTCSS scans (v1-v3)
#: the JAX scans, jitted once (one K for every trial: one compile each)
JAX_SCANS = {"v1": jax.jit(jfsm.fsm_ctcss_scan),
             "v2": jax.jit(jfsm.fsm_ctcss_scan_v2),
             "v3": jax.jit(jfsm.fsm_ctcss_scan_v3)}


def _jax_carry0():
    return jfsm.FsmCarry(jnp.int32(0), jnp.int32(-1), jnp.float32(0.0),
                         jnp.int32(0), jnp.zeros(38, jnp.complex64),
                         jnp.bool_(False), jnp.int32(0), jnp.float32(-1.0))


def scan_inputs(rng, k, trial, blk, mask):
    """The busy scenario of tests/test_fsm_unit.py:173-213: a CTCSS tone on
    one channel over noise, random detune windows and a stronger channel
    appearing mid-block."""
    t = (blk * k * NS + np.arange(k * NS)) / C.AUDIO_SAMPLERATE
    tone = C.CTCSS_FREQS[(trial * 7 + blk) % 38]
    lp = 0.01 * rng.standard_normal((k, 16, NS)).astype(np.float32)
    ch = (trial + blk) % 16
    if not mask[ch]:
        ch = (ch + 1) % 16
    lp[:, ch, :] += (0.3 * np.sin(2 * np.pi * tone * t)).reshape(
        k, NS).astype(np.float32)
    rssi = np.full((k, 16), -80.0, np.float32)
    rssi[:, ch] = -10.0
    for _ in range(2):
        a = rng.integers(0, k)
        rssi[a:min(k, a + int(rng.integers(1, 5))), ch] = -80.0
    rssi[rng.integers(0, k):, (ch + 3) % 16] = -5.0
    return rssi, lp


def assert_scans_equal(port, ref, what, float_atol=1e-5):
    """Port (carry, outputs) vs JAX's: decisions and events exact, floats
    within 1e-5 (dB, Hz), the complex tone carry within 1e-5 of its peak."""
    (pc, po), (jc, jo) = port, ref
    for name, a, b in zip(jo._fields + jc._fields, tuple(jo) + tuple(jc),
                          tuple(po) + tuple(pc)):
        a, b = np.asarray(a), b.numpy()
        if a.dtype.kind == "c":
            assert np.max(np.abs(b - a)) <= 1e-5 * max(np.max(np.abs(a)),
                                                        1.0), f"{what} {name}"
        elif a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=0, atol=float_atol,
                                       err_msg=f"{what} {name}")
        else:
            np.testing.assert_array_equal(b, a, err_msg=f"{what} {name}")


@pytest.mark.parametrize("trial", [0, 1])
def test_ctcss_scans_match_jax(trial):
    """The port's v1, v2 and v3 against JAX's v1, v2 and v3 over three
    streamed blocks (lock_max off and on, a masked channel); the port's
    three make the same decisions, and v3 on the channel-major lp_cm form
    equals v3 on lp."""
    rng = np.random.default_rng(17 + trial)
    k, lock = 9, trial == 1
    mask = np.ones(16, bool)
    mask[5] = trial == 0
    scans = {v: (JAX_SCANS[v], getattr(tfsm, name))
             for v, name in (("v1", "fsm_ctcss_scan"),
                             ("v2", "fsm_ctcss_scan_v2"),
                             ("v3", "fsm_ctcss_scan_v3"))}
    jc = {v: _jax_carry0() for v in scans}
    tc = {v: tfsm.FsmCarry(*(torch.from_numpy(np.array(x))
                             for x in _jax_carry0())) for v in scans}
    acquired = detuned = 0
    for blk in range(3):
        rssi, lp = scan_inputs(rng, k, trial, blk, mask)
        jargs = (jnp.asarray(rssi), jnp.asarray(lp), jnp.asarray(mask),
                 jnp.float32(18.0), jnp.asarray(lock))
        targs = (torch.from_numpy(rssi), torch.from_numpy(lp),
                 torch.from_numpy(mask), torch.tensor(np.float32(18.0)),
                 torch.tensor(lock))
        # v3 on the channel-major form, from the same carry: identical
        lp_cm = torch.from_numpy(np.ascontiguousarray(lp.transpose(1, 0, 2)))
        cm_carry, cm_out = tfsm.fsm_ctcss_scan_v3(
            tc["v3"], targs[0], None, *targs[2:], lp_cm=lp_cm)
        outs = {}
        for v, (jscan, tscan) in scans.items():
            ref = jscan(jc[v], *jargs)
            got = tscan(tc[v], *targs)
            assert_scans_equal(got, ref, f"trial {trial} blk {blk} {v}")
            jc[v], tc[v] = ref[0], got[0]
            outs[v] = got[1]
        for a, b in zip(tuple(cm_carry) + tuple(cm_out),
                        tuple(tc["v3"]) + tuple(outs["v3"])):
            assert torch.equal(a, b)
        for v in ("v2", "v3"):
            for name in ("active_chan", "ct_detected", "ct_max_idx",
                         "ev_ct_acquired", "ev_ct_changed", "ev_ct_lost",
                         "ev_tuned", "ev_detuned", "ev_changed"):
                assert torch.equal(getattr(outs[v], name),
                                   getattr(outs["v1"], name)), (v, name)
        acquired += int(outs["v1"].ev_ct_acquired.sum())
        detuned += int(outs["v1"].ev_detuned.sum())
    assert acquired >= 1 and detuned >= 1


def test_ctcss_building_blocks_match_jax():
    """ctcss_tables, ctcss_subchunk_sums (a window boundary inside the
    sub-chunk, and none) and ctcss_detect (a tone, and noise) against
    JAX's."""
    jt = jfsm.ctcss_tables(NS)
    tt = tfsm.ctcss_tables(NS)
    for a, b in zip(jt, tt):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        assert b.numpy().dtype == np.asarray(a).dtype
    rng = np.random.default_rng(8)
    x = (0.3 * np.sin(2 * np.pi * C.CTCSS_FREQS[9] * np.arange(NS)
                      / C.AUDIO_SAMPLERATE)
         + 0.01 * rng.standard_normal(NS)).astype(np.float32)
    for cnt in (0, 1500, C.CTCSS_BLOCK_SIZE - 1):
        js = jfsm.ctcss_subchunk_sums(jnp.asarray(x), jnp.int32(cnt), jt)
        ts = tfsm.ctcss_subchunk_sums(torch.from_numpy(x),
                                      torch.tensor(cnt, dtype=torch.int32), tt)
        for a, b in zip(js[:2], ts[:2]):
            a = np.asarray(a)
            assert np.max(np.abs(b.numpy() - a)) <= 1e-5 * np.max(np.abs(a))
        assert bool(ts[2]) == bool(js[2])
        power = np.abs(np.asarray(js[0])) ** 2
        for p in (power, rng.random(38).astype(np.float32)):
            jd = jfsm.ctcss_detect(jnp.asarray(p))
            td = tfsm.ctcss_detect(torch.from_numpy(p))
            assert (bool(td[0]), int(td[1])) == (bool(jd[0]), int(jd[1]))

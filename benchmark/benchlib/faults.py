"""Faults planted in the program's timed path, to show that the comparison
catches them: ``broken_step`` wraps the block step of the program's
scanner chain (the megastep, built from the step with the chain, runs the
broken one), and ``plant`` puts it in place in a process (each rank's, on
several cards).  Used by the tests and by ``calibrate.py --plant``."""

from __future__ import annotations

#: the FSM's carry in the chain's state (scanner/chain.py's FsmCarry)
FSM_FIELDS = ("fsm_state", "active_chan", "rssi", "ct_count", "ct_carry",
              "ct_detected", "ct_max_idx", "ct_freq")


def state_kept(chain, state_in, new_state, out):
    """A step that returns its state unchanged."""
    return state_in, out


def fsm_carry_reset(chain, state_in, new_state, out):
    """A step that hands on its filters' state but resets the FSM's carry
    (squelch state, active channel, the CTCSS detector's count, carry and
    detection) to the initial state's, as a fused FSM that dropped it
    would."""
    init = chain.__dict__.get("_fault_init")
    if init is None:
        # made on the first, eager call: a CUDA graph's capture may not
        # copy from the host
        init = chain.__dict__["_fault_init"] = chain.init_state()
    return new_state._replace(**{f: getattr(init, f).clone()
                                 for f in FSM_FIELDS}), out


def answer_altered(chain, state_in, new_state, out):
    """One sub-chunk's active channel moved to the next channel."""
    chan = out.active_chan.clone()
    i = chan.shape[-1] // 2
    chan[..., i] = (chan[..., i] + 1) % 16
    return new_state, out._replace(active_chan=chan)


FAULTS = {f.__name__: f for f in (state_kept, fsm_carry_reset,
                                  answer_altered)}


def broken_step(step, name: str):
    """``step(self, state, wire, params)`` with the fault ``name``."""
    fault = FAULTS[name]

    def broken(self, state, wire, params):
        new_state, out = step(self, state, wire, params)
        return fault(self, state, new_state, out)
    return broken


def plant(name: str):
    """The program's scanner chain's step broken by the fault ``name`` in
    this process; returns what puts the sound step back."""
    from sdr_pmr446_tpu_torch.scanner.chain import ScannerChain
    step = ScannerChain.step
    ScannerChain.step = broken_step(step, name)

    def undo():
        ScannerChain.step = step
    return undo

"""The time-sharded dsd_in chain on a one-card (stream x time) mesh (PyTorch).

Counterpart of sdr_pmr446_tpu/parallel/dsd_sharded.py on its MONO engine
(``use_pallas=True``, K_local % 8 == 0): each shard runs K4
(kernels/chan_tail.py::MonoChain, mode "dsd") with its exact incoming
state.  The pre-pass of the sharded duo scanner (K10 and the fold of
parallel/fused_halo.py) recovers each shard's incoming DC state and a
corrected DC tail of ``TAIL`` samples, and every other halo — the front
history, the band rows, the discriminator's previous sample and the demod
history — is rebuilt from that tail through the plain resamplers, so the
kernel needs no correction.

``ShardedDsdInChain(mesh, K).step(state, wire uint8 [S, step_arg_len]) ->
(state', pcm int16 [S, T * 3 / 64])``, the state DsdState with every field
[S, ...] (the JAX sharded mono state's layout).  A geometry without the
mono engine (K_local % 8 != 0), whose JAX counterpart is the op engine,
raises (ROADMAP queue 1: the JAX op engines).  ``multi_step(state, wires
uint8 [S_steps, S, step_arg_len])`` runs S_steps blocks in one dispatch
(runtime/fuse.py), the pcm [S, S_steps * T * 3 / 64], equal to the steps
bit for bit.
"""

from __future__ import annotations

import torch

from sdr_pmr446_tpu_torch import config as C
from sdr_pmr446_tpu_torch import device as devices
from sdr_pmr446_tpu_torch import precision
from sdr_pmr446_tpu_torch.kernels.chan_tail import MonoChain
from sdr_pmr446_tpu_torch.ops import decode, fm
from sdr_pmr446_tpu_torch.parallel import fused_halo as FH
from sdr_pmr446_tpu_torch.parallel.scanner_sharded import (Mesh, mesh_device,
                                                           stacked,
                                                           time_shards)
from sdr_pmr446_tpu_torch.runtime import fuse
from sdr_pmr446_tpu_torch.runtime.state import stack_state
from sdr_pmr446_tpu_torch.scanner.dsd_in import DsdState


def mono_geometry(subchunks_per_step: int, mesh: Mesh) -> int:
    """K_local, or a ValueError where the sharded mono engine cannot run."""
    if subchunks_per_step % mesh.n_time:
        raise ValueError(f"subchunks_per_step={subchunks_per_step} must "
                         f"divide evenly over the {mesh.n_time}-way time mesh")
    k_local = subchunks_per_step // mesh.n_time
    if k_local % 8:
        raise ValueError(
            f"the sharded mono engine needs subchunks_per_step / n_time % 8 "
            f"== 0 (got K_local={k_local}); the JAX op engine that serves "
            f"the rest is not ported (ROADMAP queue 1: the JAX op "
            f"engines)")
    return k_local


class ShardedDsdInChain:
    """dsd_in over S streams on a one-card (S, D) mesh, mono engine."""

    #: DC tail: the 384-sample front history and the 6,656 input samples
    #: that rebuild the band, signal and demod halos (1,300 band samples)
    TAIL = 7040
    #: band samples after which the decimator's last 51 outputs start
    SIG_SPAN = 816

    def __init__(self, mesh: Mesh, subchunks_per_step: int = 16,
                 input_format: str = "cu8", device=devices.DEFAULT):
        precision.check()
        self.mesh = mesh
        self.device = mesh_device(mesh, device)
        self.k_local = mono_geometry(subchunks_per_step, mesh)
        self.input_format = decode.wire_format(input_format)
        self.input_len = subchunks_per_step * C.SUBCHUNK_IN
        self.t_local = self.input_len // mesh.n_time
        self.output_len = self.input_len * 3 // 64
        self.mono = MonoChain("dsd", self.input_format, device=self.device)
        self.megastep = fuse.fused_sharded_steps(self.step)

    @property
    def step_arg_len(self) -> int:
        """Wire bytes per stream and step."""
        return self.input_len * decode.BYTES_PER_SAMPLE[self.input_format]

    def init_state(self) -> DsdState:
        return stack_state(DsdState(*self.mono.init_state(self.device)),
                           self.mesh.n_stream)

    def multi_step(self, state: DsdState, wires: torch.Tensor):
        """S_steps blocks of every stream in one dispatch (module
        docstring)."""
        return self.megastep(state, wires)

    def step(self, state: DsdState, wire: torch.Tensor):
        wire3 = time_shards(wire, self.mesh, self.step_arg_len)
        x_in, y_in, dcx_carry, dcy_carry, dc_tail = FH.exact_dc_state(
            wire3, self.input_format, self.t_local, self.TAIL, state.dc_x,
            state.dc_y)
        # every halo rebuilt from the corrected tail, before the kernel
        tail = self.mono.tail
        fh_in, fh_carry = FH.shard_pass_right(
            state.front_hist, dc_tail[..., -self.mono.front.hist_len:])
        band = FH.resample_tail(self.mono.front.resampler, dc_tail,
                                FH.REBUILD_START)           # [S, D, 1300]
        bh_in, bh_carry = FH.shard_pass_right(
            state.band_hist, band[..., -state.band_hist.shape[-1]:])
        sig = FH.resample_tail(tail.decim, band,
                               band.shape[-1] - self.SIG_SPAN)   # [.., 51]
        sp_in, sp_carry = FH.shard_pass_right(state.sig_prev, sig[..., -1])
        _, dem = fm.fm_demod(sig[..., 0], sig[..., 1:])     # [S, D, 50]
        dh_in, dh_carry = FH.shard_pass_right(state.demod_hist, dem)
        outs = [[self.mono(wire3[s, d], x_in[s, d], y_in[s, d], fh_in[s, d],
                           bh_in[s, d], sp_in[s, d], dh_in[s, d])
                 for d in range(self.mesh.n_time)]
                for s in range(self.mesh.n_stream)]
        # clipped in the kernel; the int16 cast truncates toward zero, as
        # the JAX chain's astype(jnp.int16) does
        pcm = stacked(outs, "out").reshape(self.mesh.n_stream, -1)
        new = DsdState(dcx_carry, dcy_carry, fh_carry, bh_carry, sp_carry,
                       dh_carry)
        return (DsdState(*(v.contiguous() for v in new)),
                pcm.to(torch.int16))

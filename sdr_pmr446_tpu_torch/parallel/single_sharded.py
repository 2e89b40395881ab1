"""The time-sharded single-channel monitor on a one-card mesh (PyTorch).

Counterpart of sdr_pmr446_tpu/parallel/single_sharded.py on its MONO
engine (``use_pallas=True``, K_local % 8 == 0): each shard runs K4
(kernels/chan_tail.py::MonoChain, mode "single") with its exact incoming
state, from the pre-pass of the sharded duo scanner (K10 and the fold of
parallel/fused_halo.py).  The band history is rebuilt in raw (unmixed)
band space, the space K4 carries; the discriminator and demod halos need
the MIXED tail, e^{-j w (global band index)} applied by the mixer's
32-entry table.

The port's K4 takes the mixer phase as ``n0`` (the block's first band
index mod 32) where JAX's takes a rotation, so each shard gets its own
n0 = (n0 + d * t_band_local) mod 32; at K_local % 8 == 0 every shard's
equals the stream's, as JAX's shared ``rot`` assumes.

``ShardedSingleChain(mesh, channel, K).step(state, wire uint8 [S,
step_arg_len]) -> (state', audio f32 [S, T * 25 / 2048])``, the state
SingleState with every field [S, ...].  K_local % 8 != 0 raises (ROADMAP
queue 1: the JAX op engines).  ``multi_step(state, wires uint8 [S_steps,
S, step_arg_len])`` runs S_steps blocks in one dispatch (runtime/fuse.py),
the audio [S, S_steps * T * 25 / 2048], equal to the steps bit for bit.
"""

from __future__ import annotations

import torch

from sdr_pmr446_tpu_torch import config as C
from sdr_pmr446_tpu_torch import device as devices
from sdr_pmr446_tpu_torch import precision
from sdr_pmr446_tpu_torch.kernels.chan_tail import (DPS, GL, PHASE_PERIOD,
                                                    MonoChain)
from sdr_pmr446_tpu_torch.ops import decode, fm
from sdr_pmr446_tpu_torch.parallel import fused_halo as FH
from sdr_pmr446_tpu_torch.parallel.dsd_sharded import mono_geometry
from sdr_pmr446_tpu_torch.parallel.scanner_sharded import (Mesh, mesh_device,
                                                           stacked,
                                                           time_shards)
from sdr_pmr446_tpu_torch.runtime import fuse
from sdr_pmr446_tpu_torch.runtime.state import stack_state
from sdr_pmr446_tpu_torch.scanner.single import SingleState


class ShardedSingleChain:
    """The single-channel monitor over S streams on a one-card (S, D) mesh,
    mono engine."""

    #: DC tail: the 384-sample front history and the input span that yields
    #: the decimator's history + (17 * 25 + 1) * 16 = 7,653 band samples of
    #: the signal and demod halos (39,296 * 25 / 128 = 7,675 >= 7,653)
    TAIL = 384 + 39296

    def __init__(self, mesh: Mesh, channel: int,
                 subchunks_per_step: int = 16,
                 audio_gain: float = C.SDR_DEFAULT_AUDIO_GAIN,
                 input_format: str = "cu8", device=devices.DEFAULT):
        precision.check()
        if not 1 <= channel <= C.NUM_CHANNELS:
            raise ValueError(f"channel must be 1..{C.NUM_CHANNELS}")
        self.mesh = mesh
        self.device = mesh_device(mesh, device)
        self.k_local = mono_geometry(subchunks_per_step, mesh)
        self.channel = channel
        self.input_format = decode.wire_format(input_format)
        self.input_len = subchunks_per_step * C.SUBCHUNK_IN
        self.t_local = self.input_len // mesh.n_time
        self.t_band_local = self.t_local * C.RESAMP_L // C.RESAMP_M
        self.output_len = self.input_len * 25 // 2048
        self.mono = MonoChain("single", self.input_format, channel=channel,
                              audio_gain=audio_gain, device=self.device)
        self.megastep = fuse.fused_sharded_steps(self.step)

    @property
    def step_arg_len(self) -> int:
        """Wire bytes per stream and step."""
        return self.input_len * decode.BYTES_PER_SAMPLE[self.input_format]

    def init_state(self) -> SingleState:
        st = SingleState(*self.mono.init_state(self.device),
                         torch.zeros((), dtype=torch.int32,
                                     device=self.device))
        return stack_state(st, self.mesh.n_stream)

    def multi_step(self, state: SingleState, wires: torch.Tensor):
        """S_steps blocks of every stream in one dispatch (module
        docstring)."""
        return self.megastep(state, wires)

    def step(self, state: SingleState, wire: torch.Tensor):
        n_s, n_t = self.mesh.n_stream, self.mesh.n_time
        wire3 = time_shards(wire, self.mesh, self.step_arg_len)
        x_in, y_in, dcx_carry, dcy_carry, dc_tail = FH.exact_dc_state(
            wire3, self.input_format, self.t_local, self.TAIL, state.dc_x,
            state.dc_y)
        tail = self.mono.tail
        fh_in, fh_carry = FH.shard_pass_right(
            state.front_hist, dc_tail[..., -self.mono.front.hist_len:])
        band = FH.resample_tail(self.mono.front.resampler, dc_tail,
                                FH.REBUILD_START)           # [S, D, 7675]
        bh_in, bh_carry = FH.shard_pass_right(state.band_hist,
                                              band[..., -tail.hb * GL:])

        # each shard's mixer phase, and the mixed tail: band sample j of
        # the last b_need of shard d has global index n0_(d+1) - b_need + j
        t_band = self.t_band_local
        d = torch.arange(n_t, dtype=torch.int32, device=self.device)
        n0_d = ((state.n0[:, None] + d * t_band) % PHASE_PERIOD
                ).to(torch.int32)                           # [S, D]
        chf = tail.decim
        b_need = chf.hist_len + (tail.dh * DPS + 1) * chf.M     # 7653
        j = torch.arange(b_need, dtype=torch.int32, device=self.device)
        idx = (n0_d[..., None] + t_band - b_need + j) % PHASE_PERIOD
        mixed = band[..., -b_need:] * tail.tab[idx.long()]
        sig = FH.resample_tail(chf, mixed, chf.hist_len)    # [S, D, 426]
        sp_in, sp_carry = FH.shard_pass_right(state.sig_prev, sig[..., -1])
        _, dem = fm.fm_demod(sig[..., 0], sig[..., 1:])     # [S, D, 425]
        dh_in, dh_carry = FH.shard_pass_right(state.demod_hist, dem)

        outs = [[self.mono(wire3[s, d], x_in[s, d], y_in[s, d], fh_in[s, d],
                           bh_in[s, d], sp_in[s, d], dh_in[s, d],
                           n0=n0_d[s, d])
                 for d in range(n_t)] for s in range(n_s)]
        audio = stacked(outs, "out").reshape(n_s, -1)
        n0 = ((state.n0 + n_t * t_band) % PHASE_PERIOD).to(torch.int32)
        new = SingleState(dcx_carry, dcy_carry, fh_carry, bh_carry, sp_carry,
                          dh_carry, n0)
        return SingleState(*(v.contiguous() for v in new)), audio

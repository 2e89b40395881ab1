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

``engine="op"`` is JAX's op engine (``use_pallas=False``, JAX
single_sharded.py:163-192) at every K_local, on the cf32 wire only (JAX
single_sharded.py:86-91): the DC blocker over shards, the plain resampler
and channel filter each with its ``shard_hist`` halo, the mixer's table at
each shard's own phase (n0 + d * t_band_local) mod 32, the discriminator
with ``shard_scalar_prev``, the HP and de-emphasis FIRs with their halos,
carrying SingleOpState.  The kernel engine refuses K_local % 8 != 0
(dsd_sharded.mono_geometry).

``ShardedSingleChain(mesh, channel, K).step(state, wire uint8 [S,
step_arg_len]) -> (state', audio f32 [S, T * 25 / 2048])``, the state
SingleState (SingleOpState on the op engine) with every field [S, ...].
``multi_step(state, wires uint8 [S_steps, S, step_arg_len])`` runs S_steps
blocks in one dispatch (runtime/fuse.py), the audio [S, S_steps * T * 25 /
2048], equal to the steps bit for bit.  On a rank's block of a mesh over
several processes (parallel/distributed.py::global_mesh) the wire, the
audio and the state are the rank's, each shard's mixer phase from its
global time index, the halos passed over its time group.
"""

from __future__ import annotations

import torch

from sdr_pmr446_tpu_torch import config as C
from sdr_pmr446_tpu_torch import device as devices
from sdr_pmr446_tpu_torch import engine as engines
from sdr_pmr446_tpu_torch import precision
from sdr_pmr446_tpu_torch.kernels.chan_tail import (DPS, GL, PHASE_PERIOD,
                                                    MonoChain)
from sdr_pmr446_tpu_torch.ops import decode, fir, fm
from sdr_pmr446_tpu_torch.ops.resample import complex_of, planes
from sdr_pmr446_tpu_torch.parallel import fused_halo as FH
from sdr_pmr446_tpu_torch.parallel import halo
from sdr_pmr446_tpu_torch.parallel.dsd_sharded import mono_geometry
from sdr_pmr446_tpu_torch.parallel.scanner_sharded import (Mesh, mesh_device,
                                                           stacked,
                                                           time_shards)
from sdr_pmr446_tpu_torch.runtime import fuse
from sdr_pmr446_tpu_torch.runtime.state import stack_state
from sdr_pmr446_tpu_torch.scanner.op_front import shard_planes
from sdr_pmr446_tpu_torch.scanner.single import (SingleChannelChain,
                                                 SingleState)


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
                 input_format: str = "cu8", device=devices.DEFAULT,
                 engine: str = engines.KERNEL):
        precision.check()
        if not 1 <= channel <= C.NUM_CHANNELS:
            raise ValueError(f"channel must be 1..{C.NUM_CHANNELS}")
        self.mesh = mesh
        self.device = mesh_device(mesh, device)
        self.engine = engines.resolve(engine)
        self.op = self.engine == engines.OP
        self.k_local = mono_geometry(subchunks_per_step, mesh, self.engine)
        self.tg = halo.TimeGroup.of(mesh)
        self.channel = channel
        self.input_format = decode.wire_format(input_format)
        self.input_len = subchunks_per_step * C.SUBCHUNK_IN
        self.t_local = self.k_local * C.SUBCHUNK_IN
        self.t_band_local = self.t_local * C.RESAMP_L // C.RESAMP_M
        self.output_len = self.input_len * 25 // 2048
        if self.op:
            # the unsharded op chain's filters, table and zero state (it
            # refuses any wire but cf32)
            self.chain = SingleChannelChain(
                channel, subchunks_per_step, audio_gain, self.input_format,
                device=self.device, engine=self.engine)
        else:
            self.mono = MonoChain("single", self.input_format,
                                  channel=channel, audio_gain=audio_gain,
                                  device=self.device)
        self.megastep = fuse.fused_sharded_steps(self.step, self.tg.size)

    @property
    def step_arg_len(self) -> int:
        """Wire bytes per stream and step (of the rank's time shards)."""
        return (self.t_local * self.mesh.n_time
                * decode.BYTES_PER_SAMPLE[self.input_format])

    def init_state(self):
        if self.op:
            return stack_state(self.chain.init_state(), self.mesh.n_stream)
        st = SingleState(*self.mono.init_state(self.device),
                         torch.zeros((), dtype=torch.int32,
                                     device=self.device))
        return stack_state(st, self.mesh.n_stream)

    def multi_step(self, state: SingleState, wires: torch.Tensor):
        """S_steps blocks of every stream in one dispatch (module
        docstring)."""
        return self.megastep(state, wires)

    def step(self, state, wire: torch.Tensor):
        n_s, n_t, tg = self.mesh.n_stream, self.mesh.n_time, self.tg
        wire3 = time_shards(wire, self.mesh, self.step_arg_len)
        if self.op:
            return self._op_step(state, wire3)
        x_in, y_in, dcx_carry, dcy_carry, dc_tail = FH.exact_dc_state(
            wire3, self.input_format, self.t_local, self.TAIL, state.dc_x,
            state.dc_y, tg)
        tail = self.mono.tail
        band = FH.resample_tail(self.mono.front.resampler, dc_tail,
                                FH.REBUILD_START)           # [S, D, 7675]

        # each shard's mixer phase, and the mixed tail: band sample j of
        # the last b_need of shard d has global index n0_(d+1) - b_need + j
        t_band = self.t_band_local
        d = tg.shard_index(n_t, self.device)
        n0_d = ((state.n0[:, None] + d * t_band) % PHASE_PERIOD
                ).to(torch.int32)                           # [S, D]
        chf = tail.decim
        b_need = chf.hist_len + (tail.dh * DPS + 1) * chf.M     # 7653
        j = torch.arange(b_need, dtype=torch.int32, device=self.device)
        idx = (n0_d[..., None] + t_band - b_need + j) % PHASE_PERIOD
        mixed = band[..., -b_need:] * tail.tab[idx.long()]
        sig = FH.resample_tail(chf, mixed, chf.hist_len)    # [S, D, 426]
        _, dem = fm.fm_demod(sig[..., 0], sig[..., 1:])     # [S, D, 425]
        # the four halos (one collective over a time group)
        ((fh_in, fh_carry), (bh_in, bh_carry), (sp_in, sp_carry),
         (dh_in, dh_carry)) = tg.pass_right(
            (state.front_hist, dc_tail[..., -self.mono.front.hist_len:]),
            (state.band_hist, band[..., -tail.hb * GL:]),
            (state.sig_prev, sig[..., -1]), (state.demod_hist, dem))

        outs = [[self.mono(wire3[s, d], x_in[s, d], y_in[s, d], fh_in[s, d],
                           bh_in[s, d], sp_in[s, d], dh_in[s, d],
                           n0=n0_d[s, d])
                 for d in range(n_t)] for s in range(n_s)]
        audio = stacked(outs, "out").reshape(n_s, -1)
        n0 = ((state.n0 + tg.total(n_t) * t_band) % PHASE_PERIOD).to(
            torch.int32)
        new = SingleState(dcx_carry, dcy_carry, fh_carry, bh_carry, sp_carry,
                          dh_carry, n0)
        return SingleState(*(v.contiguous() for v in new)), audio

    def _op_step(self, st, wire3):
        """The op engine over the shards (JAX single_sharded.py:163-192)."""
        n_s, n_t, tg = self.mesh.n_stream, self.mesh.n_time, self.tg
        ops = self.chain.ops
        dx, dy, c1, band = ops.resample_shards(
            st.dc_x, st.dc_y, st.res_hist,
            shard_planes(wire3, self.input_format), tg)     # [S, D, 2, Tb]
        # each shard's mixer phase: its first band sample's global index
        d = tg.shard_index(n_t, self.device)
        n0_d = st.n0[:, None] + d * self.t_band_local       # [S, D]
        mixed = ops.mix(complex_of(band), n0_d)
        h2, c2 = halo.shard_hist(st.ch_hist, mixed, ops.chf.hist_len, tg=tg)
        _, sig = ops.chf(planes(h2), planes(mixed))
        sig = complex_of(sig)
        fm_prev, fm_carry = halo.shard_scalar_prev(st.fm_prev, sig, tg)
        _, audio = fm.fm_demod(fm_prev, sig)
        h3, c3 = halo.shard_hist(st.hp_hist, audio, ops.hp_taps.shape[0] - 1,
                                 tg=tg)
        _, audio = fir.fir_apply(h3, audio, ops.hp_taps)
        audio = audio * self.chain.audio_gain
        h4, c4 = halo.shard_hist(st.deemph_hist, audio,
                                 ops.deemph_taps.shape[0] - 1, tg=tg)
        _, audio = fir.fir_apply(h4, audio, ops.deemph_taps)
        n0 = ((st.n0 + tg.total(n_t) * self.t_band_local) % PHASE_PERIOD
              ).to(torch.int32)
        new = type(st)(dx, dy, c1, c2, fm_carry, c3, c4, n0)
        return (type(st)(*(v.contiguous() for v in new)),
                audio.reshape(n_s, -1))

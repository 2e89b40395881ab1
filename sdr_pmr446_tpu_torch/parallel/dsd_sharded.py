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

``engine="op"`` is JAX's op engine (``use_pallas=False``, JAX
dsd_sharded.py:182-200) at every K_local: the wire decoded to planes, the
DC blocker over shards (``halo.shard_dc_blocker``), the three plain
resamplers each with its ``shard_hist`` halo and the discriminator with
``shard_scalar_prev``, carrying DsdOpState.  The kernel engine refuses a
K_local % 8 != 0 (``mono_geometry``); nothing falls back to the op engine
quietly, as JAX's does (JAX dsd_sharded.py:62).

``ShardedDsdInChain(mesh, K).step(state, wire uint8 [S, step_arg_len]) ->
(state', pcm int16 [S, T * 3 / 64])``, the state DsdState (DsdOpState on
the op engine) with every field [S, ...] (the JAX sharded state's
layout).  ``multi_step(state, wires uint8 [S_steps, S, step_arg_len])``
runs S_steps blocks in one dispatch (runtime/fuse.py), the pcm [S, S_steps
* T * 3 / 64], equal to the steps bit for bit.
"""

from __future__ import annotations

import torch

from sdr_pmr446_tpu_torch import config as C
from sdr_pmr446_tpu_torch import device as devices
from sdr_pmr446_tpu_torch import engine as engines
from sdr_pmr446_tpu_torch import precision
from sdr_pmr446_tpu_torch.kernels.chan_tail import MonoChain
from sdr_pmr446_tpu_torch.ops import decode, fm
from sdr_pmr446_tpu_torch.ops.resample import complex_of, planes
from sdr_pmr446_tpu_torch.parallel import fused_halo as FH
from sdr_pmr446_tpu_torch.parallel import halo
from sdr_pmr446_tpu_torch.parallel.scanner_sharded import (Mesh, mesh_device,
                                                           stacked,
                                                           time_shards)
from sdr_pmr446_tpu_torch.runtime import fuse
from sdr_pmr446_tpu_torch.runtime.state import stack_state
from sdr_pmr446_tpu_torch.scanner.op_front import shard_planes
from sdr_pmr446_tpu_torch.scanner.dsd_in import (DsdInChain, DsdState,
                                                 to_pcm)


def mono_geometry(subchunks_per_step: int, mesh: Mesh,
                  engine: str = engines.KERNEL) -> int:
    """K_local, or a ValueError where the ``engine`` cannot run: the
    sharded mono (kernel) engine needs K_local % 8 == 0, the op engine
    serves every K_local."""
    if subchunks_per_step % mesh.n_time:
        raise ValueError(f"subchunks_per_step={subchunks_per_step} must "
                         f"divide evenly over the {mesh.n_time}-way time mesh")
    k_local = subchunks_per_step // mesh.n_time
    if k_local % 8 and engines.resolve(engine) == engines.KERNEL:
        raise ValueError(
            f"the sharded mono engine needs subchunks_per_step / n_time % 8 "
            f"== 0 (got K_local={k_local}); engine=\"op\" (--engine op) "
            f"serves every K_local")
    return k_local


class ShardedDsdInChain:
    """dsd_in over S streams on a one-card (S, D) mesh, mono engine."""

    #: DC tail: the 384-sample front history and the 6,656 input samples
    #: that rebuild the band, signal and demod halos (1,300 band samples)
    TAIL = 7040
    #: band samples after which the decimator's last 51 outputs start
    SIG_SPAN = 816

    def __init__(self, mesh: Mesh, subchunks_per_step: int = 16,
                 input_format: str = "cu8", device=devices.DEFAULT,
                 engine: str = engines.KERNEL):
        precision.check()
        self.mesh = mesh
        self.device = mesh_device(mesh, device)
        self.engine = engines.resolve(engine)
        self.op = self.engine == engines.OP
        self.k_local = mono_geometry(subchunks_per_step, mesh, self.engine)
        self.input_format = decode.wire_format(input_format)
        self.input_len = subchunks_per_step * C.SUBCHUNK_IN
        self.t_local = self.input_len // mesh.n_time
        self.output_len = self.input_len * 3 // 64
        if self.op:
            # the unsharded op chain's resamplers and zero state
            self.chain = DsdInChain(subchunks_per_step, self.input_format,
                                    device=self.device, engine=self.engine)
        else:
            self.mono = MonoChain("dsd", self.input_format,
                                  device=self.device)
        self.megastep = fuse.fused_sharded_steps(self.step)

    @property
    def step_arg_len(self) -> int:
        """Wire bytes per stream and step."""
        return self.input_len * decode.BYTES_PER_SAMPLE[self.input_format]

    def init_state(self):
        if self.op:
            return stack_state(self.chain.init_state(), self.mesh.n_stream)
        return stack_state(DsdState(*self.mono.init_state(self.device)),
                           self.mesh.n_stream)

    def multi_step(self, state: DsdState, wires: torch.Tensor):
        """S_steps blocks of every stream in one dispatch (module
        docstring)."""
        return self.megastep(state, wires)

    def step(self, state, wire: torch.Tensor):
        wire3 = time_shards(wire, self.mesh, self.step_arg_len)
        if self.op:
            return self._op_step(state, wire3)
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

    def _op_step(self, st, wire3):
        """The op engine over the shards (JAX dsd_sharded.py:182-200)."""
        n_s, n_t = self.mesh.n_stream, self.mesh.n_time
        ops = self.chain.ops
        dx, dy, c1, band = ops.resample_shards(
            st.dc_x, st.dc_y, st.res1_hist,
            shard_planes(wire3, self.input_format))         # [S, D, 2, nb]
        h2, c2 = halo.shard_hist_planes(st.res2_hist, band,
                                        ops.res2.hist_len)
        _, sig = ops.res2(planes(h2), band)
        sig = complex_of(sig)                               # [S, D, Ts]
        fm_prev, fm_carry = halo.shard_scalar_prev(st.fm_prev, sig)
        _, audio = fm.fm_demod(fm_prev, sig)
        h3, c3 = halo.shard_hist(st.up_hist, audio, ops.up.hist_len)
        _, out48 = ops.up(h3, audio)
        new = type(st)(dx, dy, c1, c2, fm_carry, c3)
        return (type(st)(*(v.contiguous() for v in new)),
                to_pcm(out48).reshape(n_s, -1))

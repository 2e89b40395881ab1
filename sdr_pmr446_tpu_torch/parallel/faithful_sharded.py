"""The time-sharded faithful-mode scanner on a one-card mesh (PyTorch).

Counterpart of sdr_pmr446_tpu/parallel/faithful_sharded.py
(``ShardedFaithfulChain``).  Faithful mode's audio path is gated and
strictly sequential per sub-chunk (scanner/faithful.py), so the sharding
splits at the rate boundary, as in JAX: the front end runs time-sharded
with its halos (parallel/halo.py), in this order:

  1. the IQ DC blocker as a composed shard recurrence
     (``halo.shard_dc_blocker``);
  2. the 25/128 resampler with the 345-sample input history of its left
     neighbour (``halo.shard_hist_planes``);
  3. the PFB with the 400-sample band history of its left neighbour and
     each shard's incoming frame parity, once over every [S, D] row

(scanner/op_front.py's ``OpFrontEnd.shards``, which the op scanner runs
too), then each stream's channel sub-chunks and [K, 16] RSSI are gathered (the
tensor itself on one card) and ``faithful_scan``, the unsharded chain's
function, runs once a stream over all K sub-chunks.  Like the JAX module
and the unsharded faithful chain, it runs no kernel: the same plain ops
run on the card.

``ShardedFaithfulChain(mesh, K).step(state, iq c64 [S, K * SUBCHUNK_IN],
params) -> (state', FaithfulOutputs [S, K, ...])``, every state field [S,
...] (runtime/state.py::stack_state of FaithfulState), per stream the
unsharded chain's decisions exactly and audio to f32 rounding of the
composed carries (tests/test_sharding.py:323).  ``multi_step(state, iqs
[S_steps, S, K * SUBCHUNK_IN], params)`` runs S_steps blocks in one
dispatch (runtime/fuse.py), outputs stream-major [S, S_steps * K, ...].
On a rank's block of a mesh over several processes (parallel/
distributed.py::global_mesh) ``iq`` is the rank's time shards of its
streams, [S_loc, D_loc * K_local * SUBCHUNK_IN], the channel sub-chunks are
gathered over its time group, ``faithful_scan`` runs over all K on every
rank of the group, and the outputs are the rank's sub-chunks.
"""

from __future__ import annotations

import torch

from sdr_pmr446_tpu_torch import config as C
from sdr_pmr446_tpu_torch import device as devices
from sdr_pmr446_tpu_torch.ops.rssi import subchunk_rssi
from sdr_pmr446_tpu_torch.parallel.halo import TimeGroup
from sdr_pmr446_tpu_torch.parallel.scanner_sharded import Mesh, mesh_device
from sdr_pmr446_tpu_torch.runtime import fuse
from sdr_pmr446_tpu_torch.runtime.state import stack_state
from sdr_pmr446_tpu_torch.scanner.chain import RuntimeParams
from sdr_pmr446_tpu_torch.scanner.faithful import (FaithfulOutputs,
                                                   FaithfulScannerChain,
                                                   FaithfulState,
                                                   faithful_scan)

NCH = C.NUM_CHANNELS


class ShardedFaithfulChain:
    """The faithful scanner over S streams on a one-card (S, D) mesh;
    ``device`` (the card by default) must be the mesh's."""

    def __init__(self, mesh: Mesh, subchunks_per_step: int = 8,
                 lowpass: bool = False, device=devices.DEFAULT):
        self.mesh = mesh
        self.device = mesh_device(mesh, device)
        self.K = subchunks_per_step
        self.lowpass = lowpass
        self.n_stream, self.n_time = mesh.n_stream, mesh.n_time
        self.tg = TimeGroup.of(mesh)
        n_time = self.tg.total(self.n_time)
        if self.K % n_time:
            raise ValueError(f"subchunks_per_step={self.K} must divide "
                             f"evenly over the {n_time}-way time axis")
        self.k_local = self.K // n_time
        self.k_rank = self.k_local * self.n_time
        # the unsharded chain's filters, taps and zero state
        self.chain = FaithfulScannerChain(self.K, lowpass, device=self.device)
        self.megastep = fuse.fused_sharded_steps(self.step, self.tg.size)

    @property
    def input_len(self) -> int:
        """Samples per stream and step (of the rank's time shards)."""
        return self.k_rank * C.SUBCHUNK_IN

    def init_state(self) -> FaithfulState:
        """The zero state of every stream, each field [S, ...]."""
        return stack_state(self.chain.init_state(), self.n_stream)

    def step(self, state: FaithfulState, iq: torch.Tensor,
             params: RuntimeParams):
        """One block of every stream: ``iq`` complex64 [S, input_len] on
        the chain's device."""
        want = (self.n_stream, self.input_len)
        if iq.dtype != torch.complex64 or tuple(iq.shape) != want:
            raise ValueError(f"iq must be complex64 {want}, got {iq.dtype} "
                             f"{tuple(iq.shape)}")
        n_s, n_t, tg = self.n_stream, self.n_time, self.tg
        x = torch.stack([iq.real, iq.imag], dim=1).reshape(
            n_s, 2, n_t, -1).transpose(1, 2)                # [S, D, 2, T]
        fr = self.chain.front.shards(state.dc_x, state.dc_y,
                                     state.resamp_hist, state.pfb_hist,
                                     state.frame_parity, x, tg)
        chans = tg.gather(fr.chan).transpose(1, 2).reshape(
            n_s, NCH, -1)                                   # [S, 16, K*ns]

        carries, outs = [], []
        for s in range(n_s):
            chan_blocks = chans[s].reshape(NCH, self.K, -1).transpose(0, 1)
            carry, o = faithful_scan(
                FaithfulState(*(v[s] for v in state)),
                subchunk_rssi(chans[s], self.K), chan_blocks, params,
                self.chain.hp_flip, self.chain.lp_flip, self.chain.de_coeffs,
                self.lowpass)
            carries.append(carry)
            outs.append(o)
        carry = {f: torch.stack([c[f] for c in carries]) for f in carries[0]}
        out = FaithfulOutputs(*(torch.stack(v) for v in zip(*outs)))
        new_state = FaithfulState(
            dc_x=fr.dc_x, dc_y=fr.dc_y, resamp_hist=fr.resamp_hist,
            pfb_hist=fr.pfb_hist, frame_parity=fr.parity,
            rssi=out.rel_rssi[:, -1], **carry)
        if tg.size > 1:
            mine = slice(tg.index * self.k_rank, (tg.index + 1) * self.k_rank)
            out = FaithfulOutputs(*(v[:, mine] for v in out))
        return FaithfulState(*(v.contiguous() for v in new_state)), out

    def multi_step(self, state: FaithfulState, iqs: torch.Tensor,
                   params: RuntimeParams):
        """S_steps blocks of every stream in one dispatch: ``iqs``
        complex64 [S_steps, S, input_len]; outputs [S, S_steps * K, ...],
        equal to the steps bit for bit."""
        return self.megastep(state, iqs, params)

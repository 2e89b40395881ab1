"""The time-sharded (stream x time) scanner on a one-card mesh (PyTorch).

Counterpart of sdr_pmr446_tpu/parallel/scanner_sharded.py on its kernel
engines (``use_pallas=True``), BASELINE.json config 5: S independent
captures (the 'stream' axis), each block cut into D time shards (the 'time'
axis).  In JAX the mesh's shards are devices and the halos move by
collectives; here all S x D shards live on one card (``make_mesh``) and
the collectives are tensor operations along the time dim
(parallel/halo.py), or K11 (kernels/halo_dma.py: one launch a halo,
straight from the signal's re / im planes) for the plane path's two
front-end halos with ``halo_dma=True``.

``ShardedScannerChain(mesh, block).step(state, wire uint8 [S,
step_arg_len], params) -> (state', StepOutputs)``, every output leaf [S, K,
...] and every state field [S, ...] (runtime/state.py::stack_state): per
stream the unsharded ScannerChain's outputs, decisions and events exactly,
RSSI and audio to f32 rounding of the composed carries.  Each shard runs
the kernels of the unsharded engines on its K_local = K / D sub-chunks;
the FSM (scanner/fsm.py v3) runs once for all S streams on the gathered
[S, K, 16] RSSI and [S, K, 38] tone sums, as JAX's vmap runs it.  The
engine follows JAX's gate: the kernel engines (duo or trio) when every
``fuse_*`` switch is on and K_local % 8 == 0, the plane path otherwise
(the port has no ``fuse_group``, as in scanner/chain.py):

  (a) the DUO (default): for D > 1 a read-only pre-pass (K10,
      kernels/summary.py) and the fold of parallel/fused_halo.py give each
      shard's exact incoming DC state; the outgoing halos (front history,
      PFB row, the last frame's discriminator sample) are rebuilt from a
      short corrected DC tail through the plain resampler; then K1 runs per
      shard with the exact state and its own carries are dropped.  With
      one time shard the pre-pass is skipped and K1 keeps its carries;
  (b) the TRIO (``fuse_band=False``): K6 per shard from zero y and zero
      history, the band planes corrected by the affine ramp and history
      response (fused_halo.correct_band), then K7 on the corrected band;
  (c) the PLANE path (any switch off or K_local % 8 != 0): the wire
      decoded to planes, the DC blocker as a composed shard recurrence
      (halo.shard_dc_blocker), K9 with the resampler-history halo, K7's
      plane form, K8 ``apply``, the lp DC blocker over shards and the FSM's
      three-phase CTCSS scan.

On (a) and (b), FSM phase A runs on the gathered RSSI, K2 per shard from a
zero lp-DC state, and its tone sums are corrected (fused_halo.
correct_raw_sums) before phase C, with the kernel phase restarting every
K_local sub-chunks (fsm.raw_sums_to_ctcss ``period``).

``multi_step(state, wires uint8 [S_steps, S, step_arg_len], params)``
runs S_steps blocks in one dispatch (runtime/fuse.py): a CUDA graph of
the steps, every output leaf stream-major [S, S_steps * K, ...], equal to
the steps bit for bit.

The waterfall (``waterfall=w``, JAX scanner_sharded.py:265-284, 340-359,
487-516) runs K3 (kernels/waterfall.py) once a shard, on the band planes
of that shard's engine: K1's ``DuoOut.band`` (after the pre-pass when D >
1), the trio's corrected planes, or K9's on the plane path.  A shard's
window history is the w/2 band samples before its first one
(``halo.shard_hist_reach``): the tail of its left neighbour's band, or,
when w/2 is longer than a shard's band (w = 78400 at K_local = 1), the
tails of as many left neighbours as it takes and the carried history.
Shard 0 reads the stream's carried history as the unsharded chain does
(the last w/2 samples of ``pfb_hist`` for w <= 800, else ``wf_hist``).
Each shard's hop counter is analytic, (wf_cnt + d * K_local * 19600) mod
(w/4), and the carried ``wf_hist`` / ``wf_cnt`` are the last shard's.  Rows
come back [S, K, w], per stream the unsharded chain's within 2e-3 dB.

Over several processes (parallel/distributed.py: ``global_mesh`` gives the
chain a rank's block of the global mesh) the chain holds the rank's S_loc
streams x D_loc time shards and steps its block: ``wire`` uint8 [S_loc,
step_arg_len] (the rank's shards of each stream), the state its streams'
rows (replicated over the ranks of a time group, as JAX replicates the
state over the time axis) and every output leaf [S_loc, D_loc * K_local,
...], its own sub-chunks.  The halos cross the ranks through the time
group's host-staged transport (halo.TimeGroup); the FSM runs over the
whole K on every rank of the group, for the rank's streams at once, on the
gathered [S_loc, K, 16] RSSI and [S_loc, K, 38] tone sums (or [S_loc, 16,
K, ns] lp plane).  A rank's outputs equal its block of the one-process
mesh's bit for bit.

``engine="op"`` is JAX's op engine (``use_pallas=False``, the op branch
of JAX scanner_sharded.py:595-760, every K_local): the wire decoded to
planes, the DC blocker over shards (``halo.shard_dc_blocker``), the plain
resampler with the ``resamp_hist`` halo and the plain PFB with the
``pfb_hist`` halo and each shard's frame parity, once over every [S, D]
row (scanner/op_front.py ``OpFrontEnd.shards``), the discriminator with ``shard_scalar_prev``, the HP FIR, the
delay line, the de-emphasis FIR and (``lowpass``) the lowpass FIR each
with its ``shard_hist`` halo (each shorter than a shard's 1,225 K_local
audio samples, so one neighbour serves it), the lp branch's DC blocker
over shards, then the FSM's three-phase scan of every stream at once on
the gathered [S, K, 16] RSSI and [S, 16, K, ns] lp plane.  It carries the
op layout (runtime/state.py), ignores the ``fuse_*`` switches and runs K3
alone of the kernels, for the waterfall, as above.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sdr_pmr446_tpu_torch import config as C
from sdr_pmr446_tpu_torch import device as devices
from sdr_pmr446_tpu_torch import engine as engines
from sdr_pmr446_tpu_torch import precision
from sdr_pmr446_tpu_torch.kernels.audio_bank import AudioBank
from sdr_pmr446_tpu_torch.kernels.duo import ScannerDuo
from sdr_pmr446_tpu_torch.kernels.front_end import FrontEnd
from sdr_pmr446_tpu_torch.kernels.pfb_demod import PfbDemod, last_frame_output
from sdr_pmr446_tpu_torch.kernels.resample_kernel import Resampler
from sdr_pmr446_tpu_torch.kernels.waterfall import Waterfall
from sdr_pmr446_tpu_torch.ops import decode, fir, fm, spectrogram
from sdr_pmr446_tpu_torch.ops.rssi import (average_power_db, rssi_from_sums,
                                           subchunk_rssi)
from sdr_pmr446_tpu_torch.parallel import fused_halo as FH
from sdr_pmr446_tpu_torch.parallel import halo
from sdr_pmr446_tpu_torch.runtime import fuse
from sdr_pmr446_tpu_torch.runtime.state import (ScannerState,
                                                init_scanner_state,
                                                stack_state)
from sdr_pmr446_tpu_torch.scanner.chain import (OP_AUDIO_HIST, RuntimeParams,
                                                StepOutputs)
from sdr_pmr446_tpu_torch.scanner.fsm import (FsmCarry, fsm_ctcss_scan_v3,
                                              fsm_phase_a, fsm_phase_c,
                                              raw_sums_to_ctcss)
from sdr_pmr446_tpu_torch.scanner.op_front import OpFrontEnd, shard_planes
from sdr_pmr446_tpu_torch.taps import design as D

NCH = C.NUM_CHANNELS
#: the duo pre-pass's DC tail: covers the 512-sample front history and the
#: 416-sample band span of the PFB row and the last frame
DUO_TAIL = 2560
PFB_TAPS = 416


class Mesh(NamedTuple):
    """A (stream x time) mesh on one card: ``n_stream`` streams, each block
    cut into ``n_time`` time shards, every shard on ``device``."""
    n_stream: int
    n_time: int
    device: torch.device


def make_mesh(n_stream: int, n_time: int, device=devices.DEFAULT) -> Mesh:
    """The one-card counterpart of the JAX make_mesh (JAX's takes devices;
    here every shard lives on ``device``, the card by default)."""
    if n_stream < 1 or n_time < 1:
        raise ValueError(f"mesh ({n_stream}, {n_time}): both axes must be "
                         f">= 1")
    return Mesh(n_stream, n_time, devices.resolve(device))


def mesh_device(mesh: Mesh, device) -> torch.device:
    """The chain's device, which must be the mesh's."""
    dev = devices.resolve(device)
    if dev != mesh.device:
        raise ValueError(f"the chain runs on {dev}, its mesh on {mesh.device}")
    return dev


def time_shards(wire: torch.Tensor, mesh: Mesh, arg_len: int) -> torch.Tensor:
    """Check ``wire`` (uint8 [S, arg_len]) and view it as [S, D, bytes a
    shard]: shard d of stream s is wire[s, d * arg_len / D:][:arg_len / D]."""
    want = (mesh.n_stream, arg_len)
    if wire.dtype != torch.uint8 or tuple(wire.shape) != want:
        raise ValueError(f"wire must be uint8 {want}, got {wire.dtype} "
                         f"{tuple(wire.shape)}")
    return wire.reshape(mesh.n_stream, mesh.n_time, -1)


def stacked(outs, field: str) -> torch.Tensor:
    """[S, D, ...] from per-(stream, shard) kernel outputs [S][D]."""
    return torch.stack([torch.stack([getattr(o, field) for o in row])
                        for row in outs])


class _Front(NamedTuple):
    """Steps 1-2 of every engine, per shard."""
    dc_x: torch.Tensor        # c64 [S]      carried state of the next block
    dc_y: torch.Tensor        # c64 [S]
    resamp_hist: torch.Tensor  # c64 [S, H]
    pfb_hist: torch.Tensor    # c64 [S, 400]
    parity: torch.Tensor      # i32 [S]
    prev: torch.Tensor        # c64 [S, 16]
    demod: list               # [S][D] f32 [16, F_local] (None: op engine)
    rssi: torch.Tensor        # f32 [S, D, K_local, 16]
    band: list                # [S][D] f32 [2, nb_local] band planes (K3's)
    #                           (a tensor [S, D, 2, nb_local] on the op engine)


class ShardedScannerChain:
    """The scanner block step over S streams on a one-card (S, D) mesh.

    ``device`` (the card by default) must be the mesh's: CUDA runs the
    kernels, the CPU their plain versions.  ``engine`` chooses the kernel
    engines (the default) or the op engine; on the kernel engines
    ``fuse_band``, ``fuse_dc``, ``fuse_rssi``, ``fuse_lp_dc`` and
    ``fuse_ctcss`` choose the engine by the JAX names (module docstring);
    ``halo_dma`` moves the plane path's two front-end halos by K11."""

    def __init__(self, mesh: Mesh, block: C.BlockConfig | None = None,
                 lowpass: bool = False, fir_deemph: bool = False,
                 waterfall: int = 0, halo_dma: bool = False,
                 input_format: str = "cu8", fuse_dc: bool = True,
                 fuse_lp_dc: bool = True, fuse_rssi: bool = True,
                 fuse_ctcss: bool = True, fuse_band: bool = True,
                 device=devices.DEFAULT, engine: str = engines.KERNEL):
        precision.check()
        self.mesh = mesh
        self.device = mesh_device(mesh, device)
        self.engine = engines.resolve(engine)
        self.op = self.engine == engines.OP
        self.block = block or C.BlockConfig()
        self.input_format = decode.wire_format(input_format)
        spectrogram.validate_width(waterfall)
        self.waterfall = max(waterfall, 0)
        self.lowpass = lowpass
        self.n_time, self.n_stream = mesh.n_time, mesh.n_stream
        self.tg = halo.TimeGroup.of(mesh)
        n_time = self.tg.total(self.n_time)
        k = self.block.subchunks_per_step
        if k % n_time:
            raise ValueError(f"subchunks_per_step={k} must divide evenly over "
                             f"the {n_time}-way time axis")
        self.k_local = k // n_time
        #: the rank's sub-chunks a step (K on the one-card mesh)
        self.k_rank = self.k_local * self.n_time
        self.t_local = self.block.input_len // n_time
        self.fused = bool(fuse_dc and fuse_lp_dc and fuse_rssi and fuse_ctcss
                          and self.k_local % 8 == 0 and not self.op)
        self.fused_duo = self.fused and fuse_band
        self.halo_dma = halo_dma
        dev = self.device
        deemph = D.deemph_fir_taps() if fir_deemph else D.deemph_fir_equiv()
        self.deemph_hist_len = deemph.shape[0] - 1
        self.wf = (Waterfall(self.waterfall, device=dev)
                   if self.waterfall else None)
        self.megastep = fuse.fused_sharded_steps(self.step, self.tg.size)
        if self.op:
            self.front = OpFrontEnd(dev)
            self.resamp_hist_len = self.front.resampler.hist_len
            self.pfb_hist_len = self.front.pfb.hist_len
            self.audio_hist_len = OP_AUDIO_HIST
            f32 = lambda taps: torch.as_tensor(  # noqa: E731
                np.asarray(taps, np.float32), device=dev)
            self.hp_taps = f32(D.ctcss_hp_taps())
            self.deemph_taps = f32(deemph)
            self.lp_taps = f32(D.audio_lp_taps())
            return
        if self.fused_duo:
            self.duo = ScannerDuo(self.input_format, device=dev)
            self.resamp_hist_len = self.duo.front_hist_len
        elif self.fused:
            self.front = FrontEnd(self.input_format, device=dev)
            self.resamp_hist_len = self.front.hist_len
        else:
            self.resampler = Resampler(device=dev)
            self.resamp_hist_len = self.resampler.hist_len
        if not self.fused_duo:
            self.pfb = PfbDemod(device=dev)
        self.pfb_hist_len = (self.duo.pfb if self.fused_duo
                             else self.pfb).hist_len
        self.audio_bank = AudioBank(lowpass, fir_deemph, device=dev)
        self.audio_hist_len = self.audio_bank.hist

    @property
    def engine_label(self) -> str:
        """The engine a step runs: duo, trio, plane path or op."""
        if self.op:
            return "op"
        return ("duo" if self.fused_duo else "trio" if self.fused
                else "plane path")

    def init_state(self) -> ScannerState:
        """The zero state of every stream, each field [S, ...]."""
        return stack_state(init_scanner_state(
            self.resamp_hist_len, self.pfb_hist_len, self.deemph_hist_len,
            self.audio_hist_len, self.device, waterfall=self.waterfall),
            self.n_stream)

    @property
    def step_arg_len(self) -> int:
        """Wire bytes per stream and step (of the rank's time shards)."""
        return self.t_local * self.n_time * decode.BYTES_PER_SAMPLE[
            self.input_format]

    def multi_step(self, state: ScannerState, wires: torch.Tensor,
                   params: RuntimeParams):
        """S_steps blocks of every stream in one dispatch: ``wires`` uint8
        [S_steps, S, step_arg_len].  Returns (state', StepOutputs [S,
        S_steps * K, ...]), per stream equal to the steps bit for bit."""
        return self.megastep(state, wires, params)

    # ------------------------------------------------------------ engines
    def _duo_front(self, st: ScannerState, wire3, ns: int) -> _Front:
        """(a): K1 per shard, after the exact-state pre-pass when D > 1."""
        n_s, n_t, tg = self.n_stream, self.n_time, self.tg
        run = lambda s, d, *state: self.duo(wire3[s, d], *state, ns)  # noqa: E731
        if tg.total(n_t) == 1:
            outs = [[run(s, 0, st.dc_x[s], st.dc_y[s], st.resamp_hist[s],
                         st.pfb_hist[s], st.frame_parity[s],
                         st.demod_prev[s])] for s in range(n_s)]
            last = lambda f: stacked(outs, f)[:, 0]  # noqa: E731
            return _Front(last("dc_x"), last("dc_y"), last("front_hist"),
                          last("pfb_hist"), last("parity"), last("prev"),
                          [[o.demod for o in row] for row in outs],
                          rssi_from_sums(stacked(outs, "mag_sums"), ns),
                          [[o.band for o in row] for row in outs])
        t_local = self.t_local
        dcx_in, y_in, dcx_carry, dcy_carry, dc_tail = FH.exact_dc_state(
            wire3, self.input_format, t_local, DUO_TAIL, st.dc_x, st.dc_y,
            tg)

        # the outgoing halos from the corrected tail, before the kernel
        # (one collective for the three over a time group)
        h = self.resamp_hist_len
        bt = FH.resample_tail(self.duo.front.resampler, dc_tail,
                              FH.REBUILD_START)
        f_local = t_local * C.RESAMP_L // C.RESAMP_M // NCH
        par, lsign, new_par = halo.frame_parities(st.frame_parity, n_t,
                                                  f_local, tg)
        cand = last_frame_output(bt[..., -PFB_TAPS:].real,
                                 bt[..., -PFB_TAPS:].imag, lsign)
        ((hist_in, rh_carry), (pfb_hist_in, ph_carry),
         (fm_prev, fm_carry)) = tg.pass_right(
            (st.resamp_hist, dc_tail[..., -h:]),
            (st.pfb_hist, bt[..., -self.pfb_hist_len:]),
            (st.demod_prev, cand))

        # K1 with the exact incoming state; its returned carries are the
        # pre-pass's to f32 rounding, and the rebuilt ones are kept
        outs = [[run(s, d, dcx_in[s, d], y_in[s, d], hist_in[s, d],
                     pfb_hist_in[s, d], par[s, d], fm_prev[s, d])
                 for d in range(n_t)] for s in range(n_s)]
        return _Front(dcx_carry, dcy_carry, rh_carry, ph_carry, new_par,
                      fm_carry, [[o.demod for o in row] for row in outs],
                      rssi_from_sums(stacked(outs, "mag_sums"), ns),
                      [[o.band for o in row] for row in outs])

    def _last_samples(self, wire3) -> torch.Tensor:
        """Each shard's last input sample, c64 [S, D]."""
        bps = decode.BYTES_PER_SAMPLE[self.input_format]
        xr, xi = decode.decode_planes(wire3[..., -bps:].reshape(-1),
                                      self.input_format)
        return torch.complex(xr, xi).reshape(wire3.shape[:2])

    def _trio_front(self, st: ScannerState, wire3, ns: int) -> _Front:
        """(b): K6 per shard from zero y and history, the band corrected,
        then K7 on the corrected band."""
        n_s, n_t, tg = self.n_stream, self.n_time, self.tg
        h, t_local = self.resamp_hist_len, self.t_local
        xlast = self._last_samples(wire3)
        dcx_in, dcx_carry = halo.shard_scalar_prev(st.dc_x, xlast[..., None],
                                                   tg)
        c64 = dict(dtype=torch.complex64, device=self.device)
        zy, zh = torch.zeros((), **c64), torch.zeros(h, **c64)
        fos = [[self.front(wire3[s, d], dcx_in[s, d], zy, zh)
                for d in range(n_t)] for s in range(n_s)]
        fc = FH.front_end_consts(t_local, h)
        y_in, _, dcy_carry, _ = FH.compose_dc_chain(
            stacked(fos, "dc_y"), xlast, st.dc_y, st.dc_x, fc["p_t1"], 0.0,
            tg)
        ramp = FH._device_const(FH.front_end_consts, str(self.device),
                                "tail_ramp", t_local, h)
        hist_in, rh_carry = FH.shard_pass_right(
            st.resamp_hist, stacked(fos, "front_hist") + y_in[..., None] * ramp,
            tg)
        band = stacked(fos, "band")                        # [S, D, 2, nb]
        g_local = band.shape[-1] // (NCH * C.RESAMP_L)
        bw = band.reshape(n_s, n_t, 2, g_local, NCH * C.RESAMP_L)
        band = torch.stack([
            FH.correct_band(bw[:, :, 0], y_in.real, hist_in.real, t_local, h),
            FH.correct_band(bw[:, :, 1], y_in.imag, hist_in.imag, t_local, h)],
            dim=2).reshape(band.shape)
        f_local = band.shape[-1] // NCH
        par, lsign, new_par = halo.frame_parities(st.frame_parity, n_t,
                                                  f_local, tg)
        cand = last_frame_output(band[..., 0, -PFB_TAPS:],
                                 band[..., 1, -PFB_TAPS:], lsign)
        hl = self.pfb_hist_len
        (fm_prev, fm_carry), (pfb_hist_in, ph_carry) = tg.pass_right(
            (st.demod_prev, cand),
            (st.pfb_hist, torch.complex(band[..., 0, -hl:],
                                        band[..., 1, -hl:])))
        outs = [[self.pfb(band[s, d], pfb_hist_in[s, d], par[s, d],
                          fm_prev[s, d], ns, mag="sums")
                 for d in range(n_t)] for s in range(n_s)]
        return _Front(dcx_carry, dcy_carry, rh_carry, ph_carry, new_par,
                      fm_carry, [[o.demod for o in row] for row in outs],
                      rssi_from_sums(stacked(outs, "mag"), ns),
                      [list(row) for row in band])

    def _plane_front(self, st: ScannerState, wire3, ns: int) -> _Front:
        """(c): the plain DC blocker over shards, then K9 and K7's plane
        form per shard."""
        n_s, n_t, tg = self.n_stream, self.n_time, self.tg
        t_local, kl = self.t_local, self.k_local
        xr, xi = decode.decode_planes(wire3.reshape(-1), self.input_format)
        x = torch.stack([xr.reshape(n_s, n_t, t_local),
                         xi.reshape(n_s, n_t, t_local)], dim=2)
        (ndx, ndy), y = halo.shard_dc_blocker(
            (torch.view_as_real(st.dc_x), torch.view_as_real(st.dc_y)), x,
            C.DC_BLOCK_ALPHA, tg)
        h = self.resamp_hist_len
        rhist, r_carry = halo.shard_hist_planes(st.resamp_hist, y, h,
                                                self.halo_dma, tg)
        bands = [[self.resampler(rhist[s, d], y[s, d, 0], y[s, d, 1])[1]
                  for d in range(n_t)] for s in range(n_s)]
        # a shard's band (>= 19,600 samples) holds its whole last frame
        tails = torch.stack([torch.stack([b[:, -PFB_TAPS:] for b in row])
                             for row in bands])            # [S, D, 2, 416]
        hl = self.pfb_hist_len
        phist, p_carry = halo.shard_hist_planes(st.pfb_hist, tails, hl,
                                                self.halo_dma, tg)
        f_local = bands[0][0].shape[-1] // NCH
        par, lsign, new_par = halo.frame_parities(st.frame_parity, n_t,
                                                  f_local, tg)
        cand = last_frame_output(tails[..., 0, :], tails[..., 1, :], lsign)
        fm_prev, fm_carry = halo.shard_scalar_prev(st.demod_prev,
                                                   cand[..., None], tg)
        outs = [[self.pfb(bands[s][d], phist[s, d], par[s, d], fm_prev[s, d],
                          ns, mag="plane")
                 for d in range(n_t)] for s in range(n_s)]
        rssi = torch.stack([torch.stack([subchunk_rssi(o.mag, kl)
                                         for o in row]) for row in outs])
        return _Front(torch.complex(ndx[..., 0], ndx[..., 1]),
                      torch.complex(ndy[..., 0], ndy[..., 1]), r_carry,
                      p_carry, new_par, fm_carry,
                      [[o.demod for o in row] for row in outs], rssi, bands)

    def _op_front(self, st: ScannerState, wire3, ns: int) -> _Front:
        """The op engine's steps 1-5 over the shards (module docstring):
        the demod comes back as a tensor [S, D, 16, F_local] in ``demod``
        and the band planes as one [S, D, 2, nb_local]."""
        n_s, n_t, kl = self.n_stream, self.n_time, self.k_local
        fr = self.front.shards(st.dc_x, st.dc_y, st.resamp_hist, st.pfb_hist,
                               st.frame_parity,
                               shard_planes(wire3, self.input_format),
                               self.tg)
        rssi = average_power_db(fr.chan.reshape(n_s, n_t, NCH, kl, ns),
                                dim=-1).transpose(-1, -2)   # [S, D, kl, 16]
        fm_prev, fm_carry = halo.shard_scalar_prev(st.demod_prev, fr.chan,
                                                   self.tg)
        _, demod = fm.fm_demod(fm_prev, fr.chan)
        return _Front(fr.dc_x, fr.dc_y, fr.resamp_hist, fr.pfb_hist,
                      fr.parity, fm_carry, demod, rssi, fr.band)

    def _op_audio(self, state: ScannerState, fr: _Front, params,
                  carry: FsmCarry):
        """The op engine's audio path over the shards and the FSM over the
        streams: (audio [S][D] [16, F_local], the FSM's (carry, outputs)
        [S, ...], the state fields it carries)."""
        n_s, n_t, tg = self.n_stream, self.n_time, self.tg
        k, ns = self.block.subchunks_per_step, C.SUBCHUNK_AUDIO
        demod = fr.demod
        hp_hist, hp_carry = halo.shard_hist(state.hp_hist, demod,
                                            C.HP_AUDIO_FILT_TAPS - 1, tg=tg)
        _, hp_out = fir.fir_apply(hp_hist, demod, self.hp_taps)
        dl_hist, dl_carry = halo.shard_hist(state.delay_hist, demod,
                                            C.CTCSS_DELAY, tg=tg)
        _, delayed = fir.delay_apply(dl_hist, demod)
        (lpx_carry, lpy_carry), lp_dcb = halo.shard_dc_blocker(
            (state.lp_dc_x, state.lp_dc_y), delayed - hp_out,
            C.DC_BLOCK_ALPHA, tg)
        gained = hp_out * params.audio_gain
        de_hist, de_carry = halo.shard_hist(state.deemph_hist, gained,
                                            self.deemph_hist_len, tg=tg)
        _, audio = fir.fir_apply(de_hist, gained, self.deemph_taps)
        al_carry = state.audio_lp_hist
        if self.lowpass:
            al_hist, al_carry = halo.shard_hist(
                state.audio_lp_hist, audio, C.LP_AUDIO_FILT_TAPS - 1, tg=tg)
            _, audio = fir.fir_apply(al_hist, audio, self.lp_taps)
        # the FSM of every stream over the whole K at once: the group's
        # RSSI and lp plane
        rssi_g, lp_g = tg.gather(fr.rssi, lp_dcb)
        res = fsm_ctcss_scan_v3(
            carry, rssi_g.reshape(n_s, k, NCH), None, params.channel_mask,
            params.squelch_level, params.lock_max,
            lp_cm=lp_g.transpose(1, 2).reshape(n_s, NCH, k, ns))
        fields = dict(hp_hist=hp_carry, delay_hist=dl_carry,
                      lp_dc_x=lpx_carry, lp_dc_y=lpy_carry,
                      deemph_hist=de_carry, audio_lp_hist=al_carry)
        return ([[audio[s, d] for d in range(n_t)] for s in range(n_s)],
                res, fields)

    def _kernel_audio(self, state: ScannerState, fr: _Front, params,
                      carry: FsmCarry):
        """The kernel engines' audio path per shard and the FSM over the
        streams: (audio [S][D] [16, F_local], the FSM's (carry, outputs)
        [S, ...], the state fields it carries)."""
        ns = C.SUBCHUNK_AUDIO
        n_s, n_t, kl, tg = self.n_stream, self.n_time, self.k_local, self.tg
        k = self.block.subchunks_per_step
        ha = self.audio_bank.hist
        ah_tails = torch.stack([torch.stack([dm[:, -ha:] for dm in row])
                                for row in fr.demod])
        if tg.size == 1:
            rssi_g = fr.rssi
            ah_local, ah_carry = halo.shard_hist(state.audio_hist, ah_tails,
                                                 ha)
        else:
            # the RSSI gathered with the audio halo's edges: one collective
            rssi_g, edges = tg.gather(fr.rssi, ah_tails[:, -1:])
            left = (state.audio_hist if tg.index == 0
                    else edges[:, tg.index - 1])
            ah_local = halo.shift_right(left, ah_tails)
            ah_carry = edges[:, -1]
        rssi_all = rssi_g.reshape(n_s, k, NCH)
        if self.fused:
            # 7a. phase A of every stream on the gathered RSSI
            sched = fsm_phase_a(carry, rssi_all, params.channel_mask,
                                params.squelch_level, params.lock_max, ns)
            sel = torch.clamp(sched.act2, 0, NCH - 1)         # i32 [S, K]
            sel3 = tg.local(sel.reshape(n_s, tg.total(n_t), kl))
            b3 = tg.local(sched.b_arr.reshape(n_s, tg.total(n_t), kl))
            # 6. K2 per shard from a zero lp-DC state; its zero-state error
            # in the tone sums is delta * zeta^pos, added back exactly
            z16 = torch.zeros(NCH, dtype=torch.float32, device=self.device)
            banks = [[self.audio_bank(ah_local[s, d], z16, z16, fr.demod[s][d],
                                      params.audio_gain, b3[s, d], sel3[s, d],
                                      ns)
                      for d in range(n_t)] for s in range(n_s)]
            cc = FH.ctcss_corr_consts(kl, ns)
            _, delta_lp, lpy_carry, lpx_carry = FH.compose_dc_chain(
                stacked(banks, "dc_y"), stacked(banks, "dc_x"),
                state.lp_dc_y, state.lp_dc_x, cc["p_t1"], FH._G, tg)
            delta_sel = torch.gather(delta_lp, 2, sel3.long())
            pre, mem = tg.gather(*FH.correct_raw_sums(
                stacked(banks, "raw_pre"), stacked(banks, "raw_mem"),
                delta_sel, b3, kl, ns))
            audio = [[b.audio for b in row] for row in banks]
            # 7b. the gathered tone sums; each shard's kernel phase restarts
            # at its own sample 0 (period = K_local)
            s_pre, s_suf = raw_sums_to_ctcss(
                sched, pre.reshape(n_s, k, -1), mem.reshape(n_s, k, -1), ns,
                period=kl)
            res = fsm_phase_c(carry, sched, s_pre, s_suf)
        else:
            # 6. K8 apply per shard, the lp DC blocker over the shards
            banks = [[self.audio_bank.apply(ah_local[s, d], fr.demod[s][d],
                                            params.audio_gain)
                      for d in range(n_t)] for s in range(n_s)]
            (lpx_carry, lpy_carry), lp_dcb = halo.shard_dc_blocker(
                (state.lp_dc_x, state.lp_dc_y), stacked(banks, "lp"),
                C.DC_BLOCK_ALPHA, tg)
            lp_dcb = tg.gather(lp_dcb)
            audio = [[b.audio for b in row] for row in banks]
            res = fsm_ctcss_scan_v3(
                carry, rssi_all, None, params.channel_mask,
                params.squelch_level, params.lock_max,
                lp_cm=lp_dcb.transpose(1, 2).reshape(n_s, NCH, k, ns))
        return audio, res, dict(lp_dc_x=lpx_carry, lp_dc_y=lpy_carry,
                                audio_hist=ah_carry)

    # --------------------------------------------------------------- step
    def step(self, state: ScannerState, wire: torch.Tensor,
             params: RuntimeParams):
        """One block step of every stream: ``wire`` uint8 [S, step_arg_len]
        on the chain's device.  Returns (state', StepOutputs [S, K, ...])."""
        wire3 = time_shards(wire, self.mesh, self.step_arg_len)
        ns = C.SUBCHUNK_AUDIO
        n_s = self.n_stream
        k = self.block.subchunks_per_step
        if self.op:
            fr = self._op_front(state, wire3, ns)
        elif self.fused_duo:
            fr = self._duo_front(state, wire3, ns)
        elif self.fused:
            fr = self._trio_front(state, wire3, ns)
        else:
            fr = self._plane_front(state, wire3, ns)
        carry = FsmCarry(state.fsm_state, state.active_chan, state.rssi,
                         state.ct_count, state.ct_carry, state.ct_detected,
                         state.ct_max_idx, state.ct_freq)
        audio, (fsm, fo), fields = (self._op_audio if self.op
                                    else self._kernel_audio)(state, fr,
                                                             params, carry)

        wf_hist, wf_cnt, wf_rows = self._waterfall(state, fr.band)

        # 8. each stream's selected audio, of the rank's sub-chunks
        kr = self.k_rank
        ks = torch.arange(kr, device=self.device)
        at_s = torch.arange(n_s, device=self.device)[:, None]
        mine = slice(self.tg.index * kr, (self.tg.index + 1) * kr)
        fo = type(fo)(*(v[:, mine] for v in fo))
        sel = torch.clamp(fo.active_chan, 0, NCH - 1).long()    # [S, kr]
        a = torch.stack([torch.cat(row, dim=-1) for row in audio])
        out = StepOutputs(
            audio=a.reshape(n_s, NCH, kr, ns)[at_s, sel, ks],
            audio_valid=fo.active_chan >= 0, active_chan=fo.active_chan,
            rel_rssi=fo.rel_rssi, rssi_db=fr.rssi.reshape(n_s, kr, NCH),
            ev_tuned=fo.ev_tuned, ev_detuned=fo.ev_detuned,
            ev_changed=fo.ev_changed, ev_prev_chan=fo.ev_prev_chan,
            ev_new_chan=fo.ev_new_chan, ct_detected=fo.ct_detected,
            ct_max_idx=fo.ct_max_idx, ct_freq=fo.ct_freq,
            ev_ct_acquired=fo.ev_ct_acquired, ev_ct_changed=fo.ev_ct_changed,
            ev_ct_lost=fo.ev_ct_lost, waterfall=wf_rows)
        new_state = state._replace(
            dc_x=fr.dc_x, dc_y=fr.dc_y, resamp_hist=fr.resamp_hist,
            pfb_hist=fr.pfb_hist, frame_parity=fr.parity,
            demod_prev=fr.prev, **fields,
            fsm_state=fsm.fsm_state, active_chan=fsm.active_chan,
            rssi=fsm.rssi, ct_count=fsm.ct_count, ct_carry=fsm.ct_carry,
            ct_detected=fsm.ct_detected, ct_max_idx=fsm.ct_max_idx,
            ct_freq=fsm.ct_freq, wf_hist=wf_hist, wf_cnt=wf_cnt)
        return ScannerState(*(v.contiguous() for v in new_state)), out

    def _waterfall(self, state: ScannerState, band: list):
        """K3 once a shard on its band planes ``band`` [S][D] f32 [2,
        nb_local]: (wf_hist' [S, w/2], wf_cnt' [S], rows [S, K, w]), the
        carries the last shard's (module docstring)."""
        n_s, n_t, tg = self.n_stream, self.n_time, self.tg
        if self.wf is None:
            return state.wf_hist, state.wf_cnt, torch.zeros(
                (n_s, self.k_rank, 0), dtype=torch.float32,
                device=self.device)
        wl = self.wf.wl
        hist0 = (state.pfb_hist if wl <= state.pfb_hist.shape[-1]
                 else state.wf_hist)
        # the halo reads the last min(w/2, nb) samples of each shard
        nb = band[0][0].shape[-1]
        keep = min(wl, nb)
        tails = torch.stack([torch.stack([b[:, nb - keep:] for b in row])
                             for row in band])
        hist, _ = halo.shard_hist_reach(hist0[..., -wl:], tails, wl, tg)
        d = tg.shard_index(n_t, self.device)
        cnt = (state.wf_cnt[:, None] + d * nb) % (self.waterfall // 4)
        outs = [[self.wf(band[s][j], hist[s, j], cnt[s, j])
                 for j in range(n_t)] for s in range(n_s)]
        hist_c, cnt_c = tg.last(
            torch.stack([row[-1].hist for row in outs])[:, None],
            torch.stack([row[-1].cnt for row in outs])[:, None])
        return (hist_c, cnt_c, torch.stack([torch.cat([o.rows for o in row])
                                            for row in outs]))

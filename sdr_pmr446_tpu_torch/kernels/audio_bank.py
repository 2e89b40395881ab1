"""K2 and K8: the audio filter bank, the lp DC blocker and the CTCSS DFT.

K2 replaces the TPU kernel
sdr_pmr446_tpu/kernels/audio_bank.py::PallasAudioBank.apply_dc_ctcss
(body ``_body_dc_ctcss``, tables ``_ctcss_dft_consts`` / ``_kernel_matrix``).
For all 16 channels of one block of discriminator output it computes

  audio = gain * (deemph * [LP] * HP377)(demod)
  lp    = (delta_188 - HP)(demod), then the one-pole DC blocker on lp

with the cascaded FIRs composed in float64 on the host (``_kernel_columns``,
re-derived here because the JAX module imports jax).  For the channel the
FSM selected in each sub-chunk k (``sel[k]``, from fsm_phase_a) it also
forms the 38 CTCSS tone sums over global block positions p = k*ns + i:

  raw_mem[k, t] = sum_{i < ns}    lpdc[sel[k], p] e^{-j w_t p}
  raw_pre[k, t] = sum_{i <= b[k]} lpdc[sel[k], p] e^{-j w_t p}

which scanner/fsm.raw_sums_to_ctcss turns into window sums.  w_t p reaches
thousands of radians, where an f32 sin loses digits; both versions reduce
the phase exactly in integers instead (every CTCSS tone is a whole number
of 0.1 Hz, so w_t p = 2 pi ((10 f_t p) mod 125000) / 125000).

K8 replaces PallasAudioBank.apply (body ``_body``) and apply_dc (body
``_body_dc``), the same bank without the CTCSS epilogue, which the
scanner's op-path switches run (scanner/chain.py):

  apply(hist, demod, gain) -> (hist', audio, lp)
  apply_dc(hist, dc_x, dc_y, demod, gain) -> (hist', dc_x', dc_y', audio,
                                              lp_dcb)

lp_dcb being the DC-blocked lp plane [16, F] that the FSM's CTCSS scan
reads.  dc_x' is lp[:, F-1]; the JAX kernel recomputes it as a dot against
the new history, which gives the same value to f32 rounding.  K2's and K8's
plain versions are one function (``apply_plain`` and ``apply_dc_plain``,
which ``plain`` extends by the tone sums).

Carried state: the last H (512, or 640 for lowpass + fir_deemph) demod
samples per channel and the lp DC blocker's (x[-1], y[-1]) per channel.

The CUDA versions (csrc/audio_bank.cu) share their launches: the composed
FIR pair over one shared-memory window of [hist | demod] with, for K2 and
K8 apply_dc, the lp DC blocker's chunk-local response in its epilogue
(the lp plane never reaches device memory), the chunk-carry scan, then
K2's CTCSS sums (one block per (k, 4 tones), 4 warps a tone, the
sub-chunk's DC-fixed samples staged once) or K8 apply_dc's DC-blocked lp
plane, and the state tail: 4 launches; K8 apply runs the FIR pair
(writing the lp plane) and the history alone.  Intermediates in device memory: the chunk-local lp DC
response (4 B per channel sample) and its chunk ends.

What bounds it: the FIRs, ~800 multiply-adds per channel sample (0.63 G,
0.0188 ms at the card's f32 peak, at K = 40); the rest moves ~10 bytes per
channel sample, and the CTCSS pass is 38 sincos per selected-channel
sample.  The FIR pair is a register-tiled product: a thread keeps AB_R
consecutive audio and lp sums and a sliding window of samples in
registers, and per group of 4 taps makes one float4 window load and one or
two broadcast float4 tap loads (``staged_taps``) for 32 or 64 FFMAs.

K2 runs behind the ``torch.library`` custom op ``sdr_pmr446::audio_bank``:
the launch is its CUDA implementation (registered for "cuda" alone), the
plain version its CPU implementation ("cpu" alone), the taps tensor
arguments; the live scanner and an exported step (apps/export_chain.py)
call the op, and ``LAUNCHES`` counts in its CUDA implementation.  K8
(``apply``, ``apply_dc``), which no exported step reaches, stays a direct
launch.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from sdr_pmr446_tpu_torch import config as C
from sdr_pmr446_tpu_torch.taps import design as D
from sdr_pmr446_tpu_torch.kernels import build
from sdr_pmr446_tpu_torch.kernels.front_end import DC_L, P_L, dc_powers
from sdr_pmr446_tpu_torch.ops import fir, iir

NCH = C.NUM_CHANNELS
LANES = 128
#: longest composed FIR the CUDA kernel's shared-memory window takes
#: (csrc/audio_bank.cu MAX_TAPS)
MAX_TAPS = 640
#: the CUDA FIR pair's tile (csrc/audio_bank.cu, test-enforced): AB_R
#: consecutive outputs a thread, AB_TILE a block (whole DC_L chunks), the
#: staged tap regions padded to whole AB_G (four groups of 4 taps)
AB_R = 8
AB_TILE = 1024
AB_G = 16
#: CTCSS phase period in units of 0.1 Hz * sample: 10 * audio rate
PHASE_PERIOD = 10 * C.AUDIO_SAMPLERATE
_P = 1.0 - C.DC_BLOCK_ALPHA
_G = (1.0 + _P) / 2.0

#: kernel launches of the CUDA versions (one per call): K2, K8 apply and
#: K8 apply_dc; the plain versions never count
LAUNCHES = 0
APPLY_LAUNCHES = 0
APPLY_DC_LAUNCHES = 0


class BankOut(NamedTuple):
    """K8 apply's outputs, in the JAX order."""
    hist: torch.Tensor      # f32 [16, H]
    audio: torch.Tensor     # f32 [16, F]
    lp: torch.Tensor        # f32 [16, F]  the lp branch before its DC blocker


class BankDcOut(NamedTuple):
    """K8 apply_dc's outputs, in the JAX order."""
    hist: torch.Tensor      # f32 [16, H]
    dc_x: torch.Tensor      # f32 [16]  lp x[-1]
    dc_y: torch.Tensor      # f32 [16]  lp DC blocker y[-1]
    audio: torch.Tensor     # f32 [16, F]
    lp_dcb: torch.Tensor    # f32 [16, F]  the DC-blocked lp branch


class AudioOut(NamedTuple):
    hist: torch.Tensor      # f32 [16, H]
    dc_x: torch.Tensor      # f32 [16]  lp x[-1]
    dc_y: torch.Tensor      # f32 [16]  lp DC blocker y[-1]
    audio: torch.Tensor     # f32 [16, F]
    raw_pre: torch.Tensor   # c64 [K, 38]
    raw_mem: torch.Tensor   # c64 [K, 38]


@functools.lru_cache(maxsize=None)
def _kernel_columns(lowpass: bool, fir_deemph: bool):
    """(audio_fir, lp_fir) float64 composed kernels (bit-equal to the JAX
    package's, test-enforced)."""
    hp = D.ctcss_hp_taps()
    de = D.deemph_fir_taps() if fir_deemph else D.deemph_fir_equiv()
    audio = np.convolve(de, hp)
    if lowpass:
        audio = np.convolve(D.audio_lp_taps(), audio)
    lp = -hp.copy()
    lp[C.CTCSS_DELAY] += 1.0            # delta_188 - hp
    return audio, lp


def _pad(n: int) -> int:
    return -(-n // AB_G) * AB_G


def staged_taps(audio: np.ndarray, lp: np.ndarray):
    """(table f32 [PA + 2 PB], PA, PB): the CUDA FIR pair's shared-memory
    tap table from the composed FIRs (La > Ll taps).  Reversed and aligned
    so that output n of a tile sums table tap q against window sample
    n + q, window sample 0 being xe[n0 + H - (PA + Ll - 1)]: the audio tap
    at q is ta[PA + Ll - 1 - q], the lp tap tl[...] likewise, zero outside
    the taps.  Region A (q < PA = La - Ll padded to AB_G): the audio taps
    the lp FIR does not reach; region B (PB = Ll padded): per group of 4,
    4 audio taps then 4 lp taps.  The same f32 values, moved."""
    la, ll = audio.shape[0], lp.shape[0]
    if la <= ll:
        raise ValueError(f"the kernel needs the audio FIR ({la} taps) longer "
                         f"than the lp FIR ({ll})")
    pa, pb = _pad(la - ll), _pad(ll)
    m = pa + ll - 1 - np.arange(pa + pb)          # tap index at position q
    ta = np.where((m >= 0) & (m < la), audio[np.clip(m, 0, la - 1)], 0.0)
    tl = np.where((m >= 0) & (m < ll), lp[np.clip(m, 0, ll - 1)], 0.0)
    region_b = np.stack([ta[pa:].reshape(-1, 4), tl[pa:].reshape(-1, 4)], 1)
    table = np.concatenate([ta[:pa], region_b.reshape(-1)])
    return table.astype(np.float32), pa, pb


def hist_len(lowpass: bool, fir_deemph: bool) -> int:
    """Per-channel demod history: 512, or 640 when the composed audio FIR
    outgrows it (the JAX audio bank's rule)."""
    audio, _ = _kernel_columns(lowpass, fir_deemph)
    return max(4, -(-(audio.shape[0] + 1) // LANES)) * LANES


def tone_units() -> np.ndarray:
    """int32 [38]: each CTCSS tone in units of 0.1 Hz (exact)."""
    f10 = np.rint(np.asarray(C.CTCSS_FREQS) * 10.0)
    assert np.allclose(f10, np.asarray(C.CTCSS_FREQS) * 10.0, rtol=0,
                       atol=1e-9)
    return f10.astype(np.int32)


def check_demod(demod: torch.Tensor, ns: int | None = None):
    """(F, K): raise unless ``demod`` is [16, F] (F whole sub-chunks of
    ``ns`` when given; K = 0 without)."""
    if demod.dim() != 2 or demod.shape[0] != NCH or demod.shape[1] == 0 \
            or (ns is not None and demod.shape[1] % ns):
        whole = f"K*{ns}" if ns is not None else "F"
        raise ValueError(f"demod must be [16, {whole}], got "
                         f"{tuple(demod.shape)}")
    f = demod.shape[1]
    return f, (f // ns if ns is not None else 0)


def apply_plain(hist, demod, gain, taps_audio, taps_lp) -> BankOut:
    """K8 apply in plain PyTorch ops (any device): the FIR pair with the
    composed taps."""
    f, _ = check_demod(demod)
    h = hist.shape[-1]
    la, ll = taps_audio.shape[0], taps_lp.shape[0]
    _, audio = fir.fir_apply(hist[:, h - (la - 1):], demod, taps_audio)
    _, lp = fir.fir_apply(hist[:, h - (ll - 1):], demod, taps_lp)
    new_hist = torch.cat([hist, demod], dim=-1)[:, f:].contiguous()
    return BankOut(new_hist, audio * gain, lp)


def apply_dc_plain(hist, dc_x, dc_y, demod, gain, taps_audio,
                   taps_lp) -> BankDcOut:
    """K8 apply_dc in plain PyTorch ops: the FIR pair, then the lp DC
    blocker (ops/iir.py)."""
    new_hist, audio, lp = apply_plain(hist, demod, gain, taps_audio, taps_lp)
    (ndx, ndy), lp_dcb = iir.dc_blocker_apply((dc_x, dc_y), lp,
                                              C.DC_BLOCK_ALPHA)
    return BankDcOut(new_hist, ndx.contiguous(), ndy.contiguous(), audio,
                     lp_dcb)


def bank_plain(hist, dc_x, dc_y, demod, gain, b_arr, sel, taps_audio,
               taps_lp, f10, ns: int = C.SUBCHUNK_AUDIO) -> AudioOut:
    """K2 in plain PyTorch ops: apply_dc_plain, then the tone sums."""
    check_demod(demod, ns)
    o = apply_dc_plain(hist, dc_x, dc_y, demod, gain, taps_audio, taps_lp)
    raw_pre, raw_mem = ctcss_sums_plain(o.lp_dcb, b_arr, sel, ns, f10)
    return AudioOut(o.hist, o.dc_x, o.dc_y, o.audio, raw_pre, raw_mem)


def dc_scratch(f: int, dev):
    """(lp_last, lplocal, yend, carry) device scratch for an F-sample
    block: lp[:, F-1], the chunk-local lp DC response, its chunk ends and
    the chunk carries."""
    chunks = -(-f // DC_L)
    f32 = dict(dtype=torch.float32, device=dev)
    return (torch.empty(NCH, **f32), torch.empty((NCH, f), **f32),
            torch.empty((NCH, chunks), **f32),
            torch.empty((NCH, chunks), **f32))


def check_bank(hist, demod, gain, taps_staged, taps_audio, taps_lp, pj,
               dev, dc=()) -> int:
    """F: raise unless the inputs and the taps suit the CUDA kernels."""
    f, _ = check_demod(demod)
    h = hist.shape[-1]
    la, ll = taps_audio.shape[0], taps_lp.shape[0]
    if not ll < la <= min(MAX_TAPS, h):
        raise ValueError(f"the kernels take an audio FIR of {la} taps longer "
                         f"than the lp FIR's {ll}, within {MAX_TAPS} and "
                         f"the history's {h}")
    build.require(demod, "demod", torch.float32, (NCH, f), dev)
    build.require(hist, "hist", torch.float32, (NCH, h), dev)
    build.require(gain, "gain", torch.float32, (), dev)
    build.require(taps_staged, "taps_staged", torch.float32, None, dev)
    build.require(pj, "pj", torch.float32, (DC_L,), dev)
    for name, t in zip(("dc_x", "dc_y"), dc):
        build.require(t, name, torch.float32, (NCH,), dev)
    return f


# ------------------------------------------------------ the custom op
# K2: (hist', dc_x', dc_y', audio, raw_pre, raw_mem), AudioOut's fields

@torch.library.custom_op("sdr_pmr446::audio_bank", mutates_args=(),
                         device_types="cpu")
def audio_bank_op(hist: torch.Tensor, dc_x: torch.Tensor,
                  dc_y: torch.Tensor, demod: torch.Tensor,
                  gain: torch.Tensor, b_arr: torch.Tensor,
                  sel: torch.Tensor, taps_staged: torch.Tensor,
                  taps_audio: torch.Tensor, taps_lp: torch.Tensor,
                  pj: torch.Tensor, f10: torch.Tensor, ns: int
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2 on CPU tensors: the plain version."""
    return tuple(build.owned(t) for t in bank_plain(
        hist, dc_x, dc_y, demod, gain, b_arr, sel, taps_audio, taps_lp, f10,
        ns))


@audio_bank_op.register_kernel("cuda")
def _audio_bank_cuda(hist, dc_x, dc_y, demod, gain, b_arr, sel, taps_staged,
                     taps_audio, taps_lp, pj, f10, ns):
    """K2 on CUDA tensors: csrc/audio_bank.cu audio_bank_run on the current
    stream (raises on any fault)."""
    global LAUNCHES
    dev = demod.device
    f = check_bank(hist, demod, gain, taps_staged, taps_audio, taps_lp, pj,
                   dev, (dc_x, dc_y))
    _, k = check_demod(demod, ns)
    h = hist.shape[-1]
    build.require(b_arr, "b_arr", torch.int32, (k,), dev)
    build.require(sel, "sel", torch.int32, (k,), dev)
    build.require(f10, "f10", torch.int32, (C.CTCSS_NUM_FREQS,), dev)
    lp_last, lplocal, yend, carry = dc_scratch(f, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    c64 = dict(dtype=torch.complex64, device=dev)
    out = AudioOut(torch.empty((NCH, h), **f32), torch.empty(NCH, **f32),
                   torch.empty(NCH, **f32), torch.empty((NCH, f), **f32),
                   torch.empty((k, C.CTCSS_NUM_FREQS), **c64),
                   torch.empty((k, C.CTCSS_NUM_FREQS), **c64))
    code = build.library().audio_bank_run(
        demod.data_ptr(), f, hist.data_ptr(), h,
        dc_x.data_ptr(), dc_y.data_ptr(), gain.data_ptr(),
        b_arr.data_ptr(), sel.data_ptr(), k, ns, taps_staged.data_ptr(),
        taps_audio.shape[0], taps_lp.shape[0],
        pj.data_ptr(), _P, _G, P_L, f10.data_ptr(),
        lp_last.data_ptr(), lplocal.data_ptr(), yend.data_ptr(),
        carry.data_ptr(),
        out.audio.data_ptr(), out.hist.data_ptr(), out.dc_x.data_ptr(),
        out.dc_y.data_ptr(), out.raw_pre.data_ptr(), out.raw_mem.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(code, "audio_bank_run")
    LAUNCHES += 1
    return tuple(out)


@audio_bank_op.register_fake
def _audio_bank_fake(hist, dc_x, dc_y, demod, gain, b_arr, sel, taps_staged,
                     taps_audio, taps_lp, pj, f10, ns):
    f, k = check_demod(demod, ns)
    c64 = dict(dtype=torch.complex64)
    return (hist.new_empty(hist.shape), dc_x.new_empty((NCH,)),
            dc_y.new_empty((NCH,)), demod.new_empty((NCH, f)),
            demod.new_empty((k, C.CTCSS_NUM_FREQS), **c64),
            demod.new_empty((k, C.CTCSS_NUM_FREQS), **c64))


def ctcss_sums_plain(lpdc: torch.Tensor, b_arr: torch.Tensor,
                     sel: torch.Tensor, ns: int, f10: torch.Tensor):
    """(raw_pre, raw_mem) c64 [K, 38] of the selected channels (plain)."""
    nch, f = lpdc.shape
    k = f // ns
    dev = lpdc.device
    n = torch.arange(f, device=dev, dtype=torch.int64)
    r = (f10.long()[:, None] * n[None, :]) % PHASE_PERIOD      # [38, F]
    ang = r.to(torch.float64) * (2.0 * math.pi / PHASE_PERIOD)
    cos_t = torch.cos(ang).to(torch.float32).reshape(-1, k, ns)
    sin_t = torch.sin(ang).to(torch.float32).reshape(-1, k, ns)
    ks = torch.arange(k, device=dev)
    x = lpdc.reshape(nch, k, ns)[sel.long(), ks]                # [K, ns]
    pre = torch.arange(ns, device=dev)[None, :] <= b_arr[:, None]
    xp = torch.where(pre, x, torch.zeros_like(x))

    def sums(v):
        re = torch.einsum("ki,tki->kt", v, cos_t)
        im = -torch.einsum("ki,tki->kt", v, sin_t)
        return torch.complex(re, im)

    return sums(xp), sums(x)


class AudioBank(nn.Module):
    """K2 (``forward``) and K8 (``apply``, ``apply_dc``).

    ``module(hist, dc_x, dc_y, demod, gain, b_arr, sel, ns)`` -> AudioOut
    through ``sdr_pmr446::audio_bank``.  Each of the three runs the CUDA
    kernel for CUDA tensors and the plain version for CPU tensors.
    ``gain`` is a 0-d f32 tensor (read on device, never on the host);
    b_arr, sel are i32 [K] from the FSM schedule."""

    def __init__(self, lowpass: bool = False, fir_deemph: bool = False,
                 *, device):
        super().__init__()
        audio, lp = (t.astype(np.float32)
                     for t in _kernel_columns(lowpass, fir_deemph))
        self.hist = hist_len(lowpass, fir_deemph)
        assert max(audio.shape[0], lp.shape[0]) <= min(MAX_TAPS, self.hist)
        self.register_buffer("taps_audio", torch.as_tensor(audio,
                                                           device=device))
        self.register_buffer("taps_lp", torch.as_tensor(lp, device=device))
        table, self.pa, self.pb = staged_taps(audio, lp)
        self.register_buffer("taps_staged", torch.as_tensor(table,
                                                            device=device))
        self.register_buffer("pj", torch.as_tensor(dc_powers(), device=device))
        self.register_buffer("f10", torch.as_tensor(tone_units(),
                                                    device=device))

    @staticmethod
    def _route(demod, kernel, plain, *args):
        if demod.device.type == "cuda":
            return kernel(*args)
        if demod.device.type == "cpu":
            return plain(*args)
        raise ValueError(f"no audio bank for device {demod.device}")

    def forward(self, hist, dc_x, dc_y, demod, gain, b_arr, sel,
                ns: int = C.SUBCHUNK_AUDIO) -> AudioOut:
        if demod.device.type not in ("cuda", "cpu"):
            raise ValueError(f"no audio bank for device {demod.device}")
        return AudioOut(*audio_bank_op(
            hist, dc_x, dc_y, demod, gain, b_arr, sel, self.taps_staged,
            self.taps_audio, self.taps_lp, self.pj, self.f10, ns))

    def apply(self, hist, demod, gain) -> BankOut:
        """K8 apply: (hist', audio, lp), as PallasAudioBank.apply."""
        return self._route(demod, self.apply_kernel, self.apply_plain, hist,
                           demod, gain)

    def apply_dc(self, hist, dc_x, dc_y, demod, gain) -> BankDcOut:
        """K8 apply_dc: (hist', dc_x', dc_y', audio, lp_dcb), as
        PallasAudioBank.apply_dc."""
        return self._route(demod, self.apply_dc_kernel, self.apply_dc_plain,
                           hist, dc_x, dc_y, demod, gain)

    # ------------------------------------------------------------ plain
    def apply_plain(self, hist, demod, gain) -> BankOut:
        """K8 apply in plain PyTorch ops (any device): the FIR pair."""
        return apply_plain(hist, demod, gain, self.taps_audio, self.taps_lp)

    def apply_dc_plain(self, hist, dc_x, dc_y, demod, gain) -> BankDcOut:
        """K8 apply_dc in plain PyTorch ops: the FIR pair, then the lp DC
        blocker (ops/iir.py)."""
        return apply_dc_plain(hist, dc_x, dc_y, demod, gain, self.taps_audio,
                              self.taps_lp)

    def plain(self, hist, dc_x, dc_y, demod, gain, b_arr, sel,
              ns: int = C.SUBCHUNK_AUDIO) -> AudioOut:
        """K2 in plain PyTorch ops: apply_dc_plain, then the tone sums."""
        return bank_plain(hist, dc_x, dc_y, demod, gain, b_arr, sel,
                          self.taps_audio, self.taps_lp, self.f10, ns)

    # ------------------------------------------------------------- cuda
    def _check(self, hist, demod, gain, dev, dc=()):
        """Raise unless the inputs and the taps suit the kernels."""
        build.require(hist, "hist", torch.float32, (NCH, self.hist), dev)
        return check_bank(hist, demod, gain, self.taps_staged,
                          self.taps_audio, self.taps_lp, self.pj, dev, dc)

    def _taps(self):
        """The staged tap table's C arguments: (table, La, Ll)."""
        return (self.taps_staged.data_ptr(), self.taps_audio.shape[0],
                self.taps_lp.shape[0])

    def kernel(self, hist, dc_x, dc_y, demod, gain, b_arr, sel,
               ns: int = C.SUBCHUNK_AUDIO) -> AudioOut:
        """The op on CUDA tensors: K2 (csrc/audio_bank.cu audio_bank_run)
        on the current stream."""
        if demod.device.type != "cuda":
            raise ValueError(f"the audio-bank kernel takes CUDA tensors, got "
                             f"{demod.device}")
        return self(hist, dc_x, dc_y, demod, gain, b_arr, sel, ns)

    def apply_kernel(self, hist, demod, gain) -> BankOut:
        """Launch K8 apply (csrc/audio_bank.cu audio_bank_apply) on the
        current stream."""
        global APPLY_LAUNCHES
        dev = demod.device
        f = self._check(hist, demod, gain, dev)
        f32 = dict(dtype=torch.float32, device=dev)
        out = BankOut(torch.empty((NCH, self.hist), **f32),
                      torch.empty((NCH, f), **f32),
                      torch.empty((NCH, f), **f32))
        code = build.library().audio_bank_apply(
            demod.data_ptr(), f, hist.data_ptr(), self.hist, gain.data_ptr(),
            *self._taps(), out.lp.data_ptr(), out.audio.data_ptr(),
            out.hist.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        build.check(code, "audio_bank_apply")
        APPLY_LAUNCHES += 1
        return out

    def apply_dc_kernel(self, hist, dc_x, dc_y, demod, gain) -> BankDcOut:
        """Launch K8 apply_dc (csrc/audio_bank.cu audio_bank_apply_dc) on
        the current stream."""
        global APPLY_DC_LAUNCHES
        dev = demod.device
        f = self._check(hist, demod, gain, dev, (dc_x, dc_y))
        lp_last, lplocal, yend, carry = dc_scratch(f, dev)
        f32 = dict(dtype=torch.float32, device=dev)
        out = BankDcOut(torch.empty((NCH, self.hist), **f32),
                        torch.empty(NCH, **f32), torch.empty(NCH, **f32),
                        torch.empty((NCH, f), **f32),
                        torch.empty((NCH, f), **f32))
        code = build.library().audio_bank_apply_dc(
            demod.data_ptr(), f, hist.data_ptr(), self.hist,
            dc_x.data_ptr(), dc_y.data_ptr(), gain.data_ptr(), *self._taps(),
            self.pj.data_ptr(), _P, _G, P_L,
            lp_last.data_ptr(), lplocal.data_ptr(), yend.data_ptr(),
            carry.data_ptr(), out.audio.data_ptr(), out.hist.data_ptr(),
            out.dc_x.data_ptr(), out.dc_y.data_ptr(), out.lp_dcb.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        build.check(code, "audio_bank_apply_dc")
        APPLY_DC_LAUNCHES += 1
        return out

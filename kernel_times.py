#!/usr/bin/env python3
"""Times of the port's kernels of one tree, by CUDA kernel.

    python3 kernel_times.py [--tree DIR] [--label NAME] [--reps N] [--out FILE]
                            [--chains | --fsm] [--only TEXT]

Runs, on one CUDA card, kernels of the ``sdr_pmr446_tpu_torch`` package
found in DIR (default: this checkout), after building that tree's kernels
from its own sources.  The kernels that hold a filter bank (the resampler,
the PFB or the audio FIRs):

  K1 (duo, cu8, K = 40), K2 and K8 (the audio bank: apply_dc_ctcss,
  apply and apply_dc, K = 40 and 10, with F.conv1d, K8 apply's library
  yardstick, beside them), K6 (front end, cu8 K = 40 and cs16 K = 10), K7
  (PFB + discriminator, |y| sums, K = 40 and 10, on the plain front end's
  band), K9 (resampler, K = 40 and 10, with F.conv1d, its library
  yardstick, beside it), K4 (mono chain, dsd and single, cu8, K = 16) and
  K5 (channel tail, dsd and single, cu8 K = 16 and cs16 K = 15, on K6's
  band as chip_smoke.py's chan_tail_case builds it), with K5's two
  F.conv1d yardsticks beside it: the dsd decimator (477 taps, stride 16)
  on the two band planes and the single audio FIR (408 taps) on the
  demod (chip_smoke.py's tail_conv);

then K10 (the zero summary) on the cu8 wire of one config-5 step
(4 streams x K = 40, 32.1 MB), with L2 cold (N wires rolled apart, more
than the 50 MB L2 together) and in the sharded path's order (the wire
uploaded, then K10: its copy and the kernel apart in the split), on two
steps' wire with L2 cold (the second point of time against bytes), and a
read-rate yardstick (``sum`` of the cold wire viewed as f32: one read of
the same bytes), and K12a's eight layout moves on seeded random inputs,
then K12b's three modes and torch.matmul (TF32 off, the library
yardstick) on seeded random [128, 256] x [256, 128] f32, and the plane
path's two halos of one config-5 step ((4, 4), K = 40: the resampler
history, h = 345, of the [4, 4, 2, 1003520] DC-blocked planes, and the
PFB tail, h = 400, of the [4, 4, 2, 416] tails) from the planes to (hist,
carry) with halo_dma (K11 from the planes where the tree has it, else the
tree's composition: torch.complex, the ring shift, the carry copy) and
with the collectives (torch.complex, the shift), and torch.roll of each
halo's complex tail (K11's ring shift as one library call),

each on chip_smoke.py's inputs (the same helpers): CUDA events around one
call (median over N fresh inputs, after a warm-up call), and the device
time of the same N calls under torch.profiler, in all and by CUDA kernel,
per call, with the CUDA kernels a call and the median span of a call on
the device (its first kernel's start to its last one's end: launch gaps
and overlaps included).  Two trees compare on one card when one job runs
this for each in turns (parent, change, change, parent).
With --chains it times the tree's chain steps instead of its kernels:
the Msamples/s at S = 1 of ScannerChain (the duo, cu8, K = 40) and
DsdInChain (mono, cu8, K = 16), each step on a device-resident block, 8
distinct blocks (chip_smoke.py's bench_blocks / chain_blocks) after a
warm-up block, host clock to a synchronize, N runs (median and all).
With --fsm it reads the scanner FSM's cost on the tree's chains instead
(chip_smoke.py phase 22(c), (d)): the duo (cu8, K = 40) through
multi_step at S = 8, its Msamples/s over 16 blocks, a replay's device
ms a block and one replay under torch.profiler by part (the FSM's ops in
"other"), and one step of the sharded duo at config 5's (4, 5) under
torch.profiler (ms and device events by part).  --only TEXT times only the
kernel cases whose name holds TEXT.
Prints a line per case and, last, one JSON object {"label", "card",
"cases": {...}}; writes that object to FILE too when given.  Needs a CUDA
device and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
import chip_smoke as cs  # noqa: E402  (helpers; the package loads lazily)


def measure(fn, inputs, sync) -> dict:
    split, span, kernels = cs.device_profile(fn, inputs, sync)
    return {"event_ms": cs.timed(cs.cuda_timer, fn, inputs),
            "device_ms": sum(split.values()), "span_ms": span,
            "kernels": kernels, "by_kernel": split}


def k12b_k11_cases(dev, reps: int):
    """(name, fn, inputs) of K12b's modes beside torch.matmul and of the
    plane path's halo pair, built on ``dev``."""
    import torch
    from sdr_pmr446_tpu_torch import config as C
    from sdr_pmr446_tpu_torch.kernels import probe_precision as K12b
    from sdr_pmr446_tpu_torch.parallel import halo
    rng = np.random.default_rng(14)
    ab = [tuple(torch.as_tensor(rng.standard_normal(shape).astype(
        np.float32), device=dev) for shape in ((128, 256), (256, 128)))
        for _ in range(reps)]
    out = [(f"K12b {mode}", lambda x, y, m=mode: K12b.probe_dot_kernel(
        x, y, m), ab) for mode in K12b.MODES]
    torch.backends.cuda.matmul.allow_tf32 = False
    out.append(("torch.matmul (TF32 off)", torch.matmul, ab))
    (n_s, n_t), k = cs.CONFIG5["plane"]
    t_local = k // n_t * C.SUBCHUNK_IN
    g = torch.Generator(device=dev).manual_seed(14)
    y = torch.randn(n_s, n_t, 2, t_local, device=dev, generator=g)
    rh, ph = 345, 400   # the resampler history, the PFB history
    ins = [(torch.randn(n_s, rh, dtype=torch.complex64, device=dev,
                        generator=g), y,
            torch.randn(n_s, ph, dtype=torch.complex64, device=dev,
                        generator=g),
            torch.randn(n_s, n_t, 2, 416, device=dev, generator=g))
           for _ in range(reps)]
    if hasattr(halo, "shard_hist_planes"):
        dma = lambda c, p, h: halo.shard_hist_planes(c, p, h, True)  # noqa
    else:  # the tree before K11 took the planes
        dma = cs.halo_composition
    collective = lambda c, p, h: halo.shard_hist(c, torch.complex(  # noqa
        p[..., 0, p.shape[-1] - h:], p[..., 1, p.shape[-1] - h:]), h)
    for name, fn in (("halo_dma", dma), ("collectives", collective)):
        out.append((f"halo pair, {name}", lambda cr, yy, cp, tl, fn=fn: (
            fn(cr, yy, rh), fn(cp, tl, ph)), ins))
    tail = lambda p, h: torch.complex(  # noqa: E731
        p[..., 0, p.shape[-1] - h:], p[..., 1, p.shape[-1] - h:])
    for name, i, h in (("resampler history", 1, rh), ("PFB", 3, ph)):
        out.append((f"torch.roll (K11's library call), {name} tail",
                    lambda x: torch.roll(x, 1, dims=1),
                    [(tail(a[i], h),) for a in ins]))
    return out


def k10_k12a_cases(dev, reps: int):
    """(name, fn, inputs) of K10 and K12a's cases, built on ``dev``."""
    import torch
    from sdr_pmr446_tpu_torch.kernels import probe_layout as K12a
    from sdr_pmr446_tpu_torch.kernels import summary
    (n_s, _), k = cs.CONFIG5["duo"]
    streams = cs.config5_streams(n_s, k, 2)
    cu8 = np.concatenate([s[0] for s in streams])
    kernel = lambda w: summary.zero_summary_kernel(w, "cu8")  # noqa: E731

    def cold(x):  # reps wires rolled apart: each call finds its own cold
        return [(torch.roll(torch.as_tensor(x, device=dev), 2 * 977 * r),)
                for r in range(reps)]

    out = [("K10 cu8 config-5 step, L2 cold", kernel, cold(cu8)),
           ("K10 cu8 config-5 step, after its upload",
            lambda h: kernel(torch.as_tensor(h, device=dev)),
            [(cu8,)] * reps),
           ("K10 cu8 two config-5 steps, L2 cold", kernel,
            cold(np.concatenate([cu8] + [s[1] for s in streams]))),
           ("read yardstick: the cold wire as f32, summed",
            lambda w: w.view(torch.float32).sum(), cold(cu8))]
    rng = np.random.default_rng(14)
    for move, (shape, _) in K12a.MOVES.items():
        out.append((f"K12a {move}",
                    lambda x, m=move: K12a.probe_move_kernel(x, m),
                    [(torch.as_tensor(rng.standard_normal(shape).astype(
                        np.float32), device=dev),) for _ in range(reps)]))
    return out


def bank_cases(dev, reps: int):
    """(name, fn, inputs) of the filter-bank kernels' cases, built on
    ``dev``."""
    import torch
    from sdr_pmr446_tpu_torch import config as C
    from sdr_pmr446_tpu_torch.kernels.audio_bank import AudioBank
    from sdr_pmr446_tpu_torch.kernels.chan_tail import MonoChain
    from sdr_pmr446_tpu_torch.kernels.duo import ScannerDuo
    from sdr_pmr446_tpu_torch.kernels.front_end import FrontEnd
    from sdr_pmr446_tpu_torch.kernels.pfb_demod import PfbDemod
    from sdr_pmr446_tpu_torch.kernels.resample_kernel import Resampler
    from sdr_pmr446_tpu_torch.ops import decode, iir
    out = []

    def wires(k, fmt, base=None):
        base = cs.occupied_band(k * C.SUBCHUNK_IN) if base is None else base
        return [torch.as_tensor(decode.quantize_iq(
            base * np.exp(0.37j * s), fmt), device=dev) for s in range(reps)]

    rng = np.random.default_rng(40)
    duo = ScannerDuo("cu8", device=dev)
    st = cs.random_duo_state(duo, rng, dev)
    out.append(("K1 cu8 K=40", lambda *a: duo.kernel(*a, ns=cs.NS),
                [(w,) + st for w in wires(40, "cu8")]))
    for k in (40, 10):
        # phase 2's inputs: the plain K1's demod of the occupied band
        demods = [duo.plain(w, *st, ns=cs.NS).demod for w in wires(k, "cu8")]
        bank = AudioBank(device=dev)
        hist, dcx, dcy, gain, b_arr, sel = cs.bank_state(bank, rng, k)
        out.append((f"K2 K={k}", bank.kernel,
                    [(hist, dcx, dcy, d, gain, b_arr, sel, cs.NS)
                     for d in demods]))
        out.append((f"K8 apply K={k}", bank.apply_kernel,
                    [(hist, d, gain) for d in demods]))
        out.append((f"K8 apply_dc K={k}", bank.apply_dc_kernel,
                    [(hist, dcx, dcy, d, gain) for d in demods]))
        conv, xs = cs.k8_conv(bank, hist, gain, demods)
        out.append((f"F.conv1d (K8) K={k}", conv, xs))
    bands = {}
    for fmt, k in (("cu8", 40), ("cs16", 10)):
        fe = FrontEnd(fmt, device=dev)
        st = (cs.random_c64(rng, dev, scale=0.1),
              cs.random_c64(rng, dev, scale=0.01),
              cs.random_c64(rng, dev, fe.hist_len, scale=0.01))
        ins = [(w,) + st for w in wires(k, fmt)]
        out.append((f"K6 {fmt} K={k}", fe.kernel, ins))
        bands[k] = [fe.plain(*a).band for a in ins]
    for k in (40, 10):
        pd = PfbDemod(device=dev)
        st = (cs.random_c64(rng, dev, 400, scale=0.1),
              torch.tensor(1, dtype=torch.int32, device=dev),
              cs.random_c64(rng, dev, 16, scale=0.1))
        out.append((f"K7 sums K={k}", lambda *a, pd=pd: pd.kernel(
            *a, ns=cs.NS, mag="sums"), [(b,) + st for b in bands[k]]))
    for k in (40, 10):
        rs = Resampler(device=dev)
        n = k * C.SUBCHUNK_IN
        hist = cs.random_c64(rng, dev, rs.hist_len, scale=0.1)
        planes = []
        for x in wires(k, "cf32"):
            xr, xi = decode.decode_planes(x, "cf32")
            z = torch.zeros(2, device=dev)
            planes.append(iir.dc_blocker_apply(
                (z, z), torch.stack([xr, xi]), C.DC_BLOCK_ALPHA)[1])
        out.append((f"K9 K={k}", rs.kernel,
                    [(hist, p[0], p[1]) for p in planes]))
        op = rs.op
        need = (n // op.M - 1) * op.M + op.W
        lhs = [(torch.cat([torch.view_as_real(hist).T, p], dim=-1)[:, :need]
                .reshape(2, 1, need).contiguous(),) for p in planes]
        out.append((f"F.conv1d K={k}", lambda x, w=op.weight, m=op.M:
                    torch.nn.functional.conv1d(x, w, stride=m), lhs))
    for mode in ("dsd", "single"):
        mono = MonoChain(mode, "cu8", channel=5,
                         audio_gain=C.SDR_DEFAULT_AUDIO_GAIN, device=dev)
        st, n0 = cs.random_mono_state(mono, rng, dev)
        ins = [(w, *st) for w in wires(16, "cu8", cs.mono_signal(
            mode, 16 * C.SUBCHUNK_IN, 0))]
        out.append((f"K4 {mode} cu8 K=16",
                    lambda *a, m=mono, n0=n0: m.kernel(*a, n0=n0), ins))
    for fmt, k in (("cu8", 16), ("cs16", 15)):
        for mode in ("dsd", "single"):
            mono = MonoChain(mode, fmt, channel=5,
                             audio_gain=C.SDR_DEFAULT_AUDIO_GAIN, device=dev)
            st, n0 = cs.random_mono_state(mono, rng, dev)
            bands = [mono.front.kernel(w, *st[:3]).band
                     for w in wires(k, fmt, cs.mono_signal(
                         mode, k * C.SUBCHUNK_IN, 0))]
            out.append((f"K5 {mode} {fmt} K={k}",
                        lambda *a, t=mono.tail, n0=n0: t.kernel(*a, n0=n0),
                        [(b,) + tuple(st[3:]) for b in bands]))
            if fmt == "cu8":
                conv, xs = cs.tail_conv(mono.tail, st[3:], n0, bands)
                what = "decimator" if mode == "dsd" else "audio FIR"
                out.append((f"F.conv1d (K5 {mode} {what}) K={k}", conv, xs))
    return out


def chain_rates(dev, sync, reps: int) -> dict:
    """--chains: {chain: {"msamples_per_s": median, "runs": [...]}}."""
    import time
    import torch
    from sdr_pmr446_tpu_torch import config as C
    from sdr_pmr446_tpu_torch.scanner.chain import (ScannerChain,
                                                    make_runtime_params)
    from sdr_pmr446_tpu_torch.scanner.dsd_in import DsdInChain
    n_blocks = 8
    scanner = ScannerChain(C.BlockConfig(40), device=dev)
    dsd = DsdInChain(16, input_format="cu8", device=dev)
    params = (make_runtime_params(C.ScannerArgs(), dev),)
    paths = {"scanner duo K=40 cu8": (scanner, params,
                                      cs.bench_blocks(40, 1 + n_blocks)),
             "dsd_in mono K=16 cu8": (dsd, (),
                                      cs.chain_blocks("dsd", 16, 1 + n_blocks,
                                                      "cu8"))}
    out = {}
    for name, (chain, rest, blocks) in paths.items():
        wires = [torch.as_tensor(b, device=dev) for b in blocks]
        n_samp = sum(len(b) for b in blocks[1:]) // 2       # cu8: 2 B each
        st, _ = chain.step(chain.init_state(), wires[0], *rest)
        runs = []
        for _ in range(reps):
            state = st
            sync()
            t0 = time.perf_counter()
            for w in wires[1:]:
                state, _ = chain.step(state, w, *rest)
            sync()
            runs.append(n_samp / (time.perf_counter() - t0) / 1e6)
        out[name] = {"msamples_per_s": float(np.median(runs)), "runs": runs}
        cs.log(f"  {name}: S = 1, {np.median(runs):.1f} Msamples/s (runs "
               f"{', '.join(f'{r:.1f}' for r in runs)})")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=None,
                    help="checkout whose sdr_pmr446_tpu_torch to time")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--reps", type=int, default=cs.REPS)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--chains", action="store_true",
                    help="time the chain steps at S = 1, not the kernels")
    ap.add_argument("--fsm", action="store_true",
                    help="read the FSM's cost on the chains, not the "
                         "kernels")
    ap.add_argument("--only", default="",
                    help="time only the kernel cases whose name holds this")
    args = ap.parse_args(argv)
    if args.tree is not None:
        sys.path.insert(0, str(args.tree.resolve()))
    import torch
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device available", file=sys.stderr)
        return 2
    import sdr_pmr446_tpu_torch
    from sdr_pmr446_tpu_torch.kernels import build
    dev = torch.device("cuda", 0)
    sync = lambda: torch.cuda.synchronize(dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    cs.log(f"{args.label}: {Path(sdr_pmr446_tpu_torch.__file__).parent}, "
           f"{card}")
    build.library()
    if args.chains or args.fsm:
        doc = {"label": args.label, "card": card,
               "cases": (chain_rates(dev, sync, args.reps) if args.chains
                         else cs.fsm_tree_readings(dev, sync))}
        write(doc, args.out)
        return 0
    res = {}
    cases = (bank_cases(dev, args.reps) + k10_k12a_cases(dev, args.reps)
             + k12b_k11_cases(dev, args.reps))
    for name, fn, inputs in cases:
        if args.only not in name:
            continue
        res[name] = r = measure(fn, inputs, sync)
        span = "n/a" if r["span_ms"] is None else f"{r['span_ms']:.4f} ms"
        cs.log(f"  {name}: event {r['event_ms']:.4f} ms, device "
               f"{r['device_ms']:.4f} ms, {r['kernels']:g} CUDA kernels, "
               f"span {span}: {cs.split_str(r['by_kernel'])}")
    write({"label": args.label, "card": card, "cases": res}, args.out)
    return 0


def write(doc: dict, out: Path | None) -> None:
    """Prints ``doc`` as JSON, and writes it to ``out`` when given."""
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(doc))
    print(json.dumps(doc))


if __name__ == "__main__":
    sys.exit(main())

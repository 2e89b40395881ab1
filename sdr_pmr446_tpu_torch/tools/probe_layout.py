"""Run the layout probes on the card (K12a).

    python -m sdr_pmr446_tpu_torch.tools.probe_layout [--device cpu]

Counterpart of tools/probe_layout.py.  The JAX tool compiles each of its
eight moves once on zeros; here each move (kernels/probe_layout.py) runs on
a seeded random input and its output is held bit for bit against the plain
version (torch slicing, ``reshape`` and ``.T``) on the host.  One line a
move, ``name: PASS`` when it built, launched and matched, else ``name: FAIL
<reason>``.  Every move is expected to pass on Hopper, ``value_lane_off16``
included (the JAX tool expects Mosaic to refuse that one).

Exits 0 only if every move passes.  ``--device cpu`` runs the plain
versions; the default, ``cuda``, exits 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from sdr_pmr446_tpu_torch import device as devices
from sdr_pmr446_tpu_torch.kernels import probe_layout as K12a


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Same shape and the same f32 bit patterns."""
    return (a.shape == b.shape
            and torch.equal(a.contiguous().view(torch.int32),
                            b.contiguous().view(torch.int32)))


def run(device, seed: int = 0) -> list[tuple[str, bool, str]]:
    """(move, passed, reason) for every move, in the kernel's order."""
    rng = np.random.default_rng(seed)
    results = []
    for move, (shape, _) in K12a.MOVES.items():
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        try:
            got = K12a.probe_move(x.to(device), move).cpu()
        except (RuntimeError, ValueError) as e:
            head = next((ln for ln in str(e).splitlines() if ln.strip()), "?")
            results.append((move, False, f"{type(e).__name__}: {head[:160]}"))
            continue
        ok = bits_equal(got, K12a.probe_move_plain(x, move))
        results.append((move, ok, "" if ok else "output differs from the "
                        "plain version"))
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="probe_layout",
                                description="layout probes (K12a)")
    p.add_argument("--device", default=devices.DEFAULT,
                   help="cuda: the kernel; cpu: the plain versions "
                        "(default: cuda)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random inputs")
    ns = p.parse_args(argv)
    try:
        dev = devices.resolve(ns.device)
    except (ValueError, RuntimeError) as e:
        print(f"probe_layout: {e}", file=sys.stderr)
        return 1
    ok = True
    for move, passed, reason in run(dev, ns.seed):
        print(f"{move}: PASS" if passed else f"{move}: FAIL {reason}",
              flush=True)
        ok &= passed
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

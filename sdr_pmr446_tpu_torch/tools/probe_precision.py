"""Probe the f32 contraction precision on the card (K12b).

    python -m sdr_pmr446_tpu_torch.tools.probe_precision [--device cpu]

Counterpart of tools/probe_precision.py.  The probe is the JAX tool's: A f32
[128, 256] of 1 + 2^-12 times B f32 [256, 128] of ones reads 256.0625 when
the product contracts in true f32 and 256.0 after one TF32 pass (TF32 rounds
1 + 2^-12 to 1.0, as bf16 does on the TPU).  One line a reading, in the
JAX tool's format (``path mode: value  -> verdict``):

  - ``kernel`` ffma / tf32 / 3xtf32: the K12b kernel's three modes
    (kernels/probe_precision.py); they must read f32, tf32 and f32;
  - ``matmul`` / ``conv1d`` policy: ``torch.matmul`` and ``F.conv1d`` under
    the port's TF32-off policy (precision.py); they must read f32;
  - ``matmul`` / ``conv1d`` tf32-on: the same with its TF32 switch on,
    printed and not gated (the switches are restored afterwards).

Exits 0 only if every gated reading is the expected one.  ``--device cpu``
runs the plain versions; the default, ``cuda``, exits 1 without a CUDA
device.  Every reading runs in this process: the JAX tool's one
subprocess a probe was a workaround for its TPU host and has no
counterpart.
"""

from __future__ import annotations

import argparse
import sys

from sdr_pmr446_tpu_torch import device as devices
from sdr_pmr446_tpu_torch.kernels import probe_precision as K12b


def readings(device) -> list:
    """The kernel's readings, then the library's."""
    return K12b.kernel_readings(device) + K12b.library_readings(device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="probe_precision",
        description="f32 contraction-precision probe (K12b)")
    p.add_argument("--device", default=devices.DEFAULT,
                   help="cuda: the kernel and cuBLAS / cuDNN; cpu: the "
                        "plain versions (default: cuda)")
    ns = p.parse_args(argv)
    try:
        dev = devices.resolve(ns.device)
    except (ValueError, RuntimeError) as e:
        print(f"probe_precision: {e}", file=sys.stderr)
        return 1
    ok = True
    for r in readings(dev):
        gate = "" if r.expected else "  (not gated)"
        print(f"{r.path:7s} {r.mode:8s}: {r.value!r}  -> {r.verdict}{gate}",
              flush=True)
        ok &= r.expected is None or r.verdict == r.expected
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

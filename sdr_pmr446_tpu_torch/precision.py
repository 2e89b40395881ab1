"""Float32 precision policy (counterpart of sdr_pmr446_tpu/kernels/precision.py).

The JAX package pins every value-bearing f32 dot to ``Precision.HIGHEST``
because the TPU contracts f32 in bf16 by default.  On an NVIDIA card the
matching hazard is TF32: cuBLAS matmuls stay true f32 unless
``torch.backends.cuda.matmul.allow_tf32`` is set, but cuDNN runs f32
*convolutions* in TF32 by default (``torch.backends.cudnn.allow_tf32`` is
True).  The plain resampler, PFB and audio FIR bank are convolutions, so
both switches are turned off here and the chain asserts the policy at
construction: TF32 keeps ~3 decimal digits, which would collapse the
> 100 dB kernel-vs-plain gate and put borderline squelch and CTCSS
decisions at risk.
"""

from __future__ import annotations

import contextlib

import torch


def apply() -> None:
    """Turn TF32 off for both cuBLAS matmuls and cuDNN convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def check() -> None:
    """Raise if TF32 is enabled for matmuls or convolutions."""
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError(
            "TF32 is enabled (torch.backends.cuda.matmul.allow_tf32 or "
            "torch.backends.cudnn.allow_tf32); the scanner needs true f32 — "
            "call sdr_pmr446_tpu_torch.precision.apply()")


@contextlib.contextmanager
def tf32_switches(matmul: bool, cudnn: bool):
    """Set the two TF32 switches for the body of a ``with``, then restore
    both as they were, also when the body raises (the probe's readings
    with TF32 on, kernels/probe_precision.py)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = matmul
    torch.backends.cudnn.allow_tf32 = cudnn
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old

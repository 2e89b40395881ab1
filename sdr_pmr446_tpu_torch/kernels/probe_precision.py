"""K12b: the f32 contraction-precision probe, CUDA kernel and plain versions.

Replaces the TPU kernel in tools/probe_precision.py::_probe_one (its Pallas
path, a ``dot_general`` at default or HIGHEST precision).  On the TPU the
question is whether an f32 product contracts in true f32 or in one bf16
pass; on an NVIDIA card it is true f32 against one TF32 pass.  The probe
input is the JAX tool's: A f32 [128, 256] filled with 1 + 2^-12, B f32
[256, 128] of ones.  True f32 gives 256 (1 + 2^-12) = 256.0625 exactly;
TF32 keeps 10 mantissa bits, rounds 1 + 2^-12 to 1.0 and gives 256.0.

``probe_dot(a, b, mode)`` computes a @ b (f32 [M, K] x [K, N]) at one of
three contraction precisions:

  - ``ffma``: true f32.  Plain version: ``torch.matmul`` with both TF32
    switches off (precision.py's policy); kernel: ``fmaf`` over k in order
    for each output, 2 x 2 outputs a thread from operands staged in shared
    memory;
  - ``tf32``: one TF32 pass, the counterpart of the TPU's default
    precision.  Plain version: both inputs rounded to TF32 by int32 bit
    operations (``tf32_round``), then a true-f32 product; kernel:
    ``wgmma ... tf32`` on ``cvt.rna.tf32.f32``-rounded inputs;
  - ``3xtf32``: three TF32 passes, the counterpart of HIGHEST: hi =
    tf32(x), lo = tf32(x - hi), a_lo b_hi + a_hi b_lo + a_hi b_hi.  Plain
    version: the same split and three true-f32 products; kernel: three
    ``wgmma`` a k-step into one accumulator.

The CUDA version (csrc/probe_precision.cu) runs the tensor-core modes on
``wgmma``: a cluster of four blocks a 64 x 16 output tile, each block one
warpgroup over a quarter of the depth (A's slice staged by ``cp.async`` and
rounded in registers, B's rounded and stored transposed in the 128-byte
swizzled K-major layout its descriptor names), the partial tiles added in
block 0 in rank order.  ffma runs on the CUDA cores, a 16 x 16 tile a block
over the whole depth in k's order.  Every mode needs N % 16 == 0 and K %
128 == 0 with K <= 512, ffma M % 16 == 0 and the tensor-core modes M % 64
== 0, and contiguous operands on 16 bytes (``probe_dot_kernel`` raises
ValueError otherwise).  ``library_readings`` reads the same probe
through ``torch.matmul`` and ``F.conv1d`` (the product as a conv with 256
input channels and kernel size 1) under the policy and with each TF32
switch on; the port never computes a mode with them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sdr_pmr446_tpu_torch import precision
from sdr_pmr446_tpu_torch.kernels import build

EPS = 2.0 ** -12           # tf32(1 + 2^-12) == 1.0; f32 keeps it
DEPTH = 256                # contraction depth: f32 sum = 256.0625 exactly
EXACT = DEPTH * (1.0 + EPS)   # 256.0625
ROUNDED = float(DEPTH)        # 256.0
MODES = ("ffma", "tf32", "3xtf32")
MODE_CODE = {m: i for i, m in enumerate(MODES)}
#: the verdict each kernel mode must read on the probe input
EXPECTED = {"ffma": "f32-contract", "tf32": "tf32-contract",
            "3xtf32": "f32-contract"}

#: the kernel's tiles (csrc/probe_precision.cu PD_KMULT, PD_KMAX, TC_N,
#: FM_BM, TC_M): K a multiple of K_MULT (the tensor-core modes split it four
#: ways, each slice whole 128-byte rows), at most K_MAX
K_MULT, K_MAX, N_TILE = 128, 512, 16
M_TILE = {"ffma": 16, "tf32": 64, "3xtf32": 64}

#: kernel launches of the CUDA version by mode (one per call); the plain
#: versions never count
LAUNCHES = {m: 0 for m in MODES}


class Reading(NamedTuple):
    path: str        # "kernel", "matmul" or "conv1d"
    mode: str        # a kernel mode, "policy" or "tf32-on"
    value: float     # out[0, 0] on the probe input
    verdict: str     # "f32-contract", "tf32-contract" or "other (...)"
    expected: str | None   # the verdict the reading must have (None: any)


def probe_inputs(device):
    """The probe's A [128, 256] = 1 + 2^-12 and B [256, 128] = 1, f32."""
    a = torch.full((128, DEPTH), 1.0 + EPS, dtype=torch.float32,
                   device=device)
    b = torch.ones((DEPTH, 128), dtype=torch.float32, device=device)
    return a, b


def verdict(v: float) -> str:
    """The JAX tool's verdict, with TF32 in the place of bf16."""
    if abs(v - EXACT) < 2 ** -8:
        return "f32-contract"
    if abs(v - ROUNDED) < 2 ** -8:
        return "tf32-contract"
    return f"other ({v!r})"


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 as ``cvt.rna.tf32.f32`` does: to the nearest
    value with 10 mantissa bits, ties away from zero (add half of the 13
    dropped bits' weight to the magnitude bits, then clear them).
    Non-finite values pass unchanged."""
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def _check(a: torch.Tensor, b: torch.Tensor, mode: str) -> None:
    if mode not in MODE_CODE:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.float32 or t.dim() != 2:
            raise ValueError(f"{name}: expected a 2-D f32 tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} do not "
                         f"contract")


def probe_dot(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """K12b: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if a.device.type == "cuda":
        return probe_dot_kernel(a, b, mode)
    if a.device.type == "cpu":
        return probe_dot_plain(a, b, mode)
    raise ValueError(f"no probe for device {a.device}")


def probe_dot_plain(a: torch.Tensor, b: torch.Tensor,
                    mode: str) -> torch.Tensor:
    """The same function in plain PyTorch ops (any device), every product
    in true f32."""
    _check(a, b, mode)
    with precision.tf32_switches(False, False):
        if mode == "ffma":
            return torch.matmul(a, b)
        a_hi, b_hi = tf32_round(a), tf32_round(b)
        if mode == "tf32":
            return torch.matmul(a_hi, b_hi)
        a_lo, b_lo = tf32_round(a - a_hi), tf32_round(b - b_hi)
        return (torch.matmul(a_lo, b_hi) + torch.matmul(a_hi, b_lo)
                + torch.matmul(a_hi, b_hi))


def probe_dot_kernel(a: torch.Tensor, b: torch.Tensor,
                     mode: str) -> torch.Tensor:
    """Launch csrc/probe_precision.cu on the current stream (raises on any
    fault)."""
    _check(a, b, mode)
    m, k = a.shape
    n = b.shape[1]
    if (m % M_TILE[mode] or n % N_TILE or k % K_MULT or not 0 < k <= K_MAX
            or m <= 0 or n <= 0):
        raise ValueError(f"mode {mode}: needs M % {M_TILE[mode]} == N % "
                         f"{N_TILE} == K % {K_MULT} == 0 and 0 < K <= "
                         f"{K_MAX}, got M={m}, N={n}, K={k}")
    dev = a.device
    build.require(a, "a", torch.float32, (m, k), dev)
    build.require(b, "b", torch.float32, (k, n), dev)
    build.check_aligned(a.data_ptr(), "a")
    build.check_aligned(b.data_ptr(), "b")
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    code = build.library().probe_dot_run(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, MODE_CODE[mode],
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(code, "probe_dot_run")
    LAUNCHES[mode] += 1
    return out


def _reading(path: str, mode: str, out: torch.Tensor,
             expected: str | None) -> Reading:
    v = float(out[0, 0])
    return Reading(path, mode, v, verdict(v), expected)


def kernel_readings(device) -> list[Reading]:
    """Each mode of ``probe_dot`` on the probe input."""
    a, b = probe_inputs(device)
    return [_reading("kernel", m, probe_dot(a, b, m), EXPECTED[m])
            for m in MODES]


def library_readings(device) -> list[Reading]:
    """``torch.matmul`` and ``F.conv1d`` on the probe input, under the
    TF32-off policy (must read true f32) and with their TF32 switch on
    (printed, not gated); both switches are restored afterwards."""
    a, b = probe_inputs(device)
    matmul = lambda: torch.matmul(a, b)
    conv = lambda: torch.nn.functional.conv1d(b[None], a[:, :, None])[0]
    out = []
    with precision.tf32_switches(False, False):
        out.append(_reading("matmul", "policy", matmul(), "f32-contract"))
        out.append(_reading("conv1d", "policy", conv(), "f32-contract"))
    with precision.tf32_switches(True, False):
        out.append(_reading("matmul", "tf32-on", matmul(), None))
    with precision.tf32_switches(False, True):
        out.append(_reading("conv1d", "tf32-on", conv(), None))
    return out

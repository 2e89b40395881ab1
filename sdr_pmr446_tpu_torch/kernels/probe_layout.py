"""K12a: the layout probes, CUDA kernel and plain versions.

Replaces the TPU kernels of tools/probe_layout.py (``_call``'s Pallas
kernels, one body per move in its ``main()``).  The JAX tool compiles each
move once on zeros to learn whether Mosaic lowers it; here each move runs
on real values and its output is held bit for bit against the plain
version.  The eight moves a fused front-end -> PFB kernel would need, by
the JAX tool's names, input -> output shape (all f32):

  ====================  ============  ===========  ===========================
  move                  input         output       plain version
  ====================  ============  ===========  ===========================
  scratch_store_off16   [8, 256]      [8, 128]     s = x; s[:, 16:32] =
                                                   x[:, 0:16]; s[:, 0:128]
  scratch_read_off16    [8, 256]      [8, 128]     x[:, 16:144]
  scratch_read_narrow   [8, 256]      [8, 16]      x[:, 16:32]
  value_lane_off16      [8, 256]      [8, 128]     x[:, 16:144]
  value_stride_sub      [128, 256]    [8, 256]     x[0::16, :]
  reshape_rows_wide     [128, 128]    [8, 2048]    x.reshape(8, 2048)
  reshape_25_16         [128, 25]     [200, 16]    x.reshape(200, 16)
  transpose_16          [128, 16]     [16, 128]    x.T
  ====================  ============  ===========  ===========================

The CUDA version (csrc/probe_layout.cu) is one launch a move (8 blocks for
``value_stride_sub`` and ``reshape_rows_wide``, one block for the rest):
every move but ``value_lane_off16`` stages in shared memory (the VMEM
scratch's counterpart) only what its output reads, by bulk copies on one
mbarrier (``transpose_16`` by 16-byte ``cp.async`` into a swizzled tile),
and writes the output from there in float4; ``value_lane_off16`` slices in
registers with warp shuffles, the move the JAX tool expects Mosaic to
refuse.  ``x`` and the output start on 16 bytes (``build.check_aligned``).
"""

from __future__ import annotations

import torch

from sdr_pmr446_tpu_torch.kernels import build

#: move -> (input shape, output shape), in the kernel's move order
MOVES = {
    "scratch_store_off16": ((8, 256), (8, 128)),
    "scratch_read_off16": ((8, 256), (8, 128)),
    "scratch_read_narrow": ((8, 256), (8, 16)),
    "value_lane_off16": ((8, 256), (8, 128)),
    "value_stride_sub": ((128, 256), (8, 256)),
    "reshape_rows_wide": ((128, 128), (8, 2048)),
    "reshape_25_16": ((128, 25), (200, 16)),
    "transpose_16": ((128, 16), (16, 128)),
}
MOVE_CODE = {m: i for i, m in enumerate(MOVES)}

#: kernel launches of the CUDA version by move (one per call); the plain
#: versions never count
LAUNCHES = {m: 0 for m in MOVES}


def _store_off16(x: torch.Tensor) -> torch.Tensor:
    s = x.clone()
    s[:, 16:32] = x[:, 0:16]
    return s[:, 0:128].contiguous()


_PLAIN = {
    "scratch_store_off16": _store_off16,
    "scratch_read_off16": lambda x: x[:, 16:144].contiguous(),
    "scratch_read_narrow": lambda x: x[:, 16:32].contiguous(),
    "value_lane_off16": lambda x: x[:, 16:144].contiguous(),
    "value_stride_sub": lambda x: x[0::16, :].contiguous(),
    "reshape_rows_wide": lambda x: x.reshape(8, 2048).clone(),
    "reshape_25_16": lambda x: x.reshape(200, 16).clone(),
    "transpose_16": lambda x: x.T.contiguous(),
}


def min_bytes(move: str) -> int:
    """Bytes ``move`` must move: each input word its output reads, once
    (the plain version run on the words' own indices), and its output."""
    shape_in, shape_out = MOVES[move]
    n = shape_in[0] * shape_in[1]
    index = torch.arange(n, dtype=torch.float32).reshape(shape_in)
    read = probe_move_plain(index, move).unique().numel()
    return 4 * (read + shape_out[0] * shape_out[1])


def _check(x: torch.Tensor, move: str) -> None:
    if move not in MOVES:
        raise ValueError(f"unknown move {move!r}; moves: {list(MOVES)}")
    shape = MOVES[move][0]
    if x.dtype != torch.float32 or tuple(x.shape) != shape:
        raise ValueError(f"{move}: expected f32 {shape}, got {x.dtype} "
                         f"{tuple(x.shape)}")


def probe_move(x: torch.Tensor, move: str) -> torch.Tensor:
    """K12a: the CUDA kernel for a CUDA tensor, the plain version for a CPU
    tensor."""
    if x.device.type == "cuda":
        return probe_move_kernel(x, move)
    if x.device.type == "cpu":
        return probe_move_plain(x, move)
    raise ValueError(f"no layout probe for device {x.device}")


def probe_move_plain(x: torch.Tensor, move: str) -> torch.Tensor:
    """The same move in plain PyTorch ops (any device): torch slicing,
    ``reshape`` and ``.T``."""
    _check(x, move)
    return _PLAIN[move](x)


def probe_move_kernel(x: torch.Tensor, move: str) -> torch.Tensor:
    """Launch csrc/probe_layout.cu on the current stream (raises on any
    fault)."""
    _check(x, move)
    dev = x.device
    build.require(x, "x", torch.float32, MOVES[move][0], dev)
    build.check_aligned(x.data_ptr(), "x")
    out = torch.empty(MOVES[move][1], dtype=torch.float32, device=dev)
    code = build.library().probe_layout_run(
        MOVE_CODE[move], x.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(code, "probe_layout_run")
    LAUNCHES[move] += 1
    return out

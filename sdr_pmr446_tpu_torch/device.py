"""The device an entry point runs on.

Every entry point of the port (``ScannerDriver``, ``ScannerChain``,
``DsdInChain``, ``SingleChannelChain``, the CLIs) defaults to ``"cuda"``;
the CPU runs only when the caller passes ``device="cpu"``.  Without a CUDA
device the default raises here, before anything is built: nothing falls
back to the CPU quietly.
"""

from __future__ import annotations

import torch

DEFAULT = "cuda"


def resolve(device=DEFAULT) -> torch.device:
    """``device`` as a torch.device: a CUDA device runs the hand-written
    kernels, the CPU their plain versions.  Raises ValueError for any other
    device type and RuntimeError for a CUDA device on a host that has
    none."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {str(dev)!r}: the port runs on 'cuda' (its "
                         f"kernels) or 'cpu' (their plain versions)")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r} requested but no CUDA device "
                           f"is available (pass device='cpu' / --device cpu "
                           f"for the plain PyTorch versions)")
    return dev

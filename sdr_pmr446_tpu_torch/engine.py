"""The engine a chain runs.

Every chain of the port (``ScannerChain``, ``DsdInChain``,
``SingleChannelChain``, the three sharded chains and ``ScannerDriver``)
takes ``engine``:

  - ``"kernel"`` (the default): the hand-written CUDA kernels, the
    counterpart of the JAX chains' ``use_pallas=True``;
  - ``"op"``: plain PyTorch ops (convolutions, scans, the FSM's ops), the
    counterpart of the JAX op engine (``use_pallas=False``, the JAX
    driver's default off a TPU), with its state layout, so a JAX state
    written on a CPU host loads into the port and back.

The engine and the device are separate choices: on a CUDA device the op
engine runs its ops there (and K3 for the waterfall, the port's waterfall
on every engine); on the CPU the kernel engine runs the kernels' plain
versions.
"""

from __future__ import annotations

KERNEL = "kernel"
OP = "op"
ENGINES = (KERNEL, OP)


def resolve(engine: str = KERNEL) -> str:
    """``engine`` checked: one of ENGINES, else ValueError."""
    if engine not in ENGINES:
        raise ValueError(f"engine {engine!r}: expected one of "
                         f"{', '.join(ENGINES)}")
    return engine

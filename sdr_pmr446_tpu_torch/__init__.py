"""PyTorch + CUDA port of the PMR446 scanner (sdr_pmr446_tpu).

The JAX package ``sdr_pmr446_tpu`` is the reference; this package mirrors
its sub-package layout (``ops/``, ``kernels/``, ``scanner/``, ``runtime/``,
``apps/``) so each module's counterpart sits at the same path.  It imports
``torch`` and never ``jax``, and nothing of the reference package: it keeps
its own copies of the JAX-free modules it needs (``config``,
``taps/design``, ``io/iq``, ``io/synth``, ``io/wav``, ``oracle/chain``).

Every entry point (``ScannerDriver``, ``ScannerChain``, ``DsdInChain``,
``SingleChannelChain`` and the CLIs) runs on the CUDA card unless the caller
passes ``device="cpu"``; with no card the default raises.

The TPU kernels on the scanner's main path are hand-written CUDA C++ for
Hopper (``csrc/*.cu``, built by ``kernels/build.py``); every kernel wrapper
keeps a plain PyTorch version beside it, which is what runs for CPU
tensors.

Importing the package applies the f32 policy of ``precision.py`` (TF32
off for cuBLAS matmuls and cuDNN convolutions); the chain checks it.
"""

from sdr_pmr446_tpu_torch import precision as _precision

__version__ = "0.1.0"

_precision.apply()

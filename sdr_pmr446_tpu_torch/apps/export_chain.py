"""export_chain — export a chain's block step with torch.export (.pt2).

Counterpart of sdr_pmr446_tpu/apps/export_chain.py.  The block step
((state, wire[, params]) -> (state', outputs)) is traced once at fixed
shapes by ``torch.export.export`` and saved with ``torch.export.save``;
``load`` gives it back as a module that runs with no chain built, in a
process that imports this module and nothing else of the package:

    python -m sdr_pmr446_tpu_torch.apps.export_chain --config scanner \\
        -k 40 --input-format cu8 --out scanner_k40.pt2 [--device cuda]

    from sdr_pmr446_tpu_torch.apps import export_chain
    step = export_chain.load("scanner_k40.pt2")
    state, outputs = step(state, wire, params)

On the kernel engine (``--engine kernel``, the default) the artifact
calls the hand-written kernels as the ``torch.library`` custom ops
``sdr_pmr446::duo`` (K1), ``::audio_bank`` (K2), ``::waterfall`` (K3,
``-w``) and ``::mono`` (K4, dsd and single), which the kernel modules
register when they are imported: on the card their CUDA launches, on the
CPU their plain versions.  ``--engine op`` exports the JAX op engine's
plain ops, which is what the JAX artifact holds (JAX exports
``use_pallas=False``).  An ExportedProgram holds its tables as constants
on the device it was exported on, so one artifact serves one device.

Importing this module registers what a process that loads an artifact
needs, as the JAX module does: the state, params and output NamedTuples
under stable wire names (``sdr_pmr446_tpu_torch.<Name>``, with the pytree
and with ``torch.load``'s safe globals, so ``torch.export.load`` stays on
its ``weights_only`` path), the custom ops, and the TF32-off precision
policy (precision.py), which no chain's constructor sets in a process
that builds none.

Round trips against the live chains are test-enforced
(tests/test_torch_export.py; chip_smoke.py phase 20 on the card).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

import torch
import torch.utils._pytree as pytree
from torch import nn

from sdr_pmr446_tpu_torch import config as C
from sdr_pmr446_tpu_torch import precision
# imported for the custom ops they register
from sdr_pmr446_tpu_torch.kernels import (audio_bank, chan_tail,  # noqa: F401
                                          duo, waterfall)
from sdr_pmr446_tpu_torch.runtime.state import ScannerState
from sdr_pmr446_tpu_torch.scanner.chain import (RuntimeParams, ScannerChain,
                                                StepOutputs,
                                                make_runtime_params)
from sdr_pmr446_tpu_torch.scanner.dsd_in import (DsdInChain, DsdOpState,
                                                 DsdState)
from sdr_pmr446_tpu_torch.scanner.single import (SingleChannelChain,
                                                 SingleOpState, SingleState)

#: the NamedTuples an artifact's inputs and outputs are made of (the dsd
#: step returns its PCM as one tensor, so it has no outputs class)
NAMEDTUPLES = (ScannerState, RuntimeParams, StepOutputs, DsdState,
               DsdOpState, SingleState, SingleOpState)


def register_serializations() -> None:
    """Register NAMEDTUPLES for torch.export's serializer and for
    ``torch.load``'s weights-only unpickler.  Needed on both sides:
    exporting, and any process that loads an artifact (importing this
    module is enough).  The names are stable wire identifiers: never
    change them once artifacts exist."""
    for cls in NAMEDTUPLES:
        name = f"sdr_pmr446_tpu_torch.{cls.__name__}"
        if cls in pytree.SUPPORTED_SERIALIZED_TYPES:
            continue                    # already registered in this process
        pytree._register_namedtuple(cls, serialized_type_name=name)
    torch.serialization.add_safe_globals(list(NAMEDTUPLES))


register_serializations()
precision.apply()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="export_chain",
        description="export a chain step with torch.export (.pt2, PyTorch "
                    "+ CUDA port)")
    p.add_argument("--config", choices=["scanner", "dsd", "single"],
                   default="scanner")
    p.add_argument("-k", "--subchunks-per-step", type=int, default=10)
    p.add_argument("--out", type=str, required=True,
                   help="the .pt2 file to write")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to export on: 'cuda' (the CUDA "
                        "kernels) or 'cpu' (their plain versions).  The "
                        "artifact holds its tables on this device and "
                        "serves it alone (JAX's --platforms has no "
                        "counterpart; without a CUDA device the default "
                        "exits 1)")
    p.add_argument("--engine", choices=["kernel", "op"], default="kernel",
                   help="kernel: the hand-written kernels as custom ops "
                        "(the default); op: plain PyTorch ops, the JAX op "
                        "engine, which the JAX artifact holds")
    p.add_argument("--lowpass", action="store_true")
    p.add_argument("--fir-deemph", action="store_true")
    p.add_argument("-w", "--waterfall", type=int, default=0)
    p.add_argument("--input-format", default="cf32",
                   choices=["cf32", "cs16", "cu8", "cs8"],
                   help="the raw wire words decoded on the device: the "
                        "scanner's, and dsd's with cu8 taken as cf32 (as "
                        "in JAX); single takes cf32")
    p.add_argument("--channel", type=int, default=5,
                   help="single config: fixed channel")
    return p


class ExportStep(nn.Module):
    """A chain's block step as a module: its tables are the buffers of the
    chain's modules (or lifted constants), ``forward`` is ``chain.step``."""

    def __init__(self, chain):
        super().__init__()
        self.parts = nn.ModuleDict(
            {"chain": chain} if isinstance(chain, nn.Module) else
            {name: m for name, m in vars(chain).items()
             if isinstance(m, nn.Module)})
        self.step = chain.step

    def forward(self, *args):
        return self.step(*args)


def build_chain(ns):
    """-> (chain, example args of its step), as JAX build_exported builds
    them: the zero state, a zero wire and (scanner) the runtime params."""
    k = ns.subchunks_per_step
    if ns.config == "scanner":
        chain = ScannerChain(
            C.BlockConfig(k), lowpass=ns.lowpass, fir_deemph=ns.fir_deemph,
            waterfall=ns.waterfall, input_format=ns.input_format,
            device=ns.device, engine=ns.engine)
        params = make_runtime_params(C.ScannerArgs(
            lowpass=ns.lowpass, waterfall=ns.waterfall,
            fir_deemph=ns.fir_deemph), chain.device)
        extra = (params,)
    elif ns.config == "dsd":
        chain = DsdInChain(k, input_format=(ns.input_format
                                            if ns.input_format != "cu8"
                                            else "cf32"),
                           device=ns.device, engine=ns.engine)
        extra = ()
    else:
        chain = SingleChannelChain(ns.channel, k, device=ns.device,
                                   engine=ns.engine)
        extra = ()
    wire = torch.zeros(chain.step_arg_len, dtype=torch.uint8,
                       device=chain.device)
    return chain, (chain.init_state(), wire) + extra


def export_step(chain, args) -> torch.export.ExportedProgram:
    """The chain's step traced at the shapes of ``args``, no dim dynamic."""
    return torch.export.export(ExportStep(chain), args, strict=False)


def load(path: str) -> nn.Module:
    """The step an artifact holds, as a module:
    ``step(state, wire[, params]) -> (state', outputs)``."""
    return torch.export.load(path).module()


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    ns = build_parser().parse_args(argv)
    try:
        chain, args = build_chain(ns)
    except (ValueError, RuntimeError) as e:
        logging.error("%s", e)
        return 1
    t0 = time.perf_counter()
    ep = export_step(chain, args)
    t_export = time.perf_counter() - t0
    # the zero example inputs (the wire alone is 8-13 MB at K = 16-40)
    # tell a loader nothing that the graph's signature does not
    ep.example_inputs = None
    torch.export.save(ep, ns.out)
    logging.info("exported %s step (K=%d, %s engine) on %s in %.2f s -> %s "
                 "(%d bytes)", ns.config, ns.subchunks_per_step,
                 chain.engine, chain.device, t_export, ns.out,
                 os.path.getsize(ns.out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

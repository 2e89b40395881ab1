"""The port stands alone: it imports neither JAX nor the JAX package.

The card's machine has no JAX, and the port keeps its own copies of the
JAX-free modules it needs.  An AST scan of every module of
``sdr_pmr446_tpu_torch``, of ``chip_smoke.py`` and of ``kernel_times.py``
(the card's scripts) rejects any import of
``jax`` or ``sdr_pmr446_tpu`` (the ``_torch`` package itself is allowed);
a fresh interpreter that imports every module of the port must not have
either in ``sys.modules``.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "sdr_pmr446_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "sdr_pmr446_tpu")


def port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "kernel_times.py"]


def port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def imported_names(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


@pytest.mark.parametrize("path", port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_nothing_of_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [f"{path.name}:{line}: {name}"
           for line, name in imported_names(tree) if forbidden(name)]
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {port_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'sdr_pmr446_tpu'))\n"
            "print(len(bad), bad)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split()[0] == "0", res.stdout

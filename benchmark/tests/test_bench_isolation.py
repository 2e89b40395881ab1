"""Nothing the benchmark runs imports JAX or the JAX package, by whole
top-level names, and the reference imports nothing of the program."""

import _paths

import ast
import subprocess
import sys

import pytest

from benchlib import isolation

SOURCES = sorted(p for p in _paths.BENCH.rglob("*.py")
                 if "tests" not in p.parts)
#: the plain reference and what it loads
REFERENCE = [_paths.BENCH / "references" / "scanner16.py",
             _paths.BENCH / "benchlib" / "design.py"]


def imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_top_level_names_compared_whole():
    assert isolation.found(["sdr_pmr446_tpu_torch.scanner.chain", "numpy",
                            "jax_like", "flaxen"]) == []
    assert isolation.found(["sdr_pmr446_tpu.ops", "jax", "jaxlib.xla",
                            "flax.linen"]) == ["flax.linen", "jax",
                                               "jaxlib.xla",
                                               "sdr_pmr446_tpu.ops"]
    assert isolation.found(["sdr_pmr446_tpu_torch"],
                           (isolation.PROGRAM,)) == ["sdr_pmr446_tpu_torch"]


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(_paths.ROOT)))
def test_sources_import_no_jax(path):
    bad = [n for n in imports(path)
           if isolation.top_level(n) in isolation.FORBIDDEN]
    assert not bad


@pytest.mark.parametrize("path", REFERENCE,
                         ids=lambda p: str(p.relative_to(_paths.ROOT)))
def test_reference_imports_nothing_of_the_program(path):
    assert not [n for n in imports(path)
                if isolation.top_level(n) == isolation.PROGRAM]


def test_loaded_modules_in_a_fresh_interpreter():
    """Every benchmark module imported, the reference alone first: no JAX
    anywhere, and nothing of the program after the reference."""
    code = f"""
import sys
sys.path[:0] = [{str(_paths.BENCH)!r}, {str(_paths.ROOT)!r}]
from benchlib import isolation, spec
spec.module("references", "scanner16")
assert not isolation.found(forbidden=(isolation.PROGRAM,)), \\
    isolation.found(forbidden=(isolation.PROGRAM,))
for kind in ("entries", "metrics", "references"):
    for p in sorted((spec.BENCH_DIR / kind).glob("*.py")):
        spec.module(kind, p.stem)
import run, calibrate
import sdr_pmr446_tpu_torch.runtime.driver
print(",".join(isolation.found()))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""

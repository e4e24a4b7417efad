"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the measured program.  Names are compared by
their top-level part, whole: the port's name begins with the JAX package's."""
from __future__ import annotations

import ast
import subprocess
import sys

from benchmark.run import FORBIDDEN
from benchmark.tests.conftest import REPO

PORT = "vision_semantic_segmentation_tpu_torch"


def _imports(path):
    """Every module a file names in an import, at any depth, resolved to
    absolute names (relative imports inside ``benchmark``)."""
    tree = ast.parse(path.read_text())
    package = ".".join(path.relative_to(REPO).with_suffix("").parts[:-1])
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = package.split(".")[: len(package.split(".")) - node.level + 1]
                names.add(".".join(base + ([node.module] if node.module else [])))
            else:
                names.add(node.module)
    return names


def _sources():
    return [p for p in sorted((REPO / "benchmark").rglob("*.py")) if "tests" not in p.parts]


def test_whole_name_comparison():
    assert "vision_semantic_segmentation_tpu" in FORBIDDEN
    assert PORT.split(".")[0] not in FORBIDDEN


def test_nothing_imported_loads_jax():
    modules = sorted({n for p in _sources() for n in _imports(p)} - {"__future__"})
    code = ("import importlib, sys, runpy\n"
            f"sys.path.insert(0, {str(REPO)!r})\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "from benchmark.run import load_file_module\n"
            "from pathlib import Path\n"
            f"for p in Path({str(REPO / 'benchmark')!r}).glob('*/*.py'):\n"
            "    if p.parent.name in ('drivers', 'metrics'):\n"
            "        load_file_module('benchmark.' + p.parent.name + '.' + p.stem.replace('.', '_'), p)\n"
            "from benchmark.run import forbidden_modules\n"
            "print('FOUND', forbidden_modules(), len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUND [] " in out.stdout, out.stdout
    assert PORT in {n.split(".")[0] for n in modules}


def test_reference_imports_nothing_of_the_program():
    for path in sorted((REPO / "benchmark" / "reference").glob("*.py")):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in FORBIDDEN and top != PORT, (path.name, name)
            assert top in ("torch", "numpy", "math", "typing", "__future__", "benchmark"), name
            if top == "benchmark":
                assert name.startswith("benchmark.reference"), (path.name, name)

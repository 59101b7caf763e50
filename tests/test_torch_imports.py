"""Import hygiene of the PyTorch port: it imports neither jax nor the JAX
package ``repro``, at run time or in its source."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]

CHILD = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
from repro_torch.launch import train
trainer = train.main(["--arch", "bert-large", "--smoke", "--batch", "4", "--seq", "16",
                      "--fused-lamb", "--no-flash", "--steps", "1",
                      "--device", "cpu"])
assert trainer.state.step == 1
import repro_torch.serve
from repro_torch.launch import serve
out = serve.main(["--arch", "smollm-360m", "--smoke", "--requests", "2", "--prompt-len", "4",
                  "--max-new", "2", "--continuous", "--device", "cpu"])
assert [r.status.value for r in out] == ["completed"] * 2
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print("MODULES", len(names), "BAD", bad)
"""


def test_port_runs_a_step_without_importing_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", CHILD], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("MODULES")][-1]
    assert line.endswith("BAD []"), line
    assert int(line.split()[1]) >= 25  # every module of the package was imported


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax_or_repro(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"
    text = path.read_text()
    assert "import jax" not in text and "from repro." not in text

"""What the benchmark imports: no module that ``portbench`` runs has jax,
jaxlib, flax, lcgan_tpu, bench, chip_smoke or tools as its top-level name,
compared whole (``lcgan_torch`` is not ``lcgan_tpu``), and the reference
imports nothing of the port."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.relative_to(HERE).parts)


def _imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_banned_top_level_name(path):
    assert not _imported(path) & set(harness.BANNED)


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "lcgan_torch" not in _imported(path)


def test_top_level_names_are_compared_whole():
    planted = ("lcgan_tpux", "jax_probe", "toolsy", "jax.probe")  # only the last has a banned top-level name
    for name in planted:
        sys.modules[name] = sys
    try:
        found = harness.banned_modules()
        assert "jax.probe" in found and not set(planted[:3]) & set(found)
    finally:
        for name in planted:
            del sys.modules[name]


def test_a_run_loads_no_banned_module():
    """Everything a run imports, in a fresh process: the harness, both
    drivers' imports of the port, the reference and the readers."""
    code = (
        "import sys, portbench.run, portbench.harness as h, portbench.control, portbench.work\n"
        "import lcgan_torch.train.loop, lcgan_torch.train.steps, lcgan_torch.gen.artifacts, lcgan_torch.config\n"
        "for p in sorted((h.HERE / 'drivers').glob('*.py')) + sorted((h.HERE / 'metrics').glob('*.py')):\n"
        "    h.load_module(p, 'm_' + p.stem.replace('.', '_'))\n"
        "print(h.banned_modules())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"

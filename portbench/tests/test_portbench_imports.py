"""What the benchmark imports: no module whose top-level name (the part
before the first dot, compared whole) is jax, jaxlib, flax or giga_tpu,
anywhere in portbench or in the program modules a run loads; and nothing of
the program (giga_tpu_torch) in the reference."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "giga_tpu"}
FILES = sorted(HERE.rglob("*.py"))


def imported(path: Path) -> set:
    """Full names of the modules a source file imports (relative imports
    resolved within portbench)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = path.relative_to(ROOT).with_suffix("").parts[:-node.level]
                names.add(".".join(base + ((node.module,) if node.module else ())))
            else:
                names.add(node.module)
    return names


def top(name: str) -> str:
    return name.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_imports_jax_flax_or_the_jax_package(path):
    assert not {top(n) for n in imported(path)} & FORBIDDEN


def test_top_level_names_are_compared_whole():
    assert top("giga_tpu_torch.models") == "giga_tpu_torch" not in FORBIDDEN
    assert top("giga_tpu.models") in FORBIDDEN


def _closure(start: Path) -> set:
    """The portbench files ``start`` reaches by imports, and every module
    name they import."""
    seen, names, todo = set(), set(), [start]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for name in imported(path):
            names.add(name)
            if top(name) == "portbench":
                target = ROOT.joinpath(*name.split("."))
                for cand in (target.with_suffix(".py"), target / "__init__.py"):
                    if cand.is_file():
                        todo.append(cand)
    return names


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    reached = {top(n) for n in _closure(path)}
    assert "giga_tpu_torch" not in reached and not reached & FORBIDDEN


def test_a_run_loads_no_forbidden_module():
    """The modules a run of each cell loads, in a fresh interpreter."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import portbench.run, portbench.calibrate\n"
        "import portbench.reference.judge, portbench.reference.recon\n"
        "ref = {m for m in sys.modules if m.split('.')[0] == 'giga_tpu_torch'}\n"
        "from pathlib import Path\n"
        "for kind in ('drivers', 'metrics'):\n"
        "    for p in sorted(Path(%r, kind).glob('*.py')):\n"
        "        portbench.run.load_module(p)\n"
        "import giga_tpu_torch.inference.planner, giga_tpu_torch.inference.serving\n"
        "import giga_tpu_torch.models.registry, giga_tpu_torch.geometry.generation\n"
        "print(sorted(ref), portbench.run.forbidden_modules())\n"
    ) % (str(ROOT), str(HERE))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] []"


def test_forbidden_modules_reads_sys_modules(monkeypatch):
    sys.path.insert(0, str(ROOT))
    from portbench import run as harness

    monkeypatch.setitem(sys.modules, "flax.core", object())
    monkeypatch.setitem(sys.modules, "giga_tpu_torchx", object())
    assert harness.forbidden_modules() == ["flax"]

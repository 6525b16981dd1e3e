"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program; names are compared whole, by the
part before the first dot (the port's name begins with the JAX package's)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import run

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "perfbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "spatialthinker_tpu"}
# what the reference imports of the benchmark: besides it, plain PyTorch and NumPy
REFERENCE = [PKG / "reference" / "qwen2_5_vl.py", PKG / "reference" / "grpo.py", PKG / "check.py",
             PKG / "weights.py"]


def _top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


@pytest.mark.parametrize("path", sorted(p for p in PKG.rglob("*.py") if "tests" not in p.parts),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_on_the_run_path(path):
    assert not _top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert _top_level_imports(path) <= {"__future__", "math", "json", "pathlib", "typing", "numpy", "torch"}


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r); import perfbench.run, perfbench.train_phase, "
            "perfbench.calibrate; from perfbench.train_phase import build_program; "
            "import spatialthinker_torch.trainer.grpo_trainer; "
            "print(sorted({m.split('.', 1)[0] for m in sys.modules} & %r))" % (str(ROOT), FORBIDDEN))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxfoo", object())
    monkeypatch.setitem(sys.modules, "spatialthinker_tpu_extra", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_modules() == ["jax"]

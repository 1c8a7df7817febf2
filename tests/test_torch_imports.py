"""The port stands alone: ``src/repro_torch/**``, ``chip_smoke.py`` and
``chip_sweep.py`` import neither ``jax`` nor anything of the JAX package ``repro`` (the
machine with the card has no JAX), nor ``msgpack`` (nor has it that: the
checkpoints' encoder is the port's own). Checked on the source, with ``ast``:
import statements, ``import_module``/``__import__`` calls with a constant
name, and every string constant that is a whole dotted ``repro`` module
path, which a lazy import map (``{"name": "pkg.module"}``) would hand to
``import_module`` at run time."""
import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py", ROOT / "chip_sweep.py"]
FORBIDDEN = ("jax", "jaxlib", "repro", "msgpack")
MODULE_PATH = re.compile(r"^repro(\.\w+)+$")


def _imported_packages(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]
        elif (isinstance(node, ast.Constant) and isinstance(node.value, str)
              and MODULE_PATH.match(node.value)):
            yield node.value.split(".")[0]


def test_the_port_has_modules():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert "src/repro_torch/kernels/flash_attention.py" in names
    assert "src/repro_torch/serving/engine.py" in names
    assert "src/repro_torch/kernels/rglru_scan.py" in names
    assert "src/repro_torch/models/rglru.py" in names
    assert "src/repro_torch/deploy/runner.py" in names
    assert "src/repro_torch/launch/experiment.py" in names
    for module in ("training/__init__.py", "training/optimizer.py",
                   "training/train_loop.py", "training/data.py",
                   "training/checkpoint.py", "training/tree.py",
                   "launch/train.py"):
        assert f"src/repro_torch/{module}" in names
    assert (ROOT / "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
            ).exists()
    assert len(FILES) > 15


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_and_no_repro_imports(path):
    bad = sorted({p for p in _imported_packages(path) if p in FORBIDDEN})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("source,bad", [
    ('_LAZY = {"runner": "repro.deploy.runner"}', ["repro"]),
    ('import importlib\nimportlib.import_module("jax.numpy")', ["jax"]),
    ('from repro.core import tags', ["repro"]),
    ('_LAZY = {"runner": "repro_torch.deploy.runner"}', []),
    ('DOC = "see repro/deploy/runner.py and repro.deploy"', []),
])
def test_the_check_sees_lazy_module_paths(tmp_path, source, bad):
    path = tmp_path / "m.py"
    path.write_text(source)
    assert sorted({p for p in _imported_packages(path)
                   if p in FORBIDDEN}) == bad

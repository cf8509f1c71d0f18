"""The port must run on a machine with PyTorch and no JAX: no module of
``optwboundeigenval_tpu_torch/`` and not ``chip_smoke.py`` may import
``jax``, ``flax``, ``optax`` or anything of ``optwboundeigenval_tpu``
(whose ``__init__`` imports jax).  Checked statically, because this
test process has jax loaded already."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "optwboundeigenval_tpu")
FILES = sorted((ROOT / "optwboundeigenval_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_the_port_has_modules():
    assert len(FILES) > 20 and all(f.exists() for f in FILES)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported(tree)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"

"""What a run loads: no JAX, flax, optax or JAX package in a run of each
cell (at a toy size on the CPU, in a fresh process), and nothing of the
program in the reference."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from portbench.run import forbidden_modules

REPO = Path(__file__).resolve().parents[2]

RUN_CELLS = """
import json, sys, torch
sys.path.insert(0, {tests!r})
from conftest import toy
from portbench import harness
from portbench.run import forbidden_modules, result_line
torch.set_num_threads(1)
spec = harness.benchmark()
for cell in spec["workloads"]:
    for trace in (False, True):
        ctx = harness.run(cell["name"], 11, 0.2, trace, device="cpu", **toy(cell["name"]))
        result_line(ctx, spec, cell, trace)
print(json.dumps(forbidden_modules()))
"""


def test_runs_load_no_jax():
    out = subprocess.run([sys.executable, "-c", RUN_CELLS.format(tests=str(REPO / "portbench" / "tests"))],
                         cwd=REPO, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_names_are_compared_whole():
    assert forbidden_modules(["optwboundeigenval_tpu_torch", "optwboundeigenval_tpu_torch.ops",
                              "jaxtyping", "flax_like", "torch"]) == []
    assert forbidden_modules(["jax.numpy", "jaxlib", "flax.linen", "optax",
                              "optwboundeigenval_tpu.ops"]) == [
        "flax", "jax", "jaxlib", "optax", "optwboundeigenval_tpu"]


def test_reference_imports_nothing_of_the_program():
    allowed = {"__future__", "math", "typing", "torch", "portbench"}
    for path in sorted((REPO / "portbench" / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] in allowed, (path.name, name)
                if name.startswith("portbench"):
                    assert name.startswith("portbench.reference"), (path.name, name)
    code = ("import sys, portbench.reference.follow, portbench.reference.models; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'optwboundeigenval_tpu_torch', 'optwboundeigenval_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"

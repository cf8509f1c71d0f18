"""The plain reference against the program at toy sizes in float64 on
the CPU: the steps of both configurations and the audit batches, through
the benchmark's own run (``harness.run``), and the configurations'
recipes against the program's config modules."""

import importlib
import json
from pathlib import Path

import pytest
import torch

from conftest import toy
from portbench import harness

CELLS = ["dn40-step-b128", "dn40-audit-b128"]
# the chest x-ray configuration (Adam, W-BCE, the DenseNet-121 trunk),
# which no cell of the benchmark times yet
CXR = {
    "cxr121-step-b16": ({"name": "cxr121-step-b16", "config": "cxr121", "traffic": "step"},
                        {"rho": 1.0, "gradf": 1.0, "grad": 1.0, "change": 1.0, "bn": 1.0,
                         "v": 1.0}),
    "cxr121-audit-b16": ({"name": "cxr121-audit-b16", "config": "cxr121", "traffic": "audit"},
                         {"rho": 1.0, "bn": 1.0, "v": 1.0}),
}


@pytest.mark.parametrize("workload", CELLS + list(CXR))
def test_program_matches_reference_in_float64(workload):
    extra = dict(zip(("cell", "limits"), CXR[workload])) if workload in CXR else {}
    ctx = harness.run(workload, 2 ** 33 + 7, 0.5, False, device="cpu", dtype=torch.float64,
                      **toy(workload), **extra)
    assert ctx["correct"]
    assert ctx["units"] >= 1
    # float64 leaves room for rounding alone, but Adam (the chest x-ray
    # recipe) turns a gradient entry at rounding level into a whole step of
    # lr, so after three steps a leaf with such entries differs in change,
    # and the later steps' rho, taken at those parameters, follows it
    loose = {"change": 1e-3, "rho": 1e-6} if workload == "cxr121-step-b16" else {}
    for k in ctx["limits"]:
        assert ctx["numbers"][k] < loose.get(k, 1e-8), (k, ctx["numbers"])


@pytest.mark.parametrize("name", ["cxr121", "dn40"])
def test_recipe_is_the_program_config(name, tmp_path):
    """The reference's recipe (``configs/<name>.json``) is the program's
    config module's, with the cell's overrides."""
    cfg = json.loads((Path(harness.ROOT) / "configs" / f"{name}.json").read_text())
    mod = importlib.import_module(
        f"optwboundeigenval_tpu_torch.configs.{cfg['program']['config']}")
    opts = mod.options(device="cpu", **cfg["program"]["overrides"])
    r = cfg["recipe"]
    for key in ("mu", "K", "Kmin", "pow_iter_eps", "max_pow_iter", "remat"):
        assert opts.get(key, {"Kmin": 0.0}.get(key)) == r[key], key
    assert opts.get("ignore_bad_vals", True) == r["ignore_bad_vals"]
    assert opts.get("gradg_clip") == r["gradg_clip"]
    assert opts["loss"] == r["loss"]
    tr = harness.Program(cfg, "cpu", str(tmp_path), *_state(cfg), {}).tr
    spec = r["optimizer"]
    assert tr.optimizer.name.lower() == spec["name"]
    assert tr.opt_state["lr"] == spec["lr"]
    assert opts["batch_size"] == cfg["program"]["overrides"]["batch_size"]
    assert tr.ndim == cfg["parameters"]
    momenta = {m.momentum for m in tr.task.model.modules() if hasattr(m, "running_mean")}
    assert momenta == {r["bn_momentum"]}


def _state(cfg):
    from portbench.reference.models import Model

    model = Model(cfg["arch"])
    meta = torch.device("meta")
    return ({k: torch.empty(s, device=meta) for k, s, _ in model.leaves()},
            {k: torch.empty(s, device=meta) for k, s, _ in model.buffers()})

"""Recount each configuration's FLOPs a sample (``flops/__init__.py``):

    python3 -m portbench.flops.count [config ...]

prints, for each configuration file of ``configs/`` (or those named),
the FLOPs that ``torch.utils.flop_counter.FlopCounterMode`` counts in the
program's convolutions and matmuls for one sample at the configuration's
shapes: one ``gradient`` (``curvature.grad``), one product of the kept
gradient graph (``linearize_hvp``'s map), one ``remat`` product
(``curvature.hvp``), one ``vghv`` and one train-mode ``forward``
(``Task.train_loss``).  It runs the program's own functions on the meta
device, so it needs no card and computes nothing.
"""

from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def count(cfg: dict) -> dict:
    from portbench import harness
    from portbench.reference.models import Model
    from optwboundeigenval_tpu_torch.ops import curvature

    model = Model(cfg["arch"])
    meta = torch.device("meta")
    params = {k: torch.empty(s, device=meta) for k, s, _ in model.leaves()}
    state = {k: torch.empty(s, device=meta) for k, s, _ in model.buffers()}
    with tempfile.TemporaryDirectory() as tmp:
        tr = harness.Program(cfg, "cpu", tmp, params, state, {}).tr
    task = tr.task
    data = cfg["data"]
    batch = {"x": torch.empty((1, *data["shape"]), device=meta),
             "y": (torch.empty((1, data["classes"]), device=meta) if data["labels"] == "multilabel"
                   else torch.zeros(1, dtype=torch.long, device=meta)),
             "w": torch.ones(1, device=meta)}
    loss_fn = task.loss_fn(state)
    v = {k: torch.empty_like(p) for k, p in params.items()}
    _, hvp_kept = curvature.linearize_hvp(loss_fn, params, batch)
    runs = {
        "gradient": lambda: curvature.grad(loss_fn, params, batch),
        "hvp_kept": lambda: hvp_kept(v),
        "hvp_remat": lambda: curvature.hvp(loss_fn, params, batch, v),
        "vghv": lambda: curvature.vghv(loss_fn, params, batch, v),
        "forward": lambda: task.train_loss(params, state, batch),
    }
    out = {}
    for name, fn in runs.items():
        with FlopCounterMode(display=False) as fc:
            fn()
        out[name] = int(fc.get_total_flops())
    return out


def main(argv) -> int:
    names = argv or sorted(p.stem for p in CONFIGS.glob("*.json"))
    for name in names:
        cfg = json.loads((CONFIGS / f"{name}.json").read_text())
        print(name, json.dumps(count(cfg)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

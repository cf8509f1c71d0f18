"""Readings that set the limits of ``limits/<workload>.json``:

    python3 -m portbench.control --workload <name> --mode <mode> --seeds <n> ... [--seconds s]

``--mode program``: runs of the cell (``harness.run``, ``--seconds`` each)
on every seed, in one process: the lower readings.

``--mode tf32``: the control.  The reference is put in the program's
place and computed in TF32 (cuDNN and cuBLAS), the precision below the
configuration's float32 with TF32 off; the float32 reference judges it
by the same numbers, on the same inputs as a run of the seed: the first
units from the benchmark's start, then ``check_units`` single units,
each from the control's own state before it, as a run samples its
window.

``--mode half_batch``: a fault.  The reference in the program's place
takes every step (or audit batch) on the first half of the batch's rows,
the mean over those alone.

The other faults need no run: a step that returns its state unchanged
moves no parameter, and ``change`` reads 1 (``bn`` too).

Each seed prints one JSON line ``{"seed", "mode", "numbers"}``.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from portbench import check, generate, harness
from portbench.reference.follow import follow
from portbench.reference.models import Model


def _inputs(name: str, seed: int, device: str, dtype=torch.float32):
    w = harness.workload(name)
    cfg, traffic = harness.load("configs", w["config"]), harness.load("traffic", w["traffic"])
    model = Model(cfg["arch"])
    gen = generate.generator(seed, device)
    params, state = generate.make_state(model, gen, device, dtype)
    batches = generate.make_batches(cfg["data"], cfg["program"]["overrides"]["batch_size"],
                                    traffic["distinct_batches"], gen, device, dtype)
    batches = [harness.ref_batch(b, device, dtype) for b in batches]
    return cfg, traffic, model, params, state, batches


def _half(batch: dict) -> dict:
    n = len(batch["x"]) // 2
    return {k: t[:n] for k, t in batch.items()}


def _as_program(mode: str, fn):
    """``fn()`` as the program in ``mode``: in TF32, or on half batches."""
    torch.backends.cudnn.allow_tf32 = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = mode == "tf32"
    try:
        return fn()
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def control(name: str, seed: int, mode: str, device: str = "cuda") -> dict:
    cfg, traffic, model, params, state, batches = _inputs(name, seed, device)
    limits = harness.load("limits", name)
    hp, n, margin = cfg["recipe"], traffic["follow_steps"], traffic["margin"]
    own = (lambda bs: [_half(b) for b in bs]) if mode == "half_batch" else (lambda bs: bs)
    train = traffic["entry"] == "step"
    numbers_of = check.step_numbers if train else (
        lambda p, r, a, s: check.audit_numbers(p, r, s))
    prog = _as_program(mode, lambda: follow(model, hp, params, state, own(batches[:n]),
                                            train=train)[0])
    refs = follow(model, hp, params, state, batches[:n], train=train, margin=margin)
    readings = [check.best_path(prog, refs, lambda p, r: numbers_of(p, r, params, state),
                                limits)]
    for j in range(traffic["check_units"]):
        b = batches[(n + j) % len(batches)]
        start = prog
        kw = {"v0": start["v"], "opt0": start["opt"]}
        prog = _as_program(mode, lambda: follow(model, hp, start["params"], start["state"],
                                                own([b]), train=train, **kw)[0])
        refs = follow(model, hp, start["params"], start["state"], [b], train=train,
                      margin=margin, **kw)
        readings.append(check.best_path(
            prog, refs, lambda p, r: numbers_of(p, r, start["params"], start["state"]),
            limits))
    return check.merge(readings)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m portbench.control")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--mode", choices=("program", "tf32", "half_batch"), required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=5.0)
    args = parser.parse_args(argv)
    for seed in args.seeds:
        if args.mode == "program":
            ctx = harness.run(args.workload, seed, args.seconds, False)
            numbers = ctx["numbers"]
            extra = {"iters": ctx["iters"], "units": ctx["units"], "window_s": ctx["window_s"],
                     "setup_s": ctx["setup_s"], "peak_bytes": ctx["peak_bytes"],
                     "setup_parts": ctx["setup_parts"], "followed_iters": ctx["followed_iters"]}
        else:
            numbers, extra = control(args.workload, seed, args.mode), {}
        print(json.dumps({"seed": seed, "mode": args.mode, "numbers": numbers, **extra}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

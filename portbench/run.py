"""The benchmark's command:

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number with its limit,
which also close standard error.  Without CUDA, with fewer cards than
the cell asks for, or where JAX, flax, optax or the JAX package is
loaded once the window has closed, it exits with 1 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "optwboundeigenval_tpu"}


def forbidden_modules(names=None):
    """Top-level names of loaded modules (the part before the first dot,
    compared whole) that the benchmark must not have loaded."""
    names = list(sys.modules) if names is None else names
    return sorted({name.split(".")[0] for name in names} & FORBIDDEN)


def result_line(ctx: dict, spec: dict, cell: dict, trace: bool) -> dict:
    import torch

    from portbench.harness import reading

    listed = spec["per_layer"] if trace else spec["end_to_end"]
    metrics = {}
    for m in listed:
        if "workloads" in m and cell["name"] not in m["workloads"]:
            continue
        value = reading(m["name"], ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    cuda = torch.cuda.is_available()
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": cell["chips"], "memory_peak_bytes": ctx["memory_peak_bytes"]}
    line = {"correct": ctx["correct"], "attempted": ctx["units"], "failed": 0,
            "metrics": metrics, "device": device}
    prof = ctx["profile"]
    if trace and prof:
        device["busy_s"], device["window_s"] = prof["busy_s"], prof["wall_s"]
        ops = sorted(prof["kernels"].items(), key=lambda kv: -kv[1][1])[:10]
        gaps = sorted(prof["idle_by_span"].items(), key=lambda kv: -kv[1])[:10]
        line["breakdown"] = {"device_ops": [[k[:160], s] for k, (_, s) in ops],
                             "idle_gaps": [[k, s] for k, s in gaps]}
    # a number that cannot be read (one side discarded its rho) prints as
    # the largest float, which fails every limit, and keeps the line JSON
    line["checks"] = {k: {"value": min(ctx["numbers"][k], sys.float_info.max), "limit": lim}
                      for k, lim in ctx["limits"].items()}
    return line


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m portbench.run")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    # the program's build and kernel caches, at fixed paths in the checkout
    build = Path(__file__).resolve().parents[1] / "build" / "portbench"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))

    import torch

    from portbench import harness

    # one process with few threads: the host's share of a unit is one
    # thread's dispatch, and an idle pool's spinning takes cores from it
    torch.set_num_threads(1)
    spec = harness.benchmark()
    cell = harness.workload(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    ctx = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), t_start=T_START)
    line = result_line(ctx, spec, cell, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}; no result", file=sys.stderr)
        return 1
    print(f"portbench: set-up {ctx['setup_parts']}, followed units' products "
          f"{ctx['followed_iters']}, window products {ctx['iters']}", file=sys.stderr)
    if ctx["missing"]:
        print(f"portbench: span targets not found: {ctx['missing']}", file=sys.stderr)
    if ctx["profile"]:
        p = ctx["profile"]
        print(f"portbench: profiled {p['units']} units: wall {p['wall_s']!r} s, busy "
              f"{p['busy_s']!r} s, {p['launches']} launches, first device event "
              f"{p['clock_offset_s']!r} s after the host's start", file=sys.stderr)
    print(f"portbench: compared at {ctx['numbers'].get('worst_leaf')}", file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

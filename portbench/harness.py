"""One run of a cell: set-up, the measured window, the comparison with
the reference, and the metrics (``run.py`` is the command).

Everything of a cell is found by name from ``BENCHMARK.json``: the
configuration in ``configs/<config>.json``, the traffic in
``traffic/<traffic>.json``, the limits in ``limits/<workload>.json``,
each per-layer metric's reader in ``metrics/<name before the first
dot>.py`` and the spans in ``spans/``.

Set-up builds the program's trainer as its entry does
(``driver.build_trainer(<config>.options(...))``, TF32 off through
``utils/precision.set_tf32(False)``), makes the weights, running
statistics and batches from the seed on the device (``generate.py``),
hands the program copies, and drives its first ``follow_steps`` units
through the window's own call: ``train_step(batch, fetch=False)`` (traffic
``step``) or ``rho_test(loader=...)`` (traffic ``audit``), on distinct
batches.  They warm the carried eigenvector and every kernel, and they
are what the reference follows.  A step traffic's ``warmup_steps`` more
steps follow.

The window runs units on the batches after those, cycling over the set
only where it outruns it, until ``seconds`` have passed, and
synchronises.  An audit window is one ``rho_test`` call whose loader
yields batches until the time is up.  Either window keeps the program's
state before and after ``check_units`` of its units, drawn from the seed
by a reservoir, for the reference to follow from.  After the window the
peak memory is read, the program is freed, and the reference runs.
"""

from __future__ import annotations

import copy
import gc
import importlib
import json
import math
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import check, generate
from portbench.reference.follow import follow
from portbench.reference.models import Model

ROOT = Path(__file__).resolve().parent


def load(kind: str, name: str) -> dict:
    return json.loads((ROOT / kind / f"{name}.json").read_text())


def benchmark() -> dict:
    return json.loads((ROOT.parent / "BENCHMARK.json").read_text())


def workload(name: str) -> dict:
    for w in benchmark()["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def ref_batch(batch: dict, device, dtype) -> dict:
    return {"x": batch["x"], "y": batch["y"], "w": torch.as_tensor(batch["w"], device=device,
                                                                    dtype=dtype)}


class Program:
    """The program's trainer, built as the port's entry builds it, holding
    copies of the benchmark's weights and running statistics."""

    def __init__(self, cfg: dict, device, tmp: str, params, state, options: dict):
        from optwboundeigenval_tpu_torch.train import driver
        from optwboundeigenval_tpu_torch.utils import precision
        from optwboundeigenval_tpu_torch.utils.tree import tree_uniform_like

        prog = cfg["program"]
        mod = importlib.import_module(f"optwboundeigenval_tpu_torch.configs.{prog['config']}")
        opts = mod.options(device=str(device), log_dir=f"{tmp}/logs", model_dir=f"{tmp}/models",
                           **{**prog["overrides"], **options})
        precision.set_tf32(False)
        tr = driver.build_trainer(opts)
        names = {k: tuple(p.shape) for k, p in tr.task.model.named_parameters()}
        bufs = {k: tuple(b.shape) for k, b in tr.task.model.named_buffers()}
        ours = {k: tuple(p.shape) for k, p in params.items()}
        ours_b = {k: tuple(b.shape) for k, b in state.items()}
        if names != ours or bufs != ours_b:
            diff = sorted(set(names.items()) ^ set(ours.items()) | set(bufs.items()) ^ set(ours_b.items()))
            raise RuntimeError(f"the program's parameters are not the reference's: {diff[:6]}")
        tr.params = {k: params[k].clone() for k in names}
        tr.model_state = {k: state[k].clone() for k in bufs}
        tr.opt_state = tr.optimizer.init(tr.params)
        tr.v = tree_uniform_like(tr.params)
        self.tr = tr

    def rho_csv(self) -> np.ndarray:
        """The rows ``rho_test`` wrote for its last call: batch, rho, norm,
        iters, res_change, seconds."""
        path = Path(self.tr.log_dir) / f"{self.tr.header2}_rho_test.csv"
        return np.loadtxt(path, delimiter=",", ndmin=2)


class Reservoir:
    """``keep`` items of a stream, drawn uniformly by a reservoir from
    ``rng``."""

    def __init__(self, keep: int, rng: np.random.Generator):
        self.keep, self.rng = keep, rng
        self.kept: List[dict] = []
        self.seen = 0

    def offer(self, item: dict) -> bool:
        """Whether ``item``, the stream's next, is kept (for now)."""
        j, self.seen = self.seen, self.seen + 1
        if len(self.kept) < self.keep:
            self.kept.append(item)
            return True
        r = int(self.rng.integers(0, j + 1))
        if r < self.keep:
            self.kept[r] = item
            return True
        return False


def _held(tr):
    """What keeps the trainer's state as it is: the trees themselves, as a
    step commits new ones, or copies where it writes into the old (the
    trainer's ``donate``)."""
    return copy.deepcopy if tr.donate else (lambda tree: tree)


class WindowLoader:
    """Batches from ``start`` on, cycling, until ``deadline``; keeps the
    trainer's state before and after the batches that ``pool`` keeps."""

    def __init__(self, tr, batches: List[dict], start: int, deadline: float, pool: Reservoir):
        self.tr, self.batches, self.start, self.deadline = tr, batches, start, deadline
        self.pool, self.hold = pool, _held(tr)
        self.count = 0

    def _finish(self, j: int) -> None:
        for item in self.pool.kept:
            if item["j"] == j:
                item["v_out"], item["state_out"] = self.hold(self.tr.v), self.hold(
                    self.tr.model_state)

    def __iter__(self):
        j = 0
        while j == 0 or time.perf_counter() < self.deadline:
            self._finish(j - 1)
            item = {"j": j, "batch": (self.start + j) % len(self.batches),
                    "v_in": self.tr.v, "state_in": self.tr.model_state}
            if self.pool.offer(item):
                item["v_in"], item["state_in"] = self.hold(item["v_in"]), self.hold(
                    item["state_in"])
            self.count = j + 1
            yield self.batches[item["batch"]]
            j += 1

    def close(self) -> None:
        self._finish(self.count - 1)


def run(name: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
        dtype=torch.float32, t_start: Optional[float] = None, options: Optional[dict] = None,
        arch: Optional[dict] = None, data: Optional[dict] = None,
        batch_size: Optional[int] = None, cell: Optional[dict] = None,
        limits: Optional[dict] = None) -> dict:
    """One run of the cell ``name``; returns the metrics' context (``ctx``)
    with ``numbers``, ``limits`` and ``correct``.  ``options``, ``arch``,
    ``data``, ``batch_size``, and ``cell`` and ``limits`` for a cell that
    ``BENCHMARK.json`` does not list, replace the benchmark's (small cells
    for the tests on the CPU)."""
    t_start = time.perf_counter() if t_start is None else t_start
    w = cell or workload(name)
    cfg, traffic = load("configs", w["config"]), load("traffic", w["traffic"])
    limits = limits or load("limits", name)
    arch = arch or cfg["arch"]
    data = data or cfg["data"]
    batch_size = batch_size or cfg["program"]["overrides"]["batch_size"]
    options = dict(options or {})
    if batch_size != cfg["program"]["overrides"]["batch_size"]:
        options["batch_size"] = batch_size
    cuda = device.startswith("cuda")
    hp = cfg["recipe"]
    kind = traffic["entry"]

    parts = {"imports": time.perf_counter() - t_start}
    model = Model(arch)
    gen = generate.generator(seed, device)
    params0, state0 = generate.make_state(model, gen, device, dtype)
    n_batches = traffic["distinct_batches"]
    batches = generate.make_batches(data, batch_size, n_batches, gen, device, dtype)
    follow_n = traffic["follow_steps"]
    tmp = tempfile.TemporaryDirectory(prefix="portbench-")
    if cuda:
        torch.cuda.synchronize()
    parts["inputs"] = time.perf_counter() - t_start - sum(parts.values())
    prog = Program(cfg, device, tmp.name, params0, state0, options)
    tr = prog.tr
    parts["trainer"] = time.perf_counter() - t_start - sum(parts.values())

    # set-up: the first units through the window's own call
    first: Dict[str, object] = {}
    if kind == "step":
        rho, gradf, iters = [], [], []
        for i in range(follow_n):
            m = tr.train_step(batches[i], fetch=False)
            rho.append(float(m["rho"]))
            gradf.append(float(m["gradf_norm"]))
            iters.append(int(m["pow_iters"]))
            if i == 0:
                first["d1"] = _direction(cfg, None, tr.opt_state)
            parts[f"unit{i}"] = time.perf_counter() - t_start - sum(parts.values())
        first.update(rho=rho, gradf_norm=gradf, iters=iters, params=tr.params,
                     state=tr.model_state, v=tr.v)
        for i in range(follow_n, follow_n + traffic.get("warmup_steps", 0)):
            tr.train_step(batches[i % n_batches], fetch=False)
        parts["warmup"] = time.perf_counter() - t_start - sum(parts.values())
    else:
        tr.rho_test(loader=batches[:follow_n])
        parts["units"] = time.perf_counter() - t_start - sum(parts.values())
        csv = prog.rho_csv()
        first.update(rho=[float(r) for r in csv[:, 1]], iters=[int(i) for i in csv[:, 3]],
                     state=tr.model_state, v=tr.v)
    setup_peak = 0
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    # the window
    spans = None
    if trace:
        from portbench.trace import Spans
        spans = Spans(cuda).__enter__()
    rng = np.random.default_rng([seed % (2 ** 63), 1])
    t0 = time.perf_counter()
    deadline = t0 + seconds
    window_iters: List[int] = []
    pool = Reservoir(traffic["check_units"], rng)
    if kind == "step":
        i = follow_n + traffic.get("warmup_steps", 0)
        hold = _held(tr)
        while True:
            item = {"j": len(window_iters), "batch": i % n_batches}
            picked = pool.offer(item)
            if picked:
                item.update(params_in=hold(tr.params), opt_in=hold(tr.opt_state),
                            state_in=hold(tr.model_state), v_in=hold(tr.v))
            m = tr.train_step(batches[i % n_batches], fetch=False)
            if picked:
                item.update(params=hold(tr.params), opt_out=hold(tr.opt_state),
                            state=hold(tr.model_state), v=hold(tr.v), metrics=m)
            window_iters.append(int(m["pow_iters"]))
            i += 1
            if time.perf_counter() >= deadline:
                break
        if cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        for item in pool.kept:
            m = item.pop("metrics")
            item.update(rho=[float(m["rho"])], gradf_norm=[float(m["gradf_norm"])],
                        d1=_direction(cfg, item["opt_in"], item["opt_out"]))
    else:
        loader = WindowLoader(tr, batches, follow_n, deadline, pool)
        tr.rho_test(loader=loader)
        if cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        loader.close()
        csv = prog.rho_csv()
        window_iters = [int(i) for i in csv[:, 3]]
        for item in pool.kept:
            item["rho"] = float(csv[item["j"], 1])
    kept = pool.kept
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    ctx = {"kind": kind, "batch_size": batch_size, "setup_s": setup_s, "window_s": window_s,
           "peak_bytes": peak, "memory_peak_bytes": max(peak, setup_peak) if cuda else 0,
           "units": len(window_iters), "samples": len(window_iters) * batch_size,
           "iters": window_iters, "flops": cfg["flops_per_sample"], "work": traffic["work"],
           "remat": bool(hp.get("remat")), "peak_flops": cfg["peak_flops"],
           "spans": {}, "missing": [], "profile": None, "setup_parts": parts,
           "followed_iters": first["iters"]}
    if trace:
        ctx["spans"], ctx["missing"] = spans.ms(), list(spans.missing)
        if cuda:
            start = i if kind == "step" else follow_n
            ctx["profile"] = _profile(traffic, prog, batches, start, spans)
        spans.__exit__(None, None, None)

    # free the program, then the reference
    del tr, prog
    m = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rbatches = [ref_batch(b, device, dtype) for b in batches]
    numbers = compare(cfg, kind, model, params0, state0, rbatches, follow_n, first, kept,
                      limits, traffic["margin"])
    tmp.cleanup()
    ctx.update(numbers=numbers, limits=limits,
               correct=all(numbers[k] <= limits[k] for k in limits))
    return ctx


def _direction(cfg: dict, before: Optional[dict], after: dict) -> Dict[str, torch.Tensor]:
    """A step's decayed direction, from the optimizer's state before it
    (None: the initial, all zeros) and after it: SGD's momentum trace less
    the decayed old one, Adam's first moment less the decayed old one, over
    ``1 - b1``."""
    spec = cfg["recipe"]["optimizer"]
    key, decay, scale = (("trace", spec["momentum"], 1.0) if spec["name"] == "sgd"
                         else ("mu", spec["b1"], 1 - spec["b1"]))
    return {k: (t - decay * before[key][k] if before else t) / scale
            for k, t in after[key].items()}


def ref_opt_state(cfg: dict, opt: dict) -> dict:
    """The program's optimizer state under the reference's names."""
    if cfg["recipe"]["optimizer"]["name"] == "sgd":
        return {"trace": dict(opt["trace"])}
    return {"count": int(opt["count"]), "m": dict(opt["mu"]), "v": dict(opt["nu"])}


def compare(cfg, kind, model, params0, state0, batches, follow_n, first, kept, limits,
            margin) -> Dict[str, float]:
    """Each number's largest reading over the followed units and the
    sampled window units, each of those followed from the program's own
    state before it (``check.py``)."""
    hp, train = cfg["recipe"], kind == "step"
    numbers_of = check.step_numbers if train else (
        lambda p, r, params, state: check.audit_numbers(p, r, state))
    paths = follow(model, hp, params0, state0, batches[:follow_n], train=train, margin=margin)
    readings = [check.best_path(first, paths, lambda p, r: numbers_of(p, r, params0, state0),
                                limits)]
    readings[0]["worst_leaf"]["paths"] = len(paths)
    for item in sorted(kept, key=lambda it: it["j"]):
        params = item["params_in"] if train else params0
        opt0 = ref_opt_state(cfg, item["opt_in"]) if train else None
        paths = follow(model, hp, params, item["state_in"], [batches[item["batch"]]],
                       train=train, v0=item["v_in"], opt0=opt0, margin=margin)
        if not train:
            item = {"rho": [item["rho"]], "state": item["state_out"], "v": item["v_out"],
                    "state_in": item["state_in"]}
        readings.append(check.best_path(
            item, paths, lambda p, r, a=params, s=item["state_in"]: numbers_of(p, r, a, s),
            limits))
    return check.merge(readings)


def _profile(traffic, prog, batches, start, spans) -> Optional[dict]:
    """``profile_units`` more units under the profiler (``trace.profile``),
    with the products each took."""
    from portbench import trace as tracelib

    tr, n = prog.tr, traffic["profile_units"]
    iters: List[int] = []

    def units():
        picked = [batches[(start + j) % len(batches)] for j in range(n)]
        if traffic["entry"] == "step":
            iters.extend(int(tr.train_step(b, fetch=False)["pow_iters"]) for b in picked)
        else:
            tr.rho_test(loader=picked)

    prof = tracelib.profile(units, spans)
    if prof is None:
        return None
    if traffic["entry"] != "step":
        iters = [int(i) for i in prog.rho_csv()[:, 3]]
    return {**prof, "units": n, "iters": iters}


def reading(metric: str, ctx: dict) -> Optional[float]:
    """The reading of ``metric`` by its reader, ``metrics/<name before the
    first dot>.py``; None where it finds nothing."""
    reader = importlib.import_module(f"portbench.metrics.{metric.split('.')[0]}")
    value = reader.read(ctx)
    return None if value is None or not math.isfinite(value) else float(value)

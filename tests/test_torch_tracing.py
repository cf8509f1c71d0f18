"""The program's spans and host-synchronisation counter
(``utils/timing.py``) on a toy DenseNet on the CPU: off, a step and an
audit batch record nothing and read no clock; on, they leave the state
bit for bit as off does, open the span tree of the trainer's docstring
under one unit each, and count ``2 + products`` host synchronisations
with a host ``w``.  The card's side (every synchronisation inside a sync
span, the clock against the device trace) is in ``tests/test_torch_cuda.py``.
"""

import json

import numpy as np
import pytest
import torch

from optwboundeigenval_tpu_torch.models.densenet import DenseNet3
from optwboundeigenval_tpu_torch.optim.api import sgd
from optwboundeigenval_tpu_torch.train.task import Task
from optwboundeigenval_tpu_torch.train.trainer import SpectralTrainer
from optwboundeigenval_tpu_torch.utils import timing

torch.set_num_threads(1)
STEP = ["batch.h2d", "gradient", "eigensolver", "spectral.gate", "vghv.pass", "optimizer", "bn"]
AUDIT = ["batch.h2d", "gradient", "eigensolver", "bn", "audit.row"]
FUSED = ["batch.h2d", "gradient", "eigensolver", "audit.row"]


def _trainer(tmp_path, **kw):
    torch.manual_seed(0)
    tr = SpectralTrainer(Task(model=DenseNet3(depth=10, growth_rate=4, num_classes=4),
                              has_batch_stats=True), sgd(0.1, momentum=0.9), device="cpu",
                         mu=0.01, K=0.0, batch_size=8, max_pow_iter=4, pow_iter_eps=1e-2,
                         remat=True, seed=3, log_dir=str(tmp_path / "logs"),
                         model_dir=str(tmp_path / "models"), **kw)
    tr.init_state()
    return tr


def _batches(n=2, host_xy=False):
    """Batches with ``x`` and ``y`` as tensors on the trainer's device (or
    host arrays) and a host ``w``, as a host loader hands the weights."""
    rng = np.random.default_rng(5)
    out = []
    for _ in range(n):
        x = rng.normal(size=(8, 32, 32, 3)).astype(np.float32)
        y = rng.integers(0, 4, size=8)
        out.append({"x": x if host_xy else torch.from_numpy(x),
                    "y": y if host_xy else torch.from_numpy(y), "w": np.ones(8, np.float32)})
    return out


def _children(spans, parent):
    return [i for i, s in enumerate(spans) if s.parent == parent]


def _unit_tree(spans, top, names):
    """The unit span ``top``'s children are ``names`` in order, every span
    under it carries its unit, and returns the ``eigen.product`` spans
    under its eigensolver."""
    kids = _children(spans, top)
    assert [spans[i].name for i in kids] == names
    under = [i for i in range(top + 1, len(spans)) if spans[i].unit == spans[top].unit]
    for i in under:
        j = spans[i].parent
        while j != top:  # each reaches its unit's span through its parents
            assert j is not None and j > top
            j = spans[j].parent
    eig = kids[names.index("eigensolver")]
    products = [i for i in _children(spans, eig) if spans[i].name == "eigen.product"]
    assert all(s.end_ns >= s.start_ns for s in spans)
    return products


def test_off_records_nothing_and_reads_no_clock(tmp_path, monkeypatch):
    tr = _trainer(tmp_path)
    batches = _batches()

    def refuse(*a, **k):
        raise AssertionError("recording is off")

    class Clock:
        time_ns = perf_counter = staticmethod(refuse)

    monkeypatch.setattr(timing, "time", Clock)
    monkeypatch.setattr(timing.Recording, "span", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert timing.span("x") is timing.unit("y") is timing._OFF
    tr.train_step(batches[0], fetch=False)
    tr.train_step(batches[1])
    tr.rho_test(loader=batches[:1])
    tr.rho_test_fused(loader=batches[1:])
    assert timing._ACTIVE.get() is None


def test_recording_leaves_the_state_bit_for_bit(tmp_path):
    batches = _batches()
    states = []
    for on in (False, True):
        tr = _trainer(tmp_path / str(on))
        with timing.record() if on else timing._OFF:
            for b in batches:
                tr.train_step(b, fetch=False)
            audit = tr.rho_test(loader=batches)
        states.append((tr.params, tr.opt_state["trace"], tr.model_state, tr.v, audit))
    off, on = states
    for a, b in zip(off[:4], on[:4]):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    np.testing.assert_array_equal(off[4][:4], on[4][:4])  # rho, norm, iters, res; not the time


@pytest.mark.parametrize("eigensolver", ["power", "lanczos", "lanczos_adaptive"])
def test_step_spans_and_syncs(tmp_path, eigensolver):
    """Two steps: two units, the step's layers in order, one
    ``eigen.product`` a product, and the host synchronisations by site:
    ``batch.h2d`` once (the host ``w``), ``spectral.gate`` once and the
    solver's reads."""
    kw = {"power": {}, "lanczos": {"eigensolver": "lanczos", "lanczos_m": 4},
          "lanczos_adaptive": {"eigensolver": "auto", "rand_init": True, "lanczos_m": 4}}
    tr = _trainer(tmp_path, **kw[eigensolver])
    assert tr.eigensolver == eigensolver
    products = []
    with timing.record() as rec:
        for b in _batches():
            products.append(tr.train_step(b, fetch=False)["pow_iters"])
    spans = rec.spans
    tops = [i for i, s in enumerate(spans) if s.parent is None]
    assert [spans[i].name for i in tops] == ["step", "step"] and rec.units == 2
    assert [spans[i].unit for i in tops] == [0, 1]
    for top, n in zip(tops, products):
        assert len(_unit_tree(spans, top, STEP)) == n
    # the power iteration reads its stop test once a product; Lanczos at a
    # fixed depth reads its tridiagonal (two reads) and the residual's test,
    # and copies back the Ritz vector, value and estimate; the adaptive
    # build reads once a depth and copies back three
    stops = {"power": sum(products), "lanczos": 3 * 2,
             "lanczos_adaptive": sum(products) - 2}[eigensolver]
    want = {"batch.h2d": 2, "eigen.stop": stops, "spectral.gate": 2}
    if eigensolver != "power":
        want["eigen.h2d"] = 3 * 2
    assert rec.syncs == want
    assert sum(s.sync for s in spans) == sum(want.values())
    if eigensolver == "power":
        assert sum(want.values()) == 2 * (1 + 1) + sum(products)  # 1 + products + 1 a step


def test_audit_spans_and_syncs(tmp_path):
    tr = _trainer(tmp_path)
    with timing.record() as rec:
        tr.rho_test(loader=_batches())
    iters = np.loadtxt(tmp_path / "logs" / f"{tr.header2}_rho_test.csv", delimiter=",",
                       ndmin=2)[:, 3]
    spans = rec.spans
    tops = [i for i, s in enumerate(spans) if s.parent is None]
    assert [spans[i].name for i in tops] == ["audit.batch"] * 2 and rec.units == 2
    for top, n in zip(tops, iters):
        assert len(_unit_tree(spans, top, AUDIT)) == n
    assert rec.syncs == {"batch.h2d": 2, "eigen.stop": int(iters.sum()), "audit.row": 2}

    with timing.record() as rec:
        tr.rho_test_fused(loader=_batches()[:1])
    iters = np.loadtxt(tmp_path / "logs" / f"{tr.header2}_rho_test.csv", delimiter=",",
                       ndmin=2)[:, 3]
    assert len(_unit_tree(rec.spans, 0, FUSED)) == iters[0]
    assert rec.syncs == {"batch.h2d": 1, "eigen.stop": int(iters[0]), "audit.row": 1}


def test_fetched_step_and_host_batches_count_their_copies(tmp_path):
    """``fetch=True`` reads the metrics once more (``step.fetch``); a batch
    of host arrays is three copies."""
    tr = _trainer(tmp_path)
    with timing.record() as rec:
        m = tr.train_step(_batches(1, host_xy=True)[0])
    assert rec.syncs == {"batch.h2d": 3, "eigen.stop": m["pow_iters"], "spectral.gate": 1,
                         "step.fetch": 1}


def test_inner_recording_takes_the_block(tmp_path):
    with timing.record() as outer:
        with timing.span("a"):
            with timing.record() as inner:
                with timing.unit("u"):
                    timing.read("s", torch.ones(()))
            with timing.span("b"):
                pass
    assert [s.name for s in outer.spans] == ["a", "b"]
    assert [s.parent for s in outer.spans] == [None, 0] and outer.syncs == {}
    assert [(s.name, s.parent, s.unit, s.sync) for s in inner.spans] == [
        ("u", None, 0, False), ("s", 0, 0, True)]
    assert inner.syncs == {"s": 1}


def test_trace_file_shows_the_spans(tmp_path):
    tr = _trainer(tmp_path)
    path = tmp_path / "t" / "step.json"
    with timing.trace(path=str(path)) as where:
        tr.train_step(_batches(1)[0], fetch=False)
    assert where == str(path)
    names = {e.get("name", "") for e in json.loads(path.read_text())["traceEvents"]}
    assert set(STEP) | {"step", "eigen.product"} <= names


def test_timers_on_the_cpu_read_the_host_clock():
    for timers in (timing.Timers(), timing.Timers("cpu")):
        assert not timers.cuda
        with timers("G"):
            sum(range(10000))
        with timers("G"):
            pass
        assert timers.totals["G"] > 0
        assert timers.report(["G", "Test"]).splitlines()[1] == (
            "Test Time elapsed:  0 hrs,  0 min, 0.00 sec")


MESH_STEP = """
import json, sys
import numpy as np, torch, torch.distributed as dist
sys.path.insert(0, {tests!r})
from test_torch_tracing import _batches, _trainer
from optwboundeigenval_tpu_torch.models.norm import BatchNorm2d
from optwboundeigenval_tpu_torch.parallel import make_mesh
from optwboundeigenval_tpu_torch.utils import timing
import pathlib
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore({store!r}, 1), world_size=1, rank=0)
tr = _trainer(pathlib.Path({tmp!r}), mesh=make_mesh(device="cpu"))
layers = sum(isinstance(m, BatchNorm2d) for m in tr.task.model.modules())
with timing.record() as rec:
    m = tr.train_step(_batches(1)[0], fetch=False)
dist.destroy_process_group()
print(json.dumps({{"syncs": rec.syncs, "layers": layers, "products": m["pow_iters"]}}))
"""


def test_mesh_sites_count_their_copies(tmp_path):
    """On a one-rank gloo group (its own process): every decision of
    ``mesh.agree`` copies the flag to the device and reads it back, and
    every train-mode BatchNorm forward does so for its count
    (``norm.count``)."""
    import subprocess
    import sys
    from pathlib import Path

    code = MESH_STEP.format(tests=str(Path(__file__).parent), store=str(tmp_path / "store"),
                            tmp=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).parents[1],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    syncs, n = got["syncs"], got["products"]
    assert syncs["batch.h2d"] == 1 and syncs["eigen.stop"] == n and syncs["spectral.gate"] == 1
    assert syncs["mesh.agree"] == 2 * (n + 1)  # the stop tests and the gate
    # a train-mode forward for the gradient, each product's recomputation,
    # the vGHv pass and the statistics: two copies a layer each
    assert syncs["norm.count"] > 0 and syncs["norm.count"] % (2 * got["layers"]) == 0

"""The vGHv pass's route (``ops/spectral.py``: ``graphable``,
``VghvGraphs``, ``eager_pass``) on the CPU.  Every pass that the rule
refuses (CPU tensors, a mesh, micro-batches, a dropout key) runs op by
op, counts ``vghv.eager`` and returns what the plain call returns, bit
for bit; a signature's passes go eager, capture, replay; a capture that
ran out of memory leaves its signature eager.  The graphs themselves run
on the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from optwboundeigenval_tpu_torch.models.densenet import DenseNet3
from optwboundeigenval_tpu_torch.ops import curvature, spectral
from optwboundeigenval_tpu_torch.optim.api import sgd
from optwboundeigenval_tpu_torch.parallel import mesh as meshlib
from optwboundeigenval_tpu_torch.train.task import Task
from optwboundeigenval_tpu_torch.train.trainer import SpectralTrainer
from optwboundeigenval_tpu_torch.utils import timing

torch.set_num_threads(1)
CUDA = torch.device("cuda")  # a device object only: nothing runs on it here


def _case(dropout=False, batch=8, seed=0):
    """A small DenseNet3 task (with dropout: a key a step), its state, a
    batch and a unit ``v`` on the CPU."""
    model = (DenseNet3(depth=7, growth_rate=4, bottleneck=False, drop_rate=0.2, reduction=1.0)
             if dropout else DenseNet3(depth=10, growth_rate=4, num_classes=4))
    task = Task(model=model, has_batch_stats=True, has_dropout=dropout)
    params, state = task.init(torch.Generator().manual_seed(seed), "cpu")
    g = torch.Generator().manual_seed(seed + 1)
    batch = {"x": torch.randn((batch, 32, 32, 3), generator=g),
             "y": torch.randint(0, 4, (batch,), generator=g),
             "w": torch.rand(batch, generator=g) + 0.5}
    v = {k: torch.randn(p.shape, generator=g) for k, p in params.items()}
    n = torch.sqrt(sum((t * t).sum() for t in v.values()))
    return task, params, state, batch, {k: t / n for k, t in v.items()}


def _equal(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("case,want", [("admitted", True), ("cpu", False), ("mesh", False),
                                       ("micro", False), ("dropout", False)])
def test_graphable_admits_one_cuda_device_whole_batch_no_dropout(case, want, monkeypatch):
    if case == "mesh":
        monkeypatch.setattr(meshlib, "current", lambda: object())
    device = torch.device("cpu") if case == "cpu" else CUDA
    key = 7 if case == "dropout" else None
    micros = (2, 4) if case == "micro" else (0, 1)  # the trainer's default hvp_micro is 0
    assert all(spectral.graphable(device, m, key) is want for m in micros)


@pytest.mark.parametrize("case", ["cpu", "micro", "dropout", "clip"])
def test_refused_passes_run_eager_and_equal_the_plain_call(case):
    """Three passes each: every one counts ``vghv.eager`` alone, nothing is
    captured or even remembered, and ``g``, ``grad g`` and ``grad rho``
    equal the call without a cache and the plain ``vghv`` bit for bit."""
    task, params, state, batch, v = _case(dropout=case == "dropout")
    key = 11 if case == "dropout" else None
    micro = 2 if case == "micro" else 1
    clip = 1e-3 if case == "clip" else None
    loss = task.loss_fn(state, key)
    rho = torch.tensor(0.5)
    graphs = spectral.VghvGraphs(task)
    for _ in range(3):
        with timing.record() as rec:
            got = spectral.penalty_and_grad(loss, params, batch, v, rho, K=0.0, gradg_clip=clip,
                                            num_micro=micro, graphs=graphs, model_state=state,
                                            key=key)
        assert rec.counts == {"vghv.eager": 1}
        want = spectral.penalty_and_grad(loss, params, batch, v, rho, K=0.0, gradg_clip=clip,
                                         num_micro=micro)
        assert torch.equal(got.g, want.g)
        assert _equal(got.grad_rho, want.grad_rho) and _equal(got.grad_g, want.grad_g)
        plain = (curvature.vghv_microbatched(loss, params, batch, v, micro) if micro > 1
                 else curvature.vghv(loss, params, batch, v))
        assert _equal(got.grad_rho, spectral.clip_by_norm(plain, clip))
    assert not graphs._graphs and not graphs._seen


def test_closed_gate_counts_no_route():
    """``g = 0``: no pass, no route counted, zero gradients."""
    task, params, state, batch, v = _case()
    graphs = spectral.VghvGraphs(task)
    with timing.record() as rec:
        sg = spectral.penalty_and_grad(task.loss_fn(state), params, batch, v,
                                       torch.tensor(0.5), K=1.0, graphs=graphs,
                                       model_state=state)
    assert rec.counts == {} and rec.syncs == {"spectral.gate": 1}
    assert all(not t.any() for t in sg.grad_rho.values()) and not graphs._seen


def test_admitted_pass_goes_through_the_cache(monkeypatch):
    """Where ``graphable`` admits the pass, ``penalty_and_grad`` hands the
    cache the step's loss, parameters, batch, ``v``, the ``model_state``
    the loss closes over and ``gradg_clip``, and scales its result."""
    task, params, state, batch, v = _case()
    loss = task.loss_fn(state)
    seen = {}
    monkeypatch.setattr(spectral, "graphable",
                        lambda device, m, key: seen.update(args=(device, m, key)) or True)

    def fake_graphs(*args):
        seen["call"] = args
        return spectral.eager_pass(args[0], args[1], args[2], args[3], args[5])

    rho = torch.tensor(0.5)
    got = spectral.penalty_and_grad(loss, params, batch, v, rho, K=0.0, gradg_clip=2.0,
                                    graphs=fake_graphs, model_state=state)
    assert seen["args"] == (torch.device("cpu"), 1, None)
    assert seen["call"][0] is loss and seen["call"][1] is params and seen["call"][2] is batch
    assert seen["call"][3] is v and seen["call"][4] is state and seen["call"][5] == 2.0
    want = spectral.penalty_and_grad(loss, params, batch, v, rho, K=0.0, gradg_clip=2.0)
    assert _equal(got.grad_g, want.grad_g) and _equal(got.grad_rho, want.grad_rho)


class _Captured:
    def result(self):
        return "captured"


def test_a_signature_runs_eager_then_captures_then_replays(monkeypatch):
    """The cache's bookkeeping, the capture and the replay stubbed: a
    signature's first pass is eager, its second captures, later ones
    replay; a batch of another shape and another ``gradg_clip`` are
    signatures of their own."""
    task, params, state, batch, v = _case()
    loss = task.loss_fn(state)
    captured = []
    monkeypatch.setattr(spectral.VghvGraphs, "capture",
                        lambda self, *a: captured.append(a) or _Captured())
    monkeypatch.setattr(spectral.VghvGraphs, "replay", lambda self, graph, *a: "replayed")
    graphs = spectral.VghvGraphs(task)
    outs = [graphs(loss, params, batch, v, state, None) for _ in range(4)]
    assert isinstance(outs[0], dict) and outs[1:] == ["captured", "replayed", "replayed"]
    assert len(captured) == 1 and captured[0][3] is state
    half = {k: t[:4] for k, t in batch.items()}
    assert isinstance(graphs(loss, params, half, v, state, None), dict)
    assert graphs(loss, params, half, v, state, None) == "captured"
    assert isinstance(graphs(loss, params, batch, v, state, 1.0), dict)
    assert graphs(loss, params, batch, v, state, None) == "replayed"
    assert len(graphs._graphs) == 2 and len(graphs._seen) == 3


def test_a_capture_out_of_memory_leaves_the_signature_eager(monkeypatch):
    """A capture that returns None (it ran out of device memory) is not
    tried again: that pass and every later one run eager, with the eager
    result."""
    task, params, state, batch, v = _case()
    loss = task.loss_fn(state)
    tries = []
    monkeypatch.setattr(spectral.VghvGraphs, "capture", lambda self, *a: tries.append(1))
    graphs = spectral.VghvGraphs(task)
    want = spectral.clip_by_norm(curvature.vghv(loss, params, batch, v), None)
    with timing.record() as rec:
        outs = [graphs(loss, params, batch, v, state, None) for _ in range(4)]
    assert len(tries) == 1 and rec.counts == {"vghv.eager": 4}
    assert all(_equal(o, want) for o in outs)


def test_trainer_hands_its_cache_state_and_key(tmp_path, monkeypatch):
    """A CPU trainer step: the pass goes to the trainer's own cache with
    the step's ``model_state`` and dropout key (None without dropout),
    and the cache sees CPU tensors, so the step's pass counts eager."""
    torch.manual_seed(0)
    tr = SpectralTrainer(Task(model=DenseNet3(depth=10, growth_rate=4, num_classes=4),
                              has_batch_stats=True), sgd(0.1, momentum=0.9), device="cpu",
                         mu=0.01, K=0.0, batch_size=8, max_pow_iter=4, pow_iter_eps=1e-2,
                         seed=3, log_dir=str(tmp_path / "logs"),
                         model_dir=str(tmp_path / "models"))
    tr.init_state()
    seen = []
    real = spectral.penalty_and_grad
    monkeypatch.setattr(spectral, "penalty_and_grad",
                        lambda *a, **kw: seen.append(kw) or real(*a, **kw))
    state = tr.model_state
    rng = np.random.default_rng(5)
    batch = {"x": rng.normal(size=(8, 32, 32, 3)).astype(np.float32),
             "y": rng.integers(0, 4, size=8), "w": np.ones(8, np.float32)}
    with timing.record() as rec:
        m = tr.train_step(batch)
    assert m["step_ok"] and m["g"] > 0
    assert seen[0]["graphs"] is tr._vghv_graphs and seen[0]["model_state"] is state
    assert seen[0]["key"] is None and seen[0]["num_micro"] == 0
    assert rec.counts == {"vghv.eager": 1}
    names = [s.name for s in rec.spans]
    assert names[names.index("vghv.pass") + 1] == "vghv.eager"


def test_counted_spans_count_only_when_recording():
    with timing.counted("route.a"):
        pass
    with timing.record() as rec:
        for name in ("route.a", "route.b", "route.a"):
            with timing.counted(name):
                pass
    assert rec.counts == {"route.a": 2, "route.b": 1} and rec.syncs == {}
    assert [s.name for s in rec.spans] == ["route.a", "route.b", "route.a"]

"""The trainer's execution knobs (``scan_steps``, ``donate``, ``mem_track``,
``profile_dir``/``profile_epoch``, device-resident data) against the knob
off and against the JAX package's trainer, at float64 on the CPU.

Each knob's contract in the JAX package is that it leaves the trajectory
as it is (``tests/test_trainer.py:328-440``).  Here the port's runs with a
knob on equal its runs with it off bit for bit (rtol 1e-12 where an
equality would do), and the JAX trainer's run of the same knobs from the
same float64 weights to rtol 1e-9.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from optwboundeigenval_tpu_torch.data.device import DeviceArrayLoader
from optwboundeigenval_tpu_torch.data.loaders import ArrayLoader
from optwboundeigenval_tpu_torch.data.synthetic import make_classification
from optwboundeigenval_tpu_torch.models.densenet import DenseNet3
from optwboundeigenval_tpu_torch.models.mlp_forest import ForestNet
from optwboundeigenval_tpu_torch.optim.api import sgd
from optwboundeigenval_tpu_torch.train.task import Task
from optwboundeigenval_tpu_torch.train.trainer import SpectralTrainer

torch.set_num_threads(1)
RTOL = 1e-12
RTOL_JAX = 1e-9
TRAINER = dict(mu=0.01, K=1.0, batch_size=32, max_iter=2, min_iter=1, max_pow_iter=30,
               pow_iter_eps=1e-2)


@dataclasses.dataclass(frozen=True, eq=False)
class _Given(Task):
    """A task that starts from given parameters."""

    params0: dict = dataclasses.field(default_factory=dict)

    def init(self, generator, device):
        return {k: t.to(device, copy=True) for k, t in self.params0.items()}, {}


@pytest.fixture(scope="module")
def weights():
    """A float64 flax init of ForestNet(hidden=12, 4 classes), JAX's and the
    port's copy."""
    import jax
    import jax.numpy as jnp

    from optwboundeigenval_tpu.models import ForestNet as JForestNet
    from optwboundeigenval_tpu.train.task import Task as JTask
    from optwboundeigenval_tpu_torch.utils import interop

    p, _ = JTask(model=JForestNet(hidden=12, num_classes=4, dtype=jnp.float64)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 10)))
    p = jax.tree.map(lambda a: np.asarray(a, np.float64), p)
    return p, interop.forestnet_from_jax(p)


def _data():
    x, y = make_classification(320, 10, 4, seed=0)
    xv, yv = make_classification(64, 10, 4, seed=1)
    return x, y, xv, yv


def port_run(tmp_path, weights, header, loader_cls=ArrayLoader, optimizer=None, **kw):
    x, y, xv, yv = _data()
    extra = {"device": "cpu"} if loader_cls is DeviceArrayLoader else {}
    tr = SpectralTrainer(_Given(model=ForestNet(in_features=10, hidden=12, num_classes=4),
                                params0=weights[1]), optimizer or sgd(0.1), device="cpu",
                         header=header, log_dir=str(tmp_path / "logs"),
                         model_dir=str(tmp_path / "models"), **{**TRAINER, **kw})
    tr.train(train_loader=loader_cls(x, y, batch_size=32, shuffle=True, seed=7, **extra),
             valid_loader=ArrayLoader(xv, yv, batch_size=32))
    return tr


@pytest.fixture(scope="module")
def jax_scan(weights, tmp_path_factory):
    """The JAX trainer's scan path (``scan_steps=4``, ``donate``) from the
    same weights: 10 batches an epoch, chunks of 4, 4 and 2."""
    import jax

    from optwboundeigenval_tpu.data.loaders import ArrayLoader as JLoader
    from optwboundeigenval_tpu.models import ForestNet as JForestNet
    from optwboundeigenval_tpu.optim import sgd as jsgd
    from optwboundeigenval_tpu.train import SpectralTrainer as JTrainer
    from optwboundeigenval_tpu.train.task import Task as JTask
    from optwboundeigenval_tpu_torch.utils import interop
    import jax.numpy as jnp

    class Given(JTask):
        def init(self, rng, x):
            return jax.tree.map(jnp.asarray, weights[0]), {}

    tmp = tmp_path_factory.mktemp("jax")
    x, y, xv, yv = _data()
    tr = JTrainer(Given(model=JForestNet(hidden=12, num_classes=4, dtype=jnp.float64)),
                  jsgd(0.1), header="JSCAN", defer_metrics=True, scan_steps=4, donate=True,
                  log_dir=str(tmp / "logs"), model_dir=str(tmp / "models"), **TRAINER)
    tr.train(train_loader=JLoader(x, y, batch_size=32, shuffle=True, seed=7),
             valid_loader=JLoader(xv, yv, batch_size=32))
    params = interop.forestnet_from_jax(jax.tree.map(np.asarray, tr.params))
    return {"f": tr.f, "rho": tr.rho, "h": tr.h, "params": params,
            "val_acc": tr.best_val_acc, "pow": tr.mean_pow_iters}


@pytest.fixture(scope="module")
def per_step(weights, tmp_path_factory):
    """The port's per-step ``defer_metrics`` run: the trajectory every knob
    must keep."""
    return port_run(tmp_path_factory.mktemp("base"), weights, "BASE", defer_metrics=True)


def _close(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(float(np.abs(want).max(initial=0.0)), 1e-30),
                               err_msg=what)


def _same_run(tr, want, rtol, what):
    for k in ("f", "rho", "h"):
        _close(getattr(tr, k), want[k] if isinstance(want, dict) else getattr(want, k),
               rtol, f"{what} {k}")
    params = want["params"] if isinstance(want, dict) else want.params
    for k, t in params.items():
        _close(tr.params[k], t, rtol, f"{what} {k}")


def test_scan_steps_matches_per_step_and_jax(tmp_path, weights, per_step, jax_scan):
    """tests/test_trainer.py:328: chunks of 4 (and a short last chunk of 2)
    give the per-step trajectory, and JAX's scan path."""
    tr = port_run(tmp_path, weights, "SCAN4", defer_metrics=True, scan_steps=4)
    assert len(tr.epoch_pow_iters) == 10
    _same_run(tr, per_step, RTOL, "scan vs per-step")
    assert tr.epoch_pow_iters == per_step.epoch_pow_iters
    _same_run(tr, jax_scan, RTOL_JAX, "scan vs JAX scan")
    # JAX's scan path reports the mean of the chunks' means (trainer.py:
    # 986-988), the port the mean over steps
    chunks = [tr.epoch_pow_iters[i:i + 4] for i in (0, 4, 8)]
    assert np.mean([np.mean(c) for c in chunks]) == jax_scan["pow"]
    _close(tr.best_val_acc, jax_scan["val_acc"], RTOL_JAX, "val_acc")


@pytest.mark.parametrize("scan_steps", [1, 4])
def test_donate_matches(tmp_path, weights, per_step, jax_scan, scan_steps):
    """tests/test_trainer.py:358: donate on the per-step and the chunked
    path leaves the trajectory as it is."""
    tr = port_run(tmp_path, weights, f"DON{scan_steps}", defer_metrics=True, donate=True,
                  scan_steps=scan_steps)
    _same_run(tr, per_step, RTOL, "donate vs per-step")
    _same_run(tr, jax_scan, RTOL_JAX, "donate vs JAX")


def _nan_epoch(tmp_path, **kw):
    """An epoch whose steps are all non-finite (SGD at lr NaN), from a
    finite start."""
    x, y = make_classification(96, 10, 4, seed=0)
    tr = SpectralTrainer(Task(model=ForestNet(in_features=10, hidden=12, num_classes=4)),
                         sgd(float("nan")), device="cpu", header="NAN",
                         log_dir=str(tmp_path / "logs"), model_dir=str(tmp_path / "models"),
                         **{**TRAINER, "max_iter": 1, **kw})
    tr.init_state()
    before = {k: t.clone() for k, t in tr.params.items()}
    tr.iter_epoch(ArrayLoader(x, y, batch_size=32))
    return tr, before


@pytest.mark.parametrize("donate", [False, True], ids=["scan", "donate_scan"])
def test_scan_and_donate_nan_recovery(tmp_path, donate):
    """tests/test_trainer.py:389 and :406: a non-finite step inside a chunk
    restores the epoch-start state; under donate the snapshot is a clone,
    not the storage the steps overwrote."""
    tr, before = _nan_epoch(tmp_path, defer_metrics=True, scan_steps=2, donate=donate)
    for k, t in before.items():
        assert torch.equal(tr.params[k], t)


def test_donate_commits_a_non_finite_fetched_step():
    """As in JAX (trainer.py:876-884): a fetched step whose norms are not
    finite is withheld, but committed under donate (the rollback is then
    the checkpoint reload)."""
    x, y = make_classification(32, 10, 4, seed=0)
    batch = next(iter(ArrayLoader(np.full_like(x, np.nan), y, batch_size=32)))
    for donate in (False, True):
        tr = SpectralTrainer(Task(model=ForestNet(in_features=10, hidden=12, num_classes=4)),
                             sgd(0.1), device="cpu", donate=donate, **TRAINER)
        tr.init_state()
        before = {k: t.clone() for k, t in tr.params.items()}
        assert not tr.train_step(batch)["step_ok"]
        same = all(torch.equal(tr.params[k], t) for k, t in before.items())
        assert same != donate


def test_device_loader_trajectory_matches_host(tmp_path, weights, per_step, jax_scan):
    """tests/test_trainer.py:423: the device-resident loader on the
    per-step and the chunked path (its batches stacked on the device)."""
    for scan_steps in (1, 4):
        tr = port_run(tmp_path, weights, f"DEV{scan_steps}", loader_cls=DeviceArrayLoader,
                      defer_metrics=True, scan_steps=scan_steps)
        _same_run(tr, per_step, RTOL, f"device loader, scan_steps={scan_steps}")
        _same_run(tr, jax_scan, RTOL_JAX, "device loader vs JAX")


@pytest.mark.parametrize("case", ["lobpcg", "verbose", "no_defer"])
def test_scan_steps_takes_the_per_step_path_where_jax_does(tmp_path, weights, monkeypatch,
                                                           case):
    """scan_steps applies exactly with defer_metrics, without verbose and
    without a preconditioner (JAX trainer.py:938-940)."""
    kw = {"lobpcg": dict(defer_metrics=True, lobpcg=True, kfac_rand=False),
          "verbose": dict(defer_metrics=True, verbose=True),
          "no_defer": dict(defer_metrics=False)}[case]
    base = port_run(tmp_path, weights, "PS1", **kw, max_iter=1)

    def no_chunks(*a, **k):
        raise AssertionError("the chunked path ran")

    monkeypatch.setattr(SpectralTrainer, "_run_scan_chunk", no_chunks)
    tr = port_run(tmp_path, weights, "PS4", **kw, max_iter=1, scan_steps=4)
    _same_run(tr, base, RTOL, case)


def test_scan_steps_draws_the_dropout_keys_of_the_per_step_path(tmp_path):
    """A dropout task under scan_steps draws its keys in the per-step order:
    the same masks, the same trajectory, the same count."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(24, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 4, size=24).astype(np.int32)

    def run(scan_steps):
        model = DenseNet3(depth=7, growth_rate=4, num_classes=4, bottleneck=False,
                          drop_rate=0.2).double()
        tr = SpectralTrainer(Task(model=model, has_batch_stats=True, has_dropout=True),
                             sgd(0.1), device="cpu", mu=0.01, K=0.0, batch_size=8,
                             max_pow_iter=4, pow_iter_eps=1e-2, defer_metrics=True,
                             scan_steps=scan_steps, seed=4)
        tr.init_state()
        tr.iter_epoch(ArrayLoader(x, y, batch_size=8))
        return tr

    a, b = run(1), run(2)
    assert a._dropout_draws == b._dropout_draws == 4  # 3 steps and the epoch-end rho
    _same_run(b, a, RTOL, "dropout under scan")
    for k, t in a.model_state.items():
        _close(b.model_state[k], t, RTOL, k)


def test_mem_track_is_zero_on_the_cpu(tmp_path, weights, capsys):
    tr = port_run(tmp_path, weights, "MEM", mem_track=True, max_iter=1)
    assert tr.mem_check() == 0 and tr.mem_max == 0
    assert "Running Max device memory" not in capsys.readouterr().out


def test_profile_dir_traces_the_chosen_epoch_only(tmp_path, weights):
    trace_dir = tmp_path / "trace"
    tr = port_run(tmp_path, weights, "PROF", profile_dir=str(trace_dir), profile_epoch=1,
                  max_iter=3, min_iter=3)
    assert sorted(os.listdir(trace_dir)) == [f"{tr.header2}_epoch1.json"]
    events = json.loads((trace_dir / f"{tr.header2}_epoch1.json").read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("addmm" in n or "linear" in n for n in names), sorted(names)[:20]


def test_donate_keeps_the_state_storage(tmp_path):
    """Under donate the committed params, model_state, opt_state and v keep
    their storage across steps (``data_ptr`` unchanged); without it every
    step allocates new trees."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(16, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 4, size=16).astype(np.int32)

    def ptrs(tr):
        trees = (tr.params, tr.model_state, tr.opt_state["trace"], tr.v)
        return [t.data_ptr() for tree in trees for t in tree.values()]

    for donate in (True, False):
        tr = SpectralTrainer(Task(model=DenseNet3(depth=10, growth_rate=4, num_classes=4),
                                  has_batch_stats=True), sgd(0.1, momentum=0.9), device="cpu",
                             mu=0.01, K=0.0, batch_size=8, max_pow_iter=4, pow_iter_eps=1e-2,
                             donate=donate, defer_metrics=True, scan_steps=2)
        tr.init_state()
        before = ptrs(tr)
        tr.train_step(ArrayLoader(x, y, batch_size=8).random_batch(np.random.default_rng(0)))
        tr.iter_epoch(ArrayLoader(x, y, batch_size=8))
        after = ptrs(tr)
        assert (after == before) == donate

"""Data-parallel training over ``torch.distributed`` (``parallel/mesh.py``)
against one process and against the JAX package's 8-device mesh, at
float64 on the CPU.

The two-rank runs happen once for the module: its fixture ``ranks``
starts this file as a script in two processes (gloo, ``127.0.0.1``),
each running every scenario of :func:`scenarios` on its rows, while the
pytest process runs the same scenarios with no mesh.  The tests then
compare:

* every row of the JAX package's ``_BREADTH`` table
  (``tests/test_parallel.py:142-177``) and its conv+BN flagship knob set
  (``:215``): ``f``, ``rho``, ``g`` and ``params`` after two epochs, two
  ranks against one process (rtol 1e-10) and against the JAX trainer on
  the 8-device CPU mesh from the same weights (rtol 1e-9).  The JAX rows
  that draw from jax.random, which the port cannot reproduce, run with
  the draws off for that comparison: Entropy-SGD's noise (``eps=0``) and
  K-FAC's sampled targets (``kfac_rand=False``); the two-rank runs keep
  them on against one process;
* the gradient, an HVP and the vGHv through the global BatchNorm of a
  small DenseNet, two ranks of 4 rows against one process of 8;
* dropout masks drawn for the global batch: a dropout DenseNet's step;
* the per-step rows of ``train_step`` on ``host_shard`` loaders, and a
  whole ``train`` with a ``save_full``/``resume`` in the middle (JAX
  ``tests/test_multihost.py:67`` and ``:169``): equal on both ranks and
  to one process, rank 0 alone writing logs and checkpoints;
* ``test_model`` over two ranks, from a loader that gives both ranks the
  same batches and from ``host_shard`` loaders, against one process.
"""

import dataclasses
import datetime
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from optwboundeigenval_tpu_torch.data.loaders import ArrayLoader
from optwboundeigenval_tpu_torch.data.synthetic import make_classification
from optwboundeigenval_tpu_torch.models.densenet import DenseNet3
from optwboundeigenval_tpu_torch.models.mlp_forest import ForestNet
from optwboundeigenval_tpu_torch.ops import curvature
from optwboundeigenval_tpu_torch.optim.api import sgd
from optwboundeigenval_tpu_torch.optim.entropy_sgd import EntropySGD
from optwboundeigenval_tpu_torch.optim.kfac_optimizer import KFAC
from optwboundeigenval_tpu_torch.optim.sam import SAM
from optwboundeigenval_tpu_torch.parallel import mesh as meshlib
from optwboundeigenval_tpu_torch.train.task import Task
from optwboundeigenval_tpu_torch.train.trainer import SpectralTrainer

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 2
RTOL_RANKS = 1e-10
RTOL_JAX = 1e-9

BREADTH = {  # tests/test_parallel.py:142-177, optimizers by name
    "sam": dict(optimizer="sam"),
    "entropy_sgd": dict(optimizer="entropy_sgd"),
    "kfac_opt": dict(optimizer="kfac"),
    "lobpcg": dict(lobpcg=True, kfac_batch=1),
    "defer_metrics": dict(defer_metrics=True),
    "hvp_micro": dict(hvp_micro=2),
    "remat": dict(remat=True),
    "scan": dict(defer_metrics=True, scan_steps=2),
    "momentum": dict(pow_iter_momentum=0.9),
    "lanczos": dict(eigensolver="lanczos", lanczos_m=8),
    "lanczos_adaptive": dict(eigensolver="auto", rand_init=True, lanczos_m=8),
    "donate": dict(donate=True),
    "donate_scan": dict(donate=True, remat=True, defer_metrics=True, scan_steps=2),
}
# the rows as the JAX mesh is held to: jax.random's draws off
QUIET = {"entropy_sgd": dict(optimizer="entropy_sgd_quiet"),
         "kfac_opt": dict(optimizer="kfac_fixed"),
         "lobpcg": dict(lobpcg=True, kfac_batch=1, kfac_rand=False)}
FLAGSHIP = dict(remat=True, donate=True, defer_metrics=True, scan_steps=2)


def _optimizer(name, jax=False):
    if jax:
        from optwboundeigenval_tpu.optim import KFAC as JKFAC, SAM as JSAM, sgd as jsgd
        from optwboundeigenval_tpu.optim.entropy_sgd import EntropySGD as JEntropySGD
        table = {"sgd": lambda: jsgd(0.1), "sam": lambda: JSAM(jsgd(0.1), rho=0.05),
                 "entropy_sgd_quiet": lambda: JEntropySGD(lr=0.1, L=3, g0=1e-2, eps=0.0),
                 "kfac_fixed": lambda: JKFAC(lr=0.01, TCov=1, TInv=2, kfac_rand=False)}
        return table[name]()
    table = {"sgd": lambda: sgd(0.1), "sam": lambda: SAM(sgd(0.1), rho=0.05),
             "entropy_sgd": lambda: EntropySGD(lr=0.1, L=3, g0=1e-2),
             "entropy_sgd_quiet": lambda: EntropySGD(lr=0.1, L=3, g0=1e-2, eps=0.0),
             "kfac": lambda: KFAC(lr=0.01, TCov=1, TInv=2),
             "kfac_fixed": lambda: KFAC(lr=0.01, TCov=1, TInv=2, kfac_rand=False)}
    return table[name]()


@dataclasses.dataclass(frozen=True, eq=False)
class _Given(Task):
    """A task that starts from given weights ``(params, model_state)``."""

    weights: tuple = ({}, {})

    def init(self, generator, device):
        p, s = self.weights
        return ({k: t.to(device, copy=True) for k, t in p.items()},
                {k: t.to(device, copy=True) for k, t in s.items()})


def _images(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 4, size=n).astype(np.int32))


def _local(batches, mesh):
    return batches if mesh is None else [meshlib.shard_batch(b, mesh) for b in batches]


def _state(tr):
    return {"f": tr.f, "rho": tr.rho, "g": tr.g,
            "params": {k: t.detach().cpu() for k, t in tr.params.items()}}


def _trainer(task, opt, mesh, tmp, header, **kw):
    return SpectralTrainer(task, opt, mesh=mesh, device="cpu", header=header,
                           log_dir=os.path.join(tmp, "logs"),
                           model_dir=os.path.join(tmp, "models"), **kw)


def breadth_run(name, kw, weights, mesh, tmp):
    """tests/test_parallel.py:180: two epochs of a row on ForestNet."""
    kw = dict(kw)
    opt = _optimizer(kw.pop("optimizer", "sgd"))
    x, y = make_classification(128, 10, 4, seed=11)
    batches = _local(list(ArrayLoader(x, y, batch_size=64)), mesh)
    tr = _trainer(_Given(model=ForestNet(in_features=10, hidden=8, num_classes=4),
                         weights=weights), opt, mesh, tmp, f"BRD{name}", mu=0.05, K=0.0,
                  batch_size=64, max_pow_iter=20, pow_iter_eps=1e-2,
                  ignore_bad_vals=False, seed=5, **kw)
    tr.init_state()
    for _ in range(2):
        tr.iter_epoch(batches)
    return _state(tr)


def flagship_run(weights, mesh, tmp):
    """tests/test_parallel.py:215: the flagship knobs on a conv+BN model."""
    x, y = _images(64, 4)
    batches = _local(list(ArrayLoader(x, y, batch_size=32)), mesh)
    tr = _trainer(_Given(model=DenseNet3(depth=10, growth_rate=4, num_classes=4),
                         has_batch_stats=True, weights=weights), sgd(0.05), mesh, tmp,
                  "FLAG", mu=0.05, K=0.0, batch_size=32, max_pow_iter=10,
                  pow_iter_eps=1e-2, ignore_bad_vals=False, seed=7, **FLAGSHIP)
    tr.init_state()
    for _ in range(2):
        tr.iter_epoch(batches)
    return {**_state(tr), "model_state": {k: t.cpu() for k, t in tr.model_state.items()}}


def batchnorm_orders(weights, mesh):
    """Gradient, HVP and vGHv of a BatchNorm DenseNet on 8 images."""
    task = _Given(model=DenseNet3(depth=10, growth_rate=4, num_classes=4),
                  has_batch_stats=True, weights=weights)
    params, state = task.init(None, "cpu")
    x, y = _images(8, 5)
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y),
             "w": torch.tensor([1.0] * 7 + [0.0])}
    if mesh is not None:
        batch = meshlib.shard_batch(batch, mesh)
    g = torch.Generator().manual_seed(3)
    v = {k: torch.randn(t.shape, generator=g, dtype=t.dtype) for k, t in params.items()}
    loss_fn = task.loss_fn(state)
    with meshlib.active(mesh):
        loss, grad = curvature.value_and_grad(loss_fn, params, batch)
        return {"loss": loss, "grad": grad, "hv": curvature.hvp(loss_fn, params, batch, v),
                "vghv": curvature.vghv(loss_fn, params, batch, v),
                "stats": task.train_loss(params, state, batch)[1]}


def dropout_run(mesh, tmp):
    """A step and an epoch end of a dropout DenseNet (masks of the global batch)."""
    model = DenseNet3(depth=7, growth_rate=4, num_classes=4, bottleneck=False,
                      drop_rate=0.2, generator=torch.Generator().manual_seed(0)).double()
    x, y = _images(8, 6)
    batches = _local(list(ArrayLoader(x, y, batch_size=8)), mesh)
    tr = _trainer(Task(model=model, has_batch_stats=True, has_dropout=True), sgd(0.1), mesh,
                  tmp, "DROP", mu=0.05, K=0.0, batch_size=8, max_pow_iter=5,
                  pow_iter_eps=1e-2, ignore_bad_vals=False, seed=3)
    tr.init_state()
    tr.iter_epoch(batches)
    return _state(tr)


def step_rows(mesh, tmp):
    """tests/test_multihost.py:67: three train_steps on host_shard loaders."""
    x, y = make_classification(128, 10, 4, seed=7)
    loader = (ArrayLoader(x, y, batch_size=32) if mesh is None else
              ArrayLoader(x, y, batch_size=32 // mesh.data, host_shard=(mesh.rank, mesh.data)))
    tr = _trainer(Task(model=ForestNet(in_features=10, hidden=8, num_classes=4).double()),
                  sgd(0.1), mesh, tmp, "MH", mu=0.05, K=0.0, batch_size=32,
                  max_pow_iter=50, pow_iter_eps=1e-4, seed=0)
    rows = []
    for step, batch in enumerate(loader):
        m = tr.train_step(batch)
        rows.append([m["rho"], m["g"], m["gradf_norm"], float(m["step_ok"])])
        if step >= 2:
            break
    return torch.tensor(rows, dtype=torch.float64)


class _PinnedRng:
    def __init__(self, start=0):
        self.i = start

    def integers(self, low, high):
        self.i += 1
        return low + (self.i - 1) % max(high - low, 1)


def train_resume(mesh, tmp):
    """tests/test_multihost.py:169: train 2 epochs with save_full, resume a
    fresh trainer for the third, evaluate through the host-sharded loader."""
    x, y = make_classification(128, 10, 4, seed=7)
    xv, yv = make_classification(64, 10, 4, seed=8)
    train = (ArrayLoader(x, y, batch_size=32) if mesh is None else
             ArrayLoader(x, y, batch_size=32 // mesh.data, host_shard=(mesh.rank, mesh.data)))
    valid = ArrayLoader(xv, yv, batch_size=32)

    def trainer(epochs, start):
        tr = _trainer(Task(model=ForestNet(in_features=10, hidden=8, num_classes=4).double()),
                      sgd(0.1), mesh, tmp, "MHT", mu=0.05, K=0.0, batch_size=32,
                      max_pow_iter=50, pow_iter_eps=1e-4, min_iter=epochs, max_iter=epochs,
                      seed=0, full_ckpt=True)
        tr._np_rng = _PinnedRng(start)
        return tr

    if mesh is None:  # straight through
        second = trainer(3, 0)
    else:
        trainer(2, 0).train(train_loader=train, valid_loader=valid)
        second = trainer(3, 2)
        second.resume()
    second.train(train_loader=train, valid_loader=valid)
    rows = ([[float(c) for c in ln.split()] for ln in open(second.log_file) if ln[:1].isdigit()]
            if second._writer else [])
    return {**_state(second), "h": second.h, "best_iter": second.best_iter,
            "best_val_acc": second.best_val_acc, "rows": torch.tensor(rows),
            "eval": torch.tensor(second.test_model(loader=train))}


def evaluation(mesh, tmp):
    """test_model: a loader giving every rank the same batches (striped),
    and host_shard loaders; 70 rows, so the last batch is padded."""
    x, y = make_classification(70, 10, 4, seed=9)
    tr = _trainer(Task(model=ForestNet(in_features=10, hidden=8, num_classes=4).double()),
                  sgd(0.1), mesh, tmp, "EVAL", seed=2)
    tr.init_state()
    same = tr.test_model(loader=ArrayLoader(x, y, batch_size=32))
    shard = (same if mesh is None else
             tr.test_model(loader=ArrayLoader(x, y, batch_size=16,
                                              host_shard=(mesh.rank, mesh.data))))
    return {"same": torch.tensor(same), "host_shard": torch.tensor(shard)}


def scenarios(weights, mesh, tmp):
    """Every scenario on this rank (``mesh``) or one process (None)."""
    out = {"breadth": {}}
    for name, kw in BREADTH.items():
        out["breadth"][name] = breadth_run(name, kw, weights["forest"], mesh,
                                           os.path.join(tmp, name))
        if name in QUIET:
            out["breadth"][name + "_quiet"] = breadth_run(
                name, QUIET[name], weights["forest"], mesh, os.path.join(tmp, name + "_q"))
    out["flagship"] = flagship_run(weights["densenet"], mesh, os.path.join(tmp, "flag"))
    out["orders"] = batchnorm_orders(weights["densenet"], mesh)
    out["dropout"] = dropout_run(mesh, os.path.join(tmp, "drop"))
    out["steps"] = step_rows(mesh, os.path.join(tmp, "steps"))
    out["resume"] = train_resume(mesh, os.path.join(tmp, "resume"))
    out["eval"] = evaluation(mesh, os.path.join(tmp, "eval"))
    return out


# ---- the pytest side ----------------------------------------------------------


def _jax_weights():
    """Float64 JAX inits of the two models, and the port's copies."""
    import jax
    import jax.numpy as jnp

    from optwboundeigenval_tpu.models import ForestNet as JForestNet
    from optwboundeigenval_tpu.models.densenet import DenseNet3 as JDenseNet3
    from optwboundeigenval_tpu.train.task import Task as JTask
    from optwboundeigenval_tpu_torch.utils import interop

    f64 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float64), t)
    pf, _ = JTask(model=JForestNet(hidden=8, num_classes=4, dtype=jnp.float64)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 10)))
    pd, sd = JTask(model=JDenseNet3(depth=10, growth_rate=4, num_classes=4,
                                    dtype=jnp.float64), has_batch_stats=True).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    jax_w = {"forest": (f64(pf), {}),
             "densenet": (f64(pd), {"batch_stats": f64(sd["batch_stats"])})}
    port_w = {"forest": (interop.forestnet_from_jax(jax_w["forest"][0]), {}),
              "densenet": interop.densenet3_from_jax(*f64((pd, sd["batch_stats"])))}
    return jax_w, port_w


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks():
    """``(jax weights, one-process results, [rank 0, rank 1] results)``."""
    jax_w, port_w = _jax_weights()
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(port_w, os.path.join(tmp, "weights.pt"))
        env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
        port = _free_port()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r),
                                   str(RANKS), str(port), tmp], cwd=ROOT, env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                 for r in range(RANKS)]
        try:
            one = scenarios(port_w, None, os.path.join(tmp, "one"))
        finally:
            logs = []
            for p in procs:
                try:
                    logs.append(p.communicate(timeout=300)[0].decode(errors="replace"))
                except subprocess.TimeoutExpired:
                    for q in procs:
                        q.kill()
                    raise
        for p, log in zip(procs, logs):
            assert p.returncode == 0, f"rank failed:\n{log[-4000:]}"
        per_rank = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                    for r in range(RANKS)]
    return jax_w, one, per_rank


def _close(got, want, rtol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(float(np.abs(want).max(initial=0.0)), 1e-30),
                               err_msg=what)


def _close_state(got, want, rtol, what):
    for k in ("f", "rho", "g"):
        _close(got[k], want[k], rtol, f"{what} {k}")
    assert sorted(got["params"]) == sorted(want["params"])
    for k, t in want["params"].items():
        _close(got["params"][k], t, rtol, f"{what} params {k}")


BREADTH_RUNS = sorted(list(BREADTH) + [n + "_quiet" for n in QUIET])


@pytest.mark.parametrize("name", BREADTH_RUNS)
def test_breadth_two_ranks_match_one_process(ranks, name):
    _, one, per_rank = ranks
    for r, res in enumerate(per_rank):
        _close_state(res["breadth"][name], one["breadth"][name], RTOL_RANKS, f"rank {r} {name}")


def _jax_trainer_run(monkeypatch, tmp_path, model, weights, opt, batches, **kw):
    from optwboundeigenval_tpu.parallel import make_mesh
    from optwboundeigenval_tpu.train import SpectralTrainer as JTrainer
    from optwboundeigenval_tpu.train.task import Task as JTask
    import jax

    p0, s0 = weights
    monkeypatch.setattr(JTask, "init", lambda self, rng, x: (
        jax.tree.map(np.asarray, p0), jax.tree.map(np.asarray, s0)))
    tr = JTrainer(JTask(model=model, has_batch_stats=bool(s0)), opt, mesh=make_mesh(),
                  log_dir=str(tmp_path / "logs"), model_dir=str(tmp_path / "models"), **kw)
    tr.init_state(batches[0])
    for _ in range(2):
        tr.iter_epoch(batches)
    return tr


@pytest.mark.parametrize("name", sorted(BREADTH))
def test_breadth_two_ranks_match_jax_mesh(ranks, eight_devices, monkeypatch, tmp_path, name):
    import jax.numpy as jnp

    from optwboundeigenval_tpu.data.loaders import ArrayLoader as JLoader
    from optwboundeigenval_tpu.data.synthetic import make_classification as jclassification
    from optwboundeigenval_tpu.models import ForestNet as JForestNet
    from optwboundeigenval_tpu_torch.utils import interop

    jax_w, _, per_rank = ranks
    kw = dict(QUIET.get(name, BREADTH[name]))
    opt = _optimizer(kw.pop("optimizer", "sgd"), jax=True)
    x, y = jclassification(128, 10, 4, seed=11)
    jtr = _jax_trainer_run(monkeypatch, tmp_path, JForestNet(hidden=8, num_classes=4,
                                                             dtype=jnp.float64),
                           jax_w["forest"], opt, list(JLoader(x, y, batch_size=64)),
                           mu=0.05, K=0.0, batch_size=64, max_pow_iter=20,
                           pow_iter_eps=1e-2, ignore_bad_vals=False, seed=5,
                           header=f"JBRD{name}", **kw)
    want = {"f": jtr.f, "rho": jtr.rho, "g": jtr.g,
            "params": interop.forestnet_from_jax(
                {k: {kk: np.asarray(vv) for kk, vv in v.items()} for k, v in jtr.params.items()})}
    got = per_rank[0]["breadth"][name + ("_quiet" if name in QUIET else "")]
    _close_state(got, want, RTOL_JAX, f"{name} vs JAX")


def test_flagship_knob_set_two_ranks(ranks, eight_devices, monkeypatch, tmp_path):
    """remat + donate + defer_metrics + scan_steps on the conv+BN DenseNet:
    two ranks against one process and against the JAX 8-device mesh."""
    import jax
    import jax.numpy as jnp

    from optwboundeigenval_tpu.data.loaders import ArrayLoader as JLoader
    from optwboundeigenval_tpu.models.densenet import DenseNet3 as JDenseNet3
    from optwboundeigenval_tpu.optim import sgd as jsgd
    from optwboundeigenval_tpu_torch.utils import interop

    jax_w, one, per_rank = ranks
    for r, res in enumerate(per_rank):
        _close_state(res["flagship"], one["flagship"], RTOL_RANKS, f"rank {r} flagship")
        for k, t in one["flagship"]["model_state"].items():
            _close(res["flagship"]["model_state"][k], t, RTOL_RANKS, f"rank {r} {k}")
    x, y = _images(64, 4)
    jtr = _jax_trainer_run(monkeypatch, tmp_path, JDenseNet3(depth=10, growth_rate=4,
                                                             num_classes=4, dtype=jnp.float64),
                           jax_w["densenet"], jsgd(0.05), list(JLoader(x, y, batch_size=32)),
                           mu=0.05, K=0.0, batch_size=32, max_pow_iter=10,
                           pow_iter_eps=1e-2, ignore_bad_vals=False, seed=7,
                           header="JFLAG", **FLAGSHIP)
    f64 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float64), t)
    params, stats = interop.densenet3_from_jax(f64(jtr.params),
                                               f64(jtr.model_state["batch_stats"]))
    _close_state(per_rank[0]["flagship"], {"f": jtr.f, "rho": jtr.rho, "g": jtr.g,
                                           "params": params}, RTOL_JAX, "flagship vs JAX")
    for k, t in stats.items():
        _close(per_rank[0]["flagship"]["model_state"][k], t, RTOL_JAX, f"flagship vs JAX {k}")


def test_third_order_through_the_global_batchnorm(ranks):
    """The vGHv differentiates BatchNorm three times; across two ranks the
    statistics come from an all-reduce whose backward is an all-reduce."""
    _, one, per_rank = ranks
    want = one["orders"]
    for r, res in enumerate(per_rank):
        _close(res["orders"]["loss"], want["loss"], RTOL_RANKS, f"rank {r} loss")
        for part in ("grad", "hv", "vghv", "stats"):
            for k, t in want[part].items():
                _close(res["orders"][part][k], t, RTOL_RANKS, f"rank {r} {part} {k}")
        assert float(torch.stack([t.norm() for t in res["orders"]["vghv"].values()]).sum()) > 0


def test_dropout_masks_of_the_global_batch(ranks):
    _, one, per_rank = ranks
    for r, res in enumerate(per_rank):
        _close_state(res["dropout"], one["dropout"], RTOL_RANKS, f"rank {r} dropout")


def test_step_rows_equal_across_ranks_and_one_process(ranks):
    _, one, per_rank = ranks
    assert per_rank[0]["steps"].shape == (3, 4)
    for r, res in enumerate(per_rank):
        _close(res["steps"], one["steps"], RTOL_RANKS, f"rank {r} step rows")
    assert bool((one["steps"][:, 3] == 1).all())


def test_train_resume_on_two_ranks_matches_one_process(ranks):
    """The whole loop with a resume in the middle: the rank-0 TSV equals one
    process's straight-through log (rank 1 writes none), every rank holds
    the same state and evaluates the host-sharded train set to the
    one-process value."""
    _, one, per_rank = ranks
    want = one["resume"]
    assert want["rows"].shape == (3, 7)
    _close(per_rank[0]["resume"]["rows"], want["rows"], RTOL_RANKS, "TSV rows")
    assert per_rank[1]["resume"]["rows"].numel() == 0
    for r, res in enumerate(per_rank):
        got = res["resume"]
        _close_state(got, want, RTOL_RANKS, f"rank {r} resumed")
        _close(got["h"], want["h"], RTOL_RANKS, f"rank {r} h")
        _close(got["eval"], want["eval"], RTOL_RANKS, f"rank {r} train eval")
        assert (got["best_iter"], got["best_val_acc"]) == (want["best_iter"],
                                                           want["best_val_acc"])


@pytest.mark.parametrize("loader", ["same", "host_shard"])
def test_model_over_two_ranks_matches_one_process(ranks, loader):
    _, one, per_rank = ranks
    for r, res in enumerate(per_rank):
        _close(res["eval"][loader], one["eval"]["same"], RTOL_RANKS, f"rank {r} {loader}")


# ---- without ranks -----------------------------------------------------------


def test_init_distributed_is_a_no_op_without_a_coordinator(monkeypatch):
    """tests/test_parallel.py:282: no coordinator, no process group; with
    one it calls init_process_group with the address and the rank."""
    import torch.distributed as dist

    meshlib.init_distributed()
    assert not dist.is_initialized()
    called = {}
    monkeypatch.setattr(dist, "init_process_group", lambda **kw: called.update(kw))
    meshlib.init_distributed("10.0.0.1:1234", num_processes=8, process_id=3, device="cpu")
    assert called == {"backend": "gloo", "init_method": "tcp://10.0.0.1:1234",
                      "world_size": 8, "rank": 3}
    meshlib.init_distributed("10.0.0.1:1234", num_processes=8, process_id=3)
    assert called["backend"] == "nccl"


def test_host_shard_partitions_exactly():
    """tests/test_parallel.py:262: the strided shards are disjoint and
    cover the rows."""
    x = np.arange(100, dtype=np.float32).reshape(100, 1)
    y = np.arange(100, dtype=np.int32)
    seen = []
    for i in range(4):
        loader = ArrayLoader(x, y, batch_size=8, host_shard=(i, 4))
        assert loader.host_shard == (i, 4)
        rows = [int(v) for b in loader for v, w in zip(b["y"], b["w"]) if w > 0]
        assert len(rows) == 25
        seen.extend(rows)
    assert sorted(seen) == list(range(100))


def test_make_mesh_model_axis_raises():
    with pytest.raises(ValueError, match="world of 1"):
        meshlib.make_mesh(model=2, device="cpu")
    mesh = meshlib.make_mesh(device="cpu")  # no process group: a world of one
    assert (mesh.data, mesh.model, mesh.rank, mesh.writer) == (1, 1, 0, True)
    with pytest.raises(ValueError, match="world of 1"):
        meshlib.make_mesh(data=2, device="cpu")
    batch = {"x": np.arange(8), "y": torch.arange(8)}
    half = meshlib.shard_batch(batch, dataclasses.replace(mesh, data=2, rank=1))
    assert half["x"].tolist() == [4, 5, 6, 7] and half["y"].tolist() == [4, 5, 6, 7]


def test_trainer_on_a_mesh_of_one_rank_runs_as_without(tmp_path):
    """With no process group a mesh is a world of one: the trainer runs
    the same steps; the mesh's device is the trainer's."""
    mesh = meshlib.make_mesh(device="cpu")
    x, y = make_classification(64, 10, 4, seed=1)

    def run(m):
        tr = _trainer(Task(model=ForestNet(in_features=10, hidden=8, num_classes=4).double()),
                      sgd(0.1), m, str(tmp_path), "ONE", mu=0.05, K=0.0, batch_size=32,
                      max_pow_iter=10, pow_iter_eps=1e-2, seed=1)
        tr.init_state()
        tr.iter_epoch(ArrayLoader(x, y, batch_size=32))
        return tr

    a, b = run(None), run(mesh)
    assert a.f == b.f and a.rho == b.rho
    assert b.device == torch.device("cpu")


if __name__ == "__main__":  # one rank of the ``ranks`` fixture
    rank, world, port, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    meshlib.init_distributed(f"127.0.0.1:{port}", num_processes=world, process_id=rank,
                             device="cpu", timeout=datetime.timedelta(seconds=120))
    mesh = meshlib.make_mesh(device="cpu")
    weights = torch.load(os.path.join(tmp, "weights.pt"), weights_only=False)
    results = scenarios(weights, mesh, os.path.join(tmp, "ranks"))
    torch.save(results, os.path.join(tmp, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()

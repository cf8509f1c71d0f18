"""The Asymmetric Valley trainer under a mesh, the micro-batched step under
a data mesh, and a bounded wait for a rank that skips a collective, at
float64 on the CPU.

The two-rank runs happen once for the module: its fixture ``ranks``
starts this file as a script in two gloo processes (``127.0.0.1``, a
120 s collective timeout), each running every scenario of
:func:`scenarios`, while the pytest process runs them with no mesh and
runs the JAX package on a 2-device CPU mesh.  The tests then compare:

* an Asymmetric Valley run (SWA from epoch 2, the SGD hunt from epoch 4,
  a 9-point interpolation over 6 epochs) of ``ForestNet`` and of
  ``CNNUSPS`` on ``data=2``, each rank taking its block of the loaders'
  global batches, against the JAX package's ``AsymmetricValleyTrainer``
  on ``make_mesh(data=2)``: ``f`` per epoch at full precision,
  ``val_acc`` and ``val_f1`` from rank 0's log, the SWA params and the four
  ``asymmetric_valley_*_results.txt`` arrays (rtol 1e-10);
* the same run on ``data=1 x model=2`` (``shard_params`` at
  ``min_elems=1024``: ForestNet's ``fc1``, CNNUSPS's ``conv2``, ``conv3``
  and ``fc1``) against one process (rtol 1e-10);
* ``bn_update`` of a BatchNorm DenseNet3 over two ranks' blocks against
  one process;
* a spectral step of a BatchNorm DenseNet3 with ``hvp_micro=2`` on
  ``data=2``, the global batch of 8 rows fed in its natural order (each
  rank holds rows 2 of each micro-batch), against the JAX trainer's step
  on ``make_mesh(data=2)`` and against one process (rtol 1e-10): ``rho``,
  ``g``, the params and the BatchNorm statistics;
* two gloo ranks started with a 5 s timeout, one of which never makes an
  all-reduce that the other makes: the other raises well inside 30 s.
"""

import dataclasses
import datetime
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

from optwboundeigenval_tpu_torch.data.loaders import ArrayLoader
from optwboundeigenval_tpu_torch.models.cnn_usps import CNNUSPS
from optwboundeigenval_tpu_torch.models.densenet import DenseNet3
from optwboundeigenval_tpu_torch.models.mlp_forest import ForestNet
from optwboundeigenval_tpu_torch.optim.api import sgd
from optwboundeigenval_tpu_torch.parallel import mesh as meshlib
from optwboundeigenval_tpu_torch.parallel.sharding import shard_params
from optwboundeigenval_tpu_torch.train.asymmetric_valley import (
    AsymmetricValleyTrainer,
    bn_update,
)
from optwboundeigenval_tpu_torch.train.task import Task
from optwboundeigenval_tpu_torch.train.trainer import SpectralTrainer

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 2
RTOL = 1e-10
RANK_TIMEOUT = datetime.timedelta(seconds=120)
MIN_ELEMS = 1024
AV = dict(max_iter=6, swa_start=2, sgd_start=4, save_freq=1, eval_freq=1, distances=2,
          division_part=4)
AV_BATCH = 16
# the learning rates at which the SGD hunt finds its point on these rows
AV_LR = {"forest": 0.5, "cnn": 0.2}
RESULTS = ("train_loss", "test_loss", "train_acc", "test_acc")
STEP = dict(mu=0.05, K=0.0, batch_size=8, max_pow_iter=6, pow_iter_eps=1e-12,
            ignore_bad_vals=False, seed=7, hvp_micro=2)


@dataclasses.dataclass(frozen=True, eq=False)
class _Given(Task):
    """A task that starts from given weights ``(params, model_state)``."""

    weights: tuple = ({}, {})

    def init(self, generator, device):
        p, s = self.weights
        return ({k: t.to(device, copy=True) for k, t in p.items()},
                {k: t.to(device, copy=True) for k, t in s.items()})


def _av_data(name):
    """``(train x, y, valid x, y)``: 64 and 32 rows, float32 as the loaders
    hold them."""
    rng = np.random.default_rng({"forest": 31, "cnn": 32}[name])
    shape, classes = ((54,), 7) if name == "forest" else ((16, 16, 1), 10)
    x = rng.normal(size=(96,) + shape).astype(np.float32)
    y = rng.integers(0, classes, size=96).astype(np.int32)
    return x[:64], y[:64], x[64:], y[64:]


def _port_model(name):
    return ForestNet() if name == "forest" else CNNUSPS()


def _images(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 4, size=n).astype(np.int32))


def _loaders(name, jax=False):
    if jax:
        from optwboundeigenval_tpu.data.loaders import ArrayLoader as Loader
    else:
        Loader = ArrayLoader
    x, y, xv, yv = _av_data(name)
    return (Loader(x, y, AV_BATCH, shuffle=True, seed=5), Loader(xv, yv, AV_BATCH))


def _log_rows(path):
    with open(path) as fh:
        return torch.tensor([[float(c) for c in ln.split()] for ln in fh if ln[:1].isdigit()],
                            dtype=torch.float64)


def _f_per_epoch(tr):
    """The list that ``tr``'s epochs append their ``f`` to, at full
    precision (the log prints 6 decimals)."""
    fs, real = [], tr.train_epoch

    def train_epoch(loader):
        out = real(loader)
        fs.append(float(tr.f))
        return out

    tr.train_epoch = train_epoch
    return fs


def av_run(name, weights, mesh, tmp):
    """An Asymmetric Valley run on this rank (``mesh``) or one process:
    rank 0's log rows and results arrays (none on another rank), the
    gathered SWA params, ``swa_n`` and whether the hunt and the sweep
    happened."""
    task = _Given(model=_port_model(name), weights=weights)
    tr = AsymmetricValleyTrainer(task, sgd(AV_LR[name]), mesh=mesh, device="cpu",
                                 header=f"AV{name}", batch_size=AV_BATCH, mu=0.0, K=0.0,
                                 seed=3, log_dir=os.path.join(tmp, "logs"),
                                 model_dir=os.path.join(tmp, "models"),
                                 plot_dir=os.path.join(tmp, "plots"), **AV)
    if mesh is not None and mesh.model > 1:
        tr.init_state()
        tr.params = shard_params(tr.params, mesh, MIN_ELEMS, task.model)
    train, valid = _loaders(name)
    f = _f_per_epoch(tr)
    tr.train(train_loader=train, valid_loader=valid)
    out = {"f": f, "swa": {k: t.detach().clone() for k, t in tr._full(tr.swa_params).items()},
           "swa_n": tr.swa_n, "hunted": tr.sgd_path is not None,
           "interpolated": tr.interpolated, "writer": tr._writer,
           "sharded": sorted(tr._sharding.dims) if tr._sharding is not None else []}
    if tr._writer:
        out["rows"] = _log_rows(tr.log_file)
        out["results"] = {k: np.loadtxt(os.path.join(
            tmp, "logs", f"asymmetric_valley_{k}_results.txt")) for k in RESULTS}
    else:
        out["files"] = [f for _, _, fs in os.walk(tmp) for f in fs]
    return out


def bn_run(weights, mesh):
    """``bn_update`` of a BatchNorm DenseNet3 over 3 batches of 8 rows."""
    task = _Given(model=DenseNet3(depth=10, growth_rate=4, num_classes=4),
                  has_batch_stats=True, weights=weights)
    params, state = task.init(None, "cpu")
    x, y = _images(24, 8)
    tr = AsymmetricValleyTrainer(task, sgd(0.1), mesh=mesh, device="cpu")
    with meshlib.active(mesh):
        return bn_update(task, params, state, tr._rows(ArrayLoader(x, y, 8)), tr.put_batch)


def micro_step(weights, mesh):
    """One ``hvp_micro=2`` spectral step of a BatchNorm DenseNet3 on the
    global batch of 8 rows in its natural order (this rank's block on a
    mesh)."""
    task = _Given(model=DenseNet3(depth=10, growth_rate=4, num_classes=4),
                  has_batch_stats=True, weights=weights)
    x, y = _images(8, 9)
    batch = {"x": x, "y": y, "w": np.ones(8, np.float32)}
    if mesh is not None:
        batch = meshlib.shard_batch(batch, mesh)
    with tempfile.TemporaryDirectory() as tmp:
        tr = SpectralTrainer(task, sgd(0.1), mesh=mesh, device="cpu", header="MICRO",
                             log_dir=tmp, model_dir=tmp, **STEP)
        tr.init_state()
        m = tr.train_step(batch)
    return {"rho": m["rho"], "g": m["g"], "pow_iters": m["pow_iters"],
            "params": {k: t.clone() for k, t in tr.params.items()},
            "model_state": {k: t.clone() for k, t in tr.model_state.items()}}


def scenarios(weights, tmp, meshes):
    """Every scenario on this rank (``meshes``: ``{"data": data=2 mesh,
    "model": data=1 x model=2 mesh}``) or in one process (all None)."""
    out = {}
    for axes, mesh in meshes.items():
        for name in ("forest", "cnn"):
            out[(axes, name)] = av_run(name, weights[name], mesh, os.path.join(tmp, axes, name))
    out["bn_update"] = bn_run(weights["densenet"], meshes["data"])
    out["micro"] = micro_step(weights["densenet"], meshes["data"])
    return out


# ---- the pytest side ----------------------------------------------------------


def _jax_models():
    import jax.numpy as jnp

    from optwboundeigenval_tpu.models import ForestNet as JForestNet
    from optwboundeigenval_tpu.models.cnn_usps import CNNUSPS as JCNNUSPS
    from optwboundeigenval_tpu.models.densenet import DenseNet3 as JDenseNet3

    return {"forest": JForestNet(dtype=jnp.float64), "cnn": JCNNUSPS(dtype=jnp.float64),
            "densenet": JDenseNet3(depth=10, growth_rate=4, num_classes=4, dtype=jnp.float64)}


def _jax_weights():
    """Float64 JAX inits of the three models, and the port's copies."""
    import jax
    import jax.numpy as jnp

    from optwboundeigenval_tpu.train.task import Task as JTask
    from optwboundeigenval_tpu_torch.utils import interop

    f64 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float64), t)
    models = _jax_models()
    jax_w, port_w = {}, {}
    for name, shape in (("forest", (1, 54)), ("cnn", (1, 16, 16, 1))):
        p, _ = JTask(model=models[name]).init(jax.random.PRNGKey(0), jnp.zeros(shape))
        jax_w[name] = (f64(p), {})
        port_w[name] = ({"forest": interop.forestnet_from_jax,
                         "cnn": interop.cnnusps_from_jax}[name](f64(p)), {})
    p, s = JTask(model=models["densenet"], has_batch_stats=True).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    jax_w["densenet"] = (f64(p), {"batch_stats": f64(s["batch_stats"])})
    port_w["densenet"] = interop.densenet3_from_jax(f64(p), f64(s["batch_stats"]))
    return jax_w, port_w


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(args):
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    port = str(_free_port())
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(RANKS),
                              port, *args], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT) for r in range(RANKS)]


@pytest.fixture(scope="module")
def ranks():
    """``(jax weights, one-process results, [rank 0, rank 1] results)``."""
    jax_w, port_w = _jax_weights()
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(port_w, os.path.join(tmp, "weights.pt"))
        procs = _spawn(["scenarios", tmp])
        try:
            one = scenarios(port_w, os.path.join(tmp, "one"), {"data": None, "model": None})
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


def _close(got, want, what, rtol=RTOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(float(np.abs(want).max(initial=0.0)), 1e-30),
                               err_msg=what)


def _close_tree(got, want, what):
    assert sorted(got) == sorted(want), what
    for k, t in want.items():
        _close(got[k], t, f"{what} {k}")


@pytest.fixture(scope="module")
def jax_av(ranks, tmp_path_factory):
    """The JAX package's Asymmetric Valley runs on ``make_mesh(data=2)``:
    ``{name: (f per epoch, log rows, results arrays, SWA params in the
    port's layout, swa_n)}``."""
    import jax

    from optwboundeigenval_tpu.optim import sgd as jsgd
    from optwboundeigenval_tpu.parallel import make_mesh
    from optwboundeigenval_tpu.train import asymmetric_valley as jav
    from optwboundeigenval_tpu.train.task import Task as JTask
    from optwboundeigenval_tpu_torch.utils import interop

    if len(jax.devices()) < 2:
        pytest.skip("need 2 virtual devices")
    jax_w = ranks[0]
    out = {}
    for name, jmodel in _jax_models().items():
        if name == "densenet":
            continue
        tmp = tmp_path_factory.mktemp(f"jav{name}")
        p0 = jax_w[name][0]
        tr = jav.AsymmetricValleyTrainer(JTask(model=jmodel), jsgd(AV_LR[name]),
                                         mesh=make_mesh(data=2), header=f"AV{name}",
                                         batch_size=AV_BATCH, mu=0.0, K=0.0, seed=3,
                                         log_dir=str(tmp / "logs"),
                                         model_dir=str(tmp / "models"), **AV)
        train, valid = _loaders(name, jax=True)
        f = _f_per_epoch(tr)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(JTask, "init", lambda self, rng, x: (jax.tree.map(np.asarray, p0), {}))
            mp.chdir(tmp)  # its plots go to ./plots
            tr.train(train_loader=train, valid_loader=valid)
        to_port = {"forest": interop.forestnet_from_jax, "cnn": interop.cnnusps_from_jax}[name]
        swa = to_port(jax.tree.map(lambda a: np.asarray(a, np.float64), tr.swa_params))
        results = {k: np.loadtxt(tmp / "logs" / f"asymmetric_valley_{k}_results.txt")
                   for k in RESULTS}
        out[name] = (f, _log_rows(tr.log_file), results, swa, tr.swa_n)
    return out


def _av_checks(got, want_f, want_rows, want_results, want_swa, want_swa_n, what):
    assert got["hunted"] and got["interpolated"] and got["swa_n"] == want_swa_n, what
    assert len(got["f"]) == len(want_f) == AV["max_iter"], what
    _close(got["f"], want_f, f"{what} f per epoch")
    _close_tree(got["swa"], want_swa, f"{what} SWA params")
    if not got["writer"]:
        assert got["files"] == [], f"{what}: a rank other than 0 wrote {got['files']}"
        return
    assert got["rows"].shape == want_rows.shape == (AV["max_iter"], 7), what
    for col, label in ((5, "val_acc"), (6, "val_f1")):
        _close(got["rows"][:, col], want_rows[:, col], f"{what} {label} per epoch")
    for k in RESULTS:
        assert got["results"][k].shape == (2 * AV["distances"] + AV["division_part"] + 1,)
        _close(got["results"][k], want_results[k], f"{what} {k}")


@pytest.mark.parametrize("name", ["forest", "cnn"])
def test_asymmetric_valley_on_a_data_mesh_matches_jax(ranks, jax_av, name):
    """``data=2``: each rank trains, evaluates and sweeps on its block of
    the global batches; rank 0's log, results and the SWA params equal the
    JAX trainer's on a 2-device mesh."""
    _, one, per_rank = ranks
    f, rows, results, swa, swa_n = jax_av[name]
    _av_checks(one[("data", name)], f, rows, results, swa, swa_n, f"one process {name}")
    for r, res in enumerate(per_rank):
        _av_checks(res[("data", name)], f, rows, results, swa, swa_n, f"rank {r} {name}")


@pytest.mark.parametrize("name", ["forest", "cnn"])
def test_asymmetric_valley_on_a_model_axis_matches_one_process(ranks, name):
    """``data=1 x model=2``: the large leaves split over the ranks, the
    SWA average on the slices, the checkpoints gathered and cut again."""
    _, one, per_rank = ranks
    want = one[("model", name)]
    expected = (["fc1.weight"] if name == "forest" else
                ["conv2.weight", "conv3.weight", "fc1.weight"])
    for r, res in enumerate(per_rank):
        got = res[("model", name)]
        assert [k for k in got["sharded"] if k.endswith("weight")] == expected
        _av_checks(got, want["f"], want.get("rows"), want.get("results"), want["swa"],
                   want["swa_n"], f"rank {r} {name} model=2")


def test_bn_update_over_a_data_mesh_matches_one_process(ranks):
    _, one, per_rank = ranks
    for r, res in enumerate(per_rank):
        _close_tree(res["bn_update"], one["bn_update"], f"rank {r} bn_update")


def test_micro_batched_step_on_a_data_mesh_matches_jax(ranks, monkeypatch, tmp_path):
    """``hvp_micro=2`` on ``data=2`` from the global batch in its natural
    order: each rank's micro-batch ``i`` is its share of the JAX package's
    global micro-batch ``i``, so the BatchNorm statistics of every pass
    are that slice's, as in the JAX trainer on a 2-device mesh."""
    import jax

    from optwboundeigenval_tpu.optim import sgd as jsgd
    from optwboundeigenval_tpu.parallel import make_mesh
    from optwboundeigenval_tpu.train import SpectralTrainer as JTrainer
    from optwboundeigenval_tpu.train.task import Task as JTask
    from optwboundeigenval_tpu_torch.utils import interop

    jax_w, one, per_rank = ranks
    p0, s0 = jax_w["densenet"]
    monkeypatch.setattr(JTask, "init", lambda self, rng, x: (
        jax.tree.map(np.asarray, p0), jax.tree.map(np.asarray, s0)))
    x, y = _images(8, 9)
    batch = {"x": x, "y": y, "w": np.ones(8, np.float32)}
    tr = JTrainer(JTask(model=_jax_models()["densenet"], has_batch_stats=True), jsgd(0.1),
                  mesh=make_mesh(data=2), header="JMICRO", log_dir=str(tmp_path),
                  model_dir=str(tmp_path), **STEP)
    tr.init_state(batch)
    m = tr.train_step(batch)
    f64 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float64), t)
    params, stats = interop.densenet3_from_jax(f64(tr.params), f64(tr.model_state["batch_stats"]))
    for who, got in [("one process", one["micro"])] + [
            (f"rank {r}", res["micro"]) for r, res in enumerate(per_rank)]:
        assert got["pow_iters"] == int(m["pow_iters"]), who
        _close(got["rho"], float(m["rho"]), f"{who} rho")
        _close(got["g"], float(m["g"]), f"{who} g")
        _close_tree(got["params"], params, f"{who} params")
        _close_tree(got["model_state"], stats, f"{who} BatchNorm statistics")


def test_a_rank_that_skips_a_collective_fails_its_peer_within_the_timeout():
    """``init_distributed(..., timeout=5 s)``: rank 1 never makes the
    all-reduce that rank 0 makes; rank 0 raises well inside 30 s instead of
    waiting gloo's default 30 minutes."""
    procs = _spawn(["hang"])
    try:
        out0 = procs[0].communicate(timeout=30)[0].decode(errors="replace")
    finally:
        for p in procs:
            p.kill()
            p.wait()
    assert procs[0].returncode == 3, out0[-4000:]
    waited = float(out0.split("raised after ")[1].split(" s")[0])
    assert 4.0 <= waited < 25.0, out0[-4000:]


def _hang(rank, world, port):
    """A rank of the hang test: rank 0 all-reduces, rank 1 never does."""
    meshlib.init_distributed(f"127.0.0.1:{port}", num_processes=world, process_id=rank,
                             device="cpu", timeout=datetime.timedelta(seconds=5))
    if rank == 1:
        time.sleep(60)
        os._exit(0)
    t0 = time.perf_counter()
    try:
        torch.distributed.all_reduce(torch.ones(4))
    except Exception as exc:  # the timeout's error, whatever its class
        print(f"raised after {time.perf_counter() - t0:.2f} s: {type(exc).__name__}: {exc}",
              flush=True)
        os._exit(3)
    os._exit(0)


if __name__ == "__main__":  # one rank of the ``ranks`` fixture or of the hang test
    rank, world, port, what = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    if what == "hang":
        _hang(rank, world, port)
    tmp = sys.argv[5]
    meshlib.init_distributed(f"127.0.0.1:{port}", num_processes=world, process_id=rank,
                             device="cpu", timeout=RANK_TIMEOUT)
    meshes = {"data": meshlib.make_mesh(data=2, device="cpu"),
              "model": meshlib.make_mesh(data=1, model=2, device="cpu")}
    weights = torch.load(os.path.join(tmp, "weights.pt"), weights_only=False)
    results = scenarios(weights, os.path.join(tmp, "ranks", str(rank)), meshes)
    torch.save(results, os.path.join(tmp, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()

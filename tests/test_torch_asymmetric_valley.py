"""The Asymmetric Valley trainer against the JAX package at float64 on the
CPU.

* ``bn_update`` on a depth-10 DenseNet3 over three batches (the last one
  short): the averaged BatchNorm statistics to rtol 1e-10 (the JAX
  package recovers them from its running-stat update by a momentum probe,
  the port reads them directly; measured ~1e-15).
* ``forest_asymmetric_valley`` through both drivers on cut data (256
  train rows, 128 valid and test) with SWA from epoch 2, the SGD hunt
  from epoch 4 and a 9-point interpolation over 6 epochs: the log and the
  four ``asymmetric_valley_*_results.txt`` files agree to rtol 1e-8
  (float64 math in other orders; measured ~1e-14).
* the trapezoid learning-rate schedule, exactly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optwboundeigenval_tpu.configs import forest_asymmetric_valley as jcfg
from optwboundeigenval_tpu.data.loaders import ArrayLoader as JaxLoader
from optwboundeigenval_tpu.models import ForestNet as JaxForestNet
from optwboundeigenval_tpu.models.densenet import DenseNet3 as JaxDenseNet3
from optwboundeigenval_tpu.optim import sgd as jsgd
from optwboundeigenval_tpu.train import asymmetric_valley as jav
from optwboundeigenval_tpu.train import driver as jdriver
from optwboundeigenval_tpu.train.task import Task as JaxTask
from optwboundeigenval_tpu_torch.configs import forest_asymmetric_valley as tcfg
from optwboundeigenval_tpu_torch.data.loaders import ArrayLoader
from optwboundeigenval_tpu_torch.models.densenet import DenseNet3
from optwboundeigenval_tpu_torch.models.mlp_forest import ForestNet
from optwboundeigenval_tpu_torch.optim.api import sgd
from optwboundeigenval_tpu_torch.train import asymmetric_valley as tav
from optwboundeigenval_tpu_torch.train import driver
from optwboundeigenval_tpu_torch.train.task import Task
from optwboundeigenval_tpu_torch.utils import interop

torch.set_num_threads(1)
RTOL = 1e-8


def test_bn_update_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(24, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=24).astype(np.int32)
    jtask = JaxTask(model=JaxDenseNet3(depth=10, growth_rate=4, dtype=jnp.float64),
                    has_batch_stats=True)
    p, s = jtask.init(jax.random.PRNGKey(1), jnp.asarray(x[:2]))
    p = jax.tree.map(lambda a: np.asarray(a, np.float64), p)
    stats = jax.tree.map(lambda a: np.asarray(a, np.float64) + 0.1, s["batch_stats"])
    want = jav.bn_update(jtask, jax.tree.map(jnp.asarray, p),
                         {"batch_stats": jax.tree.map(jnp.asarray, stats)},
                         JaxLoader(x, y, 10), lambda d: {k: jnp.asarray(v) for k, v in d.items()})
    ttask = Task(model=DenseNet3(depth=10, growth_rate=4), has_batch_stats=True)
    tp, ts = interop.densenet3_from_jax(p, stats)
    got = tav.bn_update(ttask, tp, ts, ArrayLoader(x, y, 10),
                        lambda d: {k: torch.as_tensor(v) for k, v in d.items()})
    _, want_s = interop.densenet3_from_jax(p, jax.tree.map(np.asarray, want["batch_stats"]))
    assert sorted(got) == sorted(want_s)
    for k, t in want_s.items():
        np.testing.assert_allclose(got[k].numpy(), t.numpy(), rtol=1e-10, atol=1e-12,
                                   err_msg=k)
        assert not torch.equal(got[k], ts[k])
    # no BatchNorm: nothing to do
    assert tav.bn_update(Task(model=ForestNet()), {}, {}, None, None) == {}


def test_schedule_matches_jax():
    jtr = jav.AsymmetricValleyTrainer(JaxTask(model=JaxForestNet()), jsgd(0.5), swa_start=10)
    ttr = tav.AsymmetricValleyTrainer(Task(model=ForestNet()), sgd(0.5), swa_start=10,
                                      device="cpu")
    for swa in (True, False):
        for i in range(0, 14):
            jtr.swa = ttr.swa = swa
            jtr.i = ttr.i = i
            jtr.lr_init = ttr.lr_init = 0.5
            assert ttr.schedule_lr() == jtr.schedule_lr()


def _float(s):
    try:
        return float(s)
    except ValueError:
        return s


def _log(path):
    with open(path) as fh:
        return [[_float(t) for t in ln.replace(":", " ").split()] for ln in fh]


def test_forest_asymmetric_valley_run_matches_jax(tmp_path, monkeypatch):
    jm = JaxForestNet(dtype=jnp.float64)
    p0 = jax.tree.map(lambda a: np.asarray(a, np.float64),
                      jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 54)))["params"])
    monkeypatch.setattr(JaxTask, "init", lambda self, rng, x: (jax.tree.map(jnp.asarray, p0), {}))
    monkeypatch.setattr(Task, "init", lambda self, g, dev: (interop.forestnet_from_jax(p0), {}))
    small = dict(max_iter=6, swa_start=2, sgd_start=4, save_freq=1, eval_freq=1,
                 distances=2, division_part=4)
    runs = {}
    for side, opts, run in (("jax", jcfg.options(), jdriver.run),
                            ("port", tcfg.options(device="cpu"), driver.run)):
        # the learning rate the recipe's forest_config takes, raised so the
        # hunt finds its SGD point on this cut
        opts["optimizer"] = (jsgd if side == "jax" else sgd)(1.0)
        for k, n in (("inputs", 256), ("target", 256), ("inputs_valid", 128),
                     ("target_valid", 128), ("inputs_test", 128), ("target_test", 128)):
            opts[k] = opts[k][:n]
        opts.update(small, log_dir=str(tmp_path / side / "logs"),
                    model_dir=str(tmp_path / side / "models"))
        if side == "jax":
            opts["model"] = jm
        os.makedirs(tmp_path / side, exist_ok=True)
        monkeypatch.chdir(tmp_path / side)  # the plots go to ./plots
        runs[side] = run(opts)
    jtr, ttr = runs["jax"], runs["port"]
    assert isinstance(ttr, tav.AsymmetricValleyTrainer) and ttr.header2 == jtr.header2
    assert ttr.swa_n == jtr.swa_n == 2
    assert ttr.sgd_path is not None and jtr.sgd_path is not None and ttr.interpolated
    logs = {s: tmp_path / s / "logs" for s in runs}
    got, want = (_log(logs[s] / (jtr.header2 + ".log")) for s in ("port", "jax"))
    assert len(got) == len(want) == 1 + 6 + 3 + 6
    for rg, rw in zip(got, want):
        assert len(rg) == len(rw)
        for a, b in zip(rg, rw):
            if isinstance(b, float):
                np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-12)
            else:
                assert a == b
    for key in ("train_loss", "test_loss", "train_acc", "test_acc"):
        f = f"asymmetric_valley_{key}_results.txt"
        g, w = np.loadtxt(logs["port"] / f), np.loadtxt(logs["jax"] / f)
        assert g.shape == (9,)
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=1e-12, err_msg=key)
    assert os.path.exists(tmp_path / "port" / "plots" / "asymmetric_valley_test_acc_results.png")
    assert ttr.swa_path.endswith("_av_ep3.pt") and os.path.exists(ttr.swa_path)
    assert os.path.exists(ttr.sgd_path) and "_av_sgd_ep" in ttr.sgd_path

"""The port's DenseNet3, BatchNorm, losses and weight interop against the
JAX package at float64 on the CPU.

Forwards and losses: rtol 1e-10 (same float64 math, other summation
order).  Weight maps are pure transposes, so round trips are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optwboundeigenval_tpu.models.densenet import DenseNet3 as JaxDenseNet3
from optwboundeigenval_tpu.train import task as jtask_mod
from optwboundeigenval_tpu.train.task import Task as JaxTask
from optwboundeigenval_tpu.utils.torch_interop import convert_densenet3_state_dict
from optwboundeigenval_tpu_torch.models.densenet import DenseNet3
from optwboundeigenval_tpu_torch.train import task as ttask_mod
from optwboundeigenval_tpu_torch.train.task import Task
from optwboundeigenval_tpu_torch.utils.interop import (
    densenet3_from_jax,
    densenet3_to_jax,
)

torch.set_num_threads(1)
RTOL = 1e-10


@pytest.fixture(scope="module")
def nets():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(8, 32, 32, 3))
    y = rng.integers(0, 10, size=8).astype(np.int32)
    w = np.concatenate([np.ones(7), np.zeros(1)]).astype(np.float32)
    jtask = JaxTask(model=JaxDenseNet3(depth=10, growth_rate=4, dtype=jnp.float64),
                    has_batch_stats=True)
    p, s = jtask.init(jax.random.PRNGKey(1), jnp.asarray(x))
    p = jax.tree.map(lambda a: np.asarray(a, np.float64), p)
    stats = jax.tree.map(lambda a: np.asarray(a, np.float64)
                         + rng.uniform(0.1, 0.5, size=a.shape), s["batch_stats"])
    ttask = Task(model=DenseNet3(depth=10, growth_rate=4), has_batch_stats=True)
    tp, ts = densenet3_from_jax(p, stats)
    jb = {"x": jnp.asarray(x), "y": jnp.asarray(y), "w": jnp.asarray(w)}
    tb = {"x": torch.from_numpy(x), "y": torch.from_numpy(y), "w": torch.from_numpy(w)}
    return jtask, p, stats, jb, ttask, tp, ts, tb


def test_state_names_match_the_module(nets):
    *_, ttask, tp, ts, _ = nets
    m = ttask.model
    assert sorted(tp) == sorted(k for k, _ in m.named_parameters())
    assert sorted(ts) == sorted(k for k, _ in m.named_buffers())


@pytest.mark.parametrize("train", [True, False])
def test_forward_matches_flax(nets, train):
    jtask, p, stats, jb, ttask, tp, ts, tb = nets
    variables = {"params": p, "batch_stats": stats}
    if train:
        want, _ = jtask.model.apply(variables, jb["x"], train=True,
                                    mutable=["batch_stats"])
        got = ttask._apply(tp, ts, tb["x"], True)
    else:
        want = jtask.predict(p, {"batch_stats": stats}, jb)
        got = ttask.predict(tp, ts, tb)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-12)


def test_bn_stats_update_matches_train_loss(nets):
    jtask, p, stats, jb, ttask, tp, ts, tb = nets
    jloss, jstate = jtask.train_loss(p, {"batch_stats": stats}, jb)
    tloss, tstate = ttask.train_loss(tp, ts, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL)
    _, want = densenet3_from_jax(p, jax.tree.map(np.asarray, jstate["batch_stats"]))
    assert sorted(want) == sorted(tstate)
    for k in want:
        np.testing.assert_allclose(tstate[k].numpy(), want[k].numpy(), rtol=RTOL,
                                   err_msg=k)
    # the loss function itself never moves the statistics
    ttask.loss_fn(ts)(tp, tb)
    for k, v in densenet3_from_jax(p, stats)[1].items():
        assert torch.equal(ts[k], v)


def test_interop_round_trip(nets):
    _, p, stats, *_ = nets
    fp, fs = densenet3_to_jax(*densenet3_from_jax(p, stats))
    assert jax.tree.structure(fp) == jax.tree.structure(p)
    assert jax.tree.structure(fs) == jax.tree.structure(stats)
    for a, b in zip(jax.tree.leaves(fp) + jax.tree.leaves(fs),
                    jax.tree.leaves(p) + jax.tree.leaves(stats)):
        np.testing.assert_array_equal(a, b)


def test_state_dict_maps_through_torch_interop(nets):
    """The port's state dict, exported to numpy, is a reference torch
    DenseNet3 state dict: the JAX package's own converter maps it back."""
    _, p, stats, _, ttask, tp, ts, _ = nets
    sd = {k: t.numpy() for k, t in {**tp, **ts}.items()}
    cp, cs = convert_densenet3_state_dict(sd, depth=10)
    for a, b in zip(jax.tree.leaves(cp) + jax.tree.leaves(cs),
                    jax.tree.leaves(p) + jax.tree.leaves(stats)):
        np.testing.assert_array_equal(a, b)
    assert jax.tree.structure(cp) == jax.tree.structure(p)


def test_full_width_densenet40_shapes():
    m = DenseNet3(depth=40, growth_rate=12, num_classes=10,
                  generator=torch.Generator().manual_seed(0))
    params = dict(m.named_parameters())
    buffers = dict(m.named_buffers())
    assert len(params) == 119 and sum(t.numel() for t in params.values()) == 176122
    assert len(buffers) == 78 and sum(t.numel() for t in buffers.values()) == 5088
    out = m(torch.zeros(2, 32, 32, 3), train=True)
    assert out.shape == (2, 10)


@pytest.mark.parametrize("name", sorted(ttask_mod.losses))
def test_losses_match_jax(name):
    rng = np.random.default_rng(5)
    out = rng.normal(size=(6, 4))
    w = np.array([1, 1, 0.5, 1, 0, 0], np.float32)  # padded rows w = 0
    if name in ("cross_entropy", "cross_entropy_double_softmax", "kl_onehot"):
        y = rng.integers(0, 4, size=6).astype(np.int32)
    elif name == "weighted_bce_with_logits":
        y = (rng.random((6, 4)) < 0.4).astype(np.float64)
        y[1, 2] = np.nan
    elif name == "bce_with_logits":
        y = rng.random((6, 4))
    else:
        y = rng.normal(size=(6, 4))
    want = jtask_mod.losses[name](jnp.asarray(out), jnp.asarray(y), jnp.asarray(w))
    got = ttask_mod.losses[name](torch.from_numpy(out), torch.from_numpy(y),
                                 torch.from_numpy(w))
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


def test_dropout_and_basic_blocks_are_not_ported():
    """Dropout and basic blocks are ported: a dropout DenseNet3 of either
    kind, in a dropout ``Task``, predicts as the JAX model does (eval mode:
    no dropout); its train-mode passes are held to flax's masks in
    ``tests/test_torch_dropout.py``."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(4, 32, 32, 3))
    for bottleneck in (True, False):
        kw = dict(depth=10, growth_rate=4, bottleneck=bottleneck, drop_rate=0.2,
                  reduction=0.5 if bottleneck else 1.0)
        jtask = JaxTask(model=JaxDenseNet3(dtype=jnp.float64, **kw), has_batch_stats=True,
                        has_dropout=True)
        p, s = jtask.init(jax.random.PRNGKey(2), jnp.asarray(x))
        p = jax.tree.map(lambda a: np.asarray(a, np.float64), p)
        stats = jax.tree.map(lambda a: np.asarray(a, np.float64)
                             + rng.uniform(0.1, 0.5, size=a.shape), s["batch_stats"])
        ttask = Task(model=DenseNet3(**kw), has_batch_stats=True, has_dropout=True)
        tp, ts = densenet3_from_jax(p, stats)
        want = jtask.predict(p, {"batch_stats": stats}, {"x": jnp.asarray(x)})
        got = ttask.predict(tp, ts, {"x": torch.from_numpy(x)})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-12)

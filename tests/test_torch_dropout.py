"""Dropout in the port against the JAX package at float64 on the CPU.

flax's keep masks are caught at each ``nn.Dropout`` (an interceptor runs
the layer on ones under the same key, which draws the same mask) and
injected into the port (``models/dropout.inject``), so both sides run one
network realisation:

* DenseNet3, bottleneck and basic, depth 10, ``drop_rate`` 0.2: the
  train-mode forward and ``train_loss`` (rtol 1e-12);
* one float64 spectral step of a dropout DenseNet3 (gradient, ``rho``,
  vGHv, direction, BatchNorm update at the pre-step parameters) against
  the JAX trainer's, plain, under ``remat`` and with ``hvp_micro=2``,
  where every micro-batch takes the masks of one key (rtol 1e-9, the
  tolerance of the trainer tests' float64 steps);
* the K-FAC capture under its own key (rtol 1e-12);
* the port's own rule: one key, one mask per site and shape, on the
  tensor's device, across a recomputed forward and every micro-batch.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optwboundeigenval_tpu.models.densenet import DenseNet3 as JaxDenseNet3
from optwboundeigenval_tpu.ops import kfac as jkfac
from optwboundeigenval_tpu.optim import sgd as jax_sgd
from optwboundeigenval_tpu.train import SpectralTrainer as JaxTrainer
from optwboundeigenval_tpu.train import Task as JaxTask
from optwboundeigenval_tpu.utils.torch_interop import convert_densenet3_state_dict
from optwboundeigenval_tpu.utils.tree import tree_uniform_like as jax_uniform
from optwboundeigenval_tpu_torch.models import dropout
from optwboundeigenval_tpu_torch.models.densenet import DenseNet3
from optwboundeigenval_tpu_torch.ops import curvature, kfac
from optwboundeigenval_tpu_torch.optim import api as topt
from optwboundeigenval_tpu_torch.train.task import Task
from optwboundeigenval_tpu_torch.train.trainer import SpectralTrainer
from optwboundeigenval_tpu_torch.utils import interop
from optwboundeigenval_tpu_torch.utils.tree import tree_norm, tree_sub, tree_uniform_like

torch.set_num_threads(1)
RTOL = 1e-12
STEP_RTOL = 1e-9
SOLVER = dict(mu=0.01, K=0.0, pow_iter_eps=0.05, max_pow_iter=100)


def flax_masks(jmodel, variables, x, key):
    """The keep masks flax's dropout layers draw from ``key`` on ``x``, in
    call order, as NCHW boolean arrays."""

    def run(variables, x, key):
        masks = []

        def catch(next_fun, args, kwargs, context):
            if isinstance(context.module, fnn.Dropout) and context.method_name == "__call__":
                keep = next_fun(jnp.ones_like(args[0]), *args[1:], **kwargs) != 0
                masks.append(keep)
                return jnp.where(keep, args[0] / (1.0 - context.module.rate), 0.0)
            return next_fun(*args, **kwargs)

        with fnn.intercept_methods(catch):
            jmodel.apply(variables, x, train=True, rngs={"dropout": key},
                         mutable=["batch_stats"])
        return masks

    masks = jax.jit(run)(variables, jnp.asarray(x), key)
    return [np.asarray(m).transpose(0, 3, 1, 2) if m.ndim == 4 else np.asarray(m)
            for m in masks]


def injector(model, jmodel, variables, key, *xs):
    """``masks(key, site, shape)`` for ``dropout.inject``: flax's masks of
    ``key`` on each input of ``xs`` (one per batch shape)."""
    table = {}
    for x in xs:
        for site, m in zip(dropout.sites(model), flax_masks(jmodel, variables, x, key)):
            table[(site, m.shape)] = torch.from_numpy(m)
    return lambda _key, site, shape: table[(site, shape)]


def _models(bottleneck, depth=10, growth=4):
    kw = dict(depth=depth, growth_rate=growth, bottleneck=bottleneck, drop_rate=0.2,
              reduction=0.5 if bottleneck else 1.0)
    return JaxDenseNet3(dtype=jnp.float64, **kw), DenseNet3(**kw)


def _state(jmodel, x, seed=0):
    variables = jax.jit(lambda r: jmodel.init({"params": r, "dropout": r},
                                              jnp.asarray(x), train=False))(
        jax.random.PRNGKey(1))
    rng = np.random.default_rng(seed)
    p = jax.tree.map(lambda a: np.asarray(a, np.float64), variables["params"])
    stats = jax.tree.map(lambda a: np.asarray(a, np.float64)
                         + rng.uniform(0.0, 0.2, size=a.shape), variables["batch_stats"])
    return p, stats


def _batch(n=8, seed=3):
    rng = np.random.default_rng(seed)
    w = np.ones(n, np.float32)
    w[-1] = 0.0
    return {"x": rng.normal(size=(n, 32, 32, 3)),
            "y": rng.integers(0, 10, size=n).astype(np.int32), "w": w}


def _close(got, want, rtol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max(),
                               err_msg=what)


@pytest.mark.parametrize("bottleneck", [True, False])
def test_forward_and_train_loss_match_flax_with_its_masks(bottleneck):
    jm, tm = _models(bottleneck)
    b = _batch()
    p, stats = _state(jm, b["x"])
    variables = {"params": p, "batch_stats": stats}
    key = jax.random.PRNGKey(7)
    masks = flax_masks(jm, variables, b["x"], key)
    assert len(masks) == len(dropout.sites(tm)) == (3 * (1 if bottleneck else 2)
                                                    * (2 if bottleneck else 1) + 2)
    assert all(0.6 < m.mean() < 0.95 for m in masks)
    jtask = JaxTask(model=jm, has_batch_stats=True, has_dropout=True)
    ttask = Task(model=tm, has_batch_stats=True, has_dropout=True)
    tp, ts = interop.densenet3_from_jax(p, stats)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    want_out, (want_loss, want_state), want_eval = jax.jit(lambda b: (
        jm.apply(variables, b["x"], train=True, rngs={"dropout": key},
                 mutable=["batch_stats"])[0],
        jtask.train_loss(p, {"batch_stats": stats}, b, key),
        jtask.predict(p, {"batch_stats": stats}, b)))(jb)
    with dropout.inject(injector(tm, jm, variables, key, b["x"])):
        got_out = ttask._apply(tp, ts, tb["x"], True, key=1)
        got_loss, got_state = ttask.train_loss(tp, ts, tb, key=1)
    _close(got_out.detach(), want_out, RTOL, "outputs")
    _close(float(got_loss), float(want_loss), RTOL, "loss")
    _, want_s = interop.densenet3_from_jax(p, jax.tree.map(np.asarray, want_state["batch_stats"]))
    for k in want_s:
        _close(got_state[k], want_s[k], RTOL, k)
    # eval mode runs no dropout: no key, no masks
    _close(ttask.predict(tp, ts, tb), want_eval, RTOL)


def test_basic_block_weights_cross_both_ways():
    jm, tm = _models(bottleneck=False)
    p, stats = _state(jm, _batch()["x"])
    tp, ts = interop.densenet3_from_jax(p, stats)
    assert sorted(tp) == sorted(k for k, _ in tm.named_parameters())
    assert sorted(ts) == sorted(k for k, _ in tm.named_buffers())
    fp, fs = interop.densenet3_to_jax(tp, ts)
    cp, cs = convert_densenet3_state_dict({k: t.numpy() for k, t in {**tp, **ts}.items()},
                                          depth=10, bottleneck=False)
    for tree in ((fp, fs), (cp, cs)):
        assert jax.tree.structure(tree) == jax.tree.structure((p, stats))
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves((p, stats))):
            np.testing.assert_array_equal(a, b)


@functools.lru_cache(maxsize=None)
def _jax_step(hvp_micro):
    """The JAX trainer's step on a basic dropout DenseNet3 from float64
    weights, with the masks of its step key as port injection.  (JAX's
    ``remat`` is ``jax.checkpoint`` of the same loss, the same function,
    so the port's remat step is held to the plain step.)"""
    b = _batch()
    jm, tm = _models(bottleneck=False, depth=7)
    jtr = JaxTrainer(JaxTask(model=jm, has_batch_stats=True, has_dropout=True),
                     jax_sgd(0.1, momentum=0.9, weight_decay=1e-4),
                     hvp_micro=hvp_micro, **SOLVER)
    jtr.init_state(b)
    p, stats = _state(jm, b["x"])
    jtr.params = jax.tree.map(jnp.asarray, p)
    jtr.model_state = {"batch_stats": jax.tree.map(jnp.asarray, stats)}
    jtr.opt_state = jtr.optimizer.init(jtr.params)
    jtr.v = jax_uniform(jtr.params)
    # the key the JAX step closes its loss over (trainer.py:516-518, 846)
    rng_step = jax.random.split(jax.random.split(jtr.rng)[1])[0]
    shapes = [b["x"]] + ([b["x"][:len(b["x"]) // hvp_micro]] if hvp_micro else [])
    inject = injector(tm, jm, {"params": p, "batch_stats": stats}, rng_step, *shapes)
    metrics = jtr.train_step(b)
    after = interop.densenet3_from_jax(jax.tree.map(np.asarray, jtr.params),
                                       jax.tree.map(np.asarray, jtr.model_state["batch_stats"]))
    v = interop.densenet3_from_jax(jax.tree.map(np.asarray, jtr.v), stats)[0]
    return b, p, stats, inject, metrics, after, v


@pytest.mark.parametrize("hvp_micro,remat", [(0, False), (0, True), (2, False)],
                         ids=["plain", "remat", "hvp_micro=2"])
def test_spectral_step_matches_jax_with_its_masks(hvp_micro, remat):
    b, p, stats, inject, jm, (want_p, want_s), want_v = _jax_step(hvp_micro)
    tm_ = _models(bottleneck=False, depth=7)[1]
    ttr = SpectralTrainer(Task(model=tm_, has_batch_stats=True, has_dropout=True),
                          topt.sgd(0.1, momentum=0.9, weight_decay=1e-4),
                          hvp_micro=hvp_micro, remat=remat, device="cpu", **SOLVER)
    ttr.params, ttr.model_state = interop.densenet3_from_jax(p, stats)
    ttr.opt_state = ttr.optimizer.init(ttr.params)
    ttr.v = tree_uniform_like(ttr.params)
    with dropout.inject(inject):
        tm = ttr.train_step(b)
    assert tm["step_ok"] and jm["step_ok"]
    assert tm["pow_iters"] == int(jm["pow_iters"])
    assert tm["g"] > 0  # K = 0: the vGHv pass ran
    for k in ("rho", "g", "gradf_norm", "gradg_norm", "norm"):
        _close(tm[k], float(jm[k]), STEP_RTOL, k)
    for got, want in ((ttr.params, want_p), (ttr.model_state, want_s), (ttr.v, want_v)):
        for k in want:
            _close(got[k], want[k], STEP_RTOL, k)


def test_kfac_capture_matches_jax_under_its_own_key():
    jm, tm = _models(bottleneck=False, depth=7)
    b = _batch()
    p, stats = _state(jm, b["x"])
    variables = {"params": p, "batch_stats": stats}
    key = jax.random.PRNGKey(11)
    jtask = JaxTask(model=jm, has_batch_stats=True, has_dropout=True)
    def run(b):
        loss, caps = jkfac.capture(jtask, p, {"batch_stats": stats}, b, key)
        return loss, {path: (cap.a, cap.g) for path, cap in caps.items()}

    jloss, jcaps = jax.jit(run)({k: jnp.asarray(v) for k, v in b.items()})
    ttask = Task(model=tm, has_batch_stats=True, has_dropout=True)
    tp, ts = interop.densenet3_from_jax(p, stats)
    with dropout.inject(injector(tm, jm, variables, key, b["x"])):
        tloss, tcaps = kfac.capture(ttask, tp, ts, {k: torch.from_numpy(v) for k, v in b.items()},
                                    key=5)
    _close(float(tloss), float(jloss), RTOL)
    names = interop.module_names(tm)
    assert sorted(names[path] for path in jcaps) == sorted(tcaps)
    nchw = lambda a: np.asarray(a).transpose(0, 3, 1, 2) if np.ndim(a) == 4 else np.asarray(a)
    for path, (a, g) in jcaps.items():
        got = tcaps[names[path]]
        _close(got.a, nchw(a), RTOL, f"{path} a")
        _close(got.g, nchw(g), RTOL, f"{path} g")


def _dropout_task():
    m = DenseNet3(depth=7, growth_rate=3, bottleneck=False, drop_rate=0.2, reduction=1.0,
                  generator=torch.Generator().manual_seed(0)).double()
    task = Task(model=m, has_batch_stats=True, has_dropout=True)
    params, state = task.init(torch.Generator().manual_seed(0), "cpu")
    params = {k: t.double() for k, t in params.items()}
    state = {k: t.double() for k, t in state.items()}
    b = {k: torch.from_numpy(v) for k, v in _batch().items()}
    return task, params, state, b


def test_one_key_draws_one_mask_per_site_and_shape():
    task, params, state, b = _dropout_task()
    out = lambda key, x=b["x"]: task._apply(params, state, x, True, key=key).detach()
    assert torch.equal(out(3), out(3))
    assert not torch.equal(out(3), out(4))
    # a slice of another shape draws its own masks; slices of one shape share them
    seen = {}

    def record(key, site, shape):
        x = torch.empty(shape, dtype=torch.float64)
        mask = dropout.keep_mask(key, site, x, 0.8)
        seen.setdefault((site, shape), []).append(mask)
        return mask

    with dropout.inject(record):
        for half in (b["x"][:4], b["x"][4:]):
            out(9, half)
    assert all(len(ms) == 2 and torch.equal(*ms) for ms in seen.values())
    keep = torch.cat([m[0].flatten().double() for m in seen.values()]).mean()
    assert 0.75 < float(keep) < 0.85


def test_recomputed_and_micro_batched_products_keep_the_masks():
    """remat's recomputed HVP equals the kept graph's under one key; each
    micro-batched product equals the sum of per-slice products under it."""
    task, params, state, b = _dropout_task()
    v = tree_uniform_like(params)
    loss = task.loss_fn(state, 21)
    _, kept = curvature.linearize_hvp(loss, params, b)
    _, recomputed = curvature.recompute_hvp(loss, params, b)
    a, r = kept(v), recomputed(v)
    assert float(tree_norm(tree_sub(a, r)) / tree_norm(a)) < RTOL
    other = curvature.hvp(task.loss_fn(state, 22), params, b, v)
    assert float(tree_norm(tree_sub(a, other)) / tree_norm(a)) > 1e-3
    w = b["w"]  # float32: the scales are, as in the JAX package
    for name in ("hvp", "vghv"):
        micro = getattr(curvature, f"{name}_microbatched")(loss, params, b, v, 2)
        parts = [getattr(curvature, name)(loss, params, {k: t[s] for k, t in b.items()}, v)
                 for s in (slice(0, 4), slice(4, 8))]
        scales = [float(w[:4].sum() / w.sum()), float(w[4:].sum() / w.sum())]
        want = {k: scales[0] * parts[0][k] + scales[1] * parts[1][k] for k in micro}
        assert float(tree_norm(tree_sub(micro, want)) / tree_norm(want)) < RTOL, name


def test_train_mode_dropout_needs_a_key():
    task, params, state, b = _dropout_task()
    with pytest.raises(RuntimeError, match="needs a key"):
        task.loss_fn(state)(params, b)
    plain = Task(model=task.model, has_batch_stats=True)
    with pytest.raises(RuntimeError, match="needs a key"):
        plain.loss_fn(state, 3)(params, b)  # a task without dropout passes no key
    assert torch.isfinite(task.predict(params, state, b)).all()


def test_trainer_draws_one_key_a_step_from_its_own_stream():
    task, _, _, b = _dropout_task()
    keys = []

    def build():
        tr = SpectralTrainer(task, topt.sgd(0.1), device="cpu", **{**SOLVER, "max_pow_iter": 3})
        tr.init_state()
        return tr

    def record(key, site, shape):
        keys.append(key)
        return dropout.keep_mask(key, site, torch.empty(shape), 0.8)

    first, second = build(), build()
    gen_state = first.generator.get_state()
    with dropout.inject(record):
        m1 = first.train_step({k: v.numpy() for k, v in b.items()})
    assert len(set(keys)) == 1 and keys[0] == dropout.step_key(first.seed, 1)
    assert torch.equal(first.generator.get_state(), gen_state)  # the optimizer's stream
    m2 = second.train_step({k: v.numpy() for k, v in b.items()})
    assert m1["rho"] == m2["rho"] and first._dropout_draws == 1

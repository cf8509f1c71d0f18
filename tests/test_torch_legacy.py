"""The legacy loops, the VAE and the logistic regression of the port
against the JAX package at float64 on the CPU (rtol 1e-12 for every
value; the BatchNorm statistics, parameters and meters after an epoch
too), as ``tests/test_aux.py`` drives the JAX ones: ``train_epoch`` on a
ForestNet and on a small DenseNet3 (the statistics at the post-step
parameters), ``train2_epoch`` on a VAE over a ForestNet (statistics never
updated) with the JAX step's noise injected, ``validate``, the sigmoid
``test`` (the port's numpy AUC against sklearn's), copy-on-best
checkpoints; the VAE over a DenseNet trunk and ``vae_loss``."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optwboundeigenval_tpu.models import ForestNet as JaxForestNet
from optwboundeigenval_tpu.models.backbones import DenseNetFeatures as JaxDenseNetFeatures
from optwboundeigenval_tpu.models.densenet import DenseNet3 as JaxDenseNet3
from optwboundeigenval_tpu.models.logistic import LogisticRegression as JaxLogistic
from optwboundeigenval_tpu.models.vae import VAE as JaxVAE
from optwboundeigenval_tpu.models.vae import vae_loss as jax_vae_loss
from optwboundeigenval_tpu.optim import sgd as jax_sgd
from optwboundeigenval_tpu.train import Task as JaxTask
from optwboundeigenval_tpu.train import legacy as jlegacy
from optwboundeigenval_tpu_torch.models.backbones import DenseNetFeatures
from optwboundeigenval_tpu_torch.models.densenet import DenseNet3
from optwboundeigenval_tpu_torch.models.logistic import LogisticRegression
from optwboundeigenval_tpu_torch.models.mlp_forest import ForestNet
from optwboundeigenval_tpu_torch.models.vae import VAE, vae_loss
from optwboundeigenval_tpu_torch.optim import api as topt
from optwboundeigenval_tpu_torch.train import checkpoints, legacy
from optwboundeigenval_tpu_torch.train.task import Task
from optwboundeigenval_tpu_torch.utils import interop

torch.set_num_threads(1)
RTOL = 1e-12


def _close(got, want, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def _forest_batches(n_classes=3, multilabel=False, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(3):
        w = np.ones(32, np.float32)
        if i == 2:
            w[-5:] = 0.0  # the padded last batch
        y = ((rng.random((32, n_classes)) > 0.5).astype(np.float64) if multilabel
             else rng.integers(0, n_classes, 32).astype(np.int32))
        out.append({"x": rng.normal(size=(32, 8)), "y": y, "w": w})
    return out


def _forest_pair(seed=0):
    jtask = JaxTask(model=JaxForestNet(hidden=8, num_classes=3, dtype=jnp.float64))
    p, _ = jtask.init(jax.random.PRNGKey(seed), jnp.zeros((2, 8), jnp.float64))
    ttask = Task(model=ForestNet(hidden=8, num_classes=3, in_features=8))
    return jtask, _f64(p), ttask, interop.forestnet_from_jax(_f64(p))


def test_train_epoch_and_validate_match_jax_on_forest():
    jtask, p, ttask, tp = _forest_pair()
    loader = _forest_batches()
    jopt, topt_ = jax_sgd(0.2, momentum=0.9), topt.sgd(0.2, momentum=0.9)
    jstate, tstate = jopt.init(p), topt_.init(tp)
    for epoch in range(2):
        p, _, jstate, javg = jlegacy.train_epoch(jtask, p, {}, jopt, jstate, loader,
                                                 jax.random.PRNGKey(epoch))
        tp, _, tstate, tavg = legacy.train_epoch(ttask, tp, {}, topt_, tstate, loader)
        _close(tavg, javg, f"epoch {epoch} loss")
    want = interop.forestnet_from_jax(_f64(p))
    for k in want:
        _close(tp[k], want[k], k)
    for (tl, ta), (jl, ja) in ((legacy.validate(ttask, tp, {}, loader),
                                jlegacy.validate(jtask, p, {}, loader)),):
        _close(tl, jl, "validate loss")
        assert ta == ja


def test_train_epoch_updates_bn_at_the_post_step_params():
    kw = dict(depth=7, growth_rate=3, bottleneck=False, reduction=1.0)
    jtask = JaxTask(model=JaxDenseNet3(dtype=jnp.float64, **kw), has_batch_stats=True)
    ttask = Task(model=DenseNet3(**kw), has_batch_stats=True)
    rng = np.random.default_rng(4)
    loader = [{"x": rng.normal(size=(4, 32, 32, 3)), "y": rng.integers(0, 10, 4).astype(np.int32),
               "w": np.ones(4, np.float32)} for _ in range(2)]
    p, s = jtask.init(jax.random.PRNGKey(0), jnp.asarray(loader[0]["x"]))
    p, stats = _f64(p), _f64(s["batch_stats"])
    tp, ts = interop.densenet3_from_jax(p, stats)
    jopt, topt_ = jax_sgd(0.1), topt.sgd(0.1)
    p, s, _, javg = jlegacy.train_epoch(jtask, p, {"batch_stats": stats}, jopt, jopt.init(p),
                                        loader, jax.random.PRNGKey(1))
    tp, ts, _, tavg = legacy.train_epoch(ttask, tp, ts, topt_, topt_.init(tp), loader)
    _close(tavg, javg, "loss")
    want_p, want_s = interop.densenet3_from_jax(_f64(p), _f64(s["batch_stats"]))
    for got, want in ((tp, want_p), (ts, want_s)):
        for k in want:
            _close(got[k], want[k], k)


def _vae_pair(encoder="forest", seed=0, x=None):
    if encoder == "forest":
        jm = JaxVAE(encoder=JaxForestNet(hidden=8, num_classes=8, dtype=jnp.float64),
                    znum=6, hnum=8, outnum=4, dtype=jnp.float64)
        tm = VAE(ForestNet(hidden=8, num_classes=8, in_features=12), znum=6, hnum=8,
                 outnum=4, in_features=8)
    else:
        jm = JaxVAE(encoder=JaxDenseNetFeatures((1, 1), 4, 8, 2, dtype=jnp.float64),
                    znum=6, hnum=8, outnum=4, dtype=jnp.float64)
        tm = VAE(DenseNetFeatures((1, 1), 4, 8, 2), znum=6, hnum=8, outnum=4)
    variables = jm.init({"params": jax.random.PRNGKey(seed), "reparam": jax.random.PRNGKey(1)},
                        jnp.asarray(x), train=False)
    p = _f64(variables["params"])
    rng = np.random.default_rng(seed)
    stats = jax.tree.map(lambda a: np.asarray(a, np.float64) + rng.uniform(0.0, 0.2, a.shape),
                         variables.get("batch_stats", {}))
    tp, ts = interop.from_jax(tm, p, stats)
    return jm, tm, p, stats, tp, ts


def jax_noise(jm, variables, x, key):
    """The VAE's reparameterising noise under ``key``, from the ``de1``
    input ``z`` and the ``mu``/``logvar`` heads' outputs."""
    seen = {}

    def catch(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if context.method_name == "__call__" and context.module.name in ("mu_fc", "logv_fc", "de1"):
            seen[context.module.name] = args[0] if context.module.name == "de1" else out
        return out

    kw = {"mutable": ["batch_stats"]} if "batch_stats" in variables else {}
    with fnn.intercept_methods(catch):
        jm.apply(variables, jnp.asarray(x), train=True, rngs={"reparam": key}, **kw)
    mu, logvar, z = (np.asarray(seen[k]) for k in ("mu_fc", "logv_fc", "de1"))
    return (z - mu) / np.exp(0.5 * logvar)


@pytest.mark.parametrize("encoder", ["forest", "densenet"])
def test_vae_forward_and_loss_match_jax_with_its_noise(encoder):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(6, 12)) if encoder == "forest" else rng.normal(size=(6, 32, 32, 3))
    y = (rng.random((6, 4)) > 0.5).astype(np.float64)
    y[0, 1] = np.nan
    w = np.array([1, 1, 1, 1, 1, 0], np.float32)
    jm, tm, p, stats, tp, ts = _vae_pair(encoder, x=x)
    variables = {"params": p, **({"batch_stats": stats} if stats else {})}
    key = jax.random.PRNGKey(5)
    noise = jax_noise(jm, variables, x, key)
    kw = {"mutable": ["batch_stats"]} if stats else {}
    out = jm.apply(variables, jnp.asarray(x), train=True, rngs={"reparam": key}, **kw)
    want = out[0] if stats else out
    got = torch.func.functional_call(tm, (tp, ts), (torch.from_numpy(x),),
                                     {"train": True, "noise": torch.from_numpy(noise)})
    for g, wv, name in zip(got, want, ("logits", "mu", "logvar")):
        _close(g, wv, name)
    for kl in (0.0, 0.3):
        _close(vae_loss(got, torch.from_numpy(y), torch.from_numpy(w), kl_weight=kl),
               jax_vae_loss(want, jnp.asarray(y), jnp.asarray(w), kl_weight=kl), f"kl {kl}")
    evals = (torch.func.functional_call(tm, (tp, ts), (torch.from_numpy(x),)),
             jm.apply(variables, jnp.asarray(x), train=False))
    for g, wv in zip(*evals):
        _close(g, wv, "eval")
    with pytest.raises(ValueError, match="noise or a generator"):
        torch.func.functional_call(tm, (tp, ts), (torch.from_numpy(x),), {"train": True})


def test_train2_epoch_matches_jax_and_leaves_bn_alone():
    batches = _forest_batches(n_classes=4, multilabel=True, seed=1)
    for b in batches:
        b["x"] = np.concatenate([b["x"], b["x"][:, :4]], axis=1)  # 12 features
    jm, tm, p, _, tp, ts = _vae_pair("forest", x=batches[0]["x"])
    rng = jax.random.PRNGKey(2)
    noises = []
    for b in batches:  # the keys train2_epoch splits, one a batch (legacy.py:97-99)
        rng, r = jax.random.split(rng)
        noises.append(torch.from_numpy(jax_noise(jm, {"params": p}, b["x"], r)))
    jopt, topt_ = jax_sgd(0.05), topt.sgd(0.05)
    jp, _, _, javg = jlegacy.train2_epoch(jm, p, {}, jopt, jopt.init(p), batches,
                                          jax.random.PRNGKey(2), kl_weight=0.1)
    tp2, ts2, _, tavg = legacy.train2_epoch(tm, tp, ts, topt_, topt_.init(tp), batches,
                                            kl_weight=0.1, noises=noises)
    _close(tavg, javg, "loss")
    want = interop.from_jax(tm, _f64(jp), {})[0]
    for k in want:
        _close(tp2[k], want[k], k)
    assert ts2 is ts
    with pytest.raises(ValueError, match="generator or the noises"):
        legacy.train2_epoch(tm, tp, ts, topt_, topt_.init(tp), batches)
    g = torch.Generator().manual_seed(0)
    assert np.isfinite(legacy.train2_epoch(tm, tp, ts, topt_, topt_.init(tp), batches, g)[3])


def test_sigmoid_test_matches_jax_and_sklearn():
    batches = _forest_batches(n_classes=4, multilabel=True, seed=3)
    for b in batches:
        b["x"] = np.concatenate([b["x"], b["x"][:, :4]], axis=1)
    jm, tm, p, _, tp, ts = _vae_pair("forest", x=batches[0]["x"])

    class JaxWrap:
        @staticmethod
        def predict(params, ms, batch):
            return jm.apply({"params": params, **ms}, batch["x"], train=False)[0]

    class TorchWrap:
        @staticmethod
        def predict(params, ms, batch):
            return torch.func.functional_call(tm, (params, ms), (batch["x"],))[0]

    jroc, javg, (jl, jo) = jlegacy.test(JaxWrap, p, {}, batches)
    troc, tavg, (tl, to) = legacy.test(TorchWrap, tp, ts, batches)
    assert troc.shape == (4,)
    np.testing.assert_array_equal(tl, jl)
    _close(to, jo, "outputs")
    _close(troc, jroc, "per-class AUC")
    _close(tavg, javg, "mean AUC")


def test_meter_and_copy_on_best(tmp_path):
    m = legacy.AverageMeter()
    m.update(1.0, 2)
    m.update(2.0, 2)
    assert m.avg == 1.5 and m.val == 2.0 and m.count == 4
    payload = {"params": {"w": torch.arange(3.0)}, "epoch": 2}
    path = str(tmp_path / "ck.pt")
    assert legacy.save_checkpoint_copy_on_best(payload, False, path=path) == path
    best = legacy.save_checkpoint_copy_on_best(payload, True, path=path)
    assert best == str(tmp_path / "ck_best.pt")
    loaded = checkpoints.load_checkpoint(best)
    assert loaded["epoch"] == 2 and torch.equal(loaded["params"]["w"], torch.arange(3.0))


def test_logistic_regression_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(5, 4, 4, 3))
    jm = JaxLogistic(num_outputs=2, dtype=jnp.float64)
    p = _f64(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    tm = LogisticRegression(48, num_outputs=2)
    tp, _ = interop.from_jax(tm, p, {})
    _close(torch.func.functional_call(tm, tp, (torch.from_numpy(x),)),
           jm.apply({"params": p}, jnp.asarray(x)), "logits")
    fp, _ = interop.to_jax(tm, tp, {})
    np.testing.assert_array_equal(fp["Dense_0"]["kernel"], p["Dense_0"]["kernel"])

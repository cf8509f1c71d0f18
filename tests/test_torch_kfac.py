"""The port's K-FAC (``ops/kfac.py``), its factor interop and the
preconditioned power iteration against the JAX package at float64 on the
CPU, on ForestNet (``fc2`` applied twice), CNNUSPS (convs and the
permuted ``fc1``) and a depth-10 DenseNet3 (BatchNorm, bias-free convs).

The captures, covariances, running factors and the tree-form natural
gradient agree to rtol 1e-10 (the same float64 math in other orders;
measured ~1e-15).  ``eigh`` picks eigenvector signs and bases of
degenerate eigenspaces differently in the two backends, so factors are
compared as matrices and the natural gradient in tree form, never ``Q``
alone.  The preconditioned power iteration takes the same number of
iterations and gives ``rho`` and ``v`` to rtol 1e-10.  Factor interop
round trips are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optwboundeigenval_tpu.models import CNNUSPS as JaxCNNUSPS
from optwboundeigenval_tpu.models import ForestNet as JaxForestNet
from optwboundeigenval_tpu.models.densenet import DenseNet3 as JaxDenseNet3
from optwboundeigenval_tpu.ops import curvature as jcurv
from optwboundeigenval_tpu.ops import eigen as jeig
from optwboundeigenval_tpu.ops import kfac as jkfac
from optwboundeigenval_tpu.train.task import Task as JaxTask
from optwboundeigenval_tpu.utils.tree import tree_uniform_like as jax_uniform
from optwboundeigenval_tpu_torch.models.cnn_usps import CNNUSPS
from optwboundeigenval_tpu_torch.models.densenet import DenseNet3
from optwboundeigenval_tpu_torch.models.mlp_forest import ForestNet
from optwboundeigenval_tpu_torch.ops import curvature as tcurv
from optwboundeigenval_tpu_torch.ops import eigen as teig
from optwboundeigenval_tpu_torch.ops import kfac as tkfac
from optwboundeigenval_tpu_torch.optim.api import sgd
from optwboundeigenval_tpu_torch.train.task import Task
from optwboundeigenval_tpu_torch.train.trainer import SpectralTrainer, resolve_eigensolver
from optwboundeigenval_tpu_torch.utils import interop

torch.set_num_threads(1)
RTOL = 1e-10


def _close(got, want, what, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-300),
                               err_msg=what)


def _batch(xshape, n, classes, pad, seed):
    rng = np.random.default_rng(seed)
    w = np.ones(n, np.float32)
    if pad:
        w[-pad:] = 0.0
    return {"x": rng.normal(size=(n,) + xshape).astype(np.float32),
            "y": rng.integers(0, classes, size=n).astype(np.int32), "w": w}


def _model(name):
    """``(jax task, jax params, jax state, port task, port params, port
    state, example batch)`` at the same float64 weights."""
    if name == "forest":
        jm, tm, xshape, classes = JaxForestNet(dtype=jnp.float64), ForestNet(), (54,), 7
    elif name == "usps":
        jm, tm, xshape, classes = JaxCNNUSPS(dtype=jnp.float64), CNNUSPS(), (16, 16, 1), 10
    else:
        jm = JaxDenseNet3(depth=10, growth_rate=4, dtype=jnp.float64)
        tm, xshape, classes = DenseNet3(depth=10, growth_rate=4), (32, 32, 3), 10
    bn = name == "densenet"
    batch = _batch(xshape, 12, classes, 3, 5)
    jtask = JaxTask(model=jm, has_batch_stats=bn)
    p, s = jtask.init(jax.random.PRNGKey(2), jnp.asarray(batch["x"]))
    p = jax.tree.map(lambda a: np.asarray(a, np.float64), p)
    if bn:
        rng = np.random.default_rng(0)
        stats = jax.tree.map(lambda a: np.asarray(a, np.float64)
                             + rng.uniform(0.0, 0.2, size=a.shape), s["batch_stats"])
        tp, ts = interop.densenet3_from_jax(p, stats)
        js = {"batch_stats": jax.tree.map(jnp.asarray, stats)}
    else:
        tp = (interop.forestnet_from_jax if name == "forest" else interop.cnnusps_from_jax)(p)
        ts, js = {}, {}
    ttask = Task(model=tm, has_batch_stats=bn)
    return jtask, jax.tree.map(jnp.asarray, p), js, ttask, tp, ts, batch


def _tree_to_port(name, jtree, js):
    """A JAX gradient-like tree in the port's layout (the weight maps are
    linear, so they carry gradients too)."""
    jtree = jax.tree.map(np.asarray, jtree)
    if name == "forest":
        return interop.forestnet_from_jax(jtree)
    if name == "usps":
        return interop.cnnusps_from_jax(jtree)
    stats = jax.tree.map(np.asarray, js["batch_stats"])
    return interop.densenet3_from_jax(jtree, stats)[0]


def _jax_batch(batch, w=True):
    return {k: jnp.asarray(v) for k, v in batch.items() if w or k != "w"}


def _port_batch(batch, w=True):
    return {k: torch.from_numpy(v) for k, v in batch.items() if w or k != "w"}


MODELS = ["forest", "usps", "densenet"]


def _jax_side(jtask, jp, js, batch):
    """Everything the tests read from the JAX package, in one jitted
    program: per batch form (weighted, unweighted) the loss and each
    layer's ``(a, g, cov_a, cov_g batch-averaged, cov_g not)``; the
    factors after two EMA updates from identity and their inverses; the
    natural gradient of the loss gradient (damping 1e-3)."""

    def side(p, s, bw, bu):
        out = {}
        for key, b in (("weighted", bw), ("unweighted", bu)):
            loss, caps = jkfac.capture(jtask, p, s, b)
            out[key] = (loss, {k: (c.a, c.g, jkfac.cov_a(c, "bias" in _node(p, k)),
                                   jkfac.cov_g(c, True), jkfac.cov_g(c, False))
                               for k, c in caps.items()})
        _, caps = jkfac.capture(jtask, p, s, bw)
        f = jkfac.init_factors(jtask, p, s, bw)
        for _ in range(2):
            f = jkfac.update_factors(f, caps, p, 0.95)
        f = jkfac.compute_inverses(f)
        g = jax.grad(jtask.loss_fn(s))(p, bw)
        return out, f, jkfac.apply_to_tree(f, g, 1e-3)

    return jax.jit(side)(jp, js, _jax_batch(batch), _jax_batch(batch, False))


def _node(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


_CACHE = {}


def _sides(name):
    """``(model tuple, JAX side)`` for ``name``, built once per worker."""
    if name not in _CACHE:
        m = _model(name)
        _CACHE[name] = (m, _jax_side(m[0], m[1], m[2], m[6]))
    return _CACHE[name]


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("weighted", [True, False])
def test_capture_and_covariances_match_jax(name, weighted):
    """Layer inputs and grad-outputs, then ``cov_a``/``cov_g`` (with the
    padding mask and without ``w``), carried through the factor interop."""
    (jtask, jp, js, ttask, tp, ts, batch), (jout, _, _) = _sides(name)
    jloss, jcaps = jout["weighted" if weighted else "unweighted"]
    tloss, tcaps = tkfac.capture(ttask, tp, ts, _port_batch(batch, weighted))
    _close(float(tloss), float(jloss), "loss")
    names = interop._layer_names(jcaps)
    assert sorted(tcaps) == sorted(names.values())
    for ba in (True, False):
        jcov = {}
        for path, (ja, jg, aa, gg_avg, gg) in jcaps.items():
            gg = gg_avg if ba else gg
            jcov[path] = jkfac.LayerFactors(m_aa=aa, m_gg=gg, Q_a=aa, d_a=jnp.diag(aa),
                                            Q_g=gg, d_g=jnp.diag(gg))
        want = interop.kfac_factors_from_jax(jcov, tp)
        for layer, tc in tcaps.items():
            _close(tkfac.cov_a(tc, f"{layer}.bias" in tp).numpy(), want[layer]["m_aa"].numpy(),
                   f"{layer} cov_a")
            _close(tkfac.cov_g(tc, ba).numpy(), want[layer]["m_gg"].numpy(),
                   f"{layer} cov_g batch_averaged={ba}")
    for path, (ja, jg, *_) in jcaps.items():
        tc = tcaps[names[path]]
        ja, jg = np.asarray(ja), np.asarray(jg)
        if ja.ndim == 4:  # NHWC -> NCHW
            ja, jg = ja.transpose(0, 3, 1, 2), jg.transpose(0, 3, 1, 2)
        elif path == "Dense_0" and name == "usps":  # HWC -> CHW columns
            ja = ja[:, interop._a_perm("fc1", tp, True)[:-1]]
        _close(tc.a.numpy(), ja, f"{path} a")
        _close(tc.g.numpy(), jg, f"{path} g")


def test_forest_fc2_keeps_the_last_input_and_sums_both_grad_outputs():
    """ForestNet applies ``fc2`` twice: the capture holds the input of the
    second call and the sum of the two calls' grad-outputs, against a
    hand-written backward."""
    _, _, _, ttask, tp, ts, batch = _sides("forest")[0]
    b = _port_batch(batch)
    _, caps = tkfac.capture(ttask, tp, ts, b)
    relu = torch.relu
    p = {k: t.clone().requires_grad_(True) for k, t in tp.items()}
    x = b["x"].double()
    h1 = relu(x @ p["fc1.weight"].T + p["fc1.bias"])
    o2a = h1 @ p["fc2.weight"].T + p["fc2.bias"]
    h2 = relu(o2a)
    o2b = h2 @ p["fc2.weight"].T + p["fc2.bias"]
    out = relu(o2b) @ p["fc3.weight"].T + p["fc3.bias"]
    loss = ttask.loss(out, b["y"], b["w"])
    ga, gb = torch.autograd.grad(loss, [o2a, o2b])
    _close(caps["fc2"].a.numpy(), h2.detach().numpy(), "fc2 a")
    _close(caps["fc2"].g.numpy(), (ga + gb).numpy(), "fc2 g")


@pytest.mark.parametrize("name", MODELS)
def test_factors_inverses_and_natural_gradient_match_jax(name):
    """Two EMA updates from identity, the inverses, and the natural
    gradient of the loss gradient in tree form, damping 1e-3."""
    (jtask, jp, js, ttask, tp, ts, batch), (_, jf, jnat) = _sides(name)
    tb = _port_batch(batch)
    tf = tkfac.init_factors(ttask.model, tp)
    _, tcaps = tkfac.capture(ttask, tp, ts, tb)
    for _ in range(2):
        tf = tkfac.update_factors(tf, tcaps, tp, 0.95)
    tf = tkfac.compute_inverses(tf)
    want = interop.kfac_factors_from_jax(jf, tp)
    assert sorted(want) == sorted(tf)
    for layer, f in tf.items():
        for k in ("m_aa", "m_gg"):
            _close(f[k].numpy(), want[layer][k].numpy(), f"{layer} {k}")
        for q, d, m in (("Q_a", "d_a", "m_aa"), ("Q_g", "d_g", "m_gg")):
            # Q diag(d) Q^T is the factor, whatever eigh's signs and bases
            _close((f[q] * f[d]) @ f[q].T, f[m].numpy(), f"{layer} {q} {d}", rtol=1e-9)
    tg = tcurv.grad(ttask.loss_fn(ts), tp, tb)
    jnat = _tree_to_port(name, jnat, js)
    tnat = tkfac.apply_to_tree(tf, tg, 1e-3)
    assert sorted(tnat) == sorted(tp)
    for k in tp:
        _close(tnat[k].numpy(), jnat[k].numpy(), f"natural gradient {k}", rtol=1e-9)


@pytest.mark.parametrize("name", MODELS)
def test_factor_interop_round_trip_is_exact(name):
    (_, _, _, _, tp, _, _), (_, jf, _) = _sides(name)
    tf = interop.kfac_factors_from_jax(jf, tp)
    back = interop.kfac_factors_to_jax(tf, tp, list(jf))
    for path, f in jf.items():
        for k in interop._FACTOR_FIELDS:
            np.testing.assert_array_equal(back[path][k], np.asarray(getattr(f, k)))


@pytest.mark.parametrize("name", ["forest", "usps"])
def test_preconditioned_power_iteration_matches_jax(name):
    """The LOBPCG solve (``v + alpha P(r)``) on the loss Hessian with the
    K-FAC preconditioner at identity + one refit, the recipes' damping
    ``exp(-4 i - 2)`` and ``pow_iter_eps`` 1e-3."""
    from optwboundeigenval_tpu_torch.configs._families import lobpcg_alpha

    jtask, jp, js, ttask, tp, ts, batch = _sides(name)[0]
    kw = dict(eps=1e-3, max_iter=1000)

    def jax_solve(p, s, b):
        f = jkfac.fit_factors(jtask, p, s, b, jax.random.PRNGKey(0), sample_targets=False)
        _, hvp = jcurv.linearize_hvp(jtask.loss_fn(s), p, b)
        return jeig.estimate_dominant_eig(
            hvp, jax_uniform(p), alpha=lambda i: jnp.exp(-4.0 * i.astype(jnp.float32) - 2.0),
            precond=lambda r: jkfac.precond_apply(f, r), **kw)

    want = jax.jit(jax_solve)(jp, js, _jax_batch(batch))
    tb = _port_batch(batch)
    tf = tkfac.fit_factors(ttask, tp, ts, tb, sample_targets=False)
    _, thvp = tcurv.linearize_hvp(ttask.loss_fn(ts), tp, tb)
    tv0 = _tree_to_port(name, jax_uniform(jp), js)
    got = teig.estimate_dominant_eig(thvp, tv0, alpha=lobpcg_alpha,
                                     precond=lambda r: tkfac.precond_apply(tf, r), **kw)
    assert got.iters == int(want.iters) and got.iters > 2
    assert got.converged == bool(want.converged)
    for field in ("rho", "norm", "res_change"):
        _close(float(getattr(got, field)), float(getattr(want, field)), field)
    wv = _tree_to_port(name, want.v, js)
    for k in tp:
        _close(got.v[k].numpy(), wv[k].numpy(), f"v {k}")


def test_lobpcg_compose_errors_and_auto_match_jax():
    from optwboundeigenval_tpu.optim import sgd as jsgd
    from optwboundeigenval_tpu.train import SpectralTrainer as JaxTrainer

    v = {"a": torch.ones(3)}
    with pytest.raises(ValueError, match="preconditioner"):
        teig.power_iteration(lambda u: u, v, momentum=0.9, precond=lambda r: r)
    task = Task(model=ForestNet())
    for bad in (dict(pow_iter_momentum=0.9), dict(eigensolver="lanczos")):
        with pytest.raises(ValueError, match="lobpcg"):
            SpectralTrainer(task, sgd(0.1), device="cpu", lobpcg=True, **bad)
    for rand_init in (False, True):
        kw = dict(eigensolver="auto", lobpcg=True, rand_init=rand_init, pow_iter_eps=1e-3)
        t = SpectralTrainer(task, sgd(0.1), device="cpu", **kw)
        j = JaxTrainer(JaxTask(model=JaxForestNet()), jsgd(0.1), **kw)
        assert t.eigensolver == j.eigensolver == "power"
        assert (t.eigensolver, t.lanczos_m) == resolve_eigensolver("auto", rand_init, 1e-3,
                                                                   None, None, True)
    assert t.precond_builder is tkfac.precond_apply and t._kfac_iter == 1


def test_sampled_targets_come_from_the_generator():
    """Categorical draws from the softmax under a seeded generator: the
    same seed gives the same targets, and ``capture`` takes them."""
    _, _, _, ttask, tp, ts, batch = _sides("forest")[0]
    b = _port_batch(batch)
    draw = lambda seed: tkfac.sample_fisher_targets(ttask, tp, ts, b,
                                                    torch.Generator().manual_seed(seed))
    y1, y2 = draw(1), draw(1)
    assert torch.equal(y1, y2) and y1.shape == (12,) and int(y1.max()) < 7
    _, caps_y = tkfac.capture(ttask, tp, ts, {**b, "y": y1})
    _, caps_t = tkfac.capture(ttask, tp, ts, b, targets=y1)
    for k in caps_y:
        assert torch.equal(caps_y[k].g, caps_t[k].g)

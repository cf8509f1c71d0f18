"""The port's conditional GANs against the JAX package on the CPU at
float64: the four modules' forward passes in train and eval mode (the
BatchNorm statistics they update, the dropout masks flax draws), the
weight interop both ways, two ``train_cgan`` steps from one state with
the JAX step's draws injected (losses, parameters, Adam(W) moments,
BatchNorm statistics, with and without the label tricks), optax's cosine
schedule, the dropout keep rate, the generated ``.npz`` read by the other
package's loader and the ``gan`` script's ``main``.

Agreement: rtol 1e-10 (same float64 math, other summation order); the
weight maps are transposes and flips, so round trips are exact.
"""

import bz2
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from optwboundeigenval_tpu.analysis import gan_train as jgan_train
from optwboundeigenval_tpu.data import usps as jusps
from optwboundeigenval_tpu.models import gan as jgan
from optwboundeigenval_tpu_torch.analysis import gan_train
from optwboundeigenval_tpu_torch.data import usps
from optwboundeigenval_tpu_torch.models import gan
from optwboundeigenval_tpu_torch.utils import interop

torch.set_num_threads(1)
RTOL = 1e-10
LATENT = 8


def _close(got, want, rtol=RTOL, msg=""):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30), err_msg=msg)


def _close_dicts(got, want, rtol=RTOL):
    """Leaf by leaf to ``rtol``, with an absolute floor of ``rtol`` times the
    dict's largest value: a bias ahead of a BatchNorm has a zero gradient,
    which float64 leaves at rounding level, and Adam scales that up."""
    assert sorted(got) == sorted(want)
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    for k in want:
        g = got[k].detach().numpy() if isinstance(got[k], torch.Tensor) else got[k]
        np.testing.assert_allclose(g, np.asarray(want[k]), rtol=rtol, atol=rtol * scale,
                                   err_msg=k)


# name: (JAX module, port module, the inputs (first, labels) at batch B)
def _cases(b=6):
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 10, b)
    z = rng.normal(size=(b, LATENT))
    return {
        "mlp_g": (jgan.MLPGenerator(n=4, latent_dim=LATENT, dtype=jnp.float64),
                  gan.MLPGenerator(latent_dim=LATENT, n=4).double(), z, labels),
        "mlp_d": (jgan.MLPDiscriminator(n=4, dtype=jnp.float64),
                  gan.MLPDiscriminator(n=4).double(),
                  rng.uniform(-1, 1, (b, 16, 16, 1)), labels),
        "dc_g": (jgan.DCGenerator(latent_dim=LATENT, feat=4, dtype=jnp.float64),
                 gan.DCGenerator(latent_dim=LATENT, feat=4).double(), z, labels),
        "dc_d": (jgan.DCDiscriminator(feat=4, dtype=jnp.float64),
                 gan.DCDiscriminator(feat=4).double(),
                 rng.uniform(-1, 1, (b, 32, 32, 1)), labels),
    }


def _gan_vars(module, a, labels, seed):
    """float64 variables of a flax GAN module drawn from ``seed``: kernels and
    embeddings ``N(0, 1 / fan_in)``, biases and BatchNorm biases ``N(0,
    0.01)``, scales ``1 + N(0, 0.01)``, running means ``N(0, 0.01)``,
    variances in ``[1.1, 1.5)``."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: module.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.asarray(a), jnp.asarray(labels), train=False))

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name in ("kernel", "embedding"):
            return rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        if name in ("bias", "scale", "mean"):
            return (name == "scale") + 0.1 * rng.normal(size=shape)
        return 1.0 + rng.uniform(0.1, 0.5, size=shape)

    return (jax.tree_util.tree_map_with_path(draw, shapes["params"]),
            jax.tree_util.tree_map_with_path(draw, shapes.get("batch_stats", {})))


def _load(module, p, s):
    tp, ts = interop.from_jax(module, p, s)
    module.load_state_dict({**tp, **ts})
    return module


def dropout_masks(d, params, img, labels, key):
    """The keep masks flax's dropout layers draw from ``key`` (they depend on
    the key and the shapes only)."""
    masks = []

    def record(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, fnn.Dropout):
            masks.append(np.asarray(out) != 0)
        return out

    with fnn.intercept_methods(record):
        d.apply({"params": params}, jnp.asarray(img), jnp.asarray(labels), train=True,
                rngs={"dropout": key})
    return masks


@pytest.mark.parametrize("name", ["mlp_g", "mlp_d", "dc_g", "dc_d"])
@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_jax(name, train):
    jm, tm, a, labels = _cases()[name]
    p, s = _gan_vars(jm, a, labels, seed=3)
    _load(tm, p, s)
    variables = {"params": p, **({"batch_stats": s} if s else {})}
    kw = {}
    if train and name == "mlp_d":
        key = jax.random.PRNGKey(5)
        masks = dropout_masks(jm, p, a, labels, key)
        assert len(masks) == 2 and 0.3 < masks[0].mean() < 0.9
        kw = {"rngs": {"dropout": key}}
        tkw = {"keep": [torch.from_numpy(m) for m in masks]}
    else:
        tkw = {}
    if train and s:
        want, upd = jm.apply(variables, jnp.asarray(a), jnp.asarray(labels), train=True,
                             mutable=["batch_stats"], **kw)
    else:
        want = jm.apply(variables, jnp.asarray(a), jnp.asarray(labels), train=train, **kw)
    got = tm(torch.from_numpy(a), torch.from_numpy(labels), train=train, **tkw)
    _close(got, want)
    if train and s:  # the running statistics moved as flax's did
        _close_dicts(dict(tm.named_buffers()), interop.from_jax(tm, p, upd["batch_stats"])[1])


def test_train_mode_discriminator_needs_masks():
    d = gan.MLPDiscriminator(n=4)
    with pytest.raises(ValueError, match="keep masks"):
        d(torch.zeros(2, 16, 16, 1), torch.zeros(2, dtype=torch.long), train=True)


@pytest.mark.parametrize("name", ["mlp_g", "mlp_d", "dc_g", "dc_d"])
def test_interop_round_trip_is_exact(name):
    jm, tm, a, labels = _cases()[name]
    p, s = _gan_vars(jm, a, labels, seed=4)
    tp, ts = interop.from_jax(tm, p, s)
    fp, fs = interop.to_jax(tm, tp, ts)
    for x, y in zip(jax.tree.leaves(fp) + jax.tree.leaves(fs),
                    jax.tree.leaves(p) + jax.tree.leaves(s)):
        np.testing.assert_array_equal(x, y)
    assert jax.tree.structure(fp) == jax.tree.structure(p)


# ---- train_cgan -------------------------------------------------------------------


class F64:
    """A flax module whose ``init`` gives float64 variables (flax keeps its
    parameters float32 whatever the compute dtype)."""

    def __init__(self, module):
        self.module = module

    def init(self, *args, **kwargs):
        return jax.tree.map(lambda t: jnp.asarray(t, jnp.float64),
                            self.module.init(*args, **kwargs))

    def apply(self, *args, **kwargs):
        return self.module.apply(*args, **kwargs)


def _record_adam_states(monkeypatch):
    """Every optax ``adam``/``adamw`` state the JAX step produces, in order."""
    states = []

    def recording(make):
        def build(*args, **kwargs):
            tx = make(*args, **kwargs)

            def update(grads, state, params=None):
                updates, new = tx.update(grads, state, params)
                jax.debug.callback(lambda s: states.append(s), new, ordered=True)
                return updates, new

            return optax.GradientTransformation(tx.init, update)

        return build

    monkeypatch.setattr(optax, "adam", recording(optax.adam))
    monkeypatch.setattr(optax, "adamw", recording(optax.adamw))
    return states


def _jax_draws(jd, d_params, x, seed, steps, batch, n_classes, rand, smooth, swap):
    """The draws of the JAX step ``steps`` times, as the port's ``draws``
    take them."""
    rng = jax.random.split(jax.random.PRNGKey(seed), 3)[0]
    labels0 = jnp.zeros((batch,), jnp.int32)
    out = []
    for _ in range(steps):
        rng, zk, lk, dk1, dk2, sk, rk1, rk2 = jax.random.split(rng, 8)
        d = {"z": jax.random.normal(zk, (batch, LATENT)),
             "gen_labels": jax.random.randint(lk, (batch,), 0, n_classes)}
        if rand > 0:
            d["valid"] = jax.random.uniform(rk1, (batch, 1), minval=1.0 - rand, maxval=1.0)
            d["fake"] = jax.random.uniform(rk2, (batch, 1), minval=0.0, maxval=rand)
        else:
            d["valid"], d["fake"] = jnp.full((batch, 1), 1.0 - smooth), jnp.zeros((batch, 1))
        d["flip"] = jax.random.bernoulli(sk, swap) if swap > 0 else False
        d = {k: torch.from_numpy(np.array(v)) for k, v in d.items()}
        keep = lambda key: [torch.from_numpy(m) for m in dropout_masks(jd, d_params, x[:batch],
                                                                        labels0, key)]
        if isinstance(jd, jgan.MLPDiscriminator):
            d["keep1"], d["keep2"] = keep(dk1), keep(dk2)
        else:
            d["keep1"] = d["keep2"] = []
        out.append(d)
    return out


def _adam_moments(state):
    inner = [s for s in state if hasattr(s, "mu")][0]
    return inner.count, inner.mu, inner.nu


TRICKS = {
    "mlp plain": ("mlp", {}),
    "mlp rand swap adamw cosine": ("mlp", dict(rand=0.3, swap=1.0, weight_decay=2e-5,
                                               cosine_schedule=True)),
    "mlp smooth d_iter 2": ("mlp", dict(smooth=0.1, swap=0.5, d_iter=2)),
    "dc adamw": ("dc", dict(weight_decay=2e-5)),
}


@pytest.mark.parametrize("case", sorted(TRICKS))
def test_train_cgan_steps_match_jax(case, monkeypatch):
    kind, tricks = TRICKS[case]
    batch, steps, seed = 8, 2, 3
    rng = np.random.default_rng(1)
    side = 16 if kind == "mlp" else 32
    x = rng.uniform(-1, 1, (batch * steps, side, side, 1))
    y = rng.integers(0, 10, batch * steps)
    if kind == "mlp":
        jg = jgan.MLPGenerator(n=4, latent_dim=LATENT, dtype=jnp.float64)
        jd = jgan.MLPDiscriminator(n=4, dtype=jnp.float64)
        tg, td = gan.MLPGenerator(latent_dim=LATENT, n=4), gan.MLPDiscriminator(n=4)
    else:
        jg = jgan.DCGenerator(latent_dim=LATENT, feat=4, dtype=jnp.float64)
        jd = jgan.DCDiscriminator(feat=4, dtype=jnp.float64)
        tg, td = gan.DCGenerator(latent_dim=LATENT, feat=4), gan.DCDiscriminator(feat=4)
    kw = dict(n_epochs=1, batch_size=batch, lr=1e-3, latent_dim=LATENT, seed=seed,
              log_every=100, **tricks)

    # the JAX run's initial variables, as train_cgan draws them
    _, gk, dk = jax.random.split(jax.random.PRNGKey(seed), 3)
    l0 = jnp.zeros((batch,), jnp.int32)
    g_vars = F64(jg).init(gk, jnp.zeros((batch, LATENT)), l0, train=True)
    d_vars = F64(jd).init({"params": dk, "dropout": dk}, jnp.zeros((batch, side, side, 1)),
                          l0, train=True)
    states = _record_adam_states(monkeypatch)
    jgp, jgs, jdp, jhist = jgan_train.train_cgan(x, y, F64(jg), F64(jd), **kw)
    jax.effects_barrier()

    _load(tg.double(), g_vars["params"], g_vars["batch_stats"])
    _load(td.double(), d_vars["params"], {})
    draws = _jax_draws(jd, d_vars["params"], x, seed, steps, batch, 10,
                       tricks.get("rand", 0.0), tricks.get("smooth", 0.0),
                       tricks.get("swap", 0.0))
    hist, g_opt, d_opt = gan_train.train_cgan(x, y, tg, td, device="cpu",
                                              draws=lambda i: draws[i], **kw)

    _close(hist, jhist)
    tp, ts = interop.from_jax(tg, jgp, jgs["batch_stats"])
    _close_dicts(tg.state_dict(), {**tp, **ts})
    _close_dicts(dict(td.named_parameters()), interop.from_jax(td, jdp, {})[0])
    d_iter = tricks.get("d_iter", 1)
    assert len(states) == steps * (1 + d_iter)
    g_state, d_state = states[-1 - d_iter], states[-1]
    for opt, state, module, stats in ((g_opt, g_state, tg, g_vars["batch_stats"]),
                                      (d_opt, d_state, td, {})):
        count, mu, nu = _adam_moments(state)
        assert opt.count == int(count) == steps * (1 if opt is g_opt else d_iter)
        _close_dicts(opt.mu, interop.from_jax(module, mu, stats)[0])
        _close_dicts(opt.nu, interop.from_jax(module, nu, stats)[0])


def test_rand_and_smooth_exclude_each_other():
    with pytest.raises(ValueError, match="mutually exclusive"):
        gan_train.train_cgan(np.zeros((8, 16, 16, 1)), np.zeros(8, int), gan.MLPGenerator(),
                             gan.MLPDiscriminator(), rand=0.3, smooth=0.1, device="cpu")


def test_cosine_schedule_matches_optax():
    ours, theirs = gan_train.cosine_decay(1e-4, 60), optax.cosine_decay_schedule(1e-4, 60)
    for count in range(100):
        _close(ours(count), float(theirs(count)), rtol=1e-13)


def test_dropout_keep_rate_and_scale():
    g = torch.Generator().manual_seed(0)
    d = gan_train.cgan_draws(g, batch_size=64, latent_dim=LATENT, n_classes=10, rand=0.3,
                             smooth=0.0, swap=0.01, dropout_shapes=((2048,), (2048,)),
                             dtype=torch.float64, device="cpu")
    for keep in d["keep1"] + d["keep2"]:
        assert keep.shape == (64, 2048) and abs(float(keep.double().mean()) - 0.6) < 0.006
    assert float(d["valid"].min()) >= 0.7 and float(d["fake"].max()) <= 0.3
    x = torch.randn(64, 2048, dtype=torch.float64)
    out = gan._dropout(x, d["keep1"][0])
    assert torch.equal(out, torch.where(d["keep1"][0], x / 0.6, torch.zeros_like(x)))


# ---- generated sets ------------------------------------------------------------------


def test_generated_sets_cross_between_packages(tmp_path):
    jg = jgan.MLPGenerator(n=4, latent_dim=LATENT)
    jv = jg.init(jax.random.PRNGKey(0), jnp.zeros((2, LATENT)), jnp.zeros(2, jnp.int32),
                 train=False)
    jpath = jgan_train.generate_dataset(jg, jv["params"], {"batch_stats": jv["batch_stats"]},
                                        n_images=20, latent_dim=LATENT,
                                        out_path=str(tmp_path / "jax" / "gan_usps.npz"))
    tg = gan.MLPGenerator(latent_dim=LATENT, n=4, generator=torch.Generator().manual_seed(0))
    tpath = gan_train.generate_dataset(tg, n_images=20, latent_dim=LATENT,
                                       out_path=str(tmp_path / "port" / "gan_usps.npz"))
    with np.load(tpath) as z:
        assert z["x"].dtype == np.float32 and z["x"].shape == (20, 16, 16, 1)
        assert z["y"].dtype == np.int32 and np.all(np.abs(z["x"]) <= 1)
    for path, loader in ((jpath, usps.get_gan_loader), (tpath, jusps.get_gan_loader)):
        ld = loader(batch_size=8, root=os.path.dirname(path))
        with np.load(path) as z:
            np.testing.assert_array_equal(ld.x, z["x"])
            np.testing.assert_array_equal(ld.y, z["y"])


def _write_usps_bz2(path, n, seed):
    """A libsvm ``usps.bz2`` of ``n`` rows (labels 1-10, values in [-1, 1])."""
    rng = np.random.default_rng(seed)
    with bz2.open(path, "wt") as fh:
        for _ in range(n):
            vals = rng.uniform(-1, 1, 256)
            fh.write(f"{rng.integers(1, 11)} "
                     + " ".join(f"{i + 1}:{v:.6f}" for i, v in enumerate(vals)) + "\n")


@pytest.mark.parametrize("dc", [False, True])
def test_gan_script_main(tmp_path, capsys, dc):
    from optwboundeigenval_tpu_torch.scripts import gan as gan_script

    os.makedirs(tmp_path / "data")
    _write_usps_bz2(tmp_path / "data" / "usps.bz2", 130, seed=2)
    args = ["--n_epochs", "1", "--nodes", "4", "--gen_images", "12", "--sample_interval", "1",
            "--device", "cpu", "--data_root", str(tmp_path / "data"),
            "--models_dir", str(tmp_path / "models"), "--sample_dir", str(tmp_path / "img"),
            "--out", str(tmp_path / "data" / "gan_usps.npz")] + (["--dc"] if dc else [])
    path = gan_script.main(args)
    assert path.endswith("cgan_usps.npz" if dc else "gan_usps.npz")
    with np.load(path) as z:
        assert z["x"].shape == ((12, 32, 32, 1) if dc else (12, 16, 16, 1))
        first = z["x"].copy()
    out = capsys.readouterr().out
    assert "final d_loss=" in out and sorted(os.listdir(tmp_path / "img")) == ["1.npz", "2.npz"]
    # --train 0 reloads the saved generator and generates the same images
    assert gan_script.main(args + ["--train", "0"]) == path
    with np.load(path) as z:
        np.testing.assert_array_equal(z["x"], first)

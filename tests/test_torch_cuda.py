"""Tests of the port that need an NVIDIA GPU (marker ``cuda``); they skip
elsewhere.  This file imports neither JAX nor the JAX package, so it also
runs on a machine with PyTorch alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import time

import numpy as np
import pytest
import torch

from optwboundeigenval_tpu_torch.models.densenet import DenseNet3
from optwboundeigenval_tpu_torch.ops import curvature
from optwboundeigenval_tpu_torch.ops import pallas_kernels as pk
from optwboundeigenval_tpu_torch.optim.api import sgd
from optwboundeigenval_tpu_torch.train.task import Task
from optwboundeigenval_tpu_torch.train.trainer import SpectralTrainer
from optwboundeigenval_tpu_torch.utils import precision
from optwboundeigenval_tpu_torch.utils.tree import tree_norm, tree_sub

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    precision.set_tf32(False)  # as driver.run sets it by default
    return torch.device("cuda")


@pytest.mark.parametrize("n", [1, 3, 4, 1000, 7 * 13, 1 << 20])
def test_kernel_matches_plain_in_place(cuda, n):
    g = torch.Generator(device=cuda).manual_seed(n)
    alpha = torch.tensor(0.37, device=cuda)
    acc = torch.randn(n + 1, device=cuda, generator=g)
    delta = torch.randn(n + 1, device=cuda, generator=g)
    for a, d in ((acc[:n], delta[:n]), (acc[1:], delta[1:])):  # aligned, unaligned
        want = pk.axpy_accumulate_plain(a.clone(), d, alpha)
        ptr, before = a.data_ptr(), pk.axpy_accumulate.launches
        pk.axpy_accumulate(a, d, alpha)
        torch.cuda.synchronize()
        assert pk.axpy_accumulate.launches == before + 1 and a.data_ptr() == ptr
        assert torch.equal(a, want)


@pytest.mark.parametrize("init", [False, True])
def test_kernel_float64_matches_plain(cuda, init):
    g = torch.Generator(device=cuda).manual_seed(64)
    alpha = torch.tensor(0.37, device=cuda)  # float32: the wrapper casts it
    acc = torch.randn(1001, device=cuda, dtype=torch.float64, generator=g)
    delta = torch.randn(1001, device=cuda, dtype=torch.float64, generator=g)
    for a, d in ((acc[:1000], delta[:1000]), (acc[1:], delta[1:])):  # aligned, unaligned
        want = pk.axpy_accumulate_plain(a.clone(), d, alpha, init=init)
        if init:
            a.fill_(float("nan"))  # must never be read
        pk.axpy_accumulate(a, d, alpha, init=init)
        torch.cuda.synchronize()
        assert torch.equal(a, want)


def _tree(device, dtype, sizes, seed, unaligned=()):
    """Leaves of ``sizes`` (each its own tensor, or a view at offset 1
    where its index is in ``unaligned``)."""
    g = torch.Generator(device=device).manual_seed(seed)
    def leaf(i, n):
        t = torch.randn(n + 1, device=device, dtype=dtype, generator=g)
        return t[1:] if i in unaligned else t[:n]
    return [leaf(i, n) for i, n in enumerate(sizes)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("case", ["ragged", "above_capacity"])
def test_kernel_tree_matches_plain(cuda, dtype, init, case):
    """One call over a tree: a ragged one with an unaligned view leaf and an
    empty leaf (one launch), and one of more leaves than the table holds
    (one launch per TABLE_CAPACITY leaves)."""
    if case == "ragged":
        sizes, unaligned = [5000, 0, 1000, 1, 3, 2049, 12 * 16 * 3 * 3], (2,)
    else:
        sizes, unaligned = [1 + i % 300 for i in range(2 * pk.TABLE_CAPACITY + 7)], (5, 1500)
    launches = -(-sum(n > 0 for n in sizes) // pk.TABLE_CAPACITY)
    accs = _tree(cuda, dtype, sizes, 1, unaligned)
    deltas = _tree(cuda, dtype, sizes, 2, unaligned)
    alpha = torch.tensor(0.5 + 1.0 / 3.0, device=cuda, dtype=dtype)
    want = pk.axpy_accumulate_plain([a.clone() for a in accs], deltas, alpha, init=init)
    if init:
        for a in accs:
            a.fill_(float("nan"))
    before = pk.axpy_accumulate.launches
    out = pk.axpy_accumulate(accs, deltas, alpha, init=init)
    torch.cuda.synchronize()
    assert out is accs and pk.axpy_accumulate.launches - before == launches
    for a, w in zip(accs, want):
        assert torch.equal(a, w)


def test_train_step_on_the_card(cuda):
    """Two micro-batched steps of a small DenseNet3 on the card: every
    accumulate goes through K1, and the card's float64 HVP agrees with
    the CPU's."""
    task = Task(model=DenseNet3(depth=10, growth_rate=4), has_batch_stats=True)
    tr = SpectralTrainer(task, sgd(0.1, momentum=0.9), mu=0.01, K=0.0,
                         pow_iter_eps=0.05, max_pow_iter=20, hvp_micro=2)
    assert tr.device.type == "cuda"
    rng = np.random.default_rng(0)
    batch = {"x": rng.normal(size=(8, 32, 32, 3)).astype(np.float32),
             "y": rng.integers(0, 10, size=8).astype(np.int32),
             "w": np.ones(8, np.float32)}
    for _ in range(2):
        before = pk.axpy_accumulate.launches
        m = tr.train_step(batch)
        assert m["step_ok"] and m["g"] > 0
        # one launch per accumulate: gradient, each HVP, vGHv, 2 micro-batches
        assert pk.axpy_accumulate.launches - before == (m["pow_iters"] + 2) * 2

    to = lambda tree, dev: {k: t.to(dev, torch.float64) if t.is_floating_point()
                            else t.to(dev) for k, t in tree.items()}
    v = {k: torch.randn_like(t) for k, t in tr.params.items()}
    out = {}
    for dev in ("cpu", "cuda"):
        b = to(tr.put_batch(batch), dev)
        loss = task.loss_fn(to(tr.model_state, dev))
        out[dev] = to(curvature.hvp(loss, to(tr.params, dev), b, to(v, dev)), "cpu")
    rel = float(tree_norm(tree_sub(out["cuda"], out["cpu"])) / tree_norm(out["cpu"]))
    assert rel < 1e-9


def test_driver_run_forest_on_the_card(cuda, tmp_path):
    """``driver.run`` on ``forest_best`` at full width, cut to 4 train
    batches: two epochs, the test cascade and ``rho_test`` on the card."""
    from optwboundeigenval_tpu_torch.configs import forest_best
    from optwboundeigenval_tpu_torch.train import driver

    opts = forest_best.options(max_iter=2, rho_test=True,
                               log_dir=str(tmp_path / "logs"),
                               model_dir=str(tmp_path / "models"))
    for k, n in (("inputs", 512), ("target", 512), ("inputs_valid", 256),
                 ("target_valid", 256), ("inputs_test", 256), ("target_test", 256)):
        opts[k] = opts[k][:n]
    tr = driver.run(opts)
    assert tr.device.type == "cuda" and all(p.is_cuda for p in tr.params.values())
    lines = open(tr.log_file).read().splitlines()
    rows = [ln.split() for ln in lines[1:] if ln[:1].isdigit()]
    assert len(rows) == 2 and np.isfinite(np.asarray(rows, float)).all()
    assert any(ln.startswith("Test Accuracy: ") for ln in lines)
    rho = np.loadtxt(tmp_path / "logs" / (tr.header2 + "_rho_test.csv"), delimiter=",")
    assert rho.shape == (4, 6) and np.isfinite(rho).all()


def _f64(tree, dev):
    return {k: t.to(dev, torch.float64) if t.is_floating_point() else t.to(dev)
            for k, t in tree.items()}


def test_kfac_factors_and_natural_gradient_on_the_card(cuda):
    """Capture, factors, ``eigh`` and the natural gradient of CNNUSPS in
    float64: the card against the CPU (the ``eigh``s differ in signs and
    bases, so the factors and the natural gradient are compared, not Q)."""
    from optwboundeigenval_tpu_torch.models.cnn_usps import CNNUSPS
    from optwboundeigenval_tpu_torch.ops import kfac

    task = Task(model=CNNUSPS())
    p, _ = task.init(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    batch = {"x": torch.from_numpy(rng.normal(size=(32, 16, 16, 1))),
             "y": torch.from_numpy(rng.integers(0, 10, size=32)),
             "w": torch.ones(32)}
    batch["w"][-5:] = 0.0
    out = {}
    for dev in ("cpu", "cuda"):
        pd, bd = _f64(p, dev), {k: t.to(dev) for k, t in batch.items()}
        f = kfac.fit_factors(task, pd, {}, bd, sample_targets=False)
        g = curvature.grad(task.loss_fn({}), pd, bd)
        out[dev] = (f, kfac.precond_apply(f, g, 1e-3))
    (fc, nc), (fg, ng) = out["cpu"], out["cuda"]
    for layer, f in fc.items():
        for k in ("m_aa", "m_gg"):
            assert torch.allclose(fg[layer][k].cpu(), f[k], rtol=1e-10, atol=1e-14)
    rel = float(tree_norm(tree_sub(_f64(ng, "cpu"), nc)) / tree_norm(nc))
    assert rel < 1e-9


@pytest.mark.parametrize("opt", ["kfac", "sam", "entropy_sgd"])
def test_comparator_steps_on_the_card(cuda, opt):
    """Two steps of each comparator optimizer on ForestNet on the card,
    float64, against the same steps on the CPU (Entropy-SGD's noise comes
    from the trainer's host generator, the same on both)."""
    from optwboundeigenval_tpu_torch.configs._families import _make_optimizer
    from optwboundeigenval_tpu_torch.models.mlp_forest import ForestNet

    rng = np.random.default_rng(2)
    batch = {"x": rng.normal(size=(32, 54)).astype(np.float32),
             "y": rng.integers(0, 7, size=32).astype(np.int32), "w": np.ones(32, np.float32)}
    params = {}
    for dev in ("cpu", "cuda"):
        tr = SpectralTrainer(Task(model=ForestNet()), _make_optimizer(opt, lr=0.5), mu=0.0,
                             K=0.0, pow_iter=False, device=dev)
        tr.init_state()
        tr.params = _f64(tr.params, dev)
        tr.opt_state = tr.optimizer.init(tr.params)
        if tr.optimizer.build_extra_state is not None:
            tr.opt_state = tr.optimizer.build_extra_state(tr.opt_state, tr.task, tr.params, {})
        for _ in range(2):
            assert tr.train_step(batch)["step_ok"]
        assert all(t.device.type == dev for t in tr.params.values())
        params[dev] = _f64(tr.params, "cpu")
    rel = float(tree_norm(tree_sub(params["cuda"], params["cpu"])) / tree_norm(params["cpu"]))
    assert rel < 1e-9


def test_lobpcg_and_asymmetric_valley_runs_on_the_card(cuda, tmp_path):
    """``forest_lobpcg`` for one epoch and ``forest_asymmetric_valley``
    for 3 (SWA from 2, the hunt from 3) through ``driver.run`` on 4 train
    batches: finite logs, the preconditioner on the card."""
    from optwboundeigenval_tpu_torch.configs import forest_asymmetric_valley, forest_lobpcg
    from optwboundeigenval_tpu_torch.train import driver

    for mod, kw in ((forest_lobpcg, dict(max_iter=1)),
                    (forest_asymmetric_valley, dict(max_iter=3, swa_start=2, sgd_start=3,
                                                    save_freq=1, eval_freq=1, distances=1,
                                                    division_part=2,
                                                    plot_dir=str(tmp_path / "plots")))):
        opts = mod.options(log_dir=str(tmp_path / "logs"), model_dir=str(tmp_path / "models"),
                           **kw)
        for k, n in (("inputs", 512), ("target", 512), ("inputs_valid", 256),
                     ("target_valid", 256), ("inputs_test", 256), ("target_test", 256)):
            opts[k] = opts[k][:n]
        tr = driver.run(opts)
        assert tr.device.type == "cuda" and all(p.is_cuda for p in tr.params.values())
        rows = [ln.split() for ln in open(tr.log_file).read().splitlines()[1:]
                if ln[:1].isdigit()]
        assert len(rows) == kw["max_iter"] and np.isfinite(np.asarray(rows, float)).all()
        if tr.lobpcg:
            assert all(t.is_cuda for f in tr._precond_state.values() for t in f.values())


def test_cxr_step_card_vs_cpu(cuda):
    """One float64 ``train_step`` of ``chestxray_mu0_01_K0``
    (``CXRModel(densenet121)``, remat, W-BCE over NaN labels) at 64 px,
    batch 2, from one state on the card and on the CPU: the metrics and
    the step's direction (Adam's first moment; its first update moves the
    transit conv's bias, whose gradient ahead of BatchNorm is zero, by
    +-lr on rounding)."""
    from optwboundeigenval_tpu_torch.configs import chestxray_mu0_01_K0
    from optwboundeigenval_tpu_torch.data.synthetic import make_multilabel
    from optwboundeigenval_tpu_torch.train.driver import build_trainer

    x, y = make_multilabel(2, shape=(64, 64, 3), n_classes=14, seed=5, nan_frac=0.1)
    batch = {"x": x, "y": y, "w": np.ones(2, np.float32)}
    out = {}
    for dev in ("cpu", "cuda"):
        tr = build_trainer(chestxray_mu0_01_K0.options(device=dev, batch_size=2))
        tr.init_state()
        tr.params, tr.model_state = _f64(tr.params, dev), _f64(tr.model_state, dev)
        tr.opt_state = tr.optimizer.init(tr.params)
        tr.v = {k: torch.ones_like(t) for k, t in tr.params.items()}
        m = tr.train_step(batch)
        assert m["step_ok"] and tr.remat and all(t.device.type == dev
                                                 for t in tr.params.values())
        out[dev] = (m, _f64(tr.opt_state["mu"], "cpu"))
    (mc, dc), (mg, dg) = out["cpu"], out["cuda"]
    assert mg["pow_iters"] == mc["pow_iters"]
    for k in ("rho", "g", "gradf_norm", "gradg_norm"):
        assert abs(mg[k] - mc[k]) <= 1e-9 * abs(mc[k]), k
    assert float(tree_norm(tree_sub(dg, dc)) / tree_norm(dc)) < 1e-9


# ---- the analysis path -------------------------------------------------------------


def _rel(a, b):
    a, b = (torch.as_tensor(np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t))
            for t in (a, b))
    return float((a.double() - b.double()).norm() / b.double().norm())


def test_analysis_maps_card_vs_cpu(cuda):
    """Input-gradient, guided-backprop and Grad-CAM maps of a float64 CNNUSPS
    on the card and the CPU."""
    from optwboundeigenval_tpu_torch.analysis.grad_cam import grad_cam
    from optwboundeigenval_tpu_torch.analysis.guided_backprop import generate_gradients
    from optwboundeigenval_tpu_torch.analysis.saliency import batch_saliency
    from optwboundeigenval_tpu_torch.models.cnn_usps import CNNUSPS

    task = Task(model=CNNUSPS().double())
    params, _ = task.init(torch.Generator().manual_seed(3), "cpu")
    x = np.random.default_rng(0).normal(size=(6, 16, 16, 1))
    for fn in (batch_saliency, generate_gradients,
               lambda *a: grad_cam(*a, "conv3")):
        got = fn(task, {k: t.to(cuda) for k, t in params.items()}, {}, x)
        assert _rel(got, fn(task, params, {}, x)) < 1e-9


def test_cgan_steps_card_vs_cpu(cuda):
    """Two float64 ``train_cgan`` steps of the MLP and DC cGANs from one
    state, the draws made once and injected."""
    from optwboundeigenval_tpu_torch.analysis import gan_train
    from optwboundeigenval_tpu_torch.models import gan

    for make, side in ((lambda g: (gan.MLPGenerator(n=8, generator=g),
                                   gan.MLPDiscriminator(n=8, generator=g)), 16),
                       (lambda g: (gan.DCGenerator(feat=4, generator=g),
                                   gan.DCDiscriminator(feat=4, generator=g)), 32)):
        rng = np.random.default_rng(1)
        x, y = rng.uniform(-1, 1, (32, side, side, 1)), rng.integers(0, 10, 32)
        shapes = make(torch.Generator().manual_seed(0))[1].dropout_shapes
        gen = torch.Generator().manual_seed(2)
        draws = [gan_train.cgan_draws(gen, batch_size=16, latent_dim=100, n_classes=10,
                                      rand=0.3, smooth=0.0, swap=0.5, dropout_shapes=shapes,
                                      dtype=torch.float64, device="cpu") for _ in range(2)]
        out = {}
        for dev in ("cpu", cuda):
            g, d = (m.double() for m in make(torch.Generator().manual_seed(0)))
            on = lambda v: [t.to(dev) for t in v] if isinstance(v, list) else v.to(dev)
            dd = [{k: on(v) for k, v in dr.items()} for dr in draws]
            hist, g_opt, d_opt = gan_train.train_cgan(
                x, y, g, d, n_epochs=1, batch_size=16, weight_decay=2e-5, rand=0.3, swap=0.5,
                cosine_schedule=True, device=dev, draws=lambda i: dd[i])
            out[str(dev)] = [{"": torch.tensor(hist[0][1:])}, g.state_dict(), d.state_dict(),
                             g_opt.mu, d_opt.nu]
        # each tree in the relative 2-norm: a bias ahead of a BatchNorm has a
        # zero gradient, whose rounding noise Adam scales to ~1e-12 per entry,
        # differently on the two devices
        for a, b in zip(out["cuda"], out["cpu"]):
            a, b = (torch.cat([t.detach().cpu().flatten() for t in tree.values()])
                    for tree in (a, b))
            assert float((a - b).norm() / b.norm()) < 1e-9


def test_cov_shift_card_vs_cpu(cuda, tmp_path):
    """The float64 covariate-shift sweep of a small ForestNet checkpoint on
    the card and the CPU: equal indices, acc and F1 within 1e-9."""
    from optwboundeigenval_tpu_torch.analysis import cov_shift
    from optwboundeigenval_tpu_torch.data.synthetic import make_classification
    from optwboundeigenval_tpu_torch.models.mlp_forest import ForestNet
    from optwboundeigenval_tpu_torch.train.trainer import CKPT_BEST

    x, y = make_classification(300, 8, 3, seed=0)
    res = {}
    for dev in ("cpu", "cuda"):
        tr = SpectralTrainer(Task(model=ForestNet(hidden=8, num_classes=3, in_features=8)
                                  .double()), sgd(0.1), header="CS", batch_size=64,
                             device=dev, model_dir=str(tmp_path / "m"))
        tr.init_state()
        if dev == "cpu":
            tr.save(CKPT_BEST)
        res[dev] = cov_shift.cov_shift_tester([tr], x, y, iters=10, mult=0.3, mean_diff=1.0,
                                              sd_diff=0.2, skew_diff=1.0, seed=4,
                                              log_dir=str(tmp_path / dev))
    assert np.array_equal(res["cpu"][2], res["cuda"][2])
    for a, b in zip(res["cuda"][:2], res["cpu"][:2]):
        assert np.abs(a - b).max() <= 1e-9 * np.abs(b).max()


def test_distances_and_meta_classifier_card_vs_cpu(cuda):
    from optwboundeigenval_tpu_torch.analysis.distance import nearest_distances
    from optwboundeigenval_tpu_torch.analysis.jaccard import fit_meta_classifier

    rng = np.random.default_rng(3)
    a, b = rng.random((300, 256)).astype(np.float32), rng.random((500, 256)).astype(np.float32)
    for dist in ("euclid", "cosine"):
        np.testing.assert_allclose(nearest_distances(a, b, dist, device="cuda"),
                                   nearest_distances(a, b, dist, device="cpu"), rtol=1e-5)
    maps, labels = rng.random((40, 256)) * 0.05, (rng.random((40, 14)) < 0.3).astype(float)
    got, want = fit_meta_classifier(maps, labels), fit_meta_classifier(maps, labels, device="cpu")
    for k in ("w", "b"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4 * np.abs(want[k]).max())


# ---- dropout, the gemm CNN, the legacy loops, the oracle, reference .pt ------------


def _dropout_trainer(device, hvp_micro=0, **kw):
    from optwboundeigenval_tpu_torch.utils.tree import tree_uniform_like

    model = DenseNet3(depth=7, growth_rate=4, bottleneck=False, drop_rate=0.2, reduction=1.0)
    tr = SpectralTrainer(Task(model=model, has_batch_stats=True, has_dropout=True),
                         sgd(0.1, momentum=0.9), mu=0.01, K=0.0, pow_iter_eps=0.05,
                         max_pow_iter=20, hvp_micro=hvp_micro, device=device, **kw)
    tr.init_state()
    tr.params, tr.model_state = _f64(tr.params, device), _f64(tr.model_state, device)
    tr.opt_state = tr.optimizer.init(tr.params)
    tr.v = tree_uniform_like(tr.params)
    return tr


def _cpu_masks():
    """Masks drawn once on the CPU, injected on both devices."""
    from optwboundeigenval_tpu_torch.models import dropout

    table = {}
    return lambda _key, site, shape: table.setdefault(
        (site, shape), dropout.keep_mask(3, site, torch.empty(shape), 0.8))


def _batch8(seed=0):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(8, 32, 32, 3)), "y": rng.integers(0, 10, 8).astype(np.int32),
            "w": np.ones(8, np.float32)}


@pytest.mark.parametrize("hvp_micro,remat", [(0, True), (2, False)])
def test_dropout_step_card_vs_cpu(cuda, hvp_micro, remat):
    """A float64 step of a dropout DenseNet3 on the card and on the CPU with
    the same masks injected; through K1 when micro-batched."""
    from optwboundeigenval_tpu_torch.models import dropout

    masks, out = _cpu_masks(), {}
    for dev in ("cpu", "cuda"):
        tr = _dropout_trainer(dev, hvp_micro, remat=remat)
        before = pk.axpy_accumulate.launches
        with dropout.inject(masks):
            m = tr.train_step(_batch8())
        if dev == "cuda" and hvp_micro:
            assert pk.axpy_accumulate.launches - before == 2 * (m["pow_iters"] + 2)
        out[dev] = (m, _f64(tr.params, "cpu"))
    (mc, pc), (mg, pg) = out["cpu"], out["cuda"]
    assert mg["step_ok"] and mg["pow_iters"] == mc["pow_iters"]
    for k in ("rho", "g", "gradf_norm", "gradg_norm"):
        assert abs(mg[k] - mc[k]) <= 1e-9 * abs(mc[k]), k
    assert float(tree_norm(tree_sub(pg, pc)) / tree_norm(pc)) < 1e-9


def test_dropout_masks_are_drawn_on_the_card_and_h_is_symmetric(cuda):
    """Without injection the masks come from a generator on the card; one
    key gives one symmetric H (``u.Hv == v.Hu`` to float32 rounding)."""
    from optwboundeigenval_tpu_torch.models import dropout
    from optwboundeigenval_tpu_torch.utils.tree import tree_vdot

    x = torch.ones(64, 64, device=cuda)
    assert dropout.keep_mask(5, "s", x, 0.8).device.type == "cuda"
    assert torch.equal(dropout.keep_mask(5, "s", x, 0.8), dropout.keep_mask(5, "s", x, 0.8))
    model = DenseNet3(depth=7, growth_rate=4, bottleneck=False, drop_rate=0.2, reduction=1.0)
    task = Task(model=model, has_batch_stats=True, has_dropout=True)
    params, state = task.init(torch.Generator().manual_seed(0), cuda)
    batch = {k: torch.as_tensor(v, device=cuda) for k, v in _batch8().items()}
    batch["x"] = batch["x"].float()
    _, hvp = curvature.linearize_hvp(task.loss_fn(state, 11), params, batch)
    u = {k: torch.randn_like(t) for k, t in params.items()}
    v = {k: torch.randn_like(t) for k, t in params.items()}
    hv, hu = hvp(v), hvp(u)
    scale = float(tree_norm(u) * tree_norm(hv))
    assert abs(float(tree_vdot(u, hv) - tree_vdot(v, hu))) < 1e-4 * scale


def test_gemm_cnn_step_card_vs_cpu(cuda):
    from optwboundeigenval_tpu_torch.models.cnn_usps import CNNUSPS
    from optwboundeigenval_tpu_torch.optim.api import adam

    rng = np.random.default_rng(1)
    batch = {"x": rng.normal(size=(16, 16, 16, 1)), "y": rng.integers(0, 10, 16).astype(np.int32),
             "w": np.ones(16, np.float32)}
    out = {}
    for dev in ("cpu", "cuda"):
        tr = SpectralTrainer(Task(model=CNNUSPS(conv_impl="gemm")), adam(1e-3), mu=0.01, K=0.0,
                             device=dev)
        tr.init_state()
        tr.params = _f64(tr.params, dev)
        tr.opt_state = tr.optimizer.init(tr.params)
        tr.v = {k: torch.ones_like(t) for k, t in tr.params.items()}
        m = tr.train_step(batch)
        out[dev] = (m, _f64(tr.opt_state["mu"], "cpu"))
    (mc, dc), (mg, dg) = out["cpu"], out["cuda"]
    assert mg["pow_iters"] == mc["pow_iters"]
    for k in ("rho", "g", "gradf_norm"):
        assert abs(mg[k] - mc[k]) <= 1e-9 * abs(mc[k]), k
    assert float(tree_norm(tree_sub(dg, dc)) / tree_norm(dc)) < 1e-9


def test_legacy_loops_and_vae_on_the_card(cuda):
    from optwboundeigenval_tpu_torch.data.synthetic import make_multilabel
    from optwboundeigenval_tpu_torch.models.backbones import DenseNetFeatures
    from optwboundeigenval_tpu_torch.models.cxr import CXRModel
    from optwboundeigenval_tpu_torch.models.vae import VAE
    from optwboundeigenval_tpu_torch.optim.api import adam
    from optwboundeigenval_tpu_torch.train import legacy
    from optwboundeigenval_tpu_torch.train.task import weighted_bce_with_logits

    x, y = make_multilabel(8, shape=(64, 64, 3), n_classes=14, seed=2, nan_frac=0.0)
    loader = [{"x": x[i:i + 4], "y": y[i:i + 4], "w": np.ones(4, np.float32)} for i in (0, 4)]
    task = Task(model=CXRModel("densenet121", outnum=14), loss=weighted_bce_with_logits,
                has_batch_stats=True)
    params, state = task.init(torch.Generator().manual_seed(0), cuda)
    opt = adam(1e-5)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params, state, _, loss = legacy.train_epoch(task, params, state, opt, opt.init(params),
                                                loader, gen)
    vloss, _ = legacy.validate(task, params, state, loader)
    roc, avg, _ = legacy.test(task, params, state, loader)
    assert np.isfinite([loss, vloss, avg]).all() and roc.shape == (14,)
    vae = VAE(DenseNetFeatures((2, 2), 8, 16, 2), znum=8, hnum=16, outnum=14)
    vae.reset_parameters(torch.Generator().manual_seed(1))
    vp = {k: p.detach().to(cuda) for k, p in vae.named_parameters()}
    vs = {k: b.detach().to(cuda) for k, b in vae.named_buffers()}
    vp, vs2, _, vloss = legacy.train2_epoch(vae, vp, vs, opt, opt.init(vp), loader, gen)
    assert np.isfinite(vloss) and all(torch.equal(vs2[k], t) for k, t in vs.items())


def test_oracle_on_the_card(cuda):
    from optwboundeigenval_tpu_torch import hess_test

    diffs = hess_test.main([])
    assert all(diffs[k] < b for k, b in hess_test.BOUNDS.items())


@pytest.mark.parametrize("arch", ["forest", "usps_cnn", "densenet3"])
def test_reference_pt_round_trip_on_the_card(cuda, tmp_path, arch):
    from optwboundeigenval_tpu_torch.models.cnn_usps import CNNUSPS
    from optwboundeigenval_tpu_torch.models.mlp_forest import ForestNet
    from optwboundeigenval_tpu_torch.train.checkpoints import (
        load_torch_checkpoint,
        save_torch_checkpoint,
    )

    build, shape = {"forest": (ForestNet, (4, 54)), "usps_cnn": (CNNUSPS, (4, 16, 16, 1)),
                    "densenet3": (lambda: DenseNet3(depth=7, growth_rate=4, bottleneck=False,
                                                    drop_rate=0.2, reduction=1.0),
                                  (4, 32, 32, 3))}[arch]
    src = build()
    src.reset_parameters(torch.Generator().manual_seed(2))
    src = src.to(cuda)
    path = save_torch_checkpoint(src, str(tmp_path / f"{arch}.pt"), arch)
    dst = build().to(cuda)
    dst.load_state_dict(load_torch_checkpoint(path, arch))
    x = torch.randn(shape, device=cuda)
    assert torch.equal(dst(x), src(x))


def _forest_knob_run(device, tmp_path, header, **kw):
    from optwboundeigenval_tpu_torch.data.device import DeviceArrayLoader
    from optwboundeigenval_tpu_torch.data.loaders import ArrayLoader
    from optwboundeigenval_tpu_torch.data.synthetic import make_classification
    from optwboundeigenval_tpu_torch.models.mlp_forest import ForestNet

    x, y = make_classification(160, 10, 4, seed=0)
    device_data = kw.pop("device_data", False)
    loader = (DeviceArrayLoader(x, y, 32, shuffle=True, seed=7, device=device) if device_data
              else ArrayLoader(x, y, 32, shuffle=True, seed=7))
    tr = SpectralTrainer(Task(model=ForestNet(in_features=10, hidden=12, num_classes=4).double()),
                         sgd(0.1, momentum=0.9), device=device, mu=0.01, K=1.0, batch_size=32,
                         max_iter=2, min_iter=1, max_pow_iter=30, pow_iter_eps=1e-2,
                         defer_metrics=True, header=header, log_dir=str(tmp_path / "logs"),
                         model_dir=str(tmp_path / "models"), **kw)
    tr.train(train_loader=loader)
    return tr


def test_knobs_on_the_card_keep_the_trajectory(cuda, tmp_path):
    """scan_steps, donate and device-resident data on the card against the
    per-step run on the card: the same float64 trajectory."""
    base = _forest_knob_run(cuda, tmp_path, "OFF")
    knobs = _forest_knob_run(cuda, tmp_path, "ON", scan_steps=2, donate=True,
                             device_data=True, mem_track=True)
    assert knobs.mem_max > 0
    for k, t in base.params.items():
        assert knobs.params[k].device.type == "cuda"
        torch.testing.assert_close(knobs.params[k], t, rtol=1e-12, atol=1e-14)
    assert abs(knobs.f - base.f) <= 1e-12 * abs(base.f)


def test_device_loader_on_the_card(cuda):
    from optwboundeigenval_tpu_torch.data.device import DeviceArrayLoader, cifar_augment_device
    from optwboundeigenval_tpu_torch.data.loaders import ArrayLoader

    rng = np.random.default_rng(3)
    x = rng.normal(size=(37, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 5, size=37).astype(np.int32)
    dev = DeviceArrayLoader(x, y, batch_size=8, shuffle=True, seed=11)
    assert dev.device.type == "cuda" and dev.x.device.type == "cuda"
    for h, d in zip(ArrayLoader(x, y, batch_size=8, shuffle=True, seed=11), dev):
        assert d["x"].device.type == "cuda"
        np.testing.assert_array_equal(d["x"].cpu().numpy(), h["x"])
    aug = DeviceArrayLoader(x, y, batch_size=8, seed=1, augment=cifar_augment_device)
    batch = next(iter(aug))
    assert batch["x"].device.type == "cuda" and batch["x"].shape == (8, 8, 8, 3)


def test_mem_track_reads_the_card(cuda, tmp_path, capsys):
    tr = _forest_knob_run(cuda, tmp_path, "MEM", mem_track=True)
    assert tr.mem_max > 0
    assert "Running Max device memory used (in bytes):" in capsys.readouterr().out


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("case", ["ragged", "mixed"])
def test_kernel_bfloat16_entry_matches_plain(cuda, init, case):
    """K1's bfloat16 entry: a ragged bfloat16 tree (an unaligned view leaf,
    empty leaves, ragged tails) in one launch, and the gemm CNNUSPS's
    mixed tree (bfloat16 conv leaves beside float32 dense ones), one launch
    a dtype; bit-equal to the plain version."""
    sizes = [5000, 0, 1000, 1, 3, 2049, 0, 8 * 9, 7]
    bf = _tree(cuda, torch.bfloat16, sizes, 3, unaligned=(2,))
    bf_d = _tree(cuda, torch.bfloat16, sizes, 4, unaligned=(2,))
    if case == "mixed":
        f32 = _tree(cuda, torch.float32, [8192, 64, 640, 10], 5)
        f32_d = _tree(cuda, torch.float32, [8192, 64, 640, 10], 6)
        accs, deltas, launches = bf[:4] + f32 + bf[4:], bf_d[:4] + f32_d + bf_d[4:], 2
    else:
        accs, deltas, launches = bf, bf_d, 1
    alpha = torch.tensor(0.5 + 1.0 / 3.0, device=cuda)
    want = pk.axpy_accumulate_plain([a.clone() for a in accs], deltas, alpha, init=init)
    if init:
        for a in accs:
            a.fill_(float("nan"))
    before = pk.axpy_accumulate.launches
    pk.axpy_accumulate(accs, deltas, alpha, init=init)
    torch.cuda.synchronize()
    assert pk.axpy_accumulate.launches - before == launches
    for a, w in zip(accs, want):
        assert a.dtype == w.dtype and torch.equal(a, w)
    with pytest.raises(TypeError, match="bfloat16"):
        half = torch.zeros(4, device=cuda, dtype=torch.float16)
        pk.axpy_accumulate([accs[0], half], [deltas[0], half.clone()], alpha)


def test_main_float32_step_runs_with_tf32_off(cuda, tmp_path, monkeypatch, capsys):
    """``main``'s float32 steps run with both TF32 flags off, the setting
    every card number of the port was taken at, whatever they were before."""
    from optwboundeigenval_tpu_torch import main as entry

    seen = []
    step = SpectralTrainer.train_step
    monkeypatch.setattr(SpectralTrainer, "train_step", lambda self, *a, **k: (
        seen.append(precision.tf32()), step(self, *a, **k))[1])
    precision.set_tf32(True)
    tr = entry.main(["main", "forest_best", "max_iter=1", f"log_dir='{tmp_path}/logs'",
                     f"model_dir='{tmp_path}/models'"])
    assert tr.device.type == "cuda" and seen and set(seen) == {(False, False)}
    assert all(p.dtype == torch.float32 for p in tr.params.values())
    assert "tf32: cudnn.allow_tf32=False, cuda.matmul.allow_tf32=False" in capsys.readouterr().out


def test_bfloat16_densenet_step_on_the_card(cuda):
    """Two micro-batched steps of a small DenseNet3 at bfloat16 compute on
    the card: float32 parameters, statistics and accumulates (K1 launches
    ``2 * (pow_iters + 2)`` a step, its float32 entry), bfloat16 logits."""
    torch.manual_seed(0)
    tr = SpectralTrainer(Task(model=DenseNet3(depth=10, growth_rate=4, dtype=torch.bfloat16),
                              has_batch_stats=True),
                         sgd(0.1, momentum=0.9), hvp_micro=2, mu=0.01, K=0.0,
                         pow_iter_eps=0.05, device="cuda")
    rng = np.random.default_rng(0)
    for _ in range(2):
        batch = {"x": rng.normal(size=(8, 32, 32, 3)).astype(np.float32),
                 "y": rng.integers(0, 10, size=8).astype(np.int32)}
        before = pk.axpy_accumulate.launches
        m = tr.train_step(batch)
        torch.cuda.synchronize()
        assert m["step_ok"] and np.isfinite(m["rho"])
        assert pk.axpy_accumulate.launches - before == 2 * (m["pow_iters"] + 2)
    assert all(t.dtype == torch.float32 for t in tr.params.values())
    assert all(t.dtype == torch.float32 for t in tr.model_state.values())
    out = tr.task.predict(tr.params, tr.model_state, tr.put_batch(batch))
    assert out.dtype == torch.bfloat16 and out.is_cuda


def _dn40(tmp_path, batch=16):
    """The DenseNet-40 recipe's trainer (``remat``, SGD, ``pow_iter_eps``
    0.05) on the card at ``batch``, and batches with ``x`` and ``y`` on the
    card and a host ``w``, as the benchmark hands them."""
    from optwboundeigenval_tpu_torch.configs import cifar10_densenet_mu0_01_K0 as cfg
    from optwboundeigenval_tpu_torch.train import driver

    tr = driver.build_trainer(cfg.options(device="cuda", augment=False, batch_size=batch,
                                          log_dir=str(tmp_path / "logs"),
                                          model_dir=str(tmp_path / "models")))
    tr.init_state()
    g = torch.Generator(device="cuda").manual_seed(17)
    batches = [{"x": torch.randn((batch, 32, 32, 3), generator=g, device="cuda"),
                "y": torch.randint(0, 10, (batch,), generator=g, device="cuda"),
                "w": np.ones(batch, np.float32)} for _ in range(3)]
    return tr, batches


def _synchronising_calls(run):
    """``run()`` under ``torch.cuda.set_sync_debug_mode("warn")`` with the
    program's recording on: the warnings of synchronising calls, and the
    recording."""
    import warnings

    from optwboundeigenval_tpu_torch.utils import timing

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught, timing.record() as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return [w for w in caught if "called a synchronizing CUDA operation" in str(w.message)], rec


def test_every_synchronisation_is_a_sync_span(cuda, tmp_path):
    """One DenseNet-40 step and one audit batch on the card: the card's own
    count of synchronising calls equals the program's ``host_syncs``, so
    none happens outside a sync span (``1 + products + 1`` each)."""
    tr, batches = _dn40(tmp_path)
    tr.train_step(batches[0], fetch=False)  # first use of cuDNN and cuBLAS
    out = {}
    warned, rec = _synchronising_calls(
        lambda: out.update(tr.train_step(batches[1], fetch=False)))
    assert len(warned) == sum(rec.syncs.values()), ([str(w.message) for w in warned], rec.syncs)
    assert rec.syncs == {"batch.h2d": 1, "eigen.stop": out["pow_iters"], "spectral.gate": 1}
    warned, rec = _synchronising_calls(lambda: tr.rho_test(loader=batches[2:]))
    assert len(warned) == sum(rec.syncs.values()), ([str(w.message) for w in warned], rec.syncs)
    assert set(rec.syncs) == {"batch.h2d", "eigen.stop", "audit.row"}
    assert rec.syncs["batch.h2d"] == rec.syncs["audit.row"] == 1


def test_spans_share_the_device_trace_clock(cuda):
    """A clock marker: after a synchronise, a span around a sleep kernel,
    under the profiler; the kernel starts after the span opens (both on
    ``time.time_ns``'s clock) and within 5 ms of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from optwboundeigenval_tpu_torch.utils import timing

    torch.cuda._sleep(1000)  # load the kernel before the marker
    offsets = []
    for _ in range(3):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
            with timing.record() as rec:
                with timing.span("marker"):
                    torch.cuda._sleep(1_000_000)
            torch.cuda.synchronize()
        starts = [e.start_ns() if hasattr(e, "start_ns") else 1000 * e.start_us()
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA]
        assert len(starts) == 1
        offsets.append(starts[0] - rec.spans[0].start_ns)
    print(f"sleep kernel start less the span's start: {[o / 1e3 for o in offsets]} us")
    assert all(0 <= o <= 5_000_000 for o in offsets), offsets


def test_timers_and_mem_check_read_the_device(cuda, tmp_path):
    """``Timers`` on the card time a stage's device work, not its enqueue;
    ``mem_check`` sees a peak inside a step that is freed before it reads."""
    from optwboundeigenval_tpu_torch.utils import timing

    timers = timing.Timers(cuda)
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with timers("G"):
        torch.cuda._sleep(100_000_000)  # about 50 ms at 2 GHz
    enqueue = time.perf_counter() - t0
    assert timers.totals["G"] > 0.02 > enqueue
    tr, _ = _dn40(tmp_path, batch=4)
    tr.mem_track = True
    big = torch.empty(256 << 20, dtype=torch.uint8, device=cuda)
    del big
    assert tr.mem_check() >= 256 << 20


# ---- the vGHv pass as a CUDA graph (ops/spectral.VghvGraphs) -------------------------
#
# cuDNN's default backward-filter algorithm (``wgrad_alg0_engine``) adds with atomics in an
# order that changes run to run, so two eager vGHv passes on the same inputs differ at float32
# rounding; a replay can equal the eager pass bit for bit only under deterministic algorithms.
# cuDNN's plan cache lives as long as the process, and in the whole card suite plans chosen by
# earlier tests served later passes under ``cudnn.deterministic`` too (two eager passes 3e-6
# apart): so the bit-for-bit cases run in a process of their own (``_fresh``).


def _fresh(case, tmp_path, *args):
    """``case(tmp, *args)`` of this module in a new Python process with
    deterministic cuDNN and TF32 off; its output on failure."""
    import subprocess
    import sys
    from pathlib import Path

    here = Path(__file__).resolve().parent
    code = (f"import sys; sys.path.insert(0, {str(here)!r}); import torch; "
            "torch.backends.cudnn.deterministic = True; import test_torch_cuda as t; "
            f"t.precision.set_tf32(False); t.{case}({str(tmp_path)!r}, *{args!r})")
    out = subprocess.run([sys.executable, "-c", code], cwd=here.parent, capture_output=True,
                         text=True, timeout=600)
    print(out.stdout[-2000:])
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-5000:]


def _vghv_inputs(tr, batch, g, shape=(32, 32, 3), classes=10, multilabel=False):
    """Fresh parameters, BatchNorm buffers, a batch with ``w`` and a unit
    ``v`` near the trainer's state, on the card."""
    dev = tr.device
    params = {k: p + 1e-2 * torch.randn(p.shape, generator=g, device=dev, dtype=p.dtype)
              for k, p in tr.params.items()}
    state = {k: b + 1e-2 * torch.rand(b.shape, generator=g, device=dev, dtype=b.dtype)
             if b.is_floating_point() else b.clone() for k, b in tr.model_state.items()}
    if multilabel:
        y = (torch.rand((batch, classes), generator=g, device=dev) > 0.5).float()
    else:
        y = torch.randint(0, classes, (batch,), generator=g, device=dev)
    b = {"x": torch.randn((batch, *shape), generator=g, device=dev), "y": y,
         "w": torch.rand(batch, generator=g, device=dev) + 0.5}
    v = {k: torch.randn(p.shape, generator=g, device=dev, dtype=p.dtype)
         for k, p in tr.params.items()}
    n = tree_norm(v)
    return params, state, b, {k: t / n for k, t in v.items()}


def _vghv(tr, inputs, graphs=None, gradg_clip=None):
    """``grad rho`` of one vGHv pass (the gate open), through ``graphs``
    or op by op, and the routes it counted."""
    from optwboundeigenval_tpu_torch.ops import spectral
    from optwboundeigenval_tpu_torch.utils import timing

    params, state, b, v = inputs
    rho = torch.ones((), device=tr.device)
    with timing.record() as rec:
        sg = spectral.penalty_and_grad(tr.task.loss_fn(state), params, b, v, rho, K=0.0,
                                       gradg_clip=gradg_clip, graphs=graphs, model_state=state)
    return sg.grad_rho, rec.counts


def _gap(a, b) -> float:
    return float(tree_norm(tree_sub(a, b)) / tree_norm(b))


def _replays_equal_eager(tr, graphs, n, batch, gradg_clip=None, seed=0, loose=(), **shape):
    """``n`` passes of one signature through ``graphs``, each on new
    inputs (the previous ones freed first) and equal to the eager pass on
    the same inputs bit for bit, the leaves in ``loose`` to a relative
    1e-4; each earlier result is checked again after the next replay
    (nothing returned aliases the graph).  Returns the routes counted."""
    g = torch.Generator(device=tr.device).manual_seed(seed)
    counts, kept = {}, []
    for _ in range(n):
        inputs = _vghv_inputs(tr, batch, g, **shape)
        got, c = _vghv(tr, inputs, graphs, gradg_clip)
        want, _ = _vghv(tr, inputs, None, gradg_clip)
        del inputs
        for k in c:
            counts[k] = counts.get(k, 0) + c[k]
        assert got.keys() == want.keys()
        differ = [k for k in want if k not in loose and not torch.equal(got[k], want[k])]
        assert not differ, (c, len(differ), differ[:8], _gap(got, want))
        assert all(_gap({k: got[k]}, {k: want[k]}) <= 1e-4 for k in loose)
        for old, copy in kept:
            assert all(torch.equal(old[k], copy[k]) for k in copy)
        kept.append((got, {k: t.clone() for k, t in got.items()}))
    return counts


def _dn40_graphs(tmp, batch=16):
    from pathlib import Path

    from optwboundeigenval_tpu_torch.ops import spectral

    tr, _ = _dn40(Path(tmp), batch=batch)
    return tr, spectral.VghvGraphs(tr.task)


def _replays_case(tmp):
    tr, graphs = _dn40_graphs(tmp)
    counts = _replays_equal_eager(tr, graphs, 6, 16)
    assert counts == {"vghv.eager": 1, "vghv.capture": 1, "vghv.replay": 4}, counts
    counts = _replays_equal_eager(tr, graphs, 3, 8, seed=1)
    assert counts == {"vghv.eager": 1, "vghv.capture": 1, "vghv.replay": 1}, counts
    assert len(graphs._graphs) == 2 and all(graphs._graphs.values())
    counts = _replays_equal_eager(tr, graphs, 2, 16, seed=2)
    assert counts == {"vghv.replay": 2}, counts


def test_vghv_graph_replays_equal_eager(cuda, tmp_path):
    """DenseNet-40 at batch 16: over 6 passes of one signature, the first
    runs eager, the second captures, the rest replay, and every result
    equals the eager pass's bit for bit (the same kernels in the same
    order on the same inputs, cuDNN's algorithms deterministic); a batch
    of another shape runs eager once, then captures its own graph in the
    shared pool, and the first graph still replays."""
    _fresh("_replays_case", tmp_path)


def test_vghv_graph_with_default_cudnn_is_within_float32_rounding(cuda, tmp_path):
    """With cuDNN's default algorithms (the benchmark's and the recipes'
    setting) two eager passes on the same inputs differ (DenseNet-40 at
    batch 16: relative 3e-6 of the tree, H100); replays differ from the
    eager pass as much, held to 2e-5."""
    tr, graphs = _dn40_graphs(tmp_path)
    g = torch.Generator(device=cuda).manual_seed(5)
    for _ in range(5):
        inputs = _vghv_inputs(tr, 16, g)
        got, _ = _vghv(tr, inputs, graphs)
        want, _ = _vghv(tr, inputs, None)
        again, _ = _vghv(tr, inputs, None)
        print(f"graph - eager {_gap(got, want):.3g}, eager - eager {_gap(again, want):.3g}")
        assert _gap(got, want) <= 2e-5


def _clip_case(tmp):
    tr, graphs = _dn40_graphs(tmp, batch=8)
    counts = _replays_equal_eager(tr, graphs, 4, 8, gradg_clip=1e-3)
    assert counts == {"vghv.eager": 1, "vghv.capture": 1, "vghv.replay": 2}, counts


def test_vghv_graph_with_a_clip_replays_equal_eager(cuda, tmp_path):
    """``gradg_clip`` is part of the signature and of the graph: a clip
    that binds, over 4 passes."""
    _fresh("_clip_case", tmp_path)


def _family_case(tmp, config, shape, classes):
    import importlib

    from optwboundeigenval_tpu_torch.ops import spectral
    from optwboundeigenval_tpu_torch.train import driver

    mod = importlib.import_module(f"optwboundeigenval_tpu_torch.configs.{config}")
    tr = driver.build_trainer(mod.options(device="cuda", batch_size=4, log_dir=f"{tmp}/logs",
                                          model_dir=f"{tmp}/models"))
    tr.init_state()
    graphs = spectral.VghvGraphs(tr.task)
    stem = [k for k in tr.params if k.startswith(("features.conv0.", "features.norm0."))]
    counts = _replays_equal_eager(tr, graphs, 4, 4, shape=shape, classes=classes,
                                  multilabel=config.startswith("chestxray"), loose=stem)
    assert counts == {"vghv.eager": 1, "vghv.capture": 1, "vghv.replay": 2}, counts


@pytest.mark.parametrize("config,shape,classes", [
    ("forest_best", (54,), 7), ("usps_cnn_mu0_01_K0", (16, 16, 1), 10),
    ("chestxray_mu0_01_K0", (64, 64, 3), 14)])
def test_vghv_graph_of_each_model_family_equals_eager(cuda, tmp_path, config, shape, classes):
    """The other models that train on one card with ``mu > 0``: ForestNet,
    CNNUSPS and the chest x-ray DenseNet-121 (64 px, W-BCE) replay their
    vGHv pass bit for bit as the eager pass computes it.  DenseNet-121's
    stem (``conv0``, ``norm0``) lies under an overlapping max pool whose
    backward adds with atomics, so there two eager passes differ at float32
    rounding too (relative 1e-9 to 1e-8 of the tree, H100): held to 1e-4."""
    _fresh("_family_case", tmp_path, config, shape, classes)


def _out_of_memory_case(tmp):
    tr, graphs = _dn40_graphs(tmp)
    g = torch.Generator(device="cuda").manual_seed(3)
    first = _vghv_inputs(tr, 16, g)
    _, counts = _vghv(tr, first, graphs)
    assert counts == {"vghv.eager": 1}, counts
    total = torch.cuda.get_device_properties(0).total_memory
    begin, end = torch.cuda.CUDAGraph.capture_begin, torch.cuda.CUDAGraph.capture_end
    capped = []

    def capped_begin(self, *args, **kwargs):
        capped.append(torch.cuda.memory_reserved())
        torch.cuda.set_per_process_memory_fraction((capped[0] + (64 << 20)) / total)
        return begin(self, *args, **kwargs)

    def lifted_end(self, *args, **kwargs):
        torch.cuda.set_per_process_memory_fraction(1.0)
        return end(self, *args, **kwargs)

    torch.cuda.CUDAGraph.capture_begin, torch.cuda.CUDAGraph.capture_end = capped_begin, lifted_end
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    try:
        got, counts = _vghv(tr, first, graphs)
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
        torch.cuda.CUDAGraph.capture_begin, torch.cuda.CUDAGraph.capture_end = begin, end
    assert len(capped) == 1 and counts == {"vghv.capture": 1, "vghv.eager": 1}, counts
    assert list(graphs._graphs.values()) == [None]
    # nothing of the capture is held but what a stream keeps once used:
    # cuBLAS's workspaces for the capture stream, 32 MiB for each of the
    # two threads that multiply (the caller's and autograd's)
    result = sum(t.numel() * t.element_size() for t in got.values())
    print(f"held after the failed capture: {torch.cuda.memory_allocated() - held - result} B")
    assert torch.cuda.memory_allocated() <= held + result + (80 << 20)
    want, _ = _vghv(tr, first, None)
    assert all(torch.equal(got[k], want[k]) for k in want)
    counts = _replays_equal_eager(tr, graphs, 2, 16, seed=4)
    assert counts == {"vghv.eager": 2}, counts


def test_vghv_capture_out_of_memory_stays_eager(cuda, tmp_path):
    """A capture forced out of memory (the process capped at what it holds
    as the capture begins, the cap lifted as it ends) frees what it took
    and leaves its signature eager, with the eager result; later passes
    of the signature stay eager."""
    _fresh("_out_of_memory_case", tmp_path)


@pytest.mark.parametrize("case", ["dropout", "micro"])
def test_vghv_graph_never_captures_dropout_or_micro_batches(cuda, case):
    """A dropout task (a key a step) and ``hvp_micro=2`` (K1) train op by op
    on the card: every step's pass counts ``vghv.eager``."""
    from optwboundeigenval_tpu_torch.utils import timing

    if case == "dropout":
        tr = _dropout_trainer("cuda")
    else:
        tr = SpectralTrainer(Task(model=DenseNet3(depth=10, growth_rate=4), has_batch_stats=True),
                             sgd(0.1, momentum=0.9), mu=0.01, K=0.0, pow_iter_eps=0.05,
                             max_pow_iter=20, hvp_micro=2)
    counts = {}
    for _ in range(3):
        with timing.record() as rec:
            m = tr.train_step(_batch8())
        assert m["step_ok"] and m["g"] > 0
        for k, c in rec.counts.items():
            counts[k] = counts.get(k, 0) + c
    assert counts == {"vghv.eager": 3} and not tr._vghv_graphs._graphs


def _trainer_case(tmp):
    from pathlib import Path

    from optwboundeigenval_tpu_torch.utils import timing

    runs = {}
    for graphed in (True, False):
        tr, batches = _dn40(Path(tmp) / str(graphed))
        if not graphed:
            tr._vghv_graphs = None
        routes, syncs = [], []
        for i in range(4):
            with timing.record() as rec:
                m = tr.train_step(batches[i % len(batches)], fetch=False)
                products = int(m["pow_iters"])
            routes.append(rec.counts)
            syncs.append((rec.syncs, products))
        runs[graphed] = (tr.params, routes, syncs)
    (pg, rg, sg), (pe, re_, _) = runs[True], runs[False]
    assert rg == [{"vghv.eager": 1}, {"vghv.capture": 1}, {"vghv.replay": 1},
                  {"vghv.replay": 1}], rg
    assert re_ == [{"vghv.eager": 1}] * 4, re_
    for s, n in sg:
        assert s == {"batch.h2d": 1, "eigen.stop": n, "spectral.gate": 1}, s
    assert all(torch.equal(pg[k], pe[k]) for k in pe), _gap(pg, pe)


def test_vghv_graph_through_the_trainer(cuda, tmp_path):
    """Four DenseNet-40 steps at batch 16 with the graph and without it
    (``_vghv_graphs`` None) from one state: the same parameters bit for
    bit, the routes eager, capture, replay, replay, and a replayed step
    synchronises as an eager one does (``1 + products + 1``)."""
    _fresh("_trainer_case", tmp_path)

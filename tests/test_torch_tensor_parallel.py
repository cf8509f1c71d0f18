"""The ``model`` mesh axis (``parallel/sharding.py``, ``parallel/mesh.py``)
against one process and against the JAX package, at float64 on the CPU.

The ranks run once for the module: the fixture ``worlds`` starts this
file as a script in two worlds of gloo ranks (``127.0.0.1``) at once, 2
ranks as ``data=1 x model=2`` and 4 ranks as ``data=2 x model=2``, each
rank running the scenarios of its world, while the pytest process runs
the same scenarios with no mesh.  The tests then compare:

* (i) ``infer_param_specs`` with the JAX package's specs, mapped through
  ``utils/interop.py`` (no process group: a mesh stand-in);
* (ii) on 2 ranks, the gradient, an HVP and the vGHv of sharded params,
  plain, through BatchNorm, under remat and micro-batched, against one
  process (rtol 1e-12);
* (iii) the sharded eigensolve's ``rho`` against the JAX package's
  replicated one from the same weights (``tests/test_parallel.py:77``,
  rtol 1e-9);
* (iv) the JAX multi-chip dryrun's sequence (``__graft_entry__.py``: a
  step, a ``scan_steps=2`` epoch, a LOBPCG step, a Lanczos step, the
  flagship knobs and ``auto``) on CNNUSPS on 4 ranks against one process;
* (v) the ``tests/test_multihost.py:248`` loop on 4 ranks (replicated
  params, and sharded ones) against one process and against the JAX
  package's single-process rows;
* (vi) ``save_full`` from sharded ranks against one process's file, and a
  ``resume`` that shards again;
* (vii) the column split layer by layer on 2 ranks: ``Conv2d``,
  ``Linear``, ``ConvTranspose2d``, ``Embedding`` and the gemm conv, each
  holding a slice of its weight, against the whole layer in one process
  (output, gradient, HVP, vGHv; rtol 1e-12);
* (viii) the spectral step on a CXR-shaped model (a DenseNet trunk, the
  1,024-channel transit conv and the classifier, every layer sharded)
  and on a dropout DenseNet3, on both worlds: the gradient, HVP, vGHv
  (plain, under remat, micro-batched through K1's plain version) and a
  step's ``rho`` and update against one process (rtol 1e-12, scaled by
  the tree's largest value) and, for the CXR model, against the JAX
  package's ``shard_params`` run on the 8-device CPU mesh (rtol 1e-9;
  the CXR model's micro-batched products there through the
  ``hvp_micro=2`` step; the dropout model's plain products under flax's
  masks);
* (ix) the all-reduces of one forward of the CXR-shaped model: one over
  the ``model`` group per sharded layer, of that layer's output size,
  none of a weight's.
"""

import contextlib
import dataclasses
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from optwboundeigenval_tpu_torch.data.loaders import ArrayLoader
from optwboundeigenval_tpu_torch.data.synthetic import make_classification, make_images
from optwboundeigenval_tpu_torch.models import backbones, dropout
from optwboundeigenval_tpu_torch.models.cnn_usps import CNNUSPS, gemm_conv3x3_same
from optwboundeigenval_tpu_torch.models.cxr import CXRModel, TransitHead
from optwboundeigenval_tpu_torch.models.densenet import DenseNet3
from optwboundeigenval_tpu_torch.models.layers import Conv2d, ConvTranspose2d, Embedding, Linear
from optwboundeigenval_tpu_torch.models.mlp_forest import ForestNet
from optwboundeigenval_tpu_torch.ops import curvature, eigen
from optwboundeigenval_tpu_torch.optim.api import sgd
from optwboundeigenval_tpu_torch.parallel import mesh as meshlib
from optwboundeigenval_tpu_torch.parallel.sharding import (
    infer_param_specs,
    shard_params,
    sharding_of,
)
from optwboundeigenval_tpu_torch.train import checkpoints
from optwboundeigenval_tpu_torch.train.task import Task, losses
from optwboundeigenval_tpu_torch.train.trainer import SpectralTrainer
from optwboundeigenval_tpu_torch.utils.tree import tree_uniform_like

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = {2: (1, 2), 4: (2, 2)}  # ranks -> (data, model)
RTOL_ORDERS = 1e-12
RTOL_RANKS = 1e-10
RTOL_JAX = 1e-9
MIN_ELEMS = 64
CXR_ROWS, CXR_CLASSES = 8, 4
DROPOUT_KEY = 5


@dataclasses.dataclass(frozen=True, eq=False)
class _Given(Task):
    """A task that starts from given weights ``(params, model_state)``."""

    weights: tuple = ({}, {})

    def init(self, generator, device):
        p, s = self.weights
        return ({k: t.to(device, copy=True) for k, t in p.items()},
                {k: t.to(device, copy=True) for k, t in s.items()})


def _trainer(task, mesh, tmp, header, **kw):
    return SpectralTrainer(task, kw.pop("opt", None) or sgd(0.1), mesh=mesh, device="cpu",
                           header=header, log_dir=os.path.join(tmp, "logs"),
                           model_dir=os.path.join(tmp, "models"), **kw)


def _shard(tr, min_elems):
    """The dryrun's ``tr.params = shard_params(...)``, ``tr.v = ...``."""
    if tr.mesh is not None:
        tr.params = shard_params(tr.params, tr.mesh, min_elems)
        tr.v = shard_params(tr.v, tr.mesh, min_elems)
    return tr


def _state(tr):
    """``f``, ``rho``, ``g`` and the gathered params (every rank calls it)."""
    return {"f": tr.f, "rho": tr.rho, "g": tr.g,
            "params": {k: t.detach().clone() for k, t in tr._full(tr.params).items()}}


def _local(batches, mesh):
    return batches if mesh is None else [meshlib.shard_batch(b, mesh) for b in batches]


def _images(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 4, size=n).astype(np.int32))


def _batch(x, y, w=None):
    out = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    if w is not None:
        out["w"] = torch.tensor(w, dtype=torch.float64)
    return out


# ---- the scenarios ------------------------------------------------------------


def orders(weights, mesh):
    """(ii) Every curvature product on 8 rows, ForestNet and a BatchNorm
    DenseNet3, plain, remat and with 2 micro-batches, gathered."""
    out = {}
    for name, task in (("forest", _Given(model=ForestNet(in_features=10, hidden=16,
                                                          num_classes=4),
                                         weights=weights["forest16"])),
                       ("densenet", _Given(model=DenseNet3(depth=10, growth_rate=4,
                                                           num_classes=4),
                                           has_batch_stats=True,
                                           weights=weights["densenet"]))):
        params, state = task.init(None, "cpu")
        if name == "forest":
            x, y = make_classification(8, 10, 4, seed=3)
        else:
            x, y = _images(8, 5)
        batch = _batch(x, y, [1.0] * 7 + [0.0])
        g = torch.Generator().manual_seed(3)
        v = {k: torch.randn(t.shape, generator=g, dtype=t.dtype) for k, t in params.items()}
        sh = None
        if mesh is not None:
            batch = meshlib.shard_batch(batch, mesh)
            sh = sharding_of(params, mesh, MIN_ELEMS)
            params, v = sh.local(params), sh.local(v)
        loss_fn = task.loss_fn(state)
        res = {}
        with meshlib.active(mesh, sh):
            res["loss"], res["grad"] = curvature.value_and_grad(loss_fn, params, batch)
            res["hv"] = curvature.hvp(loss_fn, params, batch, v)
            res["vghv"] = curvature.vghv(loss_fn, params, batch, v)
            res["remat_grad"], hvp_fn = curvature.recompute_hvp(loss_fn, params, batch)
            res["remat_hv"] = hvp_fn(v)
            res["micro_grad"] = curvature.grad_microbatched(loss_fn, params, batch, 2)
            res["micro_hv"] = curvature.hvp_microbatched(loss_fn, params, batch, v, 2)
            res["micro_vghv"] = curvature.vghv_microbatched(loss_fn, params, batch, v, 2)
            res["stats"] = task.train_loss(params, state, batch)[1]
            if sh is not None:
                res["local"] = {k: tuple(t.shape) for k, t in res["hv"].items()}
                res = {k: sh.gather_tree(t) if isinstance(t, dict) and k != "local" else t
                       for k, t in res.items()}
        out[name] = res
    return out


def eigensolve(weights, mesh):
    """(iii) tests/test_parallel.py:77 on the port: a ForestNet(hidden=16)
    eigensolve from the uniform vector, its large leaves sharded."""
    task = _Given(model=ForestNet(in_features=10, hidden=16, num_classes=4),
                  weights=weights["forest16"])
    params, _ = task.init(None, "cpu")
    x, y = make_classification(64, 10, 4, seed=4)
    batch = _batch(x, y, np.ones(64))
    sh = None
    if mesh is not None:
        batch = meshlib.shard_batch(batch, mesh)
        sh = sharding_of(params, mesh, MIN_ELEMS)
        params = sh.local(params)
    with meshlib.active(mesh, sh):
        _, hvp_fn = curvature.linearize_hvp(task.loss_fn({}), params, batch)
        res = eigen.estimate_dominant_eig(hvp_fn, tree_uniform_like(params), eps=1e-6,
                                          max_iter=500)
    return {"rho": float(res.rho), "iters": res.iters}


def dryrun(mesh, tmp):
    """(iv) __graft_entry__.py:121-230 on CNNUSPS, float64: 16 rows a
    batch (4 per device of the JAX 4-device mesh), min_elems=1024."""
    x, y = make_images(32, shape=(16, 16, 1), n_classes=10, seed=0)
    batches = list(ArrayLoader(x, y, batch_size=16))
    local = _local(batches, mesh)
    common = dict(mu=0.01, K=1.0, batch_size=16, pow_iter_eps=1e-2)
    model = lambda: CNNUSPS().double()
    out = {}

    tr = _trainer(Task(model=model()), mesh, tmp, "DRYRUN", opt=sgd(0.05), max_pow_iter=5,
                  **common)
    tr.init_state()
    _shard(tr, 1024)
    m = tr.train_step(local[0])
    out["step"] = {**_state(tr), "rho": m["rho"], "step_ok": m["step_ok"]}
    tr.defer_metrics, tr.scan_steps = True, 2
    tr.iter_epoch(local)
    out["scan"] = _state(tr)

    for leg, kw in (("lobpcg", dict(max_pow_iter=30, ignore_bad_vals=False, lobpcg=True,
                                    kfac_batch=1)),
                    ("lanczos", dict(max_pow_iter=5, ignore_bad_vals=False,
                                     eigensolver="lanczos", lanczos_m=4))):
        t = _trainer(Task(model=model()), mesh, tmp, f"DRYRUN_{leg}", opt=sgd(0.05),
                     **common, **kw)
        t.init_state()
        _shard(t, 1024)
        m = t.train_step(local[0])
        out[leg] = {**_state(t), "rho": m["rho"], "step_ok": m["step_ok"]}

    for leg, kw in (("ctl", {}), ("flag", dict(remat=True, defer_metrics=True, donate=True,
                                               scan_steps=2)),
                    ("auto", dict(eigensolver="auto"))):
        t = _trainer(Task(model=model()), mesh, tmp, f"DRYRUN_{leg}", opt=sgd(0.05),
                     max_pow_iter=5, seed=3, **common, **kw)
        t.init_state()
        _shard(t, 1024)
        t.iter_epoch(local)
        out[leg] = _state(t)
    out["sharded"] = sorted(tr._sharding.dims) if tr._sharding is not None else []
    return out


class _PinnedRng:
    def __init__(self, start=0):
        self.i = start

    def integers(self, low, high):
        self.i += 1
        return low + (self.i - 1) % max(high - low, 1)


def _rows(tr):
    if not tr._writer:
        return torch.zeros(0)
    return torch.tensor([[float(c) for c in ln.split()] for ln in open(tr.log_file)
                         if ln[:1].isdigit()], dtype=torch.float64)


def loop(weights, mesh, tmp, min_elems=None):
    """(v) tests/test_multihost.py:248: the whole train() on host_shard
    loaders fed by the data coordinate, then test_model through the
    host_shard loader; with ``min_elems`` on sharded params."""
    x, y = make_classification(128, 10, 4, seed=7)
    xv, yv = make_classification(64, 10, 4, seed=8)
    train = (ArrayLoader(x, y, batch_size=32) if mesh is None else
             ArrayLoader(x, y, batch_size=32 // mesh.data,
                         host_shard=(mesh.data_coord, mesh.data)))
    tr = _trainer(_Given(model=ForestNet(in_features=10, hidden=8, num_classes=4),
                         weights=weights["forest8"]), mesh, tmp, "MHDT", mu=0.05, K=0.0,
                  batch_size=32, max_pow_iter=50, pow_iter_eps=1e-4, min_iter=2, max_iter=2,
                  seed=0)
    tr._np_rng = _PinnedRng()
    if min_elems is not None:
        tr.init_state()
        _shard(tr, min_elems)
    tr.train(train_loader=train, valid_loader=ArrayLoader(xv, yv, batch_size=32))
    counted = (sum(len(b["y"]) for b in tr._eval_outputs_sharded(train)) if mesh is not None
               else len(x))
    return {**_state(tr), "rows": _rows(tr), "best_iter": tr.best_iter, "counted": counted,
            "eval": torch.tensor(tr.test_model(loader=train)),
            "sharded": sorted(tr._sharding.dims) if tr._sharding is not None else []}


def save_resume(weights, mesh, tmp):
    """(vi) One epoch with save_full on sharded params, the file, and a
    fresh sharded trainer resumed from it for the second epoch."""
    x, y = make_classification(64, 10, 4, seed=12)
    batches = _local(list(ArrayLoader(x, y, batch_size=32)), mesh)

    def trainer(epochs, start):
        tr = _trainer(_Given(model=ForestNet(in_features=10, hidden=16, num_classes=4),
                             weights=weights["forest16"]), mesh, tmp, "SR", mu=0.05,
                      K=0.0, batch_size=32, max_pow_iter=20, pow_iter_eps=1e-3,
                      min_iter=epochs, max_iter=epochs, seed=4, full_ckpt=True,
                      opt=sgd(0.1, momentum=0.9))
        tr._np_rng = _PinnedRng(start)
        tr.init_state()
        return _shard(tr, MIN_ELEMS)

    first = trainer(1, 0)
    first.train(train_loader=batches)
    fname = os.path.join(tmp, "models", first.header2 + "_full.pt")
    saved = checkpoints.load_checkpoint(fname) if first._writer else None
    second = trainer(2, 1)
    second.resume(fname)
    local_shapes = {k: tuple(t.shape) for k, t in second.opt_state["trace"].items()}
    second.train(train_loader=batches)
    return {"saved": saved, "resumed": _state(second), "trace_shapes": local_shapes}


def _optimizer(name):
    from optwboundeigenval_tpu_torch.optim.api import adam
    from optwboundeigenval_tpu_torch.optim.entropy_sgd import EntropySGD
    from optwboundeigenval_tpu_torch.optim.kfac_optimizer import KFAC
    from optwboundeigenval_tpu_torch.optim.sam import SAM

    return {"adam": lambda: adam(1e-2), "sam": lambda: SAM(sgd(0.1), rho=0.05),
            "entropy_sgd": lambda: EntropySGD(lr=0.1, L=2, g0=1e-2),
            "kfac": lambda: KFAC(lr=0.01, TCov=1, TInv=1)}[name]()


OPTIMIZERS = ("adam", "sam", "entropy_sgd", "kfac")


def optimizers_and_audits(weights, mesh, tmp):
    """An epoch of 2 steps per optimizer on sharded ForestNet params (K-FAC
    and Entropy-SGD step on the gathered tree, Adam and SAM on the
    slices), then ``rho_test_fused`` and both ``spectrum_test`` methods."""
    x, y = make_classification(64, 10, 4, seed=13)
    batches = _local(list(ArrayLoader(x, y, batch_size=32)), mesh)
    out = {}
    for name in OPTIMIZERS:
        tr = _trainer(_Given(model=ForestNet(in_features=10, hidden=16, num_classes=4),
                             weights=weights["forest16"]), mesh, tmp, f"OPT{name}",
                      opt=_optimizer(name), mu=0.05, K=0.0, batch_size=32, max_pow_iter=20,
                      pow_iter_eps=1e-3, seed=6)
        tr.init_state()
        _shard(tr, MIN_ELEMS)
        tr.iter_epoch(batches)
        out[name] = _state(tr)
    out["rho_test_fused"] = torch.tensor(tr.rho_test_fused(loader=batches))
    out["spectrum_subspace"] = torch.tensor(tr.spectrum_test(loader=batches, k=2, max_iter=30))
    out["spectrum_lanczos"] = torch.tensor(tr.spectrum_test(loader=batches, k=2,
                                                            method="lanczos", lanczos_m=8))
    return out


class ToyCXR(torch.nn.Module):
    """``CXRModel``'s layout at a toy size: a DenseNet trunk (blocks (2, 2),
    growth 8, 16 initial features) and ``TransitHead``, its 1,024-channel
    transit conv and the classifier to 4 classes."""

    forward = CXRModel.forward

    def __init__(self):
        super().__init__()
        self.features = backbones.DenseNetFeatures(block_config=(2, 2), growth_rate=8,
                                                   num_init_features=16)
        self.head = TransitHead(self.features.out_channels, CXR_CLASSES)


class _Gemm(torch.nn.Module):
    """CNNUSPS's gemm conv as a layer: a ``Conv2d``'s parameters through
    ``gemm_conv3x3_same``."""

    def __init__(self, cin, cout):
        super().__init__()
        self.conv = Conv2d(cin, cout, 3, padding=1)

    def forward(self, x):
        return gemm_conv3x3_same(x, self.conv.weight, self.conv.bias, self.conv.out_channels)


class _Layer(torch.nn.Module):
    """``layer`` behind a replicated per-channel scale of its input (so the
    input's gradient, completed over the ranks, reaches a leaf)."""

    def __init__(self, layer, channels=None, dim=1):
        super().__init__()
        self.layer, self.dim = layer, dim
        self.pre = None if channels is None else torch.nn.Parameter(torch.ones(channels))

    def forward(self, x):
        if self.pre is not None:
            x = torch.tanh(x * self.pre.reshape((-1,) + (1,) * (x.dim() - 1 - self.dim)))
        return self.layer(x)


def _layer_cases():
    """name: (module, input)."""
    g = torch.Generator().manual_seed(11)
    x = lambda *shape: torch.randn(shape, generator=g, dtype=torch.float64)
    return {
        "conv2d": (_Layer(Conv2d(4, 6, 3, padding=1), 4), x(2, 4, 5, 5)),
        "linear": (_Layer(Linear(5, 6), 5, -1), x(3, 5)),
        "conv_transpose2d": (_Layer(ConvTranspose2d(4, 6, 2, stride=2), 4), x(2, 4, 3, 3)),
        "embedding": (_Layer(Embedding(7, 6)), torch.randint(0, 7, (3, 4), generator=g)),
        "gemm_conv": (_Layer(_Gemm(4, 6), 4), x(2, 4, 5, 5)),
    }


def layers(mesh):
    """(vii) Each layer of ``_layer_cases`` with every weight sharded
    (``min_elems=1``): its output, and the gradient, HVP and vGHv of
    ``sum(c * sin(y))``, gathered; with the sharded leaves' local shapes."""
    from torch.func import functional_call

    out = {}
    for name, (net, x) in _layer_cases().items():
        net = net.double()
        g = torch.Generator().manual_seed(12)
        params = {k: torch.randn(p.shape, generator=g, dtype=torch.float64)
                  for k, p in net.named_parameters()}
        v = {k: torch.randn(t.shape, generator=g, dtype=torch.float64) for k, t in params.items()}
        c = torch.randn(functional_call(net, params, (x,)).shape, generator=g,
                        dtype=torch.float64)

        def loss_fn(p, batch):
            y = functional_call(net, p, (batch["x"],))
            loss = (batch["c"] * torch.sin(y)).sum()
            return loss if mesh is None else loss / mesh.model

        sh = None
        if mesh is not None:
            sh = sharding_of(params, mesh, 1, net)
            params, v = sh.local(params), sh.local(v)
        batch = {"x": x, "c": c}
        with meshlib.active(mesh, sh):
            res = {"y": {"y": functional_call(net, params, (x,)).detach()},
                   "grad": curvature.grad(loss_fn, params, batch),
                   "hv": curvature.hvp(loss_fn, params, batch, v),
                   "vghv": curvature.vghv(loss_fn, params, batch, v)}
            if sh is not None:
                res["local"] = {k: tuple(t.shape) for k, t in params.items()}
                res = {k: t if k in ("y", "local") else sh.gather_tree(t) for k, t in res.items()}
        out[name] = res
    return out


def _cxr_batch():
    """The global batch of the CXR-shaped model: 8 rows at 32 px, 4
    multi-label classes, the last row weighted 0."""
    rng = np.random.default_rng(21)
    x = rng.normal(size=(CXR_ROWS, 32, 32, 3))
    y = (rng.random((CXR_ROWS, CXR_CLASSES)) < 0.4).astype(np.float64)
    return _batch(x, y, [1.0] * (CXR_ROWS - 1) + [0.0])


def _dropout_batch():
    x, y = _images(CXR_ROWS, 22)
    return _batch(x.astype(np.float64), y, np.ones(CXR_ROWS))


def _micro_order(mesh, rows, micro=2):
    """The order of the global batch's rows whose ``data`` shards hold the
    one-process micro-batches: slice ``i`` of data coordinate ``d`` holds
    the ``d``-th part of the global slice ``i``, so micro-batched BatchNorm
    statistics and dropout masks are one process's (the identity with one
    data coordinate)."""
    if mesh is None or mesh.data == 1:
        return np.arange(rows)
    mb = rows // mesh.data // micro
    return np.array([i * (rows // micro) + d * mb + j for d in range(mesh.data)
                     for i in range(micro) for j in range(mb)])


STEP = dict(mu=0.05, K=0.0, batch_size=CXR_ROWS, max_pow_iter=4, pow_iter_eps=1e-12,
            ignore_bad_vals=False)
STEP_LEGS = {"plain": {}, "remat": {"remat": True}, "micro": {"hvp_micro": 2}}
SPECTRAL_PARTS = ("grad", "hv", "vghv", "remat_grad", "remat_hv", "micro_grad", "micro_hv",
                  "micro_vghv")


def _spectral_task(name, weights):
    if name == "cxr":
        return _Given(model=ToyCXR().double(), loss=losses["weighted_bce_with_logits"],
                      has_batch_stats=True, weights=weights["cxr"]), _cxr_batch()
    return (_Given(model=_dropout_densenet(), has_batch_stats=True, has_dropout=True,
                   weights=weights["densenet"]), _dropout_batch())


def _dropout_densenet():
    return DenseNet3(depth=10, growth_rate=4, num_classes=4, drop_rate=0.2).double()


def spectral(weights, mesh, tmp):
    """(viii) The CXR-shaped model and a dropout DenseNet3 with every layer
    sharded (``min_elems=64``): the curvature products, plain, remat and
    with 2 micro-batches, gathered (the dropout model's under flax's masks
    of ``DROPOUT_KEY`` where the weights carry them), and one
    ``train_step`` a leg (plain, ``remat``, ``hvp_micro=2``; the trainer's
    own masks): its ``rho`` and the update of the gathered params."""
    out = {}
    for name in ("cxr", "dropout"):
        task, glob = _spectral_task(name, weights)
        params, state = task.init(None, "cpu")
        p0 = {k: t.clone() for k, t in params.items()}
        key = DROPOUT_KEY if task.has_dropout else None
        v = weights[f"{name}_v"]
        table = weights.get("dropout_masks") if task.has_dropout else None
        masks = (dropout.inject(lambda _key, site, shape: table[(site, shape)]) if table
                 else contextlib.nullcontext())

        def local(micro):
            if mesh is None:
                return glob
            order = _micro_order(mesh, CXR_ROWS) if micro else np.arange(CXR_ROWS)
            return meshlib.shard_batch({k: t[order] for k, t in glob.items()}, mesh)

        b, bm = local(False), local(True)
        sh = None
        if mesh is not None:
            sh = sharding_of(params, mesh, MIN_ELEMS, task.model)
            params, v = sh.local(params), sh.local(v)
        loss_fn = task.loss_fn(state, key)
        with meshlib.active(mesh, sh), masks:
            res = {"grad": curvature.grad(loss_fn, params, b),
                   "hv": curvature.hvp(loss_fn, params, b, v),
                   "vghv": curvature.vghv(loss_fn, params, b, v)}
            res["remat_grad"], hvp_fn = curvature.recompute_hvp(loss_fn, params, b)
            res["remat_hv"] = hvp_fn(v)
            res["micro_grad"] = curvature.grad_microbatched(loss_fn, params, bm, 2)
            res["micro_hv"] = curvature.hvp_microbatched(loss_fn, params, bm, v, 2)
            res["micro_vghv"] = curvature.vghv_microbatched(loss_fn, params, bm, v, 2)
            if sh is not None:
                res = {k: sh.gather_tree(t) for k, t in res.items()}
        for leg, kw in STEP_LEGS.items():
            tr = _trainer(task, mesh, tmp, f"SPEC{name}{leg}", seed=9, **STEP, **kw)
            tr.init_state()
            if mesh is not None:
                tr.params = shard_params(tr.params, mesh, MIN_ELEMS, task.model)
                tr.v = shard_params(tr.v, mesh, MIN_ELEMS, task.model)
            m = tr.train_step(bm if kw.get("hvp_micro") else b)
            full = tr._full(tr.params)
            res[f"step_{leg}"] = {"rho": m["rho"], "pow_iters": m["pow_iters"],
                                  "update": {k: full[k] - p0[k] for k in p0}}
        out[name] = res
    return out


def forward_reduces(weights, mesh):
    """(ix) ``(values, over the model group)`` of every all-reduce of one
    eval-mode forward of the CXR-shaped model on this rank's rows, every
    layer sharded."""
    task, glob = _spectral_task("cxr", weights)
    params, state = task.init(None, "cpu")
    sh = sharding_of(params, mesh, MIN_ELEMS, task.model)
    params = sh.local(params)
    calls = []
    real = torch.distributed.all_reduce

    def counting(t, *args, **kwargs):
        calls.append((t.numel(), kwargs.get("group") is mesh.model_group))
        return real(t, *args, **kwargs)

    torch.distributed.all_reduce = counting
    try:
        with meshlib.active(mesh, sh):
            task.predict(params, state, meshlib.shard_batch(glob, mesh))
    finally:
        torch.distributed.all_reduce = real
    return calls


def scenarios(weights, mesh, tmp, world):
    """The scenarios of a world on this rank (``mesh``) or one process."""
    out = {}
    if world in (None, 2):
        out["orders"] = orders(weights, mesh)
        out["save_resume"] = save_resume(weights, mesh, os.path.join(tmp, "sr"))
        out["optimizers"] = optimizers_and_audits(weights, mesh, os.path.join(tmp, "opt"))
        out["layers"] = layers(mesh)
    if world in (None, 4):
        out["eigensolve"] = eigensolve(weights, mesh)
        out["dryrun"] = dryrun(mesh, os.path.join(tmp, "dry"))
        out["loop"] = loop(weights, mesh, os.path.join(tmp, "loop"))
        out["loop_sharded"] = loop(weights, mesh, os.path.join(tmp, "loops"), MIN_ELEMS)
    out["spectral"] = spectral(weights, mesh, os.path.join(tmp, "spectral"))
    if mesh is not None:
        out["reduces"] = forward_reduces(weights, mesh)
    return out


# ---- the pytest side ----------------------------------------------------------


def _jax_weights():
    """Float64 JAX inits (ForestNet hidden 16 and 8, a small DenseNet3) and
    the port's copies."""
    import jax
    import jax.numpy as jnp

    from optwboundeigenval_tpu.models import ForestNet as JForestNet
    from optwboundeigenval_tpu.models.densenet import DenseNet3 as JDenseNet3
    from optwboundeigenval_tpu.train.task import Task as JTask
    from optwboundeigenval_tpu_torch.utils import interop

    f64 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float64), t)
    jax_w, port_w = {}, {}
    for hidden in (16, 8):
        p, _ = JTask(model=JForestNet(hidden=hidden, num_classes=4, dtype=jnp.float64)).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 10)))
        jax_w[f"forest{hidden}"] = (f64(p), {})
        port_w[f"forest{hidden}"] = (interop.forestnet_from_jax(f64(p)), {})
    pd, sd = JTask(model=JDenseNet3(depth=10, growth_rate=4, num_classes=4,
                                    dtype=jnp.float64), has_batch_stats=True).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    port_w["densenet"] = interop.densenet3_from_jax(*f64((pd, sd["batch_stats"])))
    rng = np.random.default_rng(23)
    v = jax.tree.map(lambda a: rng.normal(size=a.shape), f64(pd))
    jax_w["dropout"] = (f64(pd), f64(sd["batch_stats"]), v)
    port_w["dropout_v"] = interop.densenet3_from_jax(v, f64(sd["batch_stats"]))[0]
    port_w["dropout_masks"] = _flax_masks(*jax_w["dropout"][:2])
    p, s, v = _jax_cxr_vars()
    jax_w["cxr"], jax_w["cxr_v"] = (p, s), v
    port_w["cxr"] = interop.from_jax(ToyCXR().double(), p, s)
    port_w["cxr_v"] = interop.from_jax(ToyCXR().double(), v, s)[0]
    return jax_w, port_w


def _jax_dropout_densenet():
    import jax.numpy as jnp

    from optwboundeigenval_tpu.models.densenet import DenseNet3 as JDenseNet3

    return JDenseNet3(depth=10, growth_rate=4, num_classes=4, drop_rate=0.2,
                      dtype=jnp.float64)


def _flax_masks(params, stats):
    """``{(site, shape): keep mask}``: the masks flax's dropout layers draw
    under ``DROPOUT_KEY`` on the dropout batch and on a micro-batch of it
    (they depend on the key and the shape only), for ``dropout.inject``."""
    import jax

    from test_torch_dropout import flax_masks

    sites = dropout.sites(_dropout_densenet())
    x = _dropout_batch()["x"].numpy()
    table = {}
    for rows in (x, x[:CXR_ROWS // 2]):
        masks = flax_masks(_jax_dropout_densenet(), {"params": params, "batch_stats": stats},
                           rows, jax.random.PRNGKey(DROPOUT_KEY))
        for site, m in zip(sites, masks):
            table[(site, m.shape)] = torch.tensor(m)
    return table


def _jax_toy_cxr():
    """The JAX package's ``CXRModel`` composition at ``ToyCXR``'s size."""
    import flax.linen as fnn
    import jax.numpy as jnp

    from optwboundeigenval_tpu.models import backbones as jbb
    from optwboundeigenval_tpu.models.cxr import TransitHead as JTransitHead

    class JToyCXR(fnn.Module):
        def setup(self):
            self.features = jbb.DenseNetFeatures(block_config=(2, 2), growth_rate=8,
                                                 num_init_features=16, dtype=jnp.float64)
            self.head = JTransitHead(CXR_CLASSES, jnp.float64)

        def __call__(self, x, train=False):
            return self.head(self.features(x, train), train)

    return JToyCXR()


def _jax_cxr_vars(seed=3):
    """float64 flax variables of the toy CXR model and a vector ``v`` in
    its layout: kernels ``N(0, 1 / fan_in)``, biases ``N(0, 0.01)``,
    BatchNorm scales ``1 + N(0, 0.01)``, running means in ``[0.1, 0.5)``
    and variances in ``[1.1, 1.5)``; ``v`` standard normal."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(
        lambda x: _jax_toy_cxr().init(jax.random.PRNGKey(0), x, train=False),
        jax.ShapeDtypeStruct((1, 32, 32, 3), jnp.float64))

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            return rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        if name in ("bias", "scale"):
            return (name == "scale") + 0.1 * rng.normal(size=shape)
        return (name == "var") + rng.uniform(0.1, 0.5, size=shape)

    p = jax.tree_util.tree_map_with_path(draw, shapes["params"])
    s = jax.tree_util.tree_map_with_path(draw, shapes["batch_stats"])
    v = jax.tree.map(lambda a: rng.normal(size=a.shape), p)
    return p, s, v


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def worlds():
    """``(jax weights, one-process results, {world: [per-rank results]})``."""
    jax_w, port_w = _jax_weights()
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(port_w, os.path.join(tmp, "weights.pt"))
        env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
        procs = []
        for world in WORLDS:
            port = _free_port()
            procs += [(world, r, subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), str(r), str(world), str(port), tmp],
                cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
                for r in range(world)]
        try:
            one = scenarios(port_w, None, os.path.join(tmp, "one"), None)
        finally:
            logs = []
            for _, _, p in procs:
                try:
                    logs.append(p.communicate(timeout=300)[0].decode(errors="replace"))
                except subprocess.TimeoutExpired:
                    for _, _, q in procs:
                        q.kill()
                    raise
        for (world, r, p), log in zip(procs, logs):
            assert p.returncode == 0, f"world {world} rank {r} failed:\n{log[-4000:]}"
        ranks = {w: [torch.load(os.path.join(tmp, f"w{w}_rank{r}.pt"), weights_only=False)
                     for r in range(w)] for w in WORLDS}
    return jax_w, one, ranks


def _close(got, want, rtol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(float(np.abs(want).max(initial=0.0)), 1e-30),
                               err_msg=what)


def _close_tree(got, want, rtol, what):
    assert sorted(got) == sorted(want), what
    for k, t in want.items():
        _close(got[k], t, rtol, f"{what} {k}")


def _close_state(got, want, rtol, what):
    for k in ("f", "rho", "g"):
        _close(got[k], want[k], rtol, f"{what} {k}")
    _close_tree(got["params"], want["params"], rtol, f"{what} params")


# (i) ---------------------------------------------------------------------------

def _spec_models():
    """name: (JAX module, port module, the JAX init's inputs, min_elems)."""
    import jax.numpy as jnp

    from optwboundeigenval_tpu.models import CNNUSPS as JCNNUSPS, ForestNet as JForestNet
    from optwboundeigenval_tpu.models import gan as jgan
    from optwboundeigenval_tpu.models.densenet import DenseNet3 as JDenseNet3
    from optwboundeigenval_tpu_torch.models import gan

    labels = np.zeros(1, np.int32)
    return {
        "forest": (JForestNet(hidden=16, num_classes=7, dtype=jnp.float64),
                   ForestNet(hidden=16), (np.zeros((1, 54)),), 64),
        "cnnusps_lax": (JCNNUSPS(dtype=jnp.float64), CNNUSPS(),
                        (np.zeros((1, 16, 16, 1)),), 1024),
        "cnnusps_gemm": (JCNNUSPS(dtype=jnp.float64, conv_impl="gemm"),
                         CNNUSPS(conv_impl="gemm"), (np.zeros((1, 16, 16, 1)),), 1024),
        "densenet3": (JDenseNet3(depth=10, growth_rate=12, num_classes=10,
                                 dtype=jnp.float64),
                      DenseNet3(depth=10, growth_rate=12, num_classes=10),
                      (np.zeros((1, 32, 32, 3)),), 1024),
        "cxr": (_jax_toy_cxr(), ToyCXR(), (np.zeros((1, 32, 32, 3)),), MIN_ELEMS),
        "mlp_generator": (jgan.MLPGenerator(n=4, latent_dim=8, dtype=jnp.float64),
                          gan.MLPGenerator(latent_dim=8, n=4),
                          (np.zeros((1, 8)), labels), MIN_ELEMS),
        "mlp_discriminator": (jgan.MLPDiscriminator(n=4, dtype=jnp.float64),
                              gan.MLPDiscriminator(n=4),
                              (np.zeros((1, 16, 16, 1)), labels), MIN_ELEMS),
        "dc_generator": (jgan.DCGenerator(latent_dim=8, feat=4, dtype=jnp.float64),
                         gan.DCGenerator(latent_dim=8, feat=4),
                         (np.zeros((1, 8)), labels), MIN_ELEMS),
        "dc_discriminator": (jgan.DCDiscriminator(feat=4, dtype=jnp.float64),
                             gan.DCDiscriminator(feat=4),
                             (np.zeros((1, 32, 32, 1)), labels), MIN_ELEMS),
    }


def _from_jax(model, params, batch_stats):
    from optwboundeigenval_tpu_torch.utils import interop

    if isinstance(model, ForestNet):
        return interop.forestnet_from_jax(params)
    if isinstance(model, CNNUSPS):
        return interop.cnnusps_from_jax(params)
    return interop.from_jax(model, params, batch_stats)[0]


SPEC_MODELS = ["forest", "cnnusps_lax", "cnnusps_gemm", "densenet3", "cxr", "mlp_generator",
               "mlp_discriminator", "dc_generator", "dc_discriminator"]


@pytest.mark.parametrize("name", SPEC_MODELS)
def test_infer_param_specs_match_jax_through_interop(eight_devices, name):
    """The port shards the leaves JAX shards, along the dimension that
    ``utils/interop.py`` maps JAX's trailing (output-feature) dimension
    to: every kernel and embedding filled with its trailing index comes
    out of the interop map constant along all but its layer's output
    dimension (dim 0 of a conv or dense weight, dim 1 of a transposed
    conv or embedding weight), which holds that index."""
    import jax
    from jax.sharding import PartitionSpec as P

    from optwboundeigenval_tpu.parallel import make_mesh as jmake_mesh
    from optwboundeigenval_tpu.parallel.sharding import infer_param_specs as jspecs
    from optwboundeigenval_tpu_torch.parallel.sharding import output_dims
    from optwboundeigenval_tpu_torch.utils import interop

    jmodel, model, inputs, min_elems = _spec_models()[name]
    # only the shapes: every kernel's values are its trailing index below
    variables = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, *inputs,
        train=False))
    zeros = lambda tree: jax.tree.map(lambda a: np.zeros(a.shape, np.float64), tree)
    params, stats = zeros(variables["params"]), zeros(variables.get("batch_stats", {}))
    specs = interop.flatten(jspecs(params, jmake_mesh(data=4, model=2), min_elems))
    # JAX's trailing index, through the interop map
    indexed = jax.tree.map(lambda a: np.broadcast_to(
        np.arange(a.shape[-1], dtype=np.float64), a.shape).copy() if a.ndim >= 2 else a,
        params)
    port = _from_jax(model, indexed, stats)
    names = interop.module_names(model)
    dims = output_dims(model)
    mesh = meshlib.Mesh(device=torch.device("cpu"), data=4, model=2, rank=0)
    ours = infer_param_specs(port, mesh, min_elems, model)
    want = {}
    for path, spec in specs.items():
        scope, leaf = path.rsplit("/", 1)
        if leaf not in ("kernel", "embedding"):
            assert spec == P(), path
            continue
        key = f"{names[scope]}.weight"
        t, d = port[key], dims[key]
        want[key] = d if spec == P(*([None] * (t.dim() - 1)), "model") else None
        shape = [1] * t.dim()
        shape[d] = -1
        index = torch.arange(t.shape[d], dtype=t.dtype).reshape(shape)
        assert torch.equal(t, index.expand_as(t)), f"{key}: JAX's trailing dim is not dim {d}"
    assert {k: d for k, d in ours.items() if d is not None} == {
        k: d for k, d in want.items() if d is not None}
    assert any(d is not None for d in ours.values())
    assert all(d is None for k, d in ours.items() if k not in want)


def test_infer_param_specs_on_a_model_axis_of_one():
    mesh = meshlib.Mesh(device=torch.device("cpu"), data=2, model=1, rank=0)
    params = dict(ForestNet(hidden=16).named_parameters())
    assert set(infer_param_specs(params, mesh, 1).values()) == {None}
    assert shard_params(params, mesh, 1) is params
    assert sharding_of(params, mesh, 1) is None


def test_shard_params_slices_and_is_idempotent():
    """Rank 3 of data=2 x model=2 sits at model coordinate 1: the second
    half of every sharded leaf's rows, as a ``Sharded`` tree that
    ``shard_params`` hands back unchanged."""
    mesh = meshlib.Mesh(device=torch.device("cpu"), data=2, model=2, rank=3)
    assert (mesh.data_coord, mesh.model_coord, mesh.world) == (1, 1, 4)
    params = {k: p.detach() for k, p in ForestNet(hidden=16).named_parameters()}
    local = shard_params(params, mesh, MIN_ELEMS)
    assert sorted(local.sharding.dims) == ["fc1.weight", "fc2.weight"]  # fc3: 7 rows
    for k, t in params.items():
        if k in local.sharding.dims:
            assert torch.equal(local[k], t[t.shape[0] // 2:])
            assert local.sharding.is_local(k, local[k]) and not local.sharding.is_local(k, t)
        else:
            assert local[k] is t
    assert shard_params(local, mesh, MIN_ELEMS) is local


# (ii) --------------------------------------------------------------------------

PRODUCTS = ("grad", "hv", "vghv", "remat_grad", "remat_hv", "micro_grad", "micro_hv",
            "micro_vghv", "stats")


@pytest.mark.parametrize("model", ["forest", "densenet"])
def test_sharded_curvature_products_match_one_process(worlds, model):
    """2 ranks, data=1 x model=2: the sharded leaves' products are the
    rank's slices, gathered equal to one process's at rtol 1e-12."""
    _, one, ranks = worlds
    want = one["orders"][model]
    for r, res in enumerate(ranks[2]):
        got = res["orders"][model]
        assert any(s[0] * 2 == want["hv"][k].shape[0] for k, s in got["local"].items())
        _close(got["loss"], want["loss"], RTOL_ORDERS, f"rank {r} {model} loss")
        for part in PRODUCTS:
            _close_tree(got[part], want[part], RTOL_ORDERS, f"rank {r} {model} {part}")


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizers_on_sharded_params_match_one_process(worlds, name):
    _, one, ranks = worlds
    for r, res in enumerate(ranks[2]):
        _close_state(res["optimizers"][name], one["optimizers"][name], RTOL_RANKS,
                     f"rank {r} {name}")


@pytest.mark.parametrize("audit", ["rho_test_fused", "spectrum_subspace", "spectrum_lanczos"])
def test_audits_on_sharded_params_match_one_process(worlds, audit):
    """The flat solvers work on the gathered vector: the same subspace
    start rows and Lanczos perturbations as one process."""
    _, one, ranks = worlds
    want = one["optimizers"][audit]
    for r, res in enumerate(ranks[2]):
        got = res["optimizers"][audit]
        if audit == "rho_test_fused":
            got, want_ = got[:3], want[:3]  # rho, norm, iters; not the seconds
        else:
            got, want_ = got[:, :2], want[:, :2]  # the eigenvalues
        _close(got, want_, RTOL_RANKS, f"rank {r} {audit}")


# (iii) -------------------------------------------------------------------------

def test_sharded_eigensolve_matches_jax_replicated(worlds, eight_devices):
    """tests/test_parallel.py:77: the JAX replicated eigensolve from the
    same weights, against the port's on data=2 x model=2 (rtol 1e-9)."""
    import jax
    import jax.numpy as jnp

    from optwboundeigenval_tpu.data.synthetic import make_classification as jclassification
    from optwboundeigenval_tpu.models import ForestNet as JForestNet
    from optwboundeigenval_tpu.ops import curvature as jcurv, eigen as jeigen
    from optwboundeigenval_tpu.train.task import Task as JTask
    from optwboundeigenval_tpu.utils.tree import tree_uniform_like as jtree_uniform_like

    jax_w, one, ranks = worlds
    task = JTask(model=JForestNet(hidden=16, num_classes=4, dtype=jnp.float64))
    x, y = jclassification(64, 10, 4, seed=4)
    batch = {"x": jnp.asarray(x, jnp.float64), "y": jnp.asarray(y),
             "w": jnp.ones(64, jnp.float64)}
    params = jax.tree.map(jnp.asarray, jax_w["forest16"][0])

    def loss_fn(p, b):
        return task.loss(task.model.apply({"params": p}, b["x"], train=True), b["y"], b["w"])

    _, hvp_fn = jcurv.linearize_hvp(loss_fn, params, batch)
    want = float(jeigen.estimate_dominant_eig(hvp_fn, jtree_uniform_like(params), eps=1e-6,
                                              max_iter=500).rho)
    _close(one["eigensolve"]["rho"], want, RTOL_JAX, "one process vs JAX")
    for r, res in enumerate(ranks[4]):
        _close(res["eigensolve"]["rho"], want, RTOL_JAX, f"rank {r} vs JAX")
        assert res["eigensolve"]["iters"] == one["eigensolve"]["iters"]


# (iv) --------------------------------------------------------------------------

DRYRUN_LEGS = ("step", "scan", "lobpcg", "lanczos", "ctl", "flag", "auto")


@pytest.mark.parametrize("leg", DRYRUN_LEGS)
def test_dryrun_sequence_on_four_ranks_matches_one_process(worlds, leg):
    _, one, ranks = worlds
    want = one["dryrun"][leg]
    for r, res in enumerate(ranks[4]):
        assert res["dryrun"]["sharded"] == ["conv2.weight", "conv3.weight", "fc1.weight"]
        _close_state(res["dryrun"][leg], want, RTOL_RANKS, f"rank {r} {leg}")
        if "step_ok" in want:
            assert res["dryrun"][leg]["step_ok"] and want["step_ok"]


# (v) ---------------------------------------------------------------------------

def _jax_loop_rows(monkeypatch, tmp_path, jax_w):
    """tests/test_multihost.py:135 at float64 from the port's weights."""
    import jax
    import jax.numpy as jnp

    from optwboundeigenval_tpu.data.loaders import ArrayLoader as JLoader
    from optwboundeigenval_tpu.data.synthetic import make_classification as jclassification
    from optwboundeigenval_tpu.models import ForestNet as JForestNet
    from optwboundeigenval_tpu.optim import sgd as jsgd
    from optwboundeigenval_tpu.train import SpectralTrainer as JTrainer
    from optwboundeigenval_tpu.train.task import Task as JTask

    p0, _ = jax_w["forest8"]
    monkeypatch.setattr(JTask, "init", lambda self, rng, x: (jax.tree.map(np.asarray, p0), {}))
    x, y = jclassification(128, 10, 4, seed=7)
    xv, yv = jclassification(64, 10, 4, seed=8)
    tr = JTrainer(JTask(model=JForestNet(hidden=8, num_classes=4, dtype=jnp.float64)),
                  jsgd(0.1), mu=0.05, K=0.0, batch_size=32, max_pow_iter=50,
                  pow_iter_eps=1e-4, min_iter=2, max_iter=2, seed=0, header="JMHDT",
                  log_dir=str(tmp_path / "logs"), model_dir=str(tmp_path / "models"))
    tr._np_rng = _PinnedRng()
    tr.train(train_loader=JLoader(x, y, batch_size=32),
             valid_loader=JLoader(xv, yv, batch_size=32))
    rows = [[float(c) for c in ln.split()] for ln in open(tr.log_file) if ln[:1].isdigit()]
    return np.asarray(rows)


@pytest.mark.parametrize("variant", ["loop", "loop_sharded"])
def test_dp_tp_train_loop_on_four_ranks(worlds, monkeypatch, tmp_path, variant):
    """The whole loop on data=2 x model=2: rank 0's TSV equals one
    process's and the JAX package's single-process rows (epoch, f, rho,
    h, norm, val_acc, val_f1), every rank holds the same state, and the
    train-set evaluation through the host_shard loader counts every row
    once (``_eval_is_contributor``)."""
    jax_w, one, ranks = worlds
    want = one[variant]
    assert want["rows"].shape == (2, 7)
    _close(ranks[4][0][variant]["rows"], want["rows"], RTOL_RANKS, "TSV rows")
    _close(want["rows"], _jax_loop_rows(monkeypatch, tmp_path, jax_w), RTOL_JAX,
           "one process vs JAX rows")
    for r, res in enumerate(ranks[4]):
        got = res[variant]
        if r:
            assert got["rows"].numel() == 0
        _close_state(got, want, RTOL_RANKS, f"rank {r} {variant}")
        _close(got["eval"], want["eval"], RTOL_RANKS, f"rank {r} train eval")
        assert got["best_iter"] == want["best_iter"]
        assert got["counted"] == 128  # each row once: the model replicas send w = 0
        assert got["sharded"] == ([] if variant == "loop" else ["fc1.weight", "fc2.weight"])


# (vi) --------------------------------------------------------------------------

def test_save_full_from_sharded_ranks_and_resume(worlds):
    """Rank 0 writes the gathered tree: the file equals one process's; a
    fresh sharded trainer resumes from it, its momentum cut to the
    slices, and ends the second epoch where one process does."""
    _, one, ranks = worlds
    want = one["save_resume"]
    saved = ranks[2][0]["save_resume"]["saved"]
    assert ranks[2][1]["save_resume"]["saved"] is None
    for part in ("params", "v"):
        _close_tree(saved[part], want["saved"][part], RTOL_RANKS, f"saved {part}")
    _close_tree(saved["opt_state"]["trace"], want["saved"]["opt_state"]["trace"], RTOL_RANKS,
                "saved momentum")
    assert saved["params"]["fc1.weight"].shape == (16, 10)
    for r, res in enumerate(ranks[2]):
        got = res["save_resume"]
        assert got["trace_shapes"]["fc1.weight"] == (8, 10)
        assert got["trace_shapes"]["fc1.bias"] == (16,)
        _close_state(got["resumed"], want["resumed"], RTOL_RANKS, f"rank {r} resumed")


# (vii) -------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(_layer_cases()))
def test_layer_computes_its_own_columns(worlds, name):
    """2 ranks, data=1 x model=2, each layer holding half of its weight's
    output features: the output, the gradient, the HVP and the vGHv equal
    the whole layer's in one process at rtol 1e-12."""
    _, one, ranks = worlds
    want = one["layers"][name]
    for r, res in enumerate(ranks[2]):
        got = res["layers"][name]
        assert got["local"]["layer.weight" if name != "gemm_conv" else "layer.conv.weight"][
            1 if name in ("conv_transpose2d", "embedding") else 0] == 3
        for part in ("y", "grad", "hv", "vghv"):
            _close_tree(got[part], want[part], RTOL_ORDERS, f"rank {r} {name} {part}")


def test_a_slice_needs_its_mesh_and_a_layer_that_splits():
    """Outside an active mesh a sliced weight raises, as it does in a layer
    that cannot split (a grouped conv); nothing falls back."""
    from torch.func import functional_call

    conv = Conv2d(4, 6, 3).double()
    half = {"weight": conv.weight[:3].detach(), "bias": conv.bias.detach()}
    with pytest.raises(RuntimeError, match="mesh active"):
        functional_call(conv, half, (torch.zeros(1, 4, 5, 5, dtype=torch.float64),))
    grouped = Conv2d(4, 6, 3, groups=2).double()
    half = {"weight": grouped.weight[:3].detach(), "bias": grouped.bias.detach()}
    with pytest.raises(ValueError, match="cannot compute"):
        functional_call(grouped, half, (torch.zeros(1, 4, 5, 5, dtype=torch.float64),))


def test_trainer_refuses_leaves_sharded_along_another_dim(tmp_path):
    """``shard_params`` without the model takes dim 0, which is not a
    transposed conv's output feature: the trainer refuses it, and takes
    the shards of ``shard_params(..., model=...)``."""
    from optwboundeigenval_tpu_torch.models.gan import DCGenerator

    mesh = meshlib.Mesh(device=torch.device("cpu"), data=1, model=2, rank=1)
    model = DCGenerator(latent_dim=8, feat=4)
    tr = _trainer(Task(model=model), mesh, str(tmp_path), "DIMS")
    tr.init_state()
    with pytest.raises(ValueError, match="output feature"):
        tr.params = shard_params(tr.params, mesh, 64)
    tr.params = shard_params(tr.params, mesh, 64, model)
    assert tr._sharding.dims == {"label_emb.weight": 1, "deconv.0.weight": 1,
                                 "deconv.1.weight": 1, "deconv.2.weight": 1}
    assert tr.params["deconv.0.weight"].shape == (8, 8, 4, 4)


# (viii) ------------------------------------------------------------------------

def _close_scaled(got, want, rtol, what):
    """Leaf by leaf to ``rtol``, with an absolute floor of ``rtol`` times the
    tree's largest value: a conv bias ahead of a BatchNorm has a zero
    gradient, which float64 leaves at rounding level."""
    assert sorted(got) == sorted(want), what
    scale = max(float(t.abs().max()) for t in want.values())
    for k, t in want.items():
        np.testing.assert_allclose(np.asarray(got[k], np.float64), np.asarray(t, np.float64),
                                   rtol=rtol, atol=rtol * scale, err_msg=f"{what} {k}")


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("model", ["cxr", "dropout"])
def test_column_split_spectral_step_matches_one_process(worlds, world, model):
    """Every layer of the CXR-shaped model (BatchNorm) and of a dropout
    DenseNet3 sharded: the gradient, HVP and vGHv (plain, remat, 2
    micro-batches through K1's plain version) and a step's ``rho`` and
    update of each leg equal one process's, on data=1 x model=2 and
    data=2 x model=2."""
    _, one, ranks = worlds
    want = one["spectral"][model]
    for r, res in enumerate(ranks[world]):
        got = res["spectral"][model]
        for part in SPECTRAL_PARTS:
            _close_scaled(got[part], want[part], RTOL_ORDERS, f"w{world} rank {r} {part}")
        for leg in STEP_LEGS:
            g, w = got[f"step_{leg}"], want[f"step_{leg}"]
            assert g["pow_iters"] == w["pow_iters"] == STEP["max_pow_iter"]
            _close(g["rho"], w["rho"], RTOL_ORDERS, f"w{world} rank {r} {leg} rho")
            _close_scaled(g["update"], w["update"], RTOL_ORDERS, f"w{world} rank {r} {leg}")


@pytest.fixture(scope="module")
def jax_cxr(worlds, eight_devices, tmp_path_factory):
    """The JAX package's run of the toy CXR model with ``shard_params`` on
    the 8-device CPU mesh (data=4 x model=2, tests/test_parallel.py:77):
    the gradient, HVP and vGHv and a ``train_step`` (plain, and
    ``hvp_micro=2``, whose update carries the micro-batched gradient,
    HVPs and vGHv) in the port's layout."""
    import jax
    import jax.numpy as jnp

    from optwboundeigenval_tpu.ops import curvature as jcurv
    from optwboundeigenval_tpu.optim import sgd as jsgd
    from optwboundeigenval_tpu.parallel import make_mesh as jmake_mesh
    from optwboundeigenval_tpu.parallel import shard_batch as jshard_batch
    from optwboundeigenval_tpu.parallel import shard_params as jshard_params
    from optwboundeigenval_tpu.train import SpectralTrainer as JTrainer
    from optwboundeigenval_tpu.train.task import Task as JTask
    from optwboundeigenval_tpu.train.task import losses as jlosses
    from optwboundeigenval_tpu_torch.utils import interop

    jax_w, _, _ = worlds
    (p, s), v = jax_w["cxr"], jax_w["cxr_v"]
    mesh = jmake_mesh(data=4, model=2)
    task = JTask(model=_jax_toy_cxr(), loss=jlosses["weighted_bce_with_logits"],
                 has_batch_stats=True)
    batch = {k: t.numpy() for k, t in _cxr_batch().items()}
    loss = task.loss_fn({"batch_stats": s})
    pt, vt = jshard_params(p, mesh, MIN_ELEMS), jshard_params(v, mesh, MIN_ELEMS)
    bt = jshard_batch({k: jnp.asarray(t) for k, t in batch.items()}, mesh)
    port = lambda tree: interop.from_jax(ToyCXR().double(), jax.tree.map(np.asarray, tree),
                                         s)[0]
    out = {}
    for name, fn, args in (("grad", jcurv.grad, ()), ("hv", jcurv.hvp, (vt,)),
                           ("vghv", jcurv.vghv, (vt,))):
        out[name] = port(jax.jit(fn, static_argnums=0)(loss, pt, bt, *args))
    tmp = str(tmp_path_factory.mktemp("jax_cxr"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JTask, "init", lambda self, rng, x: (p, {"batch_stats": s}))
        for leg, micro in (("plain", 0), ("micro", 2)):
            tr = JTrainer(task, jsgd(0.1), mesh=mesh, hvp_micro=micro, header=f"J{leg}",
                          log_dir=tmp, model_dir=tmp, **STEP)
            tr.init_state(batch)
            tr.params = jshard_params(tr.params, mesh, MIN_ELEMS)
            tr.v = jshard_params(tr.v, mesh, MIN_ELEMS)
            m = tr.train_step(batch)
            after = jax.tree.map(lambda a, b: np.asarray(a) - b, tr.params, p)
            out[f"step_{leg}"] = {"rho": float(m["rho"]), "update": port(after)}
    return out


@pytest.mark.parametrize("world", [None] + list(WORLDS))
def test_column_split_cxr_matches_jax_shard_params(worlds, jax_cxr, world):
    """The toy CXR model on one process and on each rank of both worlds
    against the JAX package's tensor-parallel run (rtol 1e-9): its
    gradient, HVP and vGHv, the remat forms against the plain ones, and
    the plain, remat and micro-batched steps' ``rho`` and update."""
    _, one, ranks = worlds
    runs = [one] if world is None else ranks[world]
    for r, res in enumerate(runs):
        got, what = res["spectral"]["cxr"], f"world {world} rank {r}"
        for part in SPECTRAL_PARTS:
            if part.startswith("micro"):
                continue
            want = jax_cxr[part.replace("remat_", "")]
            _close_scaled(got[part], want, RTOL_JAX, f"{what} {part}")
        for leg in STEP_LEGS:
            want = jax_cxr["step_micro" if leg == "micro" else "step_plain"]
            _close(got[f"step_{leg}"]["rho"], want["rho"], RTOL_JAX, f"{what} {leg} rho")
            _close_scaled(got[f"step_{leg}"]["update"], want["update"], RTOL_JAX,
                          f"{what} {leg} update")


@pytest.fixture(scope="module")
def jax_dropout(worlds, eight_devices):
    """The JAX package's products of the dropout DenseNet3 under
    ``DROPOUT_KEY`` with ``shard_params`` on the 8-device CPU mesh
    (data=4 x model=2): gradient, HVP and vGHv in the port's layout."""
    import jax
    import jax.numpy as jnp

    from optwboundeigenval_tpu.ops import curvature as jcurv
    from optwboundeigenval_tpu.parallel import make_mesh as jmake_mesh
    from optwboundeigenval_tpu.parallel import shard_batch as jshard_batch
    from optwboundeigenval_tpu.parallel import shard_params as jshard_params
    from optwboundeigenval_tpu.train.task import Task as JTask
    from optwboundeigenval_tpu_torch.utils import interop

    jax_w, _, _ = worlds
    p, stats, v = jax_w["dropout"]
    mesh = jmake_mesh(data=4, model=2)
    task = JTask(model=_jax_dropout_densenet(), has_batch_stats=True, has_dropout=True)
    loss = task.loss_fn({"batch_stats": stats}, jax.random.PRNGKey(DROPOUT_KEY))
    pt, vt = jshard_params(p, mesh, MIN_ELEMS), jshard_params(v, mesh, MIN_ELEMS)
    bt = jshard_batch({k: jnp.asarray(t.numpy()) for k, t in _dropout_batch().items()}, mesh)
    out = {}
    for name, fn, args in (("grad", jcurv.grad, ()), ("hv", jcurv.hvp, (vt,)),
                           ("vghv", jcurv.vghv, (vt,))):
        tree = jax.jit(fn, static_argnums=0)(loss, pt, bt, *args)
        out[name] = interop.densenet3_from_jax(jax.tree.map(np.asarray, tree), stats)[0]
    return out


@pytest.mark.parametrize("world", [None] + list(WORLDS))
def test_column_split_dropout_matches_jax_shard_params(worlds, jax_dropout, world):
    """The dropout DenseNet3 under flax's masks, on one process and on each
    rank of both worlds, against the JAX package's tensor-parallel
    products (rtol 1e-9): gradient, HVP and vGHv, plain and remat (the
    micro-batched ones are held to one process's)."""
    _, one, ranks = worlds
    runs = [one] if world is None else ranks[world]
    for r, res in enumerate(runs):
        got = res["spectral"]["dropout"]
        for part in SPECTRAL_PARTS:
            if part.startswith("micro"):
                continue
            _close_scaled(got[part], jax_dropout[part.replace("remat_", "")], RTOL_JAX,
                          f"world {world} rank {r} {part}")


# (ix) --------------------------------------------------------------------------

@pytest.mark.parametrize("world", list(WORLDS))
def test_forward_all_reduces_one_per_sharded_layer(worlds, world):
    """No weight is gathered: an eval-mode forward of the CXR-shaped model
    on sharded params all-reduces once per sharded layer over the
    ``model`` group, that layer's output on the rank's rows, in the
    layers' order, and nothing else (a gather of the weights would be
    one all-reduce of all their values)."""
    _, _, ranks = worlds
    model = ToyCXR().double()
    params = {k: t.detach() for k, t in model.named_parameters()}
    sizes = []
    hooks = [m.register_forward_hook(lambda m, i, o: sizes.append(o.numel()))
             for m in model.modules() if isinstance(m, (Conv2d, Linear))]
    try:
        Task(model=model).predict(params, dict(model.named_buffers()), _cxr_batch())
    finally:
        for h in hooks:
            h.remove()
    data = WORLDS[world][0]
    want = [n // data for n in sizes]
    gather = sum(t.numel() for t in params.values() if t.dim() >= 2)  # one gather's values
    assert len(want) == 12 and gather not in want
    for r, res in enumerate(ranks[world]):
        assert res["reduces"] == [(n, True) for n in want], f"rank {r}"


if __name__ == "__main__":  # one rank of the ``worlds`` fixture
    rank, world, port, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    meshlib.init_distributed(f"127.0.0.1:{port}", num_processes=world, process_id=rank,
                             device="cpu")
    data, model = WORLDS[world]
    mesh = meshlib.make_mesh(data=data, model=model, device="cpu")
    weights = torch.load(os.path.join(tmp, "weights.pt"), weights_only=False)
    results = scenarios(weights, mesh, os.path.join(tmp, f"w{world}_rank{rank}"), world)
    torch.save(results, os.path.join(tmp, f"w{world}_rank{rank}.pt"))
    torch.distributed.destroy_process_group()

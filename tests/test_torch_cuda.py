"""Tests of the port that need an NVIDIA GPU (marker ``cuda``); they skip
elsewhere.  This file imports neither JAX nor the JAX package, so it also
runs on a machine with PyTorch alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from optwboundeigenval_tpu_torch.models.densenet import DenseNet3
from optwboundeigenval_tpu_torch.ops import curvature
from optwboundeigenval_tpu_torch.ops import pallas_kernels as pk
from optwboundeigenval_tpu_torch.optim.api import sgd
from optwboundeigenval_tpu_torch.train.task import Task
from optwboundeigenval_tpu_torch.train.trainer import SpectralTrainer
from optwboundeigenval_tpu_torch.utils.tree import tree_norm, tree_sub

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
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


def test_kernel_rejects_float64_on_the_card(cuda):
    x = torch.zeros(4, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        pk.axpy_accumulate(x, x, torch.tensor(1.0, device=cuda))


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
        assert pk.axpy_accumulate.launches - before == \
            (m["pow_iters"] + 2) * 2 * len(tr.params)

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

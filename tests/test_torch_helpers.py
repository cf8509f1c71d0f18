"""Two public helpers of the JAX package in the port, on the CPU:
``ops/curvature.loss_grad_hvp_vghv`` held to the JAX function at float64
(rtol 1e-9: the same float64 math summed in other orders), and
``utils/timing.trace``, a ``torch.profiler`` context whose Chrome trace
must be on disk when the block ends.
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from optwboundeigenval_tpu.ops import curvature as jcurv
from optwboundeigenval_tpu_torch.ops import curvature as tcurv
from optwboundeigenval_tpu_torch.utils.timing import trace

torch.set_num_threads(1)
RTOL = 1e-9


def _loss(np_):
    """The toy MLP loss of ``tests/test_pallas_micro.py`` on numpy (``jnp``)
    or torch (``torch``)."""
    def loss(params, batch):
        x, y, w = batch["x"], batch["y"], batch["w"]
        out = np_.tanh(x @ params["w1"]) @ params["w2"]
        per = ((out - y) ** 2).mean(1)
        return (per * w).sum() / np_.maximum(w.sum(), np_.asarray(1e-12, dtype=w.dtype))
    return loss


def _close(got, want, what):
    w = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), w, rtol=RTOL,
                               atol=RTOL * max(np.abs(w).max(), 1e-30), err_msg=what)


def test_loss_grad_hvp_vghv_matches_jax():
    rng = np.random.default_rng(0)
    params = {"w1": rng.normal(size=(6, 5)) * 0.5, "w2": rng.normal(size=(5, 3)) * 0.5}
    batch = {"x": rng.normal(size=(16, 6)), "y": rng.normal(size=(16, 3)),
             "w": np.concatenate([np.ones(12), np.zeros(4)])}
    v = {k: rng.normal(size=a.shape) for k, a in params.items()}
    u = {k: rng.normal(size=a.shape) for k, a in params.items()}
    jt = lambda tree: {k: jnp.asarray(a) for k, a in tree.items()}
    tt = lambda tree: {k: torch.from_numpy(a) for k, a in tree.items()}
    jl, jg, jhvp, jv = jcurv.loss_grad_hvp_vghv(_loss(jnp), jt(params), jt(batch), jt(v))
    tl, tg, thvp, tv = tcurv.loss_grad_hvp_vghv(_loss(torch), tt(params), tt(batch), tt(v))
    _close(tl, jl, "loss")
    jhu, thu = jhvp(jt(u)), thvp(tt(u))
    for k in params:
        _close(tg[k], jg[k], f"grad {k}")
        _close(thu[k], jhu[k], f"hvp {k}")
        _close(tv[k], jv[k], f"vghv {k}")


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with trace(log_dir) as d:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert d == log_dir
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)

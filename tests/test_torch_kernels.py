"""The port's K1 accumulate (``optwboundeigenval_tpu_torch/ops/pallas_kernels.py``)
against the JAX Pallas kernel, run in interpret mode on the CPU.

On the CPU the wrapper takes the plain version; the CUDA kernel itself is
held against that plain version on the card by ``chip_smoke.py`` and by
``tests/test_torch_cuda.py``.  Tolerance: the plain version rounds as
``fl(acc + fl(alpha * delta))`` like the JAX kernel, so float32 results
agree to 1 ulp (rtol 1e-6) and float64 ones to rtol 1e-15.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optwboundeigenval_tpu.ops import pallas_kernels as jpk
from optwboundeigenval_tpu_torch.ops import pallas_kernels as tpk
from optwboundeigenval_tpu_torch.utils import cuda_build

torch.set_num_threads(1)


@pytest.mark.parametrize("shape,alpha", [((1000,), 0.3), ((7, 13), 1.0),
                                         ((1,), -2.5), ((3,), 0.7),
                                         ((4, 3, 3, 5), 0.125)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_plain_matches_jax_kernel(shape, alpha, dtype):
    rng = np.random.default_rng(0)
    a = rng.normal(size=shape).astype(dtype)
    d = rng.normal(size=shape).astype(dtype)
    want = np.asarray(jpk.axpy_accumulate(jnp.asarray(a), jnp.asarray(d), alpha))
    acc = torch.from_numpy(a.copy())
    ptr = acc.data_ptr()
    out = tpk.axpy_accumulate(acc, torch.from_numpy(d),
                              torch.tensor(alpha, dtype=torch.float32))
    assert out is acc and acc.data_ptr() == ptr  # in place
    rtol = 1e-6 if dtype == np.float32 else 1e-15
    np.testing.assert_allclose(acc.numpy(), want, rtol=rtol, atol=rtol)
    assert tpk.axpy_accumulate.launches == 0  # the CPU never launches


def test_wrapper_rejects_what_the_kernel_does_not_take():
    acc = torch.zeros(5)
    one = torch.tensor(1.0)
    with pytest.raises(ValueError, match="shape"):
        tpk.axpy_accumulate(acc, torch.zeros(6), one)
    with pytest.raises(ValueError, match="grad"):
        tpk.axpy_accumulate(torch.zeros(5, requires_grad=True), torch.zeros(5), one)
    with pytest.raises(TypeError, match="0-d"):
        tpk.axpy_accumulate(acc, torch.zeros(5), 1.0)
    with pytest.raises(ValueError, match="device"):
        tpk.axpy_accumulate(acc, torch.zeros(5, device="meta"), one)
    with pytest.raises(ValueError, match="cpu or cuda"):
        meta = torch.zeros(5, device="meta")
        tpk.axpy_accumulate(meta, meta, torch.tensor(1.0, device="meta"))


def test_launch_rejects_non_fp32_and_non_contiguous():
    # the checks that guard the CUDA launch, run before any build
    one = torch.tensor(1.0)
    with pytest.raises(TypeError, match="float32"):
        tpk._launch(torch.zeros(4, dtype=torch.float64),
                    torch.zeros(4, dtype=torch.float64), one)
    with pytest.raises(ValueError, match="contiguous"):
        tpk._launch(torch.zeros(4, 4).t(), torch.zeros(4, 4), one)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build.os, "access", lambda *a: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build(["axpy_accumulate"])
    assert not (tmp_path / "build").exists()


def test_library_name_tracks_source():
    p = cuda_build.library_path("axpy_accumulate")
    assert p.parent == cuda_build.BUILD_DIR
    assert p.name.startswith("axpy_accumulate-") and p.suffix == ".so"

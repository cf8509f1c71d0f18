"""The port's K1 accumulate (``optwboundeigenval_tpu_torch/ops/pallas_kernels.py``)
against the JAX Pallas kernel, run in interpret mode on the CPU.

On the CPU the wrapper takes the plain version, for one leaf or a whole
tree; the CUDA kernel itself is held against that plain version on the
card by ``chip_smoke.py`` and by ``tests/test_torch_cuda.py``.  The
launch tables the kernel reads are packed in Python and tested here as a
pure function, without a launch.  Tolerance: the plain version rounds as
``fl(acc + fl(alpha * delta))`` like the JAX kernel, so float32 results
agree to 1 ulp (rtol 1e-6) and float64 ones to rtol 1e-15.
"""

import jax
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


RAGGED = [(3,), (0,), (7, 13), (1,), (4, 3, 3, 5), (1000,)]


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_plain_tree_matches_jax_kernel(init, dtype):
    """One call over ragged leaves (one of them empty) against the JAX
    kernel mapped over the same tree; under ``init`` the JAX side starts
    from zeros and the port's accumulator holds NaN it must never read."""
    rng = np.random.default_rng(1)
    alpha = 0.5 + 1.0 / 3.0
    accs = [rng.normal(size=s).astype(dtype) for s in RAGGED]
    deltas = [rng.normal(size=s).astype(dtype) for s in RAGGED]
    start = [np.zeros_like(a) for a in accs] if init else accs
    want = jax.tree.map(lambda a, d: np.asarray(jpk.axpy_accumulate(a, d, alpha)),
                        [jnp.asarray(a) for a in start], [jnp.asarray(d) for d in deltas])
    tacc = [torch.full(s, np.nan, dtype=torch.from_numpy(a).dtype) if init
            else torch.from_numpy(a.copy()) for s, a in zip(RAGGED, accs)]
    ptrs = [t.data_ptr() for t in tacc]
    out = tpk.axpy_accumulate(tacc, [torch.from_numpy(d) for d in deltas],
                              torch.tensor(alpha, dtype=torch.float32), init=init)
    assert out is tacc and [t.data_ptr() for t in tacc] == ptrs  # in place
    rtol = 1e-6 if dtype == np.float32 else 1e-15
    for got, w in zip(tacc, want):
        np.testing.assert_allclose(got.numpy(), w, rtol=rtol, atol=rtol)
    assert tpk.axpy_accumulate.launches == 0  # the CPU never launches


def test_pack_tables_offsets_chunks_alignment():
    chunk = tpk.CHUNK_BYTES // 4  # float32 values per chunk
    sizes = [chunk + 1, 0, 1, 3 * chunk, 5]
    accs = [0x1000, 0x9000, 0x9100, 0xa004, 0x20000]
    deltas = [0x40000, 0x50000, 0x50010, 0x60000, 0x70008]
    [(rows, chunks)] = tpk.pack_tables(accs, deltas, sizes, 4)
    assert rows.dtype == np.int64 and rows.flags.c_contiguous
    # the empty leaf takes no row
    np.testing.assert_array_equal(rows[:, 0], [0x1000, 0x9100, 0xa004, 0x20000])
    np.testing.assert_array_equal(rows[:, 1], [0x40000, 0x50010, 0x60000, 0x70008])
    np.testing.assert_array_equal(rows[:, 2], [chunk + 1, 1, 3 * chunk, 5])
    np.testing.assert_array_equal(rows[:, 3], [0, 2, 3, 6])  # chunk prefix
    np.testing.assert_array_equal(rows[:, 4], [1, 1, 0, 0])  # 16-byte aligned
    assert chunks == 7
    # float64: half as many values per chunk
    [(rows64, chunks64)] = tpk.pack_tables(accs, deltas, sizes, 8)
    np.testing.assert_array_equal(rows64[:, 3], [0, 3, 4, 10])
    assert chunks64 == 11
    assert tpk.pack_tables([], [], [], 4) == []
    assert tpk.pack_tables([16], [32], [0], 4) == []


@pytest.mark.parametrize("leaves,launches", [(1, 1), (1024, 1), (1025, 2), (2500, 3)])
def test_pack_tables_splits_above_capacity(leaves, launches):
    sizes = np.arange(leaves) % 7 + 1
    ptrs = 16 * np.arange(leaves)
    tables = tpk.pack_tables(ptrs, ptrs + 8, sizes, 4)
    assert len(tables) == launches
    assert all(len(r) <= tpk.TABLE_CAPACITY for r, _ in tables)
    rows = np.concatenate([r for r, _ in tables])
    np.testing.assert_array_equal(rows[:, 2], sizes)  # every leaf once, in order
    for r, chunks in tables:  # each launch numbers its chunks from 0
        assert r[0, 3] == 0 and chunks == len(r)  # one chunk per small leaf
        np.testing.assert_array_equal(r[:, 3], np.arange(len(r)))
    assert not rows[:, 4].any()  # delta at +8: scalar path


def test_wrapper_rejects_mismatched_trees():
    one = torch.tensor(1.0)
    a = [torch.zeros(3), torch.zeros(2, 2)]
    with pytest.raises(ValueError, match="length"):
        tpk.axpy_accumulate(a, [torch.zeros(3)], one)
    with pytest.raises(ValueError, match="shape mismatch at leaf 1"):
        tpk.axpy_accumulate(a, [torch.zeros(3), torch.zeros(4)], one)
    with pytest.raises(TypeError, match="dtype"):
        tpk.axpy_accumulate(a, [torch.zeros(3), torch.zeros(2, 2, dtype=torch.float64)], one)
    with pytest.raises(TypeError, match="both"):
        tpk.axpy_accumulate(a, torch.zeros(3), one)
    assert tpk.axpy_accumulate([], [], one) == []


def test_launch_rejects_non_fp32_and_non_contiguous():
    # the checks that guard the CUDA launch, run before any build: the
    # kernel takes float32, float64 and bfloat16, contiguous leaves only,
    # and a tree with a leaf of any other dtype launches nothing
    one = torch.tensor(1.0)
    for dtype in (torch.float16, torch.int32):
        x = torch.zeros(4, dtype=dtype)
        with pytest.raises(TypeError, match="float32, float64 or bfloat16"):
            tpk._launch([x], [x], one, False)
        mixed = [torch.zeros(3), torch.zeros(2, dtype=torch.bfloat16), x]
        with pytest.raises(TypeError, match="float32, float64 or bfloat16"):
            tpk._launch(mixed, [t.clone() for t in mixed], one, False)
    with pytest.raises(ValueError, match="contiguous"):
        tpk._launch([torch.zeros(3), torch.zeros(4, 4).t()],
                    [torch.zeros(3), torch.zeros(4, 4)], one, False)
    with pytest.raises(ValueError, match="contiguous"):
        tpk._launch([torch.zeros(4, 4, dtype=torch.float64)],
                    [torch.zeros(4, 4, dtype=torch.float64).t()], one, True)


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


@pytest.mark.parametrize("init", [False, True])
def test_plain_bfloat16_rounds_once_from_float32(init):
    """A bfloat16 leaf: ``fl_bf16(fl32(acc + fl32(alpha * delta)))``, the
    sum taken in float32 and rounded once to nearest even, not twice."""
    rng = np.random.default_rng(4)
    acc = torch.from_numpy(rng.normal(size=1000).astype(np.float32)).to(torch.bfloat16)
    delta = torch.from_numpy(rng.normal(size=1000).astype(np.float32)).to(torch.bfloat16)
    alpha = torch.tensor(0.5 + 1.0 / 3.0)
    t = alpha * delta.float()
    want = (t if init else acc.float() + t).to(torch.bfloat16)
    got = acc.clone()
    tpk.axpy_accumulate(got, delta, alpha, init=init)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    if not init:  # the inputs tell one rounding from two
        assert not torch.equal(want, acc + (alpha * delta.float()).to(torch.bfloat16))
    # alpha in float64 is read as float32, as the kernel reads it
    got64 = acc.clone()
    tpk.axpy_accumulate(got64, delta, alpha.double(), init=init)
    assert torch.equal(got64, want)


def test_plain_mixed_tree_groups_by_dtype():
    """The gemm CNNUSPS's tree at bfloat16 compute: bfloat16 conv leaves
    beside float32 dense ones (and a float64 group).  Each bfloat16 leaf
    rounds once from float32; every other leaf is what a tree of its
    dtype alone gives; the groups launch in order of first appearance."""
    rng = np.random.default_rng(5)
    dtypes = [torch.bfloat16, torch.bfloat16, torch.float32, torch.float64, torch.float32,
              torch.bfloat16]
    sizes = [(8, 1, 3, 3), (0,), (64, 128), (5,), (10,), (32,)]
    accs = [torch.from_numpy(rng.normal(size=s)).to(dt) for s, dt in zip(sizes, dtypes)]
    deltas = [torch.from_numpy(rng.normal(size=s)).to(dt) for s, dt in zip(sizes, dtypes)]
    alpha = torch.tensor(0.37)
    got = [a.clone() for a in accs]
    tpk.axpy_accumulate(got, deltas, alpha)
    for a, d, g in zip(accs, deltas, got):
        assert g.dtype == a.dtype
        if a.dtype == torch.bfloat16:
            want = (a.float() + alpha * d.float()).to(torch.bfloat16)
        else:
            want = tpk.axpy_accumulate_plain(a.clone(), d, alpha)
        assert torch.equal(g, want)
    groups = tpk.dtype_groups(accs, deltas)
    assert [g[0][0].dtype for g in groups] == [torch.bfloat16, torch.float32, torch.float64]
    assert [len(g[0]) for g in groups] == [3, 2, 1]
    assert all(x is y for g in groups for x, y in zip(g[0], [a for a in accs
                                                                if a.dtype == g[0][0].dtype]))
    assert tpk.axpy_accumulate.launches == 0  # the CPU never launches

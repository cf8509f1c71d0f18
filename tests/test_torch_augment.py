"""The port's host augmentation against the JAX package's: the C++ batch
functions (the same source, built with the same g++ flags, so bit-equal),
the scipy recipes of ``use_native=False`` (bit-equal: the same numpy
draws and scipy calls), and the augmented CIFAR and USPS loaders over two
epochs, batch for batch.  A failed build or load raises: there is no
fallback to another random stream."""

import numpy as np
import pytest

from optwboundeigenval_tpu import native as jnative
from optwboundeigenval_tpu.data import cifar as jcifar
from optwboundeigenval_tpu.data import transforms as jtransforms
from optwboundeigenval_tpu.data import usps as jusps
from optwboundeigenval_tpu_torch import native
from optwboundeigenval_tpu_torch.data import cifar, transforms, usps


def _batches_equal(a, b, epochs=2):
    assert len(a) == len(b)
    for _ in range(epochs):  # a shuffling loader draws a new order per epoch
        for ba, bb in zip(a, b, strict=True):
            assert sorted(ba) == sorted(bb)
            for k in ba:
                np.testing.assert_array_equal(ba[k], bb[k], err_msg=k)


def _images(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("shape,pad,deg,seed", [
    ((16, 16, 16, 1), 1, 15.0, 0), ((5, 16, 16, 1), 2, 30.0, 2**63 - 1),
    ((3, 9, 7, 2), 3, 45.0, 7)])
def test_crop_pad_rotate_bit_equal_to_jax(shape, pad, deg, seed):
    x = _images(shape, seed % 97)
    np.testing.assert_array_equal(native.crop_pad_rotate(x, pad, deg, seed),
                                  jnative.crop_pad_rotate(x, pad, deg, seed))


@pytest.mark.parametrize("shape,frac,seed", [
    ((32, 32, 32, 3), 0.1, 0), ((4, 32, 32, 3), 0.25, 12345), ((2, 5, 8, 1), 0.1, 1)])
def test_translate_hflip_bit_equal_to_jax(shape, frac, seed):
    x = _images(shape, seed % 97)
    np.testing.assert_array_equal(native.translate_hflip(x, frac, seed),
                                  jnative.translate_hflip(x, frac, seed))


@pytest.mark.parametrize("recipe,make,shape", [
    ("usps", lambda m, native: m.usps_augment(pad=2, degrees=30, use_native=native),
     (6, 16, 16, 1)),
    ("usps flat", lambda m, native: m.usps_augment(use_native=native), (6, 256)),
    ("cifar", lambda m, native: m.cifar_augment(use_native=native), (6, 32, 32, 3))])
@pytest.mark.parametrize("use_native", [True, False])
def test_recipes_match_jax(recipe, make, shape, use_native):
    x = _images(shape, 3)
    got = make(transforms, use_native)(x, np.random.default_rng(5))
    want = make(jtransforms, use_native)(x, np.random.default_rng(5))
    assert got.shape == x.shape
    np.testing.assert_array_equal(got, want)


def test_cifar_augmented_loader_matches_jax():
    tr, va, na = cifar.get_train_valid_loader(batch_size=32, augment=True)
    jtr, jva, jna = jcifar.get_train_valid_loader(batch_size=32, augment=True)
    assert tr.augment is not None and va.augment is None and na.augment is None
    _batches_equal(tr, jtr)
    _batches_equal(va, jva, epochs=1)
    _batches_equal(na, jna, epochs=1)


def test_usps_augmented_loaders_match_jax(tmp_path):
    root = str(tmp_path)
    tr, _ = usps.get_train_valid_loader(batch_size=128, augment=True, root=root)
    jtr, _ = jusps.get_train_valid_loader(batch_size=128, augment=True, root=root)
    _batches_equal(tr, jtr)
    aug = usps.get_test_loader(batch_size=128, augment=True, root=root)
    jaug = jusps.get_test_loader(batch_size=128, augment=True, root=root)
    assert len(aug) == len(jaug) == 2
    for a, b in zip(aug, jaug):
        _batches_equal(a, b)


def test_failed_build_raises(tmp_path):
    with pytest.raises(RuntimeError, match="cannot build"):
        native.build(build_dir=tmp_path, cxx="no-such-compiler-here")
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="failed on broken.cpp"):
        native.build(src=bad, build_dir=tmp_path)
    assert not list(tmp_path.glob("*.so"))  # no half-written library left


def test_failed_load_raises(tmp_path):
    junk = tmp_path / "augment-000000000000.so"
    junk.write_bytes(b"not a shared library")
    with pytest.raises(RuntimeError, match="cannot load"):
        native.load(junk)


def test_build_is_keyed_by_the_source(tmp_path):
    path = native.build(build_dir=tmp_path)
    assert path == native.library_path(build_dir=tmp_path) and path.exists()
    assert native.build(build_dir=tmp_path) == path  # built once
    lib = native.load(path)
    assert lib.crop_pad_rotate_f32 and lib.translate_hflip_f32
    with pytest.raises(ValueError, match="NHWC"):
        native.crop_pad_rotate(np.zeros((4, 16), np.float32), 1, 15.0, 0)

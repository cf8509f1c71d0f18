"""The device-resident loader (``data/device.py``), ``host_shard``,
``PrefetchLoader`` and the driver's ``device_data`` against the JAX
package: JAX ``tests/test_data.py:101, 122, 144, 157, 196``,
``tests/test_configs_driver.py:249, 284, 297`` and
``tests/test_review_fixes.py:42``.  ``flip_crop`` given JAX's draws equals
JAX's ``cifar_augment_device`` exactly.  Everything runs on the CPU
(``device="cpu"``)."""

import threading

import numpy as np
import pytest
import torch

from optwboundeigenval_tpu_torch.configs import cifar10_densenet_mu0_01_K0
from optwboundeigenval_tpu_torch.data.device import (
    DeviceArrayLoader,
    as_device_loader,
    cifar_augment_device,
    flip_crop,
)
from optwboundeigenval_tpu_torch.data.loaders import ArrayLoader, PrefetchLoader
from optwboundeigenval_tpu_torch.data.synthetic import make_classification
from optwboundeigenval_tpu_torch.models.mlp_forest import ForestNet
from optwboundeigenval_tpu_torch.optim.api import sgd
from optwboundeigenval_tpu_torch.train import driver

torch.set_num_threads(1)


def test_host_shard_partitions_data():
    x = np.arange(10, dtype=np.float32).reshape(10, 1)
    y = np.arange(10, dtype=np.int32)
    shards = [ArrayLoader(x, y, 4, host_shard=(i, 2)) for i in range(2)]
    assert shards[0].num_examples + shards[1].num_examples == 10
    np.testing.assert_array_equal(np.sort(np.concatenate([s.y for s in shards])), y)
    np.testing.assert_array_equal(shards[1].x[:, 0], [1, 3, 5, 7, 9])


def test_device_loader_matches_both_host_loaders():
    """The same batches as the port's ArrayLoader and JAX's
    DeviceArrayLoader, bit for bit, over two shuffled epochs with a padded
    tail."""
    from optwboundeigenval_tpu.data.device import DeviceArrayLoader as JDevice

    rng = np.random.default_rng(3)
    x = rng.normal(size=(37, 4, 4, 2)).astype(np.float32)
    y = rng.integers(0, 5, size=37).astype(np.int32)
    host = ArrayLoader(x, y, batch_size=8, shuffle=True, seed=11)
    dev = DeviceArrayLoader(x, y, batch_size=8, shuffle=True, seed=11, device="cpu")
    jdev = JDevice(x, y, batch_size=8, shuffle=True, seed=11)
    for _ in range(2):
        hb, db, jb = list(host), list(dev), list(jdev)
        assert len(hb) == len(db) == len(jb) == 5
        for h, d, j in zip(hb, db, jb):
            for k in ("x", "y"):
                assert isinstance(d[k], torch.Tensor) and d[k].device.type == "cpu"
                np.testing.assert_array_equal(d[k].numpy(), h[k])
                np.testing.assert_array_equal(d[k].numpy(), np.asarray(j[k]))
            assert isinstance(d["w"], np.ndarray)
            np.testing.assert_array_equal(d["w"], h["w"])


def test_device_loader_random_batch_and_len():
    x = np.arange(20, dtype=np.float32).reshape(10, 2)
    y = np.arange(10, dtype=np.int32)
    dev = DeviceArrayLoader(x, y, batch_size=4, device="cpu")
    assert len(dev) == 3 and dev.num_examples == 10
    b = dev.random_batch(np.random.default_rng(0))
    host = ArrayLoader(x, y, batch_size=4).random_batch(np.random.default_rng(0))
    np.testing.assert_array_equal(b["x"].numpy(), host["x"])
    assert b["w"].sum() == 4.0


def _uint8_loader(seed=5):
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, size=(21, 8, 8, 3)).astype(np.uint8)
    y = rng.integers(0, 5, size=21).astype(np.int32)
    return DeviceArrayLoader(x, y, batch_size=8, shuffle=True, seed=seed, device="cpu",
                             transform=lambda xb: xb.to(torch.float32) / 255.0,
                             augment=cifar_augment_device)


def test_device_loader_transform_and_augment():
    """uint8 storage made float on the device, flip and crop drawn from the
    seed and the draw count: the same seed gives the same stream, padded
    rows stay zero, ``random_batch`` is never augmented."""
    b1, b2 = list(_uint8_loader()), list(_uint8_loader())
    assert len(b1) == 3
    for a, b in zip(b1, b2):
        assert torch.equal(a["x"], b["x"]) and torch.equal(a["y"], b["y"])
    assert b1[0]["x"].dtype == torch.float32 and float(b1[0]["x"].max()) <= 1.0
    last = b1[-1]
    assert float(last["x"][torch.from_numpy(last["w"] == 0)].abs().max()) == 0.0
    assert not torch.equal(list(_uint8_loader(seed=6))[0]["x"], b1[0]["x"])
    rb1 = _uint8_loader().random_batch(np.random.default_rng(1))
    rb2 = _uint8_loader().random_batch(np.random.default_rng(1))
    assert torch.equal(rb1["x"], rb2["x"])
    loader = _uint8_loader()
    plain = DeviceArrayLoader(loader.x.numpy(), loader.y.numpy(), batch_size=8, device="cpu",
                              transform=loader.transform)
    take = np.random.default_rng(1)
    np.testing.assert_array_equal(loader.random_batch(take)["x"].numpy(),
                                  plain.random_batch(np.random.default_rng(1))["x"].numpy())


def test_cifar_augment_device_is_flip_crop():
    """Every augmented image is an (optionally flipped) crop of the
    zero-padded original."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 6, 6, 1)).astype(np.float32)
    out = cifar_augment_device(torch.from_numpy(x), torch.Generator().manual_seed(0),
                               pad=2).numpy()
    assert out.shape == x.shape
    for i in range(4):
        cands = [np.pad(img, ((2, 2), (2, 2), (0, 0)))[oy:oy + 6, ox:ox + 6, :]
                 for img in (x[i], x[i][:, ::-1, :]) for oy in range(5) for ox in range(5)]
        assert any(np.array_equal(out[i], c) for c in cands)


@pytest.mark.parametrize("pad,shape,seed", [(4, (6, 32, 32, 3), 0), (2, (5, 6, 6, 1), 7),
                                            (4, (3, 8, 12, 2), 3)])
def test_flip_crop_equals_jax_with_its_draws(pad, shape, seed):
    """JAX's ``cifar_augment_device(x, key, pad)`` and the port's
    ``flip_crop`` given the flips and offsets that key draws
    (data/device.py:73-77) agree bit for bit."""
    import jax

    from optwboundeigenval_tpu.data.device import cifar_augment_device as jax_augment

    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    kf, kc = jax.random.split(key)
    flip = np.array(jax.random.bernoulli(kf, 0.5, (shape[0],)))
    offsets = np.array(jax.random.randint(kc, (shape[0], 2), 0, 2 * pad + 1))
    want = np.asarray(jax_augment(x, key, pad=pad))
    got = flip_crop(torch.from_numpy(x), torch.from_numpy(flip), torch.from_numpy(offsets), pad)
    np.testing.assert_array_equal(got.numpy(), want)


def _driver_opts(x, y, device_data, loader, tmp_path, **kw):
    return {"model": ForestNet(in_features=10, hidden=10, num_classes=4).double(),
            "optimizer": sgd(0.1), "loss": "cross_entropy", "mu": 0.01, "K": 1.0,
            "batch_size": 32, "max_iter": 2, "min_iter": 1, "max_pow_iter": 20,
            "pow_iter_eps": 1e-2, "header": f"DRVDEV{int(device_data)}",
            "train_loader": loader, "train": True, "test": False,
            "device_data": device_data, "device": "cpu", "seed": 3,
            "log_dir": str(tmp_path / "logs"), "model_dir": str(tmp_path / "models"), **kw}


def test_driver_device_data_flag(tmp_path):
    """tests/test_configs_driver.py:249: ``device_data`` routes the train
    loader through ``as_device_loader``, same data, same shuffle stream, the
    same trajectory."""
    x, y = make_classification(128, 10, 4, seed=0)
    xt, yt = make_classification(64, 10, 4, seed=0)
    trs = [driver.run(_driver_opts(x, y, flag, ArrayLoader(x, y, 32, shuffle=True, seed=1),
                                   tmp_path, valid_loader=ArrayLoader(xt, yt, 32)))
           for flag in (False, True)]
    for k, t in trs[0].params.items():
        assert torch.equal(trs[1].params[k], t)
    assert trs[0].f == trs[1].f and trs[0].best_val_acc == trs[1].best_val_acc


def test_as_device_loader_rejects_host_augment():
    """tests/test_configs_driver.py:284, and the driver on the CIFAR recipe,
    whose train loader augments on the host, without a device augment."""
    x, y = np.zeros((8, 2), np.float32), np.zeros(8, np.int32)
    with pytest.raises(ValueError, match="host augment"):
        as_device_loader(ArrayLoader(x, y, 4, augment=lambda xb, rng: xb), device="cpu")
    ld = as_device_loader(ArrayLoader(x, y, 4, augment=lambda xb, rng: xb), device="cpu",
                          augment=cifar_augment_device)
    assert ld.augment is cifar_augment_device
    with pytest.raises(ValueError, match="host augment"):
        driver.run(cifar10_densenet_mu0_01_K0.options(device="cpu", device_data=True,
                                                      max_iter=0))


def test_as_device_loader_continues_the_shuffle_stream():
    """Converted after an epoch, the device loader yields the host loader's
    next epochs."""
    x, y = make_classification(40, 3, 2, seed=4)
    a, b = ArrayLoader(x, y, 8, shuffle=True, seed=9), ArrayLoader(x, y, 8, shuffle=True, seed=9)
    list(a), list(b)
    dev = as_device_loader(b, device="cpu")
    for _ in range(2):
        for h, d in zip(a, dev):
            np.testing.assert_array_equal(d["x"].numpy(), h["x"])


def test_driver_device_data_unwraps_prefetch(tmp_path):
    """tests/test_configs_driver.py:297: a PrefetchLoader around the train
    loader is dropped and the loader inside converted."""
    x, y = make_classification(96, 10, 4, seed=0)
    seen = []
    real = driver.as_device_loader

    def spy(loader, **kw):
        seen.append(loader)
        return real(loader, **kw)

    inner = ArrayLoader(x, y, 32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(driver, "as_device_loader", spy)
        tr = driver.run(_driver_opts(x, y, True, PrefetchLoader(inner), tmp_path, max_iter=1))
    assert seen == [inner] and np.isfinite(tr.f)


def test_device_data_needs_an_array_loader(tmp_path):
    x, y = make_classification(32, 10, 4, seed=0)
    with pytest.raises(ValueError, match="ArrayLoader"):
        driver.run(_driver_opts(x, y, True, [next(iter(ArrayLoader(x, y, 32)))], tmp_path))


def test_trainer_refuses_a_loader_on_another_device(tmp_path):
    """No silent copy from a device loader's device to the trainer's."""
    x, y = make_classification(32, 10, 4, seed=0)

    class Elsewhere(ArrayLoader):
        device = "meta"

    with pytest.raises(ValueError, match="meta"):
        driver.run(_driver_opts(x, y, False, Elsewhere(x, y, 32), tmp_path))


def test_prefetch_loader_propagates_errors_and_stops_cleanly():
    """tests/test_review_fixes.py:42."""
    class BadLoader:
        batch_size = 4
        num_examples = 8

        def __iter__(self):
            yield {"x": np.zeros((4, 2)), "y": np.zeros(4), "w": np.ones(4)}
            raise RuntimeError("decode failure")

    with pytest.raises(RuntimeError, match="decode failure"):
        list(PrefetchLoader(BadLoader(), depth=2))
    before = threading.active_count()
    x, y = make_classification(64, 4, 3, seed=0)
    pf = PrefetchLoader(ArrayLoader(x, y, 8), depth=2)
    assert len(pf) == 8 and pf.num_examples == 64
    it = iter(pf)
    next(it)
    it.close()
    assert threading.active_count() <= before + 1
    full = [b["y"] for b in PrefetchLoader(ArrayLoader(x, y, 8), depth=2)]
    np.testing.assert_array_equal(np.concatenate(full), y)

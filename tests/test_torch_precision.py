"""The TF32 setting of the port's entry points: ``driver.run`` sets
``torch.backends.cudnn.allow_tf32`` and ``torch.backends.cuda.matmul.allow_tf32``
from its one option ``allow_tf32`` (default off) and prints both.  The
flags exist on a CPU build of torch, so this runs here; each test puts
them back."""

import pytest
import torch

from optwboundeigenval_tpu_torch.configs import forest_best
from optwboundeigenval_tpu_torch.train import driver
from optwboundeigenval_tpu_torch.utils import precision

torch.set_num_threads(1)


@pytest.fixture
def flags():
    saved = precision.tf32()
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _forest_options(tmp_path, **kw):
    opts = forest_best.options(max_iter=1, device="cpu", log_dir=str(tmp_path / "logs"),
                               model_dir=str(tmp_path / "models"), **kw)
    for k, n in (("inputs", 256), ("target", 256), ("inputs_valid", 128),
                 ("target_valid", 128), ("inputs_test", 128), ("target_test", 128)):
        opts[k] = opts[k][:n]
    return opts


@pytest.mark.parametrize("allow", [None, False, True])
def test_driver_run_sets_and_prints_both_flags(flags, tmp_path, capsys, allow):
    start = not bool(allow)  # the opposite of what the run must leave
    precision.set_tf32(start)
    kw = {} if allow is None else {"allow_tf32": allow}
    tr = driver.run(_forest_options(tmp_path, **kw))
    want = bool(allow)  # off unless asked for
    assert precision.tf32() == (want, want)
    assert f"tf32: cudnn.allow_tf32={want}, cuda.matmul.allow_tf32={want}" in (
        capsys.readouterr().out)
    assert tr.epoch_pow_iters  # the run trained


def test_set_tf32_returns_what_it_set(flags):
    for allow in (True, False, 1, 0):
        assert precision.set_tf32(allow) == (bool(allow), bool(allow)) == precision.tf32()

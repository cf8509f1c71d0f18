"""Small cells for the benchmark's tests on the CPU: the program's
models cut to a toy size, with the reference's description of the same
architecture (``reference/models.py``)."""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

TOY_DN = {"kind": "densenet_bc", "depth": 10, "growth_rate": 4, "reduction": 0.5,
          "num_classes": 10}
TOY_CXR = {"kind": "cxr_densenet", "block_config": [1, 1, 1, 1], "growth_rate": 8,
           "num_init_features": 16, "bn_size": 4, "head_width": 1024, "outnum": 14}


def toy(workload: str) -> dict:
    """``harness.run``'s keywords for ``workload`` at a toy size: 2 or 3
    dense layers a block, batch 8 (4 for the chest x-ray), 32 px."""
    if workload.startswith("cxr121"):
        from optwboundeigenval_tpu_torch.models.backbones import DenseNetFeatures
        from optwboundeigenval_tpu_torch.models.cxr import CXRModel, TransitHead

        model = CXRModel("densenet121", outnum=14)
        model.features = DenseNetFeatures((1, 1, 1, 1), 8, 16)
        model.head = TransitHead(model.features.out_channels, 14)
        return {"options": {"model": model}, "arch": TOY_CXR, "batch_size": 4,
                "data": {"shape": [32, 32, 3], "labels": "multilabel", "classes": 14,
                         "positive_rate": 0.3, "noise": 0.5}}
    from optwboundeigenval_tpu_torch.models.densenet import DenseNet3

    return {"options": {"model": DenseNet3(depth=10, growth_rate=4, num_classes=10)},
            "arch": TOY_DN, "batch_size": 8}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"

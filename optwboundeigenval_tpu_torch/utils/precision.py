"""The float32 precision of the card's convolutions and matmuls.

On an NVIDIA card a float32 convolution goes through cuDNN in TF32 unless
``torch.backends.cudnn.allow_tf32`` is False (torch's default is True),
and a float32 matmul in TF32 where ``torch.backends.cuda.matmul.allow_tf32``
is True (default False).  TF32 keeps about three decimal digits, so the
two settings decide what a float32 run computes.  :func:`set_tf32` sets
both from one boolean; ``driver.run`` calls it with its ``allow_tf32``
option (default False: full float32, the setting every card number of the
port was taken at) and prints the pair.  The flags exist on a CPU build
of torch too, where they change nothing.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def tf32() -> Tuple[bool, bool]:
    """``(cudnn.allow_tf32, cuda.matmul.allow_tf32)`` as they stand."""
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


def set_tf32(allow: bool) -> Tuple[bool, bool]:
    """Allow TF32 in float32 convolutions and matmuls, or not, both from
    ``allow``; returns the pair as set."""
    torch.backends.cudnn.allow_tf32 = bool(allow)
    torch.backends.cuda.matmul.allow_tf32 = bool(allow)
    return tf32()


def describe(flags: Tuple[bool, bool]) -> str:
    """The one line that says both settings."""
    return f"tf32: cudnn.allow_tf32={flags[0]}, cuda.matmul.allow_tf32={flags[1]}"


def host(t: torch.Tensor) -> np.ndarray:
    """``t`` as a numpy array on the host.  numpy has no bfloat16, so a
    bfloat16 tensor (the outputs of a model at bfloat16 compute) is
    widened to float32 first, which is exact."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

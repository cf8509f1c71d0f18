"""Checkpoints (counterpart of ``optwboundeigenval_tpu/train/checkpoints.py``).

A checkpoint is a dict of tensors, numbers and nested dicts written with
``torch.save`` (tensors moved to the CPU first, so a file written on the
card loads anywhere) and read with ``torch.load(weights_only=True)``.
``restore_like`` puts a loaded payload back on the device and in the
dtype of a template of the same structure.  ``load_torch_checkpoint`` and
``save_torch_checkpoint`` read and write the reference's own ``.pt``
state dicts (JAX checkpoints.py:55-122).
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


def save_checkpoint(path: str, payload: Dict[str, Any]) -> None:
    """Write ``payload`` to ``path`` through a temporary file, so a reader
    never sees half a checkpoint."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(_to_cpu(payload), tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    return torch.load(path, map_location="cpu", weights_only=True)


def to_device(tree, device):
    """A loaded payload with every tensor moved to ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


def restore_like(template, payload):
    """``payload`` in the structure, devices and dtypes of ``template``;
    raises if the keys differ."""
    if isinstance(template, dict):
        if set(template) != set(payload):
            raise KeyError(f"checkpoint keys {sorted(payload)} differ from "
                           f"{sorted(template)}")
        return {k: restore_like(t, payload[k]) for k, t in template.items()}
    if isinstance(template, torch.Tensor):
        return payload.to(device=template.device, dtype=template.dtype)
    return type(template)(payload)


def load_torch_checkpoint(path: str, arch: str):
    """A reference checkpoint (a ``.pt`` state dict, maybe nested under
    ``state_dict``, with ``module.``/``encoder.`` prefixes or legacy dotted
    keys; opt.py:765-769, 1041-1059) or a torchvision state dict -> the
    port's state dict for ``arch`` (``utils/torch_interop.from_reference``:
    ``forest``, ``usps_cnn``, ``densenet3`` or a trunk such as
    ``densenet121``), CPU tensors to load with ``model.load_state_dict``."""
    from optwboundeigenval_tpu_torch.utils import torch_interop

    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return torch_interop.from_reference(sd, arch)


def save_torch_checkpoint(model, path: str, arch: str) -> str:
    """Write a port model (or its ``{**params, **model_state}``) as a plain
    ``.pt`` state dict that the reference's model of ``arch`` (``forest``,
    ``usps_cnn`` or ``densenet3``) loads; returns ``path``."""
    from optwboundeigenval_tpu_torch.utils import torch_interop

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(torch_interop.to_reference(model, arch), path)
    return path

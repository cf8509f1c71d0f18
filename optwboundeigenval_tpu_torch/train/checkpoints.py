"""Checkpoints (counterpart of ``optwboundeigenval_tpu/train/checkpoints.py``;
the format only).

A checkpoint is a dict of tensors, numbers and nested dicts written with
``torch.save`` (tensors moved to the CPU first, so a file written on the
card loads anywhere) and read with ``torch.load(weights_only=True)``.
``restore_like`` puts a loaded payload back on the device and in the
dtype of a template of the same structure.
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

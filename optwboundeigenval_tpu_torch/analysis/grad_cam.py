"""Grad-CAM and the heatmap overlay (counterpart of
``optwboundeigenval_tpu/analysis/grad_cam.py``; reference
``pytorch_grad_cam.GradCAM`` on the last feature layer, opt.py:1384-1386,
and ``show_cam_on_image``, cam_on_image.py:8-32).

The JAX package injects an additive zero tap into the named flax module
with an interceptor; here a forward hook on the named submodule adds the
tap, and the gradient with respect to the tap is the gradient with
respect to the layer's output.  ``layer_path`` is the port's module name
(``conv3``, ``features``); ``utils/interop.module_names`` maps a JAX
package's flax path (``Conv_2``) to it.  Activations are NCHW here, so
the channel weights are the spatial means over axes (2, 3).
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import ndimage

from optwboundeigenval_tpu_torch.analysis.saliency import _device
from optwboundeigenval_tpu_torch.utils.precision import host

# matplotlib's "jet" (_cm.py _jet_data): per channel, (x, value) knots
_JET = {
    "red": ((0.0, 0.0), (0.35, 0.0), (0.66, 1.0), (0.89, 1.0), (1.0, 0.5)),
    "green": ((0.0, 0.0), (0.125, 0.0), (0.375, 1.0), (0.64, 1.0), (0.91, 0.0), (1.0, 0.0)),
    "blue": ((0.0, 0.5), (0.11, 1.0), (0.34, 1.0), (0.65, 0.0), (1.0, 0.0)),
}


def layer_output_and_grad(task, params, model_state, x, layer_path: str,
                          target_class=None):
    """``(A, d score / d A)`` for the submodule named ``layer_path``, the
    score the sum over the batch of each example's ``target_class`` output
    (default: its arg max).  An unknown name raises ``KeyError``."""
    try:
        module = task.model.get_submodule(layer_path)
    except AttributeError:
        raise KeyError(f"layer path {layer_path!r} not found in model") from None
    seen = {}

    def tap(_module, _args, out):
        if "tap" not in seen:
            seen["tap"] = torch.zeros_like(out, requires_grad=True)
        seen["a"] = out.detach()
        return out + seen["tap"]

    handle = module.register_forward_hook(tap)
    try:
        x = torch.as_tensor(x, device=_device(params))
        with torch.enable_grad():
            out = task._apply(params, model_state, x, False)
            if "tap" not in seen:
                raise KeyError(f"layer {layer_path!r} is not called by the model")
            cls = (out.argmax(dim=-1) if target_class is None
                   else torch.full(out.shape[:1], int(target_class), device=out.device))
            score = out.gather(1, cls[:, None]).sum()
            (g,) = torch.autograd.grad(score, seen["tap"])
    finally:
        handle.remove()
    return seen["a"], g


def grad_cam(task, params, model_state, x, layer_path: str,
             target_class=None) -> np.ndarray:
    """``ReLU(sum_k w_k A_k)`` with ``w_k`` the spatial mean of ``d score /
    d A_k``, divided by its maximum (+1e-8) per image and resized to the
    input's (H, W) by linear interpolation (``ndimage.zoom(order=1)``)."""
    a, g = layer_output_and_grad(task, params, model_state, x, layer_path, target_class)
    weights = g.mean(dim=(2, 3), keepdim=True)  # (B, C, 1, 1)
    cam = torch.clamp_min((weights * a).sum(dim=1), 0.0)  # (B, h, w)
    cam = cam / (cam.amax(dim=(1, 2), keepdim=True) + 1e-8)
    H, W = x.shape[1], x.shape[2]
    return np.stack([ndimage.zoom(c, (H / c.shape[0], W / c.shape[1]), order=1)
                     for c in host(cam)])


def _jet_lut(n: int = 256) -> np.ndarray:
    """matplotlib's ``LinearSegmentedColormap`` lookup table of "jet"."""
    xs = (n - 1) * np.linspace(0.0, 1.0, n)
    lut = np.ones((n, 4))
    for c, channel in enumerate(("red", "green", "blue")):
        knots = np.asarray(_JET[channel])
        x, y = knots[:, 0] * (n - 1), knots[:, 1]
        ind = np.searchsorted(x, xs)[1:-1]
        dist = (xs[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
        lut[:, c] = np.clip(np.concatenate([[y[0]], dist * (y[ind] - y[ind - 1]) + y[ind - 1],
                                            [y[-1]]]), 0.0, 1.0)
    return lut


def jet(mask: np.ndarray) -> np.ndarray:
    """``matplotlib.cm.jet(mask)`` (RGBA) without matplotlib: values in [0, 1]
    index a 256-entry table, 1.0 the last entry, values outside clip."""
    lut = _jet_lut()
    xa = np.array(mask, dtype=float) * len(lut)
    xa[xa == len(lut)] = len(lut) - 1
    idx = np.clip(np.floor(xa), 0, len(lut) - 1).astype(int)
    return lut[idx]


def show_cam_on_image(img: np.ndarray, mask: np.ndarray,
                      use_rgb: bool = True, alpha: float = 0.5) -> np.ndarray:
    """Overlay a [0, 1] heatmap (jet) on a [0, 1] image (cam_on_image.py:8-32,
    which wraps cv2.applyColorMap)."""
    heatmap = jet(mask)[..., :3]
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    return np.clip(alpha * heatmap + (1 - alpha) * img, 0, 1)

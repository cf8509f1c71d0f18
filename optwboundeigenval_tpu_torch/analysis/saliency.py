"""Input-gradient saliency maps (counterpart of
``optwboundeigenval_tpu/analysis/saliency.py``; reference ``saliency``,
opt.py:1259-1312).

The JAX package takes one batch-of-1 gradient per example under ``vmap``.
In eval mode no example sees another, so one backward pass of the summed
predicted-class scores gives the same maps.  ``Task.predict`` runs under
``no_grad``, so the forward goes through ``Task._apply`` with gradients
on.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from optwboundeigenval_tpu_torch.analysis.plots import pyplot


def _device(params) -> torch.device:
    return next(iter(params.values())).device


def input_gradient(task, params, model_state, x, target_class=None) -> torch.Tensor:
    """d score / d x of each example's ``target_class`` output (default: its
    arg max), in ``x``'s dtype on the parameters' device."""
    x = torch.as_tensor(x, device=_device(params)).detach().requires_grad_(True)
    with torch.enable_grad():
        out = task._apply(params, model_state, x, False)
        if target_class is None:
            cls = out.argmax(dim=-1)
        else:
            cls = torch.broadcast_to(torch.as_tensor(target_class, device=out.device),
                                     out.shape[:1])
        score = out.gather(1, cls.long()[:, None]).sum()
        (g,) = torch.autograd.grad(score, x)
    return g


def batch_saliency(task, params, model_state, x, target_class=None) -> torch.Tensor:
    """``|d score / d x|`` per example; ``target_class`` defaults to the
    predicted class, the reference's use of the model's own prediction."""
    return input_gradient(task, params, model_state, x, target_class).abs()


def saliency_maps(trainer, loader, max_img: int = 10, plot_dir: str = "./plots"):
    """Saliency of up to ``max_img`` real rows of ``loader``: the images and
    maps go to ``<plot_dir>/<header2>_saliency.npz`` (``x``, ``saliency``),
    and image/map pairs to ``<header2>_saliency_<i>.png`` where matplotlib
    imports (opt.py:1259-1312 writes the PNGs).  Returns the npz path."""
    imgs, maps = [], []
    for data in loader:
        if len(imgs) >= max_img:
            break
        n = min(int(np.sum(np.asarray(data["w"]) > 0)), max_img - len(imgs))
        x = np.asarray(data["x"])[:n]
        sal = batch_saliency(trainer.task, trainer.params, trainer.model_state, x)
        imgs.extend(x)
        maps.extend(sal.cpu().numpy())
    os.makedirs(plot_dir, exist_ok=True)
    out = os.path.join(plot_dir, f"{trainer.header2}_saliency.npz")
    np.savez(out, x=np.asarray(imgs), saliency=np.asarray(maps))
    plt = pyplot("saliency")
    if plt is None:
        return out
    for i, (img, s) in enumerate(zip(imgs, maps)):
        fig, axes = plt.subplots(1, 2, figsize=(6, 3))
        img, s = img.squeeze(), s.squeeze()
        if img.ndim == 1:
            side = int(np.sqrt(img.size))
            img, s = img.reshape(side, side), s.reshape(side, side)
        axes[0].imshow(img, cmap="gray")
        axes[0].set_title("image")
        axes[1].imshow(s, cmap="hot")
        axes[1].set_title("saliency")
        for ax in axes:
            ax.axis("off")
        fig.savefig(os.path.join(plot_dir, f"{trainer.header2}_saliency_{i}.png"))
        plt.close(fig)
    return out

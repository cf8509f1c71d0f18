"""Conditional-GAN training on USPS (counterpart of ``scripts/gan.py``;
reference gan.py, its flags and defaults, gan.py:24-46):

    python -m optwboundeigenval_tpu_torch.scripts.gan [--n_epochs 200]
        [--lr 1e-4] [--rand 0.3] [--swap 0.01] [--gen_images 10000] [--dc]
        [--device cpu] ...

Trains the label-embedding MLP cGAN (``--nodes`` wide) on the USPS train
set scaled to [-1, 1] (the real files under ``--data_root`` when present,
else the stand-in), or with ``--dc`` the DC-cGAN at 32x32; saves the
generator as ``<models_dir>/[dc_]cgan_generator.pt`` through
``train/checkpoints.py`` and ``--gen_images`` generated images as
``--out`` (``cgan_usps.npz`` under ``--dc``) for ``get_gan_loader``.
``--train 0`` loads the saved generator instead of training.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n_epochs", type=int, default=200, help="number of epochs of training")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-4, help="adam: learning rate")
    p.add_argument("--b1", type=float, default=0.5)
    p.add_argument("--b2", type=float, default=0.999)
    p.add_argument("--weight_decay", type=float, default=2e-5, help="adam: weight decay")
    p.add_argument("--latent_dim", type=int, default=100)
    p.add_argument("--n_classes", type=int, default=10)
    p.add_argument("--img_size", type=int, default=16, help="size of each image dimension")
    p.add_argument("--channels", type=int, default=1, help="number of image channels")
    p.add_argument("--sample_interval", type=int, default=400,
                   help="interval between image samples (0 = never)")
    p.add_argument("--gen_images", type=int, default=10000)
    p.add_argument("--nodes", type=int, default=32, help="nodes in the 1st layer of the network")
    p.add_argument("--train", type=int, default=1, help="whether or not to train the model")
    p.add_argument("--scheduler", type=int, default=1,
                   help="whether or not to use the lr scheduler")
    p.add_argument("--cos", type=int, default=1, help="whether or not to use cosine annealing lr")
    p.add_argument("--rand", type=float, default=0.3, help="amount to randomly fudge labels")
    p.add_argument("--smooth", type=float, default=0.0,
                   help="deterministic label smoothing (extension; implies --rand 0 "
                        "unless --rand is given explicitly)")
    p.add_argument("--swap", type=float, default=0.01, help="probability of swapping labels")
    p.add_argument("--d_iter", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="./data/gan_usps.npz")
    p.add_argument("--models_dir", default="./models")
    p.add_argument("--sample_dir", default="./images")
    p.add_argument("--data_root", default="./data")
    p.add_argument("--dc", action="store_true",
                   help="use the DC-cGAN (cGAN.py equivalent) at 32x32")
    p.add_argument("--device", default=None, help="cpu, or the card by default")
    return p.parse_args(argv)


def build(args, x):
    """``(x, generator, discriminator, out path)``: the MLP pair at
    ``--img_size`` or the DC pair at 32x32, ``x`` resized to match
    (linear ``ndimage.zoom``)."""
    import torch
    from scipy import ndimage

    from optwboundeigenval_tpu_torch.models import gan

    g = torch.Generator().manual_seed(args.seed)
    if args.dc:
        x = ndimage.zoom(x, (1, 2, 2, 1), order=1)
        return (x, gan.DCGenerator(args.n_classes, args.latent_dim, generator=g),
                gan.DCDiscriminator(args.n_classes, generator=g),
                args.out.replace("gan_usps", "cgan_usps"))
    if args.img_size != x.shape[1]:
        zoom = args.img_size / x.shape[1]
        x = ndimage.zoom(x, (1, zoom, zoom, 1), order=1)
    img_shape = (args.img_size, args.img_size, args.channels)
    return (x, gan.MLPGenerator(args.n_classes, args.latent_dim, img_shape, args.nodes,
                                generator=g),
            gan.MLPDiscriminator(args.n_classes, args.img_size ** 2 * args.channels,
                                 args.nodes, generator=g),
            args.out)


def main(argv=None):
    from optwboundeigenval_tpu_torch.analysis.gan_train import generate_dataset, train_cgan
    from optwboundeigenval_tpu_torch.data import usps
    from optwboundeigenval_tpu_torch.train import checkpoints
    from optwboundeigenval_tpu_torch.train.trainer import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    x, y = usps.load_usps(args.data_root, train=True)
    x = (x - 0.5) / 0.5  # to [-1, 1] for the tanh generator (gan.py transform)
    x, g, d, out = build(args, x)
    # --smooth replaces the reference's random label fudging: unless both
    # were asked for (an error in train_cgan), it turns the default --rand off
    given = sys.argv[1:] if argv is None else argv
    if args.smooth > 0 and "--rand" not in given:
        args.rand = 0.0
    ckpt = os.path.join(args.models_dir, ("dc_" if args.dc else "") + "cgan_generator.pt")
    if args.train:
        t0 = time.perf_counter()
        hist, _, _ = train_cgan(
            x, y, g, d, n_epochs=args.n_epochs, batch_size=args.batch_size, lr=args.lr,
            b1=args.b1, b2=args.b2, weight_decay=args.weight_decay,
            latent_dim=args.latent_dim, n_classes=args.n_classes, d_iter=args.d_iter,
            smooth=args.smooth, swap=args.swap, rand=args.rand,
            cosine_schedule=bool(args.cos and args.scheduler), seed=args.seed,
            sample_interval=args.sample_interval, sample_dir=args.sample_dir, device=device)
        seconds = time.perf_counter() - t0  # train_cgan reads its losses back: synchronised
        steps = args.n_epochs * (len(x) // args.batch_size)
        print(f"trained {steps} steps in {seconds:.3f} s, {steps / seconds:.2f} steps/s "
              f"on {device}")
        checkpoints.save_checkpoint(ckpt, {"params": dict(g.named_parameters()),
                                           "state": dict(g.named_buffers())})
        print(f"final d_loss={hist[-1][1]:.4f} g_loss={hist[-1][2]:.4f}")
    else:
        payload = checkpoints.load_checkpoint(ckpt)
        g.load_state_dict({**payload["params"], **payload["state"]})
        g.to(device)
    path = generate_dataset(g, n_images=args.gen_images, latent_dim=args.latent_dim,
                            n_classes=args.n_classes, seed=args.seed, out_path=out)
    print(f"saved {args.gen_images} generated images to {path}")
    return path


if __name__ == "__main__":
    main()

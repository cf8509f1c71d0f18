"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Phases (any failure exits non-zero and prints no result line):

1. the card: ``nvidia-smi`` name and power limit, torch and CUDA
   versions; TF32 is switched off for convolutions and matmuls through
   ``utils/precision.set_tf32``, as ``driver.run`` sets it by default, and
   both flags are printed;
2. build every CUDA kernel of the port with ``nvcc`` (one process per
   source, started together) and print the build time;
3. hold every kernel against its plain PyTorch version on the card, at
   the shapes the main path gives it plus ragged and large ones: K1 in
   float32, float64 and bfloat16, accumulate and init, over the DenseNet-40 tree
   in one call, a ragged tree (an unaligned view, an empty leaf), single
   leaves, a DenseNet-121-sized tree and a tree longer than the launch
   table; then time kernel, plain version and the one PyTorch call of the
   same function (``torch._foreach_add_``), and K1's device time;
4. the spectral step: the ``cifar10_densenet_mu0_01_K0`` recipe
   (DenseNet-40-12 on CIFAR-10, full width, batch 32) with
   ``remat=False, hvp_micro=2, augment=False``, built through the config
   driver and run for 3 ``train_step``s (5 before the time budget); each
   step must launch K1 once per micro-batched accumulate, ``(pow_iters +
   2) * hvp_micro`` times;
5. one more step under ``torch.profiler``: the device's busy share and
   the kernels that take the time (also after the runs of phases 7, 8, 10
   and 11, on a step of each);
6. the card against the CPU: HVP and vGHv at the trained weights on the
   first 8 rows of the step's batch (32 before the time budget),
   micro-batched through K1 in float32 and float64, and float64 on the
   first micro-batch, on the card vs float64 with the port on the CPU;
7. the training run through ``driver.run``, as ``main`` drives it:
   ``forest_best`` and ``usps_cnn_mu0_01_K0`` at full width on their
   synthetic stand-ins (Forest 12,800 / 3,200 / 4,000 rows, USPS 6,250 /
   1,041 / 2,007, batch 128), the train sets cut to their first 3,200 and
   2,048 rows (a cut for time), one epoch (2 before the time budget) with
   ``rho_test``, logs and
   checkpoints in a temporary directory; the TSV rows, test lines and
   ``rho_test`` means must be finite and the best checkpoint must load
   back to the trained tensors;
8. the DenseNet-40 epoch through K1: ``cifar10_densenet_mu0_01_K0`` with
   ``remat=False, augment=False, hvp_micro=2, max_iter=1`` through
   ``driver.run`` on the first 128 train, valid and test rows (4 steps; a
   cut for the time limit only), ``defer_metrics`` as the recipe sets
   it; K1 must launch ``hvp_micro * sum(pow_iters + 2)`` times over the
   epoch's steps (the epoch-end ``rho`` goes through the cached
   linearization and launches none);
9. the cached HVP (``curvature.linearize_hvp``) against the closure
   (``curvature.hvp``) for ForestNet, CNNUSPS (batch 128) and DenseNet-40
   (batch 32): float64 on the card vs the CPU's float64 closure, and the
   set-up and per-HVP times of both on the card (5 calls each; 20 before
   the time budget), beside one vGHv pass;
10. the published DenseNet-40 recipe: ``cifar10_densenet_mu0_01_K0`` with
    no override but ``max_iter=1`` (augmentation, ``remat``,
    ``defer_metrics``, power iteration at ``pow_iter_eps`` 0.05) through
    ``driver.run`` on the first 128 rows of each split (4 steps; a cut for
    the time limit only, the train loader keeping its augmentation), then
    the same epoch with ``remat=False``: s/epoch, steps/s, mean
    ``pow_iters``, host ms of augmentation per batch and peak device
    memory of each; the memory of one step's curvature passes with remat
    on and off (remat's HVP map must hold less between products, and its
    eigensolve peak lower); a float64 ``train_step`` at batch 8 (32 before
    the time budget) from one state with remat on and off on the card and
    with remat on the CPU, which must agree; and one step (2 before the
    time budget) with ``hvp_micro=2`` under remat, K1 launching
    ``hvp_micro * (pow_iters + 2)`` times;
11. the eigensolvers: ``forest_best`` and ``usps_cnn_mu0_01_K0`` for one
    epoch on the first 3,200 and 2,048 train rows (a cut for time) with
    power iteration and with ``eigensolver='auto'`` (which must
    resolve to the early-exit Lanczos solver), USPS with
    ``eigensolver='lanczos'`` and with ``rand_init=True``, HVPs per step
    beside phase 7's power iteration;
    float64 Lanczos ``rho`` at one batch on the card vs the CPU;
    ``rho_test_fused`` and ``spectrum_test`` (subspace, at most 50 sweeps,
    and Lanczos, k=4) on 4 USPS batches; and the port's plain-autograd HVP and vGHv against
    ``torch.func`` forms of them (``jvp(grad)`` and ``grad(<jvp(grad), v>)``)
    on the three models (float64 agreement, float32 times of 5 calls);
12. the comparators: the ten configs ``forest_``/``usps_cnn_`` +
    ``lobpcg``, ``kfac``, ``sam``, ``entropy_sgd`` and
    ``asymmetric_valley`` through ``driver.run`` at full width on the first
    3,200 Forest and 2,048 USPS train rows (their whole synthetic stand-ins
    before the time budget) for 1 epoch (Asymmetric Valley cut to 4 so
    that SWA, ``bn_update``, the SGD hunt and the interpolation get their
    turn), each with s/epoch, steps/s, mean ``pow_iters``, a profiled step
    and its log rows, test lines, parameters and factors checked; the
    K-FAC refresh and apply times for Forest, USPS and DenseNet-40;
    float64 card vs CPU for a ``usps_cnn_lobpcg`` step, a K-FAC step on a
    ``TCov``/``TInv`` boundary, a SAM step and an Entropy-SGD step with its
    noise given; and one DenseNet-40 LOBPCG step with ``hvp_micro=2``,
    K-FAC over its 40 conv and dense layers, K1 launching ``2 * (pow_iters
    + 2)`` times;
13. the chest x-ray workload at the published 224 px, on
    ``make_multilabel`` stand-ins (NIH 14 classes; CheXpert and MIMIC 13,
    10% NaN labels): ``chestxray_mu0_01_K0`` (``CXRModel(densenet121)``,
    batch 4) through ``driver.run`` with no other override but
    ``max_iter=1`` and the loaders (4 train rows, 8 valid, 8 per test
    set; one step, a cut for the time limit only: 8 train rows and 2
    steps before the time budget), ``comp_test`` over the three test sets
    on their shared classes, then the same epoch with ``remat=False``:
    s/epoch, steps/s, mean
    ``pow_iters``, a profiled step, the peak device memory and the
    per-dataset AUC; the memory of one step's curvature passes with remat
    on and off (remat's HVP map must hold less between products and its
    eigensolve peak lower, as in phase 10); 2 steps of
    ``chestxray_best_reg`` (``auto`` resolving to the early-exit Lanczos
    solver); one K-FAC refresh on ``CXRModel`` (``chestxray_best_lobpcg``)
    timed by part, the transit conv's 9,217-wide ``eigh`` alone; one step
    with ``hvp_micro=2`` and at most 2 HVPs, K1 launching ``2 * (pow_iters + 2)`` times; one
    full-width step each of ``chestxray_mu0_vgg`` (VGG16-BN) and
    ``cifar100_resnet_mu0`` (ResNet50, 32 px); and a float64 step of
    ``CXRModel(densenet121)`` at 64 px, batch 2, at most 2 HVPs, on the
    card vs the CPU;
14. the analysis path (no K1 on it: gradients to the input, GAN steps):
    ``CXRModel(densenet121)`` at 224 px, batch 4, on 16 stand-in rows,
    ``chestxray_mu0_01_K0`` against a ``chestxray_mu0`` baseline (another
    seed): input-gradient, guided-backprop and Grad-CAM (the trunk's
    output, ``features``) maps in ms a batch, ``jaccard_audit`` for each
    method with the meta-classifier and ``jaccard_comp`` over three
    trainers; the three maps in float64 on the card vs the CPU at 64 px,
    batch 2; the MLP cGAN through the ``gan`` script at its published
    defaults for 1 of the published 200 epochs (a cut for time only; 2
    before the time budget) with
    10,000 generated images, the DC-cGAN (``--dc``, feat 64, 32x32) for 1
    epoch, steps/s, a profiled run's busy share and the peak memory, and
    two float64 steps of each on the card vs the CPU with the draws
    (dropout masks included) injected; ``nearest_distances`` (Euclid and
    cosine) of the 2,007 USPS test rows to the 10,000 generated images and
    ``create_dist_dataset`` over the two augmented test sets (the
    ``distance`` and ``create_dist`` scripts); ``forest_best``,
    ``forest_unreg`` and ``mu=0.01 K=1`` for 1 epoch on the first 2,560
    train rows through ``driver.run``, the ``cov_shift_test`` script's 100 shifts (draws/s)
    and its slope comparison, and the float64 sweep on the card vs the
    CPU; ``usps_cnn_mu0_01_K0`` for 1 epoch on the first 1,024 train rows
    through ``driver.run`` with
    ``saliency`` and ``jaccard`` against a first run's checkpoint;
15. dropout, the gemm CNN, the legacy loops, the oracle and reference
    checkpoints: the original DenseNet-40 of Huang et al. (``DenseNet3(depth=40,
    growth_rate=12, reduction=1.0, bottleneck=False, drop_rate=0.2)``,
    1,059,298 parameters) through ``driver.run`` with
    ``cifar10_densenet_mu0_01_K0``'s options but the model,
    ``has_dropout=True``, ``augment=False`` and ``max_iter=1``, on the
    first 128 rows of each split (4 steps; a cut for time only) under the
    recipe's ``remat``: s/epoch, steps/s, mean ``pow_iters``, a profiled
    step and the peak memory; one step (2 before the time budget) with
    ``hvp_micro=2, remat=False``, K1 launching ``2 * (pow_iters + 2)``
    times; ``u.(H v) == v.(H
    u)`` within one step's key in float32; a float64 step at batch 2 and at
    most 2 HVPs on the card vs the CPU with the masks injected; ``usps_cnn_mu0_01_K0`` with
    ``CNNUSPS(conv_impl='gemm')`` for one epoch on the first 1,024 train
    rows (8 steps; a cut for time only, 16 before the time budget), steps/s and HVPs/s beside phase
    7's lax run, and its float64 step card vs CPU; ``legacy.train_epoch``,
    ``validate`` and ``test`` on ``CXRModel(densenet121)`` at 224 px, batch
    4, 16 NIH stand-in rows, and ``train2_epoch`` on a ``VAE`` over the
    densenet121 trunk, ms a batch each; the curvature oracle in float64 on
    the card; ``.pt`` round trips for ``forest``, ``usps_cnn`` and
    ``densenet3``, and a torchvision-keyed densenet121 state dict (``module.``
    prefixes, ``norm.1`` keys) into the trunk, outputs equal;
16. the trainer's execution knobs and the data-parallel mesh: (a) the
    JAX package's device-bound flagship leg on the published DenseNet-40
    recipe through ``driver.run``, the train set on the card
    (``device_data``, ``cifar_augment_device`` for the host augmentation),
    ``scan_steps=8``, ``donate``, ``mem_track`` and epoch 0 profiled into
    ``profile_dir``, two epochs on the first 32 rows (1 step, one chunk
    an epoch; a cut for time only): s/epoch, steps/s, mean ``pow_iters``,
    ``mem_max``, the peak memory, the trace's size, events and busy share;
    the unprofiled epoch 1 against epoch 1 of the same run with
    ``scan_steps=1`` and no ``donate`` (the same ``pow_iters``) and beside
    phase 10's run with every knob off; (b) the float64 recipe at batch 4,
    at most 2 HVPs a step, for 2 chunks of 2 steps with ``scan_steps``, ``donate`` and the device
    loader on and then off, within ``CARD_F64_RTOL``, the donated state
    keeping its storage; (c) one such chunk with ``hvp_micro=2``, K1
    launching ``2 * (pow_iters + 2)`` times a step; (d) one
    ``chestxray_mu0_01_K0`` step at 224 px, batch 4, with ``donate`` off and
    on, the peak memory of each; (e) two gloo ranks sharing the card (this
    script started with ``--rank``) at float64 on ``usps_cnn_mu0_01_K0`` for
    one epoch of 2 steps and on the DenseNet-40 recipe for one step at
    batch 4, at most 2 HVPs a step, against one process, and a one-rank NCCL
    group on ``forest_best`` (float64) for one epoch on the first 2,560
    train rows through ``driver.run`` against
    ``mesh=None``, all within ``CARD_F64_RTOL``;
17. the ``model`` mesh axis (``parallel/sharding.py``: each sharded conv
    and dense layer computes its own output columns and assembles the
    whole output over the ``model`` group), gloo ranks sharing
    the card (this script started with ``--rank ... --phase``): (a) two
    ranks as ``data=1 x model=2``, ``chestxray_mu0_01_K0``'s
    ``CXRModel(densenet121)`` sharded at the default ``min_elems`` (the
    leaves and values sharded, the bytes of params, ``v`` and Adam state a
    rank holds against one process), one ``train_step`` with
    ``hvp_micro=2`` and at most 2 HVPs at 224 px, batch 4, float32, K1 launching ``2 *
    (pow_iters + 2)`` times on the local slices (their 16-byte alignment,
    and every call bit-equal to its plain version on the same leaves),
    ``rho``, ``g``, ``f`` before the step, the Adam moments, the
    BatchNorm statistics and the updated params against one process from
    the same seed, and the update each rank applied against Adam's step
    from the moments it holds, within ``CARD_F32_RTOL``, then the same
    but the params at float64, 64 px, batch 2 and at most 2 HVPs within
    ``CARD_F64_RTOL``,
    the step's seconds and each process's peak device memory, sharded and
    not; at float32, for each rank and one process beside the card's name
    and power limit, the step's all-reduces over the ``model`` group and
    its column assemblies with their bytes (one more step profiled before
    the time budget); (b) four ranks as ``data=2 x model=2``, the JAX package's multi-chip dryrun (``__graft_entry__.py``)
    on CNNUSPS at float64 with ``min_elems=1024``: a step, a
    ``scan_steps=2`` epoch, a LOBPCG step, a Lanczos step, the control,
    flagship-knob and ``auto`` epochs, each against one process; (c) the
    same four ranks on ``forest_best``'s ForestNet at float64, replicated
    params, 2 epochs of ``train()`` on the first 512 train rows through
    ``host_shard`` loaders fed by the data coordinate and ``test_model``
    through them: rank 0's TSV rows, every rank's state and evaluation
    against one process, each row counted once;
18. the models' compute dtype, TF32 off as ``driver.run`` sets it: (a)
    ``cifar10_densenet_mu0_01_K0`` with ``model=DenseNet3(dtype=torch.bfloat16)``
    and ``max_iter=1`` through ``driver.run`` on the first 128 rows of each
    split (4 steps, the recipe's remat and augmentation, as phase 10 runs
    the float32 model): s/epoch, steps/s, mean ``pow_iters``, the peak
    memory, a profiled step's busy share and kernel count; the JAX bench's
    DenseNet-40 HVP rate (batch 128, remat) at bfloat16 and float32
    compute, one reading each (the median of 3 before the time budget);
    (b) 2 steps of it with ``hvp_micro=2,
    remat=False``, K1 launching ``2 * (pow_iters + 2)`` times a step on
    float32 leaves, every call bit-equal to its plain version; (c)
    ``chestxray_mu0_01_K0`` with ``CXRModel("densenet121", outnum=14,
    dtype=torch.bfloat16)`` at 224 px, batch 4, one step through
    ``driver.run``: steps/s, mean ``pow_iters``, the peak memory, a profiled
    step; (d) a bfloat16 and a float32 ``train_step`` of the recipe on the
    card from one state and batch (``rho``, ``g``, the loss, the update and
    the BatchNorm statistics within the ``BF16_*`` bounds), and a bfloat16
    DenseNet-40 forward, gradient and HVP at batch 4 (8 before the time
    budget) on the card against the port's bfloat16 on the CPU (the
    tests' rule); (e) one ``usps_cnn_mu0_01_K0``
    step with ``CNNUSPS(conv_impl='gemm', dtype=torch.bfloat16)`` (bfloat16
    conv parameters beside float32 dense ones) and ``hvp_micro=2``, K1's
    bfloat16 and float32 entries one launch each a call, every call
    bit-equal to its plain version;
19. the Asymmetric Valley trainer under a mesh and the micro-batched step
    on a data mesh, one spawn of two gloo ranks sharing the card against
    this process alone, all at float64 within ``CARD_F64_RTOL``: (a)
    ``usps_cnn_asymmetric_valley`` (CNNUSPS, 14,794 parameters, batch 128)
    on the first 512 train rows and 256 of the other sets (``AV_ROWS``),
    cut to 4 epochs and a 5-point sweep (``AV_MESH``) through
    ``driver.run`` on ``data=2``, each rank its block of the global
    batches, then on ``data=1 x model=2`` with ``conv2``, ``conv3`` and
    ``fc1`` sharded: ``f`` per epoch and the four
    ``asymmetric_valley_*_results.txt`` arrays from rank 0, the SWA params
    from every rank; (b) the DenseNet-40 recipe at full width with
    ``hvp_micro=2, remat=False`` and at most 2 HVPs, one step on 8 rows in their natural
    order on ``data=2`` (each rank 4 rows, its share of the 2 global
    micro-batches): ``rho``, ``g``, the params and the BatchNorm
    statistics, K1 launching ``2 * (pow_iters + 2)`` times on each rank,
    every call bit-equal to its plain version; steps, seconds and peak
    device memory of every process;
20. the seconds of every phase against the ``BUDGET_S`` budget, a
    ``{"kernels": [...]}`` line (K1's launches summed over phases 4, 7,
    8, 10, 11, 12, 13, 15, 16, 17, 18 and 19, each counted from 0 just
    before its run), the card's name and power limit, and last the
    ``{"ok": true, "device": ...}`` line.

Weights are random (seed 1226); the data are the real sets when they are
under ``./data``, else their synthetic stand-ins.

Every wait is bounded.  The ranks join their gloo group with a
``RANK_TIMEOUT_S`` timeout, so a collective that one rank never makes
raises in its peer; the smoke waits for a phase's ranks at most about 3x
their measured time and never more than ``RANK_WAIT_MAX_S``, and then
kills them, prints each rank's last 4,000 characters and fails naming the
phase.  At ``DEADLINE_S`` from the start a watchdog prints the phase in
progress, kills every rank still alive, dumps every thread's stack and
exits 1.
"""

from __future__ import annotations

import contextlib
import datetime
import faulthandler
import gc
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12  # float32 outside the tensor cores
STEPS = 3  # phase 4's steps (5 until the smoke got its time budget)
EPOCHS = 1  # phase 7's epochs (2 before the time budget)
ROUNDS = 3  # phase 3's timing rounds (5 before the budget)
# the parameter tensors and parameters of torchvision's densenet121 (the
# chest-x-ray backbone), for a K1 tree of that size
DN121_LEAVES = 364
DN121_VALUES = 7_978_856
# kernel vs plain: the kernel rounds as fl(acc + fl(alpha * delta)) (and as
# fl(alpha * delta) under init), like the plain version, so the two should
# agree bit for bit; phase 3 allows 1 ulp of the dtype
# card vs CPU float64, relative error in the 2-norm.  Float32: the
# gradient of the first layers is a small difference of large sums (the
# BatchNorm backward subtracts the projections), so float32 keeps only
# ~3 digits there: 6.3e-4 to 3.2e-3 measured on the H100 over two runs
# (the trained weights differ run to run, cuDNN's sums not being
# deterministic).  The bound leaves 10x; the faults it guards against
# (a lost micro-batch, a wrong scale, full-batch BN statistics) show as
# 1e-1 and more.  Float64: rounding only.
CARD_F32_RTOL = 3e-2
CARD_F64_RTOL = 1e-9
# the rows of phase 10's float64 card-vs-CPU step (the recipe's 32 before the
# time budget)
F64_ROWS = 4
# phase 10's remat steps through K1 (2 before the time budget)
REMAT_MICRO_STEPS = 1
# the power iterations of the float64 steps held against the CPU or run on
# gloo ranks, a cut for time (the configs' caps of 100 before the time
# budget): on 2 gloo ranks every BatchNorm statistic and product crosses the
# host, 21.2 s a DenseNet-40 step of 7 HVPs.  A DenseNet-40 recipe step keeps
# its rho when the 2 HVPs do not converge (the recipe discards it), so the
# comparisons hold a real rho
F64_POW_ITERS = 2
F64_CAP = dict(max_pow_iter=F64_POW_ITERS, ignore_bad_vals=False)
# the time budget: the whole smoke in 720 s on an H100, 60% of the 1,200 s
# it is allowed, which leaves room for a host 1.6x slower; at 1,080 s a
# watchdog names the phase in progress, kills the ranks, dumps every
# thread's stack and exits 1
BUDGET_S = 720
DEADLINE_S = 1080
# a rank's collective that its peer never makes raises after this (the
# ranks' process group timeout)
RANK_TIMEOUT_S = 120
# the longest the smoke waits for a phase's ranks, and each phase's wait:
# about 3x the phase's measured time (PERF.md section 5)
RANK_WAIT_MAX_S = 240
MESH_WAIT_S = 90  # phase 16 (e): its ranks 24.6 s
TP2_WAIT_S = 240  # phase 17 (a): 116.7 s, its ranks about 80 s of it
TP4_WAIT_S = 100  # phase 17 (b, c): 31.5 s
AV_WAIT_S = 90  # phase 19: 27.3 s, 60 s budgeted
# the phase in progress and the rank processes started, for the watchdog
_RUN = {"phase": "start-up", "ranks": []}


def log(*args):
    print(*args, flush=True)


def fail(msg):
    log(f"FAILED: {msg}")
    sys.exit(1)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_card():
    from optwboundeigenval_tpu_torch.utils import precision

    smi = nvidia_smi()
    flags = precision.set_tf32(False)  # as driver.run sets it by default
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    log(precision.describe(flags))
    return smi


def phase_build():
    from optwboundeigenval_tpu_torch import native
    from optwboundeigenval_tpu_torch.utils import cuda_build

    for old in cuda_build.BUILD_DIR.glob("*.so") if cuda_build.BUILD_DIR.exists() else ():
        old.unlink()  # build from the sources of this checkout, every run
    t0 = time.perf_counter()
    paths = cuda_build.build(["axpy_accumulate"])
    log(f"build: {time.perf_counter() - t0:.3f} s -> "
        + ", ".join(str(p.name) for p in paths.values()))
    t0 = time.perf_counter()
    native.lib()  # the host augmentation (g++), before anything times it
    log(f"build: augment.cpp with g++ {time.perf_counter() - t0:.3f} s -> "
        f"{native.library_path().name}")


def densenet40_leaf_shapes():
    from optwboundeigenval_tpu_torch.models.densenet import DenseNet3

    m = DenseNet3(depth=40, growth_rate=12, num_classes=10)
    return [tuple(p.shape) for p in m.parameters()]


def densenet121_sized_leaves(seed=1226):
    """``DN121_LEAVES`` leaf sizes that sum to ``DN121_VALUES`` (the parameter
    tensors and parameters of torchvision's ``densenet121``), drawn
    log-normal from ``seed``: a few large convolution leaves and many small
    ones, as in the real tree."""
    rng = np.random.default_rng(seed)
    w = rng.lognormal(sigma=2.0, size=DN121_LEAVES)
    sizes = np.maximum(1, np.floor(w / w.sum() * DN121_VALUES)).astype(np.int64)
    sizes[np.argmax(sizes)] += DN121_VALUES - sizes.sum()
    return [(int(n),) for n in sizes]


def _tree(shapes, dtype, g, unaligned=()):
    """One tensor per shape on the card; the leaves whose index is in
    ``unaligned`` are views at offset 1 (the kernel's scalar path)."""
    def leaf(i, shape):
        n = math.prod(shape)
        t = torch.randn(n + 1, device="cuda", dtype=dtype, generator=g)
        return (t[1:] if i in unaligned else t[:n]).view(shape)
    return [leaf(i, s) for i, s in enumerate(shapes)]


def _flat_views(shapes, dtype, g):
    """Leaves laid out as ``curvature._accumulate`` lays out its accumulator:
    views into one buffer at offsets padded to 4 values."""
    from optwboundeigenval_tpu_torch.ops.curvature import _flat_like

    tree = _flat_like({str(i): torch.empty(s, device="cuda", dtype=dtype)
                       for i, s in enumerate(shapes)})
    for t in tree.values():
        t.copy_(torch.randn(t.shape, device="cuda", dtype=dtype, generator=g))
    return list(tree.values())


def host_us(fn, reps=200):
    """Host time per call of ``fn`` (perf_counter; what the device does is
    not waited for)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    return us


def wall_ms(fns, reps, rounds=ROUNDS):
    """Per name, the median, least and most of ``rounds`` readings of
    :func:`cuda_time_ms` over ``reps`` back-to-back calls, the functions
    taken in turns so that the host's noise falls on each alike."""
    readings = {k: [] for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            readings[k].append(cuda_time_ms(fn, reps))
    return {k: (float(np.median(v)), min(v), max(v)) for k, v in readings.items()}


def show(wall):
    return ", ".join(f"{k} {m:.4f} ({lo:.4f}-{hi:.4f})" for k, (m, lo, hi) in wall.items())


def show_us(us, bound_us=None):
    if us is None:
        return "not measured"
    if bound_us is None:
        return f"{us:.2f} us"
    return f"{us:.2f} us, {100 * bound_us / us:.1f}% of the {bound_us:.2f} us bound"


def device_us_per_launch(fn, reps=20):
    """K1's device time per launch from ``torch.profiler`` (None when the
    profiler records no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and "axpy_tree" in e.key]
    count = sum(e.count for e in evs)
    if not count:
        return None
    return sum(e.self_device_time_total for e in evs) / count


def phase_kernel_check(leaf_shapes):
    """K1 against its plain version on the card, in float32 and float64,
    accumulate and init, on whole trees in one call; then its timings.
    Returns the kernel entry of the kernels line (without ``launches``)."""
    from optwboundeigenval_tpu_torch.ops import pallas_kernels as pk

    g = torch.Generator(device="cuda").manual_seed(1226)
    cap = pk.TABLE_CAPACITY
    dn121 = densenet121_sized_leaves()
    over = [(1 + i % 300,) for i in range(2 * cap + 452)]
    ragged = [(1000,), (0,), (7, 13), (3,), (1,), (12, 1, 3, 3), (2049,)]
    cases = [
        ("densenet40 tree", lambda dt: _tree(leaf_shapes, dt, g)),
        ("densenet40 flat-buffer views", lambda dt: _flat_views(leaf_shapes, dt, g)),
        ("ragged: unaligned view + empty leaf", lambda dt: _tree(ragged, dt, g, (0,))),
        ("densenet121-sized tree", lambda dt: _tree(dn121, dt, g)),
        (f"{len(over)} leaves, above capacity", lambda dt: _tree(over, dt, g, (7,))),
    ]
    for shape in [(1,), (3,), (1000,), (7, 13), (1 << 24,)]:
        cases.append((f"single leaf {shape}", lambda dt, s=shape: _tree([s], dt, g)[0]))
    cases.append(("single leaf (1000,) unaligned",
                  lambda dt: _tree([(1000,)], dt, g, (0,))[0]))
    max_err, checked = 0.0, 0
    for dtype in (torch.float32, torch.float64, torch.bfloat16):
        eps = torch.finfo(dtype).eps
        # a bfloat16 tree sums in float32 against a float32 alpha
        alpha = torch.tensor(0.5 + 1.0 / 3.0, device="cuda",
                             dtype=torch.float32 if dtype == torch.bfloat16 else dtype)
        for name, make in cases:
            for init in (False, True):
                acc, delta = make(dtype), make(dtype)
                accs = [acc] if isinstance(acc, torch.Tensor) else acc
                deltas = [delta] if isinstance(delta, torch.Tensor) else delta
                want = pk.axpy_accumulate_plain([a.clone() for a in accs], deltas,
                                                alpha, init=init)
                if init:
                    for a in accs:
                        a.fill_(float("nan"))  # the kernel must never read them
                ptrs = [a.data_ptr() for a in accs]
                before = pk.axpy_accumulate.launches
                out = pk.axpy_accumulate(acc, delta, alpha, init=init)
                torch.cuda.synchronize()
                label = f"axpy_accumulate {name}, {dtype}, {'init' if init else 'accumulate'}"
                launched = pk.axpy_accumulate.launches - before
                expect = -(-sum(a.numel() > 0 for a in accs) // cap)
                if out is not acc or [a.data_ptr() for a in accs] != ptrs:
                    fail(f"{label}: not in place")
                if launched != expect:
                    fail(f"{label}: {launched} launches, expected {expect}")
                for a, w in zip(accs, want):
                    err = (a - w).abs()
                    if not bool((err <= eps * w.abs()).all()):
                        fail(f"{label}: max abs err {err.max().item():.3e} over 1 ulp")
                    if err.numel():
                        max_err = max(max_err, err.float().max().item())
                checked += 1
    log(f"axpy_accumulate: {checked} calls ({len(cases)} trees and leaves x float32, "
        f"float64, bfloat16 x accumulate, init) match the plain version, max abs err "
        f"{max_err:.3e} (tolerance 1 ulp); the {len(over)}-leaf tree took "
        f"{-(-len(over) // cap)} launches")

    # timing at the main path's unit of work: one full-model accumulate of
    # DenseNet-40 in float32 (2.1 MB, in L2 as in the step), back to back
    alpha = torch.tensor(0.5 + 1.0 / 3.0, device="cuda")
    a = float(alpha)
    accs, deltas = _tree(leaf_shapes, torch.float32, g), _tree(leaf_shapes, torch.float32, g)
    n = sum(t.numel() for t in accs)
    kernel = lambda: pk.axpy_accumulate(accs, deltas, alpha)
    foreach = lambda: torch._foreach_add_(accs, deltas, alpha=a)
    wall = wall_ms({"kernel": kernel, "_foreach_add_": foreach,
                    "plain": lambda: pk.axpy_accumulate_plain(accs, deltas, alpha),
                    "add_ per leaf": lambda: [x.add_(d, alpha=a) for x, d in zip(accs, deltas)]},
                   reps=200)
    kernel_ms, library_ms, plain_ms = (wall[k][0] for k in ("kernel", "_foreach_add_", "plain"))
    dn40_us = device_us_per_launch(kernel)
    # where the wrapper's host time goes: its checks, the contiguity and
    # pointer reads of _launch, the table packing, and the ctypes launch
    T = torch.Tensor
    reads = lambda: (list(map(T.data_ptr, accs)), list(map(T.data_ptr, deltas)),
                     list(map(T.numel, accs)))
    pa, pd, ns = reads()
    [(rows, chunks)] = pk.pack_tables(pa, pd, ns, 4)
    fn, stream = pk._kernels()[torch.float32], torch.cuda.current_stream().cuda_stream
    host = {
        "wrapper": host_us(kernel),
        "checks": host_us(lambda: pk._check(accs, deltas, alpha)),
        "contiguity": host_us(lambda: all(map(T.is_contiguous, accs + deltas))),
        "pointers": host_us(reads),
        "packing": host_us(lambda: pk.pack_tables(pa, pd, ns, 4)),
        "launch": host_us(lambda: fn(rows.ctypes.data, len(rows), chunks,
                                     alpha.data_ptr(), 0, stream)),
        "_foreach_add_": host_us(foreach),
    }
    nbytes, nflops = 12 * n, 2 * n
    bound_ms = 1e3 * max(nbytes / H100_BYTES_PER_S, nflops / H100_FP32_FLOPS)
    log(f"axpy_accumulate per full-model accumulate ({len(accs)} leaves, {n} values, "
        f"{nbytes} B, one call), wall ms per call, median (min-max) of {ROUNDS}: {show(wall)}; "
        f"kernel device time per launch {show_us(dn40_us)}, bound {bound_ms:.6f} ms (bytes)")
    log("axpy_accumulate host us per densenet40 call: "
        + ", ".join(f"{k} {v:.1f}" for k, v in host.items()))

    # the DenseNet-121-sized tree: 64 MB of acc and delta, more than L2
    accs = _tree(dn121, torch.float32, g)
    deltas = _tree(dn121, torch.float32, g)
    n121 = sum(t.numel() for t in accs)
    kernel = lambda: pk.axpy_accumulate(accs, deltas, alpha)
    wall121 = wall_ms({"kernel": kernel,
                       "_foreach_add_": lambda: torch._foreach_add_(accs, deltas, alpha=a)},
                      reps=50)
    dn121_us = device_us_per_launch(kernel)
    dn121_bound_us = 1e6 * 12 * n121 / H100_BYTES_PER_S
    log(f"axpy_accumulate densenet121-sized tree ({len(accs)} leaves, {n121} values, "
        f"{12 * n121} B): kernel device time per launch {show_us(dn121_us, dn121_bound_us)}; "
        f"wall ms per call, median (min-max) of {ROUNDS}: {show(wall121)}")

    big_a = torch.randn(1 << 24, device="cuda", generator=g)
    big_d = torch.randn(1 << 24, device="cuda", generator=g)
    kernel = lambda: pk.axpy_accumulate(big_a, big_d, alpha)
    wall16 = wall_ms({"kernel": kernel,
                      "plain": lambda: pk.axpy_accumulate_plain(big_a, big_d, alpha),
                      "add_": lambda: big_a.add_(big_d, alpha=a)}, reps=50)
    flat_us = device_us_per_launch(kernel)
    b16 = 1e6 * 12 * (1 << 24) / H100_BYTES_PER_S
    aim = "" if flat_us is None or b16 / flat_us >= 0.8 else ", BELOW the 80% aim"
    log(f"axpy_accumulate flat 16M (201 MB moved): kernel device time per launch "
        f"{show_us(flat_us, b16)}{aim}; wall ms per call, median (min-max) of {ROUNDS}: "
        f"{show(wall16)}")
    return {
        "name": "axpy_accumulate",
        "route": "cuda",
        "source": "optwboundeigenval_tpu_torch/csrc/axpy_accumulate.cu",
        "replaces": "optwboundeigenval_tpu/ops/pallas_kernels.py:62",
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": library_ms,
        "library_call": "torch._foreach_add_",
        "device_us": dn40_us,
        "dn121_device_us": dn121_us,
        "dn121_bound_us": dn121_bound_us,
        "dn121_ms": wall121["kernel"][0],
        "dn121_library_ms": wall121["_foreach_add_"][0],
        "flat16m_device_us": flat_us,
        "flat16m_bound_us": b16,
    }


def phase_slice(device="cuda", steps=STEPS):
    """The main path through the config driver; returns the trainer, the
    batch, and the kernel launches counted during the steps."""
    from optwboundeigenval_tpu_torch.configs import cifar10_densenet_mu0_01_K0
    from optwboundeigenval_tpu_torch.ops import pallas_kernels as pk
    from optwboundeigenval_tpu_torch.train.driver import build_trainer

    opts = cifar10_densenet_mu0_01_K0.options(
        remat=False, hvp_micro=2, augment=False, device=device)
    trainer = build_trainer(opts)
    batches = iter(opts["train_loader"])
    trainer.init_state()
    log(f"slice: DenseNet-40-12, {trainer.ndim} parameters in "
        f"{len(trainer.params)} leaves, batch {opts['batch_size']}, "
        f"hvp_micro {trainer.hvp_micro}, mu {trainer.mu}, K {trainer.K}, on {device}")
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    pk.axpy_accumulate.launches = 0
    batch = None
    for i in range(steps):
        batch = next(batches)
        before = pk.axpy_accumulate.launches
        sync()
        t0 = time.perf_counter()
        m = trainer.train_step(batch)
        sync()
        ms = 1e3 * (time.perf_counter() - t0)
        launched = pk.axpy_accumulate.launches - before
        log(f"step {i}: rho {m['rho']:.6g} pow_iters {m['pow_iters']} "
            f"converged {m['converged']} g {m['g']:.6g} "
            f"gradf_norm {m['gradf_norm']:.6g} gradg_norm {m['gradg_norm']:.6g} "
            f"step_ms {ms:.1f} K1_launches {launched}")
        values = [m[k] for k in ("rho", "g", "gradf_norm", "gradg_norm")]
        if not (m["step_ok"] and all(math.isfinite(x) for x in values)):
            fail(f"step {i}: non-finite metrics {m}")
        if not (m["g"] > 0 and m["gradg_norm"] > 0):
            fail(f"step {i}: the vGHv pass did not run (g {m['g']}, "
                 f"gradg_norm {m['gradg_norm']})")
        # every accumulate of the step goes through K1, one launch per
        # micro-batch over all leaves: gradient, each power-iteration HVP
        # and the vGHv pass
        want = (m["pow_iters"] + 2) * trainer.hvp_micro
        if device == "cuda" and launched != want:
            fail(f"step {i}: {launched} K1 launches, expected {want}")
    launches = pk.axpy_accumulate.launches
    for k, t in trainer.params.items():
        if not bool(torch.isfinite(t).all()):
            fail(f"non-finite parameter {k}")
    if device == "cuda":
        log(f"max_memory_allocated: {torch.cuda.max_memory_allocated()} B")
    if device == "cuda" and launches == 0:
        fail("the main path launched no K1 kernel")
    log(f"K1 launches in {steps} steps: {launches}")
    return trainer, trainer.put_batch(batch), launches


def phase_profile(trainer, batch, label="densenet40 hvp_micro=2", step=None):
    """One more step under ``torch.profiler`` (``trainer.train_step``, or
    ``step()``): the device's busy share of the step's wall time, K1's
    share, and the kernels that take most.  Returns ``(wall ms, device-busy
    ms, kernel launches)``, or None when the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    # device activity only: the host's op events would double what the
    # profiler has to gather on a step of 10^5 kernels, and are not read
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        m = trainer.train_step(batch) if step is None else step()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    t1 = time.perf_counter()
    # (launches, ns) by kernel name, summed from the raw device events:
    # key_averages() first builds the whole event tree, the larger part of
    # the smoke's profiling time on a CXR step (PERF.md, section 6)
    kernels = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            n, ns = kernels.get(e.name(), (0, 0))
            kernels[e.name()] = (n + 1, ns + e.duration_ns())
    busy_us = sum(ns for _, ns in kernels.values()) / 1e3
    launches = sum(n for n, _ in kernels.values())
    if busy_us == 0:
        log("profile: the profiler recorded no device time (not measured)")
        return None
    k1_us = sum(ns for k, (_, ns) in kernels.items() if "axpy" in k) / 1e3
    iters = m["pow_iters"] if isinstance(m, dict) and "pow_iters" in m else "-"
    log(f"profile {label} (one step, pow_iters {iters}): wall {wall_us / 1e3:.1f} ms, "
        f"device busy {busy_us / 1e3:.1f} ms ({100 * busy_us / wall_us:.1f}%), "
        f"idle {100 * (1 - busy_us / wall_us):.1f}%, K1 {k1_us / 1e3:.2f} ms "
        f"({100 * k1_us / busy_us:.2f}% of busy), {launches} kernel launches; the "
        f"profile took {time.perf_counter() - t1:.1f} s to read")
    for k, (n, ns) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:6]:
        log(f"  {ns / 1e6:9.2f} ms {n:6d}x  {k[:90]}")
    return wall_us / 1e3, busy_us / 1e3, launches


def phase_card_vs_cpu(trainer, batch, rows=8):
    """HVP and vGHv at the trained weights on a fixed ``v``, on the first
    ``rows`` rows of the step's batch (32 before the time budget): the card
    against the port on the CPU in float64.  The micro-batched products
    run through K1 on the card in float32 and in float64, each held to the
    CPU's float64 micro-batched product; float64 on the card also runs the
    plain ``hvp``/``vghv`` on the first micro-batch, a tight check of the
    device's convolutions and autodiff alone.  (BatchNorm statistics are
    per micro-batch, so a full-batch product is another operator than the
    micro-batched one.)"""
    from optwboundeigenval_tpu_torch.ops import curvature
    from optwboundeigenval_tpu_torch.ops import pallas_kernels as pk
    from optwboundeigenval_tpu_torch.utils.tree import tree_norm, tree_sub

    rng = np.random.default_rng(1226)
    v64 = {k: torch.from_numpy(rng.normal(size=tuple(t.shape)))
           for k, t in trainer.params.items()}
    scale = 1.0 / float(tree_norm(v64))
    v64 = {k: t * scale for k, t in v64.items()}
    dev, cpu = trainer.device, torch.device("cpu")
    cast = lambda tree, dtype, device: {
        k: (t.detach().to(device, dtype) if t.is_floating_point() else t.to(device))
        for k, t in tree.items()}
    task, micro = trainer.task, trainer.hvp_micro
    batch = {k: t[:rows] for k, t in batch.items()}
    p64, s64, b64 = (cast(t, torch.float64, cpu) for t in
                     (trainer.params, trainer.model_state, batch))
    half = {k: t[:len(t) // micro] for k, t in b64.items()}
    f64 = task.loss_fn(s64)
    f64_card = task.loss_fn(cast(s64, torch.float64, dev))
    on_dev = lambda *trees: [cast(t, torch.float64, dev) for t in trees]
    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, 1e3 * (time.perf_counter() - t0)

    for name in ("hvp", "vghv"):
        micro_fn, full_fn = getattr(curvature, f"{name}_microbatched"), getattr(curvature, name)
        micro_ref = timed(lambda: micro_fn(f64, p64, b64, v64, micro))
        half_ref = timed(lambda: full_fn(f64, p64, half, v64))
        checks = (
            ("card f32 micro-batched (K1)", CARD_F32_RTOL, micro, micro_ref,
             lambda: micro_fn(task.loss_fn(trainer.model_state), trainer.params,
                              batch, cast(v64, torch.float32, dev), micro)),
            ("card f64 micro-batched (K1)", CARD_F64_RTOL, micro, micro_ref,
             lambda: micro_fn(f64_card, *on_dev(p64, b64, v64), micro)),
            ("card f64 first micro-batch", CARD_F64_RTOL, 0, half_ref,
             lambda: full_fn(f64_card, *on_dev(p64, half, v64))),
        )
        for label, bound, launches, (ref, cpu_ms), on_card in checks:
            before = pk.axpy_accumulate.launches
            out, card_ms = timed(lambda: cast(on_card(), torch.float64, cpu))
            launched = pk.axpy_accumulate.launches - before
            rel = float(tree_norm(tree_sub(out, ref)) / tree_norm(ref))
            log(f"{name}: {label} vs cpu f64: relative error {rel:.3e} "
                f"(bound {bound:g}); K1 launches {launched}; card {card_ms:.1f} ms, "
                f"cpu {cpu_ms:.1f} ms")
            if not rel < bound:
                fail(f"{name}: {label} and the CPU disagree ({rel:.3e})")
            if launched != launches:
                fail(f"{name}: {label} launched K1 {launched} times, expected {launches}")


def _finite_floats(text):
    return all(math.isfinite(float(t)) for t in text.split())


def run_epochs(label, opts, device, epochs):
    """``driver.run`` on ``opts`` with K1's count set to 0 just before and
    read just after; prints the TSV rows, test lines, epoch seconds,
    steps/s and power iterations, and fails on anything not finite, a
    missing row, a best checkpoint that does not load back to the
    trained tensors or non-finite ``rho_test`` means.  Returns the
    trainer, a train batch and the K1 launches of the run."""
    from optwboundeigenval_tpu_torch.ops import pallas_kernels as pk
    from optwboundeigenval_tpu_torch.train import checkpoints, driver

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    pk.axpy_accumulate.launches = 0
    sync()
    t0 = time.perf_counter()
    trainer = driver.run(opts)
    sync()
    wall = time.perf_counter() - t0
    launches = pk.axpy_accumulate.launches
    with open(trainer.log_file) as fh:
        lines = fh.read().splitlines()
    rows = [ln for ln in lines[1:] if ln[:1].isdigit()]
    tests = [ln for ln in lines if ln.split(":")[0].endswith(("Loss", "Accuracy", "F1"))]
    steps = epochs * len(trainer.epoch_pow_iters)
    t = trainer.timers.totals
    log(f"{label}: {trainer.ndim} parameters, {steps} steps in {epochs} epochs, "
        f"driver.run {wall:.1f} s; per epoch {t['Iteration'] / epochs:.2f} s "
        f"(steps {t['G'] / epochs:.2f} s, epoch-end f {t['Test'] / epochs:.2f} s), "
        f"{steps / t['G']:.2f} steps/s; mean pow_iters (last epoch) "
        f"{trainer.mean_pow_iters:.2f}; K1 launches {launches}")
    log(lines[0])
    for ln in rows + tests:
        log(f"  {ln}")
    if len(rows) != epochs or not all(_finite_floats(r) for r in rows):
        fail(f"{label}: the log holds {len(rows)} rows, expected {epochs} finite ones")
    if len(tests) < 6 or not all(math.isfinite(float(ln.split(":")[1])) for ln in tests):
        fail(f"{label}: the train and test lines are missing or not finite")
    best = os.path.join(trainer.model_dir, trainer.header2 + "_trained_model_best.pt")
    if not os.path.exists(best):
        fail(f"{label}: no best checkpoint {best}")
    saved = checkpoints.load_checkpoint(best)["params"]
    if sorted(saved) != sorted(trainer.params) or not all(
            torch.equal(saved[k].to(trainer.device), p) for k, p in trainer.params.items()):
        fail(f"{label}: the best checkpoint does not load back to the tested tensors")
    if opts.get("rho_test"):
        csv = np.loadtxt(os.path.join(trainer.log_dir, trainer.header2 + "_rho_test.csv"),
                         delimiter=",", ndmin=2)
        means = csv[:, 1:].mean(axis=0)
        log(f"{label}: rho_test over {len(csv)} batches, means rho {means[0]:.6g} "
            f"norm {means[1]:.6g} iters {means[2]:.3f} res_change {means[3]:.6g} "
            f"seconds {means[4]:.4f}")
        if not np.isfinite(csv).all():
            fail(f"{label}: rho_test values not finite")
    train_loader = driver._loaders(opts, trainer.batch_size)[0]
    return trainer, trainer.put_batch(next(iter(train_loader))), launches


def phase_epochs(device="cuda", epochs=EPOCHS):
    """Phase 7: Forest and USPS through ``driver.run`` at full width on
    ``TRAIN_ROWS`` train rows."""
    from optwboundeigenval_tpu_torch.configs import forest_best, usps_cnn_mu0_01_K0

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, mod in (("forest_best", forest_best),
                           ("usps_cnn_mu0_01_K0", usps_cnn_mu0_01_K0)):
            opts = _train_rows(mod.options(max_iter=epochs, rho_test=True, device=device,
                                           log_dir=f"{tmp}/{label}/logs",
                                           model_dir=f"{tmp}/{label}/models"),
                               TRAIN_ROWS[label.split("_")[0]])
            out[label] = run_epochs(label, opts, device, epochs)
    return out


def phase_densenet_epoch(device="cuda", rows=128):
    """Phase 8: one DenseNet-40 epoch through ``driver.run`` with
    ``hvp_micro=2``, on the first ``rows`` rows of each split; K1's
    launches must be ``hvp_micro * sum(pow_iters + 2)`` over the steps."""
    from optwboundeigenval_tpu_torch.configs import cifar10_densenet_mu0_01_K0
    from optwboundeigenval_tpu_torch.data.loaders import ArrayLoader

    with tempfile.TemporaryDirectory() as tmp:
        opts = cifar10_densenet_mu0_01_K0.options(
            remat=False, augment=False, hvp_micro=2, max_iter=1, device=device,
            log_dir=f"{tmp}/logs", model_dir=f"{tmp}/models")
        bs = opts["batch_size"]
        cut = lambda ld, **kw: ArrayLoader(ld.x[:rows], ld.y[:rows], bs, **kw)
        opts["train_loader"] = cut(opts["train_loader"], shuffle=True, seed=1226)
        opts["valid_loader"] = cut(opts["valid_loader"])
        opts["train_loader_na"] = cut(opts["train_loader_na"])
        opts["test_loader"] = [cut(opts["test_loader"][0])]
        trainer, batch, launches = run_epochs("cifar10_densenet_mu0_01_K0", opts,
                                              device, 1)
    want = trainer.hvp_micro * sum(p + 2 for p in trainer.epoch_pow_iters)
    log(f"densenet40 epoch: defer_metrics {trainer.defer_metrics}, pow_iters per "
        f"step {trainer.epoch_pow_iters}, K1 launches {launches}, expected {want}")
    if device == "cuda" and (launches != want or launches == 0):
        fail(f"densenet40 epoch: {launches} K1 launches, expected {want}")
    return trainer, batch, launches


def _train_rows(opts, rows):
    """``opts`` with the train set cut to its first ``rows`` rows (the
    ``inputs``/``target`` arrays, or the train loaders with their batch size,
    shuffling and augmentation), a cut for time."""
    from optwboundeigenval_tpu_torch.data.loaders import ArrayLoader

    if opts.get("inputs") is not None:
        opts["inputs"], opts["target"] = opts["inputs"][:rows], opts["target"][:rows]
        return opts
    for key in ("train_loader", "train_loader_na"):
        ld = opts.get(key)
        if ld is not None:
            opts[key] = ArrayLoader(ld.x[:rows], ld.y[:rows], ld.batch_size,
                                    shuffle=ld.shuffle, seed=1226, augment=ld.augment)
    return opts


def _first_batch(mod, rows, **overrides):
    opts = mod.options(device="cpu", **overrides)
    if "train_loader" in opts:
        ld = opts["train_loader"]
        x, y = ld.x[:rows], ld.y[:rows]
    else:
        x, y = opts["inputs"][:rows], opts["target"][:rows]
    return opts["model"], opts.get("has_batch_stats", False), {
        "x": x, "y": y, "w": np.ones(rows, np.float32)}


def phase_cached_hvp(reps=5):
    """Phase 9: ``linearize_hvp`` (one gradient graph, one reverse pass per
    HVP) against the closure (``curvature.hvp``, reverse over reverse from
    scratch per HVP): float64 on the card vs the CPU's float64 closure, and
    both on the card timed, set-up (the gradient) and per HVP."""
    from optwboundeigenval_tpu_torch.configs import (
        cifar10_densenet_mu0_01_K0, forest_best, usps_cnn_mu0_01_K0)
    from optwboundeigenval_tpu_torch.ops import curvature
    from optwboundeigenval_tpu_torch.train.task import Task
    from optwboundeigenval_tpu_torch.utils.tree import tree_norm, tree_sub

    cases = (("ForestNet b128", forest_best, 128, {}),
             ("CNNUSPS b128", usps_cnn_mu0_01_K0, 128, {}),
             ("DenseNet-40 b32", cifar10_densenet_mu0_01_K0, 32, {"augment": False}))
    cpu = torch.device("cpu")
    for label, mod, rows, kw in cases:
        model, bn, batch = _first_batch(mod, rows, **kw)
        task = Task(model=model, has_batch_stats=bn)
        p32, s32 = task.init(torch.Generator().manual_seed(1226), cpu)
        rng = np.random.default_rng(1226)
        v = {k: torch.from_numpy(rng.normal(size=tuple(t.shape))) for k, t in p32.items()}
        v = {k: t / float(tree_norm(v)) for k, t in v.items()}
        to = lambda tree, dtype, dev: {
            k: t.to(dev, dtype) if t.is_floating_point() else t.to(dev)
            for k, t in tree.items()}
        b = {k: torch.as_tensor(a) for k, a in batch.items()}
        ref = curvature.hvp(task.loss_fn(to(s32, torch.float64, cpu)),
                            to(p32, torch.float64, cpu), b, v)
        timings = []
        for dtype in (torch.float64, torch.float32):
            p, s, bd, vd = (to(t, dtype, "cuda") for t in (p32, s32, b, v))
            loss = task.loss_fn(s)
            _, hvp_fn = curvature.linearize_hvp(loss, p, bd)
            got = to(hvp_fn(vd), torch.float64, cpu)
            rel = float(tree_norm(tree_sub(got, ref)) / tree_norm(ref))
            closure = to(curvature.hvp(loss, p, bd, vd), torch.float64, cpu)
            rel_c = float(tree_norm(tree_sub(closure, ref)) / tree_norm(ref))
            bound = CARD_F64_RTOL if dtype == torch.float64 else CARD_F32_RTOL
            log(f"cached hvp {label} {dtype}: card linearize_hvp vs cpu f64 closure "
                f"{rel:.3e}, card closure vs cpu {rel_c:.3e} (bound {bound:g})")
            if not (rel < bound and rel_c < bound):
                fail(f"cached hvp {label} {dtype}: the card and the CPU disagree")
            setup_c = cuda_time_ms(lambda: curvature.linearize_hvp(loss, p, bd), 5, 1)
            hvp_c = cuda_time_ms(lambda: hvp_fn(vd), reps)
            setup_u = cuda_time_ms(lambda: curvature.grad(loss, p, bd), 5, 1)
            hvp_u = cuda_time_ms(lambda: curvature.hvp(loss, p, bd, vd), reps)
            vghv = cuda_time_ms(lambda: curvature.vghv(loss, p, bd, vd), 5, 1)
            timings.append(f"{dtype}: cached set-up {setup_c:.3f} ms, {hvp_c:.3f} ms "
                           f"per HVP; closure set-up {setup_u:.3f} ms, {hvp_u:.3f} ms "
                           f"per HVP ({hvp_u / hvp_c:.2f}x); vGHv {vghv:.3f} ms")
        log(f"cached hvp {label} on the card (wall, CUDA events): " + "; ".join(timings))


class _TimedHook:
    """A loader's augmentation hook with its host time summed."""

    def __init__(self, hook):
        self.hook, self.seconds, self.calls = hook, 0.0, 0

    def __call__(self, x, rng):
        t0 = time.perf_counter()
        out = self.hook(x, rng)
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        return out


def _as_f64(trainer):
    """The trainer's fresh state in float64, its eigenvector the uniform one."""
    from optwboundeigenval_tpu_torch.utils.tree import tree_uniform_like

    trainer.init_state()
    trainer.params = {k: t.double() for k, t in trainer.params.items()}
    trainer.model_state = {k: t.double() if t.is_floating_point() else t
                           for k, t in trainer.model_state.items()}
    trainer.opt_state = trainer.optimizer.init(trainer.params)
    if trainer.optimizer.build_extra_state is not None:
        trainer.opt_state = trainer.optimizer.build_extra_state(
            trainer.opt_state, trainer.task, trainer.params, trainer.model_state)
    trainer.v = tree_uniform_like(trainer.params)
    return trainer


def _rel(a, b):
    """Relative 2-norm error of tree (or tensor) ``a`` against ``b``, on the CPU."""
    if isinstance(a, torch.Tensor):
        a, b = {"": a}, {"": b}
    num = sum(float(((a[k].cpu().double() - b[k].cpu().double()) ** 2).sum()) for k in b)
    den = sum(float((b[k].cpu().double() ** 2).sum()) for k in b)
    return math.sqrt(num / den) if den else math.sqrt(num)


class _Memory:
    """Bytes allocated on ``device`` around a call: the caching allocator's
    counters on the card; on the CPU (a rehearsal), the allocations and
    frees that ``torch.profiler`` records, summed in time order."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"

    def __call__(self, fn):
        """``(fn(), peak, after)``: the peak during the call and what stays
        allocated after it, both above what was allocated before."""
        if self.cuda:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = fn()
            torch.cuda.synchronize()
            return (out, torch.cuda.max_memory_allocated() - base,
                    torch.cuda.memory_allocated() - base)
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU], profile_memory=True) as prof:
            out = fn()
        cur = peak = 0
        for e in sorted(prof.events(), key=lambda e: e.time_range.start):
            cur += e.cpu_memory_usage if e.name == "[memory]" else e.self_cpu_memory_usage
            peak = max(peak, cur)
        return out, peak, cur


def remat_memory(label, build, batch, device="cuda"):
    """Memory of one step's curvature passes with ``remat`` on and off,
    from one state: what the HVP map holds between products, the peak of
    one product above that, the peak over the map's set-up and the
    eigensolve, the peak of the vGHv pass and of a whole ``train_step``.
    Fails unless the remat map holds less between products and its
    eigensolve peaks lower (``jax.linearize(grad(jax.checkpoint(loss)))``
    keeps only its inputs).  The vGHv pass holds the most in both
    settings, so it sets the step's peak in both.  Every product peaks
    alike, so ``build`` may cap the power iterations (the smoke gives 2).
    """
    from optwboundeigenval_tpu_torch.ops import curvature

    mem, out = _Memory(device), {}
    for remat in (True, False):
        tr = build(remat)
        tr.init_state()
        b = tr.put_batch(batch)
        loss = tr._loss_fn(tr.model_state)
        v = tr._start(tr.v)
        (grads, hvp_fn), set_up, after = mem(lambda: tr._linearize(loss, tr.params, b))
        held = after - sum(t.numel() * t.element_size() for t in grads.values())
        _, product, _ = mem(lambda: hvp_fn(v))
        eig, solve, _ = mem(lambda: tr._eig(hvp_fn, v))
        eig_peak = max(set_up, after + solve)
        del hvp_fn, grads
        _, vghv_peak, _ = mem(lambda: curvature.vghv(loss, tr.params, b, eig.v))
        m, step_peak, _ = mem(lambda: tr.train_step(batch))
        out[remat] = (held, eig_peak, vghv_peak, step_peak)
        log(f"{label} memory on {device}, remat {remat}: the HVP map holds {held} B between "
            f"products, one product peaks {product} B above that; set-up and eigensolve "
            f"peak {eig_peak} B; vGHv pass {vghv_peak} B; train_step {step_peak} B "
            f"(pow_iters {m['pow_iters']})")
        del tr, eig
    (h1, e1, _, _), (h0, e0, _, _) = out[True], out[False]
    log(f"{label} memory: remat holds {h1} B against {h0} B between HVPs, eigensolve peak "
        f"{e1} B against {e0} B ({e1 / e0:.3f}x)")
    if not (h1 < h0 and e1 < e0):
        fail(f"{label}: remat does not bound the eigensolve's memory ({h1} vs {h0} B held, "
             f"{e1} vs {e0} B peak)")
    return out


def phase_recipe(device="cuda", rows=128):
    """Phase 10: the published DenseNet-40 recipe through ``driver.run``,
    with remat and without; a float64 step with remat on and off; and 2
    remat steps with ``hvp_micro=2`` through K1.  Returns K1's launches
    and the recipe's run as published (s/epoch, steps/s, ``pow_iters``,
    peak), which phase 16 prints beside its knobs."""
    from optwboundeigenval_tpu_torch.configs import cifar10_densenet_mu0_01_K0 as cfg
    from optwboundeigenval_tpu_torch.data.loaders import ArrayLoader
    from optwboundeigenval_tpu_torch.ops import pallas_kernels as pk
    from optwboundeigenval_tpu_torch.train.driver import build_trainer

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    launches, published = 0, {}
    with tempfile.TemporaryDirectory() as tmp:
        for i, (label, overrides) in enumerate((("recipe", {}),
                                                ("recipe remat=False", {"remat": False}))):
            opts = cfg.options(max_iter=1, device=device, log_dir=f"{tmp}/{i}/logs",
                               model_dir=f"{tmp}/{i}/models", **overrides)
            if opts["remat"] != (not overrides) or opts["train_loader"].augment is None:
                fail(f"{label}: the recipe lost augment or remat")
            bs, hook = opts["batch_size"], _TimedHook(opts["train_loader"].augment)
            cut = lambda ld, **kw: ArrayLoader(ld.x[:rows], ld.y[:rows], bs, **kw)
            opts["train_loader"] = cut(opts["train_loader"], shuffle=True, seed=1226,
                                       augment=hook)
            opts["valid_loader"] = cut(opts["valid_loader"])
            opts["train_loader_na"] = cut(opts["train_loader_na"])
            opts["test_loader"] = [cut(opts["test_loader"][0])]
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            trainer, batch, n = run_epochs(f"cifar10_densenet_mu0_01_K0 {label}", opts,
                                           device, 1)
            launches += n
            mem = torch.cuda.max_memory_allocated() if cuda else "not measured"
            if not overrides:  # beside phase 16's run of the recipe with the knobs on
                t = trainer.timers.totals
                published.update(s_epoch=t["Iteration"], pow=trainer.mean_pow_iters,
                                  steps_s=len(trainer.epoch_pow_iters) / t["G"], peak=mem)
            log(f"{label}: remat {trainer.remat}, augment {1e3 * hook.seconds / hook.calls:.3f} "
                f"host ms per batch ({hook.calls} batches of {bs}), "
                f"pow_iters per step {trainer.epoch_pow_iters}, max_memory_allocated {mem} B")
            if trainer.remat != (not overrides) or hook.calls == 0:
                fail(f"{label}: remat {trainer.remat}, augmented {hook.calls} batches")
            if cuda:
                phase_profile(trainer, batch, f"cifar10_densenet_mu0_01_K0 {label}")
    if cuda:
        remat_memory("cifar10_densenet_mu0_01_K0", lambda remat: build_trainer(
            cfg.options(device=device, remat=remat, augment=False,
                        max_pow_iter=F64_POW_ITERS)),
            next(iter(cfg.options(device="cpu", augment=False)["train_loader_na"])))

    # float64 from one state: remat on and off on the card, remat on the CPU,
    # on F64_ROWS rows
    batch = next(iter(cfg.options(device="cpu", batch_size=F64_ROWS)["train_loader_na"]))
    steps = {}
    for label, dev, remat in (("card remat", device, True), ("card no remat", device, False),
                              ("cpu remat", "cpu", True)):
        tr = _as_f64(build_trainer(cfg.options(device=dev, remat=remat, batch_size=F64_ROWS)))
        p0 = {k: t.clone() for k, t in tr.params.items()}
        sync()
        t0 = time.perf_counter()
        m = tr.train_step(batch)
        sync()
        steps[label] = (m, {k: tr.params[k] - p0[k] for k in p0}, tr.model_state)
        log(f"float64 step, {label}: rho {m['rho']:.15g} pow_iters {m['pow_iters']} "
            f"g {m['g']:.15g} gradf_norm {m['gradf_norm']:.15g} gradg_norm "
            f"{m['gradg_norm']:.15g}, {time.perf_counter() - t0:.2f} s")
    ref_m, ref_d, ref_s = steps["card remat"]
    for label in ("card no remat", "cpu remat"):
        m, d, st = steps[label]
        errs = {k: abs(m[k] - ref_m[k]) / abs(ref_m[k])
                for k in ("rho", "g", "gradf_norm", "gradg_norm")}
        errs["update"], errs["bn_stats"] = _rel(d, ref_d), _rel(st, ref_s)
        worst = max(errs.values())
        log(f"float64 step, {label} vs card remat: pow_iters {m['pow_iters']} vs "
            f"{ref_m['pow_iters']}, relative errors "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + f" (bound {CARD_F64_RTOL:g})")
        if m["pow_iters"] != ref_m["pow_iters"] or not worst < CARD_F64_RTOL:
            fail(f"float64 step: {label} and the card's remat step disagree")

    # path (b): remat composed with K1
    opts = cfg.options(hvp_micro=2, device=device)
    tr = build_trainer(opts)
    batches = iter(opts["train_loader"])
    pk.axpy_accumulate.launches = 0
    for i in range(REMAT_MICRO_STEPS):
        before = pk.axpy_accumulate.launches
        sync()
        t0 = time.perf_counter()
        m = tr.train_step(next(batches))
        sync()
        launched = pk.axpy_accumulate.launches - before
        want = tr.hvp_micro * (m["pow_iters"] + 2)
        log(f"remat hvp_micro=2 step {i}: rho {m['rho']:.6g} pow_iters {m['pow_iters']} "
            f"g {m['g']:.6g} step_ms {1e3 * (time.perf_counter() - t0):.1f} "
            f"K1_launches {launched} (expected {want})")
        if not (tr.remat and m["step_ok"] and math.isfinite(m["rho"])):
            fail(f"remat hvp_micro=2 step {i}: {m}")
        if cuda and launched != want:
            fail(f"remat hvp_micro=2 step {i}: {launched} K1 launches, expected {want}")
    return launches + pk.axpy_accumulate.launches, published


# the epochs of phases 7, 11 and 12 on the first rows of the train set
# (Forest 12,800, USPS 6,250 before the time budget)
TRAIN_ROWS = {"forest": 3200, "usps": 2048}
# phase 11's subspace sweeps at most (200, which the batches reached, before
# the time budget)
SPECTRUM_SWEEPS = 50


def phase_eigensolvers(power_hvps, device="cuda"):
    """Phase 11: the Lanczos solvers and ``rand_init`` through
    ``driver.run`` for one epoch on ``TRAIN_ROWS`` train rows, float64
    Lanczos on the card vs the CPU, the two audits,
    and the curvature products' two forms.  ``power_hvps`` maps a config
    name to phase 7's mean HVPs per step.  Returns K1's launches."""
    from optwboundeigenval_tpu_torch.configs import forest_best, usps_cnn_mu0_01_K0
    from optwboundeigenval_tpu_torch.data.loaders import ArrayLoader

    launches, usps_trainer = 0, None
    with tempfile.TemporaryDirectory() as tmp:
        for i, (name, mod, kw, want) in enumerate((
                ("forest_best", forest_best, {"eigensolver": "power"}, "power"),
                ("forest_best", forest_best, {"eigensolver": "auto"}, "lanczos_adaptive"),
                ("usps_cnn_mu0_01_K0", usps_cnn_mu0_01_K0, {"eigensolver": "power"}, "power"),
                ("usps_cnn_mu0_01_K0", usps_cnn_mu0_01_K0, {"eigensolver": "auto"},
                 "lanczos_adaptive"),
                ("usps_cnn_mu0_01_K0", usps_cnn_mu0_01_K0, {"eigensolver": "lanczos"},
                 "lanczos"),
                ("usps_cnn_mu0_01_K0", usps_cnn_mu0_01_K0, {"rand_init": True}, "power"))):
            label = f"{name} " + ", ".join(f"{k}={v}" for k, v in kw.items())
            opts = _train_rows(mod.options(max_iter=1, device=device,
                                           log_dir=f"{tmp}/{i}/logs",
                                           model_dir=f"{tmp}/{i}/models", **kw),
                               TRAIN_ROWS[name.split("_")[0]])
            tr, b, n = run_epochs(label, opts, device, 1)
            launches += n
            if device == "cuda":
                phase_profile(tr, b, label)
            log(f"{label}: solver {tr.eigensolver} (lanczos_m {tr.lanczos_m}), mean HVPs "
                f"per step {tr.mean_pow_iters:.2f}; power iteration in phase 7: "
                f"{power_hvps.get(name, float('nan')):.2f}")
            if tr.eigensolver != want:
                fail(f"{label}: resolved to {tr.eigensolver}, expected {want}")
            if i == 3:
                usps_trainer = tr

        # the audits on 4 batches of USPS, at the auto trainer's weights
        ld = usps_cnn_mu0_01_K0.options(device="cpu")["train_loader_na"]
        four = ArrayLoader(ld.x[:512], ld.y[:512], 128)
        t0 = time.perf_counter()
        means = usps_trainer.rho_test_fused(loader=four)
        log(f"rho_test_fused over 4 USPS batches ({usps_trainer.eigensolver}): means rho "
            f"{means[0]:.6g} norm {means[1]:.6g} iters {means[2]:.2f} res_change "
            f"{means[3]:.6g} seconds {means[4]:.4f}; {time.perf_counter() - t0:.2f} s")
        if not np.isfinite(means).all():
            fail("rho_test_fused: values not finite")
        for method in ("subspace", "lanczos"):
            t0 = time.perf_counter()
            rows = usps_trainer.spectrum_test(loader=four, k=4, method=method,
                                              max_iter=SPECTRUM_SWEEPS)
            log(f"spectrum_test {method} k=4 over 4 USPS batches: {time.perf_counter() - t0:.2f} s;"
                f" eigenvalues of batch 0 {rows[0, :4].tolist()}, residuals "
                f"{rows[0, 4:8].tolist()}, sweeps or HVPs {rows[:, 8].tolist()}")
            if rows.shape != (4, 9) or not np.isfinite(rows).all():
                fail(f"spectrum_test {method}: rows {rows.shape} not finite")

    _lanczos_card_vs_cpu(device)
    _curvature_forms(device)
    return launches


def _lanczos_card_vs_cpu(device):
    """Float64 Lanczos ``rho`` at one USPS batch: the card against the CPU."""
    from optwboundeigenval_tpu_torch.configs import usps_cnn_mu0_01_K0
    from optwboundeigenval_tpu_torch.ops import curvature, eigen
    from optwboundeigenval_tpu_torch.train.task import Task
    from optwboundeigenval_tpu_torch.utils.tree import tree_uniform_like

    model, _, batch = _first_batch(usps_cnn_mu0_01_K0, 128)
    task = Task(model=model)
    p32, _ = task.init(torch.Generator().manual_seed(1226), torch.device("cpu"))
    out = {}
    for dev in (device, "cpu"):
        p = {k: t.to(dev, torch.float64) for k, t in p32.items()}
        b = {k: torch.as_tensor(a).to(dev) for k, a in batch.items()}
        _, hvp_fn = curvature.linearize_hvp(task.loss_fn({}), p, b)
        for method in ("lanczos", "lanczos_adaptive"):
            out[dev, method] = eigen.estimate_dominant_eig(
                hvp_fn, tree_uniform_like(p), eps=1e-3, method=method, lanczos_m=16)
    for method in ("lanczos", "lanczos_adaptive"):
        card, cpu = out[device, method], out["cpu", method]
        rel = abs(float(card.rho) - float(cpu.rho)) / abs(float(cpu.rho))
        log(f"float64 {method} rho at one USPS batch: card {float(card.rho):.15g} "
            f"({card.iters} HVPs, converged {card.converged}), cpu {float(cpu.rho):.15g} "
            f"({cpu.iters}, {cpu.converged}), relative error {rel:.3e} (bound {CARD_F64_RTOL:g})")
        if not (rel < CARD_F64_RTOL and card.iters == cpu.iters
                and card.converged == cpu.converged):
            fail(f"float64 {method}: the card and the CPU disagree")


def _func_hvp(loss, p, b, v):
    """``H v`` by ``torch.func`` forward over reverse, for comparison."""
    from torch.func import grad, jvp

    return jvp(lambda q: grad(loss)(q, b), (p,), (v,))[1]


def _func_vghv(loss, p, b, v):
    """``v^T (grad H) v`` by ``torch.func``, for comparison."""
    from torch.func import grad

    from optwboundeigenval_tpu_torch.utils.tree import tree_vdot

    return grad(lambda q: tree_vdot(_func_hvp(loss, q, b, v), v))(p)


def _curvature_forms(device, reps=5):
    """The port's plain-autograd HVP and vGHv against ``torch.func`` forms of
    them on the three models: float64 agreement on the card, and float32
    times on the card (CUDA events)."""
    from optwboundeigenval_tpu_torch.configs import (
        cifar10_densenet_mu0_01_K0, forest_best, usps_cnn_mu0_01_K0)
    from optwboundeigenval_tpu_torch.ops import curvature
    from optwboundeigenval_tpu_torch.train.task import Task

    forms = {"hvp": (curvature.hvp, _func_hvp), "vghv": (curvature.vghv, _func_vghv)}
    cases = (("ForestNet b128", forest_best, 128, {}),
             ("CNNUSPS b128", usps_cnn_mu0_01_K0, 128, {}),
             ("DenseNet-40 b32", cifar10_densenet_mu0_01_K0, 32, {"augment": False}))
    for label, mod, rows, kw in cases:
        model, bn, batch = _first_batch(mod, rows, **kw)
        task = Task(model=model, has_batch_stats=bn)
        p32, s32 = task.init(torch.Generator().manual_seed(1226), torch.device("cpu"))
        rng = np.random.default_rng(1226)
        v = {k: torch.from_numpy(rng.normal(size=tuple(t.shape))) for k, t in p32.items()}
        times = []
        for dtype in (torch.float64, torch.float32):
            to = lambda tree: {k: t.to(device, dtype) if t.is_floating_point() else t.to(device)
                               for k, t in tree.items()}
            p, s, vd = to(p32), to(s32), to(v)
            b = {k: torch.as_tensor(a).to(device) for k, a in batch.items()}
            loss = task.loss_fn(s)
            if dtype == torch.float64:
                for name, (port, func) in forms.items():
                    rel = _rel(port(loss, p, b, vd), func(loss, p, b, vd))
                    log(f"curvature forms {label} float64 {name}: autograd vs torch.func "
                        f"{rel:.3e} (bound {CARD_F64_RTOL:g})")
                    if not rel < CARD_F64_RTOL:
                        fail(f"curvature forms {label} {name}: the forms disagree")
                continue
            t = {f"{name} {form}": cuda_time_ms(lambda fn=fn: fn(loss, p, b, vd),
                                                reps if name == "hvp" else 5, 2)
                 for name, pair in forms.items()
                 for form, fn in zip(("autograd", "func"), pair)}
            times.append(", ".join(f"{k} {ms:.3f} ms" for k, ms in t.items()))
        log(f"curvature forms {label} float32 on the card (wall, CUDA events): "
            + "; ".join(times))


# the ten comparator configs of phase 12; Asymmetric Valley cut to 4 epochs
# with SWA from epoch 2, the SGD hunt from epoch 3 and a 9-point sweep
AV_SMALL = dict(max_iter=4, swa_start=2, sgd_start=3, save_freq=1, eval_freq=1,
                distances=2, division_part=4)
COMPARATORS = ("forest_lobpcg", "usps_cnn_lobpcg", "forest_kfac", "usps_cnn_kfac",
               "forest_sam", "usps_cnn_sam", "forest_entropy_sgd", "usps_cnn_entropy_sgd",
               "forest_asymmetric_valley", "usps_cnn_asymmetric_valley")


def _factors(trainer, fields=("m_aa", "m_gg", "Q_a", "d_a", "Q_g", "d_g")):
    """The K-FAC factor tensors a trainer holds (LOBPCG's preconditioner,
    the K-FAC optimizer's state), the ``fields`` of each layer."""
    trees = [trainer._precond_state, trainer.opt_state.get("factors")]
    return [f[k] for tree in trees if tree for f in tree.values() for k in fields]


def run_comparator(name, device="cuda", tmp="."):
    """``driver.run`` of the config ``name`` for one epoch (Asymmetric
    Valley: ``AV_SMALL``) on the first ``TRAIN_ROWS`` rows of its synthetic
    stand-in (the whole of it before the time budget), K1's count set
    to 0 just before and read just after; prints s/epoch, steps/s, mean
    ``pow_iters`` and the busy share of one profiled step, and fails on
    a non-finite log row or test line, or a parameter or factor off the
    card.  Returns K1's launches."""
    import importlib

    from optwboundeigenval_tpu_torch.ops import pallas_kernels as pk
    from optwboundeigenval_tpu_torch.train import driver

    av = name.endswith("asymmetric_valley")
    mod = importlib.import_module(f"optwboundeigenval_tpu_torch.configs.{name}")
    over = dict(AV_SMALL, plot_dir=f"{tmp}/{name}/plots") if av else dict(max_iter=1)
    opts = _train_rows(mod.options(device=device, log_dir=f"{tmp}/{name}/logs",
                                   model_dir=f"{tmp}/{name}/models", **over),
                       TRAIN_ROWS[name.split("_")[0]])
    epochs = opts["max_iter"]
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    pk.axpy_accumulate.launches = 0
    sync()
    t0 = time.perf_counter()
    trainer = driver.run(opts)
    sync()
    wall = time.perf_counter() - t0
    launches = pk.axpy_accumulate.launches
    with open(trainer.log_file) as fh:
        lines = fh.read().splitlines()
    rows = [ln for ln in lines[1:] if ln[:1].isdigit()]
    tests = [ln for ln in lines if ln.split(":")[0].endswith(("Loss", "Accuracy", "F1"))]
    t = trainer.timers.totals
    steps = trainer.steps_done if av else len(trainer.epoch_pow_iters)
    per_epoch = wall / epochs if av else t["Iteration"]
    iters = (f"mean pow_iters {trainer.mean_pow_iters:.2f}" if trainer.pow_iter and not av
             else "no power iteration")
    train_loader = driver._loaders(opts, trainer.batch_size)[0]
    data = next(iter(train_loader))
    step = (lambda: trainer.train_epoch([data])) if av else None
    prof = (phase_profile(trainer, trainer.put_batch(data), f"{name}", step)
            if device == "cuda" else None)
    busy = None if prof is None else prof[1] / prof[0]
    log(f"{name}: {trainer.ndim} parameters, {trainer.optimizer.name}, {steps} steps in "
        f"{epochs} epochs, driver.run {wall:.1f} s, {per_epoch:.2f} s/epoch, "
        f"{steps / t['G']:.2f} steps/s, {iters}, busy share of one profiled step "
        + ("not measured" if busy is None else f"{100 * busy:.1f}%")
        + f"; K1 launches {launches}")
    if av:
        log(f"{name}: swa_n {trainer.swa_n}, the hunt found an SGD point: "
            f"{trainer.sgd_path is not None}, the interpolation ran: {trainer.interpolated}")
        if trainer.swa_n < 1:
            fail(f"{name}: no SWA averaging in {epochs} epochs")
        if not trainer.interpolated:
            # the hunt's test failed on this data: sweep from the last SGD
            # weights instead, so the interpolation runs on the card
            valid_loader = driver._loaders(opts, trainer.batch_size)[1]
            trainer.sgd_path = trainer._save_full("sgd_last")
            t1 = time.perf_counter()
            trainer.interpolation(train_loader, valid_loader)
            sync()
            res = np.loadtxt(os.path.join(trainer.log_dir,
                                          "asymmetric_valley_test_acc_results.txt"))
            log(f"{name}: the interpolation from the last SGD weights: {len(res)} points in "
                f"{time.perf_counter() - t1:.2f} s, valid accuracy {res.tolist()}")
            if not (trainer.interpolated and np.isfinite(res).all()):
                fail(f"{name}: the interpolation did not run or is not finite")
    if trainer.lobpcg:
        log(f"{name}: {len(trainer._precond_state)} factored layers, refit counter "
            f"{trainer._kfac_iter} of {trainer.kfac_batch}")
    for ln in rows + tests:
        log(f"  {ln}")
    if len(rows) != epochs or not all(_finite_floats(r) for r in rows):
        fail(f"{name}: the log holds {len(rows)} rows, expected {epochs} finite ones")
    if len(tests) < 6 or not all(math.isfinite(float(ln.split(":")[1])) for ln in tests):
        fail(f"{name}: the train and test lines are missing or not finite")
    tensors = list(trainer.params.values()) + _factors(trainer)
    if trainer.optimizer.needs_stats or trainer.lobpcg:
        if not _factors(trainer):
            fail(f"{name}: no K-FAC factors")
    if device == "cuda" and not all(x.is_cuda for x in tensors):
        fail(f"{name}: a parameter or factor is not on the card")
    return launches


def kfac_times(device="cuda", reps=2):
    """One K-FAC refresh (capture, EMA from identity, the ``eigh``s) and one
    preconditioner apply on the card for Forest, USPS (batch 128) and
    DenseNet-40 (batch 32), float32, CUDA events; beside them the capture
    and the ``eigh``s alone, and the ``eigh``s on the host."""
    from optwboundeigenval_tpu_torch.configs import (
        cifar10_densenet_mu0_01_K0, forest_best, usps_cnn_mu0_01_K0)
    from optwboundeigenval_tpu_torch.ops import kfac
    from optwboundeigenval_tpu_torch.train.task import Task

    out = {}
    for label, mod, rows, kw in (("ForestNet b128", forest_best, 128, {}),
                                 ("CNNUSPS b128", usps_cnn_mu0_01_K0, 128, {}),
                                 ("DenseNet-40 b32", cifar10_densenet_mu0_01_K0, 32,
                                  {"augment": False})):
        model, bn, batch = _first_batch(mod, rows, **kw)
        task = Task(model=model, has_batch_stats=bn)
        p, s = task.init(torch.Generator().manual_seed(1226), torch.device(device))
        b = {k: torch.as_tensor(a).to(device) for k, a in batch.items()}
        f = kfac.fit_factors(task, p, s, b, sample_targets=False)
        sizes = sorted((v["m_aa"].shape[0], v["m_gg"].shape[0]) for v in f.values())
        rng = np.random.default_rng(1226)
        r = {k: torch.from_numpy(rng.normal(size=tuple(t.shape))).to(device, t.dtype)
             for k, t in p.items()}
        refresh = cuda_time_ms(lambda: kfac.fit_factors(task, p, s, b, sample_targets=False),
                               reps, 1)
        capture = cuda_time_ms(lambda: kfac.capture(task, p, s, b), reps, 1)
        eigh = cuda_time_ms(lambda: kfac.compute_inverses(f), reps, 1)
        apply = cuda_time_ms(lambda: kfac.precond_apply(f, r), 20)
        f_cpu = {n: {k: t.cpu() for k, t in v.items()} for n, v in f.items()}
        t0 = time.perf_counter()
        for _ in range(reps):
            kfac.compute_inverses(f_cpu)
        eigh_host = 1e3 * (time.perf_counter() - t0) / reps
        log(f"kfac {label}: {len(f)} factored layers (A, G sizes {sizes[-3:]} largest), "
            f"refresh {refresh:.3f} ms (capture {capture:.3f} ms, eighs {eigh:.3f} ms on the "
            f"card, {eigh_host:.3f} ms on the host), preconditioner apply {apply:.3f} ms "
            f"(wall, CUDA events)")
        out[label] = dict(refresh_ms=refresh, capture_ms=capture, eigh_ms=eigh,
                          eigh_host_ms=eigh_host, apply_ms=apply, layers=len(f))
    return out


def comparators_card_vs_cpu(device="cuda"):
    """Float64 on the card against the CPU: one ``usps_cnn_lobpcg``
    ``train_step`` (its first refit included), one K-FAC step on a ``TCov``
    and ``TInv`` boundary, one SAM step and one Entropy-SGD step with its
    noise given; each within ``CARD_F64_RTOL``."""
    from optwboundeigenval_tpu_torch.configs import (
        usps_cnn_entropy_sgd, usps_cnn_kfac, usps_cnn_lobpcg, usps_cnn_sam)
    from optwboundeigenval_tpu_torch.ops import curvature
    from optwboundeigenval_tpu_torch.train.driver import build_trainer

    batch = next(iter(usps_cnn_lobpcg.options(device="cpu")["train_loader_na"]))
    rng = np.random.default_rng(1226)
    for name, mod in (("usps_cnn_lobpcg", usps_cnn_lobpcg), ("usps_cnn_kfac", usps_cnn_kfac),
                      ("usps_cnn_sam", usps_cnn_sam),
                      ("usps_cnn_entropy_sgd", usps_cnn_entropy_sgd)):
        noise = None
        res = {}
        for dev in (device, "cpu"):
            tr = _as_f64(build_trainer(mod.options(device=dev)))
            p0 = {k: t.clone() for k, t in tr.params.items()}
            if name.endswith("entropy_sgd"):
                if noise is None:
                    noise = [{k: torch.from_numpy(rng.normal(size=tuple(t.shape)))
                              for k, t in p0.items()} for _ in range(5)]
                b = tr.put_batch(batch)
                loss_fn = tr._loss_fn(tr.model_state)
                _, g = curvature.value_and_grad(loss_fn, tr.params, b)
                kw = tr._opt_kwargs(loss_fn, tr.model_state, b)
                tr.params, tr.opt_state = tr.optimizer.step(
                    g, tr.opt_state, tr.params, noise=[{k: z.to(dev) for k, z in n.items()}
                                                       for n in noise], **kw)
                m = {"merr": float(tr.opt_state["merr"]), "mf": float(tr.opt_state["mf"])}
            else:
                m = tr.train_step(batch)
            # the running factors: eigh's eigenvectors differ between
            # cuSOLVER and LAPACK in signs and in degenerate eigenspaces
            fac = _factors(tr, ("m_aa", "m_gg"))
            res[dev] = (m, {k: tr.params[k] - p0[k] for k in p0}, fac)
        (mc, dc, fc), (mh, dh, fh) = res[device], res["cpu"]
        keys = [k for k in ("rho", "g", "gradf_norm", "gradg_norm", "mf") if k in mc
                and mh[k] != 0]
        errs = {k: abs(mc[k] - mh[k]) / abs(mh[k]) for k in keys}
        errs["update"] = _rel(dc, dh)
        if fh:
            errs["factors"] = max(_rel(a, b) for a, b in zip(fc, fh))
        worst = max(errs.values())
        log(f"float64 {name} step, card vs cpu: relative errors "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + f" (bound {CARD_F64_RTOL:g})")
        if not worst < CARD_F64_RTOL or mc.get("pow_iters") != mh.get("pow_iters"):
            fail(f"float64 {name}: the card and the CPU disagree")


def densenet_lobpcg_step(device="cuda"):
    """One ``cifar10_densenet_mu0_01_K0`` step under LOBPCG with
    ``hvp_micro=2``: K-FAC over all 40 conv and dense layers, and K1
    launching ``2 * (pow_iters + 2)`` times.  Returns K1's launches."""
    from optwboundeigenval_tpu_torch.configs import cifar10_densenet_mu0_01_K0 as cfg
    from optwboundeigenval_tpu_torch.ops import pallas_kernels as pk
    from optwboundeigenval_tpu_torch.train.driver import build_trainer

    opts = cfg.options(lobpcg=True, kfac_batch=8, kfac_rand=False, hvp_micro=2, remat=False,
                       augment=False, device=device)
    tr = build_trainer(opts)
    batch = next(iter(opts["train_loader"]))
    tr.init_state()
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    pk.axpy_accumulate.launches = 0
    sync()
    t0 = time.perf_counter()
    m = tr.train_step(batch)
    sync()
    ms = 1e3 * (time.perf_counter() - t0)
    launches = pk.axpy_accumulate.launches
    want = tr.hvp_micro * (m["pow_iters"] + 2)
    log(f"densenet40 lobpcg step: rho {m['rho']:.6g} pow_iters {m['pow_iters']} g {m['g']:.6g} "
        f"step_ms {ms:.1f} (the first refit included), {len(tr._precond_state)} factored "
        f"layers, K1 launches {launches} (expected {want})")
    if not (m["step_ok"] and math.isfinite(m["rho"])):
        fail(f"densenet40 lobpcg step: {m}")
    if len(tr._precond_state) != 40:
        fail(f"densenet40 lobpcg: {len(tr._precond_state)} factored layers, expected 40")
    if device == "cuda" and launches != want:
        fail(f"densenet40 lobpcg step: {launches} K1 launches, expected {want}")
    # the Asymmetric Valley's bn_update where there is BatchNorm: 4 batches
    from optwboundeigenval_tpu_torch.data.loaders import ArrayLoader
    from optwboundeigenval_tpu_torch.train.asymmetric_valley import bn_update

    ld = opts["train_loader"]
    sync()
    t0 = time.perf_counter()
    stats = bn_update(tr.task, tr.params, tr.model_state,
                      ArrayLoader(ld.x[:128], ld.y[:128], 32), tr.put_batch)
    sync()
    moved = sum(not torch.equal(stats[k], t) for k, t in tr.model_state.items())
    log(f"densenet40 bn_update over 4 batches: {1e3 * (time.perf_counter() - t0):.1f} ms, "
        f"{moved} of {len(stats)} statistics recomputed")
    if moved != len(stats) or not all(bool(torch.isfinite(t).all()) and t.is_cuda == (
            device == "cuda") for t in stats.values()):
        fail("densenet40 bn_update: statistics not recomputed, not finite or off the card")
    return launches


def phase_comparators(device="cuda"):
    """Phase 12: the ten comparator configs through ``driver.run``, the
    K-FAC refresh and apply times, float64 card vs CPU, and the DenseNet-40
    LOBPCG step through K1.  Returns K1's launches."""
    launches = 0
    t0 = time.perf_counter()
    lap = lambda what: log(f"phase 12: {what} done, {time.perf_counter() - t0:.1f} s in")
    with tempfile.TemporaryDirectory() as tmp:
        for name in COMPARATORS:
            launches += run_comparator(name, device, tmp)
            lap(name)
    if device == "cuda":
        kfac_times(device)
        lap("kfac times")
    comparators_card_vs_cpu(device)
    lap("float64 card vs cpu")
    launches += densenet_lobpcg_step(device)
    lap("densenet40 lobpcg step")
    return launches


CXR_PX = 224  # the published input width of the chest x-ray recipes
# train, valid and each test set: 1 step at batch 4 (8 train rows, 2 steps,
# before the time budget)
CXR_ROWS = (4, 8, 8)


def cxr_loaders(rows=CXR_ROWS, px=CXR_PX, batch=4):
    """The chest x-ray stand-ins at ``px`` from ``make_multilabel``, as
    loader overrides: NIH train, valid and test (14 classes), and the
    CheXpert and MIMIC test sets (13 classes, 10% NaN labels), each with
    the ``class_to_idx`` and ``name`` that ``comp_test`` reads."""
    from optwboundeigenval_tpu_torch.data import chestxray as cxr
    from optwboundeigenval_tpu_torch.data.loaders import ArrayLoader
    from optwboundeigenval_tpu_torch.data.synthetic import make_multilabel

    def make(classes, n, data_seed, nan_frac, name, **kw):
        x, y = make_multilabel(n, shape=(px, px, 3), n_classes=len(classes), seed=data_seed,
                               nan_frac=nan_frac)
        ld = ArrayLoader(x, y, batch, **kw)
        ld.class_to_idx, ld.name = classes, name
        return ld

    n_train, n_valid, n_test = rows
    return dict(
        train_loader=make(cxr.NIH_CLASSES, n_train, 11, 0.0, "NIH", shuffle=True, seed=1226),
        valid_loader=make(cxr.NIH_CLASSES, n_valid, 12, 0.0, "NIH"),
        test_loader=[make(cxr.NIH_CLASSES, n_test, 13, 0.0, "NIH"),
                     make(cxr.CHEXPERT_CLASSES, n_test, 22, 0.1, "CheXpert"),
                     make(cxr.MIMIC_CLASSES, n_test, 32, 0.1, "MIMIC")])


def _steps(label, trainer, loader, n, device):
    """``n`` ``train_step``s over ``loader``; each must be finite.  Returns
    the last step's metrics and the step times in ms."""
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    batches, times, m = iter(loader), [], None
    for i in range(n):
        batch = next(batches)
        sync()
        t0 = time.perf_counter()
        m = trainer.train_step(batch)
        sync()
        times.append(1e3 * (time.perf_counter() - t0))
        log(f"{label} step {i}: rho {m['rho']:.6g} pow_iters {m['pow_iters']} g {m['g']:.6g} "
            f"gradf_norm {m['gradf_norm']:.6g} gradg_norm {m['gradg_norm']:.6g} "
            f"step_ms {times[-1]:.1f}")
        if not (m["step_ok"] and all(math.isfinite(m[k]) for k in ("rho", "g", "gradf_norm"))):
            fail(f"{label} step {i}: {m}")
    return m, times


def cxr_main_runs(device="cuda", rows=CXR_ROWS, px=CXR_PX):
    """``chestxray_mu0_01_K0`` (``CXRModel(densenet121)``, batch 4, the
    recipe's ``remat``) for one epoch through ``driver.run`` with no other
    override but ``max_iter=1`` and the loaders, ``comp_test`` over the
    three test sets; then the same epoch with ``remat=False``.  Prints
    each run's s/epoch, steps/s, mean ``pow_iters``, the busy share of a
    profiled step, the peak device memory and the per-dataset AUC;
    then :func:`remat_memory` of one step.  Returns K1's launches (none:
    no micro-batching)."""
    from optwboundeigenval_tpu_torch.configs import chestxray_mu0_01_K0 as cfg
    from optwboundeigenval_tpu_torch.train.driver import build_trainer

    cuda = device == "cuda"
    launches, peaks = 0, {}
    with tempfile.TemporaryDirectory() as tmp:
        for i, (label, overrides) in enumerate((("chestxray_mu0_01_K0", {}),
                                                ("chestxray_mu0_01_K0 remat=False",
                                                 {"remat": False}))):
            opts = cfg.options(max_iter=1, device=device, log_dir=f"{tmp}/{i}/logs",
                               model_dir=f"{tmp}/{i}/models", **overrides,
                               **cxr_loaders(rows, px))
            if (opts["remat"] != (not overrides) or opts["test"] or not opts["comp_test"]
                    or opts["batch_size"] != 4 or opts["model"].backbone != "densenet121"):
                fail(f"{label}: the recipe lost remat, comp_test, batch 4 or its trunk")
            if cuda:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            trainer, batch, n = run_epochs(label, opts, device, 1)
            launches += n
            peaks[label] = torch.cuda.max_memory_allocated() if cuda else None
            with open(trainer.log_file) as fh:
                lines = fh.read().splitlines()
            auc = {ln.split()[2]: float(ln.split(":")[1]) for ln in lines
                   if ln.startswith("Comp Test") and ln.split(":")[0].endswith("Accuracy")}
            shared = [ln for ln in lines if ln.startswith("['")]
            log(f"{label}: {trainer.ndim} parameters ({trainer.task.model.backbone} trunk "
                f"{sum(p.numel() for p in trainer.task.model.features.parameters())}, transit "
                f"conv {trainer.params['head.transit_conv.weight'].numel() + 1024}), remat "
                f"{trainer.remat}, pow_iters per step {trainer.epoch_pow_iters}, "
                f"max_memory_allocated {peaks[label]} B, comp_test AUC {auc}, shared "
                f"classes {shared}")
            if sorted(auc) != ["CheXpert", "MIMIC", "NIH"] or len(shared) != 1:
                fail(f"{label}: comp_test did not run over the three sets with their overlap")
            if not all(math.isfinite(a) for a in auc.values()):
                fail(f"{label}: a comp_test AUC is not finite")
            if cuda:
                phase_profile(trainer, batch, label)
    if cuda:
        on, off = peaks["chestxray_mu0_01_K0"], peaks["chestxray_mu0_01_K0 remat=False"]
        log(f"chestxray peak memory of the epoch: remat {on} B, no remat {off} B "
            f"({on / off:.3f}x)")
        remat_memory("chestxray_mu0_01_K0", lambda remat: build_trainer(
            cfg.options(device=device, remat=remat, max_pow_iter=F64_POW_ITERS)),
            next(iter(opts["train_loader"])))
    return launches


def cxr_best_reg(device="cuda", px=CXR_PX):
    """One step of ``chestxray_best_reg`` (2 before the time budget):
    ``eigensolver='auto'`` must resolve to the early-exit Lanczos solver
    under ``rand_init``."""
    from optwboundeigenval_tpu_torch.configs import chestxray_best_reg
    from optwboundeigenval_tpu_torch.train.driver import build_trainer

    opts = chestxray_best_reg.options(device=device, **cxr_loaders((8, 4, 4), px))
    tr = build_trainer(opts)
    log(f"chestxray_best_reg: eigensolver {tr.eigensolver} (lanczos_m {tr.lanczos_m}), "
        f"rand_init {tr.rand_init}, gradg_clip {tr.gradg_clip}, remat {tr.remat}")
    if tr.eigensolver != "lanczos_adaptive" or not tr.rand_init:
        fail(f"chestxray_best_reg: 'auto' resolved to {tr.eigensolver}")
    _steps("chestxray_best_reg", tr, opts["train_loader"], 1, device)


def cxr_kfac(device="cuda", px=CXR_PX, reps=1, host_max=512):
    """One K-FAC refresh on ``CXRModel(densenet121)`` (``chestxray_best_lobpcg``)
    timed whole and by part: the capture, the ``eigh``s on the card (the
    transit conv's 9,217-wide ``A`` alone too) and the preconditioner
    apply; the ``eigh``s of the factors up to ``host_max`` wide on the
    host."""
    from optwboundeigenval_tpu_torch.configs import chestxray_best_lobpcg
    from optwboundeigenval_tpu_torch.ops import kfac
    from optwboundeigenval_tpu_torch.train.driver import build_trainer

    opts = chestxray_best_lobpcg.options(device=device, **cxr_loaders((8, 4, 4), px))
    tr = build_trainer(opts)
    tr.init_state()
    task, p, s = tr.task, tr.params, tr.model_state
    b = tr.put_batch(next(iter(opts["train_loader"])))
    f = kfac.fit_factors(task, p, s, b, sample_targets=False)
    width = lambda v: max(v["m_aa"].shape[0], v["m_gg"].shape[0])
    transit = f["head.transit_conv"]
    rng = np.random.default_rng(1226)
    r = {k: torch.from_numpy(rng.normal(size=tuple(t.shape))).to(device, t.dtype)
         for k, t in p.items()}
    timer = cuda_time_ms if device == "cuda" else host_ms
    refresh = timer(lambda: kfac.fit_factors(task, p, s, b, sample_targets=False), reps, 1)
    capture = timer(lambda: kfac.capture(task, p, s, b), reps, 1)
    eigh = timer(lambda: kfac.compute_inverses(f), reps, 1)
    eigh_transit = timer(lambda: kfac.compute_inverses({"t": transit}), reps, 1)
    apply = timer(lambda: kfac.precond_apply(f, r), 5)
    small = {n: {k: t.cpu() for k, t in v.items()} for n, v in f.items() if width(v) <= host_max}
    eigh_host = host_ms(lambda: kfac.compute_inverses(small), 1, 0)
    log(f"kfac CXRModel(densenet121) b4 {px} px: {len(f)} factored layers, transit conv A "
        f"{tuple(transit['m_aa'].shape)} G {tuple(transit['m_gg'].shape)}; refresh "
        f"{refresh:.1f} ms (capture {capture:.1f} ms, eighs {eigh:.1f} ms on {device}, of "
        f"which the transit conv's {eigh_transit:.1f} ms), preconditioner apply "
        f"{apply:.2f} ms; eighs of the {len(small)} factors up to {host_max} wide on the "
        f"host {eigh_host:.1f} ms")
    if transit["m_aa"].shape[0] != 1024 * 9 + 1 or len(f) != len(kfac.factored_layers(
            task.model)):
        fail("kfac CXRModel: the transit conv's factor or the layer count is wrong")
    if not all(bool(torch.isfinite(t).all()) for v in f.values() for t in v.values()):
        fail("kfac CXRModel: a factor is not finite")
    return dict(refresh_ms=refresh, capture_ms=capture, eigh_ms=eigh,
                eigh_transit_ms=eigh_transit, apply_ms=apply, eigh_host_ms=eigh_host)


def host_ms(fn, reps, warmup=1):
    """Mean host time of ``fn()`` over ``reps`` calls (perf_counter)."""
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return 1e3 * (time.perf_counter() - t0) / reps


def cxr_k1_step(device="cuda", px=CXR_PX):
    """One ``chestxray_mu0_01_K0`` step with ``hvp_micro=2``: K1 must launch
    ``2 * (pow_iters + 2)`` times over the 16.4 M-parameter tree.  Returns
    K1's launches."""
    from optwboundeigenval_tpu_torch.configs import chestxray_mu0_01_K0 as cfg
    from optwboundeigenval_tpu_torch.ops import pallas_kernels as pk
    from optwboundeigenval_tpu_torch.train.driver import build_trainer

    opts = cfg.options(hvp_micro=2, device=device, max_pow_iter=F64_POW_ITERS,
                       **cxr_loaders((4, 4, 4), px))
    tr = build_trainer(opts)
    tr.init_state()
    pk.axpy_accumulate.launches = 0
    m, _ = _steps("chestxray hvp_micro=2", tr, opts["train_loader"], 1, device)
    launches = pk.axpy_accumulate.launches
    # one accumulate per micro-batch: the gradient, each HVP, and the vGHv
    # pass where the penalty is on
    want = tr.hvp_micro * (m["pow_iters"] + 1 + (m["g"] > 0))
    log(f"chestxray hvp_micro=2: {tr.ndim} parameters in {len(tr.params)} leaves, K1 "
        f"launches {launches} (expected {want})")
    if device == "cuda" and launches != want:
        fail(f"chestxray hvp_micro=2: {launches} K1 launches, expected {want}")
    return launches


def cxr_other_trunks(device="cuda", px=CXR_PX):
    """One full-width step each (2 before the time budget) of
    ``chestxray_mu0_vgg`` (VGG16-BN, 224 px, batch 4) and
    ``cifar100_resnet_mu0`` (the ResNet50 ``CXRModel`` with 100 outputs,
    32 px, the first 32 CIFAR-100 rows at batch 32)."""
    from optwboundeigenval_tpu_torch.configs import chestxray_mu0_vgg, cifar100_resnet_mu0
    from optwboundeigenval_tpu_torch.data.loaders import ArrayLoader
    from optwboundeigenval_tpu_torch.train.driver import build_trainer

    opts = chestxray_mu0_vgg.options(device=device, **cxr_loaders((8, 4, 4), px))
    tr = build_trainer(opts)
    log(f"chestxray_mu0_vgg: {tr.task.model.backbone}, {sum(t.numel() for t in tr.task.model.parameters())} "
        f"parameters, batch {tr.batch_size}")
    _steps("chestxray_mu0_vgg", tr, opts["train_loader"], 1, device)
    opts = cifar100_resnet_mu0.options(device=device, augment=False)
    ld = opts["train_loader"]
    tr = build_trainer(opts)
    log(f"cifar100_resnet_mu0: {tr.task.model.backbone}, "
        f"{sum(t.numel() for t in tr.task.model.parameters())} parameters, batch {tr.batch_size}")
    _steps("cifar100_resnet_mu0", tr, ArrayLoader(ld.x[:32], ld.y[:32], tr.batch_size), 1,
           device)


def cxr_card_vs_cpu(device="cuda", px=64, rows=2):
    """One float64 ``train_step`` of ``chestxray_mu0_01_K0``
    (``CXRModel(densenet121)``, remat) at ``px`` px and batch ``rows`` from
    one state, at most ``F64_POW_ITERS`` HVPs (a cut for time; 8 ran
    before), on the card and with the port on the CPU, within
    ``CARD_F64_RTOL``: the step's metrics, the BatchNorm statistics and
    the step's direction (Adam's first moment).  Not the parameter
    update: Adam's first step divides each coordinate by its own size, so
    the transit conv's bias, whose gradient ahead of BatchNorm is zero,
    moves by +-lr on rounding alone.  And not 32 px: the last dense
    block is then 1 x 1, its BatchNorm sees 2 values per channel, and
    ``rho`` is ~1e19 and ill-conditioned (reversing the batch's rows moves
    it on the CPU alone)."""
    from optwboundeigenval_tpu_torch.configs import chestxray_mu0_01_K0 as cfg
    from optwboundeigenval_tpu_torch.data.synthetic import make_multilabel
    from optwboundeigenval_tpu_torch.train.driver import build_trainer

    x, y = make_multilabel(rows, shape=(px, px, 3), n_classes=14, seed=1226)
    batch = {"x": x, "y": y, "w": np.ones(rows, np.float32)}
    steps = {}
    for dev in (device, "cpu"):
        tr = _as_f64(build_trainer(cfg.options(device=dev, batch_size=rows,
                                               max_pow_iter=F64_POW_ITERS)))
        t0 = time.perf_counter()
        m = tr.train_step(batch)
        steps[dev] = (m, tr.opt_state["mu"], tr.model_state)
        log(f"float64 chestxray step at {px} px, batch {rows}, {dev}: rho {m['rho']:.15g} "
            f"pow_iters {m['pow_iters']} g {m['g']:.15g} gradf_norm {m['gradf_norm']:.15g} "
            f"gradg_norm {m['gradg_norm']:.15g}, {time.perf_counter() - t0:.2f} s")
    (mc, dc, sc), (mh, dh, sh) = steps[device], steps["cpu"]
    errs = {k: abs(mc[k] - mh[k]) / abs(mh[k]) for k in ("rho", "g", "gradf_norm", "gradg_norm")}
    errs["direction"], errs["bn_stats"] = _rel(dc, dh), _rel(sc, sh)
    log("float64 chestxray step, card vs cpu: relative errors "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + f" (bound {CARD_F64_RTOL:g})")
    if mc["pow_iters"] != mh["pow_iters"] or not max(errs.values()) < CARD_F64_RTOL:
        fail("float64 chestxray step: the card and the CPU disagree")
    return errs


def phase_cxr(device="cuda", rows=CXR_ROWS, px=CXR_PX):
    """Phase 13: the chest x-ray workload at the published width.  Returns
    K1's launches."""
    t0 = time.perf_counter()
    lap = lambda what: log(f"phase 13: {what} done, {time.perf_counter() - t0:.1f} s in")
    launches = cxr_main_runs(device, rows, px)
    lap("chestxray_mu0_01_K0 with and without remat")
    cxr_best_reg(device, px)
    lap("chestxray_best_reg")
    cxr_kfac(device, px)
    lap("kfac on CXRModel")
    launches += cxr_k1_step(device, px)
    lap("K1 at CXR scale")
    cxr_other_trunks(device, px)
    lap("VGG16-BN and ResNet50")
    cxr_card_vs_cpu(device)
    lap("float64 card vs cpu")
    return launches


class _Tee(io.StringIO):
    """Standard output kept as well as printed."""

    def write(self, text):
        sys.__stdout__.write(text)
        return super().write(text)


def _sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


def _timed(fn, device):
    """``(fn(), seconds)`` with the device synchronised at both ends."""
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0


def _cast(tree, device, dtype=torch.float64):
    return {k: t.detach().to(device, dtype) for k, t in tree.items()}


def analysis_cxr(device="cuda", px=CXR_PX, rows=16, batch=4):
    """Phase 14 maps: ``chestxray_mu0_01_K0`` (seed 1226) against a
    ``chestxray_mu0`` baseline (seed 1227) and a third ``chestxray_mu0``
    (seed 1228) for ``jaccard_comp``, random weights, on ``rows`` NIH
    stand-in rows at ``px``: ms a batch of each map and audit."""
    from optwboundeigenval_tpu_torch.analysis import jaccard
    from optwboundeigenval_tpu_torch.analysis.grad_cam import grad_cam
    from optwboundeigenval_tpu_torch.analysis.guided_backprop import generate_gradients
    from optwboundeigenval_tpu_torch.analysis.saliency import batch_saliency
    from optwboundeigenval_tpu_torch.configs import chestxray_mu0, chestxray_mu0_01_K0
    from optwboundeigenval_tpu_torch.train.driver import build_trainer

    loader = cxr_loaders((batch, batch, rows), px, batch)["test_loader"][0]
    with tempfile.TemporaryDirectory() as tmp:
        dirs = dict(log_dir=f"{tmp}/logs", model_dir=f"{tmp}/models")
        trs = [build_trainer(cfg.options(device=device, seed=seed, **dirs))
               for cfg, seed in ((chestxray_mu0_01_K0, 1226), (chestxray_mu0, 1227),
                                 (chestxray_mu0, 1228))]
        for tr in trs:
            tr.init_state()
        tr, base = trs[0], trs[1]
        if tr.task.model.backbone != "densenet121" or tr.batch_size != batch:
            fail("analysis cxr: the recipe lost its trunk or batch")
        batches = [b["x"] for b in loader]
        maps = {"saliency": lambda x: batch_saliency(tr.task, tr.params, tr.model_state, x),
                "guided": lambda x: generate_gradients(tr.task, tr.params, tr.model_state, x),
                "gradcam": lambda x: grad_cam(tr.task, tr.params, tr.model_state, x,
                                              "features")}
        for name, fn in maps.items():
            fn(batches[0])  # warm-up
            if device == "cuda":
                phase_profile(None, None, f"cxr {name} map, one batch",
                              step=lambda: fn(batches[0]))
            outs, sec = _timed(lambda: [fn(x) for x in batches], device)
            out = np.concatenate([np.asarray(o.cpu() if isinstance(o, torch.Tensor) else o)
                                  for o in outs])
            want = (rows, px, px) + (() if name == "gradcam" else (3,))
            log(f"analysis cxr {name}: {1e3 * sec / len(batches):.1f} ms a batch of {batch} "
                f"at {px} px, shape {out.shape}, max {np.abs(out).max():.4g}")
            if out.shape != want or not np.isfinite(out).all() or not np.abs(out).max() > 0:
                fail(f"analysis cxr {name}: maps of shape {out.shape}, not finite or all 0")
        for method in maps:
            res, sec = _timed(lambda: jaccard.jaccard_audit(
                tr, base, loader, method=method, layer_path="features", train_meta=True,
                log_dir=dirs["log_dir"], plot_dir=f"{tmp}/plots", tag=f"jaccard_{method}"),
                device)
            jac = res["jaccard"]
            log(f"analysis cxr jaccard_audit {method}: {1e3 * sec / len(batches):.1f} ms a "
                f"batch, mean jaccard {jac.mean():.4f}, conditioned {res['conditioned'].tolist()}, "
                f"counts {res['counts'].tolist()}, meta |w| {np.abs(res['meta']['w']).max():.3g}")
            csv = f"{dirs['log_dir']}/{tr.header2}_jaccard_{method}_values.csv"
            if (jac.shape != (rows,) or not ((jac >= 0) & (jac <= 1)).all()
                    or not os.path.exists(csv) or not np.isfinite(res["meta"]["w"]).all()
                    or res["counts"].sum() != rows):
                fail(f"analysis cxr jaccard_audit {method}: {res}")
        # over every row: random weights seldom agree on the arg max
        mat, sec = _timed(lambda: jaccard.jaccard_comp(trs, loader, same_pred_only=False,
                                                       log_dir=dirs["log_dir"]), device)
        log(f"analysis cxr jaccard_comp over 3 trainers: {1e3 * sec / len(batches):.1f} ms a "
            f"batch, matrix {np.round(mat, 4).tolist()}")
        if (mat.shape != (3, 3) or not np.array_equal(np.diag(mat), np.ones(3))
                or not np.array_equal(mat, mat.T) or not ((mat >= 0) & (mat <= 1)).all()):
            fail("analysis cxr jaccard_comp: not a symmetric 3x3 matrix of Jaccards")
    return tr


def analysis_cxr_card_vs_cpu(tr, device="cuda", px=64, rows=2):
    """The three maps of ``tr``'s model in float64 on the card and the CPU,
    at ``px`` px and batch ``rows``, within ``CARD_F64_RTOL``."""
    from optwboundeigenval_tpu_torch.analysis.grad_cam import grad_cam
    from optwboundeigenval_tpu_torch.analysis.guided_backprop import generate_gradients
    from optwboundeigenval_tpu_torch.analysis.saliency import batch_saliency
    from optwboundeigenval_tpu_torch.data.synthetic import make_multilabel

    x = make_multilabel(rows, shape=(px, px, 3), n_classes=14, seed=1226)[0].astype(np.float64)
    task = tr.task
    out = {}
    for dev in (device, "cpu"):
        p, st = _cast(tr.params, dev), _cast(tr.model_state, dev)
        out[dev] = [np.asarray(m.cpu() if isinstance(m, torch.Tensor) else m) for m in (
            batch_saliency(task, p, st, x), generate_gradients(task, p, st, x),
            grad_cam(task, p, st, x, "features"))]
    errs = [_rel(torch.from_numpy(a), torch.from_numpy(b))
            for a, b in zip(out[device], out["cpu"])]
    log(f"analysis cxr float64 maps at {px} px, batch {rows}, card vs cpu: relative errors "
        f"saliency {errs[0]:.3e}, guided {errs[1]:.3e}, gradcam {errs[2]:.3e} "
        f"(bound {CARD_F64_RTOL:g})")
    if not max(errs) < CARD_F64_RTOL:
        fail("analysis cxr: the card's float64 maps and the CPU's disagree")
    return errs


def _gan_pair(kind, feat_or_n):
    from optwboundeigenval_tpu_torch.models import gan

    g = torch.Generator().manual_seed(1226)
    if kind == "mlp":
        return (gan.MLPGenerator(n=feat_or_n, generator=g).double(),
                gan.MLPDiscriminator(n=feat_or_n, generator=g).double())
    return (gan.DCGenerator(feat=feat_or_n, generator=g).double(),
            gan.DCDiscriminator(feat=feat_or_n, generator=g).double())


def analysis_gan_card_vs_cpu(device="cuda", steps=2, batch=64):
    """Two float64 ``train_cgan`` steps of the published MLP cGAN (nodes 32,
    label tricks and AdamW as the script sets them) and of the DC-cGAN
    (feat 64) from one state on the card and the CPU, the draws (dropout
    masks included) made once on the CPU and injected: losses,
    parameters, BatchNorm statistics and Adam moments within
    ``CARD_F64_RTOL``."""
    from optwboundeigenval_tpu_torch.analysis import gan_train

    errs = {}
    for kind, width, side in (("mlp", 32, 16), ("dc", 64, 32)):
        rng = np.random.default_rng(1226)
        x = rng.uniform(-1, 1, (batch * steps, side, side, 1))
        y = rng.integers(0, 10, batch * steps)
        kw = dict(n_epochs=1, batch_size=batch, lr=1e-4, weight_decay=2e-5, rand=0.3,
                  swap=0.5, cosine_schedule=True, log_every=100)
        shapes = _gan_pair(kind, width)[1].dropout_shapes
        gen = torch.Generator().manual_seed(7)
        draws = [gan_train.cgan_draws(gen, batch_size=batch, latent_dim=100, n_classes=10,
                                      rand=0.3, smooth=0.0, swap=0.5, dropout_shapes=shapes,
                                      dtype=torch.float64, device="cpu") for _ in range(steps)]
        runs = {}
        for dev in (device, "cpu"):
            g, d = _gan_pair(kind, width)
            on = lambda v: ([t.to(dev) for t in v] if isinstance(v, list) else v.to(dev))
            dd = [{k: on(v) for k, v in dr.items()} for dr in draws]
            hist, g_opt, d_opt = gan_train.train_cgan(x, y, g, d, device=dev,
                                                      draws=lambda i: dd[i], **kw)
            runs[dev] = (torch.tensor(hist[0][1:]), g.state_dict(), d.state_dict(),
                         g_opt.mu, g_opt.nu, d_opt.mu, d_opt.nu)
        errs[kind] = max(_rel(a, b) for a, b in zip(runs[device], runs["cpu"]))
    log(f"analysis gan float64 {steps} steps, card vs cpu (losses, parameters, BatchNorm "
        f"statistics, Adam moments): relative error MLP {errs['mlp']:.3e}, DC {errs['dc']:.3e} "
        f"(bound {CARD_F64_RTOL:g})")
    if not max(errs.values()) < CARD_F64_RTOL:
        fail("analysis gan: the card's float64 steps and the CPU's disagree")
    return errs


def _script(main, argv):
    """``main(argv)`` with its standard output kept: ``(result, text)``."""
    tee = _Tee()
    with contextlib.redirect_stdout(tee):
        out = main(argv)
    return out, tee.getvalue()


def analysis_gans(tmp, device="cuda"):
    """The ``gan`` script: the MLP cGAN at its published defaults for 1
    epoch (2 before the time budget) and 10,000 images, the DC-cGAN for 1 epoch; steps/s, peak memory,
    and the busy share of a profiled 20-step run."""
    from optwboundeigenval_tpu_torch.analysis import gan_train
    from optwboundeigenval_tpu_torch.data import usps
    from optwboundeigenval_tpu_torch.scripts import gan as gan_script

    rates = {}
    for label, extra in (("mlp cgan", ["--n_epochs", "1"]),
                         ("dc cgan", ["--dc", "--n_epochs", "1", "--gen_images", "1000"])):
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        argv = extra + ["--device", device, "--out", f"{tmp}/data/gan_usps.npz",
                        "--models_dir", f"{tmp}/models", "--sample_dir", f"{tmp}/images"]
        (path, text), sec = _timed(lambda: _script(gan_script.main, argv), device)
        line = [ln for ln in text.splitlines() if ln.startswith("trained ")][0]
        rates[label] = float(line.split(", ")[1].split()[0])
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else None
        with np.load(path) as z:
            gx, gy = z["x"], z["y"]
        n = 10000 if label == "mlp cgan" else 1000
        side = 16 if label == "mlp cgan" else 32
        log(f"analysis {label}: {line}; the script {sec:.2f} s, max_memory_allocated {peak} B; "
            f"{len(gx)} images {gx.shape[1:]}, range [{gx.min():.3f}, {gx.max():.3f}], "
            f"classes {np.bincount(gy, minlength=10).tolist()}")
        if gx.shape != (n, side, side, 1) or not np.isfinite(gx).all() or np.abs(gx).max() > 1:
            fail(f"analysis {label}: generated images of shape {gx.shape} or out of [-1, 1]")
    if device == "cuda":
        x0, y0 = usps.load_usps(train=True)
        for label, flags in (("mlp cgan", []), ("dc cgan", ["--dc"])):
            args = gan_script.parse_args(flags + ["--device", device])
            x, g, d, _ = gan_script.build(args, (x0 - 0.5) / 0.5)
            n = 20 * args.batch_size
            run = lambda: gan_train.train_cgan(
                x[:n], y0[:n], g, d, n_epochs=1, lr=args.lr, b1=args.b1, b2=args.b2,
                weight_decay=args.weight_decay, rand=args.rand, swap=args.swap,
                cosine_schedule=True, device=device)
            run()
            phase_profile(None, None, f"{label}, 20 steps at the published defaults", step=run)
    return rates


def analysis_distances(tmp, device="cuda"):
    """The ``distance`` script (Euclid and cosine) on the 10,000 generated
    images against the 2,007 USPS test rows, and ``create_dist`` over the
    two augmented test sets."""
    from optwboundeigenval_tpu_torch.data import usps
    from optwboundeigenval_tpu_torch.scripts import create_dist, distance

    for dist in ("euclid", "cosine"):
        argv = [dist, "GAN", "--device", device, "--data_dir", f"{tmp}/data",
                "--plot_dir", f"{tmp}/plots"]
        (dmm, _), sec = _timed(lambda: _script(distance.main, argv), device)
        log(f"analysis distance {dist}: 2,007 test rows x {len(dmm)} generated, {sec:.3f} s, "
            f"mean {dmm.mean():.4f}, min {dmm.min():.4f}, max {dmm.max():.4f}")
        if dmm.shape != (10000,) or not np.isfinite(dmm).all():
            fail(f"analysis distance {dist}: {dmm.shape}")
    argv = ["--dist", "cosine", "--seed", "1226", "--device", device, "--data_dir",
            f"{tmp}/data", "--plot_dir", f"{tmp}/plots"]
    (out, _), sec = _timed(lambda: _script(create_dist.main, argv), device)
    ld = usps.get_gan_loader(batch_size=128, file="constructed.npz", root=f"{tmp}/data")
    log(f"analysis create_dist cosine: {sec:.3f} s, {ld.num_examples} rows of "
        f"{ld.x.shape[1:]} in {out}")
    if ld.x.shape[1:] != (16, 16, 1) or not 0 < ld.num_examples <= 2 * 2007:
        fail("analysis create_dist: the constructed set is malformed")


# (config, mu, K): the two configs as published and the script's mu=0.01 K=1
FOREST_VARIANTS = (("forest_best", 0.0028, 1.0), ("forest_unreg", 0.0, 0.0),
                   ("forest_best", 0.01, 1.0))


# phase 14's training runs on the first rows of the train set (Forest
# 12,800, USPS 6,250 before the time budget)
ANALYSIS_ROWS = {"forest": 2560, "usps": 1024}


def analysis_cov_shift(tmp, device="cuda", iters=100):
    """Three Forest variants for 1 epoch on ``ANALYSIS_ROWS`` train rows
    through ``driver.run``, the
    ``cov_shift_test`` script's ``iters`` shifts on their best checkpoints
    (draws/s), and the float64 sweep of the same checkpoints on the card
    vs the CPU, acc and F1 within ``CARD_F64_RTOL``."""
    from optwboundeigenval_tpu_torch.analysis import cov_shift
    from optwboundeigenval_tpu_torch.configs import forest_best, forest_unreg
    from optwboundeigenval_tpu_torch.data import forest
    from optwboundeigenval_tpu_torch.models.mlp_forest import ForestNet
    from optwboundeigenval_tpu_torch.optim.api import sgd
    from optwboundeigenval_tpu_torch.scripts import cov_shift_test
    from optwboundeigenval_tpu_torch.train import driver
    from optwboundeigenval_tpu_torch.train.task import Task
    from optwboundeigenval_tpu_torch.train.trainer import SpectralTrainer

    mods = {"forest_best": forest_best, "forest_unreg": forest_unreg}
    for name, mu, K in FOREST_VARIANTS:
        tr, sec = _timed(lambda: driver.run(_train_rows(mods[name].options(
            max_iter=1, device=device, log_dir=f"{tmp}/logs", model_dir=f"{tmp}/models",
            mu=mu, K=K), ANALYSIS_ROWS["forest"])), device)
        log(f"analysis cov shift: {tr.header2} 1 epoch through driver.run, {sec:.1f} s")
    argv = [str(iters), "0.1", "--device", device, "--seed", "1226", "--models_dir",
            f"{tmp}/models", "--log_dir", f"{tmp}/logs", "--plot_dir", f"{tmp}/plots"]
    ((acc, f1, idx), text), sec = _timed(lambda: _script(cov_shift_test.main, argv), device)
    log(f"analysis cov_shift_test: {acc.shape[0]} models x {iters} shifts in {sec:.2f} s, "
        f"{iters / sec:.1f} draws/s; mean acc {acc.mean(axis=1).round(3).tolist()}, "
        f"mean f1 {f1.mean(axis=1).round(4).tolist()}")
    if acc.shape != (3, iters) or not (np.isfinite(acc).all() and np.isfinite(f1).all()):
        fail("analysis cov_shift_test: the sweep lost a model or a value")
    if "vs" not in text or np.any(idx[10:] != 0):
        fail("analysis cov_shift_test: no slope comparison, or a binary column shifted")
    data = forest.get_data()
    x, y = data["inputs_test"], data["target_test"]
    res = {}
    for dev in (device, "cpu"):
        models = [SpectralTrainer(Task(model=ForestNet().double()), sgd(0.5), header="Forest",
                                  batch_size=128, device=dev, model_dir=f"{tmp}/models",
                                  mu=mu, K=K) for _, mu, K in FOREST_VARIANTS]
        res[dev] = cov_shift.cov_shift_tester(models, x, y, iters=iters, mult=0.1,
                                              mean_diff=1.0, bad_modes=range(10, x.shape[1]),
                                              header=f"f64_{dev}", log_dir=f"{tmp}/logs",
                                              seed=1226)
    err = max(float(np.abs(a - b).max() / np.abs(b).max())
              for a, b in zip(res[device][:2], res["cpu"][:2]))
    log(f"analysis cov shift float64 card vs cpu, {iters} shifts x 3 models: acc and f1 "
        f"relative error {err:.3e} (bound {CARD_F64_RTOL:g}); indices equal "
        f"{np.array_equal(res[device][2], res['cpu'][2])}")
    if not (err < CARD_F64_RTOL and np.array_equal(res[device][2], res["cpu"][2])):
        fail("analysis cov shift: the card's float64 sweep and the CPU's disagree")
    return iters / sec


def analysis_driver_route(tmp, device="cuda"):
    """``usps_cnn_mu0_01_K0`` for 1 epoch on ``ANALYSIS_ROWS`` train rows
    through ``driver.run``, then again
    (seed 1227) with ``saliency`` and ``jaccard`` against the first run's
    best checkpoint: the CSVs and the saliency ``.npz`` must exist."""
    from optwboundeigenval_tpu_torch.configs import usps_cnn_mu0_01_K0 as cfg
    from optwboundeigenval_tpu_torch.train import driver

    rows = ANALYSIS_ROWS["usps"]
    first = driver.run(_train_rows(cfg.options(max_iter=1, device=device,
                                               log_dir=f"{tmp}/u0/logs",
                                               model_dir=f"{tmp}/u0/models"), rows))
    best = os.path.join(first.model_dir, first.header2 + "_trained_model_best.pt")
    tr, sec = _timed(lambda: driver.run(_train_rows(cfg.options(
        max_iter=1, device=device, seed=1227, saliency=True, jaccard=True, comp_fname=best,
        log_dir=f"{tmp}/u1/logs", model_dir=f"{tmp}/u1/models", plot_dir=f"{tmp}/u1/plots"),
        rows)), device)
    csvs = [f"{tr.log_dir}/{tr.header2}_jaccard_{t}.csv" for t in ("cond", "counts", "values")]
    npz = f"{tmp}/u1/plots/{tr.header2}_saliency.npz"
    missing = [f for f in csvs + [npz] if not os.path.exists(f)]
    values = np.loadtxt(csvs[2], delimiter=",") if not missing else np.zeros(0)
    log(f"analysis driver route: usps_cnn_mu0_01_K0 with saliency and jaccard, {sec:.1f} s; "
        f"{len(values)} jaccards, mean {values.mean() if len(values) else float('nan'):.4f}; "
        f"missing {missing}")
    if missing or len(values) != 2007:
        fail(f"analysis driver route: missing {missing} or {len(values)} jaccards")


def phase_analysis(device="cuda"):
    """Phase 14: the analysis path."""
    t0 = time.perf_counter()
    lap = lambda what: log(f"phase 14: {what} done, {time.perf_counter() - t0:.1f} s in")
    tr = analysis_cxr(device)
    lap("CXR maps and audits at 224 px")
    analysis_cxr_card_vs_cpu(tr, device)
    lap("float64 maps card vs cpu")
    with tempfile.TemporaryDirectory() as tmp:
        analysis_gans(tmp, device)
        lap("the cGANs")
        analysis_gan_card_vs_cpu(device)
        lap("float64 GAN steps card vs cpu")
        analysis_distances(tmp, device)
        lap("distances")
        analysis_cov_shift(tmp, device)
        lap("covariate shift")
        analysis_driver_route(tmp, device)
        lap("the driver's saliency and jaccard routes")


# the original DenseNet of Huang et al. 2017 (Table 2: L=40, k=12, dropout
# 0.2 on C10 without augmentation): 1,059,298 parameters, 456 channels at
# the head
ORIGINAL_DENSENET = dict(depth=40, growth_rate=12, reduction=1.0, bottleneck=False,
                         drop_rate=0.2)
ORIGINAL_DENSENET_PARAMS = 1_059_298


def _original_densenet_opts(device, rows=None, tmp=None, **overrides):
    """``cifar10_densenet_mu0_01_K0``'s options with only the model (the
    original DenseNet-40), ``has_dropout``, ``augment=False`` and
    ``max_iter=1`` changed, and ``overrides``; every split cut to its first
    ``rows`` rows when given."""
    from optwboundeigenval_tpu_torch.configs import cifar10_densenet_mu0_01_K0 as cfg
    from optwboundeigenval_tpu_torch.data.loaders import ArrayLoader
    from optwboundeigenval_tpu_torch.models.densenet import DenseNet3

    dirs = {} if tmp is None else {"log_dir": f"{tmp}/logs", "model_dir": f"{tmp}/models"}
    opts = cfg.options(model=DenseNet3(**ORIGINAL_DENSENET), has_dropout=True, augment=False,
                       max_iter=1, device=device, **dirs, **overrides)
    if rows is not None:
        bs = opts["batch_size"]
        cut = lambda ld, **kw: ArrayLoader(ld.x[:rows], ld.y[:rows], bs, **kw)
        opts["train_loader"] = cut(opts["train_loader"], shuffle=True, seed=1226)
        opts["valid_loader"] = cut(opts["valid_loader"])
        opts["train_loader_na"] = cut(opts["train_loader_na"])
        opts["test_loader"] = [cut(opts["test_loader"][0])]
    return opts


def dropout_densenet_runs(device="cuda", rows=128, micro_steps=1):
    """Phase 15a: the original DenseNet-40 through ``driver.run`` under the
    recipe's ``remat`` on ``rows`` rows of each split, with s/epoch,
    steps/s, mean ``pow_iters``, a profiled step and the peak memory; then
    ``micro_steps`` steps with ``hvp_micro=2, remat=False``, K1 launching
    ``2 * (pow_iters + 2)`` times a step.  Returns the epoch's trainer, a
    batch and K1's launches."""
    from optwboundeigenval_tpu_torch.ops import pallas_kernels as pk
    from optwboundeigenval_tpu_torch.train.driver import build_trainer

    cuda = device == "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        opts = _original_densenet_opts(device, rows, tmp)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        trainer, batch, launches = run_epochs("original DenseNet-40 (dropout 0.2, remat)", opts,
                                              device, 1)
    if trainer.ndim != ORIGINAL_DENSENET_PARAMS or not (trainer.remat and trainer.task.has_dropout):
        fail(f"original DenseNet-40: {trainer.ndim} parameters, remat {trainer.remat}, "
             f"dropout {trainer.task.has_dropout}")
    mem = torch.cuda.max_memory_allocated() if cuda else "not measured"
    log(f"original DenseNet-40: pow_iters per step {trainer.epoch_pow_iters}, "
        f"{trainer._dropout_draws} dropout keys drawn, max_memory_allocated {mem} B")
    if cuda:
        phase_profile(trainer, batch, "original DenseNet-40 dropout (remat)")

    opts = _original_densenet_opts(device, rows, remat=False, hvp_micro=2)
    tr, batches = build_trainer(opts), iter(opts["train_loader"])
    pk.axpy_accumulate.launches = 0
    for i in range(micro_steps):
        before = pk.axpy_accumulate.launches
        m, ms = _timed(lambda: tr.train_step(next(batches)), device)
        launched = pk.axpy_accumulate.launches - before
        want = 2 * (m["pow_iters"] + 2)
        log(f"original DenseNet-40 hvp_micro=2 step {i}: rho {m['rho']:.6g} pow_iters "
            f"{m['pow_iters']} g {m['g']:.6g} step_ms {1e3 * ms:.1f} K1_launches {launched} "
            f"(expected {want})")
        if not (m["step_ok"] and math.isfinite(m["rho"]) and m["g"] > 0):
            fail(f"original DenseNet-40 hvp_micro=2 step {i}: {m}")
        if cuda and launched != want:
            fail(f"original DenseNet-40 hvp_micro=2 step {i}: {launched} K1 launches, "
                 f"expected {want}")
    return trainer, batch, launches + pk.axpy_accumulate.launches


def dropout_symmetry(trainer, batch):
    """Within one step's key the Hessian is one symmetric operator: ``u.(H v)``
    equals ``v.(H u)`` to float32 rounding; across two keys it does not."""
    from optwboundeigenval_tpu_torch.models import dropout
    from optwboundeigenval_tpu_torch.ops import curvature
    from optwboundeigenval_tpu_torch.utils.tree import tree_norm, tree_vdot

    rng = np.random.default_rng(1226)
    unit = lambda: (lambda t: {k: a / tree_norm(t) for k, a in t.items()})(
        {k: torch.from_numpy(rng.normal(size=tuple(a.shape))).to(a) for k, a in
         trainer.params.items()})
    u, v = unit(), unit()
    key = dropout.step_key(trainer.seed, 10 ** 6)
    hvp = lambda k: curvature.linearize_hvp(trainer.task.loss_fn(trainer.model_state, k),
                                            trainer.params, batch)[1]
    h1, h2 = hvp(key), hvp(key + 1)
    uhv, vhu, vh2u = (float(a) for a in (tree_vdot(u, h1(v)), tree_vdot(v, h1(u)),
                                         tree_vdot(v, h2(u))))
    same = abs(uhv - vhu) / max(abs(uhv), abs(vhu))
    cross = abs(uhv - vh2u) / max(abs(uhv), abs(vh2u))
    log(f"dropout symmetry (float32, unit u and v): u.Hv {uhv:.6g}, v.Hu {vhu:.6g}, relative "
        f"difference {same:.3e} (bound 1e-4); with the masks of two keys v.H'u {vh2u:.6g}, "
        f"{cross:.3e}")
    if not same < 1e-4:
        fail(f"dropout: H is not symmetric within one key ({same:.3e})")


def _fixed_masks(key=7):
    """An injection of masks drawn once on the CPU, for both devices."""
    from optwboundeigenval_tpu_torch.models import dropout

    table = {}

    def masks(_key, site, shape):
        if (site, shape) not in table:
            table[(site, shape)] = dropout.keep_mask(key, site, torch.empty(shape), 0.8)
        return table[(site, shape)]

    return masks


def _f64_step_card_vs_cpu(label, build, batch, device):
    """A float64 ``train_step`` from one state on ``device`` and on the CPU
    (the same dropout masks injected): pow_iters equal, the metrics, the
    update and the BatchNorm statistics within ``CARD_F64_RTOL``."""
    from optwboundeigenval_tpu_torch.models import dropout

    masks, steps = _fixed_masks(), {}
    for dev in (device, "cpu"):
        tr = _as_f64(build(dev))
        p0 = {k: t.clone() for k, t in tr.params.items()}
        with dropout.inject(masks):
            m, sec = _timed(lambda: tr.train_step(batch), dev)
        steps[dev] = (m, {k: tr.params[k] - p0[k] for k in p0}, tr.model_state)
        log(f"{label} float64 step on {dev}: rho {m['rho']:.15g} pow_iters {m['pow_iters']} "
            f"g {m['g']:.15g} gradf_norm {m['gradf_norm']:.15g}, {sec:.2f} s")
    (m, d, st), (ref_m, ref_d, ref_s) = steps[device], steps["cpu"]
    errs = {k: abs(m[k] - ref_m[k]) / abs(ref_m[k]) for k in ("rho", "g", "gradf_norm", "gradg_norm")}
    errs["update"] = _rel(d, ref_d)
    if ref_s:
        errs["bn_stats"] = _rel(st, ref_s)
    log(f"{label} float64 {device} vs cpu: pow_iters {m['pow_iters']} vs {ref_m['pow_iters']}, "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + f" (bound {CARD_F64_RTOL:g})")
    if m["pow_iters"] != ref_m["pow_iters"] or not max(errs.values()) < CARD_F64_RTOL:
        fail(f"{label}: the float64 step on {device} and on the CPU disagree")


def dropout_card_vs_cpu(device="cuda", batch_size=2):
    """Phase 15b: a float64 step of the original DenseNet-40 (the recipe's
    remat) at batch 2 and at most ``F64_POW_ITERS`` HVPs (batch 4 and the
    recipe's cap before the time budget), card vs CPU, masks injected."""
    from optwboundeigenval_tpu_torch.train.driver import build_trainer

    opts = _original_densenet_opts("cpu", batch_size=batch_size)
    batch = next(iter(opts["train_loader_na"]))
    _f64_step_card_vs_cpu(
        "original DenseNet-40", lambda dev: build_trainer(
            _original_densenet_opts(dev, batch_size=batch_size,
                                    **F64_CAP)), batch, device)


def gemm_usps(device="cuda", lax=None, rows=1024):
    """Phase 15c: ``usps_cnn_mu0_01_K0`` with ``CNNUSPS(conv_impl='gemm')``
    for one epoch through ``driver.run`` on the first ``rows`` train rows
    (8 steps; a cut for time only, 16 before the time budget), steps/s and HVPs/s beside the lax
    run's (phase 7: ``lax`` is its ``(steps/s, mean pow_iters of its last
    epoch)``), and a float64 step on the card vs the CPU."""
    from optwboundeigenval_tpu_torch.configs import usps_cnn_mu0_01_K0 as cfg
    from optwboundeigenval_tpu_torch.data.loaders import ArrayLoader
    from optwboundeigenval_tpu_torch.models.cnn_usps import CNNUSPS
    from optwboundeigenval_tpu_torch.train.driver import build_trainer

    with tempfile.TemporaryDirectory() as tmp:
        opts = cfg.options(model=CNNUSPS(conv_impl="gemm"), max_iter=1, device=device,
                           log_dir=f"{tmp}/logs", model_dir=f"{tmp}/models")
        ld = opts["train_loader"]
        opts["train_loader"] = ArrayLoader(ld.x[:rows], ld.y[:rows], opts["batch_size"],
                                           shuffle=True, seed=1226)
        trainer, batch, _ = run_epochs("usps_cnn_mu0_01_K0 gemm", opts, device, 1)
    g = trainer.timers.totals["G"]
    rate, hvps = len(trainer.epoch_pow_iters) / g, sum(trainer.epoch_pow_iters) / g
    lax = "not run" if lax is None else f"{lax[0]:.2f} steps/s, mean pow_iters {lax[1]:.2f}"
    log(f"usps_cnn_mu0_01_K0: gemm {rate:.2f} steps/s, {hvps:.1f} HVPs/s (mean pow_iters "
        f"{trainer.mean_pow_iters:.2f}); lax {lax} (phase 7)")
    if device == "cuda":
        phase_profile(trainer, batch, "usps_cnn_mu0_01_K0 gemm")
    first = next(iter(cfg.options(device="cpu")["train_loader_na"]))
    _f64_step_card_vs_cpu("usps_cnn gemm", lambda dev: build_trainer(cfg.options(
        model=CNNUSPS(conv_impl="gemm"), device=dev)), first, device)


def legacy_cxr(device="cuda", px=CXR_PX, rows=16, batch=4):
    """Phase 15d: the legacy loops on ``CXRModel(densenet121)`` at ``px``,
    batch 4, on ``rows`` NIH stand-in rows (``train_epoch``, ``validate``,
    ``test`` with finite AUCs), then ``train2_epoch`` on a ``VAE`` over the
    densenet121 trunk (``outnum`` 14); ms a batch of each."""
    from optwboundeigenval_tpu_torch.models.backbones import densenet121_features
    from optwboundeigenval_tpu_torch.models.cxr import CXRModel
    from optwboundeigenval_tpu_torch.models.vae import VAE
    from optwboundeigenval_tpu_torch.optim.api import adam
    from optwboundeigenval_tpu_torch.train import legacy
    from optwboundeigenval_tpu_torch.train.task import Task, weighted_bce_with_logits

    loaders = cxr_loaders(rows=(rows, rows, rows), px=px, batch=batch)
    train, valid, test = loaders["train_loader"], loaders["valid_loader"], loaders["test_loader"][0]
    n = len(train)
    task = Task(model=CXRModel("densenet121", outnum=14), loss=weighted_bce_with_logits,
                has_batch_stats=True)
    params, state = task.init(torch.Generator().manual_seed(1226), torch.device(device))
    opt = adam(1e-5)
    gen = torch.Generator(device=device).manual_seed(1226)
    (params, state, _, loss), t_train = _timed(lambda: legacy.train_epoch(
        task, params, state, opt, opt.init(params), train, gen), device)
    (vloss, vacc), t_valid = _timed(lambda: legacy.validate(task, params, state, valid), device)
    (roc, avgroc, _), t_test = _timed(lambda: legacy.test(task, params, state, test), device)
    log(f"legacy CXRModel(densenet121) {px} px batch {batch}: train_epoch loss {loss:.6g} "
        f"{1e3 * t_train / n:.1f} ms a batch; validate loss {vloss:.6g} acc {vacc:.2f} "
        f"{1e3 * t_valid / len(valid):.1f} ms a batch; test mean AUC {avgroc:.4f} "
        f"{1e3 * t_test / len(test):.1f} ms a batch")
    labels = np.concatenate([np.asarray(d["y"]) for d in test])
    both = np.array([len(np.unique(c[~np.isnan(c)])) == 2 for c in labels.T])
    log(f"legacy test: AUC per class {np.round(roc, 4).tolist()} ({int((~both).sum())} classes "
        "with one label value only, whose AUC is NaN)")
    if not (math.isfinite(loss) and math.isfinite(vloss) and np.isfinite(roc[both]).all()
            and np.isnan(roc[~both]).all() and both.any()):
        fail(f"legacy loops: loss {loss}, validate {vloss}, AUCs {roc}")
    vae = VAE(densenet121_features(), outnum=14)
    vae.reset_parameters(torch.Generator().manual_seed(1227))
    vp = {k: p.detach().to(device) for k, p in vae.named_parameters()}
    vs = {k: b.detach().to(device) for k, b in vae.named_buffers()}
    before = {k: t.clone() for k, t in vs.items()}
    (vp, vs, _, vae_loss), t_vae = _timed(lambda: legacy.train2_epoch(
        vae, vp, vs, opt, opt.init(vp), train, gen, kl_weight=0.1), device)
    log(f"legacy train2_epoch VAE(densenet121 trunk, outnum 14): loss {vae_loss:.6g} "
        f"{1e3 * t_vae / n:.1f} ms a batch")
    if not math.isfinite(vae_loss) or any(not torch.equal(vs[k], t) for k, t in before.items()):
        fail(f"train2_epoch: loss {vae_loss}, or the BatchNorm statistics moved")


def oracle(device="cuda"):
    """Phase 15e: the curvature oracle in float64 on ``device``."""
    from optwboundeigenval_tpu_torch import hess_test

    with contextlib.redirect_stdout(io.StringIO()):
        diffs = hess_test.main([] if device == "cuda" else ["--device", device])
    log(f"oracle on {device} (float64): grad diff {diffs['grad']:.3e}, HVP diff "
        f"{diffs['hvp']:.3e}, vGHv diff {diffs['vghv']:.3e} (bounds {hess_test.BOUNDS})")


def _legacy_torchvision_key(key):
    return "module.features." + key.replace("norm1", "norm.1").replace("conv2", "conv.2")


def pt_round_trips(tmp, device="cuda", px=CXR_PX):
    """Phase 15f: ``save_torch_checkpoint`` then ``load_torch_checkpoint``
    for ``forest``, ``usps_cnn`` and ``densenet3`` (the original
    DenseNet-40), and a torchvision-keyed densenet121 state dict (``module.``
    prefixes, ``norm.1``-style keys, ``num_batches_tracked``) into the
    trunk: the loaded models' outputs must equal the source's on ``device``."""
    from optwboundeigenval_tpu_torch.models.backbones import densenet121_features
    from optwboundeigenval_tpu_torch.models.cnn_usps import CNNUSPS
    from optwboundeigenval_tpu_torch.models.densenet import DenseNet3
    from optwboundeigenval_tpu_torch.models.mlp_forest import ForestNet
    from optwboundeigenval_tpu_torch.train.checkpoints import (
        load_torch_checkpoint,
        save_torch_checkpoint,
    )

    g = torch.Generator().manual_seed(1226)
    rnd = lambda *shape: torch.randn(*shape, generator=g).to(device)

    def randomise(m):
        m.reset_parameters(g)
        for name, b in m.named_buffers():  # running statistics away from 0 and 1
            b.copy_(torch.rand(b.shape, generator=g) + (0.5 if name.endswith("var") else -0.5))
        return m.to(device)

    cases = (("forest", ForestNet, rnd(8, 54)), ("usps_cnn", CNNUSPS, rnd(8, 16, 16, 1)),
             ("densenet3", lambda: DenseNet3(**ORIGINAL_DENSENET), rnd(4, 32, 32, 3)))
    for arch, build, x in cases:
        src = randomise(build())
        path = save_torch_checkpoint(src, os.path.join(tmp, f"{arch}.pt"), arch)
        dst = build().to(device)
        dst.load_state_dict(load_torch_checkpoint(path, arch))
        same = torch.equal(dst(x), src(x))
        log(f".pt round trip {arch}: {os.path.getsize(path)} B, outputs equal {same}")
        if not same:
            fail(f".pt round trip {arch}: the outputs differ")
    src = randomise(densenet121_features())
    ref = {_legacy_torchvision_key(k): v.cpu() for k, v in src.state_dict().items()}
    ref.update({_legacy_torchvision_key(k.replace("running_mean", "num_batches_tracked")):
                torch.tensor(3) for k in src.state_dict() if k.endswith("running_mean")})
    ref["module.classifier.weight"] = torch.zeros(1000, 1024)
    torch.save(ref, os.path.join(tmp, "densenet121.pth"))
    dst = densenet121_features().to(device)
    dst.load_state_dict(load_torch_checkpoint(os.path.join(tmp, "densenet121.pth"), "densenet121"))
    x = rnd(2, 3, px, px)
    same = all(torch.equal(dst(x, train), src(x, train)) for train in (False, True))
    log(f"torchvision densenet121 state dict ({len(ref)} keys, module. prefixes, norm.1 "
        f"keys) into the trunk: outputs equal {same} at {px} px")
    if not same:
        fail("torchvision densenet121: the loaded trunk's outputs differ")


def phase_surface(device="cuda", lax=None):
    """Phase 15: dropout and the original DenseNet-40 through the spectral
    step, the gemm CNNUSPS, the legacy loops with the VAE, the oracle and
    the reference ``.pt`` round trips.  Returns K1's launches."""
    t0 = time.perf_counter()
    lap = lambda what: log(f"phase 15: {what} done, {time.perf_counter() - t0:.1f} s in")
    trainer, batch, launches = dropout_densenet_runs(device)
    dropout_symmetry(trainer, batch)
    lap("the original DenseNet-40 runs")
    dropout_card_vs_cpu(device)
    lap("float64 dropout step card vs cpu")
    gemm_usps(device, lax)
    lap("the gemm CNNUSPS")
    legacy_cxr(device)
    lap("the legacy loops and the VAE")
    oracle(device)
    with tempfile.TemporaryDirectory() as tmp:
        pt_round_trips(tmp, device)
    lap("the oracle and the .pt round trips")
    return launches


# phase 16: the execution knobs and the data-parallel mesh


@contextlib.contextmanager
def _counted(cls, name):
    """Count the calls of ``cls.name`` inside; yields the counter."""
    calls = [0]
    real = getattr(cls, name)

    def counting(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)

    setattr(cls, name, counting)
    try:
        yield calls
    finally:
        setattr(cls, name, real)


def _trace_stats(path):
    """``(bytes, events, kernel busy share of the traced span, op names)``
    of a Chrome trace written by ``torch.profiler``."""
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"] if "ts" in e]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))) for e in events]
    wall = max(b for _, b in spans) - min(a for a, _ in spans)
    busy = sum(float(e.get("dur", 0)) for e in events if e.get("cat") == "kernel")
    return (os.path.getsize(path), len(events), busy / wall if wall else None,
            {e.get("name", "") for e in events})


def _flagship_run(label, tmp, device, rows, epochs, **knobs):
    """The published DenseNet-40 recipe through ``driver.run`` on its first
    ``rows`` rows for ``epochs`` epochs, the train set on the card with
    ``cifar_augment_device`` and ``knobs``.  Returns the trainer, K1's
    launches, the chunks run and each epoch's ``(seconds by timer,
    pow_iters)``, printed."""
    from optwboundeigenval_tpu_torch.configs import cifar10_densenet_mu0_01_K0 as cfg
    from optwboundeigenval_tpu_torch.data.device import cifar_augment_device
    from optwboundeigenval_tpu_torch.data.loaders import ArrayLoader
    from optwboundeigenval_tpu_torch.train.trainer import SpectralTrainer

    opts = cfg.options(max_iter=epochs, device=device, log_dir=f"{tmp}/{label}/logs",
                       model_dir=f"{tmp}/{label}/models", device_data=True,
                       device_augment=cifar_augment_device, **knobs)
    bs = opts["batch_size"]
    cut = lambda ld, **kw: ArrayLoader(ld.x[:rows], ld.y[:rows], bs, **kw)
    opts["train_loader"] = cut(opts["train_loader"], shuffle=True, seed=1226,
                               augment=opts["train_loader"].augment)
    opts["valid_loader"] = cut(opts["valid_loader"])
    opts["train_loader_na"] = cut(opts["train_loader_na"])
    opts["test_loader"] = [cut(opts["test_loader"][0])]
    per_epoch, prev = [], {}
    real_epoch = SpectralTrainer.iter_epoch

    def timed_epoch(self, loader):
        nonlocal prev
        real_epoch(self, loader)
        t = dict(self.timers.totals)
        per_epoch.append(({k: t[k] - prev.get(k, 0.0) for k in ("Iteration", "G", "Test")},
                          list(self.epoch_pow_iters)))
        prev = t

    with _counted(SpectralTrainer, "_run_scan_chunk") as chunks:
        SpectralTrainer.iter_epoch = timed_epoch
        try:
            trainer, _, launches = run_epochs(f"cifar10_densenet_mu0_01_K0 {label}", opts,
                                              device, epochs)
        finally:
            SpectralTrainer.iter_epoch = real_epoch
    for i, (d, pows) in enumerate(per_epoch):
        profiled = " (profiled)" if knobs.get("profile_dir") and i == 0 else ""
        log(f"{label}, epoch {i}{profiled}: {len(pows)} steps, {d['Iteration']:.2f} s/epoch "
            f"(steps {d['G']:.2f} s, epoch-end f {d['Test']:.2f} s), {len(pows) / d['G']:.3f} "
            f"steps/s, mean pow_iters {np.mean(pows):.2f}, pow_iters {pows}")
    steps = [len(p) for _, p in per_epoch]
    if steps != [rows // bs] * epochs:
        fail(f"{label}: {steps} steps, expected {rows // bs} an epoch")
    return trainer, launches, chunks[0], per_epoch


def knobs_flagship(tmp, device="cuda", rows=32, epochs=2, off=None):
    """Phase 16 (a): the JAX package's device-bound flagship leg
    (bench.py:673-703) on the published DenseNet-40 recipe: the train set
    on the card with ``cifar_augment_device`` for the host augmentation,
    ``scan_steps=8``, ``donate``, ``mem_track``, epoch 0 profiled into
    ``profile_dir``, on the first ``rows`` rows (1 step, one chunk an
    epoch; a cut for the time limit only: the profiled epoch's trace of 256
    rows took 1.4 GB, of 128 rows 650 MB, of 64 rows 517 MB).  Epoch 1 runs
    unprofiled and is compared with epoch
    1 of the same run with ``scan_steps=1`` and no ``donate`` (the same
    trajectory, so the same HVPs), and with phase 10's run of the recipe
    with every knob off (``off``, phase 10's numbers).  Returns K1's launches."""
    _, launches_off, _, base = _flagship_run("scan_steps=1", tmp, device, rows, epochs)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    trainer, launches, chunks, per_epoch = _flagship_run(
        "knobs on", tmp, device, rows, epochs, scan_steps=8, donate=True, mem_track=True,
        profile_dir=os.path.join(tmp, "trace"), profile_epoch=0)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else None
    size, events, busy, names = _trace_stats(trainer.trace_file(0))
    rate = lambda run: len(run[-1][1]) / run[-1][0]["G"]
    log(f"knobs on: {chunks} chunks, mem_max {trainer.mem_max} B, max_memory_allocated "
        f"{peak} B; epoch 0's trace {size} B, {events} events, device busy "
        f"{'not measured' if busy is None else f'{100 * busy:.1f}%'} of the traced span; "
        f"epoch 1 {rate(per_epoch):.3f} steps/s against {rate(base):.3f} with scan_steps=1 "
        f"and no donate ({rate(per_epoch) / rate(base):.3f}x)")
    if off:
        log(f"knobs off (phase 10, the recipe on 128 rows, one epoch): {off['s_epoch']:.2f} "
            f"s/epoch, {off['steps_s']:.3f} steps/s, mean pow_iters {off['pow']:.2f}, "
            f"max_memory_allocated {off['peak']} B; steps/s of epoch 1 on/off "
            f"{rate(per_epoch) / off['steps_s']:.3f}x")
    if per_epoch[-1][1] != base[-1][1]:
        fail(f"knobs on: pow_iters {per_epoch[-1][1]} where scan_steps=1 took {base[-1][1]}")
    if chunks != epochs or "aten::index_select" not in names:
        fail(f"knobs on: {chunks} chunks, device gather {'aten::index_select' in names}: "
             "the scan path or the device data did not run")
    if device == "cuda" and not trainer.mem_max > 0:
        fail("knobs on: mem_track read no device memory")
    return launches + launches_off


def _f64_trainer(device, batch_size=4, **overrides):
    """The DenseNet-40 recipe at float64, augmentation off."""
    from optwboundeigenval_tpu_torch.configs import cifar10_densenet_mu0_01_K0 as cfg
    from optwboundeigenval_tpu_torch.train.driver import build_trainer

    opts = cfg.options(device=device, augment=False, batch_size=batch_size, **overrides)
    return _as_f64(build_trainer(opts)), opts["train_loader_na"]


def _ptrs(tr):
    trees = (tr.params, tr.model_state, tr.opt_state["trace"], tr.v)
    return [t.data_ptr() for tree in trees for t in tree.values()]


def knobs_trajectory(device="cuda", rows=16):
    """Phase 16 (b): the float64 DenseNet-40 recipe at batch 4, augmentation
    off, 2 chunks of 2 steps with ``scan_steps``, ``donate`` and the device
    loader, then the same epoch with all three off: ``params``, ``v``, ``f``
    and ``rho`` within ``CARD_F64_RTOL``; under donate the state keeps its
    storage."""
    from optwboundeigenval_tpu_torch.data.device import DeviceArrayLoader
    from optwboundeigenval_tpu_torch.data.loaders import ArrayLoader

    out = {}
    for on in (True, False):
        knobs = dict(scan_steps=2, donate=True) if on else {}
        tr, na = _f64_trainer(device, **F64_CAP, **knobs)
        x, y = na.x[:rows], na.y[:rows]
        loader = (DeviceArrayLoader(x, y, 4, shuffle=True, seed=1226, device=device) if on
                  else ArrayLoader(x, y, 4, shuffle=True, seed=1226))
        before = _ptrs(tr)
        t0 = time.perf_counter()
        tr.iter_epoch(loader)
        _sync(device)
        out[on] = tr
        log(f"float64 knobs {'on' if on else 'off'}: f {tr.f:.15g} rho {tr.rho:.15g} "
            f"pow_iters {tr.epoch_pow_iters}, {time.perf_counter() - t0:.2f} s; storage kept "
            f"{_ptrs(tr) == before}")
        if on and _ptrs(tr) != before:
            fail("donate: the state did not keep its storage")
    a, b = out[True], out[False]
    errs = {"f": abs(a.f - b.f) / abs(b.f), "rho": abs(a.rho - b.rho) / abs(b.rho),
            "params": _rel(a.params, b.params), "v": _rel(a.v, b.v)}
    log("float64 knobs on vs off: relative errors "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + f" (bound {CARD_F64_RTOL:g})")
    if a.epoch_pow_iters != b.epoch_pow_iters or not max(errs.values()) < CARD_F64_RTOL:
        fail("float64 knobs on and off disagree")


def knobs_k1(device="cuda", rows=8):
    """Phase 16 (c): one chunk of 2 float64 steps with ``hvp_micro=2`` and
    ``remat=False``: K1 launches ``2 * (pow_iters + 2)`` a step (the
    epoch-end ``rho`` and ``f`` launch none).  Returns K1's launches."""
    from optwboundeigenval_tpu_torch.data.device import DeviceArrayLoader
    from optwboundeigenval_tpu_torch.ops import pallas_kernels as pk

    tr, na = _f64_trainer(device, scan_steps=2, donate=True, hvp_micro=2, remat=False)
    loader = DeviceArrayLoader(na.x[:rows], na.y[:rows], 4, device=device)
    pk.axpy_accumulate.launches = 0
    tr.iter_epoch(loader)
    launches = pk.axpy_accumulate.launches
    want = sum(tr.hvp_micro * (p + 2) for p in tr.epoch_pow_iters)
    log(f"K1 under scan_steps: pow_iters {tr.epoch_pow_iters}, K1 launches {launches} "
        f"(expected {want})")
    if device == "cuda" and (launches != want or launches == 0):
        fail(f"K1 under scan_steps: {launches} launches, expected {want}")
    return launches


def knobs_cxr_memory(device="cuda", px=CXR_PX):
    """Phase 16 (d): one ``chestxray_mu0_01_K0`` step at 224 px, batch 4,
    with ``donate`` off and on: the peak device memory of each."""
    from optwboundeigenval_tpu_torch.configs import chestxray_mu0_01_K0 as cfg
    from optwboundeigenval_tpu_torch.train.driver import build_trainer

    mem, peaks = _Memory(device), {}
    for donate in (False, True):
        opts = cfg.options(device=device, donate=donate, **cxr_loaders((4, 4, 4), px))
        tr = build_trainer(opts)
        tr.init_state()
        m, peak, _ = mem(lambda: tr.train_step(next(iter(opts["train_loader"]))))
        state = sum(t.numel() * t.element_size() for tree in (tr.params, tr.v)
                    for t in tree.values())
        peaks[donate] = peak
        log(f"chestxray_mu0_01_K0 step, donate {donate}: peak {peak} B above the state "
            f"before it (params and v {state} B), pow_iters {m['pow_iters']}")
        if not m["step_ok"]:
            fail(f"chestxray donate={donate}: the step is not finite")
        del tr
        if device == "cuda":
            torch.cuda.empty_cache()
    log(f"chestxray step peak: donate {peaks[True]} B against {peaks[False]} B "
        f"({peaks[True] / peaks[False]:.4f}x)")


def _mesh_runs(device, mesh=None):
    """The scenarios of phase 16 (e) on this rank (``mesh``) or one process:
    ``usps_cnn_mu0_01_K0`` at float64 for one epoch of 2 steps (256 rows)
    and the DenseNet-40 recipe at float64 for one step at batch 4 (its
    BatchNorm over the ranks' rows), each step's power iteration capped by
    ``F64_CAP``, a cut for time."""
    from optwboundeigenval_tpu_torch.configs import usps_cnn_mu0_01_K0
    from optwboundeigenval_tpu_torch.data.loaders import ArrayLoader
    from optwboundeigenval_tpu_torch.parallel import shard_batch
    from optwboundeigenval_tpu_torch.train.driver import build_trainer

    out = {}
    opts = usps_cnn_mu0_01_K0.options(device=device, mesh=mesh)
    runs = (("usps_cnn_mu0_01_K0", _as_f64(build_trainer({**opts, **F64_CAP})),
             opts["train_loader_na"], 128, 2),
            ("densenet40 recipe", *_f64_trainer(device, mesh=mesh,
                                                **F64_CAP), 4, 1))
    for label, tr, na, bs, steps in runs:
        batches = list(ArrayLoader(na.x[:steps * bs], na.y[:steps * bs], bs))
        if mesh is not None:
            batches = [shard_batch(b, mesh) for b in batches]
        t0 = time.perf_counter()
        tr.iter_epoch(batches)
        _sync(device)
        out[label] = {"f": tr.f, "rho": tr.rho, "seconds": time.perf_counter() - t0,
                      "params": {k: t.detach().cpu() for k, t in tr.params.items()}}
    return out


def _rank_main(run):
    """One gloo rank of this script, ``chip_smoke.py --rank R --world N
    --port P --out DIR --device D [--phase tp2|tp4]``: joins the group,
    runs ``run(args)`` and leaves it."""
    from optwboundeigenval_tpu_torch.parallel import init_distributed
    from optwboundeigenval_tpu_torch.utils import precision

    args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
    torch.set_num_threads(2)  # the ranks share the host's cores with the parent
    init_distributed(f"127.0.0.1:{args['--port']}", num_processes=int(args["--world"]),
                     process_id=int(args["--rank"]), backend="gloo",
                     timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    precision.set_tf32(False)
    try:
        run(args)
    finally:
        torch.distributed.destroy_process_group()


def mesh_rank(args):
    """One rank of phase 16 (e), started by :func:`knobs_mesh`."""
    from optwboundeigenval_tpu_torch.parallel import make_mesh

    device = args["--device"]
    mesh = make_mesh(device=None if device == "cuda" else device)
    out = _mesh_runs(device, mesh)
    torch.save(out, os.path.join(args["--out"], f"rank{args['--rank']}.pt"))


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def knobs_mesh(tmp, device="cuda", world=2):
    """Phase 16 (e): ``world`` gloo ranks sharing the one card against one
    process (float64, ``CARD_F64_RTOL``); then a one-rank NCCL group on
    ``forest_best`` (float64) for one epoch on ``ANALYSIS_ROWS`` train rows
    through ``driver.run`` against ``mesh=None``."""
    from optwboundeigenval_tpu_torch.configs import forest_best
    from optwboundeigenval_tpu_torch.models.mlp_forest import ForestNet
    from optwboundeigenval_tpu_torch.parallel import init_distributed, make_mesh
    from optwboundeigenval_tpu_torch.train import driver

    t0 = time.perf_counter()
    port = _free_port()
    procs = _started([subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank",
                                        str(r), "--world", str(world), "--port", str(port),
                                        "--out", tmp, "--device", device],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                      for r in range(world)])
    try:
        one = _mesh_runs(device)
    finally:
        ranks = _join_ranks(procs, tmp, "phase 16 (e)", MESH_WAIT_S)
    for label, want in one.items():
        for r, res in enumerate(ranks):
            got = res[label]
            errs = {"f": abs(got["f"] - want["f"]) / abs(want["f"]),
                    "rho": abs(got["rho"] - want["rho"]) / abs(want["rho"]),
                    "params": _rel(got["params"], want["params"])}
            log(f"{world} gloo ranks on one card, {label}, rank {r}: "
                + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                + f" (bound {CARD_F64_RTOL:g}); {got['seconds']:.2f} s against "
                f"{want['seconds']:.2f} s in one process")
            if not max(errs.values()) < CARD_F64_RTOL:
                fail(f"{label}: rank {r} and one process disagree")
    log(f"phase 16 (e): {world} ranks done, {time.perf_counter() - t0:.1f} s")

    # NCCL on the card (gloo for a rehearsal on the CPU)
    init_distributed(f"127.0.0.1:{_free_port()}", num_processes=1, process_id=0,
                     backend="nccl" if device == "cuda" else "gloo")
    try:
        runs = {}
        for label, mesh in (("mesh=None", None),
                            ("one-rank NCCL mesh", make_mesh(device=None if device == "cuda"
                                                             else device))):
            opts = _train_rows(forest_best.options(device=device, max_iter=1, mesh=mesh,
                                                   model=ForestNet().double(),
                                                   log_dir=f"{tmp}/{label}/logs",
                                                   model_dir=f"{tmp}/{label}/models"),
                               ANALYSIS_ROWS["forest"])
            t1 = time.perf_counter()
            runs[label] = driver.run(opts)
            log(f"forest_best {label}: f {runs[label].f:.15g} rho {runs[label].rho:.15g}, "
                f"{time.perf_counter() - t1:.2f} s")
        a, b = runs["one-rank NCCL mesh"], runs["mesh=None"]
        errs = {"f": abs(a.f - b.f) / abs(b.f), "rho": abs(a.rho - b.rho) / abs(b.rho),
                "params": _rel(a.params, b.params)}
        log("forest_best one-rank NCCL vs mesh=None: relative errors "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + f" (bound {CARD_F64_RTOL:g})")
        if not max(errs.values()) < CARD_F64_RTOL:
            fail("forest_best: the one-rank NCCL mesh and mesh=None disagree")
    finally:
        torch.distributed.destroy_process_group()


def phase_knobs(device="cuda", published=None):
    """Phase 16: the trainer's execution knobs and the data-parallel mesh.
    Returns K1's launches."""
    t0 = time.perf_counter()
    lap = lambda what: log(f"phase 16: {what} done, {time.perf_counter() - t0:.1f} s in")
    with tempfile.TemporaryDirectory() as tmp:
        launches = knobs_flagship(tmp, device, off=published)
    lap("(a) the flagship leg")
    knobs_trajectory(device)
    lap("(b) float64 knobs on vs off")
    launches += knobs_k1(device)
    lap("(c) K1 under scan_steps")
    knobs_cxr_memory(device)
    lap("(d) donate at CXR scale")
    with tempfile.TemporaryDirectory() as tmp:
        knobs_mesh(tmp, device)
    lap("(e) the mesh")
    return launches


def _spawn_ranks(tmp, device, world, phase, px=CXR_PX):
    """Start ``world`` gloo ranks of this script (``--rank``) for ``phase``;
    returns the processes."""
    port = _free_port()
    return _started([subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank",
                                       str(r), "--world", str(world), "--port", str(port),
                                       "--out", tmp, "--device", device, "--phase", phase,
                                       "--px", str(px)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                     for r in range(world)])


def _started(procs):
    """Register rank processes, so that the watchdog can kill them."""
    _RUN["ranks"].extend(procs)
    return procs


def _kill_ranks(procs=None):
    for p in _RUN["ranks"] if procs is None else procs:
        if p.poll() is None:
            p.kill()


def _join_ranks(procs, tmp, label, wait):
    """Wait at most ``wait`` s (never more than ``RANK_WAIT_MAX_S``) for the
    ranks of phase ``label``; fail on any exit but 0, and when the wait
    expires kill them and fail after printing each rank's last 4,000
    characters.  Returns their saved results."""
    wait = min(wait, RANK_WAIT_MAX_S)
    end = time.monotonic() + wait
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(end - time.monotonic(), 0.1))[0])
    except subprocess.TimeoutExpired:
        _kill_ranks(procs)
        for r, p in enumerate(procs):
            text = (outs[r] if r < len(outs) else p.communicate()[0]).decode(errors="replace")
            log(f"--- {label}: rank {r}, exit {p.returncode}, its last 4,000 characters ---")
            log(text[-4000:])
        fail(f"{label}: the ranks did not finish within the {wait:.0f} s wait")
    finally:
        _kill_ranks(procs)
    for r, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            log(text.decode(errors="replace")[-4000:])
            fail(f"{label}: rank {r} exited {p.returncode}")
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(len(procs))]


def _bytes(tree):
    return sum(t.numel() * t.element_size() for t in tree.values())


@contextlib.contextmanager
def _collectives_counted(mesh):
    """Counts, while the block runs, every ``torch.distributed.all_reduce``
    (over the ``model`` group or not) and every column assembly of a
    sharded layer (``models/layers.py``), with their bytes."""
    from optwboundeigenval_tpu_torch.models import layers

    n = {"all-reduces": 0, "bytes": 0, "model-group all-reduces": 0, "model-group bytes": 0,
         "column assemblies": 0, "assembled bytes": 0}
    reduce, columns = torch.distributed.all_reduce, layers.assemble_columns

    def counting_reduce(t, *args, **kwargs):
        size = t.numel() * t.element_size()
        n["all-reduces"] += 1
        n["bytes"] += size
        if mesh is not None and kwargs.get("group") is mesh.model_group:
            n["model-group all-reduces"] += 1
            n["model-group bytes"] += size
        return reduce(t, *args, **kwargs)

    def counting_columns(y, full, dim, bias=None):
        n["column assemblies"] += 1
        n["assembled bytes"] += y.numel() // y.shape[dim] * full * y.element_size()
        return columns(y, full, dim, bias)

    torch.distributed.all_reduce, layers.assemble_columns = counting_reduce, counting_columns
    try:
        yield n
    finally:
        torch.distributed.all_reduce, layers.assemble_columns = reduce, columns


def _tp_cxr_step(device, f64, mesh=None, px=CXR_PX):
    """Phase 17 (a) on this rank (``mesh``, its large leaves sharded at the
    default ``min_elems``) or one process: one ``chestxray_mu0_01_K0``
    ``train_step`` with ``hvp_micro=2`` and at most ``F64_POW_ITERS`` HVPs
    (a cut for time) from the config's seed, float32 at ``px`` (224) and
    batch 4, or float64 at 64 px and batch 2.  Every K1
    call of the step is held bit for bit against its plain version on
    the same leaves.  Returns the metrics, the eval-mode ``f`` of the
    batch before the step, the gathered params, their update, the Adam
    moments and Adam's step from them after it, the BatchNorm statistics, K1's launches,
    the alignment of its deltas and the plain comparison, the bytes
    held, the device memory allocated at the step's start and at its
    peak (above what the process held before the trainer), the step's
    seconds, its all-reduces and column assemblies with their bytes."""
    from optwboundeigenval_tpu_torch.configs import chestxray_mu0_01_K0 as cfg
    from optwboundeigenval_tpu_torch.ops import curvature
    from optwboundeigenval_tpu_torch.ops import pallas_kernels as pk
    from optwboundeigenval_tpu_torch.parallel import mesh as meshlib, shard_params
    from optwboundeigenval_tpu_torch.train.driver import build_trainer

    px, rows = (64, 2) if f64 else (px, 4)
    cuda = device == "cuda"
    if cuda:  # what this process held before the trainer
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
    opts = cfg.options(device=device, hvp_micro=2, batch_size=rows, mesh=mesh,
                       **cxr_loaders((rows, rows, rows), px, rows),
                       max_pow_iter=F64_POW_ITERS)
    tr = build_trainer(opts)
    if f64:
        _as_f64(tr)
    tr.init_state()
    full = {"params": _bytes(tr.params), "v": _bytes(tr.v),
            "adam": _bytes(tr.opt_state["mu"]) + _bytes(tr.opt_state["nu"])}
    if mesh is not None:
        tr.params = shard_params(tr.params, mesh)
        tr.v = shard_params(tr.v, mesh)
    dims = tr._sharding.dims if tr._sharding is not None else {}
    held = {"params": _bytes(tr.params), "v": _bytes(tr.v),
            "adam": _bytes(tr.opt_state["mu"]) + _bytes(tr.opt_state["nu"])}
    order = list(tr.params)
    aligned, mismatch = [], []
    check = {"calls": 0, "values": 0, "sliced": 0, "seconds": 0.0, "allocated": 0}

    def recording(acc, delta, alpha, init=False):
        """K1 on this rank's leaves, held bit for bit against its plain
        version on clones of the same ``acc``; the count of leaves that
        differ stays on the card until the step has ended."""
        t = time.perf_counter()
        aligned.append([(d.data_ptr() & 15) == 0 for k, d in zip(order, delta) if k in dims])
        want = pk.axpy_accumulate_plain([a.clone() for a in acc], delta, alpha, init=init)
        check["seconds"] += time.perf_counter() - t
        out = pk.axpy_accumulate(acc, delta, alpha, init=init)
        t = time.perf_counter()
        if cuda:
            check["allocated"] = max(check["allocated"], torch.cuda.memory_allocated() - base)
        norms = torch._foreach_norm(torch._foreach_sub(out, want))
        mismatch.append(torch.stack(norms).ne(0).sum())
        check["calls"] += 1
        check["values"] += sum(a.numel() for a in acc)
        check["sliced"] += sum(a.numel() for k, a in zip(order, acc) if k in dims)
        check["seconds"] += time.perf_counter() - t
        return out

    batch = next(iter(opts["train_loader"]))
    with meshlib.active(tr.mesh, tr._sharding):  # the batch's loss, sharded layers split
        loss, _ = tr.task.eval_loss(tr.params, tr.model_state, tr.put_batch(batch))
        f = float(meshlib.all_sum(loss))
    before = {k: t.to("cpu", copy=True) for k, t in tr._full(tr.params).items()}
    curvature.axpy_accumulate, plain = recording, curvature.axpy_accumulate
    try:
        pk.axpy_accumulate.launches = 0
        _sync(device)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated() - base if cuda else 0
        with _collectives_counted(mesh) as collectives:
            t0 = time.perf_counter()
            m = tr.train_step(batch)
            _sync(device)
            seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base if cuda else 0
        launches = pk.axpy_accumulate.launches
    finally:
        curvature.axpy_accumulate = plain
    check["mismatched"] = int(sum(int(n) for n in mismatch))
    after = {k: t.to("cpu", copy=True) for k, t in tr._full(tr.params).items()}
    st = tr.opt_state
    mu, nu = ({k: t.cpu() for k, t in tr._full(st[n]).items()} for n in ("mu", "nu"))
    # the config's Adam (b1 0.9, b2 0.999, eps 1e-8) from the moments held
    c1, c2 = 1 - 0.9 ** st["count"], 1 - 0.999 ** st["count"]
    adam = {k: -st["lr"] * ((mu[k].double() / c1) / ((nu[k].double() / c2).sqrt() + 1e-8))
            for k in mu}
    return {"m": {k: m[k] for k in ("rho", "g", "gradf_norm", "gradg_norm", "pow_iters",
                                    "step_ok")},
            "f": f, "params": after, "direction": mu, "nu": nu, "adam": adam,
            "update": {k: after[k].double() - before[k].double() for k in after},
            "bn_stats": {k: t.cpu() for k, t in tr.model_state.items()},
            "launches": launches, "aligned": aligned, "check": check, "seconds": seconds,
            "memory": (start, peak),
            "sharded": (len(dims), sum(tr._sharding.shapes[k].numel() for k in dims)
                        if dims else 0),
            "leaves": len(tr.params), "values": tr.ndim, "bytes": (held, full),
            "collectives": collectives}


def _tp_dryrun(device, mesh=None):
    """Phase 17 (b): ``__graft_entry__.py:121-230`` step for step on CNNUSPS
    at its published widths, float64, 16 rows a batch (4 a device of the
    JAX package's 4-device mesh), ``min_elems=1024``: a ``train_step``, a
    ``scan_steps=2`` epoch, a LOBPCG step (``kfac_batch=1``), a Lanczos
    step (``lanczos_m=4``), and one epoch each of the plain control, the
    flagship knobs and ``eigensolver='auto'``.  ``f``, ``rho``, ``g`` and
    the gathered params of each leg."""
    from optwboundeigenval_tpu_torch.data.loaders import ArrayLoader
    from optwboundeigenval_tpu_torch.data.synthetic import make_images
    from optwboundeigenval_tpu_torch.models.cnn_usps import CNNUSPS
    from optwboundeigenval_tpu_torch.optim.api import sgd
    from optwboundeigenval_tpu_torch.parallel import shard_batch, shard_params
    from optwboundeigenval_tpu_torch.train.task import Task
    from optwboundeigenval_tpu_torch.train.trainer import SpectralTrainer

    x, y = make_images(32, shape=(16, 16, 1), n_classes=10, seed=0)
    batches = list(ArrayLoader(x, y, batch_size=16))
    if mesh is not None:
        batches = [shard_batch(b, mesh) for b in batches]
    tmp = tempfile.mkdtemp()

    def trainer(header, **kw):
        tr = SpectralTrainer(Task(model=CNNUSPS().double()), sgd(0.05), mu=0.01, K=1.0,
                             batch_size=16, pow_iter_eps=1e-2, header=header, mesh=mesh,
                             device=device, log_dir=tmp, model_dir=tmp, **kw)
        tr.init_state()
        if mesh is not None:
            tr.params = shard_params(tr.params, mesh, min_elems=1024)
            tr.v = shard_params(tr.v, mesh, min_elems=1024)
        return tr

    def state(tr, rho=None):
        return {"f": tr.f, "rho": tr.rho if rho is None else rho, "g": tr.g,
                "params": {k: t.cpu() for k, t in tr._full(tr.params).items()}}

    out, t0 = {}, time.perf_counter()
    tr = trainer("DRYRUN", max_pow_iter=5)
    out["step"] = state(tr, tr.train_step(batches[0])["rho"])
    tr.defer_metrics, tr.scan_steps = True, 2
    tr.iter_epoch(batches)
    out["scan_steps=2 epoch"] = state(tr)
    for leg, kw in (("lobpcg step", dict(max_pow_iter=30, ignore_bad_vals=False, lobpcg=True,
                                         kfac_batch=1)),
                    ("lanczos step", dict(max_pow_iter=5, ignore_bad_vals=False,
                                          eigensolver="lanczos", lanczos_m=4))):
        t = trainer(f"DRYRUN_{leg}", **kw)
        out[leg] = state(t, t.train_step(batches[0])["rho"])
    for leg, kw in (("control epoch", {}),
                    ("flagship epoch", dict(remat=True, defer_metrics=True, donate=True,
                                            scan_steps=2)),
                    ("auto epoch", dict(eigensolver="auto"))):
        t = trainer(f"DRYRUN_{leg}", max_pow_iter=5, seed=3, **kw)
        t.iter_epoch(batches)
        out[leg] = state(t)
    out["sharded"] = sorted(tr._sharding.dims) if tr._sharding is not None else []
    out["seconds"] = time.perf_counter() - t0
    return out


def _tp_loop(device, tmp, mesh=None, rows=512):
    """Phase 17 (c): ``tests/test_multihost.py:248`` on ``forest_best``'s
    ForestNet at float64 with replicated params: 2 epochs of ``train()``
    on the first ``rows`` train rows (a cut for time only) through
    ``host_shard`` loaders fed by the data coordinate, the first 256
    validation rows, then ``test_model`` through the ``host_shard`` loader.
    The TSV rows (rank 0 writes them), the final state, the evaluation and
    the rows the gathered evaluation counts."""
    from optwboundeigenval_tpu_torch.configs import forest_best
    from optwboundeigenval_tpu_torch.data.loaders import ArrayLoader
    from optwboundeigenval_tpu_torch.models.mlp_forest import ForestNet
    from optwboundeigenval_tpu_torch.train.driver import build_trainer

    label = "one" if mesh is None else f"rank{mesh.rank}"
    opts = forest_best.options(device=device, mesh=mesh, model=ForestNet().double(),
                               max_iter=2, min_iter=2, log_dir=f"{tmp}/{label}/logs",
                               model_dir=f"{tmp}/{label}/models")
    bs = opts["batch_size"]
    x, y = opts["inputs"][:rows], opts["target"][:rows]
    loader = (ArrayLoader(x, y, bs) if mesh is None else
              ArrayLoader(x, y, bs // mesh.data, host_shard=(mesh.data_coord, mesh.data)))
    tr = build_trainer(opts)
    t0 = time.perf_counter()
    tr.train(train_loader=loader, valid_loader=ArrayLoader(opts["inputs_valid"][:256],
                                                           opts["target_valid"][:256], bs))
    seconds = time.perf_counter() - t0
    rows_seen = (sum(len(b["y"]) for b in tr._eval_outputs_sharded(loader))
                 if mesh is not None else rows)
    tsv = ([[float(c) for c in ln.split()] for ln in open(tr.log_file) if ln[:1].isdigit()]
           if tr._writer else [])
    return {"f": tr.f, "rho": tr.rho, "g": tr.g, "h": tr.h,
            "params": {k: t.cpu() for k, t in tr.params.items()}, "rows": tsv,
            "eval": list(tr.test_model(loader=loader)), "rows_seen": rows_seen,
            "seconds": seconds}


def tp_rank(args):
    """One rank of phase 17, started by :func:`phase_model_axis`."""
    from optwboundeigenval_tpu_torch.parallel import make_mesh

    device, rank = args["--device"], int(args["--rank"])
    if args["--phase"] == "tp2":
        mesh = make_mesh(data=1, model=2, device=None if device == "cuda" else device)
        out = {"f32": _tp_cxr_step(device, False, mesh, int(args["--px"])),
               "f64": _tp_cxr_step(device, True, mesh)}
    else:
        mesh = make_mesh(data=2, model=2, device=None if device == "cuda" else device)
        out = {"dryrun": _tp_dryrun(device, mesh), "loop": _tp_loop(device, args["--out"], mesh),
               "coords": (mesh.data_coord, mesh.model_coord)}
    torch.save(out, os.path.join(args["--out"], f"rank{rank}.pt"))


def _tp_check(label, errs, bound):
    log(f"{label}: relative errors " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (bound {bound:g})")
    if not max(errs.values()) < bound:
        fail(f"{label}: the ranks and one process disagree")


def tp_model_axis_cxr(device="cuda", px=CXR_PX):
    """Phase 17 (a): two gloo ranks sharing the card as ``data=1 x
    model=2``, the sharded layers computing their own output columns, one
    ``chestxray_mu0_01_K0`` step with ``hvp_micro=2`` against one process
    from the same seed: float32 at 224 px (``CARD_F32_RTOL``) and float64
    at 64 px (``CARD_F64_RTOL``), the Adam moments and the update each
    rank applied (against Adam's step from its own moments) included; K1's
    launches on the local slices, each call bit-equal to its plain
    version; each process's device memory at the step's peak; the float32
    step's cost (:func:`_tp_cost`).  Returns K1's launches on rank 0."""
    from optwboundeigenval_tpu_torch.ops import pallas_kernels as pk

    one = {"f32": _tp_cxr_step(device, False, px=px), "f64": _tp_cxr_step(device, True)}
    if device == "cuda":
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = _join_ranks(_spawn_ranks(tmp, device, 2, "tp2", px), tmp, "phase 17 (a)",
                            TP2_WAIT_S)
    for prec, bound in (("f32", CARD_F32_RTOL), ("f64", CARD_F64_RTOL)):
        want = one[prec]
        held, full = ranks[0][prec]["bytes"]
        n, values = ranks[0][prec]["sharded"]
        log(f"model axis, chestxray {prec}: {n} of {want['leaves']} leaves sharded, "
            f"{values} of {want['values']} values; bytes a rank holds against one process: "
            + ", ".join(f"{k} {held[k]} / {full[k]} ({held[k] / full[k]:.4f}x)" for k in held))
        for r, res in enumerate(ranks):
            m = res[prec]["m"]
            want_k1 = 2 * (m["pow_iters"] + 2)
            aligned = [a for call in res[prec]["aligned"] for a in call]
            log(f"model axis, chestxray {prec}, rank {r}: rho {m['rho']:.10g} pow_iters "
                f"{m['pow_iters']} g {m['g']:.10g} f {res[prec]['f']:.10g}, step "
                f"{res[prec]['seconds']:.2f} s against {want['seconds']:.2f} s in one "
                f"process; K1 launches {res[prec]['launches']} (expected {want_k1}), "
                f"{sum(aligned)} of {len(aligned)} local-slice deltas 16-byte aligned")
            if device == "cuda" and res[prec]["launches"] != want_k1:
                fail(f"model axis {prec}: {res[prec]['launches']} K1 launches, expected {want_k1}")
            if m["pow_iters"] != want["m"]["pow_iters"] or not m["step_ok"]:
                fail(f"model axis {prec}: rank {r} {m} against one process {want['m']}")
            errs = {k: abs(m[k] - want["m"][k]) / max(abs(want["m"][k]), 1e-30)
                    for k in ("rho", "g", "gradf_norm", "gradg_norm")}
            errs["f"] = abs(res[prec]["f"] - want["f"]) / max(abs(want["f"]), 1e-30)
            errs["direction"] = _rel(res[prec]["direction"], want["direction"])
            errs["second moment"] = _rel(res[prec]["nu"], want["nu"])
            errs["bn_stats"] = _rel(res[prec]["bn_stats"], want["bn_stats"])
            if prec == "f32":
                errs["params"] = _rel(res[prec]["params"], want["params"])
            # the update the rank applied to its slices and replicated
            # leaves, against Adam's step from the moments it holds
            errs["update vs its Adam step"] = _rel(res[prec]["update"], res[prec]["adam"])
            _tp_check(f"model axis, chestxray {prec}, rank {r} vs one process", errs, bound)
            log(f"model axis, chestxray {prec}, rank {r}: update against one process's "
                f"{_rel(res[prec]['update'], want['update']):.3e}, held to no bound: Adam's "
                "first step maps a gradient of rounding noise (a conv bias before BatchNorm "
                "has an exact gradient of 0) to as much as +-lr, so rounding moves it")
            check = res[prec]["check"]
            log(f"model axis, chestxray {prec}, rank {r}: K1 against its plain version on "
                f"{check['calls']} calls, {check['values']} values ({check['sliced']} of them "
                f"in local slices), {check['mismatched']} leaves differing; the check's host "
                f"time {check['seconds']:.3f} s of the step, its most allocated "
                f"{check['allocated']} B")
            unchecked = device == "cuda" and check["calls"] != res[prec]["launches"]
            if check["mismatched"] or unchecked:
                fail(f"model axis {prec}: rank {r}'s K1 and its plain version differ ({check})")
            (start, peak), (one_start, one_peak) = res[prec]["memory"], want["memory"]
            log(f"model axis, chestxray {prec}, rank {r}: device memory allocated at the "
                f"step's start {start} B, peak {peak} B; one process {one_start} B, peak "
                f"{one_peak} B ({peak / max(one_peak, 1):.4f}x)")
    _tp_cost(one["f32"], [res["f32"] for res in ranks], px, device)
    return ranks[0]["f32"]["launches"] + ranks[0]["f64"]["launches"]


def _tp_cost(one, ranks, px, device):
    """Phase 17 (a)'s cost at float32, one process and each rank, every
    number beside the card's name and power limit: the step's seconds, the
    step's
    ``model``-group all-reduces and column assemblies with their bytes
    (on ``data=1 x model=2`` the ``model`` group is the world), its peak
    above the process's prior allocation, the bytes of params, ``v`` and
    Adam state held."""
    card = nvidia_smi() if device == "cuda" else "no card"
    n, values = ranks[0]["sharded"]
    assemblies = ranks[0]["collectives"]["column assemblies"]
    log(f"model axis, chestxray f32 {px} px ({card}): {n} sharded layers, a gather of their "
        f"weights would all-reduce {4 * values} B a forward; the step ran "
        f"{assemblies / max(n, 1):.0f} forwards through them")
    for label, res in [("one process", one)] + [(f"rank {r}", x) for r, x in enumerate(ranks)]:
        c = res["collectives"]
        log(f"model axis cost, chestxray f32 {px} px, {label} ({card}): step "
            f"{res['seconds']:.2f} s; model-group all-reduces "
            f"{c['model-group all-reduces']} ({c['model-group bytes']} B) of "
            f"{c['all-reduces']} ({c['bytes']} B), of them column assemblies "
            f"{c['column assemblies']} ({c['assembled bytes']} B); step peak above the prior "
            f"allocation {res['memory'][1]} B; params, v and Adam state held "
            f"{sum(res['bytes'][0].values())} B")


def tp_dp_tp(device="cuda"):
    """Phase 17 (b) and (c): four gloo ranks sharing the card as ``data=2 x
    model=2``, the dryrun sequence and the multi-host loop against one
    process (``CARD_F64_RTOL``)."""
    with tempfile.TemporaryDirectory() as tmp:
        procs = _spawn_ranks(tmp, device, 4, "tp4")
        try:
            one = {"dryrun": _tp_dryrun(device), "loop": _tp_loop(device, tmp)}
        finally:
            ranks = _join_ranks(procs, tmp, "phase 17 (b, c)", TP4_WAIT_S)
    if [r["coords"] for r in ranks] != [(0, 0), (0, 1), (1, 0), (1, 1)]:
        fail(f"mesh coordinates {[r['coords'] for r in ranks]}")
    for r, res in enumerate(ranks):
        if res["dryrun"]["sharded"] != ["conv2.weight", "conv3.weight", "fc1.weight"]:
            fail(f"dryrun: rank {r} sharded {res['dryrun']['sharded']}")
        for leg, want in one["dryrun"].items():
            if leg in ("sharded", "seconds"):
                continue
            got = res["dryrun"][leg]
            errs = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-30) for k in ("f", "rho", "g")}
            errs["params"] = _rel(got["params"], want["params"])
            _tp_check(f"dp x tp dryrun {leg}, rank {r} vs one process", errs, CARD_F64_RTOL)
    log(f"dp x tp dryrun: {ranks[0]['dryrun']['seconds']:.2f} s on 4 ranks, "
        f"{one['dryrun']['seconds']:.2f} s in one process")
    want = one["loop"]
    if len(want["rows"]) != 2 or len(ranks[0]["loop"]["rows"]) != 2:
        fail(f"dp x tp loop: TSV rows {ranks[0]['loop']['rows']} against {want['rows']}")
    errs = {"TSV rows": _rel(torch.tensor(ranks[0]["loop"]["rows"]), torch.tensor(want["rows"]))}
    for r, res in enumerate(ranks):
        got = res["loop"]
        errs.update({f"rank {r} {k}": abs(got[k] - want[k]) / max(abs(want[k]), 1e-30)
                     for k in ("f", "rho", "h")})
        errs[f"rank {r} params"] = _rel(got["params"], want["params"])
        errs[f"rank {r} eval"] = _rel(torch.tensor(got["eval"]), torch.tensor(want["eval"]))
        if got["rows_seen"] != want["rows_seen"]:
            fail(f"dp x tp loop: rank {r}'s evaluation counted {got['rows_seen']} rows of "
                 f"{want['rows_seen']}")
    log("dp x tp loop (forest_best, 2 epochs, replicated params): TSV "
        f"{ranks[0]['loop']['rows']}; "
        f"every rank's gathered evaluation counted {want['rows_seen']} rows once; "
        f"{ranks[0]['loop']['seconds']:.2f} s on 4 ranks, {want['seconds']:.2f} s in one process")
    _tp_check("dp x tp loop vs one process", errs, CARD_F64_RTOL)


def phase_model_axis(device="cuda", px=CXR_PX):
    """Phase 17: the ``model`` mesh axis.  Returns K1's launches."""
    t0 = time.perf_counter()
    launches = tp_model_axis_cxr(device, px)
    log(f"phase 17: (a) data=1 x model=2 done, {time.perf_counter() - t0:.1f} s in")
    tp_dp_tp(device)
    log(f"phase 17: (b, c) data=2 x model=2 done, {time.perf_counter() - t0:.1f} s in")
    return launches


# phase 18: the models' compute dtype.  The card's bfloat16 step against its
# float32 step, from one state and one batch: rho and g within 5% (the CPU
# tests' rho bound against the JAX package); the loss before the step within
# 2e-2 and the BatchNorm statistics within 2e-2 (the tests' bound on the
# statistics); the update within 0.5 of the float32 one by the 2-norm of the
# tree.  The update carries mu * grad g, and the vGHv behind grad g is the
# least accurate product at bfloat16: the JAX package's own bfloat16 vGHv
# sits 0.15-0.25 from its float32 one leaf by leaf, and its bfloat16 step
# 0.13 from its float32 step, on the tests' depth-10 DenseNet3
# (tests/test_torch_dtype.py); the port's step on DenseNet-40 sat 0.23
# from its float32 step on the CPU.  A lost cast or a bfloat16 statistic
# shows as O(1).
BF16_RHO_RTOL = 5e-2
BF16_F_RTOL = 2e-2
BF16_STATS_TOL = 2e-2
BF16_UPDATE_RTOL = 0.5


def _bf16_densenet(depth=40):
    from optwboundeigenval_tpu_torch.models.densenet import DenseNet3

    return DenseNet3(depth=depth, growth_rate=12, num_classes=10, dtype=torch.bfloat16)


@contextlib.contextmanager
def _k1_recorded():
    """Every K1 call of the curvature products inside, held bit for bit
    against its plain version on clones of the same accumulator; yields
    ``{"calls", "dtypes", "mismatch"}`` (the count of leaves that differ
    stays on the card until it is read)."""
    from optwboundeigenval_tpu_torch.ops import curvature
    from optwboundeigenval_tpu_torch.ops import pallas_kernels as pk

    rec = {"calls": 0, "dtypes": set(), "mismatch": []}

    def recording(acc, delta, alpha, init=False):
        want = pk.axpy_accumulate_plain([a.clone() for a in acc], delta, alpha, init=init)
        out = pk.axpy_accumulate(acc, delta, alpha, init=init)
        rec["calls"] += 1
        rec["dtypes"] |= {str(a.dtype).removeprefix("torch.") for a in acc}
        diff = torch._foreach_sub([a.float() for a in out], [w.float() for w in want])
        rec["mismatch"].append(torch.stack(torch._foreach_norm(diff)).ne(0).sum())
        return out

    curvature.axpy_accumulate, real = recording, curvature.axpy_accumulate
    try:
        yield rec
    finally:
        curvature.axpy_accumulate = real


def _mismatched(rec):
    return int(torch.stack(rec["mismatch"]).sum()) if rec["mismatch"] else 0


def bf16_recipe(device="cuda", rows=128):
    """Phase 18 (a): ``cifar10_densenet_mu0_01_K0`` with its model at
    bfloat16 compute, ``max_iter=1``, through ``driver.run`` on the first
    ``rows`` rows of each split, the recipe's remat and augmentation as
    phase 10 runs it.  Returns K1's launches (none: no micro-batching)."""
    from optwboundeigenval_tpu_torch.configs import cifar10_densenet_mu0_01_K0 as cfg
    from optwboundeigenval_tpu_torch.data.loaders import ArrayLoader

    cuda = device == "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        opts = cfg.options(max_iter=1, device=device, log_dir=f"{tmp}/logs",
                           model_dir=f"{tmp}/models", model=_bf16_densenet())
        if not opts["remat"] or opts["train_loader"].augment is None:
            fail("bf16 recipe: the recipe lost augment or remat")
        bs, aug = opts["batch_size"], opts["train_loader"].augment
        cut = lambda ld, **kw: ArrayLoader(ld.x[:rows], ld.y[:rows], bs, **kw)
        opts["train_loader"] = cut(opts["train_loader"], shuffle=True, seed=1226, augment=aug)
        opts["valid_loader"] = cut(opts["valid_loader"])
        opts["train_loader_na"] = cut(opts["train_loader_na"])
        opts["test_loader"] = [cut(opts["test_loader"][0])]
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        label = "cifar10_densenet_mu0_01_K0 bf16"
        trainer, batch, launches = run_epochs(label, opts, device, 1)
        mem = torch.cuda.max_memory_allocated() if cuda else "not measured"
    out = trainer.task.predict(trainer.params, trainer.model_state, batch)
    dtypes = {str(t.dtype) for t in list(trainer.params.values())
              + list(trainer.model_state.values())}
    log(f"{label}: remat {trainer.remat}, pow_iters per step {trainer.epoch_pow_iters}, "
        f"max_memory_allocated {mem} B, logits {out.dtype}, params and statistics {dtypes}")
    if out.dtype != torch.bfloat16 or dtypes != {"torch.float32"}:
        fail(f"{label}: logits {out.dtype}, params and statistics {dtypes}")
    if cuda:
        phase_profile(trainer, batch, label)
    return launches


def hvp_rates(device="cuda", batch=128, reps=1, counts=(2, 8)):
    """Phase 18 (a): the JAX bench's DenseNet-40 HVP rate (``bench.py``,
    batch 128, ``remat``: each HVP recomputes forward and gradient) at
    bfloat16 and at float32 compute: HVPs/s from the difference of two
    runs of ``counts`` normalised HVPs, median (min-max) of ``reps``."""
    from optwboundeigenval_tpu_torch.models.densenet import DenseNet3
    from optwboundeigenval_tpu_torch.ops import curvature
    from optwboundeigenval_tpu_torch.train.task import Task
    from optwboundeigenval_tpu_torch.utils.tree import tree_norm, tree_scale, tree_uniform_like

    rng = np.random.default_rng(0)
    b = {"x": torch.from_numpy(rng.normal(size=(batch, 32, 32, 3)).astype(np.float32)),
         "y": torch.from_numpy(rng.integers(0, 10, size=batch).astype(np.int32)),
         "w": torch.ones(batch)}
    b = {k: t.to(device) for k, t in b.items()}
    out = {}
    for label, dtype in (("bfloat16", torch.bfloat16), ("float32", None)):
        task = Task(model=DenseNet3(depth=40, growth_rate=12, num_classes=10, dtype=dtype),
                    has_batch_stats=True)
        params, state = task.init(torch.Generator().manual_seed(1226), device)
        _, hvp_fn = curvature.recompute_hvp(task.loss_fn(state), params, b)

        def run(n):
            v = tree_uniform_like(params)
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(n):
                hv = hvp_fn(v)
                v = tree_scale(1.0 / tree_norm(hv), hv)
            _sync(device)
            return time.perf_counter() - t0

        run(1)  # warm
        rates = sorted((counts[1] - counts[0]) / (run(counts[1]) - run(counts[0]))
                       for _ in range(reps))
        out[label] = rates
        log(f"DenseNet-40 HVP rate, batch {batch}, remat, {label} compute: "
            f"{rates[len(rates) // 2]:.3f} HVPs/s, median (min-max) of {reps}: "
            f"({rates[0]:.3f}-{rates[-1]:.3f})")
        del hvp_fn, params
    return out


def bf16_k1_steps(device="cuda", steps=2):
    """Phase 18 (b): 2 steps of the recipe at bfloat16 compute with
    ``hvp_micro=2, remat=False``: K1 launches ``2 * (pow_iters + 2)`` times
    a step, every accumulate's leaves float32, every call bit-equal to its
    plain version.  Returns K1's launches."""
    from optwboundeigenval_tpu_torch.configs import cifar10_densenet_mu0_01_K0 as cfg
    from optwboundeigenval_tpu_torch.ops import pallas_kernels as pk
    from optwboundeigenval_tpu_torch.train.driver import build_trainer

    opts = cfg.options(hvp_micro=2, remat=False, augment=False, device=device,
                       model=_bf16_densenet())
    tr = build_trainer(opts)
    batches = iter(opts["train_loader"])
    pk.axpy_accumulate.launches = 0
    with _k1_recorded() as rec:
        for i in range(steps):
            before = pk.axpy_accumulate.launches
            _sync(device)
            t0 = time.perf_counter()
            m = tr.train_step(next(batches))
            _sync(device)
            launched = pk.axpy_accumulate.launches - before
            want = tr.hvp_micro * (m["pow_iters"] + 2)
            log(f"bf16 hvp_micro=2 step {i}: rho {m['rho']:.6g} pow_iters {m['pow_iters']} "
                f"g {m['g']:.6g} step_ms {1e3 * (time.perf_counter() - t0):.1f} "
                f"K1_launches {launched} (expected {want})")
            if not (m["step_ok"] and math.isfinite(m["rho"])):
                fail(f"bf16 hvp_micro=2 step {i}: {m}")
            if device == "cuda" and launched != want:
                fail(f"bf16 hvp_micro=2 step {i}: {launched} K1 launches, expected {want}")
    bad = _mismatched(rec)
    log(f"bf16 hvp_micro=2: {rec['calls']} K1 calls on leaves of {sorted(rec['dtypes'])}, "
        f"{bad} leaves differing from the plain version")
    if rec["dtypes"] != {"float32"} or bad:
        fail(f"bf16 hvp_micro=2: K1 on {rec['dtypes']}, {bad} leaves differing")
    return pk.axpy_accumulate.launches


def bf16_cxr(device="cuda", px=CXR_PX, rows=(4, 4, 4)):
    """Phase 18 (c): ``chestxray_mu0_01_K0`` with ``CXRModel(densenet121)``
    at bfloat16 compute, 224 px, batch 4, one step through ``driver.run``
    (the stand-ins of phase 13, cut to 4 rows of each set; 2 steps on 8
    train rows before the time budget).
    Returns K1's launches (none)."""
    from optwboundeigenval_tpu_torch.configs import chestxray_mu0_01_K0 as cfg
    from optwboundeigenval_tpu_torch.models.cxr import CXRModel

    cuda = device == "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        opts = cfg.options(max_iter=1, device=device, log_dir=f"{tmp}/logs",
                           model_dir=f"{tmp}/models", **cxr_loaders(rows, px),
                           model=CXRModel("densenet121", outnum=14, dtype=torch.bfloat16))
        if not opts["remat"] or opts["batch_size"] != 4:
            fail("bf16 chestxray: the recipe lost remat or batch 4")
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        label = "chestxray_mu0_01_K0 bf16"
        trainer, batch, launches = run_epochs(label, opts, device, 1)
        mem = torch.cuda.max_memory_allocated() if cuda else "not measured"
    out = trainer.task.predict(trainer.params, trainer.model_state, batch)
    log(f"{label}: {trainer.ndim} parameters at {px} px, pow_iters per step "
        f"{trainer.epoch_pow_iters}, max_memory_allocated {mem} B, logits {out.dtype}")
    if out.dtype != torch.bfloat16:
        fail(f"{label}: logits {out.dtype}")
    if cuda:
        phase_profile(trainer, batch, label)
    return launches


def _tree_rel(a, b):
    """``||a - b|| / ||b||`` over the whole tree, in float32."""
    num = sum(float(((x.float() - b[k].float()) ** 2).sum()) for k, x in a.items())
    den = sum(float((b[k].float() ** 2).sum()) for k in a)
    return math.sqrt(num / max(den, 1e-300))


def bf16_card_vs_card(device="cuda"):
    """Phase 18 (d), first half: from one state and one batch, a bfloat16
    ``train_step`` and a float32 one of the recipe (batch 32, remat)."""
    from optwboundeigenval_tpu_torch.configs import cifar10_densenet_mu0_01_K0 as cfg
    from optwboundeigenval_tpu_torch.models.densenet import DenseNet3
    from optwboundeigenval_tpu_torch.train.driver import build_trainer

    batch = next(iter(cfg.options(device="cpu", augment=False)["train_loader_na"]))
    res = {}
    for label, dtype in (("bfloat16", torch.bfloat16), ("float32", None)):
        tr = build_trainer(cfg.options(device=device, model=DenseNet3(
            depth=40, growth_rate=12, num_classes=10, dtype=dtype)))
        tr.init_state()
        p0 = {k: t.clone() for k, t in tr.params.items()}
        f = float(tr.task.loss_fn(tr.model_state)(tr.params, tr.put_batch(batch)))
        m = tr.train_step(batch)
        res[label] = (m, f, {k: tr.params[k] - p0[k] for k in p0}, tr.model_state)
    (mb, fb, ub, sb), (mf, ff, uf, sf) = res["bfloat16"], res["float32"]
    errs = {"rho": abs(mb["rho"] - mf["rho"]) / abs(mf["rho"]),
            "g": abs(mb["g"] - mf["g"]) / max(abs(mf["g"]), 1e-30),
            "f": abs(fb - ff) / abs(ff), "update": _tree_rel(ub, uf),
            "bn_stats": max(float((sb[k] - sf[k]).abs().max()) for k in sf)}
    bounds = {"rho": BF16_RHO_RTOL, "g": BF16_RHO_RTOL, "f": BF16_F_RTOL,
              "update": BF16_UPDATE_RTOL, "bn_stats": BF16_STATS_TOL}
    log(f"bf16 vs float32 step on the card: rho {mb['rho']:.6g} vs {mf['rho']:.6g}, "
        f"pow_iters {mb['pow_iters']} vs {mf['pow_iters']}, "
        + ", ".join(f"{k} {v:.3e} (bound {bounds[k]:g})" for k, v in errs.items()))
    if not all(errs[k] <= bounds[k] for k in errs):
        fail("bf16 step on the card: disagrees with the float32 step")


def bf16_card_vs_cpu(device="cuda", batch_size=4):
    """Phase 18 (d), second half: a bfloat16 forward, gradient and HVP of
    DenseNet-40 on the card against the port's bfloat16 on the CPU, within
    the tests' rule with the CPU's bfloat16 value as ``jb`` and its float32
    value as ``jf``, by the 2-norm of the logits and of the whole gradient
    and HVP trees (``tests/test_torch_dtype.py``, TREE_NORM): two bfloat16
    computations by other convolution kernels (cuDNN's against oneDNN's)
    part by an ulp here and there at each of the 40 layers, where the CPU's
    bfloat16 logit can sit on its float32 value at an element."""
    from optwboundeigenval_tpu_torch.configs import cifar10_densenet_mu0_01_K0 as cfg
    from optwboundeigenval_tpu_torch.models.densenet import DenseNet3
    from optwboundeigenval_tpu_torch.ops import curvature
    from optwboundeigenval_tpu_torch.train.task import Task
    from optwboundeigenval_tpu_torch.utils.tree import tree_uniform_like

    ld = cfg.options(device="cpu", augment=False)["train_loader_na"]
    b = {k: torch.as_tensor(v[:batch_size]) for k, v in next(iter(ld)).items()}
    params, state = Task(model=DenseNet3(depth=40, growth_rate=12, num_classes=10),
                         has_batch_stats=True).init(torch.Generator().manual_seed(7), "cpu")
    v = {k: t + 1e-2 * torch.randn(t.shape, generator=torch.Generator().manual_seed(8))
         for k, t in tree_uniform_like(params).items()}
    got = {}
    for label, dev, dtype in (("card bf16", device, torch.bfloat16),
                              ("cpu bf16", "cpu", torch.bfloat16), ("cpu f32", "cpu", None)):
        task = Task(model=DenseNet3(depth=40, growth_rate=12, num_classes=10, dtype=dtype),
                    has_batch_stats=True)
        on = lambda t: {k: x.to(dev) for k, x in t.items()}
        p, s, bb, vv = on(params), on(state), on(b), on(v)
        f = task.loss_fn(s)
        out = task._apply(p, s, bb["x"], True)
        _, g = curvature.value_and_grad(f, p, bb)
        hv = curvature.hvp(f, p, bb, vv)
        got[label] = {"logits": {"": out.float().cpu()},
                      "grad": {k: t.float().cpu() for k, t in g.items()},
                      "hvp": {k: t.float().cpu() for k, t in hv.items()}}
    card, jb, jf = got["card bf16"], got["cpu bf16"], got["cpu f32"]
    excess = {}
    for what in ("logits", "grad", "hvp"):
        err = math.sqrt(sum(float(((card[what][k] - jb[what][k]) ** 2).sum()) for k in jb[what]))
        own = math.sqrt(sum(float(((jb[what][k] - jf[what][k]) ** 2).sum()) for k in jb[what]))
        size = math.sqrt(sum(float((jf[what][k] ** 2).sum()) for k in jb[what]))
        excess[what] = err - (3 * own + 1e-2 * size)
        log(f"bf16 card vs CPU {what}: ||card - cpu bf16|| {err:.4e}, bound "
            f"{3 * own + 1e-2 * size:.4e} (cpu bf16 vs f32 {own:.4e}, ||f32|| {size:.4e})")
    if max(excess.values()) > 0:
        fail(f"bf16 card vs CPU: over the bound {excess}")


def bf16_gemm_usps(device="cuda"):
    """Phase 18 (e): one ``usps_cnn_mu0_01_K0`` step with the gemm CNNUSPS
    at bfloat16 compute (its convs' parameters bfloat16, the dense ones
    float32) and ``hvp_micro=2``: K1 launches its bfloat16 and float32
    entries, one launch a dtype a call, each call bit-equal to its plain
    version.  Returns K1's launches."""
    from optwboundeigenval_tpu_torch.configs import usps_cnn_mu0_01_K0 as cfg
    from optwboundeigenval_tpu_torch.models.cnn_usps import CNNUSPS
    from optwboundeigenval_tpu_torch.ops import pallas_kernels as pk
    from optwboundeigenval_tpu_torch.train.driver import build_trainer

    opts = cfg.options(hvp_micro=2, device=device,
                       model=CNNUSPS(conv_impl="gemm", dtype=torch.bfloat16))
    tr = build_trainer(opts)
    tr.init_state()
    held = sorted({str(t.dtype).removeprefix("torch.") for t in tr.params.values()})
    batch = next(iter(opts["train_loader"]))
    pk.axpy_accumulate.launches = 0
    with _k1_recorded() as rec:
        m = tr.train_step(batch)
        _sync(device)
    launched, want = pk.axpy_accumulate.launches, 2 * tr.hvp_micro * (m["pow_iters"] + 2)
    bad = _mismatched(rec)
    log(f"gemm CNNUSPS bf16 hvp_micro=2 step: params {held}, rho {m['rho']:.6g} pow_iters "
        f"{m['pow_iters']}, {rec['calls']} K1 calls on leaves of {sorted(rec['dtypes'])}, "
        f"{launched} launches (expected {want}), {bad} leaves differing from the plain version")
    if not (m["step_ok"] and math.isfinite(m["rho"])) or held != ["bfloat16", "float32"]:
        fail(f"gemm CNNUSPS bf16 step: {m}, params {held}")
    if rec["dtypes"] != {"bfloat16", "float32"} or bad:
        fail(f"gemm CNNUSPS bf16 step: K1 on {rec['dtypes']}, {bad} leaves differing")
    if device == "cuda" and launched != want:
        fail(f"gemm CNNUSPS bf16 step: {launched} K1 launches, expected {want}")
    return launched


def phase_dtype(device="cuda"):
    """Phase 18: the models' compute dtype.  Returns K1's launches."""
    t0 = time.perf_counter()
    launches = bf16_recipe(device)
    hvp_rates(device)
    log(f"phase 18: (a) done, {time.perf_counter() - t0:.1f} s in")
    launches += bf16_k1_steps(device)
    log(f"phase 18: (b) done, {time.perf_counter() - t0:.1f} s in")
    launches += bf16_cxr(device)
    log(f"phase 18: (c) done, {time.perf_counter() - t0:.1f} s in")
    bf16_card_vs_card(device)
    bf16_card_vs_cpu(device)
    log(f"phase 18: (d) done, {time.perf_counter() - t0:.1f} s in")
    launches += bf16_gemm_usps(device)
    log(f"phase 18: (e) done, {time.perf_counter() - t0:.1f} s in")
    return launches


# phase 19: the Asymmetric Valley trainer under a mesh and the micro-batched
# step on a data mesh.  AV as usps_cnn_asymmetric_valley publishes it but
# cut to 4 epochs (SWA from 2, the hunt from 3) and a 5-point sweep
# (distances 1, division_part 2), for time
AV_MESH = dict(max_iter=4, swa_start=2, sgd_start=3, save_freq=1, eval_freq=1,
               distances=1, division_part=2)
# the first rows of each split: on the full stand-in (6,250 train rows, 196
# steps) the float64 run is chaotic, a 1e-15 relative change of the initial
# weights moving the sweep's losses by 1.2e-3 and the ranks' summation order
# by up to 3.5e-6 (CPU, PERF.md section 6), beyond CARD_F64_RTOL
AV_ROWS = {"train_loader": 512, "valid_loader": 256, "train_loader_na": 512,
           "test_loader": 256}
AV_RESULTS = ("train_loss", "test_loss", "train_acc", "test_acc")
AV_SHARDED = ["conv2.weight", "conv3.weight", "fc1.weight"]  # at min_elems=1024
MICRO_ROWS = 8  # the float64 DenseNet-40 step's global batch: 4 rows a rank


def _peak_reset(device):
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()


def _peak(device):
    return torch.cuda.max_memory_allocated() if device == "cuda" else 0


@contextlib.contextmanager
def _f_per_epoch():
    """The Asymmetric Valley trainer's epoch ``f`` at full precision, one
    value an epoch (its log prints 6 decimals), while the block runs."""
    from optwboundeigenval_tpu_torch.train.asymmetric_valley import AsymmetricValleyTrainer

    fs, real = [], AsymmetricValleyTrainer.train_epoch

    def recording(self, loader):
        out = real(self, loader)
        fs.append(self.f)
        return out

    AsymmetricValleyTrainer.train_epoch = recording
    try:
        yield fs
    finally:
        AsymmetricValleyTrainer.train_epoch = real


def av_mesh_run(device, tmp, mesh=None):
    """Phase 19 (a): ``usps_cnn_asymmetric_valley`` at float64 with
    ``AV_MESH``, through ``driver.run`` in one process or on ``data=2``
    (each rank its block of the config's global batches); on ``data=1 x
    model=2`` built by ``driver.build_trainer``, CNNUSPS's ``conv2``,
    ``conv3`` and ``fc1`` sharded at ``min_elems=1024`` and trained as
    ``driver.run`` trains it.  Where the hunt finds no SGD point the sweep
    runs from the last SGD weights (as phase 12 does), so it runs on every
    process.  Returns ``f`` per epoch, rank 0's results (none elsewhere),
    the gathered SWA params, the steps, seconds and peak device memory."""
    from optwboundeigenval_tpu_torch.configs import usps_cnn_asymmetric_valley as cfg
    from optwboundeigenval_tpu_torch.data.loaders import ArrayLoader
    from optwboundeigenval_tpu_torch.models.cnn_usps import CNNUSPS
    from optwboundeigenval_tpu_torch.parallel import shard_params
    from optwboundeigenval_tpu_torch.train import driver

    opts = cfg.options(device=device, mesh=mesh, model=CNNUSPS().double(),
                       log_dir=f"{tmp}/logs", model_dir=f"{tmp}/models",
                       plot_dir=f"{tmp}/plots", **AV_MESH)
    for key, n in AV_ROWS.items():
        old = opts[key]
        cut = lambda l: ArrayLoader(l.x[:n], l.y[:n], l.batch_size, shuffle=l.shuffle, seed=5)
        opts[key] = [cut(l) for l in old] if isinstance(old, list) else cut(old)
    _peak_reset(device)
    _sync(device)
    t0 = time.perf_counter()
    with _f_per_epoch() as f:
        if mesh is None or mesh.model == 1:
            tr = driver.run(opts)
        else:
            tr = driver.build_trainer(opts)
            tr.init_state()
            tr.params = shard_params(tr.params, mesh, 1024, tr.task.model)
            tr.train(train_loader=opts["train_loader"], valid_loader=opts["valid_loader"])
    hunted = tr.sgd_path is not None
    if not tr.interpolated:
        tr.sgd_path = tr._save_full("sgd_last")
        tr.interpolation(opts["train_loader"], opts["valid_loader"])
    _sync(device)
    out = {"seconds": time.perf_counter() - t0, "peak": _peak(device), "hunted": hunted,
           "f": f,
           "interpolated": tr.interpolated, "swa_n": tr.swa_n, "steps": tr.steps_done,
           "swa": {k: t.detach().cpu() for k, t in tr._full(tr.swa_params).items()},
           "sharded": sorted(tr._sharding.dims) if tr._sharding is not None else [],
           "on_card": all(t.device.type == torch.device(device).type
                          for t in tr.params.values())}
    if tr._writer:
        out["results"] = {k: np.loadtxt(os.path.join(tr.log_dir,
                                                      f"asymmetric_valley_{k}_results.txt"))
                          for k in AV_RESULTS}
    return out


def av_mesh_micro(device, mesh=None, steps=1):
    """Phase 19 (b): the DenseNet-40 recipe (full width) at float64 with
    ``hvp_micro=2, remat=False`` and ``F64_POW_ITERS`` HVPs at most,
    ``steps`` steps on the first
    ``MICRO_ROWS`` rows a step in their natural order (on ``data=2`` each
    rank its block: 4 rows in 2 micro-batches, its share of the global
    micro-batches), every K1 call held bit for bit to its plain version.
    Returns ``rho``, ``g``, ``pow_iters``, params and BatchNorm statistics,
    K1's launches and checked calls, seconds and peak device memory."""
    from optwboundeigenval_tpu_torch.data.loaders import ArrayLoader
    from optwboundeigenval_tpu_torch.ops import pallas_kernels as pk
    from optwboundeigenval_tpu_torch.parallel import shard_batch

    tr, na = _f64_trainer(device, batch_size=MICRO_ROWS, mesh=mesh, hvp_micro=2,
                          remat=False, **F64_CAP)
    rows = MICRO_ROWS * steps
    batches = list(ArrayLoader(na.x[:rows], na.y[:rows], MICRO_ROWS))
    if mesh is not None:
        batches = [shard_batch(b, mesh) for b in batches]
    metrics = []
    _peak_reset(device)
    _sync(device)
    t0 = time.perf_counter()
    pk.axpy_accumulate.launches = 0
    with _k1_recorded() as rec:
        for b in batches:
            metrics.append(tr.train_step(b))
    _sync(device)
    return {"seconds": time.perf_counter() - t0, "peak": _peak(device),
            "launches": pk.axpy_accumulate.launches, "calls": rec["calls"],
            "mismatched": _mismatched(rec),
            "m": [{k: m[k] for k in ("rho", "g", "pow_iters", "step_ok")} for m in metrics],
            "params": {k: t.detach().cpu() for k, t in tr.params.items()},
            "stats": {k: t.detach().cpu() for k, t in tr.model_state.items()}}


def av_rank(args):
    """One rank of phase 19, started by :func:`phase_av_mesh`: (a) on
    ``data=2``, then on ``data=1 x model=2``; (b) on ``data=2``."""
    from optwboundeigenval_tpu_torch.parallel import make_mesh

    device, rank, tmp = args["--device"], args["--rank"], args["--out"]
    at = None if device == "cuda" else device
    data2, model2 = make_mesh(data=2, device=at), make_mesh(data=1, model=2, device=at)
    out = {"data": av_mesh_run(device, f"{tmp}/rank{rank}/data", data2),
           "model": av_mesh_run(device, f"{tmp}/rank{rank}/model", model2),
           "micro": av_mesh_micro(device, data2)}
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def _av_errs(got, want):
    """Relative errors of an AV run against one process's: the SWA params,
    ``f`` per epoch and, on rank 0, the four results arrays."""
    errs = {"SWA params": _rel(got["swa"], want["swa"]),
            "f per epoch": _rel(torch.tensor(got["f"]), torch.tensor(want["f"]))}
    if "results" in got:
        errs.update({k: _rel(torch.from_numpy(np.atleast_1d(got["results"][k])),
                             torch.from_numpy(np.atleast_1d(want["results"][k])))
                     for k in AV_RESULTS})
    return errs


def phase_av_mesh(device="cuda"):
    """Phase 19: one spawn of 2 gloo ranks sharing the card runs (a) and (b)
    while this process runs them alone; every rank against one process
    within ``CARD_F64_RTOL``.  Returns K1's launches on rank 0."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        procs = _spawn_ranks(tmp, device, 2, "av")
        try:
            one = {"av": av_mesh_run(device, f"{tmp}/one"), "micro": av_mesh_micro(device)}
        finally:
            ranks = _join_ranks(procs, tmp, "phase 19", AV_WAIT_S)
    want = one["av"]
    log(f"phase 19 (a) usps_cnn_asymmetric_valley float64, one process: {want['steps']} steps "
        f"in {AV_MESH['max_iter']} epochs, {want['seconds']:.2f} s, peak {want['peak']} B, "
        f"swa_n {want['swa_n']}, the hunt found an SGD point: {want['hunted']}, f per epoch "
        f"{want['f']}, valid accuracy along the sweep {want['results']['test_acc'].tolist()}")
    if not (want["on_card"] and want["interpolated"] and want["swa_n"] >= 1
            and all(math.isfinite(f) for f in want["f"])):
        fail(f"phase 19 (a): the one-process run {want}")
    for axes in ("data", "model"):
        for r, res in enumerate(ranks):
            got = res[axes]
            log(f"phase 19 (a) {axes} axis, rank {r}: {got['steps']} steps, "
                f"{got['seconds']:.2f} s against {want['seconds']:.2f} s in one process, peak "
                f"{got['peak']} B, sharded {got['sharded']}, swa_n {got['swa_n']}, hunted "
                f"{got['hunted']}")
            if (got["swa_n"], got["hunted"], got["steps"]) != (
                    want["swa_n"], want["hunted"], want["steps"]) or not got["on_card"]:
                fail(f"phase 19 (a) {axes}: rank {r} took another course than one process")
            if got["sharded"] != (AV_SHARDED if axes == "model" else []):
                fail(f"phase 19 (a) {axes}: rank {r} sharded {got['sharded']}")
            if (r == 0) != ("results" in got) or len(got["f"]) != AV_MESH["max_iter"]:
                fail(f"phase 19 (a) {axes}: rank {r} wrote the results: {'results' in got}, "
                     f"f over {len(got['f'])} epochs")
            _tp_check(f"phase 19 (a) AV on {axes}={2}, rank {r} vs one process",
                      _av_errs(got, want), CARD_F64_RTOL)
    want = one["micro"]
    for r, res in enumerate(ranks):
        got = res["micro"]
        for i, (m, w) in enumerate(zip(got["m"], want["m"])):
            expected = 2 * (m["pow_iters"] + 2)
            log(f"phase 19 (b) DenseNet-40 float64 hvp_micro=2 data=2, rank {r} step {i}: rho "
                f"{m['rho']:.12g} pow_iters {m['pow_iters']} g {m['g']:.6g}; one process rho "
                f"{w['rho']:.12g} pow_iters {w['pow_iters']}")
            if m["pow_iters"] != w["pow_iters"] or not m["step_ok"]:
                fail(f"phase 19 (b): rank {r} step {i} {m} against one process {w}")
        expected = sum(2 * (m["pow_iters"] + 2) for m in got["m"])
        log(f"phase 19 (b) rank {r}: {got['seconds']:.2f} s against {want['seconds']:.2f} s "
            f"in one process, peak {got['peak']} B against {want['peak']} B; K1 launches "
            f"{got['launches']} (expected {expected}), {got['calls']} calls held to the plain "
            f"version, {got['mismatched']} leaves differing")
        if device == "cuda" and (got["launches"] != expected or got["calls"] != expected):
            fail(f"phase 19 (b): rank {r} K1 launches {got['launches']}, checked calls "
                 f"{got['calls']}, expected {expected}")
        if got["mismatched"]:
            fail(f"phase 19 (b): rank {r}'s K1 and its plain version differ")
        errs = {k: _rel(torch.tensor([m[k] for m in got["m"]]),
                        torch.tensor([m[k] for m in want["m"]])) for k in ("rho", "g")}
        errs["params"] = _rel(got["params"], want["params"])
        errs["BatchNorm statistics"] = _rel(
            {k: t for k, t in got["stats"].items() if t.is_floating_point()},
            {k: t for k, t in want["stats"].items() if t.is_floating_point()})
        _tp_check(f"phase 19 (b) rank {r} vs one process", errs, CARD_F64_RTOL)
    log(f"phase 19: {time.perf_counter() - t0:.1f} s")
    return ranks[0]["micro"]["launches"]


def _watchdog(t0, deadline=DEADLINE_S):
    """At ``deadline`` s after ``t0``: name the phase in progress, kill every
    rank process still alive, dump all threads' stacks and exit 1."""
    def fire():
        log(f"WATCHDOG: {time.perf_counter() - t0:.0f} s since the start, past the "
            f"{deadline} s deadline, in {_RUN['phase']}; killing the ranks")
        _kill_ranks()
        faulthandler.dump_traceback(file=sys.stdout, all_threads=True)
        sys.stdout.flush()
        os._exit(1)

    timer = threading.Timer(max(deadline - (time.perf_counter() - t0), 0.0), fire)
    timer.daemon = True
    timer.start()
    return timer


def main():
    if "--rank" in sys.argv:
        phase = dict(zip(sys.argv[1::2], sys.argv[2::2])).get("--phase")
        return _rank_main({None: mesh_rank, "tp2": tp_rank, "tp4": tp_rank,
                           "av": av_rank}[phase])
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")
    t0 = time.perf_counter()
    _watchdog(t0)
    times = []

    def begin(phase):
        _RUN["phase"], _RUN["since"] = phase, time.perf_counter()

    def done(phase):
        now = time.perf_counter()
        times.append((phase, now - _RUN["since"]))
        log(f"[{now - t0:.0f} s] {phase} done, {now - _RUN['since']:.1f} s")
        begin(f"the phase after {phase}")

    begin("phases 1-2")
    smi = phase_card()
    phase_build()
    done("phases 1-2")
    entry = phase_kernel_check(densenet40_leaf_shapes())
    done("phase 3")
    trainer, batch, launches = phase_slice()
    phase_profile(trainer, batch)
    done("phases 4-5")
    phase_card_vs_cpu(trainer, batch)
    done("phase 6")
    power_hvps, rates = {}, {}
    for label, (tr, b, n) in phase_epochs().items():
        phase_profile(tr, b, label)
        launches += n
        power_hvps[label] = tr.mean_pow_iters
        steps, g = EPOCHS * len(tr.epoch_pow_iters), tr.timers.totals["G"]
        rates[label] = (steps / g, tr.mean_pow_iters)
    done("phase 7")
    tr, b, n = phase_densenet_epoch()
    phase_profile(tr, b, "cifar10_densenet_mu0_01_K0 epoch trainer")
    launches += n
    done("phase 8")
    phase_cached_hvp()
    done("phase 9")
    n, published = phase_recipe()
    launches += n
    done("phase 10")
    launches += phase_eigensolvers(power_hvps)
    done("phase 11")
    launches += phase_comparators()
    done("phase 12")
    launches += phase_cxr()
    done("phase 13")
    phase_analysis()
    done("phase 14")
    launches += phase_surface(lax=rates["usps_cnn_mu0_01_K0"])
    done("phase 15")
    launches += phase_knobs(published=published)
    done("phase 16")
    launches += phase_model_axis()
    done("phase 17")
    launches += phase_dtype()
    done("phase 18")
    launches += phase_av_mesh()
    done("phase 19")
    total = time.perf_counter() - t0
    log("phase seconds: " + ", ".join(f"{p} {t:.1f}" for p, t in times)
        + f"; total {total:.1f} s of the {BUDGET_S} s budget"
        + ("" if total <= BUDGET_S else f", OVER BUDGET by {total - BUDGET_S:.1f} s"))
    kernels = [{**entry, "launches": launches}]
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

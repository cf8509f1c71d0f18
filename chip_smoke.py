"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Phases (any failure exits non-zero and prints no result line):

1. the card: ``nvidia-smi`` name and power limit, torch and CUDA
   versions; TF32 is switched off for convolutions and matmuls;
2. build every CUDA kernel of the port with ``nvcc`` (one process per
   source, started together) and print the build time;
3. hold every kernel against its plain PyTorch version on the card, at
   the shapes the main path gives it plus ragged and large ones, and
   time kernel, plain version and the PyTorch library call;
4. the main path: the ``cifar10_densenet_mu0_01_K0`` recipe (DenseNet-40-12
   on CIFAR-10, full width, batch 32) with ``remat=False, hvp_micro=2,
   augment=False``, built through the config driver and run for 5
   ``train_step``s; the kernel launch counts are set to 0 just before
   and read just after;
5. one more step under ``torch.profiler``: the device's busy share and
   the kernels that take the time;
6. the card against the CPU: HVP and vGHv at the trained weights,
   float32 (micro-batched, through K1) and float64 on the card vs
   float64 with the port on the CPU;
7. a ``{"kernels": [...]}`` line, the card's name and power limit, and
   last the ``{"ok": true, "device": ...}`` line.

Weights are random (seed 1226); the data is the CIFAR-10 pickle set when
``./data/cifar-10-batches-py`` exists, else its synthetic stand-in.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12  # float32 outside the tensor cores
STEPS = 5
# kernel vs plain: the kernel rounds as fl(acc + fl(alpha * delta)), like
# the plain version, so the two should agree bit for bit; allow 1 ulp
KERNEL_RTOL = torch.finfo(torch.float32).eps
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
    smi = nvidia_smi()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    log(f"tf32: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    return smi


def phase_build():
    from optwboundeigenval_tpu_torch.utils import cuda_build

    for old in cuda_build.BUILD_DIR.glob("*.so") if cuda_build.BUILD_DIR.exists() else ():
        old.unlink()  # build from the sources of this checkout, every run
    t0 = time.perf_counter()
    paths = cuda_build.build(["axpy_accumulate"])
    log(f"build: {time.perf_counter() - t0:.3f} s -> "
        + ", ".join(str(p.name) for p in paths.values()))


def densenet40_leaf_shapes():
    from optwboundeigenval_tpu_torch.models.densenet import DenseNet3

    m = DenseNet3(depth=40, growth_rate=12, num_classes=10)
    return [tuple(p.shape) for p in m.parameters()]


def phase_kernel_check(leaf_shapes):
    """K1 against its plain version on the card; returns the kernel entry
    of the kernels line (without ``launches``)."""
    from optwboundeigenval_tpu_torch.ops import pallas_kernels as pk

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1226)
    alpha = torch.tensor(0.5 + 1.0 / 3.0, device=dev)
    cases = [(f"leaf{tuple(s)}", s) for s in leaf_shapes]
    cases += [("n=1", (1,)), ("n=3", (3,)), ("n=1000", (1000,)),
              ("(7,13)", (7, 13)), ("flat 16M", (1 << 24,))]
    max_err = 0.0
    for name, shape in cases + [("n=1000 unaligned", None)]:
        if shape is None:  # scalar (unaligned) path: a view at offset 1
            acc = torch.randn(1001, device=dev, generator=g)[1:]
            delta = torch.randn(1001, device=dev, generator=g)[1:]
        else:
            acc = torch.randn(shape, device=dev, generator=g)
            delta = torch.randn(shape, device=dev, generator=g)
        want = pk.axpy_accumulate_plain(acc.clone(), delta, alpha)
        ptr = acc.data_ptr()
        pk.axpy_accumulate(acc, delta, alpha)
        torch.cuda.synchronize()
        if acc.data_ptr() != ptr:
            fail(f"axpy_accumulate {name}: not in place")
        err = (acc - want).abs()
        if not bool((err <= KERNEL_RTOL * want.abs()).all()):
            fail(f"axpy_accumulate {name}: max abs err {err.max().item():.3e} "
                 f"over 1 ulp")
        max_err = max(max_err, err.max().item())
    log(f"axpy_accumulate: {len(cases) + 1} shapes match the plain version, "
        f"max abs err {max_err:.3e} (tolerance 1 ulp)")

    # timing at the main path's unit of work: one full-model accumulate,
    # one wrapper call per leaf (the 2.1 MB fit in L2, as in the step)
    accs = [torch.randn(s, device=dev, generator=g) for s in leaf_shapes]
    deltas = [torch.randn(s, device=dev, generator=g) for s in leaf_shapes]
    a = float(alpha)
    n = sum(t.numel() for t in accs)
    reps = 200
    kernel_ms = cuda_time_ms(lambda: [pk.axpy_accumulate(x, d, alpha)
                                      for x, d in zip(accs, deltas)], reps)
    plain_ms = cuda_time_ms(lambda: [pk.axpy_accumulate_plain(x, d, alpha)
                                     for x, d in zip(accs, deltas)], reps)
    library_ms = cuda_time_ms(lambda: [x.add_(d, alpha=a)
                                       for x, d in zip(accs, deltas)], reps)
    foreach_ms = cuda_time_ms(lambda: torch._foreach_add_(accs, deltas, alpha=a), reps)
    nbytes, nflops = 12 * n, 2 * n
    bound_ms = 1e3 * max(nbytes / H100_BYTES_PER_S, nflops / H100_FP32_FLOPS)
    log(f"axpy_accumulate per full-model accumulate ({len(accs)} leaves, {n} values, "
        f"{nbytes} B): kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"add_ per leaf {library_ms:.4f} ms, _foreach_add_ {foreach_ms:.4f} ms, "
        f"bound {bound_ms:.6f} ms (bytes)")

    big_a = torch.randn(1 << 24, device=dev, generator=g)
    big_d = torch.randn(1 << 24, device=dev, generator=g)
    k16 = cuda_time_ms(lambda: pk.axpy_accumulate(big_a, big_d, alpha), 50)
    p16 = cuda_time_ms(lambda: pk.axpy_accumulate_plain(big_a, big_d, alpha), 50)
    l16 = cuda_time_ms(lambda: big_a.add_(big_d, alpha=a), 50)
    b16 = 1e3 * 12 * (1 << 24) / H100_BYTES_PER_S
    log(f"axpy_accumulate flat 16M (201 MB moved): kernel {k16:.4f} ms "
        f"({12 * (1 << 24) / (k16 * 1e-3) / 1e9:.1f} GB/s), plain {p16:.4f} ms, add_ {l16:.4f} ms, "
        f"bound {b16:.4f} ms")
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
    leaves = len(trainer.params)
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
        # every accumulate of the step goes through K1: gradient, each
        # power-iteration HVP and the vGHv pass, 2 micro-batches each
        want = (m["pow_iters"] + 2) * trainer.hvp_micro * leaves
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


def phase_profile(trainer, batch):
    """One more step under ``torch.profiler``: the device's busy share of
    the step's wall time, K1's share, and the kernels that take most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        m = trainer.train_step(batch)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us == 0:
        log("profile: the profiler recorded no device time (not measured)")
        return
    k1_us = sum(e.self_device_time_total for e in kernels if "axpy" in e.key)
    log(f"profile (one step, pow_iters {m['pow_iters']}): wall {wall_us / 1e3:.1f} ms, "
        f"device busy {busy_us / 1e3:.1f} ms ({100 * busy_us / wall_us:.1f}%), "
        f"idle {100 * (1 - busy_us / wall_us):.1f}%, K1 {k1_us / 1e3:.2f} ms "
        f"({100 * k1_us / busy_us:.2f}% of busy), "
        f"{sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"  {e.self_device_time_total / 1e3:9.2f} ms {e.count:6d}x  {e.key[:90]}")


def phase_card_vs_cpu(trainer, batch):
    """HVP and vGHv at the trained weights on a fixed ``v``: the card
    against the port on the CPU in float64.  Float32 on the card runs the
    micro-batched path through K1.  K1 takes float32 only, so float64 on
    the card runs the plain ``hvp``/``vghv`` on the first micro-batch, a
    tight check of the device's convolutions and autodiff.  (BatchNorm
    statistics are per micro-batch, so a full-batch product is another
    operator than the micro-batched one.)"""
    from optwboundeigenval_tpu_torch.ops import curvature
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
    p64, s64, b64 = (cast(t, torch.float64, cpu) for t in
                     (trainer.params, trainer.model_state, batch))
    half = {k: t[:len(t) // micro] for k, t in b64.items()}
    f64 = task.loss_fn(s64)
    f64_card = task.loss_fn(cast(s64, torch.float64, dev))
    for name in ("hvp", "vghv"):
        micro_fn, full_fn = getattr(curvature, f"{name}_microbatched"), getattr(curvature, name)
        checks = (
            ("card f32 micro-batched (K1)", CARD_F32_RTOL,
             lambda: micro_fn(f64, p64, b64, v64, micro),
             lambda: micro_fn(task.loss_fn(trainer.model_state), trainer.params,
                              batch, cast(v64, torch.float32, dev), micro)),
            ("card f64 first micro-batch", CARD_F64_RTOL,
             lambda: full_fn(f64, p64, half, v64),
             lambda: full_fn(f64_card, cast(p64, torch.float64, dev),
                             cast(half, torch.float64, dev),
                             cast(v64, torch.float64, dev))),
        )
        for label, bound, on_cpu, on_card in checks:
            t0 = time.perf_counter()
            ref = on_cpu()
            t1 = time.perf_counter()
            out = cast(on_card(), torch.float64, cpu)
            t2 = time.perf_counter()
            rel = float(tree_norm(tree_sub(out, ref)) / tree_norm(ref))
            log(f"{name}: {label} vs cpu f64: relative error {rel:.3e} "
                f"(bound {bound:g}); card {1e3 * (t2 - t1):.1f} ms, "
                f"cpu {1e3 * (t1 - t0):.1f} ms")
            if not rel < bound:
                fail(f"{name}: {label} and the CPU disagree ({rel:.3e})")


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")
    smi = phase_card()
    phase_build()
    entry = phase_kernel_check(densenet40_leaf_shapes())
    trainer, batch, launches = phase_slice()
    phase_profile(trainer, batch)
    phase_card_vs_cpu(trainer, batch)
    kernels = [{**entry, "launches": launches}]
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

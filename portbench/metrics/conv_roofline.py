"""The convolution and matmul kernels' share of their roofline, in %:
the FLOPs of the convolutions and matmuls the profiled units executed
(``flops/``, recomputation under ``remat`` included, at their own
products) over the device seconds of the kernels whose names match
``PATTERNS`` times the peak.  At float32 with TF32 off these kernels run
on the CUDA cores, compute-bound at the 67 TFLOP/s peak."""

from portbench.flops import work_flops

# cuDNN and cuBLAS kernel names of convolutions and matmuls (their data
# layout transforms included), frozen with the benchmark
PATTERNS = ("conv", "gemm", "xmma", "cudnn", "winograd", "fft", "dgrad", "wgrad",
            "fprop", "cutlass", "implicit", "engine")


def read(ctx):
    p = ctx["profile"]
    if not p:
        return None
    secs = sum(s for name, (_, s) in p["kernels"].items()
               if any(pat in name.lower() for pat in PATTERNS))
    if not secs:
        return None
    flops = work_flops(ctx["flops"], ctx["work"], p["iters"], ctx["batch_size"],
                       executed=True, remat=ctx["remat"])
    return 100.0 * flops / (secs * ctx["peak_flops"])

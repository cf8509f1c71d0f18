"""The whole step's (or audit batch's) share of the card's peak, in %:
the FLOPs the window's work requires (``flops/``: gradient, HVPs over a
kept graph at the window's own products, vGHv, the BatchNorm forward;
never recomputation) over the window's seconds times the peak."""

from portbench.flops import work_flops


def read(ctx):
    flops = work_flops(ctx["flops"], ctx["work"], ctx["iters"], ctx["batch_size"],
                       executed=False, remat=ctx["remat"])
    return 100.0 * flops / (ctx["window_s"] * ctx["peak_flops"]) if ctx["iters"] else None

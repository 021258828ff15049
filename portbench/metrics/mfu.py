"""The whole iteration's share of the cards' float32 peak, in %: the
counted work of the window's iterations (``counts.iteration_counts``: the
kernel's operations, the policy's passes and the baseline's products, per
sample) over the window's seconds times 67 TFLOP/s per card."""

from portbench.counts import PEAK_FP32_PER_S


def read(ctx):
    work = ctx["counts"]["flops_per_sample"] * ctx["samples"]
    return 100.0 * work / (ctx["seconds"] * PEAK_FP32_PER_S * ctx["ranks"])

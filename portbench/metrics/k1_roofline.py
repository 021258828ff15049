"""K1's (the smooth planar step's) share of its roofline, in %: the frozen
operation count (``counts.count_kernel_ops``) and bytes per launch against
the published float32 peak and bandwidth, over its mean device time per
launch in the profiled iteration."""

from portbench.counts import roofline_share


def read(ctx):
    return roofline_share(ctx, "planar_step_kernel_f32")

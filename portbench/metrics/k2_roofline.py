"""K2's (the contact / RK4 planar step's) share of its roofline, in %:
the frozen operation count (``counts.count_contact_ops``) and bytes per
launch against the published float32 peak and bandwidth, over its mean
device time per launch in the profiled iteration."""

from portbench.counts import roofline_share


def read(ctx):
    return roofline_share(ctx, "planar_contact_kernel_f32")

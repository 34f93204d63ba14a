"""``csrc/cd_grads_wide.cu``'s share of its roofline: a data-parallel rank's
W-blocked step on its rows, against ``counts.wide_step_bound`` (see
``_roofline``)."""

from bench_port import counts
from bench_port.metrics._roofline import share


def read(ctx):
    least, _ = counts.wide_step_bound(ctx.config, ctx.chips)
    return share(ctx, "cd_wide_step_kernel", least)

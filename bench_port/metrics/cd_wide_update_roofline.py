"""``csrc/cd_wide_update.cuh``'s share of its roofline: the W-blocked update over
every rank's factors, against ``counts.wide_update_bound`` (see ``_roofline``)."""

from bench_port import counts
from bench_port.metrics._roofline import share


def read(ctx):
    least, _ = counts.wide_update_bound(ctx.config, ctx.chips)
    return share(ctx, "cd_wide_update_kernel", least)

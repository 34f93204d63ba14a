"""The whole step's share of the cards' peak over the traced stretch: the model
operations of an update (``counts.update_flops`` at the global batch) times
the updates the traced jobs ran, over the stretch's seconds, over the chips
times the peak of the configuration's compute dtype."""

from bench_port import counts


def read(ctx):
    if not ctx.jobs or ctx.window_s[0] <= 0:
        return None
    ops = counts.update_flops(ctx.config) * ctx.updates_per_job * len(ctx.jobs)
    return 100.0 * ops / ctx.window_s[0] / (ctx.chips * counts.peak_flops(ctx.config))

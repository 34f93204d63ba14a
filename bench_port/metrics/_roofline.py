"""A kernel's share of its roofline: for each launch the profiler saw (on every
card), the frozen bound of the work that launch did, over its device time,
taken over all such launches (their bounds' sum over their times' sum)."""

from bench_port import counts


def launches(ctx, kernel: str):
    """Device seconds of each launch of ``kernel`` in the traced stretch, on every card."""
    return [(b - a) * 1e-6 for t in ctx.traces for name, a, b in t.device if kernel in name]


def share(ctx, kernel: str, least_s: float):
    """Percent of the roofline of launches that each need at least ``least_s``."""
    seen = launches(ctx, kernel)
    return 100.0 * least_s * len(seen) / sum(seen) if seen else None


def fit_share(ctx, kernel: str):
    """A CD training kernel's share: ``counts.bound`` of a launch's updates."""
    least, _ = counts.bound(ctx.config, ctx.updates_per_job // ctx.launches_per_job,
                            ctx.l2_bytes)
    return share(ctx, kernel, least)

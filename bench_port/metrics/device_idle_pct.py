"""The share of the traced stretch of jobs in which no operation ran on the card:
the stretch less the union of the device's intervals, over the stretch; on
several cards, the mean over them."""


def read(ctx):
    shares = [1.0 - busy / span for busy, span in zip(ctx.busy_s, ctx.window_s) if span > 0]
    return 100.0 * sum(shares) / len(shares) if shares else None

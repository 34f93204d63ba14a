"""The data-parallel exchange's device time a step: the NCCL kernels' time in the
traced stretch over its steps (the global updates of the traced jobs), the
mean over the cards. The exchange runs on the step's own stream between the
step and the update kernels, so none of it is hidden behind other work."""


def read(ctx):
    per_card = []
    for t in ctx.traces:
        nccl = sum(b - a for name, a, b in t.device if "nccl" in name.lower())
        steps = ctx.updates_per_job * len(t.jobs)
        if nccl and steps:
            per_card.append(nccl / steps)
    return sum(per_card) / len(per_card) if per_card else None

"""The trainer's host time a launch: over the traced jobs, each job's wall time
(its ``bench.job`` span) less the card's busy time inside it, over the device
operations the job launched."""

from bench_port import trace as tr


def read(ctx):
    host_us, launches = 0.0, 0
    for _, a, b in ctx.jobs:
        inside = tr.clip(ctx.trace.device, a, b)
        host_us += (b - a) - tr.busy_us(inside, a, b)
        launches += len(inside)
    return host_us / launches if launches else None

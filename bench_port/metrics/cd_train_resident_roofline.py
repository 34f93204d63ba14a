"""``csrc/cd_train_resident.cu``'s share of its roofline (see ``_roofline``)."""

from bench_port.metrics._roofline import fit_share


def read(ctx):
    return fit_share(ctx, "cd_train_resident_kernel")

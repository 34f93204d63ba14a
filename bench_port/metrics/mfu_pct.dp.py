"""``mfu_pct``, read the same way, for the cells whose end-to-end metrics carry ``.dp``."""

from bench_port.metrics.mfu_pct import read  # noqa: F401

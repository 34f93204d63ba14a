"""``mfu_pct``, read the same way, for the cells whose end-to-end metrics carry ``.wide``."""

from bench_port.metrics.mfu_pct import read  # noqa: F401

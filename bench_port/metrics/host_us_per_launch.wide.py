"""``host_us_per_launch``, read the same way, for the cells whose end-to-end metrics carry ``.wide``."""

from bench_port.metrics.host_us_per_launch import read  # noqa: F401

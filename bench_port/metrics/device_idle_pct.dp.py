"""``device_idle_pct``, read the same way, for the cells whose end-to-end metrics carry ``.dp``."""

from bench_port.metrics.device_idle_pct import read  # noqa: F401

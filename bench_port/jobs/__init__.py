"""Job kinds of the benchmark's traffic, one module each, found by the name a
workload file gives. A module defines ``Fits(config, workload, data, fit=None,
overrides=None)`` with ``run(job_seed)`` (the timed call), ``outputs(result)``,
``route_count()``, ``updates_per_job``, ``launches_per_job`` and
``check(kept, log)``, which returns the numbers compared."""

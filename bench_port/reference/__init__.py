"""Plain reference of the benchmark: PyTorch only, nothing of the measured program."""

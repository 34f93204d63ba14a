"""Data kinds of the benchmark's traffic, one module each, found by the name a
workload file gives: ``make(params, seed, device)`` returns the float32
matrix [rows, features] a cell's jobs train on, made from the run's seed."""

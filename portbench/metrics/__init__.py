"""Readers of the benchmark's metrics, one file per metric: ``read(rec)``."""

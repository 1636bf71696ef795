"""device_busy_share.pairs: ``device_busy_share``, read in the metric cells, where it moves
``pairs_per_s``."""

from portbench.metrics.device_busy_share import read  # noqa: F401

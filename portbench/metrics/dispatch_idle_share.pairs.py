"""dispatch_idle_share.pairs: ``dispatch_idle_share``, read in the metric cells, where it moves
``pairs_per_s``."""

from portbench.metrics.dispatch_idle_share import read  # noqa: F401

"""op_host_ms.pairs: ``op_host_ms``, read in the metric cells, where it moves
``pairs_per_s``."""

from portbench.metrics.op_host_ms import read  # noqa: F401

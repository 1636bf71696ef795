"""op_device_ms.pairs: ``op_device_ms``, read in the metric cells, where it moves
``pairs_per_s``."""

from portbench.metrics.op_device_ms import read  # noqa: F401

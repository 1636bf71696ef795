"""op_roofline.pairs: ``op_roofline``, read in the metric cells, where it moves
``pairs_per_s``."""

from portbench.metrics.op_roofline import read  # noqa: F401

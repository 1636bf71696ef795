"""kernels_per_batch.pairs: ``kernels_per_batch``, read in the metric cells, where it moves
``pairs_per_s``."""

from portbench.metrics.kernels_per_batch import read  # noqa: F401

"""pairs_per_s: frame pairs a metric op scored inside the window over the
window's seconds (host clock): the frames of the batches whose completion the
host saw inside the window, as ``frames_per_s`` counts them.  A metric cell
reports it in place of ``frames_per_s`` so that it can carry its own bound:
a metric op that dispatches thousands of plain-torch kernels a batch spreads
with the host's speed, run to run, where the kernel cells do not."""

from portbench.metrics.frames_per_s import read  # noqa: F401

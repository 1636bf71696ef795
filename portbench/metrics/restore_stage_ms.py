"""restore_stage_ms: the median, over the op calls traced, of the device
time of the operations that MosquitoNR's restore stage launched (the span
``vszip.op.mosquito_nr.restore``: the lifting transforms of the original and
of the blend, the LL mix where restore < 128, the inverse, and the output's
rounding, clamp and cast), in ms.  Device operations are tied to their stage
as in ``smooth_stage_ms``, and it is left out in the same cases."""

from portbench.metrics.smooth_stage_ms import stage_ms

STAGE = "vszip.op.mosquito_nr.restore"


def read(rec):
    return stage_ms(rec, STAGE)

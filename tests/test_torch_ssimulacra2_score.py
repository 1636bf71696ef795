"""vszip_tpu_torch.ssimulacra2's score held against vszip_tpu.ssimulacra2
on YUV and linear inputs: YUV420P16 through the integer chroma upsample
with the height rule's BT.601 and with ``_Matrix=1``, 8-bit gray, and an
RGBS clip that already carries ``_Transfer=8`` (no EOTF).  (RGBS, two-chunk
clips, the blocks and the errors are in tests/test_torch_ssimulacra2.py.)

Tolerance: rtol 1e-3 / atol 1e-6, the metric's criterion
(benchmarks/tpu_parity.py); the measured gap is in each assertion's
message.
"""

import pytest

from test_torch_ssimulacra2 import check_score


@pytest.mark.parametrize("fmt,props", [("YUV420P16", None), ("YUV420P16", {"_Matrix": 1}),
                                       ("GRAY8", None), ("RGBS", {"_Transfer": 8})], ids=str)
def test_score_matches_jax(fmt, props):
    check_score(fmt, 2, 80, 112, len(fmt), props)

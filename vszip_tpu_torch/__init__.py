"""vszip_tpu_torch: the PyTorch/CUDA port of vszip_tpu for NVIDIA Hopper.

The same surface as ``vszip_tpu`` for the ported slice: a ``Clip`` of
``(N, H, W)`` plane tensors, the format and parameter layer, every filter of
the JAX package (BoxBlur, Bilateral, BilateralDither, Deband, Limiter,
LimitFilter, CLAHE, EEDI3/EEDI3H, Compress, Checkmate, CombMask, CombMaskMT,
MosquitoNR, AdaptiveBinarize, PackRGB, RFS, ColorMap, and the metrics
PlaneAverage, PlaneMinMax, XPSNR and SSIMULACRA2) with the same arguments,
validation messages and results, the format conversions ``bit_depth``,
``resize``, ``to_rgbs`` and ``srgb_to_linear``, the streaming runtime
(``ArraySource``, ``SyntheticSource``, ``process_stream``, with ``mesh=``
to split chunks over several devices), ImageRead (``image_read``) and frame
sharding (``parallel``: ``frames_mesh``, ``shard_clip``, ``replicate_clip``,
``run_sharded``), and ``trace``: spans at the ops', kernel wrappers' and
``process_stream``'s boundaries, recorded under ``trace.collect()`` (the
op and stream spans also under a running ``torch.profiler``) and free
otherwise, and the launch counters.
Integer
BoxBlur, Deband, 8-bit CLAHE, EEDI3, Compress, Checkmate, CombMask,
BilateralDither, XPSNR's block statistics and SSIMULACRA2's per-scale sums
run hand-written CUDA
kernels (``csrc/``) on CUDA tensors and their plain PyTorch versions on CPU
tensors.
Clips are made on the card unless the caller asks for another device.  The
package imports torch and never JAX.
"""

from .core.clip import WIPED_FORMAT, Clip, VariableClip, from_reference
from .core.format import (
    ColorFamily,
    ColorRange,
    SampleType,
    VideoFormat,
    get_format,
)
from .core.params import VSZipError
from .core.resample import bit_depth, resize, srgb_to_linear, to_rgbs
from .io import image_read
from .ops import (adaptive_binarize, bilateral, bilateral_dither, boxblur, checkmate, clahe,
                  colormap, comb_mask, comb_mask_mt, compress, deband, eedi3, eedi3h,
                  limit_filter, limiter, mosquito_nr, packrgb, plane_average, plane_minmax, rfs,
                  ssimulacra2, xpsnr)
from .runtime.stream import ArraySource, SyntheticSource, process_stream
from . import parallel, trace

__all__ = [
    "Clip",
    "VariableClip",
    "WIPED_FORMAT",
    "from_reference",
    "ColorFamily",
    "ColorRange",
    "SampleType",
    "VideoFormat",
    "get_format",
    "VSZipError",
    "bit_depth",
    "resize",
    "srgb_to_linear",
    "to_rgbs",
    "image_read",
    "adaptive_binarize",
    "bilateral",
    "bilateral_dither",
    "boxblur",
    "checkmate",
    "clahe",
    "colormap",
    "comb_mask",
    "comb_mask_mt",
    "compress",
    "deband",
    "eedi3",
    "eedi3h",
    "limit_filter",
    "limiter",
    "mosquito_nr",
    "packrgb",
    "plane_average",
    "plane_minmax",
    "rfs",
    "ssimulacra2",
    "xpsnr",
    "ArraySource",
    "SyntheticSource",
    "process_stream",
    "parallel",
    "trace",
]

__version__ = "0.1.0"

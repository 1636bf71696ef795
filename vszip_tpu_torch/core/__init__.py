from .clip import WIPED_FORMAT, Clip, VariableClip, from_reference
from .format import (
    ColorFamily,
    ColorRange,
    SampleType,
    VideoFormat,
    get_format,
)
from .params import (
    VSZipError,
    compare_clips,
    get_array,
    get_value,
    parse_planes,
    require,
)

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
    "compare_clips",
    "get_array",
    "get_value",
    "parse_planes",
    "require",
]

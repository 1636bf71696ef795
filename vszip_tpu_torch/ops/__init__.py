from .boxblur import boxblur
from .clahe import clahe
from .deband import deband
from .eedi3 import eedi3, eedi3h
from .limiter import limiter
from .ssimulacra2 import ssimulacra2
from .xpsnr import xpsnr

__all__ = ["boxblur", "clahe", "deband", "eedi3", "eedi3h", "limiter", "ssimulacra2",
           "xpsnr"]

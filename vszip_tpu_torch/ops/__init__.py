from .bilateral_dither import bilateral_dither
from .boxblur import boxblur
from .checkmate import checkmate
from .clahe import clahe
from .comb_mask import comb_mask
from .comb_mask_mt import comb_mask_mt
from .compress import compress
from .deband import deband
from .eedi3 import eedi3, eedi3h
from .limiter import limiter
from .mosquito_nr import mosquito_nr
from .ssimulacra2 import ssimulacra2
from .xpsnr import xpsnr

__all__ = ["bilateral_dither", "boxblur", "checkmate", "clahe", "comb_mask", "comb_mask_mt",
           "compress", "deband", "eedi3", "eedi3h", "limiter", "mosquito_nr", "ssimulacra2",
           "xpsnr"]

from .adaptive_binarize import adaptive_binarize
from .bilateral import bilateral
from .bilateral_dither import bilateral_dither
from .boxblur import boxblur
from .checkmate import checkmate
from .clahe import clahe
from .colormap import colormap
from .comb_mask import comb_mask
from .comb_mask_mt import comb_mask_mt
from .compress import compress
from .deband import deband
from .eedi3 import eedi3, eedi3h
from .limit_filter import limit_filter
from .limiter import limiter
from .mosquito_nr import mosquito_nr
from .packrgb import packrgb
from .planeaverage import plane_average
from .planeminmax import plane_minmax
from .rfs import rfs
from .ssimulacra2 import ssimulacra2
from .xpsnr import xpsnr

__all__ = ["adaptive_binarize", "bilateral", "bilateral_dither", "boxblur", "checkmate",
           "clahe", "colormap", "comb_mask", "comb_mask_mt", "compress", "deband", "eedi3",
           "eedi3h", "limit_filter", "limiter", "mosquito_nr", "packrgb", "plane_average",
           "plane_minmax", "rfs", "ssimulacra2", "xpsnr"]

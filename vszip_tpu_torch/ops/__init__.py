from .boxblur import boxblur
from .deband import deband
from .limiter import limiter

__all__ = ["boxblur", "deband", "limiter"]

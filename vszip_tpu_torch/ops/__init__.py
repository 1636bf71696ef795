from .boxblur import boxblur
from .limiter import limiter

__all__ = ["boxblur", "limiter"]

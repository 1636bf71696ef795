"""ImageRead: image files decoded on the host into clips on the card."""

from .image_read import image_read

__all__ = ["image_read"]

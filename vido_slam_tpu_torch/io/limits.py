"""The size limits the two reference readers hold on every image, checked
by the port's readers from the header, before anything is allocated:

  - ``cv2.imread`` (loadsave.cpp::validateInputImageSize, once the decoder
    has read the header and before it reads a sample): a side over
    ``CV2_MAX_SIDE`` or more than ``CV2_MAX_PIXELS`` pixels raises a
    ``cv2.error``, not None, so the port raises ``ImageTooLarge``;
  - PIL's ``Image.open`` (``Image._decompression_bomb_check``, as each
    plugin's ``_open`` returns): more than twice ``PIL_MAX_IMAGE_PIXELS``
    pixels (each side counted as at least 1) raises
    ``DecompressionBombError``; between the two limits PIL only warns, and
    reads.
"""

from __future__ import annotations

CV2_MAX_SIDE = 1 << 20
CV2_MAX_PIXELS = 1 << 30

# PIL.Image.MAX_IMAGE_PIXELS: 1024 * 1024 * 1024 // 4 // 3
PIL_MAX_IMAGE_PIXELS = 89478485


class ImageTooLarge(ValueError):
    """A header past cv2.imread's size limits: cv2 raises there (a
    ``cv2.error``, not None), and so does the port."""


class DecompressionBombError(ValueError):
    """PIL's ``Image.DecompressionBombError``: a header of more than
    ``2 * PIL_MAX_IMAGE_PIXELS`` pixels."""


def check_cv2_size(W: int, H: int) -> None:
    """Raises ImageTooLarge where ``cv2.imread`` would: a side over
    ``CV2_MAX_SIDE`` or more than ``CV2_MAX_PIXELS`` pixels."""
    if W > CV2_MAX_SIDE or H > CV2_MAX_SIDE or W * H > CV2_MAX_PIXELS:
        raise ImageTooLarge(f"a {W} x {H} image is past cv2.imread's limits "
                            f"(sides {CV2_MAX_SIDE}, {CV2_MAX_PIXELS} "
                            f"pixels)")


def check_pil_size(W: int, H: int) -> None:
    """Raises DecompressionBombError where ``Image.open`` would."""
    pixels = max(1, W) * max(1, H)
    if pixels > 2 * PIL_MAX_IMAGE_PIXELS:
        raise DecompressionBombError(
            f"Image size ({pixels} pixels) exceeds limit of "
            f"{2 * PIL_MAX_IMAGE_PIXELS} pixels, could be decompression "
            f"bomb DOS attack.")

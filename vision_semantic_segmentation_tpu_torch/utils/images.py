"""Host-side image display helpers (debug/diagnostic surface).

Port of ``vision_semantic_segmentation_tpu/utils/images.py``, the
image-list viewer of ref src/utils/utils.py:180-219 (used interactively
while tuning the mapping); host numpy and cv2, as there.  Composition is separated
from display so it is testable headless: :func:`concat_image_list` builds
the side-by-side panel; :func:`show_image_list` shows it via cv2 when a
display exists.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def concat_image_list(
    image_list: Sequence[np.ndarray],
    size: Optional[Tuple[int, int]] = None,
) -> Optional[np.ndarray]:
    """Resize images to a common (h, w) and concatenate horizontally.

    Matches the reference's rules (ref utils.py:187-217): with no ``size``
    every image shrinks to the smallest height/width in the list
    (INTER_NEAREST); grayscale images are promoted to 3 channels.
    Returns None for an empty list; a single image passes through.
    """
    import cv2

    if len(image_list) == 0:
        return None
    if len(image_list) == 1:
        return np.asarray(image_list[0])

    if size is None:
        hs = [im.shape[0] for im in image_list]
        ws = [im.shape[1] for im in image_list]
        size = (min(hs), min(ws))

    fixed = []
    for image in image_list:
        image = np.asarray(image)
        if image.shape[0] != size[0] or image.shape[1] != size[1]:
            image = cv2.resize(
                image, (size[1], size[0]), interpolation=cv2.INTER_NEAREST
            )
        if image.ndim == 2:
            image = cv2.cvtColor(image, cv2.COLOR_GRAY2BGR)
        fixed.append(image)
    return np.concatenate(fixed, axis=1)


def show_image_list(
    image_list: Sequence[np.ndarray],
    delay: int = 0,
    size: Optional[Tuple[int, int]] = None,
) -> None:
    """Display a list of images side by side (ref utils.py:180-219).

    Interactive-only: needs a cv2 GUI backend; headless use should call
    :func:`concat_image_list` and save the panel instead.
    """
    import cv2

    panel = concat_image_list(image_list, size=size)
    if panel is None:
        return
    title = "image" if len(image_list) == 1 else "concatenated"
    cv2.imshow(title, panel)
    cv2.waitKey(delay)

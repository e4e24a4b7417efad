"""File-system helpers: the part of ``vision_semantic_segmentation_tpu/
utils/file_io.py`` the online nodes use (ref src/utils/file_io.py)."""
from __future__ import annotations

import os


def makedirs(path: str, exist_ok: bool = False) -> None:
    os.makedirs(path, exist_ok=exist_ok)

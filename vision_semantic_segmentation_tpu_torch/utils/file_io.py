"""File-system helpers.

Port of ``vision_semantic_segmentation_tpu/utils/file_io.py`` (ref
src/utils/file_io.py): host-side listing, moving and removal.
"""
from __future__ import annotations

import os
import os.path as osp
import shutil
from typing import List


def get_dir_list(directory: str) -> List[str]:
    """Names of sub-directories directly under ``directory``."""
    return [c for c in os.listdir(directory) if osp.isdir(osp.join(directory, c))]


def get_file_list(directory: str, no_ext: bool = False) -> List[str]:
    """Names of files directly under ``directory`` (optionally without extension)."""
    return [osp.splitext(c)[0] if no_ext else c for c in os.listdir(directory)
            if osp.isfile(osp.join(directory, c))]


def move(src: str, dst: str) -> None:
    shutil.move(src, dst)


def remove(path: str, recursive: bool = True) -> None:
    """Remove a file, or a whole tree when ``recursive``; a missing path is no error."""
    if not osp.exists(path):
        return
    if not recursive or osp.isfile(path):
        os.remove(path)
    else:
        shutil.rmtree(path)


def makedirs(path: str, exist_ok: bool = False) -> None:
    os.makedirs(path, exist_ok=exist_ok)

"""Run loggers.

Own copy of ``vision_semantic_segmentation_tpu/utils/logger.py``:
:class:`MyLogger` (ref src/utils/logger.py:11-91), stdout plus a file in a
fresh ``version_N`` directory under ``save_dir``, and the training logger
:func:`setup_logger`, stdout plus a timestamped file in ``save_dir``.
"""
from __future__ import annotations

import logging
import os
import os.path as osp
import socket
import sys
import time
from typing import Optional

from .file_io import makedirs


class MyLogger:
    """Stdout + file logger that allocates a fresh ``version_N`` run dir."""

    def __init__(self, name: str, save_dir: str = "", version: Optional[int] = None,
                 use_timestamp: bool = True):
        logger = logging.getLogger(name)
        logger.setLevel(logging.DEBUG)
        for handler in list(logger.handlers):
            handler.close()
        logger.handlers.clear()

        formatter = logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s")
        ch = logging.StreamHandler(stream=sys.stdout)
        ch.setLevel(logging.DEBUG)
        ch.setFormatter(formatter)
        logger.addHandler(ch)

        if save_dir:
            if version is None:
                version = self._next_version(save_dir)
            save_dir = osp.join(save_dir, f"version_{version}")
            makedirs(save_dir, exist_ok=True)
            filename = "log"
            if use_timestamp:
                filename += f".{time.strftime('%m-%d_%H-%M-%S')}.{socket.gethostname()}"
            fh = logging.FileHandler(osp.join(save_dir, filename + ".txt"))
            fh.setLevel(logging.DEBUG)
            fh.setFormatter(formatter)
            logger.addHandler(fh)

        self.logger = logger
        self.save_dir = save_dir

    def log(self, msg: str, level: str = "info") -> None:
        fn = {
            "info": self.logger.info,
            "debug": self.logger.debug,
            "warning": self.logger.warning,
            "critical": self.logger.critical,
        }.get(level)
        if fn is None:
            raise NotImplementedError(f"Unknown log level {level}")
        fn(msg)

    @staticmethod
    def _next_version(save_dir: str) -> int:
        makedirs(save_dir, exist_ok=True)
        versions = [
            int(d.split("_")[1])
            for d in os.listdir(save_dir)
            if osp.isdir(osp.join(save_dir, d)) and d.startswith("version_")
        ]
        return max(versions) + 1 if versions else 0


def setup_logger(name: str, save_dir: str = "", prefix: str = "") -> logging.Logger:
    """Training logger: stdout + timestamped file in ``save_dir``."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    for handler in list(logger.handlers):
        handler.close()
    logger.handlers.clear()
    logger.propagate = False

    formatter = logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s")
    ch = logging.StreamHandler(stream=sys.stdout)
    ch.setFormatter(formatter)
    logger.addHandler(ch)

    if save_dir:
        makedirs(save_dir, exist_ok=True)
        stamp = time.strftime("%m-%d_%H-%M-%S")
        name_parts = ["log", prefix, stamp, socket.gethostname()]
        filename = ".".join(p for p in name_parts if p) + ".txt"
        fh = logging.FileHandler(osp.join(save_dir, filename))
        fh.setFormatter(formatter)
        logger.addHandler(fh)

    return logger

from .file_io import makedirs
from .logger import MyLogger

__all__ = ["MyLogger", "makedirs"]

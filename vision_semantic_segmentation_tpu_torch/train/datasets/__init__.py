from .base import DataLoader, Dataset
from .bdd import BDDSegmentation
from .mapillary import MapillaryVistas
from .pascal import OverfitVOCSegmentation, VOCSegmentation

__all__ = [
    "DataLoader",
    "Dataset",
    "BDDSegmentation",
    "MapillaryVistas",
    "OverfitVOCSegmentation",
    "VOCSegmentation",
]

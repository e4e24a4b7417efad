from .base import DataLoader, Dataset
from .mapillary import MapillaryVistas

__all__ = ["DataLoader", "Dataset", "MapillaryVistas"]

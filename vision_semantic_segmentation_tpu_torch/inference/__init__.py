from .predictor import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    SemanticSegmentation,
    colorize_labels,
    postprocess_labels,
    preprocess_frame,
)
from .convex_hull import generate_convex_hull

__all__ = [
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "SemanticSegmentation",
    "colorize_labels",
    "postprocess_labels",
    "preprocess_frame",
    "generate_convex_hull",
]

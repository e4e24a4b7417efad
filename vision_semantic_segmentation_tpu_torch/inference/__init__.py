from .predictor import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    SemanticSegmentation,
    colorize_labels,
    postprocess_labels,
    preprocess_frame,
)

__all__ = [
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "SemanticSegmentation",
    "colorize_labels",
    "postprocess_labels",
    "preprocess_frame",
]

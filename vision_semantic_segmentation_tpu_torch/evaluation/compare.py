"""Side-by-side generated vs ground-truth map comparison.

Port of ``vision_semantic_segmentation_tpu/evaluation/compare.py``, the
reference's evaluation sketch (ref src/evaluation.py:1-30): a generated map
and the ground-truth labels, plotted side by side (or saved as a panel).
Host numpy over ``map_eval.py``; cv2 and matplotlib's Agg backend are
imported inside the function.
"""
from __future__ import annotations

from typing import Optional

from .map_eval import MapEvaluator, convert_labels


def compare_maps(generated_map_path: str, ground_truth_dir: str,
                 save_path: Optional[str] = None, show: bool = False):
    """Render generated vs ground-truth label maps; returns the figure."""
    import cv2
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    evaluator = MapEvaluator(ground_truth_dir=ground_truth_dir)
    generated = convert_labels(cv2.imread(generated_map_path))
    truth = evaluator.ground_truth[: generated.shape[0], : generated.shape[1]]

    fig, axes = plt.subplots(1, 2, figsize=(16, 8))
    axes[0].matshow(generated)
    axes[0].set_title("generated")
    axes[1].matshow(truth)
    axes[1].set_title("ground truth")
    for ax in axes:
        ax.axis("off")
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
    if show:  # pragma: no cover
        plt.show()
    return fig

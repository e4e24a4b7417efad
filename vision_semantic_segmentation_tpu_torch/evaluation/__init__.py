from .compare import compare_maps
from .map_eval import MapEvaluator, convert_labels

__all__ = ["MapEvaluator", "compare_maps", "convert_labels"]

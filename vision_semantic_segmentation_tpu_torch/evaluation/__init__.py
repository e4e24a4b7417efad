from .map_eval import MapEvaluator, convert_labels

__all__ = ["MapEvaluator", "convert_labels"]

"""Dataset label table inspection (ref src/data/network_labels.py:5-15).

Port of ``vision_semantic_segmentation_tpu/train/datasets/network_labels.py``.
"""
from __future__ import annotations

import json
from typing import List


def read_json_file(path: str) -> List[dict]:
    """Load labels from a dataset config.json and return the table."""
    with open(path) as f:
        return json.load(f)["labels"]


def print_label_table(path: str) -> None:
    for i, label in enumerate(read_json_file(path)):
        print(f"{i:3d}  {label.get('readable', label.get('name', '?')):30s} {label.get('color')}")


if __name__ == "__main__":  # pragma: no cover
    import sys

    print_label_table(sys.argv[1])

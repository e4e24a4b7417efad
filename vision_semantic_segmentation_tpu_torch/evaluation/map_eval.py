"""BEV map quality harness: IoU / accuracy / missing rate vs ground truth.

Rebuild of `reference: test/test_semantic_mapping.py:6-161` — with its
latent defect fixed by construction (the reference file has a duplicated
``else:`` branch at :70 that makes it a SyntaxError under py3, breaking
``mapping.py:36``'s import; SURVEY.md section 4).

Ground-truth contract (ref test/README.md): ``bev-5cm-{road,crosswalks,
lanes,mask}.jpg`` layers, downsampled 4x, mask-gated; classes 1=road,
2=crosswalk, 3=lane (+4 sidewalk, 5 vegetation in generated maps).

Port copy of ``vision_semantic_segmentation_tpu/evaluation/map_eval.py``
(numpy only).  OpenCV is imported only to decode ground-truth JPEG layers
or PNG maps; a ground-truth directory holding ``truth.npy`` needs none.
"""
from __future__ import annotations

import os
import os.path as osp
import warnings
from typing import Dict, List, Optional

import numpy as np

Array = np.ndarray

# RGB palette -> integer evaluation labels (ref test_semantic_mapping.py:6-18)
_CONVERT_TABLE = (
    ((128, 64, 128), 1),   # road
    ((140, 140, 200), 2),  # crosswalk
    ((255, 255, 255), 3),  # lane
    ((244, 35, 232), 4),   # sidewalk
    ((107, 142, 35), 5),   # vegetation
)


def convert_labels(color_map: Array, mask: Optional[Array] = None) -> Array:
    """RGB map -> integer label map, optionally gated by a validity mask."""
    h, w = color_map.shape[:2]
    if mask is None:
        mask = np.ones((h, w), dtype=bool)
    else:
        mask = mask[:h, :w].astype(bool)
    labels = np.zeros((h, w), dtype=np.int32)
    for color, idx in _CONVERT_TABLE:
        hit = np.all(color_map == np.array(color), axis=-1) & mask
        labels[hit] = idx
    return labels


def _downsample_4x(img: Array) -> Array:
    import cv2

    h, w = img.shape[:2]
    return cv2.resize(img, (int(w / 4), int(h / 4)))


class MapEvaluator:
    """Loads the annotated ground-truth BEV layers and scores maps.

    API mirrors the reference ``Test`` class (test_single_map / full_test /
    iou), with results returned as dicts instead of only printed.
    """

    CLASS_NAMES = {0: "road", 1: "crosswalk", 2: "lane"}
    CLASS_IDS = (1, 2, 3)

    def __init__(
        self,
        ground_truth_dir: str = "./",
        shift_h: int = 0,
        shift_w: int = 0,
        logger=None,
        cache: bool = False,
    ):
        """Args:
            cache: write ``truth.npy``/``mask.npy`` into the ground-truth
                dir to skip the jpg decode+downsample on reload.  OFF by
                default — mutating the GT directory is an opt-in.
        """
        truth_path = osp.join(ground_truth_dir, "truth.npy")
        mask_path = osp.join(ground_truth_dir, "mask.npy")
        if osp.exists(truth_path):
            self.ground_truth = np.load(truth_path)
            self.mask = np.load(mask_path) if osp.exists(mask_path) else None
        else:
            import cv2

            crosswalks = cv2.imread(osp.join(ground_truth_dir, "bev-5cm-crosswalks.jpg"))
            road = cv2.imread(osp.join(ground_truth_dir, "bev-5cm-road.jpg"))
            lane = cv2.imread(osp.join(ground_truth_dir, "bev-5cm-lanes.jpg"))
            mask_img = cv2.imread(osp.join(ground_truth_dir, "bev-5cm-mask.jpg"))
            if road is None:
                raise FileNotFoundError(
                    f"No ground truth found under {ground_truth_dir!r}"
                )
            mask_img = _downsample_4x(mask_img)
            mask = np.all(mask_img == np.array([255, 255, 255]), axis=-1).astype(np.float64)
            crosswalks = _downsample_4x(crosswalks)
            road = _downsample_4x(road)
            lane = _downsample_4x(lane)
            truth = np.zeros(road.shape[:2])
            truth[np.logical_and(np.any(road > 0, axis=-1), mask > 0)] = 1
            truth[np.logical_and(np.any(lane > 0, axis=-1), mask > 0)] = 3
            truth[np.logical_and(np.any(crosswalks > 0, axis=-1), mask > 0)] = 2
            self.ground_truth = truth
            self.mask = mask
            if cache:
                np.save(truth_path, truth)
                np.save(mask_path, mask)

        self.shift_h = shift_h
        self.shift_w = shift_w
        self.logger = logger

    # -- scoring -------------------------------------------------------------
    def iou(self, gmap: Array, generated: Array) -> Dict[str, object]:
        """Per-class IoU + accuracy + missing rate (ref :127-161)."""
        ious: List[float] = []
        accs: List[float] = []
        for cls in self.CLASS_IDS:
            gt_layer = gmap == cls
            gen_layer = generated == cls
            inter = float(np.sum(gt_layer & gen_layer))
            union = float(np.sum(gt_layer) + np.sum(gen_layer) - inter)
            ious.append(inter / union if union > 0 else float("nan"))
            denom = float(np.sum(gt_layer))
            accs.append(inter / denom if denom > 0 else float("nan"))
        gt_known = gmap > 0
        missing = 1.0 - np.sum((gt_known) & (generated > 0)) / max(np.sum(gt_known), 1)
        accuracy = np.sum((gmap == generated)[gt_known]) / max(np.sum(gt_known), 1)
        return {
            "iou": dict(zip(("road", "crosswalk", "lane"), ious)),
            "miou": float(np.nanmean(ious)),
            "accuracy": dict(zip(("road", "crosswalk", "lane"), accs)),
            "mean_accuracy": float(accuracy),
            "missing_rate": float(missing),
        }

    def _crop_truth(self, generated: Array) -> Array:
        return self.ground_truth[
            self.shift_w : generated.shape[0] + self.shift_w,
            self.shift_h : generated.shape[1] + self.shift_h,
        ]

    def test_single_map(self, color_map: Array, verbose: bool = True) -> Dict[str, object]:
        """Score one RGB global map against the ground truth (ref :117-125)."""
        generated = convert_labels(np.asarray(color_map))
        result = self.iou(self._crop_truth(generated), generated)
        if verbose:
            self._report(result)
        return result

    def full_test(
        self, dir_path: str = "./global_maps", latex_mode: bool = False, verbose: bool = False
    ) -> Dict[str, object]:
        """Score every .png map in a directory and average (ref :81-115)."""
        import cv2

        files = sorted(f for f in os.listdir(dir_path) if f.endswith(".png"))
        if not files:
            raise FileNotFoundError(f"no .png maps to score under {dir_path!r}")
        ious, misses = [], []
        for name in files:
            bgr = cv2.imread(osp.join(dir_path, name))
            generated = convert_labels(bgr, self.mask)
            result = self.iou(self._crop_truth(generated), generated)
            if verbose:
                print(f"You are testing\t{name}")
                self._report(result)
            ious.append([result["iou"][k] for k in ("road", "crosswalk", "lane")])
            misses.append(result["missing_rate"])
        with warnings.catch_warnings():
            # a class absent from every map yields an all-NaN column; the
            # NaN mean is the intended result (ref reports nan IoU), not
            # a condition worth a RuntimeWarning per batch
            warnings.simplefilter("ignore", RuntimeWarning)
            mean_iou = np.nanmean(np.asarray(ious), axis=0)
            miou = float(np.nanmean(mean_iou))
        summary = {
            "iou": dict(zip(("road", "crosswalk", "lane"), mean_iou.tolist())),
            "miou": miou,
            "missing_rate": float(np.mean(misses)),
            "num_maps": len(files),
        }
        self._report(summary)
        if latex_mode:
            r = summary["iou"]
            print(
                f"&{r['road']:.3f}&{r['crosswalk']:.3f}&{r['lane']:.3f}"
                f"&{summary['miou']:.3f}&{summary['missing_rate'] * 100:.3g}\\\\ \\hline"
            )
        return summary

    def _report(self, result: Dict[str, object]) -> None:
        iou = result["iou"]
        msg = (
            f"IOU road: {iou['road']}\tcrosswalk: {iou['crosswalk']}\t"
            f"lane: {iou['lane']}\tmIOU: {result['miou']}\n"
            f"Missing rate: {result['missing_rate']}"
        )
        if self.logger is not None:
            self.logger.log(msg)
        else:
            print(msg)


# Reference-compatible alias (ref test_semantic_mapping.py:29)
Test = MapEvaluator

"""Port parity: the convex hulls and the ground-plane hull markers against
the JAX package.

The port extracts hulls without OpenCV (``scipy.ndimage`` erosion and
labelling, and OpenCV's own hull algorithm in numpy); the JAX package calls
``cv2.erode`` and ``cv2.convexHull``.  On label maps and point sets made
from a seed, the loops must be equal exactly: the same vertices, in the
same order, from the same start vertex, in the same dtype.  Marker points
come from f32 rays cast onto a plane, in both packages: equal to 1e-3 m.
"""
import cv2
import numpy as np
import pytest
import torch
from scipy import ndimage

from vision_semantic_segmentation_tpu.config import get_cfg_defaults as j_cfg_defaults
from vision_semantic_segmentation_tpu.inference.convex_hull import (
    generate_convex_hull as j_generate_convex_hull,
)
from vision_semantic_segmentation_tpu.runtime.bus import TopicBus as JaxBus
from vision_semantic_segmentation_tpu.runtime.node import SegmentationNode as JaxSegNode
from vision_semantic_segmentation_tpu.utils import markers as j_markers
from vision_semantic_segmentation_tpu_torch.config import get_cfg_defaults
from vision_semantic_segmentation_tpu_torch.inference import generate_convex_hull
from vision_semantic_segmentation_tpu_torch.inference.convex_hull import cv_convex_hull
from vision_semantic_segmentation_tpu_torch.runtime import SegmentationNode, TopicBus
from vision_semantic_segmentation_tpu_torch.utils import markers

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

PLANE = [0.0, 0.02, 1.0, 1.9]  # the ground about 1.9 m below the velodyne, tilted


def _blobs(rng, h, w, classes=(1, 2)):
    """A label map of elliptic blobs of the given classes, ragged at the edge."""
    lab = np.zeros((h, w), np.int32)
    yy, xx = np.ogrid[:h, :w]
    for _ in range(int(rng.integers(1, 7))):
        cy, cx = rng.integers(0, h), rng.integers(0, w)
        ry, rx = rng.integers(2, h // 3 + 3), rng.integers(2, w // 3 + 3)
        blob = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1
        lab[blob & (rng.random((h, w)) < 0.97)] = rng.choice(classes)
    return lab


def _assert_loops_equal(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# -- hulls -----------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(12))
def test_generate_convex_hull_matches(seed):
    rng = np.random.default_rng(seed)
    lab = _blobs(rng, int(rng.integers(30, 140)), int(rng.integers(30, 180)))
    n_loops = 0
    for index in (1, 2):
        for top_number, area_threshold in ((1, 30), (3, 0), (5, 10)):
            ours = generate_convex_hull(lab, index, top_number, area_threshold)
            _assert_loops_equal(ours, j_generate_convex_hull(lab, index, top_number,
                                                             area_threshold))
            for loop in ours:
                assert loop.shape[0] == 2 and (loop[:, 0] == loop[:, -1]).all()  # closed
            n_loops += len(ours)
    assert n_loops > 0


@pytest.mark.parametrize("seed", range(4))
def test_cv_convex_hull_matches_cv2(seed):
    """Point sets in any order, with collinear runs and duplicates removed
    (as in a pixel mask): cv2's vertices, cycle and start vertex."""
    rng = np.random.default_rng(100 + seed)
    for _ in range(300):
        span = int(rng.integers(1, 40))
        pts = np.unique(rng.integers(0, span, (int(rng.integers(1, 60)), 2)), axis=0)
        rng.shuffle(pts)
        pts = pts.astype(np.int32)
        np.testing.assert_array_equal(cv_convex_hull(pts), cv2.convexHull(pts)[:, 0, :])


@pytest.mark.parametrize("shape", [(1, 1), (1, 9), (9, 1), (2, 2), (5, 7)])
def test_cv_convex_hull_degenerate_sets(shape):
    """A point, a row, a column and full rectangles of pixels."""
    pts = np.fliplr(np.argwhere(np.ones(shape, bool))).astype(np.int32)
    np.testing.assert_array_equal(cv_convex_hull(pts), cv2.convexHull(pts)[:, 0, :])


@pytest.mark.parametrize("seed", range(3))
def test_erosion_matches_cv2(seed):
    """``binary_erosion`` with a border of ones is ``cv2.erode``'s 3x3 with its
    default border, which leaves edge pixels as they are."""
    rng = np.random.default_rng(seed)
    mask = rng.random((40, 55)) < 0.7
    mask[:, :3] = True  # blobs touching the border
    ours = ndimage.binary_erosion(mask, structure=np.ones((3, 3)), border_value=1)
    ref = cv2.erode(mask.astype(np.uint8), np.ones((3, 3), np.uint8), iterations=1)
    np.testing.assert_array_equal(ours.astype(np.uint8), ref)


def test_generate_convex_hull_edge_cases():
    for fn in (generate_convex_hull, j_generate_convex_hull):
        with pytest.raises(ValueError, match="cannot be zero"):
            fn(np.zeros((5, 5), np.int32), index_care_about=0)
    empty = np.zeros((20, 30), np.int32)
    assert generate_convex_hull(empty) == j_generate_convex_hull(empty) == []
    small = empty.copy()
    small[5:9, 5:10] = 1  # 4x5 pixels: 2x3 after erosion, under the area threshold
    assert generate_convex_hull(small) == j_generate_convex_hull(small) == []
    _assert_loops_equal(generate_convex_hull(small, area_threshold=0),
                        j_generate_convex_hull(small, area_threshold=0))


# -- markers ---------------------------------------------------------------------
def _marker_fields(m, skip=("id", "points")):
    return {k: v for k, v in m.__dict__.items() if k not in skip}


def test_markers_match():
    for kw in (dict(position=(1, 2, 3)),
               dict(position=(0, 0, 0), mtype="cube", scale=0.5, color=(0, 1, 0, 0.5),
                    lifetime=3, frame_id="velodyne", text="x"),
               dict(position=(0, 0, 0), mtype="line_strip",
                    points=np.arange(12.0).reshape(4, 3))):
        ours, ref = markers.visualize_marker(**kw), j_markers.visualize_marker(**kw)
        assert _marker_fields(ours) == _marker_fields(ref)
        assert (ours.points is None) == (ref.points is None)
        if ours.points is not None:
            np.testing.assert_array_equal(ours.points, ref.points)
    for mod in (markers, j_markers):
        with pytest.raises(ValueError, match="Unknown marker type"):
            mod.visualize_marker((0, 0, 0), mtype="mesh")
    loops = [np.array([[1, 5, 5, 1], [2, 2, 8, 2]])]
    ours, ref = markers.hull_markers(loops), j_markers.hull_markers(loops)
    assert len(ours) == len(ref) == 1
    assert _marker_fields(ours[0]) == _marker_fields(ref[0])
    np.testing.assert_array_equal(ours[0].points, ref[0].points)


# -- the segmentation node's hull markers -----------------------------------------
class _Labels:
    """A predictor double that answers every frame with one label map."""

    def __init__(self, labels):
        self.labels_np = labels
        self.device = torch.device("cpu")

    def labels(self, image, upsample_pred=False):  # the port's predictor
        return torch.from_numpy(self.labels_np)

    def segmentation(self, image, upsample_pred=False):  # the JAX package's
        return self.labels_np


def _hull_nodes(tmp_path, labels, cameras=("camera1", "camera6")):
    nodes = []
    for make, node_cls, bus_cls, extra in (
            (j_cfg_defaults, JaxSegNode, JaxBus, {}),
            (get_cfg_defaults, SegmentationNode, TopicBus, {"device": "cpu"})):
        cfg = make()
        cfg.OUTPUT_DIR = str(tmp_path)
        cfg.VISION_SEM_SEG.UNDISTORT = False
        bus = bus_cls()
        got = {"/crosswalk_markers": [], "/road_markers": []}
        for topic, sink in got.items():
            bus.subscribe(topic, sink.append)
        node = node_cls(cfg, bus, predictor=_Labels(labels), cameras=cameras,
                        publish_hulls=True, **extra)
        nodes.append((node, bus, got))
    return nodes


def _assert_markers_match(got, j_got, plane):
    n_markers = 0
    for topic, color, lifetime in (("/crosswalk_markers", (0.8, 0.0, 0.0, 0.8), 10.0),
                                   ("/road_markers", (0.0, 0.0, 0.8, 0.8), 3.0)):
        assert len(got[topic]) == len(j_got[topic])
        for msg, j_msg in zip(got[topic], j_got[topic]):
            assert len(msg.data) == len(j_msg.data)
            for m, j_m in zip(msg.data, j_msg.data):
                assert _marker_fields(m) == _marker_fields(j_m)
                assert (m.marker_type, m.frame_id, m.color, m.lifetime) == (
                    "line_strip", "velodyne", color, lifetime)
                np.testing.assert_allclose(m.points, j_m.points, atol=1e-3, rtol=0)
                # every vertex on the plane
                n = np.array(plane[:3]) / np.linalg.norm(plane[:3])
                dist = m.points @ n + plane[3] / np.linalg.norm(plane[:3])
                assert np.abs(dist).max() < 1e-3
                n_markers += 1
    return n_markers


def test_hull_markers_through_the_node(tmp_path):
    """Frames through ``image_callback``: hulls of the label map (at the
    network's resolution, scaled to the calibration's image), cast onto the
    plane of ``/estimated_plane``, on both topics, for both cameras."""
    rng = np.random.default_rng(7)
    labels = np.zeros((45, 60), np.int32)
    labels[25:40, 5:30] = 1   # a crosswalk in the lower left
    labels[28:44, 35:58] = 2  # road in the lower right
    labels[22:26, 40:45] = 2  # a smaller road blob: top_number 1 keeps the larger
    (j_node, j_bus, j_got), (node, bus, got) = _hull_nodes(tmp_path, labels)
    frame = rng.integers(0, 256, (90, 120, 3), dtype=np.uint8)
    for b in (j_bus, bus):  # a frame before the plane: hulls but no markers
        b.publish("/camera1/image_raw", frame, stamp=0.5, frame_id="camera1")
    assert not any(got.values()) and node.plane is None
    for b in (j_bus, bus):
        b.publish("/estimated_plane", PLANE, stamp=1.0)
        for i, cam in enumerate(("camera1", "camera6")):
            b.publish(f"/{cam}/image_raw", frame, stamp=2.0 + i, frame_id=cam)
    assert node.plane == node.plane.__class__(*PLANE) and node.plane_last_update == 1.0
    assert _assert_markers_match(got, j_got, PLANE) == 4
    for topic in ("/camera1/semantic", "/camera6/semantic"):
        assert bus.published_counts[topic] == j_bus.published_counts[topic] > 0


def test_hull_markers_from_a_synthetic_blob(tmp_path):
    """The JAX package's own case (``tests/test_runtime.py``): one blob of a
    100x140 label map, the plane z = -2, the markers on it."""
    labels = np.zeros((100, 140), np.int32)
    labels[40:70, 50:90] = 1
    (j_node, j_bus, j_got), (node, bus, got) = _hull_nodes(tmp_path, labels, ("camera1",))
    for n, b in ((j_node, j_bus), (node, bus)):
        b.publish("/estimated_plane", [0.0, 0.0, 1.0, 2.0], stamp=0.0)
        n.generate_and_publish_convex_hull(labels, "camera1", index_care_about=1)
    assert _assert_markers_match(got, j_got, [0.0, 0.0, 1.0, 2.0]) == 1
    np.testing.assert_allclose(got["/crosswalk_markers"][0].data[0].points[:, 2], -2.0,
                               atol=1e-3)

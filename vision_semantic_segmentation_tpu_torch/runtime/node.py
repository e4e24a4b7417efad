"""The online nodes, wired over the in-process topic bus.

Port of ``vision_semantic_segmentation_tpu/runtime/node.py`` (the
reference's ROS layer):

* :class:`SegmentationNode` (ref vision_semantic_segmentation_node.py:49-221):
  camera frame -> undistort -> scale -> network -> nearest resize ->
  colourise -> publish ``/cameraX/semantic``; with ``publish_hulls``, the
  crosswalk and road hulls of the label map, cast onto the ground plane of
  ``/estimated_plane`` and published as line-strip markers.
* :class:`MappingNode` (ref mapping.py:39-355): semantic image + pose (+
  cloud) -> nearest-stamp sync -> engine update -> finalize, which renders
  the map through K1.  A cloud ``DEPTH_METHOD`` (``points_map``,
  ``points_raw``) runs the engine step (K2) and republishes the labelled
  cloud; any other method is the planar fallback, the semantic image warped
  onto the ground plane by a homography (``engine.update_map_planar``).
* :class:`FusedOnlineNode`: raw frame + pose + cloud -> one
  :meth:`FusedFramePipeline.step` per frame, with the sync, drop accounting
  and finalize of :class:`MappingNode`; cloud methods only.

Topic names are the reference's.  Callbacks run inline on ``bus.publish``,
or serially on a :class:`~.async_bus.NodeExecutor`'s worker thread when
one is given (the online mode).  A ``tf_tree`` takes ``/tf`` into a
:class:`~..utils.ros_compat.TransformTree`, gives each camera its TF
extrinsics before its first step, and gives the planar fallback its
``world -> local_map`` edge.  Images, labelled clouds and the grid stay on
the nodes' device (torch tensors); the hulls, their rays and the finalized
map are host work.
"""
from __future__ import annotations

import os.path as osp
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config.defaults import resolve_output_dir
from ..device import DeviceLike
from ..geometry.camera import camera_from_extrinsic, get_camera
from ..geometry.plane import Plane3D
from ..geometry.transforms import pose_to_matrix
from ..inference.convex_hull import generate_convex_hull
from ..inference.predictor import (
    SemanticSegmentation,
    colorize_labels,
    postprocess_labels,
    preprocess_frame,
)
from ..mapping.engine import SemanticMappingEngine, pad_points
from ..models.convert import flax_to_state_dict, load_weights
from ..ops.colormap import palette_from_cfg
from ..ops.kernels.render import render_bev_map_fused, unpack_rgba_image
from ..utils.file_io import makedirs
from ..utils.logger import MyLogger
from ..utils.markers import visualize_marker
from .bus import Message, TopicBus, nearest_stamp_index
from .io import FrameRecord, save_frames
from .pipeline import FusedFramePipeline
from .replay import write_png

CLOUD_TOPICS = {"points_map": "/reduced_map", "points_raw": "/points_raw"}


def _make_subscriber(bus: TopicBus, executor):
    """Inline bus subscription, or through a NodeExecutor's bounded
    mailboxes when one is given (the online mode, ``async_bus.py``)."""
    if executor is None:
        return lambda topic, cb, queue_size=1: bus.subscribe(topic, cb)
    return lambda topic, cb, queue_size=1: executor.subscribe(bus, topic, cb,
                                                              queue_size=queue_size)


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class SegmentationNode:
    """Camera image -> semantic RGB image (ref node:49-221).

    Subscribes ``/cameraX/image_raw`` and ``/estimated_plane``; publishes
    ``/cameraX/semantic`` as a uint8 (H, W, 3) tensor on the predictor's
    device and, with ``publish_hulls``, crosswalk and road hull markers
    back-projected onto the ground plane (ref node:138-201).  The hulls need
    the label map on the host: one copy to the host per frame, which waits
    for the frame's forward, made only when ``publish_hulls`` is on.
    """

    def __init__(self, cfg, bus: TopicBus, predictor: Optional[SemanticSegmentation] = None,
                 cameras: Tuple[str, ...] = ("camera1", "camera6"),
                 publish_hulls: bool = False, executor=None, device: DeviceLike = "cuda"):
        _sub = _make_subscriber(bus, executor)
        self.cfg = cfg
        self.bus = bus
        net_cfg = cfg.VISION_SEM_SEG.SEM_SEG_NETWORK
        self.image_scale = float(cfg.VISION_SEM_SEG.IMAGE_SCALE)
        self.predictor = predictor or SemanticSegmentation(net_cfg, device=device)
        self.device = self.predictor.device
        # colours from the DATASET_CONFIG labels JSON when set (ref node:62-63)
        self.palette = palette_from_cfg(net_cfg)
        self.upsample_pred = bool(cfg.VISION_SEM_SEG.get("UPSAMPLE_PRED", False))
        self.publish_hulls = publish_hulls
        self.plane: Optional[Plane3D] = None
        self.plane_last_update = 0.0
        self._undistort_maps: Dict[str, torch.Tensor] = {}
        for cam in cameras:
            if cfg.VISION_SEM_SEG.get("UNDISTORT", True):
                try:
                    maps = get_camera(cam).undistort_maps()
                except KeyError:  # no calibration: frames pass through
                    pass
                else:
                    self._undistort_maps[cam] = torch.from_numpy(maps).to(self.device)
            # keep-latest depth 1: a saturated stage drops stale frames
            _sub(f"/{cam}/image_raw", self.image_callback, queue_size=1)
        _sub("/estimated_plane", self.plane_callback, queue_size=4)

    def plane_callback(self, msg: Message) -> None:
        """Ground-plane estimate update (ref node:199-201)."""
        coef = msg.data
        self.plane = Plane3D(float(coef[0]), float(coef[1]), float(coef[2]), float(coef[3]))
        self.plane_last_update = msg.stamp

    def image_callback(self, msg: Message) -> None:
        """Per-frame path (ref node:74-136)."""
        camera = msg.frame_id
        full_hw = (msg.data.shape[0], msg.data.shape[1])
        x = preprocess_frame(msg.data, undistort_map=self._undistort_maps.get(camera),
                             image_scale=self.image_scale, device=self.device)
        labels = self.predictor.labels(x, upsample_pred=self.upsample_pred)
        if self.publish_hulls:
            # crosswalk (class 1) and road (class 2) hulls on the ground plane
            # (ref node:104-106; class ids from config_19.json), from the
            # label map at the network's resolution
            labels_host = labels.cpu().numpy()
            self.generate_and_publish_convex_hull(labels_host, camera, index_care_about=1)
            self.generate_and_publish_convex_hull(labels_host, camera, index_care_about=2)
        semantic_rgb = colorize_labels(postprocess_labels(labels, full_hw), self.palette)
        self.bus.publish(f"/{camera}/semantic", semantic_rgb, stamp=msg.stamp, frame_id=camera)

    # -- hull back-projection (ref node:138-197) -----------------------------
    def generate_and_publish_convex_hull(self, labels: np.ndarray, camera: str,
                                         index_care_about: int = 1) -> None:
        cam = get_camera(camera)
        hulls = generate_convex_hull(np.asarray(labels), index_care_about=index_care_about)
        if not hulls or self.plane is None:
            return
        # scale hull vertices from the label map's resolution to the full
        # image the calibration describes (ref node:146-150)
        scale = np.array([[float(cam.im_size[0]) / labels.shape[1]],
                          [float(cam.im_size[1]) / labels.shape[0]]])
        self.cam_back_project_convex_hull(cam, [h * scale for h in hulls], index_care_about)

    def cam_back_project_convex_hull(self, cam, vertex_loops, index_care_about: int = 1) -> None:
        """Cast hull pixels to ground-plane points (host, f32) and publish markers."""
        if index_care_about == 1:
            color, lifetime = (0.8, 0.0, 0.0, 0.8), 10.0  # crosswalk red
        else:
            color, lifetime = (0.0, 0.0, 0.8, 0.8), 3.0   # road blue
        markers = []
        for loop in vertex_loops:
            d, C = cam.pixel_to_ray(torch.as_tensor(loop, dtype=torch.float32))
            ground = self.plane.ray_intersection(d, C).numpy()  # (3, K)
            markers.append(visualize_marker(
                (0, 0, 0), frame_id="velodyne", mtype="line_strip", scale=(0.1, 0.1, 0.1),
                color=color, points=ground.T, lifetime=lifetime))
        topic = "/crosswalk_markers" if index_care_about == 1 else "/road_markers"
        self.bus.publish(topic, markers)


class MappingNode:
    """Semantic image + pose (+ cloud) -> global BEV map (ref mapping.py:39-355).

    ``MAPPING.DEPTH_METHOD`` ``points_map`` or ``points_raw`` subscribes the
    cloud topic and fuses through the engine step; any other method is the
    planar fallback, which syncs the pose only.  ``tf_tree``: a
    TransformTree fed from ``/tf``; a camera whose frame it connects to
    ``base_link`` gets those extrinsics before its first step, and the
    planar fallback takes its ``world -> local_map`` edge when it has one.
    """

    #: image topics this node consumes; FusedOnlineNode takes raw frames
    IMAGE_TOPICS = ("/camera1/semantic", "/camera6/semantic")

    def __init__(self, cfg, bus: TopicBus, engine: Optional[SemanticMappingEngine] = None,
                 record_inputs: bool = False, tf_tree=None, executor=None,
                 device: DeviceLike = "cuda"):
        _sub = _make_subscriber(bus, executor)
        self.depth_method = cfg.MAPPING.DEPTH_METHOD
        # None: the planar fallback, which takes no cloud
        self.pcd_topic = CLOUD_TOPICS.get(self.depth_method)
        self.cfg = cfg
        self.bus = bus
        self.tf_tree = tf_tree
        self._tf_cameras_registered: set = set()
        self.engine = engine or SemanticMappingEngine(cfg, device=device)
        self.grid: Optional[torch.Tensor] = None
        self.test_cut_time = cfg.TEST_END_TIME
        self.label_colors = np.array(cfg.LABEL_COLORS, dtype=np.uint8)
        self.record_inputs = record_inputs
        self.input_list: List[FrameRecord] = []
        self.save_map_to_file = False
        self.finalized_map: Optional[np.ndarray] = None
        self.eval_result: Optional[dict] = None

        output_dir = resolve_output_dir(cfg.OUTPUT_DIR, cfg.TASK_NAME)
        self.logger = MyLogger("mapping", save_dir=output_dir, use_timestamp=False)
        self.output_dir = self.logger.save_dir

        # time-sync queues (ref mapping.py:91-104); the reference drops
        # frames silently when a queue is empty (ref mapping.py:281,284):
        # here they are counted and logged
        self.pose_queue: List[Message] = []
        self.pcd_queue: List[Message] = []
        self.dropped_frames = 0
        self.fused_frames = 0

        # history topics get deep mailboxes (they feed this node's own sync
        # queues); frames keep-latest depth 1
        _sub("/current_pose", self.pose_callback, queue_size=256)
        for topic in self.IMAGE_TOPICS:
            _sub(topic, self.image_callback, queue_size=1)
        if tf_tree is not None:
            _sub("/tf", self._tf_callback, queue_size=256)
        if self.pcd_topic:
            _sub(self.pcd_topic, self.pcd_callback, queue_size=256)

    # -- callbacks -----------------------------------------------------------
    def _tf_callback(self, msg: Message) -> None:
        """Fold /tf messages into the tree (rosbag playback path)."""
        for tr in getattr(msg.data, "transforms", []):
            self.tf_tree.set_pose(
                tr.translation, tr.rotation,
                parent=tr.header.frame_id.lstrip("/"),
                child=tr.child_frame_id.lstrip("/"),
                stamp=tr.header.stamp,
            )

    def _maybe_register_tf_camera(self, camera: str) -> None:
        """Camera extrinsics from TF, once, before the camera's first step.

        The reference resolves camera->base_link from the live TF tree at
        startup (ref mapping.py:142-163) and composes it with the pose
        (ref :528-541).  If the tree carries the camera frame, the engine's
        camera is rebuilt with those extrinsics; the built-in setup stays
        the fallback.  A camera whose step was already built keeps its
        built-in extrinsics, as in the JAX package, where that step is
        compiled: a late ``/tf`` does not change it.
        """
        if self.tf_tree is None or camera in self._tf_cameras_registered:
            return
        if any(key[0] == camera for key in self.engine._step_fns):
            self._tf_cameras_registered.add(camera)
            return
        try:
            T_cam_to_base = self.tf_tree.lookup("base_link", camera)
        except LookupError:
            return  # no TF calibration yet: retry on later frames
        self._tf_cameras_registered.add(camera)
        T_cam_to_velo = np.linalg.inv(self.engine.T_velodyne_to_baselink) @ T_cam_to_base
        self.engine.cameras[camera] = camera_from_extrinsic(get_camera(camera), T_cam_to_velo)
        self.logger.log(f"Registered TF extrinsics for {camera}")

    def pcd_callback(self, msg: Message) -> None:
        self.pcd_queue.append(msg)

    def pose_callback(self, msg: Message) -> None:
        self.pose_queue.append(msg)
        if msg.stamp >= self.test_cut_time:
            self.save_map_to_file = True

    @staticmethod
    def _sync(queue: List[Message], target: float) -> Message:
        idx = nearest_stamp_index([m.stamp for m in queue], target)
        # select before trimming (ref :204-216), then drop everything before
        # the bracketing window (ref :210-217)
        msg = queue[idx]
        del queue[: max(idx - 1, 0)]
        return msg

    def _drop(self, stamp: float, what: str) -> None:
        self.dropped_frames += 1
        self.logger.log(f"Dropping frame at {stamp}: no {what} in queue "
                        f"({self.dropped_frames} dropped so far)", level="warning")

    def image_callback(self, msg: Message) -> None:
        """Fuse one frame (ref mapping.py:261-355)."""
        self._maybe_register_tf_camera(msg.frame_id)
        pcd_msg = None
        if self.pcd_topic:
            if not self.pcd_queue:
                return self._drop(msg.stamp, "point cloud")
            pcd_msg = self._sync(self.pcd_queue, msg.stamp)
        if not self.pose_queue:
            return self._drop(msg.stamp, "pose")
        pose_msg = self._sync(self.pose_queue, msg.stamp)

        if self.grid is None:
            self.grid = self.engine.init_grid()
        position, quaternion = pose_msg.data
        if pcd_msg is None:
            # planar fallback (ref :321, 446-488), driven by the synced pose.
            # As in the JAX package it counts no fused frame and records no
            # input.
            self.grid = self.engine.update_map_planar(
                self.grid, msg.data, self._planar_transform(position, quaternion),
                camera=msg.frame_id)
        else:
            self._fuse_frame(msg, pcd_msg, position, quaternion)
        if self.save_map_to_file:
            self.finalize()

    def _fuse_frame(self, msg: Message, pcd_msg: Message, position, quaternion) -> None:
        """The cloud branch of :meth:`image_callback`."""
        pcd = _host(pcd_msg.data).astype(np.float32)
        if self.record_inputs:
            self.input_list.append(FrameRecord(
                pcd=pcd, pcd_frame_id=pcd_msg.frame_id, semantic_image=_host(msg.data),
                position=_host(position), quaternion=_host(quaternion),
                camera=msg.frame_id, stamp=msg.stamp,
            ))
        pcd_pad, valid = pad_points(pcd, self.engine.point_bucket)
        labeled = self._fuse_cloud(msg, pcd_pad, valid, position, quaternion, pcd_msg.frame_id)
        self.fused_frames += 1
        if labeled is not None:
            # the labelled cloud for downstream consumers (ref :316-317)
            self.bus.publish("/semantic_point_cloud", (pcd_pad, *labeled),
                             stamp=msg.stamp, frame_id=pcd_msg.frame_id)

    def _fuse_cloud(self, msg, pcd_pad, valid, position, quaternion, pcd_frame_id):
        """One cloud-mode fusion; returns the labelled cloud ``(point_cls,
        point_vis)``, or None where the fusion makes none (FusedOnlineNode)."""
        self.grid, point_cls, point_vis = self.engine.step(
            self.grid, pcd_pad, valid, msg.data, position, quaternion,
            camera=msg.frame_id, pcd_frame_id=pcd_frame_id,
        )
        return point_cls, point_vis

    def _planar_transform(self, position, quaternion) -> np.ndarray:
        """local_map -> base_link from the synced pose (ref mapping.py:454-458):
        ``inv(T_base_to_origin(pose)) @ T_local_to_origin``, host f64, with
        local_map at the origin until the TF tree has ``world -> local_map``."""
        T_base_to_origin = pose_to_matrix(
            torch.as_tensor(_host(position), dtype=torch.float64),
            torch.as_tensor(_host(quaternion), dtype=torch.float64)).numpy()
        T_local_to_origin = np.eye(4)
        if self.tf_tree is not None:
            try:
                T_local_to_origin = self.tf_tree.lookup("world", "local_map")
            except LookupError:
                pass  # no local_map broadcast yet: anchored at the origin
        return np.linalg.inv(T_base_to_origin) @ T_local_to_origin

    # -- finalization (ref mapping.py:323-355) -------------------------------
    def finalize(self) -> np.ndarray:
        """Smooth + render (K1) + save ``global_map.png`` + evaluate + publish."""
        if self.record_inputs and self.cfg.MAPPING.INPUT_DIR:
            makedirs(self.cfg.MAPPING.INPUT_DIR, exist_ok=True)
            save_frames(self.input_list, osp.join(self.cfg.MAPPING.INPUT_DIR, "input_list.npz"))
        if self.grid is None:
            self.grid = self.engine.init_grid()
        color_map = unpack_rgba_image(render_bev_map_fused(self.grid, self.label_colors))
        color_map = color_map.cpu().numpy()

        makedirs(self.output_dir, exist_ok=True)
        output_file = osp.join(self.output_dir, "global_map.png")
        write_png(output_file, color_map)
        self.logger.log(f"Saving image to {output_file}")
        if self.cfg.GROUND_TRUTH_DIR:
            from ..evaluation.map_eval import MapEvaluator

            evaluator = MapEvaluator(ground_truth_dir=self.cfg.GROUND_TRUTH_DIR,
                                     logger=self.logger)
            self.eval_result = evaluator.test_single_map(color_map)

        self.bus.publish("/semantic_local_map", color_map)
        self.finalized_map = color_map
        self.save_map_to_file = False
        return color_map


class FusedOnlineNode(MappingNode):
    """One fused step per frame: raw camera frame + pose + cloud -> grid,
    through :meth:`FusedFramePipeline.step` (undistort or point distortion,
    scale, forward with K4, projection, update with K2).

    Against the two-node topology: no ``/cameraX/semantic`` republish, no
    ``/semantic_point_cloud`` labelled cloud, and no RGB colourise /
    palette-match round trip.  Sync, drop accounting, ``TEST_END_TIME``
    finalization and the output files are :class:`MappingNode`'s.  The
    network runs in the pipeline's bf16 whatever ``MODEL.COMPUTE_DTYPE``
    says, as in the JAX package.  The planar fallback has no fused step: a
    planar ``DEPTH_METHOD`` raises ``ValueError``.
    """

    IMAGE_TOPICS = ("/camera1/image_raw", "/camera6/image_raw")

    def __init__(self, cfg, bus: TopicBus, pipeline: Optional[FusedFramePipeline] = None,
                 state_dict=None, variables=None,
                 engine: Optional[SemanticMappingEngine] = None,
                 device: DeviceLike = "cuda", **kwargs):
        """``pipeline`` injects a prebuilt FusedFramePipeline; otherwise one
        is built from ``state_dict``, ``variables`` (flax, as numpy) or the
        network config's ``MODEL.WEIGHT``, with the distortion handled on
        the projected points when ``VISION_SEM_SEG.UNDISTORT`` is set."""
        depth_method = cfg.MAPPING.DEPTH_METHOD
        if depth_method not in CLOUD_TOPICS:
            raise ValueError(
                "FusedOnlineNode needs a cloud DEPTH_METHOD (points_map/points_raw); the "
                "planar path has no fused program — use the two-node topology for "
                f"MAPPING.DEPTH_METHOD={depth_method!r}")
        if pipeline is None:
            if state_dict is None:
                weight = cfg.VISION_SEM_SEG.SEM_SEG_NETWORK.MODEL.WEIGHT
                if variables is not None:
                    state_dict = flax_to_state_dict(variables)
                elif weight:
                    state_dict = load_weights(weight)
                else:
                    raise ValueError("MODEL.WEIGHT is empty and no weights given")
            undistort = bool(cfg.VISION_SEM_SEG.get("UNDISTORT", True))
            pipeline = FusedFramePipeline(
                cfg, state_dict, engine=engine,
                distortion="points" if undistort else "none", device=device,
            )
        self.pipeline = pipeline
        super().__init__(cfg, bus, engine=pipeline.engine, device=pipeline.device, **kwargs)

    def _fuse_cloud(self, msg, pcd_pad, valid, position, quaternion, pcd_frame_id):
        self.grid, _ = self.pipeline.step(
            self.grid, msg.data, pcd_pad, valid, position, quaternion,
            camera=msg.frame_id, pcd_frame_id=pcd_frame_id,
        )
        return None

"""The probabilistic BEV mapping engine.

Port of ``vision_semantic_segmentation_tpu/mapping/engine.py`` (the mapping
math of ref mapping.py:292-488): per frame,

    pose -> T_origin_to_velodyne -> project points -> gather labels from
    the semantic image -> match palette -> cell index -> mark (cell, class)
    hits -> fold confusion-matrix columns into the grid (K2) -> LiDAR
    lane-intensity boost

The grid is planar (C, H, W) f32 on the device and is updated in place.

The update marks hits in a dense (C, H*W) observation buffer, then K2
folds it into the grid.  The reference adds evidence with a numpy
fancy-index ``+=``, which collapses duplicate (cell, class) hits to one
observation per frame.  Here the hits are marked with ``index_put_`` of 1.0
without accumulation: duplicates write the same value, so they collapse
exactly, with no sort.  Points that do not update write to one spare slot
past the end, so no boolean compaction (and no host sync) is needed.
``duplicate_semantics='accumulate'`` adds 1.0 per point with
``index_add_``; counts below 2**24 are exact in f32, so the result does not
depend on the order of the atomics.  The JAX package also has a
sort-and-segmented-scan form (``MAPPING.FOLD_METHOD 'scatter'``, keys
sorted by ``SORT_METHOD``), because a TPU serialises scatters with
duplicate indices; the card does not, so the port runs this one update for
every name of both keys (an unknown name raises ``ValueError``).  Its grid
matches each JAX form to f32 rounding of at most C + 1 terms a cell.

Confidence weighting (``weights``): a deduped (cell, class) hit carries the
largest confidence of its points (``scatter_reduce_`` ``amax`` into the
buffer); per-point mode sums the confidences.  With every weight at 1 the
grid equals the unweighted one exactly.

Windowed mode (``MAPPING.UPDATE_WINDOW`` > 0) updates a pose-centred slab
gathered and scattered back by index tensors, so it reads nothing back to
the host either; the whole frame step can be traced by ``torch.export``.

The planar fallback (``update_map_planar``, ref mapping.py:446-488) fits an
image -> grid homography on the host and warps the semantic image onto the
grid on the grid's device; it adds per-class counts, not the evidence fold.
"""
from __future__ import annotations

import dataclasses
import os.path as osp
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..geometry.camera import Camera, camera_setup_1, camera_setup_6
from ..geometry.homography import find_homography, warp_perspective
from ..geometry.transforms import (
    euler_matrix,
    homogenize,
    mm,
    pose_to_matrix,
    se3_inverse,
    to_int32,
)
from ..ops.colormap import colors_to_labels
from ..ops.kernels.fold import evidence_fold_add_


def getattr_cfg(cfg, dotted: str, default):
    """Fetch a dotted config key, tolerating older configs without it."""
    node = cfg
    for part in dotted.split("."):
        if part not in node:
            return default
        node = node[part]
    return node


# Fixed global map origin: min x/y of the point-cloud map, so all grid
# coordinates are positive (ref mapping.py:228-236, 404)
PCD_ORIGIN_OFFSET = np.array([1369.0496826171875, 562.84814453125, 0.0])


def velodyne_to_baselink() -> np.ndarray:
    """Tuned velodyne->baselink extrinsic (ref mapping.py:165-170)."""
    T = euler_matrix(0.0, 0.140, 0.0)
    T[0:3, 3] = [2.64, 0.0, 1.98]
    return T


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """BEV grid geometry (ref mapping.py:110-117).

    ``boundary`` is [[xmin, xmax], [ymin, ymax]] in meters; rows index x,
    columns index y (the reference's map[x_cell, y_cell] convention).
    """

    boundary: Tuple[Tuple[float, float], Tuple[float, float]]
    resolution: float
    num_classes: int

    @property
    def height(self) -> int:
        return int((self.boundary[0][1] - self.boundary[0][0]) / self.resolution)

    @property
    def width(self) -> int:
        return int((self.boundary[1][1] - self.boundary[1][0]) / self.resolution)

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (self.height, self.width, self.num_classes)

    @classmethod
    def from_cfg(cls, cfg) -> "GridSpec":
        b = cfg.MAPPING.BOUNDARY
        return cls(
            boundary=((b[0][0], b[0][1]), (b[1][0], b[1][1])),
            resolution=cfg.MAPPING.RESOLUTION,
            num_classes=len(cfg.LABELS_NAMES),
        )


def pad_points(pcd: np.ndarray, bucket: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pad a (4, N) point cloud to (4, bucket) with a validity mask.

    Overflow points beyond the bucket are dropped (size the bucket above
    the sensor's maximum).
    """
    n = pcd.shape[1]
    if n > bucket:
        pcd = pcd[:, :bucket]
        n = bucket
    out = np.zeros((4, bucket), dtype=np.float32)
    out[:, :n] = pcd
    valid = np.zeros((bucket,), dtype=bool)
    valid[:n] = True
    return out, valid


class SemanticMappingEngine:
    """Mapping engine; the grid is explicit state, updated in place.

    Usage:
        engine = SemanticMappingEngine(cfg)            # device="cuda"
        grid = engine.init_grid()
        grid, point_labels, point_mask = engine.step(
            grid, pcd, valid, semantic_rgb, position, quaternion,
            camera="camera1")
    """

    def __init__(
        self,
        cfg,
        evidence: Optional[np.ndarray] = None,
        duplicate_semantics: str = "reference",
        cameras: Optional[Dict[str, Camera]] = None,
        device: DeviceLike = "cuda",
    ):
        """Args:
            duplicate_semantics: 'reference' collapses duplicate (cell,
                class) hits per frame like the reference's fancy-index +=
                (ref mapping.py:424); 'accumulate' adds evidence per point.
            cameras: extra/override camera calibrations, merged over the
                built-in setups 1/6.
            device: where the grid lives; CUDA unless the caller asks for
                the CPU.
        """
        from .confusion import evidence_matrix

        if duplicate_semantics not in ("reference", "accumulate"):
            raise ValueError(f"unknown duplicate_semantics {duplicate_semantics!r}")
        self.device = resolve_device(device)
        self.duplicate_semantics = duplicate_semantics
        self.cfg = cfg
        # 0 = dense update over the whole grid; > 0 = pose-centered window
        # of that many cells.  Points outside the window are dropped, so
        # size it >= ~2.2 * RANGE_MAX / RESOLUTION.
        self.update_window = int(getattr_cfg(cfg, "MAPPING.UPDATE_WINDOW", 0))
        self.grid_spec = GridSpec.from_cfg(cfg)
        self.label_names = list(cfg.LABELS_NAMES)
        self.label_colors = np.array(cfg.LABEL_COLORS, dtype=np.uint8)
        self.lane_channel = (
            self.label_names.index("lane") if "lane" in self.label_names else -1
        )
        self.use_intensity = bool(cfg.MAPPING.PCD.USE_INTENSITY)
        self.range_max = float(cfg.MAPPING.PCD.RANGE_MAX)
        self.point_bucket = int(cfg.MAPPING.POINT_BUCKET)
        # the JAX package's update form and key sort; the port runs one
        # update for every name, and checks the names when it is built
        self.fold_method = str(getattr_cfg(cfg, "MAPPING.FOLD_METHOD", "matmul"))
        self.sort_method = str(getattr_cfg(cfg, "MAPPING.SORT_METHOD", "bitonic"))

        if evidence is None:
            evidence = evidence_matrix(cfg, len(self.label_names))
        # (C, C): column i is the additive evidence for observed class i
        self.evidence = np.ascontiguousarray(np.asarray(evidence, dtype=np.float32))

        self.T_velodyne_to_baselink = velodyne_to_baselink()
        self.cameras: Dict[str, Camera] = {
            "camera1": camera_setup_1(),
            "camera6": camera_setup_6(),
        }
        if cameras:
            self.cameras.update(cameras)
        self._step_fns: Dict[Tuple[str, bool], callable] = {}
        self._runner_fns: Dict[Tuple[str, bool], callable] = {}

    # -- state --------------------------------------------------------------
    def init_grid(self) -> torch.Tensor:
        """Fresh planar (C, H, W) f32 evidence grid on the engine's device."""
        spec = self.grid_spec
        return torch.zeros(
            (spec.num_classes, spec.height, spec.width), dtype=torch.float32,
            device=self.device,
        )

    @staticmethod
    def to_hwc(grid) -> np.ndarray:
        """Planar grid -> reference (H, W, C) numpy layout."""
        if isinstance(grid, torch.Tensor):
            grid = grid.detach().cpu().numpy()
        return np.moveaxis(np.asarray(grid), 0, -1)

    def save_grid(self, path: str, grid) -> str:
        """Checkpoint the evidence grid + its geometry to ``path`` (.npz).

        A row-sharded grid (``parallel.grid_shard.ShardedGrid``) is gathered
        once, straight to the host.
        """
        from ..parallel.grid_shard import ShardedGrid

        if not path.endswith(".npz"):
            path += ".npz"
        spec = self.grid_spec
        if isinstance(grid, ShardedGrid):
            grid = grid.gather("cpu")
        if isinstance(grid, torch.Tensor):
            grid = grid.detach().cpu().numpy()
        np.savez_compressed(
            path,
            grid=np.asarray(grid, dtype=np.float32),
            boundary=np.asarray(spec.boundary, dtype=np.float64),
            resolution=np.float64(spec.resolution),
            label_names=np.asarray(self.label_names),
        )
        return path

    def load_grid(self, path: str) -> torch.Tensor:
        """Load a :meth:`save_grid` checkpoint; validates geometry/labels."""
        if not path.endswith(".npz") and not osp.exists(path):
            path += ".npz"
        with np.load(path, allow_pickle=False) as z:
            spec = self.grid_spec
            boundary = z["boundary"].tolist()
            resolution = float(z["resolution"])
            labels = [str(s) for s in z["label_names"]]
            want_shape = (spec.num_classes, spec.height, spec.width)
            if (
                z["grid"].shape != want_shape
                or boundary != [list(b) for b in spec.boundary]
                or resolution != spec.resolution
                or labels != self.label_names
            ):
                raise ValueError(
                    f"grid checkpoint {path!r} does not match this engine: "
                    f"ckpt grid {z['grid'].shape} boundary {boundary} "
                    f"res {resolution} labels {labels} vs engine "
                    f"{want_shape} {spec.boundary} {spec.resolution} "
                    f"{self.label_names}"
                )
            return torch.from_numpy(z["grid"]).to(self.device)

    def _const(self, a, device=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device or self.device)

    # -- frame step ------------------------------------------------------------
    def _build_pointwise(
        self,
        camera_id: str,
        pcd_in_velodyne_frame: bool,
        image_is_class_id: bool = False,
        image_full_hw=None,
        distorted_image: bool = False,
        return_pixels: bool = False,
        device=None,
    ):
        """Closure computing per-point (cell, cls, vis, upd).

        ``image_is_class_id`` switches the label image from RGB (palette
        matched, the reference dataflow) to an (H, W) int32 channel-id image
        (<0 = unmapped).  ``image_full_hw`` is the raw frame size when the
        label image is smaller (nearest-downscaled gather indices).
        ``distorted_image=True`` means the label image is in the raw
        (distorted) camera frame: the plumb-bob forward model is applied to
        the projected points instead of resampling the image.
        ``return_pixels=True`` appends the (downscaled) gather rows and
        columns ``gy, gx``, for callers that fetch more per-point data
        (the network's confidence).  ``device`` holds the closure's
        constants (default: the engine's); the parallel paths build one
        closure per device of their mesh.
        """
        cam = self.cameras[camera_id]
        P = self._const(cam.P, device)
        P_norm = self._const(cam.P_norm, device)
        K = self._const(cam.K, device)
        has_dist = distorted_image and cam.dist is not None
        T_v2b = self._const(self.T_velodyne_to_baselink, device)
        label_colors = np.asarray(self.label_colors)
        offset = self._const(PCD_ORIGIN_OFFSET[:2, None], device)
        spec = self.grid_spec
        bmin = self._const([[spec.boundary[0][0]], [spec.boundary[1][0]]], device)
        inv_res = 1.0 / spec.resolution
        h, w = spec.height, spec.width
        lane = self.lane_channel
        use_intensity = self.use_intensity and lane >= 0
        range_max = self.range_max

        def pointwise(pcd, valid, image, position, quaternion):
            xyz = pcd[0:3].float()

            # pose -> T_origin_to_velodyne (ref mapping.py:368-371)
            if pcd_in_velodyne_frame:
                xyz_velo = xyz
            else:
                T_b2o = pose_to_matrix(position, quaternion).float()
                T_o2v = se3_inverse(mm(T_b2o, T_v2b))
                xyz_velo = mm(T_o2v[:3, :3], xyz) + T_o2v[:3, 3:4]

            # perspective projection with int32 truncation (ref :375)
            if has_dist:
                cam_pts = mm(P_norm, homogenize(xyz_velo))
                z = torch.where(cam_pts[2] == 0, 1e-9, cam_pts[2])
                xy_d = cam.distort_normalized(cam_pts[:2] / z)
                proj2 = mm(K[:2, :2], xy_d) + K[:2, 2:3]
                # far-off-axis points blow the polynomial up; bound before
                # the int cast (they are rejected by the masks anyway)
                ixy = to_int32(torch.clamp(proj2, -1e6, 1e6))
            else:
                proj = mm(P, homogenize(xyz_velo))
                ixy = to_int32(proj[:2] / proj[2])

            # visibility: in front, in range, inside the image (ref :378-383)
            front = (xyz_velo[0] > 0) & (xyz_velo[0] < range_max)
            img_h, img_w = image.shape[0], image.shape[1]
            bound_h, bound_w = image_full_hw if image_full_hw else (img_h, img_w)
            in_img = (ixy[0] >= 0) & (ixy[0] < bound_w) & (ixy[1] >= 0) & (ixy[1] < bound_h)
            vis = valid & front & in_img

            # gather point labels from the semantic image (ref :387)
            gx = torch.clamp(ixy[0], 0, bound_w - 1)
            gy = torch.clamp(ixy[1], 0, bound_h - 1)
            if image_full_hw:
                # nearest-downscale the gather indices (non-negative: // is
                # the JAX package's integer division)
                gx = gx * img_w // bound_w
                gy = gy * img_h // bound_h
            if image_is_class_id:
                cls = image[gy.long(), gx.long()].to(torch.int32)
            else:
                cls = colors_to_labels(image[gy.long(), gx.long()], label_colors, fill=-1)

            # grid cell from the point's map-frame x/y (ref :403-411)
            local = xyz[0:2] + offset
            cell_rc = to_int32((local - bmin) * inv_res)
            on_grid = (cell_rc[0] >= 0) & (cell_rc[0] < h) & (cell_rc[1] >= 0) & (cell_rc[1] < w)
            cell = cell_rc[0] * w + cell_rc[1]
            upd = vis & on_grid & (cls >= 0)
            if return_pixels:
                return cell, cls, vis, upd, gy.long(), gx.long()
            return cell, cls, vis, upd

        return pointwise

    def _build_dense_update(self):
        """Closure ``update(grid, cell, cls, intensity, upd, gh, gw, weights=None)``.

        ``grid`` is a contiguous planar (C, gh, gw) slab, updated in place;
        ``cell`` indexes it as ``row * gw + col``.  ``weights`` (N,) scales
        each point's observation (confidence weighting).  Every known
        ``fold_method`` and ``sort_method`` builds this one update (see the
        module docstring).
        """
        if self.fold_method not in ("matmul", "scatter"):
            raise ValueError(f"unknown fold_method {self.fold_method!r}")
        if self.sort_method not in ("bitonic", "radix"):
            raise ValueError(f"unknown sort_method {self.sort_method!r}")
        evidence = self.evidence
        num_cls = evidence.shape[0]
        lane = self.lane_channel
        use_intensity = self.use_intensity and lane >= 0
        dedupe = self.duplicate_semantics == "reference"

        def _dense_update(grid, cell, cls, intensity, upd, gh, gw, weights=None):
            n = gh * gw
            dev = grid.device
            # (cell, class) hit -> class * n + cell in the planar layout;
            # non-updating points all write the spare slot num_cls * n
            key = torch.where(
                upd, cls.clamp(min=0).long() * n + cell.long(),
                torch.full_like(cell, num_cls * n, dtype=torch.long),
            )
            obs = torch.zeros(num_cls * n + 1, dtype=torch.float32, device=dev)
            if weights is not None:
                # a deduped hit carries its strongest point's confidence; the
                # spare slot takes whatever the non-updating points carry
                w = weights.to(device=dev, dtype=torch.float32)
                if dedupe:
                    obs.scatter_reduce_(0, key, w, "amax", include_self=False)
                else:
                    obs.index_add_(0, key, w)
            elif dedupe:
                obs.index_put_((key,), torch.ones((), device=dev))
            else:
                obs.index_add_(0, key, torch.ones(key.shape, device=dev))
            evidence_fold_add_(grid, obs[: num_cls * n].view(num_cls, gh, gw), evidence)

            if use_intensity:
                # LiDAR intensity lane boost (ref :427-437): retro-reflective
                # paint returns get +2 on the lane channel, once per cell per
                # frame under 'reference' dedupe, per point otherwise
                boost = upd & (cls == lane) & ((intensity < 2) | (intensity > 14))
                bidx = torch.where(
                    boost, cell.long(), torch.full_like(cell, n, dtype=torch.long)
                )
                buf = torch.zeros(n + 1, dtype=torch.float32, device=dev)
                if dedupe:
                    buf.index_put_((bidx,), torch.full((), 2.0, device=dev))
                else:
                    buf.index_add_(0, bidx, torch.full(bidx.shape, 2.0, device=dev))
                grid[lane] += buf[:n].view(gh, gw)
            return grid

        return _dense_update

    def _build_update(self):
        """Closure ``update(grid, cell, cls, intensity, upd, weights=None)``
        applying the frame update to the full (C, H, W) grid.

        Windowed mode: the update runs on a pose-centred (C, win, win) slab,
        so its cost is independent of the grid size.  The slab is gathered
        and written back through index tensors centred on the mean updated
        cell, so nothing is read back to the host.
        """
        _dense_update = self._build_dense_update()
        spec = self.grid_spec
        h, w = spec.height, spec.width
        win = int(self.update_window) if self.update_window else 0
        windowed = 0 < win < max(h, w)
        win_r = min(win, h)
        win_c = min(win, w)

        def _window_update(grid, cell, cls, intensity, upd, weights=None):
            row = cell // w
            col = cell % w
            n_upd = torch.clamp(upd.sum(), min=1)
            # centre the window on the mean updated cell
            r_mean = torch.where(upd, row, 0).sum() // n_upd
            c_mean = torch.where(upd, col, 0).sum() // n_upd
            r0 = torch.clamp(r_mean - win_r // 2, 0, max(h - win_r, 0))
            c0 = torch.clamp(c_mean - win_c // 2, 0, max(w - win_c, 0))

            lr = row - r0
            lc = col - c0
            in_win = (lr >= 0) & (lr < win_r) & (lc >= 0) & (lc < win_c)
            local_cell = lr * win_c + lc
            rows = (r0 + torch.arange(win_r, device=grid.device))[:, None]
            cols = (c0 + torch.arange(win_c, device=grid.device))[None, :]
            slab = grid[:, rows, cols].contiguous()
            _dense_update(slab, local_cell, cls, intensity, upd & in_win, win_r, win_c,
                          weights=weights)
            grid[:, rows, cols] = slab
            return grid

        if windowed:
            return _window_update
        return lambda grid, cell, cls, intensity, upd, weights=None: _dense_update(
            grid, cell, cls, intensity, upd, h, w, weights=weights
        )

    def _build_step(self, camera_id: str, pcd_in_velodyne_frame: bool):
        pointwise = self._build_pointwise(camera_id, pcd_in_velodyne_frame)
        apply_update = self._build_update()

        def step(grid, pcd, valid, image, position, quaternion):
            cell, cls, vis, upd = pointwise(pcd, valid, image, position, quaternion)
            grid = apply_update(grid, cell, cls, pcd[3], upd)
            return grid, cls, vis

        return step

    def build_sequence_runner(self, camera: str = "camera1", pcd_frame_id: str = ""):
        """Runner fusing a stacked window of pre-segmented frames, in place.

        ``run(grid, frames)``: ``frames`` maps image (T, Hi, Wi, 3) u8, pcd
        (T, 4, N), valid (T, N), position (T, 3) and quaternion (T, 4) to
        tensors on the engine's device.  A loop over the window's frames
        through the cached per-(camera, cloud-frame) step stands in for the
        JAX package's ``lax.scan``; the grid never leaves the device.  The
        runner is cached per (camera, cloud-frame), as the step is.
        """
        key = (camera, pcd_frame_id == "velodyne")
        run = self._runner_fns.get(key)
        if run is not None:
            return run
        if key not in self._step_fns:
            self._step_fns[key] = self._build_step(*key)
        step = self._step_fns[key]

        def run(grid, frames):
            for i in range(len(frames["image"])):
                grid, _, _ = step(grid, frames["pcd"][i], frames["valid"][i], frames["image"][i],
                                  frames["position"][i], frames["quaternion"][i])
            return grid

        self._runner_fns[key] = run
        return run

    def as_tensor(self, a, dtype=None) -> torch.Tensor:
        """Host array (or tensor) -> tensor on the engine's device."""
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    def step(
        self,
        grid: torch.Tensor,
        pcd,
        valid,
        image,
        position,
        quaternion,
        camera: str = "camera1",
        pcd_frame_id: str = "",
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Fuse one frame into the grid, in place.

        Args:
            grid: planar (C, H, W) evidence grid (from ``init_grid``).
            pcd: (4, N) points [x, y, z, intensity] (N padded to the bucket).
            valid: (N,) mask for padded points.
            image: (Hi, Wi, 3) uint8 semantic RGB image.
            position, quaternion: vehicle pose (unused if pcd is already in
                the velodyne frame, ref mapping.py:366-373).
            camera: 'camera1' | 'camera6'.
            pcd_frame_id: 'velodyne' means ego-frame points (points_raw mode).

        Returns:
            (updated grid, per-point class index, per-point visibility).
        """
        key = (camera, pcd_frame_id == "velodyne")
        if key not in self._step_fns:
            self._step_fns[key] = self._build_step(*key)
        return self._step_fns[key](
            grid,
            self.as_tensor(pcd, torch.float32),
            self.as_tensor(valid, torch.bool),
            self.as_tensor(image),
            self.as_tensor(position, torch.float32),
            self.as_tensor(quaternion, torch.float32),
        )

    # -- planar (homography) fallback ----------------------------------------
    def anchor_points_2(self) -> np.ndarray:
        """Grid-frame anchor pixels used to fit the homography (ref :160-163)."""
        w, h = self.grid_spec.width, self.grid_spec.height
        return np.array(
            [[w, w / 2, w / 2, w], [h / 4, h / 4, h * 3 / 4, h * 3 / 4]], dtype=np.float64
        )

    def discretize_matrix_inv(self) -> np.ndarray:
        """Grid pixel -> local metric coordinates (ref mapping.py:148-153)."""
        spec = self.grid_spec
        return np.array([
            [spec.resolution, 0, spec.boundary[0][0]],
            [0, spec.resolution, spec.boundary[1][1]],
            [0, 0, 1],
        ])

    def update_map_planar(self, grid: torch.Tensor, image, T_local_to_base: np.ndarray,
                          camera: str = "camera1") -> torch.Tensor:
        """Project the semantic image onto the ground plane and accumulate, in place.

        Ref mapping.py:446-488: anchor grid cells are cast local_map ->
        base_link -> velodyne -> image (host numpy f64) to fit an image ->
        grid homography (host DLT); the semantic image, nearest-warped onto
        the grid on the grid's device, adds 1 to each class layer where its
        first colour channel matches the class colour's, with the cells
        closer than 8 m in x masked out; then ``grid = max(grid, 0)``.

        The reference compares the warped pixels against label *name strings*
        (``image_on_map[:, :, 0] == self.label_names[i]``, ref :474), which
        is always False in python3, so its planar path adds nothing.  As in
        the JAX package, the evident intent is implemented: match the first
        colour channel.
        """
        cam = self.cameras[camera]
        anchors = self.anchor_points_2()
        pts_local = self.discretize_matrix_inv() @ np.vstack([anchors, np.ones((1, 4))])
        pts_local[2, :] = 0.0
        pts_local_h = np.vstack([pts_local, np.ones((1, 4))])

        T_local_to_velodyne = (np.linalg.inv(self.T_velodyne_to_baselink)
                               @ np.asarray(T_local_to_base, dtype=np.float64))
        proj = cam.P @ (T_local_to_velodyne @ pts_local_h)
        H = find_homography((proj[:2] / proj[2]).T, anchors.T)
        spec = self.grid_spec
        image_on_map = warp_perspective(self.as_tensor(image), H, (spec.width, spec.height),
                                        mode="nearest")

        sep = int((8 - spec.boundary[0][0]) / spec.resolution)
        col_ok = torch.arange(spec.width, device=grid.device) >= sep
        first = self.as_tensor(self.label_colors[:len(self.label_names), 0])
        match = (image_on_map[..., 0][None] == first[:, None, None]) & col_ok
        grid += match.to(grid.dtype)
        return grid.clamp_(min=0.0)

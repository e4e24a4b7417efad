"""Fused camera + LiDAR frame pipeline.

Port of ``vision_semantic_segmentation_tpu/runtime/pipeline.py``: raw uint8
camera frame + point cloud + pose -> updated BEV grid,

    undistort -> scale -> normalize -> DeepLab forward -> argmax ->
    network-class -> map-channel table -> point projection -> label
    gather -> evidence update

The class-id shortcut skips the reference's RGB colourise/palette-match
round trip while staying identical: the network-class -> channel lookup
composes the palette write (ref node:114) with the engine's palette match
(ref mapping.py:414-424).

On the card the forward's ASPP atrous depthwise convs run K4 (one call for
all branches; Xception's 60 stride-1 depthwise convs run K3), the update's
fold runs K2, and ``MappingReplay.finalize`` renders with K1.
:meth:`FusedFramePipeline.compile_sequence_runner` runs the step exported
by ``torch.export`` (``runtime/export.py``).

On the card :meth:`FusedFramePipeline.segment` replays the preprocessing and
the network's forward from a CUDA graph, one a (camera, frame shape,
``upsample_pred``): the host launches a copy, the replay and a clone in
place of about a thousand kernels a frame.  The same kernels run in the
same order, so the logits are the eager ones bit for bit.  On the card in
eval that forward runs with the network's BatchNorms folded into the convs
and the bias, residual add and ReLU in the conv's epilogue
(``models/fold.py``), graphed or not; every other call (training,
``params``, a CPU frame) runs the modules as they are.
"""
from __future__ import annotations

import warnings
from typing import Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..inference.predictor import IMAGENET_MEAN, IMAGENET_STD
from ..mapping.engine import SemanticMappingEngine
from ..models import fold
from ..models.build import build_model
from ..ops import resize
from ..ops.kernels import _lib as kernel_lib
from ..ops.warp import undistort
from ..utils.benchmark import span


def network_to_channel_table(cfg, num_network_classes: int = 19) -> np.ndarray:
    """(num_network_classes,) -> mapped grid channel, -1 when unmapped.

    Composes cfg.LABELS (network index of each mapped channel,
    ref base_cfg.py:47): e.g. network class 2 (road) -> channel 0.
    """
    table = np.full(num_network_classes, -1, dtype=np.int32)
    for channel, net_idx in enumerate(cfg.LABELS):
        table[net_idx] = channel
    return table


class SegmentGraphInfo(NamedTuple):
    """Calls of :meth:`FusedFramePipeline.segment` by how they ran: graphs
    captured, calls replayed from a graph (the capturing call among them),
    calls run eagerly, and captures that raised (their key then runs
    eagerly)."""
    captures: int
    replays: int
    eager: int
    failed: int


class _SegmentGraph(NamedTuple):
    """A captured forward: its graph, static frame and logits, the
    hand-written kernels' launches that one replay makes, and the resize
    matrices it reads (held here, as the cache may drop them)."""
    graph: object  # torch.cuda.CUDAGraph
    frame: torch.Tensor
    logits: torch.Tensor
    launches: Dict[kernel_lib.CudaKernel, int]
    matrices: Tuple[torch.Tensor, ...]


_WARMED = "warmed"  # a key's first call ran eagerly; the next one captures
_FAILED = "failed"  # a key's capture raised; it runs eagerly


class FusedFramePipeline:
    """Camera + LiDAR fusion step against the device-resident grid."""

    def __init__(
        self,
        cfg,
        state_dict: Optional[Mapping[str, torch.Tensor]] = None,
        engine: Optional[SemanticMappingEngine] = None,
        compute_dtype: torch.dtype = torch.bfloat16,
        distortion: str = "none",
        confidence_weighting: bool = False,
        device: DeviceLike = "cuda",
        generator: Optional[torch.Generator] = None,
    ):
        """Args:
            state_dict: network weights (``models/convert.py`` turns the JAX
              package's variables into one); None draws them from
              ``generator``.
            distortion: how lens distortion is handled per frame:
              ``'none'`` — frames are already rectified/pinhole;
              ``'image'`` — undistort each raw frame through the camera's
              inverse map before the downscale (the reference's dataflow,
              ref node:85-87);
              ``'points'`` — segment the raw frame and apply the plumb-bob
              forward model to the projected points (engine
              ``distorted_image`` mode).
            confidence_weighting: scale each point's evidence by the
              network's softmax confidence (of the winning class) at its
              pixel; a deduped (cell, class) hit carries its strongest
              point's confidence, and with every confidence at 1 the update
              is the unweighted one.
            compute_dtype: the network's dtype (bf16 default, or f32).
        """
        if distortion not in ("none", "image", "points"):
            raise ValueError(f"unknown distortion {distortion!r} (none|image|points)")
        self.device = resolve_device(device)
        self.distortion = distortion
        self.confidence_weighting = bool(confidence_weighting)
        self.cfg = cfg
        self.engine = engine or SemanticMappingEngine(cfg, device=self.device)
        if self.engine.device != self.device:
            raise ValueError(f"engine on {self.engine.device}, pipeline on {self.device}")
        net_cfg = cfg.VISION_SEM_SEG.SEM_SEG_NETWORK
        self.compute_dtype = compute_dtype
        self.model = build_model(net_cfg, dtype=compute_dtype, device=self.device,
                                 generator=generator)
        if state_dict is not None:
            self.model.load_state_dict(state_dict, strict=True)
        self.image_scale = float(cfg.VISION_SEM_SEG.IMAGE_SCALE)
        # VISION_SEM_SEG.UPSAMPLE_PRED: bilinearly upsample the logits to the
        # (scaled) input size before the argmax; the engine's
        # nearest-downscaled gather indices handle either label size
        self.upsample_pred = bool(cfg.VISION_SEM_SEG.get("UPSAMPLE_PRED", False))
        self._undistort_maps: Dict[str, torch.Tensor] = {}
        if distortion == "image":
            for name, cam in self.engine.cameras.items():
                if cam.dist is not None and cam.im_size is not None:
                    self._undistort_maps[name] = torch.from_numpy(
                        cam.undistort_maps()).to(self.device)
        self.channel_table = torch.as_tensor(
            network_to_channel_table(cfg, net_cfg.DATASET.NUM_CLASSES), device=self.device
        )
        self._mean = torch.as_tensor(IMAGENET_MEAN, device=self.device)
        self._std = torch.as_tensor(IMAGENET_STD, device=self.device)
        self._pointwise: Dict[Tuple, Callable] = {}
        self._apply_update = self.engine._build_update()
        self._graphs: Dict[Tuple, object] = {}  # key -> _WARMED, _FAILED or _SegmentGraph
        self._graph_counts = dict.fromkeys(SegmentGraphInfo._fields, 0)
        self._folded: Optional[fold.FoldedNetwork] = None  # made at the first call that folds

    def init_grid(self) -> torch.Tensor:
        return self.engine.init_grid()

    def segment(self, frame_u8: torch.Tensor, camera: str = "camera1",
                params: Optional[Mapping[str, torch.Tensor]] = None) -> torch.Tensor:
        """Raw (H, W, 3) uint8 frame -> (1, C, h', w') logits (ref node:82-110).

        ``params`` (a state dict) replaces the network's own weights for this
        call (``torch.func.functional_call``; the exported step's weights
        are its inputs).

        A call that :meth:`_graph_key` keys replays a CUDA graph: the key's
        first call runs eagerly (it chooses cuDNN's plans and fills the
        resize matrices' cache, ``ops/resize.py``, which a capture may not
        copy into), the second captures and replays, later ones copy the
        frame into the graph's input and replay.  The graph reads the
        weights, the running statistics and the resize matrices by address
        (it holds the matrices): ``load_state_dict`` (an in-place copy) is
        honoured; a parameter replaced by another tensor is honoured where
        it folds (below), not where the graph reads it itself (K3's and
        K4's weights, a BatchNorm left unfolded).  The
        logits returned are a clone, which the next replay leaves alone.
        The forward runs without grad, whatever the caller's grad mode.
        :meth:`segment_graph_info` counts the calls by how they ran.

        A call that :meth:`_folds`, keyed or not (eager, captured or
        replayed), runs the network's folded forward (``models/fold.py``),
        refolded first where a weight or statistic changed since the last
        fold (:meth:`fold_info`); the graph reads the folded weights by
        address.  Any other call runs the modules unfolded."""
        key = self._graph_key(frame_u8, camera, params)
        folded = self._folds(frame_u8, params)
        with torch.no_grad():
            if folded:
                self._refold()
            entry = None if key is None else self._graphs.get(key)
            if isinstance(entry, _SegmentGraph):
                return self._replay(entry, frame_u8)
            if entry == _WARMED:
                entry = self._capture(key, frame_u8, camera, folded)
                if entry is not None:
                    return self._replay(entry, frame_u8)
            elif key is not None and entry is None:
                self._graphs[key] = _WARMED
            self._graph_counts["eager"] += 1
            return self._forward(frame_u8, camera, params, folded)

    def segment_graph_info(self) -> SegmentGraphInfo:
        """:meth:`segment`'s calls by how they ran, since the pipeline was built."""
        return SegmentGraphInfo(**self._graph_counts)

    def fold_info(self) -> fold.FoldInfo:
        """The folded forward (:meth:`segment`): BatchNorm sites folded and
        left, refolds since the first fold, conv calls by form (all 0 before
        the first call that folds)."""
        if self._folded is None:
            return fold.FoldInfo(0, 0, 0, {})
        return self._folded.info()

    def _refold(self) -> None:
        """Fold the network at the first call that folds; refold in place
        later where a source tensor changed (never while a capture runs)."""
        if self._folded is None:
            self._folded = fold.FoldedNetwork(self.model)
        else:
            self._folded.refresh()

    def _folds(self, frame_u8: torch.Tensor,
               params: Optional[Mapping[str, torch.Tensor]]) -> bool:
        """Whether this call of :meth:`segment` runs the folded forward: a
        frame on the card, the network's own weights (no ``params``: the
        ``torch.export`` path), eval, and no capture already under way."""
        return (frame_u8.device.type == "cuda" and params is None and not self.model.training
                and not torch.cuda.is_current_stream_capturing())

    def _graph_key(self, frame_u8: torch.Tensor, camera: str,
                   params: Optional[Mapping[str, torch.Tensor]]) -> Optional[Tuple]:
        """The key of the CUDA graph that runs this call of :meth:`segment`,
        or None where it runs eagerly: a call that does not fold
        (:meth:`_folds`), or the kernels' plain versions set on the card (a
        test hook, under which the forward still folds, so that the plain
        versions are held to the same network)."""
        if not self._folds(frame_u8, params) or kernel_lib.plain_hooked():
            return None
        return (camera, tuple(frame_u8.shape), frame_u8.dtype, frame_u8.device,
                self.upsample_pred)

    def _capture(self, key: Tuple, frame_u8: torch.Tensor, camera: str,
                 folded: bool) -> Optional[_SegmentGraph]:
        """Capture the forward of ``key`` on a side stream (thread-local
        mode: the online nodes stage on other threads).  A capture that
        raises is counted, warned of, and its key runs eagerly from then on;
        its tallied launches never ran and are dropped."""
        frame = frame_u8.clone(memory_format=torch.contiguous_format)
        graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.Stream(frame.device)
        try:
            with span("pipeline.segment.capture"), torch.cuda.stream(stream):
                # the outer stream context restores the caller's stream even
                # where ending a failed capture raises
                with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"), \
                        kernel_lib.captured_launches() as launches, \
                        resize.held_matrices() as matrices:
                    logits = self._forward(frame, camera, None, folded)
        except RuntimeError as err:
            self._graphs[key] = _FAILED
            self._graph_counts["failed"] += 1
            warnings.warn(f"segment: capturing the forward of {key} failed, it runs "
                          f"eagerly: {err}", RuntimeWarning, stacklevel=3)
            return None
        entry = _SegmentGraph(graph, frame, logits, launches, tuple(matrices))
        self._graphs[key] = entry
        self._graph_counts["captures"] += 1
        return entry

    def _replay(self, entry: _SegmentGraph, frame_u8: torch.Tensor) -> torch.Tensor:
        with span("pipeline.segment.replay"):
            entry.frame.copy_(frame_u8)
            entry.graph.replay()
            kernel_lib.count_launches(entry.launches)
            self._graph_counts["replays"] += 1
            return entry.logits.clone()

    def _forward(self, frame_u8: torch.Tensor, camera: str,
                 params: Optional[Mapping[str, torch.Tensor]],
                 folded: bool = False) -> torch.Tensor:
        """Preprocess and the network, launched op by op; ``folded``: the
        folded forward, where the network has one."""
        x = frame_u8
        undistort_map = self._undistort_maps.get(camera)
        if undistort_map is not None:
            x = undistort(x, undistort_map)
        if self.image_scale < 1.0:
            h, w = frame_u8.shape[0], frame_u8.shape[1]
            x = resize.resize_area(x, (int(h * self.image_scale), int(w * self.image_scale)))
        xf = (x.float() / 255.0 - self._mean) / self._std
        # (H, W, 3) is already channels-last memory for the NCHW view
        xf = xf.permute(2, 0, 1)[None].to(self.compute_dtype)
        if params is not None:
            return torch.func.functional_call(self.model, params, (xf,),
                                              {"upsample_pred": self.upsample_pred})
        network = self._folded if folded else self.model
        return network(xf, upsample_pred=self.upsample_pred)

    def _pointwise_for(self, camera: str, image_hw, velodyne_frame: bool):
        key = (camera, tuple(image_hw), velodyne_frame)
        if key not in self._pointwise:
            self._pointwise[key] = self.engine._build_pointwise(
                camera, velodyne_frame, image_is_class_id=True,
                image_full_hw=tuple(image_hw),
                distorted_image=(self.distortion == "points"),
                return_pixels=self.confidence_weighting,
            )
        return self._pointwise[key]

    @torch.no_grad()
    def step(self, grid, frame_u8, pcd, valid, position, quaternion,
             camera: str = "camera1", pcd_frame_id: str = "",
             params: Optional[Mapping[str, torch.Tensor]] = None):
        """Fuse one raw frame into ``grid`` (in place); returns (grid, labels).
        ``params``: weights for this call (see :meth:`segment`)."""
        as_t = self.engine.as_tensor
        with span("pipeline.segment"):
            frame_u8 = as_t(frame_u8, torch.uint8)
            logits = self.segment(frame_u8, camera, params)
        with span("pipeline.project"):
            net_labels = torch.argmax(logits, dim=1)[0].to(torch.int32)
            # the channel image stays at decoder resolution; the engine
            # gathers with nearest-downscaled indices
            table = self.channel_table
            channel_img = table[torch.clamp(net_labels, 0, table.shape[0] - 1).long()]
            pointwise = self._pointwise_for(
                camera, frame_u8.shape[:2], pcd_frame_id == "velodyne"
            )
            pcd = as_t(pcd, torch.float32)
            out = pointwise(
                pcd, as_t(valid, torch.bool), channel_img,
                as_t(position, torch.float32), as_t(quaternion, torch.float32),
            )
            weights = None
            if self.confidence_weighting:
                cell, cls, vis, upd, gy, gx = out
                # softmax in f32: bf16 logits saturate near 1.0 and would
                # quantise the evidence weights
                conf = torch.softmax(logits.float(), dim=1).amax(dim=1)[0]
                weights = conf[gy, gx]
            else:
                cell, cls, vis, upd = out
        with span("pipeline.update"):
            grid = self._apply_update(grid, cell, cls, pcd[3], upd, weights=weights)
        return grid, net_labels

    def run_window(self, grid, frames: Mapping[str, object], camera: str = "camera1",
                   pcd_frame_id: str = ""):
        """Fuse a stacked frame window into ``grid``.

        ``frames`` holds stacked arrays: image (T, H, W, 3) u8, pcd
        (T, 4, N), valid (T, N), position (T, 3), quaternion (T, 4).  A
        Python loop over frames replaces the JAX package's ``lax.scan``; the
        grid is updated in place and never leaves the device.
        """
        with span("pipeline.window"):
            for i in range(len(frames["image"])):
                grid, _ = self.step(
                    grid, frames["image"][i], frames["pcd"][i], frames["valid"][i],
                    frames["position"][i], frames["quaternion"][i],
                    camera=camera, pcd_frame_id=pcd_frame_id,
                )
        return grid

    def compile_sequence_runner(self, camera: str = "camera1",
                                image_hw: Tuple[int, int] = (1440, 1920),
                                pcd_frame_id: str = "", window: int = 16) -> Callable:
        """``run(grid, frames) -> grid`` for windows of exactly ``window``
        frames, over this pipeline's step exported by ``torch.export`` at
        ``image_hw`` (the program ``compile`` writes, without the file;
        JAX ``compile_sequence_runner``).  The runner takes the network's
        current weights and updates the grid in place."""
        from .export import runner_from_program, trace_frame_step

        program, meta = trace_frame_step(self, image_hw, window, camera, pcd_frame_id)
        return runner_from_program(program, meta, self.model.state_dict())

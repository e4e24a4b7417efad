"""Semantic segmentation predictor: uint8 RGB frame -> label map.

Port of ``vision_semantic_segmentation_tpu/inference/predictor.py`` (ref
semantic_segmentation.py:20-57): build the model from config, load weights,
and run normalize + forward + argmax per frame on ``device``.  On the card
the forward's ASPP runs K4.  The JAX package's per-shape compile cache is a
``jit`` concern and has no counterpart: PyTorch runs eagerly.

Int8 serving (``models/quant.py``): ``MODEL.QPACK`` names a qpack (written
by either package) that loads onto the device, or :meth:`quantize`
calibrates one on frames; every forward then runs the int8 backbone (Q1 on
its 3x3 sites on the card) and the float ASPP (K4) and decoder.

Spatially sharded serving (``MODEL.SPATIAL_SHARDS`` > 1): every frame's
rows band over a ``("grid",)`` mesh of the first ``SPATIAL_SHARDS`` of
``devices`` (``parallel/spatial_infer.py``: explicit row halos, K4, K3 and
Q1 on halo-extended bands), and the labels, confidences and logits come
back whole.  A device may repeat (logical shards of one card).  The int8
path composes (Q1 and ``_int_mm`` per band).  The fused paths
(``runtime/pipeline.py``) run the unsharded network and ignore the flag,
as the JAX package's do.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.build import build_model
from ..models.convert import flax_to_state_dict, load_weights
from ..models.quant import (
    QuantBackbone,
    backbone_groups,
    load_qpack,
    quant_deeplab_forward,
    quantize_deeplab,
)
from ..ops.colormap import MAPILLARY_19_PALETTE, apply_color_map
from ..ops.resize import resize_area, resize_nearest
from ..ops.warp import undistort
from ..parallel.mesh import create_mesh, local_devices
from ..parallel.spatial_infer import Bands, SpatialModel

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class SemanticSegmentation:
    """End-to-end segmentation: uint8 RGB frame -> label map.

    Args:
        cfg: network config node (demo tree).
        state_dict: weights for the port's model; else ``variables`` (the JAX
            package's flax variables, as numpy), else ``cfg.MODEL.WEIGHT``
            (a reference ``.pth`` or the JAX package's ``.npz``).
        compute_dtype: 'bfloat16' (default) or 'float32', or a torch dtype.
        device: where the network runs; CUDA unless the caller asks for the CPU.
        devices: the mesh of ``MODEL.SPATIAL_SHARDS`` > 1 (its first
            ``SPATIAL_SHARDS`` devices; a device may repeat); default every
            local device of ``device``'s type.  Fewer than the shards raise.
    """

    def __init__(self, cfg, state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 variables=None, compute_dtype: Union[str, torch.dtype, None] = None,
                 device: DeviceLike = "cuda", devices: Optional[Sequence[DeviceLike]] = None):
        shards = int(cfg.MODEL.get("SPATIAL_SHARDS", 0))
        self.device = resolve_device(device)
        self._mesh = None
        if shards > 1:
            if devices is None:
                devices = local_devices(self.device.type)
            if len(devices) < shards:
                raise ValueError(f"MODEL.SPATIAL_SHARDS={shards} needs {shards} devices; "
                                 f"{len(devices)} given or visible")
            self._mesh = create_mesh(axis_names=("grid",), devices=list(devices)[:shards])
        if compute_dtype is None:
            compute_dtype = cfg.MODEL.get("COMPUTE_DTYPE", "bfloat16")
        self.dtype = _DTYPES[compute_dtype] if isinstance(compute_dtype, str) else compute_dtype
        self.cfg = cfg
        self.model = build_model(cfg, dtype=self.dtype, device=self.device)
        self._weight_file = None  # quantize() reads it again for f32 weights
        if state_dict is None:
            if variables is not None:
                state_dict = flax_to_state_dict(variables)
            elif cfg.MODEL.WEIGHT:
                self._weight_file = cfg.MODEL.WEIGHT
                state_dict = load_weights(self._weight_file)
            else:
                raise ValueError("cfg.MODEL.WEIGHT is empty and no weights given")
        self.model.load_state_dict(state_dict, strict=True)
        self._mean = torch.as_tensor(IMAGENET_MEAN, device=self.device)
        self._std = torch.as_tensor(IMAGENET_STD, device=self.device)
        self.qpack = None
        self._qbackbone = None
        self._spatial = None if self._mesh is None else SpatialModel(self.model, self._mesh)
        if cfg.MODEL.get("QPACK"):
            self._set_qpack(load_qpack(cfg.MODEL.QPACK, self._groups()))

    def _groups(self) -> int:
        backbone = getattr(self.model, "backbone", None)
        if backbone is None:
            raise ValueError(f"int8 serving needs a DeepLabV3+ network, not {self.cfg.MODEL.TYPE}")
        return backbone_groups(backbone)

    def _set_qpack(self, qpack) -> None:
        """Serve ``qpack`` (``models/quant.py``'s form) from now on."""
        self._qbackbone = QuantBackbone(self.model.backbone, qpack, self.dtype, self.device)
        self.qpack = qpack
        if self._spatial is not None:
            self._spatial.set_qpack(qpack, self.dtype, self._qbackbone)

    def quantize(self, calib_images) -> None:
        """Switch to the int8-backbone serving path (``models/quant.py``).

        Calibrates activation scales on ``calib_images`` (uint8 RGB frames as
        fed to :meth:`segmentation`, normalised on the host as the JAX
        package does) and quantizes the backbone from the float weights: the
        weight file the network was loaded from, read again when the network
        holds a narrower dtype than f32 (the JAX package quantizes its f32
        variables), else the network's own.
        """
        frames = []
        for img in calib_images:
            x = np.asarray(img).astype(np.float32) / 255.0
            x = (x - IMAGENET_MEAN) / IMAGENET_STD
            frames.append(x[None] if x.ndim == 3 else x)
        state_dict = None
        if self.dtype != torch.float32 and self._weight_file:
            state_dict = load_weights(self._weight_file)
        self._set_qpack(quantize_deeplab(self.model, frames, state_dict))

    def _normalize(self, x: torch.Tensor) -> torch.Tensor:
        """uint8 NHWC -> the network's NCHW input (a channels-last view)."""
        xf = (x.float() / 255.0 - self._mean.to(x.device)) / self._std.to(x.device)
        return xf.permute(0, 3, 1, 2).to(self.dtype)

    @torch.no_grad()
    def _logits(self, image, upsample_pred: bool):
        """(H, W, 3) or (N, H, W, 3) uint8 -> (N, classes, h', w') logits;
        with spatial shards, their :class:`Bands`."""
        x = torch.as_tensor(image)
        if x.ndim == 3:
            x = x[None]
        if self._spatial is not None:
            # the raw frame's rows go to their bands, normalised there
            bands = self._spatial.split(x, dim=1)
            bands = bands.like([[self._normalize(t) for t in ts] for ts in bands.parts], dim=2)
            return self._spatial(bands, upsample_pred=upsample_pred)
        x = self._normalize(x.to(self.device))
        if self._qbackbone is not None:
            return quant_deeplab_forward(self.model, self._qbackbone, x, upsample_pred)
        return self.model(x, upsample_pred=upsample_pred)

    @staticmethod
    def _squeeze(t: torch.Tensor) -> torch.Tensor:
        return t[0] if t.shape[0] == 1 else t

    def _whole(self, bands, fn) -> torch.Tensor:
        """``fn`` per band of banded logits (over the class axis), the
        result gathered on the predictor's device; ``fn`` of the tensor
        otherwise."""
        if not isinstance(bands, Bands):
            return fn(bands)
        return bands.like([[fn(t) for t in ts] for ts in bands.parts], dim=1).gather(self.device)

    def labels(self, image, upsample_pred: bool = False) -> torch.Tensor:
        """uint8 RGB frame -> int32 label map, left on the device."""
        logits = self._logits(image, upsample_pred)
        return self._squeeze(self._whole(logits, lambda t: torch.argmax(t, dim=1).to(torch.int32)))

    def segmentation(self, image, upsample_pred: bool = False) -> np.ndarray:
        """uint8 RGB (H, W, 3) -> int32 label map (ref :41-57).

        With the reference's ``upsample_pred=False`` default the label map
        is at the decoder's output resolution; callers resize it (ref
        vision_semantic_segmentation_node.py:109).
        """
        return self.labels(image, upsample_pred).cpu().numpy()

    def segmentation_with_confidence(
        self, image, upsample_pred: bool = False
    ) -> Tuple[np.ndarray, np.ndarray]:
        """uint8 RGB frame -> (label map, softmax probability of the winning class).

        The softmax runs in f32 whatever the compute dtype.
        """
        logits = self._logits(image, upsample_pred)
        labels = self._whole(logits, lambda t: torch.argmax(t, dim=1).to(torch.int32))
        conf = self._whole(logits, lambda t: torch.softmax(t.float(), dim=1).amax(dim=1))
        return self._squeeze(labels).cpu().numpy(), self._squeeze(conf).cpu().numpy()

    def logits(self, image, upsample_pred: bool = False) -> torch.Tensor:
        """Raw logits in the JAX package's layout, (N, h', w', classes)."""
        logits = self._logits(image, upsample_pred)
        if isinstance(logits, Bands):
            logits = logits.gather(self.device)
        return logits.permute(0, 2, 3, 1)


def colorize_labels(labels, palette: np.ndarray = MAPILLARY_19_PALETTE) -> torch.Tensor:
    """Label map -> RGB via the dataset palette (ref node:114,
    mapillary_visualization.py:70-89)."""
    return apply_color_map(torch.as_tensor(labels), palette)


def preprocess_frame(image, undistort_map=None, image_scale: float = 1.0,
                     device: DeviceLike = "cuda") -> torch.Tensor:
    """Node-side frame prep: undistort + INTER_AREA downscale (ref node:85-96).

    Moves the frame to ``device`` (CUDA unless the caller asks for the CPU)
    and runs there; returns the scaled uint8 image ready for segmentation.
    """
    x = torch.as_tensor(image, device=resolve_device(device))
    if undistort_map is not None:
        x = undistort(x, torch.as_tensor(undistort_map, device=x.device))
    if image_scale < 1.0:
        out_hw = (int(x.shape[0] * image_scale), int(x.shape[1] * image_scale))
        x = resize_area(x, out_hw)
    return x


def postprocess_labels(labels, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Resize the label map back to full resolution, INTER_NEAREST (ref node:109)."""
    return resize_nearest(torch.as_tensor(labels), out_hw)

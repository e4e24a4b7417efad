"""Export of the fused frame step to a serving artifact (``compile``).

Port of ``vision_semantic_segmentation_tpu/runtime/export.py``.
``torch.export.export`` traces ``FusedFramePipeline``'s one-frame step
(undistort/scale -> network forward -> argmax -> point projection ->
evidence update) at static shapes into an ``ExportedProgram``; loading it
back builds no pipeline and no network and traces nothing.  The kernels
are ``torch.library`` custom ops (``vss_torch::depthwise3x3``,
``::aspp_depthwise3x3_multi``, ``::evidence_fold_add``), so the program
holds K3/K4 and K2 as nodes and the loaded runner launches them.  K1 (the
map render) is not part of it, as the JAX runner leaves out the finalize.

The JAX contract holds:

* the model's parameters and buffers are an *input* of the program
  (``torch.func.functional_call``), so the artifact holds no weights;
  :func:`load_sequence_runner` takes them again (a ``state_dict``), checked
  against the names, shapes and types pinned at export and moved to the
  program's device and type;
* the grid is updated in place and returned (the port's form of the JAX
  runner's donation).

One frame is exported, not the window: ``torch.export`` unrolls a Python
loop, so a window of 16 would hold 16 copies of the step's graph.  The
runner loops over the window in Python and refuses any other window length
than the one pinned at export.

File format: ``VSSTTEX1``, a little-endian u32 length, a JSON metadata
block (the JAX keys ``image_hw``, ``window``, ``camera``, ``pcd_frame_id``,
``grid_shape``, ``point_bucket``, ``distortion``, ``platforms`` (the grid's
device type, e.g. ``["cuda"]``), and ``parameters``: each state-dict entry's
name, type and shape in the program's order), then ``torch.export.save``'s
bytes.  A file with any other magic raises ``ValueError``.  The program is
tied to the PyTorch version's export format and to the device type it was
traced for.
"""
from __future__ import annotations

import io
import json
import struct
from typing import Callable, Dict, Mapping, Tuple

import torch
import torch.nn as nn

from ..ops import kernels  # noqa: F401  (registers the kernels' custom ops before a load)

_MAGIC = b"VSSTTEX1"


class _FrameStep(nn.Module):
    """The pipeline's one-frame step as a module whose weights are inputs.

    The pipeline is held outside the module's registry, so the exported
    program owns none of its parameters.
    """

    def __init__(self, pipeline, camera: str, pcd_frame_id: str):
        super().__init__()
        self.__dict__["pipeline"] = pipeline
        self.camera = camera
        self.pcd_frame_id = pcd_frame_id

    def forward(self, params: Dict[str, torch.Tensor], grid, image, pcd, valid, position,
                quaternion):
        grid, _ = self.pipeline.step(grid, image, pcd, valid, position, quaternion,
                                     camera=self.camera, pcd_frame_id=self.pcd_frame_id,
                                     params=params)
        return grid


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def trace_frame_step(pipeline, image_hw: Tuple[int, int], window: int, camera: str = "camera1",
                     pcd_frame_id: str = ""):
    """``torch.export`` of the pipeline's frame step; returns (program, meta)."""
    engine = pipeline.engine
    spec = engine.grid_spec
    bucket = engine.point_bucket
    dev = pipeline.device
    params = dict(pipeline.model.state_dict())
    h, w = image_hw
    args = (
        params,
        engine.init_grid(),
        torch.zeros((h, w, 3), dtype=torch.uint8, device=dev),
        torch.zeros((4, bucket), dtype=torch.float32, device=dev),
        torch.zeros((bucket,), dtype=torch.bool, device=dev),
        torch.zeros((3,), dtype=torch.float32, device=dev),
        torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev),
    )
    # build the step's cached closures here, with real constants: built
    # while tracing, they would keep the tracer's fake tensors
    pipeline._pointwise_for(camera, (h, w), pcd_frame_id == "velodyne")
    # and the resize matrices' device cache (``ops/resize.py``), by one
    # forward: they export as the program's constants
    pipeline.segment(args[2], camera)
    with torch.no_grad():
        program = torch.export.export(_FrameStep(pipeline, camera, pcd_frame_id), args,
                                      strict=False)
    meta = {
        "image_hw": [int(h), int(w)],
        "window": int(window),
        "camera": camera,
        "pcd_frame_id": pcd_frame_id,
        "grid_shape": [spec.num_classes, spec.height, spec.width],
        "point_bucket": bucket,
        "distortion": pipeline.distortion,
        "platforms": [dev.type],
        "parameters": [[k, _dtype_name(v.dtype), list(v.shape)] for k, v in params.items()],
    }
    return program, meta


def export_sequence_runner(
    pipeline,
    path: str,
    image_hw: Tuple[int, int],
    window: int,
    camera: str = "camera1",
    pcd_frame_id: str = "",
) -> str:
    """Write the fused step for ``window``-frame dispatches to ``path``.

    Args:
        pipeline: a :class:`~.pipeline.FusedFramePipeline` (its weights'
            values are not captured: they are an input of the program).
        image_hw: camera frame size the program is specialised to.
        window: frames per dispatch, pinned in the metadata.

    Returns ``path``.
    """
    program, meta = trace_frame_step(pipeline, image_hw, window, camera, pcd_frame_id)
    program.example_inputs = None  # the traced inputs, weights among them, stay out
    blob = io.BytesIO()
    torch.export.save(program, blob)
    head = json.dumps(meta).encode()
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(head)))
        f.write(head)
        f.write(blob.getvalue())
    return path


def runner_from_program(program, meta: dict,
                        state_dict: Mapping[str, torch.Tensor]) -> Callable:
    """``run(grid, frames) -> grid`` over an exported frame step.

    ``state_dict`` must hold every parameter pinned in ``meta`` with its
    shape; each is moved to the program's device and type once here.
    ``frames`` holds stacked image (T, H, W, 3) u8, pcd (T, 4, N), valid
    (T, N), position (T, 3), quaternion (T, 4) on the program's device,
    T the pinned window; the grid is updated in place and returned.
    """
    dev = torch.device(meta["platforms"][0])
    params = {}
    for name, dtype, shape in meta["parameters"]:
        if name not in state_dict:
            raise ValueError(f"state_dict lacks {name!r}, an input of the exported program")
        t = torch.as_tensor(state_dict[name])
        if list(t.shape) != shape:
            raise ValueError(f"{name}: shape {list(t.shape)}, the program takes {shape}")
        params[name] = t.to(device=dev, dtype=getattr(torch, dtype))
    step = program.module()
    window = int(meta["window"])

    def run(grid: torch.Tensor, frames: Mapping[str, torch.Tensor]) -> torch.Tensor:
        if len(frames["image"]) != window:
            raise ValueError(f"the program was exported for windows of {window} frames, "
                             f"got {len(frames['image'])}")
        with torch.no_grad():
            for i in range(window):
                step(params, grid, frames["image"][i], frames["pcd"][i], frames["valid"][i],
                     frames["position"][i], frames["quaternion"][i])
        return grid

    return run


def load_sequence_runner(path: str, state_dict: Mapping[str, torch.Tensor]) -> Tuple[Callable, dict]:
    """Load an exported step; returns ``(run, meta)`` (see
    :func:`runner_from_program`).  No pipeline or network is built."""
    with open(path, "rb") as f:
        if f.read(len(_MAGIC)) != _MAGIC:
            raise ValueError(f"{path}: not a vsst torch export file")
        (head_len,) = struct.unpack("<I", f.read(4))
        meta = json.loads(f.read(head_len).decode())
        blob = f.read()
    program = torch.export.load(io.BytesIO(blob))
    return runner_from_program(program, meta, state_dict), meta

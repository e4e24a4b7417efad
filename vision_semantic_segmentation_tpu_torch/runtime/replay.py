"""Deterministic offline replay of recorded frames.

Port of ``vision_semantic_segmentation_tpu/runtime/replay.py::MappingReplay``
(ref mapping_replay.py:146-211): fuse recorded (pre-segmented) frames into
the grid through the mapping engine, then smooth, render, save
``global_map_<name>.png`` and score against ground truth.  The per-frame
fold runs K2 (``ops/kernels/fold.py``) and ``finalize`` renders through K1
(``ops/kernels/render.py``): the kernels on a CUDA grid, their plain
versions on a CPU grid.

Host/device pipelining: while the card fuses window i, a one-worker prefetch
thread pads and stacks window i+1 into pinned host memory and starts its
copies on a side stream (:class:`StagedWindow`); the main thread orders its
stream after those copies before the window runs.  The grid stays on the
device for the whole sequence; only the rendered map comes back.

Parallel replay (``parallel/``): ``frame_parallel=True`` fuses a
homogeneous sequence data-parallel over a mesh of the replay's devices
(``run_frames_parallel``: one partial grid a shard, one psum);
``MAPPING.GRID_SHARDS`` > 1 row-shards the grid over that many devices
(``_run_frames_grid_sharded``), and with ``frame_parallel`` both compose
over a ('data', 'grid') mesh.  The devices are every local device of the
engine's type unless the caller names them (``devices=``; a device may
repeat, as logical shards).  A sharded grid is gathered once, onto the
engine's device, before K1 renders it.
"""
from __future__ import annotations

import os.path as osp
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config.defaults import resolve_output_dir
from ..device import DeviceLike
from ..mapping.engine import SemanticMappingEngine, getattr_cfg, pad_points
from ..ops.kernels.render import render_bev_map_fused, unpack_rgba_image
from ..parallel.frame_parallel import make_frame_parallel_run, stack_frames
from ..parallel.grid_shard import (
    ShardedGrid,
    init_sharded_grid,
    make_sharded_frame_parallel_run,
    make_sharded_step,
    shard_grid,
)
from ..parallel.mesh import create_mesh, local_devices
from ..utils import image_io
from ..utils.benchmark import span
from ..utils.file_io import makedirs
from ..utils.logger import MyLogger
from .io import FrameRecord, iter_sequence_files, load_frames, load_reference_dump


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 array as an 8-bit RGB PNG (no OpenCV).

    The bytes are the array's channels reversed, which is what
    ``cv2.imwrite(path, array)`` stores: the JAX package hands its RGB array
    to cv2 unchanged (ref mapping.py:340), and ``cv2.imread`` of either file
    returns that array.
    """
    image_io.write_png(path, np.asarray(rgb, dtype=np.uint8)[..., ::-1])


class StagedWindow(dict):
    """A stacked frame window on the device: image (T, H, W, 3) u8, pcd
    (T, 4, N), valid (T, N), position (T, 3), quaternion (T, 4).

    On a card the tensors are filled by copies still in flight on a side
    stream: call :meth:`wait` on the thread that will read them first.  The
    pinned host buffers the copies read are kept until the window goes.
    """

    def __init__(self, arrays: Dict[str, torch.Tensor], ready=None, pinned=None):
        super().__init__(arrays)
        self._ready = ready
        self._pinned = pinned

    def wait(self) -> "StagedWindow":
        """Order the calling thread's current stream after the copies (the
        host does not wait), and mark the tensors as used on that stream so
        that the allocator keeps them until its work is done."""
        if self._ready is not None:
            stream = torch.cuda.current_stream(next(iter(self.values())).device)
            stream.wait_event(self._ready)
            for t in self.values():
                t.record_stream(stream)
            self._ready = None
        return self


class MappingReplay:
    """Replays recorded sequences through the mapping engine."""

    def __init__(self, cfg, logger: Optional[MyLogger] = None,
                 engine: Optional[SemanticMappingEngine] = None, frame_parallel: bool = False,
                 device: DeviceLike = "cuda", devices: Optional[Sequence[DeviceLike]] = None):
        """``frame_parallel=True`` fuses homogeneous sequences data-parallel
        over ``devices`` (see :meth:`run_frames_parallel`); heterogeneous
        sequences fall back to the sequential window path.
        ``MAPPING.GRID_SHARDS`` > 1 row-shards the grid over the first that
        many of ``devices``.  ``devices`` defaults to every local device of
        the engine's type."""
        self.frame_parallel = bool(frame_parallel)
        self.grid_shards = int(getattr_cfg(cfg, "MAPPING.GRID_SHARDS", 1))
        self.cfg = cfg
        # the engine first: without a card it raises before any run
        # directory is made
        self.engine = engine or SemanticMappingEngine(cfg, device=device)
        self.devices = (list(devices) if devices is not None
                        else local_devices(self.engine.device.type))
        output_dir = resolve_output_dir(cfg.OUTPUT_DIR, cfg.TASK_NAME)
        if logger is None:
            logger = MyLogger("mapping_replay", save_dir=output_dir, use_timestamp=False)
        self.logger = logger
        self.output_dir = logger.save_dir or output_dir
        self.input_dir = cfg.MAPPING.INPUT_DIR
        self.label_colors = np.array(cfg.LABEL_COLORS, dtype=np.uint8)
        dev = self.engine.device
        self._copy_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    # -- core loop -----------------------------------------------------------
    @staticmethod
    def _chunk_frames(frames, window: int):
        """Split a frame sequence OR iterator into homogeneous stretches of
        <= window frames (same camera / cloud frame / image shape).  Works
        lazily, so a streaming source (``stream_bag_frames``) is chunked as
        it decodes."""

        def frame_key(f):
            return (f.camera, f.pcd_frame_id, np.asarray(f.semantic_image).shape)

        chunk: list = []
        for f in frames:
            if chunk and (len(chunk) >= window or frame_key(f) != frame_key(chunk[0])):
                yield chunk
                chunk = []
            chunk.append(f)
        if chunk:
            yield chunk

    def _stage(self, chunk, min_len: int = 2) -> Optional[StagedWindow]:
        """Host-side staging of one chunk: pad, stack, start device copies.

        Runs on the prefetch thread, so stacking and copying the next window
        overlaps the card fusing the current one.  Chunks shorter than
        ``min_len`` return None (``run_frames`` steps single frames through
        ``engine.step``; the fused CLI path stages every chunk with
        ``min_len=1``).
        """
        if len(chunk) < min_len:
            return None
        # the span closes after the helper's frame is gone: freeing the
        # stacked host arrays (84 MB a window of 1440x1920 frames) is
        # staging time too
        with span("replay.stage"):
            return self._stage_window(chunk)

    def _stage_window(self, chunk) -> StagedWindow:
        """Pad and stack ``chunk``, pin it and start its copies (:meth:`_stage`)."""
        with span("replay.stage.stack"):
            bucket = self.engine.point_bucket
            padded = [pad_points(np.asarray(f.pcd, dtype=np.float32), bucket) for f in chunk]
            host = {
                "image": torch.from_numpy(np.stack([np.asarray(f.semantic_image) for f in chunk])),
                "pcd": torch.from_numpy(np.stack([p for p, _ in padded])),
                "valid": torch.from_numpy(np.stack([v for _, v in padded])),
                "position": torch.from_numpy(
                    np.stack([np.asarray(f.position, np.float32) for f in chunk])),
                "quaternion": torch.from_numpy(
                    np.stack([np.asarray(f.quaternion, np.float32) for f in chunk])),
            }
        # a CPU engine reads the stacked arrays as they are: nothing to pin
        with span("replay.stage.pin"):
            pinned = (host if self._copy_stream is None
                      else {k: t.pin_memory() for k, t in host.items()})
        with span("replay.stage.copy"):
            if self._copy_stream is None:
                return StagedWindow({k: t.to(self.engine.device) for k, t in pinned.items()})
            with torch.cuda.stream(self._copy_stream):
                arrays = {k: t.to(self.engine.device, non_blocking=True) for k, t in pinned.items()}
                ready = torch.cuda.Event()
                ready.record(self._copy_stream)
        return StagedWindow(arrays, ready=ready, pinned=pinned)

    def run_frames(self, frames: Sequence[FrameRecord], window: int = 8, prefetch: bool = True,
                   init_grid=None, _copy_init: bool = True) -> torch.Tensor:
        """Fuse a frame sequence into a fresh grid; returns the device grid.

        Homogeneous stretches (same camera / image shape / cloud frame) are
        fused ``window`` frames per call of the engine's sequence runner;
        a single frame goes through ``engine.step``.  With ``prefetch`` the
        next window is staged on a worker thread while the current one
        fuses.  ``init_grid`` resumes from a checkpointed grid
        (``engine.load_grid``) instead of a fresh one; evidence is additive,
        so split replays compose exactly.  The grid is updated in place, so
        ``init_grid`` is copied first unless the caller owns it
        (``_copy_init=False``).  With ``MAPPING.GRID_SHARDS`` > 1 the grid
        is row-sharded and the result a :class:`ShardedGrid`.
        """
        if self.grid_shards > 1:
            return self._run_frames_grid_sharded(frames, init_grid=init_grid,
                                                 _copy_init=_copy_init)
        engine = self.engine
        if init_grid is None:
            grid = engine.init_grid()
        else:
            grid = self._full_grid(init_grid)
            if _copy_init:
                grid = grid.clone()
        bucket = engine.point_bucket
        chunks = list(self._chunk_frames(frames, window))

        def dispatch(grid, chunk, staged):
            if len(chunk) > 1:
                runner = engine.build_sequence_runner(
                    camera=chunk[0].camera, pcd_frame_id=chunk[0].pcd_frame_id)
                return runner(grid, staged.wait())
            f = chunk[0]
            pcd, valid = pad_points(np.asarray(f.pcd, dtype=np.float32), bucket)
            grid, _, _ = engine.step(grid, pcd, valid, f.semantic_image, f.position,
                                     f.quaternion, camera=f.camera, pcd_frame_id=f.pcd_frame_id)
            return grid

        if not prefetch or len(chunks) <= 1:
            for chunk in chunks:
                grid = dispatch(grid, chunk, self._stage(chunk))
            return grid

        with ThreadPoolExecutor(max_workers=1) as pool:
            pending = pool.submit(self._stage, chunks[0])
            for i, chunk in enumerate(chunks):
                staged = pending.result()
                if i + 1 < len(chunks):
                    pending = pool.submit(self._stage, chunks[i + 1])
                grid = dispatch(grid, chunk, staged)
        return grid

    def _full_grid(self, grid) -> torch.Tensor:
        """A grid as one tensor on the engine's device (a sharded grid is
        gathered; a tensor already there is not copied)."""
        if isinstance(grid, ShardedGrid):
            return grid.gather(self.engine.device)
        return torch.as_tensor(grid, device=self.engine.device)

    def _run_frames_grid_sharded(self, frames: Sequence[FrameRecord], init_grid=None,
                                 _copy_init: bool = True) -> ShardedGrid:
        """Sequential replay with the grid row-sharded over ('grid',).

        ``MAPPING.GRID_SHARDS`` devices each keep one row band
        (``parallel/grid_shard.py``); frames step one at a time, each band
        taking the points it owns: for grids larger than one device's
        memory.  Matches the unsharded replay.
        """
        if self.grid_shards > len(self.devices):
            raise ValueError(f"MAPPING.GRID_SHARDS={self.grid_shards} but only "
                             f"{len(self.devices)} devices are visible")
        mesh = create_mesh(axis_names=("grid",), devices=self.devices[:self.grid_shards])
        engine = self.engine
        if init_grid is None:
            grid = init_sharded_grid(engine, mesh)
        elif (isinstance(init_grid, ShardedGrid) and not _copy_init
              and init_grid.devices == mesh.along("grid")):
            grid = init_grid  # the caller's bands, laid out as a fresh grid's
        else:
            # resume: lay the checkpointed grid out as a fresh one is laid out
            grid = shard_grid(init_grid.gather() if isinstance(init_grid, ShardedGrid)
                              else init_grid, mesh)
        steps = {}
        for f in frames:
            key = (f.camera, f.pcd_frame_id == "velodyne")
            if key not in steps:
                steps[key] = make_sharded_step(engine, mesh, camera=f.camera,
                                               pcd_in_velodyne_frame=key[1])
            pcd, valid = pad_points(np.asarray(f.pcd, dtype=np.float32), engine.point_bucket)
            grid = steps[key](grid, pcd, valid, f.semantic_image, f.position, f.quaternion)
        return grid

    def run_frames_parallel(self, frames: Sequence[FrameRecord], mesh=None, axis: str = "data",
                            init_grid=None):
        """Fuse a homogeneous frame sequence data-parallel over a mesh.

        Frames shard over the mesh's ``axis``; each shard folds its frames
        into a partial grid and one psum adds them (exact up to f32
        re-association, ``parallel/frame_parallel.py``).  The default mesh
        is the replay's devices; with ``MAPPING.GRID_SHARDS`` > 1 (and no
        ``mesh``) frames shard over ``axis`` and grid rows over 'grid' of a
        2-D mesh of them, and the result is a :class:`ShardedGrid`.  All
        frames must share one camera and cloud frame.  A resumed
        ``init_grid`` is added once, outside the psum.
        """
        if not frames:
            raise ValueError("no frames to replay")
        cameras = {f.camera for f in frames}
        cloud_frames = {f.pcd_frame_id for f in frames}
        if len(cameras) != 1 or len(cloud_frames) != 1:
            raise ValueError("frame-parallel replay needs a homogeneous sequence; got "
                             f"cameras={cameras}, cloud frames={cloud_frames}")
        engine = self.engine
        velodyne = frames[0].pcd_frame_id == "velodyne"
        if mesh is None and self.grid_shards > 1:
            # sp x fp composed: frames over 'data', grid rows over 'grid'
            n_dev = len(self.devices)
            if n_dev % self.grid_shards:
                raise ValueError(f"{n_dev} devices do not split into "
                                 f"GRID_SHARDS={self.grid_shards}")
            mesh2d = create_mesh(axis_sizes=(n_dev // self.grid_shards, self.grid_shards),
                                 axis_names=(axis, "grid"), devices=self.devices)
            run = make_sharded_frame_parallel_run(engine, mesh2d, data_axis=axis,
                                                  camera=frames[0].camera,
                                                  pcd_in_velodyne_frame=velodyne)
            stacked = stack_frames(engine, frames, mesh2d, axis=axis)
            out = run(init_sharded_grid(engine, mesh2d), *stacked)
            # evidence is additive: resuming is adding the checkpointed grid
            # once OUTSIDE the psum (inside it would count once a shard)
            return out if init_grid is None else out.add_(init_grid)
        if mesh is None:
            mesh = create_mesh(axis_names=(axis,), devices=self.devices)
        run = make_frame_parallel_run(engine, mesh, axis=axis, camera=frames[0].camera,
                                      pcd_in_velodyne_frame=velodyne)
        out = run(engine.init_grid(), *stack_frames(engine, frames, mesh, axis=axis))
        if init_grid is not None:
            out += self._full_grid(init_grid)
        return out

    def finalize(self, grid, name: str = "") -> np.ndarray:
        """Smooth + render (K1) + save + evaluate (ref mapping_replay.py:194-211).
        A :class:`ShardedGrid` is gathered once, onto the engine's device."""
        packed = render_bev_map_fused(self._full_grid(grid), self.label_colors)
        color_map = unpack_rgba_image(packed).cpu().numpy()

        makedirs(self.output_dir, exist_ok=True)
        suffix = f"_{name}" if name else ""
        output_file = osp.join(self.output_dir, f"global_map{suffix}.png")
        write_png(output_file, color_map)
        self.logger.log(f"Saved map to {output_file}")

        if self.cfg.GROUND_TRUTH_DIR:
            from ..evaluation.map_eval import MapEvaluator

            MapEvaluator(ground_truth_dir=self.cfg.GROUND_TRUTH_DIR,
                         logger=self.logger).test_single_map(color_map)
        return color_map

    # -- entry points (ref :146-172) -----------------------------------------
    def replay_file(self, path: str, init_grid=None, return_grid: bool = False,
                    _copy_init: bool = True):
        """Replay one ``.npz``, ``.hkl`` or ``.pkl`` sequence; its map, or
        its grid with ``return_grid``."""
        name = osp.splitext(osp.basename(path))[0]
        self.logger.log(f"Loading input file {path}")
        frames = load_frames(path) if path.endswith(".npz") else load_reference_dump(path)
        # stack_frames stacks the images too, so frame-parallel needs one
        # image shape as well as one (camera, cloud frame); anything else
        # takes the sequential path (whose _chunk_frames splits on shape)
        homogeneous = len({(f.camera, f.pcd_frame_id, np.asarray(f.semantic_image).shape)
                           for f in frames}) == 1
        if self.frame_parallel and homogeneous:
            grid = self.run_frames_parallel(frames, init_grid=init_grid)
        else:
            grid = self.run_frames(frames, init_grid=init_grid, _copy_init=_copy_init)
        if return_grid:
            return grid
        return self.finalize(grid, name)

    def replay_dir(self, input_dir: Optional[str] = None, resume_grid: Optional[str] = None,
                   save_grid: Optional[str] = None) -> List[np.ndarray]:
        """Replay every sequence file in ``input_dir``.

        Default: one fresh grid and one rendered map PER FILE (the
        reference's per-recording behaviour).  With ``resume_grid`` and/or
        ``save_grid``, ONE grid threads through all files in order, seeded
        from the ``resume_grid`` checkpoint and saved to ``save_grid`` after
        the last file, and a single combined map renders.
        """
        input_dir = input_dir or self.input_dir
        continuous = resume_grid is not None or save_grid is not None
        maps = []
        if continuous:
            grid = self.engine.load_grid(resume_grid) if resume_grid else None
            seen = False
            for path in iter_sequence_files(input_dir):
                seen = True
                # this loop owns every grid it threads: no protective copy
                grid = self.replay_file(path, init_grid=grid, return_grid=True,
                                        _copy_init=False)
            if seen:
                if save_grid:
                    written = self.engine.save_grid(save_grid, grid)
                    self.logger.log(f"Saved grid checkpoint to {written}")
                maps.append(self.finalize(grid, "combined"))
        else:
            for path in iter_sequence_files(input_dir):
                maps.append(self.replay_file(path))
        if not maps:
            # a typo'd MAPPING.INPUT_DIR should not be a silent success
            print(f"replay: no sequence files (.npz/.pkl/.hkl) found in {input_dir!r}",
                  file=sys.stderr)
        return maps


def main(argv=None, device: DeviceLike = "cuda"):  # ref mapping_replay.py:321-329
    import argparse

    from ..config import get_cfg_defaults

    parser = argparse.ArgumentParser(description="Offline mapping replay")
    parser.add_argument("--cfg", dest="config_file", default="", metavar="FILE")
    args, _ = parser.parse_known_args(argv)

    cfg = get_cfg_defaults()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    return MappingReplay(cfg, device=device).replay_dir()


if __name__ == "__main__":
    main()

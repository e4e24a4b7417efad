"""Closed-loop replay of raw camera frames through the fused frame step.

The loop of ``pipeline --fused`` without bag decoding and PNG output: each
window of ``window`` frames (raw uint8 frame, cloud, pose), held in host
memory as a decoded log holds them, is staged by
``MappingReplay._stage(chunk, min_len=1).wait()`` and fused into the grid
by ``FusedFramePipeline.run_window``.  The next window is staged as soon as
the host has queued the previous one; the window ends with a synchronise.

End to end: ``frames_per_s``, every frame fused over the whole window.
Checked: the logits of frames of the last window (drawn from the seed)
against the reference network, and the grid after the window against the
reference map update fed the program's labels of every frame.
"""
from __future__ import annotations

import random
import time

import numpy as np
import torch

from ..core.checks import network_readings
from ..core.portcfg import serving_cfg
from ..core.traffic import frame_pool, sub_seed
from ..core.weights import center_classifier, make_state_dict
from ..reference.deeplab import normalize
from ..reference.mapping import MapReference, grid_error

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def launches():
    from vision_semantic_segmentation_tpu_torch.ops import kernels as K

    return {k.name: k.launches for k in K.kernels()}


class Driver:
    def __init__(self, run):
        self.run = run
        self.cfg = None

    # -- set-up ---------------------------------------------------------------
    def setup(self) -> None:
        from vision_semantic_segmentation_tpu_torch.runtime.io import FrameRecord

        run, conf = self.run, self.run.config
        p = run.traffic["frames"]
        self.window_len = int(run.traffic["window"])
        self.cfg = serving_cfg(conf)
        hw = (conf["input"]["height"], conf["input"]["width"])
        self.camera = conf["input"]["camera"]
        self.distorted = conf["input"]["distortion"] == "points"
        if run.device == "cuda":
            from vision_semantic_segmentation_tpu_torch.ops import kernels as K

            K.build_all()
        self.pool = frame_pool(run.seed, conf["map"], hw, p, run.device)
        self.records = [FrameRecord(pcd=self.pool["pcd"][i], pcd_frame_id="",
                                    semantic_image=self.pool["image"][i],
                                    position=self.pool["position"][i],
                                    quaternion=self.pool["quaternion"][i], camera=self.camera)
                        for i in range(len(self.pool["pcd"]))]
        self.build_program()
        self.grid = self.replay.engine.init_grid()
        # warm up: two windows on a grid of their own
        scratch = self.replay.engine.init_grid()
        for w in range(2):
            self.fuse(scratch, self.chunk(w))
        del scratch
        self.sync()

    def build_program(self) -> None:
        from vision_semantic_segmentation_tpu_torch.runtime.pipeline import FusedFramePipeline
        from vision_semantic_segmentation_tpu_torch.runtime.replay import MappingReplay
        from vision_semantic_segmentation_tpu_torch.utils.logger import MyLogger

        run, conf = self.run, self.run.config
        dtype = DTYPES[conf["network"]["compute_dtype"]]
        first = torch.as_tensor(self.pool["image"][0], device=run.device)[None]
        self.state_dict = center_classifier(
            run.reference, conf["network"],
            make_state_dict(run.reference, conf["network"], sub_seed(run.seed, 0), run.device,
                            dtype, conf["weights"]["residual_bn_weight"]),
            normalize(first, conf["input"]["image_scale"]))
        self.pipeline = FusedFramePipeline(self.cfg, state_dict=self.state_dict,
                                           compute_dtype=dtype,
                                           distortion=conf["input"]["distortion"],
                                           device=run.device)
        self.replay = MappingReplay(self.cfg, logger=MyLogger("benchmark"),
                                    engine=self.pipeline.engine, device=run.device)
        # what the check reads: every frame's labels, the last window's logits
        # (references the step returns anyway; no work is added)
        self.labels, self.logits, self.recording = [], [], False
        step, segment = self.pipeline.step, self.pipeline.segment

        def recorded_segment(*a, **k):
            out = segment(*a, **k)
            if self.recording:
                self.logits.append(out)
            return out

        def recorded_step(*a, **k):
            grid, labels = step(*a, **k)
            if self.recording:
                self.labels.append(labels)
            return grid, labels

        self.pipeline.segment = recorded_segment
        self.pipeline.step = recorded_step

    def sync(self) -> None:
        if self.run.device == "cuda":
            torch.cuda.synchronize()

    def chunk(self, w: int):
        n = len(self.records)
        return [self.records[(w * self.window_len + i) % n] for i in range(self.window_len)]

    def fuse(self, grid, chunk):
        spans = self.run.spans
        with spans.span("stage"):
            staged = self.replay._stage(chunk, min_len=1).wait()
        with spans.span("run_window"):
            return self.pipeline.run_window(grid, staged, camera=self.camera)

    # -- the window -----------------------------------------------------------
    def window(self) -> dict:
        run = self.run
        self.sync()
        self.recording = True
        self.sent = []
        t0 = time.perf_counter()
        deadline = t0 + run.seconds
        w = 0
        while True:
            if w and time.perf_counter() >= deadline:
                break
            run.trace_tick(w, launches())
            chunk = self.chunk(w)
            if len(self.logits) > 0:
                self.logits.clear()  # keep the last window's only
            self.sent.extend((w * self.window_len + i) % len(self.records)
                             for i in range(self.window_len))
            self.grid = self.fuse(self.grid, chunk)
            w += 1
        self.sync()
        elapsed = time.perf_counter() - t0
        run.finish_trace(launches())
        self.recording = False
        frames = len(self.sent)
        return {"end_to_end": {"frames_per_s": frames / elapsed},
                "attempted": frames, "failed": max(0, frames - len(self.labels)),
                "seconds": elapsed, "frames": frames, "windows": w,
                "unit_work": self.window_len,
                "notes": [f"window: {frames} frames in {w} windows, {elapsed:.3f} s"]}

    def release(self) -> None:
        self.sync()
        del self.pipeline, self.replay
        if self.run.device == "cuda":
            torch.cuda.empty_cache()

    # -- the check ------------------------------------------------------------
    def check(self):
        run, conf = self.run, self.run.config
        control = run.control
        rng = random.Random(sub_seed(run.seed, 3))
        last = self.sent[-len(self.logits):] if self.logits else []
        picks = sorted(rng.sample(range(len(last)), min(int(run.traffic["check_frames"]),
                                                        len(last))))
        frames = [self.pool["image"][last[i]] for i in picks]
        err, gap = network_readings(run.reference, conf["network"], self.state_dict, frames,
                                    [self.logits[i] for i in picks], run.device, control,
                                    conf["input"]["image_scale"])
        grid_err = self.grid_reading(control)
        return [("logit_err", err, conf["limits"]["logit_err"]),
                ("label_gap", gap, conf["limits"]["label_gap"]),
                ("grid_err", grid_err, conf["limits"]["grid_err"])]

    def grid_reading(self, control: bool) -> float:
        """The grid's reading: the program's grid against the reference's
        (under ``control``, the reference's bfloat16 grid in its place)."""
        run, conf = self.run, self.run.config
        grids = []
        for dtype in ((torch.bfloat16, torch.float64) if control else (torch.float64,)):
            ref = MapReference(conf["map"], run.device, dtype=dtype)
            for k, idx in enumerate(self.sent[:len(self.labels)]):
                pcd = self.pool["pcd"][idx]
                ref.update(pcd, np.ones(pcd.shape[1], bool), self.pool["position"][idx],
                           self.pool["quaternion"][idx], ref.channels_of_classes(self.labels[k]),
                           camera=self.camera, distorted=self.distorted,
                           full_hw=(conf["input"]["height"], conf["input"]["width"]))
            grids.append(ref.as_planar())
        program = grids[0] if control else self.grid
        print(f"grid: {len(self.sent)} frames, {len(self.labels)} answered; evidence "
              f"{float(program.sum()):.1f} against the reference's {float(grids[-1].sum()):.1f}",
              flush=True)
        return grid_error(program, grids[-1])

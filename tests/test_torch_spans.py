"""The port's spans (``utils/benchmark.py::span``) and the benchmark's
readers of them.

With no profiler running a span is one shared no-op and never enters
``record_function``.  Under ``torch.profiler`` on the CPU, staging and
fusing a window (``MappingReplay._stage``, ``FusedFramePipeline.
run_window``) and a two-step ``Trainer.train_one_epoch`` emit their spans
as ``user_annotation`` events, nested and in order.  The six readers under
``benchmark/metrics/`` that take idle card time and host time from the
spans are held to hand-made traces, and read nothing where the program has
no spans; so is the share of frames whose forward replayed a CUDA graph,
which reads 0 where frames ran and none replayed.
"""
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vision_semantic_segmentation_tpu_torch.config import get_cfg_defaults, get_train_cfg_defaults
from vision_semantic_segmentation_tpu_torch.mapping import PCD_ORIGIN_OFFSET
from vision_semantic_segmentation_tpu_torch.runtime import FusedFramePipeline, MappingReplay
from vision_semantic_segmentation_tpu_torch.runtime.io import FrameRecord
from vision_semantic_segmentation_tpu_torch.train.trainer import Trainer
from vision_semantic_segmentation_tpu_torch.utils import benchmark

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmark.run import load_file_module  # noqa: E402

LAYERS = ("replay.", "pipeline.", "train.")


def _spans(prof, tmp_path):
    """The trace's program spans as (start, end, name), in the order they
    opened (PyTorch's own ranges, such as ``Optimizer.step#SGD.step``, left
    out)."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
             if e.get("cat") == "user_annotation" and e["name"].startswith(LAYERS)]
    return sorted(spans, key=lambda s: (s[0], -s[1]))


def _inside(child, parents):
    return any(a <= child[0] and child[1] <= b for a, b, _ in parents)


# -- (a) no profiler -------------------------------------------------------------------
def test_span_without_profiler_is_one_shared_no_op(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    first = benchmark.span("replay.stage")
    assert benchmark.span("train.step") is first
    for _ in range(3):
        with benchmark.span("pipeline.window") as entered:
            assert entered is None
    assert benchmark.span("x") is first


# -- (b) the spans the program emits ---------------------------------------------------
def _replay_cfg(out_dir):
    cfg = get_cfg_defaults()
    cfg.MAPPING.BOUNDARY = [[100, 120], [800, 820]]
    cfg.MAPPING.POINT_BUCKET = 512
    cfg.OUTPUT_DIR = str(out_dir)
    cfg.VISION_SEM_SEG.IMAGE_SCALE = 1.0 / 16
    net = cfg.VISION_SEM_SEG.SEM_SEG_NETWORK
    net.MODEL.BACKBONE = "resnet18"
    net.MODEL.ASPP.OUT_CHANNELS = 16
    net.MODEL.ASPP.ATROUS_CHANNELS = [16, 16, 16, 16]
    net.MODEL.DECODER.REFINE_CHANNELS = [16, 16]
    return cfg


def _records(rng, n):
    x0, y0 = 100 - PCD_ORIGIN_OFFSET[0], 800 - PCD_ORIGIN_OFFSET[1]
    out = []
    for _ in range(n):
        xy = rng.uniform([[x0], [y0]], [[x0 + 20], [y0 + 20]], (2, 400))
        zi = rng.uniform([[-1.0], [0.0]], [[0.5], [20.0]], (2, 400))
        image = rng.integers(0, 256, (90, 120, 3), dtype=np.uint8).repeat(16, 0).repeat(16, 1)
        out.append(FrameRecord(pcd=np.concatenate([xy, zi]).astype(np.float32),
                               pcd_frame_id="", semantic_image=image,
                               position=np.float32([x0 - 6.0, y0 + 10.0, 0.0]),
                               quaternion=np.float32([0, 0, 0, 1]), camera="camera1"))
    return out


def test_replay_spans_nest_as_staged_and_fused(tmp_path):
    cfg = _replay_cfg(tmp_path)
    pipe = FusedFramePipeline(cfg, compute_dtype=torch.float32, distortion="points",
                              device="cpu", generator=torch.Generator().manual_seed(0))
    replay = MappingReplay(cfg, engine=pipe.engine, device="cpu")
    chunk = _records(np.random.default_rng(5), 2)
    grid = pipe.init_grid()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        staged = replay._stage(chunk, min_len=1).wait()
        pipe.run_window(grid, staged)
    spans = _spans(prof, tmp_path)
    names = [n for _, _, n in spans]
    assert names == ["replay.stage", "replay.stage.stack", "replay.stage.pin",
                     "replay.stage.copy", "pipeline.window"] + [
        "pipeline.segment", "pipeline.project", "pipeline.update"] * 2
    by = lambda name: [s for s in spans if s[2] == name]  # noqa: E731
    for child in ("replay.stage.stack", "replay.stage.pin", "replay.stage.copy"):
        assert all(_inside(c, by("replay.stage")) for c in by(child))
    for child in ("pipeline.segment", "pipeline.project", "pipeline.update"):
        assert all(_inside(c, by("pipeline.window")) for c in by(child))
    assert not _inside(by("pipeline.window")[0], by("replay.stage"))


def test_trainer_spans_follow_the_loop(tmp_path):
    cfg = get_train_cfg_defaults()
    cfg.merge_from_list(["MODEL.TYPE", "Dummy", "DATASET.NUM_CLASSES", "5",
                         "OPTIMIZER.TYPE", "SGD", "OPTIMIZER.BASE_LR", "0.05", "RNG_SEED", "3",
                         "TRAIN.BATCH_SIZE", "2", "OUTPUT_DIR", str(tmp_path)])
    trainer = Trainer(cfg, output_dir=str(tmp_path), device="cpu")
    rng = np.random.default_rng(2)
    batches = [{"image": rng.standard_normal((2, 16, 16, 3)).astype(np.float32),
                "label": rng.integers(0, 5, (2, 16, 16))} for _ in range(2)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train_one_epoch(batches, 0)
    spans = _spans(prof, tmp_path)
    step = ["train.step", "train.forward", "train.backward", "train.update"]
    assert [n for _, _, n in spans] == (["train.fetch"] + step + ["train.fetch"] + step
                                        + ["train.drain", "train.fetch", "train.drain"])
    by = lambda name: [s for s in spans if s[2] == name]  # noqa: E731
    for child in step[1:]:
        assert all(_inside(c, by("train.step")) for c in by(child))
    assert len(trainer.history) == 2


# -- (c) the readers -------------------------------------------------------------------
def _run(kernels, host, window_s=0.1):
    """A traced run as the readers see it: kernel intervals (us) and host events."""
    dtrace = SimpleNamespace(window_s=window_s, units=2,
                             kernels=[("k", float(a), float(b - a)) for a, b in kernels],
                             host=[(n, float(a), float(b - a), 1) for n, a, b in host])
    return SimpleNamespace(dtrace=dtrace)


# replay: card busy over [10, 30] and [40, 90] ms; an aten op runs to 95 ms
REPLAY = _run([(10_000, 30_000), (40_000, 90_000)], [
    ("stage", 0, 12_000),  # the benchmark's own span: not the program's
    ("replay.stage", 0, 12_000), ("replay.stage.pin", 2_000, 5_000),
    ("pipeline.window", 12_000, 31_000),
    ("replay.stage", 32_000, 45_000), ("replay.stage.pin", 33_000, 38_000),
    ("aten::add", 88_000, 95_000)])
# training: busy over [5, 20], [22, 60] and [70, 80] ms; a fetch overlaps a
# drain, and the last fetch stays open past the traced part's 100 ms
TRAIN = _run([(5_000, 20_000), (22_000, 60_000), (70_000, 80_000)], [
    ("train.fetch", 0, 6_000), ("train.step", 6_000, 50_000), ("train.update", 18_000, 23_000),
    ("train.drain", 55_000, 65_000), ("train.fetch", 64_000, 67_000),
    ("train.drain", 66_000, 68_000), ("train.fetch", 79_000, 150_000)])
# a graphed replay: four frames' segment spans, three replayed from the graph
GRAPHED = _run([(10_000, 30_000)], [
    ("pipeline.window", 0, 40_000),
    ("pipeline.segment", 1_000, 5_000), ("pipeline.segment.capture", 1_500, 4_000),
    ("pipeline.segment.replay", 4_000, 4_900),
    ("pipeline.segment", 9_000, 10_000), ("pipeline.segment.replay", 9_100, 9_900),
    ("pipeline.segment", 19_000, 20_000), ("pipeline.segment.replay", 19_100, 19_900),
    ("pipeline.segment", 29_000, 30_000), ("aten::copy_", 29_100, 29_900)])
EXPECTED = {
    "graph_replay_pct.fps": (GRAPHED, 75.0),
    "idle_stage_pct.fps": (REPLAY, 18.0),  # the head [0, 10] and the gap's [32, 40]
    "idle_frame_pct.fps": (REPLAY, 1.0),  # the gap's [30, 31]
    "stage_pin_ms.fps": (REPLAY, 4.0),  # (3 + 5) / 2
    "idle_update_pct.train": (TRAIN, 2.0),  # the gap [20, 22]
    # the head [0, 5], [60, 68] counted once, and [80, 100]
    "idle_loop_pct.train": (TRAIN, 33.0),
    "drain_ms.train": (TRAIN, 6.0),  # (10 + 2) / 2
}


def _reader(name):
    return load_file_module(f"benchmark.metrics.{name.replace('.', '_')}",
                            REPO / "benchmark" / "metrics" / f"{name}.py")


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_the_program_spans(name):
    run, want = EXPECTED[name]
    assert _reader(name).read(run) == pytest.approx(want, abs=1e-9)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_without_program_spans_reads_nothing(name):
    run, _ = EXPECTED[name]
    reader = _reader(name)
    only_ops = _run([(a, a + d) for _, a, d in run.dtrace.kernels],
                    [(n, a, a + d) for n, a, d, _ in run.dtrace.host
                     if not n.startswith(LAYERS)])
    assert reader.read(only_ops) is None
    assert reader.read(SimpleNamespace(dtrace=None)) is None


def test_graph_reader_reads_zero_where_no_forward_replays():
    """A program that launches the forward op by op has the
    ``pipeline.segment`` spans and no replay: it reads 0 %."""
    eager = _run([(a, a + d) for _, a, d in GRAPHED.dtrace.kernels],
                 [(n, a, a + d) for n, a, d, _ in GRAPHED.dtrace.host
                  if not n.startswith("pipeline.segment.")])
    assert _reader("graph_replay_pct.fps").read(eager) == 0.0

"""Port parity: the slice as a whole, frame window -> grid -> finalized map -> scores.

The same weights (flax variables converted with ``flax_to_state_dict``) and
the same raw 1440x1920 frames go through the JAX package's
``FusedFramePipeline`` sequence runner + ``MappingReplay.finalize`` and the
port's ``FusedFramePipeline.run_window`` + ``MappingReplay.finalize`` on the
CPU, in f32, with a small DeepLabV3+ (ResNet-18, OS8, narrow ASPP/decoder)
on a 1/16-scale input and a 200x200 grid.  On the CPU the port's three
kernel wrappers run their plain versions.

Tolerances: grid atol 1e-4 (the evidence is summed in another order), with
the same set of nonzero cells; rendered maps equal on >= 99.9 % of cells
(the JAX unfused render sums nine shifted planes, K1 sums separably, so a
near-tie argmax may flip); the evaluator's scores equal.

The resize matrices: a warmed ``run_window`` finds all of them in the
device cache (``ops/resize.py``), four lookups a frame at the serving
configuration's resizes, and fuses the same bits as a copy of each matrix
made at every call; the banded resize's rows of the cached matrix give the
full resize's rows bit for bit.

The forward's CUDA graph, on the CPU with the CUDA calls stood in for: which
calls run eagerly, the key's eager call, capture and replays, a failed
capture, and the kernels' launches, which a capture tallies apart (other
threads count as ever) and each replay adds.
"""
import contextlib
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_semantic_segmentation_tpu.config import get_cfg_defaults as j_cfg_defaults
from vision_semantic_segmentation_tpu.evaluation.map_eval import MapEvaluator as JaxEvaluator
from vision_semantic_segmentation_tpu.mapping import PCD_ORIGIN_OFFSET
from vision_semantic_segmentation_tpu.models.build import build_model as j_build_model
from vision_semantic_segmentation_tpu.runtime.pipeline import FusedFramePipeline as JaxPipeline
from vision_semantic_segmentation_tpu.runtime.replay import MappingReplay as JaxReplay
from vision_semantic_segmentation_tpu_torch.config import get_cfg_defaults
from vision_semantic_segmentation_tpu_torch.evaluation.map_eval import MapEvaluator
from vision_semantic_segmentation_tpu_torch.models import flax_to_state_dict
from vision_semantic_segmentation_tpu_torch.models.resize import resize_nchw
from vision_semantic_segmentation_tpu_torch.ops import resize
from vision_semantic_segmentation_tpu_torch.ops.kernels import _lib as kernel_lib
from vision_semantic_segmentation_tpu_torch.ops.kernels import depthwise as dw_kernels
from vision_semantic_segmentation_tpu_torch.parallel import spatial_infer
from vision_semantic_segmentation_tpu_torch.runtime import FusedFramePipeline, MappingReplay

from test_torch_models import _randomize_bn
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

N_FRAMES = 3
IMAGE_HW = (1440, 1920)


def _cfg(make, out_dir, gt_dir):
    cfg = make()
    cfg.MAPPING.BOUNDARY = [[100, 120], [800, 820]]  # 200x200 cells at 0.1 m
    cfg.MAPPING.POINT_BUCKET = 2048
    cfg.OUTPUT_DIR = str(out_dir)
    cfg.GROUND_TRUTH_DIR = str(gt_dir)
    cfg.VISION_SEM_SEG.IMAGE_SCALE = 1.0 / 16
    net = cfg.VISION_SEM_SEG.SEM_SEG_NETWORK
    net.MODEL.BACKBONE = "resnet18"
    net.MODEL.ASPP.OUT_CHANNELS = 32
    net.MODEL.ASPP.ATROUS_CHANNELS = [32, 32, 32, 32]
    net.MODEL.DECODER.REFINE_CHANNELS = [32, 32]
    return cfg


def _frames(rng):
    """A window of raw frames and clouds over the grid, vehicle behind it facing +x."""
    x0 = 100 - PCD_ORIGIN_OFFSET[0]
    y0 = 800 - PCD_ORIGIN_OFFSET[1]
    n = 2048
    xy = rng.uniform([[x0], [y0]], [[x0 + 20], [y0 + 20]], (N_FRAMES, 2, n))
    zi = rng.uniform([[-1.0], [0.0]], [[0.5], [20.0]], (N_FRAMES, 2, n))
    # a coarse random image: 90x120 blocks of 16x16 pixels
    coarse = rng.integers(0, 256, (N_FRAMES, 90, 120, 3), dtype=np.uint8)
    return {
        "image": coarse.repeat(16, axis=1).repeat(16, axis=2),
        "pcd": np.concatenate([xy, zi], axis=1).astype(np.float32),
        "valid": np.ones((N_FRAMES, n), bool),
        "position": np.tile(np.float32([x0 - 6.0, y0 + 10.0, 0.0]), (N_FRAMES, 1)),
        "quaternion": np.tile(np.float32([0, 0, 0, 1]), (N_FRAMES, 1)),
    }


@pytest.fixture(scope="module")
def slice_run(tmp_path_factory):
    rng = np.random.default_rng(21)
    out_dir = tmp_path_factory.mktemp("maps")
    gt_dir = tmp_path_factory.mktemp("truth")
    grid_hw = (200, 200)
    truth = rng.integers(0, 4, (grid_hw[0] // 10, grid_hw[1] // 10)).repeat(10, 0).repeat(10, 1)
    np.save(gt_dir / "truth.npy", truth.astype(np.float64))
    np.save(gt_dir / "mask.npy", np.ones(grid_hw))

    jcfg = _cfg(j_cfg_defaults, out_dir, gt_dir)
    cfg = _cfg(get_cfg_defaults, out_dir, gt_dir)
    jmodel = j_build_model(jcfg.VISION_SEM_SEG.SEM_SEG_NETWORK)[0]
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 90, 120, 3)))
    variables = _randomize_bn(jax.tree.map(np.asarray, dict(variables)), rng)
    frames = _frames(rng)
    # A random network gives every pixel the class with the largest mean
    # logit.  Centre the logits on frame 0 and hold the unmapped classes
    # back a little, so that points take several map channels and some none.
    seg = JaxPipeline(jcfg, variables, compute_dtype=jnp.float32)._build_segmentation(
        "camera1", IMAGE_HW)
    logits = np.asarray(seg(variables, jnp.asarray(frames["image"][0])))[0]
    head = variables["params"]["decoder"]["refine_layers_2"]["conv"]
    unmapped = ~np.isin(np.arange(19), jcfg.LABELS)
    head["bias"] = (head["bias"] - logits.mean((0, 1))
                    - unmapped * 0.5 * logits.std((0, 1))).astype(np.float32)

    jpipe = JaxPipeline(jcfg, variables, compute_dtype=jnp.float32, distortion="points")
    run = jpipe.build_sequence_runner(image_hw=IMAGE_HW)
    j_grid = np.asarray(run(jpipe.init_grid(), {k: jnp.asarray(v) for k, v in frames.items()}))
    j_map = JaxReplay(jcfg, engine=jpipe.engine).finalize(j_grid, "jax", use_pallas=False)

    pipe = FusedFramePipeline(cfg, state_dict=flax_to_state_dict(variables),
                              compute_dtype=torch.float32, distortion="points", device="cpu")
    grid = pipe.run_window(pipe.init_grid(), {k: torch.from_numpy(v) for k, v in frames.items()})
    replay = MappingReplay(cfg, engine=pipe.engine, device="cpu")
    t_map = replay.finalize(grid, "port")
    return dict(j_grid=j_grid, grid=grid.numpy(), j_map=j_map, map=t_map, gt_dir=str(gt_dir),
                out_dir=replay.output_dir)


def test_grid_matches(slice_run):
    grid, j_grid = slice_run["grid"], slice_run["j_grid"]
    assert (j_grid != 0).sum() > 100  # the window put evidence into the grid
    np.testing.assert_allclose(grid, j_grid, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(grid != 0, j_grid != 0)


def test_rendered_map_matches(slice_run):
    t_map, j_map = slice_run["map"], slice_run["j_map"]
    assert t_map.shape == j_map.shape == (200, 200, 3) and t_map.dtype == np.uint8
    assert (t_map.sum(-1) > 0).mean() > 0.01
    mismatch = (t_map != j_map).any(-1).mean()
    assert mismatch <= 1e-3, f"maps differ on {mismatch:.5f} of cells"
    # finalize wrote the PNG; cv2 reads back the array it was given
    import cv2

    np.testing.assert_array_equal(cv2.imread(f"{slice_run['out_dir']}/global_map_port.png"), t_map)


def test_scores_match(slice_run):
    ours = MapEvaluator(ground_truth_dir=slice_run["gt_dir"]).test_single_map(slice_run["map"])
    ref = JaxEvaluator(ground_truth_dir=slice_run["gt_dir"]).test_single_map(slice_run["j_map"])
    np.testing.assert_equal(ours, ref)
    assert all(v > 0 for v in ours["iou"].values())  # every scored class was mapped


# -- the resize matrices' device cache ----------------------------------------------------
def _serving_pipeline(tmp_path, image_scale=1.0):
    """The serving configuration's forward (OS8, points distorted) with a
    small network.  At ``image_scale`` 1 (the serving configuration's: raw
    frames, no INTER_AREA downscale) the frames are 180x240, an eighth of
    the camera's, and a frame resizes twice: ASPP's pooled branch from 1x1
    to the OS8 map, the decoder from it to the stride-4 map.  Below 1 the
    frames are the camera's 1440x1920 and are downscaled first."""
    cfg = _cfg(get_cfg_defaults, tmp_path, tmp_path)
    cfg.VISION_SEM_SEG.IMAGE_SCALE = image_scale
    cfg.VISION_SEM_SEG.SEM_SEG_NETWORK.MODEL.OUTPUT_STRIDE = 8
    pipe = FusedFramePipeline(cfg, compute_dtype=torch.float32, distortion="points",
                              device="cpu", generator=torch.Generator().manual_seed(4))
    frames = {k: torch.from_numpy(v) for k, v in _frames(np.random.default_rng(8)).items()}
    if image_scale == 1.0:
        frames["image"] = frames["image"][:, ::8, ::8].contiguous()
    # as in slice_run: the classifier's biases centred on frame 0, so that
    # points take several classes and the map gets evidence
    with torch.no_grad():
        logits = pipe.segment(frames["image"][0])
        pipe.model.state_dict()["decoder.refine_layers.2.conv.bias"] -= logits.mean((0, 2, 3))
    return pipe, frames


def _fuse(pipe, frames):
    """A window from a fresh grid: the grid, and every frame's logits and labels."""
    logits, labels = [], []
    segment, step = pipe.segment, pipe.step

    def recorded_segment(*a, **k):
        logits.append(segment(*a, **k))
        return logits[-1]

    def recorded_step(*a, **k):
        grid, lab = step(*a, **k)
        labels.append(lab)
        return grid, lab

    pipe.segment, pipe.step = recorded_segment, recorded_step
    try:
        grid = pipe.run_window(pipe.init_grid(), frames)
    finally:
        pipe.segment, pipe.step = segment, step
    return grid, logits, labels


def test_warm_window_uploads_nothing_and_hits_four_a_frame(tmp_path):
    pipe, frames = _serving_pipeline(tmp_path)
    pipe.run_window(pipe.init_grid(), {k: v[:1] for k, v in frames.items()})  # the warm frame
    before = resize.matrix_cache_info()
    pipe.run_window(pipe.init_grid(), frames)
    after = resize.matrix_cache_info()
    assert after.uploads == before.uploads
    assert after.hits - before.hits == 4 * N_FRAMES


def test_cached_matrices_fuse_the_bits_of_per_call_copies(tmp_path, monkeypatch):
    """The same window with the cache against a copy of each matrix made at
    every call (INTER_AREA and align-corners matrices): grid, logits and
    labels bit-equal."""
    pipe, frames = _serving_pipeline(tmp_path, image_scale=1.0 / 16)
    cached = _fuse(pipe, frames)
    assert (cached[0] != 0).sum() > 100  # the window put evidence into the grid

    def per_call(kind, in_size, out_size, device):
        m = {"align_corners": resize._align_corners_matrix, "area": resize._area_matrix}[kind]
        return torch.from_numpy(m(in_size, out_size).copy()).to(device)

    monkeypatch.setattr(resize, "_device_matrix", per_call)
    copied = _fuse(pipe, frames)
    np.testing.assert_array_equal(cached[0].numpy(), copied[0].numpy())
    for a, b in zip(cached[1] + cached[2], copied[1] + copied[2], strict=True):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shards", [2, 3, 4])
def test_band_rows_of_the_cached_matrix_equal_the_full_resize(shards, dtype):
    """``_resize_band`` on each output band's rows of the cached H matrix (a
    view of it) and the source rows they touch: the full resize's rows."""
    (h, w), (oh, ow) = (23, 30), (45, 60)
    src = torch.from_numpy(np.random.default_rng(shards).standard_normal((2, 6, h, w))
                           .astype(np.float32)).to(dtype)
    full = resize_nchw(src, (oh, ow))
    cpu = torch.device("cpu")
    mh = resize._device_matrix("align_corners", h, oh, cpu)
    mw = resize._device_matrix("align_corners", w, ow, cpu)
    ranges = spatial_infer.resize_ranges(resize._align_corners_matrix(h, oh), shards)
    bounds = spatial_infer.row_bounds(oh, shards)
    for (o0, o1), (r0, r1) in zip(bounds, ranges, strict=True):
        rows = mh[o0:o1, r0:r1]
        assert rows.untyped_storage().data_ptr() == mh.untyped_storage().data_ptr()
        band = spatial_infer._resize_band(src[:, :, r0:r1], rows, mw)
        assert band.dtype == dtype
        np.testing.assert_array_equal(band.float().numpy(), full[:, :, o0:o1].float().numpy())


# -- the forward's CUDA graph: the decision and the bookkeeping, on the CPU ---------------
def test_segment_on_the_cpu_runs_eagerly_and_equals_the_model(tmp_path):
    """A CPU frame never captures: every call is counted eager and gives the
    network's own logits on the normalised frame."""
    pipe, frames = _serving_pipeline(tmp_path)
    before = pipe.segment_graph_info()
    with torch.no_grad():
        for frame in frames["image"]:
            xf = ((frame.float() / 255.0 - pipe._mean) / pipe._std).permute(2, 0, 1)[None]
            want = pipe.model(xf, upsample_pred=pipe.upsample_pred)
            np.testing.assert_array_equal(pipe.segment(frame).numpy(), want.numpy())
    after = pipe.segment_graph_info()
    assert (after.captures, after.replays, after.failed) == (0, 0, 0)
    assert after.eager - before.eager == N_FRAMES


def _card_frame():
    """A stand-in for a frame on the card (the decision reads only its
    device, shape and dtype): this host has no card."""
    return types.SimpleNamespace(device=torch.device("cuda", 0), shape=torch.Size([180, 240, 3]),
                                 dtype=torch.uint8)


EAGER_CASES = ["cpu_frame", "params", "training", "capturing", "plain_versions"]


@pytest.mark.parametrize("case", EAGER_CASES)
def test_segment_stays_eager(tmp_path, monkeypatch, case):
    """Each condition alone keeps a card frame off the graph (``_graph_key``
    is None), and ``segment`` on the CPU under it counts one eager call and
    gives the eager logits."""
    pipe, frames = _serving_pipeline(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    with torch.no_grad():  # the control: a card frame and none of the conditions
        assert pipe._graph_key(_card_frame(), "camera1", None) == (
            "camera1", (180, 240, 3), torch.uint8, torch.device("cuda", 0), False)
        want = pipe.segment(frames["image"][1])
    if case == "capturing":
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    params = dict(pipe.model.state_dict()) if case == "params" else None
    plain = kernel_lib.plain_versions() if case == "plain_versions" else contextlib.nullcontext()
    if case == "training":
        pipe.model.train()
    frame = frames["image"][1] if case == "cpu_frame" else _card_frame()
    with torch.no_grad(), plain:
        assert pipe._graph_key(frame, "camera1", params) is None
        before = pipe.segment_graph_info()
        got = pipe.segment(frames["image"][1], "camera1", params)
    after = pipe.segment_graph_info()
    assert after._replace(eager=after.eager - 1) == before
    assert not got.requires_grad
    if case != "training":  # in training BatchNorm takes the frame's statistics
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_grad_mode_chooses_nothing(tmp_path, monkeypatch):
    """The caller's grad mode keys the same graph and gives the same logits,
    without grad: ``segment`` always runs its forward without it."""
    pipe, frames = _serving_pipeline(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    keys, logits = [], []
    for grad in (torch.no_grad, torch.enable_grad):
        with grad():
            keys.append(pipe._graph_key(_card_frame(), "camera1", None))
            logits.append(pipe.segment(frames["image"][1]))
    assert keys[0] is not None and keys[0] == keys[1]
    assert not any(t.requires_grad for t in logits)
    np.testing.assert_array_equal(logits[0].numpy(), logits[1].numpy())


@pytest.fixture
def stand_in_launch(monkeypatch):
    """``CudaKernel.launch`` run on the CPU: the C entry points and the CUDA
    stream stood in for, the launches counted as on the card."""
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=0))
    for k in kernel_lib.kernels():
        monkeypatch.setattr(k, "_fn", lambda *args: 0)
    return lambda k: k.launch(kernel_lib.ptr(torch.zeros(1)))


class _StandInGraph:
    """``torch.cuda.CUDAGraph`` stood in for: its capture runs the forward
    once (on the CPU); its replay runs nothing."""

    fail = False

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


@contextlib.contextmanager
def _stand_in_capture(graph, stream=None, capture_error_mode="global"):
    assert capture_error_mode == "thread_local"
    yield
    if graph.fail:
        raise RuntimeError("operation not permitted when stream is capturing")


@pytest.fixture
def stand_in_cuda(monkeypatch, stand_in_launch):
    """Every frame keyed for a graph, and the CUDA calls of a capture stood
    in for; the forward launches K4 twice."""
    forward = FusedFramePipeline._forward

    def launching_forward(self, *args):
        for _ in range(2):
            stand_in_launch(dw_kernels.MULTI_KERNEL)
        return forward(self, *args)

    monkeypatch.setattr(FusedFramePipeline, "_forward", launching_forward)
    monkeypatch.setattr(FusedFramePipeline, "_graph_key",
                        lambda self, frame, camera, params: ("stand-in", tuple(frame.shape)))
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph", _stand_in_capture)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: None)
    monkeypatch.setattr(torch.cuda, "stream", lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(_StandInGraph, "fail", False)
    return monkeypatch


def test_key_runs_eagerly_then_captures_then_replays(tmp_path, stand_in_cuda):
    """First call eager, second captured and replayed once, third replayed:
    the frame copied into the graph's input, a fresh clone of its logits
    returned each time; K4's launches counted once a replay, the capture's
    own tallied apart; the graph holds the four matrices of the forward's
    two resizes."""
    pipe, frames = _serving_pipeline(tmp_path)  # its centring call: the key's first, eager
    k4 = dw_kernels.MULTI_KERNEL
    assert pipe.segment_graph_info() == (0, 0, 1, 0)
    launches = k4.launches
    with torch.no_grad():
        captured = pipe.segment(frames["image"][1])
        entry = next(v for v in pipe._graphs.values() if not isinstance(v, str))
        replayed = pipe.segment(frames["image"][2])
    assert pipe.segment_graph_info() == (1, 2, 1, 0)
    assert entry.graph.replays == 2
    assert k4.launches - launches == 2 * 2
    assert entry.launches == {k4: 2}
    assert len(entry.matrices) == 4
    assert torch.equal(entry.frame, frames["image"][2])
    ptrs = {t.data_ptr() for t in (captured, replayed, entry.logits)}
    assert len(ptrs) == 3  # no return aliases the graph's output or another return
    with torch.no_grad():
        want = pipe._forward(frames["image"][1], "camera1", None)
    np.testing.assert_array_equal(captured.numpy(), want.numpy())


def test_failed_capture_runs_its_key_eagerly(tmp_path, stand_in_cuda):
    """A capture that raises is counted and warned of, its tallied launches
    dropped, and its key runs eagerly from then on, with the eager logits."""
    pipe, frames = _serving_pipeline(tmp_path)  # its centring call: the key's first, eager
    stand_in_cuda.setattr(_StandInGraph, "fail", True)
    k4 = dw_kernels.MULTI_KERNEL
    launches = k4.launches
    with torch.no_grad():
        with pytest.warns(RuntimeWarning, match="runs eagerly"):
            got = [pipe.segment(frames["image"][i]) for i in (1, 2)]
        assert pipe.segment_graph_info() == (0, 0, 3, 1)
        assert k4.launches - launches == 2 * 2  # the two eager forwards' alone
        want = [pipe._forward(frames["image"][i], "camera1", None) for i in (1, 2)]
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_launches_of_a_capture_are_tallied_apart_and_counted_per_replay(stand_in_launch):
    k3, k4 = dw_kernels.KERNEL, dw_kernels.MULTI_KERNEL
    before = (k3.launches, k4.launches)
    with kernel_lib.captured_launches() as tally:
        for _ in range(60):
            stand_in_launch(k3)
        stand_in_launch(k4)
    assert tally == {k3: 60, k4: 1}
    assert (k3.launches, k4.launches) == before
    for _ in range(3):
        kernel_lib.count_launches(tally)
    stand_in_launch(k4)
    assert (k3.launches - before[0], k4.launches - before[1]) == (180, 4)


def test_other_threads_count_their_launches_during_a_capture(stand_in_launch):
    """Launches another thread makes while this one captures ran: they are
    counted as ever, and stay out of the capture's tally."""
    k3, k4 = dw_kernels.KERNEL, dw_kernels.MULTI_KERNEL
    before = (k3.launches, k4.launches)
    started, release = threading.Event(), threading.Event()

    def other():
        started.set()
        release.wait(10)
        for _ in range(5):
            stand_in_launch(k3)
        stand_in_launch(k4)

    worker = threading.Thread(target=other)
    with kernel_lib.captured_launches() as tally:
        worker.start()
        started.wait(10)
        stand_in_launch(k4)
        release.set()
        worker.join(10)
        stand_in_launch(k4)
    assert tally == {k4: 2}
    assert (k3.launches - before[0], k4.launches - before[1]) == (5, 1)

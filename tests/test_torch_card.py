"""The fused step on an NVIDIA card: tests marked ``cuda``, which skip
without one.

On the card's machine, which has no JAX (``tests/conftest.py`` sets JAX up,
hence ``--noconftest``)::

    python -m pytest tests/test_torch_card.py -m cuda --noconftest -q

A warmed ``FusedFramePipeline.run_window`` of a small DeepLabV3+ in bf16
issues no host synchronisation from its first launch to its return: it runs
under ``torch.cuda.set_sync_debug_mode("error")``, which raises at any call
that waits for the card (the resize matrices, once copied from pageable host
memory at every call, now come from the device cache of ``ops/resize.py``).
And the cache changes no bit: the same window with a copy of each matrix
made at every call gives the same grid, logits and labels; the step
exported from an empty cache equals ``run_window``.

The forward's CUDA graph (``FusedFramePipeline.segment``): a warmed window
replays it, with no matrix lookup; the graphed logits of a ResNeXt50 OS8
and an Xception-65 OS16 network equal those of the same forward run
eagerly bit for bit (on the card in eval, BatchNorm folded:
``models/fold.py``), each return is a tensor of its own, weights loaded
after the capture are honoured (refolded once, outside the graph), the
resize matrices it reads stay its own when the cache is cleared, a new
frame shape captures again, the kernels' launch counts after n graphed
frames equal those after n eager ones, and a capture that raises leaves
its key eager with the eager logits.

The folded forward in bf16 at the camera's 1440x1920, seeded as each
benchmark cell seeds its network, stays well within the benchmark's
check: against the network in f32 its ``logit_err`` and ``label_gap``
are under half their limits, and its labels are the f32 network's on as
many pixels as the unfolded bf16 forward's are; three graphed frames
refold nothing, a ``load_state_dict`` refolds once.  The cells seed every
BatchNorm as the identity, so each folded bias is 0 there: with random
statistics, weights and shifts in every BatchNorm, the folded forward
holds the modules run unfolded in f32 (TF32 off) to 1e-4 of the largest
logit in f32, and within the benchmark's ``logit_err`` limit in bf16.
"""
import copy

import numpy as np
import pytest
import torch

from vision_semantic_segmentation_tpu_torch.config import get_cfg_defaults
from vision_semantic_segmentation_tpu_torch.mapping import PCD_ORIGIN_OFFSET
from vision_semantic_segmentation_tpu_torch.models import build_model, fold
from vision_semantic_segmentation_tpu_torch.ops import kernels as K
from vision_semantic_segmentation_tpu_torch.ops import resize
from vision_semantic_segmentation_tpu_torch.runtime import FusedFramePipeline

from test_torch_fold import _randomized, _residual_norms
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

pytestmark = pytest.mark.cuda

FRAMES = 4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _pipeline(card, image_scale):
    """The serving configuration's step (OS8, points distorted, bf16) with a
    ResNet-18 backbone and narrow ASPP and decoder, on a 200x200 grid; the
    classifier's biases centred on frame 0, so that the map gets evidence."""
    cfg = get_cfg_defaults()
    cfg.MAPPING.BOUNDARY = [[100, 120], [800, 820]]
    cfg.MAPPING.POINT_BUCKET = 2048
    cfg.VISION_SEM_SEG.IMAGE_SCALE = image_scale
    net = cfg.VISION_SEM_SEG.SEM_SEG_NETWORK
    net.MODEL.BACKBONE = "resnet18"
    net.MODEL.OUTPUT_STRIDE = 8
    net.MODEL.ASPP.OUT_CHANNELS = 64
    net.MODEL.ASPP.ATROUS_CHANNELS = [64, 64, 64, 64]
    net.MODEL.DECODER.REFINE_CHANNELS = [64, 64]
    pipe = FusedFramePipeline(cfg, compute_dtype=torch.bfloat16, distortion="points",
                              device=card, generator=torch.Generator().manual_seed(4))
    rng = np.random.default_rng(9)
    n = 2048
    x0, y0 = 100 - PCD_ORIGIN_OFFSET[0], 800 - PCD_ORIGIN_OFFSET[1]
    xy = rng.uniform([[x0], [y0]], [[x0 + 20], [y0 + 20]], (FRAMES, 2, n))
    zi = rng.uniform([[-1.0], [0.0]], [[0.5], [20.0]], (FRAMES, 2, n))
    coarse = rng.integers(0, 256, (FRAMES, 90, 120, 3), dtype=np.uint8)
    frames = {
        "image": coarse.repeat(16, axis=1).repeat(16, axis=2),
        "pcd": np.concatenate([xy, zi], axis=1).astype(np.float32),
        "valid": np.ones((FRAMES, n), bool),
        "position": np.tile(np.float32([x0 - 6.0, y0 + 10.0, 0.0]), (FRAMES, 1)),
        "quaternion": np.tile(np.float32([0, 0, 0, 1]), (FRAMES, 1)),
    }
    frames = {k: torch.from_numpy(v).to(card) for k, v in frames.items()}
    with torch.no_grad():
        logits = pipe.segment(frames["image"][0]).float()
        bias = pipe.model.state_dict()["decoder.refine_layers.2.conv.bias"]
        bias -= logits.mean((0, 2, 3)).to(bias.dtype)
    return pipe, frames


# the camera's 1440x1920 frames at the serving configuration's IMAGE_SCALE 1
# (two resizes a frame), and downscaled by INTER_AREA first (three)
CASES = [(1.0, 4), (0.25, 6)]


@pytest.mark.parametrize("image_scale,lookups", CASES)
def test_warm_window_waits_for_nothing(card, monkeypatch, image_scale, lookups):
    """The warmed window replays the forward's graph: no wait, no matrix
    looked up (the graph reads them by address).  The eager forward (no
    graph key) finds every matrix in the cache and waits for nothing either."""
    pipe, frames = _pipeline(card, image_scale)
    grid = pipe.init_grid()
    for _ in range(2):  # warm: every matrix uploaded, cuDNN's plans chosen, the graph captured
        grid = pipe.run_window(grid, frames)
    torch.cuda.synchronize()
    before, graphs = resize.matrix_cache_info(), pipe.segment_graph_info()
    torch.cuda.set_sync_debug_mode("error")
    try:
        grid = pipe.run_window(grid, frames)
        with monkeypatch.context() as eager:
            eager.setattr(pipe, "_graph_key", lambda *args: None)
            for frame in frames["image"]:
                pipe.segment(frame)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    after = resize.matrix_cache_info()
    assert after.uploads == before.uploads
    assert after.hits - before.hits == lookups * FRAMES
    assert pipe.segment_graph_info() == graphs._replace(replays=graphs.replays + FRAMES,
                                                        eager=graphs.eager + FRAMES)
    assert int((grid != 0).sum()) > 100


def _fuse(pipe, frames):
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
    return [grid] + logits + labels


@pytest.mark.parametrize("image_scale", [scale for scale, _ in CASES])
def test_cached_matrices_fuse_the_bits_of_per_call_copies(card, monkeypatch, image_scale):
    """Both windows eager (no graph key): a capture may not copy a matrix in."""
    pipe, frames = _pipeline(card, image_scale)
    monkeypatch.setattr(pipe, "_graph_key", lambda *args: None)
    cached = _fuse(pipe, frames)

    def per_call(kind, in_size, out_size, device):
        m = {"align_corners": resize._align_corners_matrix, "area": resize._area_matrix}[kind]
        return torch.from_numpy(m(in_size, out_size).copy()).to(device)

    monkeypatch.setattr(resize, "_device_matrix", per_call)
    copied = _fuse(pipe, frames)
    assert len(cached) == len(copied) == 1 + 2 * FRAMES
    for a, b in zip(cached, copied):
        assert torch.equal(a, b)


def test_exported_step_from_an_empty_cache(card, monkeypatch):
    """``compile_sequence_runner`` with no matrix cached: the matrices are
    built before tracing (under the tracer a copy to the card would be a
    fake tensor, and the cache would keep it): ``run_window`` after it
    finds every matrix in the cache and runs (a fake tensor there would
    raise), and the exported step's grid equals its grid to 1e-3
    (``chip_smoke.py`` phase 10's agreement).  The exported step takes the
    weights as inputs and runs the modules unfolded, so ``run_window``
    does too here."""
    pipe, frames = _pipeline(card, 1.0)
    resize._device_matrix.cache_clear()
    run = pipe.compile_sequence_runner(image_hw=(1440, 1920), window=FRAMES)
    uploads = resize.matrix_cache_info().uploads
    monkeypatch.setattr(pipe, "_folds", lambda *args: False)
    want = pipe.run_window(pipe.init_grid(), frames)
    assert resize.matrix_cache_info().uploads == uploads
    grid = run(pipe.init_grid(), frames)
    torch.testing.assert_close(grid, want, atol=1e-3, rtol=0)
    assert int((grid != 0).sum()) > 100


# -- the forward's CUDA graph ----------------------------------------------------------
NETWORKS = [("resnext50_32x4d", 8), ("xception65", 16)]


def _network_cfg(backbone, output_stride):
    cfg = get_cfg_defaults()
    net = cfg.VISION_SEM_SEG.SEM_SEG_NETWORK
    net.MODEL.BACKBONE = backbone
    net.MODEL.OUTPUT_STRIDE = output_stride
    if backbone == "xception65":
        net.MODEL.DECODER.LOW_LEVEL_OUT_CHANNELS = 48
    return cfg


def _network(card, backbone, output_stride, seed=5):
    """The serving step of a full-width network in bf16 (raw frames, points
    distorted) and three raw 96x128 frames on the card."""
    cfg = _network_cfg(backbone, output_stride)
    pipe = FusedFramePipeline(cfg, compute_dtype=torch.bfloat16, distortion="points",
                              device=card, generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    frames = torch.from_numpy(rng.integers(0, 256, (3, 96, 128, 3), dtype=np.uint8)).to(card)
    return pipe, frames


def _eager(pipe, frame):
    """``segment`` with no graph key: the same forward (BatchNorm folded)
    launched op by op."""
    with pytest.MonkeyPatch.context() as eager:
        eager.setattr(pipe, "_graph_key", lambda *args: None)
        return pipe.segment(frame)


@pytest.mark.parametrize("backbone,output_stride", NETWORKS)
def test_graphed_logits_equal_eager(card, backbone, output_stride):
    pipe, frames = _network(card, backbone, output_stride)
    with torch.no_grad():
        graphed = [pipe.segment(frame) for frame in frames]
    assert pipe.segment_graph_info() == (1, 2, 1, 0)  # eager, captured and replayed, replayed
    for frame, got in zip(frames, graphed):
        assert torch.equal(got, _eager(pipe, frame))
    assert not torch.equal(graphed[1], graphed[2])


def test_graphed_returns_do_not_alias(card):
    pipe, frames = _network(card, *NETWORKS[1])
    with torch.no_grad():
        pipe.segment(frames[0])
        first = pipe.segment(frames[1])
        kept = first.clone()
        second = pipe.segment(frames[2])
    assert first.data_ptr() != second.data_ptr()
    assert torch.equal(first, kept)


def test_load_state_dict_after_capture_is_honoured(card):
    pipe, frames = _network(card, *NETWORKS[1])
    with torch.no_grad():
        for frame in frames[:2]:
            pipe.segment(frame)
        other = _network(card, *NETWORKS[1], seed=6)[0].model.state_dict()
        pipe.model.load_state_dict(other)
        got = pipe.segment(frames[2])
    assert pipe.segment_graph_info() == (1, 2, 1, 0)
    assert torch.equal(got, _eager(pipe, frames[2]))


def test_graph_holds_the_matrices_the_cache_drops(card):
    """The resize matrices a capture read stay the graph's: the cache
    cleared and its memory handed out again, the replay still gives the
    eager logits."""
    pipe, frames = _network(card, *NETWORKS[0])
    with torch.no_grad():
        for frame in frames[:2]:  # eager, then captured and replayed
            pipe.segment(frame)
        resize._device_matrix.cache_clear()
        scribbled = [torch.full((n,), 1e9, device=card) for n in range(1, 4096, 3)]
        got = pipe.segment(frames[2])
        torch.cuda.synchronize()
        del scribbled  # held over the replay
    assert pipe.segment_graph_info() == (1, 2, 1, 0)
    assert torch.equal(got, _eager(pipe, frames[2]))


def test_new_frame_shape_captures_again(card):
    pipe, frames = _network(card, *NETWORKS[1])
    smaller = frames[:, :64, :96].contiguous()
    with torch.no_grad():
        for frame in frames[:2]:
            pipe.segment(frame)
        got = [pipe.segment(frame) for frame in smaller[:2]]
    assert pipe.segment_graph_info() == (2, 2, 2, 0)
    assert got[1].shape[-2:] != pipe.segment(frames[0]).shape[-2:]
    for frame, logits in zip(smaller, got):
        assert torch.equal(logits, _eager(pipe, frame))


@pytest.mark.parametrize("backbone,output_stride", NETWORKS)
def test_graphed_launches_equal_eager_launches(card, backbone, output_stride):
    """K3 and K4 launches after n graphed frames equal those after n eager
    ones (Xception-65: 60 K3 and 1 K4 a frame; ResNeXt50: 1 K4)."""
    pipe, frames = _network(card, backbone, output_stride)
    with torch.no_grad():
        for frame in frames[:2]:  # eager, then captured and replayed
            pipe.segment(frame)

    def counted(run):
        K.reset_launch_counts()
        for frame in frames:
            run(frame)
        torch.cuda.synchronize()
        return {k.name: k.launches for k in K.kernels() if k.launches}

    with torch.no_grad():
        graphed = counted(pipe.segment)
    eager = counted(lambda frame: _eager(pipe, frame))
    k3 = 60 * len(frames) if backbone == "xception65" else 0
    want = {"aspp_depthwise3x3_multi": len(frames)} | ({"depthwise3x3_dilated": k3} if k3 else {})
    assert graphed == eager == want
    assert pipe.segment_graph_info().replays == 1 + len(frames)


def test_failed_capture_falls_back_to_eager(card, monkeypatch):
    """A forward that waits for the card cannot be captured: the capture
    raises, is counted and warned of, the caller's stream is restored, and
    the key runs eagerly with the eager logits."""
    pipe, frames = _network(card, *NETWORKS[1])
    forward = fold.FoldedNetwork.__call__

    def waiting_forward(*args, **kwargs):
        torch.cuda.synchronize()
        return forward(*args, **kwargs)

    monkeypatch.setattr(fold.FoldedNetwork, "__call__", waiting_forward)
    stream = torch.cuda.current_stream()
    with torch.no_grad():
        pipe.segment(frames[0])
        with pytest.warns(RuntimeWarning, match="runs eagerly"):
            got = [pipe.segment(frame) for frame in frames[1:]]
    assert torch.cuda.current_stream() == stream
    assert pipe.segment_graph_info() == (0, 0, 3, 1)
    for frame, logits in zip(frames[1:], got):
        assert torch.equal(logits, _eager(pipe, frame))


# -- the folded forward against the unfolded one ---------------------------------------
RESIDUAL_BN_WEIGHT = {"resnext50_32x4d": 1.0, "xception65": 5000.0}  # as each cell seeds it


def _served(card, backbone, output_stride):
    """A full-width network seeded as its benchmark cell seeds it (He
    weights, identity BatchNorm but for the residual branches' last
    weight), its classifier's biases centred on the first of three raw
    1440x1920 frames (unfolded), and the network in f32 (TF32 off) as the
    reference."""
    pipe, _ = _network(card, backbone, output_stride)
    frames = torch.from_numpy(np.random.default_rng(13).integers(
        0, 256, (3, 1440, 1920, 3), dtype=np.uint8)).to(card)
    with torch.no_grad():
        for bn in _residual_norms(pipe.model):
            bn.weight.fill_(RESIDUAL_BN_WEIGHT[backbone])
        logits = pipe._forward(frames[0], "camera1", None).float()
        bias = pipe.model.state_dict()["decoder.refine_layers.2.conv.bias"]
        bias -= logits.mean((0, 2, 3)).to(bias.dtype)
    return pipe, frames, copy.deepcopy(pipe.model).float()


def _readings(logits, want):
    """The benchmark's two readings of (C, h, w) logits against the f32
    network's: the largest difference over the largest magnitude, and the
    widest gap by which the reference's logit of the label lies below its
    best, over the reference's standard deviation."""
    err = float((logits - want).abs().max() / want.abs().max())
    label = logits.argmax(0, keepdim=True)
    gap = float((want.max(0, keepdim=True).values - want.gather(0, label)).max() / want.std())
    return err, gap


@pytest.mark.parametrize("backbone,output_stride", NETWORKS)
def test_folded_logits_stay_within_the_check(card, backbone, output_stride):
    """Against the f32 network, the folded forward's ``logit_err`` and
    ``label_gap`` stay under half their limits (0.17, 1.1), and its labels
    are the f32 network's on as many pixels as the unfolded bf16 forward's,
    to half a point.  (The two bf16 forwards agree with each other on
    about 96 % of the pixels, as each does with f32: a random network's two
    best logits lie within bf16 rounding of each other on about 4 % of
    them.)"""
    pipe, frames, reference = _served(card, backbone, output_stride)
    with torch.no_grad():
        for frame in frames:  # eager, captured and replayed, replayed: all folded
            folded = pipe.segment(frame)[0].float()
            unfolded = pipe._forward(frame, "camera1", None)[0].float()
            xf = ((frame.float() / 255.0 - pipe._mean) / pipe._std).permute(2, 0, 1)[None]
            want = reference(xf.contiguous(memory_format=torch.channels_last),
                             upsample_pred=pipe.upsample_pred)[0]
            err, gap = _readings(folded, want)
            labels = want.argmax(0)
            agree = float((folded.argmax(0) == labels).float().mean())
            agree_unfolded = float((unfolded.argmax(0) == labels).float().mean())
            assert err < 0.17 / 2 and gap < 1.1 / 2, (err, gap)
            assert agree >= agree_unfolded - 0.005, (agree, agree_unfolded)
    assert pipe.segment_graph_info() == (1, 2, 1, 0)


@pytest.mark.parametrize("backbone,output_stride", NETWORKS)
def test_warm_frames_refold_nothing_and_a_load_refolds_once(card, backbone, output_stride):
    pipe, frames = _network(card, backbone, output_stride)
    with torch.no_grad():
        for frame in frames:
            pipe.segment(frame)
        info = pipe.fold_info()
        assert info.refolds == 0
        assert (info.folded, info.unfolded) == {"resnext50_32x4d": (62, 5),
                                                "xception65": (138, 8)}[backbone]
        pipe.model.load_state_dict(_network(card, backbone, output_stride, seed=6)[0]
                                   .model.state_dict())
        got = pipe.segment(frames[0])
        assert pipe.fold_info() == info._replace(refolds=1)
        for frame in frames:
            pipe.segment(frame)
    assert pipe.fold_info().refolds == 1
    assert pipe.segment_graph_info() == (1, 6, 1, 0)
    assert torch.equal(got, _eager(pipe, frames[0]))


@pytest.mark.parametrize("backbone,output_stride", NETWORKS)
@pytest.mark.parametrize("dtype,limit", [(torch.float32, 1e-4), (torch.bfloat16, 0.17)])
def test_folded_forward_holds_random_statistics(card, monkeypatch, backbone, output_stride,
                                                dtype, limit):
    """Every BatchNorm with random running statistics, weight and bias, the
    residual branches' last weight as each cell seeds it
    (``test_torch_fold._randomized``), and the conv biases random: the
    pipeline's folded forward at 1440x1920 (eager, captured and replayed,
    replayed) against the modules run unfolded in f32 with TF32 off, the
    largest difference over the largest logit under ``limit``: 1e-4 in
    f32, the benchmark's ``logit_err`` limit in bf16."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = _network_cfg(backbone, output_stride)
    reference = _randomized(build_model(cfg.VISION_SEM_SEG.SEM_SEG_NETWORK, device="cpu"),
                            seed=11, residual_bn_weight=RESIDUAL_BN_WEIGHT[backbone]).to(card)
    pipe = FusedFramePipeline(cfg, reference.state_dict(), compute_dtype=dtype,
                              distortion="points", device=card)
    frames = torch.from_numpy(np.random.default_rng(17).integers(
        0, 256, (3, 1440, 1920, 3), dtype=np.uint8)).to(card)
    errs = []
    with torch.no_grad():
        for frame in frames:
            got = pipe.segment(frame)[0].float()
            xf = ((frame.float() / 255.0 - pipe._mean) / pipe._std).permute(2, 0, 1)[None]
            want = reference(xf, upsample_pred=pipe.upsample_pred)[0]
            errs.append(float((got - want).abs().max() / want.abs().max()))
    assert max(errs) < limit, errs
    assert pipe.segment_graph_info() == (1, 2, 1, 0)
    info = pipe.fold_info()
    assert (info.folded, info.unfolded, info.refolds) == {
        "resnext50_32x4d": (62, 5, 0), "xception65": (138, 8, 0)}[backbone]

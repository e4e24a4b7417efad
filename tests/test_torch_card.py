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
"""
import numpy as np
import pytest
import torch

from vision_semantic_segmentation_tpu_torch.config import get_cfg_defaults
from vision_semantic_segmentation_tpu_torch.mapping import PCD_ORIGIN_OFFSET
from vision_semantic_segmentation_tpu_torch.ops import resize
from vision_semantic_segmentation_tpu_torch.runtime import FusedFramePipeline

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
def test_warm_window_waits_for_nothing(card, image_scale, lookups):
    pipe, frames = _pipeline(card, image_scale)
    grid = pipe.init_grid()
    for _ in range(2):  # warm: every matrix uploaded, cuDNN's plans chosen
        grid = pipe.run_window(grid, frames)
    torch.cuda.synchronize()
    before = resize.matrix_cache_info()
    torch.cuda.set_sync_debug_mode("error")
    try:
        grid = pipe.run_window(grid, frames)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    after = resize.matrix_cache_info()
    assert after.uploads == before.uploads
    assert after.hits - before.hits == lookups * FRAMES
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
    pipe, frames = _pipeline(card, image_scale)
    cached = _fuse(pipe, frames)

    def per_call(kind, in_size, out_size, device):
        m = {"align_corners": resize._align_corners_matrix, "area": resize._area_matrix}[kind]
        return torch.from_numpy(m(in_size, out_size).copy()).to(device)

    monkeypatch.setattr(resize, "_device_matrix", per_call)
    copied = _fuse(pipe, frames)
    assert len(cached) == len(copied) == 1 + 2 * FRAMES
    for a, b in zip(cached, copied):
        assert torch.equal(a, b)


def test_exported_step_from_an_empty_cache(card):
    """``compile_sequence_runner`` with no matrix cached: the matrices are
    built before tracing (under the tracer a copy to the card would be a
    fake tensor, and the cache would keep it): ``run_window`` after it
    finds every matrix in the cache and runs (a fake tensor there would
    raise), and the exported step's grid equals its grid to 1e-3
    (``chip_smoke.py`` phase 10's agreement)."""
    pipe, frames = _pipeline(card, 1.0)
    resize._device_matrix.cache_clear()
    run = pipe.compile_sequence_runner(image_hw=(1440, 1920), window=FRAMES)
    uploads = resize.matrix_cache_info().uploads
    want = pipe.run_window(pipe.init_grid(), frames)
    assert resize.matrix_cache_info().uploads == uploads
    grid = run(pipe.init_grid(), frames)
    torch.testing.assert_close(grid, want, atol=1e-3, rtol=0)
    assert int((grid != 0).sum()) > 100

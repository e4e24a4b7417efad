"""Port parity: the off-path renderers and stitching against the JAX package.

Every function of ``mapping/renderer.py`` and ``mapping/stitching.py::
stitch_image`` in both modes run on the same seeded numpy inputs in both
packages on the CPU, over (H, W, 5) grids of 64x96.  Tolerances: uint8
maps and min-max layer images equal; float outputs
(``log_odds_to_probability``, log-odds stitching) within 1e-6 absolute
(the port's logsumexp runs in float64 and rounds once, the JAX package's in
float32), and so a probability layer image, ``floor(255 p)``, equal but
where the JAX package's ``255 p`` lies within 255e-6 of an integer, where
it may be one level apart (see the test).  The JAX tests'
pinned cases are held too: the painter's order and the skipped last frame
of ``tests/test_mapping.py``'s stitching tests, and a ``fill_black_mode``
tie between two classes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_semantic_segmentation_tpu.mapping import renderer as j_renderer
from vision_semantic_segmentation_tpu.mapping import stitching as j_stitching
from vision_semantic_segmentation_tpu_torch.mapping import renderer, stitching

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

H, W = 64, 96
LABEL_COLORS = renderer.LABEL_COLORS


@pytest.fixture
def rng():
    return np.random.default_rng(8)


def _grid(rng, explored=0.7):
    """Count-like evidence with 30 % of the cells unexplored (all zero)."""
    grid = rng.integers(0, 6, (H, W, 5)).astype(np.float32)
    grid[rng.random((H, W)) > explored] = 0
    return grid


def _color_map(rng, black=0.5):
    cls = rng.integers(0, 5, (H, W))
    img = LABEL_COLORS[cls].copy()
    img[rng.random((H, W)) < black] = 0
    return img


def _jax(fn, *args, **kw):
    return np.asarray(fn(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args],
                         **kw))


def _port(fn, *args, **kw):
    out = fn(*[torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args], **kw)
    return out.numpy()


def test_render_bev_map(rng):
    grid = _grid(rng)
    want = _jax(j_renderer.render_bev_map, grid, LABEL_COLORS)
    np.testing.assert_array_equal(_port(renderer.render_bev_map, grid, LABEL_COLORS), want)


@pytest.mark.parametrize("args", [
    dict(),
    dict(priority=[3, 4, 0, 2, 1], thresholds=[0.1, 0.1, 0.5, 0.2, 0.05]),
    dict(priority=[0, 3, 4, 2, 1], thresholds=[0.2, 0.3, 0.25, 0.15, 0.35]),
], ids=["defaults", "test_mapping_case", "shares"])
def test_render_with_thresholds(rng, args):
    grid = _grid(rng) + rng.random((H, W, 5)).astype(np.float32) * (_grid(rng) > 0)
    want = _jax(j_renderer.render_bev_map_with_thresholds, grid, LABEL_COLORS, **args)
    got = _port(renderer.render_bev_map_with_thresholds, grid, LABEL_COLORS, **args)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want.reshape(-1, 3), axis=0)) > 2


@pytest.mark.parametrize("priority", [renderer.FILL_PRIORITY, (4, 3, 2, 1, 0)],
                         ids=["fill_priority", "reversed"])
def test_fill_black(rng, priority):
    assert renderer.FILL_PRIORITY == j_renderer.FILL_PRIORITY
    img = _color_map(rng, black=0.8)
    want = _jax(j_renderer.fill_black, img, LABEL_COLORS, priority)
    np.testing.assert_array_equal(_port(renderer.fill_black, img, LABEL_COLORS, priority), want)


def test_fill_black_mode(rng):
    img = _color_map(rng, black=0.6)
    want = _jax(j_renderer.fill_black_mode, img)
    np.testing.assert_array_equal(_port(renderer.fill_black_mode, img), want)


def test_fill_black_mode_tie():
    """Two classes with one cell each in a window: scipy.stats.mode keeps
    the smaller first channel (vegetation, 107, over road, 128) whatever
    the class order; on a tie of first channels the lower class wins."""
    img = np.zeros((5, 5, 3), np.uint8)
    img[2, 1] = LABEL_COLORS[0]  # road, first channel 128
    img[2, 3] = LABEL_COLORS[3]  # vegetation, first channel 107
    got = _port(renderer.fill_black_mode, img)
    np.testing.assert_array_equal(got, _jax(j_renderer.fill_black_mode, img))
    np.testing.assert_array_equal(got[2, 2], LABEL_COLORS[3])
    colors = np.array([[50, 0, 0], [50, 9, 9], [90, 0, 0]], np.uint8)
    img = np.zeros((3, 3, 3), np.uint8)
    img[1, 0], img[1, 2] = colors[1], colors[0]
    got = _port(renderer.fill_black_mode, img, colors)
    np.testing.assert_array_equal(got, _jax(j_renderer.fill_black_mode, img, colors))
    np.testing.assert_array_equal(got[1, 1], colors[0])


def test_resume_color_and_fill_edge(rng):
    img = _color_map(rng)
    gray3 = np.repeat(img[..., :1], 3, axis=2)
    np.testing.assert_array_equal(_port(renderer.resume_color, gray3),
                                  _jax(j_renderer.resume_color, gray3))
    before = img.copy()
    np.testing.assert_array_equal(_port(renderer.fill_edge, img), _jax(j_renderer.fill_edge, img))
    np.testing.assert_array_equal(img, before)  # a copy, as the JAX function's .at[].set


def test_log_odds_and_layer_images(rng):
    """Probabilities within 1e-6 of the JAX package's; the min-max layer
    images equal.  A probability layer image is ``floor(255 p)``: where
    JAX's float32 ``255 p`` lies within 255e-6 (the probabilities'
    tolerance) of an integer, the two may be one level apart, and only
    there (measured: 1 of 30720 values)."""
    grid = (rng.standard_normal((H, W, 5)) * 4).astype(np.float32)
    prob = _port(renderer.log_odds_to_probability, grid)
    j_prob = _jax(j_renderer.log_odds_to_probability, grid)
    assert prob.dtype == np.float32
    np.testing.assert_allclose(prob, j_prob, rtol=0, atol=1e-6)
    got = _port(renderer.map_layer_images, grid, normalize=False)
    assert got.shape == (5, H, W) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, _jax(j_renderer.map_layer_images, grid, normalize=False))
    got = _port(renderer.map_layer_images, grid).astype(np.int32)
    want = _jax(j_renderer.map_layer_images, grid).astype(np.int32)
    scaled = (j_prob * np.float32(255.0)).transpose(2, 0, 1)
    on_edge = np.abs(scaled - np.round(scaled)) < 255e-6
    assert np.abs(got - want).max() <= 1
    assert not (got != want)[~on_edge].any()
    assert (got != want).sum() <= 2


@pytest.mark.parametrize("case", [
    (np.array([1.0, 2.0]), 0.0, [[0, 6.4], [0, 9.6]]),
    (np.array([3.0, 4.5]), 0.7, [[0, 6.4], [0, 9.6]]),
    (np.array([0.2, 0.2]), -2.1, [[0, 6.4], [0, 9.6]]),  # the car partly off the map
    (np.array([2.0, 3.0]), 1.3, [[-2, 4.4], [0, 9.6]]),
], ids=["straight", "turned", "clipped", "shifted_boundary"])
def test_add_car_to_map(case):
    pos, yaw, boundary = case
    got = renderer.add_car_to_map(np.zeros((H, W, 3), np.uint8), pos, yaw, 0.1, boundary)
    want = j_renderer.add_car_to_map(np.zeros((H, W, 3), np.uint8), pos, yaw, 0.1, boundary)
    np.testing.assert_array_equal(got, want)
    assert (got == [255, 0, 0]).all(-1).sum() > 0


def _homographies(rng, n):
    """Frame-to-next-frame homographies: a shift and a small rotation each."""
    hs = []
    for _ in range(n):
        a = rng.uniform(-0.05, 0.05)
        hs.append(np.array([[np.cos(a), -np.sin(a), rng.uniform(-12, 12)],
                            [np.sin(a), np.cos(a), rng.uniform(-8, 8)],
                            [0.0, 0.0, 1.0]]))
    return hs


def test_canvas_extent(rng):
    hs = _homographies(rng, 4)
    assert stitching._canvas_extent((H, W), hs) == j_stitching._canvas_extent((H, W), hs)


@pytest.mark.parametrize("log_odds", [True, False], ids=["log_odds", "painter"])
def test_stitch_image(rng, log_odds):
    frames = [_grid(rng) + rng.random((H, W, 5)).astype(np.float32) for _ in range(4)]
    hs = _homographies(rng, 4)
    want = np.asarray(j_stitching.stitch_image(frames, hs, log_odds_out=log_odds))
    got = stitching.stitch_image([torch.from_numpy(f) for f in frames], hs,
                                 log_odds_out=log_odds).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if log_odds:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)
    assert np.abs(got.astype(np.float64)).sum() > 0


def test_stitch_skips_the_last_frame(rng):
    """tests/test_mapping.py::TestStitching: with identity homographies the
    log-odds canvas is the sum of all frames but the last, and in the
    painter's mode a later frame overwrites an earlier one where it is
    non-black."""
    frames = [rng.random((20, 30, 5)).astype(np.float32) for _ in range(3)]
    eye = np.eye(3)
    out = stitching.stitch_image(frames, [eye, eye, eye], log_odds_out=True).numpy()
    np.testing.assert_allclose(out[:20, :30], frames[0] + frames[1], atol=1e-6)
    f0 = np.zeros((10, 10, 5), dtype=np.float32)
    f0[:, :, 0] = 1  # road everywhere
    f1 = np.zeros((10, 10, 5), dtype=np.float32)
    f1[:5, :, 2] = 1  # lane in the top half
    f2 = np.zeros((10, 10, 5), dtype=np.float32)
    f2[:, :, 3] = 1  # vegetation everywhere, but the last frame is not drawn
    out = stitching.stitch_image([f0, f1, f2], [eye, eye, eye], log_odds_out=False).numpy()
    np.testing.assert_array_equal(out[7, 3], LABEL_COLORS[0])
    np.testing.assert_array_equal(out[2, 3], LABEL_COLORS[2])
    np.testing.assert_array_equal(
        out, np.asarray(j_stitching.stitch_image([f0, f1, f2], [eye] * 3, log_odds_out=False)))

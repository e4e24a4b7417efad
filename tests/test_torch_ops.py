"""Port parity: ops (resize, filters, colormap) against the JAX package.

The same numpy inputs go through the JAX function and its PyTorch port on
the CPU; f32 results agree to 1e-6 (same matrices and op order, only the
matmul summation order may differ), integer results exactly.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from vision_semantic_segmentation_tpu.ops import colormap as jcolormap
from vision_semantic_segmentation_tpu.ops import filters as jfilters
from vision_semantic_segmentation_tpu.ops import resize as jresize
from vision_semantic_segmentation_tpu_torch.ops import colormap, filters, resize
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

ATOL = 1e-6


@pytest.fixture
def rng():
    """A fixed seed for each test, whatever else ran before it in the worker."""
    return np.random.default_rng(0)


class TestResize:
    @pytest.mark.parametrize("in_hw,out_hw", [((7, 9), (13, 17)), ((16, 12), (5, 4)), ((1, 1), (3, 5))])
    def test_align_corners(self, rng, in_hw, out_hw):
        x = rng.standard_normal((2, *in_hw, 3)).astype(np.float32)
        ref = np.asarray(jresize.resize_align_corners(jnp.asarray(x), out_hw))
        ours = resize.resize_align_corners(torch.from_numpy(x), out_hw).numpy()
        np.testing.assert_allclose(ours, ref, atol=ATOL)

    @pytest.mark.parametrize("in_hw,out_hw", [((48, 64), (18, 24)), ((37, 50), (11, 19))])
    def test_area_float(self, rng, in_hw, out_hw):
        x = rng.random((*in_hw, 3)).astype(np.float32)
        ref = np.asarray(jresize.resize_area(jnp.asarray(x), out_hw))
        ours = resize.resize_area(torch.from_numpy(x), out_hw).numpy()
        np.testing.assert_allclose(ours, ref, atol=ATOL)

    def test_area_uint8(self, rng):
        x = rng.integers(0, 256, (40, 60, 3), dtype=np.uint8)
        ref = np.asarray(jresize.resize_area(jnp.asarray(x), (15, 22)))
        ours = resize.resize_area(torch.from_numpy(x), (15, 22)).numpy()
        assert ours.dtype == np.uint8
        # both round the same f32 average, summed in another order: they
        # agree except where that average lies within f32 error of a .5 tie
        exact = np.asarray(jresize.resize_area(jnp.asarray(x, jnp.float32), (15, 22)))
        near_tie = np.abs(exact - np.floor(exact) - 0.5) < 1e-4
        np.testing.assert_array_equal(ours[~near_tie], ref[~near_tie])
        assert np.all(np.abs(ours.astype(np.float32) - exact) <= 0.5 + 1e-4)

    @pytest.mark.parametrize("shape", [(9, 11), (9, 11, 3)])
    def test_nearest(self, rng, shape):
        x = rng.integers(0, 19, shape).astype(np.int32)
        ref = np.asarray(jresize.resize_nearest(jnp.asarray(x), (20, 7)))
        ours = resize.resize_nearest(torch.from_numpy(x), (20, 7)).numpy()
        np.testing.assert_array_equal(ours, ref)


class TestFilters:
    @pytest.mark.parametrize("shape", [(10, 13), (10, 13, 5)])
    def test_box_filter_float(self, rng, shape):
        x = rng.random(shape).astype(np.float32)
        ref = np.asarray(jfilters.box_filter_3x3(jnp.asarray(x)))
        ours = filters.box_filter_3x3(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(ours, ref, atol=ATOL)

    def test_apply_filter_uint8(self, rng):
        x = rng.integers(0, 256, (12, 9, 3), dtype=np.uint8)
        ref = np.asarray(jfilters.apply_filter(jnp.asarray(x)))
        ours = filters.apply_filter(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(ours, ref)


class TestColormap:
    def test_apply_color_map(self, rng):
        labels = rng.integers(0, 19, (8, 10))
        palette = jcolormap.MAPILLARY_19_PALETTE
        ref = np.asarray(jcolormap.apply_color_map(jnp.asarray(labels), palette))
        ours = colormap.apply_color_map(torch.from_numpy(labels), palette).numpy()
        np.testing.assert_array_equal(ours, ref)

    def test_colors_to_labels(self, rng):
        palette = np.array([[128, 64, 128], [140, 140, 200], [255, 255, 255], [128, 64, 128]], np.uint8)
        idx = rng.integers(0, 5, (50,))
        rgb = np.where(idx[:, None] < 4, palette[np.minimum(idx, 3)], 17).astype(np.uint8)
        ref = np.asarray(jcolormap.colors_to_labels(jnp.asarray(rgb), palette, fill=-1))
        ours = colormap.colors_to_labels(torch.from_numpy(rgb), palette, fill=-1).numpy()
        np.testing.assert_array_equal(ours, ref)
        assert (ours == -1).any() and (ours == 0).any()  # duplicate colour: first wins

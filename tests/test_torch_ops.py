"""Port parity: ops (resize, filters, colormap) against the JAX package.

The same numpy inputs go through the JAX function and its PyTorch port on
the CPU; f32 results agree to 1e-6 (same matrices and op order, only the
matmul summation order may differ), integer results exactly.  The resizes
read their matrices from a device cache (``resize._device_matrix``): one
tensor a key, built once, counted by ``resize.matrix_cache_info()``.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch
from torch.profiler import ProfilerActivity, profile

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


ALIGN_SHAPES = [((7, 9), (13, 17)), ((16, 12), (5, 4)), ((1, 1), (3, 5))]
AREA_SHAPES = [((48, 64), (18, 24)), ((37, 50), (11, 19)), ((40, 60), (15, 22))]
CPU = torch.device("cpu")


@pytest.fixture
def cold_cache():
    """An empty matrix cache, so the counts start at zero."""
    resize._device_matrix.cache_clear()
    yield
    resize._device_matrix.cache_clear()


class TestMatrixCache:
    """Every resize shape above, through the device cache: JAX parity, one
    upload a (kind, in, out, device) and a hit a later lookup."""

    @pytest.mark.parametrize("kind,in_hw,out_hw",
                             [("align_corners", *s) for s in ALIGN_SHAPES]
                             + [("area", *s) for s in AREA_SHAPES])
    def test_resize_through_the_cache(self, rng, cold_cache, kind, in_hw, out_hw):
        x = rng.random((2, *in_hw, 3)).astype(np.float32)
        ours_fn, ref_fn = {"align_corners": (resize.resize_align_corners,
                                             jresize.resize_align_corners),
                           "area": (resize.resize_area, jresize.resize_area)}[kind]
        keys = {(in_hw[0], out_hw[0]), (in_hw[1], out_hw[1])}
        first = ours_fn(torch.from_numpy(x), out_hw)
        assert resize.matrix_cache_info() == (2 - len(keys), len(keys))
        again = ours_fn(torch.from_numpy(x), out_hw)
        assert resize.matrix_cache_info() == (4 - len(keys), len(keys))
        np.testing.assert_array_equal(again.numpy(), first.numpy())
        np.testing.assert_allclose(first.numpy(), np.asarray(ref_fn(jnp.asarray(x), out_hw)),
                                   atol=ATOL)
        build = {"align_corners": resize._align_corners_matrix, "area": resize._area_matrix}[kind]
        for i, o in keys:
            m = resize._device_matrix(kind, i, o, CPU)
            assert m is resize._device_matrix(kind, i, o, CPU)
            assert m.dtype == torch.float32 and m.device == CPU
            # on the CPU the cached tensor is a view of the host matrix
            assert np.shares_memory(m.numpy(), build(i, o))

    def test_kinds_and_devices_are_separate_keys(self, cold_cache):
        a = resize._device_matrix("align_corners", 9, 4, CPU)
        b = resize._device_matrix("area", 9, 4, CPU)
        assert a is not b and not torch.equal(a, b)
        assert resize.matrix_cache_info() == (0, 2)

    def test_upload_span_only_on_the_first_lookup(self, rng, cold_cache):
        x = torch.from_numpy(rng.random((1, 6, 8, 2)).astype(np.float32))
        counts = []
        for _ in range(2):
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                resize.resize_align_corners(x, (11, 15))
            counts.append(sum(e.count for e in prof.key_averages() if e.key == "resize.upload"))
        assert counts == [2, 0]


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

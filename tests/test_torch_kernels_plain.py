"""Port parity: each kernel's plain PyTorch version against its TPU kernel.

The Pallas kernels run in interpret mode on the CPU, as the JAX package's
own tests run them.  The CUDA kernels themselves run only on a card; their
check against these plain versions is a phase of ``chip_smoke.py``.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from vision_semantic_segmentation_tpu.mapping.renderer import (
    LABEL_COLORS,
    apply_filter,
    render_bev_map,
)
from vision_semantic_segmentation_tpu.ops.pallas.depthwise import depthwise3x3_dilated as j_depthwise
from vision_semantic_segmentation_tpu.ops.pallas.fold import evidence_fold_add as j_fold
from vision_semantic_segmentation_tpu.ops.pallas.render import (
    render_bev_map_fused as j_render,
    unpack_rgba_image as j_unpack,
)
from vision_semantic_segmentation_tpu_torch.ops.kernels import (
    depthwise3x3_dilated,
    evidence_fold_add_,
    render_bev_map_fused,
    unpack_rgba_image,
)


@pytest.fixture
def rng():
    """A fixed seed for each test, whatever else ran before it in the worker."""
    return np.random.default_rng(0)


def _grid(rng, h, w, c=5):
    grid = rng.random((c, h, w)).astype(np.float32)
    grid[:, rng.random((h, w)) < 0.3] = 0.0  # unexplored cells
    return grid


class TestRender:
    @pytest.mark.parametrize("shape", [(64, 128), (37, 53)])
    def test_plain_matches_pallas_exactly(self, rng, shape):
        grid = _grid(rng, *shape)
        ref = np.asarray(j_render(jnp.asarray(grid), LABEL_COLORS, tile_h=16, interpret=True))
        ours = render_bev_map_fused(torch.from_numpy(grid), LABEL_COLORS).numpy()
        np.testing.assert_array_equal(ours.view(np.uint32), ref)
        np.testing.assert_array_equal(
            unpack_rgba_image(torch.from_numpy(ours)).numpy(), np.asarray(j_unpack(jnp.asarray(ref)))
        )

    def test_plain_matches_unfused_render(self, rng):
        grid = _grid(rng, 100, 200)
        ours = unpack_rgba_image(render_bev_map_fused(torch.from_numpy(grid), LABEL_COLORS)).numpy()
        hwc = jnp.asarray(np.moveaxis(grid, 0, -1))
        ref = np.asarray(render_bev_map(apply_filter(hwc), LABEL_COLORS))
        mismatch = (ours != ref).any(axis=-1).mean()
        # the unfused path's nine-shifted-add order can flip near-tie argmaxes
        assert mismatch < 2e-3, f"mismatch {mismatch:.5f}"

    def test_zero_grid_black(self):
        packed = render_bev_map_fused(torch.zeros((5, 32, 64)), LABEL_COLORS)
        assert int(packed.abs().sum()) == 0

    def test_rejects_bad_input(self):
        with pytest.raises(ValueError):
            render_bev_map_fused(torch.zeros((4, 8, 8)), LABEL_COLORS)
        with pytest.raises(ValueError):
            render_bev_map_fused(torch.zeros((5, 8, 8), dtype=torch.float64), LABEL_COLORS)


class TestFold:
    @pytest.mark.parametrize("shape", [(5, 64, 128), (3, 17, 23)])
    def test_plain_matches_pallas(self, rng, shape):
        grid = rng.standard_normal(shape).astype(np.float32)
        obs = (rng.random(shape) < 0.2).astype(np.float32)
        e = rng.standard_normal((shape[0], shape[0])).astype(np.float32)
        ref = np.asarray(j_fold(jnp.asarray(grid), jnp.asarray(obs), e, interpret=True))
        g = torch.from_numpy(grid.copy())
        out = evidence_fold_add_(g, torch.from_numpy(obs), e)
        assert out is g  # in place
        np.testing.assert_allclose(g.numpy(), ref, atol=1e-5)


class TestDepthwise:
    @pytest.mark.parametrize("dilation", [1, 3, 6])
    def test_plain_matches_pallas(self, dilation):
        rng = np.random.default_rng(7 + dilation)
        h, w, c = 12, 16, 128
        x = rng.standard_normal((1, h, w, c)).astype(np.float32)
        k = rng.standard_normal((3, 3, 1, c)).astype(np.float32)
        ref = np.asarray(j_depthwise(jnp.asarray(x), jnp.asarray(k), dilation, interpret=True))
        ours = depthwise3x3_dilated(torch.from_numpy(x), torch.from_numpy(k), dilation).numpy()
        np.testing.assert_allclose(ours, ref, atol=1e-5)

    def test_bf16_accumulates_in_f32(self):
        rng = np.random.default_rng(3)
        x = rng.standard_normal((1, 9, 10, 24)).astype(np.float32)
        k = rng.standard_normal((3, 3, 1, 24)).astype(np.float32)
        xb = torch.from_numpy(x).to(torch.bfloat16)
        ours = depthwise3x3_dilated(xb, torch.from_numpy(k), 2)
        assert ours.dtype == torch.bfloat16
        # f32 sums of the bf16 inputs, rounded once
        f32 = depthwise3x3_dilated(xb.float(), torch.from_numpy(k), 2)
        torch.testing.assert_close(ours, f32.to(torch.bfloat16), rtol=0, atol=0)
        ref = jax.lax.conv_general_dilated(
            jnp.asarray(xb.float().numpy()), jnp.asarray(k), (1, 1), ((2, 2), (2, 2)),
            rhs_dilation=(2, 2), dimension_numbers=("NHWC", "HWIO", "NHWC"),
            feature_group_count=24,
        )
        np.testing.assert_allclose(f32.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("call", [
    lambda t: render_bev_map_fused(t, LABEL_COLORS),
    lambda t: evidence_fold_add_(t, t, np.eye(5, dtype=np.float32)),
    lambda t: depthwise3x3_dilated(t.view(1, 5, 8, 8), torch.zeros((3, 3, 1, 8), device="meta"), 2),
], ids=["render", "fold", "depthwise"])
def test_wrappers_take_plain_version_only_on_cpu(call):
    """A tensor on neither the CPU nor a card is refused: no silent fallback."""
    with pytest.raises(ValueError, match="unsupported device"):
        call(torch.zeros((5, 8, 8), device="meta"))

"""Port parity: each kernel's plain PyTorch version against its TPU kernel.

The Pallas kernels run in interpret mode on the CPU, as the JAX package's
own tests run them.  The CUDA kernels themselves run only on a card; their
check against these plain versions is a phase of ``chip_smoke.py``.

K4 and P1/P2 are held bit for bit.  XLA's CPU backend contracts a multiply
and an add into one FMA where the host has FMA instructions, which changes
the last bit of an f32 sum; the plain versions (like the CUDA kernels) round
every product and every sum.  So their Pallas references run in a
subprocess with ``--xla_cpu_max_isa=SSE4_2``, where XLA has no FMA to use.
"""
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

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
    aspp_depthwise3x3_multi,
    aspp_depthwise3x3_multi_plain,
    depthwise3x3_dilated,
    depthwise3x3_dilated_plain,
    evidence_fold_add_,
    hoisted,
    hoisted_plain,
    hoisted_variant,
    render_bev_map_fused,
    unpack_rgba_image,
)
from vision_semantic_segmentation_tpu_torch.ops.kernels._lib import refuse_grad

REPO = Path(__file__).resolve().parents[1]


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


# (name, shape, dilations): the shapes of tests/test_pallas.py's K4 tests
K4_CASES = [("k4_a", (1, 20, 28, 256), (2, 4, 6)), ("k4_b", (1, 14, 18, 128), (1, 3, 5))]
# hoist_c: a dilation beyond 56, with a few rows and columns of taps inside the image
HOIST_CASES = [("hoist_a", (1, 12, 20, 128), 2), ("hoist_b", (1, 14, 18, 128), 3),
               ("hoist_c", (1, 66, 72, 128), 64)]
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}

_PALLAS_REFS = r"""
import functools, importlib.util, json, sys
import numpy as np
import jax
import jax.numpy as jnp
jax.config.update("jax_platforms", "cpu")
from jax.experimental import pallas
from vision_semantic_segmentation_tpu.ops.pallas.depthwise import aspp_depthwise3x3_multi

inputs, cases, out_path = np.load(sys.argv[1]), json.loads(sys.argv[2]), sys.argv[3]
saved = (jax.config.jax_compilation_cache_dir,
         jax.config.jax_persistent_cache_min_compile_time_secs)
spec = importlib.util.spec_from_file_location("probe", "scripts/probe_depthwise_hoist.py")
probe = importlib.util.module_from_spec(spec)
spec.loader.exec_module(probe)  # sets the two config values below at import
jax.config.update("jax_compilation_cache_dir", saved[0])
jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])
# the probes have no interpret argument
pallas.pallas_call = functools.partial(pallas.pallas_call, interpret=True)

out = {}
for name, kind, dilations in cases:
    x, ks = inputs[name + "_x"], inputs[name + "_k"]
    for dt, jdt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        xj = jnp.asarray(x).astype(jdt)
        if kind == "k4":
            res = aspp_depthwise3x3_multi(xj, [jnp.asarray(k) for k in ks], dilations,
                                          interpret=True)
            for b, r in enumerate(res):
                out[f"{name}_{dt}_{b}"] = np.asarray(r.astype(jnp.float32))
        else:
            k, d = jnp.asarray(ks[0]), dilations[0]
            res = {"hoisted": probe.hoisted(xj, k, d, 8),
                   "f32col": probe.hoisted_variant(xj, k, d, 8, "f32col"),
                   "slab": probe.hoisted_variant(xj, k, d, 8, "slab")}
            for v, r in res.items():
                out[f"{name}_{dt}_{v}"] = np.asarray(r.astype(jnp.float32))
np.savez(out_path, **out)
"""


@pytest.fixture(scope="module")
def pallas_refs(tmp_path_factory):
    """Inputs of the K4 and P1/P2 cases, and their Pallas outputs (interpret
    mode, no FMA), computed in one subprocess."""
    rng = np.random.default_rng(11)
    tmp = tmp_path_factory.mktemp("pallas_refs")
    inputs, cases = {}, []
    for name, shape, dilations in K4_CASES:
        inputs[name + "_x"] = rng.standard_normal(shape).astype(np.float32)
        inputs[name + "_k"] = rng.standard_normal((len(dilations), 3, 3, 1, shape[-1])).astype(np.float32)
        cases.append((name, "k4", list(dilations)))
    for name, shape, d in HOIST_CASES:
        inputs[name + "_x"] = rng.standard_normal(shape).astype(np.float32)
        inputs[name + "_k"] = rng.standard_normal((1, 3, 3, 1, shape[-1])).astype(np.float32)
        cases.append((name, "hoist", [d]))
    np.savez(tmp / "in.npz", **inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=SSE4_2",
               PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    subprocess.run([sys.executable, "-c", _PALLAS_REFS, str(tmp / "in.npz"), json.dumps(cases),
                    str(tmp / "out.npz")], cwd=REPO, env=env, check=True, timeout=300)
    with np.load(tmp / "out.npz") as out:
        return inputs, dict(out)


class TestAsppMulti:
    @pytest.mark.parametrize("dt", DTYPES)
    @pytest.mark.parametrize("name,shape,dilations", K4_CASES)
    def test_plain_matches_pallas_bit_for_bit(self, pallas_refs, name, shape, dilations, dt):
        inputs, refs = pallas_refs
        x = torch.from_numpy(inputs[name + "_x"]).to(DTYPES[dt])
        kernels = [torch.from_numpy(k) for k in inputs[name + "_k"]]
        outs = aspp_depthwise3x3_multi(x, kernels, list(dilations))
        assert len(outs) == len(dilations)
        for b, (out, kernel, d) in enumerate(zip(outs, kernels, dilations)):
            assert out.dtype == DTYPES[dt] and out.shape == shape
            np.testing.assert_array_equal(out.float().numpy(), refs[f"{name}_{dt}_{b}"])
            # each branch is K3's plain version, bit for bit
            k3 = depthwise3x3_dilated_plain(x, kernel.reshape(9, -1), d)
            torch.testing.assert_close(out, k3, rtol=0, atol=0)

    def test_plain_is_k3_plain_per_branch(self):
        rng = np.random.default_rng(4)
        x = torch.from_numpy(rng.standard_normal((1, 9, 13, 24)).astype(np.float32))
        w9s = torch.from_numpy(rng.standard_normal((3, 9, 24)).astype(np.float32))
        outs = aspp_depthwise3x3_multi_plain(x, w9s, [1, 2, 7])
        for out, w9, d in zip(outs, w9s, [1, 2, 7]):
            torch.testing.assert_close(out, depthwise3x3_dilated_plain(x, w9, d), rtol=0, atol=0)

    def test_rejects_bad_branches(self):
        x = torch.zeros((1, 4, 4, 8))
        k = torch.zeros((3, 3, 1, 8))
        with pytest.raises(ValueError):
            aspp_depthwise3x3_multi(x, [k], [1, 2])
        with pytest.raises(ValueError):
            aspp_depthwise3x3_multi(x, [k] * 9, list(range(1, 10)))


class TestHoisted:
    @pytest.mark.parametrize("dt", DTYPES)
    @pytest.mark.parametrize("name,shape,dilation", HOIST_CASES)
    def test_plain_matches_probes_bit_for_bit(self, pallas_refs, name, shape, dilation, dt):
        inputs, refs = pallas_refs
        x = torch.from_numpy(inputs[name + "_x"]).to(DTYPES[dt])
        kernel = torch.from_numpy(inputs[name + "_k"][0])
        want = hoisted_plain(x, kernel.reshape(9, -1), dilation)
        outs = {"hoisted": hoisted(x, kernel, dilation),
                "f32col": hoisted_variant(x, kernel, dilation, "f32col"),
                "slab": hoisted_variant(x, kernel, dilation, "slab")}
        for variant, out in outs.items():
            assert out.dtype == DTYPES[dt] and out.shape == shape
            torch.testing.assert_close(out, want, rtol=0, atol=0)
            np.testing.assert_array_equal(out.float().numpy(), refs[f"{name}_{dt}_{variant}"])

    def test_column_major_sum_differs_from_k3_by_order_only(self):
        rng = np.random.default_rng(6)
        x = torch.from_numpy(rng.standard_normal((1, 12, 20, 128)).astype(np.float32))
        w9 = torch.from_numpy(rng.standard_normal((9, 128)).astype(np.float32))
        a, b = hoisted_plain(x, w9, 2), depthwise3x3_dilated_plain(x, w9, 2)
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
        assert not torch.equal(a, b)

    def test_rejects_unknown_kind(self):
        with pytest.raises(ValueError, match="kind"):
            hoisted_variant(torch.zeros((1, 4, 4, 8)), torch.zeros((3, 3, 1, 8)), 1, "rows")


class TestRefuseGrad:
    """On the kernel route a wrapper refuses an input that needs a gradient,
    instead of returning an output cut from the autograd graph."""

    KERNEL = SimpleNamespace(name="grad_probe")  # refuse_grad reads only the name

    def test_raises_when_grad_is_needed(self):
        w = torch.zeros(3, requires_grad=True)
        with pytest.raises(RuntimeError, match="grad_probe.*no backward"):
            refuse_grad(self.KERNEL, torch.zeros(3), w)

    def test_passes_without_grad(self):
        w = torch.zeros(3, requires_grad=True)
        refuse_grad(self.KERNEL, torch.zeros(3), torch.zeros(3))
        with torch.no_grad():
            refuse_grad(self.KERNEL, w)
        with torch.inference_mode():
            refuse_grad(self.KERNEL, torch.zeros(3))

    def test_plain_route_keeps_the_graph(self):
        """On the CPU the plain version runs, and gradients flow through it."""
        kernel = torch.randn((3, 3, 1, 8), requires_grad=True)
        outs = aspp_depthwise3x3_multi(torch.randn((1, 5, 6, 8)), [kernel, kernel], [1, 2])
        sum(o.sum() for o in outs).backward()
        assert kernel.grad is not None and kernel.grad.abs().sum() > 0


@pytest.mark.parametrize("call", [
    lambda t: render_bev_map_fused(t, LABEL_COLORS),
    lambda t: evidence_fold_add_(t, t, np.eye(5, dtype=np.float32)),
    lambda t: depthwise3x3_dilated(t.view(1, 5, 8, 8), torch.zeros((3, 3, 1, 8), device="meta"), 2),
    lambda t: aspp_depthwise3x3_multi(t.view(1, 5, 8, 8), [torch.zeros((3, 3, 1, 8))] * 2, [1, 2]),
    lambda t: hoisted(t.view(1, 5, 8, 8), torch.zeros((3, 3, 1, 8)), 2),
    lambda t: hoisted_variant(t.view(1, 5, 8, 8), torch.zeros((3, 3, 1, 8)), 2, "slab"),
], ids=["render", "fold", "depthwise", "aspp_multi", "hoisted", "hoisted_slab"])
def test_wrappers_take_plain_version_only_on_cpu(call):
    """A tensor on neither the CPU nor a card is refused: no silent fallback."""
    with pytest.raises(ValueError, match="unsupported device"):
        call(torch.zeros((5, 8, 8), device="meta"))

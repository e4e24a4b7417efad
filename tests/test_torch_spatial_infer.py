"""Port parity: the spatially sharded (row-banded) forward and predictor.

Counterparts of ``tests/test_spatial_infer.py`` (each test there has one
here, same name, at its tolerance) on the port's logical shards of the CPU
(``["cpu"] * k``), with the JAX package's ``small_net`` variables crossed
through ``flax_to_state_dict``: the port's banded logits against the JAX
package's single-device forward (1e-4 absolute, 1e-5 relative, as the JAX
test holds GSPMD's), the banded labels equal to the port's unbanded ones,
the predictor's labels equal and its confidence within 1e-5.

Then the port-only forms one by one: uneven bands, halos that span several
bands, the stride-2 phase at a band edge, K4's and Q1's plain versions
banded (bit for bit: each output pixel sums the same taps in the same
order), the align-corners resize, ASPP's image pooling, the dropout mask
and training BatchNorm against their unbanded forms, the refusal of a
module with no banded form, and replicas on two distinct devices.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from vision_semantic_segmentation_tpu.config import get_demo_cfg_defaults as j_demo_cfg
from vision_semantic_segmentation_tpu.models import deeplab_from_cfg as j_deeplab_from_cfg
from vision_semantic_segmentation_tpu_torch.config import get_demo_cfg_defaults
from vision_semantic_segmentation_tpu_torch.inference.predictor import SemanticSegmentation
from vision_semantic_segmentation_tpu_torch.models import build_model, flax_to_state_dict
from vision_semantic_segmentation_tpu_torch.models.aspp import ASPP
from vision_semantic_segmentation_tpu_torch.models.layers import BatchNorm2d, DepthwiseConv2d, depthwise_convs
from vision_semantic_segmentation_tpu_torch.models.resize import resize_nchw
from vision_semantic_segmentation_tpu_torch.ops.kernels.int8_conv import int8_conv3x3
from vision_semantic_segmentation_tpu_torch.parallel import (
    Bands,
    SpatialModel,
    create_mesh,
    make_spatial_forward,
    replicate_variables,
    shard_image,
)
from vision_semantic_segmentation_tpu_torch.parallel import spatial_infer
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)


def _narrow(cfg):
    cfg.MODEL.TYPE = "DeepLabv3+"
    cfg.DATASET.NUM_CLASSES = 7
    cfg.MODEL.BACKBONE = "resnet18"
    cfg.MODEL.OUTPUT_STRIDE = 16
    cfg.MODEL.ASPP.OUT_CHANNELS = 16
    cfg.MODEL.ASPP.ATROUS_CHANNELS = [16, 16, 16, 16]
    cfg.MODEL.DECODER.LOW_LEVEL_OUT_CHANNELS = 8
    cfg.MODEL.DECODER.REFINE_CHANNELS = [16, 16]
    return cfg


@pytest.fixture(scope="module")
def small_net():
    """The JAX test's network and variables, the port's model loaded from
    them, and the JAX single-device logits of one image (module-scoped:
    each JAX program compiles once)."""
    jmodel = j_deeplab_from_cfg(_narrow(j_demo_cfg()))
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32),
                            train=False)
    variables = jax.tree.map(np.asarray, dict(variables))
    model = build_model(_narrow(get_demo_cfg_defaults()), device="cpu")
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    image = np.random.default_rng(0).standard_normal((1, 128, 96, 3)).astype(np.float32)
    apply = jax.jit(jmodel.apply, static_argnames=("train", "upsample_pred"))
    ref = {up: np.asarray(apply(variables, image, train=False, upsample_pred=up))
           for up in (False, True)}
    return model, variables, image, ref


def _mesh(k, devices=None):
    return create_mesh(axis_names=("grid",), devices=devices or ["cpu"] * k)


def _port_logits(model, image, upsample_pred):
    x = torch.from_numpy(image).permute(0, 3, 1, 2)
    with torch.no_grad():
        return model(x, upsample_pred=upsample_pred)


class TestSpatialForward:
    def test_matches_single_device(self, small_net):
        """Banded logits (8 bands of the 8-row OS16 map) against the JAX
        single-device forward, at the JAX test's tolerance."""
        model, _, image, ref = small_net
        mesh = _mesh(8)
        fwd = make_spatial_forward(model, mesh, axis="grid", argmax=False)
        out = fwd(replicate_variables(mesh, model), shard_image(mesh, image))
        got = out.permute(0, 2, 3, 1).numpy()
        assert got.shape == ref[False].shape
        np.testing.assert_allclose(got, ref[False], atol=1e-4, rtol=1e-5)

    def test_output_stays_row_sharded(self, small_net):
        """With upsample_pred the result stays banded: each shard holds its
        16 rows (the pieces in mesh order, as JAX's addressable_shards)."""
        model, _, _, _ = small_net
        mesh = _mesh(8)
        fwd = make_spatial_forward(model, mesh, axis="grid", upsample_pred=True, argmax=True)
        image = np.zeros((1, 128, 96, 3), np.float32)
        out = fwd(replicate_variables(mesh, model), shard_image(mesh, image))
        assert isinstance(out, Bands) and out.shards[0].dtype == torch.int32
        assert {tuple(s.shape) for s in out.shards} == {(1, 128 // 8, 96)}
        assert len(out.shards) == 8

    def test_upsample_pred_and_argmax(self, small_net):
        """The banded align-corners upsample and argmax: labels equal to the
        port's unbanded ones and to the JAX forward's."""
        model, _, image, ref = small_net
        mesh = _mesh(8)
        fwd = make_spatial_forward(model, mesh, axis="grid", upsample_pred=True, argmax=True)
        out = fwd(replicate_variables(mesh, model), shard_image(mesh, image)).gather()
        assert tuple(out.shape) == (1, 128, 96)
        want = _port_logits(model, image, True).argmax(1)
        np.testing.assert_array_equal(out.numpy(), want.numpy())
        np.testing.assert_array_equal(out.numpy(), np.argmax(ref[True], axis=-1))

    def test_submesh_four_devices(self, small_net):
        """A mesh of 4 shards (half of the JAX test's slice)."""
        model, _, image, ref = small_net
        mesh = _mesh(4)
        fwd = make_spatial_forward(model, mesh, axis="grid", argmax=False)
        out = fwd(replicate_variables(mesh, model), shard_image(mesh, image))
        np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref[False], atol=1e-4,
                                   rtol=1e-5)


class TestPredictorSpatialShards:
    """MODEL.SPATIAL_SHARDS through SemanticSegmentation: labels equal to the
    unsharded predictor's, the confidence within 1e-5."""

    def _cfg(self, shards=0):
        cfg = _narrow(get_demo_cfg_defaults())
        cfg.MODEL.TYPE = "DeepLabv3+"
        cfg.MODEL.COMPUTE_DTYPE = "float32"
        cfg.MODEL.SPATIAL_SHARDS = shards
        return cfg

    def _pair(self, small_net):
        _, variables, _, _ = small_net
        base = SemanticSegmentation(self._cfg(), variables=variables, device="cpu")
        sharded = SemanticSegmentation(self._cfg(4), variables=variables, device="cpu",
                                       devices=["cpu"] * 4)
        return base, sharded

    def test_matches_single_device_predictor(self, small_net):
        base, sharded = self._pair(small_net)
        assert sharded._mesh is not None and sharded._mesh.size == 4
        image = (np.random.default_rng(1).random((128, 96, 3)) * 255).astype(np.uint8)
        for up in (True, False):
            ref = base.segmentation(image, upsample_pred=up)
            out = sharded.segmentation(image, upsample_pred=up)
            assert out.shape == ref.shape
            np.testing.assert_array_equal(out, ref)
        ref_lab, ref_conf = base.segmentation_with_confidence(image)
        lab, conf = sharded.segmentation_with_confidence(image)
        np.testing.assert_array_equal(lab, ref_lab)
        np.testing.assert_allclose(conf, ref_conf, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(sharded.logits(image).numpy(), base.logits(image).numpy(),
                                   atol=1e-4, rtol=1e-5)

    def test_too_few_devices_raises(self, small_net):
        _, variables, _, _ = small_net
        with pytest.raises(ValueError, match="devices"):
            SemanticSegmentation(self._cfg(99), variables=variables, device="cpu")
        with pytest.raises(ValueError, match="devices"):
            SemanticSegmentation(self._cfg(4), variables=variables, device="cpu",
                                 devices=["cpu"] * 3)

    def test_composes_with_int8_qpack(self, small_net):
        """MODEL.SPATIAL_SHARDS x int8: Q1's plain version on halo-extended
        bands and ``_int_mm`` per band, labels equal to the unsharded int8
        predictor's."""
        base, sharded = self._pair(small_net)
        rng = np.random.default_rng(2)
        image = (rng.random((128, 96, 3)) * 255).astype(np.uint8)
        calib = [(rng.random((128, 96, 3)) * 255).astype(np.uint8) for _ in range(2)]
        base.quantize(calib)
        sharded.quantize(calib)
        assert set(sharded._spatial.qbackbones) == {torch.device("cpu")}
        np.testing.assert_array_equal(sharded.segmentation(image), base.segmentation(image))


# -- port-only forms ---------------------------------------------------------------
def _bands(x, k, dim=2, devices=None):
    return Bands.split(x, [devices or [torch.device("cpu")] * k], dim)


@pytest.mark.parametrize("shards", [3, 5, 7])
def test_uneven_bands(small_net, shards):
    """Row counts that do not divide: 128 rows (OS16 map 8, decoder 28) over
    3, 5 and 7 bands differing by at most one row."""
    model, _, image, ref = small_net
    sizes = [b - a for a, b in spatial_infer.row_bounds(8, shards)]
    assert sum(sizes) == 8 and max(sizes) - min(sizes) == 1 and min(sizes) >= 1
    mesh = _mesh(shards)
    fwd = make_spatial_forward(model, mesh, argmax=False)
    out = fwd(replicate_variables(mesh, model), image)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref[False], atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(out.numpy(), _port_logits(model, image, False).numpy(),
                               atol=1e-5, rtol=1e-5)


def test_row_bounds():
    assert spatial_infer.row_bounds(180, 8) == [(0, 23), (23, 46), (46, 69), (69, 92),
                                                (92, 114), (114, 136), (136, 158), (158, 180)]
    assert spatial_infer.k4_rows(180, 4, (12, 24, 36)) == [81, 117, 117, 81]
    with pytest.raises(ValueError, match="empty"):
        _bands(torch.zeros(1, 2, 3, 4), 4)


@pytest.mark.parametrize("shards,dilations", [(8, (12, 24, 36)), (4, (6, 12, 18)), (3, (2,))],
                         ids=["8x1row_d36", "4_d18", "3_k3"])
def test_banded_k4_plain_bit_equal(shards, dilations):
    """K4's (and for one branch K3's) plain version on halo-extended bands
    equals the unbanded call bit for bit; at 8 bands of a 10-row map the
    halo of dilation 36 spans every band."""
    gen = torch.Generator().manual_seed(3)
    c = 8
    x = torch.randn(1, c, 10, 13, generator=gen).contiguous(memory_format=torch.channels_last)
    convs = [DepthwiseConv2d(c, c, 3, padding=d, dilation=d, groups=c, bias=False)
             for d in dilations]
    for conv in convs:
        nn.init.normal_(conv.weight, generator=gen)
    dmax = max(dilations)
    with torch.no_grad():
        want = depthwise_convs(convs, x)
        got = spatial_infer._window(_bands(x, shards), lambda t, dev: depthwise_convs(convs, t),
                                    3, 1, dmax, dmax)
    for w, g in zip(want, got):
        assert torch.equal(g.gather(), w)


@pytest.mark.parametrize("module", [
    nn.Conv2d(4, 6, 3, stride=2, padding=1, bias=False),
    nn.Conv2d(4, 6, 7, stride=2, padding=3, bias=False),
    nn.Conv2d(4, 4, 3, stride=2, padding=2, dilation=2, groups=2, bias=False),
    nn.MaxPool2d(3, stride=2, padding=1),
    nn.Conv2d(4, 6, 1, stride=2, bias=False),
], ids=["conv3_s2", "conv7_s2", "grouped_d2_s2", "maxpool", "conv1_s2"])
def test_stride2_phase_at_band_edges(module):
    """23 rows over 4 bands (6, 6, 6, 5): the strided window's first output
    row of each band lands on the right input row (odd band starts)."""
    torch.manual_seed(4)
    x = torch.randn(2, 4, 23, 9).contiguous(memory_format=torch.channels_last)
    engine = SpatialModel(nn.Sequential(module), _mesh(4))
    with torch.no_grad():
        want = module(x)
        got = engine.module(module, _bands(x, 4)).gather()
    if isinstance(module, nn.MaxPool2d):
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("stride,dilation", [(2, 1), (2, 2), (1, 4)])
def test_banded_q1_plain(stride, dilation):
    """Q1's plain version on halo-extended bands at stride 2 (rows
    ``ceil(p / s) * s`` prepended, ``ceil(p / s)`` output rows cropped),
    equal to the unbanded call."""
    gen = torch.Generator().manual_seed(5)
    x = torch.randint(-127, 128, (1, 21, 11, 8), generator=gen, dtype=torch.int8)
    w = torch.randint(-127, 128, (8, 3, 3, 4), generator=gen, dtype=torch.int8)
    scale = torch.rand(8, generator=gen) * 1e-3
    shift = torch.randn(8, generator=gen)

    def call(t, dev):
        return int8_conv3x3(t, w, scale, shift, stride, dilation, dilation, 2, torch.int8, True)

    want = call(x, None)
    got = spatial_infer._window(_bands(x, 4, dim=1), call, 3, stride, dilation, dilation)
    assert torch.equal(got.gather(), want)


def test_banded_resize():
    """The align-corners resize: each band fetches the source rows its rows
    of the matrix touch (up 9 -> 37 and down 37 -> 9 rows)."""
    torch.manual_seed(6)
    for h, out in ((9, (37, 20)), (37, (9, 5)), (12, (12, 7))):
        x = torch.randn(2, 3, h, 11).contiguous(memory_format=torch.channels_last)
        got = spatial_infer._resize_rows(_bands(x, 4 if h > 4 else 3), out).gather()
        torch.testing.assert_close(got, resize_nchw(x, out), atol=1e-6, rtol=1e-6)


def test_banded_image_pooling():
    """ASPP's image pooling: band sums added in band order over H x W, the
    1x1 ConvBNReLU on the pooled vector, the constant upsample per band."""
    torch.manual_seed(7)
    aspp = ASPP(16, 8, (8, 8, 8, 8), (1, 3, 3, 3), (1, 2, 3, 4), 0.0).eval()
    x = torch.randn(2, 16, 11, 7).contiguous(memory_format=torch.channels_last)
    engine = SpatialModel(aspp, _mesh(4))
    with torch.no_grad():
        want = resize_nchw(aspp.global_avg_pool(x), (11, 7))
        got = engine.image_pool(aspp, _bands(x, 4), _bands(x, 4)).gather()
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(engine.aspp(aspp, _bands(x, 4)).gather(), aspp(x),
                                   atol=1e-6, rtol=1e-6)


def test_banded_dropout_mask():
    """The dropout mask is drawn for the whole tensor, as the unbanded
    module draws it, and sliced per band: equal outputs from one seed."""
    drop = nn.Dropout(0.5).train()
    x = torch.randn(2, 6, 13, 5).contiguous(memory_format=torch.channels_last)
    engine = SpatialModel(nn.Sequential(nn.Conv2d(1, 1, 1)), _mesh(4))
    torch.manual_seed(8)
    want = drop(x)
    torch.manual_seed(8)
    got = engine.dropout(drop, _bands(x, 4)).gather()
    assert torch.equal(got, want)


def test_banded_batchnorm_statistics():
    """Training BatchNorm over every band and data shard: the output, the
    running statistics (flax's biased variance, updated once) and the
    gradients against the unbanded ``BatchNorm2d`` in f64."""
    torch.manual_seed(9)
    bn = BatchNorm2d(5).double().train()
    nn.init.normal_(bn.weight)
    nn.init.normal_(bn.bias)
    ref = BatchNorm2d(5).double().train()
    ref.load_state_dict(bn.state_dict())
    x = torch.randn(4, 5, 9, 6, dtype=torch.float64, requires_grad=True)
    dy = torch.randn(4, 5, 9, 6, dtype=torch.float64)
    want = ref(x)
    (want * dy).sum().backward()
    mesh = create_mesh((2, 3), ("data", "spatial"), devices=["cpu"] * 6)
    engine = SpatialModel(nn.Sequential(bn), mesh, spatial_axis="spatial", data_axis="data")
    xb = x.detach().clone().requires_grad_(True)
    got = engine.batch_norm(bn, Bands.split(xb, engine.groups, 2)).gather()
    (got * dy).sum().backward()
    torch.testing.assert_close(got, want, atol=1e-12, rtol=1e-10)
    torch.testing.assert_close(bn.running_mean, ref.running_mean, atol=1e-12, rtol=1e-10)
    torch.testing.assert_close(bn.running_var, ref.running_var, atol=1e-12, rtol=1e-10)
    assert int(bn.num_batches_tracked) == 1
    torch.testing.assert_close(xb.grad, x.grad, atol=1e-12, rtol=1e-10)
    torch.testing.assert_close(bn.weight.grad, ref.weight.grad, atol=1e-12, rtol=1e-10)
    torch.testing.assert_close(bn.bias.grad, ref.bias.grad, atol=1e-12, rtol=1e-10)


def test_module_without_banded_form_raises():
    """A module type with no banded form raises, naming it; nothing
    gathers the image onto one device."""
    model = nn.Sequential(nn.Conv2d(3, 4, 3, padding=1), nn.Upsample(scale_factor=2))
    engine = SpatialModel(model, _mesh(2))
    with pytest.raises(NotImplementedError, match="Upsample"):
        engine.module(model, _bands(torch.zeros(1, 3, 8, 8), 2))
    with pytest.raises(NotImplementedError, match="Sequential"):
        engine(torch.zeros(1, 3, 8, 8))


def test_replicas_on_distinct_devices(small_net):
    """``cpu`` and ``cpu:0`` are distinct devices to the mesh: the second
    gets its own copy of the model, and the banded forward (its bands on
    both copies) equals the one-device mesh's."""
    model, _, image, _ = small_net
    mesh = _mesh(4, ["cpu", "cpu:0", "cpu", "cpu:0"])
    engine = SpatialModel(model, mesh)
    assert engine.devices == [torch.device("cpu"), torch.device("cpu", 0)]
    assert engine.rep(model.aspp, torch.device("cpu", 0)) is not model.aspp
    x = torch.from_numpy(image).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = engine(x, upsample_pred=True).gather()
        want = SpatialModel(model, _mesh(4))(x, upsample_pred=True).gather()
    assert torch.equal(got, want)

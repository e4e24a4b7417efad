"""Port parity: int8 post-training quantization of the backbone
(``models/quant.py``).

The same seeded weights (flax variables, BatchNorm statistics drawn as in
the JAX package's ``tests/test_quant.py``) and inputs go through the JAX
package's ``models/quant.py`` and the port's, on the CPU, at a small
spatial size, for ResNet-18 (BasicBlock) and a ResNeXt-32x4d cut to one or
two blocks a stage (Bottleneck, the grouped widths 128 to 1024: tile counts
T = 1, 2, 4 and 8 in the qpack file).  The network, the predictor and the
``quantize`` command are in ``test_torch_quant_serving.py``.  Tolerances:

* the walk over blocks, the tile-diagonal pack and unpack, quantization
  from the same absmax, and qpack files: equal, array for array;
* calibration absmax: relative 1e-5 (f32 convs summed in another order);
* the int8 executor fed the JAX-written qpack: int8 intermediates equal on
  at least 0.999 of the values and at most 1 level apart (XLA may contract
  the requantize's multiply-add into an FMA, which moves a tie), float
  outputs and features within 1e-5 of their scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_semantic_segmentation_tpu.models import quant as j_quant
from vision_semantic_segmentation_tpu.models.resnet import ResNetBackbone as JResNetBackbone
from vision_semantic_segmentation_tpu_torch.models import flax_to_state_dict
from vision_semantic_segmentation_tpu_torch.models import quant
from vision_semantic_segmentation_tpu_torch.models.resnet import ResNetBackbone
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

OS8 = (False, True, True)
BACKBONES = {
    "resnet18": dict(block="basic", layers=(2, 2, 2, 2)),
    "resnext_cut": dict(block="bottleneck", layers=(1, 1, 2, 2), groups=32, width_per_group=4),
}


def _randomize_bn(variables, rng):
    """Nontrivial BatchNorm statistics, so the folding is exercised."""
    def mutate(path, x):
        name = "/".join(str(p.key) for p in path)
        if name.endswith("mean"):
            return jnp.asarray(rng.standard_normal(x.shape) * 0.2, x.dtype)
        if name.endswith("var"):
            return jnp.asarray(0.5 + rng.random(x.shape), x.dtype)
        if name.endswith("scale"):
            return jnp.asarray(0.7 + rng.random(x.shape) * 0.6, x.dtype)
        if name.endswith("bias"):
            return jnp.asarray(rng.standard_normal(x.shape) * 0.1, x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(mutate, variables)


@pytest.fixture(scope="module", params=sorted(BACKBONES))
def backbones(request):
    """(JAX module, its variables, the port's backbone with the same weights,
    an NHWC f32 input)."""
    rng = np.random.default_rng(17)
    kw = BACKBONES[request.param]
    jm = JResNetBackbone(replace_stride_with_dilation=OS8, **kw)
    variables = jax.jit(lambda key, x: jm.init(key, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 40, 40, 3), jnp.float32))
    variables = _randomize_bn(variables, rng)
    bb = ResNetBackbone(replace_stride_with_dilation=OS8, **kw)
    bb.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, variables)), strict=True)
    bb = bb.eval().to(memory_format=torch.channels_last)
    x = rng.standard_normal((1, 40, 40, 3)).astype(np.float32)
    return jm, variables, bb, x


def _file_form(entry):
    """A port qpack entry's kernel in the file's layout."""
    w = entry["w_q"]
    return quant.pack_tile_diag(w, entry["groups"]) if entry["groups"] > 1 else w.transpose(2, 3, 1, 0)


def _assert_same_file_qpack(port, jax_side):
    assert set(port) == set(jax_side)
    for site, entry in jax_side.items():
        assert set(port[site]) - {"groups"} == set(entry), site
        for field, want in entry.items():
            got = _file_form(port[site]) if field == "w_q" else port[site][field]
            want = np.asarray(want)
            assert np.asarray(got).dtype == want.dtype and np.shape(got) == want.shape, (site, field)
            np.testing.assert_array_equal(got, want, err_msg=f"{site}|{field}")


def _torch_in(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


# -- structure ------------------------------------------------------------------------
def test_stage_plan_matches_jax(backbones):
    jm, _, bb, _ = backbones
    _, j_plan = j_quant._stage_plan(jm)
    keys = ("name", "stride", "dilation", "downsample", "stage")
    assert [{k: b[k] for k in keys} for b in quant.stage_plan(bb)] == \
        [{k: b[k] for k in keys} for b in j_plan]


@pytest.mark.parametrize("in_ch,groups,tiles", [(128, 32, 1), (256, 32, 2), (1024, 32, 8),
                                                (384, 32, 1), (256, 8, 2), (64, 1, 1)])
def test_tile_diag_pack_matches_jax(in_ch, groups, tiles):
    rng = np.random.default_rng(in_ch + groups)
    w = rng.integers(-127, 128, (in_ch, in_ch // groups, 3, 3)).astype(np.int8)
    dense, j_tiles = j_quant._expand_tile_diag(jnp.asarray(w.transpose(2, 3, 1, 0)), groups)
    packed = quant.pack_tile_diag(w, groups)
    assert j_tiles == tiles == packed.shape[2]
    assert packed.dtype == np.int8
    np.testing.assert_array_equal(packed, np.asarray(dense))
    np.testing.assert_array_equal(quant.unpack_tile_diag(packed, groups), w)
    if groups == 32 and tiles > 1:
        with pytest.raises(ValueError, match="groups"):
            quant.unpack_tile_diag(packed, 3)


# -- calibration and quantization -------------------------------------------------------
def test_calibration_matches_jax(backbones):
    jm, variables, bb, x = backbones
    frames = [x, x[:, ::-1] * 1.5]
    want = j_quant.calibrate_backbone(jm, variables, frames)
    got = quant.calibrate_backbone(bb, frames)
    assert set(got) == set(want) and all(isinstance(v, float) for v in got.values())
    for site, v in want.items():
        assert got[site] == pytest.approx(v, rel=1e-5), site


def test_quantize_backbone_matches_jax(backbones):
    jm, variables, bb, x = backbones
    absmax = j_quant.calibrate_backbone(jm, variables, [x])
    _assert_same_file_qpack(quant.quantize_backbone(bb, absmax),
                            j_quant.quantize_backbone(jm, variables, absmax))


# -- the int8 executor ------------------------------------------------------------------
def test_executor_matches_jax(backbones, tmp_path):
    jm, variables, bb, x = backbones
    j_qpack = j_quant.quantize_backbone(jm, variables, j_quant.calibrate_backbone(jm, variables, [x]))
    path = str(tmp_path / "jax.npz")
    j_quant.save_qpack(j_qpack, path)
    j_record = {}
    j_conv = j_quant._make_quant_conv_fn(jm, j_qpack, jnp.float32)

    def recording(site, *args, **kwargs):
        j_record[site] = np.asarray(j_conv(site, *args, **kwargs))
        return j_record[site]

    want = j_quant._walk(jm, variables, jnp.asarray(x), recording, jnp.float32)
    qb = quant.QuantBackbone(bb, quant.load_qpack(path, quant.backbone_groups(bb)), torch.float32)
    record = {}
    with torch.no_grad():
        got = qb(_torch_in(x), record=record)
    assert set(record) == set(j_record)
    for site, ref in j_record.items():
        out = record[site].numpy()
        assert out.dtype == ref.dtype and out.shape == ref.shape, site
        if ref.dtype == np.int8:
            diff = np.abs(out.astype(np.int32) - ref)
            assert (diff == 0).mean() >= 0.999 and diff.max() <= 1, site
        else:
            np.testing.assert_allclose(out, ref, atol=1e-5 * np.abs(ref).max(), rtol=0, err_msg=site)
    for key in ("feature", "low_feature"):
        ref = np.asarray(want[key])
        np.testing.assert_allclose(got[key].permute(0, 2, 3, 1).numpy(), ref,
                                   atol=1e-5 * np.abs(ref).max(), rtol=0)


def test_qpack_files_interchange(backbones, tmp_path):
    """JAX save -> port load -> port save -> JAX load, and the port's own
    qpack through the JAX package and back: arrays equal."""
    jm, variables, bb, x = backbones
    groups = quant.backbone_groups(bb)
    j_qpack = j_quant.quantize_backbone(jm, variables, j_quant.calibrate_backbone(jm, variables, [x]))
    j_quant.save_qpack(j_qpack, str(tmp_path / "a.npz"))
    quant.save_qpack(quant.load_qpack(str(tmp_path / "a.npz"), groups), str(tmp_path / "b.npz"))
    back = j_quant.load_qpack(str(tmp_path / "b.npz"))
    _assert_same_file_qpack(quant.load_qpack(str(tmp_path / "b.npz"), groups), back)
    _assert_same_file_qpack(quant.load_qpack(str(tmp_path / "a.npz"), groups), j_qpack)
    with np.load(tmp_path / "a.npz") as a, np.load(tmp_path / "b.npz") as b:
        assert sorted(a.files) == sorted(b.files)
    port = quant.quantize_backbone(bb, quant.calibrate_backbone(bb, [x]))
    quant.save_qpack(port, str(tmp_path / "c.npz"))
    j_quant.save_qpack(j_quant.load_qpack(str(tmp_path / "c.npz")), str(tmp_path / "d.npz"))
    again = quant.load_qpack(str(tmp_path / "d.npz"), groups)
    for site, entry in port.items():
        for field, v in entry.items():
            np.testing.assert_array_equal(again[site][field], v, err_msg=f"{site}|{field}")

"""Port parity: int8 serving of the full-width DeepLabV3+ ResNeXt50-32x4d OS8
(19 classes), the network ``chip_smoke.py`` serves, in f32 and in bf16.

The weights are ``chip_smoke.py``'s: the port's seeded initialisation
(``runtime/tuning.py::init_state_dict``, seed 0) with each BatchNorm's
statistics taken from one random frame.  Such a random network is very
sensitive to small changes: in both packages its float labels in bf16 and
in f32 differ on about a third of the pixels, and int8 moves its logits by
about two thirds of their size.  So the int8 path's label agreement with
the float path says little about the port on its own; what is held here is
that the port reads as the JAX package does on the same weights and frames
(96x128, two calibration frames, CPU).  Tolerances:

* f32, the port fed the JAX-written qpack against the JAX package's int8
  walk run eagerly (no XLA fusion, so no multiply-add contracted into an
  FMA): every site's int8 output equal, float outputs and logits within
  1e-5 of their scale;
* bf16: the same comparison cannot be exact (the two packages round the
  float stem to bf16 in different places, and one level at the first site
  grows through 16 blocks), so the port's int8 logits on the JAX qpack lie
  no further from the JAX package's eager int8 logits than the JAX
  package's jitted int8 logits do, within a factor 1.5 of relative RMS;
* the int8-vs-float label agreement, each package calibrating itself (the
  JAX side jitted as it serves in bf16), within 0.1 of the JAX package's, in
  f32 and in bf16; likewise the float bf16-vs-f32 label agreement.

The bf16 int8 tests are in ``test_torch_quant_resnext_bf16.py``, so that
each file runs in about half a minute.  Run with ``-s`` to print the
readings.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_semantic_segmentation_tpu.config import get_cfg_defaults as j_cfg_defaults
from vision_semantic_segmentation_tpu.models import deeplab_from_cfg as j_deeplab_from_cfg
from vision_semantic_segmentation_tpu.models import quant as j_quant
from vision_semantic_segmentation_tpu_torch.config import get_cfg_defaults
from vision_semantic_segmentation_tpu_torch.inference.predictor import IMAGENET_MEAN, IMAGENET_STD
from vision_semantic_segmentation_tpu_torch.models import quant
from vision_semantic_segmentation_tpu_torch.models.build import build_model
from vision_semantic_segmentation_tpu_torch.models.convert import torch_state_dict_to_flax
from vision_semantic_segmentation_tpu_torch.runtime.tuning import init_state_dict
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

HW = (96, 128)
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _pre(image):
    return ((image.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD)[None]


def _nchw(x, dtype):
    return torch.from_numpy(x).permute(0, 3, 1, 2).to(dtype).contiguous(
        memory_format=torch.channels_last)


def _agree(a, b):
    return float((a.argmax(-1) == b.argmax(-1)).mean())


def _rel(a, b):
    return float(np.sqrt(((a - b) ** 2).mean() / (b ** 2).mean()))


@pytest.fixture(scope="module")
def seeded():
    """The seeded network's state dict (BatchNorm from one frame), its flax
    variables, two calibration frames and one frame to segment."""
    net = get_cfg_defaults().VISION_SEM_SEG.SEM_SEG_NETWORK
    assert (net.MODEL.BACKBONE, net.MODEL.OUTPUT_STRIDE) == ("resnext50_32x4d", 8)
    model = build_model(net, dtype=torch.float32, device="cpu")
    model.load_state_dict(init_state_dict(net, torch.float32, "cpu", seed=0))
    rng = np.random.default_rng(100)
    for m in model.modules():  # chip_smoke.calibrate_batchnorm
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = None
            m.reset_running_stats()
    model.train()
    model.aspp.global_avg_pool.eval()
    with torch.no_grad():
        model(_nchw(_pre(rng.integers(0, 256, (*HW, 3), dtype=np.uint8)), torch.float32))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    frames = [_pre(rng.integers(0, 256, (*HW, 3), dtype=np.uint8)) for _ in range(3)]
    variables = jax.tree.map(jnp.asarray, torch_state_dict_to_flax(state))
    return dict(net=net, state=state, variables=variables, calib=frames[:2], frame=frames[2])


def _jax_float(seeded, dtype):
    model = j_deeplab_from_cfg(j_cfg_defaults().VISION_SEM_SEG.SEM_SEG_NETWORK, dtype=dtype)
    logits = jax.jit(lambda v, x: model.apply(v, x, train=False, upsample_pred=False))(
        seeded["variables"], jnp.asarray(seeded["frame"]))
    return np.asarray(logits, np.float32)


def _jax_int8(seeded, dtype, tmp_path):
    """The JAX package's own qpack (saved), its int8 logits eager and (bf16
    only: in f32 the two agree to 0.1 of relative RMS) jitted, and the eager
    walk's site outputs."""
    model = j_deeplab_from_cfg(j_cfg_defaults().VISION_SEM_SEG.SEM_SEG_NETWORK, dtype=dtype)
    v, x = seeded["variables"], jnp.asarray(seeded["frame"])
    qpack = j_quant.quantize_deeplab(model, v, seeded["calib"])
    bb = j_quant.backbone_module(model)
    conv, sites = j_quant._make_quant_conv_fn(bb, qpack, dtype), {}

    def recording(site, *args, **kwargs):
        sites[site] = np.asarray(conv(site, *args, **kwargs))
        return sites[site]

    # quant_deeplab_apply, eagerly, with the backbone's sites recorded
    feats = j_quant._walk(bb, j_quant._sub_variables(v, "backbone"), x, recording, dtype)
    aspp, decoder = j_quant._aspp_decoder_modules(model)
    eager = decoder.apply(j_quant._sub_variables(v, "decoder"),
                          aspp.apply(j_quant._sub_variables(v, "aspp"), feats["feature"], False),
                          feats["low_feature"], False)
    path = str(tmp_path / "jax_qpack.npz")
    j_quant.save_qpack(qpack, path)
    r = dict(j_eager=np.asarray(eager, np.float32), j_sites=sites, path=path)
    r["j_int8"] = r["j_eager"]
    if dtype != jnp.float32:
        r["j_int8"] = np.asarray(jax.jit(lambda v, q, x: j_quant.quant_deeplab_apply(
            model, v, q, x))(v, qpack, x), np.float32)
    return r


def _port_model(seeded, dtype):
    model = build_model(seeded["net"], dtype=dtype, device="cpu")
    model.load_state_dict(seeded["state"])
    return model.eval()


def _port_float(seeded, dtype):
    with torch.no_grad():
        logits = _port_model(seeded, dtype)(_nchw(seeded["frame"], dtype), upsample_pred=False)
    return logits.float().permute(0, 2, 3, 1).numpy()


def _port_int8(seeded, dtype, jax_qpack):
    """The port's int8 logits (its own calibration), and its int8 logits and
    site outputs on the JAX-written qpack."""
    model = _port_model(seeded, dtype)
    x = _nchw(seeded["frame"], dtype)
    sites = {}

    def int8(qpack, record=None):
        qb = quant.QuantBackbone(model.backbone, qpack, dtype, torch.device("cpu"))
        if record is not None:
            qb(x, record=record)
        return quant.quant_deeplab_forward(model, qb, x).float().permute(0, 2, 3, 1).numpy()

    with torch.no_grad():
        own = int8(quant.quantize_deeplab(model, seeded["calib"], seeded["state"]))
        on_jax = int8(quant.load_qpack(jax_qpack, quant.backbone_groups(model.backbone)), sites)
    return dict(p_int8=own, p_on_jax=on_jax,
                p_sites={k: v.float().numpy() if v.is_floating_point() else v.numpy()
                         for k, v in sites.items()})


@pytest.fixture(scope="module")
def readings(seeded, tmp_path_factory):
    """``readings(dtype, int8=True)``: both packages' outputs in one compute
    dtype, each computed once."""
    cache = {}

    def get(name, int8=True):
        t_dtype, j_dtype = DTYPES[name]
        r = cache.setdefault(name, {})
        if "j_float" not in r:
            r.update(j_float=_jax_float(seeded, j_dtype), p_float=_port_float(seeded, t_dtype))
        if int8 and "j_int8" not in r:
            r.update(_jax_int8(seeded, j_dtype, tmp_path_factory.mktemp(name)))
            r.update(_port_int8(seeded, t_dtype, r["path"]))
        return r

    return get


def int8_agreement_like_jax(r, dtype):
    """The int8-vs-float label agreement within 0.1 of the JAX package's
    (its int8 logits jitted in bf16, eager in f32)."""
    j_agree, p_agree = _agree(r["j_int8"], r["j_float"]), _agree(r["p_int8"], r["p_float"])
    print(f"\nResNeXt50 OS8 {dtype} at {HW[0]}x{HW[1]}: int8-vs-float label agreement JAX "
          f"{j_agree:.4f}, port {p_agree:.4f}; relative RMS JAX "
          f"{_rel(r['j_int8'], r['j_float']):.4f}, port {_rel(r['p_int8'], r['p_float']):.4f}")
    assert abs(p_agree - j_agree) <= 0.1


def test_resnext50_f32_int8_executor_matches_jax(readings):
    """Fed the JAX qpack, the port's grouped int8 executor equals the JAX
    package's eager walk at every site of the full ResNeXt50."""
    r = readings("float32")
    assert set(r["p_sites"]) == set(r["j_sites"]) and len(r["j_sites"]) == 52
    for site, ref in r["j_sites"].items():
        out = r["p_sites"][site]
        assert out.dtype == ref.dtype and out.shape == ref.shape, site
        if ref.dtype == np.int8:
            np.testing.assert_array_equal(out, ref, err_msg=site)
        else:
            np.testing.assert_allclose(out, ref, atol=1e-5 * np.abs(ref).max(), rtol=0, err_msg=site)
    ref = r["j_eager"]
    np.testing.assert_allclose(r["p_on_jax"], ref, atol=1e-5 * np.abs(ref).max(), rtol=0)


def test_resnext50_f32_int8_agreement_like_jax(readings):
    int8_agreement_like_jax(readings("float32"), "float32")


def test_resnext50_bf16_float_like_jax(readings):
    """The random network's own sensitivity: bf16 against f32 float labels,
    the same share in both packages."""
    f32, bf16 = readings("float32"), readings("bfloat16", int8=False)
    j_agree, p_agree = _agree(bf16["j_float"], f32["j_float"]), _agree(bf16["p_float"], f32["p_float"])
    print(f"\nResNeXt50 OS8 float bf16 against f32 at {HW[0]}x{HW[1]}: labels equal on JAX "
          f"{j_agree:.4f}, port {p_agree:.4f}; relative RMS JAX "
          f"{_rel(bf16['j_float'], f32['j_float']):.4f}, port "
          f"{_rel(bf16['p_float'], f32['p_float']):.4f}")
    assert abs(p_agree - j_agree) <= 0.1

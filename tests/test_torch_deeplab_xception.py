"""DeepLabV3+ on Xception-65 (``models/deeplab.py`` with ``backbone
"xception65"``) against the benchmark's plain reference network
(``benchmark/reference/xception65.py``), in f32 on the CPU.

The weights are the benchmark's seeded ones (``benchmark/core/weights.py``):
He-normal fan-out kernels, identity BatchNorm but for the last BatchNorm of
each residual branch at the configuration's ``residual_bn_weight``, the
classifier's biases centred on one frame.  The same state dict loads
strictly into both.  Logits agree to 1e-5 of their largest magnitude: both
run f32 convolutions, summed in another order (K3's plain version against
``F.conv2d``), and the residual weight grows the middle flow's activations,
so the bound is relative to the scale, as in ``test_torch_xception.py``.

Faults of the backbone move the reference's logits by more than the
configuration's ``logit_err`` limit, so the benchmark's check sees them:
the middle flow skipped, one middle block's first depthwise kernel zeroed,
the exit convs at rate 1, the low-level feature zeroed.
"""
import copy
import hashlib
import json
import sys
from pathlib import Path

import pytest
import torch
import torch.nn as nn
from torch.profiler import ProfilerActivity, profile

from vision_semantic_segmentation_tpu_torch.config import get_cfg_defaults
from vision_semantic_segmentation_tpu_torch.models import build_model
from vision_semantic_segmentation_tpu_torch.models.build import XceptionSeg, init_weights_
from vision_semantic_segmentation_tpu_torch.models.deeplab import DeepLabV3Plus
from vision_semantic_segmentation_tpu_torch.models.layers import DepthwiseConv2d
from vision_semantic_segmentation_tpu_torch.models.xception import Xception65
from vision_semantic_segmentation_tpu_torch.runtime import FusedFramePipeline

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmark.core.checks import logit_numbers, reference_network  # noqa: E402
from benchmark.core.weights import center_classifier, make_state_dict  # noqa: E402
from benchmark.reference.deeplab import normalize  # noqa: E402
from benchmark.run import load_reference  # noqa: E402

CONFIG = json.loads((REPO / "benchmark/configs/xception65/deeplabv3p-xc65-os16-serve.json")
                    .read_text())
NET = CONFIG["network"]
REF = load_reference(REPO, NET)
RTOL_OF_SCALE = 1e-5
# the faults' input: the smallest size at which one middle block's residual
# (fault b) moves the logits past the limit on these seeds; at the benchmark's
# 1440 x 1920 every fault moves them by 0.5 or more
FAULT_HW = (161, 225)


def _frame(seed: int, hw) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (1, *hw, 3), generator=gen, dtype=torch.uint8)


def _state_dict(seed: int, hw):
    sd = make_state_dict(REF, NET, seed, "cpu", torch.float32,
                         CONFIG["weights"]["residual_bn_weight"])
    return center_classifier(REF, NET, sd, normalize(_frame(seed + 1, hw)))


def _port(sd) -> DeepLabV3Plus:
    model = DeepLabV3Plus(NET["num_classes"], backbone="xception65", output_stride=16,
                          decoder_low_level_out_channels=NET["decoder_low_level_out_channels"])
    model.load_state_dict(sd, strict=True)
    return model.eval()


@pytest.mark.parametrize("hw", [(65, 97), (97, 129)])
def test_port_matches_reference(hw):
    sd = _state_dict(5, hw)
    port, ref = _port(sd), reference_network(REF, NET, sd, "cpu")
    x = normalize(_frame(6, hw))
    with torch.no_grad():
        got, want = port(x, upsample_pred=False), ref(x)
    assert got.shape == want.shape == (1, NET["num_classes"], hw[0] // 4 - 4, hw[1] // 4 - 4)
    scale = float(want.abs().max())
    assert scale > 0
    torch.testing.assert_close(got, want, rtol=0, atol=RTOL_OF_SCALE * scale)


def _middle_flow_skipped(model):
    model.backbone.middle_flow_modules = nn.ModuleList()


def _middle_kernel_zeroed(model):
    with torch.no_grad():
        model.backbone.middle_flow_modules[7].residual_group1[0].depthwise_cnn.conv.weight.zero_()


def _exit_rate_one(model):
    for conv in model.backbone.exit_flow_modules[1:]:
        conv.depthwise_cnn.conv.dilation, conv.depthwise_cnn.conv.padding = (1, 1), (1, 1)


def _low_level_zeroed(model):
    forward = model.backbone.forward

    def zeroed(x):
        out = forward(x)
        return {"feature": out["feature"], "low_feature": torch.zeros_like(out["low_feature"])}

    model.backbone.forward = zeroed


@pytest.fixture(scope="module", params=[3, 8])
def sound(request):
    """The reference network on one seed's weights, a frame, its logits."""
    seed = request.param
    ref = reference_network(REF, NET, _state_dict(seed, FAULT_HW), "cpu").eval()
    x = normalize(_frame(seed + 2, FAULT_HW))
    with torch.no_grad():
        return ref, x, ref(x)[0]


@pytest.mark.parametrize("fault", [_middle_flow_skipped, _middle_kernel_zeroed, _exit_rate_one,
                                   _low_level_zeroed], ids=lambda f: f.__name__.strip("_"))
def test_fault_moves_logits_past_the_limit(sound, fault):
    ref, x, logits = sound
    faulty = copy.deepcopy(ref)
    fault(faulty)
    with torch.no_grad():
        err, _ = logit_numbers(faulty(x)[0], logits)
    assert err > CONFIG["limits"]["logit_err"], err


def test_exit_convs_run_at_rate_two_on_k3():
    model = DeepLabV3Plus(19, backbone="xception65", output_stride=16)
    for conv in model.backbone.exit_flow_modules[1:]:
        dw = conv.depthwise_cnn.conv
        assert (dw.dilation, dw.padding) == ((2, 2), (2, 2)) and dw.uses_k3()
    sites = [m for m in model.backbone.modules()
             if isinstance(m, DepthwiseConv2d) and m.stride == (1, 1)]
    assert len(sites) == 60 and all(m.uses_k3() for m in sites)
    # XceptionSeg keeps the reference's unwired rate 1
    seg = XceptionSeg(19)
    assert all(c.depthwise_cnn.conv.dilation == (1, 1) for c in seg.backbone.exit_flow_modules[1:])


def _tree(output_stride=16):
    """The application tree, its network set to DeepLabV3+ on Xception-65."""
    cfg = get_cfg_defaults()
    cfg.VISION_SEM_SEG.SEM_SEG_NETWORK.merge_from_list([
        "MODEL.TYPE", "DeepLabv3+", "MODEL.BACKBONE", "xception65",
        "MODEL.OUTPUT_STRIDE", output_stride, "MODEL.DECODER.LOW_LEVEL_OUT_CHANNELS", 48])
    return cfg


def test_built_from_a_configuration_tree():
    model = build_model(_tree().VISION_SEM_SEG.SEM_SEG_NETWORK, device="cpu")
    direct = DeepLabV3Plus(model.decoder.refine_layers[-1].conv.out_channels,
                           backbone="xception65", output_stride=16)
    assert isinstance(model.backbone, Xception65)
    assert ({k: v.shape for k, v in model.state_dict().items()}
            == {k: v.shape for k, v in direct.state_dict().items()})
    assert [type(m) for m in model.modules()] == [type(m) for m in direct.modules()]
    prefixes = {k.split(".")[1] for k in model.state_dict() if k.startswith("backbone.")}
    assert prefixes == {"entry_flow_modules", "middle_flow_modules", "exit_flow_modules"}
    model.load_state_dict(_state_dict(2, (65, 97)), strict=True)
    with pytest.raises(NotImplementedError, match="xception65"):
        build_model(_tree(output_stride=8).VISION_SEM_SEG.SEM_SEG_NETWORK, device="cpu")


def test_fused_pipeline_serves_it():
    """The normal serving path from a tree: a raw frame to logits, the
    benchmark's weights loaded strictly."""
    sd = _state_dict(4, (90, 120))
    pipe = FusedFramePipeline(_tree(), state_dict=sd, compute_dtype=torch.float32,
                              device="cpu")
    frame = _frame(9, (90, 120))
    logits = pipe.segment(frame[0])
    with torch.no_grad():
        want = reference_network(REF, NET, sd, "cpu")(normalize(frame))
    assert logits.shape == want.shape == (1, 19, 18, 26)
    torch.testing.assert_close(logits, want, rtol=0,
                               atol=RTOL_OF_SCALE * float(want.abs().max()))


# XceptionSeg as it was before DeepLabV3+ took Xception-65: its key set and
# shapes (sha256 of "key shape" lines) and its logits on one seed
SEG_KEYS = (794, "a23a41c0ae8f670b56d54b7ab27789e0f2f40e32398376aede3950bbec8d6b25")
SEG_ABS_SUM, SEG_MAX = 0.012827060144275038, 8.757876639720052e-05


def test_xception_seg_unchanged():
    model = init_weights_(XceptionSeg(19), torch.Generator().manual_seed(11)).eval()
    lines = "\n".join(f"{k} {tuple(v.shape)}" for k, v in sorted(model.state_dict().items()))
    assert (len(model.state_dict()), hashlib.sha256(lines.encode()).hexdigest()) == SEG_KEYS
    x = torch.randn(1, 3, 65, 97, generator=torch.Generator().manual_seed(12))
    with torch.no_grad():
        y = model(x, upsample_pred=False)
    assert float(y.double().abs().sum()) == pytest.approx(SEG_ABS_SUM, rel=1e-5)
    assert float(y.abs().max()) == pytest.approx(SEG_MAX, rel=1e-5)


def test_spans_mark_the_three_flows_once_a_forward(tmp_path):
    model = DeepLabV3Plus(19, backbone="xception65", output_stride=16).eval()
    x = torch.randn(1, 3, 65, 97)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        model(x)
        model(x)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") == "user_annotation" and e["name"].startswith("xception."))
    assert [n for _, _, n in spans] == ["xception.entry", "xception.middle", "xception.exit"] * 2
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))

"""The cell ``xc65-os16.replay``: DeepLabV3+ on Xception-65
(``benchmark/reference/xception65.py``) through the replay driver.

On the CPU: the cell is correct at a small size, and not correct with any
of four faults planted in the measured program's backbone (the middle flow
skipped, one middle block's first depthwise kernel zeroed, the exit convs
at rate 1, the low-level feature zeroed); the FLOP
count and K3's bytes equal counts by hand at 1440 x 1920; the two readers
the cell adds read hand-made traces.  On the card (``-m cuda``), at the
cell's own size: each of four faults of the backbone comes out not correct
on three seeds.

The configuration lives in ``benchmark/configs/xception65/``: the tiny root
of ``conftest.py`` shrinks only the files directly under ``configs/``, so it
is shrunk here, to frames of 180 x 240 (at 72 x 96 the middle flow's share
of the logits is too small for its faults to show at the cell's limits).
"""
from __future__ import annotations

import contextlib
import io
import json
from types import SimpleNamespace
from typing import List, Tuple

import pytest
import torch

from benchmark.counts.flops import conv_flops, forward_flops
from benchmark.counts.kernels import k3_bytes
from benchmark.counts.sites import k3_frame_bytes, k3_sites
from benchmark.run import load_file_module, load_reference
from benchmark.tests.conftest import REPO, run_cell

CELL = "xc65-os16.replay"
CONFIG_FILE = "benchmark/configs/xception65/deeplabv3p-xc65-os16-serve.json"
NET = json.loads((REPO / CONFIG_FILE).read_text())["network"]
SEEDS = (2147483801, 2147483802, 2147483803)


@pytest.fixture
def xc65_root(tiny_root):
    p = tiny_root / CONFIG_FILE
    c = json.loads(p.read_text())
    c["input"]["image_scale"] = 0.125  # 180 x 240 network input
    c["map"] = dict(c["map"], boundary=[[100, 140], [800, 840]], point_bucket=4096)
    p.write_text(json.dumps(c))
    return tiny_root


# -- faults of the measured program ----------------------------------------------------
def _middle_flow_skipped(monkeypatch):
    from vision_semantic_segmentation_tpu_torch.models.xception import XceptionBlock

    forward = XceptionBlock.forward
    monkeypatch.setattr(XceptionBlock, "forward",
                        lambda self, x: x if self.skip_type == "sum" else forward(self, x))


def _exit_rate_one(monkeypatch):
    from vision_semantic_segmentation_tpu_torch.models import deeplab

    build = deeplab.Xception65
    monkeypatch.setattr(deeplab, "Xception65", lambda *a, **k: build(*a, **{**k, "exit_rate": 1}))


def _middle_kernel_zeroed(monkeypatch):
    from vision_semantic_segmentation_tpu_torch.runtime.pipeline import FusedFramePipeline

    init = FusedFramePipeline.__init__

    def zeroed(self, *a, **k):
        init(self, *a, **k)
        block = self.model.backbone.middle_flow_modules[7]
        with torch.no_grad():
            block.residual_group1[0].depthwise_cnn.conv.weight.zero_()

    monkeypatch.setattr(FusedFramePipeline, "__init__", zeroed)


def _low_level_zeroed(monkeypatch):
    from vision_semantic_segmentation_tpu_torch.models.xception import Xception65

    forward = Xception65.forward

    def zeroed(self, x):
        out = forward(self, x)
        return {"feature": out["feature"], "low_feature": torch.zeros_like(out["low_feature"])}

    monkeypatch.setattr(Xception65, "forward", zeroed)


FAULTS = [_middle_flow_skipped, _middle_kernel_zeroed, _exit_rate_one, _low_level_zeroed]


def test_sound_run_is_correct(xc65_root):
    result = run_cell(xc65_root, CELL)
    assert result["correct"], result["limits"]
    assert set(result["metrics"]) == {"frames_per_s", "setup_s"}


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__.strip("_"))
def test_fault_is_not_correct(xc65_root, monkeypatch, fault):
    fault(monkeypatch)
    result = run_cell(xc65_root, CELL)
    assert not result["correct"], result["limits"]
    assert result["limits"]["logit_err"]["value"] > result["limits"]["logit_err"]["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__.strip("_"))
def test_fault_is_not_correct_on_the_card(cuda_device, monkeypatch, fault):
    from benchmark import run

    fault(monkeypatch)
    for seed in SEEDS:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = run.main(["--workload", CELL, "--seed", str(seed), "--seconds", "5",
                           "--trace", "0"], root=REPO, device=cuda_device)
        assert rc == 0, out.getvalue()[-2000:]
        result = json.loads(out.getvalue().strip().splitlines()[-1])
        print(fault.__name__, seed, json.dumps(result["limits"]))
        assert result["correct"] is False, result["limits"]


# -- counts by hand --------------------------------------------------------------------
# (name, out_h, out_w, cin, cout, k, groups)
Conv = Tuple[str, int, int, int, int, int, int]


def xception_convs(net: dict, h: int, w: int) -> List[Conv]:
    """Every convolution of one (h, w) image's forward pass, by hand."""
    convs: List[Conv] = []

    def sep(name, h, w, cin, cout):
        convs.append((f"{name}.depthwise", h, w, cin, cin, 3, cin))
        convs.append((f"{name}.pointwise", h, w, cin, cout, 1, 1))

    h, w = (h - 3) // 2 + 1, (w - 3) // 2 + 1  # unpadded 3x3, stride 2
    convs.append(("stem1", h, w, 3, 32, 3, 1))
    convs.append(("stem2", h, w, 32, 64, 3, 1))
    cin = 64
    for i, ch in enumerate((128, 256, 728)):
        sep(f"entry{i}.0", h, w, cin, ch)
        sep(f"entry{i}.1", h, w, ch, ch)
        if i == 1:
            low_hw = (h, w)
        h, w = (h + 2 - 3) // 2 + 1, (w + 2 - 3) // 2 + 1  # padded by 2 at the end, stride 2
        sep(f"entry{i}.2", h, w, ch, ch)
        convs.append((f"entry{i}.skip", h, w, cin, ch, 1, 1))
        cin = ch
    for b in range(16):
        for j in range(3):
            sep(f"middle{b}.{j}", h, w, 728, 728)
    for j, (ci, co) in enumerate(((728, 728), (728, 1024), (1024, 1024))):
        sep(f"exit.{j}", h, w, ci, co)
    convs.append(("exit.skip", h, w, 728, 1024, 1, 1))
    for j, (ci, co) in enumerate(((1024, 1536), (1536, 1536), (1536, 2048))):
        sep(f"exit_conv{j}", h, w, ci, co)  # rate 2, padded 2: the size stays
    ch = net["aspp_atrous_channels"]
    convs.append(("aspp.0", h, w, 2048, ch[0], 1, 1))
    for i, c in enumerate(ch[1:], 1):
        sep(f"aspp.{i}", h, w, 2048, c)
    convs.append(("aspp.pool", 1, 1, 2048, 256, 1, 1))
    convs.append(("aspp.conv", h, w, sum(ch) + 256, net["aspp_out_channels"], 1, 1))
    lh, lw = low_hw
    low = net["decoder_low_level_out_channels"]
    convs.append(("decoder.low", lh, lw, 256, low, 1, 1))
    c = net["aspp_out_channels"] + low
    for j, out in enumerate(net["decoder_refine_channels"]):
        lh, lw = lh - 2, lw - 2
        sep(f"decoder.{j}", lh, lw, c, out)
        c = out
    convs.append(("decoder.classifier", lh, lw, c, net["num_classes"], 1, 1))
    return convs


def test_forward_flops_match_a_hand_count():
    ref = load_reference(REPO, NET)
    by_hand = sum(conv_flops(oh, ow, ci, co, k, g)
                  for _, oh, ow, ci, co, k, g in xception_convs(NET, 1440, 1920))
    assert forward_flops(ref, NET, 1440, 1920) == by_hand == 1080682266304
    assert forward_flops(ref, NET, 180, 240) == sum(
        conv_flops(oh, ow, ci, co, k, g) for _, oh, ow, ci, co, k, g in
        xception_convs(NET, 180, 240))


def test_k3_bytes_match_a_hand_sum():
    """The 60 stride-1 depthwise sites of the backbone, by hand: 2 in each
    entry block, 48 in the middle flow, 3 in the exit block, the 3 exit
    convs; ASPP's atrous branches run K4 and are not among them."""
    sites = [((719, 959), 64), ((719, 959), 128), ((360, 480), 128), ((360, 480), 256),
             ((180, 240), 256), ((180, 240), 728)]
    sites += [((90, 120), 728)] * 48
    sites += [((90, 120), 728), ((90, 120), 728), ((90, 120), 1024)]
    sites += [((90, 120), 1024), ((90, 120), 1536), ((90, 120), 1536)]
    ref = load_reference(REPO, NET)
    assert k3_sites(ref, NET, 1440, 1920) == [(h, w, c) for (h, w), c in sites]
    by_hand = sum(k3_bytes(1, h, w, c, 2) for (h, w), c in sites)
    assert k3_frame_bytes(ref, NET, 1440, 1920, 2) == by_hand == 2760223008
    assert round(by_hand / 3.35e12 * 1e6, 1) == 823.9  # the byte bound, us a frame


# -- the readers the cell adds ---------------------------------------------------------
def _reader(name):
    return load_file_module(f"benchmark.metrics.{name.replace('.', '_')}",
                            REPO / "benchmark" / "metrics" / f"{name}.py")


def _run(kernels, host, window_s=0.1, units=2):
    """A traced run as the readers see it: kernels (name, start, end in us)
    and host events."""
    from benchmark.core.trace import DeviceTrace

    dtrace = DeviceTrace(REPO / "build")
    dtrace.window_s, dtrace.units = window_s, units
    dtrace.kernels = [(n, float(a), float(b - a)) for n, a, b in kernels]
    dtrace.host = [(n, float(a), float(b - a), 1) for n, a, b in host]
    config = json.loads((REPO / CONFIG_FILE).read_text())
    return SimpleNamespace(dtrace=dtrace, config=config, reference=load_reference(REPO, NET),
                           window={"unit_work": 8})


# card busy over [10, 30] and [40, 90] ms; the backbone's spans cover [5, 60]
TRACE = _run([("void phase::phase_walk_kernel<bf16>", 10_000, 30_000),
              ("aspp_phase_kernel", 40_000, 90_000)],
             [("pipeline.window", 0, 95_000), ("xception.entry", 5_000, 20_000),
              ("xception.middle", 20_000, 50_000), ("xception.exit", 50_000, 60_000),
              ("aten::add", 92_000, 95_000)])


def test_idle_xception_reads_the_spans():
    reader = _reader("idle_xception_pct.fps")
    # idle inside [5, 60]: [5, 10] and [30, 40], 15 ms of the 100
    assert reader.read(TRACE) == pytest.approx(15.0, abs=1e-9)
    bare = _run([(n, a, a + d) for n, a, d in TRACE.dtrace.kernels],
                [(n, a, a + d) for n, a, d, _ in TRACE.dtrace.host if not n.startswith("xception.")])
    assert reader.read(bare) is None
    assert reader.read(SimpleNamespace(dtrace=None)) is None


def test_k3_roofline_counts_the_reference_sites():
    reader = _reader("k3_roofline.fps")
    # 2 units of 8 frames, 20 ms of K3
    want = 100.0 * 16 * 2760223008 / 3.35e12 / 0.020
    assert reader.read(TRACE) == pytest.approx(want, rel=1e-12)
    no_k3 = _run([("aspp_phase_kernel", 40_000, 90_000)], [])
    assert reader.read(no_k3) is None
    cut = _run([("void phase::phase_walk_kernel<bf16>", 10_000, 30_000)], [], units=0)
    assert reader.read(cut) is None  # a trace the window cut short
    assert reader.read(SimpleNamespace(dtrace=None)) is None

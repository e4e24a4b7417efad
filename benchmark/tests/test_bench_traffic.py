"""The inputs repeat exactly from a seed, and differ between seeds."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from benchmark.core.traffic import MAPILLARY_19, frame_pool, sub_seed, train_batches
from benchmark.core.weights import make_state_dict
from benchmark.reference import deeplab
from benchmark.tests.conftest import REPO

SERVE = json.loads((REPO / "benchmark/configs/deeplabv3p-rx50-os8-serve.json").read_text())


TRAIN_TRAFFIC = json.loads((REPO / "benchmark/traffic/train-device.json").read_text())


def _pool(seed):
    p = dict(json.loads((REPO / "benchmark/traffic/replay.json").read_text())["frames"], pool=3)
    m = dict(SERVE["map"], point_bucket=2048)
    return frame_pool(seed, m, (48, 64), p, "cpu")


def test_frame_pool_repeats_from_a_seed():
    a, b, c = _pool(2 ** 31 + 12345), _pool(2 ** 31 + 12345), _pool(7)
    for key in a:
        for x, y in zip(a[key], b[key]):
            assert np.array_equal(x, y), key
    assert not all(np.array_equal(x, y) for x, y in zip(a["pcd"][0], c["pcd"][0]))
    assert all(p.shape[1] <= 2048 and p.shape[1] >= int(0.6 * 2048) for p in a["pcd"])


@pytest.mark.parametrize("seed", [2 ** 31 + 99, 2 ** 33 + 1])
def test_train_batches_repeat_from_a_seed(seed):
    p = dict(TRAIN_TRAFFIC["batches"], pool=2, blob_px=8)
    a, b = (train_batches(seed, p, 3, 33, 19, "cpu") for _ in range(2))
    other = train_batches(seed + 1, p, 3, 33, 19, "cpu")
    assert a["image"].shape == (2, 3, 33, 33, 3) and a["label"].shape == (2, 3, 33, 33)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["label"], other["label"])
    labels = set(a["label"].unique().tolist())
    assert labels <= set(range(19)) | {255} and 255 in labels
    # each pixel is its label's colour shaded, normalised: labels and images pair up
    mean = torch.tensor(p["normalize"]["mean"])
    std = torch.tensor(p["normalize"]["std"])
    raw = (a["image"] * std + mean) * 255.0
    pal = torch.tensor(MAPILLARY_19 + [[0, 0, 0]] * 237, dtype=torch.float32)
    ramp = torch.linspace(0.6, 1.0, 33)[None, None, None, :, None]
    assert float((raw - (pal[a["label"].long()] * ramp).round()).abs().max()) < 1e-3


def test_weights_repeat_from_a_seed():
    net = SERVE["network"]
    a = make_state_dict(deeplab, net, sub_seed(2 ** 31 + 5, 0), "cpu", torch.bfloat16)
    b = make_state_dict(deeplab, net, sub_seed(2 ** 31 + 5, 0), "cpu", torch.bfloat16)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    w = a["backbone.layer4.0.conv2.weight"].float()
    fan_out = w.shape[0] * 9
    assert abs(float(w.std()) - (2.0 / fan_out) ** 0.5) < 0.05 * (2.0 / fan_out) ** 0.5


def test_sub_seed_takes_large_seeds():
    seeds = {sub_seed(s, k) for s in (0, 1, 2 ** 31 + 1, 2 ** 33) for k in range(5)}
    assert len(seeds) == 20 and all(0 <= s < 2 ** 63 for s in seeds)

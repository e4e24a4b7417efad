"""The plain reference agrees with the measured program at a small size on
the CPU, in float32: the network's logits, the map update and a training
step."""
from __future__ import annotations

import json

import numpy as np
import torch

from benchmark.core.checks import leaf_gap, logit_numbers, reference_network
from benchmark.core.portcfg import serving_cfg, train_cfg
from benchmark.core.traffic import blob_classes, frame_pool
from benchmark.core.weights import center_classifier, make_state_dict
from benchmark.reference import deeplab
from benchmark.reference.deeplab import normalize
from benchmark.reference.mapping import MapReference, grid_error
from benchmark.reference.train import cross_entropy, sgd_steps
from benchmark.tests.conftest import REPO

SERVE = json.loads((REPO / "benchmark/configs/deeplabv3p-rx50-os8-serve.json").read_text())
TRAIN = json.loads((REPO / "benchmark/configs/deeplabv3p-rx50-os16-train.json").read_text())


def test_network_logits_agree():
    from vision_semantic_segmentation_tpu_torch.runtime.pipeline import FusedFramePipeline

    frame = torch.randint(0, 256, (72, 96, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(3))
    sd = make_state_dict(deeplab, SERVE["network"], 11, "cpu", torch.float32)
    sd = center_classifier(deeplab, SERVE["network"], sd, normalize(frame[None]))
    pipe = FusedFramePipeline(serving_cfg(SERVE), state_dict=sd, compute_dtype=torch.float32,
                              distortion="points", device="cpu")
    with torch.no_grad():
        prog = pipe.segment(frame)[0]
        ref = reference_network(deeplab, SERVE["network"], sd, "cpu")(normalize(frame[None]))[0]
    err, gap = logit_numbers(prog, ref)
    assert err < 1e-4 and gap < 1e-4, (err, gap)


def test_map_update_agrees():
    from vision_semantic_segmentation_tpu_torch.mapping.engine import SemanticMappingEngine
    from vision_semantic_segmentation_tpu_torch.mapping.engine import pad_points

    conf = json.loads(json.dumps(SERVE))
    conf["map"].update(boundary=[[100, 160], [800, 860]], point_bucket=8192)
    p = json.loads((REPO / "benchmark/traffic/replay.json").read_text())["frames"]
    p.update(pool=3, start_m=10.0)
    pool = frame_pool(5, conf["map"], (8, 8), p, "cpu")
    # colourised label images: blobs of the map's channels and of a colour
    # no channel takes (-1)
    colors = torch.tensor(conf["map"]["label_colors"] + [[0, 0, 142]], dtype=torch.uint8)
    channels = blob_classes(3, (1440, 1920), 32, len(colors), torch.Generator().manual_seed(6),
                            "cpu")
    channels = torch.where(channels == len(colors) - 1, -1, channels)
    engine = SemanticMappingEngine(serving_cfg(conf), device="cpu")
    ref = MapReference(conf["map"], "cpu")
    grid = engine.init_grid()
    for i in range(3):
        pcd, valid = pad_points(pool["pcd"][i], engine.point_bucket)
        grid, _, _ = engine.step(grid, pcd, valid, colors[channels[i]].numpy(),
                                 pool["position"][i], pool["quaternion"][i], camera="camera1")
        ref.update(pcd, valid, pool["position"][i], pool["quaternion"][i], channels[i],
                   distorted=False, full_hw=(1440, 1920))
    assert float(ref.grid.sum()) > 100
    assert grid_error(grid, ref.as_planar()) < 1e-3


def test_train_step_agrees():
    from vision_semantic_segmentation_tpu_torch.parallel.train_step import TrainState, make_train_step
    from vision_semantic_segmentation_tpu_torch.models.build import build_train_model
    from vision_semantic_segmentation_tpu_torch.train.optim import build_optimizer, build_schedule
    from vision_semantic_segmentation_tpu_torch.train.optim import build_scheduler

    conf = json.loads(json.dumps(TRAIN))
    conf["network"]["aspp_dropout"] = 0.0
    cfg = train_cfg(conf, "unused", "", 5)
    model, *_ = build_train_model(cfg, device="cpu")
    sd = make_state_dict(deeplab, conf["network"], 12, "cpu", torch.float32,
                         conf["weights"]["residual_bn_weight"])
    model.load_state_dict(sd)
    opt = build_optimizer(cfg, list(model.parameters()))
    state = TrainState(model=model, optimizer=opt,
                       scheduler=build_scheduler(opt, build_schedule(cfg)),
                       generator=torch.Generator())
    step = make_train_step(19)
    gen = torch.Generator().manual_seed(1)
    image = torch.randn((2, 65, 65, 3), generator=gen)
    label = torch.randint(0, 19, (2, 65, 65), generator=gen)
    label[:, :5] = 255
    loss = float(step(state, {"image": image, "label": label})["loss"])
    ref = reference_network(deeplab, conf["network"], sd, "cpu", training=True)
    losses, first, _, _ = sgd_steps(ref, conf["train"], [(image.permute(0, 3, 1, 2), label)])
    assert abs(loss - losses[0]) < 1e-5 * abs(losses[0])
    prog = {n: opt.state[p]["momentum_buffer"] for n, p in model.named_parameters()}
    worst, leaf, _ = leaf_gap(prog, first, list(first))
    assert worst < 1e-3, (leaf, worst)
    assert float(cross_entropy(torch.zeros(1, 19, 2, 2), torch.full((1, 2, 2), 255))) == 0.0
    assert np.isfinite(loss)


def test_train_step_from_the_programs_state_agrees():
    """The window's probe: the reference's step from the program's
    parameters and momentum buffers after a step (``start``, ``bufs``)
    takes the program's next step."""
    from vision_semantic_segmentation_tpu_torch.parallel.train_step import TrainState, make_train_step
    from vision_semantic_segmentation_tpu_torch.models.build import build_train_model
    from vision_semantic_segmentation_tpu_torch.train.optim import build_optimizer, build_schedule
    from vision_semantic_segmentation_tpu_torch.train.optim import build_scheduler

    conf = json.loads(json.dumps(TRAIN))
    conf["network"]["aspp_dropout"] = 0.0
    conf["train"]["poly_max_iter"] = 4  # the learning rate moves from step to step
    cfg = train_cfg(conf, "unused", "", 5)
    model, *_ = build_train_model(cfg, device="cpu")
    sd = make_state_dict(deeplab, conf["network"], 13, "cpu", torch.float32,
                         conf["weights"]["residual_bn_weight"])
    model.load_state_dict(sd)
    opt = build_optimizer(cfg, list(model.parameters()))
    state = TrainState(model=model, optimizer=opt,
                       scheduler=build_scheduler(opt, build_schedule(cfg)),
                       generator=torch.Generator())
    step = make_train_step(19)
    gen = torch.Generator().manual_seed(2)
    batches = [{"image": torch.randn((2, 65, 65, 3), generator=gen),
                "label": torch.randint(0, 19, (2, 65, 65), generator=gen)} for _ in range(3)]
    params = dict(model.named_parameters())
    for b in batches[:2]:
        step(state, b)
    before = {n: p.detach().clone() for n, p in params.items()}
    bufs = {n: opt.state[p]["momentum_buffer"].clone() for n, p in params.items()}
    loss = float(step(state, batches[2])["loss"])
    ref = reference_network(deeplab, conf["network"], dict(sd, **before), "cpu", training=True)
    b = batches[2]
    losses, taken, _, _ = sgd_steps(ref, conf["train"], [(b["image"].permute(0, 3, 1, 2),
                                                          b["label"])], start=2, bufs=bufs)
    assert abs(loss - losses[0]) < 1e-5 * abs(losses[0])
    m = conf["train"]["momentum"]
    prog = {n: opt.state[p]["momentum_buffer"] - m * bufs[n] for n, p in params.items()}
    worst, leaf, _ = leaf_gap(prog, taken, list(taken))
    assert worst < 1e-3, (leaf, worst)
    prog = {n: p.detach() - before[n] for n, p in params.items()}
    ref_change = {n: p.detach() - before[n] for n, p in ref.named_parameters()}
    worst, leaf, _ = leaf_gap(prog, ref_change, list(prog))
    assert worst < 1e-3, (leaf, worst)

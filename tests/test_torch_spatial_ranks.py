"""Port parity: bands across ranks, ``TRAIN.SPATIAL_SHARDS`` under
``train --distributed`` (gloo ranks on the CPU), against the JAX package's
``jit_spatial_train_step`` / ``jit_spatial_eval_step`` on its 8-device CPU
mesh and against the port's one-process banded step.

The ranks are child processes of this file, run as ``python
tests/test_torch_spatial_ranks.py --rank-worker spec.json`` with
``torchrun``'s environment variables, as in
``tests/test_torch_data_parallel.py``: one PyTorch thread each, JAX imported
only inside this module's tests and fixtures, never at module level, and a
group that has not finished within ``GROUP_TIMEOUT`` seconds is killed and
its test fails.  Rank r holds band ``r % S`` of data group ``r // S``.

The model is the JAX spatial tests' thin DeepLab (resnet18 OS8, ASPP and
decoder 8-16 channels wide) on 64x32 images, so the OS8 map has 8 rows: at
4 bands each band holds 2, and ASPP's and layer4's dilated halos cross two
bands.  It runs in f64 on both sides, with both packages' resizes and loss
summed in f64 (``tests/test_torch_train_step.py`` gives the reason: in f32
train-mode BatchNorm at batch 2 turns rounding noise into gradient
differences of several per cent).  Tolerances against JAX: the loss within
1e-5 relative, the confusion exactly, every parameter and running
statistic within 1e-5 absolute, the eval-mode gradient within 1e-5 of each
leaf's largest value.  Against the port's one-process banded step the same
f64 arithmetic is summed in another order (the bands' BatchNorm sums and
gradients over ranks instead of in band order on one device): within
1e-9, a million times f64's rounding and far below the 1e-5 a missing halo
row or a doubled reduction would move.
"""
import datetime
import json
import logging
import os
import os.path as osp
import random
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from vision_semantic_segmentation_tpu_torch.__main__ import main as cli_main
from vision_semantic_segmentation_tpu_torch.config import get_train_cfg_defaults
from vision_semantic_segmentation_tpu_torch.models import build_train_model
from vision_semantic_segmentation_tpu_torch.models import resize as p_model_resize
from vision_semantic_segmentation_tpu_torch.ops import resize as p_resize
from vision_semantic_segmentation_tpu_torch.parallel import (
    SpatialModel,
    TrainState,
    create_mesh,
    ensure_distributed,
    make_spatial_eval_step,
    make_spatial_train_step,
)
from vision_semantic_segmentation_tpu_torch.parallel import spatial_infer
from vision_semantic_segmentation_tpu_torch.parallel import train_step as p_train_step
from vision_semantic_segmentation_tpu_torch.parallel.distributed import Traffic, all_reduce_
from vision_semantic_segmentation_tpu_torch.parallel.spatial_infer import (
    Bands,
    _align_corners_matrix,
    exchange_plan,
    padded_ranges,
    resize_ranges,
    row_bounds,
    window_ranges,
)
from vision_semantic_segmentation_tpu_torch.parallel.train_step import spatial_loss
from vision_semantic_segmentation_tpu_torch.train.build import build_dataloader
from vision_semantic_segmentation_tpu_torch.train.checkpoint import Checkpoint
from vision_semantic_segmentation_tpu_torch.train.datasets import DataLoader, Dataset
from vision_semantic_segmentation_tpu_torch.train.trainer import Trainer
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
GROUP_TIMEOUT = 120
CLASSES = 5
LR = 0.05
JAX_RTOL, JAX_ATOL = 1e-5, 1e-5
# the one-process banded step: the same f64 arithmetic in another order
BANDED_TOL = 1e-9
# the Trainer's first step in f32 against one process: see
# test_trainer_two_steps_match_one_process
STEP1_ATOL = 1e-5
MEAN, STD = "[0.485, 0.456, 0.406]", "[0.229, 0.224, 0.225]"
# (name, data groups, bands): the step cases held against JAX
STEP_CASES = [("1x2", 1, 2), ("2x2", 2, 2), ("1x4", 1, 4)]


def _tiny(cfg, dropout=0.0):
    cfg.MODEL.TYPE = "DeepLabv3+"
    cfg.MODEL.BACKBONE = "resnet18"
    cfg.MODEL.OUTPUT_STRIDE = 8
    cfg.MODEL.ASPP.OUT_CHANNELS = 16
    cfg.MODEL.ASPP.ATROUS_CHANNELS = [16, 16, 16, 16]
    cfg.MODEL.ASPP.DROPOUT = dropout
    cfg.MODEL.DECODER.LOW_LEVEL_OUT_CHANNELS = 8
    cfg.MODEL.DECODER.REFINE_CHANNELS = [16, 16]
    cfg.DATASET.NUM_CLASSES = CLASSES
    return cfg


def _batch(seed: int, b: int = 2, h: int = 64, w: int = 32) -> dict:
    """Images and labels whose ignored pixels differ between the images and
    the bands, so the global count is no sum of equal parts."""
    rng = np.random.default_rng(seed)
    label = rng.integers(0, CLASSES, (b, h, w)).astype(np.int64)
    label[0, : h // 3] = 255
    label[-1, -5:, :7] = 255
    return {"image": rng.standard_normal((b, h, w, 3)), "label": label}


# -- f64 resizes and loss on the port's side (the module docstring) ---------------------
def _port_resize_f64(x, out_hw):
    (h, w), (oh, ow) = x.shape[-3:-1], out_hw
    if (h, w) == (oh, ow):
        return x
    mh, mw = (torch.from_numpy(p_resize._align_corners_matrix(i, o)).double()
              for i, o in ((h, oh), (w, ow)))
    y = torch.einsum("oh,...hwc->...owc", mh, x.double())
    return torch.einsum("ow,...hwc->...hoc", mw, y).to(x.dtype)


def _band_resize_f64(src, mh, mw):
    x = src.permute(0, 2, 3, 1).double()
    y = torch.einsum("oh,...hwc->...owc", mh.double(), x)
    y = torch.einsum("ow,...hwc->...hoc", mw.double(), y)
    return y.to(src.dtype).permute(0, 3, 1, 2)


def _sum_count_f64(logits, labels, ignore_index=255):
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    nll = -F.log_softmax(logits.double(), dim=1).gather(1, safe.unsqueeze(1)).squeeze(1)
    w = valid.double()
    return (nll * w).sum(), w.sum()


class _f64:
    """The port's resizes (unbanded and banded) and loss summed in f64."""

    def __enter__(self):
        self.saved = (p_model_resize.resize_align_corners, spatial_infer._resize_band,
                      p_train_step.cross_entropy_sum_count)
        p_model_resize.resize_align_corners = _port_resize_f64
        spatial_infer._resize_band = _band_resize_f64
        p_train_step.cross_entropy_sum_count = _sum_count_f64

    def __exit__(self, *exc):
        (p_model_resize.resize_align_corners, spatial_infer._resize_band,
         p_train_step.cross_entropy_sum_count) = self.saved


def _state(weights: dict, dropout: float = 0.0) -> TrainState:
    model, *_ = build_train_model(_tiny(get_train_cfg_defaults(), dropout), device="cpu")
    model.load_state_dict(weights, strict=True)
    model.double()
    opt = torch.optim.SGD(model.parameters(), lr=LR, momentum=0.9)
    return TrainState(model, opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda s: 1.0),
                      torch.Generator().manual_seed(0))


def _tensors(batch: dict) -> dict:
    return {"image": torch.as_tensor(batch["image"], dtype=torch.float64),
            "label": torch.as_tensor(batch["label"]).long()}


def _mine(batch: dict, groups) -> dict:
    """This rank's data group's contiguous slice of a global batch."""
    n = batch["image"].shape[0] // groups.data_groups
    return {k: v[groups.data * n:(groups.data + 1) * n] for k, v in batch.items()}


class _Arrays(Dataset):
    def __init__(self, batch):
        self.batch = batch

    def __len__(self):
        return len(self.batch["image"])

    def __getitem__(self, i):
        return {k: np.asarray(v[i]) for k, v in self.batch.items()}


# -- the ranks -------------------------------------------------------------------------
def _case(case: dict, world) -> dict:
    groups = world.spatial_groups(case["bands"])
    groups.traffic.reset()
    batch = _tensors(case["batch"])
    kind = case["kind"]
    if kind == "train":
        state = _state(case["weights"], case.get("dropout", 0.0))
        if "seed" in case:
            torch.manual_seed(case["seed"])
        m = make_spatial_train_step(CLASSES, None, group=groups)(state, _mine(batch, groups))
        out = {"loss": float(m["loss"]), "confusion": m["confusion"].numpy(),
               "state": {k: v.numpy() for k, v in state.model.state_dict().items()}}
    elif kind == "eval_grads":
        model = _state(case["weights"]).model.eval()
        engine = SpatialModel(model, ranks=groups)
        mine = _mine(batch, groups)
        logits = engine(engine.split(mine["image"].permute(0, 3, 1, 2)), upsample_pred=True)
        loss, _ = spatial_loss(logits, engine.split(mine["label"], 1), CLASSES, 255, engine.home,
                               groups)
        loss.backward()
        all_reduce_([p.grad for p in model.parameters()], world.group)
        out = {"grads": {k: p.grad.numpy() for k, p in model.named_parameters()}}
    else:  # the eval step over the distributed loader's padded slices
        state = _state(case["weights"])
        loader = DataLoader(_Arrays(case["batch"]), batch_size=len(case["batch"]["image"]),
                            rank=groups.data, world=groups.data_groups)
        m = make_spatial_eval_step(CLASSES, None, group=groups)(state, _tensors(next(iter(loader))))
        out = {"loss": float(m["loss"]), "confusion": m["confusion"].numpy()}
    out["calls"] = dict(groups.traffic.calls)
    out["bytes"] = groups.traffic.bytes_sent
    return out


def task_steps(spec, rank: int) -> dict:
    cases = torch.load(spec["inputs"], weights_only=False)
    world = ensure_distributed("cpu")
    with _f64():
        return {name: _case(case, world) for name, case in cases.items()}


def _dummy_cfg(out, extra=()):
    cfg = get_train_cfg_defaults()
    cfg.merge_from_list(["MODEL.TYPE", "Dummy", "DATASET.NUM_CLASSES", "5",
                         "OPTIMIZER.TYPE", "SGD", "OPTIMIZER.BASE_LR", "0.05", "RNG_SEED", "3",
                         "TRAIN.BATCH_SIZE", "4", "TRAIN.SPATIAL_SHARDS", "2",
                         "MODEL.SYNC_BN", "True", "OUTPUT_DIR", out, *extra])
    return cfg


def trainer_cfg(spatial: int = 2):
    """The tiny DeepLab for the Trainer, in f32 with ASPP's dropout on."""
    cfg = _tiny(get_train_cfg_defaults(), dropout=0.5)
    cfg.merge_from_list(["MODEL.SYNC_BN", "True", "OPTIMIZER.TYPE", "SGD",
                         "OPTIMIZER.BASE_LR", "0.05", "OPTIMIZER.SGD.momentum", "0.9",
                         "SCHEDULER.TYPE", "PolyLRDecay", "SCHEDULER.PolyLRDecay.max_iter", "100",
                         "SCHEDULER.MAX_EPOCH", "1", "TRAIN.BATCH_SIZE", "2", "RNG_SEED", "7",
                         "TRAIN.SPATIAL_SHARDS", str(spatial)])
    return cfg


def trainer_batches():
    return [_batch(seed) for seed in (21, 22)]


def task_trainer_steps(spec, rank: int) -> dict:
    """``Trainer(distributed=True)`` with S = 2: its groups and
    ``spec["steps"]`` steps (default two)."""
    trainer = Trainer(trainer_cfg(), device="cpu", distributed=True)
    groups = trainer._groups
    losses, states = [], []
    for batch in trainer_batches()[:spec.get("steps", 2)]:
        m = trainer._train_step(trainer.state, trainer._on_device(batch, False))
        losses.append(float(m["loss"]))
        states.append({k: v.numpy().copy() for k, v in trainer.model.state_dict().items()})
    return {"losses": losses, "route": trainer._train_step.__qualname__,
            "groups": (groups.shards, groups.band, groups.data, groups.data_groups,
                       groups.backend), "states": states}


def _generators(trainer) -> dict:
    """The states a rank's dropout and host draws come from."""
    return {"device": torch.get_rng_state().numpy(),
            "augment": trainer.state.generator.get_state().numpy(),
            "python": random.getstate(), "numpy": np.random.get_state()[1]}


def task_trainer(spec, rank: int) -> dict:
    """On 4 ranks: the loader's slices and the generators, at the start and
    after a resume from rank 0's checkpoint at step 3; and each refusal."""
    out = spec["out_dir"]
    result = {}
    cfg = _dummy_cfg(out, ["DATASET.NAME", "Mapillary", "DATASET.ROOT_DIR", spec["data"],
                           "TRAIN.AUGMENTATION",
                           "[RandomHorizontalFlip, [RandomSizeAndCrop, 16, [0.5, 2.0], 255], "
                           f"ToTensor, [Normalize, {MEAN}, {STD}]]",
                           "DATALOADER.NUM_WORKERS", "3", "AUTO_RESUME", "True"])
    for phase in ("start", "resumed"):
        trainer = Trainer(cfg, output_dir=out, device="cpu", distributed=True)
        if phase == "start":
            trainer.state.step = 3
            trainer._save("model_0000003")
        else:
            trainer.resume()
            assert trainer.state.step == 3
        loader = build_dataloader(cfg, mode="train", distributed=True)
        loader.set_epoch(1)
        result[phase] = {"loader": [{k: np.asarray(v) for k, v in b.items()} for b in loader],
                         "generators": _generators(trainer), "workers": loader.num_workers}
        del trainer
    refusals = {
        "world": (["TRAIN.SPATIAL_SHARDS", "3"], None),
        "per_device": (["MODEL.SYNC_BN", "False"], None),
        "augment": (["TRAIN.DEVICE_AUGMENT.ENABLED", "True"], None),
        "batch": (["TRAIN.BATCH_SIZE", "3"], None),
        "micro": (["TRAIN.GRAD_ACCUM_STEPS", "4"], None),
        "crop_rows": ([], 33),
        "crop_stride": ([], 16),
    }
    for name, (extra, height) in refusals.items():
        try:
            trainer = Trainer(_dummy_cfg(out, extra), device="cpu", distributed=True)
            if height is not None:
                trainer._on_device(_batch(0, 2, height, 8), False)
        except (NotImplementedError, ValueError) as exc:
            result[name] = (type(exc).__name__, str(exc))
    return result


def task_cli(spec, rank: int) -> dict:
    """``train --distributed ... TRAIN.SPATIAL_SHARDS 2``: the losses, the
    launches of checkpoint writes and the log files of this rank."""
    writes = []
    write = Checkpoint._write
    Checkpoint._write = staticmethod(lambda path, payload: (writes.append(path),
                                                            write(path, payload)))
    trainer = cli_main(spec["argv"])
    logs = [h.baseFilename for h in logging.getLogger("train").handlers
            if isinstance(h, logging.FileHandler)]
    return {"history": trainer.history, "step": trainer.state.step, "logs": logs,
            "checkpoints": list(writes), "best": trainer.best_metric,
            "calls": dict(trainer._groups.traffic.calls)}


TASKS = {"steps": task_steps, "trainer_steps": task_trainer_steps, "trainer": task_trainer,
         "cli": task_cli}


def _worker(spec_path: str) -> None:
    with open(spec_path) as f:
        spec = json.load(f)
    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    if spec["open_group"]:  # else the Trainer joins from the environment
        dist.init_process_group("gloo", init_method="env://",
                                timeout=datetime.timedelta(seconds=GROUP_TIMEOUT))
    try:
        result = TASKS[spec["task"]](spec, rank)
        result = {"result": result, "jax_imported": "jax" in sys.modules}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    torch.save(result, osp.join(spec["out_dir"], f"rank{rank}.pt"))


# -- the harness -----------------------------------------------------------------------
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(out_dir, task: str, world: int, open_group: bool = True, **spec) -> list:
    """Run ``task`` on ``world`` child ranks; their results, rank by rank."""
    os.makedirs(out_dir, exist_ok=True)
    spec_path = osp.join(out_dir, "spec.json")
    with open(spec_path, "w") as f:
        json.dump({"task": task, "open_group": open_group, "out_dir": str(out_dir), **spec}, f)
    port = _free_port()
    procs, logs = [], []
    for r in range(world):
        env = {**os.environ, "RANK": str(r), "LOCAL_RANK": str(r), "WORLD_SIZE": str(world),
               "MASTER_ADDR": "localhost", "MASTER_PORT": str(port), "OMP_NUM_THREADS": "1",
               "PYTHONPATH": os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")])}
        log = open(osp.join(out_dir, f"rank{r}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen([sys.executable, osp.abspath(__file__), "--rank-worker",
                                       spec_path], env=env, stdout=log,
                                      stderr=subprocess.STDOUT, cwd=REPO))
    deadline = time.monotonic() + GROUP_TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        tails = {r: open(osp.join(out_dir, f"rank{r}.log")).read()[-3000:] for r in failed}
        pytest.fail(f"{task}: ranks {failed} failed or timed out after {GROUP_TIMEOUT} s: {tails}")
    results = [torch.load(osp.join(out_dir, f"rank{r}.pt"), weights_only=False)
               for r in range(world)]
    assert not any(r["jax_imported"] for r in results), "a rank imported jax"
    return [r["result"] for r in results]


# -- the exchange plan, no processes -----------------------------------------------------
def _windows():
    """(height, bands, ranges, fill) of every window kind the banded forms
    read: self-padding windows over kernels, strides and dilations (ASPP's
    at OS8 and OS16 among them), explicit asymmetric pads, the resizes."""
    out = []
    for height in (8, 17, 64):
        for bands in (2, 3, 4, 8):
            if height < bands:
                continue
            for k, s, p, d in ((3, 1, 1, 1), (3, 2, 1, 1), (1, 2, 0, 1), (3, 1, 2, 2),
                               (3, 1, 12, 12), (3, 1, 36, 36), (7, 2, 3, 1)):
                h_out, ranges, _ = window_ranges(height, bands, k, s, p, d)
                if h_out >= bands:
                    out.append((height, bands, ranges, -np.inf if k == 3 and s == 2 else 0.0))
            for k, s, top, bottom in ((3, 2, 0, 1), (3, 1, 1, 1), (1, 1, 0, 1)):
                h_out, ranges = padded_ranges(height, bands, k, s, 1, top, bottom)
                if h_out >= bands:
                    out.append((height, bands, ranges, 0.0))
            for out_h in (bands, 2 * height - 1, 4 * height, max(bands, height // 3)):
                out.append((height, bands, resize_ranges(_align_corners_matrix(height, out_h),
                                                         bands), 0.0))
    return out


@pytest.mark.parametrize("height,bands,ranges,fill", _windows())
def test_exchange_plan_reassembles_fetch(height, bands, ranges, fill):
    """Each band's plan, worked out from the bounds and the ranges alone:
    the rows its peers send it (their plans' ``send`` to it), between its
    fills, are exactly what ``Bands.fetch`` reads in one process, and a
    band receives from a peer exactly what that peer sends it."""
    x = torch.arange(2 * 3 * height * 5, dtype=torch.float64).reshape(2, 3, height, 5)
    one = Bands.split(x, [["cpu"] * bands], 2)
    bounds = row_bounds(height, bands)
    plans = [exchange_plan(bounds, ranges, b, height) for b in range(bands)]
    for b, plan in enumerate(plans):
        pieces = [torch.full((2, 3, plan.top, 5), fill, dtype=x.dtype)]
        for j, lo, hi in plan.recv:
            sent = [(lo2, hi2) for i, lo2, hi2 in plans[j].send if i == b]
            assert j == b or sent == [(lo, hi)], (b, j)
            pieces.append(one.parts[0][j].narrow(2, lo - bounds[j][0], hi - lo))
        pieces.append(torch.full((2, 3, plan.bottom, 5), fill, dtype=x.dtype))
        want = one.fetch(0, "cpu", *ranges[b], fill=fill)
        assert torch.equal(torch.cat(pieces, 2), want), b
        received = {j for j, _, _ in plan.recv if j != b}
        assert {j for j, p in enumerate(plans) if any(i == b for i, _, _ in p.send)} == received


def test_traffic_counts_and_times():
    """``Traffic`` counts every call by kind; with ``timed`` it also sums
    each kind's seconds (phase 14 of ``chip_smoke.py`` reads them)."""
    traffic = Traffic()
    with traffic.record("exchange", torch.device("cpu")):
        pass
    traffic.timed = True
    for _ in range(2):
        with traffic.record("all_reduce", torch.device("cpu")):
            time.sleep(0.01)
    assert traffic.calls == {"exchange": 1, "all_reduce": 2}
    assert set(traffic.seconds) == {"all_reduce"} and traffic.seconds["all_reduce"] >= 0.02
    traffic.reset()
    assert not traffic.calls and not traffic.seconds and traffic.bytes_sent == 0


# -- the reference sides -----------------------------------------------------------------
@pytest.fixture(scope="module")
def setup():
    """The JAX model's initial variables (f64), and the batches."""
    import jax
    import jax.numpy as jnp

    from vision_semantic_segmentation_tpu.config import get_train_cfg_defaults as j_cfg
    from vision_semantic_segmentation_tpu.models.build import build_model as j_build_model
    from vision_semantic_segmentation_tpu_torch.models import flax_to_state_dict

    jmodel, *_ = j_build_model(_tiny(j_cfg()))
    variables = jax.jit(lambda k, x: jmodel.init(k, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    variables = jax.tree.map(lambda v: np.asarray(v, np.float64), dict(variables))
    weights = {k: v.double() for k, v in flax_to_state_dict(variables).items()}
    return {"jmodel": jmodel, "variables": variables, "weights": weights,
            "train": _batch(1), "eval": _batch(2, b=3)}


def _cases(setup, world: int) -> dict:
    w = setup["weights"]
    if world == 2:
        return {"1x2": {"kind": "train", "bands": 2, "batch": setup["train"], "weights": w},
                "1x2_dropout": {"kind": "train", "bands": 2, "batch": setup["train"],
                                "weights": w, "dropout": 0.5, "seed": 11}}
    return {"2x2": {"kind": "train", "bands": 2, "batch": setup["train"], "weights": w},
            "1x4": {"kind": "train", "bands": 4, "batch": setup["train"], "weights": w},
            "grads": {"kind": "eval_grads", "bands": 4, "batch": setup["train"], "weights": w},
            "eval": {"kind": "eval", "bands": 2, "batch": setup["eval"], "weights": w}}


class _Ranks(dict):
    """Each world's step cases, run as one group of children when a test
    first asks for one of them (so each group's time lands on its first
    test)."""

    def __init__(self, setup, tmp_path_factory):
        super().__init__()
        self.setup, self.tmp = setup, tmp_path_factory

    def __missing__(self, name):
        world = 2 if name.startswith("1x2") else 4
        d = self.tmp.mktemp(f"ranks{world}")
        torch.save(_cases(self.setup, world), d / "inputs.pt")
        results = run_ranks(d, "steps", world, inputs=str(d / "inputs.pt"))
        for case in results[0]:
            self[case] = [r[case] for r in results]
        return self[name]


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    """Every step case, by name, rank by rank."""
    return _Ranks(setup, tmp_path_factory)


def _jax_flat(jstate) -> dict:
    import jax

    from vision_semantic_segmentation_tpu_torch.models import flax_to_state_dict

    tree = {"params": jax.tree.map(np.asarray, jstate.params),
            "batch_stats": jax.tree.map(np.asarray, jstate.batch_stats)}
    return {k: v.numpy() for k, v in flax_to_state_dict(tree).items()
            if not k.endswith("num_batches_tracked")}


def _jax_mesh(data: int, bands: int):
    import jax

    from vision_semantic_segmentation_tpu.parallel import create_mesh as j_create_mesh

    return j_create_mesh((data, bands), ("data", "spatial"), devices=jax.devices()[:data * bands])


def _jax_state(setup):
    import jax
    import optax

    from vision_semantic_segmentation_tpu.parallel import TrainState as JState

    return JState.create(setup["jmodel"], setup["variables"], optax.sgd(LR, momentum=0.9),
                         jax.random.PRNGKey(1))


# -- the tests ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["1x2", "1x2_dropout", "2x2", "1x4", "grads", "eval"])
def test_collectives_equal_on_every_rank(ranks, name):
    """Every rank made the same collective calls, each kind as many times
    (the step itself checks the total at its end); a training step's
    backward makes one reverse exchange per forward exchange but the first
    conv's, whose input (the image) takes no gradient."""
    calls = [r["calls"] for r in ranks[name]]
    assert all(c == calls[0] for c in calls), calls
    assert calls[0]["exchange"] > 0 and calls[0]["all_reduce"] > 0
    if name != "eval":
        assert calls[0]["exchange_backward"] == calls[0]["exchange"] - 1
    assert all(r["bytes"] > 0 for r in ranks[name])


@pytest.mark.parametrize("name,data,bands", STEP_CASES, ids=[c[0] for c in STEP_CASES])
def test_step_matches_jit_spatial_train_step(setup, ranks, name, data, bands):
    """One banded step on ``data x bands`` ranks against the JAX package's
    ``jit_spatial_train_step`` on a (data, spatial) mesh of as many of its
    CPU devices: every rank holds the same loss, confusion and state.  At
    1x4 the OS8 map holds 2 rows a band, and the dilated halos of layer4
    and ASPP cross two bands."""
    from test_torch_train_step import _jax_f64
    from vision_semantic_segmentation_tpu.parallel import (
        jit_spatial_train_step,
        make_train_step as j_make_train_step,
        shard_spatial_batch,
    )

    mesh = _jax_mesh(data, bands)
    batch = {"image": setup["train"]["image"], "label": setup["train"]["label"].astype(np.int32)}
    with _jax_f64():
        step = jit_spatial_train_step(j_make_train_step(num_classes=CLASSES), mesh)
        state, m = step(_jax_state(setup), shard_spatial_batch(mesh, batch))
        want = {"loss": float(m["loss"]), "confusion": np.asarray(m["confusion"]),
                "state": _jax_flat(state)}
    for got in ranks[name]:
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=JAX_RTOL)
        np.testing.assert_array_equal(got["confusion"], want["confusion"])
        for k, v in want["state"].items():
            np.testing.assert_allclose(got["state"][k], v, atol=JAX_ATOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("name,data,bands,dropout", [
    ("1x2", 1, 2, 0.0), ("2x2", 2, 2, 0.0), ("1x4", 1, 4, 0.0), ("1x2_dropout", 1, 2, 0.5)])
def test_step_matches_one_process_banded(setup, ranks, name, data, bands, dropout):
    """The same step on logical shards of one process
    (``make_spatial_train_step`` over a ``["cpu"] * (data x bands)`` mesh)
    within ``BANDED_TOL``; with ASPP's dropout, the ranks of the image draw
    the one-process step's mask from generators seeded alike."""
    mesh = create_mesh((data, bands), ("data", "spatial"), devices=["cpu"] * (data * bands))
    state = _state(setup["weights"], dropout)
    with _f64():
        torch.manual_seed(11)
        m = make_spatial_train_step(CLASSES, mesh)(state, _tensors(setup["train"]))
    want = {k: v.numpy() for k, v in state.model.state_dict().items()}
    for got in ranks[name]:
        np.testing.assert_allclose(got["loss"], float(m["loss"]), rtol=BANDED_TOL)
        np.testing.assert_array_equal(got["confusion"], m["confusion"].numpy())
        for k, v in want.items():
            np.testing.assert_allclose(got["state"][k], v, atol=BANDED_TOL, rtol=0, err_msg=k)


def test_backward_halos_eval_mode_grads(setup, ranks):
    """Eval-mode (running-statistics) gradients through 4 bands across
    ranks against JAX's on a 4-device ('spatial',) mesh (JAX's
    ``test_backward_halos_eval_mode_grads``), within 1e-5 of each leaf's
    largest value: a cotangent row that does not reach its owner is O(1)
    wrong on the early convs."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from test_torch_train_step import _jax_f64, _jax_loss_f64
    from vision_semantic_segmentation_tpu.parallel import create_mesh as j_create_mesh

    jmodel, variables = setup["jmodel"], setup["variables"]
    mesh = j_create_mesh(axis_names=("spatial",), devices=jax.devices()[:4])
    rep, sh = NamedSharding(mesh, P()), NamedSharding(mesh, P(None, "spatial"))
    batch = setup["train"]

    def loss_fn(params, image, label):
        logits = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]}, image,
                              train=False, upsample_pred=True)
        return _jax_loss_f64(logits, label)

    with _jax_f64():
        grads = jax.jit(jax.grad(loss_fn), in_shardings=(rep, sh, sh), out_shardings=rep)(
            variables["params"], jax.device_put(batch["image"], sh),
            jax.device_put(batch["label"].astype(np.int32), sh))
    want = _jax_flat(type("G", (), {"params": grads, "batch_stats": {}})())
    for got in ranks["grads"]:
        assert set(got["grads"]) == set(want)
        for k, a in want.items():
            scale = np.max(np.abs(a)) + 1e-30
            assert np.max(np.abs(a - got["grads"][k])) <= JAX_ATOL * scale, k


def test_eval_step_pads_to_the_data_axis(setup, ranks):
    """A batch of 3 over 2 data groups of 2 bands: the distributed loader
    pads the second group's slice with an ignored copy, and the loss and
    confusion are the 3 images' (JAX's ``jit_spatial_eval_step`` over the
    JAX trainer's padded batch)."""
    from types import SimpleNamespace

    from test_torch_train_step import _jax_f64
    from vision_semantic_segmentation_tpu.parallel import (
        jit_spatial_eval_step,
        make_eval_step as j_make_eval_step,
        shard_spatial_batch,
    )
    from vision_semantic_segmentation_tpu.train.trainer import Trainer as JTrainer

    batch = {"image": setup["eval"]["image"], "label": setup["eval"]["label"].astype(np.int32)}
    padded = JTrainer._pad_batch(SimpleNamespace(_data_size=2), batch)
    mesh = _jax_mesh(2, 2)
    with _jax_f64():
        m = jit_spatial_eval_step(j_make_eval_step(num_classes=CLASSES), mesh)(
            _jax_state(setup), shard_spatial_batch(mesh, padded))
    for got in ranks["eval"]:
        np.testing.assert_allclose(got["loss"], float(m["loss"]), rtol=JAX_RTOL)
        np.testing.assert_array_equal(got["confusion"], np.asarray(m["confusion"]))


def test_trainer_two_steps_match_one_process(tmp_path):
    """``Trainer(distributed=True)`` with S = 2 on 2 ranks (f32, ASPP's
    dropout 0.5, the ranks' generators seeded alike) builds its groups and
    steps as the one-process ``Trainer(devices=["cpu"] * 2)``: the first
    loss within 1e-6 relative and every parameter and running statistic
    after it within ``STEP1_ATOL``; after the second step the two ranks
    hold equal states.  The bands sum ASPP's pooled cotangents after its
    BatchNorm's backward, one process before it, so the first step's
    parameters differ by f32 rounding (7e-7 measured); at a batch of 2 the
    second step grows that to 3e-3 (``tests/test_torch_train_step.py``
    measures this conditioning), so later steps are held across ranks, not
    to one process, as in ``tests/test_torch_data_parallel.py``."""
    got = run_ranks(tmp_path, "trainer_steps", 2, open_group=False)
    one = Trainer(trainer_cfg(), device="cpu", devices=["cpu"] * 2)
    want, states = [], []
    for b in trainer_batches():
        want.append(float(one._train_step(one.state, one._on_device(b, False))["loss"]))
        states.append({k: v.numpy().copy() for k, v in one.model.state_dict().items()})
    for r, res in enumerate(got):
        assert res["route"].startswith("make_spatial_train_step")
        assert res["groups"] == (2, r, 0, 1, "gloo")
        np.testing.assert_allclose(res["losses"][0], want[0], rtol=1e-6)
        assert np.isfinite(res["losses"][1]) and res["losses"] == got[0]["losses"]
        for k, v in states[0].items():
            np.testing.assert_allclose(res["states"][0][k], v, atol=STEP1_ATOL, rtol=0, err_msg=k)
    for k, v in got[0]["states"][1].items():
        np.testing.assert_array_equal(got[1]["states"][1][k], v, err_msg=k)


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    from test_torch_train import _write_dataset

    tmp = tmp_path_factory.mktemp("spatial_trainer")
    _write_dataset(str(tmp / "data"), n_train=8, n_val=2, hw=(32, 32), seed=5)
    return run_ranks(tmp / "ranks", "trainer", 4, open_group=False, data=str(tmp / "data"))


@pytest.mark.parametrize("phase", ["start", "resumed"])
def test_group_reads_the_same_images(trainers, phase):
    """4 ranks, S = 2: the two ranks of a data group decode the same slice of
    each global batch, random crops and flips included, on 3 decode threads
    a rank (each sample's own seed); the two data groups' slices differ.
    The JAX package's per-process dataset shard, which would give one
    image's bands to processes that loaded different images, is not
    copied."""
    loaders = [r[phase]["loader"] for r in trainers]
    assert all(r[phase]["workers"] == 3 for r in trainers)
    assert len(loaders[0]) == 2 and loaders[0][0]["image"].shape[0] == 2
    for a, b in ((0, 1), (2, 3)):
        for x, y in zip(loaders[a], loaders[b]):
            for k in ("image", "label"):
                np.testing.assert_array_equal(x[k], y[k])
    assert not np.array_equal(loaders[0][0]["image"], loaders[2][0]["image"])


@pytest.mark.parametrize("phase", ["start", "resumed"])
def test_group_draws_alike(trainers, phase):
    """The generators dropout and the host draw from are alike on an
    image's two ranks and differ between data groups, at the start and
    after every rank resumed from rank 0's checkpoint (whose file holds
    rank 0's generators: rank 0 reseeds by data group with the others)."""
    gens = [r[phase]["generators"] for r in trainers]
    for key in ("device", "augment", "python", "numpy"):
        for a, b in ((0, 1), (2, 3)):
            assert _same(gens[a][key], gens[b][key]), (key, a, b)
        assert not _same(gens[0][key], gens[2][key]), key


def _same(a, b) -> bool:
    return (np.array_equal(a, b) if isinstance(a, np.ndarray)
            else repr(a) == repr(b))


@pytest.mark.parametrize("workers", [0, 3])
def test_sample_seeds_ignore_worker_threads(workers):
    """With ``sample_seed`` a sample's random scale, crop and flip depend on
    its seed, epoch and index alone: 3 decode threads give what one does,
    and the next epoch draws anew."""
    from vision_semantic_segmentation_tpu_torch.train.build import build_transform

    rng = np.random.default_rng(4)
    images = rng.integers(0, 255, (6, 20, 24, 3), dtype=np.uint8)
    labels = rng.integers(0, CLASSES, (6, 20, 24), dtype=np.uint8)
    transform = build_transform([["RandomHorizontalFlip"],
                                 ["RandomSizeAndCrop", 12, [0.5, 2.0], 255]])

    class Images(Dataset):
        def __len__(self):
            return len(images)

        def __getitem__(self, i):
            return transform({"image": images[i], "label": labels[i]})

    def epoch(num_workers, e):
        loader = DataLoader(Images(), batch_size=3, num_workers=num_workers, sample_seed=11)
        loader.set_epoch(e)
        return [b["image"] for b in loader]

    random.seed(0)  # the transforms draw no number from Python's own stream
    state = random.getstate()
    got = epoch(workers, 0)
    assert random.getstate() == state
    for a, b in zip(got, epoch(0, 0)):
        np.testing.assert_array_equal(a, b)
    assert not all(np.array_equal(a, b) for a, b in zip(got, epoch(workers, 1)))


@pytest.mark.parametrize("name,kind,words", [
    ("world", "ValueError", "TRAIN.SPATIAL_SHARDS=3 does not divide the world of 4 ranks"),
    ("per_device", "NotImplementedError", "requires the SyncBN train step"),
    ("augment", "NotImplementedError", "TRAIN.DEVICE_AUGMENT composes with data parallelism"),
    ("batch", "ValueError", "does not split over 2 data groups"),
    ("micro", "ValueError", "GRAD_ACCUM_STEPS=4 x 2 data groups"),
    ("crop_rows", "ValueError", "(got H=33)"),
    ("crop_stride", "ValueError", "(got H=16)"),
])
def test_refusals_on_every_rank(trainers, name, kind, words):
    """The JAX trainer's refusals, raised on all 4 ranks before any
    collective (no rank waits for another: the group finished)."""
    for r in trainers:
        assert r[name][0] == kind and words in r[name][1], r[name]


def test_train_command_bands_across_ranks(tmp_path):
    """``train --distributed ... TRAIN.SPATIAL_SHARDS 2`` through ``main`` on
    2 ranks (DeepLabV3+ resnet18 OS16 on 32x32 crops: 2 rows a band at
    OS16), one epoch of 2 steps and a validation: every step's loss equal
    on both ranks, the first within 1e-6 relative of the one-process banded
    Trainer's ``fit`` on the same files (the command line cannot name a
    mesh; later steps as in the Trainer's test above), the collective calls
    equal, and rank 0 alone writing the log and the checkpoints."""
    from test_torch_train import _write_dataset

    _write_dataset(str(tmp_path / "data"), n_train=4, n_val=2, hw=(32, 32), seed=6)
    (tmp_path / "train.yaml").write_text("TASK_NAME: bands\n")

    def argv(out, spatial, *extra):
        opts = ["DATASET.NAME", "Mapillary", "DATASET.ROOT_DIR", str(tmp_path / "data"),
                "DATASET.NUM_CLASSES", "5", "MODEL.TYPE", "DeepLabv3+",
                "MODEL.BACKBONE", "resnet18", "MODEL.OUTPUT_STRIDE", "16",
                "MODEL.ASPP.DROPOUT", "0.0", "MODEL.SYNC_BN", "True", "OUTPUT_DIR", str(out),
                "OPTIMIZER.TYPE", "SGD", "OPTIMIZER.BASE_LR", "0.01", "RNG_SEED", "5",
                "TRAIN.BATCH_SIZE", "2", "SCHEDULER.MAX_EPOCH", "1",
                "TRAIN.AUGMENTATION", f"[ToTensor, [Normalize, {MEAN}, {STD}]]",
                "VALIDATE.AUGMENTATION", f"[ToTensor, [Normalize, {MEAN}, {STD}]]",
                "VALIDATE.PERIOD", "1", "VALIDATE.BATCH_SIZE", "2",
                "TRAIN.SPATIAL_SHARDS", str(spatial), "DATALOADER.NUM_WORKERS", "0"]
        return ["train", "--cfg", str(tmp_path / "train.yaml"), *opts, "--device", "cpu", *extra]

    rank0, rank1 = run_ranks(tmp_path / "ranks", "cli", 2, open_group=False,
                             argv=argv(tmp_path / "bands", 2, "--distributed"))
    cfg = get_train_cfg_defaults()
    cfg.merge_from_list(argv(tmp_path / "one", 2)[3:-2])
    one = Trainer(cfg, output_dir=str(tmp_path / "one"), device="cpu", devices=["cpu"] * 2)
    one.fit()
    want = [h["loss"] for h in one.history]
    got = [[h["loss"] for h in r["history"]] for r in (rank0, rank1)]
    assert len(got[0]) == 2 and got[0] == got[1] and np.isfinite(got[0]).all()
    np.testing.assert_allclose(got[0][0], want[0], rtol=1e-6)
    assert rank0["step"] == rank1["step"] == 2 and rank0["best"] == rank1["best"]
    assert rank0["calls"] == rank1["calls"]
    assert len(rank0["logs"]) == 1 and rank0["checkpoints"]
    assert rank1["logs"] == [] and rank1["checkpoints"] == []


if __name__ == "__main__" and "--rank-worker" in sys.argv:
    _worker(sys.argv[sys.argv.index("--rank-worker") + 1])

"""Port parity: data-parallel training over ``torch.distributed`` (gloo, two
ranks on the CPU) against the JAX package's 2-device CPU mesh.

The ranks are child processes of this file, run as ``python
tests/test_torch_data_parallel.py --rank-worker spec.json`` with
``torchrun``'s environment variables (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``/``MASTER_PORT`` on a free local port).  They import torch and
the port alone: this module imports JAX inside its tests and fixtures,
never at module level.  Each child runs one PyTorch thread.  A group that
has not finished within ``GROUP_TIMEOUT`` seconds is killed and its test
fails; the gloo group itself times out at the same bound.

The same numpy-seeded inputs and flax variables (crossed through
``flax_to_state_dict``) go to both sides.  Tolerances, as in
``tests/test_torch_train_step.py``: the loss within 1e-5 relative, the
confusion exactly, every parameter and BatchNorm running statistic within
1e-5 absolute.  Labels are ignored unevenly across the two ranks, so the
global batch's mean over counted pixels differs from the mean of the
ranks' means.  DeepLabV3+ runs in f64 on both sides for the reason that
file gives (its resizes and loss summed in f64; the loss in both its forms,
the mean and the global-batch step's sum and count).
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
import torch.nn as nn
import torch.nn.functional as F

from vision_semantic_segmentation_tpu_torch.__main__ import main as cli_main
from vision_semantic_segmentation_tpu_torch.config import get_train_cfg_defaults
from vision_semantic_segmentation_tpu_torch.models import build_train_model, flax_to_state_dict
from vision_semantic_segmentation_tpu_torch.models import resize as p_model_resize
from vision_semantic_segmentation_tpu_torch.models.layers import BatchNorm2d
from vision_semantic_segmentation_tpu_torch.ops import resize as p_resize
from vision_semantic_segmentation_tpu_torch.parallel import (
    TrainState,
    make_multi_train_step,
    make_per_device_bn_train_step,
    make_train_step,
)
from vision_semantic_segmentation_tpu_torch.parallel import train_step as p_train_step
from vision_semantic_segmentation_tpu_torch.train.checkpoint import Checkpoint
from vision_semantic_segmentation_tpu_torch.train.datasets import DataLoader, Dataset
from vision_semantic_segmentation_tpu_torch.train.optim import (
    build_optimizer,
    build_schedule,
    build_scheduler,
)
from vision_semantic_segmentation_tpu_torch.train.trainer import Trainer
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
WORLD = 2
GROUP_TIMEOUT = 120
LR = 0.05
MEAN, STD = "[0.485, 0.456, 0.406]", "[0.229, 0.224, 0.225]"


# -- the ranks -----------------------------------------------------------------------
class BNNet(nn.Module):
    """conv + BatchNorm + ReLU + conv: the JAX tests' BNNet
    (``tests/test_parallel.py:195-205``), flax names crossed."""

    def __init__(self):
        super().__init__()
        self.Conv = nn.ModuleList([nn.Conv2d(3, 8, 3, padding=1), nn.Conv2d(8, 3, 1)])
        self.bn = BatchNorm2d(8, eps=1e-5)

    def forward(self, x, upsample_pred=True):
        return self.Conv[1](F.relu(self.bn(self.Conv[0](x))))


def _port_resize_f64(x, out_hw):
    """The port's align-corners resize summed in f64, in x's type."""
    (h, w), (oh, ow) = x.shape[-3:-1], out_hw
    if (h, w) == (oh, ow):
        return x
    mh, mw = (torch.from_numpy(p_resize._align_corners_matrix(i, o)).double()
              for i, o in ((h, oh), (w, ow)))
    y = torch.einsum("oh,...hwc->...owc", mh, x.double())
    return torch.einsum("ow,...hwc->...hoc", mw, y).to(x.dtype)


def _port_sum_count_f64(logits, labels, ignore_index=255):
    """The port's cross entropy's sum and count in f64."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    nll = -F.log_softmax(logits.double(), dim=1).gather(1, safe.unsqueeze(1)).squeeze(1)
    w = valid.double()
    return (nll * w).sum(), w.sum()


def _port_loss_f64(logits, labels, ignore_index=255):
    """The port's cross entropy in f64 (its value as f32)."""
    total, count = _port_sum_count_f64(logits, labels, ignore_index)
    return (total / count.clamp_min(1e-12)).float()


def _case_state(case) -> TrainState:
    dtype = getattr(torch, case["dtype"])
    if case["model"] == "bnnet":
        model = BNNet()
    else:
        cfg = get_train_cfg_defaults()
        cfg.merge_from_list(case["overrides"])
        model, *_ = build_train_model(cfg, device="cpu")
    model.load_state_dict(case["state"], strict=True)
    model.to(dtype)
    if case["optimizer"] == "sgd":
        opt = torch.optim.SGD(model.parameters(), lr=LR, momentum=0.9)
        sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda s: 1.0)
    else:
        opt = build_optimizer(cfg, model.parameters())
        sched = build_scheduler(opt, build_schedule(cfg))
    return TrainState(model, opt, sched, torch.Generator().manual_seed(0))


def _run_case(case, rank: int, group) -> dict:
    """One case's steps on this rank's slice of each global batch."""
    if not case.get("f64"):
        return _steps(case, rank, group)
    saved = (p_model_resize.resize_align_corners, p_train_step.cross_entropy_loss,
             p_train_step.cross_entropy_sum_count)
    p_model_resize.resize_align_corners = _port_resize_f64
    p_train_step.cross_entropy_loss = _port_loss_f64
    p_train_step.cross_entropy_sum_count = _port_sum_count_f64
    try:
        return _steps(case, rank, group)
    finally:
        (p_model_resize.resize_align_corners, p_train_step.cross_entropy_loss,
         p_train_step.cross_entropy_sum_count) = saved


def _steps(case, rank: int, group) -> dict:
    state = _case_state(case)
    kw = case["options"]
    micro = kw.get("accum_steps", 1)

    def mine(t):
        """This rank's part of each micro-batch (``DataLoader``'s split)."""
        parts = t.reshape(t.shape[0], micro, WORLD, -1, *t.shape[2:])[:, :, rank]
        return parts.reshape(t.shape[0], -1, *t.shape[2:])

    batches = {"image": mine(torch.from_numpy(case["images"]).to(getattr(torch, case["dtype"]))),
               "label": mine(torch.from_numpy(case["labels"]).long())}
    n, kind, steps = case["num_classes"], case["kind"], len(case["images"])
    if kind in ("multi", "per_device_multi"):
        step = (make_multi_train_step(n, steps, group=group, **kw) if kind == "multi"
                else make_per_device_bn_train_step(n, group, steps=steps, **kw))
        metrics = [step(state, batches)]
    else:
        step = (make_train_step(n, group=group, **kw) if kind == "global"
                else make_per_device_bn_train_step(n, group, **kw))
        metrics = [step(state, {k: v[i] for k, v in batches.items()}) for i in range(steps)]
    return {"loss": [m["loss"].numpy() for m in metrics],
            "confusion": [m["confusion"].numpy() for m in metrics],
            "state": {k: v.numpy() for k, v in state.model.state_dict().items()},
            "steps": state.step}


def task_steps(spec, rank: int) -> dict:
    cases = torch.load(spec["inputs"], weights_only=False)
    return {name: _run_case(case, rank, dist.group.WORLD) for name, case in cases.items()}


def _dummy_cfg(out, extra=()):
    cfg = get_train_cfg_defaults()
    cfg.merge_from_list(["MODEL.TYPE", "Dummy", "DATASET.NUM_CLASSES", "5",
                         "OPTIMIZER.TYPE", "SGD", "OPTIMIZER.BASE_LR", "0.05",
                         "RNG_SEED", "3", "TRAIN.BATCH_SIZE", "4", "OUTPUT_DIR", out, *extra])
    return cfg


def _draw(trainer: Trainer):
    """This rank's dropout mask, augmentation draw and host draw."""
    return (F.dropout(torch.ones(4096), 0.5).numpy(),
            torch.rand(16, generator=trainer.state.generator).numpy(),
            random.random())


def task_trainer(spec, rank: int) -> dict:
    """Trainers joining the group from the environment: per-rank streams
    (twice, then one device), and the refusals."""
    out = spec["out_dir"]
    draws = [_draw(Trainer(_dummy_cfg(out), device="cpu", distributed=True)) for _ in range(2)]
    result = {"draws": draws, "world": dist.get_world_size(), "rank": dist.get_rank()}
    if rank == 0:
        result["one_device"] = _draw(Trainer(_dummy_cfg(out), device="cpu"))
    refusals = {
        "remat": ([], {"remat": True}),
        "accum": (["TRAIN.GRAD_ACCUM_STEPS", "2"], {}),
        "batch": (["TRAIN.BATCH_SIZE", "3"], {}),
        "micro": (["MODEL.SYNC_BN", "True", "TRAIN.GRAD_ACCUM_STEPS", "4"], {}),
        "spatial": (["TRAIN.SPATIAL_SHARDS", "2"], {}),
    }
    for name, (extra, kw) in refusals.items():
        try:
            Trainer(_dummy_cfg(out, extra), device="cpu", distributed=True, **kw)
        except (NotImplementedError, ValueError) as exc:
            result[name] = (type(exc).__name__, str(exc))
    # the global-batch path takes remat (and SYNC_BN routes to it)
    trainer = Trainer(_dummy_cfg(out, ["MODEL.SYNC_BN", "True", "TRAIN.GRAD_ACCUM_STEPS", "2"]),
                      device="cpu", distributed=True, remat=True)
    result["sync_route"] = trainer._train_step.__qualname__
    trainer = Trainer(_dummy_cfg(out), device="cpu", distributed=True)
    result["per_device_route"] = trainer._train_step.__qualname__
    result["preempt"] = _preempt_on_rank1(out, rank)
    result["split_resume"] = _resume_without_rank1s_file(out, rank)
    return result


def _resume_without_rank1s_file(out: str, rank: int):
    """AUTO_RESUME where rank 0 finds the preemption run's checkpoint (step
    2) and rank 1, in a directory of its own, finds none."""
    save_dir = osp.join(out, "preempt" if rank == 0 else "empty")
    trainer = Trainer(_dummy_cfg(save_dir, ["AUTO_RESUME", "True"]), output_dir=save_dir,
                      device="cpu", distributed=True)
    try:
        trainer.resume()
    except RuntimeError as exc:
        return str(exc)
    return None


def _preempt_on_rank1(out: str, rank: int) -> dict:
    """``fit`` over 4 batches an epoch for 3 epochs; rank 1 alone asks for
    preemption as its third batch arrives."""
    save_dir = osp.join(out, "preempt")
    cfg = _dummy_cfg(save_dir, ["VALIDATE.PERIOD", "0", "DATALOADER.PREFETCH_BATCHES", "0",
                                "SCHEDULER.MAX_EPOCH", "3"])
    trainer = Trainer(cfg, output_dir=save_dir, device="cpu", distributed=True)
    rng = np.random.default_rng(rank)

    class Batches:
        def __len__(self):
            return 4

        def __iter__(self):
            for i in range(4):
                if rank == 1 and i == 2:
                    trainer.request_preempt()
                yield {"image": rng.standard_normal((2, 8, 8, 3)).astype(np.float32),
                       "label": rng.integers(0, 5, (2, 8, 8)).astype(np.int32)}

    trainer.fit(train_loader=Batches())
    saved = None
    if rank == 0:
        pointer = open(osp.join(save_dir, "last_checkpoint")).read().strip()
        saved = (pointer, torch.load(osp.join(save_dir, pointer), weights_only=False)["step"])
    return {"step": trainer.state.step, "preempted": trainer._preempted,
            "losses": [h["loss"] for h in trainer.history], "saved": saved}


def task_cli(spec, rank: int) -> dict:
    """``train --distributed``, then a longer schedule resumed; which files
    each rank's run wrote."""
    writes = []
    write = Checkpoint._write
    Checkpoint._write = staticmethod(lambda path, payload: (writes.append(path),
                                                            write(path, payload)))
    runs = {}
    for name, argv in spec["runs"].items():
        trainer = cli_main(argv)
        logs = [h.baseFilename for h in logging.getLogger("train").handlers
                if isinstance(h, logging.FileHandler)]
        runs[name] = {"history": trainer.history, "best": trainer.best_metric,
                      "step": trainer.state.step, "device": str(trainer.device),
                      "logs": logs, "checkpoints": list(writes)}
        writes.clear()
    return runs


TASKS = {"steps": task_steps, "trainer": task_trainer, "cli": task_cli}


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


# -- the harness ---------------------------------------------------------------------
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(out_dir, task: str, open_group: bool = True, **spec) -> list:
    """Run ``task`` on ``WORLD`` child ranks; their results, rank by rank."""
    os.makedirs(out_dir, exist_ok=True)
    spec_path = osp.join(out_dir, "spec.json")
    with open(spec_path, "w") as f:
        json.dump({"task": task, "open_group": open_group, "out_dir": str(out_dir), **spec}, f)
    port = _free_port()
    procs, logs = [], []
    for r in range(WORLD):
        env = {**os.environ, "RANK": str(r), "LOCAL_RANK": str(r), "WORLD_SIZE": str(WORLD),
               "MASTER_ADDR": "localhost", "MASTER_PORT": str(port), "OMP_NUM_THREADS": "1",
               "PYTHONPATH": os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")])}
        log = open(osp.join(out_dir, f"rank{r}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen([sys.executable, __file__, "--rank-worker", spec_path],
                                      env=env, stdout=log, stderr=subprocess.STDOUT, cwd=REPO))
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
               for r in range(WORLD)]
    assert not any(r["jax_imported"] for r in results), "a rank imported jax"
    return [r["result"] for r in results]


# -- the JAX side --------------------------------------------------------------------
def _uneven_labels(rng, steps, batch, hw, classes):
    """Labels whose ignored pixels differ between the ranks' halves."""
    label = rng.integers(0, classes, (steps, batch, hw, hw)).astype(np.int32)
    label[:, 0] = 255                        # rank 0: its first sample ignored
    label[:, 1, : hw // 2] = 255             # ... and half of its second
    label[:, batch // 2 :, :2, :3] = 255     # rank 1: a corner
    return label


def _jax_flat(jstate):
    out = flax_to_state_dict({"params": _np_tree(jstate.params),
                              "batch_stats": _np_tree(jstate.batch_stats)})
    return {k: v.numpy() for k, v in out.items() if not k.endswith("num_batches_tracked")}


def _np_tree(tree):
    import jax

    return jax.tree.map(np.asarray, dict(tree))


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    """Every step case on both sides: the JAX results, and the ranks'."""
    import flax.linen as jnn
    import jax
    import jax.numpy as jnp
    import optax

    from test_torch_train_step import CLASSES, OVERRIDES, Setup, _jax_f64
    from vision_semantic_segmentation_tpu.config import get_train_cfg_defaults as j_cfg
    from vision_semantic_segmentation_tpu.models.build import build_model as j_build_model
    from vision_semantic_segmentation_tpu.parallel import (
        create_mesh,
        jit_multi_train_step,
        jit_train_step,
        shard_batch,
        shard_stacked_batches,
    )
    from vision_semantic_segmentation_tpu.parallel import train_step as jts

    class JBNNet(jnn.Module):
        @jnn.compact
        def __call__(self, x, train=False, upsample_pred=True):
            x = jnn.Conv(8, (3, 3), padding=((1, 1), (1, 1)))(x)
            x = jnn.BatchNorm(use_running_average=not train, momentum=0.9, epsilon=1e-5,
                              name="bn")(x)
            return jnn.Conv(3, (1, 1))(jnn.relu(x))

    rng = np.random.default_rng(7)
    mesh = create_mesh(axis_names=("data",), devices=jax.devices()[:WORLD])
    tx = optax.sgd(LR, momentum=0.9)
    jcfg = j_cfg()
    jcfg.merge_from_list(["MODEL.TYPE", "Dummy", "DATASET.NUM_CLASSES", "5"])
    dummy = j_build_model(jcfg)[0]
    models = {"bnnet": JBNNet(), "dummy": dummy}
    variables = {name: _np_tree(m.init(jax.random.PRNGKey(3), jnp.zeros((1, 8, 8, 3))))
                 for name, m in models.items()}

    def hetero(steps, batch, hw):
        scale = np.arange(1, batch + 1).reshape(1, batch, 1, 1, 1)
        x = rng.standard_normal((steps, batch, hw, hw, 3)).astype(np.float32)
        return (x * scale + scale - 1).astype(np.float32)

    def same(steps, batch, hw):
        one = rng.standard_normal((steps, 1, hw, hw, 3)).astype(np.float32)
        return np.repeat(one, batch, axis=1)

    same_images = same(1, 4, 8)
    same_labels = np.repeat(rng.integers(0, 3, (1, 1, 8, 8)).astype(np.int32), 4, axis=1)
    hetero_images, hetero_labels = hetero(2, 4, 8), _uneven_labels(rng, 2, 4, 8, 3)
    specs = {  # name: model, kind, images, labels, classes, step options
        "dummy_global": ("dummy", "global", rng.standard_normal((2, 4, 8, 8, 3)),
                         _uneven_labels(rng, 2, 4, 8, 5), 5, {}),
        "bnnet_global": ("bnnet", "global", hetero_images, hetero_labels, 3, {}),
        "bnnet_global_accum_clip": ("bnnet", "global", hetero(2, 8, 8),
                                    _uneven_labels(rng, 2, 8, 8, 3), 3,
                                    {"accum_steps": 2, "max_grad_norm": 0.01}),
        "bnnet_global_remat_frozen": ("bnnet", "global", hetero_images, hetero_labels, 3,
                                      {"remat": True, "freeze_bn_stats": True}),
        "bnnet_per_device": ("bnnet", "per_device", hetero_images, hetero_labels, 3, {}),
        "bnnet_per_device_clip": ("bnnet", "per_device", hetero_images, hetero_labels, 3,
                                  {"max_grad_norm": 0.01}),
        "bnnet_same_global": ("bnnet", "global", same_images, same_labels, 3, {}),
        "bnnet_same_per_device": ("bnnet", "per_device", same_images, same_labels, 3, {}),
        "dummy_multi": ("dummy", "multi", rng.standard_normal((3, 4, 8, 8, 3)),
                        _uneven_labels(rng, 3, 4, 8, 5), 5, {}),
        "bnnet_per_device_multi": ("bnnet", "per_device_multi", hetero(2, 4, 8),
                                   _uneven_labels(rng, 2, 4, 8, 3), 3, {}),
    }
    cases, want = {}, {}
    for name, (model, kind, images, labels, classes, kw) in specs.items():
        images = np.asarray(images, np.float32)
        state = jts.TrainState.create(models[model], variables[model], tx,
                                      jax.random.PRNGKey(0))
        if kind == "global":
            step = jit_train_step(jts.make_train_step(classes, **kw), mesh)
        elif kind == "per_device":
            step = jts.make_per_device_bn_train_step(classes, mesh, **kw)
        elif kind == "multi":
            step = jit_multi_train_step(jts.make_multi_train_step(classes, len(images)), mesh)
        else:
            step = jts.make_per_device_bn_train_step(classes, mesh, steps=len(images))
        if kind.endswith("multi"):
            state, m = step(state, shard_stacked_batches(mesh, {"image": images,
                                                                "label": labels}))
            metrics = [m]
        else:
            metrics = []
            for i in range(len(images)):
                state, m = step(state, shard_batch(mesh, {"image": images[i],
                                                          "label": labels[i]}))
                metrics.append(m)
        want[name] = {"loss": [np.asarray(m["loss"]) for m in metrics],
                      "confusion": [np.asarray(m["confusion"]) for m in metrics],
                      "state": _jax_flat(state)}
        cases[name] = {"model": model if model == "bnnet" else "cfg", "kind": kind,
                       "overrides": ["MODEL.TYPE", "Dummy", "DATASET.NUM_CLASSES", "5"],
                       "state": flax_to_state_dict(variables[model]), "dtype": "float32",
                       "optimizer": "sgd", "options": kw,
                       "images": images, "labels": labels, "num_classes": classes}

    # DeepLabV3+ resnet18 OS16 65x65, batch 1 a rank, f64: ASPP's pooled
    # branch normalises one value a rank (per-device) or two (global)
    s = Setup("DeepLabv3+", seed=0)
    overrides = [str(v) for v in OVERRIDES] + ["MODEL.TYPE", "DeepLabv3+"]
    batch = {"image": s.batches[0][0].astype(np.float64), "label": s.batches[0][1]}
    for kind, make in (("per_device", lambda: jts.make_per_device_bn_train_step(CLASSES, mesh)),
                       ("global", lambda: jit_train_step(jts.make_train_step(CLASSES), mesh))):
        with _jax_f64():
            state, m = make()(s.jax_state(np.float64), shard_batch(mesh, batch))
            want[f"deeplab_{kind}"] = {"loss": [np.asarray(m["loss"])],
                                       "confusion": [np.asarray(m["confusion"])],
                                       "state": _jax_flat(state)}
        cases[f"deeplab_{kind}"] = {
            "model": "cfg", "kind": kind, "overrides": overrides, "f64": True,
            "optimizer": "cfg", "options": {},
            "state": flax_to_state_dict(s.variables), "dtype": "float64",
            "images": s.batches[0][0][None], "labels": s.batches[0][1][None],
            "num_classes": CLASSES}

    out = tmp_path_factory.mktemp("dp_steps")
    torch.save(cases, out / "inputs.pt")
    ranks = run_ranks(out, "steps", inputs=str(out / "inputs.pt"))
    return want, ranks


def _compare(want, got, name):
    for i, (wl, gl) in enumerate(zip(want["loss"], got["loss"])):
        np.testing.assert_allclose(gl, wl, rtol=1e-5, err_msg=f"{name} loss {i}")
    for i, (wc, gc) in enumerate(zip(want["confusion"], got["confusion"])):
        np.testing.assert_array_equal(gc, wc, err_msg=f"{name} confusion {i}")
    for k, v in want["state"].items():
        np.testing.assert_allclose(got["state"][k], v, atol=1e-5, rtol=0,
                                   err_msg=f"{name} {k}")


# -- the tests -----------------------------------------------------------------------
@pytest.mark.parametrize("name", ["dummy_global", "bnnet_global", "bnnet_same_global",
                                  "bnnet_global_accum_clip", "bnnet_global_remat_frozen",
                                  "deeplab_global"])
def test_global_batch_step_matches_jit_train_step(parity, name):
    """Global-batch BatchNorm, the global valid-pixel mean, summed gradients
    and confusion, two steps with momentum; both ranks hold one state.
    Also: two micro-batches (each the global batch's contiguous half) with
    the summed gradient clipped; remat (the statistics all-reduced again in
    the backward) with frozen running statistics; DeepLabV3+ in f64 with
    ASPP's pooled branch normalising one value a rank."""
    want, ranks = parity
    for got in ranks:
        _compare(want[name], got[name], name)


@pytest.mark.parametrize("name", ["bnnet_per_device", "bnnet_same_per_device",
                                  "bnnet_per_device_clip", "deeplab_per_device"])
def test_per_device_step_matches_jax(parity, name):
    """Per-rank statistics, mean gradients and loss, running statistics the
    mean over ranks, the mean gradient clipped (DeepLabV3+: ASPP's pooled
    branch at one value a rank)."""
    want, ranks = parity
    for got in ranks:
        _compare(want[name], got[name], name)


@pytest.mark.parametrize("name", ["dummy_multi", "bnnet_per_device_multi"])
def test_k_step_dispatch_matches_jax(parity, name):
    """K steps over a stacked batch: loss (K,), confusion (K, C, C)."""
    want, ranks = parity
    for got in ranks:
        assert got[name]["loss"][0].shape == want[name]["loss"][0].shape
        assert got[name]["confusion"][0].shape == want[name]["confusion"][0].shape
        _compare(want[name], got[name], name)


def test_per_device_differs_from_global_on_heterogeneous_shards(parity):
    """JAX's property (``tests/test_parallel.py:228-254``) on the port: the
    per-rank running variance is the mean of the ranks' variances, below the
    global batch's."""
    _, ranks = parity
    got = ranks[0]
    pd, sync = got["bnnet_per_device"]["state"], got["bnnet_global"]["state"]
    assert not np.allclose(pd["bn.running_var"], sync["bn.running_var"], rtol=1e-3)
    assert (sync["bn.running_var"] >= pd["bn.running_var"] - 1e-5).all()


def test_per_device_equals_global_on_identical_shards(parity):
    """JAX's property (``tests/test_parallel.py:256-281``) on the port."""
    _, ranks = parity
    for got in ranks:
        pd, sync = got["bnnet_same_per_device"], got["bnnet_same_global"]
        np.testing.assert_allclose(pd["loss"][0], sync["loss"][0], rtol=1e-5)
        for k, v in sync["state"].items():
            np.testing.assert_allclose(pd["state"][k], v, atol=1e-5, rtol=0, err_msg=k)


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp_trainer")
    return run_ranks(out, "trainer", open_group=False)


def test_trainer_joins_from_the_environment(trainers):
    assert [(r["rank"], r["world"]) for r in trainers] == [(0, 2), (1, 2)]


@pytest.mark.parametrize("stream", [0, 1, 2], ids=["dropout", "augment", "host"])
def test_rank_streams_are_distinct_and_repeatable(trainers, stream):
    """Each rank draws its own dropout, augmentation and host (transform)
    stream, the same in every run; rank 0's is the one-device run's."""
    (a0, b0), (a1, b1) = (r["draws"] for r in trainers)
    assert np.array_equal(a0[stream], b0[stream]) and np.array_equal(a1[stream], b1[stream])
    assert not np.array_equal(a0[stream], a1[stream])
    assert np.array_equal(a0[stream], trainers[0]["one_device"][stream])


@pytest.mark.parametrize("name,kind,words", [
    ("remat", "NotImplementedError", "remat requires the SyncBN"),
    ("accum", "NotImplementedError", "GRAD_ACCUM_STEPS > 1 requires the SyncBN"),
    ("batch", "ValueError", "does not split over 2 ranks"),
    ("micro", "ValueError", "not divisible by TRAIN.GRAD_ACCUM_STEPS=4 x 2 ranks"),
    ("spatial", "NotImplementedError", "row bands across the ranks"),
])
def test_trainer_refusals_on_two_ranks(trainers, name, kind, words):
    for r in trainers:
        assert r[name][0] == kind and words in r[name][1], r[name]


def test_preemption_on_one_rank_stops_every_rank(trainers):
    """A preemption asked on rank 1 alone stops both ranks at the same step
    boundary; rank 0 saves that step."""
    r0, r1 = (r["preempt"] for r in trainers)
    assert r0["step"] == r1["step"] == 2 and r0["preempted"] and r1["preempted"]
    assert r0["losses"] == r1["losses"] and len(r0["losses"]) == 2
    assert r0["saved"] == ("model_latest.pth", 2)


def test_resume_refuses_ranks_at_different_steps(trainers):
    """A rank that finds no checkpoint (no storage shared with rank 0) stops
    every rank at the resume instead of training from step 0 beside it."""
    for r in trainers:
        assert r["split_resume"] is not None, "the ranks resumed at steps 2 and 0"
        assert "resumed at different steps (0 to 2)" in r["split_resume"]


def test_trainer_routes_by_batchnorm_scope(trainers):
    """SYNC_BN takes the global-batch step (with remat and accumulation);
    the default takes the per-device one."""
    for r in trainers:
        assert r["sync_route"].startswith("make_train_step")
        assert r["per_device_route"].startswith("make_per_device_bn_train_step")


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """``train --distributed`` with SYNC_BN True on two ranks and the same
    command in one process, over 9 frames in global batches of 4 (the last
    batch of one frame: rank 1 holds its padding sample): the Dummy model 2
    epochs then resumed to 3, DeepLabV3+ resnet18 OS16 one epoch."""
    from test_torch_train import _write_dataset

    tmp = tmp_path_factory.mktemp("dp_cli")
    _write_dataset(str(tmp / "data"), n_train=9, n_val=3, hw=(32, 32), seed=4)
    (tmp / "train.yaml").write_text("TASK_NAME: dp\n")

    def argv(out, epochs, model, *extra):
        opts = ["DATASET.NAME", "Mapillary", "DATASET.ROOT_DIR", str(tmp / "data"),
                "DATASET.NUM_CLASSES", "5", "MODEL.TYPE", model,
                "MODEL.BACKBONE", "resnet18", "MODEL.OUTPUT_STRIDE", "16",
                "MODEL.ASPP.DROPOUT", "0.0", "MODEL.SYNC_BN", "True", "OUTPUT_DIR", str(out),
                "OPTIMIZER.TYPE", "SGD", "OPTIMIZER.BASE_LR", "0.01",
                "OPTIMIZER.SGD.momentum", "0.9", "RNG_SEED", "5", "TRAIN.BATCH_SIZE", "4",
                "SCHEDULER.MAX_EPOCH", str(epochs), "DATALOADER.DROP_LAST", "False",
                "TRAIN.AUGMENTATION", f"[ToTensor, [Normalize, {MEAN}, {STD}]]",
                "VALIDATE.AUGMENTATION", f"[ToTensor, [Normalize, {MEAN}, {STD}]]",
                "VALIDATE.PERIOD", "1", "VALIDATE.BATCH_SIZE", "2",
                "TRAIN.CHECKPOINT_PERIOD", "1", "TRAIN.STEPS_PER_DISPATCH", "2",
                "DATALOADER.NUM_WORKERS", "0"]
        return ["train", "--cfg", str(tmp / "train.yaml"), *opts, "--device", "cpu", *extra]

    ranks = run_ranks(tmp / "ranks", "cli", runs={
        "first": argv(tmp / "dp", 2, "Dummy", "--distributed"),
        "resumed": argv(tmp / "dp", 3, "Dummy", "--distributed"),
        "deeplab": argv(tmp / "dp_deeplab", 1, "DeepLabv3+", "--distributed")})
    one = {"dummy": cli_main(argv(tmp / "one", 3, "Dummy")),
           "deeplab": cli_main(argv(tmp / "one_deeplab", 1, "DeepLabv3+"))}
    return tmp, ranks, one


def test_train_command_two_ranks_equals_one_process(cli_runs):
    """The Dummy model: every step's loss (the padded remainder batch among
    them) and the best validation mIoU within 1e-5 of one process."""
    _, ranks, one = cli_runs
    want = [h["loss"] for h in one["dummy"].history]
    assert len(want) == 9
    for r in ranks:
        got = [h["loss"] for h in r["first"]["history"] + r["resumed"]["history"]]
        np.testing.assert_allclose(got, want, rtol=1e-5)
        assert r["resumed"]["step"] == 9 and r["first"]["device"] == "cpu"
        np.testing.assert_allclose(r["resumed"]["best"], one["dummy"].best_metric, rtol=1e-5)


def test_train_command_global_batchnorm(cli_runs):
    """DeepLabV3+: the first step's loss (the same weights through
    global-batch BatchNorm) within 1e-5 of one process, every step equal on
    both ranks.  Later steps are not held to one process: in f32 from
    random weights at a global batch of 4, one process's own gradient lies
    1e-3 to 1e-2 from its f64 value (ASPP's pooled branch normalises 4
    values a channel), and the step tests above hold the global-batch
    BatchNorm to JAX's in f64 instead."""
    _, (rank0, rank1), one = cli_runs
    want = one["deeplab"].history[0]["loss"]
    got = [[h["loss"] for h in r["deeplab"]["history"]] for r in (rank0, rank1)]
    assert len(got[0]) == 3 and got[0] == got[1] and np.isfinite(got[0]).all()
    np.testing.assert_allclose(got[0][0], want, rtol=1e-5)


def test_train_command_rank0_checkpoints_and_resume(cli_runs):
    tmp, ranks, _ = cli_runs
    for r in ranks:
        assert [h["step"] for h in r["first"]["history"]] == [1, 2, 3, 4, 5, 6]
        assert [h["step"] for h in r["resumed"]["history"]] == [7, 8, 9]
    rank0, rank1 = ranks
    for run in ("first", "resumed", "deeplab"):
        assert len(rank0[run]["logs"]) == 1 and rank0[run]["checkpoints"]
        assert rank1[run]["logs"] == [] and rank1[run]["checkpoints"] == []
    saved = torch.load(tmp / "dp" / open(tmp / "dp" / "last_checkpoint").read().strip(),
                       weights_only=False)
    assert saved["step"] == 9


@pytest.mark.parametrize("micro", [1, 2])
def test_rank_slices_are_the_meshs_split(rng, micro):
    """Each rank decodes its contiguous part of each global batch (of each
    micro-batch, with gradient accumulation); the parts side by side are
    the one-process batch, a remainder padded as the JAX trainer's
    ``_pad_batch`` pads it, and micro-batch i is the padded batch's i-th
    contiguous chunk, as the JAX step reshapes it."""
    from types import SimpleNamespace

    from vision_semantic_segmentation_tpu.train.trainer import Trainer as JTrainer

    class Arrays(Dataset):
        def __init__(self):
            self.x = rng.standard_normal((7, 2, 2, 3)).astype(np.float32)

        def __len__(self):
            return 7

        def __getitem__(self, i):
            return {"image": self.x[i], "label": np.full((2, 2), i, np.int32)}

    data = Arrays()
    whole = list(DataLoader(data, batch_size=4, shuffle=True))
    for world in (2, 3):
        parts = [list(DataLoader(data, batch_size=4, shuffle=True, rank=r, world=world,
                                 micro=micro)) for r in range(world)]
        for i, batch in enumerate(whole):
            want = JTrainer._pad_batch(SimpleNamespace(_data_size=world), batch)
            chunks = micro if len(want["label"]) % (micro * world) == 0 else 1
            for key in ("image", "label"):
                got = np.stack([p[i][key].reshape(chunks, -1, *p[i][key].shape[1:])
                                for p in parts], axis=1)
                np.testing.assert_array_equal(got.reshape(want[key].shape), want[key])


if __name__ == "__main__" and "--rank-worker" in sys.argv:
    _worker(sys.argv[sys.argv.index("--rank-worker") + 1])

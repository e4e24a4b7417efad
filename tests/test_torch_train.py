"""Port parity: the training modules against the JAX package.

Loss, metrics, optimizers and LR schedules (against optax over several
steps), the freezer, the meters, the host transforms (against the JAX
package's Pillow transforms), the data loader, the image reader, the
checkpoint and a tiny ``Trainer.fit`` and ``train`` command on the CPU.
Inputs are numpy-seeded; each comparison states its tolerance.
"""
import io
import json
import os
import os.path as osp
import random
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import PIL.Image
import pytest
import torch

from vision_semantic_segmentation_tpu.config import get_train_cfg_defaults as j_train_cfg
from vision_semantic_segmentation_tpu.models import loss as j_loss
from vision_semantic_segmentation_tpu.models import metrics as j_metrics
from vision_semantic_segmentation_tpu.models.deeplab import DeepLabV3Plus as JDeepLab
from vision_semantic_segmentation_tpu.train import freezer as j_freezer
from vision_semantic_segmentation_tpu.train import optim as j_optim
from vision_semantic_segmentation_tpu.train import transforms as JT
from vision_semantic_segmentation_tpu.train.datasets.base import DataLoader as JDataLoader
from vision_semantic_segmentation_tpu.train.datasets.base import Dataset as JDataset
from vision_semantic_segmentation_tpu.train.meters import MeterLogger as JMeterLogger
from vision_semantic_segmentation_tpu_torch.__main__ import main as cli_main
from vision_semantic_segmentation_tpu_torch.config import get_train_cfg_defaults
from vision_semantic_segmentation_tpu_torch.models import (
    build_model,
    build_train_model,
    flax_to_state_dict,
)
from vision_semantic_segmentation_tpu_torch.models.convert import load_weights
from vision_semantic_segmentation_tpu_torch.models.loss import cross_entropy_loss
from vision_semantic_segmentation_tpu_torch.models.metrics import (
    MeanIOU,
    confusion_matrix_update,
    miou_from_confusion,
)
from vision_semantic_segmentation_tpu_torch.parallel import (
    TrainState,
    make_per_device_bn_train_step,
)
from vision_semantic_segmentation_tpu_torch.train import transforms as T
from vision_semantic_segmentation_tpu_torch.train.checkpoint import Checkpoint
from vision_semantic_segmentation_tpu_torch.train.datasets import DataLoader, Dataset
from vision_semantic_segmentation_tpu_torch.train.freezer import (
    bn_parameter_names,
    frozen_parameter_names,
)
from vision_semantic_segmentation_tpu_torch.train.meters import MeterLogger
from vision_semantic_segmentation_tpu_torch.train.optim import (
    build_optimizer,
    build_schedule,
    build_scheduler,
)
from vision_semantic_segmentation_tpu_torch.train.prefetch import PrefetchLoader
from vision_semantic_segmentation_tpu_torch.train.trainer import Trainer
from vision_semantic_segmentation_tpu_torch.utils import image_io
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


# -- loss and metrics -----------------------------------------------------------
class TestLossAndMetrics:
    @pytest.mark.parametrize("weighted", [False, True])
    def test_loss_matches_jax(self, rng, weighted):
        logits = rng.standard_normal((2, 7, 9, 11)).astype(np.float32)  # NHWC, 11 classes
        labels = rng.integers(0, 11, (2, 7, 9)).astype(np.int32)
        labels[0, :3] = 255
        weight = rng.uniform(0.5, 2.0, 11).astype(np.float32) if weighted else None
        want = j_loss.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels), 255,
                                         None if weight is None else jnp.asarray(weight))
        got = cross_entropy_loss(torch.from_numpy(logits).permute(0, 3, 1, 2),
                                 torch.from_numpy(labels).long(), 255,
                                 None if weight is None else torch.from_numpy(weight))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)

    def test_all_ignored_batch_is_zero(self):
        """JAX: 0 / max(sum w, 1e-12) = 0, where F.cross_entropy's mean is NaN."""
        logits = torch.randn(2, 5, 4, 4, requires_grad=True)
        labels = torch.full((2, 4, 4), 255)
        loss = cross_entropy_loss(logits, labels)
        assert float(loss.detach()) == 0.0
        loss.backward()
        assert torch.all(logits.grad == 0)
        assert torch.isnan(torch.nn.functional.cross_entropy(logits, labels, ignore_index=255))
        want = j_loss.cross_entropy_loss(jnp.zeros((2, 4, 4, 5)), jnp.full((2, 4, 4), 255))
        assert float(want) == 0.0

    def test_confusion_and_miou_match_jax(self, rng):
        logits = rng.standard_normal((3, 13, 17, 6)).astype(np.float32)
        labels = rng.integers(0, 7, (3, 13, 17)).astype(np.int32)  # 6 = out of range
        labels[1, 2:5] = 255
        want = np.asarray(j_metrics.confusion_matrix_update(jnp.asarray(logits),
                                                            jnp.asarray(labels), 6))
        got = confusion_matrix_update(torch.from_numpy(logits).permute(0, 3, 1, 2),
                                      torch.from_numpy(labels), 6)
        np.testing.assert_array_equal(got.numpy(), want)
        preds = logits.argmax(-1)
        np.testing.assert_array_equal(
            confusion_matrix_update(torch.from_numpy(preds), torch.from_numpy(labels), 6).numpy(),
            want)
        assert miou_from_confusion(got) == pytest.approx(
            float(j_metrics.miou_from_confusion(jnp.asarray(want))), rel=1e-6)
        mine, theirs = MeanIOU(6), j_metrics.MeanIOU(6)
        for _ in range(2):
            mine.evaluate(torch.from_numpy(logits).permute(0, 3, 1, 2), torch.from_numpy(labels))
            theirs.evaluate(jnp.asarray(logits), jnp.asarray(labels))
        np.testing.assert_array_equal(mine.confusion_matrix, theirs.confusion_matrix)
        assert mine.global_avg == theirs.global_avg


# -- optimizers and schedules -----------------------------------------------------
OPTIM_CASES = {
    "sgd_momentum_wd": ["OPTIMIZER.TYPE", "SGD", "OPTIMIZER.SGD.momentum", "0.9",
                        "OPTIMIZER.WEIGHT_DECAY", "0.01", "SCHEDULER.TYPE", "PolyLRDecay",
                        "SCHEDULER.PolyLRDecay.max_iter", "4"],
    "sgd_nesterov": ["OPTIMIZER.TYPE", "SGD", "OPTIMIZER.SGD.momentum", "0.8",
                     "OPTIMIZER.SGD.nesterov", "True", "SCHEDULER.TYPE", "StepLR",
                     "SCHEDULER.StepLR.step_size", "2", "SCHEDULER.StepLR.gamma", "0.5"],
    "sgd_plain": ["OPTIMIZER.TYPE", "SGD", "SCHEDULER.TYPE", "MultiStepLR",
                  "SCHEDULER.MultiStepLR.milestones", "[1, 3]"],
    "adam_wd": ["OPTIMIZER.TYPE", "Adam", "OPTIMIZER.Adam.betas", "[0.8, 0.99]",
                "OPTIMIZER.WEIGHT_DECAY", "0.001"],
}


@pytest.mark.parametrize("case", sorted(OPTIM_CASES))
def test_optimizer_and_schedule_match_optax(rng, case):
    """Six updates from the same gradients: parameters within 1e-6 relative
    (f32 updates, the lr as a double on the port's side)."""
    opts = OPTIM_CASES[case] + ["OPTIMIZER.BASE_LR", "0.1"]
    jcfg, cfg = j_train_cfg(), get_train_cfg_defaults()
    jcfg.merge_from_list(opts)
    cfg.merge_from_list(opts)
    shapes = [(3, 4), (5,)]
    params0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(6)]

    schedule = j_optim.build_schedule(jcfg)
    tx = j_optim.build_optimizer(jcfg, schedule)
    jp = [jnp.asarray(p) for p in params0]
    state = tx.init(jp)
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)

    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params0]
    opt = build_optimizer(cfg, params)
    sched = build_scheduler(opt, build_schedule(cfg))
    lrs = []
    for g in grads:
        lrs.append(opt.param_groups[0]["lr"])
        for p, x in zip(params, g):
            p.grad = torch.from_numpy(x)
        opt.step()
        sched.step()
    for p, want in zip(params, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    if schedule is not None:
        np.testing.assert_allclose(lrs, [float(schedule(k)) for k in range(6)], rtol=1e-6)
        assert lrs[0] == pytest.approx(0.1)  # step 0 gets BASE_LR


def test_sgd_dampening_refused():
    cfg = get_train_cfg_defaults()
    cfg.merge_from_list(["OPTIMIZER.TYPE", "SGD", "OPTIMIZER.SGD.momentum", "0.9",
                         "OPTIMIZER.SGD.dampening", "0.1"])
    with pytest.raises(NotImplementedError):
        build_optimizer(cfg, [torch.nn.Parameter(torch.zeros(2))])


# -- freezer and meters -------------------------------------------------------------
def test_freezer_matches_jax_masks():
    """FREEZE_BATCHNORM freezes the parameters JAX's bn_mask marks, and a
    pattern those whose name matches, on DeepLabV3+ resnet18."""
    shapes = jax.eval_shape(
        lambda k: JDeepLab(out_channels=5, backbone="resnet18", output_stride=16).init(
            k, jnp.zeros((1, 33, 33, 3)), train=False), jax.random.PRNGKey(0))
    params = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes["params"])
    names = list(flax_to_state_dict({"params": params}))
    marked = jax.tree.leaves(j_freezer.bn_mask(params))
    want_bn = {n for n, m in zip(names, marked) if m}
    cfg = get_train_cfg_defaults()
    cfg.merge_from_list(["MODEL.BACKBONE", "resnet18", "DATASET.NUM_CLASSES", "5"])
    model, *_ = build_train_model(cfg, device="cpu")
    assert sorted(n for n, _ in model.named_parameters()) == sorted(names)
    assert bn_parameter_names(model) == want_bn
    frozen = frozen_parameter_names(model, patterns=(r"^backbone\.layer1\.",), freeze_batchnorm=True)
    assert frozen == want_bn | {n for n in names if n.startswith("backbone.layer1.")}


def test_meters_match_jax():
    mine, theirs = MeterLogger(), JMeterLogger()
    for v in (1.0, 2.5, np.array([1.0, 3.0]), 4):
        mine.update(loss=v)
        theirs.update(loss=v)
    mine.update(loss=torch.tensor([2.0, 2.0]))
    theirs.update(loss=np.array([2.0, 2.0]))
    assert str(mine) == str(theirs) and mine.summary_str == theirs.summary_str


# -- transforms ---------------------------------------------------------------------
def _pil_pair(image, label):
    return {"image": PIL.Image.fromarray(image), "label": PIL.Image.fromarray(label)}


def _run(transform_j, transform_p, image, label, seed):
    random.seed(seed)
    want = transform_j(_pil_pair(image, label))
    random.seed(seed)
    got = transform_p({"image": image, "label": label})
    return ({k: np.asarray(v) for k, v in want.items()}, got)


TRANSFORM_CASES = [
    ("Resize", ([40, 30],)),
    ("RandomHorizontalFlip", ()),
    ("RandomCrop", (24, 255, False)),
    ("RandomCrop", ((60, 90), 0, True)),
    ("RandomSizeAndCrop", (32, (0.5, 2.0), 255)),
    ("RandomSizeAndCrop", ((20, 28), (0.7, 1.3), 255, False, 40)),
    ("FixScaleCenterCrop", ((30, 20),)),
    ("CenterCropWithPad", ((70, 30), 255)),
    ("MaxSizeCenterCrop", ((40, 40), 255)),
]


@pytest.mark.parametrize("name,args", TRANSFORM_CASES)
def test_transform_matches_jax(rng, name, args):
    """Crops, pads, flips and nearest label resizes equal Pillow's exactly;
    bilinear image resizes within one grey level on at most 5 % of the
    pixels of a noise image (PyTorch's port of Pillow's filter rounds its
    fixed-point sums differently; 0.2-0.4 % of the pixels at larger sizes)."""
    image = rng.integers(0, 256, (45, 57, 3), dtype=np.uint8)
    label = rng.integers(0, 19, (45, 57), dtype=np.uint8)
    for seed in range(4):
        want, got = _run(getattr(JT, name)(*args), getattr(T, name)(*args), image, label, seed)
        np.testing.assert_array_equal(got["label"], want["label"])
        diff = np.abs(got["image"].astype(int) - want["image"].astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.05, (diff.max(), (diff > 0).mean())


def test_to_tensor_normalize_match_jax(rng):
    image = rng.integers(0, 256, (9, 11, 3), dtype=np.uint8)
    label = rng.integers(0, 19, (9, 11), dtype=np.uint8)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    want, got = _run(JT.Compose([JT.ToTensor(), JT.Normalize(mean, std)]),
                     T.Compose([T.ToTensor(), T.Normalize(mean, std)]), image, label, 0)
    for k in ("image", "label"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_random_rotate_close_to_pillow(rng):
    """Rotation samples with grid_sample: close to Pillow's rotate in the
    interior (mean difference under 2 grey levels on a smooth image)."""
    yy, xx = np.mgrid[0:40, 0:50]
    image = np.stack([yy * 5, xx * 4, (yy + xx) * 2], -1).astype(np.uint8)
    label = (xx // 10).astype(np.uint8)
    want, got = _run(JT.RandomRotate(10), T.RandomRotate(10), image, label, 1)
    inner = (slice(8, 32), slice(8, 42))
    assert np.abs(got["image"][inner].astype(int) - want["image"][inner].astype(int)).mean() < 2
    assert (got["label"][inner] != want["label"][inner]).mean() < 0.05


def test_nearest_index_is_pillows():
    """Pillow's NEAREST accumulates the pixel centre in double precision."""
    lab = np.arange(97 * 130, dtype=np.int32).reshape(97, 130) % 251
    lab = lab.astype(np.uint8)
    for w, h in [(1, 1), (65, 48), (260, 194), (513, 513), (129, 33), (3, 97)]:
        want = np.asarray(PIL.Image.fromarray(lab).resize((w, h), PIL.Image.NEAREST))
        np.testing.assert_array_equal(T.resize_nearest(lab, (w, h)), want)


# -- data loader, image reader --------------------------------------------------------
class _Arrays:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"image": np.full((2, 2), i, np.float32), "label": np.full((2,), i, np.int32)}


class _JArrays(_Arrays, JDataset):
    pass


class _PArrays(_Arrays, Dataset):
    pass


@pytest.mark.parametrize("kw", [
    dict(batch_size=3, shuffle=True, drop_last=True),
    dict(batch_size=4, shuffle=True, drop_last=False, num_workers=2),
    dict(batch_size=2, shuffle=False, num_shards=3, shard_index=1),
])
def test_data_loader_matches_jax(kw):
    mine, theirs = DataLoader(_PArrays(11), **kw), JDataLoader(_JArrays(11), **kw)
    assert len(mine) == len(theirs)
    for epoch in (0, 1):
        mine.set_epoch(epoch)
        theirs.set_epoch(epoch)
        got, want = list(mine), list(theirs)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a["image"], b["image"])
            np.testing.assert_array_equal(a["label"], b["label"])


def test_prefetch_loader_keeps_order_and_raises():
    batches = [{"image": np.full((1, 2), i)} for i in range(5)]
    assert [int(b["image"][0, 0]) for b in PrefetchLoader(batches, depth=2)] == list(range(5))
    staged = list(PrefetchLoader(batches, depth=2, device="cpu"))
    assert [int(b.wait()["image"][0, 0]) for b in staged] == list(range(5))

    def broken():
        yield batches[0]
        raise RuntimeError("decode failed")

    class Broken:
        def __iter__(self):
            return broken()

    with pytest.raises(RuntimeError, match="decode failed"):
        list(PrefetchLoader(Broken()))


@pytest.mark.parametrize("mode,shape", [("RGB", (23, 31, 3)), ("L", (17, 9)),
                                        ("RGBA", (8, 12, 4)), ("P", (19, 21))])
def test_image_reader_reads_png_under_jpg_name(tmp_path, rng, mode, shape, monkeypatch):
    """PNG data under a .jpg name: the port's own decoder (Pillow hidden),
    and the reader with Pillow, both equal PIL.Image.open; smooth images
    make Pillow's encoder pick every row filter."""
    a = rng.integers(0, 256 if mode != "P" else 7, shape, dtype=np.uint8)
    if mode != "P":
        a = (np.cumsum(a, axis=0) // 9).astype(np.uint8)
    path = tmp_path / "frame.jpg"
    PIL.Image.fromarray(a, mode).save(path, format="PNG")
    want = np.asarray(PIL.Image.open(path))
    np.testing.assert_array_equal(image_io.read_image(str(path)), want)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    np.testing.assert_array_equal(image_io.read_image(str(path)), want)


def test_image_reader_refuses_jpeg_without_pillow(tmp_path, monkeypatch):
    path = tmp_path / "frame.jpg"
    PIL.Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(path, format="JPEG")
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    with pytest.raises(RuntimeError, match="JPEG"):
        image_io.read_image(str(path))


def test_png_writer_round_trips(rng):
    for a in (rng.integers(0, 256, (5, 7, 3), dtype=np.uint8),
              rng.integers(0, 256, (4, 6), dtype=np.uint8)):
        data = image_io.encode_png(a)
        np.testing.assert_array_equal(np.asarray(PIL.Image.open(io.BytesIO(data))), a)
        np.testing.assert_array_equal(image_io.decode_png(data), a)


# -- checkpoint ----------------------------------------------------------------------
def _dummy_cfg(tmp_path, extra=()):
    cfg = get_train_cfg_defaults()
    cfg.merge_from_list(["MODEL.TYPE", "Dummy", "DATASET.NUM_CLASSES", "5",
                         "OPTIMIZER.TYPE", "SGD", "OPTIMIZER.BASE_LR", "0.05",
                         "OPTIMIZER.SGD.momentum", "0.9", "RNG_SEED", "3",
                         "OUTPUT_DIR", str(tmp_path), *extra])
    return cfg


def _state(cfg, seed=0):
    model, *_ = build_train_model(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    opt = build_optimizer(cfg, model.parameters())
    return TrainState(model, opt, build_scheduler(opt, build_schedule(cfg)),
                      torch.Generator().manual_seed(seed))


def _step(state):
    x = torch.randn(2, 3, 8, 8)
    loss = state.model(x).square().mean()
    state.model.zero_grad()
    loss.backward()
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1


class TestCheckpoint:
    def test_save_load_pointer_and_versions(self, tmp_path):
        cfg = _dummy_cfg(tmp_path)
        a = _state(cfg)
        _step(a)
        ckpt = Checkpoint(a, str(tmp_path))
        ckpt.save("model_latest", best_metric=0.25)
        assert open(tmp_path / "last_checkpoint").read() == "model_latest.pth"
        _step(a)
        ckpt.save("model_latest", best_metric=0.5)  # re-save: a .v1 sibling, old one retired
        assert open(tmp_path / "last_checkpoint").read() == "model_latest.v1.pth"
        assert not (tmp_path / "model_latest.pth").exists()
        b = _state(cfg, seed=7)
        extras = Checkpoint(b, str(tmp_path)).load()
        assert extras == {"best_metric": 0.5} and b.step == 2
        for (k, va), vb in zip(a.model.state_dict().items(), b.model.state_dict().values()):
            assert torch.equal(va, vb), k
        assert b.optimizer.state_dict()["state"].keys() == a.optimizer.state_dict()["state"].keys()
        assert torch.equal(b.generator.get_state(), a.generator.get_state())
        # the serving path reads the same file through MODEL.WEIGHT
        net = build_model(cfg, device="cpu")
        net.load_state_dict(load_weights(str(tmp_path / "model_latest.v1.pth")), strict=True)

    def test_weights_only_load(self, tmp_path):
        cfg = _dummy_cfg(tmp_path)
        a = _state(cfg)
        _step(a)
        Checkpoint(a, str(tmp_path)).save("model_000")
        b = _state(cfg, seed=5)
        assert Checkpoint(b, str(tmp_path)).load("model_000", resume=False,
                                                 resume_states=False) == {}
        assert b.step == 0 and not b.optimizer.state_dict()["state"]
        assert torch.equal(b.model.Conv[0].weight, a.model.Conv[0].weight)

    def test_async_save_snapshots_and_commits_late(self, tmp_path):
        cfg = _dummy_cfg(tmp_path)
        a = _state(cfg)
        ckpt = Checkpoint(a, str(tmp_path))
        before = a.model.Conv[0].weight.detach().clone()
        ckpt.save("model_000", block=False)
        _step(a)  # training goes on: the snapshot was taken at save()
        ckpt.finish()
        assert open(tmp_path / "last_checkpoint").read() == "model_000.pth"
        saved = torch.load(tmp_path / "model_000.pth", weights_only=False)
        assert torch.equal(saved["model"]["Conv.0.weight"], before) and saved["step"] == 0

    def test_next_save_commits_the_pending_one(self, tmp_path):
        a = _state(_dummy_cfg(tmp_path))
        ckpt = Checkpoint(a, str(tmp_path))
        ckpt.save("model_000", block=False)
        ckpt.save("model_001", block=False)
        assert (tmp_path / "model_000.pth").exists()
        ckpt.finish()
        assert open(tmp_path / "last_checkpoint").read() == "model_001.pth"


# -- trainer and command ----------------------------------------------------------
def _write_dataset(root, n_train=8, n_val=2, hw=(24, 32), seed=0):
    """A Mapillary-layout dataset: PNG data under .jpg names, colour = class."""
    rng = np.random.default_rng(seed)
    colors = np.array([[20, 20, 20], [200, 40, 40], [40, 200, 40], [40, 40, 200],
                       [220, 220, 40]], np.uint8)
    os.makedirs(root, exist_ok=True)
    with open(osp.join(root, "config.json"), "w") as f:
        json.dump({"labels": [{"name": str(i), "color": c.tolist()} for i, c in enumerate(colors)]}, f)
    for split, n in (("training", n_train), ("validation", n_val)):
        os.makedirs(osp.join(root, split, "images"), exist_ok=True)
        os.makedirs(osp.join(root, split, "labels"), exist_ok=True)
        for i in range(n):
            lab = np.repeat(rng.integers(0, 5, (hw[0] // 4, hw[1] // 4)), 4, 0).repeat(4, 1)
            lab = lab.astype(np.uint8)
            image_io.write_png(osp.join(root, split, "images", f"{i:03d}.jpg"), colors[lab])
            image_io.write_png(osp.join(root, split, "labels", f"{i:03d}.png"), lab)


def _train_opts(root, out, epochs):
    mean, std = "[0.485, 0.456, 0.406]", "[0.229, 0.224, 0.225]"
    return ["DATASET.NAME", "Mapillary", "DATASET.ROOT_DIR", str(root),
            "DATASET.NUM_CLASSES", "5", "MODEL.TYPE", "Dummy", "OUTPUT_DIR", str(out),
            "OPTIMIZER.TYPE", "Adam", "OPTIMIZER.BASE_LR", "0.01", "RNG_SEED", "1",
            "TRAIN.BATCH_SIZE", "4", "SCHEDULER.MAX_EPOCH", str(epochs),
            "TRAIN.AUGMENTATION", f"[RandomHorizontalFlip, ToTensor, [Normalize, {mean}, {std}]]",
            "VALIDATE.AUGMENTATION", f"[ToTensor, [Normalize, {mean}, {std}]]",
            "VALIDATE.PERIOD", "1", "VALIDATE.BATCH_SIZE", "2", "TRAIN.CHECKPOINT_PERIOD", "2",
            "TRAIN.STEPS_PER_DISPATCH", "8", "DATALOADER.NUM_WORKERS", "2"]


def test_trainer_fit_loss_falls_and_resumes(tmp_path):
    root = tmp_path / "data"
    _write_dataset(str(root))
    cfg = get_train_cfg_defaults()
    cfg.merge_from_list(_train_opts(root, tmp_path / "out", 5))
    trainer = Trainer(cfg, output_dir=str(tmp_path / "out"), device="cpu")
    trainer.fit()
    losses = [h["loss"] for h in trainer.history]
    assert len(losses) == 10 and all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    assert trainer.state.step == 10 and trainer.best_metric > 0
    assert open(tmp_path / "out" / "last_checkpoint").read().startswith("model_best")
    # AUTO_RESUME: a longer schedule continues from the pointer's step
    cfg.defrost()
    cfg.SCHEDULER.MAX_EPOCH = 6
    again = Trainer(cfg, output_dir=str(tmp_path / "out"), device="cpu")
    again.fit()
    assert [h["step"] for h in again.history] == [11, 12]


def test_train_command_on_cpu(tmp_path):
    root = tmp_path / "data"
    _write_dataset(str(root), n_train=4, n_val=0)
    cfg_path = tmp_path / "train.yaml"
    cfg_path.write_text("TASK_NAME: tiny\n")
    opts = _train_opts(root, tmp_path / "out", 1) + ["VALIDATE.PERIOD", "0"]
    trainer = cli_main(["train", "--cfg", str(cfg_path), *opts, "--device", "cpu"])
    assert trainer.state.step == 1 and trainer.device.type == "cpu"
    assert any(f.startswith("log") for f in os.listdir(trainer.output_dir))


def test_trainer_refuses_multi_device(tmp_path):
    """Two spatial shards do not divide the one CPU device (the JAX
    trainer's ValueError); bands across the ranks of a process group are
    not ported."""
    cfg = _dummy_cfg(tmp_path, ["TRAIN.SPATIAL_SHARDS", "2"])
    with pytest.raises(ValueError, match="SPATIAL_SHARDS=2 does not divide the device count 1"):
        Trainer(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Trainer(cfg, device="cpu", distributed=True)


def test_distributed_needs_torchrun_environment(tmp_path, monkeypatch):
    """``distributed`` without a group or torchrun's environment raises and
    never falls back to one process (the Trainer and ``train --distributed``)."""
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node"):
        Trainer(_dummy_cfg(tmp_path), device="cpu", distributed=True)
    cfg_path = tmp_path / "train.yaml"
    cfg_path.write_text("TASK_NAME: tiny\n")
    with pytest.raises(RuntimeError, match="WORLD_SIZE"):
        cli_main(["train", "--cfg", str(cfg_path), "OUTPUT_DIR", str(tmp_path), "--device",
                  "cpu", "--distributed"])
    assert not torch.distributed.is_initialized()
    assert os.listdir(tmp_path) == ["train.yaml"]  # no log, no checkpoint


def test_per_device_step_refuses_remat_and_accumulation():
    """The JAX trainer's refusals on the per-device BatchNorm path, word for
    word where they apply."""
    with pytest.raises(NotImplementedError, match="remat requires the SyncBN train step"):
        make_per_device_bn_train_step(5, None, remat=True)
    with pytest.raises(NotImplementedError, match="GRAD_ACCUM_STEPS > 1 requires the SyncBN"):
        make_per_device_bn_train_step(5, None, accum_steps=2)

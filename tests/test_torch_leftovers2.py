"""Port parity: the last host-side leftovers against the JAX package.

``train/tensorboard_util.add_scalars`` and the trainer's ``tensorboard``
option with a fake writer; the BDD and Pascal VOC readers, directly and
through ``train/build.py``, on a tiny synthetic tree; ``preparation``'s
Mapillary remap and BDD colour conversion, whose files must be the JAX
package's byte for byte; and the native PointCloud2 decoder against the
numpy decoder and the JAX package's (skipped only where no C++ compiler is
found), with its loud fallback.  Everything compares exactly.
"""
import json
import logging
import os
import os.path as osp
import shutil

import numpy as np
import PIL.Image
import pytest

from vision_semantic_segmentation_tpu.config import get_train_cfg_defaults as j_train_cfg
from vision_semantic_segmentation_tpu.runtime import native_io as j_native
from vision_semantic_segmentation_tpu.train import build as j_build
from vision_semantic_segmentation_tpu.train import tensorboard_util as j_tb
from vision_semantic_segmentation_tpu.train.datasets import bdd as j_bdd
from vision_semantic_segmentation_tpu.train.datasets import pascal as j_pascal
from vision_semantic_segmentation_tpu.train.datasets import preparation as j_prep
from vision_semantic_segmentation_tpu.train.meters import MeterLogger as JMeterLogger
from vision_semantic_segmentation_tpu_torch.config import get_train_cfg_defaults
from vision_semantic_segmentation_tpu_torch.runtime import native_io, rosbag
from vision_semantic_segmentation_tpu_torch.train import build
from vision_semantic_segmentation_tpu_torch.train.datasets import (
    BDDSegmentation,
    OverfitVOCSegmentation,
    VOCSegmentation,
    bdd,
    preparation,
)
from vision_semantic_segmentation_tpu_torch.train.meters import MeterLogger
from vision_semantic_segmentation_tpu_torch.train.tensorboard_util import add_scalars
from vision_semantic_segmentation_tpu_torch.train.trainer import Trainer
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

from test_torch_train import _train_opts, _write_dataset

MEAN, STD = "[0.485, 0.456, 0.406]", "[0.229, 0.224, 0.225]"


class FakeWriter:
    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), int(step)))


# -- TensorBoard scalars -------------------------------------------------------------
def test_add_scalars_matches_jax():
    port, jax_side = MeterLogger(), JMeterLogger()
    for meters in (port, jax_side):
        meters.update(loss=0.5, data_time=0.1)
        meters.update(loss=1.5, data_time=0.3, acc=np.array([1.0, 0.0]))
        meters.update(empty=float("nan"))  # a NaN average is skipped
    got, want = FakeWriter(), FakeWriter()
    add_scalars(got, port, "train", 7)
    j_tb.add_scalars(want, jax_side, "train", 7)
    assert got.scalars == want.scalars
    assert [s[0] for s in got.scalars] == ["train/loss", "train/data_time", "train/acc"]
    assert got.scalars[0] == ("train/loss", 1.0, 7)


def test_trainer_tensorboard_option(tmp_path, caplog):
    root = tmp_path / "data"
    _write_dataset(str(root), n_train=4, n_val=2)
    cfg = get_train_cfg_defaults()
    cfg.merge_from_list(_train_opts(root, tmp_path / "out", 2))
    writer = FakeWriter()
    trainer = Trainer(cfg, output_dir=str(tmp_path / "out"), device="cpu", tensorboard=writer)
    trainer.fit()
    tags = [(t, s) for t, _, s in writer.scalars]
    for epoch in (0, 1):
        for tag in ("train/loss", "train/data_time", "train/batch_time", "val/loss", "val/miou"):
            assert (tag, epoch) in tags
    losses = [h["loss"] for h in trainer.history if h["epoch"] == 1]
    logged = [v for t, v, s in writer.scalars if t == "train/loss" and s == 1]
    assert logged == [pytest.approx(np.mean(losses))]
    # True without tensorboardX: the trainer runs on and says so once
    import builtins

    real_import = builtins.__import__

    def no_tensorboardx(name, *args, **kwargs):
        if name == "tensorboardX":
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    builtins.__import__ = no_tensorboardx
    try:
        with caplog.at_level(logging.INFO):
            quiet = Trainer(cfg, output_dir=str(tmp_path / "out2"), device="cpu",
                            tensorboard=True, logger=logging.getLogger("tb_test"))
    finally:
        builtins.__import__ = real_import
    assert quiet._tb is None
    assert sum("tensorboardX is not installed" in r.message for r in caplog.records) == 1


# -- readers ---------------------------------------------------------------------------
def _bdd_tree(root, rng, n=3, hw=(24, 32)):
    """BDD layout with colour labels, converted by the JAX preparation."""
    colors = np.array(sorted({lab.color for lab in bdd.labels}), np.uint8)
    for split in ("train", "val"):
        images = osp.join(root, "seg/images", split)
        raw = osp.join(root, "seg/color_labels", split)
        os.makedirs(images)
        os.makedirs(raw)
        for i in range(n):
            PIL.Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)).save(
                osp.join(images, f"{split}{i}.jpg"))
            lab = colors[rng.integers(0, len(colors), hw)]
            lab[0, 0] = (1, 2, 3)  # a colour of no label: ignored
            PIL.Image.fromarray(lab).save(osp.join(raw, f"{split}{i}_train_color.png"))
        j_prep.prepare_labels(raw, osp.join(root, "seg/color_labels_preprocessed", split),
                              kind="bdd", num_workers=2)


def _voc_tree(root, rng, n=4, hw=(20, 28)):
    os.makedirs(osp.join(root, "ImageSets/Segmentation"))
    os.makedirs(osp.join(root, "JPEGImages"))
    os.makedirs(osp.join(root, "SegmentationClass"))
    palette = rng.integers(0, 256, 256 * 3).astype(np.uint8).tolist()
    ids = [f"2007_{i:06d}" for i in range(n)]
    for i in ids:
        PIL.Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)).save(
            osp.join(root, "JPEGImages", i + ".jpg"))
        lab = PIL.Image.fromarray(rng.integers(0, 21, hw).astype(np.uint8), mode="P")
        lab.putpalette(palette)
        lab.save(osp.join(root, "SegmentationClass", i + ".png"))
    for split, part in (("train", ids[:3]), ("val", ids[3:])):
        with open(osp.join(root, "ImageSets/Segmentation", split + ".txt"), "w") as f:
            f.write("".join(p + "\n" for p in part))


def _same_samples(port, jax_side):
    assert len(port) == len(jax_side) > 0
    for i in range(len(port)):
        a, b = port[i], jax_side[i]
        for key in ("image", "label"):
            np.testing.assert_array_equal(a[key], np.asarray(b[key]))


def _loader_batches(name, root, mode):
    opts = ["DATASET.NAME", name, "DATASET.ROOT_DIR", str(root), "VALIDATE.BATCH_SIZE", "2",
            "VALIDATE.AUGMENTATION", f"[ToTensor, [Normalize, {MEAN}, {STD}]]",
            "TRAIN.BATCH_SIZE", "2",
            "TRAIN.AUGMENTATION", f"[ToTensor, [Normalize, {MEAN}, {STD}]]"]
    cfg, jcfg = get_train_cfg_defaults(), j_train_cfg()
    cfg.merge_from_list(opts)
    jcfg.merge_from_list(opts)
    return list(build.build_dataloader(cfg, mode)), list(j_build.build_dataloader(jcfg, mode))


def test_bdd_reader_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    _bdd_tree(str(tmp_path), rng)
    for split in ("train", "val"):
        _same_samples(BDDSegmentation(str(tmp_path), split),
                      j_bdd.BDDSegmentation(str(tmp_path), split))
    port, jax_side = _loader_batches("BDD", tmp_path, "val")
    assert len(port) == len(jax_side) == 2
    for a, b in zip(port, jax_side):
        for key in ("image", "label"):
            np.testing.assert_array_equal(a[key], b[key])
    with pytest.raises(ValueError, match="split"):
        BDDSegmentation(str(tmp_path), "training")
    shutil.rmtree(tmp_path / "seg/color_labels_preprocessed")
    with pytest.raises(FileNotFoundError, match="preprocess"):
        BDDSegmentation(str(tmp_path), "train")


def test_pascal_readers_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    _voc_tree(str(tmp_path), rng)
    for split in ("train", "val"):
        _same_samples(VOCSegmentation(str(tmp_path), split),
                      j_pascal.VOCSegmentation(str(tmp_path), split))
    _same_samples(OverfitVOCSegmentation(str(tmp_path), "train", 2),
                  j_pascal.OverfitVOCSegmentation(str(tmp_path), "train", 2))
    assert VOCSegmentation(str(tmp_path), "train")[0]["label"].ndim == 2  # palette indices
    port, jax_side = _loader_batches("Pascal", tmp_path, "train")
    assert len(port) == len(jax_side) > 0
    for a, b in zip(port, jax_side):
        for key in ("image", "label"):
            np.testing.assert_array_equal(a[key], b[key])
    with pytest.raises(ValueError, match="size"):
        OverfitVOCSegmentation(str(tmp_path), "train", 4)


def test_bdd_label_table_is_jax():
    assert bdd.labels == j_bdd.labels and len(bdd.labels) == 41
    assert preparation.bdd_color_to_trainid_table() == j_prep.bdd_color_to_trainid_table()


# -- label preparation -----------------------------------------------------------------
def _files(directory):
    return {f: open(osp.join(directory, f), "rb").read() for f in sorted(os.listdir(directory))
            if osp.isfile(osp.join(directory, f))}


@pytest.mark.parametrize("workers", [1, 3])
def test_prepare_labels_bytes_equal_jax(tmp_path, workers):
    rng = np.random.default_rng(5)
    mapillary, colors = tmp_path / "mapillary", tmp_path / "bdd"
    mapillary.mkdir()
    colors.mkdir()
    palette = np.array(sorted({lab.color for lab in bdd.labels}), np.uint8)
    for i in range(4):
        PIL.Image.fromarray(rng.integers(0, 70, (16, 24)).astype(np.uint8)).save(
            mapillary / f"{i}.png")  # 66..69: beyond the table, ignored
        rgb = palette[rng.integers(0, len(palette), (16, 24))]
        PIL.Image.fromarray(np.dstack([rgb, np.full((16, 24), 255, np.uint8)])).save(
            colors / f"{i}_train_color.png")  # RGBA, as BDD ships them
    (mapillary / "notes.txt").write_text("not a label")
    for kind, src in (("mapillary", mapillary), ("bdd", colors)):
        n = preparation.prepare_labels(str(src), str(tmp_path / f"port_{kind}"), kind=kind,
                                       num_workers=workers)
        j_n = j_prep.prepare_labels(str(src), str(tmp_path / f"jax_{kind}"), kind=kind,
                                    num_workers=workers)
        assert n == j_n == 4
        assert _files(tmp_path / f"port_{kind}") == _files(tmp_path / f"jax_{kind}")
    np.testing.assert_array_equal(preparation.mapillary_label_map(), j_prep.mapillary_label_map())
    remapped = np.asarray(PIL.Image.open(tmp_path / "port_mapillary" / "0.png"))
    assert remapped.max() == 255 and remapped[remapped < 255].max() <= 18


def test_prepare_mapillary_matches_jax(tmp_path):
    rng = np.random.default_rng(6)
    src = tmp_path / "src"
    config = {"labels": [{"name": f"l{i}", "color": [i, i, i]} for i in range(66)]}
    src.mkdir()
    (src / "config.json").write_text(json.dumps(config))
    for split in ("training", "validation"):
        for sub in ("images", "labels"):
            (src / split / sub).mkdir(parents=True)
        for i in range(2):
            PIL.Image.fromarray(rng.integers(0, 256, (8, 12, 3), dtype=np.uint8)).save(
                src / split / "images" / f"{i}.jpg")
            PIL.Image.fromarray(rng.integers(0, 66, (8, 12)).astype(np.uint8)).save(
                src / split / "labels" / f"{i}.png")
    preparation.prepare_mapillary(str(src), str(tmp_path / "port"), num_workers=2)
    j_prep.prepare_mapillary(str(src), str(tmp_path / "jax"), num_workers=2)
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")  # config.json
    for split in ("training", "validation"):
        for sub in ("images", "labels"):
            assert (_files(tmp_path / "port" / split / sub)
                    == _files(tmp_path / "jax" / split / sub))


# -- native PointCloud2 decoder -------------------------------------------------------
@pytest.fixture
def compiler():
    if not (shutil.which("c++") or shutil.which("g++")):
        pytest.skip("no host C++ compiler (c++ or g++) to build the native decoder")


def _cloud(rng, n=500):
    """A point layout of every PointField type: float32 x y z intensity,
    then int8, uint8, int16, uint16, int32, uint32, float64; some NaNs."""
    formats = ["<f4"] * 4 + ["i1", "u1", "<i2", "<u2", "<i4", "<u4", "<f8"]
    offsets = [0, 4, 8, 12, 16, 17, 18, 20, 24, 28, 32]
    codes = [7, 7, 7, 7, 1, 2, 3, 4, 5, 6, 8]
    names = [f"f{i}" for i in range(len(formats))]
    points = np.zeros(n, np.dtype({"names": names, "formats": formats, "offsets": offsets,
                                   "itemsize": 40}))
    for name, fmt in zip(names, formats):
        kind = np.dtype(fmt)
        if kind.kind == "f":
            points[name] = rng.standard_normal(n) * 10
        else:
            info = np.iinfo(kind)
            points[name] = rng.integers(info.min, info.max, n, endpoint=True)
    points["f0"][5::37] = np.nan
    points["f2"][11::41] = np.inf
    return points.tobytes(), 40, list(zip(offsets, codes))


def test_native_decoder_matches_numpy_and_jax(compiler):
    rng = np.random.default_rng(7)
    data, step, fields = _cloud(rng)
    offsets, types = [f[0] for f in fields], [f[1] for f in fields]
    assert native_io.native_available()
    before = native_io.calls["native"]
    for skip in (True, False):
        got = native_io.decode_pointcloud2(data, 500, step, offsets, types, skip_nans=skip)
        plain = native_io._numpy_decode(data, 500, step, offsets, types, skip)
        np.testing.assert_array_equal(got, plain)
        np.testing.assert_array_equal(
            got, j_native.decode_pointcloud2(data, 500, step, offsets, types, skip_nans=skip))
        assert got.shape == (11, 474 if skip else 500)  # 26 points hold a NaN or an inf
        for bucket in (256, 1024):
            out, valid = native_io.decode_and_bucket(data, 500, step, offsets, types, bucket,
                                                     skip_nans=skip)
            j_out, j_valid = j_native.decode_and_bucket(data, 500, step, offsets, types, bucket,
                                                        skip_nans=skip)
            np.testing.assert_array_equal(out, j_out)
            np.testing.assert_array_equal(valid, j_valid)
            n = min(bucket, plain.shape[1])
            np.testing.assert_array_equal(out[:, :n], plain[:, :n])
            assert valid.sum() == n and not out[:, n:].any()
    assert native_io.calls["native"] == before + 6
    with pytest.raises(ValueError, match="16 fields"):
        native_io.decode_pointcloud2(data, 500, step, [0] * 17, [7] * 17)


def test_rosbag_cloud_goes_through_native_decoder(compiler):
    rng = np.random.default_rng(8)
    pts = rng.standard_normal((300, 6)).astype(np.float32)  # x y z pad intensity ring
    fields = [rosbag.PointField(name, off, 7, 1)
              for name, off in (("x", 0), ("y", 4), ("z", 8), ("intensity", 16))]
    msg = rosbag.PointCloud2Msg(rosbag.Header(0, 1.0, "velodyne"), 1, 300, fields, 24,
                                pts.tobytes())
    before = dict(native_io.calls)
    got = msg.xyzi()
    assert native_io.calls["native"] == before["native"] + 1
    np.testing.assert_array_equal(got, pts[:, [0, 1, 2, 4]].T)
    msg.fields = fields[:3]  # no intensity: the numpy path, zeros
    np.testing.assert_array_equal(msg.xyzi()[3], np.zeros(300, np.float32))
    assert native_io.calls["native"] == before["native"] + 1


def test_native_decoder_falls_back_loudly(tmp_path, monkeypatch, caplog):
    monkeypatch.setattr(native_io, "_lib", None)
    monkeypatch.setattr(native_io, "_failure", None)
    monkeypatch.setattr(native_io, "BUILD_DIR", tmp_path / "libs")
    monkeypatch.setenv("CXX", shutil.which("false") or "/bin/false")
    rng = np.random.default_rng(9)
    data, step, fields = _cloud(rng, 50)
    offsets, types = [f[0] for f in fields], [f[1] for f in fields]
    before = native_io.calls["numpy"]
    with caplog.at_level(logging.WARNING, logger=native_io.__name__):
        assert not native_io.native_available()
        got = native_io.decode_pointcloud2(data, 50, step, offsets, types)
        native_io.decode_and_bucket(data, 50, step, offsets, types, 64)
    assert native_io.calls["numpy"] == before + 2
    np.testing.assert_array_equal(got, native_io._numpy_decode(data, 50, step, offsets, types,
                                                               True))
    warnings = [r for r in caplog.records if "decoding with numpy" in r.message]
    assert len(warnings) == 1

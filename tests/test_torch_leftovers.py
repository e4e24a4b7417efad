"""Port parity: the host-side leftovers against the JAX package.

``utils/pcd_bev.py`` (ASCII and binary ``.pcd`` round trips, the BEV
image), ``utils/images.py``, ``train/datasets/visualization.py``,
``utils/file_io.py``, ``ops/colormap.py::load_palette_from_dataset_config``,
``evaluation/compare.py::compare_maps`` and ``utils/benchmark.py`` run on
the same seeded inputs in both packages on the CPU.  Every output is host
numpy, strings or files and is held equal.
"""
import json
import os

import cv2
import numpy as np
import pytest
import torch

from vision_semantic_segmentation_tpu.evaluation import compare as j_compare
from vision_semantic_segmentation_tpu.ops import colormap as j_colormap
from vision_semantic_segmentation_tpu.train.datasets import visualization as j_vis
from vision_semantic_segmentation_tpu.utils import benchmark as j_benchmark
from vision_semantic_segmentation_tpu.utils import file_io as j_file_io
from vision_semantic_segmentation_tpu.utils import images as j_images
from vision_semantic_segmentation_tpu.utils import pcd_bev as j_pcd_bev
from vision_semantic_segmentation_tpu_torch.config import get_demo_cfg_defaults
from vision_semantic_segmentation_tpu_torch.evaluation import compare
from vision_semantic_segmentation_tpu_torch.ops import colormap
from vision_semantic_segmentation_tpu_torch.train.datasets import visualization as vis
from vision_semantic_segmentation_tpu_torch.utils import benchmark, file_io, images, pcd_bev

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)


@pytest.fixture
def rng():
    return np.random.default_rng(21)


def _cloud(rng, n=500):
    xyz = rng.uniform([-10, -5, -1], [10, 5, 2], (n, 3)).astype(np.float32)
    return xyz, rng.uniform(0, 50, n).astype(np.float32)


def _write_pcd(path, xyz, intensity, fmt):
    n = len(xyz)
    header = ("# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
              "FIELDS x y z intensity\nSIZE 4 4 4 4\nTYPE F F F F\nCOUNT 1 1 1 1\n"
              f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\nDATA {fmt}\n")
    data = np.concatenate([xyz, intensity[:, None]], axis=1).astype(np.float32)
    with open(path, "wb") as f:
        f.write(header.encode())
        if fmt == "ascii":
            np.savetxt(f, data, fmt="%.9g")
        else:
            f.write(data.tobytes())


@pytest.mark.parametrize("fmt", ["ascii", "binary"])
def test_pcd_round_trip_and_bev(rng, tmp_path, fmt):
    xyz, intensity = _cloud(rng)
    path = str(tmp_path / f"cloud_{fmt}.pcd")
    _write_pcd(path, xyz, intensity, fmt)
    got, want = pcd_bev.read_pcd(path), j_pcd_bev.read_pcd(path)
    assert list(got) == list(want) == ["x", "y", "z", "intensity"]
    for k, v in zip(("x", "y", "z"), xyz.T):
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(np.float32(got[k]), v)
    np.testing.assert_array_equal(np.float32(got["intensity"]), intensity)
    for res, bounds in ((0.1, None), (0.25, ((-5, 5), (-4, 4)))):
        bev = pcd_bev.pointcloud_to_bev(xyz, intensity, res, bounds)
        np.testing.assert_array_equal(bev, j_pcd_bev.pointcloud_to_bev(xyz, intensity, res, bounds))
        assert bev.dtype == np.uint8 and bev.any()
    np.testing.assert_array_equal(pcd_bev.pointcloud_to_bev(xyz), j_pcd_bev.pointcloud_to_bev(xyz))
    a = pcd_bev.generate_pointcloud_bev(path, str(tmp_path / "port.jpg"), 0.2)
    b = j_pcd_bev.generate_pointcloud_bev(path, str(tmp_path / "jax.jpg"), 0.2)
    np.testing.assert_array_equal(cv2.imread(a), cv2.imread(b))


def test_images(rng, monkeypatch):
    lst = [rng.integers(0, 256, (30, 40, 3), dtype=np.uint8),
           rng.integers(0, 256, (24, 50), dtype=np.uint8),
           rng.integers(0, 256, (36, 36, 3), dtype=np.uint8)]
    for size in (None, (20, 25)):
        np.testing.assert_array_equal(images.concat_image_list(lst, size),
                                      j_images.concat_image_list(lst, size))
    assert images.concat_image_list([]) is None
    assert images.concat_image_list(lst[:1]) is lst[0]
    shown = []
    monkeypatch.setattr(cv2, "imshow", lambda title, img: shown.append((title, img)))
    monkeypatch.setattr(cv2, "waitKey", lambda delay: -1)
    images.show_image_list(lst)
    j_images.show_image_list(lst)
    assert shown[0][0] == shown[1][0] == "concatenated"
    np.testing.assert_array_equal(shown[0][1], shown[1][1])


def _dataset_config(tmp_path, rng, n=7):
    labels = [{"name": f"c{i}", "color": [int(c) for c in rng.integers(0, 256, 3)]}
              for i in range(n)]
    path = tmp_path / "config.json"
    path.write_text(json.dumps({"labels": labels}))
    return str(path)


def test_palettes(rng, tmp_path):
    path = _dataset_config(tmp_path, rng)
    np.testing.assert_array_equal(colormap.load_palette_from_dataset_config(path),
                                  j_colormap.load_palette_from_dataset_config(path))
    assert vis.get_labels(path) == j_vis.get_labels(path)
    np.testing.assert_array_equal(vis.bdd_trainid_color_map(), j_vis.bdd_trainid_color_map())
    cfg = get_demo_cfg_defaults()
    for train_dataset, dataset_config in (("", ""), ("BDD", ""), ("", path), ("bdd", path)):
        cfg.TRAIN_DATASET, cfg.DATASET_CONFIG = train_dataset, dataset_config
        np.testing.assert_array_equal(vis.palette_from_cfg(cfg), j_vis.palette_from_cfg(cfg))
    np.testing.assert_array_equal(vis.palette_from_cfg(None), j_vis.palette_from_cfg(None))
    labels = rng.integers(0, 40, (9, 11))
    labels[0, :3] = 255
    for arr in (labels, torch.from_numpy(labels)):
        np.testing.assert_array_equal(vis.apply_color_map(arr, vis.get_labels(path)),
                                      j_vis.apply_color_map(labels, j_vis.get_labels(path)))
        np.testing.assert_array_equal(vis.apply_bdd_color_map(arr),
                                      j_vis.apply_bdd_color_map(labels))


class _Writer:
    def __init__(self):
        self.calls = []

    def add_image(self, tag, img, step, dataformats):
        self.calls.append((tag, img, step, dataformats))


def test_grids_and_network_outputs(rng, tmp_path):
    imgs = rng.standard_normal((5, 8, 10, 3)).astype(np.float32)
    for nrow, pad in ((4, 2), (2, 0), (8, 1)):
        np.testing.assert_array_equal(vis.make_grid(imgs, nrow, pad), j_vis.make_grid(imgs, nrow, pad))
    np.testing.assert_array_equal(vis.denormalize_images(imgs), j_vis.denormalize_images(imgs))
    preds = rng.integers(0, 19, (5, 8, 10))
    labels = rng.integers(0, 19, (5, 8, 10))
    labels[:, 0] = 255
    dataset_labels = vis.get_labels(_dataset_config(tmp_path, rng, n=19))
    for ds in (None, dataset_labels):
        w, jw = _Writer(), _Writer()
        vis.log_network_outputs(w, "val", torch.from_numpy(imgs), torch.from_numpy(preds),
                                labels, 3, dataset_labels=ds, nrow=2)
        j_vis.log_network_outputs(jw, "val", imgs, preds, labels, 3, dataset_labels=ds, nrow=2)
        assert [c[0] for c in w.calls] == [c[0] for c in jw.calls] == [
            "val/image", "val/prediction", "val/label"]
        for c, jc in zip(w.calls, jw.calls):
            assert c[2:] == jc[2:]
            np.testing.assert_array_equal(c[1], jc[1])


def test_file_io(tmp_path):
    root = tmp_path / "tree"
    (root / "a" / "deep").mkdir(parents=True)
    (root / "b").mkdir()
    for name in ("x.txt", "y.tar.gz", "z"):
        (root / name).write_text(name)
    (root / "a" / "deep" / "f").write_text("f")
    d = str(root)
    assert sorted(file_io.get_dir_list(d)) == sorted(j_file_io.get_dir_list(d)) == ["a", "b"]
    for no_ext in (False, True):
        assert sorted(file_io.get_file_list(d, no_ext)) == sorted(j_file_io.get_file_list(d, no_ext))
    assert sorted(file_io.get_file_list(d, no_ext=True)) == ["x", "y.tar", "z"]
    file_io.move(str(root / "z"), str(root / "b" / "z"))
    assert (root / "b" / "z").read_text() == "z" and not (root / "z").exists()
    file_io.remove(str(root / "x.txt"), recursive=False)
    file_io.remove(str(root / "missing"))
    with pytest.raises(OSError):
        file_io.remove(str(root / "b"), recursive=False)
    file_io.remove(str(root / "a"))
    assert sorted(os.listdir(d)) == ["b", "y.tar.gz"]
    file_io.makedirs(str(root / "c" / "d"))
    file_io.makedirs(str(root / "c" / "d"), exist_ok=True)
    assert (root / "c" / "d").is_dir()


def test_compare_maps(rng, tmp_path):
    gt = tmp_path / "gt"
    gt.mkdir()
    np.save(gt / "truth.npy", rng.integers(0, 4, (50, 60)).astype(np.float64))
    colors = np.array([[0, 0, 0], [128, 64, 128], [140, 140, 200], [255, 255, 255],
                       [35, 142, 107]], np.uint8)
    cv2.imwrite(str(tmp_path / "map.png"), colors[rng.integers(0, 5, (40, 55))])
    figs = [fn(str(tmp_path / "map.png"), str(gt), save_path=str(tmp_path / f"{name}.png"))
            for name, fn in (("port", compare.compare_maps), ("jax", j_compare.compare_maps))]
    for ax, j_ax in zip(figs[0].axes, figs[1].axes):
        assert ax.get_title() == j_ax.get_title()
        np.testing.assert_array_equal(ax.images[0].get_array(), j_ax.images[0].get_array())
    assert figs[0].axes[0].images[0].get_array().shape == (40, 55)
    assert (tmp_path / "port.png").exists()


def test_timers(tmp_path, capsys):
    timer, j_timer = benchmark.StageTimer(), j_benchmark.StageTimer()
    for t in (timer, j_timer):
        t.totals, t.counts = {"decode": 0.5, "forward": 1.25, "fold": 0.0625}, {
            "decode": 2, "forward": 5, "fold": 1}
    assert timer.summary() == j_timer.summary()
    with timer.stage("fold", block_on=torch.ones(3)):
        pass
    with timer.stage("new"):
        pass
    assert timer.counts == {"decode": 2, "forward": 5, "fold": 2, "new": 1}

    @benchmark.device_timer
    def work(n):
        return {"a": torch.arange(n), "b": [torch.ones(2)]}

    @benchmark.timer
    def host(n):
        return n + 1

    assert work(4)["a"].tolist() == [0, 1, 2, 3] and host(1) == 2
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("work took ") and out[0].endswith("s (device)")
    assert out[1].startswith("host took ")
    with benchmark.trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    assert prof is not None
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)
    assert benchmark.profile(host)(2) == 3

"""Port parity: the serving operating-point sweep (``runtime/serving_pareto.py``,
``autotune --serving``) against the JAX package.

The pure functions (``default_points``, ``point_key``, ``pareto``,
``serving_overlay_yaml``) equal the JAX functions on the same rows.  The
frames/s sweep runs the real fused pipeline at tiny shapes on the CPU
(times say nothing of the card).  ``score_quality`` trains, maps and
scores on a thinned golden scene with a tiny recipe, no quality floor.
The two defects of the JAX module that the port does not copy are pinned:
the trained-weight cache keys on the recipe and the training sources, and
a sweep with a failed quality point is marked partial, in its result and
in its overlay.
"""
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vision_semantic_segmentation_tpu.runtime import serving_pareto as j_sp
from vision_semantic_segmentation_tpu_torch.__main__ import main
from vision_semantic_segmentation_tpu_torch.config import get_cfg_defaults
from vision_semantic_segmentation_tpu_torch.evaluation import synthetic_scene as scene_mod
from vision_semantic_segmentation_tpu_torch.runtime import serving_pareto as sp

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

IMAGE_HW = (64, 96)


def _rows():
    def mk(sc, up, fps, miou):
        point = dict(backbone="resnext50_32x4d", output_stride=8, image_scale=sc,
                     upsample_pred=up)
        return (dict(point, fps=fps),
                dict(point, miou=miou, iou={"road": miou}, missing_rate=0.0, train_s=1.0))

    pairs = [
        mk(1.0, False, 20.0, 0.90),    # the headline anchor
        mk(0.5, False, 45.0, 0.88),    # fast, within 95 % of 0.90
        mk(0.5, True, 42.0, 0.89),     # slower, higher quality
        mk(0.355, False, 55.0, 0.70),  # fastest, quality collapsed
        mk(0.25, False, 30.0, 0.60),   # dominated
    ]
    return [p[0] for p in pairs], [p[1] for p in pairs]


@pytest.mark.parametrize("kw", [{}, dict(backbones=("resnet18",), strides=(16,),
                                         scales=(1.0, 0.1), upsample=(True,))])
def test_points_and_keys_equal_jax(kw):
    assert sp.default_points(**kw) == j_sp.default_points(**kw)
    assert [sp.point_key(p) for p in sp.default_points(**kw)] == \
        [j_sp.point_key(p) for p in j_sp.default_points(**kw)]
    assert sp.HEADLINE_POINT == j_sp.HEADLINE_POINT


@pytest.mark.parametrize("drop", [None, 0, "quality"], ids=["all", "no_anchor", "no_quality"])
def test_pareto_and_overlay_equal_jax(drop, tmp_path):
    fps_rows, q_rows = _rows()
    if drop == 0:
        fps_rows, q_rows = fps_rows[1:], q_rows[1:]
    elif drop == "quality":
        q_rows = []
    ours = sp.pareto(fps_rows, q_rows, quality_budget=0.95)
    ref = j_sp.pareto(fps_rows, q_rows, quality_budget=0.95)
    assert {k: ours[k] for k in ref} == ref
    assert ours["partial"] is False and ours["missing_quality_points"] == []
    if ref["recommended"] is None:
        return
    text = sp.serving_overlay_yaml(ours["recommended"], ours)
    assert text == j_sp.serving_overlay_yaml(ref["recommended"], ref)
    path = tmp_path / "serving.yaml"
    path.write_text(text)
    cfg = get_cfg_defaults()
    cfg.merge_from_file(str(path))
    assert cfg.VISION_SEM_SEG.IMAGE_SCALE == ours["recommended"]["image_scale"]
    assert cfg.VISION_SEM_SEG.SEM_SEG_NETWORK.MODEL.BACKBONE == "resnext50_32x4d"


def test_sweep_fps_rows(tmp_path):
    cfg = get_cfg_defaults()
    cfg.OUTPUT_DIR = str(tmp_path / "out")
    cfg.MAPPING.BOUNDARY = [[100, 140], [800, 840]]
    cfg.MAPPING.POINT_BUCKET = 2048
    cfg.VISION_SEM_SEG.SEM_SEG_NETWORK.MODEL.TYPE = "Dummy"
    points = [{"backbone": "Dummy", "output_stride": 16, "image_scale": 1.0,
               "upsample_pred": False},
              {"backbone": "Dummy", "output_stride": 16, "image_scale": 0.5,
               "upsample_pred": True}]
    lines = []
    rows = sp.sweep_fps(cfg, points, image_hw=IMAGE_HW, window=2, n_windows=1, repeats=1,
                        log=lines.append, device="cpu")
    assert len(rows) == 2 == len(lines)
    for row, point in zip(rows, points):
        assert row["fps"] > 0 and row["ms_per_frame"] > 0 and row["warmup_s"] >= 0
        assert {k: row[k] for k in point} == point


def test_weight_cache_keys_on_recipe_and_sources(tmp_path, monkeypatch):
    """The JAX cache keys on the point alone; here another recipe or other
    training sources train anew, and the same ones reuse the file."""
    seen = []

    class Stop(Exception):
        pass

    def fake_train(frames, labels, weight_path, **kw):
        seen.append((weight_path, kw))
        raise Stop

    monkeypatch.setattr(scene_mod, "train_segmenter", fake_train)
    scene = SimpleNamespace(root=str(tmp_path), images=[np.zeros((8, 8, 3), np.uint8)] * 2,
                            net_labels=[np.zeros((8, 8), np.uint8)] * 2, train_idx=[0],
                            val_idx=[1])
    point = {"backbone": "resnet18", "output_stride": 16, "image_scale": 1.0,
             "upsample_pred": False}

    def path_for(**kw):
        with pytest.raises(Stop):
            sp.score_quality(scene, point, device="cpu", **kw)
        return seen[-1][0]

    base = path_for(train_steps=7)
    assert seen[-1][1]["max_steps"] == 7 and "lr" not in seen[-1][1]
    assert "quality_floor" not in seen[-1][1]
    assert path_for(train_steps=7) == base
    others = [path_for(train_steps=8), path_for(train_steps=7, train_batch=4),
              path_for(train_steps=7, train_lr=1.5e-3), path_for(train_steps=7, train_floor=None),
              path_for(train_steps=7, compute_dtype=torch.float32)]
    assert seen[-3][1]["lr"] == 1.5e-3 and seen[-2][1]["quality_floor"] is None
    monkeypatch.setattr(sp, "training_digest", lambda: "other sources")
    others.append(path_for(train_steps=7))
    assert len({base, *others}) == 7
    assert all(p.endswith(".pth") and "seg_resnet18_os16_s1.0_" in p for p in others)


def test_partial_sweep_is_marked(tmp_path, monkeypatch):
    """A failed quality point leaves the sweep going, marked ``partial``
    with the point's key, in the JSON and in the overlay's first line."""
    points = [{"backbone": "resnet18", "output_stride": 16, "image_scale": s,
               "upsample_pred": False} for s in (1.0, 0.5)]
    monkeypatch.setattr(sp, "default_points", lambda **kw: [dict(p) for p in points])
    monkeypatch.setattr(sp, "sweep_fps", lambda cfg, pts, **kw: [
        dict(p, fps=10.0 + i, ms_per_frame=1.0, warmup_s=0.0) for i, p in enumerate(pts)])
    monkeypatch.setattr(sp, "SceneArtifacts", lambda *a, **k: object())

    def fake_quality(scene, point, **kw):
        if point["image_scale"] == 0.5:
            raise RuntimeError("deterministic training collapse")
        return dict(point, miou=0.9, iou={"road": 0.9}, missing_rate=0.0, train_s=1.0)

    monkeypatch.setattr(sp, "score_quality", fake_quality)
    out, js = tmp_path / "rec.yaml", tmp_path / "sweep.json"
    result = main(["autotune", "--serving", "--out", str(out), "--json", str(js),
                   "--device", "cpu"])
    assert result["partial"] is True
    assert result["missing_quality_points"] == [["resnet18", 16, 0.5, False]]
    assert json.loads(js.read_text())["partial"] is True
    first = out.read_text().splitlines()[0]
    assert first.startswith("# PARTIAL sweep") and "0.5" in first
    cfg = get_cfg_defaults()
    cfg.merge_from_file(str(out))  # the marker is a comment: the overlay still merges
    assert cfg.VISION_SEM_SEG.IMAGE_SCALE == 1.0


def test_score_quality_on_a_tiny_scene(tmp_path):
    """Scene render -> training -> fused mapping -> MapEvaluator at a
    thinned pose lattice and a tiny recipe (6 poses, 6 steps of 2 frames,
    no floor): mechanics only; the weights are reused on a second call."""
    scene = sp.SceneArtifacts(str(tmp_path / "scene"), pose_stride=15)
    point = {"backbone": "resnet18", "output_stride": 16, "image_scale": 0.1,
             "upsample_pred": True}
    kw = dict(train_steps=6, train_batch=2, compute_dtype=torch.float32, map_window=4,
              train_floor=None, device="cpu")
    row = sp.score_quality(scene, point, **kw)
    assert 0.0 <= row["miou"] <= 1.0 and set(row["iou"]) == {"road", "crosswalk", "lane"}
    assert {k: row[k] for k in point} == point and row["train_s"] > 0
    again = sp.score_quality(scene, point, **kw)
    assert again["miou"] == row["miou"] and again["train_s"] < row["train_s"]

"""Port parity: the golden synthetic scene against the JAX package's.

The scene, the poses, the point map, the rendered frames (the same rays and
class tests: equal images and labels), the class-balanced crops (the same
numpy generator: equal crops) and the ground truth (the port's
``truth.npy``/``mask.npy`` against what the JAX ``MapEvaluator`` decodes
from the JAX package's ``bev-5cm-*.jpg`` layers through OpenCV: equal).
Then a short ``train_segmenter`` on the CPU, and (marked slow: it trains
300 steps and runs the pipeline over 90 frames, several minutes on a CPU)
the golden quality floors of ``tests/test_e2e_golden.py`` with the port's
own weights and the port's fused pipeline.
"""
import numpy as np
import pytest
import torch

from vision_semantic_segmentation_tpu.evaluation import synthetic_scene as J
from vision_semantic_segmentation_tpu.evaluation.map_eval import MapEvaluator as JMapEvaluator
from vision_semantic_segmentation_tpu_torch.evaluation import synthetic_scene as S
from vision_semantic_segmentation_tpu_torch.evaluation.map_eval import MapEvaluator
from vision_semantic_segmentation_tpu_torch.models.convert import load_weights
from vision_semantic_segmentation_tpu_torch.ops.resize import resize_area
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)


def test_poses_point_map_and_config_match():
    for (p, q), (jp, jq) in zip(S.make_poses(), J.make_poses()):
        np.testing.assert_array_equal(p, jp)
        np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(S.make_point_map(), J.make_point_map())
    assert S.scaled_hw(0.1) == J.scaled_hw(0.1) and S.scaled_hw(1.5) == J.scaled_hw(1.5)
    cfg, jcfg = S.scene_network_cfg("w.pth"), J.scene_network_cfg("w.pth")
    assert cfg.dump() == jcfg.dump()
    assert (S.apply_scene_mapping_cfg(cfg, 0.2).dump()
            == J.apply_scene_mapping_cfg(jcfg, 0.2).dump())


@pytest.mark.parametrize("index", [0, 13, 47, 88])
def test_render_frame_matches(index):
    position, quaternion = S.make_poses()[index]
    img, lab = S.render_frame(position, quaternion, scale=4)
    jimg, jlab = J.render_frame(position, quaternion, scale=4)
    np.testing.assert_array_equal(img, jimg)
    np.testing.assert_array_equal(lab, jlab)
    np.testing.assert_array_equal(S.subsample_labels(lab, (144, 192)),
                                  J.subsample_labels(jlab, (144, 192)))


def test_mapped_crops_match():
    rng = np.random.default_rng(0)
    images = rng.standard_normal((2, 40, 50, 3)).astype(np.float32)
    targets = rng.choice([0, 1, 2, 5, 8], (2, 40, 50)).astype(np.int32)
    got = S._mapped_crops(images, targets, (16, 20), 6, (2, 1, 8), np.random.default_rng(11))
    want = J._mapped_crops(images, targets, (16, 20), 6, (2, 1, 8), np.random.default_rng(11))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_truth_arrays_equal_the_decoded_jpegs(tmp_path):
    pytest.importorskip("cv2")
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    J.write_ground_truth(str(tmp_path / "jax"))
    S.write_truth_arrays(str(tmp_path / "port"))
    want = JMapEvaluator(ground_truth_dir=str(tmp_path / "jax"))
    got = MapEvaluator(ground_truth_dir=str(tmp_path / "port"))
    np.testing.assert_array_equal(got.ground_truth, want.ground_truth)
    np.testing.assert_array_equal(got.mask, want.mask)
    assert set(np.unique(got.ground_truth)) == {0.0, 1.0, 2.0, 3.0}


def _small_views(count, offset=0):
    poses = S.make_poses()
    idx = [(offset + i * 11) % len(poses) for i in range(count)]
    frames, labels = [], []
    for i in idx:
        img, lab = S.render_frame(*poses[i])
        frames.append(resize_area(torch.from_numpy(img), (72, 96)).numpy().astype(np.float32))
        labels.append(lab[9::20, 9::20])
    return frames, labels


def test_train_segmenter_short(tmp_path):
    """A few steps on the CPU: the weights load into the serving model and
    the last train batch's accuracy is reported (no quality floor)."""
    frames, labels = _small_views(2)
    path = str(tmp_path / "seg.pth")
    acc = S.train_segmenter(frames, labels, path, max_steps=3, min_steps=1,
                            quality_floor=None, device="cpu")
    assert 0.0 <= acc <= 1.0
    sd = load_weights(path)
    assert "backbone.conv1.weight" in sd and "aspp.global_avg_pool.1.bn.running_var" in sd


def test_dropout_is_seeded_whatever_ran_before(tmp_path):
    """ASPP's dropout draws from a fork of the default generator seeded by
    the trainer: two runs with different draws from the global generators
    before them save equal weights, bit for bit."""
    frames, labels = _small_views(2)
    weights = []
    for seed in (3, 4):
        torch.manual_seed(seed)
        torch.nn.functional.dropout(torch.ones(10_000 * seed), 0.5)
        path = str(tmp_path / f"seg_{seed}.pth")
        S.train_segmenter(frames, labels, path, max_steps=2, min_steps=1,
                          quality_floor=None, device="cpu")
        weights.append(load_weights(path))
    assert weights[0].keys() == weights[1].keys()
    for key, value in weights[0].items():
        assert torch.equal(value, weights[1][key]), key


def test_quality_floor_reads_the_eval_step(tmp_path, monkeypatch):
    """The final floor reads the final weights through the evaluation step
    (running statistics, no update), never a train step."""
    from vision_semantic_segmentation_tpu_torch.parallel import train_step

    calls = {"train": 0, "eval": 0}
    make_train, make_eval = train_step.make_train_step, train_step.make_eval_step

    def counting(kind, make):
        def build(*a, **k):
            fn = make(*a, **k)

            def run(*args):
                calls[kind] += 1
                return fn(*args)
            return run
        return build

    monkeypatch.setattr(train_step, "make_train_step", counting("train", make_train))
    monkeypatch.setattr(train_step, "make_eval_step", counting("eval", make_eval))
    frames, labels = _small_views(2)
    with pytest.raises(AssertionError, match="failed to overfit"):
        S.train_segmenter(frames, labels, str(tmp_path / "seg.pth"), max_steps=2, min_steps=1,
                          quality_floor=(1.01, 0.0), batch_size=1, device="cpu")
    assert calls == {"train": 2, "eval": 2}  # one eval per train batch, after the 2 steps


@pytest.mark.slow
def test_golden_floors_with_port_weights(tmp_path):
    """The golden scene trained by the port (the JAX test's recipe: resnet18
    OS16 at 144x192, 8 train and 8 held-out views, 300 steps at most), then
    the port's ``pipeline --fused`` over the 90-frame bag, scored against
    ``truth.npy`` with the floors of ``test_cli_pipeline_iou``."""
    from vision_semantic_segmentation_tpu_torch.__main__ import main

    poses = S.make_poses()
    images, net_labels = zip(*[S.render_frame(p, q) for p, q in poses])
    train_idx = list(range(0, len(poses), len(poses) // 8))[:8]
    stride = len(poses) // 8
    val_idx = [min(i + max(1, stride // 2), len(poses) - 1) for i in train_idx]

    def small(idx):
        return ([resize_area(torch.from_numpy(images[i]), (144, 192)).numpy().astype(np.float32)
                 for i in idx], [net_labels[i][4::10, 4::10] for i in idx])

    frames, labels = small(train_idx)
    val_frames, val_labels = small(val_idx)
    weights = str(tmp_path / "segmenter.pth")
    S.train_segmenter(frames, labels, weights, max_steps=300, val_frames=val_frames,
                      val_labels=val_labels, device="cpu")
    gt = tmp_path / "gt"
    gt.mkdir()
    S.write_truth_arrays(str(gt))
    bag = S.build_scene_bag(str(tmp_path / "bag.npz"), images, poses)
    cfg = S.apply_scene_mapping_cfg(S.scene_network_cfg(weights), image_scale=0.1)
    cfg.OUTPUT_DIR = str(tmp_path / "out")
    cfg.GROUND_TRUTH_DIR = str(gt)
    (tmp_path / "golden.yaml").write_text(cfg.dump())
    run = main(["pipeline", "--cfg", str(tmp_path / "golden.yaml"), "--bag", bag, "--fused",
                "--device", "cpu"])
    result = MapEvaluator(ground_truth_dir=str(gt)).test_single_map(run.color_map)
    assert result["iou"]["road"] >= 0.88, result
    assert result["iou"]["crosswalk"] >= 0.92, result
    assert result["iou"]["lane"] >= 0.80, result
    assert result["miou"] >= 0.87, result

"""Port parity: the grid-update autotuner (``runtime/tuning.py``'s
``tune``, ``overlay_yaml``, ``write_overlay``; the ``autotune`` command)
against the JAX package.

The Dummy model at 64x96 in f32 on a 400x400 grid, windows of 2 frames,
on the CPU.  CPU times say nothing of the card: what is held is the
mechanics.  Every ``UPDATE_WINDOW`` candidate builds and runs the fused
pipeline, without a sweep the dense update and the cfg's safe window are
timed (the safe window only where it is smaller than the grid), a lossy
window is timed but never wins and every-candidate-lossy raises, the first
row wins a tie, the overlay merges back into a config, the command writes
it, and on one config the rows' ``lossy`` flags and update windows equal
the JAX ``tune``'s at its default fold and sort (timings are not
compared).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vision_semantic_segmentation_tpu.config import get_cfg_defaults as j_cfg_defaults
from vision_semantic_segmentation_tpu.models import build_model as j_build_model
from vision_semantic_segmentation_tpu.runtime import tuning as j_tuning
from vision_semantic_segmentation_tpu_torch.__main__ import main
from vision_semantic_segmentation_tpu_torch.config import get_cfg_defaults
from vision_semantic_segmentation_tpu_torch.runtime import tuning
from vision_semantic_segmentation_tpu_torch.runtime.tuning import overlay_yaml, tune, write_overlay

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

IMAGE_HW = (64, 96)
SMALL = dict(image_hw=IMAGE_HW, window=2, n_windows=1, repeats=1, distortion="none")
ROW_KEYS = ["update_window", "lossy", "distortion", "fps", "ms_per_frame", "warmup_s"]


def _cfg(make, tmp_path):
    cfg = make()
    cfg.OUTPUT_DIR = str(tmp_path / "out")
    cfg.MAPPING.BOUNDARY = [[100, 140], [800, 840]]
    cfg.MAPPING.POINT_BUCKET = 2048
    net = cfg.VISION_SEM_SEG.SEM_SEG_NETWORK
    net.MODEL.TYPE = "Dummy"
    net.MODEL.COMPUTE_DTYPE = "float32"
    return cfg


@pytest.fixture(scope="module")
def variables(tmp_path_factory):
    net = _cfg(j_cfg_defaults, tmp_path_factory.mktemp("net")).VISION_SEM_SEG.SEM_SEG_NETWORK
    model = j_build_model(net)[0]
    tree = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3), jnp.float32))
    return jax.tree.map(np.asarray, dict(tree))


def test_rows_result_and_overlay_roundtrip(variables, tmp_path):
    cfg = _cfg(get_cfg_defaults, tmp_path)
    # RANGE_MAX 100 m at 0.1 m needs 2200 cells, more than the 400-cell grid:
    # the dense update alone; at 5 m, 110 cells: the dense update and 110
    assert tuning._default_windows(cfg) == (0,)
    cfg.MAPPING.PCD.RANGE_MAX = 5.0
    lines = []
    result = tune(cfg, variables=variables, log=lines.append, device="cpu", **SMALL)
    assert list(result) == ["rows", "best", "device_kind", "image_hw", "window", "n_windows",
                            "point_bucket", "boundary", "resolution"]
    assert result["device_kind"] == "cpu" and result["image_hw"] == list(IMAGE_HW)
    assert len(result["rows"]) == 2 == len(lines)
    assert [(r["update_window"], r["lossy"]) for r in result["rows"]] == [(0, False), (110, False)]
    assert all(list(r) == ROW_KEYS and r["fps"] > 0 for r in result["rows"])
    assert result["best"]["fps"] == max(r["fps"] for r in result["rows"])
    path = write_overlay(result, str(tmp_path / "tuned.yaml"))
    merged = get_cfg_defaults()
    merged.merge_from_file(path)
    assert merged.MAPPING.UPDATE_WINDOW == result["best"]["update_window"]
    assert "FOLD_METHOD" not in overlay_yaml(result) and "SORT_METHOD" not in overlay_yaml(result)


def test_lossy_window_never_wins(variables, tmp_path):
    """RANGE_MAX 100 m at 0.1 m needs 2200 cells: a 128-cell window drops
    points, is timed and flagged, and never wins; alone it raises."""
    cfg = _cfg(get_cfg_defaults, tmp_path)
    result = tune(cfg, variables=variables, update_windows=[128, 0], device="cpu", **SMALL)
    by_uw = {r["update_window"]: r for r in result["rows"]}
    assert by_uw[128]["lossy"] and not by_uw[0]["lossy"]
    assert result["best"]["update_window"] == 0
    assert "UPDATE_WINDOW: 0" in overlay_yaml(result)
    with pytest.raises(ValueError, match="lossy"):
        tune(cfg, variables=variables, update_windows=[128], device="cpu", **SMALL)


def test_lossy_flags_equal_jax(variables, tmp_path):
    """On one config the port's rows and the JAX rows at its default fold
    and sort carry the same update windows and lossy flags (RANGE_MAX 5 m:
    110 cells needed)."""
    j_cfg, cfg = _cfg(j_cfg_defaults, tmp_path), _cfg(get_cfg_defaults, tmp_path)
    for c in (j_cfg, cfg):
        c.MAPPING.PCD.RANGE_MAX = 5.0
    kw = dict(update_windows=[0, 100, 128], **SMALL)
    ours = tune(cfg, variables=variables, device="cpu", **kw)
    ref = j_tuning.tune(j_cfg, variables=variables, combos=[("matmul", "bitonic")], **kw)

    def flags(rows):
        return [(r["update_window"], r["lossy"], r["distortion"]) for r in rows]

    assert flags(ours["rows"]) == flags(ref["rows"])
    assert [r["lossy"] for r in ours["rows"]] == [False, True, False]


def test_defaults_win_ties(tmp_path, monkeypatch):
    """Equal-fps rows keep the first candidate, through ``tune`` itself."""
    order = []

    def fake_row(cfg, state_dict, uw, windows, image_hw, window, camera, repeats, distortion,
                 device):
        order.append(uw)
        return {"update_window": uw, "lossy": False, "distortion": "none", "fps": 5.0,
                "ms_per_frame": 200.0, "warmup_s": 0.0}

    monkeypatch.setattr(tuning, "_time_update_window", fake_row)
    monkeypatch.setattr(tuning, "generate_windows", lambda *a, **k: [])
    monkeypatch.setattr(tuning, "init_state_dict", lambda *a, **k: {})
    result = tuning.tune(_cfg(get_cfg_defaults, tmp_path), window=2, n_windows=1,
                         update_windows=[0, 2400, 3000], device="cpu")
    assert order == [0, 2400, 3000]
    assert result["best"]["update_window"] == 0


def test_cli_writes_overlay(tmp_path):
    cfg = _cfg(get_cfg_defaults, tmp_path)
    cfg_path = str(tmp_path / "exp.yaml")
    with open(cfg_path, "w") as f:
        f.write(cfg.dump())
    out = str(tmp_path / "tuned.yaml")
    result = main(["autotune", "--cfg", cfg_path, "--out", out, "--height", "64", "--width",
                   "96", "--window", "2", "--windows", "1", "--repeats", "1",
                   "--update-windows", "128,0", "--distortion", "none", "--device", "cpu"])
    assert os.path.exists(out) and len(result["rows"]) == 2
    merged = get_cfg_defaults()
    merged.merge_from_file(out)
    assert merged.MAPPING.UPDATE_WINDOW == 0  # 128 is lossy
    with pytest.raises(SystemExit):
        main(["autotune", "--cfg", cfg_path, "--folds", "scatter", "--device", "cpu"])

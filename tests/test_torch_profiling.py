"""Port parity: the stage profiler (``runtime/profiling.py``, the ``profile``
command) and the measurement helpers of ``runtime/tuning.py`` against the
JAX package.

The Dummy model at 64x96 in f32, a 400x400 grid, windows of 2 frames, one
window, one repeat, on the CPU.  CPU times say nothing of the card; what is
held is the mechanics: the result carries the JAX package's keys, every
stage runs and is positive, fusion is e2e - forward (each rounded to 1e-3,
so to within 1.5e-3), degenerate windows raise the JAX message, the
confidence path runs, ``format_report`` renders a dict as the JAX function
does, the ``'auto'`` distortion rule answers as the JAX rule does, and the
command writes its JSON.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_semantic_segmentation_tpu.config import get_cfg_defaults as j_cfg_defaults
from vision_semantic_segmentation_tpu.mapping.engine import SemanticMappingEngine as JaxEngine
from vision_semantic_segmentation_tpu.models import build_model as j_build_model
from vision_semantic_segmentation_tpu.runtime import profiling as j_profiling
from vision_semantic_segmentation_tpu.runtime import tuning as j_tuning
from vision_semantic_segmentation_tpu_torch.__main__ import main
from vision_semantic_segmentation_tpu_torch.config import get_cfg_defaults
from vision_semantic_segmentation_tpu_torch.mapping import SemanticMappingEngine
from vision_semantic_segmentation_tpu_torch.runtime import profiling, tuning

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

IMAGE_HW = (64, 96)
SMALL = dict(image_hw=IMAGE_HW, window=2, n_windows=1, repeats=1, distortion="none")


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


@pytest.fixture(scope="module")
def jax_result(variables, tmp_path_factory):
    cfg = _cfg(j_cfg_defaults, tmp_path_factory.mktemp("jax_profile"))
    return j_profiling.profile_stages(cfg, variables=variables, **SMALL)


def test_result_keys_and_stages(variables, jax_result, tmp_path):
    lines = []
    result = profiling.profile_stages(_cfg(get_cfg_defaults, tmp_path), variables=variables,
                                      log=lines.append, device="cpu", **SMALL)
    assert list(result) == list(jax_result)
    for key in ("image_hw", "window", "n_windows", "repeats", "camera", "distortion",
                "confidence_weighting", "boundary", "resolution", "point_bucket"):
        assert result[key] == jax_result[key], key
    assert result["device_kind"] == "cpu"
    for key in ("null_ms", "forward_ms_raw", "e2e_ms_raw", "e2e_fps"):
        assert result[key] > 0, key
    assert abs(result["forward_ms"] - max(result["forward_ms_raw"] - result["null_ms"], 0)) < 1.5e-3
    assert abs(result["e2e_ms"] - max(result["e2e_ms_raw"] - result["null_ms"], 0)) < 1.5e-3
    assert abs(result["fusion_ms"] - max(result["e2e_ms"] - result["forward_ms"], 0)) < 1.5e-3
    assert any("forward" in ln for ln in lines) and any("e2e" in ln for ln in lines)
    assert profiling.format_report(result) == j_profiling.format_report(result)
    assert profiling.format_report(jax_result) == j_profiling.format_report(jax_result)


@pytest.mark.parametrize("window, n_windows", [(0, 1), (2, 0)])
def test_degenerate_windows_raise_the_jax_message(tmp_path, window, n_windows):
    with pytest.raises(ValueError) as j_err:
        j_profiling.profile_stages(_cfg(j_cfg_defaults, tmp_path), image_hw=IMAGE_HW,
                                   window=window, n_windows=n_windows)
    with pytest.raises(ValueError) as err:
        profiling.profile_stages(_cfg(get_cfg_defaults, tmp_path), image_hw=IMAGE_HW,
                                 window=window, n_windows=n_windows, device="cpu")
    assert str(err.value) == str(j_err.value)


def test_confidence_path_and_random_init(tmp_path):
    """The confidence-weighted fusion path, on ``init_state_dict``'s weights."""
    result = profiling.profile_stages(_cfg(get_cfg_defaults, tmp_path), device="cpu",
                                      confidence_weighting=True, **SMALL)
    assert result["confidence_weighting"] is True and result["e2e_fps"] > 0


@pytest.mark.parametrize("distortion", ["auto", "none", "points"])
@pytest.mark.parametrize("image_hw", [(1440, 1920), IMAGE_HW], ids=["calibrated", "other"])
@pytest.mark.parametrize("undistort", [True, False])
def test_resolve_distortion(tmp_path, distortion, image_hw, undistort):
    answers = []
    for make, engine in ((j_cfg_defaults, JaxEngine), (get_cfg_defaults, None)):
        cfg = _cfg(make, tmp_path)
        cfg.VISION_SEM_SEG.UNDISTORT = undistort
        if engine is None:
            eng, resolve = SemanticMappingEngine(cfg, device="cpu"), tuning._resolve_distortion
        else:
            eng, resolve = engine(cfg), j_tuning._resolve_distortion
        answers.append(resolve(cfg, eng, "camera1", image_hw, distortion))
    assert answers[0] == answers[1]
    if distortion == "auto":
        assert answers[1] == ("points" if undistort and image_hw == (1440, 1920) else "none")


def test_windows_and_init(tmp_path):
    """The JAX package's window shapes, dtypes and ranges; a new generator
    per window; seeded weights that do not depend on the run."""
    cfg = _cfg(get_cfg_defaults, tmp_path)
    windows = tuning.generate_windows(cfg, IMAGE_HW, 3, 2, device="cpu")
    j_windows = j_tuning.generate_windows(_cfg(j_cfg_defaults, tmp_path), IMAGE_HW, 3, 2)
    for w, jw in zip(windows, j_windows):
        assert w.keys() == jw.keys()
        for k in w:
            assert tuple(w[k].shape) == jw[k].shape, k
            assert str(w[k].dtype).split(".")[-1] == str(jw[k].dtype), k
        for row in range(4):
            lo, hi = float(jnp.min(jw["pcd"][:, row])), float(jnp.max(jw["pcd"][:, row]))
            span = hi - lo
            assert lo - 0.02 * span <= float(w["pcd"][:, row].min()) <= lo + 0.02 * span
            assert hi - 0.02 * span <= float(w["pcd"][:, row].max()) <= hi + 0.02 * span
        np.testing.assert_array_equal(w["position"].numpy(), np.asarray(jw["position"]))
        np.testing.assert_array_equal(w["quaternion"].numpy(), np.asarray(jw["quaternion"]))
    assert not torch.equal(windows[0]["image"], windows[1]["image"])
    net = cfg.VISION_SEM_SEG.SEM_SEG_NETWORK
    a, b = (tuning.init_state_dict(net, device="cpu", seed=3) for _ in range(2))
    assert all(torch.equal(a[k], b[k]) for k in a)
    c = tuning.init_state_dict(net, device="cpu", seed=4)
    assert not torch.equal(a["Conv.0.weight"], c["Conv.0.weight"])


def test_cli_writes_json(tmp_path, capsys):
    cfg_path = tmp_path / "exp.yaml"
    cfg_path.write_text(_cfg(get_cfg_defaults, tmp_path).dump())
    out = tmp_path / "profile.json"
    result = main(["profile", "--cfg", str(cfg_path), "--height", "64", "--width", "96",
                   "--window", "2", "--windows", "1", "--repeats", "1",
                   "--distortion", "none", "--json", str(out), "--device", "cpu"])
    assert json.loads(out.read_text()) == result
    printed = capsys.readouterr().out
    assert profiling.format_report(result) in printed and f"wrote {out}" in printed

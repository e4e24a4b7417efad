"""Port parity: the exported frame step (``runtime/export.py``, the
``compile`` command, ``FusedFramePipeline.compile_sequence_runner``)
against ``run_window`` and the JAX package's exported runner.

The slice test's config (``test_torch_pipeline.py``): DeepLabV3+ ResNet-18
with a narrow ASPP and decoder, here at OS16, on raw 1440x1920 frames cut
to 1/16 before the network, a 200x200 grid, a bucket of 2048, in f32 on
the CPU.  The port's exported runner equals its own ``run_window`` bit for
bit (the same ops, the kernels' plain versions as the custom ops' CPU
impls); against the JAX exported runner the grid agrees to 1e-4 with the
same set of nonzero cells (the slice test's tolerance: evidence summed in
another order).
"""
import io
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_semantic_segmentation_tpu.config import get_cfg_defaults as j_cfg_defaults
from vision_semantic_segmentation_tpu.models.build import build_model as j_build_model
from vision_semantic_segmentation_tpu.runtime import export as j_export
from vision_semantic_segmentation_tpu.runtime.pipeline import FusedFramePipeline as JaxPipeline
from vision_semantic_segmentation_tpu_torch.__main__ import main
from vision_semantic_segmentation_tpu_torch.config import get_cfg_defaults
from vision_semantic_segmentation_tpu_torch.models import flax_to_state_dict
from vision_semantic_segmentation_tpu_torch.runtime import FusedFramePipeline
from vision_semantic_segmentation_tpu_torch.runtime.export import (
    load_sequence_runner,
    export_sequence_runner,
)

from test_torch_models import _randomize_bn
from test_torch_pipeline import IMAGE_HW, N_FRAMES, _cfg, _frames
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

JAX_META_KEYS = {"image_hw", "window", "camera", "pcd_frame_id", "grid_shape", "point_bucket",
                 "distortion", "platforms"}


def _os16(cfg):
    cfg.VISION_SEM_SEG.SEM_SEG_NETWORK.MODEL.OUTPUT_STRIDE = 16
    return cfg


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("export")
    rng = np.random.default_rng(31)
    jcfg = _os16(_cfg(j_cfg_defaults, tmp, tmp))
    cfg = _os16(_cfg(get_cfg_defaults, tmp, tmp))
    jmodel = j_build_model(jcfg.VISION_SEM_SEG.SEM_SEG_NETWORK)[0]
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 90, 120, 3)))
    variables = _randomize_bn(jax.tree.map(np.asarray, dict(variables)), rng)
    frames = _frames(rng)
    # centre a random network's logits on frame 0, unmapped classes held
    # back, so points take several map channels (as the slice test does)
    seg = JaxPipeline(jcfg, variables, compute_dtype=jnp.float32)._build_segmentation(
        "camera1", IMAGE_HW)
    logits = np.asarray(seg(variables, jnp.asarray(frames["image"][0])))[0]
    head = variables["params"]["decoder"]["refine_layers_2"]["conv"]
    unmapped = ~np.isin(np.arange(19), jcfg.LABELS)
    head["bias"] = (head["bias"] - logits.mean((0, 1))
                    - unmapped * 0.5 * logits.std((0, 1))).astype(np.float32)

    jpipe = JaxPipeline(jcfg, variables, compute_dtype=jnp.float32, distortion="points")
    j_path = str(tmp / "jax.vsstexp")
    j_export.export_sequence_runner(jpipe, j_path, image_hw=IMAGE_HW, window=N_FRAMES)
    j_run, _ = j_export.load_sequence_runner(j_path, variables)
    j_grid = np.asarray(j_run(jpipe.init_grid(), {k: jnp.asarray(v) for k, v in frames.items()}))

    state_dict = flax_to_state_dict(variables)
    pipe = FusedFramePipeline(cfg, state_dict=state_dict, compute_dtype=torch.float32,
                              distortion="points", device="cpu")
    path = str(tmp / "port.vsstexp")
    export_sequence_runner(pipe, path, image_hw=IMAGE_HW, window=N_FRAMES)
    frames = {k: torch.from_numpy(v) for k, v in frames.items()}
    return dict(cfg=cfg, pipe=pipe, path=path, state_dict=state_dict, frames=frames,
                j_grid=j_grid, tmp=tmp)


def test_exported_equals_run_window_and_jax(exported):
    pipe, frames = exported["pipe"], exported["frames"]
    run, meta = load_sequence_runner(exported["path"], exported["state_dict"])
    grid = pipe.init_grid()
    out = run(grid, frames)
    assert out is grid  # updated in place and returned
    want = pipe.run_window(pipe.init_grid(), frames)
    assert torch.equal(grid, want)
    j_grid = exported["j_grid"]
    assert (j_grid != 0).sum() > 100
    np.testing.assert_allclose(grid.numpy(), j_grid, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(grid.numpy() != 0, j_grid != 0)


def test_metadata_and_artifact(exported):
    _, meta = load_sequence_runner(exported["path"], exported["state_dict"])
    assert JAX_META_KEYS <= set(meta) and set(meta) - JAX_META_KEYS == {"parameters"}
    assert meta["image_hw"] == list(IMAGE_HW) and meta["window"] == N_FRAMES
    assert meta["grid_shape"] == [5, 200, 200] and meta["point_bucket"] == 2048
    assert meta["platforms"] == ["cpu"] and meta["distortion"] == "points"
    assert meta["camera"] == "camera1" and meta["pcd_frame_id"] == ""
    assert [p[0] for p in meta["parameters"]] == list(exported["pipe"].model.state_dict())
    # the weights stay out of the artifact
    sd_bytes = sum(t.numel() * t.element_size() for t in exported["state_dict"].values())
    with open(exported["path"], "rb") as f:
        assert len(f.read()) < sd_bytes


def test_program_holds_the_kernels_as_ops(exported):
    """K4 and K2 are nodes of the saved program's graph; no autograd
    Function is."""
    with open(exported["path"], "rb") as f:
        blob = f.read()
    (head_len,) = struct.unpack("<I", blob[8:12])
    program = torch.export.load(io.BytesIO(blob[12 + head_len:]))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count("vss_torch.aspp_depthwise3x3_multi.default") == 1
    assert targets.count("vss_torch.evidence_fold_add.default") == 1
    assert not any("autograd" in t or "DepthwiseBranches" in t for t in targets)
    assert len(program.state_dict) == 0  # parameters and buffers are inputs


def test_load_builds_no_pipeline(exported, monkeypatch):
    from vision_semantic_segmentation_tpu_torch.models import build as build_mod
    from vision_semantic_segmentation_tpu_torch.runtime import pipeline as pipeline_mod

    def boom(*a, **k):
        raise AssertionError("a pipeline or network was built at load or run time")

    monkeypatch.setattr(build_mod, "build_model", boom)
    monkeypatch.setattr(pipeline_mod, "build_model", boom)
    monkeypatch.setattr(pipeline_mod.FusedFramePipeline, "__init__", boom)
    run, _ = load_sequence_runner(exported["path"], exported["state_dict"])
    grid = run(torch.zeros((5, 200, 200)), exported["frames"])
    assert float(grid.sum()) > 0


def test_refuses_another_window_and_bad_weights(exported):
    run, _ = load_sequence_runner(exported["path"], exported["state_dict"])
    short = {k: v[: N_FRAMES - 1] for k, v in exported["frames"].items()}
    with pytest.raises(ValueError, match="windows of 3"):
        run(torch.zeros((5, 200, 200)), short)
    partial = dict(exported["state_dict"])
    partial.pop(next(iter(partial)))
    with pytest.raises(ValueError, match="lacks"):
        load_sequence_runner(exported["path"], partial)


def test_rejects_garbage_file(tmp_path):
    path = tmp_path / "bad.vsstexp"
    path.write_bytes(b"definitely not an export")
    with pytest.raises(ValueError, match="not a vsst torch export"):
        load_sequence_runner(str(path), {})
    # the JAX package's artifacts carry their own magic
    path.write_bytes(b"VSSTEXP1" + b"\0" * 16)
    with pytest.raises(ValueError, match="not a vsst torch export"):
        load_sequence_runner(str(path), {})


def test_compile_sequence_runner_in_process(exported):
    pipe, frames = exported["pipe"], exported["frames"]
    run = pipe.compile_sequence_runner(image_hw=IMAGE_HW, window=N_FRAMES)
    grid = run(pipe.init_grid(), frames)
    assert torch.equal(grid, pipe.run_window(pipe.init_grid(), frames))


def test_cli_compile_writes_loadable_artifact(exported):
    tmp = exported["tmp"]
    weight = str(tmp / "w.pth")
    torch.save(exported["state_dict"], weight)
    cfg = exported["cfg"].clone()
    cfg.VISION_SEM_SEG.SEM_SEG_NETWORK.MODEL.WEIGHT = weight
    cfg_path = str(tmp / "c.yaml")
    with open(cfg_path, "w") as f:
        f.write(cfg.dump())
    out = str(tmp / "cli.vsstexp")
    assert main(["compile", "--cfg", cfg_path, "--out", out, "--height", str(IMAGE_HW[0]),
                 "--width", str(IMAGE_HW[1]), "--window", str(N_FRAMES),
                 "--device", "cpu"]) == out
    run, meta = load_sequence_runner(out, exported["state_dict"])
    assert meta["window"] == N_FRAMES and meta["distortion"] == "points"
    grid = run(torch.zeros((5, 200, 200)), exported["frames"])
    # compile builds in the pipeline's bf16: the weights go in as bf16
    assert float(grid.sum()) > 0

"""Port parity: ``.pth`` -> ``.npz`` conversion against the JAX package.

A narrow DeepLabV3+ (ResNet-18 OS16, 32-wide ASPP and decoder; dense,
depthwise and 1x1 convs, BatchNorm with drawn running statistics) is saved
three ways: a reference-style checkpoint ``{"model": state_dict}`` with the
``nn.DataParallel`` ``module.`` prefix, a bare state dict, and a training
directory of the port's ``train/checkpoint.py`` (saved twice, so its
``last_checkpoint`` pointer names a ``.v1`` sibling).  The port's
``convert_pth_to_npz`` and the JAX package's write ``.npz`` files with the
same keys, and per key the same dtype, shape and bytes; the port's
``load_weights`` reads its ``.npz`` back to the original state dict (the
``num_batches_tracked`` counters, which the flax tree does not keep, come
back as 0).  ``main(["convert", ...])`` prints the JAX command's line.
"""
import numpy as np
import pytest
import torch

from vision_semantic_segmentation_tpu.__main__ import main as j_main
from vision_semantic_segmentation_tpu.models import convert as j_convert
from vision_semantic_segmentation_tpu_torch.__main__ import main
from vision_semantic_segmentation_tpu_torch.config import get_cfg_defaults, get_train_cfg_defaults
from vision_semantic_segmentation_tpu_torch.models import build_model, build_train_model, convert
from vision_semantic_segmentation_tpu_torch.parallel.train_step import TrainState
from vision_semantic_segmentation_tpu_torch.train import Checkpoint, build_optimizer
from vision_semantic_segmentation_tpu_torch.train import build_schedule, build_scheduler

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

NARROW = ["MODEL.BACKBONE", "resnet18", "MODEL.OUTPUT_STRIDE", "16",
          "MODEL.ASPP.OUT_CHANNELS", "32", "MODEL.ASPP.ATROUS_CHANNELS", "[32, 32, 32, 32]",
          "MODEL.DECODER.REFINE_CHANNELS", "[32, 32]"]


def _net_cfg():
    net = get_cfg_defaults().VISION_SEM_SEG.SEM_SEG_NETWORK
    net.merge_from_list(NARROW)
    return net


def _randomize_bn(model, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
                m.num_batches_tracked.fill_(7)
    return model


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """(name, path given to convert, the state dict it holds, its network's config)."""
    root = tmp_path_factory.mktemp("convert")
    model = _randomize_bn(build_model(_net_cfg(), device="cpu",
                                      generator=torch.Generator().manual_seed(1)), 2)
    sd = model.state_dict()
    reference = root / "reference.pth"
    torch.save({"model": {f"module.{k}": v for k, v in sd.items()}, "iteration": 10}, reference)
    bare = root / "bare.pth"
    torch.save(sd, bare)

    train_dir = root / "train"
    cfg = get_train_cfg_defaults()
    cfg.merge_from_list(NARROW + ["DATASET.NUM_CLASSES", "19", "OPTIMIZER.TYPE", "SGD",
                                  "OUTPUT_DIR", str(train_dir)])
    net, *_ = build_train_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    _randomize_bn(net, 4)
    opt = build_optimizer(cfg, net.parameters())
    state = TrainState(net, opt, build_scheduler(opt, build_schedule(cfg)),
                       torch.Generator().manual_seed(0))
    ckpt = Checkpoint(state, str(train_dir))
    ckpt.save("model_latest")
    with torch.no_grad():
        next(net.parameters()).mul_(2.0)  # the pointer must name the newer file
    ckpt.save("model_latest")
    assert (train_dir / "last_checkpoint").read_text() == "model_latest.v1.pth"
    return [("reference", reference, sd, _net_cfg()), ("bare", bare, sd, _net_cfg()),
            ("train_dir", train_dir, net.state_dict(), cfg)]


@pytest.mark.parametrize("which", [0, 1, 2], ids=["reference", "bare", "train_dir"])
def test_npz_equals_the_jax_packages(checkpoints, which, tmp_path):
    name, path, sd, net_cfg = checkpoints[which]
    ours = convert.convert_pth_to_npz(str(path), str(tmp_path / "port.npz"))
    theirs = j_convert.convert_pth_to_npz(str(path), str(tmp_path / "jax.npz"))
    with np.load(ours) as a, np.load(theirs) as b:
        assert a.files == b.files and len(a.files) > 100
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert a[k].tobytes() == b[k].tobytes(), k
    back = convert.load_weights(ours)
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        want = torch.zeros_like(v) if k.endswith("num_batches_tracked") else v
        assert back[k].dtype == want.dtype and torch.equal(back[k], want), k
    build_model(net_cfg, device="cpu").load_state_dict(back, strict=True)


def test_default_path_and_pointer(checkpoints):
    """With no ``--out`` the ``.npz`` lands beside the ``.pth`` the pointer names."""
    train_dir = checkpoints[2][1]
    assert convert.resolve_last_checkpoint(str(train_dir)) == j_convert.resolve_last_checkpoint(
        str(train_dir)) == str(train_dir / "model_latest.v1.pth")
    assert convert.convert_pth_to_npz(str(train_dir)) == str(train_dir / "model_latest.v1.npz")
    with pytest.raises(FileNotFoundError, match="last_checkpoint"):
        convert.resolve_last_checkpoint(str(train_dir.parent))


def test_tree_and_files_roundtrip(checkpoints, tmp_path):
    _, path, sd, _ = checkpoints[1]
    tree = convert.torch_state_dict_to_flax(sd)
    j_tree = j_convert.torch_state_dict_to_flax(sd)
    flat, j_flat = convert._flatten(tree), j_convert._flatten(j_tree)
    assert flat.keys() == j_flat.keys()
    assert all(np.array_equal(flat[k], j_flat[k]) for k in flat)
    assert convert.load_torch_checkpoint(str(path)).keys() == {"params", "batch_stats"}
    convert.save_npz(tree, str(tmp_path / "t.npz"))
    back = convert._flatten(convert.load_npz(str(tmp_path / "t.npz")))
    assert all(np.array_equal(back[k], flat[k]) for k in flat)
    assert convert._fuse_indices(("layer1", "0", "conv1")) == ("layer1_0", "conv1")
    assert convert._split_indices(convert._fuse_indices(("aspp", "module_pyramid", "2"))) == (
        "aspp", "module_pyramid", "2")
    with pytest.raises(ValueError, match="Unrecognized"):
        convert.torch_state_dict_to_flax({"conv.weird": torch.zeros(1)})


def test_bf16_state_dict_converts_exactly(tmp_path):
    """A serving network's bf16 state dict: the JAX package's converter
    refuses it (numpy has no bfloat16); the port writes float32, which holds
    each value exactly, and a bf16 network loaded from it equals the original."""
    model = _randomize_bn(build_model(_net_cfg(), dtype=torch.bfloat16, device="cpu",
                                      generator=torch.Generator().manual_seed(5)), 6)
    path = tmp_path / "bf16.pth"
    torch.save(model.state_dict(), path)
    with pytest.raises(TypeError):
        j_convert.load_torch_checkpoint(str(path))
    out = convert.convert_pth_to_npz(str(path))
    with np.load(out) as data:
        assert {data[k].dtype for k in data.files} == {np.dtype(np.float32)}
    net = build_model(_net_cfg(), dtype=torch.bfloat16, device="cpu")
    net.load_state_dict(convert.load_weights(out), strict=True)
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(net.state_dict()[k], v), k


def test_cli_prints_the_jax_line(checkpoints, tmp_path, capsys):
    path = checkpoints[0][1]
    out = str(tmp_path / "cli.npz")
    j_main(["convert", str(path), "--out", out])
    j_line = capsys.readouterr().out
    with np.load(out) as data:
        j_files = {k: data[k].tobytes() for k in data.files}
    assert main(["convert", str(path), "--out", out]) == out
    assert capsys.readouterr().out == j_line == f"wrote {out}\n"
    with np.load(out) as data:
        assert {k: data[k].tobytes() for k in data.files} == j_files

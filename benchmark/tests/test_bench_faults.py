"""A run with the timed path broken underneath comes out not correct.

Each case drives the whole harness on the CPU at the small size of
``tiny_root`` (the look for a card skipped), with one fault planted in the
measured program: a step that returns its state unchanged, half of each
batch or window left out, an answer altered where it is produced.  The
small size runs in float32 and has limits of its own, set from its sound
runs (``SOUND``); the sound run of each cell must come out correct first.
"""
from __future__ import annotations

import json

import pytest
import torch

from benchmark.tests.conftest import run_cell

# float32 on the CPU: the programs agree with the reference to rounding, but
# for the frames shrunk 20-fold, whose area average rounds back to uint8
# otherwise where it lies on a half (the logits move by up to 1 %)
TINY_LIMITS = {
    "deeplabv3p-rx50-os8-serve": {"logit_err": 5e-2, "label_gap": 5e-2, "grid_err": 1e-3},
    # steps 2 and 3 drift apart in float32 at a batch of 2 (chaotic from
    # random weights); the first gradient stays within 1e-6, and so does a
    # step of the window taken from the program's own state
    "deeplabv3p-rx50-os16-train": {"pred_diff": 1e-2, "loss_gap": 1e-1, "grad_gap": 1e-2,
                                   "change_gap": 2.5e-1, "step_loss_gap": 1e-4,
                                   "step_grad_gap": 1e-2, "step_change_gap": 1e-2},
}


@pytest.fixture
def root(tiny_root):
    for p in (tiny_root / "benchmark" / "configs").glob("*.json"):
        c = json.loads(p.read_text())
        c["limits"] = TINY_LIMITS[c["name"]]
        if "train" in c:
            c["train"]["compute_dtype"] = "float32"
        else:
            c["network"]["compute_dtype"] = "float32"
        p.write_text(json.dumps(c))
    return tiny_root


def _unchanged_state(monkeypatch):
    from vision_semantic_segmentation_tpu_torch.mapping.engine import SemanticMappingEngine

    monkeypatch.setattr(SemanticMappingEngine, "_build_update",
                        lambda self, device=None: (lambda grid, *a, **k: grid))


def _half_window(monkeypatch):
    from vision_semantic_segmentation_tpu_torch.runtime.pipeline import FusedFramePipeline

    run_window = FusedFramePipeline.run_window

    def half(self, grid, frames, **kw):
        n = len(frames["image"])
        return run_window(self, grid, {k: v[: max(1, n // 2)] for k, v in frames.items()}, **kw)

    monkeypatch.setattr(FusedFramePipeline, "run_window", half)


def _altered_labels(monkeypatch):
    from vision_semantic_segmentation_tpu_torch.runtime.pipeline import FusedFramePipeline

    segment = FusedFramePipeline.segment
    monkeypatch.setattr(FusedFramePipeline, "segment",
                        lambda self, *a, **k: segment(self, *a, **k).roll(1, dims=1))


def _frozen_step(monkeypatch):
    from vision_semantic_segmentation_tpu_torch.parallel import train_step

    def update(state):
        state.scheduler.step()
        state.step += 1

    monkeypatch.setattr(train_step, "_update", update)


def _half_batch(monkeypatch):
    from vision_semantic_segmentation_tpu_torch.train.trainer import Trainer

    on_device = Trainer._on_device

    def half(self, batch, raw):
        b = on_device(self, batch, raw)
        n = b["image"].shape[0] // 2
        return {k: v[:n] for k, v in b.items()}

    monkeypatch.setattr(Trainer, "_on_device", half)


CASES = {
    "rx50-os8.replay": [_unchanged_state, _half_window, _altered_labels],
    "rx50-os16.train-device": [_frozen_step, _half_batch],
}


@pytest.mark.parametrize("cell", sorted(CASES))
def test_sound_run_is_correct(root, cell):
    result = run_cell(root, cell)
    assert result["correct"], result["limits"]


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in sorted(CASES.items()) for f in fs],
                         ids=lambda v: v if isinstance(v, str) else v.__name__.strip("_"))
def test_fault_is_not_correct(root, monkeypatch, cell, fault):
    fault(monkeypatch)
    result = run_cell(root, cell)
    assert not result["correct"], result["limits"]
    torch.manual_seed(0)

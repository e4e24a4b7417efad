"""Checkpoint and resume.

Port of ``vision_semantic_segmentation_tpu/train/checkpoint.py`` (ref
core/utils/checkpoint.py:6-129) in the port's own format: one
``<name>.pth`` file, ``torch.save`` of ``{"model": state_dict,
"optimizer", "scheduler", "step", "rng", "extras"}``.  Its ``"model"``
entry is what ``models/convert.py::load_weights`` reads, so a training
checkpoint serves through ``MODEL.WEIGHT``.  The JAX package's semantics
are kept:

  * the ``last_checkpoint`` pointer (a bare file name in ``save_dir``) is
    written only when a save commits, so it never names a torn file;
  * re-saving a name writes a fresh ``<name>.vN.pth`` sibling and removes
    the older versions only after the pointer names the new one;
  * ``block=False`` (``TRAIN.ASYNC_CHECKPOINT``) snapshots the state to
    host memory, returns, and writes on a thread; at most one save is in
    flight, and the next ``save``/``load``/``finish`` commits it (a failed
    write raises there);
  * ``load(resume=True)`` prefers the pointer over ``filename``;
    ``resume_states=False`` loads the weights alone (model parameters and
    BatchNorm statistics).

Each file is written to a temporary name and renamed into place.
"""
from __future__ import annotations

import glob
import logging
import os
import os.path as osp
import re
import threading
from typing import Any, Dict, List, Optional

import torch

from ..parallel.train_step import TrainState


def _to_host(obj):
    """A copy of every tensor in a nested state on the host."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _rng_state(state: TrainState) -> Dict[str, torch.Tensor]:
    """The augment generator's state and the device's default generator
    (dropout draws from it)."""
    dev = state.generator.device
    out = {"generator": state.generator.get_state()}
    out["device"] = (torch.cuda.get_rng_state(dev) if dev.type == "cuda"
                     else torch.get_rng_state())
    return out


def _set_rng_state(state: TrainState, rng: Dict[str, torch.Tensor]) -> None:
    dev = state.generator.device
    state.generator.set_state(rng["generator"])
    if dev.type == "cuda":
        torch.cuda.set_rng_state(rng["device"], dev)
    else:
        torch.set_rng_state(rng["device"])


class Checkpoint:
    """Named-checkpoint manager with a ``last_checkpoint`` pointer."""

    def __init__(self, state: TrainState, save_dir: str = ".", logger=None):
        self.save_dir = osp.abspath(save_dir)
        self.logger = logger or logging.getLogger(__name__)
        self.state = state
        # (thread, path, replaced, error holder) of an in-flight save, else None
        self._pending = None

    # -- save ----------------------------------------------------------------
    def save(self, filename: str, block: bool = True, **extras) -> None:
        """Save the state and ``extras`` (scalars) as ``save_dir/<filename>.pth``."""
        if not self.save_dir or not filename:
            self.logger.warning("Invalid save directory or filename")
            return
        self.finish()  # at most one save in flight
        os.makedirs(self.save_dir, exist_ok=True)
        base = osp.join(self.save_dir, filename)
        replaced = self._existing_versions(base)
        path = base + ".pth"
        if replaced:
            k = 1
            while osp.exists(f"{base}.v{k}.pth"):
                k += 1
            path = f"{base}.v{k}.pth"
        s = self.state
        payload = _to_host({
            "model": s.model.state_dict(),
            "optimizer": s.optimizer.state_dict(),
            "scheduler": s.scheduler.state_dict(),
            "step": int(s.step),
            "rng": _rng_state(s),
            "extras": {k: float(v) for k, v in extras.items()},
        })
        self.logger.info(f"Saving checkpoint to {path}")
        if block:
            self._write(path, payload)
            self._finalize(path, replaced)
            return
        error: List[BaseException] = []

        def write():
            try:
                self._write(path, payload)
            except BaseException as exc:  # noqa: BLE001 - re-raised by finish()
                error.append(exc)

        thread = threading.Thread(target=write, name="checkpoint", daemon=True)
        thread.start()
        self._pending = (thread, path, replaced, error)

    @staticmethod
    def _write(path: str, payload: Dict[str, Any]) -> None:
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)

    @staticmethod
    def _existing_versions(base: str) -> List[str]:
        """Committed files of ``base``'s checkpoint — ``base.pth`` and any
        ``base.vN.pth`` — oldest first."""
        def version(p):
            m = re.fullmatch(re.escape(base) + r"\.v(\d+)\.pth", p)
            return int(m.group(1)) if m else 0

        found = [p for p in [base + ".pth"] + glob.glob(glob.escape(base) + ".v*.pth")
                 if osp.isfile(p) and re.fullmatch(re.escape(base) + r"(\.v\d+)?\.pth", p)]
        return sorted(found, key=version)

    def _finalize(self, path: str, replaced=()) -> None:
        self.update_last_checkpoint(path)
        # only after the pointer names the new file: retire the older versions
        for old in replaced:
            try:
                os.remove(old)
            except OSError:
                pass

    def finish(self) -> None:
        """Wait for an in-flight save and commit its pointer (no-op when
        none is pending); a failed write raises here."""
        if self._pending is None:
            return
        thread, path, replaced, error = self._pending
        self._pending = None
        thread.join()
        if error:
            raise error[0]
        self._finalize(path, replaced)

    # -- load ----------------------------------------------------------------
    def resolve(self, filename: str) -> str:
        """A checkpoint name (bare, relative or absolute, with or without
        ``.pth``) -> the newest committed file holding it."""
        candidates = [filename]
        if not osp.isabs(filename):
            candidates.append(osp.join(self.save_dir, filename))
        for cand in candidates:
            if osp.isfile(cand):
                return cand
            base = cand[:-4] if cand.endswith(".pth") else cand
            versions = self._existing_versions(base)
            if versions:
                return versions[-1]
        raise FileNotFoundError(f"no checkpoint {filename!r} (save_dir {self.save_dir})")

    def load(self, filename: Optional[str] = None, resume: bool = True,
             resume_states: bool = True) -> Dict[str, float]:
        """Load a checkpoint into the state; returns the extras saved with it.

        ``resume`` prefers the ``last_checkpoint`` pointer over ``filename``;
        ``resume_states`` restores optimizer, schedule, step and generators
        as well as the weights (ref checkpoint.py:66-100).
        """
        self.finish()  # a pending save commits before the pointer is read
        if resume and self.has_checkpoint():
            filename = self.get_checkpoint_file()
        if not filename:
            self.logger.info("No checkpoint found. Initializing model from scratch")
            return {}
        path = self.resolve(filename)
        self.logger.info(f"Loading checkpoint from {path}")
        payload = torch.load(path, map_location="cpu", weights_only=False)
        s = self.state
        s.model.load_state_dict(payload["model"], strict=True)
        if not resume_states:
            return {}
        s.optimizer.load_state_dict(payload["optimizer"])
        s.scheduler.load_state_dict(payload["scheduler"])
        s.step = int(payload["step"])
        _set_rng_state(s, payload["rng"])
        return dict(payload.get("extras", {}))

    # -- pointer file (ref checkpoint.py:102-129) ----------------------------
    def has_checkpoint(self) -> bool:
        return osp.exists(osp.join(self.save_dir, "last_checkpoint"))

    def get_checkpoint_file(self) -> str:
        try:
            with open(osp.join(self.save_dir, "last_checkpoint")) as f:
                last_saved = f.read().strip()
        except OSError:
            return ""
        if last_saved and not osp.isabs(last_saved):
            last_saved = osp.join(self.save_dir, last_saved)
        return last_saved

    def update_last_checkpoint(self, last_filename: str) -> None:
        # written to a temporary file and renamed: a reader sees the old
        # pointer or the new one, never a partial write
        pointer = osp.join(self.save_dir, "last_checkpoint")
        with open(pointer + ".tmp", "w") as f:
            f.write(osp.basename(last_filename))
        os.replace(pointer + ".tmp", pointer)

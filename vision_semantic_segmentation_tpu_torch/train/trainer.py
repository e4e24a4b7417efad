"""Training driver.

Port of ``vision_semantic_segmentation_tpu/train/trainer.py`` (ref
train.py:56-280) for one device: per-epoch training with periodic logging,
validation, checkpointing and best-mIoU tracking, AUTO_RESUME /
RESUME_STATES (mid-epoch, from the exact saved step), and preemption
(``TRAIN.PREEMPTION_SAFE``: SIGTERM checkpoints at the next step boundary
and returns).

``TRAIN.STEPS_PER_DISPATCH`` K is accepted and runs K single steps, which
the JAX package's fused K-step dispatch equals bit for bit.
``TRAIN.COMPUTE_DTYPE`` bfloat16 runs the forward under ``torch.autocast``
with f32 parameters.  Multi-device training (``TRAIN.SPATIAL_SHARDS`` > 1,
``distributed``) is refused: ROADMAP queue 1 items 4 and 5.

``tensorboard=True`` (with an ``output_dir``) writes the epoch's training
meters and the validation loss and mIoU as TensorBoard scalars through
``tensorboard_util.add_scalars``, with a tensorboardX ``SummaryWriter`` in
``output_dir``; without tensorboardX the trainer runs on and logs one line
saying so.  Any object with ``add_scalar`` may be passed instead of True.

Steps are pipelined one deep: step i+1 is queued on the card before step
i's loss and confusion are read back, so the host stages and queues while
the card computes.  ``history`` keeps one record a step (loss, the host
time spent waiting for the batch, and the wall time between steps).
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.build import build_train_model
from ..parallel.train_step import TrainState, make_eval_step, make_train_step
from ..runtime.replay import StagedWindow
from ..utils.seed import set_random_seed
from .augment import device_augment_from_cfg
from .build import build_dataloader
from .checkpoint import Checkpoint
from .freezer import trainable_parameters
from .meters import MeterLogger
from .optim import build_optimizer, build_schedule, build_scheduler
from .prefetch import stage_batch
from .tensorboard_util import add_scalars

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_DATA_PARALLEL = "data-parallel training is not ported (ROADMAP queue 1 item 4, parallel/)"
_SPATIAL = "spatially sharded training is not ported (ROADMAP queue 1 item 5, parallel/)"


class Trainer:
    """Config-driven trainer (ref train.py:163-243) on one device."""

    def __init__(self, cfg, output_dir: str = "", logger=None, device: DeviceLike = "cuda",
                 tensorboard=False, remat: bool = False, distributed: bool = False):
        """Args:
            tensorboard: True for a tensorboardX writer in ``output_dir``, or
                a writer (any object with ``add_scalar``).
            remat: recompute the whole forward in the backward (memory saver).
            device: where the model trains; CUDA unless the caller asks for the CPU.
        """
        if distributed:
            raise NotImplementedError(f"distributed: {_DATA_PARALLEL}")
        if int(getattr(cfg.TRAIN, "SPATIAL_SHARDS", 1)) > 1:
            raise NotImplementedError(f"TRAIN.SPATIAL_SHARDS > 1: {_SPATIAL}")
        self.cfg = cfg
        self.output_dir = output_dir
        self.logger = logger
        self.device = resolve_device(device)

        seed = set_random_seed(cfg.RNG_SEED)
        seed = 0 if seed is None else seed  # RNG_SEED < 0: unseeded (ref torch_util.py:7-16)
        compute = str(getattr(cfg.TRAIN, "COMPUTE_DTYPE", "float32"))
        if compute not in _DTYPES:
            raise ValueError(f"TRAIN.COMPUTE_DTYPE {compute!r} not in {sorted(_DTYPES)}")
        self.compute_dtype = _DTYPES[compute]
        self.model, self.loss_fn, self.train_metric, self.val_metric = build_train_model(
            cfg, device=self.device, generator=torch.Generator().manual_seed(seed))

        params = trainable_parameters(self.model, tuple(cfg.TRAIN.FROZEN_PATTERNS),
                                      bool(cfg.TRAIN.FREEZE_BATCHNORM))
        optimizer = build_optimizer(cfg, params)
        self.schedule = build_schedule(cfg)
        self.state = TrainState(
            model=self.model, optimizer=optimizer,
            scheduler=build_scheduler(optimizer, self.schedule),
            generator=torch.Generator(self.device).manual_seed(seed + 1),
        )

        num_classes = cfg.DATASET.NUM_CLASSES
        self._steps_per_dispatch = max(1, int(getattr(cfg.TRAIN, "STEPS_PER_DISPATCH", 1)))
        accum = max(1, int(getattr(cfg.TRAIN, "GRAD_ACCUM_STEPS", 1)))
        if accum > 1 and cfg.TRAIN.BATCH_SIZE % accum:
            raise ValueError(f"TRAIN.BATCH_SIZE={cfg.TRAIN.BATCH_SIZE} is not divisible "
                             f"by TRAIN.GRAD_ACCUM_STEPS={accum}")
        # TRAIN.DEVICE_AUGMENT: the random scale/crop/flip/normalize chain
        # runs on the card; the loader feeds raw uint8 batches
        self._device_augment = device_augment_from_cfg(cfg)
        self._train_step = make_train_step(
            num_classes, max_grad_norm=cfg.OPTIMIZER.MAX_GRAD_NORM,
            freeze_bn_stats=bool(cfg.TRAIN.FREEZE_BATCHNORM), remat=remat, accum_steps=accum,
            augment=self._device_augment, compute_dtype=self.compute_dtype)
        self._eval_step = make_eval_step(num_classes, compute_dtype=self.compute_dtype)

        # checkpointing (ref train.py:188-195)
        self.checkpoint = Checkpoint(self.state, save_dir=output_dir or ".", logger=logger)
        self.best_metric = float("-inf")
        # set by the SIGTERM handler (or request_preempt), read at step boundaries
        self._preempted = False
        self.history: List[Dict[str, float]] = []
        self._tb = self._writer(tensorboard, output_dir)

    # -- helpers -------------------------------------------------------------
    def _log(self, msg: str) -> None:
        if self.logger is None:
            print(msg, flush=True)
        elif hasattr(self.logger, "info"):
            self.logger.info(msg)
        else:
            self.logger.log(msg)

    def _writer(self, tensorboard, output_dir: str):
        if tensorboard is not True:
            return tensorboard or None
        if not output_dir:
            return None
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            self._log("tensorboard: tensorboardX is not installed, no scalars are written")
            return None
        return SummaryWriter(output_dir)

    def request_preempt(self) -> None:
        """Ask the epoch loop to checkpoint + stop at the next step boundary."""
        self._preempted = True

    def _install_preempt_handlers(self):
        """SIGTERM -> request_preempt while fit() runs; returns a restore
        callable.  From a worker thread only request_preempt() is available."""
        import signal

        previous = {}

        def handler(signum, frame):
            self._log(f"signal {signum}: checkpointing at the next step boundary")
            self.request_preempt()

        try:
            previous[signal.SIGTERM] = signal.signal(signal.SIGTERM, handler)
        except ValueError:
            self._log("not the main thread: SIGTERM handler not installed "
                      "(preemption still available via request_preempt())")

        def restore():
            for sig, prev in previous.items():
                signal.signal(sig, prev)

        return restore

    def resume(self) -> Dict:
        """AUTO_RESUME / RESUME_STATES handling (ref train.py:194-199)."""
        extras = self.checkpoint.load(filename=self.cfg.MODEL.WEIGHT or None,
                                      resume=self.cfg.AUTO_RESUME,
                                      resume_states=self.cfg.RESUME_STATES)
        if "best_metric" in extras:
            self.best_metric = float(extras["best_metric"])
        return extras

    def _on_device(self, batch, raw_images: bool) -> Dict[str, torch.Tensor]:
        """A loader batch (host arrays, or a StagedWindow from the prefetcher)
        as image/label tensors on the device, ready on its current stream."""
        if not isinstance(batch, StagedWindow):
            batch = stage_batch(self._host_batch(batch, raw_images), self.device)
        batch.wait()
        return {"image": batch["image"], "label": batch["label"].long()}

    @staticmethod
    def _host_batch(batch, raw_images: bool) -> Dict[str, np.ndarray]:
        image = np.asarray(batch["image"])
        return {"image": image if raw_images else image.astype(np.float32, copy=False),
                "label": np.asarray(batch["label"]).astype(np.int32)}

    def _loader(self, loader, raw_images: bool):
        """Wrap ``loader`` in the staging prefetcher (DATALOADER.PREFETCH_BATCHES)."""
        depth = int(getattr(self.cfg.DATALOADER, "PREFETCH_BATCHES", 0))
        if depth <= 0:
            return loader
        from .prefetch import PrefetchLoader

        return PrefetchLoader(_HostBatches(loader, raw_images), depth=depth, device=self.device)

    # -- epoch loops (ref train.py:56-161) -----------------------------------
    def train_one_epoch(self, dataloader, epoch: int, skip_steps: int = 0) -> MeterLogger:
        """One epoch of training.

        ``skip_steps`` discards that many leading batches without training
        on them — the mid-epoch resume path: a preempted run saved its state
        at ``step = epoch * len + skip``, and the deterministic loader
        replays the same order, so skipping lands on the first untrained
        batch.
        """
        meters = MeterLogger()
        self.train_metric.reset()
        log_period = self.cfg.TRAIN.LOG_PERIOD
        raw = self._device_augment is not None
        iteration = skip_steps
        inflight = None  # (metrics on the device, data seconds, steps taken after it)
        end = time.perf_counter()

        def drain():
            nonlocal inflight, end, iteration
            if inflight is None:
                return
            metrics, data_time, step = inflight
            inflight = None
            loss = float(metrics["loss"])
            self.train_metric.merge(metrics["confusion"])
            now = time.perf_counter()
            batch_time, end = now - end, now
            meters.update(loss=loss, data_time=data_time, batch_time=batch_time)
            self.history.append({"epoch": epoch, "step": step, "loss": loss,
                                 "data_time": data_time, "batch_time": batch_time})
            if log_period and iteration % log_period == 0:
                lr = self.state.optimizer.param_groups[0]["lr"]
                self._log(f"Epoch[{epoch}] iter[{iteration}] lr {lr:.5f} {meters} "
                          f"mIoU {self.train_metric.global_avg:.4f}")
            iteration += 1

        skipped = 0
        t_wait = time.perf_counter()
        for batch in dataloader:
            if skipped < skip_steps:
                skipped += 1
                t_wait = time.perf_counter()
                continue
            if self._preempted:
                break
            data_time = time.perf_counter() - t_wait
            metrics = self._train_step(self.state, self._on_device(batch, raw))
            drain()  # the previous step: the card already runs this one
            inflight = (metrics, data_time, self.state.step)
            t_wait = time.perf_counter()
        drain()
        return meters

    def validate(self, dataloader, epoch: int) -> float:
        self.val_metric.reset()
        meters = MeterLogger()
        for batch in dataloader:
            metrics = self._eval_step(self.state, self._on_device(batch, False))
            meters.update(loss=float(metrics["loss"]))
            self.val_metric.merge(metrics["confusion"])
        miou = self.val_metric.global_avg
        self._log(f"Validation epoch[{epoch}] {meters} mIoU {miou:.4f}")
        if self._tb is not None:
            add_scalars(self._tb, meters, "val", epoch)
            self._tb.add_scalar("val/miou", miou, epoch)
        return miou

    def fit(self, train_loader=None, val_loader=None) -> None:
        """Full schedule: epochs + periodic validate + checkpoints (ref train.py:207-243)."""
        cfg = self.cfg
        if train_loader is None:
            train_loader = build_dataloader(cfg, mode="train")
        if val_loader is None and cfg.VALIDATE.PERIOD:
            val_loader = build_dataloader(cfg, mode="val")
        train_loader = self._loader(train_loader, self._device_augment is not None)
        if val_loader is not None:
            val_loader = self._loader(val_loader, False)

        self.resume()
        steps_per_epoch = max(len(train_loader), 1)
        start_epoch = self.state.step // steps_per_epoch
        skip_steps = self.state.step % steps_per_epoch
        if self._steps_per_dispatch > 1:
            self._log(f"TRAIN.STEPS_PER_DISPATCH {self._steps_per_dispatch}: single steps "
                      "(equal to the JAX package's fused dispatch)")

        restore_handlers = (self._install_preempt_handlers()
                            if bool(getattr(cfg.TRAIN, "PREEMPTION_SAFE", True))
                            else (lambda: None))
        try:
            for epoch in range(start_epoch, cfg.SCHEDULER.MAX_EPOCH):
                if hasattr(train_loader, "set_epoch"):
                    train_loader.set_epoch(epoch)
                meters = self.train_one_epoch(
                    train_loader, epoch, skip_steps=skip_steps if epoch == start_epoch else 0)
                if self._preempted:
                    # blocking save: durability beats overlap on the way out
                    self.checkpoint.save("model_latest", block=True,
                                         best_metric=self.best_metric)
                    self._log(f"preempted at step {self.state.step}: checkpoint committed, "
                              "stopping (AUTO_RESUME continues from this exact step)")
                    return
                self._log(f"Epoch[{epoch}] done: {meters.summary_str}")
                if self._tb is not None:
                    add_scalars(self._tb, meters, "train", epoch)
                if self.device.type == "cuda":
                    peak = torch.cuda.max_memory_allocated(self.device) / 2 ** 20
                    self._log(f"Epoch[{epoch}] peak device memory allocated: {peak:.0f} MiB")

                # one save per epoch: on period epochs the pointer lands on the
                # numbered checkpoint
                block = not bool(getattr(cfg.TRAIN, "ASYNC_CHECKPOINT", False))
                period = cfg.TRAIN.CHECKPOINT_PERIOD
                name = (f"model_{epoch:03d}" if period and (epoch + 1) % period == 0
                        else "model_latest")
                self.checkpoint.save(name, block=block, best_metric=self.best_metric)

                if val_loader is not None and cfg.VALIDATE.PERIOD and (
                        (epoch + 1) % cfg.VALIDATE.PERIOD == 0):
                    miou = self.validate(val_loader, epoch)
                    if miou > self.best_metric:
                        self.best_metric = miou
                        self.checkpoint.save("model_best", best_metric=self.best_metric)
                        self._log(f"New best mIoU {miou:.4f}")
        finally:
            # commit an in-flight save even when an epoch raises
            self.checkpoint.finish()
            restore_handlers()


class _HostBatches:
    """A loader's batches as the host arrays the trainer stages (float32 or
    raw uint8 images, int32 labels), with the loader's length and epoch."""

    def __init__(self, loader, raw_images: bool):
        self.loader = loader
        self.raw_images = raw_images

    def __len__(self) -> int:
        return len(self.loader)

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.loader, "set_epoch"):
            self.loader.set_epoch(epoch)

    def __iter__(self):
        for batch in self.loader:
            yield Trainer._host_batch(batch, self.raw_images)


def train(cfg, output_dir: str = "", logger=None, device: DeviceLike = "cuda") -> Trainer:
    """Functional entry point (ref train.py:163)."""
    trainer = Trainer(cfg, output_dir=output_dir, logger=logger, device=device)
    trainer.fit()
    return trainer

"""Training driver.

Port of ``vision_semantic_segmentation_tpu/train/trainer.py`` (ref
train.py:56-280 and distributed_train.py:201-369): per-epoch training with
periodic logging, validation, checkpointing and best-mIoU tracking,
AUTO_RESUME / RESUME_STATES (mid-epoch, from the exact saved step), and
preemption (``TRAIN.PREEMPTION_SAFE``: SIGTERM checkpoints at the next step
boundary and returns).

``distributed=True`` trains data-parallel, one rank per card, in the
process group of ``torchrun`` (``parallel/distributed.py``): the global
batch is ``TRAIN.BATCH_SIZE``, each rank decoding its contiguous slice.
The step follows the JAX trainer's routing: global-batch BatchNorm
statistics (``make_train_step(group=...)``) with ``MODEL.SYNC_BN``, on one
rank or with ``TRAIN.FREEZE_BATCHNORM``, else per-rank statistics
(``make_per_device_bn_train_step``), which refuses remat and
``TRAIN.GRAD_ACCUM_STEPS`` > 1.  A batch that does not split over the
ranks is refused (the JAX trainer shrinks its mesh to a divisor; a
launched rank cannot be left idle).  Rank 0's parameters and buffers reach
every rank after the model is built and after a resume, and a resume
raises unless every rank read the same step (each reads the checkpoint
from its own ``OUTPUT_DIR``, which the ranks must share); rank 0 alone
writes checkpoints, logs and TensorBoard scalars, and the other ranks wait
at a barrier after each save.  Validation sums the confusion over ranks,
so every rank keeps the same best mIoU, and a SIGTERM on any rank stops
every rank at the same step boundary.

``TRAIN.STEPS_PER_DISPATCH`` K is accepted and runs K single steps, which
the JAX package's fused K-step dispatch equals bit for bit.
``TRAIN.COMPUTE_DTYPE`` bfloat16 runs the forward under ``torch.autocast``
with f32 parameters.

``TRAIN.SPATIAL_SHARDS`` S > 1 bands each image's rows over S devices
(``make_spatial_train_step``, ``parallel/spatial_infer.py``) on a
``(data, spatial)`` mesh of ``devices`` (default every local device of
``device``'s type; a device may repeat): S must divide their count, and the
data axis shrinks to a divisor of the batch, as in the JAX trainer.  With
``distributed=True`` the bands lie across the ranks instead (the JAX
trainer's ``('data', 'spatial')`` mesh over every process's devices): rank
r holds band ``r % S`` of data group ``r // S``, S must divide the world,
each data group's ranks decode the same slice of the global batch
(``build_dataloader``), and their dropout and augmentation generators are
seeded by data group, so the S ranks of an image draw alike.  The
refusals are the JAX trainer's, each raised on every rank before the
first collective: per-device BatchNorm statistics (``MODEL.SYNC_BN`` False
over more than one data shard, unfrozen) and ``TRAIN.DEVICE_AUGMENT`` raise
``NotImplementedError``; S not dividing the devices or ranks, a batch that
does not split over the data shards, and a crop height that does not divide
by S or lies below ``OUTPUT_STRIDE`` x S raise ``ValueError``.

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
import torch.distributed as dist

from ..device import DeviceLike, resolve_device
from ..models.build import build_train_model
from ..parallel.distributed import broadcast_module_, ensure_distributed, rank_seed
from ..parallel.mesh import create_mesh, local_devices
from ..parallel.train_step import (
    TrainState,
    make_eval_step,
    make_per_device_bn_train_step,
    make_spatial_eval_step,
    make_spatial_train_step,
    make_train_step,
)
from ..runtime.replay import StagedWindow
from ..utils.benchmark import span
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
_END = object()  # the loader is spent


def _largest_divisor(n: int, at_most: int) -> int:
    return next(d for d in range(min(at_most, n), 0, -1) if n % d == 0)


class Trainer:
    """Config-driven trainer (ref train.py:163-243), on one device or one
    rank of a data-parallel group."""

    def __init__(self, cfg, output_dir: str = "", logger=None, device: DeviceLike = "cuda",
                 tensorboard=False, remat: bool = False, distributed: bool = False,
                 devices=None):
        """Args:
            tensorboard: True for a tensorboardX writer in ``output_dir``, or
                a writer (any object with ``add_scalar``).
            remat: recompute the whole forward in the backward (memory saver).
            device: where the model trains; CUDA unless the caller asks for the CPU.
            distributed: join ``torchrun``'s process group (or the one this
                process opened) and train as one of its ranks; raises
                without one.  ``device`` ``cuda`` is then ``cuda:LOCAL_RANK``.
            devices: the mesh of ``TRAIN.SPATIAL_SHARDS`` > 1 (a device may
                repeat); default every local device of ``device``'s type.
                The model and optimizer stay on ``device``.  Not used with
                ``distributed`` (the bands lie across the ranks).
        """
        spatial = max(1, int(getattr(cfg.TRAIN, "SPATIAL_SHARDS", 1)))
        self.cfg = cfg
        self.output_dir = output_dir
        self.logger = logger
        self.world = ensure_distributed(device) if distributed else None
        self.device = self.world.device if distributed else resolve_device(device)
        self.rank = self.world.rank if distributed else 0
        ranks = self.world.size if distributed else 1
        accum = max(1, int(getattr(cfg.TRAIN, "GRAD_ACCUM_STEPS", 1)))
        # TRAIN.DEVICE_AUGMENT: the random scale/crop/flip/normalize chain
        # runs on the card; the loader feeds raw uint8 batches
        self._device_augment = device_augment_from_cfg(cfg)
        # every refusal below comes before the first collective, on every rank
        self.mesh = self._groups = None
        self._spatial, self._data_size, self._min_spatial_h = 1, ranks, 0
        if spatial > 1 and distributed:
            # bands across ranks: rank r holds band r % S of data group r // S
            if ranks % spatial:
                raise ValueError(f"TRAIN.SPATIAL_SHARDS={spatial} does not divide the world of "
                                 f"{ranks} ranks")
            self._data_size = ranks // spatial
            if cfg.TRAIN.BATCH_SIZE % self._data_size:
                raise ValueError(f"TRAIN.BATCH_SIZE={cfg.TRAIN.BATCH_SIZE} does not split over "
                                 f"{self._data_size} data groups ({ranks} ranks / {spatial} "
                                 "spatial shards)")
        elif cfg.TRAIN.BATCH_SIZE % ranks:
            raise ValueError(f"TRAIN.BATCH_SIZE={cfg.TRAIN.BATCH_SIZE} does not split over "
                             f"{ranks} ranks: launch a number of ranks that divides it")
        elif spatial > 1:
            # a (data, spatial) mesh, image rows banded over the spatial
            # axis, the batch over what devices remain
            devs = list(devices) if devices is not None else local_devices(self.device.type)
            if len(devs) % spatial:
                raise ValueError(f"TRAIN.SPATIAL_SHARDS={spatial} does not divide the device "
                                 f"count {len(devs)}")
            self._data_size = _largest_divisor(cfg.TRAIN.BATCH_SIZE, len(devs) // spatial)
            self.mesh = create_mesh((self._data_size, spatial), ("data", "spatial"),
                                    devices=devs[:self._data_size * spatial])
        if spatial > 1:
            self._spatial = spatial
            self._min_spatial_h = int(getattr(cfg.MODEL, "OUTPUT_STRIDE", 1)) * spatial
            if self._data_size > 1 and not cfg.MODEL.SYNC_BN and not cfg.TRAIN.FREEZE_BATCHNORM:
                raise NotImplementedError(
                    "TRAIN.SPATIAL_SHARDS > 1 requires the SyncBN train step (MODEL.SYNC_BN="
                    "True, a single-data-device mesh, or TRAIN.FREEZE_BATCHNORM=True); "
                    "per-device BN statistics are undefined for spatially-split images")
            if self._device_augment is not None:
                raise NotImplementedError(
                    "TRAIN.DEVICE_AUGMENT composes with data parallelism only; with "
                    "TRAIN.SPATIAL_SHARDS > 1 feed host-side augmented fixed-shape crops "
                    "(TRAIN.AUGMENTATION)")
        parts = self._data_size if distributed else 1
        if accum > 1 and cfg.TRAIN.BATCH_SIZE % (accum * parts):
            # each rank (data group) takes its part of each micro-batch
            unit = "ranks" if spatial == 1 else "data groups"
            raise ValueError(f"TRAIN.BATCH_SIZE={cfg.TRAIN.BATCH_SIZE} is not divisible "
                             f"by TRAIN.GRAD_ACCUM_STEPS={accum}"
                             + (f" x {parts} {unit}" if parts > 1 else ""))
        if spatial > 1 and distributed:
            self._groups = self.world.spatial_groups(spatial)
        # the generators' seed index: a rank's own, or its data group's (the
        # S ranks of an image draw the same dropout mask)
        self._stream = self.rank // spatial

        seed = set_random_seed(cfg.RNG_SEED)
        seed = 0 if seed is None else seed  # RNG_SEED < 0: unseeded (ref torch_util.py:7-16)
        self._seed = seed
        compute = str(getattr(cfg.TRAIN, "COMPUTE_DTYPE", "float32"))
        if compute not in _DTYPES:
            raise ValueError(f"TRAIN.COMPUTE_DTYPE {compute!r} not in {sorted(_DTYPES)}")
        self.compute_dtype = _DTYPES[compute]
        self.model, self.loss_fn, self.train_metric, self.val_metric = build_train_model(
            cfg, device=self.device, generator=torch.Generator().manual_seed(seed))
        if self.world is not None:
            broadcast_module_(self.model, group=self.world.group)

        params = trainable_parameters(self.model, tuple(cfg.TRAIN.FROZEN_PATTERNS),
                                      bool(cfg.TRAIN.FREEZE_BATCHNORM))
        optimizer = build_optimizer(cfg, params)
        self.schedule = build_schedule(cfg)
        self.state = TrainState(
            model=self.model, optimizer=optimizer,
            scheduler=build_scheduler(optimizer, self.schedule),
            generator=torch.Generator(self.device),
        )
        self._seed_rank(0)

        num_classes = cfg.DATASET.NUM_CLASSES
        self._steps_per_dispatch = max(1, int(getattr(cfg.TRAIN, "STEPS_PER_DISPATCH", 1)))
        # the JAX trainer's routing: per-rank BatchNorm statistics only when
        # asked for (SYNC_BN False), on more than one rank and unfrozen
        group = self.world.group if distributed else None
        per_device = ranks > 1 and not cfg.MODEL.SYNC_BN and not cfg.TRAIN.FREEZE_BATCHNORM
        if self._spatial > 1:
            self._train_step = make_spatial_train_step(
                num_classes, self.mesh, max_grad_norm=cfg.OPTIMIZER.MAX_GRAD_NORM,
                freeze_bn_stats=bool(cfg.TRAIN.FREEZE_BATCHNORM), remat=remat,
                accum_steps=accum, compute_dtype=self.compute_dtype, group=self._groups)
        elif per_device:
            self._train_step = make_per_device_bn_train_step(
                num_classes, group, max_grad_norm=cfg.OPTIMIZER.MAX_GRAD_NORM,
                augment=self._device_augment, compute_dtype=self.compute_dtype, remat=remat,
                accum_steps=accum)
        else:
            self._train_step = make_train_step(
                num_classes, max_grad_norm=cfg.OPTIMIZER.MAX_GRAD_NORM,
                freeze_bn_stats=bool(cfg.TRAIN.FREEZE_BATCHNORM), remat=remat,
                accum_steps=accum, augment=self._device_augment,
                compute_dtype=self.compute_dtype, group=group)
        self._eval_step = (
            make_spatial_eval_step(num_classes, self.mesh, compute_dtype=self.compute_dtype,
                                   group=self._groups)
            if self._spatial > 1 else
            make_eval_step(num_classes, compute_dtype=self.compute_dtype, group=group))
        if self._groups is not None:
            self._log(f"spatial: {self._data_size} data groups x {self._spatial} bands across "
                      f"{ranks} ranks (rank r: band r % {self._spatial} of data group "
                      f"r // {self._spatial}), halos over {self._groups.backend}")
        elif self._spatial > 1:
            self._log(f"spatial: {self._data_size} data x {self._spatial} spatial shards over "
                      f"{', '.join(str(d) for d in self.mesh.devices.flat)}")
        if distributed:
            self._log(f"distributed: {ranks} ranks over {dist.get_backend()}, rank 0 on "
                      f"{self.device}, {'per-device' if per_device else 'global-batch'} "
                      "BatchNorm statistics")

        # checkpointing (ref train.py:188-195)
        self.checkpoint = Checkpoint(self.state, save_dir=output_dir or ".", logger=logger)
        self.best_metric = float("-inf")
        # set by the SIGTERM handler (or request_preempt), read at step boundaries
        self._preempted = False
        self.history: List[Dict[str, float]] = []
        self._tb = self._writer(tensorboard, output_dir) if self.rank == 0 else None

    # -- helpers -------------------------------------------------------------
    def _seed_rank(self, step: int) -> None:
        """Seed this rank's host, dropout and augmentation generators for
        ``step``: rank 0 at step 0 with the run's seed (as on one device),
        every other rank with its own (``rank_seed``); with bands across
        ranks, by data group instead of rank."""
        seed = rank_seed(self._seed, self._stream, step)
        if self._stream or step:  # stream 0 at step 0 was seeded with the run's seed
            set_random_seed(seed)
        self.state.generator.manual_seed(seed + 1)

    def _log(self, msg: str) -> None:
        if self.rank:
            return
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

    def _stop_requested(self) -> bool:
        """Whether to stop at this step boundary: a preemption asked on any
        rank (every rank reaches each boundary and agrees)."""
        if self.world is not None:
            self._preempted = self.world.any(self._preempted)
        return self._preempted

    def _save(self, name: str, block: bool = True) -> None:
        """Save on rank 0; the other ranks wait for it."""
        if self.rank == 0:
            self.checkpoint.save(name, block=block, best_metric=self.best_metric)
        if self.world is not None:
            self.world.barrier()

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
        if self.world is not None:
            low, high = self.world.span(self.state.step)
            if low != high:  # a rank read another checkpoint, or found none
                raise RuntimeError(
                    f"the ranks resumed at different steps ({low} to {high}): every rank "
                    "must read the same checkpoint, so OUTPUT_DIR must lie on storage "
                    "that all ranks share")
            broadcast_module_(self.model, group=self.world.group)
            # the file holds rank 0's generators; an image's ranks reseed alike
            # by data group, rank 0 with them
            if self.rank or self._groups is not None:
                self._seed_rank(self.state.step)
        if "best_metric" in extras:
            self.best_metric = float(extras["best_metric"])
        return extras

    def _on_device(self, batch, raw_images: bool) -> Dict[str, torch.Tensor]:
        """A loader batch (host arrays, or a StagedWindow from the prefetcher)
        as image/label tensors on the device, ready on its current stream."""
        if not isinstance(batch, StagedWindow):
            batch = stage_batch(self._host_batch(batch, raw_images), self.device)
        batch.wait()
        if self._spatial > 1:
            self._check_spatial_h(batch["image"].shape[1])
        return {"image": batch["image"], "label": batch["label"].long()}

    def _check_spatial_h(self, h: int) -> None:
        """The JAX trainer's guard: a crop height that divides by the shard
        count and keeps a row a shard at the output stride."""
        if h % self._spatial or h < self._min_spatial_h:
            raise ValueError(
                f"TRAIN.SPATIAL_SHARDS={self._spatial} needs the crop height to divide by the "
                f"shard count and be >= OUTPUT_STRIDE x shards = {self._min_spatial_h} "
                f"(got H={h})")

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
            with span("train.drain"):
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
        batches = iter(dataloader)
        while True:
            # the batch is taken inside the span, so the span covers the
            # wait ``data_time`` measures
            with span("train.fetch"):
                batch = next(batches, _END)
                if batch is _END:
                    break
                if skipped < skip_steps:
                    skipped += 1
                    t_wait = time.perf_counter()
                    continue
                if self._stop_requested():
                    break
                data_time = time.perf_counter() - t_wait
            with span("train.step"):
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
        distributed = self.world is not None
        if train_loader is None:
            train_loader = build_dataloader(cfg, mode="train", distributed=distributed)
        if val_loader is None and cfg.VALIDATE.PERIOD:
            val_loader = build_dataloader(cfg, mode="val", distributed=distributed)
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
                if self._stop_requested():
                    # blocking save: durability beats overlap on the way out
                    self._save("model_latest")
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
                self._save(name, block=block)

                if val_loader is not None and cfg.VALIDATE.PERIOD and (
                        (epoch + 1) % cfg.VALIDATE.PERIOD == 0):
                    miou = self.validate(val_loader, epoch)
                    if miou > self.best_metric:
                        self.best_metric = miou
                        self._save("model_best")
                        self._log(f"New best mIoU {miou:.4f}")
        finally:
            # commit an in-flight save even when an epoch raises
            self.checkpoint.finish()
            restore_handlers()
        if self.world is not None:
            self.world.barrier()  # rank 0's last save committed


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


def train(cfg, output_dir: str = "", logger=None, device: DeviceLike = "cuda",
          distributed: bool = False) -> Trainer:
    """Functional entry point (ref train.py:163)."""
    trainer = Trainer(cfg, output_dir=output_dir, logger=logger, device=device,
                      distributed=distributed)
    trainer.fit()
    return trainer
